"""PyTorch + CUDA port of the multimodal rare-disease diagnosis system.

The JAX package `multimodal_rare_disease_tpu` is the reference; this
package mirrors its directory and module names. This slice covers the
serving path: the batch predictor (`inference/predictor.py`) and its
HTTP daemon (`cli/serve.py`) over ResNet-50 + BERT-base + attention
fusion, with the BERT FFN sublayer as a hand-written CUDA kernel for
Hopper (`csrc/ffn_ln.cu`, `kernels/ffn.py`). It imports torch and never
jax; from the JAX package it shares only jax-free host code (config,
tokenizer, clinical text, the micro-batcher).
"""

__version__ = "0.1.0"
