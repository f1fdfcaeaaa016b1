"""PyTorch + CUDA port of the multimodal rare-disease diagnosis system.

The JAX package `multimodal_rare_disease_tpu` is the reference; this
package mirrors its directory and module names and imports nothing of
it, keeping its own copies of the host code it needs (config, tokenizer
with its C++ core, clinical text, the image corpus code, the data
pipeline, the host RNG streams, the statistics, the micro-batcher). It
covers the inference side: the batch predictor (`inference/predictor.py`)
and its HTTP daemon (`cli/serve.py`) over the multimodal, image-only and
text-only models (ResNet-50, BERT-base, attention / gated /
concatenation fusion), evaluation and statistics (`evaluation/`),
Grad-CAM and attention maps (`explain/`), training (`train/`), face
detection (`models/mtcnn.py`), the weight converters, the conv VAE, the
offline corpus and setup tools, and their CLIs (`cli/`). Every TPU
kernel of the JAX package has a hand-written CUDA counterpart for Hopper
under `csrc/`, bound in `kernels/`: the fused FFN sublayer with and
without its input LayerNorm (K1, K2), the fused attention-output
sublayer (K3) and the fused uint8 normalize (K4). Its entry points run on the card unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"
