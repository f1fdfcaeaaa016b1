"""Command-line entry points of the torch package:

  python -m multimodal_rare_disease_tpu_torch.cli.train
  python -m multimodal_rare_disease_tpu_torch.cli.predict
  python -m multimodal_rare_disease_tpu_torch.cli.evaluate
  python -m multimodal_rare_disease_tpu_torch.cli.stats
  python -m multimodal_rare_disease_tpu_torch.cli.explain
  python -m multimodal_rare_disease_tpu_torch.cli.serve
  python -m multimodal_rare_disease_tpu_torch.cli.profile

Each takes `--device` (default `cuda`: the card; `cpu` to run without
one) where the JAX package's CLIs take `--platform`.
"""
