"""Command-line entry points: ``python -m mslesions3d_tpu_torch.cli.train``."""
