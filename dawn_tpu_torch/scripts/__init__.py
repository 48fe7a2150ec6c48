"""Command-line entry points: ``python -m dawn_tpu_torch.scripts.<name>``."""
