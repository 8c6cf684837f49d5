"""Command-line entry points, run as ``python -m dmtpu_torch.scripts.<name>``."""
