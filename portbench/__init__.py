"""The benchmark of ``dmtpu_torch`` on NVIDIA GPUs (see README.md)."""
