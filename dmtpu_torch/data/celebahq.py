"""Alias module, so that the reference's ``datasets.celebahq.CelebAHQ``
target resolves (counterpart of ``dmtpu/data/celebahq.py``)."""
from dmtpu_torch.data.datasets import CelebAHQ

__all__ = ["CelebAHQ"]
