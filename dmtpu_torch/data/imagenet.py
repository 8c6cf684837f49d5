"""Alias module, so that the reference's ``datasets.imagenet.ImageNet``
target resolves (counterpart of ``dmtpu/data/imagenet.py``)."""
from dmtpu_torch.data.datasets import ImageNet

__all__ = ["ImageNet"]
