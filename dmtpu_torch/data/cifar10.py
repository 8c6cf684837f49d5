"""Alias module, so that the reference's ``datasets.cifar10.CIFAR10``
target resolves (counterpart of ``dmtpu/data/cifar10.py``)."""
from dmtpu_torch.data.datasets import CIFAR10

__all__ = ["CIFAR10"]
