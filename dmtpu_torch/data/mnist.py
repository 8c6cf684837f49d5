"""Alias module, so that the reference's ``datasets.mnist.MNIST``
target resolves (counterpart of ``dmtpu/data/mnist.py``)."""
from dmtpu_torch.data.datasets import MNIST

__all__ = ["MNIST"]
