"""Alias module, so that the reference's ``datasets.ImageDir.ImageDir``
target resolves (counterpart of ``dmtpu/data/image_dir.py``)."""
from dmtpu_torch.data.datasets import ImageDir, extract_images

__all__ = ["ImageDir", "extract_images"]
