"""Data: image transforms, the dataset readers, captioned datasets and the
threaded loader."""
from dmtpu_torch.data.loader import DataLoader

__all__ = ["DataLoader"]
