"""PIL / numpy image transforms (torchvision-free).

Counterpart of ``dmtpu/data/transforms.py``, with the same output: float32
HWC in [-1, 1], as the JAX package's loader hands it out; the training CLI
moves a batch to NCHW on the card.  (reference: datasets/cifar10.py:51-63 —
resize, random hflip, normalise to [-1, 1].)  ``PIL`` is imported where an
image is resized.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from dmtpu_torch.utils.image import pil_image


def pil_resize(img, size, short_side: bool = False):
    """Resize to (size, size), or the short side to ``size`` keeping the
    aspect (torchvision ``T.Resize(int)``)."""
    Image = pil_image()
    if short_side:
        w, h = img.size
        s = size if isinstance(size, int) else size[0]
        if w <= h:
            new = (s, max(1, round(h * s / w)))
        else:
            new = (max(1, round(w * s / h)), s)
        return img.resize(new, Image.BILINEAR)
    if isinstance(size, int):
        size = (size, size)
    return img.resize((size[1], size[0]), Image.BILINEAR)


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top:top + size, left:left + size]


def random_crop(arr: np.ndarray, size: int, rng: np.random.RandomState) -> np.ndarray:
    h, w = arr.shape[:2]
    top = rng.randint(0, h - size + 1)
    left = rng.randint(0, w - size + 1)
    return arr[top:top + size, left:left + size]


def to_norm_array(img) -> np.ndarray:
    """PIL -> float32 HWC in [-1, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr * 2.0 - 1.0


class ImageTransform:
    """resize (and crop) + random horizontal flip + normalise."""

    def __init__(self, img_size: int, flip_p: float = 0.0,
                 crop: Optional[str] = None):  # None | "center" | "random"
        self.img_size = img_size
        self.flip_p = flip_p
        self.crop = crop

    def __call__(self, img, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        rng = rng or np.random
        if self.crop:
            arr = to_norm_array(pil_resize(img, self.img_size, short_side=True))
            if self.crop == "random":
                arr = random_crop(arr, self.img_size, rng)
            else:
                arr = center_crop(arr, self.img_size)
        else:
            arr = to_norm_array(pil_resize(img, self.img_size))
        if self.flip_p > 0 and rng.rand() < self.flip_p:
            arr = arr[:, ::-1].copy()
        return arr
