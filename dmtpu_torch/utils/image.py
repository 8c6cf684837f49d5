"""Image saving helpers.  Counterpart of ``dmtpu/utils/image.py``.

Arrays are channels-last ([N, H, W, C] or [H, W, C]) floats in [-1, 1], as
in the JAX package: an image leaves the models' NCHW at the pipeline's
end.  ``PIL`` is imported inside the functions that need it, so arrays can
be made and gridded without it.
"""
from __future__ import annotations

import math
import os

import numpy as np

from dmtpu_torch.utils.misc import image_norm_to_uint8


def pil_image():
    """The ``PIL.Image`` module, or an ImportError that says what needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading and writing image files needs the `PIL` package "
                          "(Pillow)") from e
    return Image


def to_pil(image: np.ndarray):
    """One [-1, 1] float image ([H, W, C], or the first of [N, H, W, C]) -> PIL."""
    arr = np.asarray(image)
    if arr.ndim == 4:
        arr = arr[0]
    u8 = image_norm_to_uint8(arr)
    if u8.shape[-1] == 1:
        u8 = u8[..., 0]
    return pil_image().fromarray(u8)


def save_image(image: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    to_pil(image).save(path)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """[N, H, W, C] in [-1, 1] -> one [-1, 1] grid image (white padding)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    nr = math.ceil(n / nrow)
    grid = np.ones((nr * (h + pad) + pad, nrow * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    save_image(make_grid(images, nrow=nrow), path)
