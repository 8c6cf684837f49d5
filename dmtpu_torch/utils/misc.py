"""Small host-side utilities.  Counterpart of the part of
``dmtpu/utils/misc.py`` that image output needs (reference: utils/misc.py)."""
from __future__ import annotations

import numpy as np


def image_float_to_uint8(image: np.ndarray) -> np.ndarray:
    """[0, 1] -> [0, 255]  (reference: utils/misc.py:20-24)"""
    return (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)


def image_norm_to_float(image: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1]  (reference: utils/misc.py:27-30)"""
    return (np.asarray(image, dtype=np.float32) + 1.0) / 2.0


def image_norm_to_uint8(image: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 255]  (reference: utils/misc.py:33-37)"""
    return image_float_to_uint8(image_norm_to_float(image))
