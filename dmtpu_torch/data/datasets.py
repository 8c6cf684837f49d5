"""Dataset helpers.  Counterpart of ``extract_images`` in
``dmtpu/data/datasets.py``; the image-folder and classic datasets of that
file are not ported yet."""
from __future__ import annotations

import os
from typing import List

IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp", ".tiff")


def extract_images(root: str) -> List[str]:
    """Image paths under ``root``, recursively, sorted.
    (reference: datasets/ImageDir.py:7-17)"""
    root = os.path.expanduser(root)
    paths = []
    for curdir, _, files in os.walk(root):
        for f in files:
            if os.path.splitext(f)[1].lower() in IMG_EXT:
                paths.append(os.path.join(curdir, f))
    return sorted(paths)
