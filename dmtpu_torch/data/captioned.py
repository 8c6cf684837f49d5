"""Captioned image datasets for latent text-to-image fine-tuning.

Counterpart of ``CaptionedImageDir`` and ``SyntheticCaptioned`` of
``dmtpu/data/captioned.py`` (``SyntheticEmbedded``, for cached text
embeddings, is not ported yet).  Items are ``{"image": float32 HWC in
[-1, 1], "caption": str}``; the loader stacks the images and gathers the
captions into an array, and the training CLI tokenizes each batch on the
host.
"""
from __future__ import annotations

import os

import numpy as np

from dmtpu_torch.data.datasets import extract_images
from dmtpu_torch.data.transforms import ImageTransform
from dmtpu_torch.utils.image import pil_image


class CaptionedImageDir:
    """A directory of images with sidecar caption files (the diffusers /
    kohya fine-tuning layout): ``img.png`` + ``img.txt``.  Images without a
    sidecar get ``default_caption``."""

    def __init__(self, root: str, img_size: int, caption_ext: str = ".txt",
                 default_caption: str = "", flip_p: float = 0.5, transform=None, **_):
        root = os.path.expanduser(root)
        if not os.path.isdir(root):
            raise ValueError(f"{root} is not a valid directory")
        self.img_paths = extract_images(root)
        if not self.img_paths:
            raise ValueError(f"no images under {root}")
        self.caption_ext = caption_ext
        self.default_caption = default_caption
        self.transform = transform or ImageTransform(img_size, flip_p=flip_p)

    def __len__(self):
        return len(self.img_paths)

    def _caption(self, img_path: str) -> str:
        side = os.path.splitext(img_path)[0] + self.caption_ext
        if os.path.isfile(side):
            with open(side, encoding="utf-8") as f:
                return f.read().strip()
        return self.default_caption

    def __getitem__(self, i: int):
        with pil_image().open(self.img_paths[i]) as img:
            image = self.transform(img.convert("RGB"))
        return {"image": image, "caption": self._caption(self.img_paths[i])}


class SyntheticCaptioned:
    """Seeded random images and template captions (tests and benchmarks: no
    file is read)."""

    _TEMPLATES = ("a photo of object {}", "a drawing of thing {}", "an image number {}", "")

    def __init__(self, img_size: int = 64, channels: int = 3, n: int = 256, seed: int = 0, **_):
        rng = np.random.RandomState(seed)
        self.images = rng.uniform(-1, 1, (n, img_size, img_size, channels)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int):
        return {"image": self.images[i],
                "caption": self._TEMPLATES[i % len(self._TEMPLATES)].format(i)}
