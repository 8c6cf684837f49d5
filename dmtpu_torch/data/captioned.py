"""Captioned image datasets for latent text-to-image fine-tuning.

Counterpart of ``dmtpu/data/captioned.py``: ``CaptionedImageDir`` and
``SyntheticCaptioned``, whose items are ``{"image": float32 HWC in [-1, 1],
"caption": str}`` (the loader stacks the images and gathers the captions
into an array, and the training CLI tokenizes each batch on the host), and
``SyntheticEmbedded``, whose items carry cached text embeddings instead.
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


class SyntheticEmbedded:
    """Seeded images and PRECOMPUTED text embeddings, the cached-embedding
    text-to-image workflow (MMDiT on ``{"image", "context", "pooled"}`` with
    no text tower in the step); the same arrays as the JAX package's from the
    same seed.  Images and embeddings follow the pseudo-class
    ``index % n_classes``, so the conditioning is learnable."""

    def __init__(self, img_size: int = 32, channels: int = 3, n: int = 256, context_len: int = 8,
                 context_dim: int = 64, pooled_dim: int = 32, n_classes: int = 4, seed: int = 0,
                 **_):
        rng = np.random.RandomState(seed)
        cls = np.arange(n) % n_classes
        base = rng.uniform(-1, 1, (n_classes, img_size, img_size, channels))
        noise = 0.1 * rng.randn(n, img_size, img_size, channels)
        self.images = np.clip(base[cls] + noise, -1, 1).astype(np.float32)
        ctx_table = rng.randn(n_classes, context_len, context_dim)
        pool_table = rng.randn(n_classes, pooled_dim)
        self.contexts = ctx_table[cls].astype(np.float32)
        self.pooled = pool_table[cls].astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int):
        return {"image": self.images[i], "context": self.contexts[i], "pooled": self.pooled[i]}
