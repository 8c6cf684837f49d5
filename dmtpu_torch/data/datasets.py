"""Dataset readers: image folders, the classic datasets and a seeded synthetic one.

Counterpart of ``dmtpu/data/datasets.py``, with the same items from the
same files or seed: a float32 HWC image in [-1, 1], or an (image, label)
pair.  The loader stacks them as the JAX package's does; the training CLIs
move a batch to NCHW on the device.  Train splits flip horizontally at
random (from ``np.random``, or the ``rng`` a caller hands ``__getitem__``).

  - ``ImageDir``   (reference: datasets/ImageDir.py:20-35)
  - ``MNIST``      (reference: datasets/mnist.py:8-60): the raw idx files
  - ``CIFAR10``    (reference: datasets/cifar10.py:8-63): the python pickle batches
  - ``CelebAHQ``   (reference: datasets/celebahq.py:22-111, the official CelebA split)
  - ``ImageNet``   (reference: datasets/imagenet.py:22-106)
  - ``Synthetic``  seeded random images (and labels): tests and benchmarks read no file

``PIL`` is imported where an image is opened or resized.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import List, Optional, Tuple

import numpy as np

from dmtpu_torch.data.transforms import ImageTransform, pil_resize, to_norm_array
from dmtpu_torch.utils.image import pil_image

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


def _open_rgb(path: str):
    return pil_image().open(path).convert("RGB")


class ImageDir:
    """Every image under ``root``, unlabelled.  ``cache=True`` keeps the
    decoded images in memory (small datasets, where the decode would
    otherwise dominate a step).  (reference: datasets/ImageDir.py:20-35)"""

    def __init__(self, root: str, img_size: Optional[int] = None, transform=None,
                 flip_p: float = 0.0, cache: bool = False):
        root = os.path.expanduser(root)
        if not os.path.isdir(root):
            raise ValueError(f"{root} is not a valid directory")
        self.img_paths = extract_images(root)
        self.transform = transform
        if transform is None and img_size is not None:
            self.transform = ImageTransform(img_size, flip_p=flip_p)
        self._cache: Optional[dict] = {} if cache else None

    def __len__(self):
        return len(self.img_paths)

    def _load(self, item: int):
        if self._cache is None:
            return _open_rgb(self.img_paths[item])
        if item not in self._cache:
            self._cache[item] = _open_rgb(self.img_paths[item])
        return self._cache[item]

    def __getitem__(self, item: int):
        img = self._load(item)
        if self.transform is not None:
            return self.transform(img)
        return to_norm_array(img)


class MNIST:
    """The raw idx files (torchvision's ``MNIST/raw`` layout, or ``root``
    itself), plain or ``.gz``; (image [H, W, 1], label) items."""

    _FILES = {
        "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root: str, img_size: int = 28, split: str = "train", **_):
        if split not in ("train", "test"):
            raise ValueError(f"Invalid split: {split}")
        self.img_size = img_size
        img_f, lbl_f = self._FILES[split]
        base = os.path.expanduser(root)
        raw = os.path.join(base, "MNIST", "raw")
        if not os.path.isdir(raw):
            raw = base
        self.images = self._read_idx(os.path.join(raw, img_f))
        self.labels = self._read_idx(os.path.join(raw, lbl_f))

    @staticmethod
    def _read_idx(path: str) -> np.ndarray:
        opener = open
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            path, opener = path + ".gz", gzip.open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, item: int) -> Tuple[np.ndarray, int]:
        img = pil_image().fromarray(self.images[item])
        if self.img_size != 28:
            img = pil_resize(img, self.img_size)
        return to_norm_array(img), int(self.labels[item])


class CIFAR10:
    """The ``cifar-10-batches-py`` pickle batches (under ``root`` or ``root``
    itself); (image [32, 32, 3], label) items, flipped at random in the train
    split unless ``transform_type`` is ``none``."""

    def __init__(self, root: str, img_size: int = 32, split: str = "train",
                 transform_type: str = "default", **_):
        if split not in ("train", "test"):
            raise ValueError(f"Invalid split: {split}")
        self.img_size = img_size
        self.split = split
        self.flip_p = 0.5 if (split == "train" and transform_type != "none") else 0.0
        base = os.path.join(os.path.expanduser(root), "cifar-10-batches-py")
        if not os.path.isdir(base):
            base = os.path.expanduser(root)
        names = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
        xs, ys = [], []
        for n in names:
            with open(os.path.join(base, n), "rb") as f:
                d = pickle.load(f, encoding="bytes")  # the dataset's own format
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.asarray(ys, np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, item: int, rng: Optional[np.random.RandomState] = None
                    ) -> Tuple[np.ndarray, int]:
        arr = self.images[item]
        if self.img_size != 32:
            arr = np.asarray(pil_resize(pil_image().fromarray(arr), self.img_size))
        arr = arr.astype(np.float32) / 255.0 * 2.0 - 1.0
        r = rng or np.random
        if self.flip_p > 0 and r.rand() < self.flip_p:
            arr = arr[:, ::-1].copy()
        return arr, int(self.labels[item])


class CelebAHQ:
    """``root/CelebA-HQ-img/`` split by the official CelebA boundaries on the
    file numbers (original-CelebA numbers, or CelebAMask-HQ indices 0..29999
    with ``CelebA-HQ-to-CelebA-mapping.txt`` beside the folder).
    (reference: datasets/celebahq.py:22-111)"""

    _SPLITS = [1, 162771, 182638, 202600]

    def __init__(self, root: str, img_size: int, split: str = "train",
                 transform_type: str = "default", transform=None, **_):
        if split not in ("train", "valid", "test", "all"):
            raise ValueError(f"Invalid split: {split}")
        root = os.path.expanduser(root)
        image_root = os.path.join(root, "CelebA-HQ-img")
        if not os.path.isdir(image_root):
            raise ValueError(f"{image_root} is not an existing directory")
        paths = extract_images(image_root)
        if split != "all":
            paths = self._split(root, image_root, paths, split)
        self.img_paths = paths
        flip_p = 0.5 if (split in ("train", "all") and transform_type != "none") else 0.0
        self.transform = transform or ImageTransform(img_size, flip_p=flip_p)

    @classmethod
    def _split(cls, root: str, image_root: str, paths: List[str], split: str) -> List[str]:
        k = {"train": 0, "valid": 1, "test": 2}[split]
        lo, hi = cls._SPLITS[k], cls._SPLITS[k + 1]
        idx_to_orig = {}
        mapping_file = os.path.join(root, "CelebA-HQ-to-CelebA-mapping.txt")
        if os.path.isfile(mapping_file):
            with open(mapping_file) as f:
                next(f, None)  # header
                for line in f:
                    parts = line.split()
                    if len(parts) >= 3:
                        idx_to_orig[int(parts[0])] = int(os.path.splitext(parts[2])[0])

        def number_of(p):
            name = os.path.splitext(os.path.basename(p))[0]
            try:
                return int(name)
            except ValueError:
                raise ValueError(
                    f"CelebAHQ expects numeric filenames, got {name!r} (original-CelebA "
                    "numbers, or CelebAMask-HQ indices with CelebA-HQ-to-CelebA-mapping.txt "
                    "present)") from None

        nums = [number_of(p) for p in paths]
        # translate through the mapping only where the names are CelebAMask-HQ
        # indices (all below 30000): a renamed original-CelebA layout that
        # carries the mapping file too would have its low numbers scrambled
        if not (idx_to_orig and nums and max(nums) < 30000):
            idx_to_orig = {}
        kept = [p for p, n in zip(paths, nums) if lo <= idx_to_orig.get(n, n) < hi]
        if not kept:
            raise ValueError(
                f"CelebAHQ split {split!r} matched 0 of the files under {image_root}: "
                "filenames must carry original-CelebA numbers, or place "
                "CelebA-HQ-to-CelebA-mapping.txt beside CelebA-HQ-img/ for raw CelebAMask-HQ "
                "numbering")
        return kept

    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, item: int):
        return self.transform(_open_rgb(self.img_paths[item]))


class ImageNet:
    """``root/<split>/`` (``val`` stands for ``valid``), unlabelled; resized
    and cropped (random crop in train) by ``transform_type``.
    (reference: datasets/imagenet.py:22-106)"""

    def __init__(self, root: str, img_size: int, split: str = "train",
                 transform_type: str = "default", transform=None, **_):
        if split not in ("train", "valid", "test"):
            raise ValueError(f"Invalid split: {split}")
        root = os.path.expanduser(root)
        image_root = os.path.join(root, split)
        if split == "valid" and not os.path.isdir(image_root):
            image_root = os.path.join(root, "val")
        if not os.path.isdir(image_root):
            raise ValueError(f"{image_root} is not an existing directory")
        self.img_paths = extract_images(image_root)
        flip_p = 0.5 if (split == "train" and transform_type != "none") else 0.0
        if transform is not None:
            self.transform = transform
        elif transform_type in ("default", "resize-crop"):
            crop = "random" if split == "train" else "center"
            self.transform = ImageTransform(img_size, flip_p=flip_p, crop=crop)
        elif transform_type == "resize":
            self.transform = ImageTransform(img_size, flip_p=flip_p)
        elif transform_type == "none":
            self.transform = None
        else:
            raise ValueError(f"Invalid transform_type: {transform_type}")

    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, item: int):
        img = _open_rgb(self.img_paths[item])
        if self.transform is not None:
            return self.transform(img)
        return to_norm_array(img)


class Synthetic:
    """``n`` seeded uniform images in [-1, 1] (HWC float32) and, with
    ``num_classes``, seeded labels: (image, label) items, else the image."""

    def __init__(self, img_size: int = 32, channels: int = 3, n: int = 1024,
                 num_classes: Optional[int] = None, seed: int = 0, **_):
        rng = np.random.RandomState(seed)
        self.images = rng.uniform(-1, 1, (n, img_size, img_size, channels)).astype(np.float32)
        self.labels = rng.randint(0, num_classes, (n,)) if num_classes else None

    def __len__(self):
        return len(self.images)

    def __getitem__(self, item: int):
        if self.labels is not None:
            return self.images[item], int(self.labels[item])
        return self.images[item]
