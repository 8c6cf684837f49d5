"""Small host-side utilities.  Counterpart of ``dmtpu/utils/misc.py``
(reference: utils/misc.py)."""
from __future__ import annotations

import datetime
import glob
import os
import shutil
import sys
from typing import Iterable, List, Optional

import numpy as np


def check_freq(freq: int, step: int) -> bool:
    """(reference: utils/misc.py:11-13)"""
    if not isinstance(freq, int):
        raise TypeError(f"a frequency is an int, got {freq!r}")
    return freq >= 1 and (step + 1) % freq == 0


def get_time_str() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")


def image_float_to_uint8(image: np.ndarray) -> np.ndarray:
    """[0, 1] -> [0, 255]  (reference: utils/misc.py:20-24)"""
    return (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)


def image_norm_to_float(image: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1]  (reference: utils/misc.py:27-30)"""
    return (np.asarray(image, dtype=np.float32) + 1.0) / 2.0


def image_norm_to_uint8(image: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 255]  (reference: utils/misc.py:33-37)"""
    return image_float_to_uint8(image_norm_to_float(image))


def amortize(n_samples: int, batch_size: int) -> List[int]:
    """Split n_samples into batch_size-sized folds.  (reference: utils/misc.py:41-44)"""
    k, r = divmod(n_samples, batch_size)
    return k * [batch_size] if r == 0 else k * [batch_size] + [r]


def get_data_generator(dataloader: Iterable):
    """Infinite epoch cycler.  (reference: utils/misc.py:47-50)"""
    while True:
        for batch in dataloader:
            yield batch


def find_resume_checkpoint(exp_dir: str, resume: str) -> str:
    """Resolve ``best`` / ``latest`` / an explicit path to a checkpoint
    directory.  (reference: utils/misc.py:53-68)"""
    if os.path.isdir(resume):
        ckpt_path = resume
    elif resume == "best":
        ckpt_path = os.path.join(exp_dir, "ckpt", "best")
    elif resume == "latest":
        steps = {}
        for name in os.listdir(os.path.join(exp_dir, "ckpt")):
            if os.path.isdir(os.path.join(exp_dir, "ckpt", name)) and name.startswith("step"):
                steps[int(name[4:])] = name
        if not steps:
            raise ValueError(f"no checkpoints found under {exp_dir}/ckpt")
        ckpt_path = os.path.join(exp_dir, "ckpt", steps[max(steps)])
    else:
        raise ValueError(f"resume option {resume} is invalid")
    if not os.path.isdir(ckpt_path):
        raise ValueError(f"{ckpt_path} is not a directory")
    return ckpt_path


class AverageMeter:
    """(reference: utils/misc.py:81-100)"""

    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def reset(self):
        self.__init__()

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def create_exp_dir(exp_dir: str, conf_yaml: str, exist_ok: bool = False,
                   time_str: Optional[str] = None, no_interaction: bool = False):
    """``exp_dir`` with ``ckpt/``, ``samples/`` and the run's config; an
    existing directory is replaced after a yes (or with ``no_interaction``)
    unless ``exist_ok``.  (reference: utils/misc.py:103-123)"""
    if time_str is None:
        time_str = get_time_str()
    if os.path.exists(exp_dir) and not exist_ok:
        if no_interaction:
            cover = True
        else:
            sys.stdout.write(f"{exp_dir} already exists! Cover it anyway? [y/N] ")
            cover = input().strip().lower() in ("y", "yes")
        if cover:
            shutil.rmtree(exp_dir, ignore_errors=True)
        else:
            sys.exit(1)
    os.makedirs(exp_dir, exist_ok=True)
    os.makedirs(os.path.join(exp_dir, "ckpt"), exist_ok=True)
    os.makedirs(os.path.join(exp_dir, "samples"), exist_ok=True)
    with open(os.path.join(exp_dir, f"config-{time_str}.yaml"), "w") as f:
        f.write(conf_yaml)


def list_weight_files(root: Optional[str]) -> List[str]:
    """The loadable weight files under ``root``, recursively and sorted (the
    UI pages' Model dropdown); empty when ``root`` is empty or missing."""
    if not root:
        return []
    out: List[str] = []
    for ext in ("pt", "pth", "ckpt", "safetensors", "npz"):
        out += glob.glob(os.path.join(root, f"**/*.{ext}"), recursive=True)
    return sorted(out)
