"""What the pixel sampling CLIs share (``sample_sdedit``, ``sample_ilvr``,
``sample_mask_guidance``, ``sample_ddib``, ``sample_clip_guidance``;
``sample_uncond`` takes ``to_nhwc``): opening a run (flags, device, config,
model), reading the input images in batches and handing samples back as
images.

Each CLI takes ``base_parser``'s flags (``--device`` defaults to ``cuda``:
without a card it exits unless ``--device cpu`` is given) and ``key=value``
config overrides; the model is the config's, with ``--weights`` loaded by
``load_model_params`` (a JAX-package ``.npz`` export or a torch file).
Under ``torchrun`` each rank edits its rows of every batch
(``DataParallelSampler``) and rank 0 writes the files.
"""
from __future__ import annotations

import argparse
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dmtpu_torch.data.image_dir import ImageDir
from dmtpu_torch.scripts._common import image_shape, load_conf, load_model_params, open_device
from dmtpu_torch.utils.config import Config, instantiate_from_config


def open_cli(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]], cli: str
             ) -> Tuple[argparse.Namespace, torch.device, Config, Tuple[int, int, int]]:
    """(flags, device, config with its overrides, (C, H, W) of its images)."""
    args, unknown = parser.parse_known_args(argv)
    device = open_device(args.device, cli)
    conf = load_conf(args, unknown)
    return args, device, conf, image_shape(conf)


def load_model(args: argparse.Namespace, conf: Config, device: torch.device) -> nn.Module:
    """The config's model on ``device`` with ``--weights`` loaded, in eval mode."""
    return load_model_params(args.weights,
                             instantiate_from_config(conf["model"], device=device)).eval()


def image_batches(input_dir: str, img_size: int, n_samples: Optional[int], batch_size: int
                  ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """(first index, n, [b, H, W, C] float32 batch in [-1, 1]) over the
    first ``n_samples`` images of ``input_dir`` (all of them by default),
    read by ``ImageDir`` at ``img_size``."""
    dataset = ImageDir(input_dir, img_size=img_size)
    n = min(n_samples or len(dataset), len(dataset))
    for i in range(0, n, batch_size):
        yield i, n, np.stack([dataset[j] for j in range(i, min(i + batch_size, n))])


def to_nhwc(x: torch.Tensor) -> np.ndarray:
    """[..., C, H, W] on the device -> clipped [..., H, W, C] float32 numpy."""
    return np.clip(x.movedim(-3, -1).float().cpu().numpy(), -1, 1)
