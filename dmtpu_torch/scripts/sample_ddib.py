"""DDIB: class-A -> class-B image translation by DDIM inversion and sampling.

    python -m dmtpu_torch.scripts.sample_ddib -c configs/ddpm_cfg_cifar10.yaml \\
        --weights ckpt.pt --save_dir out --input_dir images --class_A 0 --class_B 3 \\
        --respace_steps 50 [--n_samples N] [key=value ...]

Counterpart of ``scripts/sample_ddib.py`` (reference:
scripts/sample_ddib.py:121-157), with the same flags plus ``--device``
(default ``cuda``).  Each input image (``ImageDir``) is inverted to noise by
DDIM under ``class_A`` and sampled back by DDIM under ``class_B`` (eta 0: no
noise is drawn); the model takes its labels as ``model(x, t, y)``, as the
JAX CLI's does: a class-conditional pixel model (``UNetCategorialAdaGN``,
ADM's ``UNetModel`` with ``num_classes``).  Each ``save_dir/{i}.png`` is the
input beside its translation.  ``translate_batch`` is one batch's request as
a function.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dmtpu_torch.diffusions import DDIM
from dmtpu_torch.scripts._common import (
    DataParallelSampler,
    base_parser,
    diffusion_params,
    to_device,
)
from dmtpu_torch.scripts._editing import image_batches, load_model, open_cli, to_nhwc
from dmtpu_torch.utils.image import save_image_grid
from dmtpu_torch.utils.logger import get_logger


def build_parser() -> argparse.ArgumentParser:
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--class_A", type=int, required=True)
    p.add_argument("--class_B", type=int, required=True)
    p.add_argument("--n_samples", type=int, default=None)
    return p


def labelled(model: Callable, label: int) -> Callable:
    """The samplers' ``model_fn(x, t)`` of ``model(x, t, y)`` at one class."""
    def model_fn(x, t, **kw):
        return model(x, t, torch.full((x.shape[0],), label, dtype=torch.int64, device=x.device))
    return model_fn


@torch.no_grad()
def translate_batch(model: Callable, diffuser: DDIM, images: torch.Tensor, class_A: int,
                    class_B: int) -> torch.Tensor:
    """``images`` [B, C, H, W] in [-1, 1] inverted under ``class_A`` and
    sampled under ``class_B``; unclipped."""
    noise = diffuser.sample_inversion(labelled(model, class_A), images)
    generator = torch.Generator(device=images.device).manual_seed(0)  # eta 0 draws nothing
    return diffuser.sample(labelled(model, class_B), noise, generator)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, device, conf, shape = open_cli(build_parser(), argv, "sample_ddib")
    logger = get_logger()
    diffuser = DDIM(**diffusion_params(args, conf))
    model = load_model(args, conf, device)
    logger.info(f"Loaded weights from {args.weights} on {device}")
    dp = DataParallelSampler()
    os.makedirs(args.save_dir, exist_ok=True)
    for i, n, batch in image_batches(args.input_dir, shape[1], args.n_samples, args.batch_size):
        out = to_nhwc(dp.run(lambda x: translate_batch(model, diffuser, x, args.class_A,
                                                       args.class_B), to_device(batch, device)))
        for b in range(len(batch) if dp.is_main else 0):
            save_image_grid(np.stack([batch[b], out[b]]),
                            os.path.join(args.save_dir, f"{i + b}.png"), nrow=2)
        logger.info(f"Translated {i + len(batch)}/{n}")
    logger.info("Done")


if __name__ == "__main__":
    main()
