"""SDEdit: stroke-guided image editing.

    python -m dmtpu_torch.scripts.sample_sdedit -c configs/ddpm_celebahq.yaml \\
        --weights ckpt.pt --save_dir out --input_dir strokes --edit_steps 50 \\
        --respace_steps 100 [--n_samples N] [--var_type fixed_small] [key=value ...]

Counterpart of ``scripts/sample_sdedit.py`` (reference:
scripts/sample_sdedit.py:123-168), with the same flags plus ``--device``
(default ``cuda``).  Each input image (``ImageDir``) is diffused to the
respaced step ``t_edit = respaced_seq[edit_steps - 1]`` and denoised back by
the tail of the DDPM loop: the last ``edit_steps`` rows of its tape
(``start_step = S - edit_steps``, the tape being in descending t).  Each
``save_dir/{i}.png`` is the input beside its edit.

Noise: the JAX CLI folds the batch's first index into its key; here each
batch draws from one generator on the device seeded from (seed, first
index): first the noise that diffuses the input, then the sampler's steps.
``edit_batch`` is one batch's request as a function.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from dmtpu_torch.diffusions import DDPM
from dmtpu_torch.scripts._common import (
    DataParallelSampler,
    base_parser,
    diffusion_params,
    to_device,
)
from dmtpu_torch.scripts._editing import image_batches, load_model, open_cli, to_nhwc
from dmtpu_torch.scripts.sample_uncond import fold_generator, model_function
from dmtpu_torch.utils import rows
from dmtpu_torch.utils.image import save_image_grid
from dmtpu_torch.utils.logger import get_logger


def build_parser() -> argparse.ArgumentParser:
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--input_dir", type=str, required=True,
                   help="Directory of stroke paintings to edit")
    p.add_argument("--edit_steps", type=int, required=True,
                   help="Diffuse to this (respaced) step before denoising back")
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--var_type", type=str, default=None)
    return p


def edit_rows(diffuser: DDPM, edit_steps: int) -> tuple[int, int]:
    """(t_edit, the tape row the partial denoise starts at).
    (reference: scripts/sample_sdedit.py:141-157)"""
    S = len(diffuser.respaced_seq)
    if not 0 < edit_steps <= S:
        raise ValueError(f"edit_steps must be in (0, {S}], got {edit_steps}")
    return int(diffuser.respaced_seq[edit_steps - 1]), S - edit_steps


@torch.no_grad()
def edit_batch(model_fn: Callable, diffuser: DDPM, images: torch.Tensor, edit_steps: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``images`` [B, C, H, W] in [-1, 1] diffused to ``t_edit`` with noise
    from ``generator``, then denoised over the last ``edit_steps`` rows
    (the sampler's draws from the same generator); unclipped."""
    t_edit, start_row = edit_rows(diffuser, edit_steps)
    eps = rows.randn(images.shape, generator, images.device)
    xt = diffuser.diffuse(images, torch.full((images.shape[0],), t_edit, device=images.device),
                          eps)
    return diffuser.sample(model_fn, xt, generator, start_step=start_row)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, device, conf, shape = open_cli(build_parser(), argv, "sample_sdedit")
    logger = get_logger()
    extra: dict[str, Any] = {"var_type": args.var_type} if args.var_type else {}
    diffuser = DDPM(**diffusion_params(args, conf, **extra))
    edit_rows(diffuser, args.edit_steps)  # refuse a bad --edit_steps before any work
    model_fn = model_function(load_model(args, conf, device))
    logger.info(f"Loaded weights from {args.weights} on {device}")
    dp = DataParallelSampler()
    os.makedirs(args.save_dir, exist_ok=True)
    for i, n, batch in image_batches(args.input_dir, shape[1], args.n_samples, args.batch_size):
        generator = fold_generator(args.seed, i, device)
        edited = to_nhwc(dp.run(lambda x, generator: edit_batch(
            model_fn, diffuser, x, args.edit_steps, generator), to_device(batch, device),
            generator=generator))
        for b in range(len(batch) if dp.is_main else 0):
            save_image_grid(np.stack([batch[b], edited[b]]),
                            os.path.join(args.save_dir, f"{i + b}.png"), nrow=2)
        logger.info(f"Edited {i + len(batch)}/{n}")
    logger.info("Done")


if __name__ == "__main__":
    main()
