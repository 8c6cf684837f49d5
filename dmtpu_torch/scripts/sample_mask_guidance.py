"""Inpainting with mask guidance, optionally with RePaint's resampling.

    python -m dmtpu_torch.scripts.sample_mask_guidance -c configs/ddpm_celebahq.yaml \\
        --weights ckpt.pt --save_dir out --input_dir images --mask_type center \\
        [--resample --resample_r 10 --resample_j 10] [--n_samples N] [key=value ...]

Counterpart of ``scripts/sample_mask_guidance.py`` (reference:
scripts/sample_mask_guidance.py:132-181), with the same flags plus
``--device`` (default ``cuda``).  Each input image (``ImageDir``) gets the
mask ``MaskGenerator`` draws for its index (``--mask_type``: center, rect,
brush, half, every-second-line, sr2x; seeded by ``index + 3407``, the same
masks as the JAX package's); the known region is written back at every step
(``MaskGuidance``), over RePaint's jump schedule with ``--resample``.  Each
``save_dir/{i}.png`` is a triptych: the image, the masked image (the hole
white) and the inpainted one.

Noise: each batch draws from one generator on the device seeded from (seed,
first index): first the initial noise, then the sampler's steps (a denoise
step its reverse noise and then the known region's, a RePaint re-noise step
its forward noise).  ``inpaint_batch`` is one batch's request as a function.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from dmtpu_torch.data.image_dir import ImageDir
from dmtpu_torch.diffusions.guidance import MaskGuidance
from dmtpu_torch.scripts._common import (
    DataParallelSampler,
    base_parser,
    diffusion_params,
    to_device,
)
from dmtpu_torch.scripts._editing import load_model, open_cli, to_nhwc
from dmtpu_torch.scripts.sample_uncond import fold_generator, model_function
from dmtpu_torch.utils import rows
from dmtpu_torch.utils.image import save_image_grid
from dmtpu_torch.utils.logger import get_logger
from dmtpu_torch.utils.mask import DatasetWithMask


def build_parser() -> argparse.ArgumentParser:
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--mask_type", type=str, default="brush")
    p.add_argument("--resample", action="store_true", help="RePaint resampling")
    p.add_argument("--resample_r", type=int, default=10)
    p.add_argument("--resample_j", type=int, default=10)
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--var_type", type=str, default=None)
    return p


@torch.no_grad()
def inpaint_batch(model_fn: Callable, diffuser: MaskGuidance, images: torch.Tensor,
                  masks: torch.Tensor, generator: Optional[torch.Generator] = None,
                  resample: bool = False, resample_r: int = 10,
                  resample_j: int = 10) -> torch.Tensor:
    """``images`` [B, C, H, W] in [-1, 1] inpainted where ``masks``
    [B, 1, H, W] is 0, from noise drawn from ``generator`` (the sampler's
    draws follow); unclipped."""
    noise = rows.randn(images.shape, generator, images.device)
    diffuser.set_mask_and_image(images * masks, masks)
    if resample:
        return diffuser.resample(model_fn, noise, generator, resample_r=resample_r,
                                 resample_j=resample_j)
    return diffuser.sample(model_fn, noise, generator)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, device, conf, shape = open_cli(build_parser(), argv, "sample_mask_guidance")
    logger = get_logger()
    extra: dict[str, Any] = {"var_type": args.var_type} if args.var_type else {}
    diffuser = MaskGuidance(**diffusion_params(args, conf, **extra))
    model_fn = model_function(load_model(args, conf, device))
    logger.info(f"Loaded weights from {args.weights} on {device}")
    dataset = DatasetWithMask(ImageDir(args.input_dir, img_size=shape[1]),
                              mask_type=args.mask_type)
    n = min(args.n_samples or len(dataset), len(dataset))
    dp = DataParallelSampler()
    os.makedirs(args.save_dir, exist_ok=True)
    for i in range(0, n, args.batch_size):
        items = [dataset[j] for j in range(i, min(i + args.batch_size, n))]
        imgs = np.stack([it[0] for it in items])
        masks = np.stack([it[1] for it in items])
        generator = fold_generator(args.seed, i, device)
        out = to_nhwc(dp.run(lambda x, m, generator: inpaint_batch(
            model_fn, diffuser, x, m, generator, args.resample, args.resample_r,
            args.resample_j), to_device(imgs, device), to_device(masks, device),
            generator=generator))
        masked = imgs * masks
        for b in range(len(imgs) if dp.is_main else 0):
            trip = np.stack([imgs[b], masked[b] + (1 - masks[b]) * 1.0, out[b]])
            save_image_grid(trip, os.path.join(args.save_dir, f"{i + b}.png"), nrow=3)
        logger.info(f"Inpainted {i + len(imgs)}/{n}")
    logger.info("Done")


if __name__ == "__main__":
    main()
