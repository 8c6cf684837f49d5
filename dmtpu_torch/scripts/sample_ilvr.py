"""ILVR: sampling conditioned on the low frequencies of reference images.

    python -m dmtpu_torch.scripts.sample_ilvr -c configs/ddpm_celebahq.yaml \\
        --weights ckpt.pt --save_dir out --input_dir refs --downsample_factor 8 \\
        [--interp_method cubic|lanczos2|lanczos3|linear|box] [--n_samples N] [key=value ...]

Counterpart of ``scripts/sample_ilvr.py`` (reference:
scripts/sample_ilvr.py:101-161), with the same flags plus ``--device``
(default ``cuda``).  Each reference image (``ImageDir``) steers a DDPM
sample from fresh noise: every step adds φ(noised reference) − φ(sample),
φ the ResizeRight down / up round trip by ``--downsample_factor``
(``dmtpu_torch.diffusions.guidance.ILVR``).  Each ``save_dir/{i}.png`` is
the reference beside its sample.

Noise: each batch draws from one generator on the device seeded from (seed,
first index): first the initial noise, then the sampler's steps, each step
its reverse noise and then the reference's.  ``ilvr_batch`` is one batch's
request as a function.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from dmtpu_torch.diffusions.guidance import ILVR
from dmtpu_torch.ops.resize_right import INTERP_METHODS
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
                   help="Directory of reference images")
    p.add_argument("--downsample_factor", type=int, default=8)
    p.add_argument("--interp_method", type=str, default="cubic", choices=list(INTERP_METHODS))
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--var_type", type=str, default=None)
    return p


@torch.no_grad()
def ilvr_batch(model_fn: Callable, diffuser: ILVR, refs: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One sample per reference ``refs`` [B, C, H, W] in [-1, 1], from noise
    drawn from ``generator`` (the sampler's draws follow); unclipped."""
    noise = rows.randn(refs.shape, generator, refs.device)
    diffuser.set_ref_images(refs)
    return diffuser.sample(model_fn, noise, generator)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, device, conf, shape = open_cli(build_parser(), argv, "sample_ilvr")
    logger = get_logger()
    extra: dict[str, Any] = {"var_type": args.var_type} if args.var_type else {}
    diffuser = ILVR(downsample_factor=args.downsample_factor, interp_method=args.interp_method,
                    **diffusion_params(args, conf, **extra))
    model_fn = model_function(load_model(args, conf, device))
    logger.info(f"Loaded weights from {args.weights} on {device}")
    dp = DataParallelSampler()
    os.makedirs(args.save_dir, exist_ok=True)
    for i, n, refs in image_batches(args.input_dir, shape[1], args.n_samples, args.batch_size):
        generator = fold_generator(args.seed, i, device)
        out = to_nhwc(dp.run(lambda x, generator: ilvr_batch(model_fn, diffuser, x, generator),
                             to_device(refs, device), generator=generator))
        for b in range(len(refs) if dp.is_main else 0):
            save_image_grid(np.stack([refs[b], out[b]]),
                            os.path.join(args.save_dir, f"{i + b}.png"), nrow=2)
        logger.info(f"Sampled {i + len(refs)}/{n}")
    logger.info("Done")


if __name__ == "__main__":
    main()
