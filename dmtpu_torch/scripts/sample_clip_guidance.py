"""CLIP-guided text-conditional sampling.

    python -m dmtpu_torch.scripts.sample_clip_guidance -c configs/ddpm_celebahq.yaml \\
        --weights ckpt.pt --save_dir out --text "a smiling face" --n_samples 8 \\
        --clip_pretrained <local CLIP dir> [--guidance_weight 100] [key=value ...]

Counterpart of ``scripts/sample_clip_guidance.py`` (reference:
scripts/sample_clip_guidance.py:101-158), with the same flags plus
``--device`` (default ``cuda``).  ``--clip_pretrained`` is a LOCAL
directory that ``transformers``' torch ``CLIPModel`` and ``CLIPTokenizer``
load (nothing is downloaded); CLIP runs on the same device as the model.
Every DDPM step moves the posterior mean along the gradient of the
CLIP similarity between the predicted x0 and the text
(``dmtpu_torch.diffusions.guidance.CLIPGuidance``).  ``n_samples`` images
in folds of ``batch_size`` (``amortize``), ``save_dir/{i}.png``.

Noise: each fold draws from one generator on the device seeded from (seed,
fold): first the initial noise, then the sampler's steps.  The request of a
fold is ``sample_uncond.sample_fold`` with this CLI's sampler.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Optional, Sequence

from dmtpu_torch.diffusions.guidance.clip_guidance import CLIPGuidance
from dmtpu_torch.scripts._common import DataParallelSampler, base_parser, diffusion_params
from dmtpu_torch.scripts._editing import load_model, open_cli, to_nhwc
from dmtpu_torch.scripts.sample_uncond import model_function, sample_fold
from dmtpu_torch.utils.image import save_image
from dmtpu_torch.utils.logger import get_logger
from dmtpu_torch.utils.misc import amortize


def build_parser() -> argparse.ArgumentParser:
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--text", type=str, required=True)
    p.add_argument("--guidance_weight", type=float, default=100.0)
    p.add_argument("--clip_pretrained", type=str, default="openai/clip-vit-base-patch32",
                   help="Local path to a HF CLIP checkpoint")
    p.add_argument("--n_samples", type=int, required=True)
    p.add_argument("--var_type", type=str, default=None)
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, device, conf, shape = open_cli(build_parser(), argv, "sample_clip_guidance")
    logger = get_logger()
    extra: dict[str, Any] = {"var_type": args.var_type} if args.var_type else {}
    diffuser = CLIPGuidance(guidance_weight=args.guidance_weight,
                            clip_pretrained=args.clip_pretrained, device=device,
                            **diffusion_params(args, conf, **extra))
    diffuser.set_text(args.text)
    model_fn = model_function(load_model(args, conf, device))
    logger.info(f"Loaded weights from {args.weights} on {device}; text: {args.text!r}")
    dp = DataParallelSampler()
    os.makedirs(args.save_dir, exist_ok=True)
    idx = 0
    for fold, bs in enumerate(amortize(args.n_samples, args.batch_size)):
        images, _ = sample_fold(model_fn, diffuser, fold, bs, shape, args.seed, device, dp=dp)
        if dp.is_main:
            for b, img in enumerate(to_nhwc(images)):
                save_image(img, os.path.join(args.save_dir, f"{idx + b}.png"))
        idx += bs
        logger.info(f"Sampled {idx}/{args.n_samples}")
    logger.info("Done")


if __name__ == "__main__":
    main()
