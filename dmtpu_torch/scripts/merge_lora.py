"""Merge a trained LoRA adapter checkpoint into base SD weights for serving.

    python -m dmtpu_torch.scripts.merge_lora -c configs/sd15_lora.yaml \\
        --lora runs/exp-*/ckpt/step010000 [--base v1-5.ckpt] --out merged.pt \\
        [--no-ema] [--scale S] [--device cuda|cpu] [key.sub=value ...]

Counterpart of ``scripts/merge_lora.py``.  ``train_sd`` with ``train.lora``
saves a train state whose module (and EMA shadow) are the adapters alone
(``dmtpu_torch.models.lora``).  This CLI reads that checkpoint, merges
``W + scale · (a @ b)ᵀ`` into the base UNet once (``scale`` defaults to
alpha / rank from the config), and writes the whole ``StableDiffusion`` as a
torch state dict in the wrapper's own layout (``unet.`` / ``vae.`` /
``text_encoder.``), which ``StableDiffusion.load_weights`` reads.

``--base`` overrides the config's ``weights:``: a CompVis ``.ckpt`` /
``.safetensors``, a torch file in the wrapper's layout, or the JAX
package's ``.npz`` (what its ``merge_lora`` writes, read through the Flax
bridge; ``StableDiffusion.load_weights``).  With neither, the base is
seeded random parameters from ``seed`` on ``--device`` (the draws of the
training run when it ran on that device).  The merged file is written from
the CPU, as a torch state dict (writing the JAX ``.npz`` is not ported).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from dmtpu_torch.models.lora import lora_param_count, lora_scale, merge_lora
from dmtpu_torch.scripts._common import parse_overrides
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.scripts.train_sd import build_model
from dmtpu_torch.utils.checkpoint import load_checkpoint_host
from dmtpu_torch.utils.config import load_config, merge_dotlist
from dmtpu_torch.utils.logger import get_logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", type=str, required=True,
                   help="the train_sd config the adapters were trained with")
    p.add_argument("--lora", type=str, required=True,
                   help="LoRA checkpoint directory (runs/<exp>/ckpt/stepNNNNNN)")
    p.add_argument("--base", type=str, default=None,
                   help="base SD weights (.ckpt/.safetensors/.pt, or the JAX package's .npz); "
                        "default: the config's `weights:`")
    p.add_argument("--out", type=str, required=True, help="output .pt path")
    p.add_argument("--no-ema", action="store_true",
                   help="merge the raw adapters instead of their EMA shadow")
    p.add_argument("--scale", type=float, default=None,
                   help="override the merge scale (default alpha/rank from the config)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, unknown = build_parser().parse_known_args(argv)
    conf = merge_dotlist(load_config(args.config), parse_overrides(unknown))
    try:
        device = resolve_device(args.device, cli="merge_lora")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    logger = get_logger()
    lora_conf = conf.train.get("lora")
    if not lora_conf:
        raise ValueError("the config has no train.lora block: nothing to merge")
    scale = (args.scale if args.scale is not None
             else lora_scale(int(lora_conf["rank"]), lora_conf.get("alpha")))

    if args.base:
        conf["weights"] = args.base
    sd = build_model(conf, device, logger)
    restored = load_checkpoint_host(args.lora)
    which = "params"
    adapters = restored["model"]
    if not args.no_ema:
        if restored["ema"] is None:
            which = "params (no EMA in the checkpoint)"
        else:
            which, adapters = "ema", restored["ema"]["shadow"]
    logger.info(f"Merging {which}: {len(adapters) // 2} adapters "
                f"({lora_param_count(adapters) / 1e6:.3f}M params) at scale {scale:g}")
    with torch.no_grad():
        adapters = {k: v.to(device, torch.float32) for k, v in adapters.items()}
        sd.unet.load_state_dict(merge_lora(sd.unet.state_dict(), adapters, scale))
    torch.save({k: v.cpu() for k, v in sd.state_dict().items()}, args.out)
    logger.info(f"Wrote merged weights to {args.out}")


if __name__ == "__main__":
    main()
