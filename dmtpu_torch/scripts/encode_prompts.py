"""Cache SD3/MMDiT text conditioning to the .npz ``sample_mmdit`` consumes.

    python -m dmtpu_torch.scripts.encode_prompts --out emb.npz \\
        --prompts "a cat" "a dog"                      # demo shapes 154/4096/2048
    python -m dmtpu_torch.scripts.encode_prompts --out emb.npz --prompts "a cat" \\
        --clip_l_weights l.npz --clip_g_weights g.npz --t5_dir /path/to/local/t5 \\
        --clip_tokenizer /path/to/local/clip-tokenizer

Counterpart of ``scripts/encode_prompts.py``, with its flags, defaults and
messages plus ``--device`` (default ``cuda``: without a card the CLI fails
unless ``--device cpu`` is given).  The SD3 recipe:

  clip_l : CLIP ViT-L       penultimate (no final LN) hidden [77,  768]
                            + pooled (EOT token, final-LN)          768
  clip_g : open_clip bigG   penultimate-nonorm hidden       [77, 1280]
                            + projected pooled                     1280
  t5     : T5-XXL encoder   last hidden                     [77, 4096]
                            (zeros with --no_t5)

  context = concat_tokens( zero_pad_width( concat_width(l, g) ), t5 )
            -> [154, 4096]
  pooled  = concat(l_pooled, g_pooled) -> [2048]

Two modes: demo (no tower weights: the pseudo-embeddings of
``sample_mmdit --prompt``, byte for byte) and real (``--clip_l_weights`` /
``--clip_g_weights``, ``--t5_dir`` or ``--no_t5``, ``--clip_tokenizer``).  A
tower file is a JAX-package ``.npz`` export (``params``, read through the
Flax bridge, and the ``config`` that ``scripts/convert_checkpoint.py``
embeds) or a torch file (a state dict of ``CLIPTextTransformer`` or of HF's
``CLIPTextModel``, alone or under ``state_dict`` with a ``config`` beside
it).  The tower's shape is the file's config, else the preset's; its head
count the config's ``heads``, else the preset's (the width is never divided
by 64 to guess it).  ``--t5_dir`` is a local ``T5EncoderModel`` directory
with torch weights and its tokenizer.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dmtpu_torch.scripts.sample_mmdit import demo_embeddings
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.utils.logger import get_logger


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--prompts", nargs="+", default=None)
    p.add_argument("--prompts_file", type=str, default=None,
                   help="one prompt per line (mutually additive with --prompts)")
    p.add_argument("--include_uncond", action="store_true",
                   help="append one all-zeros row (the CFG null — identical "
                        "to MMDiT.null_conditioning / training dropout)")
    # demo-mode shapes (defaults = configs/sd3_medium.yaml)
    p.add_argument("--context_len", type=int, default=154)
    p.add_argument("--context_dim", type=int, default=4096)
    p.add_argument("--pooled_dim", type=int, default=2048)
    # real towers
    p.add_argument("--clip_l_weights", type=str, default=None)
    p.add_argument("--clip_g_weights", type=str, default=None)
    p.add_argument("--t5_dir", type=str, default=None,
                   help="local HF T5 encoder checkpoint+tokenizer dir")
    p.add_argument("--no_t5", action="store_true",
                   help="zero-fill the T5 half of the context (T5-less "
                        "serving, supported by the SD3 release)")
    p.add_argument("--clip_tokenizer", type=str,
                   default=os.environ.get("DMTPU_CLIP_TOKENIZER"),
                   help="local CLIPTokenizer dir (both CLIP towers share "
                        "the BPE vocab)")
    p.add_argument("--max_length", type=int, default=77)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def demo_rows(prompts, context_len: int, context_dim: int, pooled_dim: int):
    """Deterministic pseudo-embeddings ([N, L, Dc], [N, Dp] f32), the rows of
    ``sample_mmdit --prompt`` byte for byte."""
    rows = [demo_embeddings(text, context_len, context_dim, pooled_dim) for text in prompts]
    return np.concatenate([c for c, _ in rows]), np.concatenate([p for _, p in rows])


def assemble_sd3(l_hidden, l_pooled, g_hidden, g_pooled, t5_hidden):
    """The SD3 context / pooled assembly (shapes [B, T, *] / [B, *]): the CLIP
    halves concatenated on width and zero-padded to the T5 width, the T5
    tokens appended on the sequence axis; pooled is the L|G concatenation."""
    clip = torch.cat([l_hidden, g_hidden], dim=-1)
    wt = t5_hidden.shape[-1]
    if clip.shape[-1] > wt:
        raise ValueError(f"CLIP joint width {clip.shape[-1]} exceeds the "
                         f"T5/context width {wt}")
    clip = F.pad(clip, (0, wt - clip.shape[-1]))
    context = torch.cat([clip, t5_hidden], dim=1)
    pooled = torch.cat([l_pooled, g_pooled], dim=-1)
    return context, pooled


def build_towers(args: argparse.Namespace, device=None):
    """(clip_l, clip_g, t5_embedder_or_None): the CLIP embedders as shells on
    the meta device (``load_tower`` gives them their towers), T5 loaded from
    ``--t5_dir`` at first use on ``device``.  Separated for test injection."""
    from dmtpu_torch.models.stablediffusion.text_encoders import (
        FrozenCLIPEmbedder,
        FrozenOpenCLIPEmbedder,
        FrozenT5Embedder,
    )

    clip_l = FrozenCLIPEmbedder("clip-vit-l", max_length=args.max_length, device="meta")
    clip_g = FrozenOpenCLIPEmbedder("open-clip-vit-bigg", max_length=args.max_length,
                                    device="meta")
    t5 = None
    if not args.no_t5:
        t5 = FrozenT5Embedder(args.t5_dir, max_length=args.max_length, device=device)
    return clip_l, clip_g, t5


def encode_real(prompts, clip_l, clip_g, t5, context_dim: Optional[int] = None):
    """Run the towers and assemble; ``t5=None`` zero-fills the T5 half at
    ``context_dim`` width (required in that case)."""
    def tower(embedder):
        device = next(embedder.model.parameters()).device
        ids = torch.as_tensor(embedder.tokenize(prompts), dtype=torch.long, device=device)
        with torch.no_grad():
            # penultimate-nonorm hidden + pooled: SDXL's call shape; bigG's
            # pooled goes through its text_projection
            return embedder.model(ids, output_layer="penultimate-nonorm", return_pooled=True)

    l_h, l_p = tower(clip_l)
    g_h, g_p = tower(clip_g)
    if t5 is not None:
        t5_h = t5.encode(prompts)
    else:
        if context_dim is None:
            raise ValueError("--no_t5 needs --context_dim for the zero fill")
        t5_h = l_h.new_zeros((l_h.shape[0], l_h.shape[1], context_dim))
    return assemble_sd3(l_h, l_p, g_h, g_p, t5_h)


def load_tower(path: str, fallback_cfg: str, max_length: int, device=None):
    """A tower file -> ``CLIPTextTransformer`` with its weights, on ``device``:
    a JAX-package ``.npz`` export (through the bridge) or a torch file.  Its
    shape comes from the config embedded in the file, else from the preset
    ``fallback_cfg``; so does its head count."""
    from dmtpu_torch.convert.sd import hf_clip_text_strip
    from dmtpu_torch.models.stablediffusion.text_encoders import (
        CLIP_TEXT_CONFIGS,
        CLIPTextTransformer,
    )

    if path.endswith(".npz"):
        from dmtpu_torch.convert import load_flax_params
        from dmtpu_torch.scripts._common import load_npz_params

        with np.load(path, allow_pickle=True) as data:
            cfg = json.loads(str(data["config"])) if "config" in data else None
        params, state = load_npz_params(path), None
    else:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        cfg = blob.pop("config", None)
        state = hf_clip_text_strip(blob.get("state_dict", blob))
    preset = dict(CLIP_TEXT_CONFIGS[fallback_cfg])
    if cfg is None:
        cfg, ml = preset, max_length
    else:
        cfg = dict(cfg)
        ml = cfg.pop("max_length", max_length)
        cfg.setdefault("heads", preset["heads"])
    model = CLIPTextTransformer(max_length=ml, device=device, **cfg)
    if state is None:
        load_flax_params(model, params)
    else:
        model.load_state_dict(state)
    return model.eval()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = get_parser().parse_args(argv)
    logger = get_logger()
    prompts = list(args.prompts or [])
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts += [ln.rstrip("\n") for ln in f if ln.strip()]
    if not prompts:
        raise SystemExit("no prompts: pass --prompts and/or --prompts_file")

    real = args.clip_l_weights or args.clip_g_weights
    if real:
        if not (args.clip_l_weights and args.clip_g_weights):
            raise SystemExit("real mode needs BOTH --clip_l_weights and "
                             "--clip_g_weights")
        if not args.t5_dir and not args.no_t5:
            raise SystemExit("real mode needs --t5_dir or --no_t5")
        if not args.clip_tokenizer:
            raise SystemExit("real mode needs --clip_tokenizer (local "
                             "CLIPTokenizer dir; DMTPU_CLIP_TOKENIZER works)")
    try:
        device = resolve_device(args.device, cli="encode_prompts")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    if real:
        from transformers import CLIPTokenizer

        clip_l, clip_g, t5 = build_towers(args, device)
        clip_l.tokenizer = clip_g.tokenizer = \
            CLIPTokenizer.from_pretrained(args.clip_tokenizer, local_files_only=True)
        # the tower config the file carries (a projected clip_l or a width
        # other than the preset's would otherwise not fit)
        clip_l.model = load_tower(args.clip_l_weights, "clip-vit-l", args.max_length, device)
        clip_g.model = load_tower(args.clip_g_weights, "open-clip-vit-bigg", args.max_length,
                                  device)
        clip_l.max_length = clip_l.model.max_length
        clip_g.max_length = clip_g.model.max_length
        ctx, pool = encode_real(prompts, clip_l, clip_g, t5, context_dim=args.context_dim)
        ctx, pool = ctx.float().cpu().numpy(), pool.float().cpu().numpy()
        logger.info(f"encoded {len(prompts)} prompt(s) through the towers on {device}"
                    + (" (T5 zero-filled)" if t5 is None else ""))
    else:
        ctx, pool = demo_rows(prompts, args.context_len, args.context_dim, args.pooled_dim)
        logger.warning("no tower weights: DEMO pseudo-embeddings (match "
                       "sample_mmdit --prompt rows)")

    if args.include_uncond:
        ctx = np.concatenate([ctx, np.zeros_like(ctx[:1])])
        pool = np.concatenate([pool, np.zeros_like(pool[:1])])
    np.savez(args.out, context=ctx, pooled=pool)
    logger.info(f"Wrote {args.out}: context {ctx.shape}, pooled {pool.shape}")


if __name__ == "__main__":
    main()
