"""MMDiT (SD3-class) text-to-image sampling with the flow samplers.

    python -m dmtpu_torch.scripts.sample_mmdit -c configs/sd3_medium.yaml \\
        --prompt "a photo of a cat" --save_dir out --n_samples 2 --batch_size 2 \\
        model.params.dtype=bfloat16

Counterpart of ``scripts/sample_mmdit.py``, with its flags plus ``--device``
(default ``cuda``: without a card the CLI fails unless ``--device cpu`` is
given).  Conditioning -> a flow sampler (``FlowMatching[CFG]``, Euler or
Heun, or ``FlowDPMSolver[CFG]``; with guidance the conditional and
unconditional halves run as ONE model call on the doubled batch, the null
conditioning all zeros) -> the VAE decode ``z / scale_factor +
shift_factor`` when the config has a ``vae`` section -> PNGs
``save_dir/{i}.png``.

Conditioning, exactly one of:
  --embeddings emb.npz   ``context`` [L, Dc] or [N, L, Dc] and ``pooled``
                         [Dp] or [N, Dp], ranks in any combination; the N
                         rows cycle over the samples
  --class_idx K          item K of the config's dataset
                         (``SyntheticEmbedded``: class K's embeddings)
  --prompt "..."         demo pseudo-embeddings hashed from the text, the
                         same bytes as the JAX CLI's; random weights only
Weights: omitted for random-init demo mode; a JAX-package ``.npz`` export
(through the bridge), a torch file in the port's keys, or an SD3
``.safetensors`` / ``.ckpt`` (through ``convert_mmdit``; set
``model.params.pos_embed_max_size`` to the release's base grid, 192 for
SD3-medium).  ``--vae_weights`` takes the same kinds (``convert_sd3_vae``).

Differences from the JAX CLI: ``--guidance_scale`` defaults to the config's
``diffusion.params.guidance_scale``, then 4.0 (the JAX CLI drops the
config's value); each batch draws its noise from a generator seeded by
(seed, batch index), other draws than the JAX CLI's ``fold_in``; the
orbax train-state directory is not ported.  Under ``torchrun`` each rank
samples its rows of every batch (``DataParallelSampler``) and rank 0 writes
the files.  ``sample_mmdit`` is the request as a function; it takes a
ready model and sampler and needs no file.
"""
from __future__ import annotations

import argparse
import hashlib
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dmtpu_torch.convert.zoo import convert_mmdit, convert_sd3_vae
from dmtpu_torch.diffusions import FlowDPMSolver, FlowDPMSolverCFG, FlowMatching, FlowMatchingCFG
from dmtpu_torch.scripts._common import (
    DataParallelSampler,
    diffusion_params,
    load_conf,
    load_model_params,
    open_device,
)
from dmtpu_torch.utils.config import instantiate_from_config
from dmtpu_torch.utils.image import save_image
from dmtpu_torch.utils.logger import get_logger
from dmtpu_torch.utils.misc import amortize

DEFAULT_GUIDANCE = 4.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--weights", type=str, default=None,
                   help=".npz / torch file / SD3 .safetensors|.ckpt; omit for random-init demo")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--guidance_scale", type=float, default=None,
                   help=f"1.0 disables CFG (one conditional call); default: the config's "
                        f"diffusion.params.guidance_scale, else {DEFAULT_GUIDANCE}")
    p.add_argument("--respace_type", type=str, default="uniform")
    p.add_argument("--respace_steps", type=int, default=None)
    p.add_argument("--solver", type=str, choices=["euler", "heun", "dpm"], default=None,
                   help="dpm = FlowDPM, second-order multistep")
    p.add_argument("--time_shift", type=float, default=None,
                   help="SD3 resolution time shift (3.0 for SD3-medium)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--embeddings", type=str, default=None,
                     help=".npz with 'context' / 'pooled' cached embeddings")
    src.add_argument("--class_idx", type=int, default=None,
                     help="conditioning from item K of the config's dataset")
    src.add_argument("--prompt", type=str, default=None,
                     help="demo pseudo-embeddings (random init only)")
    p.add_argument("--context_len", type=int, default=None,
                   help="pseudo-embedding context length (default: the dataset's)")
    p.add_argument("--vae_weights", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def demo_embeddings(text: str, context_len: int, context_dim: int, pooled_dim: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic pseudo-embeddings of a prompt ([1, L, Dc], [1, Dp] f32):
    the JAX CLI's bytes (sha256 of the text seeds a ``RandomState``).  NOT a
    text encoding."""
    digest = hashlib.sha256(f"dmtpu-mmdit:{text}".encode()).digest()
    rs = np.random.RandomState(int.from_bytes(digest[:4], "little"))
    return (rs.randn(1, context_len, context_dim).astype(np.float32),
            rs.randn(1, pooled_dim).astype(np.float32))


def conditioning(args: argparse.Namespace, conf) -> Tuple[np.ndarray, np.ndarray]:
    """(context [N, L, Dc], pooled [N, Dp]) f32 host arrays; the N rows cycle."""
    logger = get_logger()
    if args.embeddings is not None:
        with np.load(args.embeddings) as data:
            ctx, pool = np.asarray(data["context"]), np.asarray(data["pooled"])
        # the ranks are independent: [L, Dc] or [N, L, Dc]; [Dp] or [N, Dp]
        ctx = ctx[None] if ctx.ndim == 2 else ctx
        pool = pool[None] if pool.ndim == 1 else pool
        if ctx.shape[0] != pool.shape[0]:
            raise SystemExit(f"--embeddings row-count mismatch: context has {ctx.shape[0]} "
                             f"rows, pooled {pool.shape[0]}")
        return ctx.astype(np.float32), pool.astype(np.float32)
    if args.class_idx is not None:
        ds = instantiate_from_config(conf.data)
        n_classes = conf.data.params.get("n_classes", 1)
        if not 0 <= args.class_idx < min(n_classes, len(ds)):
            raise SystemExit(f"--class_idx {args.class_idx} out of range [0, {n_classes})")
        # SyntheticEmbedded's class is index % n_classes: item K carries class K's embedding
        item = ds[args.class_idx]
        if not (isinstance(item, dict) and {"context", "pooled"} <= set(item)):
            raise SystemExit("--class_idx needs a dataset with cached 'context' / 'pooled' "
                             "embeddings per item")
        return (np.asarray(item["context"])[None].astype(np.float32),
                np.asarray(item["pooled"])[None].astype(np.float32))
    if args.weights is not None:
        raise SystemExit("--prompt pseudo-embeddings are only allowed in random-init demo mode; "
                         "real checkpoints need --embeddings or --class_idx (cached-embedding "
                         "workflow)")
    text = args.prompt or ""
    mp = conf.model.params
    context_len = args.context_len or conf.data.params.get("context_len", 77)
    logger.warning(f"pseudo-embeddings for prompt {text!r} (demo mode)")
    return demo_embeddings(text, context_len, mp.context_dim, mp.pooled_dim)


def make_diffuser(args: argparse.Namespace, conf) -> FlowMatching:
    """The flow sampler: the config's ``diffusion.params``, the CLI's
    respacing, ``--solver`` and ``--time_shift``.  Solver precedence: the
    flag, then ``params.solver``, then a ``FlowDPM`` target.  The guidance
    scale: the flag, then the config's, then 4.0; at 1.0 the sampler is the
    unguided one."""
    dparams = diffusion_params(args, conf)
    if args.solver is not None:
        dparams["solver"] = args.solver
    if args.time_shift is not None:
        dparams["time_shift"] = args.time_shift
    config_scale = dparams.pop("guidance_scale", None)
    gs = args.guidance_scale if args.guidance_scale is not None else (
        DEFAULT_GUIDANCE if config_scale is None else float(config_scale))
    solver = dparams.get("solver")
    if solver is None and "FlowDPM" in str(conf.diffusion.get("target", "")):
        solver = "dpm"
    if gs == 1.0:
        return (FlowDPMSolver if solver == "dpm" else FlowMatching)(**dparams)
    return (FlowDPMSolverCFG if solver == "dpm" else FlowMatchingCFG)(guidance_scale=gs, **dparams)


def build_model(conf, weights: Optional[str], device: torch.device) -> nn.Module:
    """The config's MMDiT on ``device`` in eval mode, with ``weights`` loaded
    (None: its own random init, demo mode)."""
    logger = get_logger()
    model = instantiate_from_config(conf.model, device=device)
    if weights is None:
        logger.warning("no --weights: RANDOM init (demo mode)")
    else:
        if not weights.endswith(".npz"):
            logger.info(f"Converting {weights} through convert_mmdit")
        load_model_params(weights, model, converter=convert_mmdit)
    return model.eval()


class LatentDecoder(nn.Module):
    """``z -> images`` through a VAE: ``vae.decode(z / scale_factor + shift_factor)``."""

    def __init__(self, vae: nn.Module, scale_factor: float = 1.0, shift_factor: float = 0.0):
        super().__init__()
        self.vae, self.scale_factor, self.shift_factor = vae, scale_factor, shift_factor

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor + self.shift_factor)


def build_decoder(conf, vae_weights: Optional[str], device: torch.device
                  ) -> Optional[LatentDecoder]:
    """The decoder of the config's ``vae`` section with ``vae_weights`` loaded
    (None: its own random init, demo mode), or None without a ``vae``."""
    if not conf.get("vae"):
        return None
    vae = instantiate_from_config(conf.vae, device=device)
    if vae_weights:
        load_model_params(vae_weights, vae, converter=convert_sd3_vae)
    else:
        get_logger().warning("vae: RANDOM init (demo mode)")
    return LatentDecoder(vae, float(conf.vae.get("scale_factor", 1.0)),
                         float(conf.vae.get("shift_factor", 0.0))).eval()


def batch_seed(seed: int, index: int) -> int:
    """The generator seed of batch ``index``: a function of (seed, index)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


def _noise(batch: int, shape: Sequence[int], generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    return torch.randn(batch, *shape, generator=generator, device=device)


@torch.no_grad()
def sample_mmdit(model: nn.Module, diffuser: FlowMatching, context: Any, pooled: Any,
                 n_samples: int, *, shape: Sequence[int], batch_size: int = 4, seed: int = 2022,
                 decode: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 device: Any = "cuda", dp: Optional[DataParallelSampler] = None
                 ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """One request: ``n_samples`` images in [-1, 1], [N, C, H, W] on the
    device, and on a card the stages' times in ms by CUDA events
    (``{"sample": ..., "decode": ...}`` summed over the batches; empty on the
    CPU).  ``context`` [R, L, Dc] and ``pooled`` [R, Dp] rows cycle over the
    samples; noise of ``shape`` (C, H, W) from a generator seeded by (seed,
    batch index); with a CFG sampler the unconditional branch is
    ``model.null_conditioning``; ``dp`` shares each batch's rows out over the
    ranks."""
    dev = torch.device(device)
    dp = dp or DataParallelSampler()
    context = torch.as_tensor(context, dtype=torch.float32, device=dev)
    pooled = torch.as_tensor(pooled, dtype=torch.float32, device=dev)
    guided = isinstance(diffuser, FlowMatchingCFG)
    events = []

    def mark(name: str) -> None:
        if dev.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append((name, event))

    out, start = [], 0
    mark("begin")
    for i, bs in enumerate(amortize(n_samples, batch_size)):
        rows = torch.arange(start, start + bs, device=dev) % context.shape[0]
        start += bs
        generator = torch.Generator(device=dev).manual_seed(batch_seed(seed, i))
        noise = _noise(bs, shape, generator, dev)

        def one(noise, ctx, pool, generator):
            kwargs = dict(model_kwargs={"y": {"context": ctx, "pooled": pool}})
            if guided:
                kwargs["uncond_conditioning"] = model.null_conditioning(
                    len(noise), context.shape[1], device=dev)
            z = diffuser.sample(lambda x, t, y=None, **kw: model(x, t, y), noise, generator,
                                **kwargs)
            mark("sample")
            if decode is not None:
                z = decode(z)
                mark("decode")
            return z

        out.append(dp.run(one, noise, context[rows], pooled[rows], generator=generator)
                   .float().clamp(-1.0, 1.0))
    stage_ms: Dict[str, float] = {}
    if events:
        events[-1][1].synchronize()
        for (_, before), (name, after) in zip(events, events[1:]):
            stage_ms[name] = stage_ms.get(name, 0.0) + before.elapsed_time(after)
    return torch.cat(out), stage_ms


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, unknown = build_parser().parse_known_args(argv)
    logger = get_logger()
    device = open_device(args.device, "sample_mmdit")
    dp = DataParallelSampler()
    conf = load_conf(args, unknown)
    size = conf.data.params.img_size
    shape = (conf.data.get("img_channels", conf.model.params.get("in_channels", 3)), size, size)
    context, pooled = conditioning(args, conf)
    model = build_model(conf, args.weights, device)
    diffuser = make_diffuser(args, conf)
    decode = build_decoder(conf, args.vae_weights, device)
    logger.info(f"MMDiT on {device}; {type(diffuser).__name__}, "
                f"{len(diffuser.respaced_seq)} steps")
    images, stage_ms = sample_mmdit(model, diffuser, context, pooled, args.n_samples,
                                    shape=shape, batch_size=args.batch_size, seed=args.seed,
                                    decode=decode, device=device, dp=dp)
    os.makedirs(args.save_dir, exist_ok=True)
    for idx, img in enumerate(images.permute(0, 2, 3, 1).cpu().numpy() if dp.is_main else []):
        save_image(img, os.path.join(args.save_dir, f"{idx}.png"))
    logger.info(f"Sampled {len(images)} -> {args.save_dir}"
                + (f"; stages (ms) {stage_ms}" if stage_ms else ""))


if __name__ == "__main__":
    main()
