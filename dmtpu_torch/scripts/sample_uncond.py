"""Unconditional sampling in five modes.

    python -m dmtpu_torch.scripts.sample_uncond -c configs/ddpm_cifar10.yaml \\
        --weights ckpt.pt --save_dir out --n_samples 500 --sampler ddim --respace_steps 50 \\
        [--mode sample|denoise|progressive|interpolate|reconstruction] [key=value ...]

Counterpart of ``scripts/sample_uncond.py`` (reference:
scripts/sample_uncond.py), with the same flags, the same sampler x mode
matrix (``COMPATIBLE_SAMPLER_MODE``) and the same refusals, plus ``--device``
(default ``cuda``: without a card the CLI fails unless ``--device cpu`` is
given).  The modes:

- ``sample``: ``n_samples`` images, ``save_dir/{i}.png``;
- ``denoise`` / ``progressive``: a grid per sample of every
  ``S // n_denoise``-th x_t (or predicted x_0), ending at the last step;
- ``interpolate``: a grid per sample of ``n_interpolate`` images from the
  slerp between two noises;
- ``reconstruction``: the images of ``--input_dir`` (``ImageDir``),
  inverted (DDIM, or the flow ODE run backwards) and sampled again, each
  beside its reconstruction.

Samplers: ``ddpm``, ``ddim`` (``--ddim_eta``), ``euler``, ``heun``,
``dpmpp``, ``pfdiff``, ``flow`` (``--flow_solver``, ``--time_shift``) and
``flowdpm``, over the config's diffusion.  Models: every ported
unconditional pixel-space model ``(x, t)`` (``UNet``, ``UNetModel``,
``PesserUNet``, ``UNetCategorialAdaGN`` without labels), with ``--weights``
a JAX-package ``.npz`` export or a torch file in upstream keys
(``load_model_params``).  On the card the attention kernel takes bf16: give
an f32 config a bf16 torso (``model.params.dtype=bfloat16`` for the repo's
UNets, ``model.params.use_fp16=true`` for ADM).

Noise: the JAX CLI folds the batch index into its key; here each batch (a
fold of ``amortize(n_samples, batch_size)``, or a row of ``interpolate``)
draws its noise and then its sampler steps from one generator on the device
seeded from (seed, fold), so the draws differ from the JAX package's (the
tests compare the two on the same arrays).  Under ``torchrun`` each rank
samples its rows of every batch (``DataParallelSampler``: the one-rank
samples) and rank 0 writes the files.  ``sample_fold``, ``interpolate_row``
and ``reconstruct`` are the modes' work as functions, with a ready model and
sampler and no file.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dmtpu_torch.data.image_dir import ImageDir
from dmtpu_torch.diffusions import (
    DDIM,
    DDPM,
    DPMSolverPP,
    EulerSampler,
    FlowDPMSolver,
    FlowMatching,
    HeunSampler,
    PFDiffDDIM,
)
from dmtpu_torch.scripts._common import (
    DataParallelSampler,
    base_parser,
    diffusion_params,
    image_shape,
    load_conf,
    load_model_params,
    open_device,
)
from dmtpu_torch.scripts._editing import to_nhwc
from dmtpu_torch.utils.config import instantiate_from_config
from dmtpu_torch.utils.image import save_image, save_image_grid
from dmtpu_torch.utils.logger import get_logger
from dmtpu_torch.utils.misc import amortize

COMPATIBLE_SAMPLER_MODE = dict(
    ddpm=["sample", "denoise", "progressive"],
    ddim=["sample", "denoise", "progressive", "interpolate", "reconstruction"],
    euler=["sample", "denoise", "progressive", "interpolate"],
    heun=["sample", "denoise", "progressive", "interpolate"],
    # pfdiff's collected trajectory is one entry a pair of steps, so the
    # S-step grid of denoise / progressive does not apply
    dpmpp=["sample", "denoise", "progressive", "interpolate"],
    pfdiff=["sample", "interpolate"],
    # the flow ODE runs backwards exactly: reconstruction too
    flow=["sample", "denoise", "progressive", "interpolate", "reconstruction"],
    # the multistep history has no exact reverse: no reconstruction
    flowdpm=["sample", "denoise", "progressive", "interpolate"],
)
SAMPLERS = {"ddpm": DDPM, "ddim": DDIM, "euler": EulerSampler, "heun": HeunSampler,
            "dpmpp": DPMSolverPP, "pfdiff": PFDiffDDIM, "flow": FlowMatching,
            "flowdpm": FlowDPMSolver}
MODES = ["sample", "denoise", "progressive", "interpolate", "reconstruction"]


def build_parser() -> argparse.ArgumentParser:
    p = base_parser(__doc__.splitlines()[0])
    p.set_defaults(batch_size=500)
    p.add_argument("--n_samples", type=int, required=True)
    p.add_argument("--sampler", type=str, choices=list(COMPATIBLE_SAMPLER_MODE), default="ddpm")
    p.add_argument("--var_type", type=str, default=None)
    p.add_argument("--ddim_eta", type=float, default=0.0)
    # None defers to the config's ``solver`` / ``time_shift``
    p.add_argument("--flow_solver", type=str, choices=["euler", "heun"], default=None)
    p.add_argument("--time_shift", type=float, default=None,
                   help="SD3-style flow time shift (flow samplers only)")
    p.add_argument("--mode", type=str, default="sample", choices=MODES)
    p.add_argument("--n_denoise", type=int, default=20)
    p.add_argument("--n_progressive", type=int, default=20)
    p.add_argument("--n_interpolate", type=int, default=16)
    p.add_argument("--input_dir", type=str, required=False)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> Tuple[argparse.Namespace, list]:
    """(flags, the config's ``key=value`` overrides); a mode the sampler
    does not take raises, with the JAX CLI's message."""
    args, unknown = build_parser().parse_known_args(argv)
    if args.mode not in COMPATIBLE_SAMPLER_MODE[args.sampler]:
        raise ValueError(f"mode {args.mode} is incompatible with sampler {args.sampler}")
    return args, unknown


def build_diffuser(args: argparse.Namespace, conf) -> Any:
    """The sampler the flags name, over the config's diffusion."""
    extra: Dict[str, Any] = {}
    if args.var_type is not None:
        extra["var_type"] = args.var_type
    if args.sampler == "ddim":
        extra["eta"] = args.ddim_eta
    if args.sampler == "flow":
        if args.flow_solver is not None:
            extra["solver"] = args.flow_solver
        if args.time_shift is not None:
            extra["time_shift"] = args.time_shift
    if args.sampler == "flowdpm":
        if args.flow_solver is not None:
            raise SystemExit("--flow_solver applies to the flow sampler only; "
                             "flowdpm IS the solver")
        if args.time_shift is not None:
            extra["time_shift"] = args.time_shift
        extra["solver"] = "dpm"  # overrides a flow config's euler / heun
    return SAMPLERS[args.sampler](**diffusion_params(args, conf, **extra))


def slerp(t: float, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of two noises.  (reference: scripts/sample_uncond.py:253-255)"""
    theta = torch.arccos(torch.sum(z1 * z2) / (torch.linalg.norm(z1) * torch.linalg.norm(z2)))
    return (torch.sin((1 - t) * theta) / torch.sin(theta) * z1
            + torch.sin(t * theta) / torch.sin(theta) * z2)


def fold_generator(seed: int, fold: int, device: Any) -> torch.Generator:
    """The generator of one fold: a function of (seed, fold) alone, as the
    JAX CLI's ``fold_in(key, fold)`` is."""
    state = np.random.SeedSequence([seed, fold]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=torch.device(device)).manual_seed(int(state))


def model_function(model: nn.Module) -> Callable[..., torch.Tensor]:
    """The samplers' ``model_fn(x, t)``."""
    return lambda x, t, **kw: model(x, t, **kw)


@torch.no_grad()
def sample_fold(model_fn: Callable, diffuser: Any, fold: int, batch_size: int,
                shape: Sequence[int], seed: int = 2022, device: Any = "cuda",
                collect: Sequence[str] = (), dp: Optional[DataParallelSampler] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One fold: ``batch_size`` noises of ``shape`` (C, H, W) through the
    sampler; returns (the samples [B, C, H, W], the ``collect``ed per-step
    values [S, B, C, H, W]), on the device, unclipped; ``dp`` shares the
    rows out over the ranks."""
    generator = fold_generator(seed, fold, device)
    noise = torch.randn(batch_size, *shape, generator=generator, device=torch.device(device))
    dp = dp or DataParallelSampler()
    local, b = dp.pad_shard(noise)
    x, ys = diffuser.sample_loop(model_fn, local, dp.row_generator(generator, b), collect=collect)
    return dp.gather(x, b), {k: dp.gather(v, b, dim=1) for k, v in ys.items()}


@torch.no_grad()
def interpolate_row(model_fn: Callable, diffuser: Any, index: int, n_interpolate: int,
                    shape: Sequence[int], seed: int = 2022, device: Any = "cuda",
                    dp: Optional[DataParallelSampler] = None) -> torch.Tensor:
    """``n_interpolate`` samples along the slerp between two noises of row ``index``."""
    generator = fold_generator(seed, index, device)
    z1, z2 = (torch.randn(*shape, generator=generator, device=torch.device(device))
              for _ in range(2))
    noise = torch.stack([slerp(float(t), z1, z2) for t in np.linspace(0, 1, n_interpolate)])
    return (dp or DataParallelSampler()).run(lambda x, generator: diffuser.sample(
        model_fn, x, generator), noise, generator=generator)


@torch.no_grad()
def reconstruct(model_fn: Callable, diffuser: Any, images: torch.Tensor) -> torch.Tensor:
    """``images`` [B, C, H, W] in [-1, 1] inverted to noise and sampled
    back (a deterministic sampler: DDIM at eta 0, or the flow ODE)."""
    inverted = diffuser.sample_inversion(model_fn, images)
    generator = torch.Generator(device=images.device).manual_seed(0)
    return diffuser.sample(model_fn, inverted, generator)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, unknown = parse_args(argv)
    logger = get_logger()
    device = open_device(args.device, "sample_uncond")
    dp = DataParallelSampler()
    conf = load_conf(args, unknown)
    shape = image_shape(conf)
    diffuser = build_diffuser(args, conf)
    model = load_model_params(args.weights, instantiate_from_config(conf["model"], device=device))
    model_fn = model_function(model.eval())
    logger.info(f"Loaded weights from {args.weights} on {device}")
    os.makedirs(args.save_dir, exist_ok=True)
    steps = len(diffuser.respaced_seq)

    def path(i: int) -> str:
        return os.path.join(args.save_dir, f"{i}.png")

    if args.mode == "sample":
        idx = 0
        for fold, bs in enumerate(amortize(args.n_samples, args.batch_size)):
            images, _ = sample_fold(model_fn, diffuser, fold, bs, shape, args.seed, device, dp=dp)
            if dp.is_main:
                for b, img in enumerate(to_nhwc(images)):
                    save_image(img, path(idx + b))
            idx += bs
            logger.info(f"Sampled {idx}/{args.n_samples}")
    elif args.mode in ("denoise", "progressive"):
        key = "sample" if args.mode == "denoise" else "pred_x0"
        freq = max(1, steps // (args.n_denoise if args.mode == "denoise" else args.n_progressive))
        idx = 0
        for fold, bs in enumerate(amortize(args.n_samples, args.batch_size)):
            _, ys = sample_fold(model_fn, diffuser, fold, bs, shape, args.seed, device,
                                collect=(key,), dp=dp)
            traj = to_nhwc(ys[key])[::-1][::freq][::-1]  # every freq-th, ending at the last
            for b in range(bs if dp.is_main else 0):
                save_image_grid(traj[:, b], path(idx), nrow=len(traj))
                idx += 1
            logger.info(f"Sampled {idx}/{args.n_samples}")
    elif args.mode == "interpolate":
        for i in range(args.n_samples):
            out = interpolate_row(model_fn, diffuser, i, args.n_interpolate, shape, args.seed,
                                  device, dp=dp)
            if dp.is_main:
                save_image_grid(to_nhwc(out), path(i), nrow=args.n_interpolate)
            logger.info(f"Sampled {i + 1}/{args.n_samples}")
    else:  # reconstruction
        if not args.input_dir:
            raise SystemExit("--input_dir required for reconstruction")
        dataset = ImageDir(args.input_dir, img_size=shape[1])
        n = min(args.n_samples, len(dataset))
        for i in range(0, n, args.batch_size):
            batch = np.stack([dataset[j] for j in range(i, min(i + args.batch_size, n))])
            images = torch.from_numpy(batch).permute(0, 3, 1, 2).to(device)
            recon = to_nhwc(dp.run(lambda x: reconstruct(model_fn, diffuser, x), images))
            for b in range(len(batch) if dp.is_main else 0):
                save_image_grid(np.stack([batch[b], recon[b]]), path(i + b), nrow=2)
            logger.info(f"Reconstructed {min(i + args.batch_size, n)}/{n}")
    logger.info("Done")


if __name__ == "__main__":
    main()
