"""Class-conditional sampling with classifier-free guidance.

    python -m dmtpu_torch.scripts.sample_cfg -c dit.yaml --weights DiT-XL-2-256x256.pt \\
        --vae_weights vae.pt --save_dir out --guidance_scale 4.0 \\
        --n_samples_each_class 4 --class_ids 207 --sampler ddim --respace_steps 50

Counterpart of ``scripts/sample_cfg.py``, with the same flags and the same
validation, plus ``--device`` (default ``cuda``: without a card the CLI fails
unless ``--device cpu`` is given).  Class labels and noise -> a CFG sampler
(the conditional and unconditional halves as ONE model call on the doubled
batch; the null class is row ``num_classes`` of the label table) -> the VAE
decode of a latent model -> PNGs in ``save_dir/class{c}/``.

- ``--sampler ddpm | ddim | dpmpp | pfdiff | flow``; ``flow`` is
  ``FlowMatchingCFG`` over the config's diffusion params (the DDPM keys are
  ignored), for a model trained on the flow objective whose output has its
  input's channels (a DiT with ``learn_sigma: false``);
- ``--guidance_interval T_LO T_HI`` (ddpm, ddim), ``--var_type``;
- models: the latent DiT / MDT wrapper (``models.dit.dit.DiT``,
  ``models.mdt.mdt.MDT``) with ``--weights`` either a JAX-package ``.npz``
  export of its ``{"vit", "vae"}`` params or an upstream DiT / MDT state
  dict, and ``--vae_weights`` the VAE's (CompVis or diffusers names).
  Without VAE weights the latents themselves are saved, as the JAX CLI does.
  Any other ported class-conditional model ``(x, t, y)`` samples at the
  config's image size with weights from ``load_model_params``: the pixel
  ``UNetCategorialAdaGN`` (``configs/ddpm_cfg_cifar10.yaml``; its null class
  is its table's last row) and ``UNetCombined`` (guided-diffusion's
  conditional and unconditional UNets, ``--weights COND,UNCOND`` or one
  combined file), whose doubled CFG batch goes through ``forward_cfg``: the
  conditional UNet takes the first half, the unconditional one the second
  (the JAX CLI hands the whole batch, null labels too, to the conditional
  UNet).  On the card the attention kernel takes bf16: give an f32 pixel
  config a bf16 torso (``model.params.dtype=bfloat16``;
  ``model.params.unet_kwargs.use_fp16=true``).

Noise: the JAX CLI folds (class, batch index) into its key; here each batch
draws its noise and its sampler steps from a generator on the device seeded
from (seed, class, batch index), so the draws differ from the JAX package's
(the tests compare the two on the same arrays).  Under ``torchrun`` each rank
samples its rows of every batch (``DataParallelSampler``: the one-rank
samples) and rank 0 writes the files.  ``sample_class`` is one class's
request as a function; it takes a ready model and sampler and needs no
file.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dmtpu_torch.diffusions import (
    DDIMCFG,
    DDPMCFG,
    DPMSolverPPCFG,
    FlowMatchingCFG,
    PFDiffDDIMCFG,
)
from dmtpu_torch.models.adm import UNetCombined
from dmtpu_torch.models.latent import LatentDiffusionWrapper
from dmtpu_torch.scripts._common import (
    DataParallelSampler,
    base_parser,
    diffusion_params,
    image_shape,
    load_conf,
    load_model_params,
    load_npz_params,
    load_torch_weights,
    open_device,
)
from dmtpu_torch.utils import profiling
from dmtpu_torch.utils.config import instantiate_from_config
from dmtpu_torch.utils.image import save_image
from dmtpu_torch.utils.logger import get_logger
from dmtpu_torch.utils.misc import amortize

SAMPLERS = {"ddpm": DDPMCFG, "ddim": DDIMCFG, "dpmpp": DPMSolverPPCFG, "pfdiff": PFDiffDDIMCFG,
            "flow": FlowMatchingCFG}
LATENT_CHANNELS, LATENT_DOWNSAMPLE = 4, 8


def build_parser() -> argparse.ArgumentParser:
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--sampler", type=str, choices=sorted(SAMPLERS), default="ddpm")
    p.add_argument("--guidance_scale", type=float, required=True,
                   help="s=0: uncond; s=1: plain conditional; s>1: guided")
    p.add_argument("--class_ids", type=int, nargs="+", default=None,
                   help="Which classes to sample (default: all)")
    p.add_argument("--n_samples_each_class", type=int, required=True)
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--guidance_interval", type=float, nargs=2, default=None,
                   metavar=("T_LO", "T_HI"),
                   help="apply CFG only when t_lo < t <= t_hi (original timestep units); "
                        "outside, one plain conditional call per step (ddpm/ddim samplers)")
    p.add_argument("--var_type", type=str, default=None)
    p.add_argument("--vae_weights", type=str, default=None,
                   help="VAE weights for latent models (DiT/MDT wrappers)")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> Tuple[argparse.Namespace, list]:
    """(flags, the unknown arguments: the config's ``key=value`` overrides)."""
    p = build_parser()
    args, unknown = p.parse_known_args(argv)
    if args.guidance_interval is not None and args.sampler not in ("ddpm", "ddim"):
        p.error("--guidance_interval supports the ddpm/ddim samplers")
    return args, unknown


def make_diffuser(args: argparse.Namespace, conf) -> Any:
    """The CFG sampler the flags name, over the config's diffusion."""
    extra = dict(guidance_scale=args.guidance_scale)
    if args.var_type is not None:
        extra["var_type"] = args.var_type
    if args.guidance_interval is not None:
        extra["guidance_interval"] = tuple(args.guidance_interval)
    if args.sampler == "ddim":
        extra["eta"] = args.ddim_eta
    return SAMPLERS[args.sampler](**diffusion_params(args, conf, **extra))


def build_model(conf, weights: str, vae_weights: Optional[str], device: torch.device
                ) -> Tuple[nn.Module, bool, bool]:
    """(model in eval mode on ``device``, is it latent, has its VAE weights)."""
    try:
        model = instantiate_from_config(conf["model"], device=device)
    except NotImplementedError as e:
        raise NotImplementedError(
            f"{e}: sample_cfg serves the latent DiT / MDT models and the ported "
            "class-conditional ones (UNetCategorialAdaGN, UNetCombined, DiT)") from e
    if not isinstance(model, LatentDiffusionWrapper):
        return load_model_params(weights, model).eval(), False, False
    if weights.endswith(".npz"):
        from dmtpu_torch.convert import load_flax_params

        # the JAX package's export of the wrapper's {"vit", "vae"} params
        params = load_npz_params(weights)
        load_flax_params(model.vit, params["vit"])
        has_vae = bool(params.get("vae"))
        if has_vae:
            load_flax_params(model.vae, params["vae"])
    else:
        vae_sd = load_torch_weights(vae_weights) if vae_weights else None
        model.load_state_dict(load_torch_weights(weights), vae_sd=vae_sd)
        has_vae = vae_sd is not None
    return model.eval(), True, has_vae


def check_flow_model(model: nn.Module) -> None:
    """Refuse a model with a learned variance (twice its input's channels
    out) for ``--sampler flow``, whose velocity has the input's channels:
    the JAX CLI fails on the shapes inside its sampler."""
    if model.out_channels != model.in_channels:
        raise ValueError(
            f"--sampler flow samples a velocity model: the model gives {model.out_channels} "
            f"channels for {model.in_channels} (learn_sigma); use a flow-trained model with "
            "learn_sigma: false")


def pixel_model_fn(model: nn.Module, batch_size: int) -> Callable[..., torch.Tensor]:
    """The samplers' ``model_fn(x, t, y)`` of a pixel model for batches of
    ``batch_size``: a ``UNetCombined`` takes the CFG-doubled batch through
    ``forward_cfg`` and a plain one (a guidance interval's unguided steps)
    through its conditional UNet."""
    cfg = isinstance(model, UNetCombined)

    def model_fn(x, t, y=None, **kw):
        with profiling.span("denoiser", device=True):
            if cfg and x.shape[0] == 2 * batch_size:
                return model.forward_cfg(x, t, y)
            return model(x, t, y)

    return model_fn


def batch_seed(seed: int, class_id: int, index: int) -> int:
    """The generator seed of one batch: a function of (seed, class, batch
    index) alone, as the JAX CLI's ``fold_in(fold_in(key, c), i)`` is."""
    return int(np.random.SeedSequence([seed, class_id, index]).generate_state(1, np.uint64)[0])


@profiling.spanned("request", device=True)
@torch.no_grad()
def sample_class(model: nn.Module, diffuser: DDPMCFG, class_id: int, n_samples: int, *,
                 shape: Sequence[int], num_classes: int, batch_size: int = 64, seed: int = 2022,
                 decode: bool = True, device: Any = "cuda",
                 on_stage: Optional[Callable[[str], None]] = None,
                 dp: Optional[DataParallelSampler] = None) -> torch.Tensor:
    """``n_samples`` samples of class ``class_id`` in [-1, 1], [N, C, H, W]
    on the device: noise of ``shape`` (C, H, W) -> ``diffuser`` with the null
    class ``num_classes`` as the unconditional branch -> the VAE decode
    (``decode``, latent models only).  ``on_stage(name)`` is called as the
    work of each stage has been enqueued ("sample", then "decode", for each
    batch).  ``dp`` shares each batch's rows out over the ranks.  While a
    profiler records, the call is a ``request`` span with ``sample`` and
    ``decode`` for each batch under it (``utils/profiling.py``)."""
    dev = torch.device(device)
    dp = dp or DataParallelSampler()
    mark = on_stage or (lambda name: None)
    latent = isinstance(model, LatentDiffusionWrapper)
    out = []
    for i, bs in enumerate(amortize(n_samples, batch_size)):
        generator = torch.Generator(device=dev).manual_seed(batch_seed(seed, class_id, i))
        noise = torch.randn(bs, *shape, generator=generator, device=dev)
        y = torch.full((bs,), class_id, dtype=torch.int64, device=dev)
        uncond = torch.full((bs,), num_classes, dtype=torch.int64, device=dev)

        def one(noise, y, uncond, generator):
            model_fn = model.make_model_fn() if latent else pixel_model_fn(model, len(noise))
            with profiling.span("sample", device=True):
                z = diffuser.sample(model_fn, noise, generator, uncond_conditioning=uncond,
                                    model_kwargs=dict(y=y))
            mark("sample")
            if latent and decode:
                with profiling.span("decode", device=True):
                    z = model.decode_latent(z)
                mark("decode")
            return z

        out.append(dp.run(one, noise, y, uncond, generator=generator).clamp(-1.0, 1.0))
    return torch.cat(out)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args, unknown = parse_args(argv)
    logger = get_logger()
    device = open_device(args.device, "sample_cfg")
    dp = DataParallelSampler()
    conf = load_conf(args, unknown)
    diffuser = make_diffuser(args, conf)
    model, is_latent, has_vae = build_model(conf, args.weights, args.vae_weights, device)
    if args.sampler == "flow":
        check_flow_model(model.vit if is_latent else model)
    shape = image_shape(conf)
    if is_latent:
        # DiT / MDT sample 4-channel latents at size / 8, which the VAE decodes
        shape = (LATENT_CHANNELS, shape[1] // LATENT_DOWNSAMPLE, shape[2] // LATENT_DOWNSAMPLE)
    num_classes = conf["data"]["num_classes"]
    logger.info(f"Loaded weights from {args.weights} on {device}"
                + ("" if has_vae or not is_latent else "; no VAE weights: saving latents"))
    for c in args.class_ids or list(range(num_classes)):
        images = sample_class(model, diffuser, c, args.n_samples_each_class, shape=shape,
                              num_classes=num_classes, batch_size=args.batch_size,
                              seed=args.seed, decode=has_vae, device=device, dp=dp)
        images = images.permute(0, 2, 3, 1).float().cpu().numpy()
        for idx, img in enumerate(images if dp.is_main else []):
            save_image(img, os.path.join(args.save_dir, f"class{c}", f"{idx}.png"))
        logger.info(f"class {c}: {len(images)} samples")
    logger.info("Done")


if __name__ == "__main__":
    main()
