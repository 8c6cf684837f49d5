"""Stable Diffusion text-to-image CLI: the serving stack, headless.

    python -m dmtpu_torch.scripts.sample_sd -c sd.yaml --prompt "a cat" --save_dir out

Counterpart of ``scripts/sample_sd.py``, with the same flags and the same
validation, plus ``--device`` (default ``cuda``: without a card the CLI fails
unless ``--device cpu`` is given).  Prompt -> CLIP text encoder -> a sampler
with classifier-free guidance (one doubled-batch UNet call a step) -> VAE
decode -> PNGs.

- ``--sampler ddim | ddpm | dpmpp | pfdiff``: DDIM, DDPM, DPM-Solver++(2M)
  or PFDiff-1 over DDIM;
- ``--guidance_interval T_LO T_HI``: guidance on an interval of timesteps
  (ddim, ddpm);
- ``--tome_ratio R [--tome_max_downsample DS]``: Token Merging in the
  self-attention of the levels with ``ds <= DS``;
- ``--freeu [sd15|sd21|sdxl]`` or ``--freeu_scales B1 B2 S1 S2``: FreeU;
- ``--deepcache INTERVAL SKIP``: a cached UNet (ddim, pfdiff): the full UNet
  every INTERVAL-th call, the outermost SKIP skip levels in between;
- ``--init_image`` / ``--strength``: img2img (SDEdit in latent space);
- ``--inpaint_image`` / ``--inpaint_mask``: latent inpainting (ddim).

Under ``torchrun`` each rank samples and decodes its rows of every batch
(``DataParallelSampler``: the one-rank images) and rank 0 writes the files.

Weights: a CompVis ``.ckpt`` / ``.safetensors`` via ``--weights``; without it
the pipeline runs with seeded random parameters (demo mode: wiring and
performance only).  Prompts are tokenized by a local CLIPTokenizer
(``DMTPU_CLIP_TOKENIZER``); demo mode falls back to deterministic pseudo-token
ids, so the CLI runs with no file but its config.

Optional packages, imported where they are needed: ``yaml`` (the config
file), ``PIL`` (reading and writing images), ``transformers`` (the
tokenizer), ``safetensors`` (such a weights file).  ``sample_images`` is the
pipeline as a function: it takes the config as a mapping and images as
arrays, returns the images as one uint8 array, and needs none of them.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
from typing import Any, Callable, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dmtpu_torch.diffusions import (
    DDIM,
    DDIMCFG,
    DDPMCFG,
    DPMSolverPPCFG,
    PFDiffDDIM,
    PFDiffDDIMCFG,
)
from dmtpu_torch.diffusions.deepcache import deepcache_sample, pfdiff_deepcache_sample
from dmtpu_torch.diffusions.guidance import MaskGuidanceDDIMCFG
from dmtpu_torch.ops import freeu as freeu_lib
from dmtpu_torch.utils import profiling
from dmtpu_torch.utils.config import instantiate_from_config, load_config
from dmtpu_torch.utils.image import pil_image
from dmtpu_torch.utils.logger import get_logger
from dmtpu_torch.utils.misc import image_norm_to_uint8

_SAMPLERS = {"ddim": DDIMCFG, "ddpm": DDPMCFG, "dpmpp": DPMSolverPPCFG,
             "pfdiff": PFDiffDDIMCFG}
FREEU_PRESETS = {"sd15": freeu_lib.SD15_DEFAULTS, "sd21": freeu_lib.SD21_DEFAULTS,
                 "sdxl": freeu_lib.SDXL_DEFAULTS}
LATENT_CHANNELS = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", type=str, required=True,
                   help="SD weight yaml (reference weights/stablediffusion/*.yaml)")
    p.add_argument("--weights", type=str, default=None,
                   help=".ckpt/.safetensors; omit for random-init demo mode")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative", type=str, default="")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--sampler", type=str, default="ddim",
                   choices=sorted(_SAMPLERS))
    p.add_argument("--respace_type", type=str, default="uniform")
    p.add_argument("--respace_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--guidance_interval", type=float, nargs=2, default=None,
                   metavar=("T_LO", "T_HI"))
    p.add_argument("--tome_ratio", type=float, default=0.0)
    p.add_argument("--tome_max_downsample", type=int, default=1,
                   help="merge at levels with ds <= this (2 for SDXL-style "
                        "UNets whose finest attention level is ds=2)")
    p.add_argument("--freeu", type=str, nargs="?", const="sd15", default=None,
                   choices=sorted(FREEU_PRESETS),
                   help="enable FreeU with a model-family preset "
                        "(bare --freeu = sd15 paper scales)")
    p.add_argument("--freeu_scales", type=float, nargs=4, default=None,
                   metavar=("B1", "B2", "S1", "S2"),
                   help="explicit FreeU scales (overrides --freeu preset)")
    p.add_argument("--deepcache", type=int, nargs=2, default=None,
                   metavar=("INTERVAL", "SKIP"))
    p.add_argument("--init_image", type=str, default=None,
                   help="img2img (SDEdit in latent space): encode this image, "
                        "diffuse to strength*steps, run the reverse tail")
    p.add_argument("--strength", type=float, default=0.75,
                   help="img2img noising fraction in (0, 1]: 1.0 = full noise")
    p.add_argument("--inpaint_image", type=str, default=None,
                   help="latent inpainting: keep this image where the mask "
                        "is white, regenerate the rest (ddim only)")
    p.add_argument("--inpaint_mask", type=str, default=None,
                   help="mask image (white/>=128 = keep); downsampled to the latent grid")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def flag_conflict(*, sampler: str, init_image: Any = None, strength: float = 0.75,
                  inpaint_image: Any = None, inpaint_mask: Any = None,
                  guidance_interval: Any = None, deepcache: Any = None, **_) -> Optional[str]:
    """The first conflict among the pipeline's arguments, worded as the JAX
    CLI words it for its flags, or None.  The one validator: ``parse_args``
    gives it the parsed flags, ``sample_images`` its own arguments."""
    if (inpaint_image is None) != (inpaint_mask is None):
        return "--inpaint_image and --inpaint_mask go together"
    if inpaint_image is not None:
        if sampler != "ddim":
            return "--inpaint_image supports the ddim sampler"
        if deepcache is not None or init_image is not None:
            return "--inpaint_image composes with neither --deepcache nor --init_image"
    if init_image is not None:
        if sampler == "pfdiff":
            return "--init_image needs a start_step sampler (ddim/ddpm/dpmpp)"
        if deepcache is not None:
            return "--init_image and --deepcache are not composed yet"
        if not 0.0 < strength <= 1.0:
            return "--strength must be in (0, 1]"
    if deepcache is not None and sampler not in ("ddim", "pfdiff"):
        return "--deepcache composes with the ddim/pfdiff samplers"
    if deepcache is not None and guidance_interval is not None:
        return "--deepcache and --guidance_interval are not composed yet"
    if guidance_interval is not None and sampler not in ("ddim", "ddpm"):
        return "--guidance_interval supports the ddpm/ddim samplers"
    return None


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    conflict = flag_conflict(**vars(args))
    if conflict:
        p.error(conflict)
    return args


def resolve_device(name: str, cli: str = "sample_sd") -> torch.device:
    """The device to run on.  ``cuda`` without a card raises: the CLI
    ``cli`` does not carry on on the CPU unless asked to."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{cli}: no CUDA device; pass --device cpu to run on the CPU")
    return device


def _demo_token_ids(text: str, max_length: int, vocab: int) -> np.ndarray:
    """Deterministic pseudo-tokens for demo mode (no local CLIPTokenizer):
    the same ids for the same prompt in every run and in both packages.
    NOT a real tokenization."""
    h = hashlib.sha256(text.encode()).digest()
    rng = np.random.RandomState(int.from_bytes(h[:4], "little"))
    ids = rng.randint(3, vocab - 1, size=(max_length,))
    ids[0], ids[-1] = 0, 2  # BOS/EOS-ish anchors
    return ids[None]


def load_image(path: str, width: int, height: int) -> np.ndarray:
    """PNG/JPEG -> [-1, 1] float32 [H, W, 3], resized to (width, height)."""
    Image = pil_image()
    im = Image.open(path).convert("RGB").resize((width, height), Image.LANCZOS)
    return np.asarray(im, np.float32) / 127.5 - 1.0


def load_mask(path: str, width: int, height: int) -> np.ndarray:
    """Mask image -> float32 [height, width] of 0 / 1 (white, >= 128, = keep),
    resized by nearest neighbour."""
    Image = pil_image()
    mk = Image.open(path).convert("L").resize((width, height), Image.NEAREST)
    return (np.asarray(mk, np.float32) >= 128.0).astype(np.float32)


def _token_ids(sd, text: str, real_weights: bool) -> np.ndarray:
    te = sd.text_encoder
    tok = os.environ.get("DMTPU_CLIP_TOKENIZER")
    if tok and getattr(te, "tokenizer", None) is None:
        try:
            from transformers import CLIPTokenizer
        except ImportError as e:
            raise ImportError("DMTPU_CLIP_TOKENIZER needs the `transformers` package") from e
        te.tokenizer = CLIPTokenizer.from_pretrained(tok)
    if getattr(te, "tokenizer", None) is not None:
        return np.asarray(te.tokenize([text]))
    if real_weights:
        # pseudo-tokens with real weights would quietly give garbage images
        # that look like a fault of the weights
        raise SystemExit(
            "--weights given but no tokenizer available: set DMTPU_CLIP_TOKENIZER to a "
            "local CLIPTokenizer directory (demo pseudo-tokens are only allowed with "
            "random init)")
    return _demo_token_ids(text, te.max_length, te.model.vocab_size)


def encode_prompt(sd, text: str, batch: int, real_weights: bool,
                  device: torch.device) -> torch.Tensor:
    """[batch, T, width] f32 text embedding of one prompt."""
    ids = torch.as_tensor(_token_ids(sd, text, real_weights), device=device)
    return sd.text_encoder_encode_tokens(ids).expand(batch, -1, -1).contiguous()


def build_model(conf: Mapping, weights: Optional[str], device: torch.device):
    """The ``StableDiffusion`` of ``conf["model"]`` on ``device``, in eval mode,
    with ``weights`` loaded or (demo mode) random parameters from seed 0."""
    sd = instantiate_from_config(conf["model"], device=device).eval()
    if weights:
        sd.load_weights(weights)
    else:
        sd.init_params(torch.Generator(device=device).manual_seed(0))
    return sd


def freeu_scales(freeu: Union[None, str, Sequence[float]]) -> Optional[Tuple[float, ...]]:
    """FreeU's (b1, b2, s1, s2) from a preset name, the scales themselves, or
    None (off)."""
    if freeu is None:
        return None
    if isinstance(freeu, str):
        if freeu not in FREEU_PRESETS:
            raise ValueError(f"unknown FreeU preset {freeu!r}: one of {sorted(FREEU_PRESETS)}")
        return FREEU_PRESETS[freeu]
    return tuple(float(s) for s in freeu)


@contextlib.contextmanager
def serving_accelerators(sd, tome_ratio: float, tome_max_downsample: int,
                         freeu: Union[None, str, Sequence[float]]) -> Iterator[None]:
    """ToMe and FreeU on ``sd``'s UNet for the block, as asked; the settings
    it had before come back afterwards."""
    scales, unet = freeu_scales(freeu), sd.unet
    before = (unet.tome_ratio, unet.tome_max_downsample, unet.freeu)
    try:
        sd.set_tome(tome_ratio, max_downsample=tome_max_downsample)
        sd.set_freeu(scales)
        yield
    finally:
        sd.set_tome(before[0], max_downsample=before[1])
        sd.set_freeu(before[2])


def deepcache_sampler(diffuser, sd, cond: torch.Tensor, uncond: torch.Tensor,
                      guidance_scale: float, interval: int, skip: int,
                      generator: Optional[torch.Generator]) -> Callable[..., torch.Tensor]:
    """noise -> latents through a DeepCache loop with classifier-free
    guidance: one UNet call on the doubled batch ([x, x], context [cond,
    uncond]) a step, so the cache holds both halves; the halves are combined
    in the loop's seam with the tape row in hand, each ``predict``-ed (so
    ``clip_denoised`` clips each as ``DDPMCFG`` does), then
    ``(1 - s) eps_u + s eps_c``.  ``diffuser`` is a ``DDIM`` or a ``PFDiffDDIM``."""
    if diffuser.objective != "pred_eps":
        # the seam hands the step the guided eps as the model output
        raise NotImplementedError(f"--deepcache needs objective pred_eps, got "
                                  f"{diffuser.objective}")
    context = torch.cat([cond, uncond])
    s = guidance_scale

    def cfg_combine(out2, x, c):
        out_c, out_u = out2.chunk(2)
        eps_c = diffuser.predict(out_c, x, c)["pred_eps"]
        eps_u = diffuser.predict(out_u, x, c)["pred_eps"]
        return (1.0 - s) * eps_u + s * eps_c

    def full_fn(x, t):
        return sd.unet(torch.cat([x, x]), torch.cat([t, t]), context=context, dc_skip=skip)

    def shallow_fn(x, t, cache):
        return sd.unet(torch.cat([x, x]), torch.cat([t, t]), context=context, dc_skip=skip,
                       dc_cached=cache)[0]

    if isinstance(diffuser, PFDiffDDIM):
        return lambda x: pfdiff_deepcache_sample(diffuser, full_fn, shallow_fn, x, interval,
                                                 eps_fn=cfg_combine)
    return lambda x: deepcache_sample(diffuser, full_fn, shallow_fn, x, generator, interval,
                                      postprocess=cfg_combine)


@torch.no_grad()
@profiling.spanned("request", device=True)
def sample_images(
    conf: Mapping,
    prompt: str,
    negative: str = "",
    *,
    n_samples: int = 4,
    batch_size: int = 4,
    height: int = 512,
    width: int = 512,
    seed: int = 2022,
    sampler: str = "ddim",
    respace_type: str = "uniform",
    respace_steps: int = 50,
    guidance_scale: float = 7.5,
    guidance_interval: Optional[Sequence[float]] = None,
    tome_ratio: float = 0.0,
    tome_max_downsample: int = 1,
    freeu: Union[None, str, Sequence[float]] = None,
    deepcache: Optional[Sequence[int]] = None,
    init_image: Optional[np.ndarray] = None,
    strength: float = 0.75,
    inpaint_image: Optional[np.ndarray] = None,
    inpaint_mask: Optional[np.ndarray] = None,
    weights: Optional[str] = None,
    device: str = "cuda",
    sd: Any = None,
    on_stage: Optional[Callable[[str], None]] = None,
) -> np.ndarray:
    """The pipeline: ``n_samples`` images of ``prompt`` as uint8 [N, H, W, 3].

    ``conf`` has ``model`` and ``diffusion`` (``target`` / ``params``), as the
    YAML file does.  ``tome_ratio`` / ``tome_max_downsample``, ``freeu`` (a
    preset name or the four scales) and ``deepcache`` (``(interval, skip)``)
    are the CLI's accelerator flags.  ``init_image`` and ``inpaint_image``
    are [-1, 1] float [height, width, 3] arrays, ``inpaint_mask`` a 0 / 1
    array on the latent grid [height // 8, width // 8] (1 = keep).  ``sd``
    is a ready ``StableDiffusion`` (else it is built from ``conf`` by
    ``build_model``); its ToMe and FreeU settings are as before when the call
    returns.  ``on_stage(name)`` is called as the work of each stage has been
    enqueued ("begin", "text_encode", then "sample" and "decode" for each
    batch).  Under a ``torchrun`` launch each rank computes its rows of each
    batch (``DataParallelSampler``) and every rank returns all the images.
    While a profiler records, the call is a ``request`` span with
    ``text_encode``, then ``sample``, ``decode`` and ``to_host`` for each
    batch under it (``utils/profiling.py``).
    """
    from dmtpu_torch.scripts._common import DataParallelSampler

    if sampler not in _SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}: one of {sorted(_SAMPLERS)}")
    conflict = flag_conflict(
        sampler=sampler, init_image=init_image, strength=strength, inpaint_image=inpaint_image,
        inpaint_mask=inpaint_mask, guidance_interval=guidance_interval, deepcache=deepcache)
    if conflict:
        raise ValueError(conflict)
    dev = resolve_device(device)
    if sd is None:
        sd = build_model(conf, weights, dev)
    with serving_accelerators(sd, tome_ratio, tome_max_downsample, freeu):
        mark = on_stage or (lambda name: None)
        dp = dict(conf["diffusion"].get("params", None) or {})
        dp.pop("device", None)
        if sampler != "ddpm":
            dp.pop("var_type", None)
        dp.update(respace_type=respace_type, respace_steps=respace_steps)
        extra = dict(guidance_scale=guidance_scale, cond_kwarg="text_embed")
        if guidance_interval is not None:
            extra["guidance_interval"] = tuple(guidance_interval)

        def image_batch(image: np.ndarray) -> torch.Tensor:
            """[H, W, 3] -> [batch, 3, H, W] on the device."""
            x = torch.as_tensor(np.ascontiguousarray(image, np.float32), device=dev)
            return x.permute(2, 0, 1)[None].expand(batch_size, -1, -1, -1).contiguous()

        mark("begin")
        with profiling.span("text_encode", device=True):
            ce = encode_prompt(sd, prompt, batch_size, bool(weights), dev)
            ue = encode_prompt(sd, negative, batch_size, bool(weights), dev)
        mark("text_encode")
        lat_h, lat_w = height // 8, width // 8
        generator = torch.Generator(device=dev).manual_seed(seed)

        span, t_edit, init_lat, inpaint = {}, None, None, None
        if deepcache is not None:
            interval, skip = deepcache
            diffuser = (PFDiffDDIM if sampler == "pfdiff" else DDIM)(**dp)

            def run(x, c, u, generator):
                return deepcache_sampler(diffuser, sd, c, u, guidance_scale, interval, skip,
                                         generator)(x)
        else:
            if inpaint_image is not None:
                # latent inpainting: the known region is overwritten each step
                # through the guidance seam (dmtpu_torch/diffusions/guidance)
                diffuser = MaskGuidanceDDIMCFG(**dp, **extra)
                z_known = sd.encode_latent(image_batch(inpaint_image),
                                           torch.Generator(device=dev).manual_seed(seed + 1))
                lat_mask = torch.as_tensor(np.asarray(inpaint_mask, np.float32), device=dev)
                if lat_mask.shape != (lat_h, lat_w):
                    raise ValueError(f"inpaint_mask must be [{lat_h}, {lat_w}], got "
                                     f"{tuple(lat_mask.shape)}")
                inpaint = (z_known, lat_mask[None, None].expand(batch_size, -1, -1, -1))
            else:
                diffuser = _SAMPLERS[sampler](**dp, **extra)
            if init_image is not None:
                # img2img: encode once, diffuse to the strength point, run the
                # tail of the reverse tape
                steps = len(diffuser.respaced_seq)
                edit_steps = max(1, min(steps, round(strength * steps)))
                t_edit = int(diffuser.respaced_seq[edit_steps - 1])
                span = {"start_step": steps - edit_steps}
                init_lat = sd.encode_latent(image_batch(init_image),
                                            torch.Generator(device=dev).manual_seed(seed + 2))
            model_fn = sd.make_model_fn()

            def run(x, c, u, generator):
                return diffuser.sample(model_fn, x, generator, uncond_conditioning=u,
                                       model_kwargs=dict(text_embed=c), **span)

        def one(x, c, u, *known, generator):  # a rank's rows of a batch
            if known:
                diffuser.set_mask_and_image(known[0], known[1].contiguous())
            with profiling.span("sample", device=True):
                z = run(x, c, u, generator)
            mark("sample")
            with profiling.span("decode", device=True):
                decoded = sd.decode_latent(z).clamp(-1.0, 1.0)
            mark("decode")
            return decoded

        data_parallel = DataParallelSampler()
        images = []
        done = 0
        while done < n_samples:
            x = torch.randn(batch_size, LATENT_CHANNELS, lat_h, lat_w, generator=generator,
                            device=dev)
            if init_lat is not None:
                t = torch.full((batch_size,), t_edit, dtype=torch.int64, device=dev)
                x = diffuser.diffuse(init_lat, t, x)
            decoded = data_parallel.run(one, x, ce, ue, *(inpaint or ()), generator=generator)
            take = min(batch_size, n_samples - done)
            with profiling.span("to_host"):
                host = decoded[:take].permute(0, 2, 3, 1).cpu().numpy()
                images.append(image_norm_to_uint8(host))
            done += take
        return np.concatenate(images)


def main(argv: Optional[Sequence[str]] = None) -> None:
    from dmtpu_torch.scripts._common import is_main, open_device

    args = parse_args(argv)
    logger = get_logger()
    open_device(args.device, "sample_sd")
    conf = load_config(args.config)
    if not args.weights:
        logger.warning("no --weights: RANDOM init (demo mode)")
    lat_h, lat_w = args.height // 8, args.width // 8
    images = sample_images(
        conf, args.prompt, args.negative, n_samples=args.n_samples, batch_size=args.batch_size,
        height=args.height, width=args.width, seed=args.seed, sampler=args.sampler,
        respace_type=args.respace_type, respace_steps=args.respace_steps,
        guidance_scale=args.guidance_scale, guidance_interval=args.guidance_interval,
        tome_ratio=args.tome_ratio, tome_max_downsample=args.tome_max_downsample,
        freeu=args.freeu_scales if args.freeu_scales is not None else args.freeu,
        deepcache=args.deepcache,
        init_image=(load_image(args.init_image, args.width, args.height)
                    if args.init_image else None),
        strength=args.strength,
        inpaint_image=(load_image(args.inpaint_image, args.width, args.height)
                       if args.inpaint_image else None),
        inpaint_mask=(load_mask(args.inpaint_mask, lat_w, lat_h)
                      if args.inpaint_mask else None),
        weights=args.weights, device=args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    Image = pil_image()
    for i, image in enumerate(images if is_main() else []):
        Image.fromarray(image).save(os.path.join(args.save_dir, f"{i}.png"))
    logger.info(f"saved {len(images)}/{args.n_samples} to {args.save_dir}")


if __name__ == "__main__":
    main()
