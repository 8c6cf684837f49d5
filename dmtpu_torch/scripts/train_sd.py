"""Latent text-to-image fine-tuning of Stable Diffusion.

    python -m dmtpu_torch.scripts.train_sd -c configs/sd15_finetune.yaml [-e EXP_DIR]
        [-r best|latest|PATH] [-ni] [--device cuda|cpu] [key.sub=value ...]

Counterpart of ``scripts/train_sd.py``: a frozen VAE and a frozen CLIP text
tower around a UNet that trains.  Each step encodes the batch's images to
latents (the posterior's noise drawn from the step's generator), drops each
caption to the empty prompt with probability ``train.p_uncond``, encodes the
token ids, draws t and eps and takes the eps-loss (``make_sd_loss_fn``);
``make_train_step`` clips, steps the optimizer and the EMA.  Every
``train.sample_freq`` steps a DDIMCFG preview of ``train.sample_prompts``
runs through the EMA weights; every ``train.save_freq`` steps, and at the
end, the train state is saved under ``<exp_dir>/ckpt/step{N:06d}/``
(``dmtpu_torch.utils.checkpoint``: torch files, not the JAX package's orbax
trees), and ``-r`` resumes from one.

``--device`` defaults to ``cuda``: without a card the CLI fails unless
``--device cpu`` is given.  Overrides are ``key.sub=value`` items (YAML
values); any other leftover argument is an error.

Config keys beside the model, diffusion, data and dataloader blocks:

    weights:   a CompVis .ckpt / .safetensors to fine-tune from (omitted:
               seeded random parameters from ``seed``, for demos and tests;
               the draws depend on the device's generator)
    tokenizer: a local CLIPTokenizer directory (unless the text encoder has
               a tokenizer already)
    train.lora: {rank, alpha?, targets?}: LoRA fine-tuning
               (``dmtpu_torch.models.lora``); the UNet joins the frozen
               towers, only the adapters train, and the checkpoints hold
               only them

Under ``torchrun --nproc_per_node N`` the run is data-parallel over N ranks
(``TrainRun``: each rank takes its rows of every batch, the gradients are
averaged over the ranks, as the JAX CLIs' mesh of fsdp 1) and equals the
one-rank run of a model without dropout.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

from dmtpu_torch.diffusions import DDIMCFG
from dmtpu_torch.parallel import TrainState, make_train_step
from dmtpu_torch.scripts._common import TrainRun, to_device
from dmtpu_torch.scripts.sample_sd import LATENT_CHANNELS
from dmtpu_torch.utils.config import instantiate_from_config
from dmtpu_torch.utils.image import save_image_grid
from dmtpu_torch.utils import profiling, rows

UNetFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def make_sd_loss_fn(sd, diffuser, empty_ids: torch.Tensor, p_uncond: float, total_steps: int,
                    unet: Optional[UNetFn] = None):
    """The fine-tuning loss of a batch ``{"image": [B, 3, H, W] in [-1, 1],
    "input_ids": [B, L]}``, as ``loss_fn(batch, generator)``.  It draws from
    the step's generator, in this order: the posterior's noise of the latent
    encode, the caption-drop mask (when ``p_uncond > 0``; a dropped caption
    becomes ``empty_ids``, the empty prompt's [1, L] ids), t and eps.  The
    VAE and the text tower run without gradients.  ``unet(x, t, context)``
    is ``sd.unet`` unless given (LoRA gives the base with merged weights).
    While a profiler records, the encode, the text tower and the UNet call
    are ``vae.encode``, ``text_encode`` and ``denoiser`` spans."""
    unet = unet or sd.unet

    def loss_fn(batch: Mapping[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        images, ids = batch["image"], batch["input_ids"]
        b = images.shape[0]
        with torch.no_grad():
            with profiling.span("vae.encode", device=True):
                z0 = sd.encode_latent(images, generator)
            if p_uncond > 0:
                drop = rows.rand(b, generator, ids.device) < p_uncond
                ids = torch.where(drop[:, None], empty_ids, ids)
            with profiling.span("text_encode", device=True):
                context = sd.text_encoder_encode_tokens(ids)
        t = rows.randint(0, total_steps, (b,), generator, z0.device)
        eps = rows.randn(z0.shape, generator, z0.device, z0.dtype)

        def denoiser(x, tt):
            with profiling.span("denoiser", device=True):
                return unet(x, tt, context)

        return diffuser.loss_func(denoiser, z0, t, eps=eps)

    return loss_fn


def lora_unet(sd, lora: Mapping[str, torch.Tensor], scale: float) -> UNetFn:
    """The frozen UNet run with the adapters ``lora`` merged into its weights
    in each call (``functional_call``)."""
    from dmtpu_torch.models.lora import lora_weights

    base = dict(sd.unet.named_parameters())

    def unet(x, t, context):
        merged = lora_weights(base, lora, scale)
        return torch.func.functional_call(sd.unet, merged, (x, t), {"context": context})

    return unet


def build_model(conf: Mapping, device: torch.device, logger):
    """The ``StableDiffusion`` of ``conf.model`` on ``device`` with the
    config's ``weights:`` loaded, or seeded random parameters."""
    sd = instantiate_from_config(conf["model"], device=device)
    weights = conf.get("weights")
    if weights:
        sd.load_weights(weights)
        logger.info(f"Loaded SD weights from {weights}")
    else:
        sd.init_params(torch.Generator(device=device).manual_seed(conf.get("seed", 0)))
        logger.info("No `weights:` in config -> RANDOM-INIT SD (demo/testing)")
    return sd


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train; returns what the run measured (``TrainRun.train``'s result and
    the seconds of the load, ``load_seconds``)."""
    run = TrainRun.open(argv, __doc__, "train_sd")
    conf, device, logger, seed = run.conf, run.device, run.logger, run.seed

    # data: captioned images, tokenized per batch on the host
    loader = run.loader()

    # model: the UNet trains; the VAE and the text tower stay frozen
    sd = build_model(conf, device, logger)
    for frozen in (sd.vae, sd.text_encoder):
        frozen.requires_grad_(False).eval()
    sd.unet.train()
    tok = sd.text_encoder.tokenizer
    if tok is None:
        tok_path = conf.get("tokenizer")
        if not tok_path:
            raise ValueError("config needs `tokenizer:` (a local CLIPTokenizer directory) "
                             "unless the text encoder has one")
        from transformers import CLIPTokenizer

        tok = sd.text_encoder.tokenizer = CLIPTokenizer.from_pretrained(tok_path)

    def tokenize(texts) -> torch.Tensor:
        return torch.as_tensor(sd.text_encoder.tokenize(list(texts)), dtype=torch.int64,
                               device=device)

    empty_ids = tokenize([""])  # [1, L], broadcast per sample

    lora_conf = conf.train.get("lora")
    if lora_conf:
        from dmtpu_torch.models.lora import (
            DEFAULT_TARGETS,
            init_lora,
            lora_param_count,
            lora_scale,
        )

        rank = int(lora_conf["rank"])
        scale = lora_scale(rank, lora_conf.get("alpha"))
        sd.unet.requires_grad_(False)
        trainable = init_lora(sd.unet, torch.Generator(device=device).manual_seed(seed),
                              rank=rank, targets=tuple(lora_conf.get("targets", DEFAULT_TARGETS)))
        adapters = dict(trainable.named_parameters())
        logger.info(f"LoRA fine-tune: rank={rank} scale={scale:g} "
                    f"adapters={len(trainable.paths)} "
                    f"({lora_param_count(adapters) / 1e6:.3f}M trainable; base UNet frozen)")
        unet = lora_unet(sd, adapters, scale)

        def preview_unet(weights: Mapping[str, torch.Tensor]) -> UNetFn:
            return lora_unet(sd, {k: v.float() for k, v in weights.items()}, scale)
    else:
        trainable = sd.unet
        unet = None

        def preview_unet(weights: Mapping[str, torch.Tensor]) -> UNetFn:
            params = {name: weights[name].to(p.dtype) for name, p in sd.unet.named_parameters()}
            return lambda x, t, context: torch.func.functional_call(
                sd.unet, params, (x, t), {"context": context})
    n_params = sum(p.numel() for p in trainable.parameters())
    logger.info(f"Trainable parameters: {n_params / 1e6:.2f}M")

    diffuser = instantiate_from_config(conf.diffusion)
    total_steps = int(conf.diffusion.params.total_steps)
    optimizer = instantiate_from_config(conf.train.optim, params=trainable.parameters())
    loss_fn = make_sd_loss_fn(sd, diffuser, empty_ids, float(conf.train.get("p_uncond", 0.0)),
                              total_steps, unet)
    state = TrainState.create(trainable, optimizer, ema_decay=conf.train.ema_decay,
                              ema_gradual=conf.train.get("ema_gradual", True),
                              ema_dtype=conf.train.get("ema_dtype"))
    state = run.place(state)
    load_seconds = run.resume(state)
    train_step = make_train_step(loss_fn, clip_grad_norm=conf.train.clip_grad_norm,
                                 micro_batches=run.micro_batches, seed=seed,
                                 mesh=run.mesh)

    # the periodic CFG preview through the EMA weights
    dp = dict(conf.diffusion.get("params", None) or {})
    dp.pop("device", None)
    dp.pop("var_type", None)
    dp.update(respace_type="uniform", respace_steps=int(conf.train.get("sample_respace_steps", 50)),
              guidance_scale=float(conf.train.get("sample_guidance_scale", 7.5)),
              cond_kwarg="text_embed")
    preview = DDIMCFG(**dp)
    sample_prompts = list(conf.train.get("sample_prompts", ["", ""]))
    lat = conf.data.params.img_size // 8

    @torch.no_grad()
    def sample_and_save(savepath: str, generator: torch.Generator) -> None:
        weights = state.ema.shadow if state.ema is not None else dict(trainable.named_parameters())
        net = preview_unet(weights)
        n = len(sample_prompts)
        ce = sd.text_encoder_encode_tokens(tokenize(sample_prompts))
        ue = sd.text_encoder_encode_tokens(empty_ids.expand(n, -1))
        noise = torch.randn(n, LATENT_CHANNELS, lat, lat, generator=generator, device=device)
        sd.unet.eval()
        try:
            z = preview.sample(lambda x, t, text_embed=None, **kw: net(x, t, text_embed), noise,
                               generator, uncond_conditioning=ue,
                               model_kwargs=dict(text_embed=ce))
        finally:
            sd.unet.train()
        images = sd.decode_latent(z).clamp(-1.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()
        save_image_grid(images, savepath, nrow=math.ceil(math.sqrt(n)))

    def to_batch(batch) -> Dict[str, torch.Tensor]:
        return {"image": to_device(batch["image"], device),
                "input_ids": tokenize(batch["caption"])}

    result = run.train(state, train_step, loader, to_batch, sample_and_save)
    result["load_seconds"] = load_seconds
    return result


if __name__ == "__main__":
    main()
