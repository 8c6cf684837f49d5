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

Not ported: learning-rate schedules given as configs, data-parallel and
sharded training (one card), and LoRA together with the UNet's
``use_checkpoint`` (the recompute would not see the merged weights).
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from dmtpu_torch.data import DataLoader
from dmtpu_torch.diffusions import DDIMCFG
from dmtpu_torch.parallel import TrainState, make_train_step, step_generator
from dmtpu_torch.scripts.sample_sd import LATENT_CHANNELS, resolve_device
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils.config import instantiate_from_config, load_config, merge_dotlist
from dmtpu_torch.utils.image import save_image_grid
from dmtpu_torch.utils.logger import StatusTracker, get_logger
from dmtpu_torch.utils.misc import (
    check_freq,
    create_exp_dir,
    find_resume_checkpoint,
    get_data_generator,
    get_time_str,
)
from dmtpu_torch.utils.optim import lr_fn
from dmtpu_torch.utils.profiling import StepTimer

UNetFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("-e", "--exp_dir", type=str)
    p.add_argument("-r", "--resume", type=str,
                   help="resume from a checkpoint: a path, `best` or `latest`")
    p.add_argument("-ni", "--no_interaction", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def parse_overrides(unknown: Sequence[str]) -> List[str]:
    """``key=value`` items (leading dashes dropped); anything else is an
    error, never a value paired with its neighbour."""
    bad = [a for a in unknown if "=" not in a]
    if bad:
        raise SystemExit(f"unrecognized arguments: {bad} (config overrides are key=value)")
    return [a.lstrip("-") for a in unknown]


def make_sd_loss_fn(sd, diffuser, empty_ids: torch.Tensor, p_uncond: float, total_steps: int,
                    unet: Optional[UNetFn] = None):
    """The fine-tuning loss of a batch ``{"image": [B, 3, H, W] in [-1, 1],
    "input_ids": [B, L]}``, as ``loss_fn(batch, generator)``.  It draws from
    the step's generator, in this order: the posterior's noise of the latent
    encode, the caption-drop mask (when ``p_uncond > 0``; a dropped caption
    becomes ``empty_ids``, the empty prompt's [1, L] ids), t and eps.  The
    VAE and the text tower run without gradients.  ``unet(x, t, context)``
    is ``sd.unet`` unless given (LoRA gives the base with merged weights)."""
    unet = unet or sd.unet

    def loss_fn(batch: Mapping[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        images, ids = batch["image"], batch["input_ids"]
        b = images.shape[0]
        with torch.no_grad():
            z0 = sd.encode_latent(images, generator)
            if p_uncond > 0:
                drop = torch.rand(b, generator=generator, device=ids.device) < p_uncond
                ids = torch.where(drop[:, None], empty_ids, ids)
            context = sd.text_encoder_encode_tokens(ids)
        t = torch.randint(0, total_steps, (b,), generator=generator, device=z0.device)
        eps = torch.randn(z0.shape, generator=generator, device=z0.device, dtype=z0.dtype)
        return diffuser.loss_func(lambda x, tt: unet(x, tt, context), z0, t, eps=eps)

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


def to_device(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """A loader's [B, H, W, C] float32 batch -> contiguous [B, C, H, W] on
    ``device``, through pinned memory on a card."""
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x.permute(0, 3, 1, 2).contiguous()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train; returns what the run measured: the steps' host times between
    ticks (``step_seconds``, from the second step of the run on), the seconds
    of each checkpoint save and of the load, the logged losses and the
    experiment directory."""
    args, unknown = build_parser().parse_known_args(argv)
    overrides = parse_overrides(unknown)
    try:
        device = resolve_device(args.device, cli="train_sd")
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    time_str = get_time_str()
    exp_dir = args.exp_dir or os.path.join("runs", f"exp-{time_str}")
    conf = merge_dotlist(load_config(args.config), overrides)
    import yaml

    create_exp_dir(exp_dir, yaml.safe_dump(conf.to_dict()), exist_ok=args.resume is not None,
                   time_str=time_str, no_interaction=args.no_interaction)
    logger = get_logger(log_file=os.path.join(exp_dir, f"output-{time_str}.log"))
    tracker = StatusTracker(logger, exp_dir, print_freq=conf.train.print_freq)
    seed = conf.get("seed", 0)
    logger.info(f"Experiment directory: {exp_dir}")
    logger.info("Device: " + (torch.cuda.get_device_name(device) if device.type == "cuda"
                              else str(device)))

    # data: captioned images, tokenized per batch on the host
    batch_size = conf.train.batch_size
    micro_batch = conf.train.get("micro_batch", 0) or batch_size
    micro_batches = max(1, batch_size // micro_batch)
    train_set = instantiate_from_config(conf.data)
    loader = DataLoader(train_set, batch_size=batch_size, shuffle=True, drop_last=True,
                        seed=seed, **conf.get("dataloader", {}))
    logger.info(f"Size of training set: {len(train_set)}")
    if len(loader) == 0:
        raise ValueError(f"the training set holds {len(train_set)} items, fewer than a batch "
                         f"of {batch_size}")

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

        if sd.unet.use_checkpoint:
            raise NotImplementedError("LoRA with the UNet's use_checkpoint is not ported: the "
                                      "recompute would not see the merged weights")
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
    lr_at = lr_fn(conf.train.optim)
    loss_fn = make_sd_loss_fn(sd, diffuser, empty_ids, float(conf.train.get("p_uncond", 0.0)),
                              total_steps, unet)
    state = TrainState.create(trainable, optimizer, ema_decay=conf.train.ema_decay,
                              ema_gradual=conf.train.get("ema_gradual", True),
                              ema_dtype=conf.train.get("ema_dtype"))
    result: Dict[str, Any] = {"exp_dir": exp_dir, "save_seconds": [], "load_seconds": None,
                              "losses": []}
    step = 0
    if args.resume is not None:
        path = find_resume_checkpoint(exp_dir, args.resume)
        t0 = time.perf_counter()
        ckpt_lib.load_checkpoint(path, state)
        result["load_seconds"] = time.perf_counter() - t0
        step = state.step
        logger.info(f"Resumed from {path} at step {step}")
    train_step = make_train_step(loss_fn, clip_grad_norm=conf.train.clip_grad_norm,
                                 micro_batches=micro_batches, seed=seed)

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

    def save_ckpt() -> None:
        t0 = time.perf_counter()
        ckpt_lib.save_checkpoint(os.path.join(exp_dir, "ckpt"), step, state)
        result["save_seconds"].append(time.perf_counter() - t0)

    n_steps = conf.train.n_steps
    logger.info("Start training...")
    gen = get_data_generator(loader)
    timer = StepTimer()
    pending = []
    try:
        while step < n_steps:
            batch = next(gen)
            batch = {"image": to_device(batch["image"], device),
                     "input_ids": tokenize(batch["caption"])}
            metrics = train_step(state, batch)
            timer.tick()
            # the throughput is read at tick time, so each logged step keeps
            # its own reading; the metrics stay on the card until a print
            pending.append((step, metrics, timer.throughput(batch_size)))
            if check_freq(conf.train.print_freq, step) or check_freq(conf.train.save_freq, step) \
                    or check_freq(conf.train.sample_freq, step) or step + 1 == n_steps:
                for s, m, tput in pending:
                    loss = float(m["loss"])
                    result["losses"].append(loss)
                    tracker.track_status("Train", {"loss": loss, "grad_norm": m["grad_norm"],
                                                   "lr": lr_at(s), "imgs_per_sec": tput}, s)
                pending.clear()
            if check_freq(conf.train.save_freq, step):
                save_ckpt()
            if check_freq(conf.train.sample_freq, step):
                sample_and_save(os.path.join(exp_dir, "samples", f"step{step:0>6d}.png"),
                                step_generator(seed, 2 ** 30 + step, device))
            step += 1
    finally:
        gen.close()  # stops the loader's threads
    if not check_freq(conf.train.save_freq, step - 1):
        step -= 1
        save_ckpt()
    tracker.close()
    logger.info("End of training")
    result["step_seconds"] = list(timer.times)
    return result


if __name__ == "__main__":
    main()
