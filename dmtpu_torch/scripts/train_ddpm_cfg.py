"""Class-conditional diffusion training with classifier-free label dropout.

    python -m dmtpu_torch.scripts.train_ddpm_cfg -c dit.yaml [-e EXP_DIR]
        [-r best|latest|PATH] [-ni] [--device cuda|cpu] [key.sub=value ...]

Counterpart of ``scripts/train_ddpm_cfg.py``.  A class-conditional model
``(x, t, y)`` of the config (DiT, MDTv2 on latents; the pixel-space
``UNetCategorialAdaGN`` and the class-conditional ADM UNets) trains on
labelled images from the config's dataset: each step draws t, eps and a label-dropout mask from the
step's generator, replaces each dropped label by the null class
``data.num_classes`` (probability ``train.p_uncond``) and takes the
diffusion loss (``make_diffusion_loss_fn``); ``make_train_step`` averages
over ``train.micro_batch`` splits, clips, steps the optimizer and the EMA.
Every ``train.sample_freq`` steps the EMA weights draw
``train.n_samples_each_class`` samples for each of the first
``min(10, num_classes)`` classes with ``DDPMCFG`` (guidance 1.0, the null
class as the unconditional input, uniform respacing to ``total_steps // 20``)
into ``<exp_dir>/samples/stepNNNNNN.png``, one row a class; a 4-channel
latent grid is written as an RGBA PNG, as the JAX CLI writes it.  Every
``train.save_freq`` steps, and at the end, the train state is saved under
``<exp_dir>/ckpt/step{N:06d}/`` (``dmtpu_torch.utils.checkpoint``: torch
files, not the JAX package's orbax trees), and ``-r`` resumes from one.

The model is built by the registry on ``--device`` with its own
initialisation, drawn from ``seed``.  ``--device`` defaults to ``cuda``:
without a card the CLI fails unless ``--device cpu`` is given.  Overrides are
``key.sub=value`` items (YAML values); any other leftover argument is an
error.  The metrics stay on the device and are read at the print, save and
sample boundaries and at the last step.

Not ported: data-parallel and sharded training (one card) and learning-rate
schedules given as configs.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from dmtpu_torch.diffusions import DDPMCFG
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
from dmtpu_torch.scripts._common import TrainRun, seeded_instance, to_device
from dmtpu_torch.utils.config import instantiate_from_config
from dmtpu_torch.utils.image import save_image_grid


def build_model(conf: Mapping, device: torch.device, seed: int) -> nn.Module:
    """The model of ``conf.model`` on ``device``, its parameters drawn by the
    modules' own initialisation from the device's generator seeded with
    ``seed`` (the caller's generator state is left as it was)."""
    return seeded_instance(conf["model"], device, seed)


def eval_sampler(conf: Mapping) -> DDPMCFG:
    """The periodic sampler: DDPMCFG at guidance 1.0 over the config's
    diffusion, uniformly respaced to ``total_steps // 20`` steps."""
    params = dict(conf["diffusion"].get("params", None) or {})
    params.pop("device", None)
    params.update(respace_type="uniform", respace_steps=int(params["total_steps"]) // 20)
    return DDPMCFG(guidance_scale=1.0, **params)


def labelled_batch(batch, device: torch.device) -> tuple:
    """A loader's (images [B, H, W, C], labels [B]) -> (NCHW f32, int64) on ``device``."""
    images, labels = batch
    y = torch.from_numpy(np.asarray(labels, np.int64))
    if device.type == "cuda":
        y = y.pin_memory().to(device, non_blocking=True)
    return to_device(images, device), y


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train; returns what the run measured (``TrainRun.train``'s result and
    the seconds of the load, ``load_seconds``)."""
    run = TrainRun.open(argv, __doc__, "train_ddpm_cfg")
    conf, device, seed = run.conf, run.device, run.seed
    loader = run.loader()

    num_classes = conf.data.num_classes
    diffuser = instantiate_from_config(conf.diffusion)
    model = build_model(conf, device, seed).train()
    run.logger.info(f"Model parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    optimizer = instantiate_from_config(conf.train.optim, params=model.parameters())
    state = TrainState.create(model, optimizer, ema_decay=conf.train.ema_decay,
                              ema_gradual=conf.train.get("ema_gradual", True),
                              ema_dtype=conf.train.get("ema_dtype"))
    load_seconds = run.resume(state)
    loss_fn = make_diffusion_loss_fn(
        diffuser, lambda x, t, **kw: model(x, t, train=True, **kw),
        int(conf.diffusion.params.total_steps), p_uncond=conf.train.p_uncond,
        null_label=num_classes)
    train_step = make_train_step(loss_fn, clip_grad_norm=conf.train.clip_grad_norm,
                                 micro_batches=run.micro_batches, seed=seed)

    sampler = eval_sampler(conf)
    shape = (conf.data.get("img_channels", 3),) + (conf.data.params.img_size,) * 2

    @torch.no_grad()
    def sample_and_save(savepath: str, generator: torch.Generator) -> None:
        weights = state.ema.shadow if state.ema is not None else dict(model.named_parameters())
        params = {name: weights[name].to(p.dtype) for name, p in model.named_parameters()}
        npc = conf.train.n_samples_each_class
        n_show = min(10, num_classes)
        y = torch.arange(n_show, device=device).repeat_interleave(npc)
        noise = torch.randn((n_show * npc,) + shape, generator=generator, device=device)
        model.eval()
        try:
            out = sampler.sample(
                lambda x, t, y=None, **kw: torch.func.functional_call(model, params, (x, t, y)),
                noise, generator, uncond_conditioning=torch.full_like(y, num_classes),
                model_kwargs=dict(y=y))
        finally:
            model.train()
        images = out.clamp(-1.0, 1.0).permute(0, 2, 3, 1).float().cpu().numpy()
        save_image_grid(images, savepath, nrow=npc)

    result = run.train(state, train_step, loader, lambda batch: labelled_batch(batch, device),
                       sample_and_save)
    result["load_seconds"] = load_seconds
    return result


if __name__ == "__main__":
    main()
