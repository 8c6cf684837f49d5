"""Unconditional diffusion training of the pixel-space models.

    python -m dmtpu_torch.scripts.train_ddpm -c configs/ddpm_cifar10.yaml [-e EXP_DIR]
        [-r best|latest|PATH] [-ni] [--device cuda|cpu] [--profile DIR] [key.sub=value ...]

Counterpart of ``scripts/train_ddpm.py``.  The config's model (the repo's
``UNet``, ``UNetCategorialAdaGN``, the ADM UNets, ``PesserUNet``) trains on
the images of the config's dataset (a labelled item's label is dropped) with
the config's diffusion: DDPM, DDPM_IP or flow matching
(``configs/flow_synthetic.yaml``).  Each step draws t and eps (and DDPM_IP's
perturbation) from the step's generator and takes the diffusion loss of the
model called with ``train=True``, its dropout drawn from the device's
default generator, which the train step seeds from (seed, step);
``make_train_step`` averages over ``train.micro_batch`` splits, clips at
``train.clip_grad_norm``, steps the optimizer of ``train.optim`` and the EMA
(``train.ema_decay``, ``ema_gradual``, ``ema_dtype``).  Every
``train.sample_freq`` steps the EMA weights (the trained ones without an
EMA) draw ``train.n_samples`` images with the config's own diffuser
(``diffuser.sample``, as the JAX CLI's ``sample_fn``), written as one grid
to ``<exp_dir>/samples/stepNNNNNN.png``.  Checkpoints, resume, overrides and
``--device`` are ``train_ddpm_cfg``'s (``dmtpu_torch.scripts._common.
TrainRun``).  ``--profile DIR`` writes a ``torch.profiler`` trace of the
run's steps 10-15 into DIR (the JAX flag writes a ``jax.profiler`` one).

The model is built by the registry on ``--device`` with its modules' own
initialisation, drawn from ``seed``.

Not ported: data-parallel and sharded training (one card), learning-rate
schedules given as configs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
from dmtpu_torch.scripts._common import TrainRun, seeded_instance, to_device
from dmtpu_torch.utils.config import instantiate_from_config
from dmtpu_torch.utils.image import save_image_grid


def image_batch(batch: Any, device: torch.device) -> torch.Tensor:
    """A loader's batch (images, or (images, labels)) -> NCHW f32 images on ``device``."""
    return to_device(batch[0] if isinstance(batch, (tuple, list)) else batch, device)


@torch.no_grad()
def eval_samples(model: nn.Module, weights: Mapping[str, torch.Tensor], diffuser,
                 noise: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The eval grid's samples in [-1, 1], NCHW: ``diffuser.sample`` over
    ``model`` (``train=False``) with ``weights`` (by parameter name, cast to
    the parameters' dtypes) from ``noise``, its draws from ``generator``."""
    params = {name: weights[name].to(p.dtype) for name, p in model.named_parameters()}
    out = diffuser.sample(lambda x, t, **kw: torch.func.functional_call(model, params, (x, t)),
                          noise, generator)
    return out.clamp(-1.0, 1.0)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train; returns what the run measured (``TrainRun.train``'s result and
    the seconds of the load, ``load_seconds``)."""
    run = TrainRun.open(argv, __doc__, "train_ddpm", profile=True)
    conf, device, seed = run.conf, run.device, run.seed
    loader = run.loader()

    diffuser = instantiate_from_config(conf.diffusion)
    model = seeded_instance(conf.model, device, seed)
    run.logger.info(f"Model parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    optimizer = instantiate_from_config(conf.train.optim, params=model.parameters())
    state = TrainState.create(model, optimizer, ema_decay=conf.train.ema_decay,
                              ema_gradual=conf.train.get("ema_gradual", True),
                              ema_dtype=conf.train.get("ema_dtype"))
    load_seconds = run.resume(state)
    loss_fn = make_diffusion_loss_fn(diffuser, lambda x, t, **kw: model(x, t, train=True, **kw),
                                     int(conf.diffusion.params.total_steps))
    train_step = make_train_step(loss_fn, clip_grad_norm=conf.train.clip_grad_norm,
                                 micro_batches=run.micro_batches, seed=seed)

    n_samples = conf.train.n_samples
    shape = (conf.data.get("img_channels", 3),) + (conf.data.params.img_size,) * 2

    def sample_and_save(savepath: str, generator: torch.Generator) -> None:
        weights = state.ema.shadow if state.ema is not None else dict(model.named_parameters())
        noise = torch.randn((n_samples,) + shape, generator=generator, device=device)
        images = eval_samples(model, weights, diffuser, noise, generator)
        save_image_grid(images.permute(0, 2, 3, 1).float().cpu().numpy(), savepath,
                        nrow=math.ceil(math.sqrt(n_samples)))

    result = run.train(state, train_step, loader, lambda batch: image_batch(batch, device),
                       sample_and_save)
    result["load_seconds"] = load_seconds
    return result


if __name__ == "__main__":
    main()
