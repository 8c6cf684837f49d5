"""MMDiT rectified-flow training on precomputed text embeddings.

    python -m dmtpu_torch.scripts.train_mmdit -c configs/mmdit_flow_synthetic.yaml
        [-e EXP_DIR] [-r best|latest|PATH] [-ni] [--device cuda|cpu] [key.sub=value ...]

Counterpart of ``scripts/train_mmdit.py``.  The dataset gives
``{"image", "context", "pooled"}`` items (captions embedded once, offline:
no text tower runs in the step), the diffusion is ``FlowMatching`` (or a
subclass of it), and the model is the config's MMDiT.  Each step draws t and
eps from the step's generator (``make_diffusion_loss_fn``); the model drops
each sample's conditioning to the all-zeros null with its
``cond_dropout_prob``, drawing the mask from the device's default generator,
which the train step seeds from (seed, step): the mask is a function of seed
and step.  ``make_train_step`` averages over ``train.micro_batch`` splits,
clips, steps the optimizer and the EMA.  Every ``train.sample_freq`` steps
the EMA weights (the trained ones without an EMA) draw ``train.n_samples``
samples with ``FlowMatchingCFG`` at ``train.sample_guidance_scale`` (else
the config's ``guidance_scale``, else 2.0) over the config's diffusion, its
CFG keys dropped: the conditioning of the first ``n_samples`` items against
the all-zeros null, into ``<exp_dir>/samples/stepNNNNNN.png``.  Checkpoints,
resume, overrides and ``--device`` are ``train_ddpm_cfg``'s
(``dmtpu_torch.scripts._common.TrainRun``).

``model.params.param_dtype=bfloat16`` stores MMDiT's torso in bf16 (the
optimizer state and a ``train.ema_dtype: bfloat16`` shadow follow it), as
``configs/sd3_medium.yaml`` advises for SD3-medium.

Under ``torchrun --nproc_per_node N`` the run is data-parallel over N ranks
(``TrainRun``: each rank takes its rows of every batch, the gradients are
averaged over the ranks, as the JAX CLIs' mesh of fsdp 1) and equals the
one-rank run of a model without dropout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from dmtpu_torch.diffusions import FlowMatching, FlowMatchingCFG
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
from dmtpu_torch.parallel.train import default_generator
from dmtpu_torch.scripts._common import TrainRun, seeded_instance, to_device
from dmtpu_torch.utils.config import instantiate_from_config
from dmtpu_torch.utils.image import save_image_grid

ITEM_KEYS = ("image", "context", "pooled")
# the diffusion's keys that belong to guidance, which the eval sampler sets
_CFG_KEYS = ("guidance_scale", "cond_kwarg", "guidance_interval")


def check_item(item: Any) -> None:
    """Refuse a dataset whose items are not ``{image, context, pooled}`` dicts."""
    if not (isinstance(item, dict) and set(ITEM_KEYS) <= set(item)):
        raise ValueError("train_mmdit needs dataset items {'image','context','pooled'} "
                         "(precomputed text embeddings), got " + str(type(item)))


def check_diffusion(diffuser: Any, conf: Mapping) -> None:
    """Refuse a diffusion outside the flow-matching family."""
    if not isinstance(diffuser, FlowMatching):
        raise ValueError("train_mmdit trains the flow-matching objective; "
                         f"got diffusion.target={conf['diffusion']['target']}")


def eval_sampler(conf: Mapping) -> FlowMatchingCFG:
    """The periodic sampler: FlowMatchingCFG on ``y`` over the config's
    diffusion without its guidance keys."""
    params = {k: v for k, v in dict(conf["diffusion"].get("params", None) or {}).items()
              if k not in _CFG_KEYS + ("device",)}
    scale = conf["train"].get("sample_guidance_scale",
                              conf["diffusion"]["params"].get("guidance_scale", 2.0))
    return FlowMatchingCFG(guidance_scale=float(scale), cond_kwarg="y", **params)


def eval_conditioning(dataset, n: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The conditioning of the first ``n`` items, stacked, on ``device``."""
    return {k: torch.from_numpy(np.stack([np.asarray(dataset[i][k], np.float32)
                                          for i in range(n)])).to(device)
            for k in ("context", "pooled")}


def embedded_batch(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader's dict batch -> NCHW f32 images and the f32 embeddings on ``device``."""
    out = {"image": to_device(batch["image"], device)}
    for k in ("context", "pooled"):
        x = torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
        out[k] = x.pin_memory().to(device, non_blocking=True) if device.type == "cuda" \
            else x
    return out


@torch.no_grad()
def eval_samples(model: nn.Module, weights: Mapping[str, torch.Tensor], sampler: FlowMatchingCFG,
                 y: Dict[str, torch.Tensor], noise: torch.Tensor) -> torch.Tensor:
    """The eval grid's samples in [-1, 1], NCHW: ``sampler`` over ``model``
    with ``weights`` (by parameter name, cast to the parameters' dtypes)
    from ``noise``, conditioned on ``y`` against the all-zeros null."""
    params = {name: weights[name].to(p.dtype) for name, p in model.named_parameters()}
    null = {k: torch.zeros_like(v) for k, v in y.items()}
    out = sampler.sample(
        lambda x, t, y=None, **kw: torch.func.functional_call(model, params, (x, t, y)),
        noise, None, uncond_conditioning=null, model_kwargs={"y": y})
    return out.clamp(-1.0, 1.0)


def train_apply(model: nn.Module):
    """The loss's model call: the batch's embeddings packed into MMDiT's
    ``y``, the conditioning dropout drawn from the device's default
    generator."""

    def apply(x: torch.Tensor, t: torch.Tensor, context=None, pooled=None) -> torch.Tensor:
        return model(x, t, {"context": context, "pooled": pooled}, train=True,
                     drop_generator=default_generator(x.device))

    return apply


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train; returns what the run measured (``TrainRun.train``'s result and
    the seconds of the load, ``load_seconds``)."""
    run = TrainRun.open(argv, __doc__, "train_mmdit")
    conf, device, seed = run.conf, run.device, run.seed
    loader = run.loader()
    check_item(loader.dataset[0])

    diffuser = instantiate_from_config(conf.diffusion)
    check_diffusion(diffuser, conf)
    model = seeded_instance(conf.model, device, seed).train()
    run.logger.info(f"Model parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    optimizer = instantiate_from_config(conf.train.optim, params=model.parameters())
    state = TrainState.create(model, optimizer, ema_decay=conf.train.ema_decay,
                              ema_gradual=conf.train.get("ema_gradual", True),
                              ema_dtype=conf.train.get("ema_dtype"))
    state = run.place(state)
    load_seconds = run.resume(state)
    loss_fn = make_diffusion_loss_fn(diffuser, train_apply(model),
                                     int(conf.diffusion.params.total_steps))
    train_step = make_train_step(loss_fn, clip_grad_norm=conf.train.clip_grad_norm,
                                 micro_batches=run.micro_batches, seed=seed,
                                 mesh=run.mesh)

    sampler = eval_sampler(conf)
    n_samples = conf.train.n_samples
    eval_y = eval_conditioning(loader.dataset, n_samples, device)
    shape = (conf.data.get("img_channels", 3),) + (conf.data.params.img_size,) * 2

    def sample_and_save(savepath: str, generator: torch.Generator) -> None:
        weights = state.ema.shadow if state.ema is not None else dict(model.named_parameters())
        noise = torch.randn((n_samples,) + shape, generator=generator, device=device)
        images = eval_samples(model, weights, sampler, eval_y, noise)
        save_image_grid(images.permute(0, 2, 3, 1).float().cpu().numpy(), savepath,
                        nrow=math.ceil(math.sqrt(n_samples)))

    result = run.train(state, train_step, loader, lambda batch: embedded_batch(batch, device),
                       sample_and_save)
    result["load_seconds"] = load_seconds
    return result


if __name__ == "__main__":
    main()
