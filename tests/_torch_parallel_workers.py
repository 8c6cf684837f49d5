"""What each gloo rank runs in ``tests/test_torch_parallel.py`` (no JAX:
the ranks import this module).  The tiny UNet of ``tests/test_parallel.py``
(dim 32, two levels, attention at the second), its weights read from a file
the parent writes, so every rank and the parent start from the same ones."""
from __future__ import annotations

import numpy as np
import torch

from dmtpu_torch.diffusions import DDPM
from dmtpu_torch.models.unet import UNet
from dmtpu_torch.models.unet_categorial_adagn import UNetCategorialAdaGN
from dmtpu_torch.parallel import (
    TrainState,
    make_diffusion_loss_fn,
    make_mesh,
    make_train_step,
    shard_batch,
    shard_train_state,
)
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils import optim

UNET = dict(dim=32, dim_mults=(1, 2), use_attn=(False, True), num_res_blocks=1, dropout=0.0)
ADAGN = dict(dim=32, dim_mults=(1, 2), use_attn=(False, False), num_classes=10, dropout=0.0)
# adafactor with the options whose statistics span a whole parameter (the
# block RMS of parameter scaling, the factored moments: 32 and 64 channels
# factor at 32) and a bf16 momentum.  eps 1e-8, not 1e-30: a bias before a
# one-channel-per-group GroupNorm has a zero gradient by the model's math,
# which holds only rounding noise, other noise in a sharded sum than in an
# unsharded one; at eps 1e-30 adafactor makes of it a full step of either
# sign (g / sqrt(g^2 + eps)), at 1e-8 a vanishing one, while a real
# gradient (|g| >> 1e-4) still steps as at 1e-30
ADAFACTOR = dict(lr=1e-3, min_dim_size_to_factor=32, momentum=0.9,
                 multiply_by_parameter_scale=True, eps=1e-8)


def batches(n_steps: int, size: int = 16, seed: int = 2) -> list:
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(size, 3, 8, 8).astype(np.float32))
            for _ in range(n_steps)]


def build(weights: str, kind: str = "unet") -> torch.nn.Module:
    model = UNet(**UNET) if kind == "unet" else UNetCategorialAdaGN(**ADAGN)
    model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def full_state(state: TrainState) -> dict:
    """The parameters and the EMA shadow as full tensors (a collective)."""
    params = ckpt_lib._full(dict(state.model.named_parameters()))
    shadow = ckpt_lib._full(state.ema.shadow) if state.ema is not None else {}
    return {"params": {k: v.detach().clone() for k, v in params.items()},
            "ema": {k: v.clone() for k, v in shadow.items()}}


def train(rank: int, world: int, weights: str, fsdp: int = 1, micro_batches: int = 1,
          loss: str = "diffusion", opt: str = "sgd", n_steps: int = 1, ema: bool = True,
          kind: str = "unet", p_uncond=None, ckpt_dir=None, clip=None):
    """``n_steps`` steps of the global batches of ``batches`` on a (data,
    fsdp) mesh of ``world`` ranks (``world == 0``: no mesh, in this
    process), gradients clipped at ``clip``; returns (losses, grad norms,
    ``full_state``, any parameter sharded)."""
    mesh = make_mesh("cpu", fsdp) if world else None
    model = build(weights, kind)
    optimizer = {"sgd": lambda ps: optim.sgd(ps, lr=0.1),
                 "adam": lambda ps: optim.adam(ps, lr=1e-3),
                 "adafactor": lambda ps: optim.adafactor(ps, **ADAFACTOR)}[opt](model.parameters())
    state = TrainState.create(model, optimizer, ema_decay=0.999 if ema else None)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    if loss == "diffusion":
        if kind == "unet":
            loss_fn = make_diffusion_loss_fn(DDPM(total_steps=100), model, 100)
        else:
            loss_fn = make_diffusion_loss_fn(DDPM(total_steps=100), model, 100,
                                             p_uncond=p_uncond, null_label=10)
    else:
        def loss_fn(batch, generator):
            return model(batch, torch.zeros(batch.shape[0], dtype=torch.long)).square().mean()
    step = make_train_step(loss_fn, clip_grad_norm=clip, micro_batches=micro_batches, seed=0,
                           mesh=mesh)
    losses, norms = [], []
    for x in batches(n_steps):
        batch = (x, torch.arange(x.shape[0]) % 10) if kind != "unet" else x
        metrics = step(state, shard_batch(batch, mesh, micro_batches))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    if ckpt_dir is not None:
        ckpt_lib.save_checkpoint(ckpt_dir, state.step, state)
    sharded = any(type(p).__name__ == "DTensor" for p in model.parameters())
    return losses, norms, full_state(state), sharded


def sample(rank: int, world: int, weights: str, batch: int, sampler: str = "ddpm"):
    """One DataParallelSampler batch of ``batch`` noises through a 5-step
    respaced DDPM (stochastic) or DDIM sampler (``world == 0``: one rank)."""
    from dmtpu_torch.diffusions import DDIM
    from dmtpu_torch.scripts._common import DataParallelSampler

    model = build(weights).eval()
    cls = DDPM if sampler == "ddpm" else DDIM
    diffuser = cls(total_steps=100, respace_type="uniform", respace_steps=5)
    generator = torch.Generator().manual_seed(7)
    noise = torch.randn(batch, 3, 8, 8, generator=generator)
    dp = DataParallelSampler()
    with torch.no_grad():
        return dp.run(lambda x, generator: diffuser.sample(lambda xx, tt: model(xx, tt), x,
                                                           generator),
                      noise, generator=generator), dp.is_main


def run_clis(rank: int, world: int, jobs: list, out_root: str) -> list:
    """Each ``(module, argv)`` of ``jobs`` run as its CLI's ``main``, with
    ``{out}`` in argv standing for ``<out_root>/<world>/<job index>``; returns
    the job indices that ran."""
    import importlib
    import os

    done = []
    for i, (module, argv) in enumerate(jobs):
        out = os.path.join(out_root, str(world), str(i))
        importlib.import_module(f"dmtpu_torch.scripts.{module}").main(
            [a.replace("{out}", out) for a in argv])
        done.append(i)
    return done


def ring(rank: int, world: int, q, k, v, g_out):
    """``sp_attention`` of the whole q, k, v over a mesh of ``world`` ranks
    on its fsdp dim: (output, gradients of sum(out * g_out)); and whether
    the ring over this rank's chunks, forward and backward, is bit for bit
    this rank's part of ``fold_attention`` / ``fold_attention_backward`` of
    the whole tensors over ``world`` chunks."""
    from dmtpu_torch.parallel import sp

    mesh = make_mesh("cpu", world)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = sp.sp_attention(*leaves, mesh)
    (out * g_out).sum().backward()
    chunk = lambda x, dim=1: x.chunk(world, dim=dim)[rank].contiguous()  # noqa: E731
    local = [chunk(x).requires_grad_() for x in (q, k, v)]
    ring_out = sp.ring_attention(*local)
    ring_out.backward(chunk(g_out))
    o, lse = sp.fold_attention(q, k, v, world)
    folded = (o, *sp.fold_attention_backward(q, k, v, o, lse, g_out, world))
    ring_is_fold = all(torch.equal(a, chunk(b)) for a, b in
                       zip((ring_out.detach(), *(x.grad for x in local)), folded))
    return out.detach(), [x.grad for x in leaves], ring_is_fold


def tensor_parallel(rank: int, world: int, kind: str, weights: str, cfg: dict, args: tuple):
    """The model of ``kind`` ("sd" or "dit") made tensor-parallel over all
    ranks: (its output, the gathered gradients of mean(out^2), the local
    shape of every sharded parameter, ``tp_param_sharding``'s split dim of
    every parameter)."""
    from dmtpu_torch.models.dit import DiT
    from dmtpu_torch.models.stablediffusion import SDUNetModel
    from dmtpu_torch.parallel.tp import gather_params_tp, shard_params_tp

    from dmtpu_torch.parallel.tp import tp_param_sharding

    mesh = make_mesh("cpu", world)
    model = (SDUNetModel if kind == "sd" else DiT)(**cfg)
    model.load_state_dict(torch.load(weights, weights_only=True))
    rule = {n: getattr(pl[1], "dim", None)
            for n, pl in tp_param_sharding(mesh, dict(model.named_parameters())).items()}
    shard_params_tp(model, mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if n in model.tp_layout}
    out = model(*args)
    out.square().mean().backward()
    return out.detach(), gather_params_tp(model, mesh, grads=True), shapes, rule


def pipeline(rank: int, world: int, weights: str, cfg: dict, args: tuple, fsdp: int,
             n_microbatches=None, dp_axis=None):
    """DiT through ``dit_pipeline_forward`` on a (world / fsdp, fsdp) mesh:
    (its output, the gradients of mean(out^2) by parameter name)."""
    from dmtpu_torch.models.dit import DiT
    from dmtpu_torch.parallel.pp import dit_pipeline_forward

    mesh = make_mesh("cpu", fsdp)
    model = DiT(**cfg)
    model.load_state_dict(torch.load(weights, weights_only=True))
    out = dit_pipeline_forward(model, *args, mesh=mesh, n_microbatches=n_microbatches,
                               dp_axis=dp_axis)
    out.square().mean().backward()
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None}
