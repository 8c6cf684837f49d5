"""Pipeline parallelism (GPipe) of a stack of identical blocks over a mesh dim.

Counterpart of ``dmtpu/parallel/pp.py``: the blocks of a homogeneous stack
(DiT's ``blocks``) are stacked into one tensor per parameter with a leading
layer axis, each of S stages (the ranks of the mesh dim ``axis``) applies
its L/S consecutive layers, and M microbatches stream through the stages,
each stage receiving a microbatch's activation from the stage before and
sending it on (``send`` / ``recv``): the GPipe schedule, M + S - 1 steps,
bubble (S - 1) / (M + S - 1).  The last stage's outputs are broadcast over
the stages, so every rank returns the whole output.

Autograd does not cross ``send`` / ``recv``, so the backward schedule is
explicit (``_Pipeline``, a ``torch.autograd.Function``): the stages run the
microbatches back in the same order, each recomputing its layers for the
microbatch from the activation it kept (one activation a microbatch a stage)
and sending the activation's gradient to the stage before.  The gradients
are those of one loss over the output, as ``jax.grad``'s are: the input's
is the first stage's, broadcast; the conditioning's and the stacked
parameters' are summed over the stages (each stage's layers add only to
their own slice).  ``dp_axis`` shards every microbatch over that mesh dim as
well (dp x pp): each ``dp_axis`` row runs its own pipeline on its rows, the
rows are gathered, and the parameters' gradients summed over the rows.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dmtpu_torch.parallel.mesh import FSDP_AXIS, all_gather_cat

Stacked = Dict[str, torch.Tensor]


def stack_block_params(params: Mapping[str, torch.Tensor], prefix: str = "blocks."
                       ) -> Tuple[Stacked, Dict[str, torch.Tensor], int]:
    """Split a flat state dict into (stacked blocks, the rest, block count):
    ``<prefix>{i}.<name>`` for consecutive i from 0 become ``<name>`` with a
    new leading layer axis (``torch.stack``: differentiable)."""
    idx = sorted({int(k[len(prefix):].split(".")[0]) for k in params if k.startswith(prefix)})
    if not idx or idx != list(range(len(idx))):
        raise ValueError(f"no consecutive '{prefix}i' blocks in params: {idx}")
    names = [k[len(f"{prefix}0."):] for k in params if k.startswith(f"{prefix}0.")]
    stacked = {n: torch.stack([params[f"{prefix}{i}.{n}"] for i in idx]) for n in names}
    rest = {k: v for k, v in params.items() if not k.startswith(prefix)}
    return stacked, rest, len(idx)


def _apply_stage(block_fn, layers: Stacked, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    n = next(iter(layers.values())).shape[0]
    for i in range(n):
        h = block_fn({k: v[i] for k, v in layers.items()}, h, c)
    return h


class _Pipeline(torch.autograd.Function):
    """GPipe over ``group``'s ranks (stage = rank in the group) of this dp
    row's microbatches ``xs`` [M, b, ...] and ``cs`` [M, b, ...]."""

    @staticmethod
    def forward(ctx, xs, cs, block_fn, group, names, *stacked):
        n_stages, stage = dist.get_world_size(group), dist.get_rank(group)
        prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
        nxt = dist.get_global_rank(group, stage + 1) if stage < n_stages - 1 else None
        last = dist.get_global_rank(group, n_stages - 1)
        per = stacked[0].shape[0] // n_stages
        local = {n: t[stage * per:(stage + 1) * per].detach() for n, t in zip(names, stacked)}
        inputs = []
        outs = torch.empty(xs.shape, dtype=xs.dtype, device=xs.device)
        with torch.no_grad():
            for i in range(xs.shape[0]):
                h = xs[i]
                if prev is not None:
                    h = torch.empty(xs.shape[1:], dtype=xs.dtype, device=xs.device)
                    dist.recv(h, prev, group=group)
                inputs.append(h)
                h = _apply_stage(block_fn, local, h, cs[i])
                if nxt is not None:
                    dist.send(h.contiguous(), nxt, group=group)
                else:
                    outs[i] = h
        dist.broadcast(outs, last, group=group)
        ctx.block_fn, ctx.group, ctx.names, ctx.per = block_fn, group, names, per
        ctx.links = (prev, nxt, stage, n_stages)
        ctx.save_for_backward(cs, *inputs, *stacked)
        ctx.n_in = len(inputs)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        prev, nxt, stage, n_stages = ctx.links
        group, per = ctx.group, ctx.per
        saved = ctx.saved_tensors
        cs, inputs, stacked = saved[0], saved[1:1 + ctx.n_in], saved[1 + ctx.n_in:]
        local = {n: t[stage * per:(stage + 1) * per].detach().requires_grad_()
                 for n, t in zip(ctx.names, stacked)}
        g_xs = torch.zeros((len(inputs),) + inputs[0].shape, dtype=inputs[0].dtype,
                           device=inputs[0].device)
        g_cs = torch.zeros(cs.shape, dtype=cs.dtype, device=cs.device)
        g_local = {n: torch.zeros_like(t) for n, t in local.items()}
        for i, h_in in enumerate(inputs):
            g = g_outs[i].contiguous()
            if nxt is not None:
                g = torch.empty(h_in.shape, dtype=h_in.dtype, device=h_in.device)
                dist.recv(g, nxt, group=group)
            with torch.enable_grad():
                h = h_in.detach().requires_grad_()
                c = cs[i].detach().requires_grad_()
                out = _apply_stage(ctx.block_fn, local, h, c)
                grads = torch.autograd.grad(out, [h, c, *local.values()], g,
                                            allow_unused=True)
            g_h, g_c, g_p = grads[0], grads[1], grads[2:]
            g_cs[i] += g_c if g_c is not None else 0
            for n, gp in zip(local, g_p):
                if gp is not None:
                    g_local[n] += gp
            if prev is not None:
                dist.send(g_h.contiguous(), prev, group=group)
            else:
                g_xs[i] = g_h
        first = dist.get_global_rank(group, 0)
        dist.broadcast(g_xs, first, group=group)
        dist.all_reduce(g_cs, group=group)
        g_stacked = []
        for n, t in zip(ctx.names, stacked):
            full = torch.zeros_like(t)
            full[stage * per:(stage + 1) * per] = g_local[n]
            dist.all_reduce(full, group=group)
            g_stacked.append(full)
        return (g_xs, g_cs, None, None, None, *g_stacked)


class _TakeRows(torch.autograd.Function):
    """This dp row's rows of dim 1 (the microbatch rows); the gradient of the
    whole is every row's, gathered."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.group = group
        return x.chunk(n, dim=1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, 1, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """Every dp row's rows along dim 1; the gradient of this row's is its
    part of the whole's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=1)[r].contiguous(), None


class _SumParamGrads(torch.autograd.Function):
    """Identity on the stacked parameters; their gradients summed over the dp
    rows (each row's pipeline saw only its rows)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.clone() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.contiguous()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


def pipeline_apply(stacked: Stacked, x: torch.Tensor, cond: torch.Tensor,
                   block_fn: Callable[[Stacked, torch.Tensor, torch.Tensor], torch.Tensor],
                   mesh: DeviceMesh, axis: str = FSDP_AXIS,
                   n_microbatches: Optional[int] = None,
                   dp_axis: Optional[str] = None) -> torch.Tensor:
    """``x`` [B, ...] through the stacked blocks, pipelined over the mesh dim
    ``axis``; the same shape out, on every rank.  ``block_fn(layer, h,
    cond)`` applies one block (``layer``: one slice of ``stacked``);
    ``cond`` [B, ...] goes to every block.  ``n_microbatches`` defaults to
    the stage count (B % M == 0 required).  ``dp_axis`` (another mesh dim)
    shards each microbatch's rows over its ranks as well."""
    if dp_axis == axis:
        raise ValueError("dp_axis must differ from the pipeline stage axis")
    n_stages = mesh[axis].size()
    batch = x.shape[0]
    m = n_microbatches or n_stages
    if batch % m != 0:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    layers = next(iter(stacked.values())).shape[0]
    if layers % n_stages != 0:
        raise ValueError(f"{layers} layers not divisible by {n_stages} stages")
    mb = batch // m
    if dp_axis is not None and mb % mesh[dp_axis].size() != 0:
        raise ValueError(f"microbatch {mb} not divisible by mesh axis '{dp_axis}'="
                         f"{mesh[dp_axis].size()}")
    xs = x.reshape((m, mb) + x.shape[1:])
    cs = cond.reshape((m, mb) + cond.shape[1:])
    names = list(stacked)
    tensors = [stacked[n] for n in names]
    if dp_axis is not None:
        dp_group = mesh.get_group(dp_axis)
        xs, cs = _TakeRows.apply(xs, dp_group), _TakeRows.apply(cs, dp_group)
        tensors = list(_SumParamGrads.apply(dp_group, *tensors))
    out = _Pipeline.apply(xs, cs, block_fn, mesh.get_group(axis), names, *tensors)
    if dp_axis is not None:
        out = _GatherRows.apply(out, dp_group)
    return out.reshape((batch,) + out.shape[2:])


def dit_pipeline_forward(model, x: torch.Tensor, t: torch.Tensor,
                         y: Optional[torch.Tensor] = None, *, mesh: DeviceMesh,
                         axis: str = FSDP_AXIS, n_microbatches: Optional[int] = None,
                         dp_axis: Optional[str] = None, stacked: Optional[Stacked] = None
                         ) -> torch.Tensor:
    """DiT's forward with its blocks pipelined over ``axis``: the embed and
    head run on every rank, the blocks stream through ``pipeline_apply``.
    ``stacked`` defaults to the model's blocks stacked (gradients reach
    them)."""
    if stacked is None:
        stacked, _, _ = stack_block_params(dict(model.named_parameters()))
    tokens, c = model.embed(x, t, y)
    template = model.blocks[0]

    def block_fn(layer: Stacked, h: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(template, layer, (h, cc))

    tokens = pipeline_apply(stacked, tokens, c, block_fn, mesh, axis=axis,
                            n_microbatches=n_microbatches, dp_axis=dp_axis)
    return model.head(tokens, c)
