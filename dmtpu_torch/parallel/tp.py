"""Tensor parallelism (Megatron-style) of the attention and feed-forward
layers, over a mesh dim.

Counterpart of ``dmtpu/parallel/tp.py``.  The rules are the JAX package's:
``to_q`` / ``to_k`` / ``to_v``, the first layer of a feed-forward
(``net.0.proj``, ``net.0.0``) and a fused ``qkv`` are COLUMN parallel (their
output features split over the ranks: each rank computes its heads or its
hidden slice), ``to_out.0``, ``net.2``, ``proj_out`` and an attention's
``proj`` are ROW parallel (their input features split; one all-reduce
finishes them); everything else is replicated.  They key on module paths:
a torch parameter name is read as the JAX package's Flax path (an index
joins the name before it: ``to_out.0`` is ``to_out__0``; ``weight`` is
``kernel``), so both packages classify a layer alike.

The JAX package places the weights and GSPMD inserts the collectives; here
``shard_params_tp`` does the layout by hand: each rank keeps its slice of a
sharded weight (an ``nn.Parameter`` of the local shape, under the same
name), a column layer's input passes an identity whose gradient is summed
over the ranks, and a row layer sums its partial products over the ranks
before its bias.  What GSPMD re-shards in JAX is paired by hand:

- a GEGLU ``proj`` or a fused ``qkv`` splits its output by ``chunk`` after
  the matmul, so a rank's column slice is its slice of each chunk (GEGLU's
  value and gate halves, the fused q, k and v), never a plain block of rows;
- the attentions take their local head count (``CrossAttention.heads``,
  ``TimmAttention``'s heads);
- SD1.5's ``proj_out`` is a 1x1 ``Conv2d`` fed by the replicated
  transformer output: it is row-sharded by hand, each rank convolving its
  slice of the input channels with its slice of the weight (``proj_in``,
  which no rule names, stays replicated).

A layer the rules shard inside a module of another kind raises
``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from dmtpu_torch.parallel.mesh import FSDP_AXIS, all_gather_cat

_COLUMN = ("to_q", "to_k", "to_v", "net__0__proj", "net__0__0", "qkv")
_ROW = ("to_out__0", "net__2", "proj_out", "attn__proj")


def flax_path(name: str) -> Tuple[str, ...]:
    """A torch parameter name as the JAX package's Flax path: indices joined
    to the name before them, ``weight`` as ``kernel``."""
    parts = []
    for part in name.split("."):
        if part.isdigit() and parts:
            parts[-1] += "__" + part
        else:
            parts.append(part)
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def _classify(path: Tuple[str, ...]) -> str:
    """The JAX package's rule on a Flax path: "column", "row" or "replicate"."""
    if path[-1] != "kernel":
        return "replicate"
    mods = path[:-1]
    name = "__".join(mods[-2:]) if len(mods) >= 2 else mods[-1]
    leaf = mods[-1]
    if leaf in _COLUMN or name in _COLUMN:
        return "column"
    if leaf in _ROW or name in _ROW:
        return "row"
    return "replicate"


def classify(name: str) -> str:
    """"column", "row" or "replicate" for a torch parameter name."""
    return _classify(flax_path(name))


def _split_dim(kind: str, shape: Tuple[int, ...], size: int):
    """The torch dim a weight of ``kind`` splits (column: its output
    features, dim 0; row: its input features, dim 1), or None."""
    if size == 1 or len(shape) < 2 or kind == "replicate":
        return None
    dim = 0 if kind == "column" else 1
    return dim if shape[dim] % size == 0 else None


def tp_param_sharding(mesh: DeviceMesh, params: Mapping[str, torch.Tensor],
                      axis: str = FSDP_AXIS) -> Dict[str, Tuple[Any, Any]]:
    """Per parameter (by name) its placements over (data, ``axis``): the
    rules above, replicated where the split dim does not divide."""
    size = mesh[axis].size()
    out = {}
    for name, p in params.items():
        dim = _split_dim(classify(name), tuple(p.shape), size)
        out[name] = (Replicate(), Replicate() if dim is None else Shard(dim))
    return out


class _CopyToRanks(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks (a column
    layer's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverRanks(torch.autograd.Function):
    """The partial products summed over the ranks; the gradient passes as it
    is (a row layer's output)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _slice_param(module: nn.Module, name: str, dim: int, rank: int, size: int,
                 chunks: int = 1) -> None:
    """Replace ``module.<name>`` by this rank's slice along ``dim``: of each
    of ``chunks`` equal parts in turn (GEGLU's halves, a fused qkv's three)."""
    p = getattr(module, name)
    if p.shape[dim] % (chunks * size):
        raise ValueError(f"{name} of {p.shape[dim]} along dim {dim} does not split into "
                         f"{chunks} parts over {size} ranks")
    parts = p.detach().chunk(chunks, dim=dim)
    local = torch.cat([part.chunk(size, dim=dim)[rank] for part in parts], dim=dim)
    setattr(module, name, nn.Parameter(local.clone(), requires_grad=p.requires_grad))


def _column_forward(layer: nn.Module, group, x: torch.Tensor) -> torch.Tensor:
    return type(layer).forward(layer, _CopyToRanks.apply(x, group))


def _row_forward(layer: nn.Module, group, rank: int, size: int, x: torch.Tensor
                 ) -> torch.Tensor:
    """The layer on this rank's input features (sliced here when the input
    is whole), summed over the ranks, plus the bias."""
    conv = isinstance(layer, nn.Conv2d)
    dim = 1 if conv else -1
    local = layer.weight.shape[1]
    if x.shape[dim] != local:
        x = _CopyToRanks.apply(x, group).narrow(dim, rank * local, local)
    dt = getattr(layer, "compute_dtype", x.dtype)
    w = layer.weight.to(dt)
    y = layer._conv_forward(x.to(dt), w, None) if conv else F.linear(x.to(dt), w)
    y = _SumOverRanks.apply(y, group)
    if layer.bias is not None:
        y = y + (layer.bias.to(dt).reshape(1, -1, 1, 1) if conv else layer.bias.to(dt))
    return y


def _timm_attention_forward(attn: nn.Module, heads: int, x: torch.Tensor) -> torch.Tensor:
    """``TimmAttention.forward`` with ``heads`` local heads."""
    from dmtpu_torch.ops.attention import attention

    b, t, d = x.shape
    hd = d // (heads * attn.tp_size)
    qkv = attn.qkv(x).reshape(b, t, 3, heads, hd)
    out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    return attn.proj(out.reshape(b, t, heads * hd))


def shard_params_tp(model: nn.Module, mesh: DeviceMesh, axis: str = FSDP_AXIS) -> nn.Module:
    """``model`` made tensor-parallel over the mesh dim ``axis`` in place (each
    rank keeping its slices of the sharded weights; ``model.tp_layout`` maps
    each sharded parameter to its (dim, chunks)); returns it.  Its outputs
    are those of the whole model on every rank."""
    from dmtpu_torch.models.dit import TimmAttention
    from dmtpu_torch.models.stablediffusion.attention import (
        GEGLU,
        CrossAttention,
        FeedForward,
        SpatialTransformer,
    )

    size, rank = mesh[axis].size(), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    if size == 1:
        return model
    parents = dict(model.named_modules())
    layout = model.__dict__.setdefault("tp_layout", {})
    for name, p in list(model.named_parameters()):
        kind = classify(name)
        dim = _split_dim(kind, tuple(p.shape), size)
        if dim is None:
            continue
        path, _, leaf = name.rpartition(".")
        layer = parents[path]
        owner = parents.get(path.rpartition(".")[0])
        owner2 = parents.get(path.rsplit(".", 2)[0]) if path.count(".") >= 2 else None
        if kind == "column":
            if isinstance(owner, CrossAttention):
                chunks = 1
            elif isinstance(owner, GEGLU):
                chunks = 2
            elif isinstance(owner, TimmAttention):
                chunks = 3
            else:
                raise NotImplementedError(f"tensor parallelism of {name} ({type(owner).__name__})")
            _slice_param(layer, "weight", 0, rank, size, chunks)
            layout[f"{path}.weight"] = (0, chunks)
            if layer.bias is not None:
                _slice_param(layer, "bias", 0, rank, size, chunks)
                layout[f"{path}.bias"] = (0, chunks)
            layer.forward = functools.partial(_column_forward, layer, group)
        else:
            fits = (isinstance(owner, (TimmAttention, SpatialTransformer))
                    or isinstance(owner2, CrossAttention) and path.endswith("to_out.0")
                    or isinstance(owner2, FeedForward) and path.endswith("net.2"))
            if not fits:
                raise NotImplementedError(f"tensor parallelism of {name}")
            _slice_param(layer, "weight", 1, rank, size)
            layout[f"{path}.weight"] = (1, 1)
            layer.forward = functools.partial(_row_forward, layer, group, rank, size)
    for module in model.modules():
        heads = getattr(module, "heads", getattr(module, "num_heads", 0))
        if isinstance(module, (CrossAttention, TimmAttention)) and heads % size:
            raise ValueError(f"{heads} heads do not split over {size} ranks")
        if isinstance(module, CrossAttention):
            module.heads //= size
        elif isinstance(module, TimmAttention):
            module.tp_size = size
            module.forward = functools.partial(_timm_attention_forward, module,
                                               module.num_heads // size)
    return model


def gather_params_tp(model: nn.Module, mesh: DeviceMesh, axis: str = FSDP_AXIS,
                     grads: bool = False) -> Dict[str, torch.Tensor]:
    """The whole parameters of a ``shard_params_tp`` model (or, with
    ``grads``, their gradients) by name, on every rank: the inverse of the
    slicing (a collective)."""
    group, size = mesh.get_group(axis), mesh[axis].size()
    layout = getattr(model, "tp_layout", {})
    out = {}
    for name, p in model.named_parameters():
        t = (p.grad if grads else p).detach()
        if name not in layout:
            out[name] = t.clone()
            continue
        dim, chunks = layout[name]
        pieces = [part.chunk(chunks, dim=dim)
                  for part in all_gather_cat(t, dim, group).chunk(size, dim=dim)]
        out[name] = torch.cat([torch.cat([pc[j] for pc in pieces], dim=dim)
                               for j in range(chunks)], dim=dim)
    return out
