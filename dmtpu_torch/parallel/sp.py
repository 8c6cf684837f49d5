"""Sequence parallelism: ring attention over a process group, through K1 and K2.

Counterpart of ``dmtpu/parallel/sp.py`` (ring attention, Liu et al. 2023,
arXiv:2310.01889): each rank holds S/n tokens of q, k and v; the K/V chunks
rotate around the ring of ranks (``batch_isend_irecv`` to the next rank,
from the previous one) while each rank folds one chunk a hop into its
output, so n hops see every token and no rank holds more than two chunks.

- A hop of the forward pass is K1 (``flash_attention_fwd``) on the local q
  against the visiting chunk, giving that chunk's O and row logsumexp; the
  partial results are merged by their lse in f32 (``merge``), where the
  JAX package folds the chunk's logits into a running max and normaliser.
- The backward pass (``RingAttention``, a ``torch.autograd.Function``) runs
  K2 (``flash_attention_bwd``) a hop on the visiting chunk with the global
  O and lse: the chunk's P = exp(S - lse) is then its share of the global
  softmax, so its dK / dV are exact and dQ is the sum over hops (in f32).
  Each chunk's dK / dV travel with it, are added to at every rank, and are
  sent back to their rank at the end.  The JAX package gets its backward
  from ``jax.grad`` through the ring.
- On the CPU the hops run K1's and K2's plain versions.

``ring_forward`` and ``ring_backward`` are the ring's arithmetic over the
ranks that one process holds, with the passing of chunks to the next rank
given as a function: ``RingAttention`` holds its own rank and passes
chunks by ``batch_isend_irecv``; ``fold_attention`` and
``fold_attention_backward`` hold all n ranks on one device and pass
chunks by reindexing a list.  So the fold is the ring hop for hop (the
same K1 and K2 calls, the same f32 merges and sums in the same order), and
the card runs the ring's arithmetic, backward included, on one device.

``sp_attention`` takes the whole [B, S, H, D] tensors on every rank, as the
JAX function does, shards the sequence over the mesh dim ``axis`` and
gathers the output; its gradients are those of one loss over that output,
as ``jax.grad``'s are.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
from dmtpu_torch.parallel.mesh import FSDP_AXIS, all_gather_cat

Chunk = Tuple[torch.Tensor, torch.Tensor]


def merge(o: Optional[torch.Tensor], lse: Optional[torch.Tensor], o_c: torch.Tensor,
          lse_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 (O [B, S, H, D], lse [B, H, S]) of attention over two key
    sets from each one's O and lse."""
    o_c, lse_c = o_c.float(), lse_c.float()
    if o is None:
        return o_c, lse_c
    new = torch.logaddexp(lse, lse_c)
    w = torch.exp(lse - new).transpose(1, 2).unsqueeze(-1)
    w_c = torch.exp(lse_c - new).transpose(1, 2).unsqueeze(-1)
    return o * w + o_c * w_c, new


Pass = Callable[[List[Tuple[torch.Tensor, ...]]], Callable[[], List[Tuple[torch.Tensor, ...]]]]


def ring_forward(qs: Sequence[torch.Tensor], kvs: Sequence[Chunk], n: int, pass_on: Pass,
                 scale: Optional[float] = None
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(O in q's dtype, f32 lse) of each held rank's q over n hops.  Rank i
    of ``qs`` starts with chunk i of ``kvs``; ``pass_on(items)`` starts
    handing each held rank's item to the next rank and returns the function
    that waits for the items received, so the hop's K1 runs while they
    travel."""
    outs = [(None, None)] * len(qs)
    kvs = list(kvs)
    for hop in range(n):
        received = pass_on(kvs) if hop < n - 1 else None
        outs = [merge(*out, *flash_attention_fwd(q, *kv, scale))
                for q, kv, out in zip(qs, kvs, outs)]
        if received is not None:
            kvs = received()
    return [o.to(q.dtype) for q, (o, _) in zip(qs, outs)], [lse for _, lse in outs]


def ring_backward(qs: Sequence[torch.Tensor], kvs: Sequence[Chunk],
                  os_: Sequence[torch.Tensor], lses: Sequence[torch.Tensor],
                  dos: Sequence[torch.Tensor], n: int, pass_on: Pass,
                  scale: Optional[float] = None
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """(dq, dk, dv) of each held rank, from the global O and lse: a hop is
    K2 on the visiting chunk; dq and the chunk's dK / dV sums are f32, the
    sums travel with their chunk and after n hops are back at its rank."""
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    carry = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
              torch.zeros(v.shape, dtype=torch.float32, device=v.device)) for k, v in kvs]
    for hop in range(n):
        for q, o, lse, do, dq, (k, v, dk, dv) in zip(qs, os_, lses, dos, dqs, carry):
            dq_c, dk_c, dv_c = flash_attention_bwd(q, k, v, o, lse, do, scale)
            dq += dq_c.float()
            dk += dk_c.float()
            dv += dv_c.float()
        # the chunk and its sums go on to the next rank; the last hop sends
        # only the sums home
        carry = pass_on(carry if hop < n - 1 else [c[2:] for c in carry])()
    dks, dvs = zip(*(c[-2:] for c in carry))
    return ([dq.to(q.dtype) for q, dq in zip(qs, dqs)],
            [dk.to(k.dtype) for (k, _), dk in zip(kvs, dks)],
            [dv.to(v.dtype) for (_, v), dv in zip(kvs, dvs)])


def _pass_in_list(items: list) -> Callable[[], list]:
    """All n ranks held: rank i receives rank i - 1's item."""
    return lambda: items[-1:] + items[:-1]


def _chunks(x: torch.Tensor, n: int, dim: int = 1) -> List[torch.Tensor]:
    """The n chunks of ``x`` along ``dim`` that n ranks hold, each contiguous."""
    return [c.contiguous() for c in x.chunk(n, dim=dim)]


def fold_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int,
                   scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [B, S, H, D] in q's dtype, f32 lse [B, H, S]) of an n-rank ring
    over the whole tensors' n sequence chunks, on one device: n * n K1
    launches of S/n queries against S/n keys."""
    os_, lses = ring_forward(_chunks(q, n), list(zip(_chunks(k, n), _chunks(v, n))), n,
                             _pass_in_list, scale)
    return torch.cat(os_, dim=1), torch.cat(lses, dim=2)


def fold_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, n: int,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the whole tensors from an n-rank ring's backward over
    their n sequence chunks, on one device: n * n K2 launches."""
    dqs, dks, dvs = ring_backward(_chunks(q, n), list(zip(_chunks(k, n), _chunks(v, n))),
                                  _chunks(o, n), _chunks(lse, n, 2), _chunks(do, n), n,
                                  _pass_in_list, scale)
    return torch.cat(dqs, dim=1), torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


def _pass_to_next_rank(group) -> Pass:
    """This rank held: its item goes to the next rank of ``group``'s ring
    and the previous rank's comes in."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n) if group is not None else (rank + 1) % n
    prv = dist.get_global_rank(group, (rank - 1) % n) if group is not None else (rank - 1) % n

    def pass_on(items: list) -> Callable[[], list]:
        (item,) = items
        tensors = [t.contiguous() for t in item]
        received = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, prv, group) for r in received]
        requests = dist.batch_isend_irecv(ops)

        def wait() -> list:
            for req in requests:
                req.wait()
            return [tuple(received)]

        return wait

    return pass_on


class RingAttention(torch.autograd.Function):
    """Attention of this rank's q chunk against every rank's k / v chunk,
    [B, S/n, H, D] in and out, over the ring of ``group``'s ranks."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        n = dist.get_world_size(group)
        (o,), (lse,) = ring_forward([q], [(k, v)], n, _pass_to_next_rank(group), scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.scale = group, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        n = dist.get_world_size(ctx.group)
        (dq,), (dk,), (dv,) = ring_backward([q], [(k, v)], [o], [lse], [do.contiguous()], n,
                                            _pass_to_next_rank(ctx.group), ctx.scale)
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``group`` (default: every rank) of this rank's
    [B, S/n, H, D] chunks, rank r holding tokens [r S/n, (r + 1) S/n)."""
    return RingAttention.apply(q, k, v, group, scale)


class _TakeChunk(torch.autograd.Function):
    """The rank's chunk of dim 1; the gradient of the whole tensor is every
    rank's chunk gradient, gathered."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.group = group
        return x.chunk(n, dim=1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, 1, ctx.group), None


class _GatherChunks(torch.autograd.Function):
    """Every rank's chunk along dim 1; the gradient of the rank's chunk is
    its part of the (same on every rank) gradient of the whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=1)[r].contiguous(), None


def sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh,
                 axis: str = FSDP_AXIS, scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel MHA: [B, S, H, D] x3 -> [B, S, H, D], the whole
    tensors on every rank of the mesh dim ``axis``, each computing its S/n
    rows of the output by ring attention (differentiable)."""
    n = mesh[axis].size()
    s = q.shape[1]
    if s % n != 0:
        raise ValueError(f"sequence {s} not divisible by mesh axis '{axis}'={n}")
    group = mesh.get_group(axis)
    local = [_TakeChunk.apply(t, group) for t in (q, k, v)]
    return _GatherChunks.apply(ring_attention(*local, group=group, scale=scale), group)
