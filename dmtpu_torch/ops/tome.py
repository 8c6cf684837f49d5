"""Token Merging (ToMe) for SD serving: bipartite soft matching on a fixed grid.

Counterpart of ``dmtpu/ops/tome.py`` (Bolya & Hoffman, "Token Merging for
Fast Stable Diffusion", 2023).  Before a self-attention the ``r`` most
redundant tokens are merged (averaged) into their most similar
destinations; after it the merged outputs are copied back to every source
position.  One destination token sits in each (sy, sx) cell of the token
grid.

- The source / destination partition is built once in numpy for each
  ``(h, w, sx, sy, seed)`` and kept on the device (``_grid``), so a block
  copies nothing from the host.
- Matching is one f32 product of the normalised features, a first-maximum
  ``argmax`` and a stable descending sort: equal scores keep the lower
  index first, as ``jax.lax.top_k`` orders them.  It runs without autograd:
  its results are indices, which carry no gradient in either package.
- Merging adds the sources into their destinations in f32 by
  ``scatter_add``, divides by the counts and casts back to ``x``'s dtype
  (the JAX package computes the same sum as a one-hot product); unmerging is
  one gather through a (B, N) index map.  Both are differentiable in ``x``.

A ToMe model adds no parameters: its ``state_dict`` is the baseline's.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

MergeFn = Callable[[torch.Tensor], torch.Tensor]
UnmergeFn = Callable[[torch.Tensor], torch.Tensor]


def dst_index_grid(h: int, w: int, sx: int = 2, sy: int = 2,
                   seed: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed src/dst partition of an h*w token grid.

    One destination token per (sy, sx) cell: position 0 of the cell when
    ``seed`` is None (tomesd's ``no_rand``), else a per-cell offset drawn on
    the host from ``seed``.  Tokens outside full cells (the h % sy and
    w % sx remainders) are always sources.

    Returns ``(a_idx, b_idx)``: flat-token indices of sources and
    destinations, each sorted ascending.
    """
    hsy, wsx = h // sy, w // sx
    if seed is None:
        off_y = np.zeros((hsy, wsx), np.int64)
        off_x = np.zeros((hsy, wsx), np.int64)
    else:
        rng = np.random.RandomState(seed)
        off = rng.randint(0, sy * sx, size=(hsy, wsx))
        off_y, off_x = off // sx, off % sx
    ys = np.arange(hsy)[:, None] * sy + off_y
    xs = np.arange(wsx)[None, :] * sx + off_x
    b_idx = np.sort((ys * w + xs).reshape(-1))
    mask = np.ones(h * w, bool)
    mask[b_idx] = False
    a_idx = np.nonzero(mask)[0]
    return a_idx, b_idx


@functools.lru_cache(maxsize=64)
def _grid(h: int, w: int, sx: int, sy: int, seed: Optional[int],
          device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dst_index_grid`` as int64 tensors on ``device``, built once."""
    a_np, b_np = dst_index_grid(h, w, sx, sy, seed)
    return (torch.as_tensor(a_np, dtype=torch.int64, device=device),
            torch.as_tensor(b_np, dtype=torch.int64, device=device))


def identity_merge() -> Tuple[MergeFn, UnmergeFn]:
    return (lambda x: x), (lambda x: x)


def bipartite_soft_matching_2d(metric: torch.Tensor, h: int, w: int, *,
                               sx: int = 2, sy: int = 2, r: int = 0,
                               seed: Optional[int] = None) -> Tuple[MergeFn, UnmergeFn]:
    """(merge, unmerge) built from per-token features ``metric``.

    ``metric``: (B, N=h*w, C), the transformer block's input (before its
    norm), as in tomesd.  ``r`` tokens (clamped to the number of sources)
    are merged.

    merge(x):   (B, N, C) -> (B, N-r, C), ordered [unmerged sources, destinations]
    unmerge(y): (B, N-r, C) -> (B, N, C), a merged source gets its destination's row

    Each batch item matches on its own (the CFG halves independently).
    """
    B, N, _ = metric.shape
    if N != h * w:
        raise ValueError(f"metric has {N} tokens, expected h*w={h * w}")
    a_idx, b_idx = _grid(h, w, sx, sy, seed, metric.device)
    na, nb = len(a_idx), len(b_idx)
    r = max(0, min(int(r), na))
    # a cell larger than the grid leaves no destination (or no source):
    # nothing can merge
    if r == 0 or nb == 0 or na == 0:
        return identity_merge()

    with torch.no_grad():
        mn = metric.float()
        mn = mn / (torch.linalg.vector_norm(mn, dim=-1, keepdim=True) + 1e-6)
        scores = torch.matmul(mn[:, a_idx], mn[:, b_idx].transpose(1, 2))  # (B, na, nb)
        node_max = scores.amax(dim=-1)
        node_idx = scores.argmax(dim=-1)                                  # first maximum
        del scores
        # rank sources by how well they matched, best first; ties by index
        order = torch.sort(node_max, dim=-1, descending=True, stable=True).indices
        src_idx = order[:, :r]                                            # (B, r)
        unm_idx = order[:, r:].sort(dim=-1).values                        # (B, na - r)
        dst_of_src = node_idx.gather(1, src_idx)                          # (B, r)
        counts = torch.ones(B, nb, device=metric.device).scatter_add_(
            1, dst_of_src, torch.ones(B, r, device=metric.device))
        # the row of [unm | dst] that each original position reads back
        gidx = torch.empty(B, N, dtype=torch.int64, device=metric.device)
        gidx.scatter_(1, a_idx[unm_idx], torch.arange(
            na - r, device=metric.device).expand(B, -1).contiguous())
        gidx[:, b_idx] = na - r + torch.arange(nb, device=metric.device)
        gidx.scatter_(1, a_idx[src_idx], na - r + dst_of_src)

    def merge(x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        xa, xb = x[:, a_idx], x[:, b_idx]
        unm = xa.gather(1, unm_idx[..., None].expand(-1, -1, c))
        src = xa.gather(1, src_idx[..., None].expand(-1, -1, c))
        add = torch.zeros(B, nb, c, dtype=torch.float32, device=x.device).scatter_add(
            1, dst_of_src[..., None].expand(-1, -1, c), src.float())
        dst = ((xb.float() + add) / counts[..., None]).to(x.dtype)
        return torch.cat([unm, dst], dim=1)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return y.gather(1, gidx[..., None].expand(-1, -1, y.shape[-1]))

    return merge, unmerge


def tome_r(n_tokens: int, ratio: float, h: int, w: int, sx: int = 2, sy: int = 2) -> int:
    """tomesd's r: ``int(N * ratio)`` clamped to the number of sources; 0
    when the grid has no destination to merge into."""
    nb = (h // sy) * (w // sx)
    if nb == 0:
        return 0
    return max(0, min(int(n_tokens * ratio), n_tokens - nb))
