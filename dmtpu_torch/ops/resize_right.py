"""ResizeRight as two dense matmuls: the low-pass filter of ILVR.

Counterpart of ``dmtpu/ops/resize_right.py``.  The reference vendors
ResizeRight (reference: utils/resize_right/resize_right.py) because a naive
``interpolate`` "will damage the results" of ILVR (reference: docs/ILVR.md),
so this is not ``F.interpolate``: each resized dimension is a dense
[out, in] matrix ``W``, built once on the host in float64 numpy from the same
projected grid and antialiased kernel as the JAX package's
(``make_resize_matrix``, copied here), and applied to an NCHW tensor as
``W_h · x · W_wᵀ`` in f32.  The matrices are cached by (size, scale,
method, antialiasing, device) as f32 tensors on the tensor's device.  The
products run in f32 with PyTorch's default precision (TF32 off for f32
matmuls): ILVR adds a difference of two low-passes at every step, and TF32's
three decimal digits would show in it.

Semantics (those of the reference):
  - projected grid:  i/s + (in-1)/2 - (out-1)/(2s)
  - field of view:   ceil(grid - support/2 - eps) + arange(ceil(support-eps))
  - weights normalised to sum 1 over the full window, THEN out-of-bounds
    neighbours dropped (constant zero padding): edge rows may sum < 1
  - antialiasing for downscale: kernel(x*s)*s with support/s window.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# interpolation kernels (float64 numpy; parity: reference utils/resize_right/interp_methods.py)
# ---------------------------------------------------------------------------
def cubic(x: np.ndarray) -> np.ndarray:
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return (1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1.0) + (
        -0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0
    ) * ((1.0 < absx) & (absx <= 2.0))


cubic.support_sz = 4


def lanczos2(x: np.ndarray) -> np.ndarray:
    return ((np.sin(np.pi * x) * np.sin(np.pi * x / 2) + _EPS) /
            ((np.pi ** 2 * x ** 2 / 2) + _EPS)) * (np.abs(x) < 2)


lanczos2.support_sz = 4


def lanczos3(x: np.ndarray) -> np.ndarray:
    return ((np.sin(np.pi * x) * np.sin(np.pi * x / 3) + _EPS) /
            ((np.pi ** 2 * x ** 2 / 3) + _EPS)) * (np.abs(x) < 3)


lanczos3.support_sz = 6


def linear(x: np.ndarray) -> np.ndarray:
    return (x + 1) * ((-1 <= x) & (x < 0)) + (1 - x) * ((0 <= x) & (x <= 1))


linear.support_sz = 2


def box(x: np.ndarray) -> np.ndarray:
    return ((-1 <= x) & (x < 0)).astype(np.float64) + ((0 <= x) & (x <= 1)).astype(np.float64)


box.support_sz = 1

INTERP_METHODS = {
    "cubic": cubic,
    "lanczos2": lanczos2,
    "lanczos3": lanczos3,
    "linear": linear,
    "box": box,
}


def make_resize_matrix(
    in_sz: int,
    out_sz: int,
    scale: float,
    interp_method: Union[str, Callable] = "cubic",
    antialiasing: bool = True,
) -> np.ndarray:
    """Dense [out_sz, in_sz] float64 matrix implementing one 1-D resize."""
    method = INTERP_METHODS[interp_method] if isinstance(interp_method, str) else interp_method
    support = method.support_sz

    # antialiasing modifies kernel + window for downscale
    # (reference: resize_right.apply_antialiasing_if_needed)
    if antialiasing and scale < 1.0:
        kernel = lambda x: scale * method(scale * x)  # noqa: E731
        support = support / scale
    else:
        kernel = method

    out_coords = np.arange(out_sz, dtype=np.float64)
    grid = out_coords / scale + (in_sz - 1) / 2.0 - (out_sz - 1) / (2.0 * scale)
    left = np.ceil(grid - support / 2.0 - _EPS).astype(np.int64)
    k = int(math.ceil(support - _EPS))
    fov = left[:, None] + np.arange(k)[None, :]          # [out, k]
    weights = kernel(grid[:, None] - fov)                # [out, k]
    sums = weights.sum(axis=1, keepdims=True)
    sums[sums == 0] = 1.0
    weights = weights / sums
    # constant (zero) padding == drop out-of-bounds contributions
    valid = (fov >= 0) & (fov < in_sz)
    W = np.zeros((out_sz, in_sz), dtype=np.float64)
    rows = np.repeat(np.arange(out_sz), k)
    np.add.at(W, (rows[valid.ravel()], fov.ravel()[valid.ravel()]), weights.ravel()[valid.ravel()])
    return W


@functools.lru_cache(maxsize=64)
def resize_matrix(in_sz: int, out_sz: int, scale: float, interp_method: Union[str, Callable],
                  antialiasing: bool, device: torch.device) -> torch.Tensor:
    """``make_resize_matrix`` as an f32 tensor on ``device``, built once."""
    W = make_resize_matrix(in_sz, out_sz, scale, interp_method, antialiasing)
    return torch.from_numpy(W.astype(np.float32)).to(device)


def resize(
    x: torch.Tensor,
    scale_factors: Union[None, float, Sequence[float]] = None,
    out_shape: Optional[Sequence[int]] = None,
    interp_method: Union[str, Callable] = "cubic",
    antialiasing: bool = True,
    spatial_dims: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """ResizeRight of an NCHW tensor (or any layout through ``spatial_dims``),
    in f32.

    The spatial dims default to the last two, the reference's own
    convention for NCHW (the JAX package's default is NHWC's (-3, -2)).
    ``scale_factors`` is one scale for every spatial dim or one each;
    ``out_shape`` gives the output sizes (and the scales, when none are
    given)."""
    nd = x.dim()
    if spatial_dims is None:
        spatial_dims = (-2, -1) if nd >= 2 else (-1,)
    spatial_dims = tuple(d % nd for d in spatial_dims)

    in_spatial = [x.shape[d] for d in spatial_dims]
    if scale_factors is None or np.isscalar(scale_factors):
        scales = [scale_factors] * len(spatial_dims) if scale_factors is not None else None
    else:
        scales = list(scale_factors)
    if out_shape is not None:
        outs = list(out_shape)
        if scales is None:
            scales = [o / i for o, i in zip(outs, in_spatial)]
    else:
        outs = [int(math.ceil(s * i)) for s, i in zip(scales, in_spatial)]

    out = x.float()
    # dims in ascending scale order, as the reference sorts them
    for i in sorted(range(len(spatial_dims)), key=lambda j: scales[j]):
        if scales[i] == 1.0 and outs[i] == in_spatial[i]:
            continue
        W = resize_matrix(in_spatial[i], outs[i], float(scales[i]), interp_method,
                          antialiasing, out.device)
        out = torch.movedim(torch.tensordot(W, out, dims=([1], [spatial_dims[i]])), 0,
                            spatial_dims[i])
    return out
