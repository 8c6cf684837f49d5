"""The least time one NVIDIA H100 could take for a kernel's call (a frozen
copy of the program's own table, so that a change to the program cannot move
the yardstick).

Plain functions that give the operations and the bytes of one call from its
shapes, and ``bound_ms``: the larger of operations over the card's peak rate
and bytes over its memory rate, with which of the two it is.  Every input
byte counts as read once and every output byte as written once, whatever a
kernel reads again; the true head dim counts, not a padded one.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power limit):
989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32 outside them,
3.35 TB/s of device memory.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# f32 operations per element of GroupNorm(+SiLU): the statistics (subtract,
# square, two sums), the normalisation (one fused multiply-add) and the SiLU
# (negate, exp, add, divide)
GROUP_NORM_OPS, SILU_OPS = 6, 4


def attention_fwd_work(b: int, h: int, sq: int, sk: int, d: int,
                       esize: int = 2) -> tuple[int, int]:
    """(operations, bytes) of softmax(QK^T)V: two products of 2*S_q*S_k*d;
    q, k, v read and o written in ``esize`` bytes, the f32 lse written."""
    ops = 4 * b * h * sq * sk * d
    nbytes = esize * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
    return ops, nbytes


def attention_bwd_work(b: int, h: int, sq: int, sk: int, d: int,
                       esize: int = 2) -> tuple[int, int]:
    """(operations, bytes) of the fused backward: five products (S, dP, dV,
    dK, dQ); q, k, v, o, dO and the f32 lse read, dq, dk, dv written."""
    ops = 10 * b * h * sq * sk * d
    nbytes = esize * b * h * d * (4 * sq + 4 * sk) + 4 * b * h * sq
    return ops, nbytes


def group_norm_work(n: int, c: int, hw: int, esize: int, silu: bool = True) -> tuple[int, int]:
    """(operations, bytes) of GroupNorm(+SiLU): one read and one write of x."""
    elems = n * c * hw
    return elems * (GROUP_NORM_OPS + (SILU_OPS if silu else 0)), 2 * elems * esize


def bound_ms(ops: int, nbytes: int, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """(milliseconds, "operations" or "bytes"): the larger of the two times."""
    t_ops = 1e3 * ops / peak_flops
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
