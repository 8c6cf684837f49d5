"""K3: hand-written GroupNorm(+SiLU) for Hopper (``csrc/group_norm_silu.cu``).

Counterpart of ``dmtpu/ops/groupnorm.py``, in NCHW.  Statistics and the
normalisation are computed in f32; the output has the input's dtype.

- ``group_norm_silu(x, weight, bias, groups, eps, silu)``: on a CUDA tensor
  it launches the kernel (f32 or bf16, contiguous NCHW or channels-last,
  f32 weight and bias; anything else raises), on a CPU tensor it runs the
  reference.
- ``plan`` and ``kernels_for``: which of the source's five kernels a call
  takes (channels-last goes by whole pixel rows with a thread block cluster
  per sample, where C and C/groups allow, and otherwise by 16-byte chunks of
  fixed channels, a cluster per sample that holds it in shared memory where
  it fits; contiguous NCHW by teams of CTAs that each hold a share of a
  (sample, group) slab in registers, or a warp a slab where slabs are small)
  and the launch shape.
- ``group_norm_silu_reference``: the plain PyTorch version (two-pass
  statistics, as ``dmtpu.ops.groupnorm.group_norm_silu_reference``).
- ``GroupNormSiLU``: the differentiable op, a ``torch.autograd.Function``
  whose forward is ``group_norm_silu`` and whose backward re-runs the
  reference under autograd and takes its gradients for x, weight and bias,
  as the JAX ``custom_vjp`` does (``dmtpu/ops/groupnorm.py::_bwd``).  The
  JAX package has no Pallas backward for GroupNorm, so the plain PyTorch
  backward is the faithful port; only the forward is a kernel.
- ``group_norm``: the one dispatch every model calls: ``GroupNormSiLU``, or
  the reference (plain autograd) inside ``dispatch.plain_ops()``.
- ``group_norm_silu.launches`` counts kernel launches, and
  ``group_norm_silu.launches_by_kernel`` counts them by the kernel that ran.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from dmtpu_torch.ops import _build
from dmtpu_torch.ops.dispatch import kernels_enabled
from dmtpu_torch.utils import profiling


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              groups: int = 32, eps: float = 1e-5,
                              silu: bool = True) -> torch.Tensor:
    """Plain GroupNorm(+SiLU) over NCHW ``x``; f32 math, output in x's dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    xn = xn * weight.float().reshape(shape) + bias.float().reshape(shape)
    if silu:
        xn = F.silu(xn)
    return xn.to(x.dtype)


# The five K3 kernels of ``csrc/group_norm_silu.cu``: one CTA per (sample,
# group) over contiguous NCHW ("nchw") or over channels-last ("groups", C/G
# values a pixel, two at a time), and "rows": channels-last by whole pixel
# rows, 16 bytes a thread, a thread block cluster per sample (these three
# through ``dmtpu_group_norm_silu``'s ``kernel`` argument); "team"
# (``dmtpu_group_norm_team``): contiguous NCHW, a (sample, group) slab spread
# over a team of CTAs that merge their statistics through global memory, or
# a warp a slab where slabs are small; and "chunks"
# (``dmtpu_group_norm_chunks``): channels-last as a flat array with a period
# of lcm(C, 8) values, a thread a 16-byte chunk of fixed channels, a cluster
# per sample that holds it in shared memory ("held") or streams it twice.
_KERNEL_IDS = {"nchw": 0, "groups": 1, "rows": 2}
ROWS_THREADS = 512         # the rows kernel's largest CTA
ROWS_CLUSTER = 8           # most CTAs per sample (the portable cluster size)
# CTAs in all.  Measured on an NVIDIA H100 80GB HBM3 (700 W), b16 (320, 4096)
# bf16: 64 CTAs of 480 threads, each thread with two batches of four 16-byte
# loads live (3.9 MB in flight), 0.069 ms; 128 such CTAs 0.081 ms; 32, 0.101 ms.
ROWS_TARGET_CTAS = 64
ROWS_MAX_GROUPS = 128

# The "chunks" kernel: a CTA covers at most CHUNKS_COLS chunks of a period at
# once (more in column blocks, one after the other), in about
# CHUNKS_HELD_THREADS threads where the cluster holds the sample, about
# CHUNKS_STREAM_THREADS where it streams it.  A sample is held where a CTA's
# share of it is at most CHUNKS_HOLD_MAX bytes in a cluster of 8; the
# cluster is then the smallest that keeps a share within CHUNKS_HOLD_TARGET,
# or larger where the batch would leave SMs without two CTAs.  Measured on an
# NVIDIA H100 80GB HBM3 (700 W), device time (``dev/k3_probe.py variants
# cl``), the CIFAR-10 UNet's b500 (128, 1024) bf16 held in CTAs of 128
# threads: clusters of 4 (64 KB shares) 0.1141 ms, of 8 (32 KB) 0.1154, of
# 2 (128 KB) 0.1518; clusters of 4 in 256 threads 0.1221; in f32, clusters
# of 8 (64 KB) 0.2131, of 4 (128 KB) 0.2276; CelebA-HQ's b16 (128, 4096)
# bf16 held by 8 (128 KB shares) 0.0349, streamed by 4 in 512 threads 0.0218.
CHUNKS_COLS = 512
CHUNKS_HELD_THREADS = 128
CHUNKS_STREAM_THREADS = 512
CHUNKS_HOLD_TARGET = 64 * 1024
CHUNKS_HOLD_MAX = 96 * 1024
CHUNKS_MAX_GROUPS = 8192
CHUNKS_PIECES = 4
SMEM_LIMIT = 232_448       # the dynamic shared memory a block may use

# The "team" kernels (contiguous NCHW), by the (sample, group) slab's size:
# "warp", a warp a slab (eight a CTA), and "cta", a CTA of 256 threads a slab,
# each thread holding a batch of 128 bytes of x in registers (slabs of at
# most 4 KB and 32 KB), 3 CTAs an SM; "stream", a team of CTAs a slab, one
# CTA an SM (256 threads and a producer warp that copies x into three 64 KB
# shared-memory slots), each CTA on a share of at most one slot where the
# card has the CTAs for it.  A team of more than one CTA launches
# cooperatively: at most one CTA an SM.
TEAM_THREADS = 256
TEAM_WARPS = TEAM_THREADS // 32
TEAM_BATCH_BYTES = 128     # a thread's batch in "warp" and "cta"
TEAM_HELD_CTAS_PER_SM = 3
TEAM_SLOT_BYTES = 64 * 1024
TEAM_MAX_CTAS = 4096       # the CTAs the kernel's scratch has flags and states for
H100_SMS = 132
TEAM_FORMS = {"warp": 0, "cta": 1, "stream": 2}
# Where a share is more than one slot, it is streamed again for the
# normalisation: the bytes that should still be in the 50 MB L2 cache then
# (every team's slab) are kept under 32 MB where the card has the CTAs.
L2_BYTES = 50 * 2 ** 20
TEAM_REREAD_BUDGET = 32 * 2 ** 20


@functools.lru_cache(maxsize=None)
def team_plan(c: int, hw: int, groups: int, esize: int, n: int, sms: int = H100_SMS) -> dict:
    """The "team" kernels' launch for a contiguous NCHW [n, c, hw] call on a
    card of ``sms`` SMs: the ``form`` ("warp", "cta" or "stream"), ``team``
    CTAs a slab ("stream"), ``ctas`` in all; and what it moves at once:
    ``in_flight``, the bytes of x of the slabs being normalised together
    ("stream": those of the slabs its teams hold), and ``reread``, those of
    them that a second read takes from the L2 cache."""
    slab = (c // groups) * hw * esize        # bytes of a (sample, group)
    slabs = n * groups
    if slab <= 32 * TEAM_BATCH_BYTES:
        ctas = min(-(-slabs // TEAM_WARPS), sms * TEAM_HELD_CTAS_PER_SM)
        return {"form": "warp", "team": 0, "ctas": ctas,
                "in_flight": min(slabs, ctas * TEAM_WARPS) * slab, "reread": 0}
    if slab <= TEAM_THREADS * TEAM_BATCH_BYTES:
        ctas = min(slabs, sms * TEAM_HELD_CTAS_PER_SM)
        return {"form": "cta", "team": 1, "ctas": ctas, "in_flight": ctas * slab, "reread": 0}
    # as few CTAs a slab as keep the slabs in flight (one a team) within the
    # L2 budget, and enough that the slabs' teams cover the card: a team's
    # statistics cost a few microseconds of waiting each slab (measured:
    # teams of 1 to 16 CTAs beat teams of 64 and 128 on the SD1.5 decode's
    # shapes); a divisor of the SMs, so that the teams fill every SM
    sizes = [t for t in range(1, sms + 1) if sms % t == 0]
    team = next(t for t in sizes if (sms // t) * slab <= TEAM_REREAD_BUDGET or t == sms)
    team = next(t for t in sizes if t >= team and t * slabs >= sms or t == sms)
    teams = max(1, min(slabs, sms // team))
    reread = -(-slab // team) > TEAM_SLOT_BYTES  # the shares stream again for pass 2
    return {"form": "stream", "team": team, "ctas": team * teams, "in_flight": teams * slab,
            "reread": teams * slab if reread else 0}


def chunks_smem(c: int, hw: int, groups: int, esize: int, held: bool, cluster: int,
                threads: int) -> int:
    """The "chunks" kernel's dynamic shared memory for such a launch, in
    bytes: the held share of periods (128-byte aligned), the pieces'
    barriers, each thread's 8 sums and 8 sums of squares, and five arrays of
    ``groups`` floats (as ``dmtpu_group_norm_chunks_smem`` reckons it)."""
    period = c * 8 // math.gcd(c, 8)
    nper = -(-hw * c // period)
    share = -(-(-(-nper // cluster) * period * esize) // 128) * 128 if held else 0
    return share + CHUNKS_PIECES * 8 + 2 * 8 * threads * 4 + 5 * groups * 4


@functools.lru_cache(maxsize=None)
def chunks_plan(c: int, hw: int, groups: int, esize: int, n: int = 16,
                held: Optional[bool] = None, cluster: Optional[int] = None,
                periods: Optional[int] = None, sms: int = H100_SMS) -> dict:
    """The "chunks" kernel's launch for a channels-last [n, c, hw] call: a
    sample is a flat array with a period of lcm(c, 8) values, P = period / 8
    chunks of 8; a CTA of ``threads`` threads reads ``periods`` periods at a
    time, a thread one chunk of each; ``cluster`` CTAs a sample that hold it
    in shared memory (``held``) or stream it; ``smem`` bytes of dynamic
    shared memory a CTA.  ``held``, ``cluster`` and ``periods`` may be forced."""
    period = c * 8 // math.gcd(c, 8)
    cols = min(period // 8, CHUNKS_COLS)
    nper = -(-hw * c // period)

    def share(k: int) -> int:  # bytes of a CTA's share in a cluster of k
        return -(-nper // k) * period * esize

    if held is None:
        held = (hw * c) % 8 == 0 and share(8) <= CHUNKS_HOLD_MAX and \
            chunks_smem(c, hw, groups, esize, True, 8, CHUNKS_COLS) <= SMEM_LIMIT
    if held:
        periods = periods or max(1, CHUNKS_HELD_THREADS // cols)
        if cluster is None:
            cluster = next(k for k in (1, 2, 4, 8) if share(k) <= CHUNKS_HOLD_TARGET or k == 8)
            while cluster < ROWS_CLUSTER and n * cluster < 2 * sms:
                cluster *= 2
    else:
        periods = periods or max(1, CHUNKS_STREAM_THREADS // cols)
        if cluster is None:
            cluster = ROWS_CLUSTER
            while cluster > 1 and (n * cluster > ROWS_TARGET_CTAS or nper // cluster < periods):
                cluster //= 2
    threads = -(-cols * periods // 32) * 32
    while held and cluster < ROWS_CLUSTER and \
            chunks_smem(c, hw, groups, esize, held, cluster, threads) > SMEM_LIMIT:
        cluster *= 2
    return {"kernel": "chunks", "held": held, "cluster": cluster, "periods": periods,
            "threads": threads, "smem": chunks_smem(c, hw, groups, esize, held, cluster, threads)}


def _rows_takes(c: int, groups: int) -> bool:
    return c % 8 == 0 and c // groups >= 8 and c // 8 <= ROWS_THREADS and \
        groups <= ROWS_MAX_GROUPS


@functools.lru_cache(maxsize=None)
def plan(c: int, hw: int, groups: int, esize: int, channels_last: bool, n: int = 16,
         sms: int = H100_SMS) -> dict:
    """How K3 runs a [n, c, hw] call: ``kernel`` and its launch shape.  For
    channels-last, "rows" with ``rows_plan``'s shape; the shapes it does not
    take go to "chunks" with
    ``chunks_plan``'s shape (to "groups" past ``CHUNKS_MAX_GROUPS`` groups,
    where C/groups is even), and so do those it takes at batches above 32
    where a cluster holds the sample.  For contiguous NCHW, "team" with
    ``team_plan``'s shape, which the plan also gives where it keeps "nchw"."""
    if not channels_last:
        return {"kernel": "team", **team_plan(c, hw, groups, esize, n, sms)}
    if not _rows_takes(c, groups):
        if groups <= CHUNKS_MAX_GROUPS:
            return chunks_plan(c, hw, groups, esize, n, sms=sms)
        return {"kernel": "groups"}
    if n * 2 > ROWS_TARGET_CTAS:
        # the batch leaves "rows" one CTA a sample, reading it twice; where
        # the sample fits a cluster's shared memory, "chunks" reads it once
        # over more CTAs.  Measured (NVIDIA H100 80GB HBM3, 700 W, CUDA
        # events, the CIFAR-10 UNet's b500 bf16): (256, 256) 0.0575 ms
        # against 0.0756, (512, 256) 0.1212 against 0.1446, (512, 64) 0.0381
        # against 0.0543
        chunks = chunks_plan(c, hw, groups, esize, n, sms=sms)
        if chunks["held"]:
            return chunks
    return rows_plan(c, hw, n)


def rows_plan(c: int, hw: int, n: int) -> dict:
    """The "rows" kernel's launch for a channels-last [n, c, hw] call that it
    takes: ``cluster`` CTAs per sample (a power of two, so that the batch
    has about ``ROWS_TARGET_CTAS`` in all), ``rows`` pixel rows a pass in a
    CTA of ``threads`` threads (a thread owns 8 channels of a pixel)."""
    cpr = c // 8  # 8-channel chunks per pixel row
    rows = ROWS_THREADS // cpr
    threads = -(-rows * cpr // 32) * 32
    cluster = ROWS_CLUSTER
    while cluster > 1 and (n * cluster > ROWS_TARGET_CTAS or hw // cluster < rows):
        cluster //= 2
    return {"kernel": "rows", "cluster": cluster, "rows": rows, "threads": threads}


@functools.lru_cache(maxsize=None)
def kernels_for(c: int, hw: int, groups: int, channels_last: bool) -> tuple[str, ...]:
    """The K3 kernels that take the call (C % groups == 0), the oldest first."""
    if not channels_last:
        return ("nchw", "team")
    names = ("groups",) if (c // groups) % 2 == 0 else ()
    if groups <= CHUNKS_MAX_GROUPS:
        names += ("chunks",)
    if _rows_takes(c, groups):
        names += ("rows",)
    return names


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True,
                    kernel: Optional[str] = None) -> torch.Tensor:
    """Fused GroupNorm(+SiLU), NCHW.  weight/bias: [C].  ``kernel`` forces one
    of ``kernels_for``'s names (it raises if that kernel does not take the
    call); by default ``plan`` chooses."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm_silu: x must be float32 or bfloat16, got {x.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("group_norm_silu: weight and bias must be float32")
    if x.dim() != 4:
        raise ValueError(f"group_norm_silu: x must be [N, C, H, W], got {tuple(x.shape)}")
    n, c, h, w = x.shape
    device = x.get_device()
    if weight.shape != (c,) or bias.shape != (c,) or weight.get_device() != device \
            or bias.get_device() != device:
        raise ValueError(f"group_norm_silu: weight and bias must be [{c}] on {x.device}")
    if c % groups or x.data_ptr() % 16:
        raise ValueError(f"group_norm_silu: needs C % groups == 0 and 16-byte alignment, "
                         f"got C={c}, groups={groups}")
    if x.is_contiguous() and (h * w) % 8 == 0:
        channels_last = False
    elif x.is_contiguous(memory_format=torch.channels_last) and \
            kernels_for(c, h * w, groups, True):
        channels_last = True
    else:
        raise ValueError(f"group_norm_silu: x must be contiguous NCHW with H*W % 8 == 0 or "
                         f"channels-last with at most {CHUNKS_MAX_GROUPS} groups or C/groups "
                         f"even, got shape {tuple(x.shape)} strides {x.stride()}")
    how = plan(c, h * w, groups, x.element_size(), channels_last, n, _sms(device))
    if kernel is not None and kernel != how["kernel"]:
        if kernel not in kernels_for(c, h * w, groups, channels_last):
            raise ValueError(f"group_norm_silu: kernel {kernel!r} does not take shape "
                             f"{tuple(x.shape)}, groups {groups}, strides {x.stride()}")
        if kernel == "chunks":
            how = chunks_plan(c, h * w, groups, x.element_size(), n, sms=_sms(device))
        elif kernel == "rows":
            how = rows_plan(c, h * w, n)
        else:
            how = {"kernel": kernel}
    if not weight.is_contiguous() or not bias.is_contiguous():
        weight, bias = weight.contiguous(), bias.contiguous()
    out = torch.empty_like(x)  # keeps x's layout
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_bf16 = int(x.dtype == torch.bfloat16)
    if how["kernel"] == "chunks":
        err = _build.library().dmtpu_group_norm_chunks(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, c, h * w, groups, float(eps), int(silu), is_bf16, int(how["held"]),
            how["cluster"], how["periods"], how["threads"], stream)
    elif how["kernel"] == "team":
        scratch, epoch = _team_scratch(device)
        err = _build.library().dmtpu_group_norm_team(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, c, h * w, groups, float(eps), int(silu), is_bf16, TEAM_FORMS[how["form"]],
            how["team"], how["ctas"], scratch.data_ptr(), epoch, stream)
    else:
        err = _build.library().dmtpu_group_norm_silu(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, c, h * w, groups, float(eps), int(silu), is_bf16,
            _KERNEL_IDS[how["kernel"]], how.get("cluster", 0), how.get("rows", 0),
            how.get("threads", 0), stream)
    _build.check(err, "group_norm_silu launch")
    group_norm_silu.launches += 1
    group_norm_silu.launches_by_kernel[how["kernel"]] += 1
    return out


group_norm_silu.launches = 0
group_norm_silu.launches_by_kernel = {"nchw": 0, "groups": 0, "rows": 0, "team": 0,
                                      "chunks": 0}


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_TEAM_SCRATCH: dict = {}


def _team_scratch(device: int) -> tuple[torch.Tensor, int]:
    """The "team" kernel's flags and per-CTA states on ``device`` (room for
    4096 CTAs: 160 KiB, zeroed once), and this launch's epoch: each launch's flags
    count up from the launch's number times 2^32, so the flags an earlier
    launch left read as not yet set and nothing is cleared between launches.
    One scratch a device: the launches on it must run one after the other (one
    stream), as every path of the port runs them."""
    if device not in _TEAM_SCRATCH:
        _TEAM_SCRATCH[device] = [torch.zeros(5 * TEAM_MAX_CTAS, dtype=torch.int64,
                                             device=torch.device("cuda", device)), 0]
    entry = _TEAM_SCRATCH[device]
    entry[1] += 1
    return entry[0], entry[1] << 32


class GroupNormSiLU(torch.autograd.Function):
    """K3 forward; backward through the plain version (see the module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                eps: float, silu: bool) -> torch.Tensor:
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (groups, eps, silu)
        return group_norm_silu(x, weight, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        saved = ctx.saved_tensors
        wanted = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad(), profiling.span("GroupNormSiLU.backward"):
            inputs = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            out = group_norm_silu_reference(*inputs, *ctx.args)
            grads = torch.autograd.grad(out, [inputs[i] for i in wanted], grad)
        result = [None] * 6
        for i, g in zip(wanted, grads):
            result[i] = g
        return tuple(result)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU), NCHW: ``GroupNormSiLU`` (K3 forward), or the plain
    version inside ``plain_ops()``."""
    if not kernels_enabled():
        return group_norm_silu_reference(x, weight, bias, groups, eps, silu)
    return GroupNormSiLU.apply(x, weight, bias, groups, eps, silu)
