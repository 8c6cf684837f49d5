"""K3: hand-written GroupNorm(+SiLU) for Hopper (``csrc/group_norm_silu.cu``).

Counterpart of ``dmtpu/ops/groupnorm.py``, in NCHW.  Statistics and the
normalisation are computed in f32; the output has the input's dtype.

- ``group_norm_silu(x, weight, bias, groups, eps, silu)``: on a CUDA tensor
  it launches the kernel (f32 or bf16, contiguous NCHW or channels-last,
  f32 weight and bias; anything else raises), on a CPU tensor it runs the
  reference.
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
- ``group_norm_silu.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dmtpu_torch.ops import _build
from dmtpu_torch.ops.dispatch import kernels_enabled


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


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """Fused GroupNorm(+SiLU), NCHW.  weight/bias: [C]."""
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
    if weight.shape != (c,) or bias.shape != (c,) or weight.device != x.device \
            or bias.device != x.device:
        raise ValueError(f"group_norm_silu: weight and bias must be [{c}] on {x.device}")
    if c % groups or x.data_ptr() % 16:
        raise ValueError(f"group_norm_silu: needs C % groups == 0 and 16-byte alignment, "
                         f"got C={c}, groups={groups}")
    if x.is_contiguous() and (h * w) % 8 == 0:
        channels_last = False
    elif x.is_contiguous(memory_format=torch.channels_last) and (c // groups) % 2 == 0:
        channels_last = True
    else:
        raise ValueError(f"group_norm_silu: x must be contiguous NCHW with H*W % 8 == 0 or "
                         f"channels-last with C/groups even, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    weight, bias = weight.contiguous(), bias.contiguous()
    out = torch.empty_like(x)  # keeps x's layout
    err = _build.library().dmtpu_group_norm_silu(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, c, h * w, groups, float(eps), int(silu), int(x.dtype == torch.bfloat16),
        int(channels_last), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "group_norm_silu launch")
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0


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
        with torch.enable_grad(), torch.profiler.record_function("GroupNormSiLU.backward"):
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
