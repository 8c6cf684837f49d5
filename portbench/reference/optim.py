"""The train step's update, in plain PyTorch, float32: the global-norm clip,
AdamW, Adafactor and the EMA of the parameters.

- AdamW (Loshchilov & Hutter, arXiv:1711.05101) as ``torch.optim.AdamW``
  defines it: decoupled decay p -= lr wd p, bias-corrected moments, eps
  outside the square root.
- Adafactor (Shazeer & Stern, arXiv:1804.04235) as ``optax.adafactor``
  defines it without momentum and without parameter scaling: the second
  moment of g^2 + eps with decay 1 - n^-0.8, factored into row and column
  means over the two largest dims when the second largest has at least 128
  entries, the update clipped to RMS 1 and scaled by lr.
- The EMA: shadow -= (1 - decay) (shadow - p), decay min(decay, (1 + n) /
  (10 + n)) when gradual, the shadow stored in the configured dtype.
- The clip: every gradient times min(1, max_norm / (norm + 1e-6)), the norm
  over all gradients together.

Each class keeps its state per parameter name; ``first_grad_norms`` gives,
after one update, each leaf's gradient norm as the state holds it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def global_norm(grads: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()


def clip_(grads: Tensors, max_norm: float) -> torch.Tensor:
    norm = global_norm(grads)
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads.values():
        g.mul_(coef)
    return norm


class AdamW:
    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m: Tensors = {}
        self.v: Tensors = {}
        self.n = 0

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors) -> None:
        self.n += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.n, 1 - b2 ** self.n
        for name, p in params.items():
            g = grads[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / bc2 ** 0.5 + self.eps))

    def first_grad_norms(self) -> Dict[str, float]:
        return {k: float(m.double().norm() / (1 - self.betas[0])) for k, m in self.m.items()}


def factored_dims(shape, min_size: int = 128):
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    return None if shape[order[-2]] < min_size else (order[-2], order[-1])


class Adafactor:
    def __init__(self, lr: float, decay_rate: float = 0.8, eps: float = 1e-30,
                 clipping_threshold: float = 1.0, min_dim_size_to_factor: int = 128):
        self.lr, self.decay_rate, self.eps = lr, decay_rate, eps
        self.clip, self.min_dim = clipping_threshold, min_dim_size_to_factor
        self.state: Dict[str, Tensors] = {}
        self.n = 0

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors) -> None:
        self.n += 1
        decay = float(np.float32(1.0) - np.float32(self.n) ** np.float32(-self.decay_rate))
        for name, p in params.items():
            g = grads[name].float()
            g2 = g.square() + self.eps
            st = self.state.setdefault(name, {})
            dims = factored_dims(p.shape, self.min_dim)
            if dims is None:
                v = st["v"] = decay * st.get("v", torch.zeros_like(g2)) + (1 - decay) * g2
                u = g / v.sqrt()
            else:
                second, largest = dims
                row_mean, col_mean = g2.mean(largest), g2.mean(second)
                vr = st["v_row"] = (decay * st.get("v_row", torch.zeros_like(row_mean))
                                    + (1 - decay) * row_mean)
                vc = st["v_col"] = (decay * st.get("v_col", torch.zeros_like(col_mean))
                                    + (1 - decay) * col_mean)
                # v ~ outer(v_row, v_col) / mean(v_row)
                r = second - 1 if second > largest else second
                row = (vr / vr.mean(r, keepdim=True)).unsqueeze(largest)
                u = g / row.sqrt() / vc.unsqueeze(second).sqrt()
            u = u / torch.clamp(u.square().mean().sqrt() / self.clip, min=1.0)
            p.sub_(self.lr * u)

    def first_grad_norms(self, shapes: Dict[str, torch.Size]) -> Dict[str, float]:
        """After the first update the second moment is g^2 + eps itself."""
        out = {}
        for name, st in self.state.items():
            if "v" in st:
                out[name] = float(st["v"].double().sum().sqrt())
            else:
                largest = factored_dims(shapes[name], self.min_dim)[1]
                out[name] = float((st["v_row"].double().sum() * shapes[name][largest]).sqrt())
        return out


class EMA:
    def __init__(self, params: Tensors, decay: float, gradual: bool,
                 dtype: Optional[torch.dtype] = None):
        self.decay, self.gradual, self.n = decay, gradual, 0
        self.shadow = {k: p.detach().to(dtype or p.dtype, copy=True) for k, p in params.items()}

    @torch.no_grad()
    def update(self, params: Tensors) -> None:
        self.n += 1
        d = np.float32(self.decay)
        if self.gradual:
            d = min(d, (np.float32(1.0) + np.float32(self.n)) / (np.float32(10.0) + np.float32(self.n)))
        w = float(np.float32(1.0) - np.float32(d))
        for k, s in self.shadow.items():
            s.copy_(s.float() - w * (s.float() - params[k].float()))
