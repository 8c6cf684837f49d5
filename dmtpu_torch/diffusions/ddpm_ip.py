"""DDPM with Input Perturbation (a training-time loss).

Counterpart of ``dmtpu/diffusions/ddpm_ip.py`` (reference:
diffusions/ddpm_ip.py:11-48): the diffusion noise is perturbed during
training, ``xt = diffuse(x0, t, eps + gamma * perturb_eps)``, while the model
still regresses the original eps, x0 or v.  Sampling is DDPM's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from dmtpu_torch.diffusions.ddpm import DDPM, ModelFn
from dmtpu_torch.utils import rows


class DDPM_IP(DDPM):
    def __init__(self, gamma: float = 0.1, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.gamma = float(gamma)

    def loss_func(self, model_fn: ModelFn, x0: torch.Tensor, t: torch.Tensor,
                  eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  perturb_eps: Optional[torch.Tensor] = None,
                  model_kwargs: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """f32 MSE of the model output at the perturbed ``xt`` against the
        unperturbed eps, x0 or v (``objective``).  A missing ``eps``, then a
        missing ``perturb_eps``, is drawn from ``generator`` in that order:
        standard normals of ``x0``'s shape and dtype."""
        if eps is None:
            eps = rows.randn(x0.shape, generator, x0.device, x0.dtype)
        if perturb_eps is None:
            perturb_eps = rows.randn(x0.shape, generator, x0.device, x0.dtype)
        xt = self.diffuse(x0, t, eps + self.gamma * perturb_eps)
        pred = model_fn(xt, t, **(model_kwargs or {}))
        if self.objective == "pred_eps":
            target = eps
        elif self.objective == "pred_x0":
            target = x0
        else:
            target = self.get_v(x0, eps, t)
        return torch.mean(torch.square(pred.float() - target.float()))
