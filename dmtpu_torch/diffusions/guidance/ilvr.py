"""ILVR: low-pass-filter reference injection.

Counterpart of ``dmtpu/diffusions/guidance/ilvr.py``.  At each step it adds
φ(noisy_ref) − φ(sample) to the sampled x_{t-1}, where φ is the ResizeRight
down / up round trip (reference: diffusions/guidance/ilvr.py:37-52), here the
port's matmul form (``dmtpu_torch.ops.resize_right``) in f32.  The
reference's noise is drawn from the step's generator after the step's own
reverse noise, as ``MaskGuidance.cond_fn_sample`` draws its own.

Images are [B, C, H, W]; the reference images too.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from dmtpu_torch.diffusions.ddpm import _randn
from dmtpu_torch.diffusions.guidance.base import BaseGuidance
from dmtpu_torch.ops.resize_right import resize


class ILVR(BaseGuidance):
    def __init__(
        self,
        ref_images: Optional[torch.Tensor] = None,
        downsample_factor: int = 8,
        interp_method: str = "cubic",
        *args: Any,
        **kwargs: Any,
    ):
        super().__init__(*args, **kwargs)
        self.ref_images = ref_images
        self.downsample_factor = int(downsample_factor)
        self.interp_method = interp_method

    def set_ref_images(self, ref_images: torch.Tensor) -> None:
        self.ref_images = ref_images

    def low_pass_filter(self, x: torch.Tensor) -> torch.Tensor:
        """Down by the factor, then up again.  (reference: diffusions/guidance/ilvr.py:49-52)"""
        x = resize(x, scale_factors=1.0 / self.downsample_factor, interp_method=self.interp_method)
        return resize(x, scale_factors=float(self.downsample_factor),
                      interp_method=self.interp_method)

    def cond_fn_sample(self, out, xt, c, generator):
        if self.ref_images is None:
            raise RuntimeError("Please call `set_ref_images()` before sampling.")
        ref = self.ref_images.float()
        eps = _randn(ref, generator)
        # noised to level t_prev; at the final step (t == 0) the clean reference
        diffused = c["sqrt_ac_prev"] * ref + c["sqrt_1m_ac_prev"] * eps
        noisy_ref = c["nonzero"] * diffused + (1.0 - c["nonzero"]) * ref
        return self.low_pass_filter(noisy_ref) - self.low_pass_filter(out["sample"])
