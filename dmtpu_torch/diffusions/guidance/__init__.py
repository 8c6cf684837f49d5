"""Guidance: per-step transforms of a sampler's outputs inside its loop.

ILVR and CLIP guidance (``dmtpu/diffusions/guidance/{ilvr,clip_guidance}.py``)
are not ported yet.
"""
from dmtpu_torch.diffusions.guidance.base import BaseGuidance
from dmtpu_torch.diffusions.guidance.mask_guidance import MaskGuidance, MaskGuidanceDDIMCFG

__all__ = ["BaseGuidance", "MaskGuidance", "MaskGuidanceDDIMCFG"]
