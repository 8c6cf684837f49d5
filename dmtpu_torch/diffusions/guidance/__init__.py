"""Guidance: per-step transforms of a sampler's outputs inside its loop.

``BaseGuidance`` (the four hook points), ``MaskGuidance`` (inpainting and
RePaint) and ``MaskGuidanceDDIMCFG``, ``ILVR`` (low-pass reference
injection) and ``CLIPGuidance`` (text guidance through CLIP's gradient),
which is imported lazily: it loads ``transformers`` when it is built from a
local CLIP directory.
"""
from dmtpu_torch.diffusions.guidance.base import BaseGuidance
from dmtpu_torch.diffusions.guidance.ilvr import ILVR
from dmtpu_torch.diffusions.guidance.mask_guidance import MaskGuidance, MaskGuidanceDDIMCFG

__all__ = ["BaseGuidance", "MaskGuidance", "MaskGuidanceDDIMCFG", "ILVR", "CLIPGuidance"]


def __getattr__(name):
    if name == "CLIPGuidance":
        from dmtpu_torch.diffusions.guidance.clip_guidance import CLIPGuidance
        return CLIPGuidance
    raise AttributeError(name)
