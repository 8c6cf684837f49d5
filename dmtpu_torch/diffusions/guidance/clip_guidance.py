"""CLIP guidance: steer sampling toward a text prompt.

Counterpart of ``dmtpu/diffusions/guidance/clip_guidance.py``.  The reference
backprops through HF CLIP on the predicted x0 each step (reference:
diffusions/guidance/clip_guidance.py:38-50).  Here the text embedding is
computed once, and each step preprocesses the predicted x0 as tensors on its
device (no uint8 round trip on the host: quantisation is not differentiable
and is dropped, as in the JAX package), runs CLIP's image tower and takes the
gradient of the similarity **with respect to the preprocessed
``pixel_values``**, not through the preprocessing, as the reference does.  That
gradient is resized back to the sample and the delta on the posterior mean
is ``w * sqrt(1/ᾱt) * var * resize(dL/d(pixel_values))``.

The samplers run under ``torch.no_grad()``; ``cond_fn_mean`` opens
``torch.enable_grad()`` on a detached leaf of ``pixel_values``, so nothing on
the path may run under ``torch.inference_mode()``, whose tensors cannot enter
autograd.  The resizes are ``F.interpolate(..., "bilinear",
antialias=True)``: the same triangle filter as ``jax.image.resize(...,
"bilinear")``, which antialiases when it downsamples (the tests hold the two
together).  Images are [B, C, H, W].
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dmtpu_torch.diffusions.guidance.base import BaseGuidance

# OpenAI CLIP preprocessing constants
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW tensor (antialiased
    when it downsamples)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


def load_clip(clip_pretrained: str, device: Any = None):
    """(text_features_fn, image_features_fn, tokenizer) of a local HF CLIP
    directory, through ``transformers``' torch ``CLIPModel`` and
    ``CLIPTokenizer`` (no download: a zero-egress machine points at a local
    checkout)."""
    try:
        from transformers import CLIPModel, CLIPTokenizer
    except ImportError as e:
        raise ImportError("CLIPGuidance with `clip_pretrained` needs the `transformers` "
                          "package (torch CLIPModel and CLIPTokenizer)") from e
    # CLIP's attention as plain tensor ops, as the JAX package's FlaxCLIPModel
    # runs it (no fused attention call on the path)
    model = CLIPModel.from_pretrained(clip_pretrained, attn_implementation="eager")
    model = model.eval().requires_grad_(False)
    if device is not None:
        model = model.to(device)
    tokenizer = CLIPTokenizer.from_pretrained(clip_pretrained)
    return (lambda ids, mask: _projected(model.get_text_features(input_ids=ids,
                                                                  attention_mask=mask)),
            lambda px: _projected(model.get_image_features(pixel_values=px)), tokenizer)


def _projected(features: Any) -> torch.Tensor:
    """The projected embeddings of ``get_text_features`` /
    ``get_image_features``: a tensor in the 4.x releases of ``transformers``,
    the output's ``pooler_output`` in later ones."""
    return features if isinstance(features, torch.Tensor) else features.pooler_output


class CLIPGuidance(BaseGuidance):
    def __init__(
        self,
        guidance_weight: float = 1.0,
        clip_pretrained: str = "openai/clip-vit-base-patch32",
        text_features_fn: Optional[Callable] = None,
        image_features_fn: Optional[Callable] = None,
        tokenizer: Any = None,
        image_size: int = 224,
        device: Any = None,
        **kwargs: Any,
    ):
        """Either pass ready feature callables
        (``text_features_fn(input_ids, attention_mask) -> [B, D]``,
        ``image_features_fn(pixel_values_nchw) -> [B, D]``) plus a tokenizer,
        or a local ``clip_pretrained`` directory, loaded onto ``device``
        (``load_clip``)."""
        super().__init__(**kwargs)
        self.guidance_weight = float(guidance_weight)
        self.image_size = int(image_size)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        if text_features_fn is None or image_features_fn is None:
            text_features_fn, image_features_fn, tokenizer = load_clip(clip_pretrained, device)
        self._text_features = text_features_fn
        self._image_features = image_features_fn
        self.tokenizer = tokenizer
        self.text_embed: Optional[torch.Tensor] = None

    @torch.no_grad()
    def set_text(self, text: str) -> None:
        """Compute the (normalised) text embedding once."""
        tokens = self.tokenizer([text], return_tensors="np", padding=True)
        ids, mask = (torch.from_numpy(np.asarray(tokens[k])).to(self.device)
                     for k in ("input_ids", "attention_mask"))
        self.set_text_embed(self._text_features(ids, mask))

    def set_text_embed(self, text_embed: torch.Tensor) -> None:
        text_embed = text_embed.float()
        self.text_embed = text_embed / torch.linalg.norm(text_embed, dim=-1, keepdim=True)

    def _preprocess(self, x0: torch.Tensor) -> torch.Tensor:
        """CLIP's preprocessing as tensor ops: [-1, 1] NCHW -> normalised
        ``pixel_values`` at ``image_size``."""
        img = _bilinear((x0.float() + 1.0) / 2.0, (self.image_size, self.image_size))
        mean = img.new_tensor(_CLIP_MEAN).view(1, -1, 1, 1)
        std = img.new_tensor(_CLIP_STD).view(1, -1, 1, 1)
        return (img - mean) / std

    def cond_fn_mean(self, out, xt, c, generator):
        if self.text_embed is None:
            raise RuntimeError("Please call `set_text()` before sampling.")
        # the gradient with respect to the preprocessed pixel values, then
        # resized to the sample: NOT through the preprocessing chain, whose
        # adjoint would rescale the delta by ~0.5/std per channel and change
        # what a tuned guidance_weight does
        # (reference: diffusions/guidance/clip_guidance.py:42-50)
        pixel_values = self._preprocess(out["pred_x0"]).detach().requires_grad_()
        with torch.enable_grad():
            feats = self._image_features(pixel_values).float()
            # the reference's similarity uses CLIPModel's NORMALISED image_embeds
            feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
            similarity = torch.sum(feats @ self.text_embed.T.to(feats.device))
            grad, = torch.autograd.grad(similarity, pixel_values)
        grad = _bilinear(grad, xt.shape[-2:])
        return self.guidance_weight * c["sqrt_recip_ac"] * out["var"] * grad
