"""CLIP text encoders for SD conditioning.

Counterpart of ``dmtpu/models/stablediffusion/text_encoders.py`` (reference:
models/stablediffusion/text_encoders.py: FrozenCLIPEmbedder :57-101, the HF
CLIP ViT-L text tower of SD1.5; FrozenOpenCLIPEmbedder :104-165, the
open_clip ViT-H / bigG towers of SD2.x and SDXL).

One ``CLIPTextTransformer`` covers every CLIP variant.  Its submodule names
are those of HF's ``CLIPTextModel`` without the ``text_model.`` prefix, so
``CLIPTextModel().text_model.state_dict()`` loads as it is (after
``dmtpu_torch.convert.sd.hf_clip_text_strip``), and
``dmtpu_torch.convert.sd.openclip_text_to_hf`` rewrites open_clip state
dicts into the same layout.  ``text_projection`` is the raw
[width, projection_dim] matrix of open_clip, used as ``pooled @
text_projection``.

The attention is plain torch, as it is plain einsum in the JAX module:
logits from q and k in f32, scaled by ``head_dim ** -0.5``, plus a -inf
upper triangle; f32 softmax; weights cast to v's dtype.  Parameters and
arithmetic are f32.

Tokenisation is the host's (a ``transformers`` CLIPTokenizer from a local
path); the encoders take token ids.

``FrozenT5Embedder`` and ``FrozenCLIPT5Encoder`` are not ported yet
(ROADMAP.md, Queue 1 item K) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width, device=device)
        self.k_proj = nn.Linear(width, width, device=device)
        self.v_proj = nn.Linear(width, width, device=device)
        self.out_proj = nn.Linear(width, width, device=device)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        q, k, v = (proj(x).reshape(b, t, self.heads, hd)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits * (hd ** -0.5) + causal_mask
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d)
        return self.out_proj(out)


class _CLIPMLP(nn.Module):
    def __init__(self, width: int, act: str, device=None):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(width, 4 * width, device=device)
        self.fc2 = nn.Linear(4 * width, width, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)  # else the exact (erf) GELU
        return self.fc2(h)


class _CLIPLayer(nn.Module):
    def __init__(self, width: int, heads: int, act: str = "quick_gelu", device=None):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.self_attn = _CLIPAttention(width, heads, device)
        self.layer_norm2 = nn.LayerNorm(width, eps=1e-5, device=device)
        self.mlp = _CLIPMLP(width, act, device)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class _CLIPEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, max_length: int, width: int, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        self.position_embedding = nn.Embedding(max_length, width, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(positions)[None]


class _CLIPEncoder(nn.Module):
    def __init__(self, layers: int, width: int, heads: int, act: str, device=None):
        super().__init__()
        self.layers = nn.ModuleList(_CLIPLayer(width, heads, act, device)
                                    for _ in range(layers))


class CLIPTextTransformer(nn.Module):
    """Causal CLIP text tower.

    ``output_layer``: 'last' (after all blocks, final LayerNorm applied),
    'penultimate' (the last block skipped, final LayerNorm applied: the
    open_clip semantics of SD2.x), 'penultimate-nonorm' (the last block
    skipped, no final LayerNorm: SDXL's second embedder returns the raw
    penultimate hidden state, reference: models/sdxl/conditioner.py:307-331),
    or a negative int (the index into HF's ``hidden_states``, no final
    LayerNorm, as FrozenCLIPEmbedder's layer='hidden').  With
    ``return_pooled`` it also returns the final LayerNorm of the last hidden
    state at each row's EOT token (``argmax(input_ids)``), through
    ``text_projection`` where the tower has one.
    """

    def __init__(self, vocab_size: int = 49408, max_length: int = 77, width: int = 768,
                 layers: int = 12, heads: int = 12, act: str = "quick_gelu",
                 projection_dim: Optional[int] = None, device=None):
        super().__init__()
        self.vocab_size, self.max_length, self.width = vocab_size, max_length, width
        self.embeddings = _CLIPEmbeddings(vocab_size, max_length, width, device)
        self.encoder = _CLIPEncoder(layers, width, heads, act, device)
        self.final_layer_norm = nn.LayerNorm(width, eps=1e-5, device=device)
        if projection_dim is not None:
            self.text_projection = nn.Parameter(
                0.02 * torch.randn(width, projection_dim, device=device))

    def forward(self, input_ids: torch.Tensor, output_layer: Union[str, int] = "last",
                return_pooled: bool = False):
        if output_layer == "last":
            sel, final_ln = -1, True
        elif output_layer == "penultimate":
            sel, final_ln = -2, True
        elif output_layer == "penultimate-nonorm":
            sel, final_ln = -2, False
        else:
            if output_layer is None:
                raise ValueError("output_layer is None: a config using layer='hidden' "
                                 "must also set layer_idx")
            sel, final_ln = int(output_layer), False
        input_ids = input_ids.long()
        t = input_ids.shape[1]
        x = self.embeddings(input_ids)
        mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)

        # HF's hidden_states are [embeddings, after layer 1, ...]; only the
        # layers that the wanted one (and the pooled vector) needs are run
        layers = self.encoder.layers
        want = sel if sel >= 0 else len(layers) + 1 + sel
        if not 0 <= want <= len(layers):
            raise IndexError(f"output_layer {output_layer!r} is outside the tower's "
                             f"{len(layers)} layers")
        h = hidden = x
        for i, layer in enumerate(layers[:len(layers) if return_pooled else want], start=1):
            h = layer(h, mask)
            if i == want:
                hidden = h
        z = self.final_layer_norm(hidden) if final_ln else hidden
        if not return_pooled:
            return z
        zl = self.final_layer_norm(h)
        pooled = zl[torch.arange(zl.shape[0], device=zl.device), input_ids.argmax(dim=-1)]
        if hasattr(self, "text_projection"):
            pooled = pooled @ self.text_projection
        return z, pooled


CLIP_TEXT_CONFIGS = {
    # HF openai/clip-vit-large-patch14 (SD1.5)
    "clip-vit-l": dict(width=768, layers=12, heads=12, act="quick_gelu"),
    # open_clip ViT-H-14 (SD2.x)
    "open-clip-vit-h": dict(width=1024, layers=24, heads=16, act="gelu"),
    # open_clip ViT-bigG-14 (SDXL)
    "open-clip-vit-bigg": dict(width=1280, layers=32, heads=20, act="gelu", projection_dim=1280),
}


class FrozenCLIPEmbedder(nn.Module):
    """SD1.5 text conditioning: the tower (``model``) and its tokenizer.
    (reference: models/stablediffusion/text_encoders.py:57-101)"""

    def __init__(self, version: str = "clip-vit-l", max_length: int = 77, layer: str = "last",
                 layer_idx: Optional[int] = None, tokenizer: Any = None,
                 config_overrides: Optional[dict] = None, device=None, **_: Any):
        super().__init__()
        cfg = dict(CLIP_TEXT_CONFIGS.get(version, CLIP_TEXT_CONFIGS["clip-vit-l"]))
        cfg.update(config_overrides or {})  # tiny towers for tests and demo configs
        self.model = CLIPTextTransformer(max_length=max_length, device=device, **cfg)
        self.layer = layer
        self.layer_idx = layer_idx
        self.max_length = max_length
        self.tokenizer = tokenizer

    def output_layer(self) -> Union[str, int, None]:
        if self.layer == "hidden":
            return self.layer_idx
        return "last"

    def encode_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model(input_ids, output_layer=self.output_layer())

    def tokenize(self, texts) -> np.ndarray:
        if self.tokenizer is None:
            raise RuntimeError("provide a tokenizer (a local CLIPTokenizer path)")
        enc = self.tokenizer(texts, truncation=True, max_length=self.max_length,
                             padding="max_length", return_tensors="np")
        return enc["input_ids"]


class FrozenOpenCLIPEmbedder(FrozenCLIPEmbedder):
    """SD2.x text conditioning: the ViT-H tower, penultimate layer.
    (reference: models/stablediffusion/text_encoders.py:104-165)"""

    def __init__(self, arch: str = "open-clip-vit-h", max_length: int = 77,
                 layer: str = "penultimate", tokenizer: Any = None,
                 config_overrides: Optional[dict] = None, device=None, **_: Any):
        if arch not in CLIP_TEXT_CONFIGS:
            raise KeyError(arch)
        super().__init__(version=arch, max_length=max_length, layer=layer, tokenizer=tokenizer,
                         config_overrides=config_overrides, device=device)

    def output_layer(self) -> str:
        return "penultimate" if self.layer == "penultimate" else "last"


class FrozenT5Embedder:
    """Not ported yet (``dmtpu/models/stablediffusion/text_encoders.py:216``)."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "FrozenT5Embedder is not ported to dmtpu_torch yet (ROADMAP.md, Queue 1 item K)")


class FrozenCLIPT5Encoder:
    """Not ported yet (``dmtpu/models/stablediffusion/text_encoders.py:271``)."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "FrozenCLIPT5Encoder is not ported to dmtpu_torch yet (ROADMAP.md, Queue 1 item K)")
