"""The repo's trainable DDPM UNet, in NCHW.

Counterpart of ``dmtpu/models/unet.py`` (reference: models/unet.py:10-152):
GroupNorm+SiLU+3x3-conv ResBlocks with an additive time embedding,
single-head self-attention at chosen stages and in the middle, skips
concatenated on the channels.  Module names are the JAX package's
(``first_conv``, ``down_{i}_res_{j}``, ``mid_attn``, ``up_{i}_upsample``,
``last_norm``, ...), so its params load through the bridge.

``dtype`` is the torso's compute dtype (bf16 on the card, where K1 takes
only bf16): the convolutions, the ResBlocks' projections and the attention
compute in it; the time embedding, every GroupNorm's statistics and
``last_norm`` / ``last_conv`` stay f32.  ``fused_gn`` is taken: the JAX
package sends it to its Pallas GroupNorm+SiLU, which is K3 here for both
settings (the parameters are the same).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.models.modules import (
    Conv,
    Dense,
    Downsample,
    GroupNorm,
    SelfAttentionBlock,
    SinusoidalPosEmb,
    Upsample,
)


class ResBlock(nn.Module):
    """GN-SiLU-conv twice with an additive time embedding.
    (reference: models/unet.py:10-43)  ``fused_gn`` is taken and changes
    nothing: both settings run ``group_norm`` (K3)."""

    def __init__(self, in_channels: int, out_channels: int, dropout: float = 0.1,
                 dtype: Any = None, fused_gn: bool = False, embed_dim: Optional[int] = None,
                 device: Any = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        if in_channels != out_channels:
            self.shortcut = Conv(in_channels, out_channels, 1, 1, 0, **kw)
        self.norm1 = GroupNorm(32, in_channels, eps=1e-5, device=device)
        self.conv1 = Conv(in_channels, out_channels, 3, 1, 1, **kw)
        if embed_dim is not None:
            self.proj = Dense(embed_dim, out_channels, **kw)
        self.norm2 = GroupNorm(32, out_channels, eps=1e-5, device=device)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv(out_channels, out_channels, 3, 1, 1, **kw)

    def forward(self, x: torch.Tensor, time_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
        h = self.conv1(self.norm1(x, silu=True))
        if time_embed is not None:
            h = h + self.proj(F.silu(time_embed))[:, :, None, None].to(h.dtype)
        h = self.conv2(self.dropout(self.norm2(h, silu=True)))
        return h + shortcut


class UNet(nn.Module):
    """(reference: models/unet.py:46-152)"""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, dim: int = 128,
                 dim_mults: Sequence[int] = (1, 2, 2, 2),
                 use_attn: Sequence[bool] = (False, True, False, False), num_res_blocks: int = 2,
                 n_heads: int = 1, dropout: float = 0.1, dtype: Any = None,
                 fused_gn: bool = False, device: Any = None):
        super().__init__()
        if isinstance(dtype, str):  # a YAML config names the dtype
            dtype = getattr(torch, dtype)
        self.in_channels, self.out_channels, self.dtype = in_channels, out_channels, dtype
        ted = dim * 4
        kw = dict(dtype=dtype, device=device)

        def res(name: str, cin: int, cout: int) -> None:
            self.add_module(name, ResBlock(cin, cout, dropout, fused_gn=fused_gn,
                                           embed_dim=ted, **kw))

        self.time_pos = SinusoidalPosEmb(dim, device=device)
        self.time_embed_1 = Dense(dim, ted, device=device)
        self.time_embed_2 = Dense(ted, ted, device=device)
        self.first_conv = Conv(in_channels, dim, 3, 1, 1, **kw)
        self._down, self._up = [], []  # the forward order; None marks a skip
        skips, ch = [dim], dim
        for i, mult in enumerate(dim_mults):
            out_dim = dim * mult
            for j in range(num_res_blocks):
                res(f"down_{i}_res_{j}", ch, out_dim)
                ch = out_dim
                self._down.append(f"down_{i}_res_{j}")
                if use_attn[i]:
                    self.add_module(f"down_{i}_attn_{j}",
                                    SelfAttentionBlock(out_dim, n_heads, **kw))
                    self._down.append(f"down_{i}_attn_{j}")
                skips.append(ch)
                self._down.append(None)  # a skip is taken here
            if i < len(dim_mults) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(out_dim, out_dim, **kw))
                self._down += [f"down_{i}_downsample", None]
                skips.append(ch)
        res("mid_res_1", ch, ch)
        self.mid_attn = SelfAttentionBlock(ch, 1, **kw)
        res("mid_res_2", ch, ch)
        for i in reversed(range(len(dim_mults))):
            out_dim = dim * dim_mults[i]
            for j in range(num_res_blocks + 1):
                res(f"up_{i}_res_{j}", ch + skips.pop(), out_dim)
                ch = out_dim
                self._up += [None, f"up_{i}_res_{j}"]  # None: a skip is concatenated
                if use_attn[i]:
                    self.add_module(f"up_{i}_attn_{j}", SelfAttentionBlock(out_dim, n_heads, **kw))
                    self._up.append(f"up_{i}_attn_{j}")
            if i > 0:
                self.add_module(f"up_{i}_upsample", Upsample(out_dim, out_dim, **kw))
                self._up.append(f"up_{i}_upsample")
        self.last_norm = GroupNorm(32, ch, eps=1e-5, device=device)
        self.last_conv = Conv(ch, out_channels, 3, 1, 1, device=device)

    def _block(self, name: str, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        return block(h, emb) if isinstance(block, ResBlock) else block(h)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        emb = self.time_embed_1(self.time_pos(t))
        emb = self.time_embed_2(F.silu(emb))
        h = self.first_conv(x if self.dtype is None else x.to(self.dtype))
        skips = [h]
        for name in self._down:
            if name is None:
                skips.append(h)
            else:
                h = self._block(name, h, emb)
        h = self.mid_res_2(self.mid_attn(self.mid_res_1(h, emb)), emb)
        for name in self._up:
            if name is None:
                h = torch.cat([h, skips.pop()], dim=1)
            else:
                h = self._block(name, h, emb)
        h = self.last_norm(h.float(), silu=True)
        return self.last_conv(h)
