"""The class-conditional UNet with AdaGN conditioning, in NCHW.

Counterpart of ``dmtpu/models/unet_categorial_adagn.py`` (reference:
models/unet_categorial_adagn.py:12-208): AdaGN scale-shift conditioning on
the time + class embedding, ResBlock up/downsampling, multi-head attention
sized by ``attn_head_dims``.  Module names are the JAX package's.

The unconditional branch (the reference's ``y=None``) is also the null
label ``y == num_classes``: the class table has one extra row, zero at
initialisation, so a CFG sampler's doubled batch is one call.  ``y=None``
leaves the class embedding out.  An upstream table one row short gets the
zero row appended when it is loaded, as the JAX package's converter pads it.

``dtype`` (not in the JAX module, which is f32; default None = f32) is the
torso's compute dtype, bf16 on the card, where K1 takes only bf16: the
convolutions and the attention compute in it; the embeddings, AdaGN's
projection and every GroupNorm's statistics stay f32.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.models.modules import (
    AdaGN,
    Conv,
    Dense,
    Downsample,
    GroupNorm,
    SelfAttentionBlock,
    SinusoidalPosEmb,
    Upsample,
    nearest_up,
)


class ResBlockAdaGN(nn.Module):
    """(reference: models/unet_categorial_adagn.py:12-72)"""

    def __init__(self, in_channels: int, out_channels: int, embed_dim: int, dropout: float = 0.1,
                 up: bool = False, down: bool = False, dtype: Any = None, device: Any = None):
        super().__init__()
        if up and down:
            raise ValueError("a ResBlockAdaGN is up or down, not both")
        kw = dict(dtype=dtype, device=device)
        self.up, self.down = up, down
        self.norm1 = GroupNorm(32, in_channels, eps=1e-5, device=device)
        self.conv1 = Conv(in_channels, out_channels, 3, 1, 1, **kw)
        self.adagn = AdaGN(32, out_channels, embed_dim, device=device)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv(out_channels, out_channels, 3, 1, 1, **kw)
        if in_channels != out_channels:
            self.shortcut = Conv(in_channels, out_channels, 1, 1, 0, **kw)

    def _updown(self, z: torch.Tensor) -> torch.Tensor:
        if self.up:
            return nearest_up(z)
        return F.avg_pool2d(z, 2) if self.down else z

    def forward(self, x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x, silu=True)
        if self.up or self.down:
            h, x = self._updown(h), self._updown(x)
        h = self.adagn(self.conv1(h), embed, silu=True)
        h = self.conv2(self.dropout(h))
        return h + (self.shortcut(x) if hasattr(self, "shortcut") else x)


class UNetCategorialAdaGN(nn.Module):
    """(reference: models/unet_categorial_adagn.py:75-208)"""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, dim: int = 128,
                 dim_mults: Sequence[int] = (1, 2, 2, 2),
                 use_attn: Sequence[bool] = (False, True, True, False), num_res_blocks: int = 2,
                 num_classes: Optional[int] = None, attn_head_dims: int = 64,
                 resblock_updown: bool = True, dropout: float = 0.1, dtype: Any = None,
                 device: Any = None):
        super().__init__()
        if isinstance(dtype, str):  # a YAML config names the dtype
            dtype = getattr(torch, dtype)
        self.in_channels, self.out_channels, self.dtype = in_channels, out_channels, dtype
        self.num_classes = num_classes
        ted = dim * 4
        kw = dict(dtype=dtype, device=device)

        def res(name: str, cin: int, cout: int, **updown) -> None:
            self.add_module(name, ResBlockAdaGN(cin, cout, ted, dropout, **updown, **kw))

        def attn(name: str, ch: int, heads: int) -> None:
            self.add_module(name, SelfAttentionBlock(ch, heads, **kw))

        self.time_pos = SinusoidalPosEmb(dim, device=device)
        self.time_embed_1 = Dense(dim, ted, device=device)
        self.time_embed_2 = Dense(ted, ted, device=device)
        if num_classes is not None:
            self.class_embed = nn.Embedding(num_classes + 1, ted, device=device)
            with torch.no_grad():
                self.class_embed.weight[-1].zero_()
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
                    attn(f"down_{i}_attn_{j}", out_dim, out_dim // attn_head_dims)
                    self._down.append(f"down_{i}_attn_{j}")
                self._down.append(None)
                skips.append(ch)
            if i < len(dim_mults) - 1:
                name = f"down_{i}_downsample"
                if resblock_updown:
                    res(name, out_dim, out_dim, down=True)
                else:
                    self.add_module(name, Downsample(out_dim, out_dim, **kw))
                self._down += [name, None]
                skips.append(ch)
        res("mid_res_1", ch, ch)
        self.mid_attn = SelfAttentionBlock(ch, 1, **kw)
        res("mid_res_2", ch, ch)
        for i in reversed(range(len(dim_mults))):
            out_dim = dim * dim_mults[i]
            for j in range(num_res_blocks + 1):
                res(f"up_{i}_res_{j}", ch + skips.pop(), out_dim)
                ch = out_dim
                self._up += [None, f"up_{i}_res_{j}"]
                if use_attn[i]:
                    attn(f"up_{i}_attn_{j}", out_dim, out_dim // attn_head_dims)
                    self._up.append(f"up_{i}_attn_{j}")
            if i > 0:
                name = f"up_{i}_upsample"
                if resblock_updown:
                    res(name, out_dim, out_dim, up=True)
                else:
                    self.add_module(name, Upsample(out_dim, out_dim, **kw))
                self._up.append(name)
        self.last_norm = GroupNorm(32, ch, eps=1e-5, device=device)
        self.last_conv = Conv(ch, out_channels, 3, 1, 1, device=device)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # an upstream class table has no null row: append the zero one
        key = prefix + "class_embed.weight"
        table = state_dict.get(key)
        if table is not None and table.shape[0] == self.num_classes:
            state_dict[key] = torch.cat([table, table.new_zeros(1, table.shape[1])])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _block(self, name: str, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        return block(h, emb) if isinstance(block, ResBlockAdaGN) else block(h)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.time_embed_2(F.silu(self.time_embed_1(self.time_pos(t))))
        if self.num_classes is not None and y is not None:
            emb = emb + self.class_embed(y.long())
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
        return self.last_conv(self.last_norm(h.float(), silu=True))
