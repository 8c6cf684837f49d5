"""Stable Diffusion 1.x in plain PyTorch, float32: the CLIP text tower, the
cross-attention UNet and the AutoencoderKL.

Written from the published models (CompVis/stable-diffusion's
``ldm/modules/diffusionmodules/openaimodel.py``, ``ldm/modules/attention.py``
and ``ldm/modules/diffusionmodules/model.py``; Hugging Face's
``CLIPTextModel``), for the configuration the benchmark runs: a spatial
transformer of depth 1 at each attended level, GEGLU feed-forward, 1x1
convolutions around it, no class embedding.  Parameter names are the
upstream ones under the prefixes ``unet.``, ``vae.`` and
``text_encoder.model.``, so one state dict loads into this module and into
the program under test alike.

Departures from upstream, each as the program configures it: none in the
mathematics; the GroupNorms, LayerNorms and softmax run in float32.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.nn import (
    Attend,
    Conv2d,
    GroupNorm,
    Linear,
    layer_norm,
    timestep_embedding,
)


# --- the UNet ------------------------------------------------------------------

def _gn(ch: int, eps: float = 1e-5) -> GroupNorm:
    return GroupNorm(32, ch, eps=eps)


class ResBlock(nn.Module):
    def __init__(self, ch: int, emb_ch: int, out_ch: int):
        super().__init__()
        self.in_layers = nn.Sequential(_gn(ch), nn.SiLU(), Conv2d(ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_ch, out_ch))
        self.out_layers = nn.Sequential(_gn(out_ch), nn.SiLU(), nn.Dropout(0.0),
                                        Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = nn.Identity() if ch == out_ch else Conv2d(ch, out_ch, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[2](self.in_layers[0](x, silu=True))
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None, None]
        h = self.out_layers[3](self.out_layers[0](h, silu=True))
        return self.skip_connection(x) + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(0.0))
        self.attend = Attend()

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, d = x.shape[0], self.heads, self.dim_head
        q = self.to_q(x).view(b, -1, h, d)
        k = self.to_k(context).view(b, -1, h, d)
        v = self.to_v(context).view(b, -1, h, d)
        return self.to_out[0](self.attend(q, k, v).reshape(b, -1, h * d))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0), Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = layer_norm(self.norm1, x)
        x = self.attn1(h, h) + x
        x = self.attn2(layer_norm(self.norm2, x), context) + x
        return self.ff(layer_norm(self.norm3, x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = _gn(ch, eps=1e-6)
        self.proj_in = Conv2d(ch, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim)])
        self.proj_out = Conv2d(inner, ch, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        h = h.flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = h.transpose(1, 2).reshape(b, -1, hh, ww)
        return self.proj_out(h) + x


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Block(nn.ModuleList):
    """One ``TimestepEmbedSequential``."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class UNet(nn.Module):
    """openaimodel.UNetModel with ``use_spatial_transformer``."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int], num_heads: int, context_dim: int,
                 transformer_depth: int = 1, **_):
        super().__init__()
        if transformer_depth != 1:
            raise ValueError("the reference UNet has transformer depth 1")
        ted = model_channels * 4
        self.model_channels = model_channels
        self.time_embed = nn.Sequential(Linear(model_channels, ted), nn.SiLU(), Linear(ted, ted))

        def st(ch):
            return SpatialTransformer(ch, num_heads, ch // num_heads, context_dim)

        self.input_blocks = nn.ModuleList([Block([Conv2d(in_channels, model_channels, 3,
                                                         padding=1)])])
        chans, ch, ds = [model_channels], model_channels, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, ted, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(st(ch))
                self.input_blocks.append(Block(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(Block([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = Block([ResBlock(ch, ted, ch), st(ch), ResBlock(ch, ted, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), ted, model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(st(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Block(layers))
        self.out = nn.Sequential(_gn(ch), nn.SiLU(), Conv2d(ch, out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        h, hs = x.float(), []
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out[2](self.out[0](h, silu=True))


# --- the CLIP text tower -------------------------------------------------------

class _CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(width, width)
                                                                for _ in range(4))
        self.attend = Attend(causal=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = (p(x).view(b, t, self.heads, d // self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(self.attend(q, k, v).reshape(b, t, d))


class _CLIPMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(width, 4 * width), Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick GELU


class _CLIPLayer(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.layer_norm1, self.layer_norm2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.self_attn = _CLIPAttention(width, heads)
        self.mlp = _CLIPMLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(self.layer_norm1, x))
        return x + self.mlp(layer_norm(self.layer_norm2, x))


class CLIPText(nn.Module):
    """Hugging Face ``CLIPTextModel.text_model``: the last hidden state after
    the final LayerNorm (SD1.x's ``FrozenCLIPEmbedder``)."""

    def __init__(self, vocab_size: int, max_length: int, width: int, layers: int, heads: int):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(vocab_size, width)
        self.embeddings.position_embedding = nn.Embedding(max_length, width)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(_CLIPLayer(width, heads) for _ in range(layers))
        self.final_layer_norm = nn.LayerNorm(width)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        e = self.embeddings
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = e.token_embedding(ids.long()) + e.position_embedding(pos)[None]
        for layer in self.encoder.layers:
            x = layer(x)
        return layer_norm(self.final_layer_norm, x)


# --- the AutoencoderKL ---------------------------------------------------------

class _VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = _gn(cin, 1e-6), Conv2d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = _gn(cout, 1e-6), Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class _VAEAttn(nn.Module):
    """One head as wide as the channels, 1x1-convolution projections."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _gn(ch, 1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv2d(ch, ch, 1) for _ in range(4))
        self.attend = Attend()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (conv(hn).reshape(b, c, h * w).transpose(1, 2).unsqueeze(2)
                   for conv in (self.q, self.k, self.v))
        out = self.attend(q, k, v, scale=c ** -0.5).squeeze(2).transpose(1, 2)
        return x + self.proj_out(out.reshape(b, c, h, w))


class _VAEDown(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid(ch: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = _VAEResnet(ch, ch), _VAEAttn(ch), _VAEResnet(ch, ch)
    return mid


def _level(blocks: int, cin: int, cout: int) -> nn.Module:
    level = nn.Module()
    level.block = nn.ModuleList(_VAEResnet(cin if i == 0 else cout, cout) for i in range(blocks))
    level.attn = nn.ModuleList()
    return level


class Encoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int, z_channels: int,
                 in_channels: int = 3):
        super().__init__()
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = ch
        for i, mult in enumerate(ch_mult):
            level = _level(num_res_blocks, cin, ch * mult)
            cin = ch * mult
            if i != len(ch_mult) - 1:
                level.downsample = _VAEDown(cin)
            self.down.append(level)
        self.mid = _mid(cin)
        self.norm_out = _gn(cin, 1e-6)
        self.conv_out = Conv2d(cin, 2 * z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int, z_channels: int,
                 out_ch: int = 3):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, cin, 3, padding=1)
        self.mid = _mid(cin)
        levels = []
        for i in reversed(range(len(ch_mult))):
            level = _level(num_res_blocks + 1, cin, ch * ch_mult[i])
            cin = ch * ch_mult[i]
            if i != 0:
                level.upsample = Upsample(cin)
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(cin, 1e-6)
        self.conv_out = Conv2d(cin, out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int = 4, embed_dim: int = 4, **_):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


def sample_posterior(moments: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """mean + exp(logvar / 2) * noise, the log-variance clamped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=1)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise


# --- the three together --------------------------------------------------------

CLIP_L = dict(width=768, layers=12, heads=12)


class StableDiffusion(nn.Module):
    """``unet``, ``vae`` and ``text_encoder.model`` from a config's
    ``model.params`` (the YAML layout of CompVis's configs)."""

    def __init__(self, params: Mapping):
        super().__init__()
        self.scale_factor = float(params["scale_factor"])
        self.unet = UNet(**params["unet_config"]["params"])
        self.vae = AutoencoderKL(**params["vae_config"]["params"])
        te = params["text_encoder_config"]["params"]
        self.text_encoder = nn.Module()
        clip = {**CLIP_L, **te.get("config_overrides", {})}
        self.text_encoder.model = CLIPText(clip.get("vocab_size", 49408),
                                           te.get("max_length", 77), clip["width"],
                                           clip["layers"], clip["heads"])

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder.model(ids)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z.float() / self.scale_factor)
