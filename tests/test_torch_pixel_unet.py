"""dmtpu_torch's pixel-space UNets and their blocks against dmtpu's, on the CPU.

The repo's own ``UNet`` (both ``fused_gn`` settings), ``UNetCategorialAdaGN``
(with labels, with the null class, without ``y``, with and without ResBlock
resampling), ``PesserUNet`` and the blocks of ``models/modules.py``: the
same numpy-seeded inputs go through the JAX module and its port, whose
weights are the JAX module's seeded random params (``jax_random_params``:
no layer is zero) carried by the param bridge, which maps the JAX dense
q / k / v / proj onto the port's 1x1 convolutions.  Sizes are narrow (32
and 64 channels, 8x8 or 16x16 images).  Tolerance: f32 relative L2 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models import modules as jmodules
from dmtpu.models import pesser as jpesser
from dmtpu.models.unet import UNet as JaxUNet
from dmtpu.models.unet_categorial_adagn import UNetCategorialAdaGN as JaxAdaGN
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.models import modules as tmodules
from dmtpu_torch.models.pesser import PesserUNet
from dmtpu_torch.models.unet import UNet
from dmtpu_torch.models.unet_categorial_adagn import UNetCategorialAdaGN
from dmtpu_torch.utils.config import instantiate_from_config
from tests._torch_helpers import jax_random_params, nhwc, t

F32 = 1e-5
TS = np.array([3, 700])


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _x(c, s, seed=0, b=2):
    return np.random.RandomState(seed).randn(b, c, s, s).astype(np.float32)


def _pair(jmod, tmod, *args, seed=0):
    """JAX params for ``jmod`` at ``args`` and the port's module loaded with them."""
    params = jax_random_params(jmod, *args, seed=seed)
    return params, load_flax_params(tmod, params).eval()


def _check(jmod, params, tmod, x, *jargs, targs=()):
    want = np.asarray(jmod.apply(params, jnp.asarray(nhwc(x)), *jargs))
    with torch.no_grad():
        got = tmod(t(x), *targs).numpy()
    if got.ndim == 4:
        got = nhwc(got)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert _rel_l2(got, want) <= F32, _rel_l2(got, want)


UNET = dict(in_channels=3, out_channels=3, dim=32, dim_mults=(1, 2), use_attn=(False, True),
            num_res_blocks=1, dropout=0.0)


@pytest.mark.parametrize("fused_gn", [False, True])
@pytest.mark.parametrize("n_heads", [1, 2])
def test_unet_matches_jax(fused_gn, n_heads):
    cfg = dict(UNET, fused_gn=fused_gn, n_heads=n_heads)
    x = _x(3, 8, seed=1)
    jmod = JaxUNet(**cfg)
    params, tmod = _pair(jmod, UNet(**cfg), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32))
    _check(jmod, params, tmod, x, jnp.asarray(TS), targs=(t(TS),))


def test_celebahq_unet_structure_matches_jax_at_a_narrow_width():
    """configs/ddpm_celebahq.yaml's UNet (six levels, attention at the fifth
    and in the middle, one head as wide as the channels) at dim 32, the
    narrowest its 32 GroupNorm groups take: one head of 128, on 32x32 images
    (attention at 2x2 and 1x1)."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "ddpm_celebahq.yaml")) as f:
        cfg = dict(yaml.safe_load(f)["model"]["params"], dim=32)
    assert cfg["n_heads"] == 1 and cfg["use_attn"].index(True) == 4
    x = _x(3, 32, seed=4)
    jmod = JaxUNet(**cfg)
    params, tmod = _pair(jmod, UNet(**cfg), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,), jnp.int32))
    assert tmod.down_4_attn_0.q.weight.shape[0] == 128
    # jitted: six levels op by op would compile for 20 s
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(nhwc(x)), jnp.asarray(TS)))
    with torch.no_grad():
        got = nhwc(tmod(t(x), t(TS)).numpy())
    assert np.isfinite(got).all() and _rel_l2(got, want) <= F32, _rel_l2(got, want)


def test_unet_keys_and_the_two_gn_settings_share_parameters():
    a, b = UNet(**UNET).state_dict(), UNet(**UNET, fused_gn=True).state_dict()
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    assert a["down_1_attn_0.q.weight"].shape == (64, 64, 1, 1)
    assert "first_conv.conv.weight" in a and "time_embed_1.dense.weight" in a
    assert "up_1_upsample.conv.conv.weight" in a and "mid_attn.proj.bias" in a


ADAGN = dict(in_channels=3, out_channels=3, dim=32, dim_mults=(1, 2), use_attn=(False, True),
             num_res_blocks=1, num_classes=5, attn_head_dims=32, dropout=0.0)


@pytest.mark.parametrize("resblock_updown", [True, False])
@pytest.mark.parametrize("labels", ["y", "null", "none"])
def test_unet_categorial_adagn_matches_jax(resblock_updown, labels):
    cfg = dict(ADAGN, resblock_updown=resblock_updown)
    x = _x(3, 8, seed=2)
    jmod = JaxAdaGN(**cfg)
    params, tmod = _pair(jmod, UNetCategorialAdaGN(**cfg), jnp.zeros((1, 8, 8, 3)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    ys = {"y": np.array([1, 4]), "null": np.array([5, 5]), "none": None}[labels]
    jargs = (jnp.asarray(TS),) + (() if ys is None else (jnp.asarray(ys),))
    targs = (t(TS),) + (() if ys is None else (t(ys),))
    _check(jmod, params, tmod, x, *jargs, targs=targs)


def test_adagn_null_row_is_zero_and_an_upstream_table_gets_it():
    m = UNetCategorialAdaGN(**ADAGN)
    assert m.class_embed.weight.shape == (6, 128) and not m.class_embed.weight[-1].any()
    sd = m.state_dict()
    sd["class_embed.weight"] = torch.randn(5, 128)  # the reference's table: no null row
    m.load_state_dict(sd)
    assert torch.equal(m.class_embed.weight[:5], sd["class_embed.weight"][:5])
    assert not m.class_embed.weight[5].any()
    # y=None and the null class give the same output
    x, ts = t(_x(3, 8)), t(TS)
    with torch.no_grad():
        torch.testing.assert_close(m(x, ts), m(x, ts, torch.tensor([5, 5])), rtol=0, atol=0)


PESSER = dict(ch=32, out_ch=3, num_res_blocks=1, attn_resolutions=(8,), in_channels=3,
              resolution=16, ch_mult=(1, 2), dropout=0.0)


@pytest.mark.parametrize("resamp_with_conv", [True, False])
def test_pesser_unet_matches_jax(resamp_with_conv):
    cfg = dict(PESSER, resamp_with_conv=resamp_with_conv)
    x = _x(3, 16, seed=3)
    jmod = jpesser.PesserUNet(**cfg)
    params, tmod = _pair(jmod, PesserUNet(**cfg), jnp.zeros((1, 16, 16, 3)),
                         jnp.zeros((1,), jnp.float32))
    _check(jmod, params, tmod, x, jnp.asarray(TS, jnp.float32), targs=(t(TS.astype(np.float32)),))


def test_pesser_unet_has_upstream_keys():
    keys = PesserUNet(**PESSER).state_dict()
    for k in ("temb.dense.0.weight", "conv_in.weight", "down.0.block.0.conv1.weight",
              "down.1.attn.0.q.weight", "down.0.downsample.conv.weight", "mid.attn_1.proj_out.bias",
              "up.1.block.1.nin_shortcut.weight", "up.1.upsample.conv.weight", "norm_out.weight"):
        assert k in keys, k


# ---- the blocks of models/modules.py --------------------------------------------

@pytest.mark.parametrize("n_heads", [1, 2])
def test_self_attention_block_matches_jax(n_heads):
    x = _x(64, 4, seed=4)
    jmod = jmodules.SelfAttentionBlock(64, n_heads)
    params, tmod = _pair(jmod, tmodules.SelfAttentionBlock(64, n_heads), jnp.zeros((1, 4, 4, 64)))
    _check(jmod, params, tmod, x)


def test_adagn_matches_jax():
    x, e = _x(64, 4, seed=5), np.random.RandomState(6).randn(2, 48).astype(np.float32)
    jmod = jmodules.AdaGN(32, 64, 48)
    params, tmod = _pair(jmod, tmodules.AdaGN(32, 64, 48), jnp.zeros((1, 4, 4, 64)),
                         jnp.zeros((1, 48)))
    _check(jmod, params, tmod, x, jnp.asarray(e), targs=(t(e),))


@pytest.mark.parametrize("silu", [True, False])
def test_fused_gn_silu_matches_jax(silu):
    x = _x(64, 4, seed=7)
    jmod = jmodules.FusedGNSiLU(32, silu=silu)
    params, tmod = _pair(jmod, tmodules.FusedGNSiLU(64, 32, silu=silu), jnp.zeros((1, 4, 4, 64)))
    _check(jmod, params, tmod, x)


@pytest.mark.parametrize("which,use_conv", [("up", True), ("up", False), ("down", True),
                                            ("down", False)])
def test_up_and_downsample_match_jax(which, use_conv):
    x = _x(32, 8, seed=8)
    jcls, tcls = ((jmodules.Upsample, tmodules.Upsample) if which == "up"
                  else (jmodules.Downsample, tmodules.Downsample))
    jmod = jcls(48, use_conv)
    if use_conv:
        params, tmod = _pair(jmod, tcls(32, 48, use_conv), jnp.zeros((1, 8, 8, 32)))
    else:
        params, tmod = {}, tcls(32, 48, use_conv)
    _check(jmod, params, tmod, x)


def test_sinusoidal_pos_emb_and_dense_match_jax():
    ts = np.array([0.0, 3.0, 999.0, 12.5], np.float32)
    want = np.asarray(jmodules.SinusoidalPosEmb(32)(jnp.asarray(ts)))
    got = tmodules.SinusoidalPosEmb(32)(t(ts)).numpy()
    assert _rel_l2(got, want) <= F32
    e = np.random.RandomState(9).randn(3, 16).astype(np.float32)
    jmod = jmodules.Dense(24)
    params, tmod = _pair(jmod, tmodules.Dense(16, 24), jnp.zeros((1, 16)))
    want = np.asarray(jmod.apply(params, jnp.asarray(e)))
    assert _rel_l2(tmod(t(e)).detach().numpy(), want) <= F32


@pytest.mark.parametrize("target,cls", [
    ("models.unet.UNet", UNet),
    ("models.unet_categorial_adagn.UNetCategorialAdaGN", UNetCategorialAdaGN),
    ("models.pesser.model.Model", PesserUNet),
    ("dmtpu.models.pesser.PesserUNet", PesserUNet),
])
def test_registry_builds_the_pixel_models(target, cls):
    params = {UNet: UNET, UNetCategorialAdaGN: ADAGN, PesserUNet: PESSER}[cls]
    assert isinstance(instantiate_from_config({"target": target, "params": params},
                                              device="meta"), cls)


def test_bf16_torso_keeps_f32_parameters_and_embeddings():
    m = UNet(**UNET, dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        out = m(t(_x(3, 8)), t(TS))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    a = UNetCategorialAdaGN(**ADAGN, dtype=torch.bfloat16)
    with torch.no_grad():
        assert a(t(_x(3, 8)), t(TS), t(np.array([0, 5]))).dtype == torch.float32
