"""dmtpu_torch's MMDiT and its converters against dmtpu's, on the CPU.

The same numpy-seeded inputs go through the JAX module and its port; the
JAX params are seeded random (``jax_random_params``: no layer is zero) and
carried by the bridge's MMDiT rename.  The tiny models keep MMDiT's head
dim of 64 (hidden 128, 2 heads, depth 2, so one ordinary block and the
``context_pre_only`` last one).  Tolerances, relative L2: f32 1e-5 (sums in
another order), bf16 2e-2 (the torso's rounding at other places in the two
frameworks).  An SD3-keyed state dict, made from a live Flax tree by the JAX
converter test's inverse map, goes through both packages' ``convert_mmdit``
and must give the same outputs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.convert.zoo import convert_mmdit as jax_convert_mmdit
from dmtpu.models import mmdit as jmmdit
from dmtpu_torch.convert import convert_mmdit, convert_sd3_vae, load_flax_params, mmdit_key
from dmtpu_torch.convert.flax_bridge import state_dict_from_flax
from dmtpu_torch.models import mmdit as tmmdit
from dmtpu_torch.models.stablediffusion import AutoencoderKL
from dmtpu_torch.utils.config import instantiate_from_config, load_config
from tests._torch_helpers import jax_random_params, nhwc, t
from tests.test_convert_mmdit import _to_sgm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, BF16 = 1e-5, 2e-2
TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=128, depth=2, num_heads=2,
            context_dim=16, pooled_dim=12)
rs = np.random.RandomState(0)
X = rs.randn(2, 4, 8, 8).astype(np.float32)
TS = np.array([3.5, 742.25], np.float32)
Y = {"context": rs.randn(2, 5, 16).astype(np.float32), "pooled": rs.randn(2, 12).astype(np.float32)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _params(jmod, seed=0):
    y = {"context": jnp.zeros((1, 5, jmod.context_dim)), "pooled": jnp.zeros((1, jmod.pooled_dim))}
    return jax_random_params(jmod, jnp.zeros((1, jmod.input_size, jmod.input_size,
                                              jmod.in_channels)), jnp.zeros((1,)), y, seed=seed)


def _jax_apply(jmod, params, x=X, ts=TS, y=Y):
    return np.asarray(jmod.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(ts),
                                 {k: jnp.asarray(v) for k, v in y.items()})).astype(np.float32)


def _torch_apply(tmod, x=X, ts=TS, y=Y, **kw):
    with torch.no_grad():
        out = tmod(t(x), torch.from_numpy(ts), {k: t(v) for k, v in y.items()}, **kw)
    return nhwc(out.float().numpy())


@pytest.mark.parametrize("dtype,tol", [(None, F32), ("bfloat16", BF16)], ids=["f32", "bf16"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["no_qk_norm", "qk_norm"])
def test_mmdit_matches_at_head_dim_64(qk_norm, dtype, tol):
    jmod = jmmdit.MMDiT(**TINY, qk_norm=qk_norm, dtype=None if dtype is None else jnp.bfloat16)
    params = _params(jmod)
    want = _jax_apply(jmod, params)
    tmod = load_flax_params(tmmdit.MMDiT(**TINY, qk_norm=qk_norm, dtype=dtype), params).eval()
    got = _torch_apply(tmod)
    assert got.shape == (2, 8, 8, 4) and _rel(got, want) <= tol
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    assert tmod.hidden_size // tmod.num_heads == 64


@pytest.mark.parametrize("max_size", [4, 10])
def test_cropped_pos_embed_matches(max_size):
    jmod = jmmdit.MMDiT(**TINY, pos_embed_max_size=max_size)
    params = _params(jmod, seed=1)
    tmod = load_flax_params(tmmdit.MMDiT(**TINY, pos_embed_max_size=max_size), params).eval()
    assert _rel(_torch_apply(tmod), _jax_apply(jmod, params)) <= F32
    offset = (max_size - 4) // 2
    base = tmmdit.get_2d_sincos_pos_embed(128, max_size).reshape(max_size, max_size, 128)
    crop = base[offset:offset + 4, offset:offset + 4].reshape(1, 16, 128)
    np.testing.assert_allclose(tmod.pos_embed.numpy(), crop, atol=1e-6)
    assert "pos_embed" not in tmod.state_dict()
    with pytest.raises(ValueError, match="exceeds"):
        tmmdit.MMDiT(**TINY, pos_embed_max_size=3)


def test_the_last_block_is_context_pre_only():
    m = tmmdit.MMDiT(**{**TINY, "depth": 3})
    sd = m.state_dict()
    last = "joint_blocks.2.context_block"
    assert sd[f"{last}.adaLN_modulation.1.weight"].shape == (2 * 128, 128)
    assert f"{last}.attn.qkv.weight" in sd
    assert not any(k.startswith((f"{last}.attn.proj", f"{last}.mlp")) for k in sd)
    assert sd["joint_blocks.1.context_block.adaLN_modulation.1.weight"].shape == (6 * 128, 128)
    assert "joint_blocks.2.x_block.mlp.fc1.weight" in sd
    # every key is SD3's: the JAX tree's leaves, renamed, are exactly the module's
    jmod = jmmdit.MMDiT(**{**TINY, "depth": 3}, qk_norm=True)
    keys = set(state_dict_from_flax(_params(jmod), mmdit_key))
    assert keys == set(tmmdit.MMDiT(**{**TINY, "depth": 3}, qk_norm=True).state_dict())
    assert "joint_blocks.0.x_block.attn.ln_q.weight" in keys
    # the last block returns no context
    with torch.no_grad():
        ctx, x = m.joint_blocks[2](torch.zeros(1, 5, 128), torch.zeros(1, 16, 128),
                                   torch.zeros(1, 128))
    assert ctx is None and x.shape == (1, 16, 128)


def test_null_conditioning_and_the_width_check():
    jmod = jmmdit.MMDiT(**TINY)
    tmod = tmmdit.MMDiT(**TINY)
    want = jmod.null_conditioning(3, 7)
    got = tmod.null_conditioning(3, 7)
    for k in ("context", "pooled"):
        assert tuple(got[k].shape) == want[k].shape and not got[k].any()
        assert got[k].dtype == torch.float32
    with pytest.raises(ValueError, match="do not match"):
        tmod(t(X), torch.from_numpy(TS), {"context": torch.zeros(2, 5, 15),
                                          "pooled": torch.zeros(2, 12)})
    with pytest.raises(ValueError, match="null_conditioning"):
        tmod(t(X), torch.from_numpy(TS))


def test_identity_at_init_and_remat_equals_no_remat():
    m = tmmdit.MMDiT(**TINY).eval()
    y = {k: t(v) for k, v in Y.items()}
    with torch.no_grad():
        ctx, c = m._condition(torch.from_numpy(TS), y, train=False, drop_generator=None)
        x = torch.randn(2, 16, 128)
        for blk in m.joint_blocks:  # adaLN-Zero: every block is the identity
            new_ctx, new_x = blk(ctx, x, c)
            assert torch.equal(new_x, x) and (new_ctx is None or torch.equal(new_ctx, ctx))
        assert not m(t(X), torch.from_numpy(TS), y).any()  # the zero final layer
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    r = tmmdit.MMDiT(**TINY, use_checkpoint=True)
    r.load_state_dict(m.state_dict())
    outs, grads = [], []
    for mod in (m, r):
        mod.zero_grad()
        x = t(X).requires_grad_()
        out = mod(x, torch.from_numpy(TS), y)
        out.square().mean().backward()
        outs.append(out.detach())
        grads.append([x.grad] + [p.grad for p in mod.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(*grads))


def test_conditioning_dropout_needs_train_and_a_generator():
    m = tmmdit.MMDiT(**TINY, cond_dropout_prob=1.0).eval()
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    y = {k: t(v) for k, v in Y.items()}
    null = m.null_conditioning(2, 5)
    with torch.no_grad():
        base = m(t(X), torch.from_numpy(TS), y)
        assert torch.equal(m(t(X), torch.from_numpy(TS), y, train=True), base)
        dropped = m(t(X), torch.from_numpy(TS), y, train=True,
                    drop_generator=torch.Generator().manual_seed(0))
        assert torch.equal(dropped, m(t(X), torch.from_numpy(TS), null))
        assert not torch.equal(dropped, base)


def test_sd3_medium_config_on_the_meta_device():
    conf = load_config(os.path.join(REPO, "configs", "sd3_medium.yaml"))
    m = instantiate_from_config(conf.model, device="meta")
    n = sum(p.numel() for p in m.parameters())
    assert isinstance(m, tmmdit.MMDiT) and 1.9e9 < n < 2.2e9
    assert m.qk_norm is False and m.pos_embed_max_size == 192 and m.hidden_size // m.num_heads == 64
    assert len(m.joint_blocks) == 24 and m.grid == 64
    d = instantiate_from_config(conf.diffusion)
    assert d.time_shift == 3.0 and d.solver == "euler" and len(d.respaced_seq) == 28
    vae = instantiate_from_config(conf.vae, device="meta")
    assert isinstance(vae, AutoencoderKL) and vae.post_quant_conv.out_channels == 16
    assert tmmdit.MMDIT_CONFIGS == jmmdit.MMDIT_CONFIGS
    b2 = tmmdit.mmdit_model("MMDiT-B/2", input_size=32, context_dim=4096, pooled_dim=2048,
                            device="meta")
    assert b2.depth == 12 and b2.num_heads == 12 and b2.hidden_size // b2.num_heads == 64


def _sd3_file(params, extra=()):
    """An SD3 single-file state dict from a Flax tree (``_to_sgm``'s extras
    included: a ``pos_embed``, a VAE and a text-tower tensor)."""
    sd = {k if k.startswith(("first_stage_model.", "text_encoders.")) else
          f"model.diffusion_model.{k}": torch.from_numpy(np.ascontiguousarray(v, np.float32))
          for k, v in _to_sgm(params).items()}
    sd.update(extra)
    return sd


@pytest.mark.parametrize("qk_norm", [False, True])
def test_convert_mmdit_matches_the_jax_converter(qk_norm):
    jmod = jmmdit.MMDiT(**TINY, qk_norm=qk_norm)
    params = _params(jmod, seed=2)
    sd = _sd3_file(params)
    jparams = jax_convert_mmdit({k: v.numpy() for k, v in sd.items()},
                                jax.tree.map(np.asarray, params))
    want = _jax_apply(jmod, jparams)
    tmod = tmmdit.MMDiT(**TINY, qk_norm=qk_norm)
    tmod.load_state_dict(convert_mmdit(sd, tmod))
    assert _rel(_torch_apply(tmod.eval()), want) <= F32
    # the MMDiT's own keys (a port file) pass through unchanged
    own = tmod.state_dict()
    assert convert_mmdit(own, tmod).keys() == own.keys()


def test_convert_mmdit_refuses_attn2_and_a_missing_tensor():
    jmod = jmmdit.MMDiT(**TINY)
    tmod = tmmdit.MMDiT(**TINY)
    sd = _sd3_file(_params(jmod, seed=3))
    with pytest.raises(ValueError, match="attn2"):
        convert_mmdit({**sd, "model.diffusion_model.joint_blocks.0.x_block.attn2.qkv.weight":
                       torch.zeros(3, 3)}, tmod)
    del sd["model.diffusion_model.joint_blocks.1.x_block.mlp.fc1.weight"]
    with pytest.raises(ValueError, match="unfilled"):
        convert_mmdit(sd, tmod)
    with pytest.raises(ValueError, match="unrecognised"):
        convert_mmdit({**tmod.state_dict(), "joint_blocks.0.x_block.extra": torch.zeros(1)}, tmod)


def test_convert_sd3_vae_splits_the_bundle():
    vae = AutoencoderKL(embed_dim=3, z_channels=3, ch=32, ch_mult=(1,), num_res_blocks=1)
    own = {k: torch.randn_like(v) for k, v in vae.state_dict().items()}
    bundle = {**{f"first_stage_model.{k}": v for k, v in own.items()},
              "model.diffusion_model.x_embedder.proj.weight": torch.zeros(1),
              "text_encoders.clip_l.logit_scale": torch.zeros(())}
    for sd in (bundle, own):
        got = convert_sd3_vae(sd, vae)
        assert got.keys() == own.keys() and all(torch.equal(got[k], own[k]) for k in own)
    # SD3's released VAE has no quant convolutions, which AutoencoderKL builds
    no_quant = {k: v for k, v in own.items() if "quant_conv" not in k}
    with pytest.raises(ValueError, match="unfilled"):
        convert_sd3_vae(no_quant, vae)


@pytest.mark.parametrize("kw", [dict(), dict(img_size=8, channels=16, n=10, context_len=6,
                                             context_dim=16, pooled_dim=12, n_classes=3, seed=4)])
def test_synthetic_embedded_is_the_jax_package_s(kw):
    from dmtpu.data.captioned import SyntheticEmbedded as JaxSyntheticEmbedded
    from dmtpu_torch.data.captioned import SyntheticEmbedded

    want, got = JaxSyntheticEmbedded(**kw), SyntheticEmbedded(**kw)
    assert len(got) == len(want)
    for i in (0, len(want) - 1):
        w, g = want[i], got[i]
        assert sorted(g) == sorted(w) == ["context", "image", "pooled"]
        for k in w:
            assert g[k].dtype == np.float32 and g[k].tobytes() == w[k].tobytes()
