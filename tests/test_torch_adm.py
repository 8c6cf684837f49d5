"""dmtpu_torch's ADM family against dmtpu's, on the CPU.

``AttentionBlock`` in both qkv orders, ``AttentionPool2d``, ``UNetModel``
(scale-shift norm, ResBlock resampling, classes, ``num_heads_upsample``,
learned variance, remat), ``SuperResModel``, ``EncoderUNetModel`` (every
pool), ``UNetCombined`` with ``forward_cfg`` and the combining of two
upstream state dicts, and ``SDUNetModel``'s ADM-attention path.  The JAX
params are seeded random (``jax_random_params``: no zero layer) and carried
by the param bridge; the other direction holds the port's state dict, in
upstream keys, against the JAX package's own torch-file converter
(``convert_by_structure``, ``combine_adm_weights``), which fills every JAX
leaf from it.  On the CPU both packages run the plain ``mha`` in these
attention layers (on the card the port runs K1).  Narrow sizes (32 and 64
channels, 8x8 and 16x16 images).  Tolerance: f32 relative L2 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.convert import convert_by_structure
from dmtpu.convert.zoo import combine_adm_weights
from dmtpu.models import adm as jadm
from dmtpu.models.stablediffusion import SDUNetModel as JaxSDUNet
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.models import adm as tadm
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.scripts._common import load_model_params
from dmtpu_torch.utils.config import instantiate_from_config
from tests._torch_helpers import TINY_SD_UNET_CFG, jax_random_params, nhwc, t

F32 = 1e-5
BASE = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
            attention_resolutions=[2], dropout=0.0, channel_mult=(1, 2), num_head_channels=16)
X = np.random.RandomState(0).randn(2, 3, 16, 16).astype(np.float32)
TS, YS = np.array([3, 777]), np.array([1, 7])


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, nchw=True):
    got = np.asarray(got)
    if got.ndim == 4 and nchw:
        got = nhwc(got)
    assert np.isfinite(got).all() and np.abs(np.asarray(want)).max() > 0
    assert _rel_l2(got, want) <= F32, _rel_l2(got, want)


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("new_order", [False, True])
@pytest.mark.parametrize("heads,head_channels", [(1, -1), (4, -1), (1, 16)])
def test_attention_block_matches_jax(new_order, heads, head_channels):
    x = np.random.RandomState(1).randn(2, 64, 4, 4).astype(np.float32)
    jmod = jadm.AttentionBlock(heads, head_channels, new_order)
    params = jax_random_params(jmod, jnp.zeros((1, 4, 4, 64)))
    tmod = load_flax_params(tadm.AttentionBlock(64, heads, head_channels, new_order), params)
    assert tmod.qkv.weight.shape == (192, 64, 1)  # the reference's conv_nd(1, ...)
    want = jmod.apply(params, jnp.asarray(nhwc(x)))
    with torch.no_grad():
        _close(tmod(t(x)).numpy(), want)


@pytest.mark.parametrize("output_dim", [None, 10])
def test_attention_pool_matches_jax(output_dim):
    x = np.random.RandomState(2).randn(2, 64, 4, 4).astype(np.float32)
    jmod = jadm.AttentionPool2d(16, output_dim)
    params = jax_random_params(jmod, jnp.zeros((1, 4, 4, 64)))
    tmod = load_flax_params(tadm.AttentionPool2d(4, 64, 16, output_dim), params)
    want = jmod.apply(params, jnp.asarray(nhwc(x)))
    with torch.no_grad():
        _close(tmod(t(x)).numpy(), want)


UNET_CASES = {
    "plain": {},
    "scale_shift_updown": dict(use_scale_shift_norm=True, resblock_updown=True),
    "new_order": dict(use_new_attention_order=True),
    "classes": dict(num_classes=10, use_scale_shift_norm=True),
    "learned_sigma": dict(out_channels=6),
    "heads_upsample": dict(num_heads=2, num_head_channels=-1, num_heads_upsample=4),
    "remat": dict(use_checkpoint=True, resblock_updown=True),
}


def _unet_args(cfg, x=X):
    y = YS if cfg.get("num_classes") else None
    jargs = (jnp.asarray(nhwc(x)), jnp.asarray(TS)) + (() if y is None else (jnp.asarray(y),))
    targs = (t(x), t(TS)) + (() if y is None else (t(y),))
    return jargs, targs


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_unet_model_matches_jax(case):
    cfg = dict(BASE, **UNET_CASES[case])
    jargs, targs = _unet_args(cfg)
    jmod = jadm.UNetModel(**cfg)
    params = jax_random_params(jmod, *(jnp.zeros((1,) + a.shape[1:], a.dtype) for a in jargs))
    tmod = load_flax_params(tadm.UNetModel(**cfg), params).eval()
    want = jmod.apply(params, *jargs)
    with torch.no_grad():
        _close(tmod(*targs).numpy(), want)
    # the port's state dict is in upstream keys: the JAX package's torch-file
    # converter fills every leaf from it, and gives the same model
    back = convert_by_structure(_numpy_sd(tmod), params)
    _close(jmod.apply(back, *jargs), want, nchw=False)


def test_unet_model_gradient_flows_through_remat():
    cfg = dict(BASE, use_checkpoint=True, dropout=0.1)
    m = tadm.UNetModel(**cfg)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.05)
    m.train()
    m(t(X), t(TS)).square().mean().backward()
    assert all(p.grad is not None for p in m.parameters())


def test_super_res_model_matches_jax():
    cfg = dict(BASE, num_res_blocks=1)
    low = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    jmod = jadm.SuperResModel(**{k: cfg[k] for k in ("image_size", "in_channels",
                                                     "model_channels", "out_channels",
                                                     "num_res_blocks", "attention_resolutions")},
                              kwargs={k: v for k, v in cfg.items() if k in (
                                  "dropout", "channel_mult", "num_head_channels")})
    params = jax_random_params(jmod, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 8, 8, 3)))
    tmod = load_flax_params(tadm.SuperResModel(**cfg), params).eval()
    assert "input_blocks.0.0.weight" in tmod.state_dict()  # upstream keys, no "unet."
    assert tmod.input_blocks[0][0].weight.shape[1] == 6
    want = jmod.apply(params, jnp.asarray(nhwc(X)), jnp.asarray(TS), jnp.asarray(nhwc(low)))
    with torch.no_grad():
        _close(tmod(t(X), t(TS), t(low)).numpy(), want)


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
def test_encoder_unet_model_matches_jax(pool):
    cfg = dict(BASE, out_channels=5, pool=pool)
    jmod = jadm.EncoderUNetModel(**cfg)
    params = jax_random_params(jmod, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32))
    tmod = load_flax_params(tadm.EncoderUNetModel(**cfg), params).eval()
    want = jmod.apply(params, jnp.asarray(nhwc(X)), jnp.asarray(TS))
    with torch.no_grad():
        got = tmod(t(X), t(TS)).numpy()
    assert got.shape == (2, 5)
    _close(got, want)
    back = convert_by_structure(_numpy_sd(tmod), params)
    _close(jmod.apply(back, jnp.asarray(nhwc(X)), jnp.asarray(TS)), want, nchw=False)


def test_unet_combined_forward_cfg_and_two_upstream_files(tmp_path):
    kw = dict(BASE, num_classes=10)
    jmod = jadm.UNetCombined(unet_kwargs=kw)
    args = (jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    params = jax_random_params(jmod, *args)
    tmod = load_flax_params(tadm.UNetCombined(kw), params).eval()
    x2 = np.concatenate([X, X[::-1]])
    ts2, ys2 = np.concatenate([TS, TS]), np.concatenate([YS, [10, 10]])
    want = jmod.apply(params, jnp.asarray(nhwc(x2)), jnp.asarray(ts2), jnp.asarray(ys2),
                      method=jadm.UNetCombined.forward_cfg)
    with torch.no_grad():
        _close(tmod.forward_cfg(t(x2), t(ts2), t(ys2)).numpy(), want)
        _close(tmod(t(X), t(TS)).numpy(),
               jmod.apply(params, jnp.asarray(nhwc(X)), jnp.asarray(TS)))
    # two upstream state dicts -> one, as the JAX package's combine_adm_weights
    cond = {k[len("unet_cond."):]: v for k, v in tmod.state_dict().items()
            if k.startswith("unet_cond.")}
    uncond = {k[len("unet_uncond."):]: v for k, v in tmod.state_dict().items()
              if k.startswith("unet_uncond.")}
    merged = tadm.UNetCombined.combine_state_dicts(cond, uncond)
    assert merged.keys() == tmod.state_dict().keys()
    back = combine_adm_weights({k: v.numpy() for k, v in cond.items()},
                               {k: v.numpy() for k, v in uncond.items()}, params)
    _close(jmod.apply(back, jnp.asarray(nhwc(X)), jnp.asarray(TS)),
           jmod.apply(params, jnp.asarray(nhwc(X)), jnp.asarray(TS)), nchw=False)
    torch.save(cond, tmp_path / "cond.pt")
    torch.save({"state_dict": uncond}, tmp_path / "uncond.pt")
    fresh = load_model_params(f"{tmp_path / 'cond.pt'},{tmp_path / 'uncond.pt'}",
                              tadm.UNetCombined(kw))
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in merged.items())


SD_ADM_CASES = {
    "spatial_off": dict(use_spatial_transformer=False),
    "heads_upsample": dict(use_spatial_transformer=False, num_heads_upsample=4),
    "new_order": dict(use_spatial_transformer=False, use_new_attention_order=True),
    "legacy_head_channels": dict(use_spatial_transformer=False, legacy=True, num_heads=-1,
                                 num_head_channels=16),
}


@pytest.mark.parametrize("case", sorted(SD_ADM_CASES))
def test_sd_unet_adm_attention_path_matches_jax(case):
    cfg = dict(TINY_SD_UNET_CFG, **SD_ADM_CASES[case])
    x = np.random.RandomState(4).randn(2, 4, 8, 8).astype(np.float32)
    ctx = np.random.RandomState(5).randn(2, 3, 24).astype(np.float32)
    jmod = JaxSDUNet(**cfg)
    params = jax_random_params(jmod, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 3, 24)))
    tmod = load_flax_params(SDUNetModel(**cfg), params).eval()
    assert isinstance(tmod.middle_block[1], tadm.AttentionBlock)
    want = jmod.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(TS), jnp.asarray(ctx))
    with torch.no_grad():
        _close(tmod(t(x), t(TS), t(ctx)).numpy(), want)


@pytest.mark.parametrize("target,cls,params", [
    ("models.adm.unet.UNetModel", tadm.UNetModel, BASE),
    ("models.adm.unet_combined.UNetCombined", tadm.UNetCombined,
     {"unet_kwargs": dict(BASE, num_classes=3)}),
    ("dmtpu.models.adm.SuperResModel", tadm.SuperResModel, BASE),
    ("dmtpu.models.adm.EncoderUNetModel", tadm.EncoderUNetModel, BASE),
])
def test_registry_builds_the_adm_models(target, cls, params):
    assert isinstance(instantiate_from_config({"target": target, "params": params},
                                              device="meta"), cls)


def test_release_fp16_means_a_bf16_torso():
    m = tadm.UNetModel(**BASE, use_fp16=True)
    assert m.torso_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        out = m(t(X), t(TS))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert jax.tree.leaves(jax_random_params(jadm.UNetModel(**BASE, use_fp16=True),
                                             jnp.zeros((1, 16, 16, 3)),
                                             jnp.zeros((1,), jnp.int32)))
