"""dmtpu_torch SD UNet parts against dmtpu's, in f32 on the CPU.

The JAX params are perturbed with seeded normals (so no zero-initialised
layer hides a mismatch) and loaded into the port through the param bridge.
Tolerance rtol/atol 3e-4, as the JAX package's own SD UNet parity test: f32
convolutions and matmuls summed in different orders through a few layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDIM as JaxDDIM
from dmtpu.models.adm import ResBlock as JaxResBlock
from dmtpu.models.stablediffusion import SDUNetModel as JaxUNet
from dmtpu.models.stablediffusion.attention import SpatialTransformer as JaxST
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.diffusions import DDIM
from dmtpu_torch.models.adm import ResBlock, timestep_embedding
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.models.stablediffusion.attention import SpatialTransformer
from dmtpu_torch.ops import plain_ops
from tests._torch_helpers import TINY_SD_UNET_CFG, nhwc, perturb, t

TOL = dict(rtol=3e-4, atol=3e-4)


def test_timestep_embedding_matches():
    from dmtpu.models.adm import timestep_embedding as jte

    ts = np.array([0, 3, 999, 500])
    for dim in (32, 33, 320):
        np.testing.assert_allclose(timestep_embedding(torch.from_numpy(ts), dim).numpy(),
                                   np.asarray(jte(jnp.asarray(ts), dim)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cin,cout,opts", [
    (64, 64, {}),
    (64, 96, {}),
    (64, 96, {"use_conv": True}),
    (64, 64, {"use_scale_shift_norm": True}),
    (64, 64, {"up": True}),
    (64, 64, {"down": True}),
])
def test_resblock_matches(cin, cout, opts):
    rs = np.random.RandomState(0)
    x = rs.randn(2, cin, 8, 8).astype(np.float32)
    emb = rs.randn(2, 40).astype(np.float32)
    jmod = JaxResBlock(cout, **opts)
    params = perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x)), jnp.asarray(emb)), 1)
    want = np.asarray(jmod.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(emb)))
    tmod = load_flax_params(ResBlock(cin, 40, cout, **opts), params)
    with torch.no_grad():
        got = tmod(t(x), t(emb)).numpy()
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("depth", [1, 2])
def test_spatial_transformer_matches(depth):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 64, 4, 4).astype(np.float32)
    ctx = rs.randn(2, 7, 24).astype(np.float32)
    jmod = JaxST(2, 32, depth=depth)
    params = perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x)), jnp.asarray(ctx)), 3)
    want = np.asarray(jmod.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(ctx)))
    tmod = load_flax_params(SpatialTransformer(64, 2, 32, depth=depth, context_dim=24), params)
    with torch.no_grad():
        got = tmod(t(x), t(ctx)).numpy()
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def _tiny_pair(seed=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 4, 8, 8).astype(np.float32)
    ts = np.array([3, 700])
    ctx = rs.randn(2, 7, 24).astype(np.float32)
    jmodel = JaxUNet(**TINY_SD_UNET_CFG)
    params = perturb(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x)), jnp.asarray(ts),
                                 jnp.asarray(ctx)), seed + 1)
    tmodel = load_flax_params(SDUNetModel(**TINY_SD_UNET_CFG), params).eval()
    return jmodel, params, tmodel, x, ts, ctx


def test_tiny_unet_matches():
    jmodel, params, tmodel, x, ts, ctx = _tiny_pair()
    want = np.asarray(jmodel.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(ts),
                                   jnp.asarray(ctx)))
    with torch.no_grad():
        got = tmodel(t(x), t(ts), t(ctx)).numpy()
    np.testing.assert_allclose(nhwc(got), want, **TOL)
    # the plain path is the same function on the CPU
    with torch.no_grad(), plain_ops():
        plain = tmodel(t(x), t(ts), t(ctx)).numpy()
    np.testing.assert_array_equal(plain, got)


def test_tiny_unet_ddim_matches():
    """A short DDIM run through the tiny UNet in both frameworks."""
    jmodel, params, tmodel, x, _, ctx = _tiny_pair(seed=6)
    kw = dict(total_steps=1000, respace_type="uniform", respace_steps=4)
    want = JaxDDIM(**kw).sample(
        lambda xx, tt: jmodel.apply(params, xx, tt, jnp.asarray(ctx)),
        jnp.asarray(nhwc(x)), jax.random.PRNGKey(0))
    with torch.no_grad():
        got = DDIM(**kw).sample(lambda xx, tt: tmodel(xx, tt, t(ctx)), t(x))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **TOL)


@pytest.mark.parametrize("opt", [
    {"use_checkpoint": "dots"}, {"use_checkpoint": "attn"}, {"use_checkpoint": "dots_no_batch"},
    {"use_checkpoint": "nothing"}, {"use_checkpoint": "everything"},
])
def test_unported_options_raise(opt):
    """The selective remat policies, once refused naming ROADMAP.md's item
    H, are ported (their gradients: ``tests/test_torch_remat.py``): each
    name builds the model with remat on under that policy, and a name that
    is not a policy raises as the JAX package's ``normalize_use_checkpoint``
    does (the SDXL options are ported: ``tests/test_torch_sdxl.py``; the
    ADM-attention path: ``test_adm_attention_options_match_jax``)."""
    cfg = dict(TINY_SD_UNET_CFG, **opt)
    model = SDUNetModel(**cfg, device="meta")
    assert model.use_checkpoint is True and model.remat_policy is not None
    cfg["use_checkpoint"] += "_unknown"
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        SDUNetModel(**cfg, device="meta")


@pytest.mark.parametrize("opt", [
    {"use_spatial_transformer": False}, {"num_heads_upsample": 4},
    {"use_new_attention_order": True}, {"use_spatial_transformer": False, "num_heads": 4},
    {"num_heads_upsample": 2, "use_new_attention_order": True},
])
def test_adm_attention_options_match_jax(opt):
    """The options that were refused before the ADM-attention path was
    ported (item M) build and run as the JAX module does."""
    from tests._torch_helpers import jax_random_params

    cfg = dict(TINY_SD_UNET_CFG, **opt)
    rs = np.random.RandomState(8)
    x, ctx = rs.randn(2, 4, 8, 8).astype(np.float32), rs.randn(2, 3, 24).astype(np.float32)
    ts = np.array([3, 700])
    jmod = JaxUNet(**cfg)
    params = jax_random_params(jmod, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 3, 24)))
    want = np.asarray(jmod.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(ts), jnp.asarray(ctx)))
    tmod = load_flax_params(SDUNetModel(**cfg), params).eval()
    with torch.no_grad():
        got = tmod(t(x), t(ts), t(ctx)).numpy()
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.mark.parametrize("opt", [{"tome_ratio": 0.5}, {"freeu": (1.1, 1.2, 0.9, 0.2)}],
                         ids=["tome_ratio", "freeu"])
def test_serving_accelerator_options_build_and_run(opt):
    """The options that switch ToMe and FreeU build a model with the same
    parameters, whose forward runs and differs from the plain model's
    (parity with the JAX module: ``tests/test_torch_accelerators.py``)."""
    _, _, plain, x, ts, ctx = _tiny_pair()
    model = SDUNetModel(**TINY_SD_UNET_CFG, **opt).eval()
    model.load_state_dict(plain.state_dict())
    with torch.no_grad():
        got, want = model(t(x), t(ts), t(ctx)), plain(t(x), t(ts), t(ctx))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert not torch.allclose(got, want, atol=1e-5)


def test_unported_forward_options_raise():
    """``y`` given to a model without ``num_classes`` raises; the DeepCache
    passes run (full: the plain output and the cache; shallow with it: the
    plain output again)."""
    model = SDUNetModel(**TINY_SD_UNET_CFG).eval()
    x, ts = torch.randn(1, 4, 8, 8), torch.zeros(1, dtype=torch.int64)
    ctx = torch.randn(1, 7, 24)
    with torch.no_grad():
        out, u = model(x, ts, ctx, dc_skip=1)
        assert torch.equal(out, model(x, ts, ctx))
        assert torch.equal(model(x, ts, ctx, dc_skip=1, dc_cached=u)[0], out)
    with pytest.raises(ValueError, match="conditioning"):
        model(x, ts, ctx, y=torch.zeros(1))


def test_torso_dtype_keeps_norms_and_embedding_f32():
    """Every parameter is f32 (as the JAX package's param_dtype); the torso's
    convolutions and dense layers compute in bf16, and the output is f32."""
    model = SDUNetModel(**TINY_SD_UNET_CFG, torso_dtype=torch.bfloat16)
    assert {v.dtype for v in model.state_dict().values()} == {torch.float32}
    torch.nn.init.normal_(model.out[2].weight, std=0.1)  # zero-initialised: no gradient past it
    seen = {}

    def record(name):
        return lambda module, args, out: seen.__setitem__(name, out.dtype)

    for name in ("input_blocks.1.0.in_layers.2",
                 "input_blocks.1.1.transformer_blocks.0.attn1.to_q",
                 "input_blocks.1.0.in_layers.0", "time_embed.0", "out.2"):
        model.get_submodule(name).register_forward_hook(record(name))
    out = model(torch.randn(1, 4, 8, 8), torch.tensor([10]), torch.randn(1, 7, 24))
    assert seen["input_blocks.1.0.in_layers.2"] == torch.bfloat16
    assert seen["input_blocks.1.1.transformer_blocks.0.attn1.to_q"] == torch.bfloat16
    assert seen["input_blocks.1.0.in_layers.0"] == torch.bfloat16  # GN keeps its input dtype
    assert seen["time_embed.0"] == torch.float32 and seen["out.2"] == torch.float32
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    out.square().mean().backward()
    grad = model.get_submodule("input_blocks.0.0").weight.grad  # reached through the skips
    assert grad.dtype == torch.float32 and grad.abs().max() > 0
