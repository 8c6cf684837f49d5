"""dmtpu_torch's DiT, MDTv2 and latent wrapper against dmtpu's, on the CPU.

The same numpy-seeded inputs go through the JAX module and its port; the
JAX params are seeded random (``jax_random_params``: no layer is zero) and
carried by the param bridge.  Sizes are small, one DiT case at hidden 144
with 2 heads, so that attention runs at head dim 72 (DiT-XL/2's).
Tolerances, relative L2: f32 1e-5 (sums in another order), bf16 2e-2 (the
torso's rounding at other places in the two frameworks).  The requests
(DDIMCFG, and DDPMCFG with a learned variance, each through the VAE decode)
run both samplers on the same starting noise and, for DDPM, on JAX's
per-step noise, and are held to 1e-5 as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.convert.zoo import convert_dit, convert_mdt
from dmtpu.diffusions import DDIMCFG as JaxDDIMCFG
from dmtpu.diffusions import DDPMCFG as JaxDDPMCFG
from dmtpu.models import dit as jdit
from dmtpu.models import mdt as jmdt
from dmtpu.models.latent import LatentDiffusionWrapper as JaxWrapper
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.diffusions import DDIMCFG, DDPMCFG
from dmtpu_torch.diffusions import ddpm as tddpm
from dmtpu_torch.models import dit as tdit
from dmtpu_torch.models import mdt as tmdt
from dmtpu_torch.models.latent import LatentDiffusionWrapper, PretrainedVAE
from dmtpu_torch.utils.config import instantiate_from_config
from tests._tiny_fixtures import _tiny_sd_model
from tests._torch_helpers import jax_random_params, nhwc, t
from tests.test_dit_mdt import dit_state_dict, mdt_state_dict
from tests.test_torch_vae import _diffusers_keys

F32, BF16 = 1e-5, 2e-2
DIT_SMALL = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=2,
                 num_heads=4, num_classes=5)
DIT_D72 = dict(DIT_SMALL, hidden_size=144, num_heads=2)  # head dim 72
MDT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=6, num_heads=4,
           num_classes=5, decode_layer=2, mask_ratio=0.3)
X = np.random.RandomState(0).randn(2, 4, 8, 8).astype(np.float32)
TS, YS = np.array([3, 700]), np.array([1, 4])


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _params(jmod, seed=0):
    return jax_random_params(jmod, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1,), jnp.int32), seed=seed)


def _jax_apply(jmod, params, x, ts, ys, **kw):
    return np.asarray(jmod.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(ts),
                                 jnp.asarray(ys), **kw)).astype(np.float32)


def _torch_apply(tmod, x, ts, ys, **kw):
    with torch.no_grad():
        return nhwc(tmod(t(x), torch.from_numpy(ts), torch.from_numpy(ys), **kw).float().numpy())


# ---- DiT ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,tol", [(None, F32), ("bfloat16", BF16)], ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [DIT_SMALL, DIT_D72], ids=["d8", "d72"])
def test_dit_matches(cfg, dtype, tol):
    jmod = jdit.DiT(**cfg, dtype=None if dtype is None else jnp.bfloat16)
    params = _params(jmod)
    want = _jax_apply(jmod, params, X, TS, YS)
    tmod = load_flax_params(tdit.DiT(**cfg, dtype=dtype), params).eval()
    got = _torch_apply(tmod, X, TS, YS)
    assert got.shape == (2, 8, 8, 8) and _rel_l2(got, want) <= tol
    if dtype is not None:
        # the torso computes in bf16 from f32 parameters; the head in f32
        assert all(p.dtype == torch.float32 for p in tmod.parameters())
        with torch.no_grad():
            tokens, c = tmod.embed(t(X), torch.from_numpy(TS), torch.from_numpy(YS))
            assert tokens.dtype == torch.bfloat16 and c.dtype == torch.float32
            assert tmod.head(tokens, c).dtype == torch.float32


def test_dit_forward_with_cfg_matches():
    jmod = jdit.DiT(**DIT_D72)
    params = _params(jmod, seed=1)
    x = np.concatenate([X, X[::-1]])
    ts, ys = np.array([500] * 4), np.array([1, 2, 5, 5])
    want = _jax_apply(jmod, params, x, ts, ys, method=jmod.forward_with_cfg, cfg_scale=4.0)
    tmod = load_flax_params(tdit.DiT(**DIT_D72), params).eval()
    with torch.no_grad():
        got = tmod.forward_with_cfg(t(x), torch.from_numpy(ts), torch.from_numpy(ys), 4.0)
    assert _rel_l2(nhwc(got.numpy()), want) <= F32
    # the guided halves are the same; the rest is each half's own
    assert torch.equal(got[:2, :3], got[2:, :3]) and not torch.equal(got[:2, 3:], got[2:, 3:])


@pytest.mark.parametrize("offset", [0, 3])
def test_pos_embed_table_matches_and_is_not_shared(offset):
    want = jdit.get_2d_sincos_pos_embed(72, 4, offset)
    got = tdit.get_2d_sincos_pos_embed(72, 4, offset=offset)
    assert got.dtype == np.float64 and got.shape == (16, 72)
    np.testing.assert_array_equal(got, want)
    got[:] = 0  # a caller's copy: the next call is not affected
    np.testing.assert_array_equal(tdit.get_2d_sincos_pos_embed(72, 4, offset=offset), want)
    # the table is the centre crop of a larger one
    base = tdit.get_2d_sincos_pos_embed(72, 4 + 2 * offset)
    crop = base.reshape(4 + 2 * offset, 4 + 2 * offset, 72)[offset:offset + 4, offset:offset + 4]
    np.testing.assert_allclose(crop.reshape(16, 72), want, atol=1e-12)


def test_pos_embed_is_a_buffer_of_each_module_outside_the_state_dict():
    a, b = tdit.DiT(**DIT_SMALL), tdit.DiT(**DIT_SMALL)
    assert "pos_embed" not in a.state_dict() and "pos_embed" in dict(a.named_buffers())
    assert a.pos_embed.data_ptr() != b.pos_embed.data_ptr()
    a.pos_embed.zero_()
    assert b.pos_embed.abs().sum() > 0


def test_y_none_needs_the_null_row():
    x, ts = t(X), torch.from_numpy(TS)
    with pytest.raises(ValueError, match="null-label row"):
        tdit.DiT(**DIT_SMALL, class_dropout_prob=0.0)(x, ts)
    assert tdit.DiT(**DIT_SMALL, class_dropout_prob=0.0).y_embedder.embedding_table.num_embeddings == 5
    m = tdit.DiT(**DIT_SMALL).eval()
    for p in m.parameters():  # no zero layer: the label must show in the output
        torch.nn.init.normal_(p, std=0.2)
    with torch.no_grad():
        null = torch.full((2,), 5)
        assert torch.equal(m(x, ts), m(x, ts, null)) and not torch.equal(m(x, ts), m(x, ts, t(YS)))


def test_class_dropout_draws_from_the_generator():
    m = tdit.DiT(**DIT_SMALL, class_dropout_prob=0.5)
    x, ts, ys = t(np.repeat(X, 32, 0)), torch.zeros(64, dtype=torch.long), torch.zeros(64).long()

    def labels(seed, train=True):
        with torch.no_grad():
            return m.embed(x, ts, ys, train=train,
                           drop_generator=torch.Generator().manual_seed(seed))[1]

    a, b, c = labels(0), labels(0), labels(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        te, table = m.t_embedder(ts), m.y_embedder.embedding_table.weight
        dropped = torch.isclose(a, te + table[5]).all(-1)
        kept = torch.isclose(a, te + table[0]).all(-1)
    assert torch.equal(dropped, ~kept) and 8 < int(dropped.sum()) < 56  # about half of 64
    assert torch.equal(labels(0, train=False), labels(1, train=False))


def test_remat_gives_the_same_output_and_gradients():
    a = tdit.DiT(**DIT_D72)
    b = tdit.DiT(**DIT_D72, use_checkpoint=True)
    for p in a.parameters():
        torch.nn.init.normal_(p, std=0.1)
    b.load_state_dict(a.state_dict())
    grads = []
    for m in (a, b):
        m(t(X), torch.from_numpy(TS), torch.from_numpy(YS)).square().mean().backward()
        grads.append([p.grad for p in m.parameters()])
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-7)
    # a policy name is ported (tests/test_torch_remat.py); an unknown one raises
    assert tdit.DiT(**DIT_SMALL, use_checkpoint="dots").use_checkpoint is True
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        tdit.DiT(**DIT_SMALL, use_checkpoint="dot")


def test_dit_configs_and_factory():
    assert tdit.DIT_CONFIGS == jdit.DIT_CONFIGS
    m = tdit.dit_model("DiT-S/8", input_size=16, depth=1)
    assert (m.hidden_size, m.patch_size, len(m.blocks), m.num_heads) == (384, 8, 1, 6)
    keys = set(tdit.dit_model("DiT-S/8", input_size=16, depth=1).state_dict())
    assert {"x_embedder.proj.weight", "t_embedder.mlp.0.weight", "t_embedder.mlp.2.bias",
            "y_embedder.embedding_table.weight", "blocks.0.attn.qkv.weight",
            "blocks.0.adaLN_modulation.1.weight", "final_layer.linear.weight",
            "final_layer.adaLN_modulation.1.bias"} <= keys
    # adaLN-Zero: the modulations and the final linear start at zero
    assert not m.blocks[0].adaLN_modulation[1].weight.any() and not m.final_layer.linear.weight.any()


def test_upstream_dit_state_dict_loads_as_convert_dit():
    sd = dit_state_dict(hidden=144, depth=2, heads=2, p=2, cin=4, classes=5, grid=4)
    jmod = jdit.DiT(**DIT_D72)
    init = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    jparams = convert_dit(sd, init)
    tmod = tdit.DiT(**DIT_D72).eval()
    with pytest.raises(RuntimeError, match="pos_embed"):
        tmod.load_state_dict({k: t(v) for k, v in sd.items()})
    assert tmod.load_upstream(sd) is tmod
    want_sd = state_dict_from_flax(jparams)
    assert sorted(want_sd) == sorted(tmod.state_dict())
    assert all(torch.equal(want_sd[k], v) for k, v in tmod.state_dict().items())
    assert _rel_l2(_torch_apply(tmod, X, TS, YS), _jax_apply(jmod, jparams, X, TS, YS)) <= F32


# ---- MDTv2 ------------------------------------------------------------------------
def _feed_uniform(monkeypatch, arrays):
    queue = [torch.from_numpy(np.array(a)) for a in arrays]

    def fake(shape, generator, device):
        out = queue.pop(0)
        assert tuple(out.shape) == tuple(shape)
        return out

    monkeypatch.setattr(tmdt, "_uniform", fake)
    return queue


@pytest.mark.parametrize("masked,dtype,tol", [(False, None, F32), (True, None, F32),
                                              (False, "bfloat16", BF16)],
                         ids=["f32", "f32-ids_keep", "bf16"])
def test_mdt_matches(monkeypatch, masked, dtype, tol):
    jmod = jmdt.MDTv2(**MDT, dtype=None if dtype is None else jnp.bfloat16)
    params = _params(jmod, seed=2)
    kw = {}
    if masked:
        key, len_keep = jax.random.PRNGKey(7), jmdt.sample_len_keep(16, 0.3, 0.4)
        assert len_keep == tmdt.sample_len_keep(16, 0.3, 0.4) < 16
        want = _jax_apply(jmod, params, X, TS, YS, enable_mask=True, len_keep=len_keep,
                          mask_rng=key)
        queue = _feed_uniform(monkeypatch, [jax.random.uniform(key, (2, 16))])
        kw = dict(enable_mask=True, len_keep=len_keep)
    else:
        want = _jax_apply(jmod, params, X, TS, YS)
    tmod = load_flax_params(tmdt.MDTv2(**MDT, dtype=dtype), params).eval()
    got = _torch_apply(tmod, X, TS, YS, **kw)
    assert got.shape == (2, 8, 8, 8) and _rel_l2(got, want) <= tol
    if masked:
        assert not queue
        # the side interpolater changes the output against the unmasked pass
        assert _rel_l2(_torch_apply(tmod, X, TS, YS), got) > 1e-3


@pytest.mark.parametrize("scale", [None, 4.0])
def test_mdt_forward_with_cfg_matches(scale):
    jmod = jmdt.MDTv2(**MDT)
    params = _params(jmod, seed=3)
    x = np.concatenate([X, X[::-1]])
    ts, ys = np.array([100, 900, 100, 900]), np.array([1, 2, 5, 5])
    want = _jax_apply(jmod, params, x, ts, ys, method=jmod.forward_with_cfg, cfg_scale=scale,
                      diffusion_steps=1000)
    tmod = load_flax_params(tmdt.MDTv2(**MDT), params).eval()
    with torch.no_grad():
        got = tmod.forward_with_cfg(t(x), torch.from_numpy(ts), torch.from_numpy(ys), scale)
    assert _rel_l2(nhwc(got.numpy()), want) <= F32


def test_mdt_helpers_match():
    np.testing.assert_array_equal(tmdt._relative_position_index(5),
                                  jmdt._relative_position_index(5))
    for u in np.linspace(0, 0.999, 23):
        assert tmdt.sample_len_keep(256, 0.3, u) == jmdt.sample_len_keep(256, 0.3, u)
    # an upstream MDT checkpoint's index buffers are rebuilt, not loaded
    m = tmdt.MDTv2(**MDT)
    assert not any(k.endswith("relative_position_index") for k in m.state_dict())
    assert {"pos_embed", "decoder_pos_embed", "mask_token",
            "en_outblocks.0.skip_linear.weight", "sideblocks.0.attn.qkv.weight",
            "de_blocks.1.attn.rel_pos_bias.relative_position_bias_table"} <= set(m.state_dict())


def test_upstream_mdt_state_dict_loads_as_convert_mdt():
    sd = mdt_state_dict(hidden=32, depth=6, heads=4, p=2, cin=4, classes=5, grid=4,
                        decode_layer=2)
    for k in list(sd):
        if k.endswith("relative_position_bias_table"):
            sd[k.replace("bias_table", "index")] = jmdt._relative_position_index(4)
    jmod = jmdt.MDTv2(**MDT)
    init = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    jparams = convert_mdt(sd, init)
    tmod = tmdt.MDTv2(**MDT).eval()
    with pytest.raises(RuntimeError, match="relative_position_index"):
        tmod.load_state_dict({k: t(v) for k, v in sd.items()})
    assert tmod.load_upstream(sd) is tmod
    want_sd = state_dict_from_flax(jparams)
    assert sorted(want_sd) == sorted(tmod.state_dict())
    assert all(torch.equal(want_sd[k], v) for k, v in tmod.state_dict().items())
    assert _rel_l2(_torch_apply(tmod, X, TS, YS), _jax_apply(jmod, jparams, X, TS, YS)) <= F32


# ---- the latent wrapper and the requests -------------------------------------------
WRAPPER = {
    "vae_config": {"target": "models.dit.autoencoder.AutoEncoderKL",
                   "params": _tiny_sd_model()["params"]["vae_config"]["params"]},
    "vit_config": {"target": "models.dit.model.DiT", "params": DIT_D72},
}


@pytest.fixture(scope="module")
def wrappers():
    """(JAX wrapper, its params, the port's wrapper with them)."""
    jw = JaxWrapper(**WRAPPER)
    vae_params = jax_random_params(jw.vae, jnp.zeros((1, 64, 64, 3)), jnp.zeros((2,), jnp.uint32),
                                   seed=5)
    params = {"vit": _params(jw.vit, seed=4), "vae": vae_params}
    tw = instantiate_from_config({"target": "models.dit.dit.DiT", "params": WRAPPER}).eval()
    assert isinstance(tw, LatentDiffusionWrapper) and isinstance(tw.vit, tdit.DiT)
    load_flax_params(tw.vit, params["vit"])
    load_flax_params(tw.vae, params["vae"])
    return jw, params, tw


def test_wrapper_decode_latent_and_forward_match(wrappers):
    jw, params, tw = wrappers
    z = np.random.RandomState(3).randn(2, 4, 8, 8).astype(np.float32)
    want = np.asarray(jw.decode_latent(params, jnp.asarray(nhwc(z))))
    with torch.no_grad():
        got = tw.decode_latent(t(z))
        assert got.shape == (2, 3, 64, 64)
        assert _rel_l2(nhwc(got.numpy()), want) <= F32
        fwd = tw.make_model_fn()(t(X), torch.from_numpy(TS), y=torch.from_numpy(YS), other=1)
        assert torch.equal(fwd, tw(t(X), torch.from_numpy(TS), torch.from_numpy(YS)))
    want = np.asarray(jw.vit_forward(params, jnp.asarray(nhwc(X)), jnp.asarray(TS),
                                     jnp.asarray(YS)))
    assert _rel_l2(nhwc(fwd.numpy()), want) <= F32
    vae = PretrainedVAE("stabilityai/sd-vae-ft-ema", ch=32, ch_mult=(1, 1), num_res_blocks=1)
    assert vae.from_pretrained == "stabilityai/sd-vae-ft-ema"


def test_wrapper_loads_an_upstream_vit_and_a_diffusers_vae(wrappers):
    jw, params, tw = wrappers
    vit_sd = {k: v.numpy() for k, v in tw.vit.state_dict().items()}
    vit_sd["pos_embed"] = jdit.get_2d_sincos_pos_embed(144, 4)[None]
    compvis = {k: v.numpy() for k, v in tw.vae.state_dict().items()}
    diffusers = _diffusers_keys(compvis, 4, legacy=False)
    assert set(diffusers) != set(compvis)
    fresh = instantiate_from_config({"target": "models.dit.dit.DiT", "params": WRAPPER})
    assert fresh.load_state_dict(vit_sd, vae_sd=diffusers) is fresh
    for k, v in tw.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # the JAX wrapper's loader gives the same parameters
    jparams = jw.load_state_dict(vit_sd, diffusers)
    for part in ("vit", "vae"):
        got = getattr(fresh, part).state_dict()
        assert all(torch.equal(got[k], v) for k, v in state_dict_from_flax(jparams[part]).items())
    # the wrapper's own layout loads as any module's
    again = instantiate_from_config({"target": "models.dit.dit.DiT", "params": WRAPPER})
    again.load_state_dict(tw.state_dict())
    assert torch.equal(again.vit.final_layer.linear.weight, tw.vit.final_layer.linear.weight)


def _cfg_request(wrappers, jax_sampler, torch_sampler, monkeypatch, steps_noise):
    jw, params, tw = wrappers
    noise = np.random.RandomState(4).randn(2, 4, 8, 8).astype(np.float32)
    y, null = np.array([2, 3]), np.array([5, 5])
    key = jax.random.PRNGKey(9)
    z = jax_sampler.sample(jw.make_model_fn(params), jnp.asarray(nhwc(noise)), key,
                           uncond_conditioning=jnp.asarray(null), model_kwargs=dict(y=jnp.asarray(y)))
    want = np.asarray(jw.decode_latent(params, z))
    queue = []
    if steps_noise:
        # the JAX loop splits its key (steps, 2) and row i's step draws from key[i, 0]
        steps = len(jax_sampler.respaced_seq)
        keys = jax.random.split(key, (steps, 2))
        queue = [t(np.transpose(np.asarray(jax.random.normal(keys[i, 0], nhwc(noise).shape)),
                                (0, 3, 1, 2))) for i in range(steps)]

        def fake(like, generator):
            out = queue.pop(0)
            assert out.shape == like.shape
            return out

        monkeypatch.setattr(tddpm, "_randn", fake)
    with torch.no_grad():
        zt = torch_sampler.sample(tw.make_model_fn(), t(noise), None,
                                  uncond_conditioning=torch.from_numpy(null),
                                  model_kwargs=dict(y=torch.from_numpy(y)))
        got = nhwc(tw.decode_latent(zt).numpy())
    assert not queue
    return got, want


def test_ddimcfg_request_matches(wrappers, monkeypatch):
    kw = dict(total_steps=100, respace_type="uniform", respace_steps=4)
    got, want = _cfg_request(wrappers, JaxDDIMCFG(4.0, "y", **kw), DDIMCFG(4.0, "y", **kw),
                             monkeypatch, steps_noise=False)
    assert got.shape == (2, 64, 64, 3) and _rel_l2(got, want) <= F32


def test_ddpmcfg_learned_range_request_matches_on_jax_noise(wrappers, monkeypatch):
    kw = dict(total_steps=100, respace_type="uniform", respace_steps=4, var_type="learned_range")
    got, want = _cfg_request(wrappers, JaxDDPMCFG(4.0, "y", **kw), DDPMCFG(4.0, "y", **kw),
                             monkeypatch, steps_noise=True)
    assert _rel_l2(got, want) <= F32
