"""dmtpu_torch's ILVR and CLIPGuidance against dmtpu's, in f32 on the CPU.

ILVR: the low-pass filter on the same images, and a DDPM sampling run in
which the port is handed the very noise arrays the JAX loop drew (its key
split as the JAX loop splits it, the port's ``_randn`` patched to hand them
out in order: each step's reverse noise, then the reference's).  CLIP
guidance: ``cond_fn_mean`` with injected linear feature functions against the
JAX package's, and the ``clip_pretrained`` branch on the tiny CLIP of
``tests/_tiny_fixtures.py::make_tiny_clip_dir``, whose Flax weights the test
helper carries into torch's ``CLIPModel`` (``transformers``' Flax-to-torch
loader, then ``save_pretrained``): text and image features and one guided step against
``FlaxCLIPModel``.  Tolerances: 1e-5 (f32 rounding order over a few
steps); the CLIP towers 1e-4 relative (two frameworks' f32 transformers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions.guidance import ILVR as JaxILVR
from dmtpu.diffusions.guidance.clip_guidance import CLIPGuidance as JaxCLIPGuidance
from dmtpu_torch.diffusions import DDPM
from dmtpu_torch.diffusions import ddpm as tddpm
from dmtpu_torch.diffusions.guidance import ILVR, CLIPGuidance
from dmtpu_torch.diffusions.guidance import ilvr as tilvr
from dmtpu_torch.diffusions.guidance.clip_guidance import _bilinear
from tests._torch_helpers import nhwc, t

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(total_steps=100, respace_type="uniform", respace_steps=6, var_type="fixed_small")


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _images(b, c, s, seed):
    return (np.random.RandomState(seed).rand(b, c, s, s).astype(np.float32) * 2 - 1)


# ---- ILVR ---------------------------------------------------------------------
@pytest.mark.parametrize("factor,method,size", [(2, "cubic", 16), (4, "cubic", 16),
                                                (8, "lanczos3", 32), (4, "linear", 24),
                                                (2, "box", 8), (4, "lanczos2", 16)])
def test_low_pass_filter_matches_jax(factor, method, size):
    x = _images(2, 3, size, seed=factor)
    got = ILVR(downsample_factor=factor, interp_method=method, **KW).low_pass_filter(t(x))
    want = JaxILVR(downsample_factor=factor, interp_method=method, **KW).low_pass_filter(
        jnp.asarray(nhwc(x)))
    assert got.shape == x.shape
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **TOL)


def _jax_model(x, tt, **kw):
    return 0.3 * x + jnp.asarray(tt, jnp.float32)[:, None, None, None] / 200.0


def _torch_model(x, tt, **kw):
    return 0.3 * x + tt.float()[:, None, None, None] / 200.0


def _feed(monkeypatch, arrays):
    """The port's ``_randn`` hands out ``arrays`` (NHWC, as JAX drew them) in order."""
    queue = [t(nchw(a)) for a in arrays]

    def fake(like, generator):
        out = queue.pop(0)
        assert out.shape == like.shape
        return out

    monkeypatch.setattr(tddpm, "_randn", fake)
    monkeypatch.setattr(tilvr, "_randn", fake)
    return queue


def test_ilvr_sampling_matches_jax_on_the_same_draws(monkeypatch):
    refs, x = _images(2, 3, 16, seed=1), np.random.RandomState(2).randn(2, 3, 16, 16)
    x = x.astype(np.float32)
    jd = JaxILVR(jnp.asarray(nhwc(refs)), downsample_factor=4, **KW)
    key = jax.random.PRNGKey(7)
    want, wys = jd.sample_loop(_jax_model, jnp.asarray(nhwc(x)), key, collect=("sample",))
    # the JAX loop: keys (n, 2); row i's step draws from key[i, 0], its guidance
    # from key[i, 1] split in 4, the sample hook from the fourth
    steps = len(jd.respaced_seq)
    keys = jax.random.split(key, (steps, 2))
    noise = []
    for i in range(steps):
        noise += [jax.random.normal(keys[i, 0], nhwc(x).shape, jnp.float32),
                  jax.random.normal(jax.random.split(keys[i, 1], 4)[3], nhwc(x).shape,
                                    jnp.float32)]
    queue = _feed(monkeypatch, noise)
    td = ILVR(downsample_factor=4, **KW)
    td.set_ref_images(t(refs))
    got, gys = td.sample_loop(_torch_model, t(x), None, collect=("sample",))
    assert not queue
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **TOL)
    np.testing.assert_allclose(gys["sample"].permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(wys["sample"]), **TOL)
    # the sample's low frequencies are the reference's, far more than an
    # unguided sample's from the same noise
    lp = td.low_pass_filter
    monkeypatch.undo()
    plain = DDPM(**KW).sample(_torch_model, t(x), torch.Generator().manual_seed(0))
    guided_gap = float((lp(got) - lp(t(refs))).norm() / lp(t(refs)).norm())
    plain_gap = float((lp(plain) - lp(t(refs))).norm() / lp(t(refs)).norm())
    assert guided_gap < 0.2 * plain_gap, (guided_gap, plain_gap)


def test_ilvr_without_references_raises():
    with pytest.raises(RuntimeError, match="set_ref_images"):
        ILVR(**KW).sample(_torch_model, torch.zeros(1, 3, 8, 8))


# ---- CLIP guidance: injected feature functions -------------------------------------
@pytest.mark.parametrize("size,image_size", [(8, 8), (8, 12), (16, 8)])
def test_clip_cond_fn_mean_matches_jax(size, image_size):
    """The delta is w·sqrt(1/ᾱ)·var·resize(dL/d pixel_values) in both, with
    the resizes up and down (JAX's antialiased bilinear against
    ``F.interpolate(..., antialias=True)``)."""
    rs = np.random.RandomState(size + image_size)
    W = rs.randn(3 * image_size * image_size, 4).astype(np.float32)
    v = rs.randn(1, 4).astype(np.float32)
    x0 = _images(2, 3, size, seed=5)
    common = dict(guidance_weight=2.0, image_size=image_size, tokenizer=object(),
                  total_steps=10)
    jg = JaxCLIPGuidance(text_features_fn=lambda i, m: None,
                         image_features_fn=lambda px: px.reshape(px.shape[0], -1) @ W, **common)
    jg.set_text_embed(jnp.asarray(v))
    tg = CLIPGuidance(text_features_fn=lambda i, m: None,
                      image_features_fn=lambda px: px.reshape(px.shape[0], -1) @ t(W), **common)
    tg.set_text_embed(t(v))
    want = jg.cond_fn_mean({"pred_x0": jnp.asarray(nhwc(x0)), "var": jnp.float32(0.25)},
                           jnp.asarray(nhwc(x0)), {"sqrt_recip_ac": jnp.float32(1.5)},
                           jax.random.PRNGKey(0))
    with torch.no_grad():  # as inside a sampler: the hook opens autograd itself
        got = tg.cond_fn_mean({"pred_x0": t(x0), "var": 0.25}, t(x0), {"sqrt_recip_ac": 1.5},
                              None)
    assert got.shape == x0.shape and not got.requires_grad
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("src,dst", [(256, 224), (64, 224), (224, 256)])
def test_the_clip_resize_is_jax_s_bilinear(src, dst):
    x = np.random.RandomState(src).randn(2, 3, src, src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(nhwc(x)), (2, dst, dst, 3), "bilinear")
    got = _bilinear(t(x), (dst, dst))
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), rtol=0, atol=1e-5)


def test_clip_guidance_needs_a_text():
    g = CLIPGuidance(text_features_fn=lambda i, m: None, image_features_fn=lambda px: px,
                     tokenizer=object(), total_steps=10)
    with pytest.raises(RuntimeError, match="set_text"):
        g.cond_fn_mean({"pred_x0": torch.zeros(1, 3, 8, 8), "var": 1.0},
                       torch.zeros(1, 3, 8, 8), {"sqrt_recip_ac": 1.0}, None)


# ---- CLIP guidance: a local CLIP directory ------------------------------------------
@pytest.fixture(scope="module")
def clip_dirs(tmp_path_factory):
    """(the Flax tiny CLIP directory, the same weights saved by torch's CLIPModel)."""
    from transformers import CLIPConfig, CLIPModel, CLIPTokenizer
    from transformers.modeling_flax_pytorch_utils import load_flax_checkpoint_in_pytorch_model

    from tests._tiny_fixtures import make_tiny_clip_dir

    root = tmp_path_factory.mktemp("clip")
    flax_dir = make_tiny_clip_dir(root / "flax")
    torch_dir = str(root / "torch")
    # (``from_pretrained(..., from_flax=True)`` of this transformers loads onto
    # the meta device and cannot save: the weights are carried over by hand)
    model = CLIPModel(CLIPConfig.from_pretrained(flax_dir))
    load_flax_checkpoint_in_pytorch_model(model, f"{flax_dir}/flax_model.msgpack")
    model.save_pretrained(torch_dir)
    CLIPTokenizer.from_pretrained(flax_dir).save_pretrained(torch_dir)
    return flax_dir, torch_dir


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_clip_pretrained_branch_matches_flax_clip(clip_dirs):
    flax_dir, torch_dir = clip_dirs
    kw = dict(guidance_weight=5.0, image_size=64, total_steps=10)
    jg = JaxCLIPGuidance(clip_pretrained=flax_dir, **kw)
    tg = CLIPGuidance(clip_pretrained=torch_dir, device="cpu", **kw)
    for g in (jg, tg):
        g.set_text("a cat")
    assert tuple(tg.text_embed.shape) == (1, 16)
    assert abs(float(torch.linalg.norm(tg.text_embed)) - 1.0) < 1e-5
    assert _rel(tg.text_embed.numpy(), jg.text_embed) < 1e-4
    # image features of the same preprocessed pixels
    x0 = _images(2, 3, 32, seed=9)
    px_j = jg._preprocess(jnp.asarray(nhwc(x0)))
    px_t = tg._preprocess(t(x0))
    np.testing.assert_allclose(px_t.numpy(), np.asarray(px_j), rtol=0, atol=1e-4)
    with torch.no_grad():
        feats_t = tg._image_features(px_t)
    assert _rel(feats_t.numpy(), jg._image_features_raw(px_j)) < 1e-4
    # one guided step of the DDPM loop, on the same reverse noise
    row = tg.tape_rows(tg.sampler_tape())[3]
    jrow = {k: jnp.asarray(v[3]) for k, v in jg.sampler_tape().items()}
    x = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    eps = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    out_j = jg.denoise_step(jnp.asarray(nhwc(0.1 * x)), jnp.asarray(nhwc(x)), jrow,
                            jax.random.PRNGKey(0))
    want = jg.apply_guidance({**out_j, "reverse_eps": jnp.asarray(nhwc(eps))},
                             jnp.asarray(nhwc(x)), jrow, jax.random.PRNGKey(1))
    out_t = tg.denoise_step(t(0.1 * x), t(x), row, torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = tg.apply_guidance({**out_t, "reverse_eps": t(eps)}, t(x), row, None)
    delta = nhwc((got["mean"] - out_t["mean"]).numpy())
    assert np.abs(delta).max() > 0
    assert _rel(delta, np.asarray(want["mean"] - out_j["mean"])) < 1e-4
    assert _rel(nhwc(got["sample"].numpy()), want["sample"]) < 1e-5


def test_clip_guided_sampling_from_a_local_directory_shifts_the_trajectory(clip_dirs):
    _, torch_dir = clip_dirs
    init = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 8, 8).astype(np.float32))

    def run(weight):
        g = CLIPGuidance(guidance_weight=weight, clip_pretrained=torch_dir, image_size=64,
                         total_steps=10)
        g.set_text("a cat")
        with torch.no_grad():
            out = g.sample(lambda x, tt, **kw: 0.05 * x, init, torch.Generator().manual_seed(0))
        assert out.shape == init.shape and bool(out.isfinite().all())
        return out

    # the tiny random CLIP moves an 8x8 sample by about 4e-8 a unit of weight
    assert float((run(1e4) - run(0.0)).abs().max()) > 1e-4
