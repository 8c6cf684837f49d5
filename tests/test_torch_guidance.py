"""dmtpu_torch.diffusions.guidance against dmtpu's, in f32 on the CPU.

The two frameworks draw different random numbers, so a trajectory that needs
noise is run in the port on the very arrays JAX drew: the test splits the JAX
key as the JAX loop does and patches the port's ``_randn`` to hand them out
in order.  Tolerance rtol/atol 1e-5: f32 rounding order over a few steps.
The RePaint tapes come from the same float64 numpy code and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDIM as JaxDDIM
from dmtpu.diffusions import guidance as jg
from dmtpu_torch.diffusions import DDIM, DDIMCFG
from dmtpu_torch.diffusions import ddpm as tddpm
from dmtpu_torch.diffusions import guidance as tg
from dmtpu_torch.diffusions.guidance import mask_guidance as tmg
from tests._torch_helpers import nhwc, t

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(total_steps=100, respace_type="uniform", respace_steps=8)
HOOKS = ("cond_fn_eps", "cond_fn_x0", "cond_fn_mean", "cond_fn_sample")


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _hooked(base, sampler, active):
    """``base`` guidance over ``sampler`` whose ``active`` hooks return
    deterministic deltas (functions of the step's outputs and of xt)."""
    deltas = {
        "cond_fn_eps": lambda out, xt: 0.05 * xt - 0.02 * out["pred_eps"],
        "cond_fn_x0": lambda out, xt: 0.03 * out["pred_x0"] + 0.01,
        "cond_fn_mean": lambda out, xt: -0.04 * out["mean"] + 0.02 * xt,
        "cond_fn_sample": lambda out, xt: 0.1 * out["sample"] - 0.05 * xt,
    }
    body = {name: (lambda self, out, xt, c, rng, _f=deltas[name]: _f(out, xt)) for name in active}
    return type("Hooked", (base, sampler), body)


@pytest.mark.parametrize("active", [(h,) for h in HOOKS] + [HOOKS, ()])
def test_base_guidance_hooks_match_on_one_step(active):
    """Each hook alone, all four together (the sample hook adds to the
    ORIGINAL sample, the reference's quirk) and none, on a hand-made step."""
    rs = np.random.RandomState(0)
    out = {k: rs.randn(2, 3, 4, 4).astype(np.float32)
           for k in ("sample", "mean", "pred_x0", "pred_eps", "reverse_eps")}
    xt = rs.randn(2, 3, 4, 4).astype(np.float32)
    jgd = _hooked(jg.BaseGuidance, JaxDDIM, active)(eta=0.5, **KW)
    tgd = _hooked(tg.BaseGuidance, DDIM, active)(eta=0.5, **KW)
    tape = jgd.sampler_tape()
    for i in (0, 7):
        jrow = {k: jnp.asarray(v[i]) for k, v in tape.items()}
        trow = tgd.tape_rows(tgd.sampler_tape())[i]
        want = jgd.apply_guidance({**{k: jnp.asarray(nhwc(v)) for k, v in out.items()},
                                   "var": jrow["ddim_var"]}, jnp.asarray(nhwc(xt)), jrow,
                                  jax.random.PRNGKey(0))
        got = tgd.apply_guidance({**{k: t(v) for k, v in out.items()}, "var": trow["ddim_var"]},
                                 t(xt), trow, None)
        for k in out:
            np.testing.assert_allclose(nhwc(got[k].numpy()), np.asarray(want[k]), err_msg=k, **TOL)
    if not active:
        assert all(got[k] is v or torch.equal(got[k], t(out[k])) for k, v in out.items())


def _jax_denoiser(x, tt, **kw):
    return 0.3 * x + jnp.asarray(tt, jnp.float32)[:, None, None, None] / 200.0


def _torch_denoiser(x, tt, **kw):
    return 0.3 * x + tt.float()[:, None, None, None] / 200.0


def test_hooked_ddim_trajectory_matches():
    """All four hooks inside the shared loop, eta = 0 (no noise drawn)."""
    x = np.random.RandomState(1).randn(2, 3, 6, 6).astype(np.float32)
    want, wys = _hooked(jg.BaseGuidance, JaxDDIM, HOOKS)(**KW).sample_loop(
        _jax_denoiser, jnp.asarray(nhwc(x)), jax.random.PRNGKey(0), collect=("pred_x0",))
    got, gys = _hooked(tg.BaseGuidance, DDIM, HOOKS)(**KW).sample_loop(
        _torch_denoiser, t(x), collect=("pred_x0",))
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **TOL)
    np.testing.assert_allclose(gys["pred_x0"].permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(wys["pred_x0"]), **TOL)


def test_plain_samplers_have_the_seam_and_it_is_a_no_op():
    out = {"sample": torch.ones(1)}
    assert DDIMCFG(2.0, **KW).apply_guidance(out, None, {}, None) is out


@pytest.mark.parametrize("r,j", [(10, 10), (3, 2), (2, 5), (1, 1)])
def test_repaint_schedule_and_tape_are_exact(r, j):
    kw = dict(total_steps=200, respace_type="uniform", respace_steps=20)
    jm, tm = jg.MaskGuidance(**kw), tg.MaskGuidance(**kw)
    assert tm.get_resample_seq(r, j) == jm.get_resample_seq(r, j)
    want, got = jm.resample_tape(r, j), tm.resample_tape(r, j)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- MaskGuidanceDDIMCFG under injected noise ---------------------------------
def _cfg_model_jax(x, tt, text_embed=None, **kw):
    return 0.1 * x + 0.05 * text_embed.mean(axis=(1, 2))[:, None, None, None]


def _cfg_model_torch(x, tt, text_embed=None, **kw):
    return 0.1 * x + 0.05 * text_embed.mean(dim=(1, 2))[:, None, None, None]


def _inputs(seed=2):
    rs = np.random.RandomState(seed)
    img = rs.randn(2, 4, 8, 8).astype(np.float32)
    mask = np.ones((2, 1, 8, 8), np.float32)
    mask[:, :, 2:6, 2:6] = 0.0
    return img, mask, rs.randn(2, 4, 8, 8).astype(np.float32), rs.randn(2, 7, 16).astype(np.float32)


def _feed(monkeypatch, arrays):
    """Patch the port's ``_randn`` to hand out ``arrays`` (NHWC, as JAX drew
    them) in order, as NCHW tensors."""
    queue = [t(nchw(a)) for a in arrays]

    def fake(like, generator):
        out = queue.pop(0)
        assert out.shape == like.shape
        return out

    monkeypatch.setattr(tmg, "_randn", fake)
    monkeypatch.setattr(tddpm, "_randn", fake)
    return queue


def _cfg_kw():
    return dict(guidance_scale=3.0, cond_kwarg="text_embed", **KW)


def test_mask_guidance_ddimcfg_trajectory_matches_under_injected_noise(monkeypatch):
    img, mask, x, ctx = _inputs()
    jd = jg.MaskGuidanceDDIMCFG(**_cfg_kw())
    jd.set_mask_and_image(jnp.asarray(nhwc(img)), jnp.asarray(nhwc(mask)))
    key = jax.random.PRNGKey(5)
    want = jd.sample(_cfg_model_jax, jnp.asarray(nhwc(x)), key,
                     uncond_conditioning=jnp.zeros_like(jnp.asarray(ctx)),
                     model_kwargs=dict(text_embed=jnp.asarray(ctx)))
    # the JAX loop: keys (n, 2); row i's guidance gets key[i, 1], split in 4,
    # and the sample hook draws from the fourth
    steps = len(jd.respaced_seq)
    keys = jax.random.split(key, (steps, 2))
    noise = [jax.random.normal(jax.random.split(keys[i, 1], 4)[3], nhwc(img).shape, jnp.float32)
             for i in range(steps)]
    queue = _feed(monkeypatch, noise)
    td_ = tg.MaskGuidanceDDIMCFG(**_cfg_kw())
    td_.set_mask_and_image(t(img), t(mask))
    got = td_.sample(_cfg_model_torch, t(x), None, uncond_conditioning=torch.zeros_like(t(ctx)),
                     model_kwargs=dict(text_embed=t(ctx)))
    assert not queue
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **TOL)
    # the known region is the image, the rest is not
    assert float(((got - t(img)) * t(mask)).abs().max()) < 1e-5
    assert not np.allclose((got * (1 - t(mask))).numpy(), img * (1 - mask), atol=1e-2)


def test_repaint_resample_matches_under_injected_noise(monkeypatch):
    """RePaint over the DDPM-based MaskGuidance (the resample tape has no DDIM
    columns): a denoise row draws the ancestral noise and then the known
    region's, a renoise row one forward step's."""
    img, mask, x, _ = _inputs(3)
    kw = dict(KW, respace_steps=6)
    r, j = 2, 2
    jd = jg.MaskGuidance(jnp.asarray(nhwc(img)), jnp.asarray(nhwc(mask)), **kw)
    key = jax.random.PRNGKey(6)
    want, wys = jd.resample_loop(_jax_denoiser, jnp.asarray(nhwc(x)), key, r, j,
                                 collect=("sample",))
    tape = jd.resample_tape(r, j)
    n = len(tape["t"])
    keys = jax.random.split(key, (n, 3))
    shape = nhwc(x).shape
    noise = []
    for i in range(n):
        if tape["is_denoise"][i] > 0.5:
            noise += [jax.random.normal(keys[i, 0], shape, jnp.float32),
                      jax.random.normal(jax.random.split(keys[i, 1], 4)[3], shape, jnp.float32)]
        else:
            noise.append(jax.random.normal(keys[i, 2], shape, jnp.float32))
    assert 0 < tape["is_denoise"].sum() < n
    queue = _feed(monkeypatch, noise)
    td_ = tg.MaskGuidance(t(img), t(mask), **kw)
    got, gys = td_.resample_loop(_torch_denoiser, t(x), None, r, j, collect=("sample",))
    assert not queue
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **TOL)
    np.testing.assert_allclose(gys["sample"].permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(wys["sample"]), **TOL)
    monkeypatch.undo()
    final = td_.resample(_torch_denoiser, t(x), torch.Generator().manual_seed(0), r, j)
    assert final.shape == x.shape and bool(final.isfinite().all())
    with pytest.raises(ValueError, match="can only collect 'sample'"):
        td_.resample_loop(_torch_denoiser, t(x), None, r, j, collect=("pred_x0",))


@pytest.mark.parametrize("seed", [0, 1])
def test_fully_known_mask_gives_back_the_image_for_any_noise(seed):
    """The property MaskGuidanceDDIMCFG's docstring states, with the port's
    own generator; and an all-unknown mask is plain DDIMCFG."""
    img, _, x, ctx = _inputs(4 + seed)
    run = dict(uncond_conditioning=torch.zeros_like(t(ctx)), model_kwargs=dict(text_embed=t(ctx)))
    d = tg.MaskGuidanceDDIMCFG(**_cfg_kw())
    d.set_mask_and_image(t(img), torch.ones(2, 1, 8, 8))
    out = d.sample(_cfg_model_torch, t(x), torch.Generator().manual_seed(seed), **run)
    np.testing.assert_allclose(out.numpy(), img, rtol=1e-5, atol=1e-6)
    d.set_mask_and_image(torch.zeros(2, 4, 8, 8), torch.zeros(2, 1, 8, 8))
    plain = DDIMCFG(**_cfg_kw()).sample(_cfg_model_torch, t(x), **run)
    np.testing.assert_allclose(
        d.sample(_cfg_model_torch, t(x), torch.Generator().manual_seed(seed), **run).numpy(),
        plain.numpy(), rtol=1e-6, atol=1e-6)


def test_sampling_without_mask_and_image_raises():
    d = tg.MaskGuidanceDDIMCFG(**_cfg_kw())
    with pytest.raises(RuntimeError, match="set_mask_and_image"):
        d.sample(_cfg_model_torch, torch.zeros(1, 4, 8, 8),
                 uncond_conditioning=torch.zeros(1, 7, 16),
                 model_kwargs=dict(text_embed=torch.zeros(1, 7, 16)))
