"""dmtpu_torch's Euler and Heun samplers, DDIM inversion and the DDPM helpers
against dmtpu's, on the CPU.

The deterministic samplers run one elementwise model written in both
frameworks (NHWC in JAX, NCHW here) on the same starting noise: the tapes
are compared exactly (both are float64 host arithmetic cast to float32),
the loops and their collected trajectories to a relative L2 of 1e-4, and the
inversions (plain and guided) and their round trips likewise.  The four
``pred_*`` conversions and ``set_respaced_seq`` are compared to 1e-5 and
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDIM as JaxDDIM
from dmtpu.diffusions import DDIMCFG as JaxDDIMCFG
from dmtpu.diffusions import DDPM as JaxDDPM
from dmtpu.diffusions import EulerSampler as JaxEuler
from dmtpu.diffusions import HeunSampler as JaxHeun
from dmtpu_torch.diffusions import DDIM, DDIMCFG, DDPM, EulerSampler, HeunSampler
from tests._torch_helpers import nhwc, t

LOOP, MOD = 1e-4, 1e-5
X = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
KW = dict(total_steps=1000, beta_schedule="linear", respace_type="uniform", respace_steps=10)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_model(x, tt, y=None):
    s = jnp.cos(tt.astype(jnp.float32) / 300.0)[:, None, None, None]
    out = 0.3 * x * s + 0.1 * jnp.sin(3.0 * x)
    if y is not None:
        out = out + 0.05 * (y.astype(jnp.float32) - 2.0)[:, None, None, None]
    return out


def _torch_model(x, tt, y=None):
    s = torch.cos(tt.float() / 300.0)[:, None, None, None]
    out = 0.3 * x * s + 0.1 * torch.sin(3.0 * x)
    if y is not None:
        out = out + 0.05 * (y.float() - 2.0)[:, None, None, None]
    return out


SAMPLERS = {"euler": (JaxEuler, EulerSampler), "heun": (JaxHeun, HeunSampler),
            "ddim": (JaxDDIM, DDIM)}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("objective", ["pred_eps", "pred_v"])
def test_tapes_are_the_jax_package_s(name, objective):
    jcls, tcls = SAMPLERS[name]
    want = jcls(objective=objective, **KW).sampler_tape()
    got = tcls(objective=objective, **KW).sampler_tape()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["euler", "heun"])
@pytest.mark.parametrize("objective", ["pred_eps", "pred_x0", "pred_v"])
@pytest.mark.parametrize("start_step,num_steps", [(0, None), (3, None), (0, 4)])
def test_deterministic_loops_match_jax(name, objective, start_step, num_steps):
    jcls, tcls = SAMPLERS[name]
    kw = dict(KW, objective=objective)
    collect = ("sample", "pred_x0")
    want, wys = jcls(**kw).sample_loop(_jax_model, jnp.asarray(nhwc(X)), jax.random.PRNGKey(0),
                                       collect=collect, start_step=start_step,
                                       num_steps=num_steps)
    got, gys = tcls(**kw).sample_loop(_torch_model, t(X), collect=collect,
                                      start_step=start_step, num_steps=num_steps)
    assert _rel_l2(nhwc(got.numpy()), want) <= LOOP
    for k in collect:
        assert gys[k].shape[0] == wys[k].shape[0]
        assert _rel_l2(np.transpose(gys[k].numpy(), (0, 1, 3, 4, 2)), wys[k]) <= LOOP, k


def test_heun_makes_2n_minus_1_model_calls():
    calls = []

    def model(x, tt):
        calls.append(int(tt[0]))
        return _torch_model(x, tt)

    HeunSampler(**KW).sample(model, t(X))
    assert len(calls) == 2 * 10 - 1 and calls[-1] == 0


def test_ddim_inversion_tape_is_the_jax_package_s():
    want, got = JaxDDIM(**KW).inversion_tape(), DDIM(**KW).inversion_tape()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("objective", ["pred_eps", "pred_v"])
def test_ddim_inversion_and_round_trip_match_jax(objective):
    kw = dict(KW, objective=objective)
    jd, td = JaxDDIM(**kw), DDIM(**kw)
    img = np.clip(X, -1, 1) * 0.8
    want, wys = jd.sample_inversion_loop(_jax_model, jnp.asarray(nhwc(img)), collect=("sample",))
    got, gys = td.sample_inversion_loop(_torch_model, t(img), collect=("sample",))
    assert gys["sample"].shape[0] == wys["sample"].shape[0] == 9
    assert _rel_l2(nhwc(got.numpy()), want) <= LOOP
    back_want = jd.sample(_jax_model, want, jax.random.PRNGKey(0))
    back = td.sample(_torch_model, got)
    assert _rel_l2(nhwc(back.numpy()), back_want) <= LOOP


def test_ddim_inversion_needs_eta_zero():
    with pytest.raises(ValueError, match="eta=0"):
        DDIM(eta=0.5, **KW).sample_inversion(_torch_model, t(X))


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_ddimcfg_guided_inversion_and_round_trip_match_jax(scale):
    y, null = np.array([1, 4]), np.array([5, 5])
    jd = JaxDDIMCFG(guidance_scale=scale, **KW)
    td = DDIMCFG(guidance_scale=scale, **KW)
    img = np.clip(X, -1, 1) * 0.8
    jkw = dict(uncond_conditioning=jnp.asarray(null), model_kwargs={"y": jnp.asarray(y)})
    tkw = dict(uncond_conditioning=t(null), model_kwargs={"y": t(y)})
    want = jd.sample_inversion(_jax_model, jnp.asarray(nhwc(img)), **jkw)
    got = td.sample_inversion(_torch_model, t(img), **tkw)
    assert _rel_l2(nhwc(got.numpy()), want) <= LOOP
    back_want = jd.sample(_jax_model, want, jax.random.PRNGKey(0), **jkw)
    back = td.sample(_torch_model, got, **tkw)
    assert _rel_l2(nhwc(back.numpy()), back_want) <= LOOP


@pytest.mark.parametrize("respace_type,steps", [("uniform", 25), ("quad", 10), (None, 100)])
def test_set_respaced_seq_is_the_jax_package_s(respace_type, steps):
    jd, td = JaxDDPM(total_steps=100), DDPM(total_steps=100)
    jd.set_respaced_seq(respace_type, steps)
    td.set_respaced_seq(respace_type, steps)
    np.testing.assert_array_equal(td.respaced_seq, jd.respaced_seq)
    for k, v in jd.sampler_tape().items():
        np.testing.assert_array_equal(td.sampler_tape()[k], v, err_msg=k)


@pytest.mark.parametrize("fn", ["pred_x0_from_eps", "pred_eps_from_x0", "pred_x0_from_v",
                                "pred_eps_from_v"])
def test_pred_conversions_match_jax(fn):
    rs = np.random.RandomState(1)
    xt, other = rs.randn(2, 3, 4, 4).astype(np.float32), rs.randn(2, 3, 4, 4).astype(np.float32)
    ts = np.array([5, 900])
    want = getattr(JaxDDPM(), fn)(jnp.asarray(nhwc(xt)), jnp.asarray(ts), jnp.asarray(nhwc(other)))
    got = getattr(DDPM(), fn)(t(xt), t(ts), t(other))
    assert _rel_l2(nhwc(got.numpy()), want) <= MOD
