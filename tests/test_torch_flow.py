"""dmtpu_torch's flow samplers against dmtpu's, on the CPU.

``FlowMatching`` / ``FlowMatchingCFG`` (Euler, Heun, with and without the
clip hook) and ``FlowDPMSolver`` / ``FlowDPMSolverCFG`` run the same
elementwise model (written twice, once in each framework, on the same
numpy arrays) from the same noise.  The tapes are compared exactly (both
are float64 on the host cast to float32); trajectories, losses and
inversions at 1e-5 relative L2 (f32: the same operations, XLA may fuse
them and round in another order).  The model's conditioning is MMDiT's
pytree ``{"context", "pooled"}``, with a per-sample extra kwarg beside it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import ddpm as jddpm
from dmtpu.diffusions import flow as jflow
from dmtpu.diffusions import flow_dpm as jflow_dpm
from dmtpu_torch.diffusions import ddpm as tddpm
from dmtpu_torch.diffusions import flow as tflow
from dmtpu_torch.diffusions import flow_dpm as tflow_dpm

F32 = 1e-5
rs = np.random.RandomState(0)
NOISE = rs.randn(2, 3, 4, 4).astype(np.float32)
DATA = np.clip(rs.randn(2, 3, 4, 4), -1, 1).astype(np.float32)
Y = {"context": rs.randn(2, 5, 6).astype(np.float32), "pooled": rs.randn(2, 7).astype(np.float32)}
NULL = {"context": np.zeros((2, 5, 6), np.float32), "pooled": np.zeros((2, 7), np.float32)}
GAIN = rs.rand(2).astype(np.float32) + 0.5  # a per-sample extra kwarg
T_INT = np.array([17, 903])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def jax_model(x, t, y=None, gain=None):
    """A velocity that depends on x, the float time, both conditioning leaves
    and the per-sample gain (the same arithmetic as ``torch_model``)."""
    v = 0.8 * jnp.tanh(x) - 0.3 * x + (t / 1000.0)[:, None, None, None] * 0.25
    v = v + y["pooled"][:, :3, None, None] * 0.2 + jnp.mean(y["context"], axis=(1, 2))[
        :, None, None, None]
    return v * (1.0 if gain is None else gain[:, None, None, None])


def torch_model(x, t, y=None, gain=None):
    v = 0.8 * torch.tanh(x) - 0.3 * x + (t / 1000.0)[:, None, None, None] * 0.25
    v = v + y["pooled"][:, :3, None, None] * 0.2 + torch.mean(y["context"], dim=(1, 2))[
        :, None, None, None]
    return v * (1.0 if gain is None else gain[:, None, None, None])


def _jy(y):
    return {k: jnp.asarray(v) for k, v in y.items()}


def _ty(y):
    return {k: torch.from_numpy(v) for k, v in y.items()}


TAPES = [dict(respace_type="uniform", time_shift=1.0), dict(respace_type="uniform", time_shift=3.0),
         dict(respace_type="quad", time_shift=1.0), dict(respace_type="quad", time_shift=3.0),
         dict(respace_type="uniform-leading", time_shift=2.0),
         dict(respace_type="linspace", time_shift=1.0), dict(respace_type=None, time_shift=1.0)]


@pytest.mark.parametrize("kw", TAPES, ids=lambda kw: f"{kw['respace_type']}-s{kw['time_shift']}")
@pytest.mark.parametrize("cls", ["FlowMatching", "FlowDPMSolver"])
def test_tapes_and_respaced_seq_are_the_jax_package_s(cls, kw):
    mod = jflow if cls == "FlowMatching" else jflow_dpm
    tmod = tflow if cls == "FlowMatching" else tflow_dpm
    want = getattr(mod, cls)(total_steps=1000, respace_steps=7, **kw)
    got = getattr(tmod, cls)(total_steps=1000, respace_steps=7, **kw)
    wt, gt = want.sampler_tape(), got.sampler_tape()
    assert sorted(wt) == sorted(gt)
    for k in wt:
        assert gt[k].dtype == np.float32
        np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
    np.testing.assert_array_equal(got.respaced_seq, want.respaced_seq)
    assert len(got.respaced_seq) == 7


def test_invalid_arguments_raise_as_in_the_jax_package():
    for kw in (dict(respace_type="quad2"), dict(solver="rk4"), dict(time_shift=0.0)):
        with pytest.raises(ValueError):
            jflow.FlowMatching(**kw)
        with pytest.raises(ValueError):
            tflow.FlowMatching(**kw)
    with pytest.raises(ValueError, match="itself the solver"):
        tflow_dpm.FlowDPMSolver(solver="heun")
    assert tflow_dpm.FlowDPMSolver(solver="dpm").solver == "euler"


COLLECT = ("sample", "pred_x0", "velocity")


@pytest.mark.parametrize("solver,clip", [("euler", False), ("heun", False), ("euler", True),
                                         ("heun", True)])
@pytest.mark.parametrize("shift,rtype", [(1.0, "uniform"), (3.0, "quad")])
def test_euler_and_heun_trajectories_match(solver, clip, shift, rtype):
    kw = dict(total_steps=1000, respace_steps=5, respace_type=rtype, solver=solver,
              time_shift=shift, clip_denoised=clip)
    want_x, want_ys = jflow.FlowMatching(**kw).sample_loop(
        jax_model, jnp.asarray(NOISE), model_kwargs={"y": _jy(Y)}, collect=COLLECT)
    got_x, got_ys = tflow.FlowMatching(**kw).sample_loop(
        torch_model, torch.from_numpy(NOISE), model_kwargs={"y": _ty(Y)}, collect=COLLECT)
    assert _rel(got_x, want_x) <= F32
    for k in COLLECT:
        assert got_ys[k].shape == (5, 2, 3, 4, 4) and _rel(got_ys[k], want_ys[k]) <= F32, k


def test_the_model_sees_the_float_time_unrounded():
    seen = []

    def model(x, t, y=None):
        seen.append(t.clone())
        return torch.zeros_like(x)

    s = tflow.FlowMatching(total_steps=1000, respace_steps=3, time_shift=3.0, solver="heun")
    s.sample(model, torch.from_numpy(NOISE), model_kwargs={"y": _ty(Y)})
    u = s.sampler_tape()
    want = np.stack([u["u"] * 1000, u["u_next"] * 1000], 1).reshape(-1).astype(np.float32)
    got = np.array([t[0].item() for t in seen], np.float32)
    # Heun calls the model at u and at u_next on every step, the last one too
    np.testing.assert_array_equal(got, want)
    assert len(seen) == 6 and all(t.dtype == torch.float32 for t in seen)
    assert got[1] != np.round(got[1]) and got[-1] == 0.0


@pytest.mark.parametrize("start,num", [(0, None), (2, 3), (1, 1)])
@pytest.mark.parametrize("rtype", ["uniform", "quad"])
def test_flow_dpm_matches_with_the_partial_entry_restart(start, num, rtype):
    kw = dict(total_steps=1000, respace_steps=6, respace_type=rtype, time_shift=3.0)
    want_x, want_ys = jflow_dpm.FlowDPMSolver(**kw).sample_loop(
        jax_model, jnp.asarray(NOISE), model_kwargs={"y": _jy(Y)}, collect=COLLECT,
        start_step=start, num_steps=num)
    got_x, got_ys = tflow_dpm.FlowDPMSolver(**kw).sample_loop(
        torch_model, torch.from_numpy(NOISE), model_kwargs={"y": _ty(Y)}, collect=COLLECT,
        start_step=start, num_steps=num)
    assert _rel(got_x, want_x) <= F32
    for k in COLLECT:
        # the velocity is recovered as (x - x0) / u: the cancellation scales
        # the f32 rounding of x0 by 1 / u
        assert _rel(got_ys[k], want_ys[k]) <= (1e-4 if k == "velocity" else F32), k


@pytest.mark.parametrize("name", ["FlowMatchingCFG-euler", "FlowMatchingCFG-heun",
                                  "FlowDPMSolverCFG"])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_cfg_samplers_match_on_a_pytree_with_a_per_sample_kwarg(name, scale):
    cls, _, solver = name.partition("-")
    kw = dict(guidance_scale=scale, total_steps=1000, respace_steps=4, time_shift=3.0)
    if solver:
        kw["solver"] = solver
    jcls = getattr(jflow if "Matching" in cls else jflow_dpm, cls)
    tcls = getattr(tflow if "Matching" in cls else tflow_dpm, cls)
    want = jcls(**kw).sample(jax_model, jnp.asarray(NOISE), uncond_conditioning=_jy(NULL),
                             model_kwargs={"y": _jy(Y), "gain": jnp.asarray(GAIN)})
    got = tcls(**kw).sample(torch_model, torch.from_numpy(NOISE), uncond_conditioning=_ty(NULL),
                            model_kwargs={"y": _ty(Y), "gain": torch.from_numpy(GAIN)})
    assert _rel(got, want) <= F32
    if scale == 1.0:
        # s = 1 is the conditional branch alone
        base = tflow_dpm.FlowDPMSolver if "DPM" in cls else tflow.FlowMatching
        plain = base(**{k: v for k, v in kw.items() if k != "guidance_scale"}).sample(
            torch_model, torch.from_numpy(NOISE),
            model_kwargs={"y": _ty(Y), "gain": torch.from_numpy(GAIN)})
        assert _rel(got, plain) <= F32


def test_cfg_double_merge_on_a_dict_matches_the_jax_merge():
    key = "__u__"
    jx, jm = jddpm.cfg_double_merge(jnp.asarray(NOISE), {"y": _jy(Y), "gain": jnp.asarray(GAIN),
                                                         "scalar": 3, key: _jy(NULL)}, "y", key)
    tx, tm = tddpm.cfg_double_merge(torch.from_numpy(NOISE),
                                    {"y": _ty(Y), "gain": torch.from_numpy(GAIN), "scalar": 3,
                                     key: _ty(NULL)}, "y", key)
    assert sorted(tm) == sorted(jm) == ["gain", "scalar", "y"]
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tm["gain"].numpy(), np.asarray(jm["gain"]))
    assert tm["scalar"] == 3 and sorted(tm["y"]) == ["context", "pooled"]
    for leaf in ("context", "pooled"):
        assert tm["y"][leaf].shape[0] == 4
        np.testing.assert_array_equal(tm["y"][leaf].numpy(), np.asarray(jm["y"][leaf]))
    # a list pytree too, and the missing pieces raise
    _, tl = tddpm.cfg_double_merge(torch.from_numpy(NOISE), {
        "y": [torch.ones(2, 1)], key: [torch.zeros(2, 1)]}, "y", key)
    assert isinstance(tl["y"], list) and tl["y"][0][:, 0].tolist() == [1, 1, 0, 0]
    with pytest.raises(ValueError, match="uncond_conditioning"):
        tddpm.cfg_double_merge(torch.from_numpy(NOISE), {"y": _ty(Y)}, "y", key)
    with pytest.raises(ValueError, match="not found"):
        tddpm.cfg_double_merge(torch.from_numpy(NOISE), {key: _ty(NULL)}, "y", key)


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_loss_and_diffuse_match(shift):
    kw = dict(total_steps=1000, time_shift=shift)
    want = jflow.FlowMatching(**kw).loss_func(
        jax_model, jnp.asarray(DATA), jnp.asarray(T_INT), eps=jnp.asarray(NOISE),
        model_kwargs={"y": _jy(Y)})
    got = tflow.FlowMatching(**kw).loss_func(
        torch_model, torch.from_numpy(DATA), torch.from_numpy(T_INT), eps=torch.from_numpy(NOISE),
        model_kwargs={"y": _ty(Y)})
    assert got.dtype == torch.float32 and abs(got.item() - float(want)) <= F32 * float(want)
    ts = np.array([250.5, 900.0], np.float32)
    want = jflow.FlowMatching(**kw).diffuse(jnp.asarray(DATA), jnp.asarray(ts),
                                            jnp.asarray(NOISE))
    got = tflow.FlowMatching(**kw).diffuse(torch.from_numpy(DATA), torch.from_numpy(ts),
                                           torch.from_numpy(NOISE))
    assert _rel(got, want) <= F32
    # the loss draws eps from the generator when none is given
    s = tflow.FlowMatching(**kw)
    args = (torch_model, torch.from_numpy(DATA), torch.from_numpy(T_INT))
    a = s.loss_func(*args, generator=torch.Generator().manual_seed(3), model_kwargs={"y": _ty(Y)})
    b = s.loss_func(*args, generator=torch.Generator().manual_seed(3), model_kwargs={"y": _ty(Y)})
    assert torch.equal(a, b)


@pytest.mark.parametrize("cfg", [False, True])
def test_sample_inversion_matches(cfg):
    kw = dict(total_steps=1000, respace_steps=4, time_shift=3.0, solver="heun")
    if cfg:
        want = jflow.FlowMatchingCFG(2.0, **kw).sample_inversion(
            jax_model, jnp.asarray(DATA), uncond_conditioning=_jy(NULL), model_kwargs={"y": _jy(Y)})
        got = tflow.FlowMatchingCFG(2.0, **kw).sample_inversion(
            torch_model, torch.from_numpy(DATA), uncond_conditioning=_ty(NULL),
            model_kwargs={"y": _ty(Y)})
    else:
        want = jflow.FlowMatching(**kw).sample_inversion(jax_model, jnp.asarray(DATA),
                                                         model_kwargs={"y": _jy(Y)})
        got = tflow.FlowMatching(**kw).sample_inversion(torch_model, torch.from_numpy(DATA),
                                                        model_kwargs={"y": _ty(Y)})
    assert _rel(got, want) <= F32
    # DPM inverts with first-order Euler, as the JAX package's does
    want = jflow_dpm.FlowDPMSolver(**{k: v for k, v in kw.items() if k != "solver"}) \
        .sample_inversion(jax_model, jnp.asarray(DATA), model_kwargs={"y": _jy(Y)})
    got = tflow_dpm.FlowDPMSolver(**{k: v for k, v in kw.items() if k != "solver"}) \
        .sample_inversion(torch_model, torch.from_numpy(DATA), model_kwargs={"y": _ty(Y)})
    assert _rel(got, want) <= F32
