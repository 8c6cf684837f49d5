"""The SD serving accelerators of dmtpu_torch against dmtpu's, on the CPU.

DPM-Solver++(2M), PFDiff-1, Token Merging and FreeU (DeepCache:
``tests/test_torch_deepcache.py``).  Inputs are made with numpy from a seed
and go through the JAX function and the port's, with the same weights.
Tolerances, each stated where it is used:

- tapes: exact (the same float64 numpy code);
- sampler trajectories over an analytic denoiser: rtol / atol 1e-5 (f32
  rounding order only);
- a tiny SpatialTransformer or UNet: rtol / atol 3e-4 (as
  ``tests/test_torch_sd_unet.py``);
- ToMe's merge and its gradient: 1e-4 (f32 sums in another order); the
  unmerge gathers exactly;
- FreeU: 1e-5 (two f32 FFTs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu import diffusions as jd
from dmtpu.models.stablediffusion import SDUNetModel as JaxUNet
from dmtpu.models.stablediffusion.attention import SpatialTransformer as JaxST
from dmtpu.ops import freeu as jfreeu
from dmtpu.ops import tome as jtome
from dmtpu_torch import diffusions as td
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.models.stablediffusion.attention import SpatialTransformer
from dmtpu_torch.ops import freeu as tfreeu
from dmtpu_torch.ops import tome as ttome
from tests._torch_helpers import TINY_SD_UNET_CFG, jax_random_params, nhwc, t

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
UNET_TOL = dict(rtol=3e-4, atol=3e-4)


def nchw(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 3, 1, 2))


# ---------------------------------------------------------------------------
# DPM-Solver++ and PFDiff over an analytic denoiser
# ---------------------------------------------------------------------------
def _den_jax(x, tt, y=None):
    out = 0.3 * x + jnp.asarray(tt, jnp.float32)[:, None, None, None] / 2000.0
    return out if y is None else out + 0.2 * y[:, None, None, :]


def _den_torch(x, tt, y=None):
    out = 0.3 * x + tt.float()[:, None, None, None] / 2000.0
    return out if y is None else out + 0.2 * y[:, :, None, None]


def _x(seed=0, shape=(2, 3, 8, 8)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


DPM_CASES = {
    "uniform20": dict(total_steps=1000, respace_type="uniform", respace_steps=20),
    "quad25": dict(total_steps=1000, respace_type="quad", respace_steps=25,
                   beta_schedule="quad", beta_start=0.00085, beta_end=0.012),
    # quad respacing of 60 steps into 100 repeats timesteps: rows with h = 0
    "quad_repeats": dict(total_steps=100, respace_type="quad", respace_steps=60),
}


@pytest.mark.parametrize("case", sorted(DPM_CASES))
def test_dpmpp_tape_is_exact(case):
    want = jd.DPMSolverPP(**DPM_CASES[case]).sampler_tape()
    got = td.DPMSolverPP(**DPM_CASES[case]).sampler_tape()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == "quad_repeats":
        seq = td.DPMSolverPP(**DPM_CASES[case]).respaced_seq
        assert (np.diff(seq) == 0).any()  # the case has the h = 0 rows it is about


@pytest.mark.parametrize("case", sorted(DPM_CASES))
@pytest.mark.parametrize("start_step,num_steps", [(0, None), (4, None), (3, 5)])
def test_dpmpp_trajectory_matches(case, start_step, num_steps):
    """The whole run and partial ones (img2img enters past row 0 and restarts
    the multistep weights at first order).  rtol / atol 1e-5."""
    kw, span = DPM_CASES[case], dict(start_step=start_step, num_steps=num_steps)
    x = _x(1)
    want, wys = jd.DPMSolverPP(**kw).sample_loop(
        _den_jax, jnp.asarray(nhwc(x)), jax.random.PRNGKey(0), collect=("pred_x0", "var"), **span)
    got, gys = td.DPMSolverPP(**kw).sample_loop(_den_torch, t(x), collect=("pred_x0", "var"),
                                                **span)
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **STEP_TOL)
    rows = np.asarray(wys["pred_x0"]).shape[0]
    assert tuple(gys["pred_x0"].shape) == (rows, 2, 3, 8, 8) and gys["var"].shape == (rows,)
    np.testing.assert_allclose(gys["pred_x0"].permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(wys["pred_x0"]), **STEP_TOL)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_dpmpp_cfg_matches(scale):
    """DPMSolverPPCFG through the port's ``_cfg_model_output`` against the JAX
    class, from row 0 and from row 3.  rtol / atol 1e-5."""
    kw = DPM_CASES["uniform20"]
    rs = np.random.RandomState(2)
    x, y = rs.randn(2, 3, 8, 8).astype(np.float32), rs.randn(2, 3).astype(np.float32)
    y0 = np.zeros_like(y)
    for start in (0, 3):
        want = jd.DPMSolverPPCFG(scale, "y", **kw).sample(
            _den_jax, jnp.asarray(nhwc(x)), jax.random.PRNGKey(0),
            uncond_conditioning=jnp.asarray(y0), model_kwargs={"y": jnp.asarray(y)},
            start_step=start)
        got = td.DPMSolverPPCFG(scale, "y", **kw).sample(
            _den_torch, t(x), uncond_conditioning=t(y0), model_kwargs={"y": t(y)},
            start_step=start)
        np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **STEP_TOL)
    with pytest.raises(NotImplementedError, match="guidance_interval"):
        td.DPMSolverPPCFG(2.0, "y", guidance_interval=(100, 500), **kw)


@pytest.mark.parametrize("steps", [1, 2, 3, 8, 9, 50])
def test_pfdiff_tapes_and_nfe_are_exact(steps):
    kw = dict(total_steps=1000, respace_type="uniform", respace_steps=steps)
    jsam, tsam = jd.PFDiffDDIM(**kw), td.PFDiffDDIM(**kw)
    assert tsam.nfe == jsam.nfe
    for want, got in zip(jsam.pfdiff_tapes(), tsam.pfdiff_tapes()):
        assert (want is None) == (got is None)
        if want is not None:
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if steps == 50:
        assert tsam.nfe == 26  # the 50-step grid in 26 model calls


@pytest.mark.parametrize("steps", [2, 8, 9])
def test_pfdiff_trajectory_and_collect_match(steps):
    """``collect`` stacks one entry a pair (and the trailing step).
    rtol / atol 1e-5; ``pred_eps`` 1e-4: it divides by sqrt(1 / ac - 1),
    about 0.03 at the trailing step, which scales f32 rounding up."""
    kw = dict(total_steps=1000, respace_type="uniform", respace_steps=steps)
    x = _x(3)
    keys = ("sample", "pred_x0", "pred_eps")
    want, wys = jd.PFDiffDDIM(**kw).sample_loop(_den_jax, jnp.asarray(nhwc(x)),
                                                jax.random.PRNGKey(0), collect=keys)
    got, gys = td.PFDiffDDIM(**kw).sample_loop(_den_torch, t(x), collect=keys)
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **STEP_TOL)
    for k in keys:
        assert gys[k].shape[0] == np.asarray(wys[k]).shape[0]
        tol = STEP_TOL if k != "pred_eps" else dict(rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gys[k].permute(0, 1, 3, 4, 2).numpy(), np.asarray(wys[k]),
                                   **tol)
    calls = []
    td.PFDiffDDIM(**kw).sample(lambda xx, tt: calls.append(1) or _den_torch(xx, tt), t(x))
    assert len(calls) == td.PFDiffDDIM(**kw).nfe


def test_pfdiff_cfg_matches_and_refuses_what_jax_refuses():
    """PFDiffDDIMCFG against the JAX class (rtol / atol 1e-5); its explicit
    ``sample`` keeps ``uncond_conditioning`` out of ``model_kwargs``."""
    kw = dict(total_steps=1000, respace_type="uniform", respace_steps=9)
    rs = np.random.RandomState(4)
    x, y = rs.randn(2, 3, 8, 8).astype(np.float32), rs.randn(2, 3).astype(np.float32)
    y0 = np.zeros_like(y)
    want = jd.PFDiffDDIMCFG(3.0, "y", **kw).sample(
        _den_jax, jnp.asarray(nhwc(x)), jax.random.PRNGKey(0),
        uncond_conditioning=jnp.asarray(y0), model_kwargs={"y": jnp.asarray(y)})
    got = td.PFDiffDDIMCFG(3.0, "y", **kw).sample(
        _den_torch, t(x), None, t(y0), {"y": t(y)})
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **STEP_TOL)
    with pytest.raises(ValueError, match="eta=0"):
        td.PFDiffDDIM(total_steps=100, eta=0.5)
    with pytest.raises(NotImplementedError, match="guidance_interval"):
        td.PFDiffDDIMCFG(2.0, "y", guidance_interval=(100, 500), **kw)


# ---------------------------------------------------------------------------
# Token Merging
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h,w,sx,sy,seed", [(8, 8, 2, 2, None), (6, 10, 2, 2, None),
                                            (9, 7, 3, 2, None), (8, 8, 2, 2, 3),
                                            (64, 64, 2, 2, 0)])
def test_tome_grid_and_r_are_exact(h, w, sx, sy, seed):
    for want, got in zip(jtome.dst_index_grid(h, w, sx, sy, seed),
                         ttome.dst_index_grid(h, w, sx, sy, seed)):
        np.testing.assert_array_equal(got, want)
    a, b = ttome._grid(h, w, sx, sy, seed, torch.device("cpu"))
    assert a.dtype == torch.int64 and ttome._grid(h, w, sx, sy, seed, torch.device("cpu"))[0] is a
    for ratio in (0.0, 0.3, 0.5, 0.9):
        assert ttome.tome_r(h * w, ratio, h, w, sx, sy) == jtome.tome_r(h * w, ratio, h, w, sx, sy)
    assert ttome.tome_r(4096, 0.3, 64, 64) == 1228  # 2868 tokens left at the 64x64 level


def _tie_heavy(b=2, h=8, w=8, c=16):
    """Every 2x2 cell holds four copies of one vector, and cell k's vector is
    cell (k + 8)'s: 2^(j % 3) e_j with j = k % 8.  A one-hot product has one
    non-zero term, so every score is exact in any summation order: each
    source ties with the other sources of its level and, for the argmax,
    with the second cell of its vector."""
    cells = np.zeros((b, (h // 2) * (w // 2), c), np.float32)
    for k in range(cells.shape[1]):
        j = k % 8
        cells[:, k, j] = 2.0 ** (j % 3)
    grid = cells.reshape(b, h // 2, w // 2, c).repeat(2, axis=1).repeat(2, axis=2)
    return grid.reshape(b, h * w, c)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("r,seed", [(20, None), (48, None), (30, 3)])
def test_tome_merge_unmerge_match_jax(kind, r, seed):
    """merge and unmerge against JAX's on random and on tie-heavy input
    (JAX's ``top_k`` keeps equal scores in index order; the port's stable
    sort must too): 1e-4."""
    h = w = 8
    x = (np.random.RandomState(1).randn(2, h * w, 16).astype(np.float32) if kind == "random"
         else _tie_heavy())
    y = np.random.RandomState(2).randn(2, h * w - r, 16).astype(np.float32)
    jm, ju = jtome.bipartite_soft_matching_2d(jnp.asarray(x), h, w, r=r, seed=seed)
    tm, tu = ttome.bipartite_soft_matching_2d(t(x), h, w, r=r, seed=seed)
    merged = tm(t(x))
    assert merged.shape == (2, h * w - r, 16)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jm(jnp.asarray(x))), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tu(t(y)).numpy(), np.asarray(ju(jnp.asarray(y))))
    if kind == "ties":
        # tokens merge only with copies of themselves: round trip exact
        np.testing.assert_allclose(tu(merged).numpy(), x, rtol=1e-6, atol=1e-6)


def test_tome_algebra_identity_cases_and_bf16():
    h = w = 8
    x = t(np.random.RandomState(3).randn(2, h * w, 16).astype(np.float32))
    m, u = ttome.bipartite_soft_matching_2d(x, h, w, r=24)
    # merge(unmerge(y)) is y: every kept row reads back from itself
    y = torch.randn(2, h * w - 24, 16)
    torch.testing.assert_close(m(u(y)), y, rtol=1e-6, atol=1e-6)
    # each batch item matches on its own
    m1, _ = ttome.bipartite_soft_matching_2d(x[1:], h, w, r=24)
    torch.testing.assert_close(m(x)[1:], m1(x[1:]), rtol=0, atol=0)
    for r, sx in ((0, 2), (20, 16)):  # r = 0, and a cell larger than the grid
        m, u = ttome.bipartite_soft_matching_2d(x, h, w, sx=sx, sy=sx, r=r)
        assert m(x) is x and u(x) is x
    with pytest.raises(ValueError, match="tokens"):
        ttome.bipartite_soft_matching_2d(x, 4, 4, r=4)
    m, _ = ttome.bipartite_soft_matching_2d(x.bfloat16(), h, w, r=24)
    assert m(x.bfloat16()).dtype == torch.bfloat16


def test_tome_gradient_matches_jax():
    """d/dx of sum(unmerge(merge(x) * w)) against ``jax.grad``: 1e-4."""
    h = w = 8
    rs = np.random.RandomState(4)
    x = rs.randn(2, h * w, 16).astype(np.float32)
    wt = rs.randn(2, h * w - 24, 16).astype(np.float32)

    def jloss(xx):
        m, u = jtome.bipartite_soft_matching_2d(xx, h, w, r=24)
        return jnp.sum(u(m(xx) * wt) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = t(x).requires_grad_()
    m, u = ttome.bipartite_soft_matching_2d(xt, h, w, r=24)
    (u(m(xt) * t(wt)) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ratio,seed", [(0.5, None), (0.3, 1)])
def test_tome_spatial_transformer_matches_jax(ratio, seed):
    """A tiny SpatialTransformer with ToMe, same weights: rtol / atol 3e-4."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 64, 8, 8).astype(np.float32)
    ctx = rs.randn(2, 7, 24).astype(np.float32)
    jmod = JaxST(2, 32, tome_ratio=ratio, tome_seed=seed)
    params = jax_random_params(jmod, jnp.asarray(nhwc(x)), jnp.asarray(ctx), seed=6)
    want = np.asarray(jmod.apply(params, jnp.asarray(nhwc(x)), jnp.asarray(ctx)))
    tmod = load_flax_params(SpatialTransformer(64, 2, 32, context_dim=24, tome_ratio=ratio,
                                               tome_seed=seed), params)
    plain = load_flax_params(SpatialTransformer(64, 2, 32, context_dim=24), params)
    with torch.no_grad():
        got, base = tmod(t(x), t(ctx)), plain(t(x), t(ctx))
    np.testing.assert_allclose(nhwc(got.numpy()), want, **UNET_TOL)
    assert not torch.allclose(got, base, atol=1e-4)  # ToMe changed the output
    assert tmod.state_dict().keys() == plain.state_dict().keys()


FREEU_CFG = dict(TINY_SD_UNET_CFG, channel_mult=[1, 2, 4], attention_resolutions=[1, 2])


@pytest.fixture(scope="module")
def freeu_unet():
    """(params of the tiny UNet below, x, timesteps, context)."""
    rs = np.random.RandomState(9)
    x = rs.randn(2, 4, 16, 16).astype(np.float32)
    ctx = rs.randn(2, 7, FREEU_CFG["context_dim"]).astype(np.float32)
    ts = np.array([3, 700])
    params = jax_random_params(JaxUNet(**FREEU_CFG), jnp.asarray(nhwc(x)), jnp.asarray(ts),
                               jnp.asarray(ctx), seed=10)
    return params, x, ts, ctx




@pytest.mark.parametrize("knobs", [
    dict(tome_ratio=0.5),
    dict(tome_ratio=0.5, tome_max_downsample=2, tome_seed=2),
    dict(freeu=jfreeu.SD15_DEFAULTS),
    dict(freeu=(1.2, 1.3, 0.8, 0.5), tome_ratio=0.4, tome_max_downsample=2),
], ids=["tome", "tome_ds2_seed", "freeu", "both"])
def test_tiny_unet_with_tome_and_freeu_matches_jax(freeu_unet, knobs):
    """The tiny UNet (channel mult 1, 2, 4: FreeU's b1 and b2 sites both
    exist) with the knobs, built with them and set afterwards, against the
    JAX module with the same fields: rtol / atol 3e-4."""
    params, x, ts, ctx = freeu_unet
    want = np.asarray(JaxUNet(**FREEU_CFG, **knobs).apply(
        params, jnp.asarray(nhwc(x)), jnp.asarray(ts), jnp.asarray(ctx)))
    built = load_flax_params(SDUNetModel(**FREEU_CFG, **knobs), params).eval()
    rebound = load_flax_params(SDUNetModel(**FREEU_CFG), params).eval()
    sd_before = {k: v.clone() for k, v in rebound.state_dict().items()}
    rebound.set_tome(knobs.get("tome_ratio", 0.0),
                     max_downsample=knobs.get("tome_max_downsample", 1),
                     seed=knobs.get("tome_seed")).set_freeu(knobs.get("freeu"))
    with torch.no_grad():
        a, b = built(t(x), t(ts), t(ctx)), rebound(t(x), t(ts), t(ctx))
    np.testing.assert_allclose(nhwc(a.numpy()), want, **UNET_TOL)
    assert torch.equal(a, b)
    after = rebound.state_dict()
    assert after.keys() == sd_before.keys()
    assert all(torch.equal(after[k], v) for k, v in sd_before.items())


def test_tome_gates_levels_by_max_downsample():
    model = SDUNetModel(**FREEU_CFG, tome_ratio=0.5)
    ratios = {st.ds: {blk.tome_ratio for blk in st.transformer_blocks}
              for st in model.modules() if isinstance(st, SpatialTransformer)}
    assert ratios == {1: {0.5}, 2: {0.0}, 4: {0.0}}  # 4: the middle block
    model.set_tome(0.5, max_downsample=4)
    assert {blk.tome_ratio for st in model.modules() if isinstance(st, SpatialTransformer)
            for blk in st.transformer_blocks} == {0.5}
    with pytest.raises(ValueError, match="exactly"):
        model.set_freeu((1.0, 1.0, 1.0))


# ---------------------------------------------------------------------------
# FreeU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,threshold,scale", [((2, 8, 8, 6), 1, 0.2), ((1, 9, 7, 4), 2, 0.5),
                                                   ((2, 16, 16, 3), 1, 1.0)])
def test_fourier_filter_matches_jax(shape, threshold, scale):
    """NHWC in JAX, NCHW in the port: 1e-5."""
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    want = np.asarray(jfreeu.fourier_filter(jnp.asarray(x), threshold, scale))
    got = tfreeu.fourier_filter(t(nchw(x)), threshold, scale)
    np.testing.assert_allclose(nhwc(got.numpy()), want, rtol=1e-5, atol=1e-5)
    xb = t(nchw(x)).bfloat16().to(memory_format=torch.channels_last)
    got = tfreeu.fourier_filter(xb, threshold, scale)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("channels", [128, 64, 32])
def test_apply_freeu_matches_jax(channels):
    """The gate at a b1 site (4 x 32 channels), a b2 site and a passing one:
    1e-5."""
    rs = np.random.RandomState(channels)
    h = rs.randn(2, 8, 8, channels).astype(np.float32)
    skip = rs.randn(2, 8, 8, 48).astype(np.float32)
    jh, js = jfreeu.apply_freeu(jnp.asarray(h), jnp.asarray(skip), 32, *jfreeu.SD15_DEFAULTS)
    th, ts = tfreeu.apply_freeu(t(nchw(h)), t(nchw(skip)), 32, *tfreeu.SD15_DEFAULTS)
    np.testing.assert_allclose(nhwc(th.numpy()), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(ts.numpy()), np.asarray(js), rtol=1e-5, atol=1e-5)
    assert (tfreeu.SD15_DEFAULTS, tfreeu.SD21_DEFAULTS, tfreeu.SDXL_DEFAULTS) == (
        jfreeu.SD15_DEFAULTS, jfreeu.SD21_DEFAULTS, jfreeu.SDXL_DEFAULTS)
