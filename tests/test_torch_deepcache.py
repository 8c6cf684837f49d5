"""DeepCache in dmtpu_torch against dmtpu's, on the CPU: the UNet's full and
shallow passes, ``deepcache_sample`` and ``pfdiff_deepcache_sample``.

The tiny UNet of ``tests/_torch_helpers.py`` (two levels: 4 skip
connections) with the same seeded weights in both packages, inputs made with
numpy from a seed.  Tolerances: one forward rtol / atol 3e-4 (as
``tests/test_torch_sd_unet.py``); a sampled trajectory 1e-4 relative L2.
Inside the port a FULL pass is the plain forward, a SHALLOW pass with the
same step's cache is too, and ``interval=1`` is the plain sampler: exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu import diffusions as jd
from dmtpu.diffusions import deepcache as jdc
from dmtpu.models.stablediffusion import SDUNetModel as JaxUNet
from dmtpu_torch import diffusions as td
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.diffusions import deepcache as tdc
from dmtpu_torch.models.adm import GroupNorm32, ResBlock
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.models.stablediffusion.attention import CrossAttention, SpatialTransformer
from tests._torch_helpers import SD15_UNET_CFG, TINY_SD_UNET_CFG, jax_random_params, nhwc, t

UNET_TOL = dict(rtol=3e-4, atol=3e-4)


def nchw(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 3, 1, 2))


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


DC_CFG = TINY_SD_UNET_CFG


@pytest.fixture(scope="module")
def dc_pair():
    """(JAX UNet, its seeded random params, the port's UNet with them, ctx)."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 5, DC_CFG["context_dim"]).astype(np.float32)
    jmodel = JaxUNet(**DC_CFG)
    params = jax_random_params(jmodel, jnp.asarray(x), jnp.asarray([3, 7]), jnp.asarray(ctx),
                               seed=8)
    tmodel = load_flax_params(SDUNetModel(**DC_CFG), params).eval()
    return jmodel, params, tmodel, ctx


@pytest.mark.parametrize("skip", [1, 2, 3, 4])
def test_unet_full_and_shallow_passes_match(dc_pair, skip):
    """FULL returns (out, u): out is the plain forward and u JAX's; SHALLOW
    spliced with a fresh cache is the plain forward.  rtol / atol 3e-4
    against JAX; exact within the port."""
    jmodel, params, tmodel, ctx = dc_pair
    rs = np.random.RandomState(skip)
    x, ts = rs.randn(2, 4, 8, 8).astype(np.float32), np.array([3, 700])
    jx, jts, jctx = jnp.asarray(nhwc(x)), jnp.asarray(ts), jnp.asarray(ctx)
    jout, ju = jmodel.apply(params, jx, jts, jctx, dc_skip=skip)
    jshallow, _ = jmodel.apply(params, jx, jts, jctx, dc_skip=skip, dc_cached=ju)
    with torch.no_grad():
        plain = tmodel(t(x), t(ts), t(ctx))
        out, u = tmodel(t(x), t(ts), t(ctx), dc_skip=skip)
        shallow, u2 = tmodel(t(x), t(ts), t(ctx), dc_skip=skip, dc_cached=u)
        # the JAX cache spliced into the port's shallow pass
        shallow_j, _ = tmodel(t(x), t(ts), t(ctx), dc_skip=skip,
                              dc_cached=t(nchw(np.asarray(ju))))
    assert torch.equal(out, plain) and torch.equal(shallow, plain) and u2 is u
    np.testing.assert_allclose(nhwc(out.numpy()), np.asarray(jout), **UNET_TOL)
    np.testing.assert_allclose(nhwc(u.numpy()), np.asarray(ju), **UNET_TOL)
    np.testing.assert_allclose(nhwc(shallow_j.numpy()), np.asarray(jshallow), **UNET_TOL)


def test_unet_shallow_pass_runs_the_outermost_levels_only(dc_pair):
    """With skip 3 the shallow pass runs input blocks 0-2 and the last three
    output blocks, and no middle block: at SD1.5 that is 2 + 3 ResBlocks and
    2 + 3 SpatialTransformers, 10 attention and 16 GroupNorm calls."""
    _, _, tmodel, ctx = dc_pair
    ran = []
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: ran.append(name))
             for name, m in tmodel.named_modules()
             if name.count(".") == 1 and name.startswith(("input_blocks", "middle_block.",
                                                          "output_blocks"))]
    x, ts = torch.zeros(1, 4, 8, 8), torch.zeros(1, dtype=torch.int64)
    with torch.no_grad():
        _, u = tmodel(x, ts, t(ctx[:1]), dc_skip=3)
        assert len(ran) == 4 + 3 + 4
        ran.clear()
        tmodel(x, ts, t(ctx[:1]), dc_skip=3, dc_cached=u)
    for h in hooks:
        h.remove()
    assert ran == ["input_blocks.0", "input_blocks.1", "input_blocks.2",
                   "output_blocks.1", "output_blocks.2", "output_blocks.3"]
    sd15 = SDUNetModel(**SD15_UNET_CFG, device="meta")
    shallow = list(sd15.input_blocks[:3]) + list(sd15.output_blocks[-3:])
    count = lambda kind: sum(isinstance(m, kind) for b in shallow for m in b.modules())  # noqa
    assert (count(ResBlock), count(SpatialTransformer)) == (5, 5)
    assert (count(CrossAttention), count(GroupNorm32) + 1) == (10, 16)  # + the out norm


def test_unet_dc_skip_bounds(dc_pair):
    _, _, tmodel, ctx = dc_pair
    x, ts = torch.zeros(1, 4, 8, 8), torch.zeros(1, dtype=torch.int64)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="dc_skip"):
            tmodel(x, ts, t(ctx[:1]), dc_skip=bad)
    with pytest.raises(ValueError, match="dc_skip"):
        tmodel(x, ts, t(ctx[:1]), dc_cached=torch.zeros(1, 64, 8, 8))


def _fns(apply, ctx2=None, skip=3, doubled=False):
    """full_fn / shallow_fn over ``apply(x, t, dc_skip, dc_cached)``."""
    def prep(x, tt):
        return (x, tt) if not doubled else (
            (jnp.concatenate([x, x]), jnp.concatenate([tt, tt])) if isinstance(x, jax.Array)
            else (torch.cat([x, x]), torch.cat([tt, tt])))

    def full_fn(x, tt):
        return apply(*prep(x, tt), skip, None)

    def shallow_fn(x, tt, u):
        return apply(*prep(x, tt), skip, u)[0]

    return full_fn, shallow_fn


def _both(dc_pair, doubled=False):
    jmodel, params, tmodel, ctx = dc_pair
    jctx = jnp.asarray(ctx)
    tctx = t(ctx)
    if doubled:
        jctx = jnp.concatenate([jctx, jnp.zeros_like(jctx)])
        tctx = torch.cat([tctx, torch.zeros_like(tctx)])

    def japply(x, tt, skip, u):
        return jmodel.apply(params, x, tt, jctx, dc_skip=skip, dc_cached=u)

    def tapply(x, tt, skip, u):
        return tmodel(x, tt, tctx, dc_skip=skip, dc_cached=u)

    return _fns(japply, doubled=doubled), _fns(tapply, doubled=doubled)


def _cfg_combine(diffuser, s, split):
    def combine(out2, x, c):
        oc, ou = split(out2)
        eps_c = diffuser.predict(oc, x, c)["pred_eps"]
        eps_u = diffuser.predict(ou, x, c)["pred_eps"]
        return (1.0 - s) * eps_u + s * eps_c
    return combine


@pytest.mark.parametrize("interval", [1, 2])
@pytest.mark.parametrize("guided", [False, True])
def test_deepcache_sample_matches_jax(dc_pair, interval, guided):
    """``deepcache_sample`` over the tiny UNet, plain and with the CFG seam
    (the doubled batch, each half ``predict``-ed, then combined), against
    JAX: 1e-4 relative L2."""
    dp = dict(total_steps=100, respace_type="uniform", respace_steps=6)
    noise = np.random.RandomState(20).randn(2, 4, 8, 8).astype(np.float32)
    (jfull, jshallow), (tfull, tshallow) = _both(dc_pair, doubled=guided)
    jdiff, tdiff = jd.DDIM(**dp), td.DDIM(**dp)
    jpost = _cfg_combine(jdiff, 3.0, lambda o: jnp.split(o, 2)) if guided else None
    tpost = _cfg_combine(tdiff, 3.0, lambda o: o.chunk(2)) if guided else None
    want = jax.jit(lambda n: jdc.deepcache_sample(
        jdiff, jfull, jshallow, n, jax.random.PRNGKey(0), interval=interval,
        postprocess=jpost))(jnp.asarray(nhwc(noise)))
    with torch.no_grad():
        got = tdc.deepcache_sample(tdiff, tfull, tshallow, t(noise), interval=interval,
                                   postprocess=tpost)
    assert rel_l2(nhwc(got.numpy()), np.asarray(want)) <= 1e-4


@pytest.mark.parametrize("interval", [1, 2])
@pytest.mark.parametrize("guided", [False, True])
def test_pfdiff_deepcache_sample_matches_jax(dc_pair, interval, guided):
    """``pfdiff_deepcache_sample`` on an 8-point grid (anchor, three pairs,
    the trailing step), plain and with the CFG ``eps_fn``, against JAX: 1e-4
    relative L2."""
    dp = dict(total_steps=100, respaced_seq=np.linspace(0, 99, 8).round().astype(np.int64))
    noise = np.random.RandomState(21).randn(2, 4, 8, 8).astype(np.float32)
    (jfull, jshallow), (tfull, tshallow) = _both(dc_pair, doubled=guided)
    jdiff, tdiff = jd.PFDiffDDIM(**dp), td.PFDiffDDIM(**dp)
    jeps = _cfg_combine(jdiff, 3.0, lambda o: jnp.split(o, 2)) if guided else None
    teps = _cfg_combine(tdiff, 3.0, lambda o: o.chunk(2)) if guided else None
    want = jax.jit(lambda n: jdc.pfdiff_deepcache_sample(
        jdiff, jfull, jshallow, n, interval=interval, eps_fn=jeps))(jnp.asarray(nhwc(noise)))
    with torch.no_grad():
        got = tdc.pfdiff_deepcache_sample(tdiff, tfull, tshallow, t(noise), interval=interval,
                                          eps_fn=teps)
    assert rel_l2(nhwc(got.numpy()), np.asarray(want)) <= 1e-4


class _Noisy(td.DDPM):
    """A stochastic sampler whose guidance hook also draws: interval=1 is
    exact only if the loop draws in ``DDPM.sample_loop``'s order."""

    def apply_guidance(self, out, xt, c, generator=None):
        bump = 0.01 * torch.randn(xt.shape, generator=generator)
        return dict(out, sample=out["sample"] + bump)


def test_deepcache_interval1_is_the_plain_sampler_exactly(dc_pair):
    """Within the port, ``interval=1`` gives the plain sampler's result bit
    for bit: DDIM, a stochastic DDPM with a drawing guidance hook (same
    seed), DDIMCFG through the CFG seam, PFDiffDDIM, and PFDiffDDIMCFG
    through ``eps_fn``."""
    _, _, tmodel, ctx = dc_pair
    tctx = t(ctx)
    uctx = torch.zeros_like(tctx)
    noise = t(np.random.RandomState(22).randn(2, 4, 8, 8).astype(np.float32))
    dp = dict(total_steps=100, respace_type="uniform", respace_steps=5)
    (_, _), (full, shallow) = _both(dc_pair)
    (_, _), (full2, shallow2) = _both(dc_pair, doubled=True)

    def model_fn(x, tt, text_embed=None, **kw):
        return tmodel(x, tt, tctx if text_embed is None else text_embed)

    cfg = dict(uncond_conditioning=uctx, model_kwargs=dict(text_embed=tctx))
    with torch.no_grad():
        for diffuser in (td.DDIM(**dp), _Noisy(var_type="fixed_small", **dp)):
            want = diffuser.sample(model_fn, noise, torch.Generator().manual_seed(5))
            got = tdc.deepcache_sample(diffuser, full, shallow, noise,
                                       torch.Generator().manual_seed(5), interval=1)
            assert torch.equal(got, want), type(diffuser).__name__
        want = td.DDIMCFG(3.0, "text_embed", **dp).sample(model_fn, noise, None, **cfg)
        ddim = td.DDIM(**dp)
        got = tdc.deepcache_sample(ddim, full2, shallow2, noise, interval=1,
                                   postprocess=_cfg_combine(ddim, 3.0, lambda o: o.chunk(2)))
        assert torch.equal(got, want)
        pf = td.PFDiffDDIM(**dp)
        assert torch.equal(tdc.pfdiff_deepcache_sample(pf, full, shallow, noise, interval=1),
                           pf.sample(model_fn, noise))
        want = td.PFDiffDDIMCFG(3.0, "text_embed", **dp).sample(model_fn, noise, None, **cfg)
        got = tdc.pfdiff_deepcache_sample(pf, full2, shallow2, noise, interval=1,
                                          eps_fn=_cfg_combine(pf, 3.0, lambda o: o.chunk(2)))
        assert torch.equal(got, want)
        # interval 2 reuses the cache: another trajectory
        assert not torch.equal(tdc.deepcache_sample(ddim, full, shallow, noise, interval=2),
                               ddim.sample(model_fn, noise))
    with pytest.raises(ValueError, match="interval"):
        tdc.deepcache_sample(ddim, full, shallow, noise, interval=0)
    with pytest.raises(ValueError, match="interval"):
        tdc.pfdiff_deepcache_sample(pf, full, shallow, noise, interval=0)
