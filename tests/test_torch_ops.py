"""dmtpu_torch.ops: attention and GroupNorm against the JAX package.

On the CPU the port's kernel wrappers run their plain versions; these tests
hold those against the JAX functions, with the Pallas kernels run in the TPU
interpreter as ``tests/test_flash_small_d.py`` and ``tests/test_ops.py`` run
them.  ``tests/test_torch_kernels.py`` holds the CUDA kernels against the
plain versions on the card.

Tolerances: f32 on the CPU differs only by summation order (2e-5, as the JAX
package's own kernel tests; 5e-5 for gradients, as its own gradient test,
since they sum over one more axis).  bf16 compares two frameworks that
round the logits and P at different places: 2e-2, bf16's resolution at unit
scale.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dmtpu.ops import attention as jattn
from dmtpu.ops import flash_small_d as jfsd
from dmtpu.ops import groupnorm as jgn
from dmtpu_torch.ops import (
    attention,
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_reference,
    group_norm,
    group_norm_silu,
    group_norm_silu_reference,
    mha,
    plain_ops,
)
from dmtpu_torch.ops.dispatch import kernels_enabled
from tests._torch_helpers import nhwc, t

CPU = jax.devices("cpu")[0]


def _qkv(seed, b, sq, sk, h, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 64, 64, 2, 40),      # small logits: input-dtype logits
    (2, 256, 77, 2, 160),    # cross-attention, d=160
    (1, 1536, 1536, 1, 8),   # S_q*S_k > 2**21: f32 logits
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_jax(b, sq, sk, h, d, dtype):
    q, k, v = _qkv(0, b, sq, sk, h, d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jattn.mha(*(jnp.asarray(a, jd) for a in (q, k, v))), np.float32)
    got = mha(*(t(a).to(td) for a in (q, k, v))).float().numpy()
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("s,d,block_q,block_k", [(256, 40, 128, 128), (512, 80, 128, 256),
                                                 (512, 40, 128, 256), (256, 80, 128, 128)])
def test_flash_reference_matches_pallas_interpret(s, d, block_q, block_k):
    """K1's plain version (what the wrapper runs on the CPU) == the Pallas
    flash_small_d forward, output and logsumexp, in f32."""
    b, h = 2, 2
    q, k, v = _qkv(1, b, s, s, h, d)
    scale = d ** -0.5

    def flat(a):
        return jnp.asarray(np.swapaxes(a, 1, 2).reshape(b * h, s, d))

    with jax.default_device(CPU), pltpu.force_tpu_interpret_mode():
        o, lse = jfsd._fwd(flat(q), flat(k), flat(v), scale, block_q, block_k)
    want_o = np.swapaxes(np.asarray(o).reshape(b, h, s, d), 1, 2)
    got_o, got_lse = flash_attention_fwd(t(q), t(k), t(v), scale)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_lse.reshape(b * h, s).numpy(), np.asarray(lse),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,d", [(256, 160), (64, 40), (128, 80)])
def test_cross_attention_matches_jax_mha(sq, d):
    """S_k=77 (the CLIP context) at SD's head dims: the dispatch and K1's
    plain version against the JAX package's mha."""
    q, k, v = _qkv(2, 2, sq, 77, 2, d)
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(attention(t(q), t(k), t(v)).numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(flash_attention_reference(t(q), t(k), t(v))[0].numpy(), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_matches_pallas_interpret(silu, eps):
    """NCHW group_norm_silu (CPU: its plain version) == the Pallas kernel on
    NHWC in interpret mode (C % 128 == 0)."""
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 128, 4, 4) * 3 + 1).astype(np.float32)
    scale = rs.randn(128).astype(np.float32)
    bias = rs.randn(128).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgn._pallas_forward(jnp.asarray(nhwc(x)), jnp.asarray(scale),
                                              jnp.asarray(bias), 32, eps, silu))
    got = group_norm_silu(t(x), t(scale), t(bias), 32, eps, silu).numpy()
    np.testing.assert_allclose(nhwc(got), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("c,hw", [(320, 8), (960, 4), (64, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax_reference(c, hw, dtype):
    rs = np.random.RandomState(4)
    x = (rs.randn(2, c, hw, hw) * 2 - 0.5).astype(np.float32)
    scale = rs.randn(c).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jgn.group_norm_silu_reference(
        jnp.asarray(nhwc(x), jd), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5, True),
        np.float32)
    got = group_norm_silu_reference(t(x).to(td), t(scale), t(bias), 32, 1e-5, True)
    assert got.dtype == td
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(nhwc(got.float().numpy()), want, rtol=tol, atol=tol)


GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def _torch_grads(fn, arrays, do):
    """Gradients of sum(fn(*tensors) * do) for f32 CPU tensors made from ``arrays``."""
    leaves = [t(a).requires_grad_() for a in arrays]
    fn(*leaves).backward(t(do))
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("s,d,block_q,block_k", [(256, 40, 128, 128), (512, 80, 128, 256),
                                                 (512, 40, 128, 256), (256, 80, 128, 128)])
def test_flash_backward_matches_pallas_interpret(s, d, block_q, block_k):
    """K2's plain version, and the FlashAttention function on the CPU (whose
    bodies are the plain versions), against jax.grad of the Pallas
    flash_small_d (forward and fused backward kernels) in interpret mode."""
    b, h = 2, 2
    q, k, v = _qkv(5, b, s, s, h, d)
    do = np.random.RandomState(6).randn(b, s, h, d).astype(np.float32)
    scale = d ** -0.5

    def loss(qq, kk, vv):
        return jnp.sum(jfsd.flash_small_d_bshd(qq, kk, vv, scale, block_q, block_k)
                       * jnp.asarray(do))

    with jax.default_device(CPU), pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    o, lse = flash_attention_fwd(t(q), t(k), t(v), scale)
    ref = flash_attention_backward_reference(t(q), t(k), t(v), o, lse, t(do), scale)
    got = _torch_grads(lambda *a: flash_attention(*a, scale), (q, k, v), do)
    for name, w, r, g in zip("qkv", want, ref, got):
        np.testing.assert_allclose(r.numpy(), np.asarray(w), err_msg=f"d{name}", **GRAD_TOL)
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("sq,d", [(256, 160), (64, 40), (128, 80)])
def test_cross_attention_grads_match_jax_mha(sq, d):
    """S_k=77 at SD's head dims: the FlashAttention function's gradients on
    the CPU (K2's plain version) against jax.grad of the JAX package's mha."""
    q, k, v = _qkv(7, 2, sq, 77, 2, d)
    do = np.random.RandomState(8).randn(2, sq, 2, d).astype(np.float32)

    def loss(qq, kk, vv):
        return jnp.sum(jattn.mha(qq, kk, vv) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = _torch_grads(flash_attention, (q, k, v), do)
    for name, w, g in zip("qkv", want, got):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{name}", **GRAD_TOL)


def test_flash_attention_function_wiring():
    """What the autograd function saves and hands back, on the CPU: the
    plain forward's output and f32 lse, its inputs' dtypes for the
    gradients, the backward reference's exact values, and the head-dim
    default for ``scale``."""
    q, k, v = (t(a).bfloat16().requires_grad_() for a in _qkv(9, 2, 64, 77, 2, 40))
    do = torch.from_numpy(np.random.RandomState(10).randn(2, 64, 2, 40).astype(np.float32))
    o = flash_attention(q, k, v)
    saved = o.grad_fn.saved_tensors
    assert [tuple(x.shape) for x in saved] == [(2, 64, 2, 40), (2, 77, 2, 40), (2, 77, 2, 40),
                                               (2, 64, 2, 40), (2, 2, 64)]
    assert [x.dtype for x in saved] == [torch.bfloat16] * 4 + [torch.float32]
    want_o, want_lse = flash_attention_reference(q, k, v, 40 ** -0.5)
    assert torch.equal(o, want_o) and torch.equal(saved[4], want_lse)
    o.backward(do.bfloat16())
    want = flash_attention_backward_reference(q.detach(), k.detach(), v.detach(), want_o,
                                              want_lse, do.bfloat16(), 40 ** -0.5)
    for leaf, w in zip((q, k, v), want):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w)
    assert all(torch.equal(a, b) for a, b in zip(
        flash_attention_bwd(q.detach(), k.detach(), v.detach(), want_o, want_lse,
                            do.bfloat16()), want))


@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
def test_group_norm_grads_match_jax(silu, eps):
    """The GroupNormSiLU function (K3's plain version forward, the plain
    backward) against jax.grad of the JAX custom_vjp group_norm_silu."""
    rs = np.random.RandomState(11)
    x = (rs.randn(2, 64, 4, 4) * 2 + 0.5).astype(np.float32)
    w = rs.randn(64).astype(np.float32)
    bias = rs.randn(64).astype(np.float32)
    gy = rs.randn(2, 64, 4, 4).astype(np.float32)

    def loss(xx, ww, bb):
        return jnp.sum(jgn.group_norm_silu(xx, ww, bb, 32, eps, silu) * jnp.asarray(nhwc(gy)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(nhwc(x)), jnp.asarray(w),
                                             jnp.asarray(bias))
    got = _torch_grads(lambda *a: group_norm(*a, 32, eps, silu), (x, w, bias), gy)
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-4, atol=1e-4)


def test_wrappers_raise_on_unsupported_devices():
    x = torch.zeros(1, 32, 2, 4, device="meta")
    w = torch.ones(32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_silu(x, w, w)
    q = torch.zeros(1, 8, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 1, 8, device="meta"), q)


def test_plain_ops_switch_nests_and_restores():
    assert kernels_enabled()
    with plain_ops():
        assert not kernels_enabled()
        with plain_ops():
            assert not kernels_enabled()
        assert not kernels_enabled()
    assert kernels_enabled()
    with pytest.raises(RuntimeError), plain_ops():
        raise RuntimeError("left by an error")
    assert kernels_enabled()


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX and dmtpu unimported
    (a fresh interpreter: this test process has imported both)."""
    code = ("import sys, pkgutil, importlib, dmtpu_torch\n"
            "for m in pkgutil.walk_packages(dmtpu_torch.__path__, 'dmtpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dmtpu', 'flax')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)


@pytest.mark.parametrize("kernel", [None, "mma", "wgmma"])
def test_forced_attention_kernel_on_the_cpu_is_the_plain_version(kernel):
    """``kernel=`` chooses among the CUDA kernels; a CPU tensor goes to the
    plain version whatever it says, as the JAX package's own dispatch leaves
    the CPU to its reference."""
    q, k, v = (t(a) for a in _qkv(7, 1, 160, 160, 2, 40))
    got_o, got_lse = flash_attention_fwd(q, k, v, kernel=kernel)
    want_o, want_lse = flash_attention_reference(q, k, v)
    assert torch.equal(got_o, want_o) and torch.equal(got_lse, want_lse)
    want = np.asarray(jattn.mha(*(jnp.asarray(a.numpy()) for a in (q, k, v))))
    np.testing.assert_allclose(got_o.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kernel", [None, "nchw", "groups", "rows"])
@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
def test_forced_group_norm_kernel_on_the_cpu_is_the_plain_version(kernel, layout):
    rs = np.random.RandomState(8)
    x = t((rs.randn(2, 320, 4, 4) * 2 + 1).astype(np.float32)).to(memory_format=layout)
    scale, bias = t(rs.randn(320).astype(np.float32)), t(rs.randn(320).astype(np.float32))
    got = group_norm_silu(x, scale, bias, 32, 1e-5, True, kernel=kernel)
    assert torch.equal(got, group_norm_silu_reference(x, scale, bias, 32, 1e-5, True))
    want = np.asarray(jgn.group_norm_silu_reference(
        jnp.asarray(nhwc(x.numpy())), jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
        32, 1e-5, True))
    np.testing.assert_allclose(nhwc(got.numpy()), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kernel", [None, "mma", "wgmma"])
@pytest.mark.parametrize("sq,sk,d", [(160, 160, 40), (64, 77, 80)])
def test_forced_backward_kernel_on_the_cpu_is_the_plain_version(sq, sk, d, kernel):
    """K2's ``kernel=`` chooses among the CUDA kernels; a CPU tensor goes to
    the plain version whatever it says, and that agrees with jax.grad of the
    JAX package's mha."""
    q, k, v = _qkv(12, 1, sq, sk, 2, d)
    do = np.random.RandomState(13).randn(1, sq, 2, d).astype(np.float32)
    o, lse = flash_attention_reference(t(q), t(k), t(v))
    got = flash_attention_bwd(t(q), t(k), t(v), o, lse, t(do), kernel=kernel)
    ref = flash_attention_backward_reference(t(q), t(k), t(v), o, lse, t(do))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))

    def loss(qq, kk, vv):
        return jnp.sum(jattn.mha(qq, kk, vv) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, w, g in zip("qkv", want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("name", ["tma", "MMA", ""])
def test_unknown_backward_kernel_name_raises(name):
    q = torch.zeros(1, 8, 1, 40)
    o, lse = flash_attention_reference(q, q, q)
    with pytest.raises(ValueError, match="unknown kernel"):
        flash_attention_bwd(q, q, q, o, lse, q, kernel=name)
