"""Ring attention (``dmtpu_torch/parallel/sp.py``) on gloo ranks of the CPU,
the cases of ``tests/test_sp.py``, each held against the JAX package.

- ``sp_attention`` over 2 and 4 ranks equals the JAX ``sp_attention`` on
  the 8-device CPU mesh and the plain reference (f32, 1e-5), and its
  gradients (of one loss over the output, on every rank) equal ``jax.grad``
  through the JAX reference (1e-5).
- bf16 in, bf16 out, within 2e-2 of the f32 reference (the JAX test's
  island: f32 logits and accumulator).
- The indivisible sequence raises.
- The ring over n ranks, forward and backward, is bit for bit the
  one-device fold (``fold_attention`` / ``fold_attention_backward``) over
  n chunks.
- On one device, ``fold_attention`` / ``fold_attention_backward`` over n
  chunks equal K1's and K2's plain versions on the whole sequence (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.parallel.mesh import make_mesh as jax_make_mesh
from dmtpu.parallel.sp import sp_attention as jax_sp_attention
from dmtpu_torch.ops.flash_attention import (
    flash_attention_backward_reference,
    flash_attention_reference,
)
from dmtpu_torch.parallel.sp import fold_attention, fold_attention_backward
from tests import _torch_parallel_workers as W
from tests._torch_dist import spawn


def _reference_mha(q, k, v):
    s = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32),
                   k.astype(jnp.float32)) * q.shape[-1] ** -0.5
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhqk,bkhd->bhqd", p, v.astype(jnp.float32))
    return o.transpose(0, 2, 1, 3).astype(q.dtype)


def _qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_and_reference_with_gradients(tmp_path, world):
    q, k, v, g = _qkv(0, (2, 32, 3, 8))
    mesh = jax_make_mesh(jax.devices("cpu"), fsdp=world)
    want = np.asarray(jax_sp_attention(*(jnp.asarray(x) for x in (q, k, v)), mesh))
    np.testing.assert_allclose(want, np.asarray(_reference_mha(q, k, v)), atol=1e-5)

    def loss(q_, k_, v_):
        return jnp.sum(_reference_mha(q_, k_, v_) * jnp.asarray(g))

    want_grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ranks = spawn(W.ring, world, tmp_path, *(torch.from_numpy(x) for x in (q, k, v, g)))
    for out, grads, ring_is_fold in ranks:
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
        for got, w in zip(grads, want_grads):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
        assert ring_is_fold


def test_ring_bf16_f32_softmax_island(tmp_path):
    q, k, v, g = (x[:1, :16, :2, :4] for x in _qkv(1, (2, 32, 3, 8)))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out, _, _ = spawn(W.ring, 4, tmp_path, tq, tk, tv, torch.from_numpy(g).bfloat16())[0]
    assert out.dtype == torch.bfloat16
    want = _reference_mha(*(jnp.asarray(x.float().numpy()) for x in (tq, tk, tv)))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


def test_ring_rejects_indivisible_sequence(tmp_path):
    q = torch.zeros(1, 15, 2, 4)
    with pytest.raises(RuntimeError, match="not divisible"):
        spawn(W.ring, 4, tmp_path, q, q, q, q)
    with pytest.raises(ValueError, match="not divisible"):
        jax_sp_attention(jnp.zeros((1, 15, 2, 4)), jnp.zeros((1, 15, 2, 4)),
                         jnp.zeros((1, 15, 2, 4)), jax_make_mesh(jax.devices("cpu"), fsdp=4))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_fold_over_chunks_is_the_whole_sequence(n):
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(2, (2, 64, 2, 16)))
    o, lse = fold_attention(q, k, v, n)
    o_w, lse_w = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, o_w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_w, rtol=1e-5, atol=1e-5)
    grads = fold_attention_backward(q, k, v, o, lse, do, n)
    want = flash_attention_backward_reference(q, k, v, o_w, lse_w, do)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)
