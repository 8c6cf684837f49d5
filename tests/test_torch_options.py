"""Options of the JAX package that the port gained last, against it:

- ``FeedForward(glu=False)`` (Linear, exact GELU, Linear) and
  ``BasicTransformerBlock(gated_ff=False)`` against the Flax modules, with
  the Flax parameters through the bridge (seeded, tiny widths): 1e-5
  relative L2 (f32 sums in another order);
- ``utils.profiling.trace`` writes a trace that TensorBoard's profiler
  plugin reads (a ``*.pt.trace.json`` with the traced operator in it);
- ``utils.checkpoint.save_array_dict`` writes the flat ``.npz`` that the
  JAX function writes, read back equal (bf16 tensors as f32, which holds
  them exactly).
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models.stablediffusion.attention import BasicTransformerBlock as JaxBlock
from dmtpu.models.stablediffusion.attention import FeedForward as JaxFeedForward
from dmtpu.utils.checkpoint import save_array_dict as jax_save_array_dict
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.models.stablediffusion.attention import BasicTransformerBlock, FeedForward
from dmtpu_torch.utils.checkpoint import save_array_dict
from dmtpu_torch.utils.profiling import trace
from tests._torch_helpers import jax_random_params

DIM, HEADS, D_HEAD, CTX = 16, 2, 8, 12


def _rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want))


@pytest.mark.parametrize("glu", [False, True])
def test_feed_forward_matches_flax(glu):
    x = np.random.RandomState(0).randn(2, 5, DIM).astype(np.float32)
    jff = JaxFeedForward(mult=2, glu=glu)
    params = jax_random_params(jff, jnp.asarray(x), seed=1)
    ff = load_flax_params(FeedForward(DIM, mult=2, glu=glu), params)
    want_keys = ({"net.0.proj.weight", "net.0.proj.bias"} if glu
                 else {"net.0.0.weight", "net.0.0.bias"}) | {"net.2.weight", "net.2.bias"}
    assert set(ff.state_dict()) == want_keys
    assert _rel_l2(ff(torch.from_numpy(x)), jff.apply(params, jnp.asarray(x))) <= 1e-5


def test_non_gated_transformer_block_matches_flax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 6, DIM).astype(np.float32)
    ctx = rs.randn(2, 3, CTX).astype(np.float32)
    jblock = JaxBlock(HEADS, D_HEAD, gated_ff=False)
    params = jax_random_params(jblock, jnp.asarray(x), jnp.asarray(ctx), seed=3)
    block = load_flax_params(
        BasicTransformerBlock(DIM, HEADS, D_HEAD, context_dim=CTX, gated_ff=False), params)
    assert "ff.net.0.0.weight" in block.state_dict()
    got = block(torch.from_numpy(x), context=torch.from_numpy(ctx))
    want = jax.jit(jblock.apply)(params, jnp.asarray(x), jnp.asarray(ctx))
    assert _rel_l2(got, want) <= 1e-5
    # the default block keeps the gated feed-forward
    gated = BasicTransformerBlock(DIM, HEADS, D_HEAD, context_dim=CTX)
    assert "ff.net.0.proj.weight" in gated.state_dict()


def test_trace_writes_a_tensorboard_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    a = torch.randn(32, 32)
    with trace(logdir):
        (a @ a).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, os.listdir(logdir)
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


def test_save_array_dict_round_trips(tmp_path):
    rs = np.random.RandomState(4)
    arrays = {"w": torch.from_numpy(rs.randn(3, 4).astype(np.float32)),
              "b16": torch.from_numpy(rs.randn(5).astype(np.float32)).to(torch.bfloat16),
              "steps": torch.arange(3), "host": rs.randn(2, 2)}
    path = str(tmp_path / "w.npz")
    save_array_dict(path, arrays)
    jax_path = str(tmp_path / "w_jax.npz")
    jax_save_array_dict(jax_path, {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                                   if torch.is_tensor(v) else v for k, v in arrays.items()})
    with np.load(path) as got, np.load(jax_path) as want:
        assert set(got.files) == set(want.files) == set(arrays)
        for k in arrays:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["b16"].dtype == np.float32 and got["steps"].dtype == np.int64
