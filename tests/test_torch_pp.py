"""Pipeline parallelism (``dmtpu_torch/parallel/pp.py``) on gloo ranks of
the CPU, the cases of ``tests/test_pp.py``, each held against the JAX
package: the tiny DiT-S/2 of the JAX test (12 blocks) with seeded random
parameters (``jax_random_params``: no zero layer hides a gradient).

- ``stack_block_params``: 12 stacked blocks, the rest without them.
- The GPipe forward over 2 and 4 stages (and 8 microbatches over 4) is the
  plain forward, the port's (5e-6 / 1e-5, the JAX test's) and the JAX
  package's (1e-5 relative L2: the two frameworks' f32 sums), which is the
  JAX ``dit_pipeline_forward``'s (checked at 2 stages).
- dp x pp (a 2 x 2 mesh: data rows, 2 stages): the output and the
  gradients of mean(out^2) are the plain forward's (atol 1e-6 / rtol 1e-4,
  the JAX test's) and ``jax.grad``'s through the JAX pipeline (1e-5
  relative L2); ``dp_axis`` equal to the stage axis raises.
- The gradients through the pipeline over 4 stages are the plain ones.
- The guards: an indivisible batch, no consecutive blocks, layers that do
  not divide over the stages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models.dit import dit_model as jax_dit_model
from dmtpu.parallel.mesh import make_mesh as jax_make_mesh
from dmtpu.parallel.pp import dit_pipeline_forward as jax_dit_pipeline_forward
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.models.dit import dit_model
from dmtpu_torch.parallel.pp import stack_block_params
from tests import _torch_parallel_workers as W
from tests._torch_dist import spawn
from tests._torch_helpers import jax_random_params, nhwc

CFG = dict(input_size=8, num_classes=10, learn_sigma=True)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def dit(tmp_path_factory):
    """(weights file, torch config, JAX model and params, inputs, the port's
    plain output and gradients)."""
    m = jax_dit_model("DiT-S/2", **CFG)
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 8, 8, 4))
    t, y = jnp.arange(8), jnp.arange(8) % 10
    p = jax_random_params(m, x, t, y, seed=1)
    model = load_flax_params(dit_model("DiT-S/2", **CFG), p)
    path = str(tmp_path_factory.mktemp("pp") / "dit.pt")
    torch.save(model.state_dict(), path)
    args = (torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(y)))
    out = model(*args)
    out.square().mean().backward()
    return (path, m, p, (x, t, y), args, out.detach(),
            {n: q.grad for n, q in model.named_parameters()})


def _cfg():
    from dmtpu_torch.models.dit import DIT_CONFIGS

    return dict(DIT_CONFIGS["DiT-S/2"], **CFG)


def test_stack_block_params(dit):
    model = dit_model("DiT-S/2", **CFG, device="meta")
    stacked, rest, n = stack_block_params(dict(model.named_parameters()))
    assert n == 12 and {t.shape[0] for t in stacked.values()} == {12}
    assert not any(k.startswith("blocks.") for k in rest) and "final_layer.linear.weight" in rest
    with pytest.raises(ValueError, match="no consecutive"):
        stack_block_params({"final.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="no consecutive"):
        stack_block_params({"blocks.1.w": torch.zeros(1)})


@pytest.mark.parametrize("fsdp,mb", [(2, None), (4, None), (4, 8)])
def test_pipeline_matches_plain_forward_and_jax(tmp_path, dit, fsdp, mb):
    path, m, p, jargs, args, plain = dit[:6]
    want = m.apply(p, *jargs)
    if fsdp == 2:  # the JAX pipeline is its plain forward (tests/test_pp.py)
        got = jax_dit_pipeline_forward(m, p, *jargs,
                                       mesh=jax_make_mesh(jax.devices("cpu"), fsdp=fsdp))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=5e-6, rtol=1e-5)
    out, _ = spawn(W.pipeline, fsdp, tmp_path, path, _cfg(), args, fsdp, mb)[0]
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=5e-6, rtol=1e-5)
    assert _rel_l2(nhwc(out.numpy()), np.asarray(want)) <= 1e-5


def test_pipeline_dp_composition_and_gradients(tmp_path, dit):
    """dp x pp on a 2 x 2 mesh (data rows, two stages), and the gradients over
    four stages: the plain forward's and the JAX pipeline's."""
    path, m, p, jargs, args, plain, plain_grads = dit[:7]
    mesh = jax_make_mesh(jax.devices("cpu"), fsdp=4)
    want_grads = state_dict_from_flax(jax.device_get(jax.jit(jax.grad(
        lambda pp_: jnp.mean(jax_dit_pipeline_forward(m, pp_, *jargs, mesh=mesh,
                                                      n_microbatches=2, dp_axis="data") ** 2)))(p)))
    for fsdp, mb, dp in ((2, 2, "data"), (4, None, None)):
        out, grads = spawn(W.pipeline, 4, tmp_path, path, _cfg(), args, fsdp, mb, dp)[0]
        np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=5e-6, rtol=1e-5)
        assert grads.keys() == plain_grads.keys()
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), plain_grads[name].numpy(), atol=1e-6, rtol=1e-4,
                                       err_msg=name)
        num = sum(float(np.square(grads[k].double().numpy()
                                  - want_grads[k].double().numpy().reshape(grads[k].shape)).sum())
                  for k in grads)
        den = sum(float(np.square(want_grads[k].double().numpy()).sum()) for k in grads)
        assert (num / den) ** 0.5 <= 1e-5
    with pytest.raises(RuntimeError, match="must differ"):
        spawn(W.pipeline, 2, tmp_path, path, _cfg(), args, 2, None, "fsdp")


def test_pipeline_guards(tmp_path, dit):
    path, args = dit[0], dit[4]
    with pytest.raises(RuntimeError, match="not divisible"):
        spawn(W.pipeline, 4, tmp_path, path, _cfg(), tuple(a[:6] for a in args), 4, 4)
    cfg = dict(_cfg(), depth=6)  # 6 layers over 4 stages
    model = dit_model("DiT-S/2", **dict(CFG, depth=6))
    small = str(tmp_path / "dit6.pt")
    torch.save(model.state_dict(), small)
    with pytest.raises(RuntimeError, match="layers not divisible"):
        spawn(W.pipeline, 4, tmp_path, small, cfg, args, 4)
