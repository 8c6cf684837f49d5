"""Tensor parallelism (``dmtpu_torch/parallel/tp.py``) on gloo ranks of the
CPU: the TP cases of ``tests/test_parallel.py`` (its lines 195-237), each
held against the JAX package.

- The tiny SD UNet of the JAX test, made tensor-parallel over 2 and 4
  ranks, gives the one-rank port's output (rtol / atol 2e-5, the JAX test's
  bound within one framework) and, gathered, its gradients of mean(out^2)
  (1e-5 relative L2 over all); and the JAX model's output and gradients
  within 1e-4 relative L2 (f32 sums in other orders: the one-rank port is
  5.7e-5 off JAX at most on this input).
  Column and row splits both occur; SD's 1x1-conv ``proj_out`` is
  row-sharded by hand (its local weight holds 1 / n of the input channels);
  ``proj_in`` stays whole.
- The pairing: a GEGLU ``proj`` and DiT's fused ``qkv`` keep, on each rank,
  its slice of each chunk; DiT over 2 ranks gives the one-rank and the JAX
  output and gradients as well.
- ``tp_param_sharding``'s split is the JAX ``tp_param_sharding``'s, leaf by
  leaf (Flax kernel axis -1 is torch dim 0, -2 is dim 1), and the rules
  keep embedding projections whole (the JAX regression test's paths).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models.dit import DiT as JaxDiT
from dmtpu.models.stablediffusion.unet import SDUNetModel as JaxSDUNet
from dmtpu.parallel.mesh import make_mesh as jax_make_mesh
from dmtpu.parallel.tp import _classify as jax_classify
from dmtpu.parallel.tp import tp_param_sharding as jax_tp_param_sharding
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.convert.flax_bridge import _flatten, torch_name
from dmtpu_torch.models.dit import DiT
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.parallel.tp import classify
from tests import _torch_parallel_workers as W
from tests._torch_dist import spawn
from tests._torch_helpers import jax_random_params, nhwc

SD = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
          attention_resolutions=(1,), channel_mult=(1, 2), num_heads=4, transformer_depth=1,
          context_dim=16, legacy=False)
DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2, num_heads=4,
           num_classes=5)


def _rel_l2(got, want):
    num = sum(float(np.square(got[k].double().numpy() - want[k].double().numpy()).sum())
              for k in want)
    return (num / sum(float(np.square(w.double().numpy()).sum()) for w in want.values())) ** 0.5


@pytest.fixture(scope="module")
def sd_case(tmp_path_factory):
    """(weights file, JAX params, JAX output NHWC and gradients, the port's
    one-rank output NCHW and gradients, the inputs)."""
    x = np.ones((8, 4, 8, 8), np.float32)
    t = np.arange(8)
    ctx = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 5, 16)))
    jmodel = JaxSDUNet(**SD)
    args = (jnp.asarray(nhwc(x)), jnp.asarray(t), jnp.asarray(ctx))
    params = jax_random_params(jmodel, *args)
    want = np.asarray(jmodel.apply(params, *args))
    grads = jax.jit(jax.grad(lambda p: jnp.mean(jmodel.apply(p, *args) ** 2)))(params)
    path = str(tmp_path_factory.mktemp("tp") / "sd.pt")
    model = load_flax_params(SDUNetModel(**SD), params)
    torch.save(model.state_dict(), path)
    targs = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    plain = model(*targs)
    plain.square().mean().backward()
    named = dict(model.named_parameters())
    want_grads = {k: v.reshape(named[k].shape)
                  for k, v in state_dict_from_flax(jax.device_get(grads)).items()}
    return (path, params, want, want_grads, plain.detach(),
            {n: p.grad for n, p in named.items()}, targs)


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_sd_unet_matches_jax(tmp_path, sd_case, world):
    path, _, want, want_grads, plain, plain_grads, args = sd_case
    ranks = spawn(W.tensor_parallel, world, tmp_path, "sd", path, SD, args)
    for out, grads, shapes, _ in ranks:
        # against the one-rank port at the JAX test's bound (one framework),
        # against JAX as the parity tests hold the port (f32 sums in other orders)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)
        assert grads.keys() == want_grads.keys() and _rel_l2(grads, plain_grads) <= 1e-5
        assert _rel_l2({"o": torch.from_numpy(nhwc(out.numpy()))},
                       {"o": torch.from_numpy(want)}) <= 1e-4
        assert _rel_l2(grads, want_grads) <= 1e-4
    shapes = ranks[0][2]
    full = dict(SDUNetModel(**SD, device="meta").named_parameters())
    name = "input_blocks.1.1.proj_out.weight"  # a 1x1 Conv2d, row-sharded by hand
    assert shapes[name] == (full[name].shape[0], full[name].shape[1] // world, 1, 1)
    assert "input_blocks.1.1.proj_in.weight" not in shapes
    assert {classify(n) for n in shapes if n.endswith("weight")} == {"column", "row"}
    geglu = "input_blocks.1.1.transformer_blocks.0.ff.net.0.proj.weight"
    assert shapes[geglu][0] == full[geglu].shape[0] // world


def test_geglu_and_fused_qkv_pairing(tmp_path):
    """Each rank's GEGLU proj (and DiT qkv) rows are its slice of the value
    and the gate half (q, k and v thirds); DiT over 2 ranks is the JAX DiT."""
    from dmtpu_torch.parallel.tp import _slice_param

    layer = torch.nn.Linear(4, 8)
    with torch.no_grad():
        layer.weight.copy_(torch.arange(8.0)[:, None].expand(8, 4))
    _slice_param(layer, "weight", 0, 1, 2, chunks=2)
    assert layer.weight[:, 0].tolist() == [2.0, 3.0, 6.0, 7.0]  # not the rows 4..7

    rs = np.random.RandomState(3)
    x = rs.randn(4, 4, 8, 8).astype(np.float32)
    t, y = np.array([1, 50, 300, 999]), np.array([0, 1, 2, 4])
    jmodel = JaxDiT(**DIT)
    args = (jnp.asarray(nhwc(x)), jnp.asarray(t), jnp.asarray(y))
    params = jax_random_params(jmodel, *args)
    want = np.asarray(jmodel.apply(params, *args))
    grads = jax.jit(jax.grad(lambda p: jnp.mean(jmodel.apply(p, *args) ** 2)))(params)
    model = load_flax_params(DiT(**DIT), params)
    path = str(tmp_path / "dit.pt")
    torch.save(model.state_dict(), path)
    named = dict(model.named_parameters())
    want_grads = {k: v.reshape(named[k].shape)
                  for k, v in state_dict_from_flax(jax.device_get(grads)).items()}
    targs = tuple(torch.from_numpy(a) for a in (x, t, y))
    plain = model(*targs)
    plain.square().mean().backward()
    out, got, shapes, _ = spawn(W.tensor_parallel, 2, tmp_path, "dit", path, DIT, targs)[0]
    assert shapes["blocks.0.attn.qkv.weight"] == (96, 64)
    np.testing.assert_allclose(out.numpy(), plain.detach().numpy(), rtol=2e-5, atol=2e-5)
    assert _rel_l2(got, {n: p.grad for n, p in model.named_parameters()}) <= 1e-5
    assert _rel_l2({"o": torch.from_numpy(nhwc(out.numpy()))}, {"o": torch.from_numpy(want)}) \
        <= 1e-4 and _rel_l2(got, want_grads) <= 1e-4


def test_tp_param_sharding_matches_jax_leaf_by_leaf(tmp_path, sd_case):
    path, params = sd_case[:2]
    rule = spawn(W.tensor_parallel, 2, tmp_path, "sd", path, SD, sd_case[-1])[0][3]
    specs = jax_tp_param_sharding(jax_make_mesh(jax.devices("cpu"), fsdp=2), params)
    flat = dict(_flatten(specs))
    leaves = dict(_flatten(params))
    assert len(flat) == len(rule)
    for fpath, sharding in flat.items():
        inner = fpath[1:] if fpath[0] == "params" else fpath
        key, _ = torch_name(inner, np.ndim(leaves[fpath]))
        spec = tuple(sharding.spec)
        axis = spec.index("fsdp") - len(leaves[fpath].shape) if "fsdp" in spec else None
        want = {None: None, -1: 0, -2: 1}[axis]
        assert rule[key] == want, (fpath, key)
        assert classify(key) == jax_classify(inner)


def test_tp_rules_do_not_shard_embedding_projections():
    """The JAX regression test's paths, as torch parameter names."""
    assert classify("blocks.0.attn.proj.weight") == "row"
    assert classify("down.0.res.0.proj.weight") == "replicate"
    assert classify("ada.proj.weight") == "replicate"
    assert classify("t1.to_q.weight") == "column"
    assert classify("t1.to_out.0.weight") == "row"
    assert classify("blocks.0.attn.qkv.weight") == "column"
    assert classify("t1.to_q.bias") == "replicate"
    assert jax_classify(("down_0", "res_0", "proj", "kernel")) == "replicate"
