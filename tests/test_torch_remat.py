"""Selective remat (``dmtpu_torch/ops/rematerialize.py``) against the JAX
package's (the twin of ``tests/test_remat.py``), on the CPU in f32.

- Each policy name (and ``True``) gives the gradients of the run without
  remat (atol 1e-6, the JAX test's bound) and those of ``jax.grad`` through
  the JAX module with the same ``use_checkpoint`` (1e-5 relative L2 over all
  gradients), on a tiny SD UNet, DiT, MDTv2 and ADM UNet.
- ``"attn"`` keeps the attention operator's outputs: the backward pass does
  not run the operator's forward again, where full remat does.
- ``normalize_use_checkpoint``'s values and its ``ValueError``.
- LoRA with the UNet's ``use_checkpoint``: the adapters' gradients equal the
  run without remat and ``jax.grad`` through ``apply_lora`` and the JAX
  UNet with remat (1e-4 relative L2, ``tests/test_torch_lora.py``'s bound),
  and two ``train_sd`` steps with remat end where two
  without end.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dmtpu.models import adm as jadm
from dmtpu.models import dit as jdit
from dmtpu.models import lora as jlora
from dmtpu.models import mdt as jmdt
from dmtpu.models.stablediffusion import SDUNetModel as JaxSDUNet
from dmtpu.ops import rematerialize as jremat
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.models import adm as tadm
from dmtpu_torch.models import dit as tdit
from dmtpu_torch.models import mdt as tmdt
from dmtpu_torch.models.lora import init_lora, lora_weights
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.ops import rematerialize as tremat
from dmtpu_torch.scripts import train_sd
from dmtpu_torch.utils import checkpoint as ckpt_lib
from tests._tiny_fixtures import tiny_sd_train_config
from tests._torch_helpers import TINY_SD_UNET_CFG, char_tokenizer_dir, jax_random_params, nhwc, t

POLICIES = [True, "nothing", "dots", "dots_saveable", "dots_no_batch", "attn", "everything"]
DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=2, num_heads=4,
           num_classes=5)
MDT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=4, num_heads=4,
           num_classes=5, decode_layer=1)
ADM = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
           attention_resolutions=[2], dropout=0.0, channel_mult=(1, 2), num_head_channels=16,
           use_scale_shift_norm=True)
SD = dict(TINY_SD_UNET_CFG, attention_resolutions=[2])
RS = np.random.RandomState(0)
X4, X3 = RS.randn(2, 4, 8, 8).astype(np.float32), RS.randn(2, 3, 16, 16).astype(np.float32)
CTX = RS.randn(2, 5, 24).astype(np.float32)
TS, YS = np.array([3, 700]), np.array([1, 4])

# family -> (JAX module class and config, torch class and config, inputs)
FAMILIES = {
    "sd": (JaxSDUNet, SD, SDUNetModel, SD, (X4, TS, CTX)),
    "dit": (jdit.DiT, DIT, tdit.DiT, DIT, (X4, TS, YS)),
    "mdt": (jmdt.MDTv2, MDT, tmdt.MDTv2, MDT, (X4, TS, YS)),
    "adm": (jadm.UNetModel, ADM, tadm.UNetModel, ADM, (X3, TS)),
}


def _jax_args(inputs):
    return (jnp.asarray(nhwc(inputs[0])),) + tuple(jnp.asarray(a) for a in inputs[1:])


def _torch_args(inputs):
    return (t(inputs[0]),) + tuple(t(a) for a in inputs[1:])


@pytest.fixture(scope="module")
def jax_grads():
    """family -> (seeded params, jax.grad of mean(out^2) with full remat)."""
    cache = {}

    def get(family):
        if family not in cache:
            jcls, jcfg, _, _, inputs = FAMILIES[family]
            args = _jax_args(inputs)
            params = jax_random_params(jcls(**jcfg), *(jnp.zeros_like(a[:1]) for a in args))
            jmod = jcls(**jcfg, use_checkpoint=True)
            grads = jax.jit(jax.grad(lambda p: jnp.mean(jmod.apply(p, *args) ** 2)))(params)
            cache[family] = params, state_dict_from_flax(jax.device_get(grads))
        return cache[family]

    return get


def _torch_grads(family, params, use_checkpoint):
    _, _, tcls, tcfg, inputs = FAMILIES[family]
    model = load_flax_params(tcls(**tcfg, use_checkpoint=use_checkpoint), params)
    model(*_torch_args(inputs)).square().mean().backward()
    # MDTv2's mask token gets no gradient from an unmasked forward
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES, ids=str)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_policy_grads_match_no_remat_and_jax(jax_grads, family, policy):
    params, want = jax_grads(family)
    plain = _torch_grads(family, params, False)
    got = _torch_grads(family, params, policy)
    assert got.keys() == plain.keys() == want.keys()
    want = {n: w.reshape(got[n].shape) for n, w in want.items()}  # ADM's [O, I] 1-wide convs
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), plain[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    diff = sum(float(np.square(got[n].double().numpy() - want[n].double().numpy()).sum())
               for n in got)
    norm = sum(float(np.square(want[n].double().numpy()).sum()) for n in got)
    assert norm > 0 and (diff / norm) ** 0.5 <= 1e-5


class _CountAttention(TorchDispatchMode):
    """Counts the runs of the attention operator the dispatcher sees; a
    selective checkpoint that hands back a kept output runs nothing."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func is torch.ops.dmtpu.attention.default
        return func(*args, **(kwargs or {}))


def _attention_op_calls(model, inputs):
    """(forward, backward) runs of the attention operator."""
    with _CountAttention() as mode:
        out = model(*_torch_args(inputs))
        fwd = mode.calls
        out.square().mean().backward()
    return fwd, mode.calls - fwd


@pytest.mark.parametrize("policy,recomputed", [(False, 0), (True, 1), ("dots", 1), ("attn", 0),
                                               ("everything", 0)], ids=str)
def test_attn_keeps_the_attention_op_s_outputs(policy, recomputed):
    """The backward pass runs the operator's forward once per attention
    under full remat (and under "dots": attention is not a dot), never under
    "attn": the recompute takes o and lse from the selective checkpoint."""
    torch.manual_seed(0)
    model = SDUNetModel(**SD, use_checkpoint=policy)
    fwd, bwd = _attention_op_calls(model, (X4, TS, CTX))
    assert fwd == 8 and bwd == recomputed * fwd


def test_normalize_use_checkpoint_matches_jax():
    assert tremat.normalize_use_checkpoint(True) == (True, None) == \
        jremat.normalize_use_checkpoint(True)
    assert tremat.normalize_use_checkpoint(False) == (False, None) == \
        jremat.normalize_use_checkpoint(False)
    assert tremat.normalize_use_checkpoint(0) == (False, None)
    for name in list(jremat.POLICIES) + list(jremat.NAMED_POLICIES):
        on, policy = tremat.normalize_use_checkpoint(name)
        assert on and isinstance(policy, tremat.Policy)
        jax_policy = jremat.checkpoint_policy(name)
        if name in jremat.POLICIES:
            assert policy.name == jremat.POLICIES[name] == jax_policy.__name__
    assert tremat.POLICIES == jremat.POLICIES and tremat.NAMED_POLICIES == jremat.NAMED_POLICIES
    assert tremat.checkpoint_policy(None) is None
    for bad in ("bogus", "dot"):
        with pytest.raises(ValueError, match="unknown checkpoint policy") as e:
            tremat.normalize_use_checkpoint(bad)
        with pytest.raises(ValueError, match="unknown checkpoint policy") as j:
            jremat.normalize_use_checkpoint(bad)
        assert str(e.value) == str(j.value)
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        tdit.DiT(**DIT, use_checkpoint="bogus")


def _torch_path(jax_key):
    return jax_key.removeprefix("params.").removesuffix(".kernel").replace("__", ".")


def test_lora_under_remat_matches_no_remat_and_jax():
    policy = "attn"  # a selective checkpoint around blocks run inside functional_call
    inputs = (X4, TS, CTX)
    args = _jax_args(inputs)
    params = jax_random_params(JaxSDUNet(**SD), *(jnp.zeros_like(a[:1]) for a in args))
    jl = jax.tree.map(lambda v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(9), v.shape),
                      jlora.init_lora(params, jax.random.PRNGKey(3), rank=2))
    jmod = JaxSDUNet(**SD, use_checkpoint=policy)
    want = jax.device_get(jax.jit(jax.grad(
        lambda lo: jnp.mean(jmod.apply(jlora.apply_lora(params, lo, 1.5), *args) ** 2)))(jl))
    grads = []
    for remat in (False, policy):
        model = load_flax_params(SDUNetModel(**SD, use_checkpoint=remat), params)
        model.requires_grad_(False)
        lora = init_lora(model, rank=2)
        with torch.no_grad():
            for key, ab in jl.items():
                for leaf in ("a", "b"):
                    lora.get_parameter(f"{_torch_path(key)}.{leaf}").copy_(
                        t(np.asarray(ab[leaf])))
        adapters = dict(lora.named_parameters())
        merged = lora_weights(dict(model.named_parameters()), adapters, 1.5)
        out = torch.func.functional_call(model, merged, _torch_args(inputs)[:2],
                                         {"context": t(CTX)})
        out.square().mean().backward()
        grads.append({n: p.grad for n, p in adapters.items()})
    diff = norm = 0.0
    for key, g in want.items():
        for leaf in ("a", "b"):
            name = f"{_torch_path(key)}.{leaf}"
            assert grads[1][name] is not None, name
            np.testing.assert_allclose(grads[1][name].numpy(), grads[0][name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
            diff += float(np.square(grads[1][name].double().numpy() - g[leaf]).sum())
            norm += float(np.square(g[leaf]).sum())
    assert norm > 0 and (diff / norm) ** 0.5 <= 1e-4  # tests/test_torch_lora.py's bound


def test_train_sd_lora_with_use_checkpoint(tmp_path):
    """The CLI takes LoRA with the UNet's use_checkpoint; its adapters after
    two steps are those of the run without remat."""
    tok = char_tokenizer_dir(tmp_path / "tokenizer")
    blobs = []
    for remat in (False, True):
        cfg = tiny_sd_train_config(tmp_path / f"conf{remat}.yaml", tok, lora={"rank": 4})
        exp = str(tmp_path / f"exp{remat}")
        train_sd.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu", "train.sample_freq=0",
                       f"model.params.unet_config.params.use_checkpoint={str(remat).lower()}"])
        assert glob.glob(os.path.join(exp, "output-*.log"))
        blobs.append(ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000002")))
    assert blobs[0]["model"].keys() == blobs[1]["model"].keys()
    for name, want in blobs[0]["model"].items():
        torch.testing.assert_close(blobs[1]["model"][name], want, rtol=0, atol=1e-6)
