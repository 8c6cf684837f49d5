"""dmtpu_torch's CLIP text tower against dmtpu's, in f32 on the CPU.

A tiny tower (width 32, 3 layers, 4 heads, 12 tokens): the JAX params are
perturbed with seeded normals and loaded through the param bridge.  Tolerance
1e-5 (rtol and atol): f32 sums in another order through three layers.  Also a
tiny HF ``CLIPTextModel``, whose ``text_model`` state dict must load strictly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models.stablediffusion.text_encoders import CLIP_TEXT_CONFIGS as JAX_CONFIGS
from dmtpu.models.stablediffusion.text_encoders import CLIPTextTransformer as JaxTower
from dmtpu.models.stablediffusion.text_encoders import FrozenCLIPEmbedder as JaxCLIP
from dmtpu.models.stablediffusion.text_encoders import FrozenOpenCLIPEmbedder as JaxOpenCLIP
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.convert.sd import hf_clip_text_strip
from dmtpu_torch.models.stablediffusion.text_encoders import (
    CLIP_TEXT_CONFIGS,
    CLIPTextTransformer,
    FrozenCLIPEmbedder,
    FrozenCLIPT5Encoder,
    FrozenOpenCLIPEmbedder,
    FrozenT5Embedder,
    quick_gelu,
)
from tests._torch_helpers import perturb

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=64, max_length=12, width=32, layers=3, heads=4)


def _ids(seed=0, batch=3):
    ids = np.random.RandomState(seed).randint(1, TINY["vocab_size"] - 1,
                                              size=(batch, TINY["max_length"]))
    ids[:, 0] = 0
    for row, eot in enumerate((11, 5, 8)[:batch]):  # the EOT (largest id) at differing places
        ids[row, eot] = TINY["vocab_size"] - 1
    return ids


def _pair(act="quick_gelu", projection_dim=None, seed=1):
    jmod = JaxTower(act=act, projection_dim=projection_dim, **TINY)
    params = perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(_ids()),
                               return_pooled=projection_dim is not None), seed)
    tmod = load_flax_params(
        CLIPTextTransformer(act=act, projection_dim=projection_dim, **TINY), params)
    return jmod, params, tmod.eval()


def test_quick_gelu_matches():
    from dmtpu.models.stablediffusion.text_encoders import quick_gelu as jqg

    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jqg(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_configs_are_the_jax_package_s():
    assert CLIP_TEXT_CONFIGS == JAX_CONFIGS


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("output_layer",
                         ["last", "penultimate", "penultimate-nonorm", -2, -1, -4, 0, 1])
def test_tower_output_layers_match(act, output_layer):
    jmod, params, tmod = _pair(act)
    ids = _ids()
    want = np.asarray(jmod.apply(params, jnp.asarray(ids), output_layer=output_layer))
    with torch.no_grad():
        got = tmod(torch.from_numpy(ids), output_layer=output_layer).numpy()
    assert got.shape == (3, TINY["max_length"], TINY["width"])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("projection_dim", [None, 16])
@pytest.mark.parametrize("output_layer", ["last", "penultimate"])
def test_tower_pooled_matches(projection_dim, output_layer):
    jmod, params, tmod = _pair("gelu", projection_dim)
    ids = _ids(seed=2)
    want_z, want_p = jmod.apply(params, jnp.asarray(ids), output_layer=output_layer,
                                return_pooled=True)
    with torch.no_grad():
        got_z, got_p = tmod(torch.from_numpy(ids), output_layer=output_layer, return_pooled=True)
    assert got_p.shape == (3, projection_dim or TINY["width"])
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


def test_output_layer_none_or_outside_the_tower_raises():
    _, _, tmod = _pair()
    with pytest.raises(ValueError, match="layer_idx"):
        tmod(torch.from_numpy(_ids()), output_layer=None)
    for outside in (-5, 4):  # 3 layers: hidden states 0..3
        with pytest.raises(IndexError, match="outside"):
            tmod(torch.from_numpy(_ids()), output_layer=outside)
    with pytest.raises(KeyError):
        FrozenOpenCLIPEmbedder(arch="no-such-tower")


@pytest.mark.parametrize("kind,kw", [
    ("clip", dict(layer="last")),
    ("clip", dict(layer="hidden", layer_idx=-2)),
    ("openclip", dict(layer="penultimate")),
    ("openclip", dict(layer="last")),
])
def test_embedders_match(kind, kw):
    overrides = {k: v for k, v in TINY.items() if k != "max_length"}
    jcls, tcls = (JaxCLIP, FrozenCLIPEmbedder) if kind == "clip" else \
        (JaxOpenCLIP, FrozenOpenCLIPEmbedder)
    jemb = jcls(max_length=TINY["max_length"], config_overrides=overrides, **kw)
    temb = tcls(max_length=TINY["max_length"], config_overrides=overrides, **kw).eval()
    ids = _ids(seed=3)
    params = perturb(jemb.model.init(jax.random.PRNGKey(0), jnp.asarray(ids)), 4)
    load_flax_params(temb.model, params)
    assert temb.output_layer() == jemb.output_layer()
    want = np.asarray(jemb.encode_tokens(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = temb.encode_tokens(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_tokenize_needs_a_tokenizer_and_uses_it():
    emb = FrozenCLIPEmbedder(max_length=5, config_overrides=dict(width=8, layers=1, heads=2,
                                                                 vocab_size=16))
    with pytest.raises(RuntimeError, match="tokenizer"):
        emb.tokenize(["a"])
    emb.tokenizer = lambda texts, **kw: {"input_ids": np.full((len(texts), kw["max_length"]), 3)}
    assert emb.tokenize(["a", "b"]).shape == (2, 5)


@pytest.mark.parametrize("cls", [FrozenT5Embedder, FrozenCLIPT5Encoder])
def test_t5_embedders_wait(cls):
    with pytest.raises(NotImplementedError, match="Queue 1 item K"):
        cls()


def test_hf_clip_text_model_loads_strictly_and_agrees():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPTextConfig(
        vocab_size=TINY["vocab_size"], hidden_size=TINY["width"],
        intermediate_size=4 * TINY["width"],
        num_hidden_layers=TINY["layers"], num_attention_heads=TINY["heads"],
        max_position_embeddings=TINY["max_length"], hidden_act="quick_gelu",
        eos_token_id=TINY["vocab_size"] - 1)
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(cfg).eval()
    tower = CLIPTextTransformer(**TINY).eval()
    tower.load_state_dict(hf_clip_text_strip(hf.state_dict()), strict=True)
    ids = torch.from_numpy(_ids(seed=5))
    with torch.no_grad():
        want = hf(input_ids=ids, output_hidden_states=True)
        last, pooled = tower(ids, "last", return_pooled=True)
        hidden = tower(ids, -2)
    np.testing.assert_allclose(last.numpy(), want.last_hidden_state.numpy(), **TOL)
    np.testing.assert_allclose(hidden.numpy(), want.hidden_states[-2].numpy(), **TOL)
    np.testing.assert_allclose(pooled.numpy(), want.pooler_output.numpy(), **TOL)
