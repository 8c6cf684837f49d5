"""dmtpu_torch's T5 text path against dmtpu's, in f32 on the CPU.

- ``FrozenT5Embedder`` on a tiny random torch ``T5EncoderModel`` saved to a
  local directory with a character-level tokenizer (the JAX package's
  ``tests/test_t5_encoder.py::tiny_t5_dir``, plus the tokenizer), against the
  JAX wrapper loading the same directory (its ``from_pt`` conversion): the
  last hidden state of the same ids, and ``encode`` of the same texts through
  the directory's tokenizer, at 2e-4 (the JAX test's tolerance against the
  torch tower: f32 through two layers of another framework's kernels).
- ``FrozenCLIPT5Encoder`` against the JAX one: ``[clip_z, t5_z]``, the CLIP
  half (a tiny tower, its JAX params carried by the bridge) at 1e-5, the T5
  half at 2e-4.
- An injected module, state dict and tokenizer are what the embedder uses;
  the checkpoint replaces none of them.
- A directory with Flax weights alone is refused, naming what it needs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models.stablediffusion.text_encoders import FrozenCLIPEmbedder as JaxCLIP
from dmtpu.models.stablediffusion.text_encoders import FrozenCLIPT5Encoder as JaxCLIPT5
from dmtpu.models.stablediffusion.text_encoders import FrozenT5Embedder as JaxT5
from dmtpu_torch.convert import load_flax_params
from chip_smoke import write_char_t5_tokenizer
from dmtpu_torch.models.stablediffusion.text_encoders import (
    FrozenCLIPEmbedder,
    FrozenCLIPT5Encoder,
    FrozenT5Embedder,
)
from tests._torch_helpers import jax_random_params

CPU = jax.devices("cpu")[0]
T5_TOL = dict(rtol=2e-4, atol=2e-4)
CLIP_TOL = dict(rtol=1e-5, atol=1e-5)
TINY_CLIP = dict(vocab_size=64, width=32, layers=2, heads=4)
TEXTS = ["a cat", "two dogs on a hill 42"]


def save_tiny_t5(path, seed: int = 0):
    """A random torch ``T5EncoderModel`` (d_model 32, 2 layers, 4 heads of 8,
    gated-gelu) and ``chip_smoke.py``'s character-level tokenizer (a-z, 0-9,
    space; T5's <pad>, </s> and <unk>: ``AutoTokenizer`` loads it without
    ``sentencepiece``), saved to ``path``."""
    from transformers import T5Config, T5EncoderModel

    cfg = T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                   feed_forward_proj="gated-gelu")
    torch.manual_seed(seed)
    model = T5EncoderModel(cfg).eval()
    model.save_pretrained(str(path), safe_serialization=False)
    write_char_t5_tokenizer(str(path))
    return str(path), model


@pytest.fixture(scope="module")
def tiny_t5_dir(tmp_path_factory):
    return save_tiny_t5(tmp_path_factory.mktemp("tiny_t5"))


@pytest.fixture(scope="module")
def jax_t5(tiny_t5_dir):
    with jax.default_device(CPU):
        enc = JaxT5(version=tiny_t5_dir[0], max_length=16)
        enc._ensure_loaded()
    return enc


# ids of the width the tokenizer pads to (one shape for every JAX call here)
IDS = np.pad(np.array([[3, 17, 99, 1], [5, 5, 2, 88]], np.int32), ((0, 0), (0, 12)))
IDS[1, 4:8] = [77, 1, 0, 127]


def test_t5_embedder_matches_the_jax_wrapper(tiny_t5_dir, jax_t5):
    path, _ = tiny_t5_dir
    enc = FrozenT5Embedder(version=path, max_length=16)
    assert enc.module is None  # loaded at first use
    got = enc.encode_tokens(IDS)
    assert isinstance(enc.module, torch.nn.Module) and not enc.module.training
    assert not any(p.requires_grad for p in enc.module.parameters())
    with jax.default_device(CPU):
        want = np.asarray(jax_t5.encode_tokens(jax_t5.params, jnp.asarray(IDS)))
    assert got.shape == (2, 16, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **T5_TOL)
    # through the directory's tokenizer: the same ids, the same encodings
    np.testing.assert_array_equal(enc.tokenize(TEXTS), jax_t5.tokenize(TEXTS))
    assert enc.tokenize(TEXTS).shape == (2, 16)
    with jax.default_device(CPU):
        want = np.asarray(jax_t5.encode(TEXTS))
    np.testing.assert_allclose(enc.encode(TEXTS).numpy(), want, **T5_TOL)


def test_t5_embedder_loads_in_the_dtype_asked(tiny_t5_dir):
    enc = FrozenT5Embedder(version=tiny_t5_dir[0], max_length=16, dtype="bfloat16")
    assert enc.encode_tokens(IDS).dtype == torch.bfloat16
    f32 = FrozenT5Embedder(version=tiny_t5_dir[0], max_length=16).encode_tokens(IDS)
    got = enc.encode_tokens(IDS).float()
    assert ((got - f32).norm() / f32.norm()).item() < 5e-2


def test_clip_t5_encoder_matches_the_jax_one(tiny_t5_dir, jax_t5):
    path, _ = tiny_t5_dir
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path)
    with jax.default_device(CPU):
        jdual = JaxCLIPT5(t5_version=path, clip_max_length=10, t5_max_length=16,
                          clip_tokenizer=tok, t5_module=jax_t5.module, t5_params=jax_t5.params,
                          t5_tokenizer=tok)
        # a tiny CLIP tower in place of CLIP-L's full width
        jdual.clip_encoder = JaxCLIP("clip-vit-l", max_length=10, tokenizer=tok,
                                     config_overrides=TINY_CLIP)
        clip_params = jax_random_params(jdual.clip_encoder.model, jnp.ones((1, 10), jnp.int32),
                                        seed=3)
        want = jdual.encode(TEXTS, clip_params=clip_params)
    dual = FrozenCLIPT5Encoder(t5_version=path, clip_max_length=10, t5_max_length=16,
                               clip_tokenizer=tok)
    dual.clip_encoder = FrozenCLIPEmbedder("clip-vit-l", max_length=10, tokenizer=tok,
                                           config_overrides=TINY_CLIP)
    load_flax_params(dual.clip_encoder.model, clip_params)
    got = dual.encode(TEXTS)
    assert isinstance(got, list) and len(got) == 2
    assert got[0].shape == (2, 10, 32) and got[1].shape == (2, 16, 32)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), **CLIP_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **T5_TOL)
    # the default is CLIP-L at full width beside the T5 of the directory
    full = FrozenCLIPT5Encoder(t5_version=path, device="meta")
    assert full.clip_encoder.model.width == 768 and full.t5_encoder.max_length == 77


def test_injected_module_params_and_tokenizer_are_kept(tiny_t5_dir):
    path, model = tiny_t5_dir
    from transformers import T5EncoderModel

    other = T5EncoderModel(model.config)  # other random weights

    def tok(texts, **kw):
        return {"input_ids": np.full((len(texts), kw["max_length"]), 5)}

    enc = FrozenT5Embedder(version=path, module=other, tokenizer=tok, max_length=4)
    assert enc.module is other and enc.tokenizer is tok
    got = enc.encode(["x"])
    assert enc.module is other and enc.tokenizer is tok  # the checkpoint replaced neither
    with torch.no_grad():
        want = other(input_ids=torch.full((1, 4), 5)).last_hidden_state
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # an injected state dict is what the loaded module carries, and stays the same object
    params = {k: v.clone() for k, v in other.state_dict().items()}
    enc = FrozenT5Embedder(version=path, params=params, max_length=4)
    assert enc.params is params and enc.module is None
    torch.testing.assert_close(enc.encode_tokens(np.full((1, 4), 5)), want, rtol=0, atol=0)
    assert enc.params is params and enc.module is not other


def test_a_flax_only_directory_is_refused(tmp_path):
    from transformers import T5Config

    T5Config(vocab_size=16, d_model=8, d_kv=4, d_ff=8, num_layers=1,
             num_heads=2).save_pretrained(str(tmp_path))
    (tmp_path / "flax_model.msgpack").write_bytes(b"\0")
    enc = FrozenT5Embedder(version=str(tmp_path))
    with pytest.raises(ValueError, match="Flax weights only.*torch weights.*from_flax"):
        enc.encode_tokens(np.zeros((1, 3), np.int64))
    assert enc.module is None
    assert sorted(os.listdir(tmp_path)) == ["config.json", "flax_model.msgpack"]
