"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Each test builds a JAX-package module and its ``dmtpu_torch`` counterpart,
makes inputs with numpy from a seed, hands the same weights to both and
compares the outputs.  Every JAX param leaf is perturbed with seeded normals
before it is copied, so a zero-initialised layer cannot hide a mismatch.
"""
from __future__ import annotations

import numpy as np
import torch

# the suite runs under xdist with several workers on a few cores
torch.set_num_threads(1)

SD15_UNET_CFG = dict(
    in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
    attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4), num_heads=8,
    use_spatial_transformer=True, transformer_depth=1, context_dim=768, legacy=False)

# the tiny SD config of tests/test_stablediffusion.py
TINY_SD_UNET_CFG = dict(
    image_size=32, in_channels=4, out_channels=4, model_channels=32,
    attention_resolutions=[2, 1], num_res_blocks=1, channel_mult=[1, 2],
    num_heads=2, use_spatial_transformer=True, transformer_depth=1,
    context_dim=24, legacy=False)


def perturb(params, seed: int, std: float = 0.05):
    """Copy of a Flax params tree (as numpy) with seeded normals added to
    every leaf."""
    rs = np.random.RandomState(seed)

    def go(tree):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: go(v) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        return (a + std * rs.randn(*a.shape)).astype(np.float32)

    return go(params)


def nhwc(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 2, 3, 1))


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def jax_sd_params(jsd, img_size: int, seed: int = 0) -> dict:
    """``jsd.init_params``'s {"unet", "vae", "text_encoder"} layout, each
    part's init compiled (the wrapper's own init runs op by op: ~40 s for
    the tiny stack on the CPU), every leaf perturbed with seeded normals."""
    import jax
    import jax.numpy as jnp

    k_unet, k_vae, k_text = jax.random.split(jax.random.PRNGKey(seed), 3)
    lat, max_len = img_size // 8, jsd.text_encoder.max_length
    raw = {
        "unet": jax.jit(jsd.unet.init)(
            k_unet, jnp.zeros((1, lat, lat, jsd.unet.in_channels)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, max_len, jsd.unet.context_dim))),
        "vae": jax.jit(lambda k, x: jsd.vae.init(k, x, rng=jax.random.PRNGKey(0)))(
            k_vae, jnp.zeros((1, img_size, img_size, 3))),
        "text_encoder": jax.jit(jsd.text_encoder.model.init)(
            k_text, jnp.ones((1, max_len), jnp.int32)),
    }
    return {name: {"params": perturb(raw[name]["params"], i)}
            for i, name in enumerate(("unet", "vae", "text_encoder"))}


def char_tokenizer_dir(path) -> str:
    """A local CLIPTokenizer directory with a character-level vocabulary
    (a-z, 0-9): the tokenizer of ``tests/_tiny_fixtures.py::make_tiny_clip_dir``
    without its Flax CLIP model."""
    import json
    import os

    from transformers import CLIPTokenizer

    os.makedirs(path, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    vocab_file, merges_file = os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
    with open(vocab_file, "w") as f:
        json.dump(vocab, f)
    with open(merges_file, "w") as f:
        f.write("#version: 0.2\n")
    CLIPTokenizer(vocab_file, merges_file).save_pretrained(str(path))
    return str(path)


def jax_random_params(module, *args, seed: int = 0) -> dict:
    """Seeded random Flax params for ``module.init(key, *args)`` without
    running the init (``jax.eval_shape`` traces it in seconds where the init
    itself compiles for tens): kernels N(0, 1 / fan_in), norm scales
    1 + N(0, 0.05^2), biases and everything else N(0, 0.05^2), each in the
    dtype the module declares for it (bf16 under ``param_dtype``)."""
    import jax

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rs = np.random.RandomState(seed)

    def go(tree, name=""):
        if hasattr(tree, "items"):
            return {k: go(v, k) for k, v in tree.items()}
        noise = rs.randn(*tree.shape).astype(np.float32)
        if name == "kernel":
            return (noise / np.sqrt(np.prod(tree.shape[:-1]))).astype(tree.dtype)
        return ((1.0 if name == "scale" else 0.0) + 0.05 * noise).astype(tree.dtype)

    return {"params": go(shapes["params"])}
