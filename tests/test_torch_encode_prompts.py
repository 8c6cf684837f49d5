"""``python -m dmtpu_torch.scripts.encode_prompts`` against ``scripts/encode_prompts.py``.

The six tests of ``tests/test_encode_prompts.py``, each held against the JAX
functions or CLI on the same inputs, on the CPU:

- the demo rows are the JAX CLI's and ``sample_mmdit --prompt``'s, byte for
  byte;
- ``assemble_sd3`` gives the JAX assembly exactly, and refuses a CLIP width
  wider than the T5 one with its message;
- ``encode_real`` on tiny CLIP towers (their JAX params carried by the
  bridge) with ``--no_t5`` at 1e-5 and with a tiny T5 at 2e-4 (the JAX T5
  test's tolerance);
- the CLI's demo ``.npz`` (``--include_uncond``) read by the port's
  ``sample_mmdit --embeddings``, and the same file as the JAX CLI's;
- towers from a JAX-package ``.npz`` (with the config
  ``scripts/convert_checkpoint.py`` embeds) and from a torch file, through
  the CLI's real mode with ``--no_t5`` and with ``--t5_dir``; the head count
  comes from the file's config, else the preset's;
- argument errors with the JAX CLI's messages.
"""
import json
import os
import sys
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models.stablediffusion.text_encoders import FrozenCLIPEmbedder as JaxCLIP
from dmtpu.models.stablediffusion.text_encoders import FrozenOpenCLIPEmbedder as JaxOpenCLIP
from dmtpu.models.stablediffusion.text_encoders import FrozenT5Embedder as JaxT5
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.models.stablediffusion.text_encoders import (
    FrozenCLIPEmbedder,
    FrozenOpenCLIPEmbedder,
    FrozenT5Embedder,
)
from dmtpu_torch.scripts import encode_prompts as tcli
from dmtpu_torch.scripts import sample_mmdit as tsample
from tests._torch_helpers import char_tokenizer_dir, jax_random_params
from tests.test_torch_t5 import save_tiny_t5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "scripts") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "scripts"))

import encode_prompts as jcli  # noqa: E402  (the JAX CLI)

CPU = jax.devices("cpu")[0]
T = 8  # tokens
L_CFG = dict(width=8, layers=2, heads=2, vocab_size=80, act="quick_gelu")
G_CFG = dict(width=18, layers=2, heads=3, vocab_size=80, act="gelu", projection_dim=12)
PROMPTS = ["a cat", "a dog 7"]


def test_demo_rows_are_the_jax_cli_s_and_sample_mmdit_s():
    got = tcli.demo_rows(PROMPTS, 4, 8, 6)
    want = jcli.demo_rows(PROMPTS, 4, 8, 6)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    for i, text in enumerate(PROMPTS):
        ctx, pool = tsample.demo_embeddings(text, 4, 8, 6)
        assert ctx[0].tobytes() == got[0][i].tobytes() and pool[0].tobytes() == got[1][i].tobytes()
    assert not np.allclose(got[0][0], got[0][1])


def test_assemble_sd3_is_the_jax_assembly():
    rs = np.random.RandomState(0)
    parts = [rs.randn(2, 3, 4), rs.randn(2, 4), rs.randn(2, 3, 6), rs.randn(2, 6),
             rs.randn(2, 5, 16)]
    parts = [p.astype(np.float32) for p in parts]
    ctx, pool = tcli.assemble_sd3(*map(torch.from_numpy, parts))
    jctx, jpool = jcli.assemble_sd3(*map(jnp.asarray, parts))
    assert ctx.shape == (2, 8, 16) and pool.shape == (2, 10)
    np.testing.assert_array_equal(ctx.numpy(), np.asarray(jctx))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
    with pytest.raises(ValueError, match="CLIP joint width 10 exceeds the T5/context width 8"):
        tcli.assemble_sd3(*map(torch.from_numpy, parts[:4]), torch.zeros(2, 5, 8))


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """(JAX and port CLIP-L-like / bigG-like tiny towers with one seeded set
    of params, a character tokenizer, a tiny T5 directory)."""
    root = tmp_path_factory.mktemp("towers")
    from transformers import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(char_tokenizer_dir(root / "clip_tok"))
    jl = JaxCLIP("clip-vit-l", max_length=T, tokenizer=tok, config_overrides=L_CFG)
    jg = JaxOpenCLIP("open-clip-vit-bigg", max_length=T, tokenizer=tok, config_overrides=G_CFG)
    ids = jnp.zeros((1, T), jnp.int32)

    def pooled_init(module):  # the pooled branch declares the projection
        return SimpleNamespace(init=partial(module.init, output_layer="penultimate-nonorm",
                                            return_pooled=True))

    lp = jax_random_params(pooled_init(jl.model), ids, seed=1)
    gp = jax_random_params(pooled_init(jg.model), ids, seed=2)
    tl = FrozenCLIPEmbedder("clip-vit-l", max_length=T, tokenizer=tok, config_overrides=L_CFG)
    tg = FrozenOpenCLIPEmbedder("open-clip-vit-bigg", max_length=T, tokenizer=tok,
                                config_overrides=G_CFG)
    load_flax_params(tl.model, lp)
    load_flax_params(tg.model, gp)
    t5_dir, _ = save_tiny_t5(root / "t5", seed=4)
    return dict(root=root, jl=jl, jg=jg, lp=lp, gp=gp, tl=tl, tg=tg, t5_dir=t5_dir,
                tok_dir=str(root / "clip_tok"))


def test_encode_real_matches_the_jax_towers_with_and_without_t5(towers):
    with jax.default_device(CPU):
        jt5 = JaxT5(version=towers["t5_dir"], max_length=T)
        want = jcli.encode_real(PROMPTS, towers["jl"], towers["jg"], None, towers["lp"],
                                towers["gp"], context_dim=48)
        want_t5 = jcli.encode_real(PROMPTS, towers["jl"], towers["jg"], jt5, towers["lp"],
                                   towers["gp"])
    got = tcli.encode_real(PROMPTS, towers["tl"], towers["tg"], None, context_dim=48)
    got_t5 = tcli.encode_real(PROMPTS, towers["tl"], towers["tg"],
                              FrozenT5Embedder(towers["t5_dir"], max_length=T))
    assert got[0].shape == (2, 2 * T, 48) and got[1].shape == (2, 8 + 12)
    assert got_t5[0].shape == (2, 2 * T, 32) and got_t5[1].shape == (2, 8 + 12)
    for (c, p), (jc, jp), tol in ((got, want, 1e-5), (got_t5, want_t5, 2e-4)):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=tol, atol=tol)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    ctx = got[0].numpy()
    np.testing.assert_array_equal(ctx[:, :T, 8 + 18:], 0.0)  # the width pad
    np.testing.assert_array_equal(ctx[:, T:], 0.0)  # the zero-filled T5 half
    assert np.abs(ctx[:, :T, :26]).sum() > 0 and not np.allclose(ctx[0], ctx[1])
    with pytest.raises(ValueError, match="--no_t5 needs --context_dim"):
        tcli.encode_real(PROMPTS, towers["tl"], towers["tg"], None)


def test_cli_demo_npz_feeds_sample_mmdit(tmp_path, monkeypatch):
    from tests.test_sample_mmdit_cli import TINY_CONF

    out = tmp_path / "emb.npz"
    argv = ["--out", str(out), "--prompts", "a cat", "a dog", "--include_uncond",
            "--context_len", "4", "--context_dim", "8", "--pooled_dim", "8"]
    tcli.main(argv + ["--device", "cpu"])
    data = dict(np.load(out))
    assert data["context"].shape == (3, 4, 8) and data["pooled"].shape == (3, 8)
    np.testing.assert_array_equal(data["context"][-1], 0.0)
    jout = tmp_path / "jax.npz"
    monkeypatch.setattr(sys, "argv", ["encode_prompts.py"] + argv[2:] + ["--out", str(jout)])
    jcli.main()
    want = dict(np.load(jout))
    for key in ("context", "pooled"):
        assert data[key].tobytes() == want[key].tobytes()
    conf = tmp_path / "conf.yaml"
    conf.write_text(TINY_CONF)
    tsample.main(["-c", str(conf), "--embeddings", str(out), "--save_dir", str(tmp_path / "png"),
                  "--n_samples", "3", "--batch_size", "3", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "png")) == ["0.png", "1.png", "2.png"]


def _tower_files(towers, tmp_path):
    """clip_l as a JAX-package .npz with convert_checkpoint's config, clip_g as a
    torch file with its config beside the state dict."""
    l_npz = tmp_path / "clip_l.npz"
    np.savez(l_npz, params=np.asarray(jax.tree.map(np.asarray, towers["lp"]), dtype=object),
             config=json.dumps(dict(L_CFG, max_length=T)))
    g_pt = tmp_path / "clip_g.pt"
    torch.save({"state_dict": towers["tg"].model.state_dict(), "config": dict(G_CFG, max_length=T)},
               g_pt)
    return str(l_npz), str(g_pt)


def test_towers_from_npz_and_torch_files_through_the_cli(towers, tmp_path, monkeypatch):
    l_npz, g_pt = _tower_files(towers, tmp_path)
    # the torch tower read back is the one written; its heads are the file's (3, not 18 // 64)
    g = tcli.load_tower(g_pt, "open-clip-vit-bigg", 77)
    l = tcli.load_tower(l_npz, "clip-vit-l", 77)
    assert l.max_length == g.max_length == T
    assert g.encoder.layers[0].self_attn.heads == 3 and l.encoder.layers[0].self_attn.heads == 2
    for a, b in ((l, towers["tl"].model), (g, towers["tg"].model)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                     b.state_dict().values()))
    # a config without a head count takes the preset's, never width // 64
    bare = tmp_path / "bare.pt"
    cfg = {k: v for k, v in G_CFG.items() if k != "heads"}
    state = {k: v for k, v in towers["tg"].model.state_dict().items()}
    torch.save({"state_dict": state, "config": dict(cfg, width=40, max_length=T)}, bare)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tcli.load_tower(str(bare), "open-clip-vit-bigg", 77)  # its tensors are 18 wide
    torch.save(dict(state, config=dict(cfg, max_length=T)), bare)
    assert tcli.load_tower(str(bare), "open-clip-vit-bigg", 77).encoder.layers[0] \
        .self_attn.heads == 20

    with jax.default_device(CPU):
        want = jcli.encode_real(PROMPTS, towers["jl"], towers["jg"], None, towers["lp"],
                                towers["gp"], context_dim=48)
        want_t5 = jcli.encode_real(PROMPTS, towers["jl"], towers["jg"],
                                   JaxT5(version=towers["t5_dir"], max_length=T), towers["lp"],
                                   towers["gp"])
    base = ["--prompts", *PROMPTS, "--clip_l_weights", l_npz, "--clip_g_weights", g_pt,
            "--max_length", str(T), "--clip_tokenizer", towers["tok_dir"], "--device", "cpu"]
    for extra, (wctx, wpool), tol in ((["--no_t5", "--context_dim", "48"], want, 1e-5),
                                      (["--t5_dir", towers["t5_dir"]], want_t5, 2e-4)):
        out = tmp_path / "emb.npz"
        tcli.main(["--out", str(out), *base, *extra])
        data = dict(np.load(out))
        np.testing.assert_allclose(data["context"], np.asarray(wctx), rtol=tol, atol=tol)
        np.testing.assert_allclose(data["pooled"], np.asarray(wpool), rtol=1e-5, atol=1e-5)


def test_cli_argument_errors_are_the_jax_cli_s(tmp_path, monkeypatch):
    monkeypatch.delenv("DMTPU_CLIP_TOKENIZER", raising=False)
    out = str(tmp_path / "x.npz")
    cases = [([], "no prompts"),
             (["--prompts", "p", "--clip_l_weights", "l.npz"], "BOTH"),
             (["--prompts", "p", "--clip_l_weights", "l.npz", "--clip_g_weights", "g.npz"],
              "t5_dir or --no_t5"),
             (["--prompts", "p", "--clip_l_weights", "l.npz", "--clip_g_weights", "g.npz",
               "--no_t5"], "--clip_tokenizer")]
    for argv, fragment in cases:
        monkeypatch.setattr(sys, "argv", ["encode_prompts.py", "--out", out, *argv])
        with pytest.raises(SystemExit) as want:
            jcli.main()
        with pytest.raises(SystemExit) as got:
            tcli.main(["--out", out, *argv, "--device", "cpu"])
        assert str(got.value) == str(want.value) and fragment in str(got.value)
    # the device: cuda by default, which fails without a card before anything is written
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main(["--out", out, "--prompts", "p"])
        assert not os.path.exists(out)
