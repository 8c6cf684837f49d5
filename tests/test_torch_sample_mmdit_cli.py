"""``python -m dmtpu_torch.scripts.sample_mmdit`` against ``scripts/sample_mmdit.py``.

Both CLIs run in process with ``--device cpu`` on the JAX CLI test's tiny
config (MMDiT hidden 32, depth 2, 8x8x3 images, 3 Euler steps).  The demo
pseudo-embeddings and the ``--class_idx`` conditioning must be the JAX
CLI's bytes; from the same params, embeddings and noise (the port's
``_noise`` hands out the JAX CLI's draws) the two write the same PNGs to
one step of 255 (f32 sums in another order may round a pixel the other
way).  Weights load from a JAX ``.npz`` export, a port ``.pt`` and SD3
``.safetensors`` / ``.ckpt`` files alike; a config's guidance scale reaches
the sampler (the JAX CLI drops it).
"""
import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models.mmdit import MMDiT as JaxMMDiT
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.diffusions import FlowDPMSolver, FlowDPMSolverCFG, FlowMatching, FlowMatchingCFG
from dmtpu_torch.models.mmdit import MMDiT
from dmtpu_torch.scripts import sample_mmdit as tcli
from tests._torch_helpers import jax_random_params
from tests.test_convert_mmdit import _to_sgm
from tests.test_sample_mmdit_cli import TINY_CONF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "scripts") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "scripts"))

VAE = """
vae:
  target: models.stablediffusion.autoencoder.AutoEncoderKL
  params: {ch: 32, ch_mult: [1], num_res_blocks: 1, z_channels: 3,
           embed_dim: 3, resolution: 8}
  scale_factor: 1.5
  shift_factor: 0.1
"""
TINY = dict(input_size=8, patch_size=2, in_channels=3, hidden_size=32, depth=2, num_heads=2,
            context_dim=8, pooled_dim=8)


def _conf(tmp_path, extra="", name="conf.yaml"):
    path = tmp_path / name
    path.write_text(TINY_CONF + extra)
    return str(path)


def _jax_params(seed=0):
    m = JaxMMDiT(**TINY)
    y = {"context": jnp.zeros((1, 4, 8)), "pooled": jnp.zeros((1, 8))}
    return jax_random_params(m, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)), y, seed=seed)


def _npz(tmp_path, params):
    path = tmp_path / "w.npz"
    np.savez(path, params=np.asarray(jax.tree.map(np.asarray, params), dtype=object))
    return str(path)


def _emb(tmp_path, ctx_shape=(2, 4, 8), pool_shape=(2, 8), name="emb.npz"):
    rs = np.random.RandomState(1)
    path = tmp_path / name
    np.savez(path, context=rs.randn(*ctx_shape), pooled=rs.randn(*pool_shape))
    return str(path)


def _pngs(d):
    from PIL import Image

    return [np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))]


def _run(argv):
    tcli.main(argv + ["--device", "cpu"])


def _jax_cli():
    import sample_mmdit

    return sample_mmdit


def _args(**kw):
    base = dict(embeddings=None, class_idx=None, prompt=None, weights=None, context_len=None,
                respace_type="uniform", respace_steps=None, solver=None, time_shift=None,
                guidance_scale=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw", [dict(prompt="a tiny square"), dict(prompt=None),
                                dict(prompt="x", context_len=9), dict(class_idx=1)],
                         ids=["prompt", "empty", "context_len", "class_idx"])
def test_conditioning_is_the_jax_cli_s_bytes(tmp_path, kw):
    from dmtpu.utils.config import load_config as jax_load
    from dmtpu_torch.utils.config import load_config

    path = _conf(tmp_path)
    want = _jax_cli()._conditioning(_args(**kw), jax_load(path), None,
                                    __import__("logging").getLogger("t"))
    got = tcli.conditioning(_args(**kw), load_config(path))
    for w, g in zip(want, got):
        assert g.dtype == np.float32 and g.tobytes() == np.asarray(w).tobytes()


def test_embeddings_rank_combinations_and_errors(tmp_path):
    cfg = _conf(tmp_path)
    out = tmp_path / "out"
    _run(["-c", cfg, "--embeddings", _emb(tmp_path, (4, 8), (1, 8)), "--save_dir", str(out),
          "--n_samples", "3", "--batch_size", "2"])
    assert sorted(os.listdir(out)) == ["0.png", "1.png", "2.png"]
    with pytest.raises(SystemExit, match="row-count mismatch"):
        _run(["-c", cfg, "--embeddings", _emb(tmp_path, (2, 4, 8), (8,), "bad.npz"),
              "--save_dir", str(tmp_path / "o2")])
    with pytest.raises(SystemExit, match="out of range"):
        _run(["-c", cfg, "--class_idx", "7", "--save_dir", str(tmp_path / "o3")])
    with pytest.raises(SystemExit, match="pseudo-embeddings"):
        _run(["-c", cfg, "--weights", _npz(tmp_path, _jax_params()), "--prompt", "x",
              "--save_dir", str(tmp_path / "o4")])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main(["-c", cfg, "--save_dir", str(tmp_path / "o5")])


@pytest.mark.parametrize("target,params,flags,want_cls,want_scale", [
    ("diffusions.flow.FlowMatching", "", [], FlowMatchingCFG, 4.0),
    ("diffusions.flow.FlowMatching", "", ["--guidance_scale", "1.0"], FlowMatching, None),
    ("diffusions.flow_dpm.FlowDPMSolverCFG", ", guidance_scale: 3.0", [], FlowDPMSolverCFG, 3.0),
    ("diffusions.flow_dpm.FlowDPMSolverCFG", ", guidance_scale: 3.0",
     ["--guidance_scale", "2.0"], FlowDPMSolverCFG, 2.0),
    ("diffusions.flow_dpm.FlowDPMSolverCFG", ", guidance_scale: 1.0", [], FlowDPMSolver, None),
    ("diffusions.flow_dpm.FlowDPMSolver", ", solver: heun", [], FlowMatchingCFG, 4.0),
    ("diffusions.flow.FlowMatching", ", solver: heun", ["--solver", "dpm"], FlowDPMSolverCFG, 4.0),
], ids=["default", "s1", "config-scale", "flag-wins", "config-s1", "params-solver", "flag-solver"])
def test_solver_precedence_and_the_config_s_guidance_scale(tmp_path, target, params, flags,
                                                           want_cls, want_scale):
    from dmtpu_torch.utils.config import load_config

    text = TINY_CONF.replace("target: diffusions.flow.FlowMatching", f"target: {target}").replace(
        "params: {total_steps: 1000, respace_steps: 3}",
        "params: {total_steps: 1000, respace_steps: 3" + params + "}")
    (tmp_path / "c.yaml").write_text(text)
    args, _ = tcli.build_parser().parse_known_args(["-c", "x", "--save_dir", "y"] + flags)
    d = tcli.make_diffuser(args, load_config(str(tmp_path / "c.yaml")))
    assert type(d) is want_cls
    assert getattr(d, "guidance_scale", None) == want_scale
    if "heun" in params and "--solver" not in flags:
        assert d.solver == "heun"


def _same_pngs(a, b):
    pa, pb = _pngs(a), _pngs(b)
    assert len(pa) == len(pb) > 0
    for x, y in zip(pa, pb):
        diff = np.abs(x.astype(int) - y.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99


@pytest.mark.parametrize("extra,flags", [
    ("", []), ("", ["--solver", "dpm", "--respace_steps", "4"]),
    (VAE, ["--solver", "heun", "--time_shift", "2.0"])], ids=["euler", "dpm", "heun-vae"])
def test_same_pngs_as_the_jax_cli(tmp_path, monkeypatch, extra, flags):
    """Same params (.npz), embeddings and noise: the JAX CLI's images."""
    cfg = _conf(tmp_path, extra)
    params = _jax_params(seed=4)
    w = _npz(tmp_path, params)
    argv = ["-c", cfg, "--weights", w, "--embeddings", _emb(tmp_path), "--n_samples", "3",
            "--batch_size", "2", "--seed", "5"] + flags
    vae_npz = None
    if extra:
        # the VAE's params: the JAX CLI reads an .npz, the port the same through the bridge
        from dmtpu.models.stablediffusion import AutoencoderKL as JaxVAE

        jvae = JaxVAE(ch=32, ch_mult=(1,), num_res_blocks=1, z_channels=3, embed_dim=3,
                      resolution=8)
        vparams = jax_random_params(jvae, jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(0), seed=6)
        vae_npz = tmp_path / "vae.npz"
        np.savez(vae_npz, params=np.asarray(jax.tree.map(np.asarray, vparams), dtype=object))
        argv += ["--vae_weights", str(vae_npz)]
    jcli = _jax_cli()
    monkeypatch.setattr(sys, "argv", ["sample_mmdit.py"] + argv + ["--save_dir",
                                                                  str(tmp_path / "jax")])
    jcli.main()
    # the JAX CLI's noise: split(fold_in(PRNGKey(seed), i)), NHWC
    key = jax.random.PRNGKey(5)

    def jax_noise(batch, shape, generator, device):
        i = jax_noise.calls
        jax_noise.calls += 1
        k_noise, _ = jax.random.split(jax.random.fold_in(key, i))
        z = np.asarray(jax.random.normal(k_noise, (batch, shape[1], shape[2], shape[0])))
        return torch.from_numpy(z.transpose(0, 3, 1, 2).copy()).to(device)

    jax_noise.calls = 0
    monkeypatch.setattr(tcli, "_noise", jax_noise)
    _run(argv + ["--save_dir", str(tmp_path / "port")])
    assert jax_noise.calls == 2
    _same_pngs(tmp_path / "jax", tmp_path / "port")


def test_weights_from_npz_pt_safetensors_and_ckpt_give_one_model(tmp_path):
    from safetensors.torch import save_file

    cfg = _conf(tmp_path)
    params = _jax_params(seed=7)
    model = load_flax_params(MMDiT(**TINY), params)
    files = {"npz": _npz(tmp_path, params)}
    torch.save(model.state_dict(), tmp_path / "port.pt")
    files["pt"] = str(tmp_path / "port.pt")
    sd3 = {f"model.diffusion_model.{k}": torch.from_numpy(np.ascontiguousarray(v, np.float32))
           for k, v in _to_sgm(params).items()
           if not k.startswith(("first_stage_model.", "text_encoders."))}
    save_file(sd3, tmp_path / "sd3.safetensors")
    files["safetensors"] = str(tmp_path / "sd3.safetensors")
    torch.save({"state_dict": sd3}, tmp_path / "sd3.ckpt")
    files["ckpt"] = str(tmp_path / "sd3.ckpt")
    emb = _emb(tmp_path)
    for name, path in files.items():
        _run(["-c", cfg, "--weights", path, "--embeddings", emb, "--save_dir",
              str(tmp_path / name), "--n_samples", "2", "--batch_size", "2"])
    for name in ("pt", "safetensors", "ckpt"):
        assert [p.tobytes() for p in _pngs(tmp_path / name)] == \
            [p.tobytes() for p in _pngs(tmp_path / "npz")], name


def test_vae_decode_hook_and_its_weights(tmp_path):
    from dmtpu_torch.models.stablediffusion import AutoencoderKL
    from dmtpu_torch.utils.config import load_config

    cfg = _conf(tmp_path, VAE)
    conf = load_config(cfg)
    dec = tcli.build_decoder(conf, None, torch.device("cpu"))
    assert isinstance(dec.vae, AutoencoderKL)
    assert (dec.scale_factor, dec.shift_factor) == (1.5, 0.1)
    z = torch.randn(2, 3, 8, 8)
    with torch.no_grad():
        torch.testing.assert_close(dec(z), dec.vae.decode(z / 1.5 + 0.1))
    # an SD3 bundle's first_stage_model tensors, and the VAE's own keys
    own = {k: torch.randn_like(v) for k, v in dec.vae.state_dict().items()}
    torch.save({"state_dict": {f"first_stage_model.{k}": v for k, v in own.items()}},
               tmp_path / "bundle.ckpt")
    torch.save(own, tmp_path / "own.pt")
    for name in ("bundle.ckpt", "own.pt"):
        got = tcli.build_decoder(conf, str(tmp_path / name), torch.device("cpu"))
        assert all(torch.equal(got.vae.state_dict()[k], own[k]) for k in own)
    assert tcli.build_decoder(load_config(_conf(tmp_path, name="novae.yaml")), None,
                              torch.device("cpu")) is None
    out = tmp_path / "out"
    _run(["-c", cfg, "--prompt", "latents", "--save_dir", str(out), "--n_samples", "1",
          "--batch_size", "1", "--vae_weights", str(tmp_path / "own.pt")])
    assert _pngs(out)[0].shape == (8, 8, 3)


def test_request_function_cycles_rows_and_seeds_by_batch():
    """Three samples in batches of 2 and 1 over two conditioning rows.

    Bit for bit where both sides run at the same batch shape: the request
    run twice, and its last batch (one sample) against the same batch of
    another request.  A sample made in a batch of 2 against the same sample
    made alone: within 1e-5 absolute (the CPU matmul rounds another batch
    size otherwise, 1.1e-6 seen); a wrong seed or row moves it by about 2.
    """
    model = MMDiT(**TINY).eval()
    generator = torch.Generator().manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1, generator=generator)
    d = FlowMatchingCFG(4.0, total_steps=1000, respace_steps=2)
    rs = np.random.RandomState(0)
    ctx, pooled = rs.randn(2, 4, 8).astype(np.float32), rs.randn(2, 8).astype(np.float32)
    kw = dict(shape=(3, 8, 8), seed=3, device="cpu")
    a, stages = tcli.sample_mmdit(model, d, ctx, pooled, 3, batch_size=2, **kw)
    assert a.shape == (3, 3, 8, 8) and stages == {} and a.abs().max() <= 1.0
    b, _ = tcli.sample_mmdit(model, d, ctx, pooled, 3, batch_size=2, **kw)
    assert torch.equal(a, b)
    # batch 0 alone: sample 0 (row 0, batch 0's seed) made at batch 1
    c, _ = tcli.sample_mmdit(model, d, ctx[:1], pooled[:1], 1, batch_size=1, **kw)
    assert (a[0] - c[0]).abs().max() <= 1e-5
    # batch 1 of the request is sample 2 with row 0 (rows cycle) and its own
    # seed: batch 1 of a request of two single-sample batches over row 0 twice
    e, _ = tcli.sample_mmdit(model, d, ctx[[0, 0]], pooled[[0, 0]], 2, batch_size=1, **kw)
    assert torch.equal(a[2], e[1])
    assert (a[2] - c[0]).abs().max() > 0.5 and (e[1] - e[0]).abs().max() > 0.5
