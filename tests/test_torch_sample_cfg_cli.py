"""``python -m dmtpu_torch.scripts.sample_cfg`` on the CPU.

The cases of ``tests/test_cli_dp.py``'s ``sample_cfg`` test on a tiny latent
DiT: the JAX package's ``.npz`` export of the wrapper's params (with and
without the VAE's), an upstream DiT state dict with a diffusers-named VAE, the
VAE-less branch that saves latents, ``--guidance_interval``; ``--sampler
flow`` against the JAX ``FlowMatchingCFG`` request on a DiT without learned
variance; the pixel targets (``UNetCategorialAdaGN`` from an ``.npz``,
``UNetCombined`` from two upstream files through ``forward_cfg``) against the
JAX DDIMCFG request on the same noise; the refusals (``flow`` on a
learned-variance model, a guidance interval on a solver, no card);
and the helpers of ``dmtpu_torch/scripts/_common.py``.
"""
import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.models.latent import LatentDiffusionWrapper as JaxWrapper
from dmtpu.utils.config import instantiate_from_config as jax_instantiate
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.diffusions import DDIMCFG, DDPMCFG, DPMSolverPPCFG, get_respaced_seq
from dmtpu_torch.models.dit import DiT
from dmtpu_torch.scripts import _common, sample_cfg
from dmtpu_torch.utils.config import Config, instantiate_from_config, load_config
from tests._tiny_fixtures import _tiny_sd_model, write_yaml
from tests._torch_helpers import jax_random_params
from tests.test_torch_vae import _diffusers_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = {"target": "models.dit.model.DiT",
       "params": {"input_size": 4, "patch_size": 2, "in_channels": 4, "hidden_size": 32,
                  "depth": 2, "num_heads": 4, "num_classes": 5, "learn_sigma": True}}
VAE = {"target": "models.dit.autoencoder.AutoEncoderKL",
       "params": _tiny_sd_model()["params"]["vae_config"]["params"]}
DIFFUSION = {"target": "diffusions.ddpm.DDPM",
             "params": {"total_steps": 50, "respace_type": "uniform", "respace_steps": 4,
                        "var_type": "learned_range"}}


def _conf(tmp_path, model=None):
    return write_yaml(tmp_path / "latent.yaml", {
        "data": {"params": {"img_size": 32}, "img_channels": 3, "num_classes": 5},
        "model": model or {"target": "models.dit.dit.DiT",
                           "params": {"vit_config": VIT, "vae_config": VAE}},
        "diffusion": DIFFUSION})


@pytest.fixture(scope="module")
def jax_params():
    """The JAX wrapper's seeded random {"vit", "vae"} params (numpy)."""
    jw = JaxWrapper(vit_config=VIT, vae_config=VAE)
    vit = jax_random_params(jw.vit, jnp.zeros((1, 4, 4, 4)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1,), jnp.int32), seed=1)
    vae = jax_random_params(jw.vae, jnp.zeros((1, 32, 32, 3)), jnp.zeros((2,), jnp.uint32),
                            seed=2)
    return {"vit": vit, "vae": vae}


@pytest.fixture(scope="module")
def port(jax_params):
    """The port's wrapper with those params."""
    w = instantiate_from_config({"target": "models.dit.dit.DiT",
                                 "params": {"vit_config": VIT, "vae_config": VAE}})
    load_flax_params(w.vit, jax_params["vit"])
    load_flax_params(w.vae, jax_params["vae"])
    return w.eval()


def _npz(tmp_path, params):
    path = tmp_path / "latent.npz"
    np.savez(path, params=np.asarray(params, dtype=object))
    return str(path)


def _run(tmp_path, weights, extra=(), conf=None, out="out"):
    save_dir = tmp_path / out
    sample_cfg.main(["-c", conf or _conf(tmp_path), "--weights", weights,
                     "--save_dir", str(save_dir), "--batch_size", "4",
                     "--n_samples_each_class", "2", "--class_ids", "1", "3",
                     "--guidance_scale", "2.0", "--device", "cpu", *extra])
    return save_dir


def _images(save_dir, c):
    from PIL import Image

    files = sorted(os.listdir(save_dir / f"class{c}"))
    return files, [np.asarray(Image.open(save_dir / f"class{c}" / f)) for f in files]


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpmpp", "pfdiff"])
def test_npz_branch_decodes_with_the_vae(tmp_path, jax_params, sampler):
    save_dir = _run(tmp_path, _npz(tmp_path, jax_params), ["--sampler", sampler])
    for c in (1, 3):
        files, ims = _images(save_dir, c)
        assert files == ["0.png", "1.png"]
        assert all(im.shape == (32, 32, 3) and im.dtype == np.uint8 for im in ims)


def test_npz_branch_without_vae_saves_latents(tmp_path, jax_params):
    """The JAX CLI's own test case: a ``{"vit", "vae": None}`` export."""
    save_dir = _run(tmp_path, _npz(tmp_path, {"vit": jax_params["vit"], "vae": None}),
                    ["--sampler", "dpmpp"])
    files, ims = _images(save_dir, 1)
    assert files == ["0.png", "1.png"] and ims[0].shape == (4, 4, 4)  # 4-channel latents


def _upstream_files(tmp_path, port):
    vit_sd = {k: v.clone() for k, v in port.vit.state_dict().items()}
    vit_sd["pos_embed"] = port.vit.pos_embed.clone()  # upstream checkpoints carry it
    wpath = tmp_path / "DiT-tiny.pt"
    torch.save(vit_sd, wpath)
    compvis = {k: v.numpy() for k, v in port.vae.state_dict().items()}
    vae_sd = _diffusers_keys(compvis, 4, legacy=False)
    vpath = tmp_path / "vae.pt"
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in vae_sd.items()}}, vpath)
    return str(wpath), str(vpath)


def test_upstream_branch_with_a_diffusers_vae_matches_sample_class(tmp_path, port):
    wpath, vpath = _upstream_files(tmp_path, port)
    save_dir = _run(tmp_path, wpath, ["--vae_weights", vpath, "--sampler", "ddim",
                                      "--seed", "7"])
    files, ims = _images(save_dir, 3)
    assert files == ["0.png", "1.png"] and ims[0].shape == (32, 32, 3)
    # the CLI's images are sample_class's for the same seed, class and sampler
    conf = load_config(_conf(tmp_path))
    args = argparse.Namespace(respace_type="uniform", respace_steps=None, sampler="ddim",
                              guidance_scale=2.0, var_type=None, guidance_interval=None,
                              ddim_eta=0.0)
    want = sample_cfg.sample_class(port, sample_cfg.make_diffuser(args, conf), 3, 2,
                                   shape=(4, 4, 4), num_classes=5, batch_size=4, seed=7,
                                   device="cpu")
    from dmtpu_torch.utils.misc import image_norm_to_uint8

    want = image_norm_to_uint8(want.permute(0, 2, 3, 1).numpy())
    assert np.abs(np.stack(ims).astype(int) - want.astype(int)).max() <= 1
    assert not np.array_equal(ims[0], ims[1])


def test_vae_less_upstream_branch_saves_latents(tmp_path, port):
    wpath, _ = _upstream_files(tmp_path, port)
    save_dir = _run(tmp_path, wpath, ["--sampler", "ddim"])
    files, ims = _images(save_dir, 1)
    assert files == ["0.png", "1.png"] and ims[0].shape == (4, 4, 4)


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_guidance_interval(tmp_path, jax_params, sampler, monkeypatch):
    calls = []
    real = DDPMCFG._cond_only_model_output

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(DDPMCFG, "_cond_only_model_output", spy)
    save_dir = _run(tmp_path, _npz(tmp_path, jax_params),
                    ["--sampler", sampler, "--guidance_interval", "10", "40"])
    assert _images(save_dir, 1)[0] == ["0.png", "1.png"]
    assert calls  # some steps ran the plain conditional call


@pytest.mark.parametrize("sampler", ["dpmpp", "pfdiff"])
def test_guidance_interval_needs_ddpm_or_ddim(tmp_path, jax_params, sampler):
    with pytest.raises(SystemExit):
        _run(tmp_path, _npz(tmp_path, jax_params),
             ["--sampler", sampler, "--guidance_interval", "10", "40"])


def test_flow_is_refused_naming_the_roadmap_item(tmp_path, jax_params):
    """``--sampler flow`` is ported (item K); what it refuses is a model with
    a learned variance, whose 8 channels out are no velocity of its 4 in (the
    JAX CLI fails on the shapes inside its sampler)."""
    with pytest.raises(ValueError, match="velocity model: the model gives 8 channels for 4"):
        _run(tmp_path, _npz(tmp_path, jax_params), ["--sampler", "flow"])


def test_flow_sampler_matches_the_jax_flow_request(tmp_path, monkeypatch):
    """``--sampler flow`` on a tiny DiT without learned variance (3-channel
    8x8 images): ``make_diffuser`` builds ``FlowMatchingCFG`` from the
    config's diffusion and the CLI's flags, and ``sample_class`` equals the
    JAX ``FlowMatchingCFG`` request (the same flags, the null class as the
    unconditional input) at the same noise, to 1e-5 relative L2 (f32: sums
    in other orders); the CLI writes its PNGs."""
    from dmtpu.diffusions import FlowMatchingCFG as JaxFlowMatchingCFG
    from dmtpu.models.dit import DiT as JaxDiT
    from dmtpu_torch.diffusions import FlowMatchingCFG

    params = dict(VIT["params"], input_size=8, in_channels=3, learn_sigma=False)
    jmod = JaxDiT(**params)
    jp = jax_random_params(jmod, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1,), jnp.int32), seed=6)
    conf_path = write_yaml(tmp_path / "flow.yaml", {
        "data": {"params": {"img_size": 8}, "img_channels": 3, "num_classes": 5},
        "model": {"target": "models.dit.model.DiT", "params": params},
        "diffusion": {"target": "diffusions.ddpm.DDPM",
                      "params": {"total_steps": 50, "var_type": "fixed_large"}}})
    args, _ = sample_cfg.parse_args(["-c", conf_path, "--weights", "w", "--save_dir", "o",
                                     "--guidance_scale", "3.0", "--n_samples_each_class", "3",
                                     "--sampler", "flow", "--respace_steps", "4"])
    diffuser = sample_cfg.make_diffuser(args, load_config(conf_path))
    assert type(diffuser) is FlowMatchingCFG and diffuser.guidance_scale == 3.0
    assert (diffuser.total_steps, diffuser.respace_steps) == (50, 4)

    noise = np.random.RandomState(2).randn(3, 8, 8, 3).astype(np.float32)
    jsampler = JaxFlowMatchingCFG(guidance_scale=3.0, total_steps=50, respace_type="uniform",
                                  respace_steps=4, var_type="fixed_large")
    want = np.clip(np.asarray(jsampler.sample(
        lambda x, t, y=None, **kw: jmod.apply(jp, x, t, y), jnp.asarray(noise), None,
        uncond_conditioning=jnp.full((3,), 5, jnp.int32),
        model_kwargs={"y": jnp.full((3,), 2, jnp.int32)})), -1, 1)
    model = load_flax_params(DiT(**params), jp).eval()
    real_randn = torch.randn
    monkeypatch.setattr(torch, "randn", lambda *shape, **kw: torch.from_numpy(
        np.ascontiguousarray(noise.transpose(0, 3, 1, 2))) if shape == (3, 3, 8, 8)
        else real_randn(*shape, **kw))
    got = sample_cfg.sample_class(model, diffuser, 2, 3, shape=(3, 8, 8), num_classes=5,
                                  batch_size=4, device="cpu").permute(0, 2, 3, 1).numpy()
    monkeypatch.undo()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want) and np.abs(want).max() > 0

    wpath = tmp_path / "dit.pt"
    torch.save({"model": model.state_dict()}, wpath)
    save_dir = _run(tmp_path, str(wpath), ["--sampler", "flow"], conf=conf_path)
    files, ims = _images(save_dir, 3)
    assert files == ["0.png", "1.png"] and ims[0].shape == (8, 8, 3)


ADAGN = {"target": "models.unet_categorial_adagn.UNetCategorialAdaGN",
         "params": {"dim": 32, "dim_mults": [1, 2], "use_attn": [False, True],
                    "num_res_blocks": 1, "num_classes": 5, "attn_head_dims": 32,
                    "dropout": 0.0}}
ADM = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
           attention_resolutions=[2], channel_mult=[1, 2], num_head_channels=16, num_classes=5)


def _pixel_conf(tmp_path, model):
    return write_yaml(tmp_path / "pixel.yaml", {
        "data": {"params": {"img_size": 8}, "img_channels": 3, "num_classes": 5},
        "model": model, "diffusion": DIFFUSION})


def _jax_pixel_images(jmod, params, class_id, model_fn):
    """The JAX DDIMCFG request of ``_run``'s flags on the port's noise, as uint8."""
    from dmtpu.diffusions import DDIMCFG as JaxDDIMCFG
    from dmtpu.utils.misc import image_norm_to_uint8

    g = torch.Generator().manual_seed(sample_cfg.batch_seed(2022, class_id, 0))
    noise = torch.randn(2, 3, 8, 8, generator=g).numpy().transpose(0, 2, 3, 1)
    kw = dict(DIFFUSION["params"], var_type="fixed_small")
    out = JaxDDIMCFG(guidance_scale=2.0, **kw).sample(
        model_fn, jnp.asarray(noise), jax.random.PRNGKey(0),
        uncond_conditioning=jnp.full((2,), 5, jnp.int32),
        model_kwargs={"y": jnp.full((2,), class_id, jnp.int32)})
    return image_norm_to_uint8(np.clip(np.asarray(out), -1, 1))


def test_pixel_target_is_refused_naming_the_roadmap_item(tmp_path):
    """The pixel targets are no longer refused (item M's serving half):
    ``UNetCategorialAdaGN`` from the JAX package's ``.npz`` samples each class
    as the JAX DDIMCFG request does on the same noise (PNG bytes within one
    step of 255)."""
    from dmtpu.models.unet_categorial_adagn import UNetCategorialAdaGN as JaxAdaGN

    jmod = JaxAdaGN(**ADAGN["params"])
    params = jax_random_params(jmod, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1,), jnp.int32), seed=4)
    save_dir = _run(tmp_path, _npz(tmp_path, params), ["--sampler", "ddim", "--var_type",
                                                       "fixed_small"],
                    conf=_pixel_conf(tmp_path, ADAGN))
    for c in (1, 3):
        files, ims = _images(save_dir, c)
        want = _jax_pixel_images(jmod, params, c, lambda x, tt, y=None: jmod.apply(params, x, tt, y))
        assert files == ["0.png", "1.png"] and want.std() > 0
        assert np.abs(np.stack(ims).astype(int) - want.astype(int)).max() <= 1


def test_unet_combined_samples_through_forward_cfg(tmp_path):
    """Guided-diffusion's two UNets from two upstream files: the doubled CFG
    batch goes to ``forward_cfg``, as the JAX module's ``forward_cfg`` on the
    same noise."""
    from dmtpu.models.adm import UNetCombined as JaxCombined
    from dmtpu_torch.models.adm import UNetCombined

    jmod = JaxCombined(unet_kwargs=ADM)
    params = jax_random_params(jmod, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1,), jnp.int32), seed=5)
    model = load_flax_params(UNetCombined(ADM), params)
    sd = model.state_dict()
    for part in ("cond", "uncond"):
        torch.save({k[len(part) + 6:]: v for k, v in sd.items()
                    if k.startswith(f"unet_{part}.")}, tmp_path / f"{part}.pt")
    conf = _pixel_conf(tmp_path, {"target": "models.adm.unet_combined.UNetCombined",
                                  "params": {"unet_kwargs": ADM}})
    save_dir = _run(tmp_path, f"{tmp_path / 'cond.pt'},{tmp_path / 'uncond.pt'}",
                    ["--sampler", "ddim", "--var_type", "fixed_small"], conf=conf)

    def jax_fn(x, tt, y=None):
        return jmod.apply(params, x, tt, y, method=JaxCombined.forward_cfg)

    for c in (1, 3):
        _, ims = _images(save_dir, c)
        want = _jax_pixel_images(jmod, params, c, jax_fn)
        assert np.abs(np.stack(ims).astype(int) - want.astype(int)).max() <= 1


def test_a_ported_class_conditional_model_samples_at_the_image_size(tmp_path):
    """A non-latent target: the DiT itself on 3-channel 8x8 images, weights
    from a torch file through ``load_model_params``."""
    params = dict(VIT["params"], input_size=8, in_channels=3)
    m = DiT(**params)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.05)
    wpath = tmp_path / "dit.pt"
    torch.save({"model": m.state_dict()}, wpath)
    conf = write_yaml(tmp_path / "pixel.yaml", {
        "data": {"params": {"img_size": 8}, "img_channels": 3, "num_classes": 5},
        "model": {"target": "models.dit.model.DiT", "params": params},
        "diffusion": DIFFUSION})
    save_dir = _run(tmp_path, str(wpath), ["--sampler", "ddpm"], conf=conf)
    files, ims = _images(save_dir, 1)
    assert files == ["0.png", "1.png"] and ims[0].shape == (8, 8, 3)


def test_device_cuda_without_a_card_raises(tmp_path, jax_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        sample_cfg.main(["-c", _conf(tmp_path), "--weights", _npz(tmp_path, jax_params),
                         "--save_dir", str(tmp_path / "o"), "--guidance_scale", "2.0",
                         "--n_samples_each_class", "1"])


def test_help_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "dmtpu_torch.scripts.sample_cfg", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--guidance_interval" in out.stdout and "--device" in out.stdout


def test_sample_class_draws_by_seed_class_and_batch(port):
    diffuser = DDIMCFG(2.0, total_steps=50, respace_type="uniform", respace_steps=2)

    def run(c, n, bs, seed=0):
        return sample_cfg.sample_class(port, diffuser, c, n, shape=(4, 4, 4), num_classes=5,
                                       batch_size=bs, seed=seed, decode=False, device="cpu")

    a = run(1, 3, 2)
    assert a.shape == (3, 4, 4, 4) and a.abs().max() <= 1
    assert torch.equal(a, run(1, 3, 2))                       # the same request, the same draws
    assert torch.equal(a[:2], run(1, 2, 2))                   # batch 0 depends on nothing else
    assert not torch.equal(a, run(2, 3, 2)) and not torch.equal(a, run(1, 3, 2, seed=1))
    assert sample_cfg.batch_seed(0, 1, 0) != sample_cfg.batch_seed(0, 1, 1)
    stages = []
    out = sample_cfg.sample_class(port, diffuser, 1, 3, shape=(4, 4, 4), num_classes=5,
                                  batch_size=2, device="cpu", on_stage=stages.append)
    assert out.shape == (3, 3, 32, 32) and stages == ["sample", "decode"] * 2


def test_make_diffuser_picks_the_sampler_and_its_options(tmp_path):
    conf = load_config(_conf(tmp_path))
    base = dict(respace_type="uniform", respace_steps=None, guidance_scale=3.0, var_type=None,
                guidance_interval=None, ddim_eta=0.0)
    d = sample_cfg.make_diffuser(argparse.Namespace(**base, sampler="dpmpp"), conf)
    assert type(d) is DPMSolverPPCFG and d.guidance_scale == 3.0 and d.var_type == "learned_range"
    d = sample_cfg.make_diffuser(argparse.Namespace(
        **dict(base, respace_steps=3, var_type="fixed_small", ddim_eta=0.5), sampler="ddim"), conf)
    assert type(d) is DDIMCFG and d.eta == 0.5 and d.var_type == "fixed_small"
    np.testing.assert_array_equal(d.respaced_seq, get_respaced_seq(50, "uniform", 3))


def test_common_helpers(tmp_path):
    conf_path = _conf(tmp_path)
    args = _common.base_parser().parse_args(
        ["-c", conf_path, "--weights", "w", "--save_dir", "s", "--respace_steps", "7"])
    assert args.device == "cuda" and args.batch_size == 64 and args.seed == 2022
    conf = _common.load_conf(args, ["diffusion.params.total_steps=60", "--data.num_classes=7"])
    assert conf.diffusion.params.total_steps == 60 and conf.data.num_classes == 7
    with pytest.raises(SystemExit, match="unrecognized"):
        _common.load_conf(args, ["oops"])
    dp = _common.diffusion_params(args, Config({"diffusion": {"params": {
        "total_steps": 10, "device": "cuda"}}}), guidance_scale=2.0)
    assert dp == {"total_steps": 10, "respace_type": "uniform", "respace_steps": 7,
                  "guidance_scale": 2.0}
    assert _common.image_shape(conf) == (3, 32, 32)
    sd = {"a": torch.ones(2)}
    for i, wrapped in enumerate([sd, {"state_dict": sd}, {"ema": {"shadow": sd}}, {"model": sd}]):
        torch.save(wrapped, tmp_path / f"w{i}.pt")
        assert torch.equal(_common.load_torch_weights(str(tmp_path / f"w{i}.pt"))["a"], sd["a"])
    with pytest.raises(NotImplementedError, match="orbax"):
        _common.load_model_params(str(tmp_path), DiT(**VIT["params"]))


def test_npz_export_loads_through_load_model_params(tmp_path, jax_params):
    """The JAX package's ``save_npz_params`` layout for a plain model."""
    jmod = jax_instantiate(VIT)
    path = tmp_path / "vit.npz"
    np.savez(path, params=np.asarray(jax_params["vit"], dtype=object))
    m = _common.load_model_params(str(path), DiT(**VIT["params"]))
    x = np.random.RandomState(0).randn(1, 4, 4, 4).astype(np.float32)
    want = np.asarray(jmod.apply(jax_params["vit"], jnp.asarray(x.transpose(0, 2, 3, 1)),
                                 jnp.asarray([3]), jnp.asarray([1])))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.tensor([3]), torch.tensor([1])).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-4, atol=1e-5)
