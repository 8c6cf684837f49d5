"""``python -m dmtpu_torch.scripts.sample_sd`` on the CPU, demo mode.

The cases of ``tests/test_sample_sd_cli.py`` on the same tiny config file:
pseudo-tokens -> text encoder -> sampler -> VAE decode -> PNGs, with
``--device cpu``; the serving accelerators' flags, each seen at work; the
flag conflicts; and the refusal to run without a card unless told to.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmtpu_torch.diffusions import DPMSolverPPCFG, PFDiffDDIM
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.models.stablediffusion import attention as sd_attention
from dmtpu_torch.models.stablediffusion import unet as sd_unet
from dmtpu_torch.ops import freeu as freeu_lib
from dmtpu_torch.scripts import sample_sd
from dmtpu_torch.utils.config import instantiate_from_config, load_config
from tests._tiny_fixtures import tiny_sd_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(tmp_path, out_name, extra, device=("--device", "cpu")):
    conf = tiny_sd_config(tmp_path / "sd.yaml")
    return ["-c", conf, "--prompt", "a tiny cat", "--save_dir", str(tmp_path / out_name),
            "--n_samples", "2", "--batch_size", "2", "--height", "64", "--width", "64",
            "--respace_steps", "4", "--guidance_scale", "3.0", *device, *extra]


def _run(tmp_path, monkeypatch, out_name, extra):
    monkeypatch.delenv("DMTPU_CLIP_TOKENIZER", raising=False)
    sample_sd.main(_argv(tmp_path, out_name, extra))
    return sorted(os.listdir(tmp_path / out_name))


def _png(path, shape, seed=0):
    from PIL import Image

    Image.fromarray(np.random.RandomState(seed).randint(0, 255, shape, np.uint8)).save(path)
    return str(path)


@pytest.mark.parametrize("name,extra", [
    ("ddim", []),
    ("ddpm", ["--sampler", "ddpm"]),
    ("interval", ["--guidance_interval", "20", "80"]),
    ("ddpm_interval", ["--sampler", "ddpm", "--guidance_interval", "20", "80"]),
    ("negative", ["--negative", "blurry"]),
])
def test_sample_sd_matrix(tmp_path, monkeypatch, name, extra):
    assert _run(tmp_path, monkeypatch, f"out_{name}", extra) == ["0.png", "1.png"]
    from PIL import Image

    im = np.asarray(Image.open(tmp_path / f"out_{name}" / "0.png"))
    assert im.shape == (64, 64, 3) and im.dtype == np.uint8


def test_more_samples_than_a_batch_and_a_ragged_tail(tmp_path, monkeypatch):
    files = _run(tmp_path, monkeypatch, "out_tail", ["--n_samples", "3"])
    assert files == ["0.png", "1.png", "2.png"]


@pytest.mark.parametrize("extra", [[], ["--sampler", "ddpm"], ["--strength", "1.0"]])
def test_img2img(tmp_path, monkeypatch, extra):
    src = _png(tmp_path / "init.png", (48, 48, 3))
    files = _run(tmp_path, monkeypatch, "out_i2i",
                 ["--init_image", src, "--strength", "0.5"] + extra)
    assert files == ["0.png", "1.png"]


def test_inpaint(tmp_path, monkeypatch):
    from PIL import Image

    src = _png(tmp_path / "inp.png", (48, 48, 3))
    m = np.full((48, 48), 255, np.uint8)
    m[12:36, 12:36] = 0  # regenerate the centre
    Image.fromarray(m).save(tmp_path / "mask.png")
    files = _run(tmp_path, monkeypatch, "out_inpaint",
                 ["--inpaint_image", src, "--inpaint_mask", str(tmp_path / "mask.png")])
    assert files == ["0.png", "1.png"]


@pytest.mark.parametrize("bad", [
    ["--inpaint_image", "a.png"],  # mask missing
    ["--inpaint_image", "a.png", "--inpaint_mask", "m.png", "--sampler", "dpmpp"],
    ["--inpaint_image", "a.png", "--inpaint_mask", "m.png", "--init_image", "b.png"],
    ["--init_image", "x.png", "--sampler", "pfdiff"],
    ["--init_image", "x.png", "--deepcache", "2", "1"],
    ["--init_image", "x.png", "--strength", "1.5"],
    ["--deepcache", "2", "1", "--sampler", "dpmpp"],
    ["--deepcache", "2", "1", "--guidance_interval", "20", "80"],
    ["--guidance_interval", "20", "80", "--sampler", "dpmpp"],
], ids=lambda bad: "_".join(x.lstrip("-") for x in bad))
def test_flag_conflicts_abort(tmp_path, capsys, bad):
    with pytest.raises(SystemExit) as e:
        sample_sd.main(_argv(tmp_path, "o", bad))
    assert e.value.code == 2 and "error:" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def _spy(monkeypatch) -> dict:
    """What the run did: each UNet call's ToMe ratio, FreeU scales and
    DeepCache pass, and the calls of the solvers' and ToMe's own functions."""
    seen = {"unet": [], "dpmpp": 0, "pfdiff": 0, "merges": 0, "freeu": 0}

    def count(key, fn):
        def wrapped(*args, **kwargs):
            seen[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    forward = SDUNetModel.forward

    def unet_forward(self, *args, dc_skip=None, dc_cached=None, **kwargs):
        seen["unet"].append((self.tome_ratio, self.freeu, dc_skip, dc_cached is not None))
        return forward(self, *args, dc_skip=dc_skip, dc_cached=dc_cached, **kwargs)

    monkeypatch.setattr(SDUNetModel, "forward", unet_forward)
    monkeypatch.setattr(DPMSolverPPCFG, "_x0_step", count("dpmpp", DPMSolverPPCFG._x0_step))
    monkeypatch.setattr(PFDiffDDIM, "_jump_with_eps", count("pfdiff", PFDiffDDIM._jump_with_eps))
    monkeypatch.setattr(sd_attention, "bipartite_soft_matching_2d",
                        count("merges", sd_attention.bipartite_soft_matching_2d))
    monkeypatch.setattr(sd_unet, "apply_freeu", count("freeu", sd_unet.apply_freeu))
    return seen


@pytest.mark.parametrize("flags,named", [
    (["--sampler", "dpmpp"], "--sampler dpmpp"),
    (["--sampler", "pfdiff"], "--sampler pfdiff"),
    (["--tome_ratio", "0.5", "--tome_max_downsample", "2"], "--tome_ratio"),
    (["--freeu"], "--freeu"),
    (["--freeu", "sd21"], "--freeu"),
    (["--freeu_scales", "1.2", "1.3", "0.9", "0.3"], "--freeu"),
    (["--deepcache", "2", "2"], "--deepcache"),
    (["--sampler", "pfdiff", "--deepcache", "2", "2", "--tome_ratio", "0.5"], "--tome_ratio"),
], ids=lambda x: "_".join(s.lstrip("-") for s in x) if isinstance(x, list) else None)
def test_unported_flags_exit_with_one_line(tmp_path, monkeypatch, flags, named):
    """The JAX CLI's serving-accelerator flags, alone and composed, run end
    to end and write the images; each flag given (``named`` among them) is
    seen at work in the run: the solver's own steps, the UNet called with the
    ToMe ratio and the FreeU scales asked for (and tokens merged where the
    tiny model has attention at a merged level), shallow DeepCache passes."""
    seen = _spy(monkeypatch)
    assert _run(tmp_path, monkeypatch, "o", flags) == ["0.png", "1.png"]
    opts = vars(sample_sd.parse_args(_argv(tmp_path, "o", flags)))
    given, engaged = set(), set()
    if opts["sampler"] != "ddim":
        given.add(f"--sampler {opts['sampler']}")
        if seen[opts["sampler"]]:
            engaged.add(f"--sampler {opts['sampler']}")
    calls = seen["unet"]
    if opts["tome_ratio"] > 0:
        given.add("--tome_ratio")
        if calls and all(ratio == opts["tome_ratio"] for ratio, *_ in calls):
            engaged.add("--tome_ratio")
        # the tiny model's attention sits at ds 2 only
        assert (seen["merges"] > 0) == (opts["tome_max_downsample"] >= 2)
    if opts["freeu"] or opts["freeu_scales"]:
        given.add("--freeu")
        want = tuple(opts["freeu_scales"] or sample_sd.FREEU_PRESETS[opts["freeu"]])
        if calls and all(scales == want for _, scales, *_ in calls) and seen["freeu"]:
            engaged.add("--freeu")
    if opts["deepcache"]:
        given.add("--deepcache")
        if any(shallow for *_, shallow in calls) and not all(shallow for *_, shallow in calls):
            engaged.add("--deepcache")
    assert named in given and engaged == given
    assert freeu_lib.SD21_DEFAULTS == sample_sd.FREEU_PRESETS["sd21"]


def test_real_weights_without_tokenizer_abort(tmp_path, monkeypatch):
    # pseudo-tokens with real weights would quietly make garbage images
    conf = tiny_sd_config(tmp_path / "sd.yaml")
    sd = instantiate_from_config(load_config(conf).model)
    sd.init_params(torch.Generator().manual_seed(0))
    ckpt = {"model.diffusion_model." + k: v for k, v in sd.unet.state_dict().items()}
    ckpt.update({"first_stage_model." + k: v for k, v in sd.vae.state_dict().items()})
    ckpt.update({"cond_stage_model.transformer.text_model." + k: v
                 for k, v in sd.text_encoder.model.state_dict().items()})
    torch.save({"state_dict": ckpt}, tmp_path / "w.ckpt")
    monkeypatch.delenv("DMTPU_CLIP_TOKENIZER", raising=False)
    with pytest.raises(SystemExit, match="DMTPU_CLIP_TOKENIZER"):
        sample_sd.main(_argv(tmp_path, "o", ["--weights", str(tmp_path / "w.ckpt")]))


def test_tokenizer_from_the_environment_is_used(tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    from tests._tiny_fixtures import make_tiny_clip_dir

    monkeypatch.setenv("DMTPU_CLIP_TOKENIZER", make_tiny_clip_dir(tmp_path / "clip"))
    conf = load_config(tiny_sd_config(tmp_path / "sd.yaml"))
    sd = sample_sd.build_model(conf, None, torch.device("cpu"))
    ids = sample_sd._token_ids(sd, "abc", real_weights=True)
    assert ids.shape == (1, 16) and sd.text_encoder.tokenizer is not None
    assert not np.array_equal(ids, sample_sd._demo_token_ids("abc", 16, 256))


def test_no_card_without_device_cpu_fails(tmp_path):
    """Run as a user would, as a module: the default device is the card, and
    without one the CLI stops with a message and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    run = subprocess.run(
        [sys.executable, "-m", "dmtpu_torch.scripts.sample_sd", *_argv(tmp_path, "o", [], ())],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and "no CUDA device" in run.stderr and "--device cpu" in run.stderr
    assert not (tmp_path / "o").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_sd.sample_images({}, "x")


def test_demo_token_ids_are_the_jax_cli_s():
    """The same prompt gives the same pseudo-tokens in both CLIs: the port's
    copy against the JAX CLI's own function, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_sample_sd", os.path.join(REPO, "scripts", "sample_sd.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    for text in ("a tiny cat", "", "a photograph of an astronaut riding a horse"):
        for length, vocab in ((16, 256), (77, 49408)):
            np.testing.assert_array_equal(sample_sd._demo_token_ids(text, length, vocab),
                                          jax_cli._demo_token_ids(text, length, vocab))


def test_sample_images_returns_uint8_and_is_seeded(tmp_path):
    conf = load_config(tiny_sd_config(tmp_path / "sd.yaml"))
    kw = dict(n_samples=2, batch_size=2, height=64, width=64, respace_steps=3,
              guidance_scale=3.0, device="cpu")
    stages = []
    a = sample_sd.sample_images(conf, "a tiny cat", on_stage=stages.append, **kw)
    b = sample_sd.sample_images(conf.to_dict(), "a tiny cat", **kw)
    c = sample_sd.sample_images(conf, "a tiny cat", seed=1, **kw)
    assert a.shape == (2, 64, 64, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert stages == ["begin", "text_encode", "sample", "decode"]
    # inpainting with a fully known mask decodes the known latent, whatever
    # the sampler's starting noise was
    rs = np.random.RandomState(0)
    known = rs.uniform(-1, 1, size=(64, 64, 3)).astype(np.float32)
    mask = np.ones((8, 8), np.float32)
    full = sample_sd.sample_images(conf, "a tiny cat", inpaint_image=known, inpaint_mask=mask,
                                   **kw).astype(int)
    sd = sample_sd.build_model(conf, None, torch.device("cpu"))
    with torch.no_grad():
        x = torch.from_numpy(known).permute(2, 0, 1)[None].expand(2, -1, -1, -1)
        z_known = sd.encode_latent(x, torch.Generator().manual_seed(2022 + 1))
        want = sd.decode_latent(z_known).clamp(-1, 1).permute(0, 2, 3, 1).numpy()
    assert np.abs(full - ((want + 1) / 2 * 255).astype(int)).max() <= 1
    with pytest.raises(ValueError, match="go together"):
        sample_sd.sample_images(conf, "x", inpaint_image=known, **kw)
    with pytest.raises(ValueError, match=r"\[8, 8\]"):
        sample_sd.sample_images(conf, "x", inpaint_image=known,
                                inpaint_mask=np.ones((4, 4), np.float32), **kw)
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_sd.sample_images(conf, "x", sampler="euler", **kw)


@pytest.mark.parametrize("sampler", ["ddim", "pfdiff"])
def test_deepcache_interval_one_is_the_plain_request(tmp_path, sampler):
    """``deepcache=(1, skip)`` runs the full UNet at every step: the request's
    images are the plain sampler's, bit for bit (the output layer is given
    weights: at its zero init every request gives the same images)."""
    conf = load_config(tiny_sd_config(tmp_path / "sd.yaml"))
    sd = sample_sd.build_model(conf, None, torch.device("cpu"))
    torch.nn.init.normal_(sd.unet.out[2].weight, std=0.3, generator=torch.Generator().manual_seed(1))
    kw = dict(n_samples=2, batch_size=2, height=64, width=64, respace_steps=5,
              guidance_scale=3.0, device="cpu", sd=sd, sampler=sampler)
    plain = sample_sd.sample_images(conf, "a tiny cat", **kw)
    assert np.array_equal(sample_sd.sample_images(conf, "a tiny cat", deepcache=(1, 2), **kw),
                          plain)
    assert not np.array_equal(sample_sd.sample_images(conf, "a tiny cat", deepcache=(2, 2), **kw),
                              plain)


def test_sample_images_leaves_the_model_s_accelerators_as_they_were(tmp_path):
    conf = load_config(tiny_sd_config(tmp_path / "sd.yaml"))
    sd = sample_sd.build_model(conf, None, torch.device("cpu"))
    sd.set_tome(0.3, max_downsample=2, seed=4)
    seen = []
    forward = sd.unet.forward
    sd.unet.forward = lambda *a, **k: seen.append((sd.unet.tome_ratio, sd.unet.freeu)) or \
        forward(*a, **k)
    kw = dict(n_samples=1, batch_size=1, height=64, width=64, respace_steps=2, device="cpu", sd=sd)
    sample_sd.sample_images(conf, "x", tome_ratio=0.5, freeu="sdxl", **kw)
    assert set(seen) == {(0.5, freeu_lib.SDXL_DEFAULTS)}
    u = sd.unet
    assert (u.tome_ratio, u.tome_max_downsample, u.tome_seed, u.freeu) == (0.3, 2, 4, None)
    with pytest.raises(ValueError, match="FreeU preset"):
        sample_sd.sample_images(conf, "x", freeu="sd30", **kw)
    conf["diffusion"]["params"]["objective"] = "pred_v"
    with pytest.raises(NotImplementedError, match="pred_eps"):
        sample_sd.sample_images(conf, "x", deepcache=(2, 2), **kw)
    assert u.tome_ratio == 0.3
