"""The port's Streamlit pages (``dmtpu_torch/ui/Hello.py``,
``dmtpu_torch/ui/pages/*.py``) and their logic, on the CPU.

``streamlit`` is not installed: the pages run through
``tests/test_streamlit_pages.py::_Stub`` (here a subclass that also records
every widget's label, options and default).

- Every port page runs top-down with the button off, and its widgets are
  those of the JAX package's page of the same name (the help texts aside).
- Pages 1-4 generate with the button on, on ``tests/_tiny_fixtures.py``'s
  configs, through their own environment variables (``DMTPU_DEVICE=cpu``).
- Page 3's Generate body (``ui/sd.py::generate_sd``) against the JAX
  page's (``streamlit/pages/3_Stable_Diffusion.py:87-142``) run as the same
  calls in dmtpu, f32, 5 DDIM steps, b2, FreeU on, the initial latents (offset
  noise included) handed to both: the decoded images within 1e-3 relative L2
  (f32 sums in other orders through CLIP, 5 UNet calls and the decode;
  2.3e-6 seen; the same request without FreeU is more than 10 times that).
- ``list_weight_files`` lists what the JAX package's lists.
"""
import glob
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmtpu_torch.ui import sd as sd_ui
from dmtpu_torch.utils.config import instantiate_from_config, load_config
from tests._tiny_fixtures import (
    tiny_cfg_config,
    tiny_sd_config,
    tiny_sdxl_config,
    tiny_uncond_config,
    write_yaml,
)
from tests._torch_helpers import char_tokenizer_dir, jax_sd_params, nhwc
from tests.test_streamlit_pages import _Stub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = sorted(glob.glob(os.path.join(REPO, "dmtpu_torch", "ui", "pages", "*.py")))
HELLO = os.path.join(REPO, "dmtpu_torch", "ui", "Hello.py")
JAX_PAGES = os.path.join(REPO, "streamlit", "pages")
SD_SIZE, SD_STEPS, SD_SCALE = 64, 5, 7.5


class _Recorder(_Stub):
    """The stub, recording each widget as (kind, label, arguments)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.widgets = []

    def _record(self, kind, label, args, kw):
        kw = {k: list(v) if isinstance(v, (list, tuple, range)) else v
              for k, v in kw.items() if k != "help"}
        args = [list(v) if isinstance(v, (list, tuple, range)) else v for v in args]
        self.widgets.append((kind, label, args, sorted(kw.items())))

    def slider(self, label, *args, **k):
        self._record("slider", label, args, k)
        return super().slider(label, *args, **k)

    def selectbox(self, label, options, *args, **k):
        self._record("selectbox", label, [options, *args], k)
        return super().selectbox(label, options, *args, **k)

    def select_slider(self, label, *args, **k):
        self._record("select_slider", label, args, k)
        return super().select_slider(label, *args, **k)

    def number_input(self, label, *args, **k):
        self._record("number_input", label, args, k)
        return super().number_input(label, *args, **k)

    def text_area(self, label, *args, **k):
        self._record("text_area", label, args, k)
        return super().text_area(label, *args, **k)

    def checkbox(self, label, value=False, **k):
        self._record("checkbox", label, [], dict(k, value=value))
        return self.overrides.get(label, value)

    def button(self, label, *a, **k):
        self._record("button", label, a, k)
        return super().button(label, *a, **k)


def _run(page, monkeypatch, overrides=None, button=False, env=None):
    """Run ``page`` top to bottom with the recording stub as ``streamlit``;
    the Model-dropdown directories are unset unless ``env`` sets them."""
    st = _Recorder(overrides=overrides, button_result=button)
    mod = types.ModuleType("streamlit")
    mod.__getattr__ = lambda name: getattr(st, name)
    mod.session_state = st.session_state
    monkeypatch.setitem(sys.modules, "streamlit", mod)
    env = {"DMTPU_WEIGHTS_DIR": None, "DMTPU_SD_WEIGHTS_DIR": None, **(env or {})}
    for k, v in env.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    name = "port_page_" + os.path.basename(page)[:-3]
    spec = importlib.util.spec_from_file_location(name, page)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    return st


def _page(fragment):
    (path,) = [p for p in PAGES if fragment in os.path.basename(p)]
    return path


def test_the_port_has_the_four_pages_of_the_jax_package():
    assert [os.path.basename(p) for p in PAGES] == sorted(os.listdir(JAX_PAGES))


@pytest.mark.parametrize("page", PAGES + [HELLO], ids=os.path.basename)
def test_page_runs_topdown(page, monkeypatch):
    st = _run(page, monkeypatch)
    assert not st.images


@pytest.mark.parametrize("page", PAGES, ids=os.path.basename)
def test_page_widgets_are_the_jax_page_s(page, monkeypatch):
    want = _run(os.path.join(JAX_PAGES, os.path.basename(page)), monkeypatch).widgets
    got = _run(page, monkeypatch).widgets
    assert got == want and len(got) >= 8


def _save_port_weights(conf_path, path):
    """Seeded random weights of the config's model, as a torch state dict."""
    torch.manual_seed(3)
    model = instantiate_from_config(load_config(conf_path)["model"])
    torch.save(model.state_dict(), path)
    return str(path)


def test_uncond_page_generates(monkeypatch, tmp_path):
    """Two batches of 4 (two 2x2 grids of 8x8 samples), with the weights
    picked from the DMTPU_WEIGHTS_DIR dropdown."""
    conf = tiny_uncond_config(tmp_path / "conf.yaml")
    (tmp_path / "w").mkdir()
    weights = _save_port_weights(conf, tmp_path / "w" / "unet.pt")
    st = _run(_page("1_Unconditional"), monkeypatch, button=True,
              overrides={"Sampling steps": 5, "Batch size": 4, "Batch count": 2, "Seed": 7},
              env={"DMTPU_CONFIG": conf, "DMTPU_WEIGHTS": None,
                   "DMTPU_WEIGHTS_DIR": str(tmp_path / "w"), "DMTPU_DEVICE": "cpu"})
    assert st.selectboxes["Model"] == [weights]
    assert len(st.images) == 2 and {np.asarray(i).shape for i in st.images} == {(22, 22, 3)}
    assert not np.array_equal(np.asarray(st.images[0]), np.asarray(st.images[1]))


def test_uncond_page_flow_family_gate_and_flowdpm(monkeypatch, tmp_path):
    """A flow config offers only the flow samplers and the flow respace
    types, and runs flowdpm over the config's euler solver."""
    base = tiny_uncond_config(tmp_path / "base.yaml")
    conf_d = yaml.safe_load(open(base))
    conf_d["diffusion"] = {"target": "diffusions.flow.FlowMatching",
                           "params": {"total_steps": 100, "solver": "euler"}}
    conf = write_yaml(tmp_path / "conf.yaml", conf_d)
    weights = _save_port_weights(conf, tmp_path / "w.pt")
    st = _run(_page("1_Unconditional"), monkeypatch, button=True,
              overrides={"Sampling steps": 5, "Batch size": 4, "Sampler": "flowdpm",
                         "Respace type": "quad"},
              env={"DMTPU_CONFIG": conf, "DMTPU_WEIGHTS": weights, "DMTPU_DEVICE": "cpu"})
    assert st.selectboxes["Sampler"] == ["flow", "flowdpm"]
    assert st.selectboxes["Respace type"] == ["uniform", "uniform-leading", "uniform-trailing",
                                              "quad"]
    assert len(st.images) == 1


def test_cfg_page_generates(monkeypatch, tmp_path):
    conf = tiny_cfg_config(tmp_path / "conf.yaml")
    weights = _save_port_weights(conf, tmp_path / "w.pt")
    st = _run(_page("2_Class_Conditional"), monkeypatch, button=True,
              overrides={"Sampling steps": 5, "Batch size": 4, "Class id": 3},
              env={"DMTPU_CONFIG": conf, "DMTPU_WEIGHTS": weights, "DMTPU_DEVICE": "cpu"})
    assert len(st.images) == 1 and np.asarray(st.images[0]).shape == (22, 22, 3)


def test_sd_page_generates_in_demo_mode(monkeypatch, tmp_path):
    """Random weights (the warning), a local tokenizer, offset noise, FreeU,
    two batches of two images of the chosen size."""
    conf = tiny_sd_config(tmp_path / "sd.yaml")
    st = _run(_page("3_Stable_Diffusion"), monkeypatch, button=True,
              overrides={"Steps": 4, "Height": 64, "Width": 64, "Offset noise": 0.1,
                         "FreeU": True, "Batch size": 2, "Batch count": 2},
              env={"DMTPU_SD_CONFIG": conf, "DMTPU_SD_WEIGHTS": None,
                   "DMTPU_CLIP_TOKENIZER": char_tokenizer_dir(tmp_path / "tok"),
                   "DMTPU_DEVICE": "cpu"})
    assert any("RANDOM" in w for w in st.warnings)
    assert len(st.images) == 4 and {np.asarray(i).shape for i in st.images} == {(64, 64, 3)}


def test_sd_page_ddpm_with_weights_from_the_dropdown(monkeypatch, tmp_path):
    """The DDPM sampler and a torch file picked from DMTPU_SD_WEIGHTS_DIR:
    no demo-mode warning."""
    conf = tiny_sd_config(tmp_path / "sd.yaml")
    (tmp_path / "w").mkdir()
    sd = instantiate_from_config(load_config(conf)["model"]).init_params(
        torch.Generator().manual_seed(1))
    torch.save(sd.state_dict(), tmp_path / "w" / "sd.pt")
    st = _run(_page("3_Stable_Diffusion"), monkeypatch, button=True,
              overrides={"Sampler": "ddpm", "Steps": 3, "Height": 64, "Width": 64,
                         "Batch size": 1, "Batch count": 1, "Seed": 7},
              env={"DMTPU_SD_CONFIG": conf, "DMTPU_SD_WEIGHTS": None,
                   "DMTPU_SD_WEIGHTS_DIR": str(tmp_path / "w"),
                   "DMTPU_CLIP_TOKENIZER": char_tokenizer_dir(tmp_path / "tok"),
                   "DMTPU_DEVICE": "cpu"})
    assert not st.warnings and st.selectboxes["Model"] == [str(tmp_path / "w" / "sd.pt")]
    assert len(st.images) == 1 and np.asarray(st.images[0]).shape == (64, 64, 3)


def test_sdxl_page_generates_in_demo_mode(monkeypatch, tmp_path):
    conf = tiny_sdxl_config(tmp_path / "sdxl.yaml")
    tok = char_tokenizer_dir(tmp_path / "tok")
    st = _run(_page("4_Stable_Diffusion_XL"), monkeypatch, button=True,
              overrides={"Steps": 4, "Height": 64, "Width": 64, "Offset noise": 0.1,
                         "Batch size": 2},
              env={"DMTPU_SDXL_CONFIG": conf, "DMTPU_SDXL_WEIGHTS": None,
                   "DMTPU_CLIP_TOKENIZER": tok, "DMTPU_OPENCLIP_TOKENIZER": tok,
                   "DMTPU_DEVICE": "cpu"})
    assert any("RANDOM" in w for w in st.warnings)
    assert len(st.images) == 2 and {np.asarray(i).shape for i in st.images} == {(64, 64, 3)}


def _jax_generate(conf, jsd, params, prompt, negative, noise, freeu):
    """The page's Generate body (:87-142) in dmtpu: DDIMCFG, the initial
    latents given."""
    from dmtpu.diffusions import DDIMCFG
    from dmtpu.ops.freeu import SD15_DEFAULTS

    b = noise.shape[0]
    dp = dict(conf.diffusion.get("params", {}))
    dp.pop("device", None)
    dp.pop("var_type", None)
    dp.update(respace_type="uniform-linspace", respace_steps=SD_STEPS, guidance_scale=SD_SCALE,
              cond_kwarg="text_embed")
    text_embed = jsd.text_encoder_encode(params, [prompt] * b)
    neg_embed = jsd.text_encoder_encode(params, [negative] * b)
    unet_m = jsd.unet.clone(tome_ratio=0.0, freeu=SD15_DEFAULTS if freeu else None)

    def model_fn(x, t, text_embed=None, **kw):
        return unet_m.apply(params["unet"], x, t, context=text_embed)

    z = DDIMCFG(**dp).sample(model_fn, jnp.asarray(nhwc(noise)), jax.random.PRNGKey(0),
                             uncond_conditioning=neg_embed,
                             model_kwargs=dict(text_embed=text_embed))
    return np.clip(np.asarray(jsd.decode_latent(params, z)), -1, 1)


def test_sd_generate_matches_the_jax_page(tmp_path):
    """b2, 5 DDIM steps, s = 7.5, FreeU at SD1.5's scales, a negative
    prompt; weights from the JAX package's ``.npz`` through ``load_sd``."""
    from dmtpu.utils.config import instantiate_from_config as jax_instantiate

    path = tiny_sd_config(tmp_path / "sd.yaml")
    conf = load_config(path)
    tok = char_tokenizer_dir(tmp_path / "tok")
    jsd = jax_instantiate(conf.model)
    from transformers import CLIPTokenizer

    jsd.text_encoder.tokenizer = CLIPTokenizer.from_pretrained(tok)
    params = jax_sd_params(jsd, SD_SIZE, seed=2)
    np.savez(tmp_path / "w.npz", params=params)
    rs = np.random.RandomState(5)
    noise = (rs.randn(2, 4, SD_SIZE // 8, SD_SIZE // 8)
             + 0.1 * rs.randn(2, 1, 1, 1)).astype(np.float32)
    prompt, negative = "a red cat", "blurry"
    want = _jax_generate(conf, jsd, params, prompt, negative, noise, freeu=True)
    _, sd = sd_ui.load_sd(path, weights=str(tmp_path / "w.npz"), tokenizer=tok, device="cpu")
    got = sd_ui.generate_sd(conf, sd, prompt, negative, steps=SD_STEPS, scale=SD_SCALE,
                            height=SD_SIZE, width=SD_SIZE, freeu=True, batch_size=2,
                            real_weights=True, device="cpu", noise=noise)
    assert got.shape == (2, 3, SD_SIZE, SD_SIZE) and np.abs(want).max() > 0.1
    err = np.linalg.norm(nhwc(got.numpy()) - want) / np.linalg.norm(want)
    assert err <= 1e-3, err
    # FreeU and the model's ToMe setting are as before the call
    assert sd.unet.freeu is None and sd.unet.tome_ratio == 0.0
    off = sd_ui.generate_sd(conf, sd, prompt, negative, steps=SD_STEPS, scale=SD_SCALE,
                            height=SD_SIZE, width=SD_SIZE, batch_size=2, real_weights=True,
                            device="cpu", noise=noise)
    assert np.linalg.norm(nhwc(off.numpy()) - want) / np.linalg.norm(want) > 10 * err


def test_sd_generate_options(tmp_path):
    """Each sampler runs; batch count draws new noise; offset noise and the
    seed change the images; an unknown sampler is refused; real weights
    without a tokenizer are refused; the default device is the card."""
    path = tiny_sd_config(tmp_path / "sd.yaml")
    conf, sd = sd_ui.load_sd(path, device="cpu")
    for p in sd.unet.parameters():  # the zero-initialised output conv would hide the prompt
        if not p.any():
            torch.nn.init.normal_(p, std=0.05, generator=torch.Generator().manual_seed(0))
    kw = dict(steps=3, height=32, width=48, batch_count=2, device="cpu")
    outs = {}
    for sampler in sd_ui.SAMPLERS:
        outs[sampler] = sd_ui.generate_sd(conf, sd, "a cat", sampler=sampler, seed=5, **kw)
        assert outs[sampler].shape == (2, 3, 32, 48) and outs[sampler].abs().max() <= 1
        assert not torch.equal(outs[sampler][0], outs[sampler][1])
    assert torch.equal(sd_ui.generate_sd(conf, sd, "a cat", sampler="ddpm", seed=5, **kw),
                       outs["ddpm"])
    assert not torch.equal(sd_ui.generate_sd(conf, sd, "a cat", seed=6, **kw), outs["ddim"])
    assert not torch.equal(sd_ui.generate_sd(conf, sd, "a cat", seed=5, offset_noise=0.1, **kw),
                           outs["ddim"])
    with pytest.raises(ValueError, match="sampler"):
        sd_ui.generate_sd(conf, sd, "a cat", sampler="euler", **kw)
    with pytest.raises(SystemExit, match="tokenizer"):
        sd_ui.generate_sd(conf, sd, "a cat", real_weights=True, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sd_ui.load_sd(path)


def test_list_weight_files_matches_the_jax_package(tmp_path):
    from dmtpu.utils.misc import list_weight_files as jax_list
    from dmtpu_torch.utils.misc import list_weight_files

    for rel in ("a.pt", "b/c.ckpt", "b/d/e.safetensors", "f.npz", "g.pth", "h.txt", "b/i.yaml",
                "j.pt.bak"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("x")
    got = list_weight_files(str(tmp_path))
    assert got == jax_list(str(tmp_path)) and len(got) == 5
    assert list_weight_files(None) == list_weight_files("") == jax_list(None) == []
    assert list_weight_files(str(tmp_path / "missing")) == []
