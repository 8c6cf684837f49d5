"""dmtpu_torch.utils: the config system and the image helpers.

The registry must send the reference repo's target strings and the JAX
package's own to this package's classes, and name a target it cannot serve;
``Config`` / ``merge_dotlist`` and the image helpers must behave as
``dmtpu.utils``'s do on the same inputs.
"""
import logging

import numpy as np
import pytest

from dmtpu.utils import config as jconfig
from dmtpu.utils import image as jimage
from dmtpu_torch import diffusions as td
from dmtpu_torch.data import captioned
from dmtpu_torch.diffusions import guidance as tg
from dmtpu_torch.models import adm as tadm
from dmtpu_torch.models import pesser as tpesser
from dmtpu_torch.models import stablediffusion as tsd
from dmtpu_torch.models import unet as tunet
from dmtpu_torch.models import unet_categorial_adagn as tadagn
from dmtpu_torch.models.dit import DiT
from dmtpu_torch.models.ema import EMAState
from dmtpu_torch.models.latent import LatentDiffusionWrapper, PretrainedVAE
from dmtpu_torch.models.mdt import MDTv2
from dmtpu_torch.models.mmdit import MMDiT
from dmtpu_torch.models.sdxl import SDXLConditioner, StableDiffusionXL
from dmtpu_torch.utils import config as tconfig
from dmtpu_torch.utils import image as timage
from dmtpu_torch.utils import optim as toptim
from dmtpu_torch.utils.logger import get_logger
from dmtpu_torch.utils.misc import image_norm_to_uint8
from tests._tiny_fixtures import _tiny_sd_model, tiny_sd_config

TARGETS = [
    ("diffusions.ddpm.DDPM", td.DDPM),
    ("diffusions.cfg.ddpm_cfg.DDPMCFG", td.DDPMCFG),
    ("diffusions.ddim.DDIMCFG", td.DDIMCFG),
    ("dmtpu.diffusions.ddim.DDIM", td.DDIM),
    ("dmtpu.diffusions.DDIMCFG", td.DDIMCFG),
    ("diffusions.dpm_solver.DPMSolverPPCFG", td.DPMSolverPPCFG),
    ("dmtpu.diffusions.pfdiff.PFDiffDDIMCFG", td.PFDiffDDIMCFG),
    ("diffusions.guidance.mask_guidance.MaskGuidance", tg.MaskGuidance),
    ("dmtpu.diffusions.guidance.MaskGuidanceDDIMCFG", tg.MaskGuidanceDDIMCFG),
    ("diffusions.guidance.base.BaseGuidance", tg.BaseGuidance),
    ("models.ema.EMA", EMAState),
    ("models.stablediffusion.stablediffusion.StableDiffusion", tsd.StableDiffusion),
    ("dmtpu.models.stablediffusion.StableDiffusion", tsd.StableDiffusion),
    ("models.stablediffusion.unet.UNetModel", tsd.SDUNetModel),
    ("dmtpu.models.stablediffusion.SDUNetModel", tsd.SDUNetModel),
    ("models.stablediffusion.autoencoder.AutoEncoderKL", tsd.AutoencoderKL),
    ("models.sdxl.autoencoder.AutoencoderKL", tsd.AutoencoderKL),
    ("models.sdxl.stablediffusion.StableDiffusion", StableDiffusionXL),
    ("dmtpu.models.sdxl.StableDiffusionXL", StableDiffusionXL),
    ("models.sdxl.conditioner.GeneralConditioner", SDXLConditioner),
    ("dmtpu.models.sdxl.SDXLConditioner", SDXLConditioner),
    ("models.sdxl.unet.UNetModel", tsd.SDUNetModel),
    ("models.stablediffusion.text_encoders.FrozenCLIPEmbedder", tsd.FrozenCLIPEmbedder),
    ("dmtpu.models.stablediffusion.FrozenOpenCLIPEmbedder", tsd.FrozenOpenCLIPEmbedder),
    ("torch.optim.AdamW", toptim.adamw),
    ("dmtpu.utils.optim.adafactor", toptim.adafactor),
    ("torch.optim.SGD", toptim.sgd),
    ("dmtpu.data.captioned.CaptionedImageDir", captioned.CaptionedImageDir),
    ("dmtpu.data.captioned.SyntheticCaptioned", captioned.SyntheticCaptioned),
    ("models.dit.dit.DiT", LatentDiffusionWrapper),
    ("models.dit.model.DiT", DiT),
    ("dmtpu.models.dit.DiT", DiT),
    ("models.mdt.mdt.MDT", LatentDiffusionWrapper),
    ("models.mdt.model.MDTv2", MDTv2),
    ("models.mmdit.MMDiT", MMDiT),
    ("dmtpu.models.mmdit.MMDiT", MMDiT),
    ("diffusions.flow.FlowMatching", td.FlowMatching),
    ("diffusions.flow.FlowMatchingCFG", td.FlowMatchingCFG),
    ("diffusions.flow_dpm.FlowDPMSolver", td.FlowDPMSolver),
    ("dmtpu.diffusions.FlowDPMSolverCFG", td.FlowDPMSolverCFG),
    ("dmtpu.data.captioned.SyntheticEmbedded", captioned.SyntheticEmbedded),
    ("models.dit.autoencoder.AutoEncoderKL", PretrainedVAE),
    ("models.mdt.autoencoder.AutoEncoderKL", PretrainedVAE),
    ("diffusions.ddpm_ip.DDPM_IP", td.DDPM_IP),
    ("dmtpu.diffusions.ddpm_ip.DDPM_IP", td.DDPM_IP),
    ("dmtpu.diffusions.DDPM_IP", td.DDPM_IP),
    ("diffusions.guidance.ilvr.ILVR", tg.ILVR),
    ("dmtpu.diffusions.guidance.ILVR", tg.ILVR),
    ("diffusions.guidance.clip_guidance.CLIPGuidance", tg.CLIPGuidance),
    ("dmtpu.diffusions.guidance.CLIPGuidance", tg.CLIPGuidance),
    ("diffusions.euler.EulerSampler", td.EulerSampler),
    ("diffusions.heun.HeunSampler", td.HeunSampler),
    ("models.unet.UNet", tunet.UNet),
    ("models.unet_categorial_adagn.UNetCategorialAdaGN", tadagn.UNetCategorialAdaGN),
    ("models.adm.unet.UNetModel", tadm.UNetModel),
    ("models.adm.unet_combined.UNetCombined", tadm.UNetCombined),
    ("dmtpu.models.pesser.PesserUNet", tpesser.PesserUNet),
    ("models.pesser.model.Model", tpesser.PesserUNet),
    ("dmtpu_torch.diffusions.ddim.DDIM", td.DDIM),   # this package's own paths
    ("collections.OrderedDict", __import__("collections").OrderedDict),  # any other import
]


@pytest.mark.parametrize("target,want", TARGETS, ids=[x[0] for x in TARGETS])
def test_registry_resolves_onto_this_package(target, want):
    assert tconfig.resolve_target(target) is want


def test_reference_table_is_the_jax_package_s():
    assert tconfig._REFERENCE == jconfig._REGISTRY


@pytest.mark.parametrize("target", [
    "dmtpu.models.stablediffusion.FrozenT5Embedder",
    "dmtpu.models.stablediffusion.text_encoders.FrozenCLIPT5Encoder",
    "dmtpu.models.stablediffusion.text_encoders.FrozenT5Embedder", "dmtpu.anything",
])
def test_unported_target_is_named(target):
    with pytest.raises(NotImplementedError, match="no counterpart in dmtpu_torch") as e:
        tconfig.resolve_target(target)
    assert target in str(e.value)


def test_unknown_target_fails_to_import():
    with pytest.raises(ImportError):
        tconfig.resolve_target("no_such_package.Thing")
    with pytest.raises(KeyError, match="target"):
        tconfig.instantiate_from_config({"params": {}})


def test_instantiate_builds_with_params_and_extra_kwargs():
    d = tconfig.instantiate_from_config(
        tconfig.Config({"target": "diffusions.ddim.DDIM",
                        "params": {"total_steps": 50, "respace_type": "uniform"}}),
        respace_steps=5, eta=0.5)
    assert isinstance(d, td.DDIM) and d.total_steps == 50 and d.eta == 0.5
    assert len(d.respaced_seq) >= 5
    # nested Config params reach the class as plain dicts
    sd = tconfig.instantiate_from_config(tconfig.Config(_tiny_sd_model()))
    assert isinstance(sd.vae, tsd.AutoencoderKL) and sd.unet.model_channels == 32


def test_config_and_dotlist_behave_as_the_jax_package_s(tmp_path):
    path = tiny_sd_config(tmp_path / "sd.yaml")
    want, got = jconfig.load_config(path), tconfig.load_config(path)
    assert got.to_dict() == want.to_dict()
    assert got.model.params.unet_config.params.model_channels == 32
    overrides = ["diffusion.params.total_steps=10", "train.optim.params.lr=1.0e-4",
                 "model.params.scale_factor=0.5", "new.list=[1, 2]", "empty="]
    assert tconfig.merge_dotlist(got, overrides).to_dict() == \
        jconfig.merge_dotlist(want, overrides).to_dict()
    assert got.train.optim.params.lr == 1e-4 and got.empty is None and got["new"]["list"] == [1, 2]
    got.extra = {"a": {"b": 1}}
    assert got.extra.a.b == 1 and got.get("missing") is None
    with pytest.raises(AttributeError):
        got.missing
    with pytest.raises(ValueError, match="key=value"):
        tconfig.merge_dotlist(got, ["novalue"])


def test_image_helpers_match_the_jax_package_s(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.uniform(-1.2, 1.2, size=(5, 6, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.make_grid(imgs, nrow=3), jimage.make_grid(imgs, nrow=3))
    np.testing.assert_array_equal(np.asarray(timage.to_pil(imgs)), np.asarray(jimage.to_pil(imgs)))
    gray = timage.to_pil(imgs[0, :, :, :1])
    assert gray.mode == "L" and gray.size == (4, 6)
    u8 = image_norm_to_uint8(np.array([-2.0, -1.0, 0.0, 1.0, 2.0]))
    assert u8.dtype == np.uint8 and u8.tolist() == [0, 0, 127, 255, 255]
    timage.save_image(imgs[1], str(tmp_path / "sub" / "a.png"))
    back = np.asarray(timage.pil_image().open(tmp_path / "sub" / "a.png"))
    np.testing.assert_array_equal(back, image_norm_to_uint8(imgs[1]))


def test_get_logger_reuses_or_replaces_handlers(tmp_path):
    name = "dmtpu_torch_test_logger"
    a = get_logger(name)
    assert get_logger(name) is a and len(a.handlers) == 1 and not a.propagate
    log = tmp_path / "run.log"
    b = get_logger(name, log_file=str(log))
    b.info("hello")
    assert len(b.handlers) == 2 and "hello" in log.read_text()
    c = get_logger(name)  # no file asked for: the file handler goes
    assert len(c.handlers) == 1
    assert get_logger(name, is_main_process=False).level == logging.INFO  # reused as it was
    for h in list(c.handlers):
        c.removeHandler(h)
    assert get_logger(name, is_main_process=False).level == logging.ERROR
