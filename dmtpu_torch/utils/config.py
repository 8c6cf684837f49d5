"""Config system: YAML, dotlist overrides and reflective instantiation.

Counterpart of ``dmtpu/utils/config.py``: ``Config`` wraps nested dicts with
attribute access, ``load_config`` reads YAML, ``merge_dotlist`` applies
``a.b.c=value`` overrides with YAML-typed values, and
``instantiate_from_config`` (reference: utils/misc.py:71-78) resolves the
``target:`` / ``params:`` schema.

The registry maps both the reference repo's dotted paths
(``models.stablediffusion.unet.UNetModel``, ``diffusions.ddim.DDIM``, ...)
and the JAX package's own (``dmtpu.models.stablediffusion.SDUNetModel``) onto
this package's classes, so one YAML drives both packages.  A target whose
counterpart is not ported yet raises ``NotImplementedError`` naming it; any
other dotted path is imported as it stands.

``yaml`` is imported inside the functions that parse text, so a config built
as a dict needs no YAML package.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Iterable, Mapping, Optional


class Config(dict):
    """Nested dict with attribute access (read and write) and a safe ``get``."""

    def __init__(self, data: Optional[Mapping] = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, Mapping) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return [Config._wrap(x) for x in v]
        return v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    def to_dict(self) -> Dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, Config) else x for x in v]
            else:
                out[k] = v
        return out


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading a YAML config needs the `yaml` package (PyYAML); "
                          "a config can also be given as a dict") from e
    return yaml


def load_config(path: str) -> Config:
    yaml = _yaml()
    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def merge_dotlist(conf: Config, dotlist: Iterable[str]) -> Config:
    """Apply ``key.sub=value`` overrides in place (YAML-typed values)."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Override '{item}' is not of the form key=value")
        key, _, raw = item.partition("=")
        value = _yaml().safe_load(raw) if raw != "" else None
        node = conf
        parts = key.strip().split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = Config._wrap(value)
    return conf


# ---------------------------------------------------------------------------
# target registry
# ---------------------------------------------------------------------------
# the reference repo's dotted paths -> the JAX package's (the table of
# dmtpu/utils/config.py), so that a reference YAML names the same thing here
_REFERENCE: Dict[str, str] = {
    "diffusions.ddpm.DDPM": "dmtpu.diffusions.ddpm.DDPM",
    "diffusions.ddpm.DDPMCFG": "dmtpu.diffusions.ddpm.DDPMCFG",
    "diffusions.cfg.ddpm_cfg.DDPMCFG": "dmtpu.diffusions.ddpm.DDPMCFG",
    "diffusions.ddim.DDIM": "dmtpu.diffusions.ddim.DDIM",
    "diffusions.ddim.DDIMCFG": "dmtpu.diffusions.ddim.DDIMCFG",
    "diffusions.ddpm_ip.DDPM_IP": "dmtpu.diffusions.ddpm_ip.DDPM_IP",
    "diffusions.euler.EulerSampler": "dmtpu.diffusions.euler.EulerSampler",
    "diffusions.heun.HeunSampler": "dmtpu.diffusions.heun.HeunSampler",
    "diffusions.dpm_solver.DPMSolverPP": "dmtpu.diffusions.dpm_solver.DPMSolverPP",
    "diffusions.dpm_solver.DPMSolverPPCFG": "dmtpu.diffusions.dpm_solver.DPMSolverPPCFG",
    "diffusions.flow.FlowMatching": "dmtpu.diffusions.flow.FlowMatching",
    "diffusions.flow.FlowMatchingCFG": "dmtpu.diffusions.flow.FlowMatchingCFG",
    "diffusions.flow_dpm.FlowDPMSolver": "dmtpu.diffusions.flow_dpm.FlowDPMSolver",
    "diffusions.flow_dpm.FlowDPMSolverCFG": "dmtpu.diffusions.flow_dpm.FlowDPMSolverCFG",
    "diffusions.guidance.base.BaseGuidance": "dmtpu.diffusions.guidance.base.BaseGuidance",
    "diffusions.guidance.mask_guidance.MaskGuidance":
        "dmtpu.diffusions.guidance.mask_guidance.MaskGuidance",
    "diffusions.guidance.ilvr.ILVR": "dmtpu.diffusions.guidance.ilvr.ILVR",
    "diffusions.guidance.clip_guidance.CLIPGuidance":
        "dmtpu.diffusions.guidance.clip_guidance.CLIPGuidance",
    "models.unet.UNet": "dmtpu.models.unet.UNet",
    "models.unet_categorial_adagn.UNetCategorialAdaGN":
        "dmtpu.models.unet_categorial_adagn.UNetCategorialAdaGN",
    "models.ema.EMA": "dmtpu.models.ema.EMAState",
    "models.pesser.model.Model": "dmtpu.models.pesser.PesserUNet",
    "models.adm.unet.UNetModel": "dmtpu.models.adm.UNetModel",
    "models.adm.unet_combined.UNetCombined": "dmtpu.models.adm.UNetCombined",
    "models.dit.dit.DiT": "dmtpu.models.latent.LatentDiffusionWrapper",
    "models.dit.model.DiT": "dmtpu.models.dit.DiT",
    "models.mmdit.MMDiT": "dmtpu.models.mmdit.MMDiT",
    "models.dit.autoencoder.AutoEncoderKL": "dmtpu.models.latent.PretrainedVAE",
    "models.mdt.mdt.MDT": "dmtpu.models.latent.LatentDiffusionWrapper",
    "models.mdt.model.MDTv2": "dmtpu.models.mdt.MDTv2",
    "models.mdt.autoencoder.AutoEncoderKL": "dmtpu.models.latent.PretrainedVAE",
    "models.stablediffusion.stablediffusion.StableDiffusion":
        "dmtpu.models.stablediffusion.StableDiffusion",
    "models.stablediffusion.unet.UNetModel": "dmtpu.models.stablediffusion.SDUNetModel",
    "models.stablediffusion.autoencoder.AutoEncoderKL":
        "dmtpu.models.stablediffusion.AutoencoderKL",
    "models.stablediffusion.text_encoders.FrozenCLIPEmbedder":
        "dmtpu.models.stablediffusion.FrozenCLIPEmbedder",
    "models.stablediffusion.text_encoders.FrozenOpenCLIPEmbedder":
        "dmtpu.models.stablediffusion.FrozenOpenCLIPEmbedder",
    "models.sdxl.stablediffusion.StableDiffusion": "dmtpu.models.sdxl.StableDiffusionXL",
    "models.sdxl.unet.UNetModel": "dmtpu.models.stablediffusion.SDUNetModel",
    "models.sdxl.autoencoder.AutoencoderKL": "dmtpu.models.stablediffusion.AutoencoderKL",
    "models.sdxl.conditioner.GeneralConditioner": "dmtpu.models.sdxl.SDXLConditioner",
    "datasets.ImageDir.ImageDir": "dmtpu.data.image_dir.ImageDir",
    "datasets.mnist.MNIST": "dmtpu.data.mnist.MNIST",
    "datasets.cifar10.CIFAR10": "dmtpu.data.cifar10.CIFAR10",
    "datasets.celebahq.CelebAHQ": "dmtpu.data.celebahq.CelebAHQ",
    "datasets.imagenet.ImageNet": "dmtpu.data.imagenet.ImageNet",
    "datasets.synthetic.Synthetic": "dmtpu.data.datasets.Synthetic",
    "torch.optim.Adam": "dmtpu.utils.optim.adam",
    "torch.optim.AdamW": "dmtpu.utils.optim.adamw",
    "torch.optim.SGD": "dmtpu.utils.optim.sgd",
}

# the JAX package's paths that have a counterpart here (the same path under
# ``dmtpu_torch``, but for the renames below)
_PORTED = {
    "dmtpu.diffusions.ddpm.DDPM", "dmtpu.diffusions.ddpm.DDPMCFG",
    "dmtpu.diffusions.ddim.DDIM", "dmtpu.diffusions.ddim.DDIMCFG",
    "dmtpu.diffusions.DDPM", "dmtpu.diffusions.DDPMCFG",
    "dmtpu.diffusions.ddpm_ip.DDPM_IP", "dmtpu.diffusions.DDPM_IP",
    "dmtpu.diffusions.DDIM", "dmtpu.diffusions.DDIMCFG",
    "dmtpu.diffusions.dpm_solver.DPMSolverPP", "dmtpu.diffusions.dpm_solver.DPMSolverPPCFG",
    "dmtpu.diffusions.pfdiff.PFDiffDDIM", "dmtpu.diffusions.pfdiff.PFDiffDDIMCFG",
    "dmtpu.diffusions.DPMSolverPP", "dmtpu.diffusions.DPMSolverPPCFG",
    "dmtpu.diffusions.PFDiffDDIM", "dmtpu.diffusions.PFDiffDDIMCFG",
    "dmtpu.diffusions.flow.FlowMatching", "dmtpu.diffusions.flow.FlowMatchingCFG",
    "dmtpu.diffusions.flow_dpm.FlowDPMSolver", "dmtpu.diffusions.flow_dpm.FlowDPMSolverCFG",
    "dmtpu.diffusions.FlowMatching", "dmtpu.diffusions.FlowMatchingCFG",
    "dmtpu.diffusions.FlowDPMSolver", "dmtpu.diffusions.FlowDPMSolverCFG",
    "dmtpu.diffusions.guidance.base.BaseGuidance",
    "dmtpu.diffusions.guidance.mask_guidance.MaskGuidance",
    "dmtpu.diffusions.guidance.mask_guidance.MaskGuidanceDDIMCFG",
    "dmtpu.diffusions.guidance.BaseGuidance", "dmtpu.diffusions.guidance.MaskGuidance",
    "dmtpu.diffusions.guidance.MaskGuidanceDDIMCFG",
    "dmtpu.diffusions.guidance.ilvr.ILVR", "dmtpu.diffusions.guidance.ILVR",
    "dmtpu.diffusions.guidance.clip_guidance.CLIPGuidance",
    "dmtpu.diffusions.guidance.CLIPGuidance",
    "dmtpu.diffusions.euler.EulerSampler", "dmtpu.diffusions.heun.HeunSampler",
    "dmtpu.diffusions.EulerSampler", "dmtpu.diffusions.HeunSampler",
    "dmtpu.models.ema.EMAState",
    "dmtpu.models.unet.UNet", "dmtpu.models.unet_categorial_adagn.UNetCategorialAdaGN",
    "dmtpu.models.pesser.PesserUNet",
    "dmtpu.models.adm.UNetModel", "dmtpu.models.adm.SuperResModel",
    "dmtpu.models.adm.EncoderUNetModel", "dmtpu.models.adm.UNetCombined",
    "dmtpu.models.adm.AttentionBlock", "dmtpu.models.adm.AttentionPool2d",
    "dmtpu.models.modules.SelfAttentionBlock", "dmtpu.models.modules.AdaGN",
    "dmtpu.models.modules.FusedGNSiLU",
    "dmtpu.models.dit.DiT", "dmtpu.models.mdt.MDTv2", "dmtpu.models.mmdit.MMDiT",
    "dmtpu.models.latent.LatentDiffusionWrapper", "dmtpu.models.latent.PretrainedVAE",
    "dmtpu.models.stablediffusion.StableDiffusion",
    "dmtpu.models.stablediffusion.SDUNetModel",
    "dmtpu.models.stablediffusion.unet.SDUNetModel",
    "dmtpu.models.stablediffusion.AutoencoderKL",
    "dmtpu.models.stablediffusion.autoencoder.AutoencoderKL",
    "dmtpu.models.stablediffusion.FrozenCLIPEmbedder",
    "dmtpu.models.stablediffusion.FrozenOpenCLIPEmbedder",
    "dmtpu.models.stablediffusion.text_encoders.FrozenCLIPEmbedder",
    "dmtpu.models.stablediffusion.text_encoders.FrozenOpenCLIPEmbedder",
    "dmtpu.models.stablediffusion.FrozenT5Embedder",
    "dmtpu.models.stablediffusion.FrozenCLIPT5Encoder",
    "dmtpu.models.stablediffusion.text_encoders.FrozenT5Embedder",
    "dmtpu.models.stablediffusion.text_encoders.FrozenCLIPT5Encoder",
    "dmtpu.models.sdxl.StableDiffusionXL", "dmtpu.models.sdxl.SDXLConditioner",
    "dmtpu.utils.optim.adam", "dmtpu.utils.optim.adamw", "dmtpu.utils.optim.adafactor",
    "dmtpu.utils.optim.sgd",
    "dmtpu.data.captioned.CaptionedImageDir", "dmtpu.data.captioned.SyntheticCaptioned",
    "dmtpu.data.captioned.SyntheticEmbedded",
    "dmtpu.data.datasets.ImageDir", "dmtpu.data.datasets.MNIST", "dmtpu.data.datasets.CIFAR10",
    "dmtpu.data.datasets.CelebAHQ", "dmtpu.data.datasets.ImageNet",
    "dmtpu.data.datasets.Synthetic", "dmtpu.data.image_dir.ImageDir", "dmtpu.data.mnist.MNIST",
    "dmtpu.data.cifar10.CIFAR10", "dmtpu.data.celebahq.CelebAHQ", "dmtpu.data.imagenet.ImageNet",
    "dmtpu.eval.CLIPFeatureExtractor", "dmtpu.eval.FIDInceptionV3",
    "dmtpu.eval.InceptionFeatureExtractor", "dmtpu.eval.fid.CLIPFeatureExtractor",
    "dmtpu.eval.inception.FIDInceptionV3", "dmtpu.eval.inception.InceptionFeatureExtractor",
    "dmtpu.eval.inception.BasicConv2d", "dmtpu.eval.inception.InceptionA",
    "dmtpu.eval.inception.InceptionB", "dmtpu.eval.inception.InceptionC",
    "dmtpu.eval.inception.InceptionD", "dmtpu.eval.inception.InceptionE",
}


def resolve_target(target: str) -> Any:
    """The object a ``target:`` string names in this package."""
    name = _REFERENCE.get(target, target)
    if name == "dmtpu" or name.startswith("dmtpu."):
        if name not in _PORTED:
            raise NotImplementedError(
                f"target {target!r} ({name}) has no counterpart in dmtpu_torch yet")
        name = "dmtpu_torch" + name[len("dmtpu"):]
    module, _, attr = name.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def instantiate_from_config(conf: Mapping, **extra_kwargs: Any) -> Any:
    """Build the object named by ``conf['target']`` with ``conf['params']``.
    (reference: utils/misc.py:71-78)"""
    if "target" not in conf:
        raise KeyError("Expected key `target` to instantiate.")
    cls = resolve_target(conf["target"])
    params = dict(conf.get("params", None) or {})
    params.update(extra_kwargs)
    params = {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in params.items()}
    return cls(**params)
