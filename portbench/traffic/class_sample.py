"""Class-conditional requests, back to back from one client (DiT).

Each request is ``dmtpu_torch.scripts.sample_cfg.sample_class`` on a ready
latent model: one class, drawn from the seed; ``batch`` images by DDIM-CFG
with ``steps`` uniform steps (the null class as the unconditional branch,
so twice ``batch`` rows a call); the VAE decode; the images to the host as
uint8.  Parameters: ``batch``, ``steps``, ``guidance``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from portbench import flops, weights
from portbench.harness import Context, sub_seed
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import dit as ref_dit
from portbench.reference import sd as ref_sd
from portbench.reference.nn import no_tf32, set_precision
from portbench.sampling import SamplingCell, noise_rows, request_seed

LATENT = 4


class LatentDiT(nn.Module):
    """The reference's DiT and VAE, under the names ``vit.`` and ``vae.``."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        self.scale_factor = float(params["scale_factor"])
        self.vit = ref_dit.DiT(**params["vit_config"]["params"])
        self.vae = ref_sd.AutoencoderKL(**params["vae_config"]["params"])


def batch_seed(seed: int, class_id: int, index: int) -> int:
    """The seed of a request's noise, worked out as the request derives it:
    NumPy's SeedSequence of (seed, class, batch index), one 64-bit word."""
    return int(np.random.SeedSequence([seed, class_id, index]).generate_state(1, np.uint64)[0])


class Cell(SamplingCell):
    def __init__(self, ctx: Context):
        super().__init__(ctx)
        p = self.params
        self.steps, self.guidance = int(p["steps"]), float(p["guidance"])
        self.model_params = ctx.config["model"]["params"]
        vit = self.model_params["vit_config"]["params"]
        self.num_classes, self.size = int(vit["num_classes"]), int(vit["input_size"])
        rng = np.random.default_rng(sub_seed(ctx.seed, "classes"))
        self.class_of = rng.integers(0, self.num_classes, size=100_000)
        self.weight_seed = sub_seed(ctx.seed, "weights")
        with torch.device("meta"):
            ref = self._build_reference()
        self.shapes = weights.shapes_of(ref)
        b2, lat = 2 * self.batch, (LATENT, self.size, self.size)
        vit_count = flops.count(ref.vit, torch.zeros(b2, *lat), torch.zeros(b2, dtype=torch.long),
                                torch.zeros(b2, dtype=torch.long))
        dec = flops.count(ref.vae, torch.zeros(self.batch, *lat), method="decode")
        self.flops_per_unit = self.steps * vit_count.flops + dec.flops
        self.denoiser_calls_per_unit = self.steps
        self.kernel_calls = {
            "k1": [shape + (2,) for _, shape in vit_count.attention] * self.steps,
            "k3": [shape[:3] + (4, shape[3]) for _, shape in dec.group_norm]}

    def _build_reference(self) -> LatentDiT:
        return LatentDiT(self.model_params)

    # --- the program ------------------------------------------------------------
    def setup(self) -> None:
        from dmtpu_torch.diffusions import DDIMCFG
        from dmtpu_torch.utils.config import instantiate_from_config

        self.model = instantiate_from_config(self.ctx.config["model"], device=self.device).eval()
        self.model.load_state_dict(weights.make(self.shapes, self.weight_seed, self.device))
        dp = dict(self.ctx.config["diffusion"]["params"])
        self.diffuser = DDIMCFG(**dp, respace_type="uniform", respace_steps=self.steps,
                                guidance_scale=self.guidance, eta=0.0)
        warm = DDIMCFG(**dp, respace_type="uniform", respace_steps=2,
                       guidance_scale=self.guidance, eta=0.0)
        self.serve(self.request(-1), None, diffuser=warm)

    def request(self, i: int) -> Dict[str, Any]:
        return {"class": int(self.class_of[i % len(self.class_of)]),
                "seed": request_seed(self.ctx.seed, i)}

    def serve(self, req: Dict[str, Any], on_stage, diffuser=None) -> np.ndarray:
        from dmtpu_torch.scripts.sample_cfg import sample_class
        from dmtpu_torch.utils.misc import image_norm_to_uint8

        if on_stage is not None:
            on_stage("begin")
        with torch.no_grad():
            images = sample_class(
                self.model, diffuser or self.diffuser, req["class"], self.batch,
                shape=(LATENT, self.size, self.size), num_classes=self.num_classes,
                batch_size=self.batch, seed=req["seed"], decode=True, device=self.device,
                on_stage=on_stage)
        return image_norm_to_uint8(images.permute(0, 2, 3, 1).cpu().numpy())

    def release(self) -> None:
        del self.model, self.diffuser
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference ------------------------------------------------------------
    def reference_images(self, picks: Sequence[Tuple[int, int]],
                         precision: Optional[str]) -> np.ndarray:
        ref = weights.reference_model(self._build_reference, self.weight_seed, self.device)
        if precision is not None:
            set_precision(ref, "bf16")
            set_precision(ref.vit, precision)
        ac = ref_diffusion.schedule_of(self.ctx.config["diffusion"]["params"])
        lat = (self.batch, LATENT, self.size, self.size)
        noises, labels = [], []
        for r, j in picks:
            req = self.outputs[r][0]
            noises.append(noise_rows(batch_seed(req["seed"], req["class"], 0), lat, [j],
                                     self.device))
            labels.append(req["class"])
        y = torch.tensor(labels, device=self.device)
        with torch.no_grad(), no_tf32():
            z = ref_diffusion.ddim_cfg(ref.vit, torch.cat(noises), y,
                                       torch.full_like(y, self.num_classes), ac, self.steps,
                                       self.guidance)
            images = [ref.vae.decode(z[k:k + 1].float() / ref.scale_factor).clamp(-1.0, 1.0)
                      for k in range(len(z))]
        del ref
        return ref_diffusion.to_uint8(torch.cat(images))
