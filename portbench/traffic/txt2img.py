"""Text-to-image requests, back to back from one client.

Each request is ``dmtpu_torch.scripts.sample_sd.sample_images`` on a ready
``StableDiffusion``: one prompt, drawn from the seed out of the traffic
file's captions, and the negative prompt; ``batch`` images at
``height`` x ``width`` by DDIM-CFG with ``steps`` uniform steps; the images
reach the host as uint8.  Parameters (``params``): ``batch``, ``height``,
``width``, ``steps``, ``guidance``, ``negative``, ``captions``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import flops, weights
from portbench.harness import Context, sub_seed
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import sd as ref_sd
from portbench.reference.nn import no_tf32, set_precision
from portbench.reference.tokens import demo_ids
from portbench.sampling import SamplingCell, noise_rows, request_seed

LATENT = 4


class Cell(SamplingCell):
    def __init__(self, ctx: Context):
        super().__init__(ctx)
        p = self.params
        self.h, self.w, self.steps = int(p["height"]), int(p["width"]), int(p["steps"])
        self.guidance, self.negative = float(p["guidance"]), p["negative"]
        self.captions = list(p["captions"])
        self.model_params = ctx.config["model"]["params"]
        rng = np.random.default_rng(sub_seed(ctx.seed, "prompts"))
        self.prompt_of = rng.integers(0, len(self.captions), size=100_000)
        self.weight_seed = sub_seed(ctx.seed, "weights")
        self._count_work()

    def _build_reference(self) -> ref_sd.StableDiffusion:
        return ref_sd.StableDiffusion(self.model_params)

    def _count_work(self) -> None:
        with torch.device("meta"):
            ref = self._build_reference()
        self.shapes = weights.shapes_of(ref)
        te = self.model_params["text_encoder_config"]["params"]
        length = te.get("max_length", 77)
        ctx_dim = self.model_params["unet_config"]["params"]["context_dim"]
        lat = (LATENT, self.h // 8, self.w // 8)
        b2 = 2 * self.batch
        clip = flops.count(ref.text_encoder.model, torch.zeros(1, length, dtype=torch.long))
        unet = flops.count(ref.unet, torch.zeros(b2, *lat), torch.zeros(b2, dtype=torch.long),
                           torch.zeros(b2, length, ctx_dim))
        dec = flops.count(ref.vae, torch.zeros(self.batch, *lat), method="decode")
        self.flops_per_unit = 2 * clip.flops + self.steps * unet.flops + dec.flops
        self.denoiser_calls_per_unit = self.steps
        # the UNet's attention and every GroupNorm run on the program's kernels:
        # the torso in bf16, its output norm and the VAE in f32
        k1 = [shape + (2,) for _, shape in unet.attention] * self.steps
        k3 = [shape[:3] + (4 if name == "out.0" else 2, shape[3])
              for name, shape in unet.group_norm] * self.steps
        k3 += [shape[:3] + (4, shape[3]) for _, shape in dec.group_norm]
        self.kernel_calls = {"k1": k1, "k3": k3}

    # --- the program ------------------------------------------------------------
    def setup(self) -> None:
        from dmtpu_torch.utils.config import instantiate_from_config

        self.sd = instantiate_from_config(self.ctx.config["model"], device=self.device).eval()
        self.sd.load_state_dict(weights.make(self.shapes, self.weight_seed, self.device))
        # every shape the window uses: the text tower, the UNet at the doubled
        # batch, the decode and the copy to the host, in a two-step request
        self.serve(self.request(-1), None, steps=2)

    def request(self, i: int) -> Dict[str, Any]:
        return {"prompt": self.captions[self.prompt_of[i % len(self.prompt_of)]],
                "seed": request_seed(self.ctx.seed, i)}

    def serve(self, req: Dict[str, Any], on_stage, steps: Optional[int] = None) -> np.ndarray:
        from dmtpu_torch.scripts.sample_sd import sample_images

        return sample_images(
            self.ctx.config, req["prompt"], self.negative, n_samples=self.batch,
            batch_size=self.batch, height=self.h, width=self.w, seed=req["seed"],
            sampler="ddim", respace_type="uniform", respace_steps=steps or self.steps,
            guidance_scale=self.guidance, device=str(self.device), sd=self.sd,
            on_stage=on_stage)

    def release(self) -> None:
        del self.sd
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference ------------------------------------------------------------
    def reference_images(self, picks: Sequence[Tuple[int, int]],
                         precision: Optional[str]) -> np.ndarray:
        ref = weights.reference_model(self._build_reference, self.weight_seed, self.device)
        if precision is not None:
            # the torso one precision below the configured bf16, the f32 parts
            # (text tower, VAE) one below f32
            set_precision(ref, "bf16")
            set_precision(ref.unet, precision)
        model = ref.text_encoder.model
        vocab = model.embeddings.token_embedding.num_embeddings
        length = model.embeddings.position_embedding.num_embeddings
        ac = ref_diffusion.schedule_of(self.ctx.config["diffusion"]["params"])
        lat = (self.batch, LATENT, self.h // 8, self.w // 8)
        with torch.no_grad(), no_tf32():
            def embed(text):
                ids = torch.as_tensor(demo_ids(text, length, vocab), device=self.device)
                return ref.encode_text(ids)

            uncond = embed(self.negative)
            conds, noises = [], []
            for r, j in picks:
                req = self.outputs[r][0]
                conds.append(embed(req["prompt"]))
                noises.append(noise_rows(req["seed"], lat, [j], self.device))
            cond = torch.cat(conds)
            z = ref_diffusion.ddim_cfg(ref.unet, torch.cat(noises), cond,
                                       uncond.expand_as(cond), ac, self.steps, self.guidance)
            images = [ref.decode_latent(z[k:k + 1]).clamp(-1.0, 1.0) for k in range(len(z))]
        del ref
        return ref_diffusion.to_uint8(torch.cat(images))
