"""Stable Diffusion fine-tuning steps, back to back.

The step is ``dmtpu_torch.parallel.make_train_step`` over
``dmtpu_torch.scripts.train_sd.make_sd_loss_fn``, as ``scripts/train_sd.py``
builds it: the VAE encodes the images and samples the posterior, each
caption is dropped to the empty prompt with probability ``p_uncond``, the
text tower encodes the ids (both without gradients), t and eps are drawn,
the UNet trains on the eps-MSE; the gradients are clipped to
``clip_grad_norm``; Adafactor; an EMA of the UNet.  Batches of images in
[-1, 1] and token ids are cycled from a pool made in set-up from the seed.
Parameters: ``batch``, ``pool``, ``first_steps``, ``lr``, ``clip_grad_norm``,
``ema_decay``, ``ema_gradual``, ``ema_dtype``, ``p_uncond``, ``chunks``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from portbench import flops, weights
from portbench.harness import Context, sub_seed
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import optim as ref_optim
from portbench.reference import sd as ref_sd
from portbench.reference.nn import no_tf32, set_precision
from portbench.reference.tokens import demo_ids
from portbench.training import TrainingCell, follow, step_seed

LATENT = 4


class Cell(TrainingCell):
    device_under_names = ("GroupNormSiLU.backward",)
    prefix = "unet."

    def __init__(self, ctx: Context):
        super().__init__(ctx)
        self.model_params = ctx.config["model"]["params"]
        te = self.model_params["text_encoder_config"]["params"]
        self.length = int(te.get("max_length", 77))
        self.vocab = int(te.get("config_overrides", {}).get("vocab_size", 49408))
        self.size = int(self.params["size"])
        with torch.device("meta"):
            ref = ref_sd.StableDiffusion(self.model_params)
        self.shapes = weights.shapes_of(ref)
        down = 2 ** (len(self.model_params["vae_config"]["params"]["ch_mult"]) - 1)
        b, lat = self.batch, self.size // down
        ctx_dim = self.model_params["unet_config"]["params"]["context_dim"]
        unet = flops.count(ref.unet, torch.zeros(b, LATENT, lat, lat),
                           torch.zeros(b, dtype=torch.long), torch.zeros(b, self.length, ctx_dim))
        enc = flops.count(ref.vae, torch.zeros(b, 3, self.size, self.size),
                          method="encode_moments")
        clip = flops.count(ref.text_encoder.model, torch.zeros(b, self.length, dtype=torch.long))
        self.flops_per_unit = 3 * unet.flops + enc.flops + clip.flops
        self.denoiser_calls_per_unit = 1
        k1 = [shape + (2,) for _, shape in unet.attention]
        k3 = [shape[:3] + (4, shape[3]) for _, shape in enc.group_norm]
        k3 += [shape[:3] + (4 if name == "out.0" else 2, shape[3])
               for name, shape in unet.group_norm]
        self.kernel_calls = {"k1": k1, "k2": k1, "k3": k3}

    def _empty_ids(self) -> torch.Tensor:
        return torch.as_tensor(demo_ids("", self.length, self.vocab), device=self.device)

    def _pool(self) -> list:
        """{"image": [batch, 3, size, size] in [-1, 1], "input_ids": [batch,
        length]} x pool, from the seed; ids as a tokenizer lays them out (the
        start id, ids in [3, vocab - 1), the end id)."""
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.ctx.seed, "pool"))
        n, b, s = self.pool_size, self.batch, self.size
        images = torch.rand(n, b, 3, s, s, generator=gen, device=self.device) * 2 - 1
        ids = torch.randint(3, self.vocab - 1, (n, b, self.length), generator=gen,
                            device=self.device)
        ids[..., 0], ids[..., -1] = 0, 2
        return [{"image": images[k], "input_ids": ids[k]} for k in range(n)]

    def build_program(self) -> None:
        from dmtpu_torch.diffusions import DDPM
        from dmtpu_torch.parallel import TrainState, make_train_step
        from dmtpu_torch.scripts.train_sd import make_sd_loss_fn
        from dmtpu_torch.utils.config import instantiate_from_config
        from dmtpu_torch.utils.optim import adafactor

        p, dev = self.params, self.device
        sd = instantiate_from_config(self.ctx.config["model"], device=dev)
        sd.load_state_dict(weights.make(self.shapes, self.weight_seed, dev))
        for frozen in (sd.vae, sd.text_encoder):
            frozen.requires_grad_(False).eval()
        sd.unet.train()
        optimizer = adafactor(sd.unet.parameters(), lr=float(p["lr"]))
        self.state = TrainState.create(sd.unet, optimizer, ema_decay=float(p["ema_decay"]),
                                       ema_gradual=bool(p["ema_gradual"]),
                                       ema_dtype=p["ema_dtype"])
        dp = dict(self.ctx.config["diffusion"]["params"])
        loss_fn = make_sd_loss_fn(sd, DDPM(**dp), self._empty_ids(), float(p["p_uncond"]),
                                  int(dp["total_steps"]))
        self.step_fn = make_train_step(loss_fn, clip_grad_norm=float(p["clip_grad_norm"]),
                                       seed=self.train_seed)
        self.pool = self._pool()
        self.sd = sd

    def release(self) -> None:
        del self.sd
        super().release()

    def program_first_grads(self) -> Dict[str, float]:
        opt = self.state.optimizer
        out = {}
        for name, p in self.state.model.named_parameters():
            st = opt.state[p]
            if "v" in st:
                out[name] = float(st["v"].double().sum().sqrt())
            elif "v_row" not in st:  # never stepped: no gradient reached it
                out[name] = 0.0
            else:
                largest = max(range(p.dim()), key=lambda i: (p.shape[i], i))
                out[name] = float((st["v_row"].double().sum() * p.shape[largest]).sqrt())
        return out

    def reference_steps(self, precision) -> Dict[str, Any]:
        p, dev = self.params, self.device
        ref = weights.reference_model(lambda: ref_sd.StableDiffusion(self.model_params),
                                      self.weight_seed, dev)
        if precision is not None:
            set_precision(ref, "bf16")
            set_precision(ref.unet, precision)
        for frozen in (ref.vae, ref.text_encoder):
            frozen.requires_grad_(False)
        unet = ref.unet
        params = dict(unet.named_parameters())
        opt = ref_optim.Adafactor(float(p["lr"]))
        dtype = getattr(torch, p["ema_dtype"]) if p["ema_dtype"] else None
        ema = ref_optim.EMA(params, float(p["ema_decay"]), bool(p["ema_gradual"]), dtype)
        ac = ref_diffusion.schedule_of(self.ctx.config["diffusion"]["params"])
        pool, empty = self._pool(), self._empty_ids()
        draws = {}

        def loss_of(k, c, chunks):
            if c == 0:  # the step's inputs and draws, in the loss's order
                batch = pool[k % self.pool_size]
                gen = torch.Generator(device=dev).manual_seed(step_seed(self.train_seed, k))
                b = self.batch
                with torch.no_grad():
                    moments = torch.cat([ref.vae.encode_moments(x)
                                         for x in batch["image"].split(4)])
                    noise = torch.randn(moments[:, :LATENT].shape, generator=gen, device=dev)
                    z0 = ref.scale_factor * ref_sd.sample_posterior(moments, noise)
                    drop = torch.rand(b, generator=gen, device=dev) < float(p["p_uncond"])
                    ids = torch.where(drop[:, None], empty, batch["input_ids"])
                    context = ref.encode_text(ids)
                t = torch.randint(0, len(ac), (b,), generator=gen, device=dev)
                eps = torch.randn(z0.shape, generator=gen, device=dev)
                draws.update(z0=z0, t=t, eps=eps, context=context)
            rows = slice(c * self.batch // chunks, (c + 1) * self.batch // chunks)
            d = {k2: v[rows] for k2, v in draws.items()}
            xt = ref_diffusion.diffuse(d["z0"], d["t"], d["eps"], ac)
            return ref_diffusion.eps_mse(unet(xt, d["t"], d["context"]), d["eps"])

        with no_tf32():
            out = follow(unet, opt, ema, self.first_steps, loss_of, int(p["chunks"]),
                         clip=float(p["clip_grad_norm"]))
        del ref, unet, params, opt, ema
        return out
