"""Class-conditional latent-diffusion train steps, back to back (DiT).

The step is ``dmtpu_torch.parallel.make_train_step`` over
``make_diffusion_loss_fn``, as ``scripts/train_ddpm_cfg.py`` builds it: t
uniform over the schedule, eps, and each label dropped to the null class
with probability ``p_uncond``, all drawn from the step's generator; the
eps-MSE; AdamW; an EMA.  Batches are pre-encoded latents and labels,
cycled from a pool made in set-up from the seed.  Parameters: ``batch``,
``pool``, ``first_steps``, ``lr``, ``weight_decay``, ``ema_decay``,
``ema_gradual``, ``p_uncond``, ``chunks`` (the reference's blocks of rows).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from portbench import flops, weights
from portbench.harness import Context, sub_seed
from portbench.reference import diffusion as ref_diffusion
from portbench.reference import dit as ref_dit
from portbench.reference import optim as ref_optim
from portbench.reference.nn import no_tf32, set_precision
from portbench.training import TrainingCell, follow, step_seed

LATENT = 4


class Cell(TrainingCell):
    def __init__(self, ctx: Context):
        super().__init__(ctx)
        self.vit = ctx.config["model"]["params"]["vit_config"]
        self.num_classes = int(self.vit["params"]["num_classes"])
        self.size = int(self.vit["params"]["input_size"])
        with torch.device("meta"):
            ref = self._build_reference()
        self.shapes = weights.shapes_of(ref)
        b = self.batch
        fwd = flops.count(ref, torch.zeros(b, LATENT, self.size, self.size),
                          torch.zeros(b, dtype=torch.long), torch.zeros(b, dtype=torch.long))
        self.flops_per_unit = 3 * fwd.flops
        self.denoiser_calls_per_unit = 1
        k1 = [shape + (2,) for _, shape in fwd.attention]
        self.kernel_calls = {"k1": k1, "k2": k1}

    def _build_reference(self) -> ref_dit.DiT:
        return ref_dit.DiT(**self.vit["params"])

    def build_program(self) -> None:
        from dmtpu_torch.diffusions import DDPM
        from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
        from dmtpu_torch.utils.config import instantiate_from_config
        from dmtpu_torch.utils.optim import adamw

        p, dev = self.params, self.device
        model = instantiate_from_config(self.vit, device=dev).train()
        model.load_state_dict(weights.make(self.shapes, self.weight_seed, dev))
        optimizer = adamw(model.parameters(), lr=float(p["lr"]),
                          weight_decay=float(p["weight_decay"]))
        self.state = TrainState.create(model, optimizer, ema_decay=float(p["ema_decay"]),
                                       ema_gradual=bool(p["ema_gradual"]))
        dp = dict(self.ctx.config["diffusion"]["params"])
        diffuser = DDPM(**dp)
        loss_fn = make_diffusion_loss_fn(
            diffuser, lambda x, t, **kw: model(x, t, train=True, **kw), int(dp["total_steps"]),
            p_uncond=float(p["p_uncond"]), null_label=self.num_classes)
        self.step_fn = make_train_step(loss_fn, clip_grad_norm=None, seed=self.train_seed)
        self.pool = self._pool()

    def _pool(self) -> list:
        """(latents [batch, 4, size, size], labels [batch]) x pool, from the seed."""
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.ctx.seed, "pool"))
        n, b, s = self.pool_size, self.batch, self.size
        x = torch.randn(n, b, LATENT, s, s, generator=gen, device=self.device)
        y = torch.randint(0, self.num_classes, (n, b), generator=gen, device=self.device)
        return [(x[k], y[k]) for k in range(n)]

    def program_first_grads(self) -> Dict[str, float]:
        opt = self.state.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        # a leaf the optimizer never stepped has no moment: no gradient reached it
        return {n: float(opt.state[p]["exp_avg"].double().norm()) / (1 - b1)
                if "exp_avg" in opt.state[p] else 0.0
                for n, p in self.state.model.named_parameters()}

    def reference_steps(self, precision) -> Dict[str, Any]:
        p, dev = self.params, self.device
        model = weights.reference_model(self._build_reference, self.weight_seed, dev)
        if precision is not None:
            set_precision(model, precision)
        params = dict(model.named_parameters())
        opt = ref_optim.AdamW(float(p["lr"]), weight_decay=float(p["weight_decay"]))
        ema = ref_optim.EMA(params, float(p["ema_decay"]), bool(p["ema_gradual"]))
        ac = ref_diffusion.schedule_of(self.ctx.config["diffusion"]["params"])
        pool = self._pool()
        draws = {}

        def loss_of(k, c, chunks):
            if c == 0:  # the step's draws, in the train step's order
                x0, y = pool[k % self.pool_size]
                gen = torch.Generator(device=dev).manual_seed(step_seed(self.train_seed, k))
                t = torch.randint(0, len(ac), (self.batch,), generator=gen, device=dev)
                eps = torch.randn(x0.shape, generator=gen, device=dev)
                drop = torch.rand(self.batch, generator=gen, device=dev) < float(p["p_uncond"])
                draws.update(x0=x0, t=t, eps=eps, y=torch.where(drop, self.num_classes, y))
            rows = slice(c * self.batch // chunks, (c + 1) * self.batch // chunks)
            d = {k2: v[rows] for k2, v in draws.items()}
            xt = ref_diffusion.diffuse(d["x0"], d["t"], d["eps"], ac)
            return ref_diffusion.eps_mse(model(xt, d["t"], d["y"]), d["eps"])

        with no_tf32():
            out = follow(model, opt, ema, self.first_steps, loss_of, int(p["chunks"]))
        del model, params, opt, ema
        return out
