"""Time the port's end-to-end paths for checkouts of this repository, in turns, on one card.

    python -m dmtpu_torch.dev.compare PARENT_TREE CHANGED_TREE
        [--workloads train ddim50 txt2img finetune]

Each tree's own ``dmtpu_torch`` (its kernels built from its own sources)
runs, in a subprocess of its own, the end-to-end workloads of
``chip_smoke.py`` at full SD1.5 width with seeded random weights:

- ``train``: phase 7's step: bf16 torso, full remat, the DDPM eps-loss at
  batch 16 on 64x64x4 latents with a 77x768 context, adafactor (lr 1e-4),
  clipping at 1.0, a gradual bf16 EMA; ms per step over ``--repeats``
  windows of 5 steps after one warm-up step;
- ``ddim50``: phase 5's DDIM-50 at batch 16 (uniform respacing of 1000), one
  warm-up and ``--repeats`` timed runs: samples per second;
- ``txt2img``: phase 8's request through the CLI's pipeline function
  ``sample_images``: prompt and negative prompt, DDIMCFG-50 (s = 7.5) at
  batch 16, 512x512, the VAE decode; one warm-up and ``--repeats`` timed
  runs: images per second;
- ``finetune``: the fine-tuning CLI itself in a fresh process, as a user
  runs it: ``train_sd.main`` at batch 8, 512x512, from
  ``configs/sd15_finetune.yaml`` and then ``configs/sd15_lora.yaml``, on
  ``chip_smoke.py``'s 16 noise PNGs with captions and its character-level
  tokenizer, the loss read at every step (``print_freq`` 1), no preview, one
  checkpoint at the end; ms per step between the loop's steps from the second
  on, ``1 + 5 * --repeats`` steps.  Trees from before the CLI cannot run it.

Times are host clock around work that ends in ``torch.cuda.synchronize()``.
The trees run in turns (a, b, b, a for two), so that two versions are
compared on one card in one call; each run prints one JSON line with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

WORKLOADS = ("train", "ddim50", "txt2img", "finetune")
SD15 = dict(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
            attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4), num_heads=8,
            use_spatial_transformer=True, transformer_depth=1, context_dim=768, legacy=False)


def _timed(fn, repeats: int) -> list:
    import torch

    fn()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


def finetune_ms(tree: str, repeats: int) -> dict:
    """The ``finetune`` workload of ``tree`` (its ``chip_smoke.py`` and
    ``train_sd``): ms per step of the full fine-tune and of LoRA."""
    import shutil
    import tempfile

    import chip_smoke
    import torch
    from dmtpu_torch.scripts import train_sd

    out = {}
    root = tempfile.mkdtemp(prefix="dmtpu_compare_")
    try:
        images, tokenizer = chip_smoke.write_finetune_inputs(root, 16, 512)
        for mode, config in (("full", chip_smoke.FT_CONFIG), ("lora", chip_smoke.LORA_CONFIG)):
            result = train_sd.main([
                "-c", os.path.join(tree, config), "-e", os.path.join(root, mode), "-ni",
                "--device", "cuda", f"data.params.root={images}", f"tokenizer={tokenizer}",
                "train.batch_size=8", "dataloader.num_workers=4", "train.print_freq=1",
                f"train.n_steps={1 + 5 * repeats}", "train.save_freq=0", "train.sample_freq=0"])
            out[f"finetune_{mode}_ms_per_step"] = [1e3 * s for s in result["step_seconds"]]
            shutil.rmtree(os.path.join(root, mode))
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def run_one(tree: str, workloads, repeats: int) -> dict:
    sys.path.insert(0, tree)
    import torch
    from dmtpu_torch.ops import _build

    if not os.path.abspath(_build.__file__).startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not the package of {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("compare needs a CUDA device")
    _build.build()
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": tree}

    def unet(**kw):
        from dmtpu_torch.models.stablediffusion import SDUNetModel

        model = SDUNetModel(**SD15, torso_dtype=torch.bfloat16, device=dev, **kw)
        with torch.no_grad():  # N(0, 1/fan_in) weights, small vectors: every layer non-zero
            for p in model.parameters():
                std = p[0].numel() ** -0.5 if p.dim() > 1 else 0.02
                p.copy_(std * torch.randn(p.shape, generator=g, device=dev))
        return model

    if "train" in workloads:
        from dmtpu_torch.diffusions import DDPM
        from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
        from dmtpu_torch.utils.optim import adafactor

        model = unet(use_checkpoint=True).train()
        state = TrainState.create(model, adafactor(model.parameters(), lr=1e-4),
                                  ema_decay=0.9999, ema_gradual=True, ema_dtype=torch.bfloat16)
        step = make_train_step(make_diffusion_loss_fn(DDPM(total_steps=1000), model, 1000),
                               clip_grad_norm=1.0)
        batch = {"image": torch.randn(16, 4, 64, 64, generator=g, device=dev),
                 "context": torch.randn(16, 77, 768, generator=g, device=dev)}
        seconds = _timed(lambda: [step(state, batch) for _ in range(5)], repeats)
        out["train_ms_per_step"] = [1e3 * s / 5 for s in seconds]
        del model, state, step, batch
        torch.cuda.empty_cache()
    if "ddim50" in workloads:
        from dmtpu_torch.diffusions import DDIM

        model = unet().eval()
        sampler = DDIM(total_steps=1000, respace_type="uniform", respace_steps=50)
        ctx = torch.randn(16, 77, 768, generator=g, device=dev)
        noise = torch.randn(16, 4, 64, 64, generator=g, device=dev)
        with torch.no_grad():
            seconds = _timed(lambda: sampler.sample(lambda x, t, **kw: model(x, t, ctx), noise),
                             repeats)
        out["ddim50_samples_per_s"] = [16 / s for s in seconds]
        del model
        torch.cuda.empty_cache()
    if "txt2img" in workloads:
        from dmtpu_torch.scripts.sample_sd import build_model, sample_images

        conf = {
            "model": {"target": "dmtpu.models.stablediffusion.StableDiffusion", "params": {
                "scale_factor": 0.18215,
                "unet_config": {"target": "dmtpu.models.stablediffusion.SDUNetModel",
                                "params": dict(SD15, torso_dtype="bfloat16")},
                "vae_config": {"target": "dmtpu.models.stablediffusion.AutoencoderKL",
                               "params": {"embed_dim": 4, "z_channels": 4, "resolution": 256,
                                          "ch": 128, "ch_mult": [1, 2, 4, 4],
                                          "num_res_blocks": 2}},
                "text_encoder_config": {
                    "target": "dmtpu.models.stablediffusion.FrozenCLIPEmbedder",
                    "params": {"version": "clip-vit-l"}}}},
            "diffusion": {"target": "diffusions.ddpm.DDPM", "params": {
                "total_steps": 1000, "beta_schedule": "quad", "beta_start": 0.00085,
                "beta_end": 0.012, "objective": "pred_eps"}}}
        request = dict(negative="blurry, low quality", n_samples=16, batch_size=16, height=512,
                       width=512, respace_steps=50, guidance_scale=7.5, seed=0, device="cuda")
        request["sd"] = build_model(conf, None, dev)
        seconds = _timed(lambda: sample_images(
            conf, "a photograph of an astronaut riding a horse", **request), repeats)
        out["txt2img_images_per_s"] = [16 / s for s in seconds]
        del request
        torch.cuda.empty_cache()
    if "finetune" in workloads:
        out.update(finetune_ms(tree, repeats))
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", help="checkouts of the repository, each a directory")
    p.add_argument("--workloads", nargs="+", choices=WORKLOADS, default=list(WORKLOADS))
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--one", action="store_true", help="run the one tree given in this process")
    args = p.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    if args.one:
        print(json.dumps(run_one(trees[0], args.workloads, args.repeats)), flush=True)
        return 0
    rc = 0
    for tree in trees + trees[::-1]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                              "--repeats", str(args.repeats), "--workloads", *args.workloads],
                             capture_output=True, text=True, timeout=900)
        lines = run.stdout.strip().splitlines()
        print(lines[-1] if run.returncode == 0 and lines else
              json.dumps({"tree": tree, "rc": run.returncode, "stderr": run.stderr[-2000:]}),
              flush=True)
        rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
