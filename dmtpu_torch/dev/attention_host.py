"""The host's time per attention call through each of the port's paths, and
DDIM-50 on the SD1.5 UNet in a fresh process, on one card.

    python -m dmtpu_torch.dev.attention_host

- Host microseconds of one call at b1 h8 S=64 d=40 bf16 (the host clock
  over 2000 calls, no synchronise between them), twice each in turns:
  ``ops.attention.attention`` without autograd (what the models call when
  sampling: K1's wrapper called directly), the operator
  ``torch.ops.dmtpu.attention`` without autograd, the same operator with
  inputs that need a gradient (what a train step's forward pays), and the
  bare wrapper ``flash_attention_fwd``.
- DDIM-50 at batch 16 on 64x64x4 latents with a 77x768 context through the
  full-width SD1.5 UNet (bf16 torso, its own random initialisation), three
  timed runs after a warm-up, and the host's enqueue time and the wall time
  of ten forwards.

Prints the card's name and power limit first.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

SD15 = dict(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
            attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4), num_heads=8,
            use_spatial_transformer=True, transformer_depth=1, context_dim=768, legacy=False)


def host_us(fn, n: int = 2000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / n


def main() -> None:
    from dmtpu_torch.diffusions import DDIM
    from dmtpu_torch.models.stablediffusion import SDUNetModel
    from dmtpu_torch.ops import _build
    from dmtpu_torch.ops.attention import attention
    from dmtpu_torch.ops.flash_attention import flash_attention_fwd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 64, 8, 40, generator=g, device=dev).bfloat16() for _ in range(3))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def no_grad(fn):
        def call():
            with torch.no_grad():
                fn()
        return call

    paths = {"attention, no autograd": no_grad(lambda: attention(q, k, v)),
             "the operator, no autograd": no_grad(lambda: torch.ops.dmtpu.attention(q, k, v,
                                                                                    None)),
             "the operator, recorded": lambda: torch.ops.dmtpu.attention(*leaves, None),
             "flash_attention_fwd (bare wrapper)": no_grad(lambda: flash_attention_fwd(q, k, v))}
    times: dict = {name: [] for name in paths}
    for _ in range(2):
        for name, fn in paths.items():
            times[name].append(host_us(fn))
    print("host us a call: " + json.dumps(times), flush=True)

    model = SDUNetModel(**SD15, torso_dtype=torch.bfloat16, device=dev).eval()
    x = torch.randn(16, 4, 64, 64, generator=g, device=dev)
    ctx = torch.randn(16, 77, 768, generator=g, device=dev)
    sampler = DDIM(total_steps=1000, respace_type="uniform", respace_steps=50)

    def model_fn(xx, tt, **kw):
        return model(xx, tt, ctx)

    with torch.no_grad():
        sampler.sample(model_fn, x, g)
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sampler.sample(model_fn, x, g)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            print(f"DDIM-50 b16 run {i}: {seconds:.3f} s, {16 / seconds:.3f} samples/s",
                  flush=True)
        t = torch.full((16,), 500, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            model(x, t, ctx)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"b16 forward: host enqueue {1e3 * (t1 - t0) / 10:.2f} ms, wall "
              f"{1e3 * (t2 - t0) / 10:.2f} ms, each of 10", flush=True)


if __name__ == "__main__":
    main()
