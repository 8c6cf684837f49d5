#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root, one card

The port's paths are SD1.5 text-to-latent sampling, SD1.5 training, SD1.5
text to image (prompt -> CLIP-L -> DDIMCFG over the UNet -> VAE decode ->
uint8 images, with img2img and latent inpainting), the same request with the
serving accelerators (DPM-Solver++, PFDiff, DeepCache, ToMe, FreeU) and SD1.5
fine-tuning through its CLIs (``python -m dmtpu_torch.scripts.train_sd``, full and LoRA,
and ``merge_lora``, from ``configs/sd15_finetune.yaml`` and
``configs/sd15_lora.yaml``), DiT-XL/2 (with MDTv2-XL/2) class-conditional
sampling at 256x256 through ``python -m dmtpu_torch.scripts.sample_cfg``'s
request function (phase 11), DiT-XL/2 class-conditional training at
batch 32 through ``python -m dmtpu_torch.scripts.train_ddpm_cfg`` (phase 12),
and MMDiT text to image through ``python -m dmtpu_torch.scripts.sample_mmdit``'s
request function: SD3-medium from ``configs/sd3_medium.yaml`` at 1024x1024
and ``bench.py``'s MMDiT-B/2 (phase 13), and MMDiT rectified-flow training:
``bench.py``'s MMDiT-B/2 at batch 128 and SD3-medium through ``python -m
dmtpu_torch.scripts.train_mmdit`` (phase 14), and SDXL-base text to image at
1024x1024 through the logic of the SDXL page (``dmtpu_torch.ui.sdxl``) and
``bench.py``'s ``sdxl`` extra (phase 15), and pixel-space sampling through
``python -m dmtpu_torch.scripts.sample_uncond`` (ADM-256 and the CIFAR-10
UNet, with DDIM inversion) and the AdaGN UNet through ``sample_cfg`` (phase
16), and pixel-space DDPM training: the CIFAR-10 UNet's train step at the
config's batch of 128, ``python -m dmtpu_torch.scripts.train_ddpm`` (DDPM and
DDPM_IP) and the AdaGN UNet through ``train_ddpm_cfg`` (phase 17), and
guidance and image editing through ``python -m dmtpu_torch.scripts.sample_sdedit``,
``sample_mask_guidance`` (with RePaint), ``sample_ilvr``, ``sample_ddib`` and
``sample_clip_guidance`` on ``configs/ddpm_celebahq.yaml``'s UNet and ADM-256
(phase 18), and that UNet's training through ``python -m
dmtpu_torch.scripts.train_ddpm`` with the T5 text path through ``python -m
dmtpu_torch.scripts.encode_prompts`` (phase 19), and FID / IS / KID evaluation
through ``python -m dmtpu_torch.scripts.accept`` (the CIFAR-10 UNet's DDIM-10
samples through the FID InceptionV3) and ``python -m
dmtpu_torch.scripts.evaluate`` (with CLIP-FID) (phase 20), and the selective
remat policies, LoRA under remat, a learning-rate schedule, the data-parallel
path of the CLIs and the ring attention fold (phase 21), and the UIs: the web
UI's server over the CIFAR-10 UNets and the Stable Diffusion page's logic on
SD1.5 (phase 22); for the SD paths the
full-width SD1.5 UNet (``model_channels`` 320, ``context_dim`` 768, 8 heads,
``channel_mult`` (1, 2, 4, 4)) with f32 parameters, a bf16 torso and f32
GroupNorm / softmax, random weights from a seed, on 64x64x4 latents with a
77x768 context; sampled with DDIM-50, and trained with the DDPM eps-loss
(1000 steps), full remat (``use_checkpoint=True``), adafactor (lr 1e-4),
gradient clipping at 1.0 and a gradual EMA (0.9999) with a bf16 shadow.  Text
to image adds CLIP-L (width 768, 12 layers, 12 heads, vocabulary 49408, 77
tokens) and the SD1.5 VAE (ch 128, ch_mult (1, 2, 4, 4), 2 ResNet blocks a
level, attention in the middle only), both f32, built with the UNet from one
config dict through ``instantiate_from_config`` and driven through the CLI's
pipeline function ``dmtpu_torch.scripts.sample_sd.sample_images`` with the
CLI's demo pseudo-tokens (no tokenizer, no YAML, no image file).

Phases (any failure exits non-zero, and the last line is then not printed):
  1. the card's name and power limit; the kernels built from ``dmtpu_torch/csrc``;
     each instance of K1's wgmma kernel (head dim, keys a K/V tile) and of
     K2's (head dim, one key tile or not) with ptxas's registers and spills
     and its dynamic shared memory: no spills, at most 232,448 bytes;
  2. K1 (attention forward; two kernels, wgmma and mma.sync, behind one
     dispatch, which sends every shape to wgmma) against the plain ``mha`` and against its own plain version,
     bf16, at every attention shape of the path: every kernel that takes the
     shape is checked and timed (order first, second, second, first), the row
     names the one the dispatch chose, and that one must not be the slower.
     Beside ``ms`` and ``plain_ms`` each row has ``bound_ms`` (the least time
     the card could take, ``dmtpu_torch/ops/roofline.py``) and what bounds it,
     ``library_ms`` (``F.scaled_dot_product_attention`` on [B, H, S, D] views
     of the same tensors, default backend, timed as a yardstick and used
     nowhere in the port), ``host_us`` (host clock over 200 calls of the
     wrapper with no synchronise, per call), ``host_bound`` (``ms`` within
     20% of ``host_us``) and ``host_ms_by_kernel`` (the host's time per call
     in each timed loop: where the chosen kernel's best time is within 20%
     of its own loop's, the card waited for the host's launches there, and
     the row says nothing about the kernels); all of it at batch 16 (what
     DDIM-50 and training give K1) and again at batch 32 (the CFG-doubled
     batch of a 16-image text-to-image request), the plain versions there in slices of 16; and
     at b32 at the 64x64 level's self-attention under ToMe (S 2048 at ratio
     0.5, 2868 at 0.3, off the 128 grid), with K1's time over SDPA's there
     and at S=4096; and at the pixel UNets' one head of 256
     (``K1_D256_ROWS``: the CIFAR UNet's b500 h1 S=256 and S=16, the AdaGN
     UNet's middle attention at b20), summed over one call of each;
  3. K3 (GroupNorm+SiLU) against its plain version at every GroupNorm shape
     of the path, bf16 and f32, SiLU on and off, eps 1e-5 and 1e-6,
     channels-last (both kernels, "rows" and the per-group one, as in 2) and
     NCHW; two runs must agree bit for bit; the same columns, ``library_ms``
     being ``F.group_norm`` (weight and bias cast to x's dtype in the call, as
     a caller with f32 parameters has to) followed by ``F.silu``; then the
     UNet's 19 on-path calls again on 32 samples (the CFG-doubled batch, where
     the launch plan spreads a sample over fewer CTAs); then the same at the eight GroupNorm shapes of the VAE at 512x512 (up to [16, 256,
     512, 512], 4 GiB): f32, eps 1e-6, SiLU on and off, contiguous NCHW (what
     the VAE gives K3) and channels-last (off the path: there a slower
     dispatch is noted, not failed), summed over one decode and one encode;
     and the decoder's seven shapes at 256x256 on 32 samples (DiT's decode,
     NCHW) and at 1024x1024 on 2 samples (SD3-medium's), each summed over
     one decode;
  4. one UNet forward through the kernels and one through the plain ops, each
     measured against an f32 plain run (TF32 off): the kernel path must come
     within 1.5x the plain path's error, plus 1e-3; then the batch-16 UNet
     forward time through the kernels and through the plain ops (CUDA events,
     order plain, kernels, kernels, plain) and a ``torch.profiler`` breakdown
     of the kernel path's device time by class of kernel;
  5. requests: DDIM-50 at batch 16 (one warm-up, one timed run, with the
     launch counts of the timed run) and DDIMCFG s=7.5 at batch 2: its guided
     noise prediction at the first step and its sample after a few steps,
     each held against the f32 plain path within 1.5x the plain bf16 path's
     error;
  6. K2 (attention backward; two kernels, wgmma and mma.sync, behind one
     dispatch, which sends every shape of the path to wgmma: d=40 and d=80 on
     their own instances, d=160 on its column-split instance) at every
     attention shape of the path, b16 bf16: as in 2, every
     kernel that takes the shape is checked (dq, dk and dv against K2's plain
     version and against f32 autograd through ``mha``) and timed, the row
     names the one the dispatch chose, and that one must not be the slower;
     where one CTA holds all of a dq row's sum (one key tile, wgmma) two runs
     must agree bit for bit; the columns of 2 (``library_ms``: forward and
     backward of one SDPA call, less its forward alone);
  7. training: (a) at batch 2, one fixed batch, t and eps: the loss and the
     gradient through the kernels against an f32 plain run (TF32 off), within
     1.5x the plain bf16 path's relative error plus 1e-3; (b) the launches
     of K1, K2 and K3 per step, derived from the module tree and checked
     exactly, K2's also by kernel as its dispatch predicts; (c) at batch 16:
     one warm-up step, then 10 timed steps (images per second, ms per step,
     peak memory) and a ``torch.profiler`` breakdown of one step; (d) 10 steps on one fixed batch 2: the kernel
     path's loss is finite and falls, and stays within 1e-3 of the plain
     bf16 path's loss at the same weights at every step;
  8. text to image, f32 with TF32 off but in (c): (a) at batch 2: CLIP-L on the
     card within 1e-4 relative L2 of the same module on the CPU (f32 on both
     sides, other summation order); the VAE's decode and encode through K3
     within 1e-3 relative L2 of the same through the plain GroupNorm (f32 on
     both sides; K3 rounds otherwise at each of 30 and 22 norms), K3 launched
     at every GroupNorm and given contiguous NCHW; a prompt -> 5-step DDIMCFG
     (s = 7.5) -> 512x512 uint8 images through the kernels and through the
     plain ops, each against an f32 plain run: the kernel path within 1.5x
     the plain bf16 path's relative L2 error, plus 1e-3; (b) the launches of
     K1 and K3 in every request here, derived from the module trees (32 and
     61 a UNet call, 30 a decode, 22 an encode) and checked exactly, K2 0;
     (c) the timed request: prompt and negative prompt -> DDIMCFG-50 at batch
     16, 512x512, one warm-up and one timed run (images per second, the
     stages' times by CUDA events, peak memory), with TF32 in the VAE's f32
     convolutions as cuDNN runs them by PyTorch's default, which the CLI
     leaves alone; then the VAE decode alone with and without TF32 and a
     ``torch.profiler`` breakdown of it; (d) img2img (strength 0.75) and
     inpainting at batch 2 over a few steps: right shape, varied, exact
     launches, and with a fully known mask the images are the decode of the
     known latent (to one step of 255: the latent comes back to one f32
     rounding);
  9. the fine-tuning CLI: (a) at batch 2, 512x512, the CLI's own loss
     (``make_sd_loss_fn``: latent encode, caption drop, text encode,
     eps-loss) on the stack of ``configs/sd15_finetune.yaml`` at fixed draws
     (posterior noise, drop mask, t, eps from one step's generator): its loss
     and UNet gradient through the kernels against an f32 plain run (TF32
     off), within 1.5x the plain bf16 path's relative error plus 1e-3, and no
     VAE or CLIP parameter with a gradient; (b) the launches of K1, K2 and K3
     per step derived from the module trees (32, 32, 61 + 22 for the
     encoder: no remat in the config), a preview row and a decode, checked
     exactly in (a) and in every CLI run below; then a step of each mode
     (the CLI's loss, and the optimizer and EMA of each config) on one fixed
     batch of 8 without the loader, timed (3 steps, host clock) and profiled
     (device time by class, annotated ranges, the card's idle share of the
     wall time under the profiler); (c) ``train_sd.main`` in this
     process, full fine-tune at batch 8 on 16 seeded-noise 512x512 PNGs with
     sidecar captions and a character-level CLIPTokenizer that the phase
     writes into a temporary directory (``CaptionedImageDir``, 4 loader
     workers): 3 steps with one save (5.2 GB) and an EMA preview (DDIMCFG,
     10 steps): finite losses, the checkpoint, the preview, the bf16 EMA's
     count; ms per step and images per second (host clock between the
     loop's steps, from the run's second step on: the loop reads each
     step's loss, so it waits for the card), peak memory, the checkpoint's
     size and its save seconds; (d) LoRA (``configs/sd15_lora.yaml``, rank
     16) for 2 steps, then ``-r latest`` to 3: adapters-only checkpoints,
     the resume and the EMA's count, a bit-identical base UNet, the
     adapters moved; then ``merge_lora.main`` on its last checkpoint and the
     same-seed base, whose
     merged UNet's b2 forward (loaded through ``load_weights``) agrees with
     the base run with the EMA adapters within 1e-3 relative L2 (plain
     path).  Both CLIs run with this script's non-zero random init in place
     of ``init_params`` (same seed, same draws), so that every layer gets a
     gradient; the temporary directory is removed;
 10. the serving accelerators through ``sample_images`` on phase 8's stack,
     as the JAX package's bench extras on the SD path (``SERVE_CONFIGS``):
     DPM-Solver++ 20 steps, PFDiff on the 50-step grid (26 UNet calls),
     DDIM-50 and PFDiff-50 with DeepCache (2, 3), DDIM-50 with ToMe 0.5,
     DDIM-50 with FreeU sd15, and the stack (ToMe, FreeU, PFDiff, DeepCache):
     (a) each at b2 over 5 steps through the kernels and through the plain
     ops against an f32 plain run (TF32 off): within 1.5x the plain bf16
     path's relative L2 error, plus 1e-3, with exact launches; DeepCache at
     interval 1 gives the plain DDIM and PFDiff requests' images within 1e-5;
     (b) each at b16, 512x512, one warm-up and one timed request: images per
     second, the stages' times, peak memory, and the launches of K1 and K3
     checked exactly against the UNet calls by kind (32 and 61 a full call,
     10 and 16 a shallow one, read off the module tree) plus 30 K3 a decode,
     K2 none; (c) a ``torch.profiler`` breakdown of one UNet call on 32
     samples: full, shallow, with ToMe 0.5 and with FreeU sd15;
 11. DiT-XL/2 (depth 28, hidden 1152, 16 heads of 72, patch 2, 32x32x4
     latents, bf16 torso, f32 parameters) with the SD VAE (f32) as
     ``DIT_CONF``, built through the registry, seeded non-zero weights (the
     adaLN-Zero modulations and the final layer too), driven through
     ``sample_cfg``'s ``make_diffuser`` and ``sample_class``: (a) at b2 a
     forward and a 5-step DDIMCFG request (s = 4, class 207) to 256x256
     images through the kernels and through the plain ops, each against an
     f32 plain run (TF32 off): within 1.5x the plain bf16 path's relative L2
     error, plus 1e-3, with exact launches (28 K1 a forward, 30 K3 a decode);
     (b) K1 at the request's shape, b64 h16 S=256 d=72 with q, k and v
     strided views of one projection: both kernels against the plain
     versions, timed as in 2 beside the bound, SDPA's time and the host's;
     (c) the timed request: b32, class 207, DDIMCFG-50, s = 4 (one warm-up,
     one timed: images per second, the stages' times by CUDA events, peak
     memory, launches exactly 1400 K1 through wgmma, 30 K3, no K2), the
     forward on 64 samples timed and profiled by class, and the decode
     profiled; (d) MDTv2-XL/2 (the class's defaults) on a b8 DDIMCFG-10
     request: finite images, launches K1 0 (its relative-position attention
     is plain PyTorch), K3 30;
 12. DiT-XL/2 class-conditional training (``DIT_TRAIN``: ``bench.py``'s
     ``dit_train``, bf16 torso, no remat, ``learn_sigma=False``): (a) K2 at
     b32 h16 S=256 d=72 on strided q/k/v views of one projection, from K1's
     outputs and a random dO: both kernels against the plain version and
     f32 autograd through ``mha`` (phase 6's tolerances), timed as in 6
     beside the bound, SDPA's backward and the host's time; the dispatch's
     wgmma must not be the slower; (b) at b2 the loss, the gradient and its
     norm through the kernels and through the plain ops, each against an
     f32 plain run (TF32 off): within 1.5x the plain bf16 path's relative
     error, plus 1e-3; exactly 28 K1 and 28 K2 launches a step, all wgmma;
     (c) b32, adafactor 1e-4, clip 1.0, no EMA: a warm-up, 10 timed steps
     (images per second, ms per step, peak memory, launches exactly 10 x
     (28, 28, 0), all wgmma), one profiled step (device time by class,
     annotated ranges, the card's idle share); (d) ``train_ddpm_cfg.main``
     in this process from a config the phase writes into a temporary
     directory (DiT-XL/2, ``Synthetic`` 32x32x4 latents of 1000 classes,
     batch 32, a bf16 EMA, ``p_uncond`` 0.1): 4 steps with a save at step 2
     and an eval grid at step 3, then ``-r latest`` to 6: checkpoints, grids
     (RGBA latents), the resumed step and EMA count, finite losses, exact
     launches (training and the grid's 50-step DDPMCFG), ms per step,
     checkpoint seconds and bytes; the directory is removed; (e) MDTv2-XL/2
     at b8: one unmasked train step and a masked (``mask_ratio`` 0.3)
     forward and backward, finite gradients everywhere, times, no kernel;
 13. MMDiT text to image through ``sample_mmdit``'s request function
     (``sample_mmdit.sample_mmdit``; the CLI's ``conditioning``,
     ``build_model``, ``build_decoder`` and ``make_diffuser``): (a) K1 at
     head dim 64 at the joint attention of one CFG-doubled call, q, k and v
     made by ``torch.cat`` of the two streams, S = 4250 over 24 heads at b4
     (SD3-medium) and S = 333 over 12 heads at b64 (MMDiT-B/2), both with a
     masked last key tile: both kernels against the plain versions, timed as
     in 2 beside the bound, SDPA's time and the host's, wgmma chosen and not
     the slower; (b) SD3-medium from ``configs/sd3_medium.yaml`` with
     ``model.params.dtype=bfloat16`` (MMDiT-L/2: hidden 1536, depth 24, 24
     heads of 64, 128x128x16 latents, 154 x 4096 context, pooled 2048; the
     16-channel VAE, f32), seeded non-zero weights, the CLI's demo
     pseudo-embeddings of a prompt: a forward on the CFG-doubled b2 batch and
     a 2-step request to 1024x1024 images through the kernels and through
     the plain ops, each against an f32 plain run (TF32 off): within 1.5x the
     plain bf16 path's relative L2 error, plus 1e-3, launches exact (24 K1 a
     forward, 30 K3 a decode); (c) the timed request: b2, FlowMatchingCFG
     Euler-28, time shift 3, s = 4, 1024x1024 (one warm-up, one timed: images
     per second, the stages by CUDA events, peak memory beside the
     parameters' bytes, launches exactly 672 K1 through wgmma, 30 K3, no K2),
     one MMDiT-L/2 call on 4 samples timed and profiled by class, the decode
     profiled; (d) ``bench.py``'s ``mmdit_sample``: MMDiT-B/2 (qk_norm), b32,
     FlowDPMSolverCFG-20, s = 4, 32x32x4 latents, 77 x 4096 random context,
     no VAE: samples per second, launches exactly 240 K1 through wgmma, one
     call on 64 samples timed and profiled by class;
 14. MMDiT rectified-flow training (``MMDIT_TRAIN_*``, ``SD3_TRAIN_*``): (a)
     K1 and K2 at head dim 64 at the joint attention of the two train steps,
     q, k and v made by ``torch.cat`` of the two streams, S = 333 over 12
     heads at b128 (MMDiT-B/2) and S = 4250 over 24 heads at b32
     (SD3-medium; the plain versions there in slices of 2 samples): every
     kernel against the plain versions (and K2 against f32 autograd through
     ``mha``), timed as in 2 and 6 beside the bound, SDPA's time (K2: its
     backward) and the host's, wgmma chosen and not the slower; (b) at b2
     on ``bench.py``'s MMDiT-B/2 (bf16 torso, QK norm) with f32 and with
     bf16 parameter storage: the loss, the gradient and its norm through the
     kernels and through the plain ops, each against an f32 plain run (TF32
     off) holding the same weights: within 1.5x the plain bf16 path's
     relative error, plus 1e-3; exactly 12 K1 and 12 K2 a step, all wgmma;
     (c) ``bench.py``'s ``mmdit_train``: b128, no remat, adafactor 1e-4,
     clip 1.0, no EMA, ``train_mmdit``'s loss with MMDiT's conditioning
     dropout: a warm-up, 10 timed steps (images per second, ms per step,
     peak memory, launches exactly 10 x (12, 12, 0), all wgmma), one profiled
     step (device time by class, annotated ranges, the card's idle share)
     and the MFU against 989 TFLOP/s from the forward's operations counted
     on its shapes (``forward_flops``) times three; (d) ``train_mmdit.main``
     in this process on ``configs/sd3_medium.yaml`` with
     ``SD3_TRAIN_OVERRIDES`` (MMDiT-L/2 computing and stored in bf16, remat,
     12 of its 24 blocks, the config's batch of 32, adafactor 5e-5 and bf16
     EMA 0.9999, ``SyntheticEmbedded`` cut to 64 items, no eval grid): 2
     steps and ``-r latest`` to 3: ms per step, peak memory, checkpoint
     seconds and bytes, finite losses, bf16 storage and EMA, launches
     exactly (24, 12, 0) a step, all wgmma, and one more step of the loop
     profiled (idle share);
     (e) ``sample_cfg --sampler flow``: ``make_diffuser`` and
     ``sample_class`` on phase 11's DiT-XL/2 with ``learn_sigma`` off and the
     SD VAE, b4, FlowMatchingCFG-4: finite images, launches 4 x 28 K1 and 30
     K3;
 15. SDXL-base text to image (``SDXL_CONF``: the sd_xl_base config through
     the reference targets ``models.sdxl.*``; the UNet of
     ``benchmarks/northstar.py:94-119`` with ``softmax-xformers`` and no
     remat, 2.57B parameters, bf16 torso; the conditioner at CLIP-L and bigG
     widths; the SD VAE; all f32 parameters, built on the card from a seed):
     (a) K1 at head dim 64 at the four attention shapes of a UNet call on
     the CFG-doubled b2 batch: self-attention h10 S=4096 and h20 S=1024
     and cross-attention to 77 keys from S=4096 and S=1024 (all wgmma, the
     77-key rows on its short-key tile),
     checked and timed as in 2 beside the bound, SDPA's time and the host's;
     (b) K3 at the UNet's 15 GroupNorm shapes on b2 (channels-last, bf16,
     and the f32 output norm) and at the VAE decoder's 7 at 1024x1024 on b1
     (f32, NCHW), as in 3; (c) the module tree against the tables: 70
     transformer blocks (140 attention calls) and 46 GroupNorms a UNet call,
     30 a decode; (d) the conditioner's crossattn [1, 77, 2048] and vector
     [1, 2816] within 1e-4 relative L2 of the same towers on the CPU (TF32
     off), the empty negative's text zeroed; (e) a b2 UNet forward with
     ``y`` at 128x128x4 through the kernels and through the plain ops
     against an f32 plain run (TF32 off): within 1.5x the plain bf16 path's
     relative L2 error, plus 1e-3, launches exactly (140, 0, 46); (f) the
     timed request through ``generate_sdxl``: b1, DDIMCFG-50, s = 5,
     1024x1024, seeded token ids, empty negative (one warm-up, one timed:
     images per second, the stages by CUDA events, peak memory, launches
     exactly 50 x 140 K1 (all wgmma), no K2, 50 x 46 + 30
     K3), one UNet call on 2 samples timed and profiled, the decode
     profiled; (g) ``bench.py``'s ``sdxl``: unguided DDIM-50 at b1 with a
     random context and a zero vector: samples per second, launches exactly
     (50 x 140, 0, 50 x 46), and the MFU against 989 TFLOP/s from the
     forward's operations counted on its shapes (``forward_flops``);
 16. pixel-space sampling through ``python -m dmtpu_torch.scripts.sample_uncond``
     (``sample_fold``, ``build_diffuser`` and ``main``) and ``sample_cfg``:
     (a) a gradient through a head of 512: one K1 and one K2 launch (their
     d=512 instances), dq, dk and dv within 2e-2 of f32 autograd through
     ``mha`` on the same bf16 values (phase 6's rule); (b)
     ADM-256 (``ADM256_CONF``:
     guided-diffusion's ``256x256_diffusion_uncond`` flags through the
     registry, 552.8M parameters, bf16 torso, learned sigma): a b2 forward
     through the kernels and through the plain ops against an f32 plain run
     (TF32 off), within 1.5x the plain bf16 path's relative L2 error plus
     1e-3, with the launches and the calls by shape read off the run; K1
     (d=64) and K3 at each of those shapes at b16, checked and timed as in 2
     and 3 beside the bound, the library call and the host's time (the plan's
     choice not the slower); the timed b16 DDIM-50 request at 256x256
     (images per second, peak memory, launches exactly 50 x a call's, K1 by
     kernel), one call timed and profiled by class with the card's idle
     share; (c) ``configs/ddpm_cifar10.yaml``'s UNet (35.7M, bf16 torso): the
     b2 agreement, K1 at d=256 (b500 h1 S=256 and S=16, and a ragged S=200)
     and K3 at its shapes at b500, the timed DDIM-50 and Heun-25 requests at
     the CLI's batch of 500 (every K1 launch at d=256), one call profiled,
     and ``sample_uncond --mode reconstruction`` in this process on
     ``RECON_IMAGES`` PNGs it writes into a temporary ``ImageDir`` (DDIM
     inversion, then DDIM-50; launches exactly 99 calls' worth); (d)
     ``configs/ddpm_cfg_cifar10.yaml``'s UNetCategorialAdaGN (bf16 torso, the
     null class its table's zero last row): the b2 agreement with labels, K1
     and K3 at its shapes on the CFG-doubled b20, and ``sample_cfg.main`` in this
     process, DDIMCFG-50, ``CFG_EACH`` images of each of the 10 classes
     (launches exactly, one d=256 call a step); the directory is removed;
 17. pixel-space DDPM training (``configs/ddpm_cifar10.yaml``'s UNet with
     ``PIXEL_OVERRIDES``: 35.7M, dropout 0.1, bf16 torso, one head of 256):
     (a) K2 at head dim 256 (its wgmma column-split instance; the mma.sync
     instance checked and timed beside it) at the UNet's shapes at the
     config's batch, b128 h1 S=256 and S=16, at a ragged b8 S=200 and a
     padded d=248, from K1's outputs and a random dO: against the plain
     version and f32 autograd through ``mha`` (phase 6's tolerances), timed
     as in 6 beside the bound, SDPA's backward and the host's time; (b) at
     b2, dropout off, the loss, the gradient and its norm through the
     kernels and through the plain ops, each against an f32 plain run (TF32
     off): within 1.5x the plain bf16 path's relative error, plus 1e-3; the
     attention calls read off the run (5 at S=256, 1 at S=16) and exactly 6
     K1, 6 K2 and 51 K3 a step, every K1 and K2 at d=256; (c) the config's
     train step at b128 (Adam 2e-4, clip 1.0, EMA 0.9999, dropout from the
     step's stream): a warm-up, 10 timed steps (images per second, ms per
     step, peak memory, launches exactly 10 x (6, 6, 51), K2 all wgmma),
     one profiled step (device time by class, annotated ranges such as
     ``Optimizer.step`` and ``EMAState.update``, the card's idle share); (d)
     ``train_ddpm.main`` in this process on ``configs/ddpm_cifar10.yaml``
     with ``Synthetic`` 32x32x3 data in place of CIFAR-10
     (``SYNTHETIC_DATA``): 3 steps with a save and a 16-image grid (the
     config's DDPM respaced to 100 steps), then ``-r latest`` to 5:
     checkpoints, the grid, the resumed step and EMA count, checkpoint bytes,
     save and load seconds, launches exactly; then a
     ``diffusion.target=diffusions.ddpm_ip.DDPM_IP`` run of 2 steps; (e)
     ``train_ddpm_cfg.main`` on ``configs/ddpm_cfg_cifar10.yaml``'s
     UNetCategorialAdaGN at b128 for 3 steps: launches exactly, K2 at d=64
     (10 a step) and at d=256 (1) all through wgmma; the
     directory is removed; (f) K2 at the AdaGN UNet's attention shapes (read
     off a forward on the meta device) at its config's batch of 128, as in
     (a);
 18. guidance and image editing on the pixel models, through the CLIs
     ``sample_sdedit``, ``sample_mask_guidance``, ``sample_clip_guidance``
     (``main`` in this process) and the request functions of ``sample_ilvr``
     and ``sample_ddib``, on ``EDIT_IMAGES`` seeded smooth 256x256 PNGs in a
     temporary ``ImageDir``: (a) K1 at head dim 512 (its wgmma instance, the
     mma.sync instance in ``csrc/flash_attn_fwd_mma_d512.cu`` checked and
     timed beside it) at b16 h1 S=256 and S=64 (CelebA-HQ's shapes), a ragged
     b4 S=200, a padded d=504 and b128 S=256, checked and timed as in 2
     beside the bound, SDPA (its backend named) and the host's time; (b)
     ``configs/ddpm_celebahq.yaml``'s UNet (113.7M, bf16 torso, one head of
     512): the b2 agreement as in 16, 5 attention calls at S=256 and 1 at
     S=64 a call, K3 at its 71 GroupNorms' shapes at b16 as in 3, the timed
     b16 DDIM-50 request at
     256x256 (images per second, peak, launches exactly 50 x a call's, every
     K1 at d=512 through wgmma), one call timed and profiled; (c) ``sample_sdedit.main``:
     DDPM respaced to 100, ``--edit_steps 50``, exactly 50 UNet calls; (d)
     ``sample_mask_guidance.main`` (center masks, DDPM-50), then
     ``inpaint_batch`` with and without RePaint (DDPM-25, r 2, j 5): the known
     region equals the input within 1e-6, launches exactly; (g) CLIP guidance
     (ViT-B/32 widths, seeded weights, a character-level tokenizer the phase
     writes; DDPM-50, weight 100): ``main``, one ``cond_fn_mean`` on the card
     against the CPU in f32 (1e-4), a guided and an unguided b8 request from
     the same noise (the output moves; CLIP's share of a step); (e) ILVR on
     ADM-256 at b8 (DDPM-100, factor 8, cubic): the card's low-pass against
     float64 numpy (1e-5), ``|phi(out) - phi(ref)| / |phi(ref)|`` against an
     unguided sample's; (f) DDIB on the class-conditional ADM-256 (1000
     classes): the b2 agreement over 5 + 5 DDIM steps, then DDIM-50
     inversion under one class and sampling under another at b8 (99 UNet
     calls, launches exactly); the directory is removed;
 19. CelebA-HQ DDPM training and the T5 text path: (a) K2 at head dim 512
     (its mma.sync instance in ``csrc/flash_attn_bwd_mma_d512.cu``; ptxas'
     registers and spills and its shared memory printed) at b16 h1 S=256
     and S=64 (CelebA-HQ's shapes), a ragged b4 S=200 and a padded d=504,
     from K1's outputs and a random dO: against the plain version and f32
     autograd through ``mha`` (phase 6's tolerances), timed as in 6 beside
     the bound, SDPA's backward (its backend named) and the host's time;
     (b) ``configs/ddpm_celebahq.yaml``'s UNet (113.7M, bf16 torso, one head
     of 512) at b2: the loss, the gradient and its norm through the kernels
     and through the plain ops against an f32 plain run (TF32 off), within
     1.5x the plain bf16 path's relative error plus 1e-3, the attention
     calls read off the run and exactly 6 K1, 6 K2 (all at d=512) and 71 K3
     a step; the config's train step at b16 256x256 (Adam 2e-5, clip 1.0,
     gradual EMA 0.9999): a warm-up, 10 timed steps (images per second, ms
     per step, peak, launches exactly 10 x (6, 6, 71), K1 all wgmma, K2 all
     mma.sync), one
     profiled step (device time by class, the card's idle share); then
     ``train_ddpm.main`` in this process on that config with ``Synthetic``
     256x256x3 data (``CELEBAHQ_CLI``): 2 steps with a save and a 4-image
     grid, then ``-r latest`` to 3, launches exactly; (c) a T5 encoder of
     ``google/t5-v1_1-xxl``'s published shape (``T5_XXL``: 4.76B
     parameters) built on the card with seeded random weights, beside CLIP-L
     and OpenCLIP bigG at full width (f32), through ``encode_real`` at b4:
     context [4, 154, 4096] and pooled [4, 2048], finite, timed, the T5 in
     bf16 within 5e-2 relative L2 of its f32 run; (d) ``encode_prompts.main``
     in this process: real mode from tower files the phase writes (the CLIP
     towers as torch files with their configs), once with ``--no_t5`` and
     once with ``--t5_dir`` (a T5 of XXL widths at 2 of its 24 layers, saved
     with a character-level tokenizer), and demo mode, whose rows are
     ``sample_mmdit --prompt``'s byte for byte; the directories are removed.
 20. FID / IS / KID (``EVAL_*``), in a temporary directory of files the
     phase writes (a pt_inception-layout ``.pth`` of a seeded full-width
     ``FIDInceptionV3``, five seeded ``data_batch`` pickles of 500 images, a
     seeded checkpoint of ``configs/ddpm_cifar10.yaml``'s UNet): (a)
     ``accept.main`` in this process: ``--self_test`` exits 0, a run without
     artifacts exits 2 naming all three, then row ``ddim_10`` at 2500 samples
     a side, b500, features at b250, a bf16 torso: exit 1 (random weights
     miss the published row), finite FID > 0, IS >= 1, a FAIL row, exactly
     300 K1 (all d=256), 2550 K3 and 0 K2; the sampling, feature and host
     ``sqrtm`` seconds; (b) the Inception forward on the card (TF32 off)
     within 1e-4 relative L2 of the CPU's on 16 of the samples, the same
     with TF32 on, and the FID that TF32 would give on accept's sets; its
     b250 299x299 images/s in f32 and TF32; (c) ``evaluate.main`` on PNG
     directories of 256 images a side with KID and CLIP-FID (a CLIP of
     ViT-B/32's widths, seeded): finite, and FID / IS / KID within 1e-4 of
     the same images through the CPU extractor; the phase within 150 s.
 21. selective remat and the parallelism layer (``REMAT_*``, ``RING_*``):
     (a) the SD1.5 UNet (bf16 torso, seeded weights) at b4, one forward and
     backward under each ``use_checkpoint`` of ``REMAT_POLICIES``: the
     gradient within twice the run-to-run noise of two runs without remat
     plus 1e-3 (relative L2), the peak memory ordered as the policies keep
     (``nothing`` <= ``attn`` <= ``dots_no_batch`` <= ``dots`` <=
     ``everything`` ~ no remat, with 5% and 256 MiB of slack), the step's ms
     (3 steps a run, the policies in turn and then in reverse order), and
     K1 / K2 / K3 launches exactly as the module tree gives them: under
     ``"attn"`` 32 K1 a step, where full remat launches 64; then the step's
     time and peak under no remat, full remat, ``attn`` and ``dots`` at the
     SD1.5 configs' batch of 8 and at 16; (b) LoRA with the
     UNet's ``use_checkpoint`` on ``configs/sd15_lora.yaml``'s stack at b2
     512x512: the adapters' gradients against the run without remat (the
     same bound), launches exact; then ``train_sd.main`` with
     ``use_checkpoint=true`` for 2 steps, launches exact; (c)
     ``train_ddpm.main`` on ``configs/ddpm_cifar10.yaml`` (synthetic data)
     for 3 steps under a ``warmup_cosine_decay_schedule`` given as a config:
     the logged lr is the schedule's at each update; (d) the same run with
     ``torchrun``'s variables set for one rank, so the CLI starts a NCCL
     group of one and goes through the data-parallel path: the first loss
     exactly the run's without a group, the parameters within 1e-3 relative
     L2 after 3 steps (K2's dQ sums vary between runs), the same launches;
     and one ``sample_uncond`` request through ``DataParallelSampler`` in
     that group, its PNGs those of the run without one (to one level); (e)
     the ring attention of 4 ranks on one card (``parallel/sp.py``:
     ``fold_attention`` and ``fold_attention_backward`` run the ring's own
     hop functions, ``ring_forward`` and ``ring_backward``, with all 4 ranks
     held on the card, dK / dV summed in f32 as they travel) at SD1.5's
     S=4096 h8 d=40 and S=1024 h8 d=80 at b16 (K1 / K2 wgmma) and the CIFAR
     UNet's S=256 h1 d=256 at b128 (K1 and K2 wgmma): 16 K1 and 16 K2
     launches, all through wgmma, O,
     dQ, dK and dV within 2e-2 of the largest entry of K1 / K2 on the whole
     sequence, and against f32 autograd through ``mha`` on the first sample
     within 1.5x the whole sequence's error plus 1e-3; the fold's and the
     whole sequence's times;
 22. the UIs: (a) the web UI (``dmtpu_torch.webui.app``: ``App`` and
     ``make_handler``) served in a thread on 127.0.0.1 at a free port over
     ``configs/ddpm_cifar10.yaml`` and ``configs/ddpm_cfg_cifar10.yaml`` at
     full width with a bf16 torso, seeded random weights in a temporary
     torch file: ``/health`` names the card; one warm-up, then the timed
     ``/sample?sampler=ddim&steps=50&n=16&seed=0`` (the AdaGN UNet's with
     ``&y=3&gs=3``): exact K1 / K3 launches (per UNet call 6 / 51, the AdaGN
     UNet's 11 / 68 on the doubled batch), a PNG grid of 16 32x32 samples
     that is the direct ``App.sample`` call's grid to one level; the
     request's time over HTTP beside the direct call's and the PNG
     encoding's, the card's idle share of a request under the profiler; the
     request's images through the kernels and through the plain ops against
     the same request on the f32 model (TF32 off): the kernel path within
     1.5x the plain bf16 path's error plus 1e-3; (b) page 3's logic
     (``dmtpu_torch.ui.sd.generate_sd``) on phase 8's SD1.5 stack (kept on
     the host from phase 10 on): b1 512x512 DDIM-20 at s = 7.5, ToMe 0.5,
     FreeU at SD1.5's scales, offset noise 0.1: exact launches (32 K1 and 61
     K3 a UNet call on 2 samples, 30 K3 a decode), the time and idle share,
     the images through the kernels and the plain ops against the f32 UNet's
     as in (a).

Before the last line it prints one JSON object with each kernel's launches in
the timed main-path runs (K1 and K3 in DDIM-50, K2 in the 10 train steps,
and all three counted in each of the three timed runs and in the first run
of each fine-tuning CLI and serving request), error, and its times, bound,
library time and host time summed over the calls of one forward (K2: of one
train step; K1's and K3's also over one UNet call on 32 samples, ``cfg_b32``;
K1's also over the merged self-attentions of one under ToMe, ``tome_b32``,
and over the 28 of one DiT-XL/2 call on 64 samples, ``dit_b64``, and over
the joint attentions of one CFG-doubled MMDiT call, ``sd3_medium_b4`` and
``mmdit_b2_b64``; K3's also over one VAE decode and one encode,
over one b32 decode at 256x256, ``dit_vae_decode_b32``, and one b2 decode at
1024x1024, ``sd3_vae_decode_b2``; K2's also over the 28 of one DiT-XL/2 b32
train step, ``dit_train_b32``; K1's and K2's also over the joint attentions
of one MMDiT train step, ``mmdit_train_b128`` and ``sd3_train_b32``; K1's
also over the 140 of one SDXL UNet call on 2 samples, ``sdxl_b2``; K3's also
over the 46 of that call, ``sdxl_unet_b2``, and the 30 of one b1 decode at
1024x1024, ``sdxl_vae_decode_b1``; K1's and K3's also over one ADM-256 call
at b16, ``adm256_b16``, and one CIFAR UNet call at b500, ``cifar_b500``, and
K1's over one AdaGN UNet call on the CFG-doubled b20, ``adagn_b20``; K2's
also over the 6 of one CIFAR UNet b128 train step, ``cifar_train_b128``), a
fourth entry for K1 at head dim 256, the wgmma kernel's d=256 instance (its
launches in the CIFAR UNet's DDIM-50 request and their split by kernel, its
columns over the 6 calls of one call there, and phase 2's sums over one
CIFAR and one AdaGN call, ``phase2``), a fifth for K2's wgmma column-split
instance at head dim 256 (its launches in the 10 timed b128 train steps, its
columns over the 6 calls of one step, and the mma.sync instance's beside
them, ``mma_sync``), a sixth for K1's wgmma instance at head dim 512 (its
launches in the CelebA-HQ UNet's DDIM-50 request at b16, its columns over
the 6 calls of one call there, the mma.sync instance's beside them; K1's
first entry also sums one such call, ``celebahq_b16``), a seventh for K2's
mma.sync instance at head dim 512 (its launches in the 10
timed b16 CelebA-HQ train steps, its columns over the 6 calls of one step
there; K2's first entry also sums one such step, ``celebahq_train_b16``; the
launches of all three in phase 20's ``accept`` run, ``eval_accept_ddim_10_n2500``, and
in phase 22's three UI requests, ``ui_*``), an eighth for K2's wgmma
column-split instance at head dim 160 (its launches in the 10 timed b16 SD1.5
train steps, its columns over the 12 calls of one step, phase 6's rows, and
the mma.sync instance's beside them), the seconds of each phase, and the card's name and power limit.  The last line is
``{"ok": true, "device": {...}}``.  It needs no network and leaves no
process behind.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

B = 16                      # the headline batch
STEPS = 50                  # DDIM-50 over 1000 training steps, uniform respacing
CFG_BATCH, CFG_STEPS, CFG_SCALE = 2, 5, 7.5
UNET_CHECK_BATCH = 2
UNET_TIMED_FORWARDS, UNET_PROFILED_FORWARDS = 10, 3
TRAIN_CHECK_BATCH, TRAIN_TIMED_STEPS, LEARN_STEPS = 2, 10, 10
TRAIN_LR, TRAIN_CLIP, EMA_DECAY = 1e-4, 1.0, 0.9999
SEED = 0

SD15 = dict(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
            attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4), num_heads=8,
            use_spatial_transformer=True, transformer_depth=1, context_dim=768, legacy=False)

# One SD1.5 UNet forward, read off the module tree (16 SpatialTransformers,
# each a self- and a cross-attention; heads 8).  (S_q, S_k, d): calls.
ATTN_CALLS = {
    (4096, 4096, 40): 5, (1024, 1024, 80): 5, (256, 256, 160): 5, (64, 64, 160): 1,
    (4096, 77, 40): 5, (1024, 77, 80): 5, (256, 77, 160): 5, (64, 77, 160): 1,
}
# (C, H*W, dtype, silu, eps): calls.  22 ResBlocks x 2 (bf16, SiLU, 1e-5),
# 16 SpatialTransformer norms (bf16, no SiLU, 1e-6), the output norm (f32).
GN_CALLS = {
    (320, 4096, "bf16", True, 1e-5): 7, (640, 4096, "bf16", True, 1e-5): 2,
    (960, 4096, "bf16", True, 1e-5): 1, (320, 1024, "bf16", True, 1e-5): 1,
    (640, 1024, "bf16", True, 1e-5): 6, (960, 1024, "bf16", True, 1e-5): 1,
    (1280, 1024, "bf16", True, 1e-5): 1, (1920, 1024, "bf16", True, 1e-5): 1,
    (640, 256, "bf16", True, 1e-5): 1, (1280, 256, "bf16", True, 1e-5): 6,
    (1920, 256, "bf16", True, 1e-5): 1, (2560, 256, "bf16", True, 1e-5): 2,
    (1280, 64, "bf16", True, 1e-5): 11, (2560, 64, "bf16", True, 1e-5): 3,
    (320, 4096, "bf16", False, 1e-6): 5, (640, 1024, "bf16", False, 1e-6): 5,
    (1280, 256, "bf16", False, 1e-6): 5, (1280, 64, "bf16", False, 1e-6): 1,
    (320, 4096, "f32", True, 1e-5): 1,
}
ATTN_PER_FORWARD = sum(ATTN_CALLS.values())   # 32
# Phase 2 also holds K1 at the pixel UNets' one head of 256 (phase 16 drives
# them): the CIFAR UNet's call at the CLI's b500 (5 at 16x16, 1 in the middle)
# and the AdaGN UNet's middle attention on its CFG-doubled b20.  (b, S): calls
K1_D256_ROWS = {"cifar_b500": {(500, 256): 5, (500, 16): 1}, "adagn_b20": {(20, 16): 1}}
# K1's wgmma kernel as built (csrc/flash_attn_fwd.cu): (head dim, keys a K/V
# tile); the 80-key tiles serve calls of at most 80 keys
K1_WGMMA_INSTANCES = {(40, 128), (40, 80), (64, 128), (64, 80), (72, 128), (80, 128), (80, 80),
                      (160, 64), (160, 80), (256, 64), (512, 32)}
# K2's wgmma kernel as built (csrc/flash_attn_bwd.cu): head dim -> the main
# kernel's dynamic shared memory in bytes (each instance built twice: with one
# key tile, writing dq itself, and with several).  Up to d=80 (Config): 1024
# to align, K and V, two stages of Q and dO, four dS^T tiles, two f32 dQ parts,
# two stages of lse and delta, 5 barriers; 160 and 256 (SplitConfig): K and V
# of 64 keys, two stages of Q and dO over 64 rows (the d=256 stage 66 KiB,
# which also holds the step's staged f32 dQ rows, each padded by 16 bytes),
# two dS^T tiles, the stats, 5 barriers
K2_WGMMA_SMEM = {
    40: 1024 + 2 * 16384 + 2 * 2 * 16384 + 4 * 16384 + 2 * 128 * 40 * 4 + 2 * 1024 + 40,
    64: 1024 + 2 * 16384 + 2 * 2 * 8192 + 4 * 8192 + 2 * 64 * 64 * 4 + 2 * 512 + 40,
    72: 1024 + 2 * 32768 + 2 * 2 * 16384 + 4 * 8192 + 2 * 64 * 72 * 4 + 2 * 512 + 40,
    80: 1024 + 2 * 32768 + 2 * 2 * 16384 + 4 * 8192 + 2 * 64 * 80 * 4 + 2 * 512 + 40,
    160: 1024 + 2 * 3 * 8192 + 2 * 6 * 8192 + 2 * 8192 + 2 * 512 + 40,
    256: 1024 + 2 * 4 * 8192 + 2 * 66 * 1024 + 2 * 8192 + 2 * 512 + 40,
}
# and K1's d=512 instance: Q of 64 rows, two stages of 32-key K and V tiles
K1_D512_SMEM = 1024 + 64 * 1024 + 2 * 2 * 32 * 1024 + 8 * 8
GN_PER_FORWARD = sum(GN_CALLS.values())       # 61

# The SD1.5 VAE (ch 128, ch_mult (1, 2, 4, 4), 2 ResNet blocks a level, attention
# in the middle only) at 512x512, read off the module trees: (C, H*W, silu):
# calls of one decode and of one encode.  All f32, eps 1e-6; the one without
# SiLU is the mid-block attention's norm.
VAE_DECODE_GN = {
    (512, 4096, True): 10, (512, 4096, False): 1, (512, 16384, True): 6,
    (512, 65536, True): 1, (256, 65536, True): 5, (256, 262144, True): 1,
    (128, 262144, True): 6,
}
VAE_ENCODE_GN = {
    (128, 262144, True): 4, (128, 65536, True): 1, (256, 65536, True): 3,
    (256, 16384, True): 1, (512, 16384, True): 3, (512, 4096, True): 9,
    (512, 4096, False): 1,
}
GN_PER_DECODE = sum(VAE_DECODE_GN.values())   # 30
GN_PER_ENCODE = sum(VAE_ENCODE_GN.values())   # 22

# phase 8: SD1.5 text to image as one config, the dict a YAML file would give
T2I_STEPS, T2I_SIZE, T2I_SCALE = 50, 512, 7.5
T2I_CHECK_BATCH, T2I_CHECK_STEPS, T2I_EDIT_STEPS = 2, 5, 4
SD15_CONF = {
    "model": {
        "target": "dmtpu.models.stablediffusion.StableDiffusion",
        "params": {
            "scale_factor": 0.18215,
            "unet_config": {"target": "dmtpu.models.stablediffusion.SDUNetModel",
                            "params": dict(SD15, torso_dtype="bfloat16")},
            "vae_config": {"target": "dmtpu.models.stablediffusion.AutoencoderKL",
                           "params": {"embed_dim": 4, "z_channels": 4, "resolution": 256,
                                      "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2}},
            "text_encoder_config": {
                "target": "dmtpu.models.stablediffusion.FrozenCLIPEmbedder",
                "params": {"version": "clip-vit-l"}},
        },
    },
    "diffusion": {"target": "diffusions.ddpm.DDPM",
                  "params": {"total_steps": 1000, "beta_schedule": "quad",
                             "beta_start": 0.00085, "beta_end": 0.012,
                             "objective": "pred_eps"}},
}

# phase 2: the 64x64 level's self-attention under ToMe in a b16 CFG request
# (32 samples): 4096 - r tokens, r = int(4096 * ratio) (``ops/tome.py::tome_r``):
# 2048 at 0.5, 2868 at 0.3 (off the 128-token grid); 5 calls a UNet call
TOME_ATTN = {0.5: (2048, 2048, 40), 0.3: (2868, 2868, 40)}
TOME_ATTN_CALLS = 5

# phase 10: the serving accelerators through ``sample_images`` on phase 8's
# stack, b16 512x512 CFG 7.5 (the JAX package's bench extras on the SD path)
SERVE_CONFIGS = {
    "dpmpp20": dict(sampler="dpmpp", respace_steps=20),
    "pfdiff50": dict(sampler="pfdiff", respace_steps=50),
    "ddim50_deepcache": dict(sampler="ddim", respace_steps=50, deepcache=(2, 3)),
    "pfdiff50_deepcache": dict(sampler="pfdiff", respace_steps=50, deepcache=(2, 3)),
    "ddim50_tome": dict(sampler="ddim", respace_steps=50, tome_ratio=0.5),
    "ddim50_freeu": dict(sampler="ddim", respace_steps=50, freeu="sd15"),
    "stack": dict(sampler="pfdiff", respace_steps=50, deepcache=(2, 3), tome_ratio=0.5,
                  freeu="sd15"),
}
SERVE_CHECK_STEPS = 5
# a shallow DeepCache pass at skip 3: input blocks 0-2 and the last three
# output blocks (2 + 3 ResBlocks, 2 + 3 SpatialTransformers) and the out norm
SHALLOW_ATTN, SHALLOW_GN = 10, 16

# phase 9: the fine-tuning CLI from the repository's configs, on data and a
# tokenizer that the phase writes for itself
FT_CONFIG, LORA_CONFIG = "configs/sd15_finetune.yaml", "configs/sd15_lora.yaml"
FT_SIZE, FT_IMAGES, FT_BATCH, FT_CHECK_BATCH = 512, 16, 8, 2
# the full fine-tune: one multi-GB save; the resume is the LoRA run's (small saves)
FT_STEPS, LORA_STEPS, LORA_RESUMED_STEPS, FT_PREVIEW_STEPS, FT_TIMED_STEPS = 3, 2, 3, 10, 3
FT_CAPTIONS = ("a photo of object {}", "a drawing of thing {}", "an image number {}", "")

# phase 11: DiT-XL/2 class-conditional sampling through ``sample_cfg``'s request
# function at 256x256 (``benchmarks/northstar.py:75-91``: DiT-XL/2 on 32x32x4
# latents, bf16 torso), the config dict a YAML file would give: the
# sd-vae-ft-ema architecture as the VAE, the DiT's linear schedule and learned
# variance; MDTv2-XL/2 (the class's defaults) beside it
DIT_CONF = {
    "data": {"params": {"img_size": 256}, "img_channels": 3, "num_classes": 1000},
    "model": {
        "target": "models.dit.dit.DiT",
        "params": {
            "vit_config": {"target": "models.dit.model.DiT",
                           "params": {"depth": 28, "hidden_size": 1152, "patch_size": 2,
                                      "num_heads": 16, "input_size": 32, "dtype": "bfloat16"}},
            "vae_config": {"target": "models.dit.autoencoder.AutoEncoderKL",
                           "params": {"embed_dim": 4, "z_channels": 4, "resolution": 256,
                                      "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2}},
        },
    },
    "diffusion": {"target": "diffusions.ddpm.DDPM",
                  "params": {"total_steps": 1000, "beta_schedule": "linear",
                             "beta_start": 0.0001, "beta_end": 0.02, "objective": "pred_eps",
                             "var_type": "learned_range"}},
}
DIT_B, DIT_STEPS, DIT_SCALE, DIT_CLASS = 32, 50, 4.0, 207
DIT_CHECK_BATCH, DIT_CHECK_STEPS, MDT_B, MDT_STEPS = 2, 5, 8, 10
# one DiT-XL/2 forward: 28 self-attentions at S=256 over 16 heads of 72
DIT_HEADS, DIT_ATTN, DIT_ATTN_PER_FORWARD = 16, (256, 256, 72), 28
# the VAE decoder at 256x256 (32x32 latents): VAE_DECODE_GN's shapes at a
# quarter of the pixels; 30 calls a decode
DIT_DECODE_GN = {(c, hw // 4, silu): n for (c, hw, silu), n in VAE_DECODE_GN.items()}

# phase 12: DiT-XL/2 class-conditional training, ``bench.py``'s ``dit_train``
# (``benchmarks/train_northstar.py:158-192``: DiT-XL/2 on 32x32x4 latents,
# bf16 torso, no remat, ``learn_sigma=False``, adafactor 1e-4, clip 1.0, no
# EMA, batch 32), and ``train_ddpm_cfg`` from a config the phase writes
DIT_TRAIN = dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16, input_size=32,
                 learn_sigma=False, use_checkpoint=False, dtype="bfloat16")
DIT_TRAIN_B, DIT_TRAIN_STEPS, DIT_TRAIN_CHECK_BATCH = 32, 10, 2
DIT_CLI_STEPS, DIT_CLI_RESUMED_STEPS, DIT_CLI_IMAGES = 4, 6, 128
MDT_TRAIN_B, MDT_MASK_RATIO = 8, 0.3

# phase 13: MMDiT text to image through ``sample_mmdit``'s request function:
# SD3-medium (``configs/sd3_medium.yaml``: MMDiT-L/2, 24 heads of 64, 128x128x16
# latents, 154 context tokens, FlowMatching Euler-28 at time shift 3, the
# 16-channel VAE to 1024x1024) with its torso in bf16 as the CLI's override
# gives it, and ``bench.py``'s ``mmdit_sample`` (``bench.py:214-266``:
# MMDiT-B/2 on 32x32x4 latents, 77 context tokens, FlowDPM-20, CFG 4, b32)
SD3_CONFIG, SD3_OVERRIDES = "configs/sd3_medium.yaml", ["model.params.dtype=bfloat16"]
SD3_B, SD3_STEPS, SD3_CHECK_STEPS, SD3_SCALE = 2, 28, 2, 4.0
SD3_PROMPT = "a photograph of an astronaut riding a horse"
MMDIT_B2 = dict(input_size=32, in_channels=4, context_dim=4096, pooled_dim=2048,
                dtype="bfloat16")
MMDIT_B2_B, MMDIT_B2_STEPS, MMDIT_B2_CTX = 32, 20, 77
# the joint attention of one CFG-doubled call, (b, h, S), and its calls a forward
MMDIT_ATTN = {"sd3_medium_b4": (2 * SD3_B, 24, 154 + 4096),
              "mmdit_b2_b64": (2 * MMDIT_B2_B, 12, MMDIT_B2_CTX + 256)}
MMDIT_ATTN_PER_FORWARD = {"sd3_medium_b4": 24, "mmdit_b2_b64": 12}
MMDIT_CONTEXT_TOKENS = {"sd3_medium_b4": 154, "mmdit_b2_b64": MMDIT_B2_CTX}
# the VAE decoder at 1024x1024 (128x128x16 latents): VAE_DECODE_GN's shapes at
# four times the pixels; 30 calls a decode
SD3_DECODE_GN = {(c, 4 * hw, silu): n for (c, hw, silu), n in VAE_DECODE_GN.items()}

# phase 14: MMDiT rectified-flow training: ``bench.py``'s ``mmdit_train``
# (``benchmarks/train_northstar.py:195-250``: MMDiT-B/2 on 32x32x4 latents,
# 77 x 4096 context, pooled 2048, QK norm, bf16 torso, no remat, adafactor
# 1e-4, clip 1.0, no EMA, b128) through ``train_mmdit``'s loss, and ``python -m
# dmtpu_torch.scripts.train_mmdit -c configs/sd3_medium.yaml`` with the torso
# computing and stored in bf16 (``configs/sd3_medium.yaml:60-65``) and remat on,
# its depth cut from 24 blocks to SD3_CLI_DEPTH (its widths kept),
# ``SyntheticEmbedded`` cut to 64 items, no eval grid (16-channel latents make
# no PNG); ``sample_cfg --sampler flow`` on DiT-XL/2 without learned variance
MMDIT_TRAIN_B, MMDIT_TRAIN_STEPS, MMDIT_TRAIN_CHECK_BATCH = 128, 10, 2
SD3_CLI_DEPTH = 12
SD3_TRAIN_OVERRIDES = ["model.params.dtype=bfloat16", "model.params.param_dtype=bfloat16",
                       "model.params.use_checkpoint=true", f"model.params.depth={SD3_CLI_DEPTH}",
                       "data.params.n=64", "dataloader.num_workers=4", "train.print_freq=1",
                       "train.sample_freq=0"]
SD3_TRAIN_STEPS, SD3_TRAIN_RESUMED_STEPS = 2, 3
# the joint attention of a train step, (b, h, S), and its calls a step: K1 in
# the forward (and again in the recompute under remat), K2 in the backward
MMDIT_TRAIN_ATTN = {"mmdit_train_b128": (MMDIT_TRAIN_B, 12, MMDIT_B2_CTX + 256),
                    "sd3_train_b32": (32, 24, 154 + 4096)}
MMDIT_TRAIN_CALLS = {"mmdit_train_b128": {"K1": 12, "K2": 12, "K3": 0},
                     "sd3_train_b32": {"K1": 48, "K2": 24, "K3": 0}}
MMDIT_TRAIN_CONTEXT = {"mmdit_train_b128": MMDIT_B2_CTX, "sd3_train_b32": 154}
FLOW_B, FLOW_STEPS = 4, 4

# phase 15: SDXL-base text to image through the Generate logic of the SDXL
# page (``dmtpu_torch/ui/sdxl.py``; ``streamlit/pages/4_Stable_Diffusion_XL.py``
# :69-117) at 1024x1024, as one config dict that mirrors the upstream
# ``sd_xl_base.yaml`` through the reference targets: the UNet of
# ``benchmarks/northstar.py:94-119`` (2.57B parameters, 128x128x4 latents,
# ``transformer_depth`` (1, 2, 10), context 2048, "sequential" vector 2816,
# linear projections) with the yaml's ``softmax-xformers`` attention type and
# no remat, computing in bf16 over f32 parameters; the sd_xl_base conditioner
# (CLIP-L at hidden layer 11, bigG penultimate and pooled, three size / crop
# embedders of 256); the SD VAE; and ``bench.py``'s ``sdxl`` extra (unguided
# DDIM-50, b1)
SDXL_UNET = dict(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
                 attention_resolutions=[4, 2], channel_mult=[1, 2, 4], num_head_channels=64,
                 use_spatial_transformer=True, transformer_depth=[1, 2, 10], context_dim=2048,
                 num_classes="sequential", adm_in_channels=2816,
                 use_linear_in_transformer=True, legacy=False, use_checkpoint=False,
                 spatial_transformer_attn_type="softmax-xformers", torso_dtype="bfloat16")
_SGM = "sgm.modules.encoders.modules."
SDXL_CONF = {
    "model": {
        "target": "models.sdxl.stablediffusion.StableDiffusion",
        "params": {
            "scale_factor": 0.13025,
            "conditioner_config": {
                "target": "models.sdxl.conditioner.GeneralConditioner",
                "params": {"emb_models": [
                    {"target": _SGM + "FrozenCLIPEmbedder",
                     "params": {"layer": "hidden", "layer_idx": 11}},
                    {"target": _SGM + "FrozenOpenCLIPEmbedder2",
                     "params": {"arch": "ViT-bigG-14", "layer": "penultimate",
                                "always_return_pooled": True, "legacy": False}},
                    *[{"target": _SGM + "ConcatTimestepEmbedderND", "params": {"outdim": 256}}
                      for _ in range(3)]]}},
            "unet_config": {"target": "models.sdxl.unet.UNetModel", "params": SDXL_UNET},
            "vae_config": {"target": "models.sdxl.autoencoder.AutoencoderKL",
                           "params": {"embed_dim": 4, "z_channels": 4, "resolution": 256,
                                      "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2}},
        },
    },
    "diffusion": {"target": "diffusions.ddpm.DDPM",
                  "params": {"total_steps": 1000, "beta_schedule": "quad",
                             "beta_start": 0.00085, "beta_end": 0.012,
                             "objective": "pred_eps"}},
}
SDXL_STEPS, SDXL_SCALE, SDXL_SIZE, SDXL_B, SDXL_CFG_B = 50, 5.0, 1024, 1, 2
SDXL_PROMPT_SEED = 77
# one SDXL UNet call on 128x128 latents (70 transformer blocks, each a
# self- and a cross-attention, heads of 64): (S_q, S_k, heads): calls
SDXL_ATTN = {(4096, 4096, 10): 10, (1024, 1024, 20): 60,
             (4096, 77, 10): 10, (1024, 77, 20): 60}
# (C, H*W, dtype, silu, eps): calls.  17 ResBlocks x 2 (bf16, SiLU, 1e-5),
# 11 SpatialTransformer norms (bf16, no SiLU, 1e-6), the output norm (f32)
SDXL_GN_CALLS = {
    (320, 16384, "bf16", True, 1e-5): 7, (640, 16384, "bf16", True, 1e-5): 2,
    (960, 16384, "bf16", True, 1e-5): 1, (320, 4096, "bf16", True, 1e-5): 1,
    (640, 4096, "bf16", True, 1e-5): 6, (960, 4096, "bf16", True, 1e-5): 1,
    (1280, 4096, "bf16", True, 1e-5): 1, (1920, 4096, "bf16", True, 1e-5): 1,
    (640, 1024, "bf16", True, 1e-5): 1, (1280, 1024, "bf16", True, 1e-5): 10,
    (1920, 1024, "bf16", True, 1e-5): 1, (2560, 1024, "bf16", True, 1e-5): 2,
    (640, 4096, "bf16", False, 1e-6): 5, (1280, 1024, "bf16", False, 1e-6): 6,
    (320, 16384, "f32", True, 1e-5): 1,
}
# the SD VAE's decoder at 1024x1024 (128x128x4 latents): SD3_DECODE_GN's shapes
SDXL_DECODE_GN = SD3_DECODE_GN
SDXL_BENCH_STEPS = 50  # bench.py's sdxl extra

# phase 16: pixel-space unconditional sampling through sample_uncond.
# guided-diffusion's published 256x256_diffusion_uncond flags (attention at
# 32, 16 and 8 pixels: the downsample factors 8, 16 and 32; learn_sigma: 6
# output channels; the release's fp16 torso as a bf16 one), 552.8M parameters,
# through the reference's registry target; DDIM-50 over its linear 1000-step
# schedule at b16
ADM256_CONF = {"target": "models.adm.unet.UNetModel", "params": dict(
    image_size=256, in_channels=3, model_channels=256, out_channels=6, num_res_blocks=2,
    attention_resolutions=[8, 16, 32], channel_mult=[1, 1, 2, 2, 4, 4], num_head_channels=64,
    resblock_updown=True, use_scale_shift_norm=True, dropout=0.0, use_fp16=True)}
ADM256_DIFFUSION = {"target": "diffusions.ddpm.DDPM", "params": dict(
    total_steps=1000, beta_schedule="linear", objective="pred_eps", var_type="learned_range")}
ADM256_PARAMS = 552_814_086
ADM_B, ADM_STEPS = 16, 50
# configs/ddpm_cifar10.yaml's UNet (35.7M; one 256-wide head at 16x16 and in
# the middle) at the CLI's default batch of 500: DDIM-50 and Heun-25, DDIM
# inversion then sampling of RECON_IMAGES images; configs/ddpm_cfg_cifar10.yaml's
# UNetCategorialAdaGN through sample_cfg, DDIMCFG-50, CFG_EACH images a class;
# both with a bf16 torso (K1 takes bf16)
CIFAR_CONFIG, CIFAR_CFG_CONFIG = "configs/ddpm_cifar10.yaml", "configs/ddpm_cfg_cifar10.yaml"
PIXEL_OVERRIDES = ["model.params.dtype=bfloat16"]
CIFAR_PARAMS, ADAGN_PARAMS = 35_746_307, 44_179_459
CIFAR_B, CIFAR_STEPS, HEUN_STEPS, RECON_IMAGES, CFG_EACH, CFG_SCALE_PIXEL = 500, 50, 25, 8, 10, 2.0

# phase 17: pixel-space DDPM training: configs/ddpm_cifar10.yaml's UNet (35.7M,
# dropout 0.1, one head of 256 at 16x16 and in the middle: K1 and K2 at d=256)
# at the config's batch of 128 with its Adam 2e-4, clip 1.0 and EMA 0.9999, a
# bf16 torso; train_ddpm in this process on Synthetic 32x32x3 images in place
# of CIFAR-10 (no dataset files on the card's machine), with a DDPM_IP run;
# train_ddpm_cfg on configs/ddpm_cfg_cifar10.yaml's UNetCategorialAdaGN (K2 at
# d=64 through wgmma and at d=256)
PIXEL_TRAIN_STEPS, PIXEL_TRAIN_CHECK_BATCH = 10, 2
SYNTHETIC_DATA = ["data.target=datasets.synthetic.Synthetic", "data.params.n=512",
                  "dataloader.num_workers=4", "train.print_freq=1"]
# the eval grid: train.n_samples images from the config's DDPM respaced to 100 steps
PIXEL_CLI_GRID = ["train.n_samples=16", "diffusion.params.respace_type=uniform",
                  "diffusion.params.respace_steps=100"]
PIXEL_CLI_STEPS, PIXEL_CLI_RESUMED_STEPS, PIXEL_IP_STEPS, ADAGN_CLI_STEPS = 3, 5, 2, 3
# K2 at d=256: the pixel UNets' shapes (b, S, d at h1) and a padded head dim
K2_D256_ROWS = [(128, 256, 256), (128, 16, 256), (8, 200, 256), (8, 256, 248)]
# the CIFAR UNet's attention calls a step, (S, d) at h1: 5 at 16x16, 1 in the
# middle (checked against the module tree in (b)); the AdaGN UNet's by head dim
# and its GroupNorms a call (read off its module tree in phase 16)
CIFAR_TRAIN_ATTN = {(256, 256): 5, (16, 256): 1}
ADAGN_ATTN, ADAGN_GN_PER_CALL = {64: 10, 256: 1}, 68

# phase 18: guidance and image editing.  configs/ddpm_celebahq.yaml's UNet
# (113.7M; one head of 512 at 16x16 and in the middle: K1 at d=512) with a bf16
# torso: DDIM-50 at b16 through sample_uncond, SDEdit (DDPM-100, the last 50
# rows), mask guidance (DDPM-50) and RePaint (DDPM-25, r 2, j 5), CLIP guidance
# (ViT-B/32 widths, seeded weights; DDPM-50, weight 100); ADM-256 (ADM256_CONF)
# for ILVR (DDPM-100, factor 8, cubic) and, with guided-diffusion's 1000
# classes, for DDIB (DDIM-50 inversion, then DDIM-50 sampling); EDIT_IMAGES
# seeded 256x256 PNGs in a temporary ImageDir, batches of EDIT_B
CELEBAHQ_CONFIG, CELEBAHQ_PARAMS = "configs/ddpm_celebahq.yaml", 113_673_219
CELEBAHQ_ATTN = {(1, 256, 256, 512): 5, (1, 64, 64, 512): 1}  # (h, S_q, S_k, d): calls a call
CELEBAHQ_B, CELEBAHQ_STEPS = 16, 50
# K1 at d=512: (b, S, d, calls in a b16 CelebA-HQ call): its two shapes, a
# ragged length, a padded head dim, and b128, where the card and not the host
# sets the pace
K1_D512_ROWS = [(16, 256, 512, 5), (16, 64, 512, 1), (4, 200, 512, 0), (4, 256, 504, 0),
                (128, 256, 512, 0)]
EDIT_IMAGES = EDIT_B = 8
SDEDIT_RESPACE, SDEDIT_STEPS = 100, 50
MASK_RESPACE, REPAINT_RESPACE, REPAINT_R, REPAINT_J = 50, 25, 2, 5
CLIP_RESPACE, CLIP_WEIGHT, CLIP_TEXT = 50, 100.0, "a smiling face"
ILVR_RESPACE, ILVR_FACTOR = 100, 8
DDIB_STEPS, DDIB_CHECK_STEPS, DDIB_CLASSES = 50, 5, (207, 360)

# phase 19: CelebA-HQ DDPM training and the T5 text path.
# configs/ddpm_celebahq.yaml's UNet (113.7M, one head of 512: K1 and K2 at
# d=512) with a bf16 torso at b16 256x256 and the config's Adam 2e-5, clip
# 1.0 and gradual EMA 0.9999; train_ddpm on Synthetic 256x256x3 images in
# place of CelebA-HQ (no dataset files on the card's machine); a T5 encoder
# of google/t5-v1_1-xxl's published shape (random weights built on the card)
# beside CLIP-L and OpenCLIP bigG at full width through encode_prompts
# K2 at d=512: (b, S, d, calls in a b16 CelebA-HQ train step): its two
# shapes, a ragged length and a padded head dim
K2_D512_ROWS = [(16, 256, 512, 5), (16, 64, 512, 1), (4, 200, 512, 0), (4, 256, 504, 0)]
# its shared memory: K, V and two buffers of Q and dO, 32 rows of 520 bf16
# each, the dS^T tile of 32 x 40 and two buffers of lse and delta
K2_D512_SMEM = (6 * 32 * 520 + 32 * 40) * 2 + 4 * 32 * 4
CELEBAHQ_TRAIN_B, CELEBAHQ_TRAIN_STEPS, CELEBAHQ_TRAIN_CHECK_BATCH = 16, 10, 2
CELEBAHQ_TRAIN_STEP = {"K1": 6, "K2": 6, "K3": 71}  # launches a train step
CELEBAHQ_CLI = ["data.target=datasets.synthetic.Synthetic", "data.params.n=64",
                "dataloader.num_workers=4", "train.print_freq=1",
                f"train.batch_size={CELEBAHQ_TRAIN_B}", "train.n_samples=4",
                "diffusion.params.respace_type=uniform", "diffusion.params.respace_steps=10"]
CELEBAHQ_CLI_STEPS, CELEBAHQ_CLI_RESUMED_STEPS = 2, 3
T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24,
              num_heads=64, feed_forward_proj="gated-gelu")
T5_XXL_PARAMS = 4_762_310_656
T5_CLI_LAYERS = 2  # the T5 that encode_prompts --t5_dir loads: XXL widths, 2 of 24 layers
ENCODE_PROMPTS = ("a smiling face", "a red car on a hill", "two dogs", "an image number 4")

# phase 20: FID / IS / KID.  accept's row EVAL_ROW (DDIM-10) on
# configs/ddpm_cifar10.yaml's UNet (35.7M, full width, seeded weights, bf16
# torso) at its batch of 500: EVAL_N samples a side (>= 2048, so that the
# pool3 covariance has full rank), the FID InceptionV3 (seeded weights in the
# pt_inception layout, 299², f32) at EVAL_FEATURE_B, against five seeded
# data_batch pickles of EVAL_PER_BATCH images in place of CIFAR-10 (no dataset,
# Inception or trained weights on the card's machine); evaluate on
# EVAL_DIR_IMAGES of each side written as PNGs, with KID and a CLIP of
# ViT-B/32's widths (seeded weights)
EVAL_ROW, EVAL_N, EVAL_B, EVAL_FEATURE_B, EVAL_PER_BATCH = "ddim_10", 2500, 500, 250, 500
EVAL_CALL = {"K1": 6, "K2": 0, "K3": 51}  # launches a CIFAR UNet call (phase 16's tree)
EVAL_CHECK_IMAGES, EVAL_DIR_IMAGES = 16, 256
EVAL_KID_SUBSETS, EVAL_KID_SIZE = 10, 200

# phase 21: selective remat, LoRA under remat, a schedule, data parallelism at
# world size 1 and the ring attention fold.  (a) the SD1.5 UNet (bf16 torso,
# seeded weights) at b4 under each use_checkpoint; the gradient bound is twice
# the run-to-run noise of two runs without remat plus REMAT_GRAD_TOL
REMAT_B, REMAT_GRAD_TOL, REMAT_TIMED_STEPS = 4, 1e-3, 3
REMAT_POLICIES = [False, True, "nothing", "dots", "dots_no_batch", "attn", "everything"]
# the step timed at configs/sd15_finetune.yaml's batch (8) and at 16
REMAT_TIMED_BATCHES, REMAT_TIMED_POLICIES = (8, 16), [False, True, "attn", "dots"]
# (b) configs/sd15_lora.yaml with use_checkpoint; (c) and (d)
# configs/ddpm_cifar10.yaml under a warmup-cosine schedule, then through a
# one-rank NCCL group
REMAT_LORA_BATCH, REMAT_LORA_STEPS = 2, 2
SCHEDULE_STEPS, DP_SAMPLES, DP_PARAM_TOL = 3, 4, 1e-3
# (e) the ring's arithmetic over RING_CHUNKS K/V chunks on one card: SD1.5's
# 64x64 and 32x32 self-attention (K1 / K2 wgmma) and the CIFAR UNet's d=256
# (K1 and K2 wgmma); O and the gradients within RING_TOL of the largest entry of the
# whole sequence's
RING_CHUNKS, RING_TOL = 4, 2e-2
RING_SHAPES = {"sd15_s4096_d40": (16, 4096, 8, 40), "sd15_s1024_d80": (16, 1024, 8, 80),
               "cifar_s256_d256": (128, 256, 1, 256)}

# phase 22: the UIs.  The web UI (``python -m dmtpu_torch.webui.app``) served in
# a thread on 127.0.0.1 over CIFAR_CONFIG and CIFAR_CFG_CONFIG at full width with
# a bf16 torso (PIXEL_OVERRIDES), seeded random weights in a temporary torch
# file; one /sample request each: DDIM-50 at b16 (the form's defaults), the
# AdaGN UNet's class UI_CFG_CLASS at guidance scale UI_CFG_SCALE.  Page 3's
# logic (``dmtpu_torch.ui.sd``) on phase 8's SD1.5 stack: b1 512x512 DDIM-20,
# ToMe 0.5, FreeU at SD1.5's scales, offset noise 0.1
UI_QUERY = "sampler=ddim&steps=50&n=16&seed=0"
UI_N, UI_STEPS, UI_CFG_CLASS, UI_CFG_SCALE = 16, 50, 3, 3.0
UI_CALL = {"cifar": {"K1": 6, "K3": 51}, "adagn": {"K1": 11, "K3": ADAGN_GN_PER_CALL}}
UI_SD = dict(sampler="ddim", steps=20, scale=7.5, height=512, width=512, tome_ratio=0.5,
             freeu=True, offset_noise=0.1, batch_size=1, batch_count=1)
UI_SD_PROMPT, UI_SD_NEGATIVE = "a photograph of an astronaut riding a horse", "blurry"
# the card's idle share is read off a request of UI_IDLE_STEPS (page 3: UI_SD_IDLE_STEPS)
# steps: the same work a step, and a trace the profiler reads in seconds, not tens
UI_IDLE_STEPS, UI_SD_IDLE_STEPS = 10, 5


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dmtpu_torch.diffusions import DDIM, DDIMCFG
    from dmtpu_torch.models.stablediffusion import SDUNetModel
    from dmtpu_torch.ops import _build, plain_ops, roofline
    from dmtpu_torch.ops.attention import mha
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_reference,
        kernels_for,
        select_kernel,
    )
    from dmtpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference
    from dmtpu_torch.ops import groupnorm as groupnorm_module
    from dmtpu_torch.ops.groupnorm import kernels_for as gn_kernels_for
    from dmtpu_torch.ops.groupnorm import plan as gn_plan

    dev = torch.device("cuda")
    failures: list[str] = []
    started = time.perf_counter()
    phase_seconds: dict = {}

    def run_phase(name: str, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_seconds[name] = time.perf_counter() - t0
        return out

    def check(ok: bool, what: str) -> None:
        log(("PASS " if ok else "FAIL ") + what)
        if not ok:
            failures.append(what)

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def host_us(fn, reps: int) -> float:
        """Host time of one call of ``fn``: the host clock over ``reps`` calls
        with no synchronise between them, in microseconds per call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * seconds / reps

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())
    instances = wgmma_fwd_instances(lib_path, _build.library())
    check({(inst["d"], inst["keys"]) for inst in instances} == K1_WGMMA_INSTANCES,
          f"K1 wgmma instances (head dim, keys a tile) in build.log: {K1_WGMMA_INSTANCES}")
    for inst in instances:
        log("K1 wgmma instance " + json.dumps(inst))
        check(inst["spill_stores"] == inst["spill_loads"] == 0 and inst["registers"] <= 168
              and 0 < inst["smem_bytes"] <= 232448,
              f"K1 wgmma d={inst['d']} keys a tile {inst['keys']}: no spills, "
              f"{inst['registers']} registers at launch, {inst['smem_bytes']} bytes of shared "
              "memory (a block may use 232448)")
    check([inst["smem_bytes"] for inst in instances if inst["d"] == 512] == [K1_D512_SMEM],
          f"K1 wgmma d=512: {K1_D512_SMEM} bytes of shared memory, as reckoned")
    k2_instances = wgmma_bwd_instances(lib_path, _build.library())
    check({(inst["d"], inst["one_tile"]) for inst in k2_instances}
          == {(d, one) for d in K2_WGMMA_SMEM for one in (False, True)},
          f"K2 wgmma instances (head dim, one key tile) in build.log: {sorted(K2_WGMMA_SMEM)}, "
          "each with and without one key tile")
    for inst in k2_instances:
        log("K2 wgmma instance " + json.dumps(inst))
        check(inst["spill_stores"] == inst["spill_loads"] == 0 and inst["registers"] <= 168
              and inst["smem_bytes"] == K2_WGMMA_SMEM[inst["d"]] <= 232448,
              f"K2 wgmma d={inst['d']} one key tile {inst['one_tile']}: no spills, "
              f"{inst['registers']} registers at launch, {inst['smem_bytes']} bytes of shared "
              "memory as reckoned (a block may use 232448)")

    # ---- 2. K1 ------------------------------------------------------------
    log("SDPA backends enabled: " + json.dumps({
        name: bool(getattr(torch.backends.cuda, f"{name}_sdp_enabled")())
        for name in ("flash", "mem_efficient", "math", "cudnn")
        if hasattr(torch.backends.cuda, f"{name}_sdp_enabled")}))
    def new_totals():
        return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, host_us=0.0, err=0.0,
                    bound_ms_by={"bytes": 0.0, "operations": 0.0})

    g = gen(SEED)

    def k1_case(n, sq, sk, d, calls, totals, h=8):
        """One K1 row at batch ``n`` and ``h`` heads: every kernel that takes
        the shape checked against the plain versions and timed; the chosen
        one's columns, times ``calls``, go into ``totals``."""
        q = torch.randn(n, sq, h, d, generator=g, device=dev).bfloat16()
        k = torch.randn(n, sk, h, d, generator=g, device=dev).bfloat16()
        v = torch.randn(n, sk, h, d, generator=g, device=dev).bfloat16()
        # the plain versions in slices of B samples: at S = 4096 their f32
        # logits are 8 GiB for 16 samples
        ref_o, ref_lse = (torch.cat(part) for part in zip(*(
            flash_attention_reference(q[i:i + B], k[i:i + B], v[i:i + B])
            for i in range(0, n, B))))
        plain = torch.cat([mha(q[i:i + B], k[i:i + B], v[i:i + B]) for i in range(0, n, B)])
        chosen = select_kernel(d)
        names = kernels_for(d)
        # bf16 output: one bf16 step (2^-8 relative) of the largest outputs on
        # top of P rounded to bf16 in both versions; a skipped or doubled K/V
        # tile moves outputs by about a tenth of max|o|.  mha also rounds its
        # logits to bf16 where S_q*S_k <= 2**21
        bound = 1e-2 * ref_o.float().abs().max().item()
        errs = {}
        for name in names:
            o, lse = flash_attention_fwd(q, k, v, kernel=name)
            torch.cuda.synchronize()
            err_ref = (o.float() - ref_o.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            err_mha = (o.float() - plain.float()).abs().max().item()
            rel_mha = err_mha / plain.float().abs().max().item()
            errs[name] = dict(max_abs_err_vs_mha=err_mha, rel_err_vs_mha=rel_mha,
                              max_abs_err_vs_own_plain=err_ref, lse_max_abs_err=err_lse)
            check(err_ref <= bound and err_lse <= 1e-3 and rel_mha <= 3e-2 and
                  bool(torch.isfinite(o).all()),
                  f"K1[{name}] bf16 b{n} h{h} S_q={sq} S_k={sk} d={d}")
            del o, lse
        # each hand-written kernel that takes the shape, in the order first,
        # second, second, first: the dispatch must not pick the slower one
        by_kernel, host_by_kernel = time_by_kernel(
            lambda name: flash_attention_fwd(q, k, v, kernel=name), names, 20)
        ms = sum(by_kernel[chosen]) / len(by_kernel[chosen])
        plain_ms = time_ms(lambda: mha(q, k, v), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, S, D] views
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 20)
        host = host_us(lambda: flash_attention_fwd(q, k, v), 200)
        bound_t, bound_by = roofline.bound_ms(*roofline.attention_fwd_work(n, h, sq, sk, d))
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_t),
                           ("library_ms", library_ms), ("host_us", host)):
            totals[key] += calls * value
        totals["bound_ms_by"][bound_by] += calls * bound_t
        totals["err"] = max(totals["err"], errs[chosen]["max_abs_err_vs_mha"])
        log("K1", json.dumps(dict(
            b=n, h=h, sq=sq, sk=sk, d=d, calls=calls, kernel=chosen, **errs[chosen], ms=ms,
            ms_by_kernel=by_kernel, host_ms_by_kernel=host_by_kernel, plain_ms=plain_ms,
            bound_ms=bound_t, bound_by=bound_by, library_ms=library_ms, host_us=host,
            host_bound=ms <= 1.2 * host / 1e3)))
        check(not_the_slower(by_kernel, chosen, ms, host, host_by_kernel),
              f"K1 dispatch b{n} h{h} S_q={sq} S_k={sk} d={d}: {chosen} is not the slower kernel")
        del q, k, v, qt, kt, vt, ref_o, ref_lse, plain
        return ms / library_ms

    # batch 16 is what DDIM-50 and training give K1; a text-to-image request of
    # 16 images calls the UNet on the CFG-doubled batch of 32
    k1, k1_cfg = new_totals(), new_totals()
    over_sdpa = {}  # K1's time over SDPA's, b32, by (S_q, S_k, d)
    for n, totals in ((B, k1), (2 * B, k1_cfg)):
        for (sq, sk, d), calls in ATTN_CALLS.items():
            over_sdpa[(sq, sk, d)] = k1_case(n, sq, sk, d, calls, totals)
            torch.cuda.empty_cache()
    log(f"K1 per b{B} UNet forward ({ATTN_PER_FORWARD} calls): " + json.dumps(k1))
    log(f"K1 per b{2 * B} UNet forward ({ATTN_PER_FORWARD} calls): " + json.dumps(k1_cfg))
    # the pixel UNets' one head of 256: each sum over one call's d=256 attentions
    k1_d256 = {}
    for label, rows in K1_D256_ROWS.items():
        k1_d256[label] = new_totals()
        for (n, s), calls in rows.items():
            k1_case(n, s, s, 256, calls, k1_d256[label], h=1)
            torch.cuda.empty_cache()
    log("K1 at d=256 h1, summed over the d=256 attentions of one call: "
        + json.dumps(k1_d256))
    # ToMe's merged self-attention at the 64x64 level, on the CFG-doubled batch
    k1_tome = {}
    for ratio, (sq, sk, d) in TOME_ATTN.items():
        k1_tome[f"r{ratio}"] = new_totals()
        over_sdpa[(sq, sk, d)] = k1_case(2 * B, sq, sk, d, TOME_ATTN_CALLS, k1_tome[f"r{ratio}"])
        torch.cuda.empty_cache()
    log(f"K1 ToMe rows, b{2 * B}, summed over the {TOME_ATTN_CALLS} merged self-attentions of "
        f"a UNet call: " + json.dumps(k1_tome))
    log(f"K1 time over SDPA's, b{2 * B} h8 d40: " + json.dumps(
        {f"S={sq}": over_sdpa[(sq, sk, d)] for sq, sk, d in
         [(4096, 4096, 40)] + list(TOME_ATTN.values())}))
    torch.cuda.empty_cache()

    # ---- 3. K3 ------------------------------------------------------------
    k3, k3_cfg = new_totals(), new_totals()
    pairs = sorted({(c, hw) for c, hw, *_ in GN_CALLS})
    # the UNet's activations are channels-last (cuDNN returns its bf16
    # convolutions so); NCHW is checked too, and timed but not summed
    cl, nchw = torch.channels_last, torch.contiguous_format
    variants = [("bf16", True, 1e-5, cl), ("bf16", False, 1e-6, cl), ("f32", True, 1e-5, cl),
                ("f32", False, 1e-6, cl), ("bf16", True, 1e-5, nchw), ("f32", False, 1e-6, nchw)]

    def library_gn(x, w, bias, eps, silu):
        # the library's GroupNorm wants weight and bias in x's dtype: the
        # caller, whose parameters are f32, casts them in every call
        y = torch.nn.functional.group_norm(x, 32, w.to(x.dtype), bias.to(x.dtype), eps)
        return torch.nn.functional.silu(y) if silu else y

    def add_row(totals, row, calls):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_us"):
            totals[key] += calls * row[key]
        totals["bound_ms_by"][row["bound_by"]] += calls * row["bound_ms"]
        if calls:
            totals["err"] = max(totals["err"], row["max_abs_err"])

    def k3_case(c, hw, dname, silu, eps, layout, calls, on_path=True, n=B):
        """One K3 row at batch ``n``: every kernel that takes the call checked against the
        plain version (two runs bit for bit) and timed.  ``calls`` is printed
        with the row, which is returned.  Off the path a slower dispatch is
        logged, not failed."""
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        side = int(hw ** 0.5)
        x = (torch.randn(n, c, side, side, generator=g, device=dev) * 2 + 0.5).to(
            dtype=dtype, memory_format=layout)
        w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        ref = group_norm_silu_reference(x, w, bias, 32, eps, silu)
        names = list(gn_kernels_for(c, hw, 32, layout == cl))
        planned = gn_plan(c, hw, 32, x.element_size(), layout == cl, n)
        chosen = planned["kernel"]
        # f32: summation order only.  bf16: the two round f32 values that
        # differ in the last f32 bits, so they may land one bf16 step
        # (at most 2^-7 of the value) apart
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        errs = {}
        for name in names:
            y = group_norm_silu(x, w, bias, 32, eps, silu, kernel=name)
            again = group_norm_silu(x, w, bias, 32, eps, silu, kernel=name)
            torch.cuda.synchronize()
            diff = (y.float() - ref.float()).abs_()
            errs[name] = diff.max().item()
            check(bool((diff <= tol * ref.float().abs() + 1e-4).all())
                  and bool(torch.isfinite(y).all()) and torch.equal(y, again)
                  and y.is_contiguous(memory_format=layout),
                  f"K3[{name}] {dname} silu={silu} eps={eps} {layout} b{n} C={c} HW={hw}")
            del y, again, diff
        by_kernel = {name: [] for name in names}
        for name in names + names[::-1]:
            by_kernel[name].append(time_ms(
                lambda: group_norm_silu(x, w, bias, 32, eps, silu, kernel=name), 20))
        ms = sum(by_kernel[chosen]) / len(by_kernel[chosen])
        plain_ms = time_ms(lambda: group_norm_silu_reference(x, w, bias, 32, eps, silu), 3)
        library_ms = time_ms(lambda: library_gn(x, w, bias, eps, silu), 10)
        host = host_us(lambda: group_norm_silu(x, w, bias, 32, eps, silu), 200)
        bound_t, bound_by = roofline.bound_ms(
            *roofline.group_norm_work(n, c, hw, x.element_size(), silu),
            peak_flops=roofline.PEAK_F32_FLOPS)
        row = dict(
            b=n, c=c, hw=hw, dtype=dname, silu=silu, eps=eps,
            layout="NHWC" if layout == cl else "NCHW", calls=calls, kernel=chosen,
            cluster=planned.get("cluster"),
            max_abs_err=errs[chosen], ms=ms, ms_by_kernel=by_kernel, plain_ms=plain_ms,
            bound_ms=bound_t, bound_by=bound_by, library_ms=library_ms, host_us=host,
            host_bound=ms <= 1.2 * host / 1e3)
        log("K3", json.dumps(row))
        what = (f"K3 dispatch b{n} {dname} silu={silu} {layout} C={c} HW={hw}: {chosen} is not "
                f"the slower kernel")
        if on_path or not_the_slower(by_kernel, chosen, ms, host):
            check(not_the_slower(by_kernel, chosen, ms, host), what)
        else:
            log("NOTE (off the path, not a failure): not so: " + what)
        return row

    for c, hw in pairs:
        for dname, silu, eps, layout in variants:
            calls = GN_CALLS.get((c, hw, dname, silu, eps), 0) if layout == cl else 0
            add_row(k3, k3_case(c, hw, dname, silu, eps, layout, calls), calls)
    log(f"K3 per b{B} UNet forward ({GN_PER_FORWARD} calls): " + json.dumps(k3))
    # the CFG-doubled batch of a 16-image text-to-image request: the UNet's 19
    # GroupNorm calls on 32 samples, where the plan spreads a sample over fewer
    # CTAs (the row has the cluster)
    for (c, hw, dname, silu, eps), calls in GN_CALLS.items():
        add_row(k3_cfg, k3_case(c, hw, dname, silu, eps, cl, calls, n=2 * B), calls)
    log(f"K3 per b{2 * B} UNet forward ({GN_PER_FORWARD} calls): " + json.dumps(k3_cfg))
    # the VAE's GroupNorms at 512x512: f32, eps 1e-6, contiguous NCHW on the
    # path (phase 8 checks that), channels-last checked and timed beside it
    k3_vae = {name: new_totals() for name in ("decode", "encode")}
    for c, hw in sorted({(c, hw) for c, hw, _ in list(VAE_DECODE_GN) + list(VAE_ENCODE_GN)}):
        for silu in (True, False):
            for layout in (nchw, cl):
                on_path = layout == nchw
                calls = {name: table.get((c, hw, silu), 0) if on_path else 0
                         for name, table in (("decode", VAE_DECODE_GN), ("encode", VAE_ENCODE_GN))}
                row = k3_case(c, hw, "f32", silu, 1e-6, layout, calls, on_path=on_path)
                for name in calls:
                    add_row(k3_vae[name], row, calls[name])
                torch.cuda.empty_cache()
    log(f"K3 per b{B} VAE decode at {T2I_SIZE}x{T2I_SIZE} ({GN_PER_DECODE} calls): "
        + json.dumps(k3_vae["decode"]))
    log(f"K3 per b{B} VAE encode at {T2I_SIZE}x{T2I_SIZE} ({GN_PER_ENCODE} calls): "
        + json.dumps(k3_vae["encode"]))
    # the same decoder at 256x256 on 32 samples: DiT's request (phase 11)
    k3_dit = new_totals()
    for (c, hw, silu), calls in DIT_DECODE_GN.items():
        add_row(k3_dit, k3_case(c, hw, "f32", silu, 1e-6, nchw, calls, n=DIT_B), calls)
        torch.cuda.empty_cache()
    log(f"K3 per b{DIT_B} VAE decode at 256x256 ({GN_PER_DECODE} calls): " + json.dumps(k3_dit))
    # and at 1024x1024 on SD3_B samples: the 16-channel VAE's decode (phase 13)
    k3_sd3 = new_totals()
    for (c, hw, silu), calls in SD3_DECODE_GN.items():
        add_row(k3_sd3, k3_case(c, hw, "f32", silu, 1e-6, nchw, calls, n=SD3_B), calls)
        torch.cuda.empty_cache()
    log(f"K3 per b{SD3_B} VAE decode at 1024x1024 ({GN_PER_DECODE} calls): "
        + json.dumps(k3_sd3))
    # how the rows kernel's time depends on the CTAs a sample is spread over
    # (the plan aims at 64 in all), beside what the card's memory system gives a
    # plain copy (one read, one write) and a plain sum (one read) of the same x
    x = torch.randn(B, 320, 64, 64, generator=g, device=dev).to(
        dtype=torch.bfloat16, memory_format=cl)
    w, bias = torch.ones(320, device=dev), torch.zeros(320, device=dev)
    planned = gn_plan(320, 4096, 32, 2, True, B)
    by_cluster = {}
    for n_eff in (B * 8, B * 4, B * 2, B, B // 2):  # the plan's cluster for this many samples
        cluster = gn_plan(320, 4096, 32, 2, True, n_eff)["cluster"]
        with forced_plan(groupnorm_module, dict(planned, cluster=cluster)):
            by_cluster[cluster] = time_ms(lambda: group_norm_silu(x, w, bias, 32, 1e-5, True), 20)
    log("K3 rows kernel, b16 (320, 4096) bf16 SiLU, ms by CTAs per sample: "
        + json.dumps(by_cluster) + f"; planned {planned['cluster']}; x.clone() "
        f"{time_ms(lambda: x.clone(), 20):.4f} ms, x.sum() {time_ms(lambda: x.sum(), 20):.4f} ms")
    # the same on the 32 samples of a CFG-doubled call (checked above as planned)
    x = torch.cat([x, x])
    planned = gn_plan(320, 4096, 32, 2, True, 2 * B)
    by_cluster = {}
    for cluster in (8, 4, 2, 1):
        with forced_plan(groupnorm_module, dict(planned, cluster=cluster)):
            by_cluster[cluster] = time_ms(lambda: group_norm_silu(x, w, bias, 32, 1e-5, True), 20)
    log(f"K3 rows kernel, b{2 * B} (320, 4096) bf16 SiLU, ms by CTAs per sample: "
        + json.dumps(by_cluster) + f"; planned {planned['cluster']}")
    del x
    torch.cuda.empty_cache()

    # ---- 4. the full-width UNet: kernels vs plain vs f32 -------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ref_model = SDUNetModel(**SD15, device=dev).eval()
    init_random_(ref_model, gen(SEED + 1))
    model = SDUNetModel(**SD15, torso_dtype=torch.bfloat16, device=dev).eval()
    model.load_state_dict(ref_model.state_dict())
    log(f"SD1.5 UNet: {sum(p.numel() for p in model.parameters())} params, bf16 torso")

    def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
        return ((a.float() - ref).norm() / ref.norm()).item()

    g = gen(SEED + 2)
    x = torch.randn(UNET_CHECK_BATCH, 4, 64, 64, generator=g, device=dev)
    ts = torch.tensor([999, 421], device=dev)[:UNET_CHECK_BATCH]
    ctx = torch.randn(UNET_CHECK_BATCH, 77, 768, generator=g, device=dev)
    with torch.no_grad():
        with plain_ops():
            want = ref_model(x, ts, ctx)
        flash_attention_fwd.launches = group_norm_silu.launches = 0
        got_k = model(x, ts, ctx)
        torch.cuda.synchronize()
        launches = (flash_attention_fwd.launches, group_norm_silu.launches)
        with plain_ops():
            got_p = model(x, ts, ctx)
    err_k, err_p = rel_err(got_k, want), rel_err(got_p, want)
    log(f"UNet b{UNET_CHECK_BATCH} forward: rel L2 err vs f32 plain: kernels {err_k:.3e}, "
        f"plain bf16 {err_p:.3e}; max abs: kernels "
        f"{(got_k.float() - want).abs().max().item():.3e}, plain "
        f"{(got_p.float() - want).abs().max().item():.3e}; launches {launches}")
    check(err_k <= 1.5 * err_p + 1e-3 and bool(torch.isfinite(got_k).all()),
          "UNet forward: err(kernels) <= 1.5 err(plain) + 1e-3")
    check(launches == (ATTN_PER_FORWARD, GN_PER_FORWARD),
          f"UNet forward launches {launches} == ({ATTN_PER_FORWARD}, {GN_PER_FORWARD})")
    del want, got_k, got_p

    g = gen(SEED + 5)
    x = torch.randn(B, 4, 64, 64, generator=g, device=dev)
    ts = torch.full((B,), 501, device=dev)
    ctx = torch.randn(B, 77, 768, generator=g, device=dev)

    def forward():
        return model(x, ts, ctx)

    def plain_forward():
        with plain_ops():
            return model(x, ts, ctx)

    with torch.no_grad():
        fwd_ms = {"plain": [], "kernels": []}
        for name in ("plain", "kernels", "kernels", "plain"):
            fn = forward if name == "kernels" else plain_forward
            fwd_ms[name].append(time_ms(fn, UNET_TIMED_FORWARDS))
        torch.cuda.empty_cache()
        profile = profile_by_class(forward, UNET_PROFILED_FORWARDS)
    log(f"UNet b{B} forward ms (CUDA events, {UNET_TIMED_FORWARDS} forwards, order plain, "
        f"kernels, kernels, plain; {card}): kernels {fwd_ms['kernels']}, "
        f"plain {fwd_ms['plain']}")
    log(f"UNet b{B} forward device time by class, kernel path (torch.profiler, ms per "
        f"forward over {UNET_PROFILED_FORWARDS}; wall {profile['wall_ms']:.3f} ms per forward "
        f"under the profiler): " + json.dumps(profile["classes"]))
    for name, ms in profile["top"]:
        log(f"  {ms:9.4f} ms  {name}")
    check(profile["classes"]["K1 attention"] > 0 and profile["classes"]["K3 GroupNorm"] > 0,
          "profile: the kernel path's forward ran K1 and K3 on the card")
    del x, ctx

    # ---- 5. requests ----------------------------------------------------------
    sampler = DDIM(total_steps=1000, respace_type="uniform", respace_steps=STEPS)
    g = gen(SEED + 3)
    ctx = torch.randn(B, 77, 768, generator=g, device=dev)
    noise = torch.randn(B, 4, 64, 64, generator=g, device=dev)

    def unet(xx, tt, **kw):
        return model(xx, tt, ctx)

    with torch.no_grad():
        sampler.sample(unet, noise)  # warm-up
        torch.cuda.synchronize()
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)
        t0 = time.perf_counter()
        out = sampler.sample(unet, noise)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    main_launches = {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                     "K3": group_norm_silu.launches}
    k1_by_kernel = dict(flash_attention_fwd.launches_by_kernel)
    sps = B / seconds
    log(f"DDIM-{STEPS} b{B} 64x64x4: {seconds:.3f} s, {sps:.4f} samples/s ({card}); "
        f"launches {main_launches}")
    check(tuple(out.shape) == (B, 4, 64, 64) and bool(torch.isfinite(out).all()),
          "DDIM-50 output finite, [16, 4, 64, 64]")
    check(main_launches == {"K1": STEPS * ATTN_PER_FORWARD, "K2": 0,
                            "K3": STEPS * GN_PER_FORWARD},
          f"DDIM-50 launches == {STEPS} x ({ATTN_PER_FORWARD}, 0, {GN_PER_FORWARD})")
    # the gate sends every one of a forward's 32 calls to the wgmma kernel
    wgmma_calls = sum(n for (sq, sk, d), n in ATTN_CALLS.items()
                      if select_kernel(d) == "wgmma")
    check(k1_by_kernel == {"wgmma": STEPS * wgmma_calls,
                           "mma": STEPS * (ATTN_PER_FORWARD - wgmma_calls)} and wgmma_calls > 0,
          f"DDIM-50 K1 launches by kernel {k1_by_kernel}: {wgmma_calls} of "
          f"{ATTN_PER_FORWARD} per forward through wgmma")

    cfg = DDIMCFG(CFG_SCALE, "context", total_steps=1000, respace_type="uniform",
                  respace_steps=STEPS)
    g = gen(SEED + 4)
    cond = torch.randn(CFG_BATCH, 77, 768, generator=g, device=dev)
    uncond = torch.randn(1, 77, 768, generator=g, device=dev).expand(CFG_BATCH, -1, -1)
    noise = torch.randn(CFG_BATCH, 4, 64, 64, generator=g, device=dev)

    def run_cfg(m):
        return cfg.sample(lambda xx, tt, context: m(xx, tt, context), noise,
                          uncond_conditioning=uncond.contiguous(),
                          model_kwargs={"context": cond}, num_steps=CFG_STEPS)

    def guided_eps(m):
        """The first step's guided noise prediction: one call on the doubled
        batch, uncond + s (cond - uncond), as DDIMCFG combines them."""
        t0 = int(cfg.sampler_tape()["t"][0])
        out = m(torch.cat([noise, noise]), torch.full((2 * CFG_BATCH,), t0, device=dev),
                torch.cat([cond, uncond]))
        eps_c, eps_u = out.float().chunk(2)
        return eps_u + CFG_SCALE * (eps_c - eps_u)

    with torch.no_grad():
        flash_attention_fwd.launches = group_norm_silu.launches = 0
        out_k = run_cfg(model)
        torch.cuda.synchronize()
        cfg_launches = (flash_attention_fwd.launches, group_norm_silu.launches)
        eps_k = guided_eps(model)
        with plain_ops():
            out_p, eps_p = run_cfg(model), guided_eps(model)
            out_f, eps_f = run_cfg(ref_model), guided_eps(ref_model)
    err_k, err_p = rel_err(eps_k, eps_f), rel_err(eps_p, eps_f)
    log(f"DDIMCFG s={CFG_SCALE} b{CFG_BATCH} first-step guided eps: rel L2 err vs f32 plain: "
        f"kernels {err_k:.3e}, plain bf16 {err_p:.3e}")
    check(bool(torch.isfinite(eps_k).all()) and err_k <= 1.5 * err_p,
          "DDIMCFG guided eps: finite, err(kernels) <= 1.5 err(plain)")
    err_k, err_p = rel_err(out_k, out_f), rel_err(out_p, out_f)
    log(f"DDIMCFG s={CFG_SCALE} b{CFG_BATCH} {CFG_STEPS} steps: rel L2 err vs f32 plain: "
        f"kernels {err_k:.3e}, plain bf16 {err_p:.3e}; launches {cfg_launches}")
    check(bool(torch.isfinite(out_k).all()) and err_k <= 1.5 * err_p,
          "DDIMCFG sample: finite, err(kernels) <= 1.5 err(plain)")
    check(cfg_launches == (CFG_STEPS * ATTN_PER_FORWARD, CFG_STEPS * GN_PER_FORWARD),
          f"DDIMCFG launches == {CFG_STEPS} x ({ATTN_PER_FORWARD}, {GN_PER_FORWARD})")
    del model, out, out_k, out_p, out_f
    torch.cuda.empty_cache()

    # ---- 6. K2 --------------------------------------------------------------
    phase_seconds["1-5"] = time.perf_counter() - started
    k2 = run_phase("6", phase_k2, dev, check, time_ms, host_us, gen)
    k2_by_kernel = k2.pop("by_kernel")

    # ---- 7. training -----------------------------------------------------------
    train = run_phase("7", phase_train, dev, check, gen, ref_model, card)

    # ---- 8. text to image --------------------------------------------------------
    t2i = run_phase("8", phase_text_to_image, dev, check, gen, ref_model, card, time_ms)

    # ---- 9. the fine-tuning CLI ----------------------------------------------------
    ft = run_phase("9", phase_finetune_cli, dev, check, gen, ref_model, card)

    # ---- 10. the serving accelerators ----------------------------------------------
    sd = t2i.pop("sd")
    serve = run_phase("10", phase_serving, dev, check, sd, ref_model, card)

    # ---- 11. DiT-XL/2 and MDTv2-XL/2 through sample_cfg -------------------------------
    # the SD1.5 stack and its f32 UNet wait on the host for phase 22
    sd.to("cpu")
    ref_model.to("cpu")
    torch.cuda.empty_cache()
    dit = run_phase("11", phase_dit, dev, check, gen, card, time_ms, host_us)

    # ---- 12. DiT-XL/2 training and train_ddpm_cfg ------------------------------------
    torch.cuda.empty_cache()
    dit_train = run_phase("12", phase_dit_train, dev, check, gen, card, time_ms, host_us)

    # ---- 13. MMDiT through sample_mmdit: SD3-medium and bench's MMDiT-B/2 -----------
    torch.cuda.empty_cache()
    mmdit = run_phase("13", phase_mmdit, dev, check, gen, card, time_ms, host_us)

    # ---- 14. MMDiT training: bench's MMDiT-B/2, SD3-medium through train_mmdit ------
    torch.cuda.empty_cache()
    mmdit_train = run_phase("14", phase_mmdit_train, dev, check, gen, card, time_ms,
                            host_us)

    # ---- 15. SDXL-base text to image through the SDXL page's logic --------------------
    torch.cuda.empty_cache()
    sdxl = run_phase("15", phase_sdxl, dev, check, gen, card, time_ms, host_us, k3_case,
                     add_row, new_totals)

    # ---- 16. pixel-space sampling through sample_uncond: ADM-256, the CIFAR UNets ------
    torch.cuda.empty_cache()
    pixel = run_phase("16", phase_pixel, dev, check, gen, card, time_ms, host_us, k3_case,
                      add_row, new_totals)

    # ---- 17. pixel-space training through train_ddpm and train_ddpm_cfg ----------------
    torch.cuda.empty_cache()
    pixel_train = run_phase("17", phase_pixel_train, dev, check, gen, card, time_ms, host_us)

    # ---- 18. guidance and editing: SDEdit, mask guidance, ILVR, DDIB, CLIP guidance -----
    torch.cuda.empty_cache()
    guidance = run_phase("18", phase_guidance, dev, check, gen, card, time_ms, host_us,
                         new_totals, k3_case, add_row)

    # ---- 19. CelebA-HQ training through K2 at d=512; T5 and encode_prompts ------------
    torch.cuda.empty_cache()
    celebahq = run_phase("19", phase_celebahq_t5, dev, check, gen, card, time_ms, host_us)

    # ---- 20. FID / IS / KID: accept on the CIFAR UNet, evaluate -----------------------
    torch.cuda.empty_cache()
    evals = run_phase("20", phase_eval, dev, check, gen, card, time_ms)

    # ---- 21. remat policies, LoRA under remat, a schedule, DP, the ring fold -------
    torch.cuda.empty_cache()
    remat_parallel = run_phase("21", phase_remat_parallel, dev, check, gen, card, time_ms)

    # ---- 22. the UIs: the web UI over HTTP, page 3's logic on the SD1.5 stack ---------
    torch.cuda.empty_cache()
    ui = run_phase("22", phase_ui, dev, check, card, sd, ref_model)
    del sd, ref_model
    log("phase seconds: " + json.dumps(phase_seconds))
    check("jax" not in sys.modules, "no JAX imported")

    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed: {failures}")
        # and on standard error, whose end is what a caller may keep of a run
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr,
              flush=True)
        return 1
    by_path = {name: {"ddim50": main_launches[name],
                      f"train{TRAIN_TIMED_STEPS}": train["launches"][name],
                      f"txt2img{T2I_STEPS}": t2i["launches"][name],
                      **{path: counted[name] for path, counted in ft["launches"].items()},
                      **{f"serve_{path}": counted[name]
                         for path, counted in serve["launches"].items()},
                      **{path: counted[name] for path, counted in dit["launches"].items()},
                      **{path: counted[name] for path, counted in dit_train["launches"].items()},
                      **{path: counted[name] for path, counted in mmdit["launches"].items()},
                      **{path: counted[name]
                         for path, counted in mmdit_train["launches"].items()},
                      **{path: counted[name] for path, counted in sdxl["launches"].items()},
                      **{path: counted[name] for path, counted in pixel["launches"].items()},
                      **{path: counted[name]
                         for path, counted in pixel_train["launches"].items()},
                      **{path: counted[name] for path, counted in guidance["launches"].items()},
                      **{path: counted[name] for path, counted in celebahq["launches"].items()},
                      **{path: counted[name] for path, counted in evals["launches"].items()},
                      **{path: counted[name]
                         for path, counted in remat_parallel["launches"].items()},
                      **{path: counted[name] for path, counted in ui["launches"].items()}}
               for name in ("K1", "K2", "K3")}
    def entry(name, source, replaces, launches, per, r):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[0], "launches_by_path": launches[1],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                # what bounds the larger share of the summed bound
                "bound_by": max(r["bound_ms_by"], key=r["bound_ms_by"].get),
                "bound_ms_by": r["bound_ms_by"],
                "library_ms": r["library_ms"], "host_us": r["host_us"], "timing": per}

    k2["err"] = k2.pop("max_abs_err")
    log(json.dumps({"kernels": [
        dict(entry("flash_attn_fwd", "dmtpu_torch/csrc/flash_attn_fwd.cu",
                   "dmtpu/ops/flash_small_d.py:50", (main_launches["K1"], by_path["K1"]),
                   f"per b{B} UNet forward: sum over its {ATTN_PER_FORWARD} attention calls", k1),
             other_sources=["dmtpu_torch/csrc/flash_attn_fwd_mma.cu",
                            "dmtpu_torch/csrc/hopper.cuh"],
             launches_by_kernel=k1_by_kernel,
             # the same columns at the CFG-doubled batch of the text-to-image
             # request: summed over the 32 calls of one UNet call on 32 samples
             cfg_b32=k1_cfg,
             # and over the 5 merged self-attentions of a UNet call on 32
             # samples under ToMe at ratios 0.5 and 0.3
             tome_b32=k1_tome,
             # and over the 28 self-attentions (d=72) of one DiT-XL/2 call on
             # the 64 samples of a 32-image CFG request
             dit_b64=dit["k1_per_forward"],
             # and over the joint attentions (d=64) of one CFG-doubled MMDiT
             # call: SD3-medium's 24 on 4 samples, MMDiT-B/2's 12 on 64
             **mmdit["k1_per_forward"],
             # and over those of one train step: MMDiT-B/2's 12 at b128, and
             # SD3-medium's 48 at b32 (forward and remat recompute)
             **mmdit_train["k1_per_step"],
             # and over the 140 (d=64) of one SDXL UNet call on the 2 samples
             # of a one-image CFG request
             sdxl_b2=sdxl["k1_per_call"],
             # and over the attentions of one pixel-space UNet call: ADM-256's
             # 16 (d=64) at b16, the CIFAR UNet's 6 (d=256) at b500, the AdaGN
             # UNet's 11 (d=64 and d=256) on the 20 samples of a CFG batch
             **pixel["k1_per_call"],
             # and over the 6 (d=512) of one CelebA-HQ UNet call at b16
             **guidance["k1_per_call"]),
        dict(entry("flash_attn_bwd", "dmtpu_torch/csrc/flash_attn_bwd.cu",
                   "dmtpu/ops/flash_small_d.py:118", (train["launches"]["K2"], by_path["K2"]),
                   f"per b{B} train step: sum over its {ATTN_PER_FORWARD} attention backwards",
                   k2),
             other_sources=["dmtpu_torch/csrc/flash_attn_bwd_mma.cu",
                            "dmtpu_torch/csrc/hopper.cuh"],
             launches_by_kernel=train["k2_by_kernel"], ms_by_kernel=k2_by_kernel,
             # the same columns over the 28 attention backwards (d=72, the
             # wgmma instance) of one DiT-XL/2 b32 train step, and their
             # launches by kernel in the 10 timed steps
             dit_train_b32=dit_train["k2_per_step"],
             dit_train_launches_by_kernel=dit_train["k2_by_kernel"],
             # and over the joint attention backwards (d=64) of one MMDiT
             # train step: MMDiT-B/2's 12 at b128, SD3-medium's 24 at b32
             **mmdit_train["k2_per_step"],
             # and over the 6 (d=256, wgmma) of one CIFAR UNet b128 step
             **pixel_train["k2_per_step"],
             # and over the 6 (d=512, mma.sync) of one CelebA-HQ UNet b16 step
             **celebahq["k2_per_step"]),
        dict(entry("group_norm_silu", "dmtpu_torch/csrc/group_norm_silu.cu",
                   "dmtpu/ops/groupnorm.py:44", (main_launches["K3"], by_path["K3"]),
                   f"per b{B} UNet forward: sum over its {GN_PER_FORWARD} GroupNorm calls", k3),
             # the same columns summed over the GroupNorm calls of one b16 VAE
             # decode (30) and encode (22) at 512x512, f32
             vae_decode=k3_vae["decode"], vae_encode=k3_vae["encode"],
             # and over the 61 calls of one UNet call on 32 samples
             cfg_b32=k3_cfg,
             # and over the 30 calls of one b32 VAE decode at 256x256 (DiT's)
             dit_vae_decode_b32=k3_dit,
             # and of one b2 decode at 1024x1024 (SD3-medium's 16-channel VAE)
             sd3_vae_decode_b2=k3_sd3,
             # and over the 46 calls of one SDXL UNet call on 2 samples, and
             # the 30 of one b1 SD VAE decode at 1024x1024
             sdxl_unet_b2=sdxl["k3_unet"], sdxl_vae_decode_b1=sdxl["k3_vae"],
             # and over the GroupNorms of one ADM-256 call at b16, one CIFAR
             # UNet call at b500 and one AdaGN UNet call on the 20 samples of
             # a CFG batch
             **pixel["k3_per_call"],
             # and over the 71 of one CelebA-HQ UNet call at b16
             **guidance["k3_per_call"]),
        # K1 at head dim 256 (the pixel UNets' one head as wide as the
        # channels), the wgmma kernel's d=256 instance since it took the shape
        # over from the mma.sync kernel's: its launches in the CIFAR UNet's
        # DDIM-50 request at b500 (by kernel beside), its columns over the 6
        # calls of one UNet call there (phase 16), and phase 2's sums
        dict(entry("flash_attn_fwd_wgmma_d256", "dmtpu_torch/csrc/flash_attn_fwd.cu",
                   "dmtpu/ops/flash_small_d.py:50",
                   (pixel["d256_launches"], pixel["d256_by_path"]),
                   f"per b{CIFAR_B} CIFAR UNet call: sum over its 6 attention calls at d=256",
                   pixel["k1_per_call"]["cifar_b500"]),
             other_sources=["dmtpu_torch/csrc/flash_attn_fwd_mma.cu",
                            "dmtpu_torch/csrc/hopper.cuh"],
             launches_by_kernel=pixel["metrics"][f"cifar_ddim{CIFAR_STEPS}_b{CIFAR_B}"][
                 "k1_by_kernel"],
             phase2=k1_d256),
        # K2 at head dim 256, the wgmma kernel's column-split instance since it
        # took the shape over from the mma.sync kernel's: its launches in the
        # CIFAR UNet's timed b128 train steps, its columns over the 6 calls of
        # one step there, and the mma.sync instance's time over the same calls
        dict(entry("flash_attn_bwd_wgmma_d256", "dmtpu_torch/csrc/flash_attn_bwd.cu",
                   "dmtpu/ops/flash_small_d.py:118",
                   (pixel_train["d256_launches"], pixel_train["d256_by_path"]),
                   f"per b{pixel_train['metrics']['train_b128']['batch']} CIFAR UNet train "
                   "step: sum over its 6 attention backwards at d=256",
                   pixel_train["k2_per_step"]["cifar_train_b128"]),
             other_sources=["dmtpu_torch/csrc/flash_attn_bwd_mma.cu",
                            "dmtpu_torch/csrc/hopper.cuh"],
             mma_sync={"ms": pixel_train["k2_mma_per_step"]}),
        # K2 at head dim 160 (SD1.5's 16x16 and 8x8 levels), the wgmma
        # kernel's column-split instance: its launches in the 10 timed b16
        # train steps, its columns over the 12 calls of one step (phase 6),
        # phase 6's rows, and the mma.sync instance's time over the same calls
        dict(entry("flash_attn_bwd_wgmma_d160", "dmtpu_torch/csrc/flash_attn_bwd.cu",
                   "dmtpu/ops/flash_small_d.py:118",
                   (train["k2_d160_launches"], {"train_b16": train["k2_d160_launches"]}),
                   f"per b{B} SD1.5 train step: sum over its 12 attention backwards at d=160",
                   k2["d160"]),
             other_sources=["dmtpu_torch/csrc/flash_attn_bwd_mma.cu",
                            "dmtpu_torch/csrc/hopper.cuh"],
             rows=k2["rows160"], mma_sync={"ms": k2["d160"]["mma_ms"]}),
        # K1 at head dim 512 (CelebA-HQ's one head as wide as its channels),
        # the wgmma kernel's instance since it took the shape over from the
        # mma.sync kernel's (O's columns split over its two consumer
        # warpgroups): its launches in the CelebA-HQ UNet's DDIM-50 request at
        # b16, its columns over the 6 calls of one UNet call there, and the
        # mma.sync instance's time over the same calls
        dict(entry("flash_attn_fwd_wgmma_d512", "dmtpu_torch/csrc/flash_attn_fwd.cu",
                   "dmtpu/ops/flash_small_d.py:50",
                   (guidance["d512_launches"], guidance["d512_by_path"]),
                   f"per b{CELEBAHQ_B} CelebA-HQ UNet call: sum over its 6 attention calls at "
                   "d=512", guidance["k1_per_call"][f"celebahq_b{CELEBAHQ_B}"]),
             other_sources=["dmtpu_torch/csrc/flash_attn_fwd_mma_d512.cu",
                            "dmtpu_torch/csrc/hopper.cuh"],
             mma_sync={"ms": guidance["k1_mma_per_call"]}),
        # K2's mma.sync instance at head dim 512 (dK, dV and dQ's columns
        # split over two CTAs): its launches in the CelebA-HQ UNet's 10 timed
        # b16 train steps, its columns over the 6 calls of one step there
        entry("flash_attn_bwd_mma_d512", "dmtpu_torch/csrc/flash_attn_bwd_mma_d512.cu",
              "dmtpu/ops/flash_small_d.py:118",
              (celebahq["d512_launches"], celebahq["d512_by_path"]),
              f"per b{CELEBAHQ_TRAIN_B} CelebA-HQ UNet train step: sum over its 6 attention "
              "backwards at d=512", celebahq["k2_per_step"][f"celebahq_train_b{CELEBAHQ_TRAIN_B}"]),
    ], "ddim50_b16_samples_per_s": sps, "unet_b16_forward_ms": fwd_ms,
        "train_b16": train["metrics"], "txt2img_b16": t2i["metrics"],
        "finetune_cli_b8": ft["metrics"], "serving_b16": serve["metrics"],
        "dit_b32": dit["metrics"], "dit_train_b32": dit_train["metrics"],
        "mmdit": mmdit["metrics"], "mmdit_train": mmdit_train["metrics"],
        "sdxl": sdxl["metrics"], "pixel": pixel["metrics"],
        "pixel_train": pixel_train["metrics"], "guidance": guidance["metrics"],
        "celebahq_t5": celebahq["metrics"], "eval": evals["metrics"],
        "remat_parallel": remat_parallel["metrics"], "ui": ui["metrics"],
        "phase_seconds": phase_seconds, "card": card}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def wgmma_fwd_instances(lib_path, lib) -> list:
    """Each instance of K1's wgmma kernel (head dim, keys a K/V tile) as ptxas
    reported it in ``build.log`` beside the library (registers at launch,
    spill stores and loads) and its dynamic shared memory, from the library's
    ``dmtpu_flash_attn_fwd_smem`` (a call of 77 keys for the 80-key tile)."""
    log_lines = (lib_path.parent / "build.log").read_text().splitlines()
    found = []
    for i, line in enumerate(log_lines):
        inst = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)E", line)
        if not (inst and "Compiling entry" in line):
            continue
        d, keys = int(inst[1]), int(inst[2])
        after = " ".join(log_lines[i + 1:i + 5])
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", after)
        regs = re.search(r"Used (\d+) registers", after)
        found.append({"d": d, "keys": keys, "registers": int(regs[1]),
                      "spill_stores": int(spills[1]), "spill_loads": int(spills[2]),
                      "smem_bytes": lib.dmtpu_flash_attn_fwd_smem(d, 77 if keys == 80 else 4096)})
    return sorted(found, key=lambda x: (x["d"], x["keys"]))


def wgmma_bwd_instances(lib_path, lib) -> list:
    """Each instance of K2's wgmma kernel (head dim, one key tile or not) as
    ptxas reported it in ``build.log`` (registers at launch, spill stores and
    loads) and its dynamic shared memory, from the library's
    ``dmtpu_flash_attn_bwd_smem``."""
    log_lines = (lib_path.parent / "build.log").read_text().splitlines()
    found = []
    for i, line in enumerate(log_lines):
        inst = re.search(r"flash_bwd_(?:wgmma|split)_kernelILi(\d+)ELb([01])E", line)
        if not (inst and "Compiling entry" in line):
            continue
        d = int(inst[1])
        after = " ".join(log_lines[i + 1:i + 5])
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", after)
        regs = re.search(r"Used (\d+) registers", after)
        found.append({"d": d, "one_tile": inst[2] == "1", "registers": int(regs[1]),
                      "spill_stores": int(spills[1]), "spill_loads": int(spills[2]),
                      "smem_bytes": lib.dmtpu_flash_attn_bwd_smem(d)})
    return sorted(found, key=lambda x: (x["d"], x["one_tile"]))


def timed_ms(fn, reps: int) -> tuple:
    """(ms, host ms) per call of ``fn`` over ``reps`` back-to-back calls: the
    card's time between CUDA events around them, and the host's time to issue
    them (no synchronise in between).  Where the first is within 20% of the
    second the card waited for the host's launches, and the time is the
    host's, not the kernel's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def time_by_kernel(call, names: list, reps: int) -> tuple:
    """Each kernel of ``names`` timed by ``timed_ms(lambda: call(name), reps)``
    in the order first, second, second, first: ({name: [ms, ms]}, {name:
    [host ms, host ms]})."""
    by_kernel = {name: [] for name in names}
    host_by_kernel = {name: [] for name in names}
    for name in names + names[::-1]:
        ms, host_ms = timed_ms(lambda: call(name), reps)
        by_kernel[name].append(ms)
        host_by_kernel[name].append(host_ms)
    return by_kernel, host_by_kernel


def not_the_slower(by_kernel: dict, chosen: str, ms: float, host_us: float,
                   host_by_kernel: dict | None = None) -> bool:
    """The dispatched kernel's best time is within 25% of every other
    kernel's best.  Held only where it can be told: a row within the host's
    launch time, or with a time under 0.05 ms (there two timings of one
    kernel differ by half: 0.018 and 0.028 ms in one run), says nothing about
    the kernels and passes.  With ``host_by_kernel`` (the host's time of each
    timed loop, ``time_by_kernel``) the host's launch time is also read off
    the loop of the chosen kernel's best time: ``host_us`` is timed in
    another loop, and at K2's b16 h8 S_q=64 S_k=77 d=160 one run read 59.6
    µs there while the loops took 67-94 µs a call on the card for kernels of
    28 and 53 µs of device time (``k2_probe fresh``)."""
    best = {name: min(times) for name, times in by_kernel.items()}
    if host_by_kernel is not None:
        i = by_kernel[chosen].index(best[chosen])
        if best[chosen] <= 1.2 * host_by_kernel[chosen][i]:
            return True
    if ms <= 1.2 * host_us / 1e3 or min(best.values()) < 0.05:
        return True
    return all(best[chosen] <= 1.25 * t for t in best.values())


def k1_call_row(q, k, v, calls: int, label: str, check, time_ms, host_us, card: str,
                reps: int, slice_b: int = 0, expect: str = "wgmma") -> tuple:
    """K1 at one call of a path, the dispatch expected on ``expect``: every kernel
    that takes the shape checked against the plain ``mha`` and K1's own
    plain version (phase 2's tolerances) and timed (order first, second,
    second, first, ``reps`` calls each), beside the plain version, SDPA, the
    host's time and the bound.  With ``slice_b`` the plain versions run on
    slices of that many samples (their f32 logits of the whole batch would
    not fit), and ``plain_ms`` is the time of all the slices.  Returns (the
    row, its columns times ``calls``: the sums over one forward)."""
    import torch
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.attention import mha
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_reference,
        kernels_for,
        select_kernel,
    )

    n, sq, h, d = q.shape
    sk = k.shape[1]
    step = slice_b or n

    def sliced(fn):
        return [fn(q[i:i + step], k[i:i + step], v[i:i + step]) for i in range(0, n, step)]

    ref_o, ref_lse = (torch.cat(part) for part in zip(*sliced(flash_attention_reference)))
    plain = torch.cat(sliced(mha))
    chosen, names = select_kernel(d), kernels_for(d)
    bound_err = 1e-2 * ref_o.float().abs().max().item()  # as phase 2
    errs = {}
    for name in names:
        o, lse = flash_attention_fwd(q, k, v, kernel=name)
        torch.cuda.synchronize()
        err_ref = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        err_mha = (o.float() - plain.float()).abs().max().item()
        rel_mha = err_mha / plain.float().abs().max().item()
        errs[name] = dict(max_abs_err_vs_mha=err_mha, rel_err_vs_mha=rel_mha,
                          max_abs_err_vs_own_plain=err_ref, lse_max_abs_err=err_lse)
        check(err_ref <= bound_err and err_lse <= 1e-3 and rel_mha <= 3e-2
              and bool(torch.isfinite(o).all()),
              f"K1[{name}] bf16 b{n} h{h} S_q={sq} S_k={sk} d={d}, {label}")
        del o, lse
    by_kernel, host_by_kernel = time_by_kernel(
        lambda name: flash_attention_fwd(q, k, v, kernel=name), names, reps)
    ms = sum(by_kernel[chosen]) / len(by_kernel[chosen])
    del ref_o, ref_lse, plain
    plain_ms = time_ms(lambda: sliced(mha), 1 if slice_b else 3)
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))  # [B, H, S, D] views
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), reps)
    host = host_us(lambda: flash_attention_fwd(q, k, v), 200)
    bound_t, bound_by = roofline.bound_ms(*roofline.attention_fwd_work(n, h, sq, sk, d))
    row = dict(b=n, h=h, sq=sq, sk=sk, d=d, calls=calls, kernel=chosen, **errs[chosen], ms=ms,
               ms_by_kernel=by_kernel, host_ms_by_kernel=host_by_kernel, plain_ms=plain_ms,
               bound_ms=bound_t, bound_by=bound_by, library_ms=library_ms, host_us=host,
               host_bound=ms <= 1.2 * host / 1e3)
    log("K1", json.dumps(row))
    log(f"K1 at {label}: {ms / bound_t:.2f}x its bound, {ms / library_ms:.3f}x SDPA's time "
        f"({card})")
    check(chosen == expect and not_the_slower(by_kernel, chosen, ms, host, host_by_kernel),
          f"K1 dispatch b{n} h{h} S_q={sq} S_k={sk} d={d}: {chosen} ({expect}) is not the "
          "slower kernel")
    per = {key: calls * row[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                             "host_us")}
    per.update(err=errs[chosen]["max_abs_err_vs_mha"], bound_ms_by={bound_by: per["bound_ms"]})
    return row, per

def k2_call_row(q, k, v, do, calls: int, label: str, check, time_ms, host_us, card: str,
                reps: int, slice_b: int = 0, expect: str = "wgmma") -> tuple:
    """K2 at one call of a path, the dispatch expected on ``expect``, from K1's
    outputs and the given dO: every kernel that takes the shape checked
    against K2's plain version and against f32 autograd through ``mha``
    (phase 6's tolerances) and timed (order first, second, second, first,
    ``reps`` calls each), beside the plain version, SDPA's backward (forward
    and backward of one call less its forward alone), the host's time and the
    bound.  With ``slice_b`` the plain versions and autograd run on slices of
    that many samples, and ``plain_ms`` is the time of all the slices.
    Returns (the row, its columns times ``calls``: the sums over one step)."""
    import torch
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.attention import mha
    from dmtpu_torch.ops.flash_attention import (
        bwd_kernels_for,
        flash_attention_backward_reference,
        flash_attention_bwd,
        flash_attention_fwd,
        select_bwd_kernel,
    )

    def rel(a, ref) -> float:
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    n, sq, h, d = q.shape
    sk = k.shape[1]
    step = slice_b or n
    parts = range(0, n, step)
    o, lse = flash_attention_fwd(q, k, v)

    def plain_parts():
        return [flash_attention_backward_reference(q[i:i + step], k[i:i + step], v[i:i + step],
                                                   o[i:i + step], lse[i:i + step],
                                                   do[i:i + step]) for i in parts]

    plain = [torch.cat(x) for x in zip(*plain_parts())]
    f32 = []
    for i in parts:
        leaves = [x[i:i + step].float().requires_grad_() for x in (q, k, v)]
        mha(*leaves).backward(do[i:i + step].float())
        f32.append([leaf.grad for leaf in leaves])
    f32 = [torch.cat(x) for x in zip(*f32)]
    names, chosen = bwd_kernels_for(d), select_bwd_kernel(d)
    errs = {}
    for name in names:
        got = flash_attention_bwd(q, k, v, o, lse, do, kernel=name)
        torch.cuda.synchronize()
        ok = all(bool(torch.isfinite(x).all()) and x.dtype == torch.bfloat16 for x in got)
        errs[name] = {}
        # phase 6's tolerances (see there)
        for grad, a, want, ref in zip(("dq", "dk", "dv"), got, plain, f32):
            a, want = a.float(), want.float()
            err = (a - want).abs().max().item()
            errs[name].update({f"{grad}_max_abs_err": err, f"{grad}_rel_l2": rel(a, want),
                               f"{grad}_rel_l2_vs_f32_mha": rel(a, ref)})
            ok = ok and err <= 1e-2 * want.abs().max().item() and rel(a, want) <= 1e-2 and \
                rel(a, ref) <= 2e-2 and \
                (a - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
        check(ok, f"K2[{name}] bf16 b{n} h{h} S={sq} d={d}, {label}: vs plain and vs f32 mha "
                  "autograd")
        del got
    del plain, f32
    torch.cuda.empty_cache()
    ms_by_kernel, host_by_kernel = time_by_kernel(
        lambda name: flash_attention_bwd(q, k, v, o, lse, do, kernel=name), names, reps)
    ms = sum(ms_by_kernel[chosen]) / len(ms_by_kernel[chosen])
    plain_ms = time_ms(plain_parts, 1 if slice_b else 3)
    lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    ldo = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)
        lq.grad = lk.grad = lv.grad = None
        out.backward(ldo)

    def sdpa_fwd():
        with torch.no_grad():
            torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)

    library_ms = time_ms(sdpa_fwd_bwd, reps) - time_ms(sdpa_fwd, reps)
    host = host_us(lambda: flash_attention_bwd(q, k, v, o, lse, do), 100)
    bound_t, bound_by = roofline.bound_ms(*roofline.attention_bwd_work(n, h, sq, sk, d))
    row = dict(b=n, h=h, sq=sq, sk=sk, d=d, calls=calls, kernel=chosen, **errs[chosen], ms=ms,
               ms_by_kernel=ms_by_kernel, host_ms_by_kernel=host_by_kernel,
               plain_ms=plain_ms, bound_ms=bound_t, bound_by=bound_by, library_ms=library_ms,
               host_us=host, host_bound=ms <= 1.2 * host / 1e3)
    log("K2", json.dumps(row))
    best = {name: min(times) for name, times in ms_by_kernel.items()}
    log(f"K2 at {label}: {ms / bound_t:.2f}x its bound, {ms / library_ms:.3f}x SDPA's "
        f"backward, the faster kernel {min(best, key=best.get)} ({card})")
    check(chosen == expect and not_the_slower(ms_by_kernel, chosen, ms, host, host_by_kernel),
          f"K2 dispatch b{n} S={sq} d={d}: {chosen} ({expect}) is not the slower kernel")
    per = {key: calls * row[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                             "host_us")}
    per.update(err=max(errs[chosen][f"{x}_max_abs_err"] for x in ("dq", "dk", "dv")),
               bound_ms_by={bound_by: per["bound_ms"]})
    del o, lse, lq, lk, lv, ldo
    torch.cuda.empty_cache()
    return row, per


@contextlib.contextmanager
def forced_plan(module, how: dict):
    """Within the block, ``module.plan`` answers ``how`` whatever it is asked."""
    real = module.plan
    module.plan = lambda *args: how
    try:
        yield
    finally:
        module.plan = real


def phase_k2(dev, check, time_ms, host_us, gen) -> dict:
    """K2 at every attention shape of the path, b16 h8 bf16, from K1's outputs
    and a random dO: dq, dk and dv of every K2 kernel that takes the shape
    against K2's plain version and against f32 autograd through ``mha`` on the
    same bf16 values; the kernels' times in turns, and the dispatch's choice."""
    import torch
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.attention import mha
    from dmtpu_torch.ops.flash_attention import (
        bwd_kernels_for,
        flash_attention_backward_reference,
        flash_attention_bwd,
        flash_attention_fwd,
        select_bwd_kernel,
        wgmma_bwd_key_tile,
    )

    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, host_us=0.0)
    # the same columns over the 12 calls at d=160 (its column-split instance),
    # and the mma.sync kernel's time at those calls
    d160 = dict(totals, err=0.0, bound_ms_by={"bytes": 0.0, "operations": 0.0}, mma_ms=0.0)
    rows160 = {}
    bound_ms_by = {"bytes": 0.0, "operations": 0.0}
    by_kernel = {"mma": 0.0, "wgmma": 0.0}  # ms per train step through each kernel
    worst = 0.0
    g = gen(SEED + 6)
    for (sq, sk, d), calls in ATTN_CALLS.items():
        q, k, v, do = (torch.randn(B, s, 8, d, generator=g, device=dev).bfloat16()
                       for s in (sq, sk, sk, sq))
        o, lse = flash_attention_fwd(q, k, v)
        names = bwd_kernels_for(d)
        chosen = select_bwd_kernel(d)
        plain = flash_attention_backward_reference(q, k, v, o, lse, do)
        leaves = [x.float().requires_grad_() for x in (q, k, v)]
        mha(*leaves).backward(do.float())
        row = dict(b=B, h=8, sq=sq, sk=sk, d=d, calls=calls, kernel=chosen)
        # both versions round P and dS to bf16, from f32 values that differ in
        # their last bits (exp2 vs exp, summation order, dq's f32 adds in
        # run-to-run order): single elements may land one bf16 step apart, so
        # 1e-2 of max|grad| and 1e-2 relative L2; a skipped or doubled tile
        # moves the L2 error by 1/sqrt(tiles), 12% at S=4096.  Against f32
        # autograd 2e-2: the kernel rounds P, dS and its outputs to bf16
        for kernel in names:
            got = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
            torch.cuda.synchronize()
            ok = all(bool(torch.isfinite(x).all()) and x.dtype == torch.bfloat16 for x in got)
            errs = {}
            for name, a, want, leaf in zip(("dq", "dk", "dv"), got, plain, leaves):
                a, want, f32 = a.float(), want.float(), leaf.grad
                err = (a - want).abs().max().item()
                rel = ((a - want).norm() / want.norm()).item()
                rel_f32 = ((a - f32).norm() / f32.norm()).item()
                errs[f"{name}_max_abs_err"], errs[f"{name}_rel_l2"] = err, rel
                errs[f"{name}_rel_l2_vs_f32_mha"] = rel_f32
                ok = ok and err <= 1e-2 * want.abs().max().item() and rel <= 1e-2 and \
                    rel_f32 <= 2e-2 and \
                    (a - f32).abs().max().item() <= 2e-2 * f32.abs().max().item()
            check(ok, f"K2[{kernel}] bf16 b{B} h8 S_q={sq} S_k={sk} d={d}: vs plain and vs f32 "
                      f"mha autograd")
            if kernel == "wgmma" and sk <= wgmma_bwd_key_tile(d):
                # one key tile: the CTA writes dq itself, with no adds across CTAs
                again = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K2[{kernel}] S_q={sq} S_k={sk} d={d}: two runs agree bit for bit")
                del again
            if kernel == chosen:
                row.update(errs)
                worst = max(worst, *(errs[f"{name}_max_abs_err"] for name in ("dq", "dk", "dv")))
            del got
        del plain, leaves
        torch.cuda.empty_cache()
        ms_by_kernel, row["host_ms_by_kernel"] = time_by_kernel(
            lambda name: flash_attention_bwd(q, k, v, o, lse, do, kernel=name), names, 10)
        row["ms"] = sum(ms_by_kernel[chosen]) / len(ms_by_kernel[chosen])
        row["ms_by_kernel"] = ms_by_kernel
        row["plain_ms"] = time_ms(
            lambda: flash_attention_backward_reference(q, k, v, o, lse, do), 3)
        # the library's backward: forward and backward of one SDPA call on
        # [B, H, S, D] views of the same values, less the forward alone
        lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ldo = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)
            lq.grad = lk.grad = lv.grad = None
            out.backward(ldo)

        def sdpa_fwd():
            with torch.no_grad():
                torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)

        row["library_ms"] = time_ms(sdpa_fwd_bwd, 10) - time_ms(sdpa_fwd, 10)
        row["host_us"] = host_us(lambda: flash_attention_bwd(q, k, v, o, lse, do), 50)
        row["bound_ms"], row["bound_by"] = roofline.bound_ms(
            *roofline.attention_bwd_work(B, 8, sq, sk, d))
        row["host_bound"] = row["ms"] <= 1.2 * row["host_us"] / 1e3
        for key in totals:
            totals[key] += calls * row[key]
        bound_ms_by[row["bound_by"]] += calls * row["bound_ms"]
        by_kernel[chosen] += calls * row["ms"]
        if d == 160:
            for key in totals:
                d160[key] += calls * row[key]
            d160["bound_ms_by"][row["bound_by"]] += calls * row["bound_ms"]
            d160["err"] = max(d160["err"], *(row[f"{x}_max_abs_err"] for x in ("dq", "dk", "dv")))
            d160["mma_ms"] += calls * sum(ms_by_kernel["mma"]) / len(ms_by_kernel["mma"])
            rows160[f"s{sq}_{sk}"] = row
        log("K2", json.dumps(row))
        check(not_the_slower(ms_by_kernel, chosen, row["ms"], row["host_us"],
                             row["host_ms_by_kernel"]),
              f"K2 dispatch S_q={sq} S_k={sk} d={d}: {chosen} is not the slower kernel")
        del q, k, v, do, o, lse, lq, lk, lv, ldo
        torch.cuda.empty_cache()
    log(f"K2 per b{B} train step ({ATTN_PER_FORWARD} calls): " + json.dumps(totals)
        + "; by kernel: " + json.dumps(by_kernel))
    log(f"K2 per b{B} train step over its 12 calls at d=160: " + json.dumps(d160))
    return dict(totals, max_abs_err=worst, bound_ms_by=bound_ms_by, by_kernel=by_kernel,
                d160=d160, rows160=rows160)


def per_step_launches(model) -> dict:
    """Kernel launches of one train step, read off the module tree: K1 once
    per attention in the forward and again in the recompute of a
    rematerialised block; K2 once per attention; K3 once per GroupNorm in the
    forward and again for those inside rematerialised blocks (the GroupNorm
    backward runs the plain version, no kernel)."""
    from dmtpu_torch.models.adm import GroupNorm32, ResBlock
    from dmtpu_torch.models.stablediffusion.attention import CrossAttention, SpatialTransformer

    def count(kind, root):
        return sum(isinstance(m, kind) for m in root.modules())

    remat_roots = [m for m in model.modules() if isinstance(m, (ResBlock, SpatialTransformer))]
    attn = count(CrossAttention, model)
    attn_remat = sum(count(CrossAttention, r) for r in remat_roots) if model.use_checkpoint else 0
    gn = count(GroupNorm32, model)
    gn_remat = sum(count(GroupNorm32, r) for r in remat_roots) if model.use_checkpoint else 0
    return {"K1": attn + attn_remat, "K2": attn, "K3": gn + gn_remat}


def phase_train(dev, check, gen, ref_model, card) -> dict:
    """Phase 7 (see the module docstring).  ``ref_model`` is the f32 UNet
    whose random weights every run here starts from."""
    import torch
    from dmtpu_torch.diffusions import DDPM
    from dmtpu_torch.models.stablediffusion import SDUNetModel
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        select_bwd_kernel,
    )
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
    from dmtpu_torch.utils.optim import adafactor

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_bwd.launches_by_kernel.update(mma=0, wgmma=0)
        flash_attention_bwd.launches_by_head_dim.clear()

    # K2 launches of one step by kernel, as the dispatch sends the path's shapes
    k2_per_step = {"mma": 0, "wgmma": 0}
    for (sq, sk, d), calls in ATTN_CALLS.items():
        k2_per_step[select_bwd_kernel(d)] += calls

    init = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    model = SDUNetModel(**SD15, torso_dtype=torch.bfloat16, use_checkpoint=True,
                        device=dev).train()
    model.load_state_dict(init)
    ref_model.train()
    want_per_step = per_step_launches(model)
    log(f"train: launches per step from the module tree (remat on): {want_per_step}")
    diffuser = DDPM(total_steps=1000)

    def fixed_loss(m):
        def loss_fn(batch, generator):
            return diffuser.loss_func(m, batch["image"], batch["t"], eps=batch["eps"],
                                      model_kwargs={"context": batch["context"]})
        return loss_fn

    g = gen(SEED + 7)
    fixed = {"image": torch.randn(TRAIN_CHECK_BATCH, 4, 64, 64, generator=g, device=dev),
             "eps": torch.randn(TRAIN_CHECK_BATCH, 4, 64, 64, generator=g, device=dev),
             "t": torch.tensor([999, 421], device=dev)[:TRAIN_CHECK_BATCH],
             "context": torch.randn(TRAIN_CHECK_BATCH, 77, 768, generator=g, device=dev)}

    # (a) loss and gradient at b2 against f32
    def loss_and_grads(m, plain: bool):
        m.zero_grad(set_to_none=True)
        with plain_ops() if plain else contextlib.nullcontext():
            loss = fixed_loss(m)(fixed, None)
            loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()}

    loss_f, grads_f = loss_and_grads(ref_model, plain=True)
    grads_f = {n: gr.clone() for n, gr in grads_f.items()}
    ref_model.zero_grad(set_to_none=True)
    zero_counts()
    loss_k, grads_k = loss_and_grads(model, plain=False)
    torch.cuda.synchronize()
    check_launches = counts()
    check_k2 = dict(flash_attention_bwd.launches_by_kernel)
    err_k = (sum((grads_k[n] - grads_f[n]).square().sum() for n in grads_f).sqrt()
             / sum(gr.square().sum() for gr in grads_f.values()).sqrt()).item()
    lerr_k = abs(loss_k.item() - loss_f.item()) / abs(loss_f.item())
    loss_p, grads_p = loss_and_grads(model, plain=True)
    err_p = (sum((grads_p[n] - grads_f[n]).square().sum() for n in grads_f).sqrt()
             / sum(gr.square().sum() for gr in grads_f.values()).sqrt()).item()
    lerr_p = abs(loss_p.item() - loss_f.item()) / abs(loss_f.item())
    log(f"train b{TRAIN_CHECK_BATCH} loss: f32 {loss_f.item():.6f}, kernels {loss_k.item():.6f}, "
        f"plain bf16 {loss_p.item():.6f}; rel err vs f32: kernels {lerr_k:.3e}, plain {lerr_p:.3e}")
    log(f"train b{TRAIN_CHECK_BATCH} gradient ({len(grads_f)} tensors): rel L2 err vs f32 plain: "
        f"kernels {err_k:.3e}, plain bf16 {err_p:.3e}; launches {check_launches}")
    check(bool(torch.isfinite(loss_k)) and lerr_k <= 1.5 * lerr_p + 1e-3,
          "train loss: err(kernels) <= 1.5 err(plain) + 1e-3")
    check(err_k <= 1.5 * err_p + 1e-3, "train gradient: err(kernels) <= 1.5 err(plain) + 1e-3")
    # (b) exact launches of one forward + backward
    check(check_launches == want_per_step,
          f"train forward+backward launches {check_launches} == {want_per_step}")
    check(check_k2 == k2_per_step and k2_per_step["wgmma"] > 0,
          f"train forward+backward K2 launches by kernel {check_k2} == {k2_per_step}")
    del grads_f, grads_k, grads_p
    ref_model.zero_grad(set_to_none=True)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    def fresh_state():
        model.load_state_dict(init)
        return TrainState.create(model, adafactor(model.parameters(), lr=TRAIN_LR),
                                 ema_decay=EMA_DECAY, ema_gradual=True,
                                 ema_dtype=torch.bfloat16)

    # (d) learning on one fixed batch.  The kernel path trains, and before each
    # of its steps the plain bf16 path's loss is taken at the same weights.
    # The two are not trained apart: each adafactor step (at first a step of
    # lr in the sign of every gradient) compounds their rounding differences,
    # so their losses part by more than either path's error
    step = make_train_step(fixed_loss(model), clip_grad_norm=TRAIN_CLIP)
    lk, ls = [], []
    state = fresh_state()
    for _ in range(LEARN_STEPS):
        with torch.no_grad(), plain_ops():
            ls.append(fixed_loss(model)(fixed, None).item())
        lk.append(step(state, fixed)["loss"].item())
    del state
    same = max(abs(a - b) / abs(b) for a, b in zip(lk, ls))
    log(f"train b{TRAIN_CHECK_BATCH} fixed batch, {LEARN_STEPS} steps, loss: kernels {lk}; "
        f"plain at the same weights {ls} (worst rel. diff {same:.3e})")
    check(all(map(math.isfinite, lk)) and lk[-1] < lk[0], "train: the kernel path's loss falls")
    # at the same weights the two paths differ only in rounding (at most
    # 5.9e-5 over 10 steps on the card); 1e-3 is the floor of (a)
    check(same <= 1e-3, "train: at the kernel path's weights of each step, its loss is within "
                        "1e-3 of the plain path's")
    torch.cuda.empty_cache()

    # (c) timing at b16 through the main path's own loss (random t and eps)
    g = gen(SEED + 8)
    batch = {"image": torch.randn(B, 4, 64, 64, generator=g, device=dev),
             "context": torch.randn(B, 77, 768, generator=g, device=dev)}
    state = fresh_state()
    step = make_train_step(make_diffusion_loss_fn(diffuser, model, 1000),
                           clip_grad_norm=TRAIN_CLIP)
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    history = [step(state, batch) for _ in range(TRAIN_TIMED_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    k2_by_kernel = dict(flash_attention_bwd.launches_by_kernel)
    k2_d160 = flash_attention_bwd.launches_by_head_dim.get(160, 0)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in history]
    norms = [m["grad_norm"].item() for m in history]
    metrics = {"imgs_per_s": B * TRAIN_TIMED_STEPS / seconds,
               "ms_per_step": 1e3 * seconds / TRAIN_TIMED_STEPS,
               "peak_bytes": peak, "batch": B, "steps": TRAIN_TIMED_STEPS,
               "launches_per_step": want_per_step, "k2_launches_per_step": k2_per_step}
    log(f"train b{B}: {TRAIN_TIMED_STEPS} steps in {seconds:.3f} s, {metrics['imgs_per_s']:.4f} "
        f"imgs/s, {metrics['ms_per_step']:.3f} ms/step, peak {peak / 2**30:.3f} GiB ({card}); "
        f"launches {launches}; losses {losses}; grad norms {norms}")
    check(all(map(math.isfinite, losses + norms)), "train b16: finite losses and grad norms")
    check(launches == {k: TRAIN_TIMED_STEPS * n for k, n in want_per_step.items()},
          f"train b{B} launches == {TRAIN_TIMED_STEPS} x {want_per_step}")
    check(k2_by_kernel == {k: TRAIN_TIMED_STEPS * n for k, n in k2_per_step.items()}
          and k2_by_kernel["mma"] == 0,
          f"train b{B} K2 launches by kernel {k2_by_kernel} == {TRAIN_TIMED_STEPS} x "
          f"{k2_per_step}, none through mma.sync")
    d160_calls = sum(n for (_, _, d), n in ATTN_CALLS.items() if d == 160)
    check(k2_d160 == TRAIN_TIMED_STEPS * d160_calls,
          f"train b{B}: {k2_d160} K2 launches at d=160 == {TRAIN_TIMED_STEPS} x {d160_calls}")
    check(state.ema.num_updates == TRAIN_TIMED_STEPS + 1
          and all(s.dtype == torch.bfloat16 for s in state.ema.shadow.values()),
          "train: EMA updated each step, bf16 shadow")
    torch.cuda.empty_cache()
    profile = profile_by_class(lambda: step(state, batch), 2)
    log(f"train b{B} step device time by class (torch.profiler, ms per step over 2; wall "
        f"{profile['wall_ms']:.3f} ms per step under the profiler): "
        + json.dumps(profile["classes"]) + "; annotated ranges: " + json.dumps(profile["ranges"]))
    for name, ms in profile["top"]:
        log(f"  {ms:9.4f} ms  {name}")
    metrics["profile_ms"] = dict(profile["classes"], wall=profile["wall_ms"], **profile["ranges"])
    return {"launches": launches, "k2_by_kernel": k2_by_kernel, "metrics": metrics,
            "k2_d160_launches": k2_d160}


def phase_text_to_image(dev, check, gen, ref_model, card, time_ms) -> dict:
    """Phase 8 (see the module docstring).  ``ref_model`` is the f32 UNet of
    phase 4: the text-to-image stack's UNet gets its weights."""
    import copy

    import numpy as np
    import torch
    from dmtpu_torch.models.adm import GroupNorm32
    from dmtpu_torch.models.stablediffusion import StableDiffusion
    from dmtpu_torch.models.stablediffusion.attention import CrossAttention
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.scripts.sample_sd import _demo_token_ids, sample_images
    from dmtpu_torch.utils.config import instantiate_from_config

    def count(kind, root):
        return sum(isinstance(m, kind) for m in root.modules())

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_err(a, ref) -> float:
        a, ref = (torch.as_tensor(np.asarray(x, np.float32)) for x in (a, ref))
        return ((a - ref).norm() / ref.norm()).item()

    # the stack, from the config dict through the registry; f32 parameters,
    # the UNet with a bf16 torso and phase 4's weights
    sd = instantiate_from_config(SD15_CONF["model"], device=dev).eval()
    check(isinstance(sd, StableDiffusion) and sd.unet.torso_dtype == torch.bfloat16,
          "text to image: StableDiffusion built from the config dict, bf16 UNet torso")
    sd.unet.load_state_dict(ref_model.state_dict())
    g = gen(SEED + 9)
    init_random_(sd.vae, g)
    init_random_(sd.text_encoder, g)
    ref_model.eval()
    bf16_unet = sd.unet
    sizes = {name: sum(p.numel() for p in m.parameters())
             for name, m in (("unet", sd.unet), ("vae", sd.vae), ("clip", sd.text_encoder))}
    log(f"text to image: parameters {sizes}, all f32: "
        f"{all(p.dtype == torch.float32 for p in sd.parameters())}")
    per = {"attn": count(CrossAttention, sd.unet), "unet_gn": count(GroupNorm32, sd.unet),
           "decode_gn": count(GroupNorm32, sd.vae.decoder),
           "encode_gn": count(GroupNorm32, sd.vae.encoder)}
    log(f"text to image: kernel calls from the module trees: {per}")
    check(per == {"attn": ATTN_PER_FORWARD, "unet_gn": GN_PER_FORWARD,
                  "decode_gn": GN_PER_DECODE, "encode_gn": GN_PER_ENCODE},
          "module trees give 32 attention and 61 + 30 + 22 GroupNorm calls")

    def want_launches(rows: int, batches: int = 1, encodes: int = 0) -> dict:
        """One request: ``rows`` guided UNet calls and one decode a batch."""
        return {"K1": batches * rows * per["attn"], "K2": 0,
                "K3": batches * (rows * per["unet_gn"] + per["decode_gn"])
                + encodes * per["encode_gn"]}

    # (a) the parts at batch 2, f32 with TF32 off (set in phase 4)
    b = T2I_CHECK_BATCH
    ids = torch.as_tensor(np.concatenate([
        _demo_token_ids("a photograph of an astronaut", 77, 49408),
        _demo_token_ids("", 77, 49408)]), device=dev)
    with torch.no_grad():
        emb = sd.text_encoder_encode_tokens(ids)
        emb_cpu = copy.deepcopy(sd.text_encoder).cpu().encode_tokens(ids.cpu())
    err = rel_err(emb.cpu(), emb_cpu)
    log(f"CLIP-L b{b} on the card vs the same module on the CPU (f32): rel L2 err {err:.3e}, "
        f"max abs {(emb.cpu() - emb_cpu).abs().max().item():.3e}")
    # f32 on both sides, sums in another order through 12 layers
    check(tuple(emb.shape) == (b, 77, 768) and bool(torch.isfinite(emb).all()) and err <= 1e-4,
          "CLIP-L on the card: [2, 77, 768], finite, within 1e-4 rel L2 of the CPU")

    # the VAE through K3 against the plain GroupNorm, and the layouts K3 is given
    layouts = set()

    def note_layout(_, args):
        x = args[0]
        layouts.add("NCHW" if x.is_contiguous() else
                    "NHWC" if x.is_contiguous(memory_format=torch.channels_last) else "other")

    hooks = [m.register_forward_pre_hook(note_layout)
             for m in sd.vae.modules() if isinstance(m, GroupNorm32)]
    z = torch.randn(b, 4, T2I_SIZE // 8, T2I_SIZE // 8, generator=g, device=dev)
    x = torch.rand(b, 3, T2I_SIZE, T2I_SIZE, generator=g, device=dev) * 2 - 1
    with torch.no_grad():
        zero_counts()
        dec_k, enc_k = sd.decode_latent(z), sd.vae.encode_moments(x)
        torch.cuda.synchronize()
        vae_launches = counts()
        with plain_ops():
            dec_p, enc_p = sd.decode_latent(z), sd.vae.encode_moments(x)
    for h in hooks:
        h.remove()
    err_d, err_e = rel_err(dec_k.cpu(), dec_p.cpu()), rel_err(enc_k.cpu(), enc_p.cpu())
    log(f"VAE b{b} {T2I_SIZE}x{T2I_SIZE} through K3 vs plain GroupNorm (f32, TF32 off): rel L2 "
        f"err decode {err_d:.3e}, encode {err_e:.3e}; launches {vae_launches}; K3's inputs "
        f"{sorted(layouts)}")
    # f32 on both sides: K3's statistics and SiLU round otherwise (1e-4 of a
    # value at worst, phase 3) through 30 and 22 norms
    check(tuple(dec_k.shape) == (b, 3, T2I_SIZE, T2I_SIZE) and err_d <= 1e-3
          and tuple(enc_k.shape) == (b, 8, T2I_SIZE // 8, T2I_SIZE // 8) and err_e <= 1e-3
          and bool(torch.isfinite(dec_k).all()) and bool(torch.isfinite(enc_k).all()),
          "VAE decode and encode through K3 within 1e-3 rel L2 of the plain path")
    check(vae_launches == {"K1": 0, "K2": 0, "K3": GN_PER_DECODE + GN_PER_ENCODE},
          f"VAE launches {vae_launches}: K3 at every GroupNorm ({GN_PER_DECODE} + "
          f"{GN_PER_ENCODE}), no K1")
    check(layouts == {"NCHW"}, "every GroupNorm of the VAE was given contiguous NCHW")
    del dec_k, dec_p, enc_k, enc_p, z, x

    # a prompt -> 5-step DDIMCFG -> image: kernels and plain bf16 against f32
    request = dict(negative="blurry, low quality", height=T2I_SIZE, width=T2I_SIZE,
                   guidance_scale=T2I_SCALE, seed=SEED, sd=sd)
    prompt = "a photograph of an astronaut riding a horse"
    small = dict(request, n_samples=b, batch_size=b, respace_steps=T2I_CHECK_STEPS)
    rows = len(instantiate_from_config(
        SD15_CONF["diffusion"], respace_type="uniform",
        respace_steps=T2I_CHECK_STEPS).respaced_seq)
    zero_counts()
    img_k = sample_images(SD15_CONF, prompt, **small)
    got = counts()
    with plain_ops():
        img_p = sample_images(SD15_CONF, prompt, **small)
        sd.unet = ref_model
        try:
            img_f = sample_images(SD15_CONF, prompt, **small)
        finally:
            sd.unet = bf16_unet
    err_k, err_p = rel_err(img_k, img_f), rel_err(img_p, img_f)
    log(f"text to image b{b}, {rows} DDIMCFG steps, s={T2I_SCALE}, {T2I_SIZE}x{T2I_SIZE} uint8 "
        f"images: rel L2 err vs the f32 plain run: kernels {err_k:.3e}, plain bf16 {err_p:.3e}; "
        f"mean {img_k.mean():.1f}, share of pixels at 0 or 255 "
        f"{float(((img_k == 0) | (img_k == 255)).mean()):.3f}; launches {got}")
    check(img_k.shape == (b, T2I_SIZE, T2I_SIZE, 3) and img_k.dtype == np.uint8
          and err_k <= 1.5 * err_p + 1e-3,
          "text to image: uint8 [2, 512, 512, 3], err(kernels) <= 1.5 err(plain) + 1e-3")
    check(img_k.std() > 1.0 and not np.array_equal(img_k[0], img_k[1]),
          "text to image: the images vary, and from sample to sample")
    # (b) exact launches of one request
    check(got == want_launches(rows), f"text to image launches {got} == {want_launches(rows)}")

    # (d) img2img and inpainting at batch 2
    edit = dict(request, n_samples=b, batch_size=b, respace_steps=T2I_EDIT_STEPS)
    rows = len(instantiate_from_config(
        SD15_CONF["diffusion"], respace_type="uniform",
        respace_steps=T2I_EDIT_STEPS).respaced_seq)
    rs = np.random.RandomState(SEED)
    picture = rs.uniform(-1, 1, size=(T2I_SIZE, T2I_SIZE, 3)).astype(np.float32)
    zero_counts()
    img = sample_images(SD15_CONF, prompt, init_image=picture, strength=0.75, **edit)
    got, edit_rows = counts(), max(1, min(rows, round(0.75 * rows)))
    check(img.shape == (b, T2I_SIZE, T2I_SIZE, 3) and img.std() > 1.0,
          "img2img (strength 0.75): uint8 [2, 512, 512, 3]")
    check(got == want_launches(edit_rows, encodes=1),
          f"img2img launches {got} == {want_launches(edit_rows, encodes=1)} ({edit_rows} of "
          f"{rows} steps, one encode)")
    mask = np.ones((T2I_SIZE // 8, T2I_SIZE // 8), np.float32)
    mask[16:48, 16:48] = 0.0
    zero_counts()
    img = sample_images(SD15_CONF, prompt, inpaint_image=picture, inpaint_mask=mask, **edit)
    got = counts()
    check(img.shape == (b, T2I_SIZE, T2I_SIZE, 3) and img.std() > 1.0,
          "inpainting: uint8 [2, 512, 512, 3]")
    check(got == want_launches(rows, encodes=1),
          f"inpainting launches {got} == {want_launches(rows, encodes=1)}")
    # a fully known mask gives back the known latent at t = 0: the request's
    # images are the decode of that latent (the encode draws from seed + 1)
    full = sample_images(SD15_CONF, prompt, inpaint_image=picture, inpaint_mask=np.ones_like(mask),
                         **edit)
    with torch.no_grad():
        known = torch.as_tensor(picture, device=dev).permute(2, 0, 1)[None].expand(b, -1, -1, -1)
        z_known = sd.encode_latent(known.contiguous(),
                                   torch.Generator(device=dev).manual_seed(SEED + 1))
        want = ((sd.decode_latent(z_known).clamp(-1, 1).permute(0, 2, 3, 1) + 1) / 2 * 255).cpu()
    worst = np.abs(full.astype(np.int64) - want.numpy().astype(np.int64)).max()
    log(f"inpainting with a fully known mask vs the decode of the known latent: worst "
        f"difference {worst} of 255")
    # the latent comes back to 1e-6 (one f32 rounding of a + (b - a)); a uint8
    # that sat at a rounding edge may move by one
    check(worst <= 1, "inpainting: a fully known mask gives back the known latent's image")

    # (c) the timed request: b16, DDIMCFG-50, 512x512; the f32 convolutions of
    # the VAE with TF32, PyTorch's default for cuDNN, which the CLI leaves alone
    torch.backends.cudnn.allow_tf32 = True
    events = []

    def on_stage(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append((name, event))

    timed = dict(request, n_samples=B, batch_size=B, respace_steps=T2I_STEPS)
    rows = len(instantiate_from_config(
        SD15_CONF["diffusion"], respace_type="uniform", respace_steps=T2I_STEPS).respaced_seq)
    sample_images(SD15_CONF, prompt, **timed)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    images = sample_images(SD15_CONF, prompt, on_stage=on_stage, **timed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tf32 = bool(torch.backends.cudnn.allow_tf32)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    stage_ms = {name: before.elapsed_time(after)
                for (_, before), (name, after) in zip(events, events[1:])}
    metrics = {"imgs_per_s": B / seconds, "seconds": seconds, "batch": B, "steps": rows,
               "size": T2I_SIZE, "guidance_scale": T2I_SCALE, "stage_ms": stage_ms,
               "peak_bytes": peak, "vae_conv_tf32": tf32}
    log(f"text to image b{B}, DDIMCFG-{T2I_STEPS} ({rows} UNet calls on {2 * B} samples), "
        f"{T2I_SIZE}x{T2I_SIZE}: {seconds:.3f} s, {metrics['imgs_per_s']:.4f} images/s, stages "
        f"(CUDA events, ms) {json.dumps(stage_ms)}, peak {peak / 2**30:.3f} GiB, VAE "
        f"convolutions in TF32: {tf32} ({card}); launches {launches}")
    check(images.shape == (B, T2I_SIZE, T2I_SIZE, 3) and images.dtype == np.uint8
          and images.std() > 1.0, "text to image b16: uint8 [16, 512, 512, 3]")
    check(launches == want_launches(rows),
          f"text to image b16 launches {launches} == {want_launches(rows)}")
    # the VAE decode alone at b16, with and without TF32 in its convolutions,
    # and where its device time goes
    z = torch.randn(B, 4, T2I_SIZE // 8, T2I_SIZE // 8, generator=g, device=dev)
    with torch.no_grad():
        decode_ms = {}
        for tf32 in (True, False, False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            decode_ms.setdefault("tf32" if tf32 else "f32", []).append(
                time_ms(lambda: sd.decode_latent(z), 2))
        torch.backends.cudnn.allow_tf32 = True
        with plain_ops():
            decode_ms["tf32_plain_group_norm"] = [time_ms(lambda: sd.decode_latent(z), 2)]
        profile = profile_by_class(lambda: sd.decode_latent(z), 1)
    torch.backends.cudnn.allow_tf32 = False
    metrics["vae_decode_ms"] = decode_ms
    metrics["vae_decode_profile_ms"] = profile["classes"]
    log(f"VAE decode b{B} {T2I_SIZE}x{T2I_SIZE} ms (CUDA events, 2 decodes each, order tf32, "
        f"f32, f32, tf32): {json.dumps(decode_ms)}; device time by class, TF32 (torch.profiler, "
        f"one decode): " + json.dumps(profile["classes"]))
    for name, ms in profile["top"]:
        log(f"  {ms:9.4f} ms  {name}")
    return {"launches": launches, "metrics": metrics, "sd": sd}


def phase_serving(dev, check, sd, ref_model, card) -> dict:
    """Phase 10 (see the module docstring): the serving accelerators through
    ``sample_images`` on phase 8's stack ``sd`` (bf16 UNet torso);
    ``ref_model`` is the f32 UNet with the same weights."""
    import numpy as np
    import torch
    from dmtpu_torch.diffusions import DDIM, PFDiffDDIM
    from dmtpu_torch.models.adm import GroupNorm32
    from dmtpu_torch.models.stablediffusion.attention import CrossAttention
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.freeu import SD15_DEFAULTS
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.scripts.sample_sd import sample_images

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_err(a, ref) -> float:
        a, ref = (torch.as_tensor(np.asarray(x, np.float32)) for x in (a, ref))
        return ((a - ref).norm() / ref.norm()).item()

    def count(kind, blocks):
        return sum(isinstance(m, kind) for b in blocks for m in b.modules())

    # the kernel calls of one UNet call of each kind, from the module tree
    unet = sd.unet
    shallow_blocks = list(unet.input_blocks[:3]) + list(unet.output_blocks[-3:])
    per = {"full": (count(CrossAttention, [unet]), count(GroupNorm32, [unet])),
           "shallow": (count(CrossAttention, shallow_blocks),
                       count(GroupNorm32, shallow_blocks) + 1),  # + the out norm
           "decode": count(GroupNorm32, [sd.vae.decoder])}
    log(f"serving: kernel calls of a full and a shallow (skip 3) UNet call, and of a decode, "
        f"from the module trees: {per}")
    check(per == {"full": (ATTN_PER_FORWARD, GN_PER_FORWARD),
                  "shallow": (SHALLOW_ATTN, SHALLOW_GN), "decode": GN_PER_DECODE},
          f"module trees give ({ATTN_PER_FORWARD}, {GN_PER_FORWARD}) a full call, "
          f"({SHALLOW_ATTN}, {SHALLOW_GN}) a shallow one, {GN_PER_DECODE} a decode")

    def unet_calls(config: dict, steps: int) -> tuple:
        """(full, shallow) UNet calls of one batch of ``config``, from the
        samplers' own tapes: a row a call, PFDiff's ``nfe``; DeepCache runs
        call k full when k % interval == 0."""
        dp = dict(SD15_CONF["diffusion"]["params"], respace_type="uniform", respace_steps=steps)
        n = (PFDiffDDIM(**dp).nfe if config.get("sampler") == "pfdiff"
             else len(DDIM(**dp).respaced_seq))
        interval = config["deepcache"][0] if config.get("deepcache") else 1
        full = len(range(0, n, interval))
        return full, n - full

    def want_launches(config: dict, steps: int) -> dict:
        full, shallow = unet_calls(config, steps)
        return {"K1": full * per["full"][0] + shallow * per["shallow"][0], "K2": 0,
                "K3": full * per["full"][1] + shallow * per["shallow"][1] + per["decode"]}

    prompt = "a photograph of an astronaut riding a horse"
    request = dict(negative="blurry, low quality", height=T2I_SIZE, width=T2I_SIZE,
                   guidance_scale=T2I_SCALE, seed=SEED, sd=sd)
    bf16_unet = sd.unet
    torch.backends.cudnn.allow_tf32 = False

    # (a) each accelerator at b2 over a few steps: the kernel path and the
    # plain bf16 path against an f32 plain run
    b = T2I_CHECK_BATCH
    for name, config in SERVE_CONFIGS.items():
        small = dict(request, **dict(config, respace_steps=SERVE_CHECK_STEPS), n_samples=b,
                     batch_size=b)
        zero_counts()
        img_k = sample_images(SD15_CONF, prompt, **small)
        got = counts()
        with plain_ops():
            img_p = sample_images(SD15_CONF, prompt, **small)
            sd.unet = ref_model
            try:
                img_f = sample_images(SD15_CONF, prompt, **small)
            finally:
                sd.unet = bf16_unet
        err_k, err_p = rel_err(img_k, img_f), rel_err(img_p, img_f)
        want = want_launches(config, SERVE_CHECK_STEPS)
        log(f"serving {name} b{b}, {SERVE_CHECK_STEPS} steps, {T2I_SIZE}x{T2I_SIZE}: rel L2 err "
            f"vs the f32 plain run: kernels {err_k:.3e}, plain bf16 {err_p:.3e}; UNet calls "
            f"(full, shallow) {unet_calls(config, SERVE_CHECK_STEPS)}; launches {got}")
        check(img_k.shape == (b, T2I_SIZE, T2I_SIZE, 3) and img_k.std() > 1.0
              and err_k <= 1.5 * err_p + 1e-3,
              f"serving {name} b{b}: images vary, err(kernels) <= 1.5 err(plain) + 1e-3")
        check(got == want, f"serving {name} b{b} launches {got} == {want}")
    # DeepCache with interval 1 calls the full UNet at every step: the images
    # of the plain sampler, through the kernels
    for sampler in ("ddim", "pfdiff"):
        small = dict(request, sampler=sampler, n_samples=b, batch_size=b,
                     respace_steps=SERVE_CHECK_STEPS)
        plain = sample_images(SD15_CONF, prompt, **small)
        cached = sample_images(SD15_CONF, prompt, deepcache=(1, 3), **small)
        err = rel_err(cached, plain)
        log(f"serving {sampler} with DeepCache (1, 3) vs without, b{b}: rel L2 {err:.3e}")
        check(err <= 1e-5, f"serving {sampler}: DeepCache interval 1 is the plain sampler (1e-5)")

    # (b) the timed requests: b16, 512x512; the VAE's convolutions with TF32,
    # as the CLI leaves them (phase 8)
    torch.backends.cudnn.allow_tf32 = True
    metrics, launches = {}, {}
    for name, config in SERVE_CONFIGS.items():
        timed = dict(request, **config, n_samples=B, batch_size=B)
        events = []

        def on_stage(stage):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append((stage, event))

        sample_images(SD15_CONF, prompt, **timed)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        images = sample_images(SD15_CONF, prompt, on_stage=on_stage, **timed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = counts()
        stage_ms = {stage: before.elapsed_time(after)
                    for (_, before), (stage, after) in zip(events, events[1:])}
        full, shallow = unet_calls(config, config["respace_steps"])
        metrics[name] = {"imgs_per_s": B / seconds, "seconds": seconds, "batch": B,
                         "unet_calls": {"full": full, "shallow": shallow},
                         "stage_ms": stage_ms, "peak_bytes": torch.cuda.max_memory_allocated(),
                         **{k: v for k, v in config.items() if k != "respace_steps"},
                         "steps": config["respace_steps"]}
        want = want_launches(config, config["respace_steps"])
        log(f"serving {name} b{B} {T2I_SIZE}x{T2I_SIZE}: {seconds:.3f} s, "
            f"{B / seconds:.4f} images/s, UNet calls on {2 * B} samples {full} full + {shallow} "
            f"shallow, stages (CUDA events, ms) {json.dumps(stage_ms)}, peak "
            f"{metrics[name]['peak_bytes'] / 2**30:.3f} GiB ({card}); launches {launches[name]}")
        check(images.shape == (B, T2I_SIZE, T2I_SIZE, 3) and images.dtype == np.uint8
              and images.std() > 1.0, f"serving {name} b16: uint8 [16, 512, 512, 3]")
        check(launches[name] == want, f"serving {name} b16 launches {launches[name]} == {want}")
    torch.backends.cudnn.allow_tf32 = False

    # (c) where a UNet call on 32 samples spends its device time: full, the
    # shallow pass, and the full call with ToMe 0.5 and with FreeU sd15
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = torch.randn(2 * B, 4, T2I_SIZE // 8, T2I_SIZE // 8, generator=g, device=dev)
    ts = torch.full((2 * B,), 501, device=dev)
    ctx = torch.randn(2 * B, 77, SD15["context_dim"], generator=g, device=dev)
    profiles = {}
    with torch.no_grad():
        _, cache = unet(x, ts, ctx, dc_skip=3)
        profiles["full"] = profile_by_class(lambda: unet(x, ts, ctx), 3)
        profiles["shallow"] = profile_by_class(
            lambda: unet(x, ts, ctx, dc_skip=3, dc_cached=cache), 3)
        sd.set_tome(0.5)
        profiles["tome0.5"] = profile_by_class(lambda: unet(x, ts, ctx), 3)
        sd.set_tome(0.0)
        sd.set_freeu(SD15_DEFAULTS)
        profiles["freeu_sd15"] = profile_by_class(lambda: unet(x, ts, ctx), 3)
        sd.set_freeu(None)
    for kind, profile in profiles.items():
        log(f"serving: one UNet call on {2 * B} samples, {kind}: device time by class (torch."
            f"profiler, ms a call over 3; wall {profile['wall_ms']:.3f} ms a call under the "
            f"profiler): " + json.dumps(profile["classes"]))
        if kind in ("tome0.5", "freeu_sd15"):
            for kernel, ms in profile["top"][:8]:
                log(f"  {ms:9.4f} ms  {kernel}")
    metrics["unet_b32_call_device_ms"] = {kind: profile["classes"]
                                          for kind, profile in profiles.items()}
    del x, ctx, cache
    torch.cuda.empty_cache()
    return {"launches": launches, "metrics": metrics}


def write_finetune_inputs(root: str, n: int, size: int) -> tuple:
    """``n`` seeded-noise ``size``² PNGs, each with a sidecar caption, and a
    local CLIPTokenizer directory with a character-level vocabulary (a-z,
    0-9), under ``root``: (image directory, tokenizer directory)."""
    import numpy as np
    from PIL import Image

    images, tokenizer = os.path.join(root, "images"), os.path.join(root, "tokenizer")
    os.makedirs(images)
    rs = np.random.RandomState(SEED)
    for i in range(n):
        Image.fromarray(rs.randint(0, 256, (size, size, 3), np.uint8)).save(
            os.path.join(images, f"{i:03d}.png"))
        with open(os.path.join(images, f"{i:03d}.txt"), "w") as f:
            f.write(FT_CAPTIONS[i % len(FT_CAPTIONS)].format(i))
    return images, write_char_clip_tokenizer(tokenizer)


def write_char_clip_tokenizer(path: str) -> str:
    """A local CLIPTokenizer directory at ``path`` with a character-level
    vocabulary (a-z, 0-9)."""
    from transformers import CLIPTokenizer

    os.makedirs(path, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    vocab_file, merges_file = (os.path.join(path, name) for name in ("vocab.json", "merges.txt"))
    with open(vocab_file, "w") as f:
        json.dump(vocab, f)
    with open(merges_file, "w") as f:
        f.write("#version: 0.2\n")
    CLIPTokenizer(vocab_file, merges_file).save_pretrained(path)
    return path


def write_char_t5_tokenizer(path: str) -> str:
    """A local fast tokenizer at ``path`` of single characters (a-z, 0-9,
    space) with T5's special tokens (<pad> 0, </s> 1 after every text, <unk>
    2): ``AutoTokenizer`` loads it without ``sentencepiece``."""
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789 ":
        vocab[ch] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex("."), "isolated")
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(path)
    return path


def phase_finetune_cli(dev, check, gen, ref_model, card) -> dict:
    """Phase 9 (see the module docstring).  ``ref_model`` is the f32 UNet of
    phase 4: (a) gives its weights to the config's UNet."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dmtpu_torch.diffusions import DDIMCFG
    from dmtpu_torch.models.adm import GroupNorm32
    from dmtpu_torch.models.lora import init_lora, lora_scale, lora_weights
    from dmtpu_torch.models.stablediffusion import StableDiffusion
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        select_bwd_kernel,
    )
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.parallel import TrainState, make_train_step, step_generator
    from dmtpu_torch.scripts import merge_lora, train_sd
    from dmtpu_torch.utils.checkpoint import load_checkpoint_host
    from dmtpu_torch.utils.config import instantiate_from_config, load_config

    here = os.path.dirname(os.path.abspath(__file__))
    ft_conf = load_config(os.path.join(here, FT_CONFIG))

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_bwd.launches_by_kernel.update(mma=0, wgmma=0)

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel(a, ref) -> float:
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    # (b) launches per step, from the module trees: no remat in the config, so
    # K1 and K2 once per attention, K3 at the UNet's GroupNorms and at the
    # VAE encoder's (the latent encode of the batch; the GroupNorm backward is
    # the plain version); a preview row is one guided UNet call, then one decode
    sd = instantiate_from_config(ft_conf.model, device=dev)
    per_step = per_step_launches(sd.unet)
    enc_gn = sum(isinstance(m, GroupNorm32) for m in sd.vae.encoder.modules())
    dec_gn = sum(isinstance(m, GroupNorm32) for m in sd.vae.decoder.modules())
    unet_gn = per_step["K3"]
    per_step["K3"] += enc_gn
    k2_per_step = {"mma": 0, "wgmma": 0}
    for (sq, sk, d), calls in ATTN_CALLS.items():
        k2_per_step[select_bwd_kernel(d)] += calls
    log(f"fine-tuning CLI: launches per step from the module trees {per_step} (K2 by kernel "
        f"{k2_per_step}); per preview row K1 {per_step['K1']}, K3 {unet_gn}; per decode K3 "
        f"{dec_gn}")
    check(per_step == {"K1": ATTN_PER_FORWARD, "K2": ATTN_PER_FORWARD,
                       "K3": GN_PER_FORWARD + GN_PER_ENCODE} and not sd.unet.use_checkpoint,
          f"fine-tuning: the config's tree gives 32 / 32 / {GN_PER_FORWARD} + {GN_PER_ENCODE} "
          f"launches a step (no remat)")

    # (a) the CLI's loss at b2 against f32 (TF32 off since phase 4): the
    # config's stack, its UNet with phase 4's weights, VAE and CLIP random
    sd.unet.load_state_dict(ref_model.state_dict())
    g = gen(SEED + 10)
    init_random_(sd.vae, g)
    init_random_(sd.text_encoder, g)
    for frozen in (sd.vae, sd.text_encoder):
        frozen.requires_grad_(False).eval()
    sd.unet.train()
    ref_model.train()
    b, p_uncond, lat = FT_CHECK_BATCH, 0.5, FT_SIZE // 8

    def mixed_drop(step):  # the draws of make_sd_loss_fn: posterior noise, then the mask
        gs = step_generator(SEED, step, dev)
        torch.randn(b, 4, lat, lat, generator=gs, device=dev)
        drop = torch.rand(b, generator=gs, device=dev) < p_uncond
        return 0 < int(drop.sum()) < b

    at = next(s for s in range(100) if mixed_drop(s))
    tokens = sd.text_encoder.max_length  # ids 2-73: the phase's tokenizer's
    batch = {"image": torch.rand(b, 3, FT_SIZE, FT_SIZE, generator=g, device=dev) * 2 - 1,
             "input_ids": torch.randint(2, 74, (b, tokens), generator=g, device=dev)}
    empty = torch.randint(2, 74, (1, tokens), generator=g, device=dev)
    diffuser = instantiate_from_config(ft_conf.diffusion)
    total = int(ft_conf.diffusion.params.total_steps)

    def loss_and_grad(unet, plain):
        unet.zero_grad(set_to_none=True)
        loss_fn = train_sd.make_sd_loss_fn(sd, diffuser, empty, p_uncond, total, unet)
        with plain_ops() if plain else contextlib.nullcontext():
            loss = loss_fn(batch, step_generator(SEED, at, dev))
            loss.backward()
        return loss.detach(), torch.cat([p.grad.flatten() for p in unet.parameters()])

    loss_f, grad_f = loss_and_grad(ref_model, plain=True)
    ref_model.zero_grad(set_to_none=True)
    zero_counts()
    loss_k, grad_k = loss_and_grad(sd.unet, plain=False)
    torch.cuda.synchronize()
    check_launches, check_k2 = counts(), dict(flash_attention_bwd.launches_by_kernel)
    loss_p, grad_p = loss_and_grad(sd.unet, plain=True)
    sd.unet.zero_grad(set_to_none=True)
    lerr_k, lerr_p = (abs(x.item() - loss_f.item()) / abs(loss_f.item()) for x in (loss_k, loss_p))
    err_k, err_p = rel(grad_k, grad_f), rel(grad_p, grad_f)
    del grad_f, grad_k, grad_p
    log(f"fine-tuning loss b{b} {FT_SIZE}x{FT_SIZE} (encode, caption drop at step {at}, text "
        f"encode, eps-loss): f32 {loss_f.item():.6f}, kernels {loss_k.item():.6f}, plain bf16 "
        f"{loss_p.item():.6f}; rel err vs f32: kernels {lerr_k:.3e}, plain {lerr_p:.3e}; UNet "
        f"gradient rel L2 err vs f32: kernels {err_k:.3e}, plain bf16 {err_p:.3e}; launches "
        f"{check_launches}, K2 by kernel {check_k2}")
    check(bool(torch.isfinite(loss_k)) and lerr_k <= 1.5 * lerr_p + 1e-3,
          "fine-tuning loss: err(kernels) <= 1.5 err(plain) + 1e-3")
    check(err_k <= 1.5 * err_p + 1e-3,
          "fine-tuning UNet gradient: err(kernels) <= 1.5 err(plain) + 1e-3")
    check(all(p.grad is None for m in (sd.vae, sd.text_encoder) for p in m.parameters()),
          "fine-tuning: no VAE or CLIP parameter has a gradient")
    check(check_launches == per_step and check_k2 == k2_per_step,
          f"fine-tuning forward+backward launches {check_launches} == {per_step}, K2 by kernel "
          f"{check_k2} == {k2_per_step}")
    # where the time of a step goes: the CLI's own loss, optimizer and EMA
    # from the configs, on one fixed b8 batch (no loader), TF32 in cuDNN as
    # in the CLI; a few timed steps, then torch.profiler over two
    torch.backends.cudnn.allow_tf32 = True
    lora_conf = load_config(os.path.join(here, LORA_CONFIG))
    batch = {"image": torch.rand(FT_BATCH, 3, FT_SIZE, FT_SIZE, generator=g, device=dev) * 2 - 1,
             "input_ids": torch.randint(2, 74, (FT_BATCH, tokens), generator=g, device=dev)}
    profiles = {}
    for mode, conf in (("full", ft_conf), ("lora", lora_conf)):
        if mode == "lora":
            sd.unet.zero_grad(set_to_none=True)
            sd.unet.requires_grad_(False)
            trainable = init_lora(sd.unet, gen(SEED + 12), rank=int(conf.train.lora.rank))
            with torch.no_grad():  # b non-zero, as after some training
                for name, p in trainable.named_parameters():
                    if name.endswith(".b"):
                        p.normal_(0.0, 1e-3, generator=g)
            unet = train_sd.lora_unet(sd, dict(trainable.named_parameters()),
                                      lora_scale(int(conf.train.lora.rank),
                                                 conf.train.lora.get("alpha")))
        else:
            trainable, unet = sd.unet, None
        state = TrainState.create(
            trainable, instantiate_from_config(conf.train.optim, params=trainable.parameters()),
            ema_decay=conf.train.ema_decay, ema_gradual=conf.train.get("ema_gradual", True),
            ema_dtype=conf.train.get("ema_dtype"))
        step = make_train_step(
            train_sd.make_sd_loss_fn(sd, diffuser, empty, float(conf.train.p_uncond), total,
                                     unet), clip_grad_norm=conf.train.clip_grad_norm)
        step(state, batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FT_TIMED_STEPS):
            step(state, batch)
        torch.cuda.synchronize()
        bare_ms = 1e3 * (time.perf_counter() - t0) / FT_TIMED_STEPS
        prof = profile_by_class(lambda: step(state, batch), 1)
        device_ms = prof["classes"]["total"]
        profiles[mode] = dict(prof["classes"], wall_under_profiler=prof["wall_ms"],
                              bare_step_ms=bare_ms, **prof["ranges"])
        log(f"fine-tuning step ({mode}) b{FT_BATCH} {FT_SIZE}x{FT_SIZE}, fixed batch, no loader: "
            f"{bare_ms:.3f} ms/step over {FT_TIMED_STEPS} (host clock); device time by class "
            f"(torch.profiler, one step; wall {prof['wall_ms']:.3f} ms under the profiler, the "
            f"card idle {1 - device_ms / prof['wall_ms']:.3f} of it): "
            + json.dumps(prof["classes"]) + "; annotated ranges: " + json.dumps(prof["ranges"]))
        for name, ms in prof["top"]:
            log(f"  {ms:9.4f} ms  {name}")
        del state, step, trainable, unet
        torch.cuda.empty_cache()
    del sd, batch
    ref_model.eval()
    torch.cuda.empty_cache()

    # (c), (d): the CLIs themselves, in this process.  TF32 in cuDNN as
    # PyTorch has it by default, which the CLIs leave alone.  The random
    # init is this script's (every layer non-zero, the same draws from the
    # same seed on the card), so that every parameter gets a gradient
    rows = len(DDIMCFG(total_steps=total, respace_type="uniform",
                       respace_steps=FT_PREVIEW_STEPS).respaced_seq)

    def want_launches(steps, previews):
        return {"K1": steps * per_step["K1"] + previews * rows * per_step["K1"],
                "K2": steps * per_step["K2"],
                "K3": steps * per_step["K3"] + previews * (rows * unet_gn + dec_gn)}

    def nonzero_init(self, generator=None, img_size=64):
        init_random_(self, generator)
        return self

    captured = {}
    real_build, real_init = train_sd.build_model, StableDiffusion.init_params

    def capturing_build(conf, device, logger):
        sd = captured["sd"] = real_build(conf, device, logger)
        # kept on the host, so that the run's peak memory is the CLI's own
        captured["unet_at_build"] = {k: v.to("cpu", copy=True)
                                     for k, v in sd.unet.state_dict().items()}
        return sd

    root = tempfile.mkdtemp(prefix="dmtpu_finetune_")
    metrics = {"batch": FT_BATCH, "size": FT_SIZE, "card": card, "step_profile_ms": profiles}
    launches = {}
    StableDiffusion.init_params = nonzero_init
    try:
        images, tokenizer = write_finetune_inputs(root, FT_IMAGES, FT_SIZE)
        common = [f"data.params.root={images}", f"tokenizer={tokenizer}",
                  f"train.batch_size={FT_BATCH}", "dataloader.num_workers=4",
                  f"train.sample_respace_steps={FT_PREVIEW_STEPS}", "train.print_freq=1",
                  f"seed={SEED}", "--device", "cuda", "-ni"]
        exp = os.path.join(root, "full")

        def run(config, steps, freq, *extra):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            result = train_sd.main(["-c", os.path.join(here, config), *common, *extra,
                                    f"train.n_steps={steps}", f"train.save_freq={freq}",
                                    f"train.sample_freq={freq}"])
            torch.cuda.synchronize()
            result.update(seconds=time.perf_counter() - t0, launches=counts(),
                          k2_by_kernel=dict(flash_attention_bwd.launches_by_kernel),
                          peak_bytes=torch.cuda.max_memory_allocated())
            return result

        # (c) full fine-tune: FT_STEPS steps, one save (5.2 GB), a preview
        first = run(FT_CONFIG, FT_STEPS, FT_STEPS, "-e", exp)
        ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
        last = os.path.join(exp, "ckpt", ckpts[-1])
        size = sum(os.path.getsize(os.path.join(last, f)) for f in os.listdir(last))
        blob = load_checkpoint_host(last)
        ema_ok = (blob["ema"]["num_updates"] == FT_STEPS and blob["step"] == FT_STEPS
                  and all(s.dtype == torch.bfloat16 for s in blob["ema"]["shadow"].values()))
        del blob
        text = "\n".join(open(os.path.join(exp, f)).read() for f in os.listdir(exp)
                         if f.startswith("output-"))
        step_ms = [1e3 * s for s in first["step_seconds"]]  # from the run's second step
        ms = sum(step_ms) / len(step_ms)
        metrics["full"] = {
            "ms_per_step": ms, "imgs_per_s": 1e3 * FT_BATCH / ms, "step_ms": step_ms,
            "peak_bytes": first["peak_bytes"], "checkpoint_bytes": size,
            "save_seconds": first["save_seconds"], "run_seconds": first["seconds"],
            "losses": first["losses"]}
        launches["train_sd_full"] = first["launches"]
        log(f"train_sd full fine-tune b{FT_BATCH} {FT_SIZE}x{FT_SIZE}: {ms:.3f} ms/step "
            f"({step_ms}), {metrics['full']['imgs_per_s']:.4f} imgs/s, peak "
            f"{metrics['full']['peak_bytes'] / 2**30:.3f} GiB ({card}); checkpoint "
            f"{size / 1e9:.3f} GB, save {metrics['full']['save_seconds']} s; run "
            f"{first['seconds']:.1f} s; losses {metrics['full']['losses']}; launches "
            f"{first['launches']}; checkpoints {ckpts}")
        check(all(map(math.isfinite, metrics["full"]["losses"]))
              and len(metrics["full"]["losses"]) == FT_STEPS,
              "train_sd: finite losses at every step")
        check(ckpts == [f"step{FT_STEPS - 1:06d}"] and "RANDOM-INIT" in text,
              "train_sd: one checkpoint, at the end of the run")
        check(os.path.isfile(os.path.join(exp, "samples", f"step{FT_STEPS - 1:06d}.png")),
              "train_sd: the EMA preview was written")
        check(ema_ok, "train_sd: the checkpoint's EMA counts every step and its shadow is bf16 "
                      "(ema_dtype: bfloat16 from the config)")
        check(first["launches"] == want_launches(FT_STEPS, 1)
              and first["k2_by_kernel"] == {k: FT_STEPS * n for k, n in k2_per_step.items()},
              f"train_sd launches {first['launches']} == {want_launches(FT_STEPS, 1)} "
              f"({FT_STEPS} steps and a {rows}-row preview)")
        shutil.rmtree(exp)
        torch.cuda.empty_cache()

        # (d) LoRA: a few steps, adapters-only checkpoints, a frozen base; then
        # -r latest for one more step (the CLI's resume); the merge
        exp = os.path.join(root, "lora")
        train_sd.build_model = capturing_build
        try:
            lora = run(LORA_CONFIG, LORA_STEPS, LORA_STEPS, "-e", exp)
            resumed = run(LORA_CONFIG, LORA_RESUMED_STEPS, LORA_STEPS, "-e", exp, "-r", "latest")
        finally:
            train_sd.build_model = real_build
        sd = captured.pop("sd")  # the resumed run's stack
        base_same = all(torch.equal(v, sd.unet.state_dict()[k].cpu())
                        for k, v in captured.pop("unet_at_build").items())
        ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
        ckpt = os.path.join(exp, "ckpt", f"step{LORA_RESUMED_STEPS - 1:06d}")
        size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        blob = load_checkpoint_host(ckpt)
        n_adapter = sum(v.numel() for v in blob["model"].values())
        adapters_only = all(k.endswith((".a", ".b")) for k in blob["model"]) and \
            blob["ema"]["shadow"].keys() == blob["model"].keys()
        moved = max(v.abs().max().item() for k, v in blob["model"].items() if k.endswith(".b"))
        text = "\n".join(open(os.path.join(exp, f)).read() for f in os.listdir(exp)
                         if f.startswith("output-"))
        step_ms = [1e3 * s for s in lora["step_seconds"]]
        ms = sum(step_ms) / len(step_ms)
        losses = lora["losses"] + resumed["losses"]
        metrics["lora"] = {"ms_per_step": ms, "imgs_per_s": 1e3 * FT_BATCH / ms,
                           "step_ms": step_ms, "peak_bytes": lora["peak_bytes"],
                           "checkpoint_bytes": size, "adapter_params": n_adapter,
                           "save_seconds": lora["save_seconds"] + resumed["save_seconds"],
                           "load_seconds": resumed["load_seconds"], "losses": losses,
                           "run_seconds": [lora["seconds"], resumed["seconds"]]}
        launches["train_sd_lora"] = lora["launches"]
        launches["train_sd_lora_resume"] = resumed["launches"]
        log(f"train_sd LoRA (rank 16) b{FT_BATCH} {FT_SIZE}x{FT_SIZE}: {ms:.3f} ms/step "
            f"({step_ms}), {metrics['lora']['imgs_per_s']:.4f} imgs/s, peak "
            f"{lora['peak_bytes'] / 2**30:.3f} GiB ({card}); checkpoint {size / 1e6:.3f} MB, "
            f"{n_adapter} adapter parameters, largest |b| {moved:.3e}; then -r latest to "
            f"{LORA_RESUMED_STEPS}, load {resumed['load_seconds']:.3f} s; losses {losses}; "
            f"launches {lora['launches']} then {resumed['launches']}; checkpoints {ckpts}")
        check(adapters_only and size < 1e8 and all(map(math.isfinite, losses))
              and len(losses) == LORA_RESUMED_STEPS,
              "train_sd LoRA: finite losses at every step of both runs; the checkpoint holds the "
              "adapters only")
        check(ckpts == [f"step{LORA_STEPS - 1:06d}", f"step{LORA_RESUMED_STEPS - 1:06d}"]
              and "Resumed from" in text and blob["step"] == LORA_RESUMED_STEPS
              and blob["ema"]["num_updates"] == LORA_RESUMED_STEPS,
              "train_sd LoRA: two checkpoints, resumed from the first; the EMA counts every step")
        check(base_same and moved > 0, "train_sd LoRA: the base UNet is bit-identical after "
                                       "training, the adapters moved")
        check(lora["launches"] == want_launches(LORA_STEPS, 1)
              and lora["k2_by_kernel"] == {k: LORA_STEPS * n for k, n in k2_per_step.items()}
              and resumed["launches"] == want_launches(LORA_RESUMED_STEPS - LORA_STEPS, 0),
              f"train_sd LoRA launches {lora['launches']}, {resumed['launches']} == "
              f"{want_launches(LORA_STEPS, 1)}, "
              f"{want_launches(LORA_RESUMED_STEPS - LORA_STEPS, 0)}")

        merged_path = os.path.join(root, "merged.pt")
        t0 = time.perf_counter()
        merge_lora.main(["-c", os.path.join(here, LORA_CONFIG), "--lora", ckpt, "--out",
                         merged_path, "--device", "cuda", f"seed={SEED}"])
        merge_seconds = time.perf_counter() - t0
        scale = lora_scale(int(lora_conf.train.lora.rank), lora_conf.train.lora.get("alpha"))
        merged = instantiate_from_config(lora_conf.model, device=dev).load_weights(
            merged_path).eval()
        sd.eval()
        g = gen(SEED + 11)
        x = torch.randn(FT_CHECK_BATCH, 4, lat, lat, generator=g, device=dev)
        ts = torch.tensor([999, 421], device=dev)[:FT_CHECK_BATCH]
        ctx = torch.randn(FT_CHECK_BATCH, tokens,
                          int(lora_conf.model.params.unet_config.params.context_dim),
                          generator=g, device=dev)
        shadow = {k: v.to(dev, torch.float32) for k, v in blob["ema"]["shadow"].items()}
        with torch.no_grad(), plain_ops():
            want = torch.func.functional_call(
                sd.unet, lora_weights(dict(sd.unet.named_parameters()), shadow, scale), (x, ts),
                {"context": ctx})
            got = merged.unet(x, ts, context=ctx)
            base = sd.unet(x, ts, context=ctx)
        err, shift = rel(got, want), rel(base, want)
        metrics["lora"]["merge_seconds"] = merge_seconds
        log(f"merge_lora: {merge_seconds:.1f} s; the merged UNet's b{FT_CHECK_BATCH} forward vs "
            f"the base with the EMA adapters (plain path): rel L2 err {err:.3e}; the base alone "
            f"differs by {shift:.3e}")
        check(err <= 1e-3 and bool(torch.isfinite(got).all()),
              "merge_lora: the merged weights give the adapted UNet within 1e-3 rel L2")
        del sd, merged, blob, shadow, want, got, base
    finally:
        StableDiffusion.init_params = real_init
        torch.backends.cudnn.allow_tf32 = False
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "metrics": metrics}


def phase_dit(dev, check, gen, card, time_ms, host_us) -> dict:
    """Phase 11 (see the module docstring): DiT-XL/2 and MDTv2-XL/2
    class-conditional sampling through ``sample_cfg``'s request function."""
    import argparse

    import torch
    from dmtpu_torch.models.dit import DiT, TimmAttention
    from dmtpu_torch.models.latent import LatentDiffusionWrapper
    from dmtpu_torch.models.stablediffusion.autoencoder import AutoencoderKL
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.scripts.sample_cfg import make_diffuser, sample_class
    from dmtpu_torch.utils.config import Config, instantiate_from_config

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_err(a, ref) -> float:
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    def diffuser(steps):
        args = argparse.Namespace(sampler="ddim", guidance_scale=DIT_SCALE, var_type=None,
                                  guidance_interval=None, ddim_eta=0.0, respace_type="uniform",
                                  respace_steps=steps)
        return make_diffuser(args, Config(DIT_CONF))

    conf = Config(DIT_CONF)
    num_classes = conf.data.num_classes
    size = conf.data.params.img_size
    shape = (4, size // 8, size // 8)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # the wrapper from the config dict through the registry: the bf16 DiT-XL/2
    # torso and the f32 VAE; an f32 DiT with the same weights is the reference
    model = instantiate_from_config(conf.model, device=dev).eval()
    vit = model.vit
    check(isinstance(model, LatentDiffusionWrapper) and isinstance(vit, DiT)
          and vit.dtype == torch.bfloat16 and isinstance(model.vae, AutoencoderKL),
          "DiT: LatentDiffusionWrapper built from the config dict, bf16 DiT torso, f32 VAE")
    g = gen(SEED + 20)
    init_random_(vit, g)  # adaLN-Zero and the final layer non-zero: else the output is 0
    init_random_(model.vae, g)
    ref_vit = DiT(**dict(conf.model.params.vit_config.params, dtype=None), device=dev).eval()
    ref_vit.load_state_dict(vit.state_dict())
    attn_calls = sum(isinstance(m, TimmAttention) for m in vit.modules())
    decode_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in model.vae.decoder.modules())
    log(f"DiT-XL/2: {sum(p.numel() for p in vit.parameters())} params (f32), depth "
        f"{len(vit.blocks)}, hidden {vit.hidden_size}, heads {vit.num_heads}, tokens "
        f"{vit.grid ** 2}; from the module trees: {attn_calls} attention calls a forward, "
        f"{decode_gn} GroupNorms a decode")
    check((attn_calls, decode_gn) == (DIT_ATTN_PER_FORWARD, GN_PER_DECODE),
          f"DiT module trees give {DIT_ATTN_PER_FORWARD} attention and {GN_PER_DECODE} "
          "GroupNorm calls")

    # (a) agreement at b2: a forward, then a 5-step DDIMCFG request to images
    b = DIT_CHECK_BATCH
    x = torch.randn(b, *shape, generator=g, device=dev)
    ts = torch.tensor([999, 421], device=dev)
    ys = torch.tensor([DIT_CLASS, num_classes], device=dev)
    with torch.no_grad():
        zero_counts()
        got_k = vit(x, ts, ys)
        torch.cuda.synchronize()
        fwd_launches = counts()
        with plain_ops():
            got_p, want = vit(x, ts, ys), ref_vit(x, ts, ys)
    err_k, err_p = rel_err(got_k, want), rel_err(got_p, want)
    log(f"DiT-XL/2 b{b} forward: rel L2 err vs f32 plain: kernels {err_k:.3e}, plain bf16 "
        f"{err_p:.3e}; launches {fwd_launches}")
    check(tuple(got_k.shape) == (b, 8) + shape[1:] and bool(torch.isfinite(got_k).all())
          and err_k <= 1.5 * err_p + 1e-3,
          f"DiT forward: [{b}, 8, {shape[1]}, {shape[2]}], err(kernels) <= 1.5 err(plain) "
          "+ 1e-3")
    check(fwd_launches == {"K1": DIT_ATTN_PER_FORWARD, "K2": 0, "K3": 0},
          f"DiT forward launches {fwd_launches} == K1 {DIT_ATTN_PER_FORWARD}")
    small = dict(shape=shape, num_classes=num_classes, batch_size=b, seed=SEED, device=dev)
    rows = len(diffuser(DIT_CHECK_STEPS).respaced_seq)
    zero_counts()
    img_k = sample_class(model, diffuser(DIT_CHECK_STEPS), DIT_CLASS, b, **small)
    torch.cuda.synchronize()
    req_launches = counts()
    with plain_ops():
        img_p = sample_class(model, diffuser(DIT_CHECK_STEPS), DIT_CLASS, b, **small)
        model.vit = ref_vit
        try:
            img_f = sample_class(model, diffuser(DIT_CHECK_STEPS), DIT_CLASS, b, **small)
        finally:
            model.vit = vit
    err_k, err_p = rel_err(img_k, img_f), rel_err(img_p, img_f)
    log(f"DiT b{b}, {rows} DDIMCFG steps, s={DIT_SCALE}, class {DIT_CLASS}, {size}x{size} "
        f"images: "
        f"rel L2 err vs the f32 plain run: kernels {err_k:.3e}, plain bf16 {err_p:.3e}; std "
        f"{img_k.float().std().item():.3f}; launches {req_launches}")
    check(tuple(img_k.shape) == (b, 3, size, size) and bool(torch.isfinite(img_k).all())
          and err_k <= 1.5 * err_p + 1e-3,
          f"DiT request b{b}: [{b}, 3, {size}, {size}], err(kernels) <= 1.5 err(plain) + 1e-3")
    want_small = {"K1": rows * DIT_ATTN_PER_FORWARD, "K2": 0, "K3": GN_PER_DECODE}
    check(req_launches == want_small, f"DiT request b2 launches {req_launches} == {want_small}")
    check(img_k.float().std().item() > 1e-2 and not torch.equal(img_k[0], img_k[1]),
          "DiT request b2: the images vary, and from sample to sample")
    del got_k, got_p, want, img_k, img_p, img_f, ref_vit
    torch.cuda.empty_cache()

    # (b) K1 at the request's shape: b64 (the CFG-doubled b32) h16 S=256 d=72,
    # q, k and v strided views of one projection, as TimmAttention hands them
    n, (sq, sk, d), h = 2 * DIT_B, DIT_ATTN, DIT_HEADS
    qkv = torch.randn(n, sq, 3, h, d, generator=g, device=dev).bfloat16()
    k1_row, k1_per_forward = k1_call_row(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], DIT_ATTN_PER_FORWARD,
        "DiT's shape, strided q/k/v", check, time_ms, host_us, card, 50)
    del qkv
    torch.cuda.empty_cache()

    # (c) the timed request: b32, class 207, DDIMCFG-50, s = 4, 256x256, with
    # the VAE's f32 convolutions in TF32 (cuDNN's default, which the CLI keeps)
    torch.backends.cudnn.allow_tf32 = True
    events = []

    def on_stage(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append((name, event))

    timed = dict(shape=shape, num_classes=num_classes, batch_size=DIT_B, seed=SEED, device=dev)
    sampler = diffuser(DIT_STEPS)
    rows = len(sampler.respaced_seq)
    sample_class(model, sampler, DIT_CLASS, DIT_B, **timed)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    on_stage("begin")
    images = sample_class(model, sampler, DIT_CLASS, DIT_B, on_stage=on_stage, **timed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_kernel = counts(), dict(flash_attention_fwd.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    stage_ms = {name: before.elapsed_time(after)
                for (_, before), (name, after) in zip(events, events[1:])}
    want = {"K1": rows * DIT_ATTN_PER_FORWARD, "K2": 0, "K3": GN_PER_DECODE}
    # one sampler step's model call on the CFG-doubled batch, profiled
    x2 = torch.randn(2 * DIT_B, *shape, generator=g, device=dev)
    t2 = torch.full((2 * DIT_B,), 500, device=dev)
    y2 = torch.cat([torch.full((DIT_B,), DIT_CLASS, device=dev),
                    torch.full((DIT_B,), num_classes, device=dev)])
    with torch.no_grad():
        step_ms = time_ms(lambda: vit(x2, t2, y2), 5)
        profile = profile_by_class(lambda: vit(x2, t2, y2), 2)
        z = torch.randn(DIT_B, *shape, generator=g, device=dev)
        decode_profile = profile_by_class(lambda: model.decode_latent(z), 1)
    metrics = {"imgs_per_s": DIT_B / seconds, "seconds": seconds, "batch": DIT_B, "steps": rows,
               "size": size, "class": DIT_CLASS,
               "guidance_scale": DIT_SCALE, "stage_ms": stage_ms, "peak_bytes": peak,
               "cfg_forward_ms": step_ms, "cfg_forward_profile_ms": profile["classes"],
               "cfg_forward_wall_ms": profile["wall_ms"],
               "vae_decode_profile_ms": decode_profile["classes"], "launches": launches,
               "k1_by_kernel": by_kernel}
    log(f"DiT-XL/2 b{DIT_B}, DDIMCFG-{DIT_STEPS} ({rows} DiT calls on {2 * DIT_B} samples), "
        f"class {DIT_CLASS}, s={DIT_SCALE}, {size}x{size}: {seconds:.3f} s, "
        f"{metrics['imgs_per_s']:.4f} images/s, stages (CUDA events, ms) {json.dumps(stage_ms)}, "
        f"peak {peak / 2**30:.3f} GiB ({card}); launches {launches}, K1 by kernel {by_kernel}")
    log(f"DiT-XL/2 forward on {2 * DIT_B} samples: {step_ms:.3f} ms (CUDA events, 5 forwards); "
        f"device time by class (torch.profiler, ms per forward over 2; wall "
        f"{profile['wall_ms']:.3f} ms under the profiler): " + json.dumps(profile["classes"]))
    for name, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {name}")
    log(f"VAE decode b{DIT_B} {size}x{size}, TF32, device time by class (one decode): "
        + json.dumps(decode_profile["classes"]))
    check(tuple(images.shape) == (DIT_B, 3, size, size) and bool(torch.isfinite(images).all())
          and images.float().std().item() > 1e-2,
          f"DiT request b{DIT_B}: finite [{DIT_B}, 3, {size}, {size}]")
    check(launches == want, f"DiT request b{DIT_B} launches {launches} == {want}")
    check(by_kernel == {"mma": 0, "wgmma": want["K1"]},
          f"DiT request b{DIT_B}: every K1 launch through wgmma {by_kernel}")
    check(profile["classes"]["K1 attention"] > 0, "profile: the DiT forward ran K1 on the card")
    del images, x2, t2, y2, z
    torch.cuda.empty_cache()

    # (d) MDTv2-XL/2 (the class's defaults) on a DDIMCFG-10 b8 request: its
    # relative-position attention is plain PyTorch, so K1 is not launched
    mdt_conf = {"target": "models.mdt.mdt.MDT",
                "params": {"vit_config": {"target": "models.mdt.model.MDTv2",
                                          "params": {"dtype": "bfloat16"}},
                           "vae_config": conf.model.params.vae_config}}
    mdt = instantiate_from_config(Config(mdt_conf), device=dev).eval()
    init_random_(mdt.vit, g)
    mdt.vae.load_state_dict(model.vae.state_dict())
    del model, vit
    torch.cuda.empty_cache()
    log(f"MDTv2-XL/2: {sum(p.numel() for p in mdt.vit.parameters())} params, "
        f"{len(mdt.vit.en_inblocks) + len(mdt.vit.en_outblocks) + len(mdt.vit.de_blocks)} "
        f"blocks (+1 side block), decode_layer {mdt.vit.decode_layer}")
    small = dict(timed, batch_size=MDT_B)
    sampler = diffuser(MDT_STEPS)
    rows = len(sampler.respaced_seq)
    sample_class(mdt, sampler, DIT_CLASS, MDT_B, **small)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    images = sample_class(mdt, sampler, DIT_CLASS, MDT_B, **small)
    torch.cuda.synchronize()
    mdt_seconds = time.perf_counter() - t0
    mdt_launches = counts()
    want = {"K1": 0, "K2": 0, "K3": GN_PER_DECODE}
    log(f"MDTv2-XL/2 b{MDT_B}, DDIMCFG-{MDT_STEPS} ({rows} calls on {2 * MDT_B} samples), "
        f"{size}x{size}: {mdt_seconds:.3f} s, {MDT_B / mdt_seconds:.4f} images/s ({card}); "
        f"launches {mdt_launches}")
    check(tuple(images.shape) == (MDT_B, 3, size, size) and bool(torch.isfinite(images).all())
          and images.float().std().item() > 1e-2,
          f"MDTv2 request b{MDT_B}: finite [{MDT_B}, 3, {size}, {size}]")
    check(mdt_launches == want, f"MDTv2 request b{MDT_B} launches {mdt_launches} == {want}")
    metrics["mdt_b8_ddimcfg10"] = {"imgs_per_s": MDT_B / mdt_seconds, "seconds": mdt_seconds,
                                   "steps": rows, "launches": mdt_launches}
    del mdt, images
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    return {"launches": {"dit_ddimcfg50": launches, "mdt_ddimcfg10": mdt_launches},
            "metrics": metrics, "k1": k1_row, "k1_per_forward": k1_per_forward}


def phase_dit_train(dev, check, gen, card, time_ms, host_us) -> dict:
    """Phase 12 (see the module docstring): DiT-XL/2 class-conditional
    training through K1 and K2 at head dim 72, ``train_ddpm_cfg`` in this
    process, and an MDTv2-XL/2 step."""
    import shutil
    import tempfile

    import torch
    import yaml
    from dmtpu_torch.diffusions import DDPM
    from dmtpu_torch.models.dit import DiT
    from dmtpu_torch.models.mdt import MDTv2, sample_len_keep
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
    from dmtpu_torch.scripts import train_ddpm_cfg
    from dmtpu_torch.utils import checkpoint as ckpt_lib
    from dmtpu_torch.utils.config import Config
    from dmtpu_torch.utils.optim import adafactor

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)
        flash_attention_bwd.launches_by_kernel.update(mma=0, wgmma=0)

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def by_kernel():
        return {"K1": dict(flash_attention_fwd.launches_by_kernel),
                "K2": dict(flash_attention_bwd.launches_by_kernel)}

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, h, (sq, sk, d) = DIT_TRAIN_B, DIT_HEADS, DIT_ATTN
    per_step = {"K1": DIT_ATTN_PER_FORWARD, "K2": DIT_ATTN_PER_FORWARD, "K3": 0}
    all_wgmma = {"K1": {"mma": 0, "wgmma": DIT_ATTN_PER_FORWARD},
                 "K2": {"mma": 0, "wgmma": DIT_ATTN_PER_FORWARD}}

    # (a) K2 at DiT's shape, b32 h16 S=256 d=72, from K1's outputs and a
    # random dO; q, k and v strided views of one projection, as
    # TimmAttention hands them
    g = gen(SEED + 30)
    qkv = torch.randn(n, sq, 3, h, d, generator=g, device=dev).bfloat16()
    do = torch.randn(n, sq, h, d, generator=g, device=dev).bfloat16()
    k2_row, k2_per_step = k2_call_row(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do,
                                      DIT_ATTN_PER_FORWARD, "DiT's shape, strided q/k/v", check,
                                      time_ms, host_us, card, 20)
    del qkv, do
    torch.cuda.empty_cache()

    # (b) agreement at b2: the loss and the gradient of a DiT-XL/2 step
    # through the kernels and through the plain bf16 path, each against an
    # f32 plain run (TF32 off); seeded non-zero weights (adaLN-Zero and the
    # final layer too, or most gradients would be zero)
    model = DiT(**DIT_TRAIN, device=dev).train()
    init_random_(model, g)
    ref = DiT(**dict(DIT_TRAIN, dtype=None), device=dev).train()
    ref.load_state_dict(model.state_dict())
    diffuser = DDPM(total_steps=1000)
    b = DIT_TRAIN_CHECK_BATCH
    fixed = {"x": torch.randn(b, 4, 32, 32, generator=g, device=dev),
             "eps": torch.randn(b, 4, 32, 32, generator=g, device=dev),
             "t": torch.tensor([999, 421], device=dev)[:b],
             "y": torch.tensor([DIT_CLASS, 1000], device=dev)[:b]}  # a class and the null row

    def loss_and_grads(m, plain: bool):
        m.zero_grad(set_to_none=True)
        with plain_ops() if plain else contextlib.nullcontext():
            loss = diffuser.loss_func(lambda xt, tt: m(xt, tt, fixed["y"], train=True),
                                      fixed["x"], fixed["t"], eps=fixed["eps"])
            loss.backward()
        grads = {name: p.grad.detach().clone() for name, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.detach(), grads

    def grad_err(grads, want) -> float:
        return (sum((grads[k_] - want[k_]).square().sum() for k_ in want).sqrt()
                / sum(w.square().sum() for w in want.values()).sqrt()).item()

    def norm(grads) -> float:
        return sum(x.square().sum() for x in grads.values()).sqrt().item()

    loss_f, grads_f = loss_and_grads(ref, plain=True)
    del ref
    zero_counts()
    loss_k, grads_k = loss_and_grads(model, plain=False)
    torch.cuda.synchronize()
    step_launches, step_by_kernel = counts(), by_kernel()
    loss_p, grads_p = loss_and_grads(model, plain=True)
    errs = {"loss": (abs(loss_k.item() - loss_f.item()) / abs(loss_f.item()),
                     abs(loss_p.item() - loss_f.item()) / abs(loss_f.item())),
            "gradient": (grad_err(grads_k, grads_f), grad_err(grads_p, grads_f)),
            "grad_norm": (abs(norm(grads_k) - norm(grads_f)) / norm(grads_f),
                          abs(norm(grads_p) - norm(grads_f)) / norm(grads_f))}
    log(f"DiT-XL/2 train b{b}: loss f32 {loss_f.item():.6f}, kernels {loss_k.item():.6f}, plain "
        f"bf16 {loss_p.item():.6f}; grad norm f32 {norm(grads_f):.6f}; rel err vs f32 "
        "(kernels, plain bf16): " + json.dumps(errs) + f"; launches {step_launches}, by kernel "
        f"{step_by_kernel}")
    for what, (err_k, err_p) in errs.items():
        check(math.isfinite(err_k) and err_k <= 1.5 * err_p + 1e-3,
              f"DiT train {what}: err(kernels) <= 1.5 err(plain) + 1e-3")
    check(step_launches == per_step and step_by_kernel == all_wgmma,
          f"DiT train forward+backward launches {step_launches} == {per_step}, all wgmma "
          f"{step_by_kernel}")
    del grads_f, grads_k, grads_p
    torch.cuda.empty_cache()

    # (c) bench.py's dit_train: b32, adafactor 1e-4, clip 1.0, no EMA, the
    # diffusion loss's own t and eps; PyTorch's default TF32 settings
    torch.backends.cudnn.allow_tf32 = True
    state = TrainState.create(model, adafactor(model.parameters(), lr=TRAIN_LR), ema_decay=None)
    step = make_train_step(make_diffusion_loss_fn(diffuser, model, 1000),
                           clip_grad_norm=TRAIN_CLIP)
    batch = {"image": torch.randn(n, 4, 32, 32, generator=g, device=dev),
             "y": torch.randint(0, 1000, (n,), generator=g, device=dev)}
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    history = [step(state, batch) for _ in range(DIT_TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, kernels_used = counts(), by_kernel()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in history]
    norms = [m["grad_norm"].item() for m in history]
    profile = profile_by_class(lambda: step(state, batch), 2)
    idle = 1 - profile["classes"]["total"] / profile["wall_ms"]
    metrics = {"imgs_per_s": n * DIT_TRAIN_STEPS / seconds,
               "ms_per_step": 1e3 * seconds / DIT_TRAIN_STEPS, "peak_bytes": peak, "batch": n,
               "steps": DIT_TRAIN_STEPS, "launches_per_step": per_step,
               "profile_ms": dict(profile["classes"], wall=profile["wall_ms"],
                                  **profile["ranges"]),
               "idle_share": idle}
    log(f"DiT-XL/2 train b{n}: {DIT_TRAIN_STEPS} steps in {seconds:.3f} s, "
        f"{metrics['imgs_per_s']:.4f} imgs/s, {metrics['ms_per_step']:.3f} ms/step, peak "
        f"{peak / 2**30:.3f} GiB ({card}); launches {launches}, by kernel {kernels_used}; losses "
        f"{losses}; grad norms {norms}")
    log(f"DiT-XL/2 train b{n} step device time by class (torch.profiler, ms per step over 2; wall "
        f"{profile['wall_ms']:.3f} ms per step under the profiler, the card idle {idle:.3f} of "
        "it): " + json.dumps(profile["classes"]) + "; annotated ranges: "
        + json.dumps(profile["ranges"]))
    for name, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {name}")
    check(all(map(math.isfinite, losses + norms)), f"DiT train b{n}: finite losses and grad norms")
    check(launches == {key: DIT_TRAIN_STEPS * c for key, c in per_step.items()}
          and kernels_used == {key: {kern: DIT_TRAIN_STEPS * c for kern, c in row.items()}
                               for key, row in all_wgmma.items()},
          f"DiT train b{n} launches {launches} == {DIT_TRAIN_STEPS} x {per_step}, all wgmma "
          f"{kernels_used}")
    check(profile["classes"]["K2 attention backward"] > 0,
          "profile: the DiT train step ran K2 on the card")
    del state, step, batch, history, model
    torch.cuda.empty_cache()

    # (d) train_ddpm_cfg in this process, from a config written here: the
    # model initialised the CLI's way (adaLN-Zero), a bf16 EMA, label dropout
    tmp = tempfile.mkdtemp(prefix="dmtpu_dit_cli_")
    try:
        cli_conf = {
            "seed": SEED,
            "data": {"target": "datasets.synthetic.Synthetic",
                     "params": {"img_size": 32, "channels": 4, "n": DIT_CLI_IMAGES,
                                "num_classes": 1000, "seed": SEED},
                     "img_channels": 4, "num_classes": 1000},
            "dataloader": {"num_workers": 4},
            "model": {"target": "models.dit.model.DiT", "params": dict(DIT_TRAIN)},
            "diffusion": {"target": "diffusions.ddpm.DDPM",
                          "params": {"total_steps": 1000, "beta_schedule": "linear",
                                     "beta_start": 0.0001, "beta_end": 0.02,
                                     "objective": "pred_eps", "var_type": "fixed_large"}},
            "train": {"n_steps": DIT_CLI_STEPS, "batch_size": n, "micro_batch": 0,
                      "clip_grad_norm": TRAIN_CLIP, "ema_decay": EMA_DECAY, "ema_gradual": True,
                      "ema_dtype": "bfloat16", "print_freq": 1, "save_freq": 2,
                      "sample_freq": 3, "n_samples_each_class": 1, "p_uncond": 0.1,
                      "optim": {"target": "dmtpu.utils.optim.adafactor",
                                "params": {"lr": TRAIN_LR}}},
        }
        cfg = os.path.join(tmp, "dit_xl2_cfg.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump(cli_conf, f)
        exp = os.path.join(tmp, "exp")
        rows = len(train_ddpm_cfg.eval_sampler(Config(cli_conf)).respaced_seq)
        sampled = DIT_ATTN_PER_FORWARD * rows  # one eval grid: one DiT call a row
        zero_counts()
        first = train_ddpm_cfg.main(["-c", cfg, "-e", exp, "-ni"])
        torch.cuda.synchronize()
        run1 = counts()
        zero_counts()
        again = train_ddpm_cfg.main(["-c", cfg, "-e", exp, "-ni", "-r", "latest",
                                     f"train.n_steps={DIT_CLI_RESUMED_STEPS}"])
        torch.cuda.synchronize()
        run2 = counts()
        ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
        state_file = os.path.join(exp, "ckpt", ckpts[-1], "state.pt")
        ckpt_bytes = os.path.getsize(state_file)
        blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", ckpts[-1]))
        grids = sorted(os.listdir(os.path.join(exp, "samples")))
        from dmtpu_torch.utils.image import pil_image

        with pil_image().open(os.path.join(exp, "samples", grids[0])) as im:
            grid_mode, grid_size = im.mode, im.size
        log_text = "".join(open(os.path.join(exp, f)).read() for f in os.listdir(exp)
                           if f.startswith("output-"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # an interval between two ticks of the loop spans the later step and
    # whatever the loop did after the earlier one: keep those after a step
    # with no save and no eval grid
    def busy(i):
        return (i + 1) % cli_conf["train"]["save_freq"] == 0 or \
            (i + 1) % cli_conf["train"]["sample_freq"] == 0

    cli_steps = [sec for start, run in ((0, first), (DIT_CLI_STEPS, again))
                 for j, sec in enumerate(run["step_seconds"]) if not busy(start + j)]
    step_ms = 1e3 * sum(cli_steps) / len(cli_steps)
    losses = first["losses"] + again["losses"]
    metrics["cli"] = {"ms_per_step": step_ms, "step_ms": [1e3 * x for x in cli_steps],
                      "imgs_per_s": n / (step_ms / 1e3), "losses": losses,
                      "save_seconds": first["save_seconds"] + again["save_seconds"],
                      "load_seconds": again["load_seconds"], "checkpoint_bytes": ckpt_bytes,
                      "launches": {"train": run1, "resume": run2}, "eval_rows": rows}
    log(f"train_ddpm_cfg DiT-XL/2 b{n}: {DIT_CLI_STEPS} steps, then -r latest to "
        f"{DIT_CLI_RESUMED_STEPS}: ms per step (host clock between the loop's steps, the mean "
        f"of {len(cli_steps)} with no save or grid between them) {step_ms:.3f}, each "
        f"{metrics['cli']['step_ms']}; checkpoint "
        f"{ckpt_bytes / 2**30:.3f} GiB, saves {metrics['cli']['save_seconds']} s, load "
        f"{again['load_seconds']:.3f} s ({card}); losses {losses}; launches {run1}, {run2}; "
        f"checkpoints {ckpts}, grids {grids} ({grid_mode}, {grid_size})")
    check(ckpts == ["step000001", "step000003", "step000005"] and blob["step"] ==
          DIT_CLI_RESUMED_STEPS and blob["ema"]["num_updates"] == DIT_CLI_RESUMED_STEPS
          and all(x.dtype == torch.bfloat16 for x in blob["ema"]["shadow"].values())
          and "Resumed from" in log_text,
          "train_ddpm_cfg: checkpoints at steps 2, 4 and 6, resumed to step 6, bf16 EMA")
    check(grids == ["step000002.png", "step000005.png"] and grid_mode == "RGBA"
          and grid_size == (32 + 4, 10 * 34 + 2),
          "train_ddpm_cfg: the eval grids of 10 classes x 1 latent, RGBA")
    check(len(losses) == DIT_CLI_RESUMED_STEPS and all(map(math.isfinite, losses)),
          "train_ddpm_cfg: finite losses at every step")
    want1 = {"K1": DIT_CLI_STEPS * DIT_ATTN_PER_FORWARD + sampled,
             "K2": DIT_CLI_STEPS * DIT_ATTN_PER_FORWARD, "K3": 0}
    want2 = {"K1": (DIT_CLI_RESUMED_STEPS - DIT_CLI_STEPS) * DIT_ATTN_PER_FORWARD + sampled,
             "K2": (DIT_CLI_RESUMED_STEPS - DIT_CLI_STEPS) * DIT_ATTN_PER_FORWARD, "K3": 0}
    check(run1 == want1 and run2 == want2,
          f"train_ddpm_cfg launches {run1} == {want1}, resumed {run2} == {want2}")
    del blob
    torch.cuda.empty_cache()

    # (e) MDTv2-XL/2 (the class's defaults, learn_sigma off as in (c)) at b8:
    # one unmasked train step through the same loss, then a masked forward
    # and backward; its attention is plain PyTorch, so only times are read
    mdt = MDTv2(learn_sigma=False, mask_ratio=MDT_MASK_RATIO, dtype="bfloat16",
                device=dev).train()
    init_random_(mdt, g)
    state = TrainState.create(mdt, adafactor(mdt.parameters(), lr=TRAIN_LR), ema_decay=None)
    step = make_train_step(make_diffusion_loss_fn(diffuser, mdt, 1000), clip_grad_norm=TRAIN_CLIP)
    batch = {"image": torch.randn(MDT_TRAIN_B, 4, 32, 32, generator=g, device=dev),
             "y": torch.randint(0, 1000, (MDT_TRAIN_B,), generator=g, device=dev)}
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    m = step(state, batch)
    torch.cuda.synchronize()
    mdt_step_ms = 1e3 * (time.perf_counter() - t0)
    mdt_launches = counts()
    len_keep = sample_len_keep(mdt.num_patches, MDT_MASK_RATIO, 0.5)
    mdt.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    out = mdt(batch["image"], torch.full((MDT_TRAIN_B,), 500, device=dev), batch["y"],
              enable_mask=True, len_keep=len_keep, mask_generator=g, train=True)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    masked_ms = 1e3 * (time.perf_counter() - t0)
    grads = [p.grad for p in mdt.parameters() if p.grad is not None]
    side = max(p.grad.abs().max().item() for name, p in mdt.named_parameters()
               if name.startswith("sideblocks.") and p.grad is not None)
    metrics["mdt_b8"] = {"train_step_ms": mdt_step_ms, "masked_fwd_bwd_ms": masked_ms,
                         "len_keep": len_keep, "loss": m["loss"].item(),
                         "grad_norm": m["grad_norm"].item(), "launches": mdt_launches}
    log(f"MDTv2-XL/2 b{MDT_TRAIN_B}: unmasked train step {mdt_step_ms:.3f} ms (host clock, "
        f"synchronised), masked (mask_ratio {MDT_MASK_RATIO}, {len_keep} of "
        f"{mdt.num_patches} tokens kept) forward and backward {masked_ms:.3f} ms ({card}); loss "
        f"{m['loss'].item():.6f}, grad norm {m['grad_norm'].item():.6f}; launches {mdt_launches}")
    check(math.isfinite(m["loss"].item()) and math.isfinite(m["grad_norm"].item())
          and len(grads) == len(list(mdt.parameters()))
          and all(bool(torch.isfinite(x).all()) for x in grads) and side > 0,
          f"MDTv2 b{MDT_TRAIN_B}: finite unmasked step, masked backward reaches every parameter "
          "(the side interpolater too) with finite gradients")
    check(mdt_launches == {"K1": 0, "K2": 0, "K3": 0},
          f"MDTv2 train step launches {mdt_launches}: no kernel (plain attention)")
    del mdt, state, step, batch, out, grads
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    return {"launches": {f"dit_train{DIT_TRAIN_STEPS}": launches, "dit_cli_train": run1,
                         "dit_cli_resume": run2},
            "metrics": metrics, "k2": k2_row, "k2_per_step": k2_per_step,
            "k2_by_kernel": kernels_used["K2"]}


def phase_mmdit(dev, check, gen, card, time_ms, host_us) -> dict:
    """Phase 13 (see the module docstring): MMDiT text to image through
    ``sample_mmdit``'s request function, SD3-medium at 1024x1024 and
    ``bench.py``'s MMDiT-B/2, and K1 at head dim 64."""
    import argparse

    import torch
    from dmtpu_torch.diffusions import FlowDPMSolverCFG
    from dmtpu_torch.models.mmdit import MMDiT, MMDiTBlock, mmdit_model
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.scripts import sample_mmdit as cli
    from dmtpu_torch.utils.config import instantiate_from_config, load_config, merge_dotlist

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_err(a, ref) -> float:
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    g = gen(SEED + 30)

    # (a) K1 at d=64: the joint attention's shapes, q, k and v made by torch.cat
    # of the context and image streams, as MMDiTBlock hands them
    k1_rows, k1_per_forward = {}, {}
    for name, (n, h, s) in MMDIT_ATTN.items():
        lc = MMDIT_CONTEXT_TOKENS[name]
        q, k, v = (torch.cat([torch.randn(n, lc, h, 64, generator=g, device=dev),
                              torch.randn(n, s - lc, h, 64, generator=g, device=dev)],
                             1).bfloat16() for _ in range(3))
        k1_rows[name], k1_per_forward[name] = k1_call_row(
            q, k, v, MMDIT_ATTN_PER_FORWARD[name], f"{name}, torch.cat of the two streams",
            check, time_ms, host_us, card, 20)
        del q, k, v
        torch.cuda.empty_cache()

    # the SD3-medium stack from the repository's config, as the CLI builds it
    conf = merge_dotlist(load_config(SD3_CONFIG), SD3_OVERRIDES)
    size = conf.data.params.img_size
    shape = (conf.data.img_channels, size, size)
    args = argparse.Namespace(embeddings=None, class_idx=None, prompt=SD3_PROMPT, weights=None,
                              context_len=None, respace_type="uniform", respace_steps=None,
                              solver=None, time_shift=None, guidance_scale=None)
    context, pooled = cli.conditioning(args, conf)
    model = cli.build_model(conf, None, dev)
    decoder = cli.build_decoder(conf, None, dev)
    init_random_(model, g)  # adaLN-Zero and the final layer non-zero: else the output is 0
    init_random_(decoder.vae, g)
    ref = instantiate_from_config(dict(conf.model, params=dict(conf.model.params, dtype=None)),
                                  device=dev).eval()
    ref.load_state_dict(model.state_dict())
    blocks = sum(isinstance(m, MMDiTBlock) for m in model.modules())
    decode_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in decoder.vae.decoder.modules())
    log(f"SD3-medium MMDiT-L/2: {sum(p.numel() for p in model.parameters())} params (f32), "
        f"depth {model.depth}, hidden {model.hidden_size}, heads {model.num_heads} of "
        f"{model.hidden_size // model.num_heads}, {model.grid ** 2} + {context.shape[1]} tokens, "
        f"dtype {model.dtype}; VAE {sum(p.numel() for p in decoder.vae.parameters())} params; "
        f"from the module trees: {blocks} joint attentions a forward, {decode_gn} GroupNorms a "
        f"decode")
    check(isinstance(model, MMDiT) and model.dtype == torch.bfloat16
          and (blocks, decode_gn) == (MMDIT_ATTN_PER_FORWARD["sd3_medium_b4"], GN_PER_DECODE)
          and shape == (16, 128, 128),
          "SD3-medium from configs/sd3_medium.yaml: bf16 torso, 24 joint attentions, 30 "
          "GroupNorms a decode, 128x128x16 latents")

    def diffuser(steps):
        return cli.make_diffuser(argparse.Namespace(**{**vars(args), "respace_steps": steps}),
                                 conf)

    # (b) agreement at b2, TF32 off: a forward of the CFG-doubled batch, then a
    # short request to 1024x1024 images, each three ways
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn(2 * SD3_B, *shape, generator=g, device=dev)
    ts = torch.tensor([999.0, 750.5, 421.25, 3.0][:2 * SD3_B], device=dev)
    ctx = torch.as_tensor(context, device=dev).expand(2 * SD3_B, -1, -1).contiguous()
    ctx[SD3_B:] = 0  # the unconditional half: the null conditioning
    y = {"context": ctx, "pooled": torch.as_tensor(pooled, device=dev).repeat(2 * SD3_B, 1)}
    y["pooled"][SD3_B:] = 0
    with torch.no_grad():
        zero_counts()
        got_k = model(x, ts, y)
        torch.cuda.synchronize()
        fwd_launches = counts()
        with plain_ops():
            got_p, want = model(x, ts, y), ref(x, ts, y)
    err_k, err_p = rel_err(got_k, want), rel_err(got_p, want)
    log(f"MMDiT-L/2 b{2 * SD3_B} forward: rel L2 err vs f32 plain: kernels {err_k:.3e}, plain "
        f"bf16 {err_p:.3e}; std {want.std().item():.3f}; launches {fwd_launches}")
    check(tuple(got_k.shape) == (2 * SD3_B,) + shape and bool(torch.isfinite(got_k).all())
          and err_k <= 1.5 * err_p + 1e-3,
          "MMDiT-L/2 forward: err(kernels) <= 1.5 err(plain) + 1e-3")
    want_fwd = {"K1": MMDIT_ATTN_PER_FORWARD["sd3_medium_b4"], "K2": 0, "K3": 0}
    check(fwd_launches == want_fwd, f"MMDiT-L/2 forward launches {fwd_launches} == {want_fwd}")
    del got_k, got_p, want, x, y, ctx
    small = dict(shape=shape, batch_size=SD3_B, seed=SEED, decode=decoder, device=dev)
    zero_counts()
    img_k, _ = cli.sample_mmdit(model, diffuser(SD3_CHECK_STEPS), context, pooled, SD3_B, **small)
    torch.cuda.synchronize()
    req_launches = counts()
    with plain_ops():
        img_p, _ = cli.sample_mmdit(model, diffuser(SD3_CHECK_STEPS), context, pooled, SD3_B,
                                    **small)
        img_f, _ = cli.sample_mmdit(ref, diffuser(SD3_CHECK_STEPS), context, pooled, SD3_B,
                                    **small)
    err_k, err_p = rel_err(img_k, img_f), rel_err(img_p, img_f)
    px = size * 8
    log(f"SD3-medium b{SD3_B}, Euler-{SD3_CHECK_STEPS}, s={SD3_SCALE}, {px}x{px} images: rel L2 "
        f"err vs the f32 plain run: kernels {err_k:.3e}, plain bf16 {err_p:.3e}; std "
        f"{img_k.float().std().item():.3f}; launches {req_launches}")
    check(tuple(img_k.shape) == (SD3_B, 3, px, px) and bool(torch.isfinite(img_k).all())
          and err_k <= 1.5 * err_p + 1e-3,
          f"SD3-medium request b{SD3_B}: [{SD3_B}, 3, {px}, {px}], err(kernels) <= 1.5 "
          "err(plain) + 1e-3")
    want_small = {"K1": SD3_CHECK_STEPS * MMDIT_ATTN_PER_FORWARD["sd3_medium_b4"], "K2": 0,
                  "K3": GN_PER_DECODE}
    check(req_launches == want_small,
          f"SD3-medium request b{SD3_B} launches {req_launches} == {want_small}")
    check(img_k.float().std().item() > 1e-2 and not torch.equal(img_k[0], img_k[1]),
          "SD3-medium request: the images vary, and from sample to sample")
    del img_k, img_p, img_f, ref
    torch.cuda.empty_cache()

    # (c) the timed SD3-medium request: b2, Euler-28, shift 3, CFG 4, 1024x1024,
    # the VAE's f32 convolutions in TF32 (cuDNN's default, which the CLI keeps)
    torch.backends.cudnn.allow_tf32 = True
    sampler = diffuser(None)
    rows = len(sampler.respaced_seq)
    cli.sample_mmdit(model, sampler, context, pooled, SD3_B, **small)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    images, stage_ms = cli.sample_mmdit(model, sampler, context, pooled, SD3_B, **small)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_kernel = counts(), dict(flash_attention_fwd.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    params_bytes = sum(p.numel() * p.element_size() for m in (model, decoder)
                       for p in m.parameters())
    want = {"K1": rows * MMDIT_ATTN_PER_FORWARD["sd3_medium_b4"], "K2": 0, "K3": GN_PER_DECODE}
    # one sampler step's model call on the CFG-doubled batch, and one decode, profiled
    x2 = torch.randn(2 * SD3_B, *shape, generator=g, device=dev)
    t2 = torch.full((2 * SD3_B,), 500.0, device=dev)
    y2 = {"context": torch.as_tensor(context, device=dev).repeat(2 * SD3_B, 1, 1),
          "pooled": torch.as_tensor(pooled, device=dev).repeat(2 * SD3_B, 1)}
    with torch.no_grad():
        step_ms = time_ms(lambda: model(x2, t2, y2), 3)
        profile = profile_by_class(lambda: model(x2, t2, y2), 2)
        z = torch.randn(SD3_B, *shape, generator=g, device=dev)
        decode_profile = profile_by_class(lambda: decoder(z), 1)
    metrics = {"sd3_medium_b2": {
        "imgs_per_s": SD3_B / seconds, "seconds": seconds, "batch": SD3_B, "steps": rows,
        "size": px, "guidance_scale": sampler.guidance_scale, "stage_ms": stage_ms,
        "peak_bytes": peak, "params_bytes": params_bytes, "cfg_forward_ms": step_ms,
        "cfg_forward_profile_ms": profile["classes"], "cfg_forward_wall_ms": profile["wall_ms"],
        "vae_decode_profile_ms": decode_profile["classes"], "launches": launches,
        "k1_by_kernel": by_kernel}}
    log(f"SD3-medium b{SD3_B}, Euler-{rows} ({rows} MMDiT calls on {2 * SD3_B} samples), shift "
        f"{sampler.time_shift}, s={sampler.guidance_scale}, {px}x{px}: {seconds:.3f} s, "
        f"{SD3_B / seconds:.4f} images/s, stages (CUDA events, ms) {json.dumps(stage_ms)}, peak "
        f"{peak / 2**30:.3f} GiB (parameters {params_bytes / 2**30:.3f} GiB) ({card}); launches "
        f"{launches}, K1 by kernel {by_kernel}")
    log(f"MMDiT-L/2 forward on {2 * SD3_B} samples: {step_ms:.3f} ms (CUDA events, 3 forwards); "
        f"device time by class (torch.profiler, ms per forward over 2; wall "
        f"{profile['wall_ms']:.3f} ms under the profiler): " + json.dumps(profile["classes"]))
    for kname, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {kname}")
    log(f"VAE decode b{SD3_B} {px}x{px}, TF32, device time by class (one decode): "
        + json.dumps(decode_profile["classes"]))
    check(tuple(images.shape) == (SD3_B, 3, px, px) and bool(torch.isfinite(images).all())
          and images.float().std().item() > 1e-2 and set(stage_ms) == {"sample", "decode"},
          f"SD3-medium request b{SD3_B}: finite [{SD3_B}, 3, {px}, {px}], stage times")
    check(launches == want, f"SD3-medium request b{SD3_B} launches {launches} == {want}")
    check(by_kernel == {"mma": 0, "wgmma": want["K1"]},
          f"SD3-medium request: every K1 launch through wgmma {by_kernel}")
    check(profile["classes"]["K1 attention"] > 0, "profile: the MMDiT forward ran K1 on the card")
    del model, decoder, images, x2, t2, y2, z
    torch.cuda.empty_cache()

    # (d) bench.py's mmdit_sample: MMDiT-B/2, b32, FlowDPM-20, CFG 4, no VAE
    b2 = mmdit_model("MMDiT-B/2", **MMDIT_B2, device=dev).eval()
    init_random_(b2, g)
    b2_blocks = sum(isinstance(m, MMDiTBlock) for m in b2.modules())
    check(b2_blocks == MMDIT_ATTN_PER_FORWARD["mmdit_b2_b64"] and b2.qk_norm,
          f"MMDiT-B/2: {b2_blocks} joint attentions a forward, qk_norm on")
    b2_sampler = FlowDPMSolverCFG(guidance_scale=SD3_SCALE, total_steps=1000,
                                  respace_steps=MMDIT_B2_STEPS)
    b2_ctx = torch.randn(MMDIT_B2_B, MMDIT_B2_CTX, MMDIT_B2["context_dim"], generator=g,
                         device=dev)
    b2_pooled = torch.randn(MMDIT_B2_B, MMDIT_B2["pooled_dim"], generator=g, device=dev)
    b2_shape = (MMDIT_B2["in_channels"], MMDIT_B2["input_size"], MMDIT_B2["input_size"])
    b2_kw = dict(shape=b2_shape, batch_size=MMDIT_B2_B, seed=SEED, device=dev)
    cli.sample_mmdit(b2, b2_sampler, b2_ctx, b2_pooled, MMDIT_B2_B, **b2_kw)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    latents, b2_stages = cli.sample_mmdit(b2, b2_sampler, b2_ctx, b2_pooled, MMDIT_B2_B, **b2_kw)
    torch.cuda.synchronize()
    b2_seconds = time.perf_counter() - t0
    b2_launches, b2_by_kernel = counts(), dict(flash_attention_fwd.launches_by_kernel)
    x2 = torch.randn(2 * MMDIT_B2_B, *b2_shape, generator=g, device=dev)
    t2 = torch.full((2 * MMDIT_B2_B,), 500.0, device=dev)
    y2 = {"context": b2_ctx.repeat(2, 1, 1), "pooled": b2_pooled.repeat(2, 1)}
    with torch.no_grad():
        b2_step_ms = time_ms(lambda: b2(x2, t2, y2), 10)
        b2_profile = profile_by_class(lambda: b2(x2, t2, y2), 3)
    b2_want = {"K1": MMDIT_B2_STEPS * MMDIT_ATTN_PER_FORWARD["mmdit_b2_b64"], "K2": 0, "K3": 0}
    metrics["mmdit_b2_b32"] = {
        "samples_per_s": MMDIT_B2_B / b2_seconds, "seconds": b2_seconds, "batch": MMDIT_B2_B,
        "steps": MMDIT_B2_STEPS, "stage_ms": b2_stages, "cfg_forward_ms": b2_step_ms,
        "cfg_forward_profile_ms": b2_profile["classes"],
        "cfg_forward_wall_ms": b2_profile["wall_ms"], "launches": b2_launches,
        "k1_by_kernel": b2_by_kernel}
    log(f"MMDiT-B/2 b{MMDIT_B2_B}, FlowDPM-{MMDIT_B2_STEPS} CFG {SD3_SCALE} on {b2_shape} latents, "
        f"{MMDIT_B2_CTX} context tokens: {b2_seconds:.3f} s, {MMDIT_B2_B / b2_seconds:.4f} "
        f"samples/s ({card}); launches {b2_launches}, K1 by kernel {b2_by_kernel}")
    log(f"MMDiT-B/2 forward on {2 * MMDIT_B2_B} samples: {b2_step_ms:.3f} ms (CUDA events, 10 "
        f"forwards); device time by class (ms per forward over 3; wall "
        f"{b2_profile['wall_ms']:.3f} ms under the profiler): "
        + json.dumps(b2_profile["classes"]))
    for kname, kernel_ms in b2_profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {kname}")
    check(tuple(latents.shape) == (MMDIT_B2_B,) + b2_shape and bool(torch.isfinite(latents).all())
          and latents.float().std().item() > 1e-2,
          f"MMDiT-B/2 request b{MMDIT_B2_B}: finite latents of {b2_shape}")
    check(b2_launches == b2_want, f"MMDiT-B/2 request launches {b2_launches} == {b2_want}")
    check(b2_by_kernel == {"mma": 0, "wgmma": b2_want["K1"]},
          f"MMDiT-B/2 request: every K1 launch through wgmma {b2_by_kernel}")
    del b2, latents, x2, t2, y2, b2_ctx, b2_pooled
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    return {"launches": {f"sd3_euler{rows}": launches,
                         f"mmdit_b2_flowdpm{MMDIT_B2_STEPS}": b2_launches},
            "metrics": metrics, "k1": k1_rows, "k1_per_forward": k1_per_forward}


def phase_mmdit_train(dev, check, gen, card, time_ms, host_us) -> dict:
    """Phase 14 (see the module docstring): MMDiT rectified-flow training
    through K1 and K2 at head dim 64, ``train_mmdit`` in this process on
    SD3-medium, and ``sample_cfg --sampler flow``."""
    import argparse
    import shutil
    import tempfile

    import torch
    from dmtpu_torch.diffusions import FlowMatching
    from dmtpu_torch.models.dit import DiT
    from dmtpu_torch.models.mmdit import MMDiTBlock, mmdit_model
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.ops.roofline import PEAK_BF16_FLOPS
    from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
    from dmtpu_torch.scripts import train_mmdit
    from dmtpu_torch.scripts.sample_cfg import make_diffuser, sample_class
    from dmtpu_torch.utils import checkpoint as ckpt_lib
    from dmtpu_torch.utils.config import Config, instantiate_from_config
    from dmtpu_torch.utils.optim import adafactor

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)
        flash_attention_bwd.launches_by_kernel.update(mma=0, wgmma=0)

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def by_kernel():
        return {"K1": dict(flash_attention_fwd.launches_by_kernel),
                "K2": dict(flash_attention_bwd.launches_by_kernel)}

    def all_wgmma(calls, steps=1):
        return {key: {"mma": 0, "wgmma": steps * calls[key]} for key in ("K1", "K2")}

    g = gen(SEED + 40)

    # (a) K1 and K2 at d=64 at the two train steps' joint attention: q, k and v
    # made by torch.cat of the two streams, as MMDiTBlock hands them, dO random
    k1_rows, k2_rows, k1_per_step, k2_per_step = {}, {}, {}, {}
    for name, (n, h, s) in MMDIT_TRAIN_ATTN.items():
        lc = MMDIT_TRAIN_CONTEXT[name]
        q, k, v = (torch.cat([torch.randn(n, lc, h, 64, generator=g, device=dev),
                              torch.randn(n, s - lc, h, 64, generator=g, device=dev)],
                             1).bfloat16() for _ in range(3))
        do = torch.randn(n, s, h, 64, generator=g, device=dev).bfloat16()
        slice_b = 2 if s > 1024 else 0  # the plain versions' f32 logits: 3.5 GB a slice
        reps = 10 if s > 1024 else 20
        label = f"{name}, torch.cat of the two streams"
        k1_rows[name], k1_per_step[name] = k1_call_row(
            q, k, v, MMDIT_TRAIN_CALLS[name]["K1"], label, check, time_ms, host_us, card, reps,
            slice_b=slice_b)
        k2_rows[name], k2_per_step[name] = k2_call_row(
            q, k, v, do, MMDIT_TRAIN_CALLS[name]["K2"], label, check, time_ms, host_us, card,
            reps, slice_b=slice_b)
        del q, k, v, do
        torch.cuda.empty_cache()

    # (b) agreement at b2 on bench's MMDiT-B/2: the loss, the gradient and its
    # norm through the kernels and through the plain bf16 path, each against an
    # f32 plain run (TF32 off); once with f32 parameters, once stored in bf16
    # (the f32 run then holds the same bf16-rounded weights); seeded non-zero
    # weights; the second sample's conditioning the all-zeros null
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    diffuser = FlowMatching(total_steps=1000)
    b = MMDIT_TRAIN_CHECK_BATCH
    shape = (MMDIT_B2["in_channels"],) + (MMDIT_B2["input_size"],) * 2
    ctx_shape, pooled_dim = (MMDIT_B2_CTX, MMDIT_B2["context_dim"]), MMDIT_B2["pooled_dim"]
    fixed = {"x": torch.randn(b, *shape, generator=g, device=dev),
             "eps": torch.randn(b, *shape, generator=g, device=dev),
             "t": torch.tensor([999, 421], device=dev)[:b],
             "y": {"context": torch.randn(b, *ctx_shape, generator=g, device=dev),
                   "pooled": torch.randn(b, pooled_dim, generator=g, device=dev)}}
    fixed["y"]["context"][1:] = 0
    fixed["y"]["pooled"][1:] = 0

    def loss_and_grads(m, plain: bool):
        m.zero_grad(set_to_none=True)
        with plain_ops() if plain else contextlib.nullcontext():
            loss = diffuser.loss_func(lambda xt, tt: m(xt, tt, fixed["y"], train=True),
                                      fixed["x"], fixed["t"], eps=fixed["eps"])
            loss.backward()
        grads = {name: p.grad.detach().float().clone() for name, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.detach(), grads

    def grad_err(grads, want) -> float:
        return (sum((grads[k_] - want[k_]).square().sum() for k_ in want).sqrt()
                / sum(w.square().sum() for w in want.values()).sqrt()).item()

    def norm(grads) -> float:
        return sum(x.square().sum() for x in grads.values()).sqrt().item()

    per_step = MMDIT_TRAIN_CALLS["mmdit_train_b128"]
    want_step = {"K1": per_step["K1"], "K2": per_step["K2"], "K3": 0}
    model = mmdit_model("MMDiT-B/2", **MMDIT_B2, device=dev).train()
    init_random_(model, g)
    agreement = {}
    for storage in ("f32", "bf16"):
        kw = {"param_dtype": "bfloat16"} if storage == "bf16" else {}
        m = mmdit_model("MMDiT-B/2", **MMDIT_B2, **kw, device=dev).train()
        m.load_state_dict(model.state_dict())
        ref = mmdit_model("MMDiT-B/2", **dict(MMDIT_B2, dtype=None), device=dev).train()
        ref.load_state_dict(m.state_dict())
        loss_f, grads_f = loss_and_grads(ref, plain=True)
        del ref
        zero_counts()
        loss_k, grads_k = loss_and_grads(m, plain=False)
        torch.cuda.synchronize()
        launches, kernels_used = counts(), by_kernel()
        loss_p, grads_p = loss_and_grads(m, plain=True)
        errs = {"loss": (abs(loss_k.item() - loss_f.item()) / abs(loss_f.item()),
                         abs(loss_p.item() - loss_f.item()) / abs(loss_f.item())),
                "gradient": (grad_err(grads_k, grads_f), grad_err(grads_p, grads_f)),
                "grad_norm": (abs(norm(grads_k) - norm(grads_f)) / norm(grads_f),
                              abs(norm(grads_p) - norm(grads_f)) / norm(grads_f))}
        stored = sorted({str(p.dtype) for p in m.parameters()})
        agreement[storage] = dict(errs=errs, launches=launches, param_dtypes=stored)
        log(f"MMDiT-B/2 train b{b}, {storage} parameters ({stored}): loss f32 {loss_f.item():.6f}, "
            f"kernels {loss_k.item():.6f}, plain bf16 {loss_p.item():.6f}; grad norm f32 "
            f"{norm(grads_f):.6f}; rel err vs f32 (kernels, plain bf16): " + json.dumps(errs)
            + f"; launches {launches}, by kernel {kernels_used}")
        for what, (err_k, err_p) in errs.items():
            check(math.isfinite(err_k) and err_k <= 1.5 * err_p + 1e-3,
                  f"MMDiT-B/2 train ({storage} parameters) {what}: err(kernels) <= 1.5 "
                  "err(plain) + 1e-3")
        check(launches == want_step and kernels_used == all_wgmma(per_step),
              f"MMDiT-B/2 train forward+backward ({storage} parameters) launches {launches} == "
              f"{want_step}, all wgmma {kernels_used}")
        del m, grads_f, grads_k, grads_p
        torch.cuda.empty_cache()
    del fixed

    # (c) bench.py's mmdit_train: b128, adafactor 1e-4, clip 1.0, no EMA, the
    # loss's own t and eps, MMDiT's conditioning dropout; PyTorch's TF32 defaults
    torch.backends.cudnn.allow_tf32 = True
    n = MMDIT_TRAIN_B
    blocks = sum(isinstance(m, MMDiTBlock) for m in model.modules())
    check(blocks == per_step["K1"] and model.qk_norm and model.dtype == torch.bfloat16
          and model.cond_dropout_prob > 0,
          f"MMDiT-B/2: {blocks} joint attentions a forward, qk_norm, bf16 torso, dropout")
    state = TrainState.create(model, adafactor(model.parameters(), lr=TRAIN_LR), ema_decay=None)
    step = make_train_step(make_diffusion_loss_fn(diffuser, train_mmdit.train_apply(model), 1000),
                           clip_grad_norm=TRAIN_CLIP)
    batch = {"image": torch.randn(n, *shape, generator=g, device=dev),
             "context": torch.randn(n, *ctx_shape, generator=g, device=dev),
             "pooled": torch.randn(n, pooled_dim, generator=g, device=dev)}
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    history = [step(state, batch) for _ in range(MMDIT_TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, kernels_used = counts(), by_kernel()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in history]
    norms = [m["grad_norm"].item() for m in history]
    profile = profile_by_class(lambda: step(state, batch), 2)
    idle = 1 - profile["classes"]["total"] / profile["wall_ms"]
    fwd_flops = forward_flops(model, batch["image"][:1], torch.full((1,), 500.0, device=dev),
                              {k: batch[k][:1] for k in ("context", "pooled")})
    imgs_per_s = n * MMDIT_TRAIN_STEPS / seconds
    metrics = {"mmdit_b2_b128": {
        "imgs_per_s": imgs_per_s, "ms_per_step": 1e3 * seconds / MMDIT_TRAIN_STEPS,
        "peak_bytes": peak, "batch": n, "steps": MMDIT_TRAIN_STEPS,
        "launches_per_step": per_step, "fwd_flops_per_sample": fwd_flops,
        # a step as three forwards' worth of products, over the bf16 peak
        "mfu": imgs_per_s * 3 * fwd_flops / PEAK_BF16_FLOPS,
        "profile_ms": dict(profile["classes"], wall=profile["wall_ms"], **profile["ranges"]),
        "idle_share": idle, "agreement_b2": agreement}}
    log(f"MMDiT-B/2 train b{n}: {MMDIT_TRAIN_STEPS} steps in {seconds:.3f} s, "
        f"{imgs_per_s:.4f} imgs/s, {1e3 * seconds / MMDIT_TRAIN_STEPS:.3f} ms/step, peak "
        f"{peak / 2**30:.3f} GiB; forward {fwd_flops / 1e9:.3f} GFLOP a sample, MFU "
        f"{metrics['mmdit_b2_b128']['mfu']:.4f} of 989 TFLOP/s ({card}); launches {launches}, "
        f"by kernel {kernels_used}; losses {losses}; grad norms {norms}")
    log(f"MMDiT-B/2 train b{n} step device time by class (torch.profiler, ms per step over 2; "
        f"wall {profile['wall_ms']:.3f} ms per step under the profiler, the card idle "
        f"{idle:.3f} of it): " + json.dumps(profile["classes"]) + "; annotated ranges: "
        + json.dumps(profile["ranges"]))
    for name, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {name}")
    check(all(map(math.isfinite, losses + norms)), f"MMDiT-B/2 train b{n}: finite losses and "
          "grad norms")
    want = {key: MMDIT_TRAIN_STEPS * c for key, c in per_step.items()}
    check(launches == want and kernels_used == all_wgmma(per_step, MMDIT_TRAIN_STEPS),
          f"MMDiT-B/2 train b{n} launches {launches} == {want}, all wgmma {kernels_used}")
    check(profile["classes"]["K2 attention backward"] > 0,
          "profile: the MMDiT train step ran K2 on the card")
    del state, step, batch, history, model
    torch.cuda.empty_cache()

    # (d) python -m dmtpu_torch.scripts.train_mmdit -c configs/sd3_medium.yaml
    # in this process: the model initialised the CLI's way (adaLN-Zero), bf16
    # storage, remat, adafactor 5e-5, the config's bf16 EMA; the loop's step is
    # kept for one profiled step after the run
    # the CLI's model has SD3_CLI_DEPTH of SD3-medium's 24 blocks
    sd3_calls = {key: c * SD3_CLI_DEPTH // 24
                 for key, c in MMDIT_TRAIN_CALLS["sd3_train_b32"].items()}
    kept = {}
    real_make_train_step = train_mmdit.make_train_step

    def keeping_make_train_step(loss_fn, **kw):
        inner = real_make_train_step(loss_fn, **kw)

        def step_fn(state, batch):
            kept.update(step=inner, state=state, batch=batch)
            return inner(state, batch)

        return step_fn

    tmp = tempfile.mkdtemp(prefix="dmtpu_sd3_train_")
    train_mmdit.make_train_step = keeping_make_train_step
    try:
        exp = os.path.join(tmp, "exp")
        argv = ["-c", SD3_CONFIG, "-e", exp, "-ni", *SD3_TRAIN_OVERRIDES]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        first = train_mmdit.main(argv + [f"train.n_steps={SD3_TRAIN_STEPS}"])
        torch.cuda.synchronize()
        run1, run1_kernels = counts(), by_kernel()
        sd3_state = kept["state"]
        sd3_model = sd3_state.model
        sd3_batch = kept["batch"]["image"].shape[0]
        dtypes = sorted({str(p.dtype) for p in sd3_model.parameters()})
        ema_dtypes = sorted({str(x.dtype) for x in sd3_state.ema.shadow.values()})
        params_bytes = sum(p.numel() * p.element_size() for p in sd3_model.parameters())
        n_params = sum(p.numel() for p in sd3_model.parameters())
        sd3_profile = profile_by_class(lambda: kept["step"](kept["state"], kept["batch"]), 1)
        sd3_idle = 1 - sd3_profile["classes"]["total"] / sd3_profile["wall_ms"]
        kept.clear()
        del sd3_state, sd3_model
        torch.cuda.empty_cache()
        zero_counts()
        again = train_mmdit.main(argv + ["-r", "latest",
                                         f"train.n_steps={SD3_TRAIN_RESUMED_STEPS}"])
        torch.cuda.synchronize()
        run2 = counts()
        sd3_peak = torch.cuda.max_memory_allocated()
        kept.clear()
        ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
        ckpt_bytes = os.path.getsize(os.path.join(exp, "ckpt", ckpts[-1], "state.pt"))
        blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", ckpts[-1]))
        blob_step, blob_ema = blob["step"], blob["ema"]["num_updates"]
        blob_dtypes = sorted({str(x.dtype) for x in blob["model"].values()})
        del blob
        log_text = "".join(open(os.path.join(exp, f)).read() for f in os.listdir(exp)
                           if f.startswith("output-"))
    finally:
        train_mmdit.make_train_step = real_make_train_step
        shutil.rmtree(tmp, ignore_errors=True)
    step_s = first["step_seconds"] + again["step_seconds"]
    sd3_ms = 1e3 * sum(step_s) / len(step_s)
    sd3_losses = first["losses"] + again["losses"]
    metrics["sd3_medium_cli_b32"] = {
        "ms_per_step": sd3_ms, "step_ms": [1e3 * x for x in step_s], "batch": sd3_batch,
        "imgs_per_s": sd3_batch / (sd3_ms / 1e3), "peak_bytes": sd3_peak,
        "params_bytes": params_bytes, "param_dtypes": dtypes, "ema_dtypes": ema_dtypes,
        "losses": sd3_losses, "save_seconds": first["save_seconds"] + again["save_seconds"],
        "load_seconds": again["load_seconds"], "checkpoint_bytes": ckpt_bytes,
        "profile_ms": dict(sd3_profile["classes"], wall=sd3_profile["wall_ms"],
                           **sd3_profile["ranges"]),
        "idle_share": sd3_idle, "launches": {"train": run1, "resume": run2}}
    log(f"train_mmdit SD3-medium at depth {SD3_CLI_DEPTH} (MMDiT-L/2 widths, bf16 storage "
        f"{dtypes}, remat, EMA {ema_dtypes}) "
        f"b{sd3_batch}: {SD3_TRAIN_STEPS} steps, then -r latest to {SD3_TRAIN_RESUMED_STEPS}: ms "
        f"per step (host clock between the loop's steps) {sd3_ms:.3f}, each "
        f"{metrics['sd3_medium_cli_b32']['step_ms']}; peak {sd3_peak / 2**30:.3f} GiB "
        f"(parameters {params_bytes / 2**30:.3f} GiB); checkpoint {ckpt_bytes / 2**30:.3f} GiB, "
        f"saves {metrics['sd3_medium_cli_b32']['save_seconds']} s, load "
        f"{again['load_seconds']:.3f} s ({card}); losses {sd3_losses}; launches {run1}, {run2}, "
        f"by kernel {run1_kernels}; checkpoints {ckpts}")
    log(f"SD3-medium train b{sd3_batch} step device time by class (torch.profiler, one step; "
        f"wall {sd3_profile['wall_ms']:.3f} ms under the profiler, the card idle "
        f"{sd3_idle:.3f} of it): " + json.dumps(sd3_profile["classes"]) + "; annotated "
        "ranges: " + json.dumps(sd3_profile["ranges"]))
    for name, kernel_ms in sd3_profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {name}")
    check(sd3_batch == 32 and dtypes == ["torch.bfloat16", "torch.float32"]
          and ema_dtypes == ["torch.bfloat16"] and blob_dtypes == dtypes,
          "train_mmdit SD3-medium: the config's batch of 32, bf16 storage, bf16 EMA")
    check(ckpts == [f"step{SD3_TRAIN_STEPS - 1:06d}", f"step{SD3_TRAIN_RESUMED_STEPS - 1:06d}"]
          and blob_step == blob_ema == SD3_TRAIN_RESUMED_STEPS and "Resumed from" in log_text
          and f"Model parameters: {n_params / 1e6:.2f}M" in log_text,
          f"train_mmdit SD3-medium: checkpoints at the ends of both runs, resumed to step "
          f"{SD3_TRAIN_RESUMED_STEPS}, the parameter count logged")
    check(len(sd3_losses) == SD3_TRAIN_RESUMED_STEPS and all(map(math.isfinite, sd3_losses)),
          "train_mmdit SD3-medium: finite losses at every step")
    want1 = {key: SD3_TRAIN_STEPS * c for key, c in sd3_calls.items()}
    want2 = {key: (SD3_TRAIN_RESUMED_STEPS - SD3_TRAIN_STEPS) * c for key, c in sd3_calls.items()}
    check(run1 == want1 and run2 == want2
          and run1_kernels == all_wgmma(sd3_calls, SD3_TRAIN_STEPS),
          f"train_mmdit SD3-medium launches {run1} == {want1}, resumed {run2} == {want2}, all "
          f"wgmma {run1_kernels}")
    check(sd3_profile["classes"]["K2 attention backward"] > 0,
          "profile: the SD3-medium train step ran K2 on the card")
    torch.cuda.empty_cache()

    # (e) sample_cfg --sampler flow on phase 11's DiT-XL/2 with the SD VAE,
    # learn_sigma off (a velocity has its input's channels): a short b4 request
    conf = Config(DIT_CONF)
    conf.model.params.vit_config.params.learn_sigma = False
    flow_model = instantiate_from_config(conf.model, device=dev).eval()
    init_random_(flow_model.vit, g)
    init_random_(flow_model.vae, g)
    args = argparse.Namespace(sampler="flow", guidance_scale=DIT_SCALE, var_type=None,
                              guidance_interval=None, ddim_eta=0.0, respace_type="uniform",
                              respace_steps=FLOW_STEPS)
    flow = make_diffuser(args, conf)
    size = conf.data.params.img_size
    zero_counts()
    t0 = time.perf_counter()
    images = sample_class(flow_model, flow, DIT_CLASS, FLOW_B, shape=(4, size // 8, size // 8),
                          num_classes=conf.data.num_classes, batch_size=FLOW_B, seed=SEED,
                          device=dev)
    torch.cuda.synchronize()
    flow_seconds = time.perf_counter() - t0
    flow_launches = counts()
    want = {"K1": FLOW_STEPS * DIT_ATTN_PER_FORWARD, "K2": 0, "K3": GN_PER_DECODE}
    metrics["dit_flow_b4"] = {"seconds": flow_seconds, "steps": FLOW_STEPS,
                              "launches": flow_launches, "sampler": type(flow).__name__}
    log(f"sample_cfg --sampler flow: DiT-XL/2 (learn_sigma off) b{FLOW_B}, "
        f"{type(flow).__name__}-{FLOW_STEPS} s={DIT_SCALE}, {size}x{size}: {flow_seconds:.3f} s "
        f"(first request, unwarmed; {card}); launches {flow_launches}")
    check(type(flow).__name__ == "FlowMatchingCFG" and isinstance(flow_model.vit, DiT)
          and tuple(images.shape) == (FLOW_B, 3, size, size)
          and bool(torch.isfinite(images).all()) and images.float().std().item() > 1e-2,
          f"sample_cfg --sampler flow b{FLOW_B}: FlowMatchingCFG, finite varied "
          f"[{FLOW_B}, 3, {size}, {size}]")
    check(flow_launches == want, f"sample_cfg --sampler flow launches {flow_launches} == {want}")
    del flow_model, images
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    return {"launches": {f"mmdit_train{MMDIT_TRAIN_STEPS}": launches,
                         "sd3_cli_train": run1, "sd3_cli_resume": run2,
                         f"dit_flow{FLOW_STEPS}": flow_launches},
            "metrics": metrics, "k1_per_step": k1_per_step, "k2_per_step": k2_per_step}


def phase_sdxl(dev, check, gen, card, time_ms, host_us, k3_row, add_row, new_totals) -> dict:
    """Phase 15 (see the module docstring): SDXL-base text to image at
    1024x1024 through ``dmtpu_torch.ui.sdxl`` (the SDXL page's logic), K1 and
    K3 at SDXL's shapes, and ``bench.py``'s ``sdxl`` extra.  ``k3_row``,
    ``add_row`` and ``new_totals`` are phase 3's row helpers."""
    import copy

    import torch
    from dmtpu_torch.diffusions import DDIM
    from dmtpu_torch.models.sdxl import StableDiffusionXL
    from dmtpu_torch.models.stablediffusion import SDUNetModel
    from dmtpu_torch.models.stablediffusion.attention import BasicTransformerBlock
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        select_kernel,
    )
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.ops.roofline import PEAK_BF16_FLOPS
    from dmtpu_torch.ui import sdxl as ui
    from dmtpu_torch.utils.config import Config, instantiate_from_config

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_err(a, ref) -> float:
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    def add_sums(totals, per):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_us"):
            totals[key] += per[key]
        for by, ms in per["bound_ms_by"].items():
            totals["bound_ms_by"][by] += ms
        totals["err"] = max(totals["err"], per["err"])

    g = gen(SEED + 50)
    n = SDXL_CFG_B  # the CFG-doubled batch of a one-image request

    # (a) K1 at d=64: the self-attentions of the two attention levels and the
    # cross-attentions to the 77 text tokens (the wgmma kernel's short-key
    # tile), on b2
    k1_rows, k1_per_call = {}, new_totals()
    for (sq, sk, h), calls in SDXL_ATTN.items():
        q = torch.randn(n, sq, h, 64, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(n, sk, h, 64, generator=g, device=dev).bfloat16() for _ in range(2))
        name = f"sdxl_s{sq}_k{sk}"
        k1_rows[name], per = k1_call_row(
            q, k, v, calls, f"SDXL b{n} h{h} S_q={sq} S_k={sk}", check, time_ms, host_us, card,
            20, expect="wgmma")
        add_sums(k1_per_call, per)
        del q, k, v
        torch.cuda.empty_cache()
    check({row["kernel"] for row in k1_rows.values()} == {"wgmma"}
          and any(row["sk"] == 77 for row in k1_rows.values()),
          "SDXL K1: self-attention and the 77-key cross-attention through wgmma")
    log(f"K1 per SDXL UNet call on {n} samples ({sum(SDXL_ATTN.values())} calls): "
        + json.dumps(k1_per_call))

    # (b) K3 at the UNet's GroupNorms (b2, channels-last, bf16 torso, the f32
    # output norm) and at the VAE decoder's at 1024x1024 (b1, f32, NCHW)
    k3_unet, k3_vae = new_totals(), new_totals()
    for (c, hw, dname, silu, eps), calls in SDXL_GN_CALLS.items():
        add_row(k3_unet, k3_row(c, hw, dname, silu, eps, torch.channels_last, calls, n=n), calls)
    torch.cuda.empty_cache()
    for (c, hw, silu), calls in SDXL_DECODE_GN.items():
        add_row(k3_vae, k3_row(c, hw, "f32", silu, 1e-6, torch.contiguous_format, calls,
                               n=SDXL_B), calls)
        torch.cuda.empty_cache()
    log(f"K3 per SDXL UNet call on {n} samples ({sum(SDXL_GN_CALLS.values())} calls): "
        + json.dumps(k3_unet))
    log(f"K3 per b{SDXL_B} VAE decode at {SDXL_SIZE}x{SDXL_SIZE} ({GN_PER_DECODE} calls): "
        + json.dumps(k3_vae))

    # (c) SDXL-base at full width through the reference targets, built on the
    # card from a seed (f32 parameters, bf16 UNet torso)
    conf = Config(SDXL_CONF)
    t0 = time.perf_counter()
    model = instantiate_from_config(conf.model, device=dev).eval()
    init_random_(model, g)  # the zero-initialised layers non-zero: else the UNet's output is 0
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    unet = model.unet
    blocks = sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
    gns = [m.num_channels for m in unet.modules() if isinstance(m, torch.nn.GroupNorm)]
    decode_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in model.vae.decoder.modules())
    n_params = {name: sum(p.numel() for p in part.parameters())
                for name, part in (("unet", unet), ("conditioner", model.conditioner),
                                   ("vae", model.vae))}
    attn_per_call, gn_per_call = 2 * blocks, len(gns)
    want_channels = sorted(c for (c, *_), calls in SDXL_GN_CALLS.items() for _ in range(calls))
    log(f"SDXL-base: {n_params} parameters (f32), built on the card in {build_s:.1f} s; UNet "
        f"torso {unet.torso_dtype}; from the module trees: {blocks} transformer blocks, so "
        f"{attn_per_call} attention calls a UNet call, {gn_per_call} GroupNorms a call, "
        f"{decode_gn} a decode")
    check(isinstance(model, StableDiffusionXL) and unet.torso_dtype == torch.bfloat16
          and all(p.dtype == torch.float32 and p.device.type == "cuda"
                  for p in model.parameters())
          and 2.5e9 < n_params["unet"] < 2.6e9
          and (attn_per_call, gn_per_call, decode_gn) == (
              sum(SDXL_ATTN.values()), sum(SDXL_GN_CALLS.values()), GN_PER_DECODE)
          and sorted(gns) == want_channels,
          "SDXL-base from SDXL_CONF: f32 parameters on the card, bf16 torso, 2.57B UNet, "
          "the attention and GroupNorm tables match the module tree")

    # (d) the conditioner on the card against the same towers on the CPU, f32,
    # TF32 off: a prompt's seeded token ids and the zeroed empty negative
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    host_g = torch.Generator().manual_seed(SDXL_PROMPT_SEED)
    ids = tuple(torch.randint(0, 49408, (1, 77), generator=host_g) for _ in range(2))
    size = torch.tensor([[SDXL_SIZE, SDXL_SIZE]], dtype=torch.float32)
    sizes = (size, torch.zeros_like(size), size)
    with torch.no_grad():
        cond = model.conditioner(*(x.to(dev) for x in ids + sizes))
        uncond = model.conditioner(*(x.to(dev) for x in ids + sizes), force_zero_text=True)
        cpu = copy.deepcopy(model.conditioner).cpu()
        want = cpu(*ids, *sizes)
    del cpu
    cond_err = [rel_err(a.cpu(), b) for a, b in zip(cond, want)]
    log(f"SDXL conditioner b1: crossattn {tuple(cond[0].shape)}, vector "
        f"{tuple(cond[1].shape)}; rel L2 err vs the CPU: {cond_err}")
    pooled = model.conditioner.clip_g.text_projection.shape[1]
    check(tuple(cond[0].shape) == (1, 77, unet.context_dim)
          and tuple(cond[1].shape) == (1, unet.adm_in_channels) and max(cond_err) <= 1e-4
          and not uncond[0].any() and not uncond[1][:, :pooled].any()
          and torch.equal(uncond[1][:, pooled:], cond[1][:, pooled:]),
          f"SDXL conditioner: [1, 77, {unet.context_dim}] and [1, {unet.adm_in_channels}], "
          "within 1e-4 of the CPU; the empty negative's text zeroed")

    # (e) agreement: a b2 UNet forward with y, the CFG-doubled batch of the
    # request, through the kernels and the plain ops against an f32 plain run
    ref = SDUNetModel(**dict(SDXL_UNET, torso_dtype=None), device=dev).eval()
    ref.load_state_dict(unet.state_dict())
    lat = SDXL_SIZE // 8
    x = torch.randn(1, 4, lat, lat, generator=g, device=dev).repeat(n, 1, 1, 1)
    ts = torch.tensor([501, 501], device=dev)
    ctx, vec = (torch.cat([c, u]) for c, u in zip(cond, uncond))
    with torch.no_grad():
        zero_counts()
        got_k = unet(x, ts, ctx, vec)
        torch.cuda.synchronize()
        fwd_launches = counts()
        with plain_ops():
            got_p, want = unet(x, ts, ctx, vec), ref(x, ts, ctx, vec)
    err_k, err_p = rel_err(got_k, want), rel_err(got_p, want)
    log(f"SDXL UNet b{n} forward at {lat}x{lat}x4 with y: rel L2 err vs f32 plain: kernels "
        f"{err_k:.3e}, plain bf16 {err_p:.3e}; std {want.std().item():.3f}; launches "
        f"{fwd_launches}")
    check(tuple(got_k.shape) == (n, 4, lat, lat) and bool(torch.isfinite(got_k).all())
          and err_k <= 1.5 * err_p + 1e-3,
          "SDXL UNet forward: err(kernels) <= 1.5 err(plain) + 1e-3")
    want_fwd = {"K1": attn_per_call, "K2": 0, "K3": gn_per_call}
    check(fwd_launches == want_fwd, f"SDXL UNet forward launches {fwd_launches} == {want_fwd}")
    del ref, got_k, got_p, want
    torch.cuda.empty_cache()

    # (f) the timed request: the Generate defaults (DDIM, 50 steps, s = 5,
    # 1024x1024, uniform-linspace), b1, seeded token ids, empty negative; the
    # VAE's f32 convolutions in TF32, cuDNN's default
    torch.backends.cudnn.allow_tf32 = True
    request = dict(sampler="DDIM", steps=SDXL_STEPS, scale=SDXL_SCALE, height=SDXL_SIZE,
                   width=SDXL_SIZE, batch_size=SDXL_B, batch_count=1,
                   respace_type="uniform-linspace", seed=SEED, device=dev)
    dp = dict(conf.diffusion.params, respace_type="uniform-linspace", respace_steps=SDXL_STEPS,
              guidance_scale=SDXL_SCALE, cond_kwarg="cond")
    rows = len(ui.SAMPLERS["DDIM"](**dp).respaced_seq)
    ui.generate_sdxl(conf, model, ids, "", **request)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    images, stage_ms = ui.generate_sdxl(conf, model, ids, "", **request)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_kernel = counts(), dict(flash_attention_fwd.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    params_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    wgmma_calls = sum(calls for (sq, sk, h), calls in SDXL_ATTN.items()
                      if select_kernel(64) == "wgmma")
    want = {"K1": rows * attn_per_call, "K2": 0, "K3": rows * gn_per_call + decode_gn}
    want_by_kernel = {"wgmma": rows * wgmma_calls, "mma": rows * (attn_per_call - wgmma_calls)}
    with torch.no_grad():
        call_ms = time_ms(lambda: unet(x, ts, ctx, vec), 3)
        profile = profile_by_class(lambda: unet(x, ts, ctx, vec), 2)
        z = torch.randn(SDXL_B, 4, lat, lat, generator=g, device=dev)
        decode_profile = profile_by_class(lambda: model.decode_latent(z), 1)
    metrics = {"sdxl_b1": {
        "imgs_per_s": SDXL_B / seconds, "seconds": seconds, "batch": SDXL_B, "steps": rows,
        "size": SDXL_SIZE, "guidance_scale": SDXL_SCALE, "stage_ms": stage_ms,
        "peak_bytes": peak, "params_bytes": params_bytes, "build_s": build_s,
        "cfg_call_ms": call_ms, "cfg_call_profile_ms": profile["classes"],
        "cfg_call_wall_ms": profile["wall_ms"], "vae_decode_profile_ms": decode_profile["classes"],
        "launches": launches, "k1_by_kernel": by_kernel,
        "agreement_b2": {"kernels": err_k, "plain_bf16": err_p}, "conditioner_err": cond_err}}
    log(f"SDXL b{SDXL_B}, DDIMCFG-{rows} ({rows} UNet calls on {n} samples), s={SDXL_SCALE}, "
        f"{SDXL_SIZE}x{SDXL_SIZE}: {seconds:.3f} s, {SDXL_B / seconds:.4f} images/s, stages "
        f"(CUDA events, ms) {json.dumps(stage_ms)}, peak {peak / 2**30:.3f} GiB (parameters "
        f"{params_bytes / 2**30:.3f} GiB) ({card}); launches {launches}, K1 by kernel {by_kernel}")
    log(f"SDXL UNet call on {n} samples: {call_ms:.3f} ms (CUDA events, 3 calls); device time "
        f"by class (torch.profiler, ms per call over 2; wall {profile['wall_ms']:.3f} ms under "
        "the profiler): " + json.dumps(profile["classes"]))
    for kname, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {kname}")
    log(f"VAE decode b{SDXL_B} {SDXL_SIZE}x{SDXL_SIZE}, TF32, device time by class (one "
        "decode): " + json.dumps(decode_profile["classes"]))
    check(tuple(images.shape) == (SDXL_B, 3, SDXL_SIZE, SDXL_SIZE)
          and bool(torch.isfinite(images).all()) and images.float().std().item() > 1e-2
          and set(stage_ms) == {"conditioner", "sample", "decode"},
          f"SDXL request b{SDXL_B}: finite [{SDXL_B}, 3, {SDXL_SIZE}, {SDXL_SIZE}], stage times")
    check(launches == want, f"SDXL request launches {launches} == {want}")
    check(by_kernel == want_by_kernel, f"SDXL request K1 by kernel {by_kernel} == "
                                       f"{want_by_kernel}")
    check(profile["classes"]["K1 attention"] > 0 and profile["classes"]["K3 GroupNorm"] > 0,
          "profile: the SDXL UNet call ran K1 and K3 on the card")
    del images, x, ts, ctx, vec, z
    torch.cuda.empty_cache()

    # (g) bench.py's sdxl: unguided DDIM-50 (uniform), b1, its random 77 x 2048
    # context (benchmarks/northstar.py:159) and a zero vector; MFU from the
    # forward's operations counted on its shapes
    torch.backends.cudnn.allow_tf32 = False
    sampler = DDIM(total_steps=1000, respace_type="uniform", respace_steps=SDXL_BENCH_STEPS)
    b_rows = len(sampler.respaced_seq)
    b_ctx = torch.randn(SDXL_B, 77, unet.context_dim, generator=g, device=dev)
    b_vec = torch.zeros(SDXL_B, unet.adm_in_channels, device=dev)
    noise = torch.randn(SDXL_B, 4, lat, lat, generator=g, device=dev)

    def bench_model(xx, tt, **kw):
        return unet(xx, tt, b_ctx, b_vec)

    with torch.no_grad():
        sampler.sample(bench_model, noise)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = sampler.sample(bench_model, noise)
        torch.cuda.synchronize()
        b_seconds = time.perf_counter() - t0
    b_launches = counts()
    flops = forward_flops(unet, noise, torch.full((SDXL_B,), 500, device=dev), b_ctx, b_vec)
    sps = SDXL_B / b_seconds
    mfu = sps * b_rows * flops / SDXL_B / PEAK_BF16_FLOPS
    metrics["bench_sdxl_b1"] = {"samples_per_s": sps, "seconds": b_seconds, "steps": b_rows,
                                "fwd_flops_per_sample": flops / SDXL_B, "mfu": mfu,
                                "launches": b_launches}
    log(f"bench.py sdxl: DDIM-{b_rows} b{SDXL_B} at {lat}x{lat}x4: {b_seconds:.3f} s, "
        f"{sps:.4f} samples/s; forward {flops / SDXL_B / 1e12:.4f} TFLOP a sample, MFU "
        f"{mfu:.4f} of 989 TFLOP/s ({card}); launches {b_launches}")
    b_want = {"K1": b_rows * attn_per_call, "K2": 0, "K3": b_rows * gn_per_call}
    check(tuple(out.shape) == (SDXL_B, 4, lat, lat) and bool(torch.isfinite(out).all()),
          "bench sdxl: finite latents")
    check(b_launches == b_want, f"bench sdxl launches {b_launches} == {b_want}")
    del model, unet, out, noise, b_ctx, b_vec
    torch.cuda.empty_cache()
    return {"launches": {f"sdxl_ddimcfg{rows}": launches, f"sdxl_bench_ddim{b_rows}": b_launches},
            "metrics": metrics, "k1": k1_rows, "k1_per_call": k1_per_call,
            "k3_unet": k3_unet, "k3_vae": k3_vae}


@contextlib.contextmanager
def recorded_ops(calls: dict):
    """Count the dispatching ops' calls of the pixel-space models by shape:
    ``calls["attention"][(h, S_q, S_k, d)]`` and ``calls["group_norm"][(C, HW,
    dtype, silu, eps, layout)]``, read off the tensors the models hand them
    (the module-level names ``attention`` / ``group_norm`` that
    ``models/adm.py`` and ``models/modules.py`` call are wrapped)."""
    import collections

    import torch
    from dmtpu_torch.models import adm, modules

    attn, gn = collections.Counter(), collections.Counter()
    calls.update(attention=attn, group_norm=gn)
    originals = {(mod, name): getattr(mod, name) for mod in (adm, modules)
                 for name in ("attention", "group_norm")}

    def wrap(mod, name):
        fn = originals[(mod, name)]

        def recorded(*args, **kwargs):
            x = args[0]
            if name == "attention":
                attn[(x.shape[2], x.shape[1], args[1].shape[1], x.shape[3])] += 1
            else:
                groups, eps, silu = (list(args[3:]) + [None] * 3)[:3]
                eps = kwargs.get("eps", 1e-5 if eps is None else eps)
                silu = kwargs.get("silu", False if silu is None else silu)
                layout = "nchw" if x.is_contiguous() else "cl"
                gn[(x.shape[1], x.shape[2] * x.shape[3],
                    "bf16" if x.dtype == torch.bfloat16 else "f32", bool(silu), eps, layout)] += 1
            return fn(*args, **kwargs)
        return recorded

    for (mod, name) in originals:
        setattr(mod, name, wrap(mod, name))
    try:
        yield calls
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


def phase_pixel(dev, check, gen, card, time_ms, host_us, k3_row, add_row, new_totals) -> dict:
    """Phase 16 (see the module docstring): pixel-space unconditional
    sampling through ``sample_uncond`` (ADM-256 and the CIFAR-10 UNet, with
    DDIM inversion) and the AdaGN UNet through ``sample_cfg``; K1 at head dim
    256.  ``k3_row``, ``add_row`` and ``new_totals`` are phase 3's row helpers."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dmtpu_torch.diffusions import DDIM
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.attention import attention, mha
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        select_kernel,
    )
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.scripts import sample_cfg, sample_uncond
    from dmtpu_torch.utils.config import Config, instantiate_from_config, load_config, merge_dotlist

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)
        flash_attention_fwd.launches_by_head_dim.clear()

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_err(a, ref) -> float:
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    def add_sums(totals, per):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_us"):
            totals[key] += per[key]
        for by, ms in per["bound_ms_by"].items():
            totals["bound_ms_by"][by] += ms
        totals["err"] = max(totals["err"], per["err"])

    def pixel_conf(path):
        return merge_dotlist(load_config(path), PIXEL_OVERRIDES)

    def build(conf_model, f32_params=None):
        """(the model of ``conf_model`` on the card with seeded random weights,
        the same weights in an f32 twin)."""
        model = instantiate_from_config(conf_model, device=dev).eval()
        init_random_(model, g)
        params = dict(conf_model["params"], **(f32_params or {"dtype": None}))
        ref = instantiate_from_config({"target": conf_model["target"], "params": params},
                                      device=dev).eval()
        ref.load_state_dict(model.state_dict())
        return model, ref

    def agreement(label, model, ref, args):
        """A b2 forward through the kernels and through the plain ops against
        the f32 twin (TF32 off); returns (launches, the ops' calls by shape)."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.no_grad():
            zero_counts()
            with recorded_ops({}) as calls:
                got_k = model(*args)
            torch.cuda.synchronize()
            launches = counts()
            with plain_ops():
                got_p, want = model(*args), ref(*args)
        err_k, err_p = rel_err(got_k, want), rel_err(got_p, want)
        metrics["agreement_b2"][label] = {"kernels": err_k, "plain_bf16": err_p}
        log(f"{label} b2 forward: rel L2 err vs f32 plain: kernels {err_k:.3e}, plain bf16 "
            f"{err_p:.3e}; std {want.std().item():.3f}; launches {launches}; calls by shape: "
            f"attention {dict(calls['attention'])}, GroupNorm {len(calls['group_norm'])} shapes")
        want_launches = {"K1": sum(calls["attention"].values()), "K2": 0,
                         "K3": sum(calls["group_norm"].values())}
        check(bool(torch.isfinite(got_k).all()) and err_k <= 1.5 * err_p + 1e-3
              and launches == want_launches,
              f"{label} forward: err(kernels) <= 1.5 err(plain) + 1e-3, launches {launches} "
              f"== {want_launches}")
        return want_launches, calls

    def kernel_rows(label, calls, n, k1_label, k3_label=None):
        """K1 (and K3) rows at batch ``n`` at the shapes a call records."""
        k1 = new_totals()
        for (h, sq, sk, d), k in sorted(calls["attention"].items()):
            q, kk, v = (torch.randn(n, s, h, d, generator=g, device=dev).bfloat16()
                        for s in (sq, sk, sk))
            row, per = k1_call_row(q, kk, v, k, f"{label} b{n} h{h} S={sq} d={d}", check,
                                   time_ms, host_us, card, 20, expect=select_kernel(d))
            add_sums(k1, per)
            k1_rows[f"{k1_label}_h{h}_s{sq}_d{d}"] = row
            del q, kk, v
        k1_per_call[k1_label] = k1
        log(f"K1 per {label} call on {n} samples ({sum(calls['attention'].values())} calls): "
            + json.dumps(k1))
        if k3_label:
            k3 = new_totals()
            for (c, hw, dname, silu, eps, layout), k in sorted(calls["group_norm"].items()):
                fmt = torch.channels_last if layout == "cl" else torch.contiguous_format
                add_row(k3, k3_row(c, hw, dname, silu, eps, fmt, k, n=n), k)
                torch.cuda.empty_cache()
            k3_per_call[k3_label] = k3
            log(f"K3 per {label} call on {n} samples ({sum(calls['group_norm'].values())} "
                "calls): " + json.dumps(k3))

    def timed(label, fn, want, by_kernel_want=None):
        """One warm run done by the caller; this is the timed one: seconds,
        peak, launches (checked exactly)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, by_kernel = counts(), dict(flash_attention_fwd.launches_by_kernel)
        by_dim = dict(flash_attention_fwd.launches_by_head_dim)
        check(launches == want, f"{label} launches {launches} == {want}")
        if by_kernel_want is not None:
            check(by_kernel == by_kernel_want, f"{label} K1 by kernel {by_kernel} == "
                                               f"{by_kernel_want}")
        request_launches[label] = launches
        return out, seconds, torch.cuda.max_memory_allocated(), by_kernel, by_dim

    def k1_by_kernel(calls, rows):
        out = {"mma": 0, "wgmma": 0}
        for (h, sq, sk, d), k in calls["attention"].items():
            out[select_kernel(d)] += rows * k
        return out

    g = gen(SEED + 60)
    metrics = {"agreement_b2": {}}
    k1_rows, k1_per_call, k3_per_call, request_launches = {}, {}, {}, {}

    # (a) a head of 512 (CelebA-HQ's UNet): K1 forward and K2 backward, their
    # d=512 instances (phases 18 and 19 hold them at CelebA-HQ's shapes),
    # against f32 autograd through mha on the same bf16 values (phase 6's rule)
    q, k, v, do = (torch.randn(2, 16, 1, 512, generator=g, device=dev).bfloat16()
                   for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    zero_counts()
    attention(*leaves).backward(do)
    torch.cuda.synchronize()
    launched = counts()
    f32 = [x.float().requires_grad_() for x in (q, k, v)]
    mha(*f32).backward(do.float())
    errs = {name: (rel_err(a.grad, b.grad),
                   (a.grad.float() - b.grad).abs().max().item() / b.grad.abs().max().item())
            for name, a, b in zip(("dq", "dk", "dv"), leaves, f32)}
    log(f"d=512 attention gradient: launches {launched}; (rel L2, max err / max) vs f32 mha "
        f"autograd: {errs}")
    check(launched == {"K1": 1, "K2": 1, "K3": 0}
          and all(rel <= 2e-2 and top <= 2e-2 for rel, top in errs.values()),
          "attention at d=512: one K1 and one K2 launch; dq, dk, dv within 2e-2 of f32 mha "
          "autograd")
    del q, k, v, do, leaves, f32

    # (b) ADM-256, unconditional, from the release's flags through the registry
    t0 = time.perf_counter()
    adm, adm_ref = build(Config(ADM256_CONF), {"use_fp16": False})
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in adm.parameters())
    size = ADM256_CONF["params"]["image_size"]
    log(f"ADM-256: {n_params} parameters (f32), bf16 torso, built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    check(n_params == ADM256_PARAMS and adm.torso_dtype == torch.bfloat16
          and adm.out_channels == 6, f"ADM-256 from ADM256_CONF: {ADM256_PARAMS} parameters, "
                                     "bf16 torso, learned sigma")
    x = torch.randn(2, 3, size, size, generator=g, device=dev)
    per_call, adm_calls = agreement("ADM-256", adm, adm_ref, (x, torch.tensor([999, 421],
                                                                               device=dev)))
    del adm_ref
    torch.cuda.empty_cache()
    kernel_rows("ADM-256", adm_calls, ADM_B, "adm256_b16", "adm256_b16")
    diffusion = Config({"diffusion": ADM256_DIFFUSION})
    args, _ = sample_uncond.parse_args(["-c", "-", "--weights", "-", "--save_dir", "-",
                                        "--n_samples", str(ADM_B), "--sampler", "ddim",
                                        "--respace_steps", str(ADM_STEPS)])
    ddim = sample_uncond.build_diffuser(args, diffusion)
    rows = len(ddim.respaced_seq)
    fn = sample_uncond.model_function(adm)
    shape = (3, size, size)
    sample_uncond.sample_fold(fn, DDIM(**dict(ADM256_DIFFUSION["params"], respace_type="uniform",
                                              respace_steps=2)), 0, ADM_B, shape, SEED, dev)
    images, seconds, peak, by_kernel, _ = timed(
        f"adm256_ddim{rows}", lambda: sample_uncond.sample_fold(fn, ddim, 0, ADM_B, shape, SEED,
                                                                dev)[0],
        {k: rows * v for k, v in per_call.items()}, k1_by_kernel(adm_calls, rows))
    with torch.no_grad():
        xb = torch.randn(ADM_B, *shape, generator=g, device=dev)
        tb = torch.full((ADM_B,), 500, device=dev)
        call_ms = time_ms(lambda: adm(xb, tb), 3)
        profile = profile_by_class(lambda: adm(xb, tb), 2)
    idle = max(0.0, 1.0 - profile["classes"]["total"] / profile["wall_ms"])
    metrics["adm256_b16"] = {
        "imgs_per_s": ADM_B / seconds, "seconds": seconds, "batch": ADM_B, "steps": rows,
        "peak_bytes": peak, "params": n_params, "call_ms": call_ms,
        "call_profile_ms": profile["classes"], "call_wall_ms": profile["wall_ms"],
        "host_share": idle, "k1_by_kernel": by_kernel}
    log(f"ADM-256 b{ADM_B} DDIM-{rows} at {size}x{size} through sample_uncond.sample_fold: "
        f"{seconds:.3f} s, {ADM_B / seconds:.4f} images/s, peak {peak / 2**30:.3f} GiB "
        f"({card}); K1 by kernel {by_kernel}")
    log(f"ADM-256 call on {ADM_B} samples: {call_ms:.3f} ms (CUDA events, 3 calls); device time "
        f"by class (torch.profiler, ms per call over 2; wall {profile['wall_ms']:.3f} ms under "
        f"the profiler, the card idle {idle:.3f} of it): " + json.dumps(profile["classes"]))
    for kname, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {kname}")
    check(tuple(images.shape) == (ADM_B, 3, size, size) and bool(torch.isfinite(images).all())
          and profile["classes"]["K1 attention"] > 0 and profile["classes"]["K3 GroupNorm"] > 0,
          f"ADM-256 request: finite [{ADM_B}, 3, {size}, {size}]; the call ran K1 and K3")
    del adm, images, x, xb, fn
    torch.cuda.empty_cache()

    # (c) the CIFAR-10 UNet of configs/ddpm_cifar10.yaml at the CLI's batch
    conf = pixel_conf(CIFAR_CONFIG)
    unet, unet_ref = build(conf.model)
    n_params = sum(p.numel() for p in unet.parameters())
    img = conf.data.params.img_size
    shape = (conf.data.get("img_channels", 3), img, img)
    check(n_params == CIFAR_PARAMS and unet.dtype == torch.bfloat16,
          f"CIFAR UNet from {CIFAR_CONFIG}: {CIFAR_PARAMS} parameters, bf16 torso")
    x = torch.randn(2, *shape, generator=g, device=dev)
    per_call, cifar_calls = agreement("CIFAR UNet", unet, unet_ref,
                                      (x, torch.tensor([999, 421], device=dev)))
    del unet_ref
    check(all(d == 256 and h == 1 for h, _, _, d in cifar_calls["attention"]),
          "CIFAR UNet: every attention is one head of 256")
    kernel_rows("CIFAR UNet", cifar_calls, CIFAR_B, "cifar_b500", "cifar_b500")
    # K1 at d=256 at a ragged length too (the plain version in slices)
    q, kk, v = (torch.randn(CIFAR_B, 200, 1, 256, generator=g, device=dev).bfloat16()
                for _ in range(3))
    k1_rows["cifar_ragged_s200_d256"], _ = k1_call_row(
        q, kk, v, 0, f"ragged b{CIFAR_B} h1 S=200 d=256", check, time_ms, host_us, card, 20,
        expect=select_kernel(256))
    del q, kk, v
    fn = sample_uncond.model_function(unet)

    def diffuser(sampler, steps):
        a, _ = sample_uncond.parse_args(["-c", CIFAR_CONFIG, "--weights", "-", "--save_dir", "-",
                                         "--n_samples", str(CIFAR_B), "--sampler", sampler,
                                         "--respace_steps", str(steps)])
        return sample_uncond.build_diffuser(a, conf)

    sample_uncond.sample_fold(fn, diffuser("ddim", 2), 0, CIFAR_B, shape, SEED, dev)  # warm-up
    d256_by_path = {}
    for sampler, steps in (("ddim", CIFAR_STEPS), ("heun", HEUN_STEPS)):
        sam = diffuser(sampler, steps)
        calls_n = len(sam.respaced_seq) if sampler == "ddim" else 2 * len(sam.respaced_seq) - 1
        label = f"cifar_{sampler}{steps}_b{CIFAR_B}"
        images, seconds, peak, by_kernel, by_dim = timed(
            label, lambda: sample_uncond.sample_fold(fn, sam, 0, CIFAR_B, shape, SEED, dev)[0],
            {k: calls_n * v for k, v in per_call.items()}, k1_by_kernel(cifar_calls, calls_n))
        d256_by_path[label] = by_dim.get(256, 0)
        metrics[label] = {"imgs_per_s": CIFAR_B / seconds, "seconds": seconds, "batch": CIFAR_B,
                          "model_calls": calls_n, "peak_bytes": peak, "k1_by_kernel": by_kernel,
                          "k1_by_head_dim": by_dim}
        log(f"CIFAR UNet b{CIFAR_B} {sampler}-{steps} ({calls_n} UNet calls) through "
            f"sample_uncond.sample_fold: {seconds:.3f} s, {CIFAR_B / seconds:.2f} images/s, peak "
            f"{peak / 2**30:.3f} GiB ({card}); K1 by kernel {by_kernel}, by head dim {by_dim}")
        check(tuple(images.shape) == (CIFAR_B, *shape) and bool(torch.isfinite(images).all())
              and by_dim == {256: calls_n * per_call["K1"]},
              f"CIFAR {sampler}-{steps}: finite images, every K1 launch at d=256")
        del images
    d256_launches = d256_by_path[f"cifar_ddim{CIFAR_STEPS}_b{CIFAR_B}"]
    with torch.no_grad():
        xb = torch.randn(CIFAR_B, *shape, generator=g, device=dev)
        tb = torch.full((CIFAR_B,), 500, device=dev)
        profile = profile_by_class(lambda: unet(xb, tb), 2)
    metrics[f"cifar_ddim{CIFAR_STEPS}_b{CIFAR_B}"].update(
        call_profile_ms=profile["classes"], call_wall_ms=profile["wall_ms"])
    log(f"CIFAR UNet call on {CIFAR_B} samples: device time by class (torch.profiler, ms per call "
        f"over 2; wall {profile['wall_ms']:.3f} ms under the profiler): "
        + json.dumps(profile["classes"]))
    del xb

    root = tempfile.mkdtemp(prefix="chip_smoke_pixel_")
    try:
        # reconstruction through the CLI: DDIM inversion, then sampling, of
        # RECON_IMAGES images the phase writes into an ImageDir
        from PIL import Image

        os.makedirs(os.path.join(root, "images"))
        rs = np.random.RandomState(SEED)
        for i in range(RECON_IMAGES):
            Image.fromarray(rs.randint(0, 256, (img, img, 3), dtype=np.uint8)).save(
                os.path.join(root, "images", f"{i}.png"))
        torch.save(unet.state_dict(), os.path.join(root, "unet.pt"))
        argv = ["-c", CIFAR_CONFIG, "--weights", os.path.join(root, "unet.pt"), "--save_dir",
                os.path.join(root, "recon"), "--n_samples", str(RECON_IMAGES), "--sampler",
                "ddim", "--respace_steps", str(CIFAR_STEPS), "--mode", "reconstruction",
                "--input_dir", os.path.join(root, "images"), *PIXEL_OVERRIDES]
        calls_n = 2 * CIFAR_STEPS - 1  # the inversion's S - 1 calls, then S
        _, seconds, _, by_kernel, _ = timed(
            "cifar_reconstruction", lambda: sample_uncond.main(argv),
            {k: calls_n * v for k, v in per_call.items()}, k1_by_kernel(cifar_calls, calls_n))
        grids = sorted(os.listdir(os.path.join(root, "recon")))
        shapes = {np.asarray(Image.open(os.path.join(root, "recon", f))).shape for f in grids}
        metrics["cifar_reconstruction"] = {"seconds": seconds, "images": RECON_IMAGES,
                                           "model_calls": calls_n}
        log(f"sample_uncond --mode reconstruction, {RECON_IMAGES} images, DDIM-{CIFAR_STEPS}: "
            f"{seconds:.3f} s in process ({card}); grids {grids}, shapes {shapes}")
        check(len(grids) == RECON_IMAGES and shapes == {(img + 4, 2 * img + 6, 3)},
              f"reconstruction: {RECON_IMAGES} image / reconstruction pairs")
        del unet, fn
        torch.cuda.empty_cache()

        # (d) the AdaGN UNet of configs/ddpm_cfg_cifar10.yaml through sample_cfg
        conf = pixel_conf(CIFAR_CFG_CONFIG)
        adagn, adagn_ref = build(conf.model)
        with torch.no_grad():  # the null class is its table's zero last row
            adagn.class_embed.weight[-1].zero_()
            adagn_ref.class_embed.weight[-1].zero_()
        n_params = sum(p.numel() for p in adagn.parameters())
        num_classes = conf.data.num_classes
        check(n_params == ADAGN_PARAMS, f"AdaGN UNet from {CIFAR_CFG_CONFIG}: {ADAGN_PARAMS} "
                                        "parameters")
        x = torch.randn(2, *shape, generator=g, device=dev)
        per_call, adagn_calls = agreement(
            "AdaGN UNet", adagn, adagn_ref,
            (x, torch.tensor([999, 421], device=dev), torch.tensor([3, num_classes], device=dev)))
        del adagn_ref
        kernel_rows("AdaGN UNet", adagn_calls, 2 * CFG_EACH, f"adagn_b{2 * CFG_EACH}",
                    f"adagn_b{2 * CFG_EACH}")
        torch.save(adagn.state_dict(), os.path.join(root, "adagn.pt"))
        argv = ["-c", CIFAR_CFG_CONFIG, "--weights", os.path.join(root, "adagn.pt"),
                "--save_dir", os.path.join(root, "cfg"), "--sampler", "ddim", "--respace_steps",
                str(CIFAR_STEPS), "--guidance_scale", str(CFG_SCALE_PIXEL),
                "--n_samples_each_class", str(CFG_EACH), *PIXEL_OVERRIDES]
        calls_n = num_classes * CIFAR_STEPS  # one call on the doubled batch a step
        _, seconds, peak, by_kernel, by_dim = timed(
            "adagn_ddimcfg", lambda: sample_cfg.main(argv),
            {k: calls_n * v for k, v in per_call.items()}, k1_by_kernel(adagn_calls, calls_n))
        written = sum(len(os.listdir(os.path.join(root, "cfg", f"class{c}")))
                      for c in range(num_classes))
        metrics["adagn_ddimcfg"] = {"seconds": seconds, "images": written,
                                    "imgs_per_s": written / seconds, "model_calls": calls_n,
                                    "peak_bytes": peak, "k1_by_kernel": by_kernel,
                                    "k1_by_head_dim": by_dim}
        log(f"sample_cfg, AdaGN UNet, DDIMCFG-{CIFAR_STEPS} s={CFG_SCALE_PIXEL}, {CFG_EACH} "
            f"images a class, {num_classes} classes: {seconds:.3f} s in process, "
            f"{written / seconds:.2f} images/s ({card}); K1 by kernel {by_kernel}, by head dim "
            f"{by_dim}")
        check(written == num_classes * CFG_EACH and by_dim.get(256, 0) == calls_n,
              f"sample_cfg AdaGN: {num_classes * CFG_EACH} PNGs; K1 at d=256 once a call")
        del adagn
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    d256_by_path["adagn_ddimcfg"] = metrics["adagn_ddimcfg"]["k1_by_head_dim"].get(256, 0)
    return {"launches": request_launches, "metrics": metrics, "k1": k1_rows,
            "k1_per_call": k1_per_call, "k3_per_call": k3_per_call,
            "d256_launches": d256_launches, "d256_by_path": d256_by_path}



def phase_pixel_train(dev, check, gen, card, time_ms, host_us) -> dict:
    """Phase 17 (see the module docstring): pixel-space DDPM training through
    K1 and K2 at head dim 256, ``train_ddpm`` (DDPM and DDPM_IP) and
    ``train_ddpm_cfg`` (the AdaGN UNet) in this process."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        select_bwd_kernel,
    )
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
    from dmtpu_torch.scripts import train_ddpm, train_ddpm_cfg
    from dmtpu_torch.scripts._common import seeded_instance
    from dmtpu_torch.utils import checkpoint as ckpt_lib
    from dmtpu_torch.utils.config import instantiate_from_config, load_config, merge_dotlist
    from dmtpu_torch.utils.image import pil_image

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        for fn in (flash_attention_fwd, flash_attention_bwd):
            fn.launches_by_kernel.update(mma=0, wgmma=0)
            fn.launches_by_head_dim.clear()

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def by_dim():
        return {"K1": dict(flash_attention_fwd.launches_by_head_dim),
                "K2": dict(flash_attention_bwd.launches_by_head_dim)}

    def times(per_step, n):
        return {key: n * c for key, c in per_step.items()}

    g = gen(SEED + 70)
    metrics = {}
    conf = merge_dotlist(load_config(CIFAR_CONFIG), PIXEL_OVERRIDES)
    total_steps = int(conf.diffusion.params.total_steps)
    n = conf.train.batch_size
    shape = (conf.data.img_channels, conf.data.params.img_size, conf.data.params.img_size)

    # (a) K2 at d=256 at the CIFAR UNet's shapes at the config's batch (one
    # head: S=256 at 16x16, S=16 in the middle), a ragged length and a padded
    # head dim, from K1's outputs and a random dO
    k2_rows = {}
    k2_per_step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, host_us=0.0,
                       err=0.0, bound_ms_by={"bytes": 0.0, "operations": 0.0})
    mma_per_step = 0.0  # the mma.sync instance's time over the same calls
    for b, s, d in K2_D256_ROWS:
        q, k, v, do = (torch.randn(b, s, 1, d, generator=g, device=dev).bfloat16()
                       for _ in range(4))
        calls = CIFAR_TRAIN_ATTN.get((s, d), 0) if b == n else 0
        row, per = k2_call_row(q, k, v, do, calls, f"pixel UNet b{b} h1 S={s} d={d}", check,
                               time_ms, host_us, card, 20, expect="wgmma")
        k2_rows[f"b{b}_s{s}_d{d}"] = row
        if calls:
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_us"):
                k2_per_step[key] += per[key]
            for by, ms in per["bound_ms_by"].items():
                k2_per_step["bound_ms_by"][by] += ms
            k2_per_step["err"] = max(k2_per_step["err"], per["err"])
            mma_per_step += calls * sum(row["ms_by_kernel"]["mma"]) / 2
        del q, k, v, do
    log(f"K2 per b{n} CIFAR UNet train step ({sum(CIFAR_TRAIN_ATTN.values())} calls at d=256): "
        + json.dumps(k2_per_step))
    torch.cuda.empty_cache()

    # (b) agreement at b2: the loss and the gradient of the CIFAR UNet through
    # the kernels and through the plain bf16 path, each against an f32 plain
    # run (TF32 off), seeded random weights; dropout off, so that the three
    # runs compute one function
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = dict(conf.model.params.to_dict(), dropout=0.0)
    model = instantiate_from_config({"target": conf.model.target, "params": params}, device=dev)
    init_random_(model, g)
    ref = instantiate_from_config({"target": conf.model.target,
                                   "params": dict(params, dtype=None)}, device=dev)
    ref.load_state_dict(model.state_dict())
    diffuser = instantiate_from_config(conf.diffusion)
    b = PIXEL_TRAIN_CHECK_BATCH
    fixed = {"x": torch.rand(b, *shape, generator=g, device=dev) * 2 - 1,
             "eps": torch.randn(b, *shape, generator=g, device=dev),
             "t": torch.tensor([total_steps - 1, 421 * total_steps // 1000], device=dev)[:b]}

    def loss_and_grads(m, plain: bool):
        m.zero_grad(set_to_none=True)
        with plain_ops() if plain else contextlib.nullcontext():
            loss = diffuser.loss_func(lambda xt, tt: m(xt, tt, train=True), fixed["x"],
                                      fixed["t"], eps=fixed["eps"])
            loss.backward()
        grads = {name: p.grad.detach().clone() for name, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.detach(), grads

    def grad_err(grads, want) -> float:
        return (sum((grads[k_] - want[k_]).square().sum() for k_ in want).sqrt()
                / sum(w.square().sum() for w in want.values()).sqrt()).item()

    def norm(grads) -> float:
        return sum(x.square().sum() for x in grads.values()).sqrt().item()

    loss_f, grads_f = loss_and_grads(ref, plain=True)
    del ref
    zero_counts()
    with recorded_ops({}) as calls:
        loss_k, grads_k = loss_and_grads(model, plain=False)
    torch.cuda.synchronize()
    step_launches, step_dims = counts(), by_dim()
    loss_p, grads_p = loss_and_grads(model, plain=True)
    errs = {"loss": (abs(loss_k.item() - loss_f.item()) / abs(loss_f.item()),
                     abs(loss_p.item() - loss_f.item()) / abs(loss_f.item())),
            "gradient": (grad_err(grads_k, grads_f), grad_err(grads_p, grads_f)),
            "grad_norm": (abs(norm(grads_k) - norm(grads_f)) / norm(grads_f),
                          abs(norm(grads_p) - norm(grads_f)) / norm(grads_f))}
    metrics["agreement_b2"] = errs
    log(f"CIFAR UNet train b{b}: loss f32 {loss_f.item():.6f}, kernels {loss_k.item():.6f}, "
        f"plain bf16 {loss_p.item():.6f}; grad norm f32 {norm(grads_f):.6f}; rel err vs f32 "
        "(kernels, plain bf16): " + json.dumps(errs) + f"; launches {step_launches}, by head dim "
        f"{step_dims}; attention calls {dict(calls['attention'])}")
    for what, (err_k, err_p) in errs.items():
        check(math.isfinite(err_k) and err_k <= 1.5 * err_p + 1e-3,
              f"CIFAR UNet train {what}: err(kernels) <= 1.5 err(plain) + 1e-3")
    attn = {(sq, d): c for (h, sq, sk, d), c in calls["attention"].items() if h == 1 and sq == sk}
    per_step = {"K1": sum(calls["attention"].values()), "K2": sum(calls["attention"].values()),
                "K3": sum(calls["group_norm"].values())}
    d256 = {"K1": {256: per_step["K1"]}, "K2": {256: per_step["K2"]}}
    check(attn == CIFAR_TRAIN_ATTN and sum(attn.values()) == per_step["K1"]
          and step_launches == per_step and step_dims == d256,
          f"CIFAR UNet forward+backward: attention {attn} == {CIFAR_TRAIN_ATTN}; launches "
          f"{step_launches} == {per_step}, every K1 and K2 at d=256 {step_dims}")
    del model, grads_f, grads_k, grads_p
    torch.cuda.empty_cache()

    # (c) the config's train step at its batch of 128: its UNet (dropout 0.1)
    # built as train_ddpm builds it, its Adam, clip and EMA; dropout drawn
    # from the step's stream; PyTorch's default TF32 settings, as the CLI runs
    torch.backends.cudnn.allow_tf32 = True
    model = seeded_instance(conf.model, dev, SEED)
    state = TrainState.create(model, instantiate_from_config(conf.train.optim,
                                                             params=model.parameters()),
                              ema_decay=conf.train.ema_decay,
                              ema_gradual=conf.train.ema_gradual)
    step = make_train_step(make_diffusion_loss_fn(
        diffuser, lambda x, t, **kw: model(x, t, train=True, **kw), total_steps),
        clip_grad_norm=conf.train.clip_grad_norm, seed=SEED)
    batch = torch.rand(n, *shape, generator=g, device=dev) * 2 - 1
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    history = [step(state, batch) for _ in range(PIXEL_TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, dims = counts(), by_dim()
    k2_by_kernel = dict(flash_attention_bwd.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in history]
    norms = [m["grad_norm"].item() for m in history]
    profile = profile_by_class(lambda: step(state, batch), 2)
    idle = max(0.0, 1 - profile["classes"]["total"] / profile["wall_ms"])
    metrics["train_b128"] = {
        "imgs_per_s": n * PIXEL_TRAIN_STEPS / seconds,
        "ms_per_step": 1e3 * seconds / PIXEL_TRAIN_STEPS, "peak_bytes": peak, "batch": n,
        "steps": PIXEL_TRAIN_STEPS, "launches_per_step": per_step,
        "params": sum(p.numel() for p in model.parameters()),
        "profile_ms": dict(profile["classes"], wall=profile["wall_ms"], **profile["ranges"]),
        "idle_share": idle}
    log(f"CIFAR UNet train b{n}: {PIXEL_TRAIN_STEPS} steps in {seconds:.3f} s, "
        f"{metrics['train_b128']['imgs_per_s']:.2f} imgs/s, "
        f"{metrics['train_b128']['ms_per_step']:.3f} ms/step, peak {peak / 2**30:.3f} GiB "
        f"({card}); launches {launches}, by head dim {dims}, K2 by kernel {k2_by_kernel}; losses "
        f"{losses}; grad norms {norms}")
    log(f"CIFAR UNet train b{n} step device time by class (torch.profiler, ms per step over 2; "
        f"wall {profile['wall_ms']:.3f} ms per step under the profiler, the card idle "
        f"{idle:.3f} of it): " + json.dumps(profile["classes"]) + "; annotated ranges: "
        + json.dumps(profile["ranges"]))
    for name, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {name}")
    check(all(map(math.isfinite, losses + norms)), f"CIFAR UNet train b{n}: finite losses and "
                                                   "grad norms")
    check(launches == times(per_step, PIXEL_TRAIN_STEPS)
          and dims == {key: {256: PIXEL_TRAIN_STEPS * c[256]} for key, c in d256.items()}
          and k2_by_kernel == {"mma": 0, "wgmma": launches["K2"]},
          f"CIFAR UNet train b{n} launches {launches} == {PIXEL_TRAIN_STEPS} x {per_step}, "
          f"K1 and K2 all at d=256 {dims}, K2 through wgmma {k2_by_kernel}")
    check(profile["classes"]["K2 attention backward"] > 0 and profile["classes"]["K1 attention"]
          > 0 and profile["classes"]["K3 GroupNorm"] > 0,
          "profile: the CIFAR UNet train step ran K1, K2 and K3 on the card")
    d256_launches = dims["K2"].get(256, 0)
    d256_by_path = {f"pixel_train{PIXEL_TRAIN_STEPS}": d256_launches}
    del state, step, batch, history, model
    torch.cuda.empty_cache()

    # (d) train_ddpm in this process on configs/ddpm_cifar10.yaml: a run that
    # saves and samples a grid, its resume, and a DDPM_IP run
    root = tempfile.mkdtemp(prefix="chip_smoke_pixel_train_")
    real_loss_fn, diffusers = train_ddpm.make_diffusion_loss_fn, []

    def recording(diffuser_, *args, **kwargs):
        diffusers.append(type(diffuser_).__name__)
        return real_loss_fn(diffuser_, *args, **kwargs)

    train_ddpm.make_diffusion_loss_fn = recording
    try:
        exp = os.path.join(root, "exp")
        base = ["-c", CIFAR_CONFIG, "-e", exp, "-ni", *PIXEL_OVERRIDES, *SYNTHETIC_DATA,
                *PIXEL_CLI_GRID, "train.save_freq=2"]
        grid_rows = len(instantiate_from_config(
            merge_dotlist(load_config(CIFAR_CONFIG), PIXEL_CLI_GRID).diffusion).respaced_seq)
        zero_counts()
        first = train_ddpm.main(base + [f"train.n_steps={PIXEL_CLI_STEPS}",
                                        "train.sample_freq=2"])
        torch.cuda.synchronize()
        run1, dims1 = counts(), by_dim()
        zero_counts()
        again = train_ddpm.main(base + ["-r", "latest", f"train.n_steps={PIXEL_CLI_RESUMED_STEPS}",
                                        "train.sample_freq=0"])
        torch.cuda.synchronize()
        run2, dims2 = counts(), by_dim()
        ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
        ckpt_bytes = os.path.getsize(os.path.join(exp, "ckpt", ckpts[-1], "state.pt"))
        blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", ckpts[-1]))
        grids = sorted(os.listdir(os.path.join(exp, "samples")))
        with pil_image().open(os.path.join(exp, "samples", grids[0])) as im:
            grid_mode, grid_size, grid_std = im.mode, im.size, float(np.asarray(im).std())
        log_text = "".join(open(os.path.join(exp, f)).read() for f in os.listdir(exp)
                           if f.startswith("output-"))
        zero_counts()
        ip = train_ddpm.main(["-c", CIFAR_CONFIG, "-e", os.path.join(root, "ip"), "-ni",
                              *PIXEL_OVERRIDES, *SYNTHETIC_DATA,
                              "diffusion.target=diffusions.ddpm_ip.DDPM_IP",
                              "diffusion.params.gamma=0.1", f"train.n_steps={PIXEL_IP_STEPS}",
                              "train.sample_freq=0", "train.save_freq=0"])
        torch.cuda.synchronize()
        run3 = counts()
        zero_counts()

        # (e) train_ddpm_cfg in this process on configs/ddpm_cfg_cifar10.yaml
        cfg_run = train_ddpm_cfg.main(["-c", CIFAR_CFG_CONFIG, "-e", os.path.join(root, "cfg"),
                                       "-ni", *PIXEL_OVERRIDES, *SYNTHETIC_DATA,
                                       "data.params.num_classes=10",
                                       f"train.n_steps={ADAGN_CLI_STEPS}", "train.sample_freq=0",
                                       "train.save_freq=0"])
        torch.cuda.synchronize()
        run4, dims4 = counts(), by_dim()
        k2_by_kernel4 = dict(flash_attention_bwd.launches_by_kernel)
    finally:
        train_ddpm.make_diffusion_loss_fn = real_loss_fn
        shutil.rmtree(root, ignore_errors=True)

    losses = first["losses"] + again["losses"]
    metrics["cli"] = {
        "losses": losses, "save_seconds": first["save_seconds"] + again["save_seconds"],
        "load_seconds": again["load_seconds"], "checkpoint_bytes": ckpt_bytes,
        "step_seconds": first["step_seconds"] + again["step_seconds"],
        "launches": {"train": run1, "resume": run2, "ddpm_ip": run3}, "grid_rows": grid_rows,
        "ddpm_ip_losses": ip["losses"]}
    log(f"train_ddpm {CIFAR_CONFIG} b{n} (Synthetic data): {PIXEL_CLI_STEPS} steps with a save "
        f"and a {grid_rows}-step grid of 16, then -r latest to {PIXEL_CLI_RESUMED_STEPS}: step "
        f"seconds {metrics['cli']['step_seconds']}; checkpoint {ckpt_bytes / 2**20:.1f} MiB, "
        f"saves {metrics['cli']['save_seconds']} s, load {again['load_seconds']:.3f} s "
        f"({card}); losses {losses}; launches {run1} (by head dim {dims1}), {run2}; checkpoints "
        f"{ckpts}, grids {grids} ({grid_mode}, {grid_size}, std {grid_std:.1f}); DDPM_IP run: "
        f"losses {ip['losses']}, launches {run3}; diffusers {diffusers}")
    check(ckpts == ["step000001", "step000002", "step000003", "step000004"]
          and blob["step"] == PIXEL_CLI_RESUMED_STEPS
          and blob["ema"]["num_updates"] == PIXEL_CLI_RESUMED_STEPS and "Resumed from" in log_text,
          "train_ddpm: checkpoints at steps 2, 3, 4 and 5, resumed to step 5")
    check(grids == ["step000001.png"] and grid_mode == "RGB"
          and grid_size == (4 * (shape[1] + 2) + 2,) * 2 and grid_std > 0,
          "train_ddpm: one eval grid of 4 x 4 images, RGB")
    check(len(losses) == PIXEL_CLI_RESUMED_STEPS and len(ip["losses"]) == PIXEL_IP_STEPS
          and all(map(math.isfinite, losses + ip["losses"]))
          and diffusers == ["DDPM", "DDPM", "DDPM_IP"],
          "train_ddpm: finite losses at every step, DDPM then DDPM_IP reaching the loss")
    want1 = {key: PIXEL_CLI_STEPS * c + (grid_rows * c if key != "K2" else 0)
             for key, c in per_step.items()}
    want2 = times(per_step, PIXEL_CLI_RESUMED_STEPS - PIXEL_CLI_STEPS)
    want3 = times(per_step, PIXEL_IP_STEPS)
    check(run1 == want1 and run2 == want2 and run3 == want3 and set(dims1["K2"]) == {256},
          f"train_ddpm launches {run1} == {want1}, resumed {run2} == {want2}, DDPM_IP {run3} == "
          f"{want3}")
    cfg_step = {"K1": sum(ADAGN_ATTN.values()), "K2": sum(ADAGN_ATTN.values()),
                "K3": ADAGN_GN_PER_CALL}
    want4 = times(cfg_step, ADAGN_CLI_STEPS)
    want_dims4 = {key: {d: ADAGN_CLI_STEPS * c for d, c in ADAGN_ATTN.items()}
                  for key in ("K1", "K2")}
    metrics["adagn_cli"] = {"losses": cfg_run["losses"], "step_seconds": cfg_run["step_seconds"],
                            "save_seconds": cfg_run["save_seconds"], "launches": run4,
                            "k2_by_head_dim": dims4["K2"], "k2_by_kernel": k2_by_kernel4}
    log(f"train_ddpm_cfg {CIFAR_CFG_CONFIG} b{n} (Synthetic data, 10 classes): "
        f"{ADAGN_CLI_STEPS} steps, step seconds {cfg_run['step_seconds']}, save "
        f"{cfg_run['save_seconds']} s ({card}); losses {cfg_run['losses']}; launches {run4}, by "
        f"head dim {dims4}, K2 by kernel {k2_by_kernel4}")
    check(len(cfg_run["losses"]) == ADAGN_CLI_STEPS and all(map(math.isfinite, cfg_run["losses"]))
          and run4 == want4 and dims4 == want_dims4
          and k2_by_kernel4 == {"wgmma": ADAGN_CLI_STEPS * sum(ADAGN_ATTN.values()), "mma": 0},
          f"train_ddpm_cfg AdaGN: finite losses; launches {run4} == {want4}, by head dim "
          f"{dims4} == {want_dims4}; K2 at d=64 and d=256 through wgmma")
    d256_by_path.update(pixel_cli_train=dims1["K2"].get(256, 0),
                        pixel_cli_resume=dims2["K2"].get(256, 0), pixel_cli_ddpm_ip=run3["K2"],
                        adagn_cli_train=dims4["K2"].get(256, 0))
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    # (f) K2 at the AdaGN UNet's attention shapes (read off a forward on the
    # meta device) at its config's batch: 10 calls at d=64 and 1 at d=256 a
    # train step, all through wgmma
    cfg_conf = merge_dotlist(load_config(CIFAR_CFG_CONFIG), PIXEL_OVERRIDES)
    side, nb = cfg_conf.data.params.img_size, cfg_conf.train.batch_size
    meta_t = torch.zeros(1, dtype=torch.long, device="meta")
    with recorded_ops({}) as adagn_calls, plain_ops(), torch.no_grad():
        instantiate_from_config(cfg_conf.model, device="meta")(
            torch.zeros(1, cfg_conf.data.img_channels, side, side, device="meta"), meta_t, meta_t)
    k2_adagn = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, host_us=0.0, err=0.0,
                    bound_ms_by={"bytes": 0.0, "operations": 0.0})
    by_d = {}
    for (h, sq, sk, d), calls in sorted(adagn_calls["attention"].items()):
        q, k, v, do = (torch.randn(nb, s_, h, d, generator=g, device=dev).bfloat16()
                       for s_ in (sq, sk, sk, sq))
        row, per = k2_call_row(q, k, v, do, calls, f"AdaGN UNet b{nb} h{h} S={sq} d={d}", check,
                               time_ms, host_us, card, 20, expect=select_bwd_kernel(d))
        k2_rows[f"adagn_b{nb}_h{h}_s{sq}_d{d}"] = row
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_us"):
            k2_adagn[key] += per[key]
        for by, ms in per["bound_ms_by"].items():
            k2_adagn["bound_ms_by"][by] += ms
        k2_adagn["err"] = max(k2_adagn["err"], per["err"])
        by_d[d] = by_d.get(d, 0) + calls
        del q, k, v, do
    log(f"K2 per b{nb} AdaGN UNet train step ({sum(by_d.values())} calls, by head dim {by_d}): "
        + json.dumps(k2_adagn))
    check(by_d == ADAGN_ATTN, f"AdaGN UNet: attention calls by head dim {by_d} == {ADAGN_ATTN}")
    torch.cuda.empty_cache()
    return {"launches": {f"pixel_train{PIXEL_TRAIN_STEPS}": launches, "pixel_cli_train": run1,
                         "pixel_cli_resume": run2, "pixel_cli_ddpm_ip": run3,
                         "adagn_cli_train": run4},
            "metrics": metrics, "k2": k2_rows,
            "k2_per_step": {"cifar_train_b128": k2_per_step, f"adagn_train_b{nb}": k2_adagn},
            "k2_mma_per_step": mma_per_step,
            "d256_launches": d256_launches, "d256_by_path": d256_by_path}

def phase_guidance(dev, check, gen, card, time_ms, host_us, new_totals, k3_row,
                   add_row) -> dict:
    """Phase 18 (see the module docstring): guidance and image editing on the
    pixel models through ``sample_sdedit``, ``sample_mask_guidance``,
    ``sample_ilvr``, ``sample_ddib`` and ``sample_clip_guidance``; K1 at
    head dim 512.  ``new_totals``, ``k3_row`` and ``add_row`` are phases 2
    and 3's row helpers."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image
    from dmtpu_torch.diffusions import DDIM, DDPM
    from dmtpu_torch.diffusions.guidance import ILVR, MaskGuidance
    from dmtpu_torch.diffusions.guidance.clip_guidance import CLIPGuidance
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.ops.resize_right import make_resize_matrix
    from dmtpu_torch.scripts import (
        sample_clip_guidance,
        sample_ddib,
        sample_ilvr,
        sample_mask_guidance,
        sample_sdedit,
        sample_uncond,
    )
    from dmtpu_torch.utils.config import Config, instantiate_from_config, load_config, merge_dotlist
    from dmtpu_torch.utils.mask import MaskGenerator

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)
        flash_attention_fwd.launches_by_head_dim.clear()

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_err(a, ref) -> float:
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    def build(conf_model, f32_params=None, twin=True):
        """(the model of ``conf_model`` on the card with seeded random weights,
        the same weights in an f32 twin, or None)."""
        model = instantiate_from_config(conf_model, device=dev).eval()
        init_random_(model, g)
        if not twin:
            return model, None
        params = dict(conf_model["params"], **(f32_params or {"dtype": None}))
        ref = instantiate_from_config({"target": conf_model["target"], "params": params},
                                      device=dev).eval()
        ref.load_state_dict(model.state_dict())
        return model, ref

    def agreement(label, run, run_ref):
        """``run()`` through the kernels and through the plain ops against
        ``run_ref()`` (the f32 twin, plain ops, TF32 off); returns (launches,
        the ops' calls by shape) of the kernel run."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.no_grad():
            zero_counts()
            with recorded_ops({}) as calls:
                got_k = run()
            torch.cuda.synchronize()
            launches = counts()
            with plain_ops():
                got_p, want = run(), run_ref()
        err_k, err_p = rel_err(got_k, want), rel_err(got_p, want)
        metrics["agreement_b2"][label] = {"kernels": err_k, "plain_bf16": err_p}
        log(f"{label}: rel L2 err vs f32 plain: kernels {err_k:.3e}, plain bf16 {err_p:.3e}; "
            f"std {want.std().item():.3f}; launches {launches}; attention calls by shape "
            f"{dict(calls['attention'])}")
        want_launches = {"K1": sum(calls["attention"].values()), "K2": 0,
                         "K3": sum(calls["group_norm"].values())}
        check(bool(torch.isfinite(got_k).all()) and err_k <= 1.5 * err_p + 1e-3
              and launches == want_launches,
              f"{label}: err(kernels) <= 1.5 err(plain) + 1e-3, launches {launches} == "
              f"{want_launches}")
        return want_launches, calls

    def timed(label, fn, per_call, calls_n):
        """A timed run of ``fn`` (the caller warmed its path): seconds, peak,
        the launches checked exactly against ``calls_n`` UNet calls' worth."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, by_dim = counts(), dict(flash_attention_fwd.launches_by_head_dim)
        by_kernel = dict(flash_attention_fwd.launches_by_kernel)
        want = {k: calls_n * v for k, v in per_call.items()}
        check(launches == want and by_kernel == {"mma": 0, "wgmma": launches["K1"]},
              f"{label}: launches {launches} == {calls_n} UNet calls' {want}, K1 all through "
              f"wgmma {by_kernel}")
        request_launches[label] = launches
        d512_by_path[label] = by_dim.get(512, 0)
        metrics[label] = {"seconds": seconds, "model_calls": calls_n,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "k1_by_head_dim": by_dim}
        return out, seconds

    def pngs(path):
        names = sorted(os.listdir(path))
        return names, {np.asarray(Image.open(os.path.join(path, n))).shape for n in names}

    def part_done(name):
        """The seconds since the previous part ended, kept under ``name``."""
        now = time.perf_counter()
        metrics["part_seconds"][name] = now - part_start[0]
        part_start[0] = now

    g = gen(SEED + 80)
    metrics = {"agreement_b2": {}, "part_seconds": {}}
    part_start = [time.perf_counter()]
    request_launches, d512_by_path, k1_per_call, k3_per_call = {}, {}, {}, {}

    # (a) K1 at d=512 at CelebA-HQ's shapes (b16: the 16x16 level and the
    # middle), a ragged length, a padded head dim and b128
    k1 = new_totals()
    k1_mma_ms = 0.0  # the mma.sync instance's time over the same calls
    k1_rows = {}
    for b, s, d, calls in K1_D512_ROWS:
        q, kk, v = (torch.randn(b, s, 1, d, generator=g, device=dev).bfloat16()
                    for _ in range(3))
        row, per = k1_call_row(q, kk, v, calls, f"K1 d={d} b{b} h1 S={s}", check, time_ms,
                               host_us, card, 20, expect="wgmma")
        qt, kt, vt = (z.transpose(1, 2) for z in (q, kk, v))
        row["sdpa_backend"] = sdpa_backend(qt, kt, vt)
        k1_rows[f"b{b}_s{s}_d{d}"] = row
        if calls:
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_us"):
                k1[key] += per[key]
            for by, ms in per["bound_ms_by"].items():
                k1["bound_ms_by"][by] += ms
            k1["err"] = max(k1["err"], per["err"])
            k1_mma_ms += calls * sum(row["ms_by_kernel"]["mma"]) / 2
        del q, kk, v, qt, kt, vt
    k1_per_call[f"celebahq_b{CELEBAHQ_B}"] = k1
    log(f"K1 per CelebA-HQ UNet call on {CELEBAHQ_B} samples (6 calls at d=512): "
        + json.dumps(k1) + "; SDPA's backend at d=512: "
        + json.dumps({key: row["sdpa_backend"] for key, row in k1_rows.items()}))
    part_done("a")

    # (b) the CelebA-HQ UNet: b2 agreement, K3 at its shapes, DDIM-50 at b16
    conf = merge_dotlist(load_config(CELEBAHQ_CONFIG), PIXEL_OVERRIDES)
    diffusion = conf.diffusion.params.to_dict()
    unet, unet_ref = build(conf.model)
    n_params = sum(p.numel() for p in unet.parameters())
    size = conf.data.params.img_size
    shape = (conf.data.img_channels, size, size)
    check(n_params == CELEBAHQ_PARAMS and unet.dtype == torch.bfloat16,
          f"CelebA-HQ UNet from {CELEBAHQ_CONFIG}: {CELEBAHQ_PARAMS} parameters, bf16 torso")
    x = torch.randn(2, *shape, generator=g, device=dev)
    tt = torch.tensor([999, 421], device=dev)
    per_call, calls = agreement("CelebA-HQ UNet b2 forward", lambda: unet(x, tt),
                                lambda: unet_ref(x, tt))
    check(dict(calls["attention"]) == CELEBAHQ_ATTN,
          f"CelebA-HQ UNet: attention calls {dict(calls['attention'])} == {CELEBAHQ_ATTN}")
    # K3 at the UNet's GroupNorm shapes (as the b2 run hands them) at b16
    k3 = new_totals()
    for (c, hw, dname, silu, eps, layout), k in sorted(calls["group_norm"].items()):
        fmt = torch.channels_last if layout == "cl" else torch.contiguous_format
        add_row(k3, k3_row(c, hw, dname, silu, eps, fmt, k, n=CELEBAHQ_B), k)
        torch.cuda.empty_cache()
    k3_per_call[f"celebahq_b{CELEBAHQ_B}"] = k3
    log(f"K3 per CelebA-HQ UNet call on {CELEBAHQ_B} samples "
        f"({sum(calls['group_norm'].values())} calls): " + json.dumps(k3))
    fn = sample_uncond.model_function(unet)

    def ddim(steps):
        a, _ = sample_uncond.parse_args(["-c", CELEBAHQ_CONFIG, "--weights", "-", "--save_dir",
                                         "-", "--n_samples", str(CELEBAHQ_B), "--sampler", "ddim",
                                         "--respace_steps", str(steps)])
        return sample_uncond.build_diffuser(a, conf)

    sample_uncond.sample_fold(fn, ddim(2), 0, CELEBAHQ_B, shape, SEED, dev)  # warm-up
    sam = ddim(CELEBAHQ_STEPS)
    rows = len(sam.respaced_seq)
    label = f"celebahq_ddim{rows}_b{CELEBAHQ_B}"
    images, seconds = timed(label, lambda: sample_uncond.sample_fold(
        fn, sam, 0, CELEBAHQ_B, shape, SEED, dev)[0], per_call, rows)
    d512_launches = d512_by_path[label]
    with torch.no_grad():
        xb = torch.randn(CELEBAHQ_B, *shape, generator=g, device=dev)
        tb = torch.full((CELEBAHQ_B,), 500, device=dev)
        call_ms = time_ms(lambda: unet(xb, tb), 3)
        profile = profile_by_class(lambda: unet(xb, tb), 2)
    idle = max(0.0, 1.0 - profile["classes"]["total"] / profile["wall_ms"])
    metrics[label].update(imgs_per_s=CELEBAHQ_B / seconds, batch=CELEBAHQ_B, params=n_params,
                          call_ms=call_ms, call_profile_ms=profile["classes"],
                          call_wall_ms=profile["wall_ms"], host_share=idle)
    log(f"CelebA-HQ UNet b{CELEBAHQ_B} DDIM-{rows} at {size}x{size} through "
        f"sample_uncond.sample_fold: {seconds:.3f} s, {CELEBAHQ_B / seconds:.4f} images/s, peak "
        f"{metrics[label]['peak_bytes'] / 2**30:.3f} GiB ({card}); K1 by head dim "
        f"{metrics[label]['k1_by_head_dim']}")
    log(f"CelebA-HQ UNet call on {CELEBAHQ_B} samples: {call_ms:.3f} ms (CUDA events, 3 calls); "
        f"device time by class (torch.profiler, ms per call over 2; wall {profile['wall_ms']:.3f} "
        f"ms under the profiler, the card idle {idle:.3f} of it): "
        + json.dumps(profile["classes"]))
    for kname, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {kname}")
    check(tuple(images.shape) == (CELEBAHQ_B, *shape) and bool(torch.isfinite(images).all())
          and metrics[label]["k1_by_head_dim"] == {512: rows * per_call["K1"]}
          and profile["classes"]["K1 attention"] > 0,
          f"CelebA-HQ DDIM-{rows} b{CELEBAHQ_B}: finite images, every K1 launch at d=512 "
          f"({rows} x 5 at S=256 and {rows} x 1 at S=64), the call ran K1")
    del unet_ref, images, x, xb
    torch.cuda.empty_cache()
    part_done("b")

    root = tempfile.mkdtemp(prefix="chip_smoke_guidance_")
    try:
        # seeded smooth 256x256 PNGs (8x8 noise, upsampled): the inputs, the
        # references and the images to inpaint
        images_dir = os.path.join(root, "images")
        os.makedirs(images_dir)
        rs = np.random.RandomState(SEED)
        for i in range(EDIT_IMAGES):
            Image.fromarray(rs.randint(0, 256, (8, 8, 3), dtype=np.uint8)).resize(
                (size, size), Image.BICUBIC).save(os.path.join(images_dir, f"{i}.png"))
        weights = os.path.join(root, "celebahq.pt")
        torch.save(unet.state_dict(), weights)
        base = ["-c", CELEBAHQ_CONFIG, "--weights", weights, "--input_dir", images_dir,
                "--batch_size", str(EDIT_B), *PIXEL_OVERRIDES]
        batch = np.stack([np.asarray(Image.open(os.path.join(images_dir, f"{i}.png")),
                                     np.float32) / 127.5 - 1 for i in range(EDIT_B)])
        refs = torch.from_numpy(batch).permute(0, 3, 1, 2).contiguous().to(dev)

        # (c) SDEdit through the CLI: DDPM respaced to 100, the last 50 rows
        argv = base + ["--save_dir", os.path.join(root, "sdedit"), "--respace_steps",
                       str(SDEDIT_RESPACE), "--edit_steps", str(SDEDIT_STEPS)]
        _, seconds = timed("celebahq_sdedit", lambda: sample_sdedit.main(argv), per_call,
                           SDEDIT_STEPS)
        names, shapes = pngs(os.path.join(root, "sdedit"))
        metrics["celebahq_sdedit"].update(images=len(names),
                                          imgs_per_s=len(names) / seconds)
        log(f"sample_sdedit.main, {EDIT_IMAGES} images, DDPM-{SDEDIT_RESPACE} from row "
            f"{SDEDIT_RESPACE - SDEDIT_STEPS}: {seconds:.3f} s in process ({card}); grids "
            f"{shapes}")
        check(len(names) == EDIT_IMAGES and shapes == {(size + 4, 2 * size + 6, 3)},
              f"SDEdit: {EDIT_IMAGES} input / edit pairs")
        part_done("c")

        # (d) mask guidance through the CLI, then the request function with
        # and without RePaint: the known region is the input
        argv = base + ["--save_dir", os.path.join(root, "mask"), "--respace_steps",
                       str(MASK_RESPACE), "--mask_type", "center"]
        mask_rows = len(MaskGuidance(**dict(diffusion, respace_type="uniform",
                                            respace_steps=MASK_RESPACE)).respaced_seq)
        _, seconds = timed("celebahq_mask", lambda: sample_mask_guidance.main(argv), per_call,
                           mask_rows)
        names, shapes = pngs(os.path.join(root, "mask"))
        metrics["celebahq_mask"].update(images=len(names), imgs_per_s=len(names) / seconds)
        check(len(names) == EDIT_IMAGES and shapes == {(size + 4, 3 * size + 8, 3)},
              f"mask guidance: {EDIT_IMAGES} triptychs")
        masks = torch.from_numpy(np.stack([MaskGenerator("center").sample(size, size, item=i)
                                           for i in range(EDIT_B)])).permute(0, 3, 1, 2).to(dev)
        for resample, respace in ((False, MASK_RESPACE), (True, REPAINT_RESPACE)):
            guide = MaskGuidance(**dict(diffusion, respace_type="uniform",
                                        respace_steps=respace))
            n_calls = (int(guide.resample_tape(REPAINT_R, REPAINT_J)["is_denoise"].sum())
                       if resample else len(guide.respaced_seq))
            label = "celebahq_repaint" if resample else "celebahq_mask_request"
            out, seconds = timed(label, lambda: sample_mask_guidance.inpaint_batch(
                fn, guide, refs, masks, sample_uncond.fold_generator(SEED, 0, dev), resample,
                REPAINT_R, REPAINT_J), per_call, n_calls)
            known = ((out - refs) * masks).abs().max().item()
            hole = ((out - refs) * (1 - masks)).abs().max().item()
            metrics[label].update(known_max_abs_err=known, hole_max_abs_diff=hole)
            log(f"{label}: {n_calls} UNet calls, {seconds:.3f} s ({card}); known region "
                f"max |out - input| {known:.3e}, hole {hole:.3f}")
            check(bool(torch.isfinite(out).all()) and known <= 1e-6 and hole > 1e-2,
                  f"{label}: the known region equals the input within 1e-6, the hole is new")
            del out
        part_done("d")

        # (g) CLIP guidance through the CLI: ViT-B/32 widths with seeded weights
        import transformers
        from transformers import CLIPConfig, CLIPModel, CLIPTokenizer

        clip_dir = os.path.join(root, "clip")
        torch.manual_seed(SEED)
        with torch.device(dev):  # the random init on the card: seconds, not tens
            CLIPModel(CLIPConfig()).save_pretrained(clip_dir)
        tokenizer = write_char_clip_tokenizer(os.path.join(root, "tokenizer"))
        CLIPTokenizer.from_pretrained(tokenizer).save_pretrained(clip_dir)
        argv = ["-c", CELEBAHQ_CONFIG, "--weights", weights, "--save_dir",
                os.path.join(root, "clip_out"), "--text", CLIP_TEXT, "--n_samples",
                str(EDIT_B), "--batch_size", str(EDIT_B), "--respace_steps", str(CLIP_RESPACE),
                "--guidance_weight", str(CLIP_WEIGHT), "--clip_pretrained", clip_dir,
                *PIXEL_OVERRIDES]
        clip_kw = dict(diffusion, respace_type="uniform", respace_steps=CLIP_RESPACE)
        clip_rows = len(DDPM(**clip_kw).respaced_seq)
        _, seconds = timed("celebahq_clip_cli", lambda: sample_clip_guidance.main(argv),
                           per_call, clip_rows)
        names, shapes = pngs(os.path.join(root, "clip_out"))
        check(len(names) == EDIT_B and shapes == {(size, size, 3)},
              f"sample_clip_guidance: {EDIT_B} PNGs")
        guide = CLIPGuidance(guidance_weight=CLIP_WEIGHT, clip_pretrained=clip_dir, device=dev,
                             **clip_kw)
        guide.set_text(CLIP_TEXT)
        # one cond_fn_mean on the card against the CPU, f32 (TF32 off)
        cpu_guide = CLIPGuidance(guidance_weight=CLIP_WEIGHT, clip_pretrained=clip_dir,
                                 device="cpu", **clip_kw)
        cpu_guide.set_text(CLIP_TEXT)
        x0 = torch.rand(2, *shape, generator=g, device=dev) * 2 - 1
        c = {"sqrt_recip_ac": 1.3}
        with torch.no_grad():
            got = guide.cond_fn_mean({"pred_x0": x0, "var": 0.01}, x0, c, None)
            want = cpu_guide.cond_fn_mean({"pred_x0": x0.cpu(), "var": 0.01}, x0.cpu(), c, None)
        err = rel_err(got.cpu(), want)
        metrics["clip_cond_fn_mean_rel_err_vs_cpu"] = err
        check(err <= 1e-4 and got.abs().max().item() > 0,
              f"CLIP cond_fn_mean on the card vs the CPU (f32): rel L2 {err:.3e} <= 1e-4")
        del cpu_guide
        xb = torch.rand(EDIT_B, *shape, generator=g, device=dev) * 2 - 1
        with torch.no_grad():
            clip_ms = time_ms(lambda: guide.cond_fn_mean({"pred_x0": xb, "var": 0.01}, xb, c,
                                                          None), 3)
        plain = DDPM(**clip_kw)
        sample_uncond.sample_fold(fn, plain, 0, EDIT_B, shape, SEED, dev)  # warm the sizes
        guided, g_seconds = timed("celebahq_clip", lambda: sample_uncond.sample_fold(
            fn, guide, 0, EDIT_B, shape, SEED, dev)[0], per_call, clip_rows)
        unguided, u_seconds = timed("celebahq_unguided_ddpm", lambda: sample_uncond.sample_fold(
            fn, plain, 0, EDIT_B, shape, SEED, dev)[0], per_call, clip_rows)
        moved = (guided - unguided).abs().max().item()
        metrics["celebahq_clip"].update(
            clip_ms=clip_ms, step_ms=1e3 * g_seconds / clip_rows,
            unguided_step_ms=1e3 * u_seconds / clip_rows,
            clip_share_of_step=clip_ms / (1e3 * g_seconds / clip_rows), max_abs_moved=moved)
        log(f"CLIP guidance (transformers {transformers.__version__}) b{EDIT_B} "
            f"DDPM-{clip_rows}, weight {CLIP_WEIGHT}: {g_seconds:.3f} s "
            f"against {u_seconds:.3f} s unguided from the same noise ({card}); CLIP's forward "
            f"and backward {clip_ms:.3f} ms a step (CUDA events), "
            f"{metrics['celebahq_clip']['clip_share_of_step']:.3f} of a guided step; the "
            f"guidance moved the output by up to {moved:.3e}")
        check(bool(torch.isfinite(guided).all()) and moved > 1e-3,
              "CLIP guidance: finite, and it moves the output off the unguided one")
        del guide, guided, unguided, unet, fn, xb
        torch.cuda.empty_cache()
        part_done("g")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (e) ILVR on ADM-256 (unconditional) at b8: DDPM-100, factor 8, cubic
    adm, _ = build(Config(ADM256_CONF), twin=False)
    adm_fn = sample_uncond.model_function(adm)
    ilvr_kw = dict(ADM256_DIFFUSION["params"], respace_type="uniform", respace_steps=ILVR_RESPACE)
    ilvr = ILVR(downsample_factor=ILVR_FACTOR, interp_method="cubic", **ilvr_kw)
    lp = ilvr.low_pass_filter(refs)
    w_down = make_resize_matrix(size, size // ILVR_FACTOR, 1 / ILVR_FACTOR, "cubic")
    w_up = make_resize_matrix(size // ILVR_FACTOR, size, float(ILVR_FACTOR), "cubic")
    w = w_up @ w_down
    lp64 = w @ refs.double().cpu().numpy() @ w.T  # W_h x W_w^T, batched over (b, c)
    lp_err = float(np.abs(lp.double().cpu().numpy() - lp64).max())
    metrics["ilvr_low_pass_max_abs_err_vs_f64"] = lp_err
    check(lp_err <= 1e-5, f"ILVR low-pass on the card vs float64 numpy: {lp_err:.3e} <= 1e-5")
    with torch.no_grad():
        zero_counts()
        with recorded_ops({}) as calls:
            adm(refs[:1], torch.tensor([500], device=dev))
    adm_call = {"K1": sum(calls["attention"].values()), "K2": 0,
                "K3": sum(calls["group_norm"].values())}
    sample_ilvr.ilvr_batch(adm_fn, ILVR(downsample_factor=ILVR_FACTOR, **dict(
        ilvr_kw, respace_steps=2)), refs, sample_uncond.fold_generator(SEED, 0, dev))  # warm-up
    ilvr_rows = len(ilvr.respaced_seq)
    out, i_seconds = timed("adm256_ilvr", lambda: sample_ilvr.ilvr_batch(
        adm_fn, ilvr, refs, sample_uncond.fold_generator(SEED, 0, dev)), adm_call, ilvr_rows)
    unguided, u_seconds = timed("adm256_unguided_ddpm", lambda: sample_uncond.sample_fold(
        adm_fn, DDPM(**ilvr_kw), 0, EDIT_B, shape, SEED, dev)[0], adm_call, ilvr_rows)
    phi_ref = ilvr.low_pass_filter(refs)
    gap = {name: ((ilvr.low_pass_filter(o) - phi_ref).norm() / phi_ref.norm()).item()
           for name, o in (("ilvr", out), ("unguided", unguided))}
    metrics["adm256_ilvr"].update(step_ms=1e3 * i_seconds / ilvr_rows,
                                  unguided_step_ms=1e3 * u_seconds / ilvr_rows,
                                  low_pass_gap=gap, imgs_per_s=EDIT_B / i_seconds)
    log(f"ILVR b{EDIT_B} DDPM-{ilvr_rows}, factor {ILVR_FACTOR}, cubic, on ADM-256: "
        f"{i_seconds:.3f} s against {u_seconds:.3f} s unguided ({card}); "
        f"|phi(out) - phi(ref)| / |phi(ref)|: ILVR {gap['ilvr']:.4f}, unguided "
        f"{gap['unguided']:.4f}")
    check(bool(torch.isfinite(out).all()) and gap["ilvr"] < 0.25 * gap["unguided"],
          "ILVR: the sample's low frequencies are the reference's (gap < 1/4 of the unguided)")
    del adm, adm_fn, out, unguided
    torch.cuda.empty_cache()
    part_done("e")

    # (f) DDIB on the class-conditional ADM-256: agreement at b2 over 5 + 5
    # steps, then DDIM-50 inversion under class A and sampling under class B
    adm_cond_conf = Config({"target": ADM256_CONF["target"],
                            "params": dict(ADM256_CONF["params"], num_classes=1000)})
    adm, adm_ref = build(adm_cond_conf, {"use_fp16": False})
    check_kw = dict(ADM256_DIFFUSION["params"], respace_type="uniform",
                    respace_steps=DDIB_CHECK_STEPS)
    pair = refs[:2]
    ddib_call, _ = agreement(
        f"DDIB b2 DDIM {DDIB_CHECK_STEPS} + {DDIB_CHECK_STEPS} steps",
        lambda: sample_ddib.translate_batch(adm, DDIM(**check_kw), pair, DDIB_CLASSES[0],
                                            DDIB_CLASSES[1]),
        lambda: sample_ddib.translate_batch(adm_ref, DDIM(**check_kw), pair, DDIB_CLASSES[0],
                                            DDIB_CLASSES[1]))
    del adm_ref
    torch.cuda.empty_cache()
    ddib = DDIM(**dict(ADM256_DIFFUSION["params"], respace_type="uniform",
                       respace_steps=DDIB_STEPS))
    ddib_rows = 2 * len(ddib.respaced_seq) - 1  # the inversion's S - 1 calls, then S
    check_rows = 2 * len(DDIM(**check_kw).respaced_seq) - 1
    per_ddib_call = {k: v // check_rows for k, v in ddib_call.items()}
    check(all(v == per_ddib_call[k] * check_rows for k, v in ddib_call.items())
          and per_ddib_call == adm_call,
          f"DDIB: {check_rows} UNet calls of {per_ddib_call} in the check run")
    sample_ddib.translate_batch(adm, DDIM(**check_kw), refs, *DDIB_CLASSES)  # warm-up
    out, seconds = timed("adm256_ddib", lambda: sample_ddib.translate_batch(
        adm, ddib, refs, *DDIB_CLASSES), per_ddib_call, ddib_rows)
    metrics["adm256_ddib"].update(imgs_per_s=EDIT_B / seconds)
    log(f"DDIB b{EDIT_B} on the class-conditional ADM-256, DDIM-{DDIB_STEPS} inversion under "
        f"class {DDIB_CLASSES[0]} then sampling under {DDIB_CLASSES[1]} ({ddib_rows} UNet "
        f"calls): {seconds:.3f} s ({card})")
    check(tuple(out.shape) == tuple(refs.shape) and bool(torch.isfinite(out).all()),
          f"DDIB: finite [{EDIT_B}, 3, {size}, {size}]")
    del adm, out, refs
    torch.cuda.empty_cache()
    part_done("f")
    log("phase 18 seconds by part: " + json.dumps(metrics["part_seconds"]))
    return {"launches": request_launches, "metrics": metrics, "k1": k1_rows,
            "k1_per_call": k1_per_call, "k3_per_call": k3_per_call,
            "d512_launches": d512_launches, "d512_by_path": d512_by_path,
            "k1_mma_per_call": k1_mma_ms}


def phase_celebahq_t5(dev, check, gen, card, time_ms, host_us) -> dict:
    """Phase 19 (see the module docstring): CelebA-HQ DDPM training through
    K2 at head dim 512 (``train_ddpm``), and the T5 text path
    (``FrozenT5Embedder``, ``encode_prompts``) at full width."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dmtpu_torch.models.stablediffusion.text_encoders import (
        CLIP_TEXT_CONFIGS,
        FrozenCLIPEmbedder,
        FrozenOpenCLIPEmbedder,
        FrozenT5Embedder,
    )
    from dmtpu_torch.ops import _build, plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
    from dmtpu_torch.scripts import encode_prompts, sample_mmdit, train_ddpm
    from dmtpu_torch.scripts._common import seeded_instance
    from dmtpu_torch.utils import checkpoint as ckpt_lib
    from dmtpu_torch.utils.config import instantiate_from_config, load_config, merge_dotlist

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        for fn in (flash_attention_fwd, flash_attention_bwd):
            fn.launches_by_kernel.update(mma=0, wgmma=0)
            fn.launches_by_head_dim.clear()

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def by_dim():
        return {"K1": dict(flash_attention_fwd.launches_by_head_dim),
                "K2": dict(flash_attention_bwd.launches_by_head_dim)}

    def times(per_step, n):
        return {key: n * c for key, c in per_step.items()}

    def rel(a, ref) -> float:
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    def part_done(name):
        now = time.perf_counter()
        metrics["part_seconds"][name] = now - part_start[0]
        part_start[0] = now

    g = gen(SEED + 90)
    metrics = {"part_seconds": {}}
    part_start = [time.perf_counter()]

    # (a) K2 at d=512 (csrc/flash_attn_bwd_mma_d512.cu) at CelebA-HQ's shapes
    # at b16, a ragged length and a padded head dim, from K1's outputs and a
    # random dO
    log_lines = (_build.build().parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log_lines):
        if "Compiling entry" in line and "flash_bwd_d512_kernel" in line:
            log("K2 d=512 ptxas: " + " | ".join(x.strip() for x in log_lines[i + 1:i + 4])
                + f"; {K2_D512_SMEM} bytes of dynamic shared memory")
    k2 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, host_us=0.0, err=0.0,
              bound_ms_by={"bytes": 0.0, "operations": 0.0})
    k2_rows = {}
    for b, s, d, calls in K2_D512_ROWS:
        q, k, v, do = (torch.randn(b, s, 1, d, generator=g, device=dev).bfloat16()
                       for _ in range(4))
        row, per = k2_call_row(q, k, v, do, calls, f"K2 d={d} b{b} h1 S={s}", check, time_ms,
                               host_us, card, 20, expect="mma")
        row["sdpa_backend"] = sdpa_backend(*(z.transpose(1, 2) for z in (q, k, v)))
        k2_rows[f"b{b}_s{s}_d{d}"] = row
        if calls:
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_us"):
                k2[key] += per[key]
            for by, ms in per["bound_ms_by"].items():
                k2["bound_ms_by"][by] += ms
            k2["err"] = max(k2["err"], per["err"])
        del q, k, v, do
    log(f"K2 per b{CELEBAHQ_TRAIN_B} CelebA-HQ UNet train step (6 calls at d=512): "
        + json.dumps(k2) + "; SDPA's backend at d=512: "
        + json.dumps({key: row["sdpa_backend"] for key, row in k2_rows.items()}))
    torch.cuda.empty_cache()
    part_done("a")

    # (b) the CelebA-HQ UNet at full width: b2 loss and gradient through the
    # kernels and the plain bf16 path against an f32 plain run (TF32 off),
    # seeded random weights (the config's dropout is 0)
    conf = merge_dotlist(load_config(CELEBAHQ_CONFIG), PIXEL_OVERRIDES)
    total_steps = int(conf.diffusion.params.total_steps)
    size = conf.data.params.img_size
    shape = (conf.data.img_channels, size, size)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = instantiate_from_config(conf.model, device=dev)
    init_random_(model, g)
    ref = instantiate_from_config({"target": conf.model.target,
                                   "params": dict(conf.model.params.to_dict(), dtype=None)},
                                  device=dev)
    ref.load_state_dict(model.state_dict())
    diffuser = instantiate_from_config(conf.diffusion)
    b = CELEBAHQ_TRAIN_CHECK_BATCH
    fixed = {"x": torch.rand(b, *shape, generator=g, device=dev) * 2 - 1,
             "eps": torch.randn(b, *shape, generator=g, device=dev),
             "t": torch.tensor([total_steps - 1, 421 * total_steps // 1000], device=dev)[:b]}

    def loss_and_grads(m, plain: bool):
        m.zero_grad(set_to_none=True)
        with plain_ops() if plain else contextlib.nullcontext():
            loss = diffuser.loss_func(lambda xt, tt: m(xt, tt, train=True), fixed["x"],
                                      fixed["t"], eps=fixed["eps"])
            loss.backward()
        grads = {name: p.grad.detach().clone() for name, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.detach(), grads

    def grad_err(grads, want) -> float:
        return (sum((grads[k_] - want[k_]).square().sum() for k_ in want).sqrt()
                / sum(w.square().sum() for w in want.values()).sqrt()).item()

    def norm(grads) -> float:
        return sum(x.square().sum() for x in grads.values()).sqrt().item()

    loss_f, grads_f = loss_and_grads(ref, plain=True)
    del ref
    zero_counts()
    with recorded_ops({}) as calls:
        loss_k, grads_k = loss_and_grads(model, plain=False)
    torch.cuda.synchronize()
    step_launches, step_dims = counts(), by_dim()
    loss_p, grads_p = loss_and_grads(model, plain=True)
    errs = {"loss": (abs(loss_k.item() - loss_f.item()) / abs(loss_f.item()),
                     abs(loss_p.item() - loss_f.item()) / abs(loss_f.item())),
            "gradient": (grad_err(grads_k, grads_f), grad_err(grads_p, grads_f)),
            "grad_norm": (abs(norm(grads_k) - norm(grads_f)) / norm(grads_f),
                          abs(norm(grads_p) - norm(grads_f)) / norm(grads_f))}
    metrics["agreement_b2"] = errs
    log(f"CelebA-HQ UNet train b{b}: loss f32 {loss_f.item():.6f}, kernels {loss_k.item():.6f}, "
        f"plain bf16 {loss_p.item():.6f}; grad norm f32 {norm(grads_f):.6f}; rel err vs f32 "
        "(kernels, plain bf16): " + json.dumps(errs) + f"; launches {step_launches}, by head dim "
        f"{step_dims}; attention calls {dict(calls['attention'])}")
    for what, (err_k, err_p) in errs.items():
        check(math.isfinite(err_k) and err_k <= 1.5 * err_p + 1e-3,
              f"CelebA-HQ UNet train {what}: err(kernels) <= 1.5 err(plain) + 1e-3")
    per_step = {"K1": sum(calls["attention"].values()), "K2": sum(calls["attention"].values()),
                "K3": sum(calls["group_norm"].values())}
    d512 = {"K1": {512: per_step["K1"]}, "K2": {512: per_step["K2"]}}
    check(dict(calls["attention"]) == CELEBAHQ_ATTN and per_step == CELEBAHQ_TRAIN_STEP
          and step_launches == per_step and step_dims == d512,
          f"CelebA-HQ UNet forward+backward: attention {dict(calls['attention'])} == "
          f"{CELEBAHQ_ATTN}; launches {step_launches} == {CELEBAHQ_TRAIN_STEP}, every K1 and K2 "
          f"at d=512 {step_dims}")
    del model, grads_f, grads_k, grads_p
    torch.cuda.empty_cache()

    # the config's train step at b16 256x256: its UNet built as train_ddpm
    # builds it, its Adam, clip and gradual EMA; PyTorch's default TF32
    # settings, as the CLI runs
    torch.backends.cudnn.allow_tf32 = True
    model = seeded_instance(conf.model, dev, SEED)
    state = TrainState.create(model, instantiate_from_config(conf.train.optim,
                                                             params=model.parameters()),
                              ema_decay=conf.train.ema_decay,
                              ema_gradual=conf.train.ema_gradual)
    step = make_train_step(make_diffusion_loss_fn(
        diffuser, lambda x, t, **kw: model(x, t, train=True, **kw), total_steps),
        clip_grad_norm=conf.train.clip_grad_norm, seed=SEED)
    n = CELEBAHQ_TRAIN_B
    batch = torch.rand(n, *shape, generator=g, device=dev) * 2 - 1
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    history = [step(state, batch) for _ in range(CELEBAHQ_TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, dims = counts(), by_dim()
    k1_by_kernel = dict(flash_attention_fwd.launches_by_kernel)
    k2_by_kernel = dict(flash_attention_bwd.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in history]
    norms = [m["grad_norm"].item() for m in history]
    profile = profile_by_class(lambda: step(state, batch), 1)
    idle = max(0.0, 1 - profile["classes"]["total"] / profile["wall_ms"])
    label = f"train_b{n}"
    metrics[label] = {
        "imgs_per_s": n * CELEBAHQ_TRAIN_STEPS / seconds,
        "ms_per_step": 1e3 * seconds / CELEBAHQ_TRAIN_STEPS, "peak_bytes": peak, "batch": n,
        "steps": CELEBAHQ_TRAIN_STEPS, "launches_per_step": per_step,
        "params": sum(p.numel() for p in model.parameters()),
        "profile_ms": dict(profile["classes"], wall=profile["wall_ms"], **profile["ranges"]),
        "idle_share": idle}
    log(f"CelebA-HQ UNet train b{n} {size}x{size}: {CELEBAHQ_TRAIN_STEPS} steps in "
        f"{seconds:.3f} s, {metrics[label]['imgs_per_s']:.2f} imgs/s, "
        f"{metrics[label]['ms_per_step']:.3f} ms/step, peak {peak / 2**30:.3f} GiB ({card}); "
        f"launches {launches}, by head dim {dims}, K2 by kernel {k2_by_kernel}; losses {losses}; "
        f"grad norms {norms}")
    log(f"CelebA-HQ UNet train b{n} step device time by class (torch.profiler, one step; wall "
        f"{profile['wall_ms']:.3f} ms under the profiler, the card idle {idle:.3f} of it): "
        + json.dumps(profile["classes"]) + "; annotated ranges: " + json.dumps(profile["ranges"]))
    for name, kernel_ms in profile["top"]:
        log(f"  {kernel_ms:9.4f} ms  {name}")
    check(all(map(math.isfinite, losses + norms)),
          f"CelebA-HQ UNet train b{n}: finite losses and grad norms")
    check(launches == times(per_step, CELEBAHQ_TRAIN_STEPS)
          and dims == {key: {512: CELEBAHQ_TRAIN_STEPS * c[512]} for key, c in d512.items()}
          and k1_by_kernel == {"mma": 0, "wgmma": launches["K1"]}
          and k2_by_kernel == {"mma": launches["K2"], "wgmma": 0},
          f"CelebA-HQ UNet train b{n} launches {launches} == {CELEBAHQ_TRAIN_STEPS} x "
          f"{per_step}, K1 and K2 all at d=512 {dims}, K1 through wgmma {k1_by_kernel}, K2 "
          f"through mma.sync {k2_by_kernel}")
    check(profile["classes"]["K2 attention backward"] > 0 and profile["classes"]["K1 attention"]
          > 0 and profile["classes"]["K3 GroupNorm"] > 0,
          "profile: the CelebA-HQ UNet train step ran K1, K2 and K3 on the card")
    d512_launches = dims["K2"].get(512, 0)
    d512_by_path = {f"celebahq_train{CELEBAHQ_TRAIN_STEPS}": d512_launches}
    del state, step, batch, history, model
    torch.cuda.empty_cache()
    part_done("b_step")

    # train_ddpm in this process on configs/ddpm_celebahq.yaml: a run that
    # saves and samples a small grid, then its resume
    root = tempfile.mkdtemp(prefix="chip_smoke_celebahq_train_")
    try:
        exp = os.path.join(root, "exp")
        base = ["-c", CELEBAHQ_CONFIG, "-e", exp, "-ni", *PIXEL_OVERRIDES, *CELEBAHQ_CLI,
                f"train.save_freq={CELEBAHQ_CLI_STEPS}"]
        grid_rows = len(instantiate_from_config(
            merge_dotlist(load_config(CELEBAHQ_CONFIG), CELEBAHQ_CLI).diffusion).respaced_seq)
        zero_counts()
        first = train_ddpm.main(base + [f"train.n_steps={CELEBAHQ_CLI_STEPS}",
                                        f"train.sample_freq={CELEBAHQ_CLI_STEPS}"])
        torch.cuda.synchronize()
        run1, dims1 = counts(), by_dim()
        zero_counts()
        again = train_ddpm.main(base + ["-r", "latest",
                                        f"train.n_steps={CELEBAHQ_CLI_RESUMED_STEPS}",
                                        "train.sample_freq=0"])
        torch.cuda.synchronize()
        run2, dims2 = counts(), by_dim()
        ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
        ckpt_bytes = os.path.getsize(os.path.join(exp, "ckpt", ckpts[-1], "state.pt"))
        blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", ckpts[-1]))
        blob_step, blob_ema = blob["step"], blob["ema"]["num_updates"]
        del blob
        grids = sorted(os.listdir(os.path.join(exp, "samples")))
        log_text = "".join(open(os.path.join(exp, f)).read() for f in os.listdir(exp)
                           if f.startswith("output-"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = first["losses"] + again["losses"]
    metrics["cli"] = {
        "losses": losses, "save_seconds": first["save_seconds"] + again["save_seconds"],
        "load_seconds": again["load_seconds"], "checkpoint_bytes": ckpt_bytes,
        "step_seconds": first["step_seconds"] + again["step_seconds"],
        "launches": {"train": run1, "resume": run2}, "grid_rows": grid_rows}
    log(f"train_ddpm {CELEBAHQ_CONFIG} b{n} (Synthetic {size}x{size} data): "
        f"{CELEBAHQ_CLI_STEPS} steps with a save and a {grid_rows}-step grid of 4, then -r latest "
        f"to {CELEBAHQ_CLI_RESUMED_STEPS}: step seconds {metrics['cli']['step_seconds']}; "
        f"checkpoint {ckpt_bytes / 2**20:.1f} MiB, saves {metrics['cli']['save_seconds']} s, "
        f"load {again['load_seconds']:.3f} s ({card}); losses {losses}; launches {run1} (by head "
        f"dim {dims1}), {run2}; checkpoints {ckpts}, grids {grids}")
    check(ckpts == [f"step{n_ - 1:06d}" for n_ in (CELEBAHQ_CLI_STEPS, CELEBAHQ_CLI_RESUMED_STEPS)]
          and blob_step == blob_ema == CELEBAHQ_CLI_RESUMED_STEPS and "Resumed from" in log_text
          and grids == [f"step{CELEBAHQ_CLI_STEPS - 1:06d}.png"],
          f"train_ddpm CelebA-HQ: checkpoints at the ends of both runs, resumed to step "
          f"{CELEBAHQ_CLI_RESUMED_STEPS}, one eval grid")
    check(len(losses) == CELEBAHQ_CLI_RESUMED_STEPS and all(map(math.isfinite, losses)),
          "train_ddpm CelebA-HQ: finite losses at every step")
    want1 = {key: CELEBAHQ_CLI_STEPS * c + (grid_rows * c if key != "K2" else 0)
             for key, c in per_step.items()}
    want2 = times(per_step, CELEBAHQ_CLI_RESUMED_STEPS - CELEBAHQ_CLI_STEPS)
    check(run1 == want1 and run2 == want2 and set(dims1["K2"]) == set(dims2["K2"]) == {512},
          f"train_ddpm CelebA-HQ launches {run1} == {want1}, resumed {run2} == {want2}, K2 at "
          "d=512")
    d512_by_path.update(celebahq_cli_train=dims1["K2"].get(512, 0),
                        celebahq_cli_resume=dims2["K2"].get(512, 0))
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    part_done("b_cli")

    # (c) T5 at full width: google/t5-v1_1-xxl's published shape with random
    # weights from a seed, built on the card (f32, then cast in place to
    # bf16; nothing written to disk), beside CLIP-L and OpenCLIP bigG at full
    # width (f32) through encode_real at b4
    from transformers import AutoTokenizer, CLIPTokenizer, T5Config, T5EncoderModel

    root = tempfile.mkdtemp(prefix="chip_smoke_t5_")
    try:
        clip_tok_dir = write_char_clip_tokenizer(os.path.join(root, "clip_tokenizer"))
        clip_tok = CLIPTokenizer.from_pretrained(clip_tok_dir)
        t5_tok = AutoTokenizer.from_pretrained(write_char_t5_tokenizer(
            os.path.join(root, "t5_tokenizer")))
        torch.manual_seed(SEED + 91)
        t0 = time.perf_counter()
        with torch.device(dev):  # the random init on the card
            t5 = T5EncoderModel(T5Config(**T5_XXL)).eval()
        clip_l = FrozenCLIPEmbedder("clip-vit-l", tokenizer=clip_tok, device=dev).eval()
        clip_g = FrozenOpenCLIPEmbedder("open-clip-vit-bigg", tokenizer=clip_tok,
                                        device=dev).eval()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_t5 = sum(p.numel() for p in t5.parameters())
        embedder = FrozenT5Embedder(None, module=t5, tokenizer=t5_tok)
        prompts = list(ENCODE_PROMPTS)
        ctx32, pool32 = encode_prompts.encode_real(prompts, clip_l, clip_g, embedder)
        t5.to(torch.bfloat16)
        encode_prompts.encode_real(prompts, clip_l, clip_g, embedder)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ctx, pool = encode_prompts.encode_real(prompts, clip_l, clip_g, embedder)
        torch.cuda.synchronize()
        encode_ms = 1e3 * (time.perf_counter() - t0)
        t5_ms = time_ms(lambda: embedder.encode(prompts), 3)
        t5_peak = torch.cuda.max_memory_allocated()
        tokens = clip_l.max_length
        t5_err = rel(ctx[:, tokens:], ctx32[:, tokens:])
        metrics["t5_xxl"] = {
            "params": n_t5, "build_seconds": build_s, "encode_real_b4_ms": encode_ms,
            "t5_b4_ms": t5_ms, "peak_bytes": t5_peak, "bf16_vs_f32_rel_l2": t5_err,
            "context_shape": list(ctx.shape), "pooled_shape": list(pool.shape)}
        log(f"T5-XXL-shaped encoder ({n_t5} parameters, bf16) with CLIP-L and bigG (f32) built on "
            f"the card in {build_s:.1f} s; encode_real b{len(prompts)}: {encode_ms:.2f} ms (host "
            f"clock), the T5 alone {t5_ms:.2f} ms (CUDA events), peak {t5_peak / 2**30:.3f} GiB "
            f"({card}); context {tuple(ctx.shape)}, pooled {tuple(pool.shape)}; bf16 T5 vs f32: "
            f"rel L2 {t5_err:.3e}")
        check(n_t5 == T5_XXL_PARAMS and tuple(ctx.shape) == (len(prompts), 2 * tokens, 4096)
              and tuple(pool.shape) == (len(prompts), 2048) and bool(torch.isfinite(ctx).all())
              and bool(torch.isfinite(pool).all()) and ctx.dtype == torch.float32,
              f"encode_real with a T5-XXL-shaped encoder ({T5_XXL_PARAMS} parameters): context "
              f"[{len(prompts)}, 154, 4096], pooled [{len(prompts)}, 2048], finite")
        check(t5_err <= 5e-2 and rel(ctx[:, :tokens], ctx32[:, :tokens]) <= 1e-6
              and rel(pool, pool32) <= 1e-6,
              "T5-XXL in bf16 within 5e-2 relative L2 of f32 on the card; the CLIP half unchanged")
        clip_half = ctx32[:, :tokens].cpu()
        del t5, embedder, ctx, ctx32, pool
        torch.cuda.empty_cache()
        part_done("c")

        # (d) python -m dmtpu_torch.scripts.encode_prompts in this process:
        # real mode from tower files written here (the CLIP towers as torch
        # files with their configs; a T5 of XXL widths at reduced depth saved
        # with its tokenizer), once with --no_t5 and once with --t5_dir; then
        # demo mode
        l_path, g_path = os.path.join(root, "clip_l.pt"), os.path.join(root, "clip_g.pt")
        for path, emb, preset in ((l_path, clip_l, "clip-vit-l"),
                                  (g_path, clip_g, "open-clip-vit-bigg")):
            torch.save({"state_dict": emb.model.state_dict(),
                        "config": dict(CLIP_TEXT_CONFIGS[preset], max_length=tokens)}, path)
        del clip_l, clip_g
        t5_dir = os.path.join(root, "t5")
        with torch.device(dev):
            small = T5EncoderModel(T5Config(**dict(T5_XXL, num_layers=T5_CLI_LAYERS)))
        small.to(torch.bfloat16).save_pretrained(t5_dir)
        write_char_t5_tokenizer(t5_dir)
        del small
        torch.cuda.empty_cache()
        real = ["--prompts", *prompts, "--clip_l_weights", l_path, "--clip_g_weights", g_path,
                "--clip_tokenizer", clip_tok_dir, "--device", "cuda"]
        outs = {}
        for name, extra in (("no_t5", ["--no_t5"]), ("t5_dir", ["--t5_dir", t5_dir]),
                            ("demo", None)):
            out = os.path.join(root, f"{name}.npz")
            t0 = time.perf_counter()
            encode_prompts.main(["--out", out, *(real + extra if extra else
                                                 ["--prompts", *prompts, "--device", "cuda"])])
            with np.load(out) as data:
                outs[name] = (dict(data), time.perf_counter() - t0)
        metrics["encode_prompts_seconds"] = {k: v[1] for k, v in outs.items()}
        (no_t5, _), (with_t5, _), (demo, _) = outs["no_t5"], outs["t5_dir"], outs["demo"]
        log("encode_prompts.main on the card: " + json.dumps(
            {k: {"context": list(v[0]["context"].shape), "pooled": list(v[0]["pooled"].shape),
                 "seconds": v[1]} for k, v in outs.items()}))
        want_ctx, want_pool = (len(prompts), 2 * tokens, 4096), (len(prompts), 2048)
        check(all(d["context"].shape == want_ctx and d["pooled"].shape == want_pool
                  and np.isfinite(d["context"]).all() for d in (no_t5, with_t5))
              and not no_t5["context"][:, tokens:].any() and with_t5["context"][:, tokens:].any()
              and np.allclose(no_t5["context"][:, :tokens], clip_half.numpy(), rtol=1e-5,
                              atol=1e-5)
              and np.array_equal(no_t5["context"][:, :tokens], with_t5["context"][:, :tokens]),
              "encode_prompts real mode from tower files: [4, 154, 4096] / [4, 2048]; --no_t5 "
              "zero-fills the T5 half, --t5_dir fills it; the CLIP half is the towers' of (c)")
        rows = [sample_mmdit.demo_embeddings(p, 154, 4096, 2048) for p in prompts]
        check(demo["context"].tobytes() == np.concatenate([c for c, _ in rows]).tobytes()
              and demo["pooled"].tobytes() == np.concatenate([p for _, p in rows]).tobytes(),
              "encode_prompts demo mode: the rows of sample_mmdit --prompt, byte for byte")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    part_done("d")
    log("phase 19 seconds by part: " + json.dumps(metrics["part_seconds"]))
    return {"launches": {f"celebahq_train{CELEBAHQ_TRAIN_STEPS}": launches,
                         "celebahq_cli_train": run1, "celebahq_cli_resume": run2},
            "metrics": metrics, "k2": k2_rows, "k2_per_step": {f"celebahq_train_b{n}": k2},
            "d512_launches": d512_launches, "d512_by_path": d512_by_path}


def init_inception_(model, generator) -> None:
    """Seeded weights for the FID InceptionV3, as ``tests/test_accept.py``
    fabricates them: convolutions and ``fc`` N(0, 1 / fan_in), batch-norm
    scales 1 + 0.5|N|, biases and running means 0.5 N, variances 1 (random
    weights alone collapse the features through ~95 conv + BN layers)."""
    import torch

    with torch.no_grad():
        for name, p in model.state_dict().items():
            noise = torch.randn(p.shape, generator=generator, device=p.device)
            if name.endswith("bn.weight"):
                p.copy_(1 + 0.5 * noise.abs())
            elif name.endswith(("bn.bias", "running_mean")):
                p.copy_(0.5 * noise)
            elif name.endswith("running_var"):
                p.fill_(1.0)
            elif name == "fc.bias":
                p.zero_()
            else:
                p.copy_(noise * p[0].numel() ** -0.5)


def phase_eval(dev, check, gen, card, time_ms) -> dict:
    """Phase 20 (see the module docstring): FID / IS / KID through ``python
    -m dmtpu_torch.scripts.accept`` on the CIFAR-10 UNet and ``python -m
    dmtpu_torch.scripts.evaluate`` (classic FID + IS + KID, and CLIP-FID)."""
    import contextlib
    import io
    import multiprocessing
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image
    from dmtpu_torch.eval import InceptionFeatureExtractor, fid_from_features, inception_score
    from dmtpu_torch.eval import fid as fid_module
    from dmtpu_torch.eval.fid import kid_from_features
    from dmtpu_torch.eval.inception import FIDInceptionV3, exact_f32
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.scripts import accept, evaluate
    from dmtpu_torch.utils.config import instantiate_from_config, load_config

    def rel(a, ref) -> float:
        a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
        return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))

    def close(a, b) -> bool:  # the CPU tests' parity tolerance
        return abs(a - b) <= max(1e-4 * abs(b), 1e-4)

    def run_cli(main, argv):
        """(exit code or None, stdout) of ``main(argv)`` in this process."""
        out, code = io.StringIO(), None
        with contextlib.redirect_stdout(out):
            try:
                main(argv)
            except SystemExit as e:
                code = e.code
        return code, out.getvalue()

    g = gen(SEED + 100)
    started = time.perf_counter()
    metrics = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        # (a) the files: a pt_inception .pth, five data_batch pickles, a UNet
        torch.manual_seed(SEED)
        with torch.device(dev):
            inception = FIDInceptionV3()
        init_inception_(inception, g)
        inception_pth = os.path.join(root, "pt_inception-2015-12-05-52768-1.pth")
        torch.save({k: v.cpu() for k, v in inception.state_dict().items()}, inception_pth)
        cifar = os.path.join(root, "cifar-10-batches-py")
        os.makedirs(cifar)
        rs = np.random.RandomState(SEED)
        for i in range(1, 6):
            with open(os.path.join(cifar, f"data_batch_{i}"), "wb") as f:
                pickle.dump({b"data": rs.randint(0, 256, (EVAL_PER_BATCH, 3072), dtype=np.uint8),
                             b"labels": list(rs.randint(0, 10, EVAL_PER_BATCH))}, f)
        unet = instantiate_from_config(load_config(CIFAR_CONFIG)["model"], device=dev)
        init_random_(unet, g)
        unet_pt = os.path.join(root, "unet.pt")
        torch.save(unet.state_dict(), unet_pt)
        del unet
        torch.cuda.empty_cache()
        metrics["files_seconds"] = time.perf_counter() - started

        # (b) accept: the machinery, the missing-artifact path, then the row
        code, out = run_cli(accept.main, ["--self_test"])
        check(code == 0 and "machinery OK" in out, "accept --self_test exits 0")
        saved_env = {k: os.environ.pop(k, None) for k in
                     ("DMTPU_INCEPTION_WEIGHTS", "DMTPU_DATA_DIR", "DMTPU_ACCEPT_WEIGHTS")}
        try:
            code, out = run_cli(accept.main, ["--rows", EVAL_ROW])
        finally:
            os.environ.update({k: v for k, v in saved_env.items() if v is not None})
        check(code == 2 and all(w in out for w in ("inception weights", "CIFAR-10", "checkpoint")),
              "accept without artifacts exits 2 and names the Inception weights, CIFAR-10 and "
              "the checkpoint")
        spent = {"sample": 0.0, "features": 0.0, "sqrtm": []}
        seen = {}

        def timed(name, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                seconds = time.perf_counter() - t0
                if name == "sqrtm":
                    spent[name].append(seconds)
                else:
                    spent[name] += seconds
                if name == "features":
                    seen.setdefault("sets", []).append(args[1])
                return out
            return run

        patched = [(accept, "sample_row"), (InceptionFeatureExtractor, "_batched"),
                   (fid_module, "frechet_distance")]
        originals = [getattr(obj, name) for obj, name in patched]
        for (obj, name), fn, label in zip(patched, originals, ("sample", "features", "sqrtm")):
            setattr(obj, name, timed(label, fn))
        out_json = os.path.join(root, "accept.json")
        argv = ["--rows", EVAL_ROW, "--config", CIFAR_CONFIG, "--weights", unet_pt,
                "--inception_weights", inception_pth,
                "--cifar10_dir", root, "--n_samples", str(EVAL_N), "--batch_size", str(EVAL_B),
                "--eval_batch_size", str(EVAL_FEATURE_B), "--out", out_json, *PIXEL_OVERRIDES]
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_head_dim.clear()
        t0 = time.perf_counter()
        try:
            code, out = run_cli(accept.main, argv)
        finally:
            for (obj, name), fn in zip(patched, originals):
                setattr(obj, name, fn)
        accept_seconds = time.perf_counter() - t0
        launches = {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                    "K3": group_norm_silu.launches}
        by_dim = dict(flash_attention_fwd.launches_by_head_dim)
        for line in out.strip().splitlines():
            log("  accept:", line)
        row = json.loads(open(out_json).read())["rows"][EVAL_ROW]
        calls = len(accept.build_diffuser(accept.ROWS[EVAL_ROW]).respaced_seq) * (EVAL_N // EVAL_B)
        want = {k: calls * v for k, v in EVAL_CALL.items()}
        metrics["accept"] = dict(row, exit_code=code, seconds=accept_seconds,
                                 sample_seconds=spent["sample"],
                                 feature_seconds=spent["features"],
                                 sqrtm_seconds=spent["sqrtm"], launches=launches,
                                 k1_by_head_dim=by_dim, n_samples=EVAL_N, batch=EVAL_B)
        log(f"accept --rows {EVAL_ROW} on {CIFAR_CONFIG} (seeded weights, bf16 torso), "
            f"{EVAL_N} samples a side at b{EVAL_B}: exit {code}, FID {row['fid']:.4f}, IS "
            f"{row['is_mean']:.4f} +- {row['is_std']:.4f}; {accept_seconds:.3f} s in all: "
            f"sampling {spent['sample']:.3f} s ({EVAL_N / spent['sample']:.1f} images/s), "
            f"Inception features {spent['features']:.3f} s for {2 * EVAL_N} images, the host's "
            f"sqrtm {spent['sqrtm']} s ({card}); launches {launches}, K1 by head dim {by_dim}")
        check(code == 1 and np.isfinite(row["fid"]) and row["fid"] > 0 and row["is_mean"] >= 1.0
              and any(ln.startswith(EVAL_ROW) and "FAIL" in ln for ln in out.splitlines()),
              f"accept {EVAL_ROW} on seeded weights: exit 1 (out of tolerance), finite FID > 0, "
              "IS >= 1, a FAIL row")
        check(launches == want and by_dim == {256: want["K1"]},
              f"accept launches: exactly {want['K1']} K1 (all d=256), {want['K3']} K3, 0 K2 "
              f"({calls} UNet calls)")
        real_u8, fake_u8 = seen["sets"]
        check(len(real_u8) == len(fake_u8) == EVAL_N and real_u8.dtype == fake_u8.dtype == np.uint8,
              f"accept's sets: {EVAL_N} uint8 images a side")

        # (c) the Inception forward on the card against the CPU's, f32.  The
        # two FIDs of (c) and (d) that no CLI computes run their host sqrtm in
        # a pool of two spawned processes, beside the card's work and the CPU
        # extractor: each takes as long as the whole card side of the phase
        ext = InceptionFeatureExtractor(inception_pth, batch_size=EVAL_FEATURE_B, device=dev)
        cpu_ext = InceptionFeatureExtractor(inception_pth, batch_size=64, device="cpu")
        check_u8 = np.ascontiguousarray(fake_u8[:EVAL_CHECK_IMAGES])
        cpu_pool3, cpu_probs = cpu_ext.features_and_probs(check_u8)
        card_pool3, card_probs = ext.features_and_probs(check_u8)

        def tf32_sweep(images):
            """(pool3, probabilities) of the card's forward with TF32 on."""
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            feats, probs = [], []
            with torch.no_grad():
                for i in range(0, len(images), EVAL_FEATURE_B):
                    x = torch.from_numpy(np.ascontiguousarray(images[i:i + EVAL_FEATURE_B]))
                    f, logits = ext.module(x.to(dev).permute(0, 3, 1, 2).float() / 255.0)
                    feats.append(f.cpu().numpy())
                    probs.append(torch.softmax(logits, -1).cpu().numpy())
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            return np.concatenate(feats), np.concatenate(probs)

        tf32_pool3, tf32_probs = tf32_sweep(check_u8)
        errs = {"f32": {"pool3": rel(card_pool3, cpu_pool3), "probs": rel(card_probs, cpu_probs)},
                "tf32": {"pool3": rel(tf32_pool3, cpu_pool3), "probs": rel(tf32_probs, cpu_probs)}}
        check(errs["f32"]["pool3"] <= 1e-4 and errs["f32"]["probs"] <= 1e-4,
              f"Inception on the card (TF32 off) vs the CPU, {EVAL_CHECK_IMAGES} images: pool3 "
              f"{errs['f32']['pool3']:.3e}, probabilities {errs['f32']['probs']:.3e} relative L2 "
              "(<= 1e-4)")
        # one BLAS thread each: sqrtm's Schur steps barely use more, and
        # spinning BLAS threads of three processes would crowd the host
        blas = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")
        saved_env = {k: os.environ.get(k) for k in blas}
        os.environ.update(dict.fromkeys(blas, "1"))
        try:
            pool = multiprocessing.get_context("spawn").Pool(2)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        try:
            fid_tf32_job = pool.apply_async(fid_from_features, (tf32_sweep(real_u8)[0],
                                                                tf32_sweep(fake_u8)[0]))
            x = torch.rand(EVAL_FEATURE_B, 3, 299, 299, generator=g, device=dev)
            with torch.no_grad():
                with exact_f32():
                    f32_ms = time_ms(lambda: ext.module(x), 3)
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
                tf32_ms = time_ms(lambda: ext.module(x), 3)
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            del x

            # (d) evaluate on PNG directories of accept's images, with CLIP-FID,
            # and the same images through the CPU extractor
            from transformers import CLIPConfig, CLIPModel

            dirs = []
            for side, images in (("real", real_u8), ("fake", fake_u8)):
                os.makedirs(os.path.join(root, side))
                for i in range(EVAL_DIR_IMAGES):
                    Image.fromarray(images[i]).save(os.path.join(root, side, f"{i:04d}.png"))
                dirs += [f"--{side}_dir", os.path.join(root, side)]
            t0 = time.perf_counter()
            real = evaluate.load_images_u8(os.path.join(root, "real"))
            fake = evaluate.load_images_u8(os.path.join(root, "fake"))
            c_fake, c_probs = cpu_ext.features_and_probs(fake)
            c_real = cpu_ext(real)
            cpu_seconds = time.perf_counter() - t0
            cpu_fid_job = pool.apply_async(fid_from_features, (c_real, c_fake))
            cpu = {}
            cpu["is_mean"], cpu["is_std"] = inception_score(c_probs)
            cpu["kid_mean"], cpu["kid_std"] = kid_from_features(
                c_real, c_fake, subsets=EVAL_KID_SUBSETS, subset_size=EVAL_KID_SIZE)
            clip_dir = os.path.join(root, "clip")
            torch.manual_seed(SEED)
            with torch.device(dev):
                CLIPModel(CLIPConfig()).save_pretrained(clip_dir)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                results = evaluate.main([*dirs, "--inception_weights", inception_pth, "--kid",
                                         "--kid_subsets", str(EVAL_KID_SUBSETS),
                                         "--kid_subset_size", str(EVAL_KID_SIZE),
                                         "--clip_pretrained", clip_dir,
                                         "--batch_size", str(EVAL_FEATURE_B)])
            evaluate_seconds = time.perf_counter() - t0
            t0 = time.perf_counter()
            fid_tf32 = fid_tf32_job.get(timeout=600)
            cpu["fid"] = cpu_fid_job.get(timeout=600)
            waited = time.perf_counter() - t0
        finally:
            pool.terminate()
            pool.join()
        fid_f32 = row["fid"]
        metrics["inception"] = {
            "card_vs_cpu_rel_l2": errs, "fid_f32": fid_f32, "fid_tf32": fid_tf32,
            "fid_tf32_minus_f32": fid_tf32 - fid_f32,
            "b250_ms": {"f32": f32_ms, "tf32": tf32_ms},
            "images_per_s": {"f32": EVAL_FEATURE_B / f32_ms * 1e3,
                             "tf32": EVAL_FEATURE_B / tf32_ms * 1e3}}
        log(f"Inception b{EVAL_FEATURE_B} 299x299 forward: f32 {f32_ms:.3f} ms "
            f"({EVAL_FEATURE_B / f32_ms * 1e3:.1f} images/s), TF32 {tf32_ms:.3f} ms "
            f"({EVAL_FEATURE_B / tf32_ms * 1e3:.1f} images/s) ({card}); against the CPU's f32 "
            f"forward on {EVAL_CHECK_IMAGES} images: {json.dumps(errs)}; FID of accept's sets "
            f"with TF32 {fid_tf32:.6f} against {fid_f32:.6f} in f32 "
            f"({fid_tf32 - fid_f32:+.6f})")
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"evaluate, {EVAL_DIR_IMAGES} PNGs a side: {json.dumps(line)} in "
            f"{evaluate_seconds:.3f} s ({card}); the same images through the CPU extractor "
            f"({cpu_seconds:.3f} s for the features; {waited:.3f} s more waiting for the "
            f"pool's two sqrtm): {json.dumps(cpu)}")
        check(sorted(line) == ["clip_fid", "fid", "is_mean", "is_std", "kid_mean", "kid_std"]
              and all(np.isfinite(v) for v in line.values()),
              "evaluate prints finite FID, IS, KID and CLIP-FID")
        check(all(close(results[k], v) for k, v in cpu.items()),
              "evaluate's FID / IS / KID on the card equal the CPU path's within 1e-4")
        metrics["evaluate"] = {"printed": line, "results": results, "cpu": cpu,
                               "seconds": evaluate_seconds, "cpu_feature_seconds": cpu_seconds,
                               "pool_wait_seconds": waited, "images": EVAL_DIR_IMAGES}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    metrics["seconds"] = time.perf_counter() - started
    log(f"phase 20 wall {metrics['seconds']:.3f} s ({card})")
    check(metrics["seconds"] <= 150, f"phase 20 within 150 s ({metrics['seconds']:.1f} s)")
    return {"launches": {f"eval_accept_{EVAL_ROW}_n{EVAL_N}": launches},
            "metrics": metrics}


def sdpa_backend(q, k, v) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for [B, H, S, D]
    q, k, v (PyTorch's own choice function; "unknown" where this PyTorch has
    none)."""
    import torch

    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "unknown"
    from torch.nn.attention import SDPBackend

    return SDPBackend(choose(q, k, v)).name


def forward_flops(model, *inputs) -> int:
    """Operations (two a multiply-add) of one forward ``model(*inputs)``,
    counted from the shapes the forward sees: every linear layer and
    convolution at the rows it is given (forward hooks), and each attention's
    Q K^T and P V, 4 S_q S_k D over all heads: MMDiT's joint attention (a
    block) and the SD UNet's ``CrossAttention``.  The elementwise work is not
    counted."""
    import torch
    from torch import nn

    from dmtpu_torch.models.mmdit import MMDiTBlock
    from dmtpu_torch.models.stablediffusion.attention import CrossAttention

    total = [0]

    def linear(m, inputs, out):
        total[0] += 2 * out.numel() * m.in_features

    def conv(m, inputs, out):
        total[0] += 2 * out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]

    def joint(m, inputs, out):
        ctx, xx = inputs[0], inputs[1]
        s = ctx.shape[1] + xx.shape[1]
        total[0] += 4 * xx.shape[0] * s * s * xx.shape[2]

    def cross(m, args, kwargs, out):
        x = args[0]
        ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
        sk = x.shape[1] if ctx is None else ctx.shape[1]
        total[0] += 4 * x.shape[0] * x.shape[1] * sk * m.heads * m.dim_head

    hooks = [m.register_forward_hook(linear if isinstance(m, nn.Linear) else
                                     conv if isinstance(m, nn.Conv2d) else joint)
             for m in model.modules() if isinstance(m, (nn.Linear, nn.Conv2d, MMDiTBlock))]
    hooks += [m.register_forward_hook(cross, with_kwargs=True)
              for m in model.modules() if isinstance(m, CrossAttention)]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for hook in hooks:
            hook.remove()
    return total[0]


# kernel-name fragments -> class, first match wins
KERNEL_CLASSES = (
    ("flash_fwd", "K1 attention"), ("flash_bwd", "K2 attention backward"),
    ("group_norm", "K3 GroupNorm"),
    ("at::native", "PyTorch elementwise and reductions"),
    ("nchwToNhwc", "cuDNN convolutions"), ("nhwcToNchw", "cuDNN convolutions"),
    ("fprop", "cuDNN convolutions"), ("dgrad", "cuDNN convolutions"),
    ("wgrad", "cuDNN convolutions"), ("conv", "cuDNN convolutions"),
    ("gemm", "cuBLAS GEMMs"), ("nvjet", "cuBLAS GEMMs"),
)


def profile_by_class(fn, calls: int, host_ops: bool = True) -> dict:
    """Device time per call of ``fn`` by class of kernel (``KERNEL_CLASSES``,
    else "other"), the twelve costliest kernels, the device span of each
    annotated range (such as ``Optimizer.step``; not a kernel, so not in the
    classes) and the wall time per call, from ``torch.profiler``.  Without
    ``host_ops`` the profiler traces the device alone: no annotated ranges,
    and seconds instead of tens to read a trace of some ten thousand kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    classes = {name: 0.0 for _, name in KERNEL_CLASSES}
    classes["other"] = 0.0
    kernels, ranges = [], {}
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = row.self_device_time_total / 1e3 / calls
        if getattr(row, "is_user_annotation", False):
            ranges[row.key] = ms
            continue
        cls = next((c for frag, c in KERNEL_CLASSES if frag in row.key), "other")
        classes[cls] += ms
        kernels.append((row.key[:150], ms))
    classes["total"] = sum(classes.values())
    return {"classes": classes, "top": sorted(kernels, key=lambda kv: -kv[1])[:12],
            "ranges": ranges, "wall_ms": wall_ms}


def phase_remat_parallel(dev, check, gen, card, time_ms) -> dict:
    """Phase 21 (see the module docstring): the remat policies, LoRA under
    remat, a learning-rate schedule, data parallelism at world size 1 and
    the ring attention fold."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import yaml
    from dmtpu_torch.diffusions import DDPM
    from dmtpu_torch.models.lora import init_lora, lora_scale
    from dmtpu_torch.models.stablediffusion import SDUNetModel, StableDiffusion
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.attention import mha
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.ops.rematerialize import normalize_use_checkpoint
    from dmtpu_torch.parallel.sp import fold_attention, fold_attention_backward
    from dmtpu_torch.scripts import sample_uncond, train_ddpm, train_sd
    from dmtpu_torch.utils import checkpoint as ckpt_lib
    from dmtpu_torch.utils.config import instantiate_from_config, load_config, merge_dotlist
    from dmtpu_torch.utils.optim import build_schedule

    here = os.path.dirname(os.path.abspath(__file__))
    metrics: dict = {"card": card}
    launches: dict = {}

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_l2(got, want) -> float:
        num = sum((got[n].float() - want[n].float()).square().sum() for n in want)
        den = sum(want[n].float().square().sum() for n in want)
        return float((num / den).sqrt())

    # (a) the policies on the SD1.5 UNet at b4
    from dmtpu_torch.models.adm import GroupNorm32, ResBlock
    from dmtpu_torch.models.stablediffusion.attention import CrossAttention, SpatialTransformer

    model = SDUNetModel(**SD15, torso_dtype=torch.bfloat16, device=dev).train()
    init_random_(model, gen(SEED + 21))
    blocks = [m for m in model.modules() if isinstance(m, (ResBlock, SpatialTransformer))]
    n_attn = sum(isinstance(m, CrossAttention) for m in model.modules())
    n_gn = sum(isinstance(m, GroupNorm32) for m in model.modules())
    gn_in_blocks = sum(isinstance(m, GroupNorm32) for b in blocks for m in b.modules())
    g = gen(SEED + 22)
    x0 = torch.randn(REMAT_B, 4, 64, 64, generator=g, device=dev)
    eps = torch.randn(REMAT_B, 4, 64, 64, generator=g, device=dev)
    ctx = torch.randn(REMAT_B, 77, 768, generator=g, device=dev)
    t = torch.randint(0, 1000, (REMAT_B,), generator=g, device=dev)
    diffuser = DDPM(total_steps=1000)

    def step():
        model.zero_grad(set_to_none=True)
        loss = diffuser.loss_func(model, x0, t, eps=eps, model_kwargs={"context": ctx})
        loss.backward()
        return loss

    def with_policy(policy):
        model.use_checkpoint, model.remat_policy = normalize_use_checkpoint(policy)

    with_policy(False)
    step()  # cuBLAS / cuDNN set-up
    # the gradients' run-to-run noise: K2's dQ sums and cuDNN's weight
    # gradients add in an order that varies between runs
    first = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    step()
    floor = rel_l2({n: p.grad for n, p in model.named_parameters()}, first)
    grad_tol = 2 * floor + REMAT_GRAD_TOL
    del first
    log(f"remat: two runs without remat differ by {floor:.3e} rel L2; bound {grad_tol:.3e}")
    rows, grads0 = {}, None
    for policy in REMAT_POLICIES:
        with_policy(policy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        loss = step()
        torch.cuda.synchronize()
        got = counts()
        peak = torch.cuda.max_memory_allocated() - base
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        if grads0 is None:
            grads0 = grads
        recomputes = model.use_checkpoint and str(policy) != "everything"
        want = {"K1": n_attn * (1 + (recomputes and policy != "attn")), "K2": n_attn,
                "K3": n_gn + (gn_in_blocks if recomputes else 0)}
        err = rel_l2(grads, grads0)
        rows[str(policy)] = {"peak_bytes": peak, "launches": got, "grad_rel_l2": err,
                             "loss": loss.item()}
        launches[f"remat_{policy}_b{REMAT_B}"] = got
        log(f"remat use_checkpoint={policy!r} b{REMAT_B}: peak {peak / 2**30:.3f} GiB above the "
            f"weights, launches {got} (want {want}), grad rel L2 vs no remat {err:.3e} ({card})")
        check(got == want, f"remat {policy!r}: launches {got} == {want}")
        check(bool(torch.isfinite(loss)) and err <= grad_tol,
              f"remat {policy!r}: gradient within {grad_tol:.3e} rel L2 of no remat")
        del grads
    # the step's time: the policies in turn, then in the reverse order
    for order in (REMAT_POLICIES, REMAT_POLICIES[::-1]):
        for policy in order:
            with_policy(policy)
            rows[str(policy)].setdefault("ms_runs", []).append(time_ms(step, REMAT_TIMED_STEPS))
    for name, row in rows.items():
        row["ms"] = sum(row["ms_runs"]) / len(row["ms_runs"])
        log(f"remat use_checkpoint={name} b{REMAT_B}: {row['ms']:.3f} ms a forward+backward "
            f"({row['ms_runs']}, {REMAT_TIMED_STEPS} steps a run; {card})")
    metrics["remat_b4"] = {"policies": rows, "grad_noise_rel_l2": floor}
    peaks = {k: r["peak_bytes"] for k, r in rows.items()}
    slack = lambda a: 1.05 * a + 2**28  # noqa: E731  (allocator rounding)
    order = ["nothing", "attn", "dots_no_batch", "dots", "everything"]
    check(all(peaks[a] <= slack(peaks[b]) for a, b in zip(order, order[1:]))
          and peaks["True"] <= slack(peaks["nothing"]) and peaks["nothing"] <= slack(peaks["True"])
          and peaks["everything"] <= slack(peaks["False"]) and peaks["True"] < peaks["False"],
          f"remat peaks ordered as the policies keep: {peaks}")
    check(rows["attn"]["launches"]["K1"] == n_attn and rows["True"]["launches"]["K1"] == 2 * n_attn,
          f"attn launches {n_attn} K1 a step where full remat launches {2 * n_attn}")
    del grads0, x0, eps, ctx
    # the step's time and peak at the SD1.5 configs' own batch and at twice it
    timed = {}
    for b in REMAT_TIMED_BATCHES:
        g = gen(SEED + 28)
        xb, eb = (torch.randn(b, 4, 64, 64, generator=g, device=dev) for _ in range(2))
        cb = torch.randn(b, 77, 768, generator=g, device=dev)
        tb = torch.randint(0, 1000, (b,), generator=g, device=dev)

        def step_b():
            model.zero_grad(set_to_none=True)
            loss = diffuser.loss_func(model, xb, tb, eps=eb, model_kwargs={"context": cb})
            loss.backward()
            return loss

        rows_b: dict = {}
        for order in (REMAT_TIMED_POLICIES, REMAT_TIMED_POLICIES[::-1]):
            for policy in order:
                with_policy(policy)
                model.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ms = time_ms(step_b, REMAT_TIMED_STEPS)
                row = rows_b.setdefault(str(policy), {"ms_runs": [], "peak_bytes": 0})
                row["ms_runs"].append(ms)
                row["peak_bytes"] = max(row["peak_bytes"],
                                        torch.cuda.max_memory_allocated() - base)
                row["loss"] = step_b().item()
        for name, row in rows_b.items():
            row["ms"] = sum(row["ms_runs"]) / len(row["ms_runs"])
            log(f"remat use_checkpoint={name} b{b}: {row['ms']:.3f} ms a forward+backward "
                f"({row['ms_runs']}, {REMAT_TIMED_STEPS} steps a run), peak "
                f"{row['peak_bytes'] / 2**30:.3f} GiB above the weights ({card})")
        check(all(math.isfinite(row["loss"]) for row in rows_b.values()),
              f"remat at b{b}: finite losses under every timed policy")
        timed[f"b{b}"] = rows_b
        del xb, eb, cb, tb
    metrics["remat_timed"] = timed
    model.zero_grad(set_to_none=True)
    del model
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_remat_parallel_")
    try:
        # (b) LoRA under remat: the adapters' gradients, then the CLI
        images, tokenizer = write_finetune_inputs(root, REMAT_LORA_BATCH, FT_SIZE)
        conf = merge_dotlist(load_config(os.path.join(here, LORA_CONFIG)),
                             [f"tokenizer={tokenizer}"])
        real_init = StableDiffusion.init_params
        StableDiffusion.init_params = lambda self, generator=None, img_size=64: (
            init_random_(self, generator), self)[1]
        try:
            sd = train_sd.build_model(conf, dev, get_quiet_logger())
        finally:
            StableDiffusion.init_params = real_init
        sd.vae.requires_grad_(False).eval()
        sd.text_encoder.requires_grad_(False).eval()
        sd.unet.requires_grad_(False).train()
        rank = int(conf.train.lora.rank)
        scale = lora_scale(rank, conf.train.lora.get("alpha"))
        lora = init_lora(sd.unet, gen(SEED + 23), rank=rank)
        with torch.no_grad():  # b is zero at init: a gets no gradient then
            for name, p in lora.named_parameters():
                if name.endswith(".b"):
                    p.normal_(0.0, 0.02, generator=gen(SEED + 24))
        adapters = dict(lora.named_parameters())
        unet_fn = train_sd.lora_unet(sd, adapters, scale)
        g = gen(SEED + 25)
        batch = {"image": torch.rand(REMAT_LORA_BATCH, 3, FT_SIZE, FT_SIZE, generator=g,
                                     device=dev) * 2 - 1,
                 "input_ids": torch.randint(2, 40, (REMAT_LORA_BATCH, sd.text_encoder.max_length),
                                            generator=g, device=dev)}
        lora_grads = {}
        for remat in (False, True):
            sd.unet.use_checkpoint, sd.unet.remat_policy = normalize_use_checkpoint(remat)
            loss_fn = train_sd.make_sd_loss_fn(sd, DDPM(total_steps=1000), batch["input_ids"][:1],
                                               0.0, 1000, unet_fn)
            for p in adapters.values():
                p.grad = None
            zero_counts()
            loss_fn(batch, gen(SEED + 26)).backward()
            torch.cuda.synchronize()
            lora_grads[remat] = ({n: p.grad.clone() for n, p in adapters.items()}, counts())
        err = rel_l2(lora_grads[True][0], lora_grads[False][0])
        # with the base frozen, nothing upstream of the first adapter needs a
        # gradient: the ResBlocks ahead of the first SpatialTransformer are
        # not recomputed, and their GroupNorms not launched again
        ahead = []
        for m in sd.unet.modules():
            if isinstance(m, SpatialTransformer):
                break
            ahead.append(m)
        not_recomputed = sum(isinstance(m, GroupNorm32) for r in ahead if isinstance(r, ResBlock)
                             for m in r.modules())
        per_step = {"K1": 2 * n_attn, "K2": n_attn,
                    "K3": n_gn + gn_in_blocks - not_recomputed + GN_PER_ENCODE}
        log(f"LoRA under remat b{REMAT_LORA_BATCH} {FT_SIZE}x{FT_SIZE}: adapter grad rel L2 vs "
            f"no remat {err:.3e}; launches remat {lora_grads[True][1]}, none "
            f"{lora_grads[False][1]}")
        check(err <= grad_tol and all(float(v.abs().max()) > 0
                                      for v in lora_grads[True][0].values()),
              f"LoRA under remat: the adapters' gradients within {grad_tol:.3e} of no remat")
        check(lora_grads[True][1] == per_step,
              f"LoRA under remat: launches {lora_grads[True][1]} == {per_step}")
        metrics["lora_remat"] = {"grad_rel_l2": err, "launches": lora_grads[True][1]}
        del sd, lora, adapters, unet_fn, lora_grads, batch
        torch.cuda.empty_cache()
        zero_counts()
        result = train_sd.main(["-c", os.path.join(here, LORA_CONFIG), "-e",
                                os.path.join(root, "lora"), "-ni", "--device", "cuda",
                                f"data.params.root={images}", f"tokenizer={tokenizer}",
                                f"train.batch_size={REMAT_LORA_BATCH}",
                                "dataloader.num_workers=2", f"seed={SEED}",
                                f"train.n_steps={REMAT_LORA_STEPS}", "train.sample_freq=0",
                                f"train.save_freq={REMAT_LORA_STEPS}",
                                "model.params.unet_config.params.use_checkpoint=true"])
        torch.cuda.synchronize()
        got = counts()
        want = {k: REMAT_LORA_STEPS * v for k, v in per_step.items()}
        launches["train_sd_lora_remat"] = got
        log(f"train_sd LoRA with use_checkpoint, {REMAT_LORA_STEPS} steps b{REMAT_LORA_BATCH}: "
            f"losses {result['losses']}, launches {got}")
        check(all(map(math.isfinite, result["losses"])) and got == want,
              f"train_sd LoRA with use_checkpoint: finite losses, launches {got} == {want}")
        metrics["lora_remat"]["cli_losses"] = result["losses"]
        torch.cuda.empty_cache()

        # (c) a schedule, and (d) the same run through the data-parallel path
        schedule = {"target": "optax.warmup_cosine_decay_schedule",
                    "params": {"init_value": 0.0, "peak_value": 2e-4, "warmup_steps": 1,
                               "decay_steps": SCHEDULE_STEPS, "end_value": 1e-5}}
        lr = yaml.safe_dump(schedule, default_flow_style=True).strip()  # YAML floats

        def pixel_run(name):
            exp = os.path.join(root, name)
            zero_counts()
            out = train_ddpm.main(["-c", CIFAR_CONFIG, "-e", exp, "-ni", "--device", "cuda",
                                   *PIXEL_OVERRIDES,
                                   *SYNTHETIC_DATA, f"train.n_steps={SCHEDULE_STEPS}",
                                   "train.sample_freq=0", f"train.save_freq={SCHEDULE_STEPS}",
                                   f"train.optim.params.lr={lr}"])
            torch.cuda.synchronize()
            text = "".join(open(os.path.join(exp, f)).read() for f in os.listdir(exp)
                           if f.startswith("output-"))
            logged = [float(line.split("lr: ")[1].split(",")[0]) for line in text.splitlines()
                      if "[Train]" in line]
            ckpt = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt",
                                                              sorted(os.listdir(
                                                                  os.path.join(exp, "ckpt")))[-1]))
            return out, logged, ckpt, counts()

        plain_run, logged, ckpt_plain, plain_launches = pixel_run("schedule")
        want_lr = [build_schedule(schedule)(k) for k in range(SCHEDULE_STEPS)]
        log(f"train_ddpm with {schedule['target']}: logged lr {logged}, the schedule's "
            f"{want_lr}; losses {plain_run['losses']}; launches {plain_launches}")
        check(len(logged) == SCHEDULE_STEPS and all(abs(a - b) <= 5e-7 for a, b in
                                                    zip(logged, want_lr)),
              "train_ddpm: the logged lr is the schedule's value at each update")
        check(all(g.get("lr_updates") == SCHEDULE_STEPS
                  for g in ckpt_plain["optimizer"]["param_groups"]),
              "train_ddpm: the checkpoint's optimizer counts the scheduled updates")
        metrics["schedule"] = {"logged_lr": logged, "want_lr": want_lr,
                               "losses": plain_run["losses"]}
        launches["train_ddpm_schedule"] = plain_launches
        # (d) world size 1: a NCCL group of one rank, as torchrun starts it
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port)}
        weights = os.path.join(root, "cifar.pt")
        torch.save({k: v for k, v in ckpt_plain["model"].items()}, weights)
        sample_args = ["-c", CIFAR_CONFIG, "--weights", weights, "--device", "cuda",
                       "--sampler", "ddpm", "--n_samples", str(DP_SAMPLES), "--batch_size",
                       str(DP_SAMPLES), "--respace_steps", "5", *PIXEL_OVERRIDES]
        sample_uncond.main([*sample_args, "--save_dir", os.path.join(root, "samples_plain")])
        os.environ.update(env)
        try:
            dp_run, dp_logged, ckpt_dp, dp_launches = pixel_run("schedule_dp")
            world = dist.get_world_size() if dist.is_initialized() else 0
            zero_counts()
            sample_uncond.main([*sample_args, "--save_dir", os.path.join(root, "samples_dp")])
            torch.cuda.synchronize()
            sample_launches = counts()
        finally:
            for key in env:
                os.environ.pop(key, None)
            if dist.is_initialized():
                dist.destroy_process_group()
        first_loss_same = dp_run["losses"][0] == plain_run["losses"][0]
        err = rel_l2({k: v for k, v in ckpt_dp["model"].items() if v.is_floating_point()},
                     {k: v for k, v in ckpt_plain["model"].items() if v.is_floating_point()})
        pngs = {name: [np.asarray(__import__("PIL.Image").Image.open(
            os.path.join(root, name, f))).astype(np.int16)
            for f in sorted(os.listdir(os.path.join(root, name)))]
            for name in ("samples_plain", "samples_dp")}
        png_diff = max(int(np.abs(a - b).max()) for a, b in zip(*pngs.values()))
        log(f"data-parallel path at world size {world} (NCCL): losses {dp_run['losses']} vs "
            f"{plain_run['losses']}, parameters rel L2 {err:.3e} after {SCHEDULE_STEPS} steps, "
            f"lr {dp_logged}; sample_uncond through DataParallelSampler: "
            f"{len(pngs['samples_dp'])} images, max diff {png_diff} levels, launches "
            f"{sample_launches}")
        check(world == 1 and first_loss_same and dp_logged == logged and err <= DP_PARAM_TOL
              and dp_launches == plain_launches,
              f"train_ddpm through the data-parallel path (world size 1) equals the run without "
              f"a group (first loss exact, parameters within {DP_PARAM_TOL}, same launches)")
        check(len(pngs["samples_dp"]) == DP_SAMPLES and png_diff <= 1,
              "sample_uncond through DataParallelSampler equals the run without a group")
        metrics["data_parallel_world1"] = {"losses": dp_run["losses"], "param_rel_l2": err,
                                           "png_max_diff": png_diff}
        launches["train_ddpm_dp_world1"] = dp_launches
        launches["sample_uncond_dp_world1"] = sample_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) the ring fold: n chunks of K/V on one card against the whole sequence
    ring = {}
    for label, (b, s, h, d) in RING_SHAPES.items():
        g = gen(SEED + 27)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
                       for _ in range(4))
        zero_counts()
        for fn in (flash_attention_fwd, flash_attention_bwd):
            fn.launches_by_kernel.update(mma=0, wgmma=0)
        o, lse = fold_attention(q, k, v, RING_CHUNKS)
        dq, dk, dv = fold_attention_backward(q, k, v, o, lse, do, RING_CHUNKS)
        torch.cuda.synchronize()
        fold_launches = counts()
        fold_by_kernel = {"K1": dict(flash_attention_fwd.launches_by_kernel),
                          "K2": dict(flash_attention_bwd.launches_by_kernel)}
        o_w, lse_w = flash_attention_fwd(q, k, v)
        dq_w, dk_w, dv_w = flash_attention_bwd(q, k, v, o_w, lse_w, do)
        # the plain f32 version on the first sample: f32 autograd through mha
        leaves = [x[:1].float().requires_grad_() for x in (q, k, v)]
        o_f = mha(*leaves)
        o_f.backward(do[:1].float())
        err_w = {name: (a.float() - w.float()).abs().max().item()
                 for name, a, w in (("o", o, o_w), ("dq", dq, dq_w), ("dk", dk, dk_w),
                                    ("dv", dv, dv_w))}
        err_lse = (lse - lse_w).abs().max().item()
        rel_f = {name: ((a[:1].float() - w).norm() / w.norm()).item()
                 for name, a, w in (("o", o, o_f.detach()), ("dq", dq, leaves[0].grad),
                                    ("dk", dk, leaves[1].grad), ("dv", dv, leaves[2].grad))}
        rel_w = {name: ((a[:1].float() - w).norm() / w.norm()).item()
                 for name, a, w in (("o", o_w, o_f.detach()), ("dq", dq_w, leaves[0].grad),
                                    ("dk", dk_w, leaves[1].grad), ("dv", dv_w, leaves[2].grad))}
        fold_fwd_ms = time_ms(lambda: fold_attention(q, k, v, RING_CHUNKS), 10)
        fold_bwd_ms = time_ms(lambda: fold_attention_backward(q, k, v, o, lse, do, RING_CHUNKS),
                              10)
        whole_fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v), 10)
        whole_bwd_ms = time_ms(lambda: flash_attention_bwd(q, k, v, o_w, lse_w, do), 10)
        bound_fwd = roofline.bound_ms(*roofline.attention_fwd_work(b, h, s, s, d))[0]
        row = {"shape": [b, s, h, d], "chunks": RING_CHUNKS, "launches": fold_launches,
               "fold_fwd_ms": fold_fwd_ms, "fold_bwd_ms": fold_bwd_ms,
               "whole_fwd_ms": whole_fwd_ms, "whole_bwd_ms": whole_bwd_ms,
               "whole_fwd_bound_ms": bound_fwd, "max_abs_err_vs_whole": err_w,
               "lse_max_abs_err_vs_whole": err_lse, "rel_l2_vs_f32": rel_f,
               "whole_rel_l2_vs_f32": rel_w}
        ring[label] = row
        launches[f"ring_fold_{label}"] = fold_launches
        log(f"ring fold {label} b{b} S={s} h{h} d={d}, {RING_CHUNKS} chunks: fwd {fold_fwd_ms:.3f} "
            f"ms (whole K1 {whole_fwd_ms:.3f}, bound {bound_fwd:.3f}), bwd {fold_bwd_ms:.3f} ms "
            f"(whole K2 {whole_bwd_ms:.3f}); max |fold - whole| {err_w}, lse {err_lse:.2e}; "
            f"rel L2 vs f32 (first sample) fold {rel_f}, whole {rel_w}; launches "
            f"{fold_launches} ({card})")
        top = {name: max(w.float().abs().max().item(), 1e-6)
               for name, w in (("o", o_w), ("dq", dq_w), ("dk", dk_w), ("dv", dv_w))}
        check(fold_launches == {"K1": RING_CHUNKS ** 2, "K2": RING_CHUNKS ** 2, "K3": 0}
              and fold_by_kernel == {key: {"mma": 0, "wgmma": RING_CHUNKS ** 2}
                                     for key in ("K1", "K2")},
              f"ring fold {label}: {RING_CHUNKS ** 2} K1 and {RING_CHUNKS ** 2} K2 launches "
              f"({RING_CHUNKS} ranks, {RING_CHUNKS} hops), all through wgmma {fold_by_kernel}")
        check(all(err_w[n] <= RING_TOL * top[n] for n in err_w) and err_lse <= 1e-3,
              f"ring fold {label}: O, dQ, dK, dV within {RING_TOL} of the largest entry of "
              "K1 / K2 on the whole sequence, lse within 1e-3")
        check(all(rel_f[n] <= 1.5 * rel_w[n] + 1e-3 for n in rel_f),
              f"ring fold {label}: against the plain f32 version within 1.5x the whole "
              "sequence's error, plus 1e-3")
        del q, k, v, do, o, lse, dq, dk, dv, o_w, lse_w, dq_w, dk_w, dv_w, leaves, o_f
        torch.cuda.empty_cache()
    metrics["ring_fold"] = ring
    return {"metrics": metrics, "launches": launches}


def phase_ui(dev, check, card, sd, ref_model) -> dict:
    """Phase 22 (see the module docstring): the web UI over the CIFAR-10 UNet
    and the AdaGN UNet, served over HTTP, and page 3's logic on phase 8's
    SD1.5 stack ``sd`` (bf16 UNet torso); ``ref_model`` is its f32 UNet with
    the same weights."""
    import base64
    import io
    import re
    import shutil
    import tempfile
    import threading
    import urllib.request
    from http.server import HTTPServer

    import numpy as np
    import torch
    import yaml
    from PIL import Image
    from dmtpu_torch.diffusions import DDIM
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.ui import sd as sd_ui
    from dmtpu_torch.ui import uncond
    from dmtpu_torch.utils.config import instantiate_from_config, load_config, merge_dotlist
    from dmtpu_torch.utils.image import make_grid, to_pil
    from dmtpu_torch.webui import app as webui

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def rel_err(a, ref) -> float:
        a, ref = (torch.as_tensor(np.asarray(x, np.float32)) for x in (a, ref))
        return ((a - ref).norm() / ref.norm()).item()

    def f32_run(fn):
        """``fn()`` through the plain ops with TF32 off (the f32 reference)."""
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with plain_ops():
                return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn

    metrics, launches = {}, {}
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ui_")
    try:
        # (a) the web UI: one server a config, each in a thread on a free port
        for label, path, extra in (("cifar", CIFAR_CONFIG, ""),
                                   ("adagn", CIFAR_CFG_CONFIG,
                                    f"&y={UI_CFG_CLASS}&gs={UI_CFG_SCALE}")):
            conf = merge_dotlist(load_config(path), PIXEL_OVERRIDES)
            model = instantiate_from_config(conf["model"], device=dev)
            init_random_(model, torch.Generator(device=dev).manual_seed(SEED + 22))
            weights = os.path.join(tmp, f"{label}.pt")
            torch.save(model.state_dict(), weights)
            del model
            paths = {}
            for dtype in ("bfloat16", None):
                d = conf.to_dict()
                d["model"]["params"]["dtype"] = dtype
                paths[dtype] = os.path.join(tmp, f"{label}_{dtype or 'float32'}.yaml")
                with open(paths[dtype], "w") as f:
                    yaml.safe_dump(d, f)
            mark(f"{label}_weights")
            t0 = time.perf_counter()
            app = webui.App(paths["bfloat16"], weights, device=dev)
            load_s = time.perf_counter() - t0
            server = HTTPServer(("127.0.0.1", 0), webui.make_handler(app))
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            port = server.server_address[1]

            def get(route):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                            timeout=300) as r:
                    return r.status, r.read().decode()

            try:
                status, body = get("/health")
                health = json.loads(body)
                log(f"ui {label}: /health {health}")
                check(status == 200 and health["ok"] and health["device"] == str(dev)
                      and health["device_name"] == torch.cuda.get_device_name(0),
                      f"ui {label}: /health names the card")
                route = f"/sample?{UI_QUERY}{extra}"
                y, gs = (UI_CFG_CLASS, UI_CFG_SCALE) if extra else (-1, 3.0)
                request = ("ddim", UI_STEPS, "fixed_small", UI_N, 0, y, gs)
                # the card's busy share of a shorter request (after a warm-up one)
                short = route.replace(f"steps={UI_STEPS}", f"steps={UI_IDLE_STEPS}")
                profile = profile_by_class(lambda: get(short), 1, host_ops=False)
                idle = max(0.0, 1.0 - profile["classes"]["total"] / profile["wall_ms"])
                mark(f"{label}_profile")
                zero_counts()
                t0 = time.perf_counter()
                status, body = get(route)
                http_s = time.perf_counter() - t0
                got = counts()
                steps = len(DDIM(**uncond.sampler_params(
                    app.conf, "ddim", UI_STEPS, "fixed_small", "uniform")).respaced_seq)
                want = {"K1": steps * UI_CALL[label]["K1"], "K2": 0,
                        "K3": steps * UI_CALL[label]["K3"]}
                launches[f"ui_webui_{label}_ddim{UI_STEPS}_b{UI_N}"] = got
                check(got == want, f"ui {label} /sample launches {got} == {want}")
                found = re.search(r"data:image/png;base64,([A-Za-z0-9+/=]+)", body)
                grid = (np.asarray(Image.open(io.BytesIO(base64.b64decode(found.group(1)))))
                        if found else None)
                # 16 samples of 32x32: 4x4 with 2-pixel padding
                cols = int(math.ceil(math.sqrt(UI_N)))
                side = 2 + cols * (app.shape[1] + 2)
                check(status == 200 and grid is not None and grid.shape == (side, side, 3),
                      f"ui {label} /sample: a PNG grid of {side}x{side}x3")
                # the same sampling called directly, and the PNG encoding alone
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                images = app.sample(*request)
                direct_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                webui.png_grid(images)
                png_s = time.perf_counter() - t0
                same = np.asarray(to_pil(make_grid(images, nrow=cols)))
                check(grid is not None and np.abs(grid.astype(int) - same.astype(int)).max() <= 1,
                      f"ui {label}: the PNG is the direct call's grid (to one level)")
                mark(f"{label}_timed")
                # the request's images through the kernels and the plain ops
                # against the f32 model's (TF32 off)
                with plain_ops():
                    plain = app.sample(*request)
                mark(f"{label}_plain")
                ref_app = webui.App(paths[None], weights, device=dev)
                want_images = f32_run(lambda: ref_app.sample(*request))
                del ref_app
                mark(f"{label}_f32")
                err_k, err_p = rel_err(images, want_images), rel_err(plain, want_images)
                metrics[f"webui_{label}"] = {
                    "http_s": http_s, "direct_s": direct_s, "png_s": png_s,
                    "png_share": png_s / http_s, "idle_share": idle, "idle_steps": UI_IDLE_STEPS,
                    "load_s": load_s,
                    "profile_device_ms": profile["classes"], "profile_wall_ms": profile["wall_ms"],
                    "err_vs_f32": {"kernels": err_k, "plain_bf16": err_p}, "launches": got,
                    "steps": steps, "batch": UI_N}
                log(f"ui {label} /sample?{UI_QUERY}{extra}: {http_s:.4f} s over HTTP, "
                    f"{direct_s:.4f} s for App.sample called directly, PNG grid {png_s:.4f} s "
                    f"({png_s / http_s:.4f} of the request); card idle {idle:.4f} of a "
                    f"{UI_IDLE_STEPS}-step request under the profiler ({profile['wall_ms']:.3f} "
                    f"ms); images vs "
                    f"the f32 model: rel L2 kernels {err_k:.3e}, plain bf16 {err_p:.3e}; "
                    f"launches {got} ({card})")
                check(bool(np.isfinite(images).all()) and images.std() > 0.05
                      and err_k <= 1.5 * err_p + 1e-3,
                      f"ui {label}: images vary, err(kernels) <= 1.5 err(plain) + 1e-3")
                check(profile["classes"]["total"] > 0,
                      f"ui {label}: the profiled request ran on the card")
            finally:
                server.shutdown()
                server.server_close()
                thread.join()
            del app
            torch.cuda.empty_cache()

        # (b) page 3's logic on phase 8's SD1.5 stack
        sd.to(dev)
        ref_model.to(dev)
        mark("sd_to_card")
        kw = dict(UI_SD, seed=SEED, device=dev)

        def page3():
            out = sd_ui.generate_sd(SD15_CONF, sd, UI_SD_PROMPT, UI_SD_NEGATIVE, **kw)
            torch.cuda.synchronize()
            return out

        page3()  # warm-up
        short = dict(kw, steps=UI_SD_IDLE_STEPS)
        profile = profile_by_class(
            lambda: sd_ui.generate_sd(SD15_CONF, sd, UI_SD_PROMPT, UI_SD_NEGATIVE, **short), 1,
            host_ops=False)
        idle = max(0.0, 1.0 - profile["classes"]["total"] / profile["wall_ms"])
        mark("sd_profile")
        zero_counts()
        t0 = time.perf_counter()
        images = page3()
        sd_s = time.perf_counter() - t0
        mark("sd_timed")
        got = counts()
        dp = dict(SD15_CONF["diffusion"]["params"], respace_type="uniform-linspace",
                  respace_steps=UI_SD["steps"])
        steps = len(DDIM(**dp).respaced_seq)
        want = {"K1": steps * ATTN_PER_FORWARD, "K2": 0,
                "K3": steps * GN_PER_FORWARD + GN_PER_DECODE}
        launches[f"ui_page3_sd15_ddim{UI_SD['steps']}_b1"] = got
        check(got == want, f"ui page 3 launches {got} == {want}")
        with plain_ops():
            plain = page3()
        mark("sd_plain")
        bf16_unet = sd.unet
        sd.unet = ref_model
        try:
            want_images = f32_run(page3)
        finally:
            sd.unet = bf16_unet
        mark("sd_f32")
        err_k, err_p = rel_err(images.cpu(), want_images.cpu()), rel_err(plain.cpu(),
                                                                         want_images.cpu())
        metrics["page3_sd15"] = {"seconds": sd_s, "idle_share": idle,
                                 "idle_steps": UI_SD_IDLE_STEPS, "steps": steps,
                                 "profile_device_ms": profile["classes"],
                                 "err_vs_f32": {"kernels": err_k, "plain_bf16": err_p},
                                 "launches": got, **{k: v for k, v in UI_SD.items()}}
        log(f"ui page 3 (SD1.5, b{UI_SD['batch_size']} {UI_SD['height']}x{UI_SD['width']} "
            f"DDIM-{UI_SD['steps']}, ToMe {UI_SD['tome_ratio']}, FreeU sd15, offset noise "
            f"{UI_SD['offset_noise']}): {sd_s:.4f} s; card idle {idle:.4f} of a "
            f"{UI_SD_IDLE_STEPS}-step request under the profiler "
            f"({profile['wall_ms']:.3f} ms); images vs the f32 UNet's: rel L2 kernels "
            f"{err_k:.3e}, plain bf16 {err_p:.3e}; launches {got} ({card})")
        size = (UI_SD["batch_size"], 3, UI_SD["height"], UI_SD["width"])
        check(tuple(images.shape) == size and bool(torch.isfinite(images).all())
              and images.std().item() > 0.05 and err_k <= 1.5 * err_p + 1e-3,
              f"ui page 3: {list(size)}, images vary, err(kernels) <= 1.5 err(plain) + 1e-3")
        check(profile["classes"]["total"] > 0, "ui page 3: the profiled request ran on the card")
        check(sd.unet.freeu is None and sd.unet.tome_ratio == 0.0,
              "ui page 3: the model's ToMe and FreeU settings are back")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics["part_seconds"] = {name: t - before
                               for (_, before), (name, t) in zip(marks, marks[1:])}
    log("ui: seconds by part " + json.dumps(metrics["part_seconds"]))
    return {"launches": launches, "metrics": metrics}


def get_quiet_logger():
    """A logger for the builders that take one, writing nothing."""
    import logging

    logger = logging.getLogger("chip_smoke_quiet")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def init_random_(model, generator) -> None:
    """Seeded random weights: N(0, 1/fan_in) for convolutions and dense
    layers, norm scales near 1, small biases.  The layers the model zero-
    initialises (``out_layers.3``, ``proj_out``, ``out.2``) get small
    non-zero weights, or the output would not depend on the blocks they
    close."""
    import torch

    def zero_init(name: str) -> bool:
        return "out_layers.3." in name or "proj_out." in name or name.startswith("out.2.")

    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=generator, device=p.device)
            if name.endswith("bias"):
                p.copy_(0.02 * noise)
            elif p.dim() == 1:  # GroupNorm / LayerNorm scale
                p.copy_(1 + 0.05 * noise)
            else:
                std = p[0].numel() ** -0.5
                if zero_init(name):
                    std *= 0.2
                p.copy_(std * noise)


if __name__ == "__main__":
    sys.exit(main())
