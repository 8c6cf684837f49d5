"""dmtpu_torch.ops.roofline and the kernels' dispatch plans, on the CPU.

The operations, bytes and bounds of every attention and GroupNorm call of one
SD1.5 UNet forward (the shapes ``chip_smoke.py`` checks on the card), counted
here a second way, from the tensors a call reads and writes; and what the
redesigned kernels decide in Python: which attention kernel a shape goes to,
and the launch shape of the channels-last GroupNorm kernel.
"""
import importlib
import importlib.util
import inspect
import math
from pathlib import Path

import collections

import pytest
import torch

from dmtpu_torch.models.adm import GroupNorm32
from dmtpu_torch.ops import groupnorm as gn
from dmtpu_torch.ops import plain_ops, roofline

# the package exports a function of the same name as this module
fa = importlib.import_module("dmtpu_torch.ops.flash_attention")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B, H = chip_smoke.B, 8
ATTN = sorted(chip_smoke.ATTN_CALLS)
GN = sorted(chip_smoke.GN_CALLS)
BIG_SELF_ATTENTION = {(4096, 4096, 40), (1024, 1024, 80)}
VAE_GN = sorted(set(chip_smoke.VAE_DECODE_GN) | set(chip_smoke.VAE_ENCODE_GN))


def test_the_path_has_eight_attention_and_nineteen_groupnorm_shapes():
    assert len(ATTN) == 8 and sum(chip_smoke.ATTN_CALLS.values()) == 32
    assert len(GN) == 19 and sum(chip_smoke.GN_CALLS.values()) == 61


@pytest.mark.parametrize("sq,sk,d", ATTN)
def test_attention_forward_work_and_bound(sq, sk, d):
    ops, nbytes = roofline.attention_fwd_work(B, H, sq, sk, d)
    # two products of S_q x S_k x d multiply-adds each, per batch and head
    assert ops == 2 * (2 * sq * sk * d) * B * H
    q = o = B * sq * H * d
    k = v = B * sk * H * d
    assert nbytes == 2 * (q + k + v + o) + 4 * B * H * sq
    ms, by = roofline.bound_ms(ops, nbytes)
    assert ms == pytest.approx(max(ops / 989e12, nbytes / 3.35e12) * 1e3)
    assert by == ("operations" if (sq, sk, d) in BIG_SELF_ATTENTION else "bytes")


@pytest.mark.parametrize("sq,sk,d", ATTN)
def test_attention_backward_work_and_bound(sq, sk, d):
    ops, nbytes = roofline.attention_bwd_work(B, H, sq, sk, d)
    assert ops == 5 * (2 * sq * sk * d) * B * H  # S, dP, dV, dK, dQ
    rows, keys = B * sq * H * d, B * sk * H * d
    # q, o, dO read and dq written; k, v read and dk, dv written; the f32 lse read
    assert nbytes == 2 * (4 * rows + 4 * keys) + 4 * B * H * sq
    ms, by = roofline.bound_ms(ops, nbytes)
    assert ms == pytest.approx(max(ops / 989e12, nbytes / 3.35e12) * 1e3)
    assert by == ("operations" if (sq, sk, d) in BIG_SELF_ATTENTION else "bytes")
    fwd_ops, _ = roofline.attention_fwd_work(B, H, sq, sk, d)
    assert ops == 2.5 * fwd_ops


@pytest.mark.parametrize("c,hw,dtype,silu,eps", GN)
def test_group_norm_work_and_bound(c, hw, dtype, silu, eps):
    esize = 2 if dtype == "bf16" else 4
    ops, nbytes = roofline.group_norm_work(B, c, hw, esize, silu)
    assert nbytes == 2 * B * c * hw * esize  # x read once, y written once
    assert ops == B * c * hw * (10 if silu else 6)
    ms, by = roofline.bound_ms(ops, nbytes, peak_flops=roofline.PEAK_F32_FLOPS)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_pinned_bounds_of_the_two_largest_calls():
    ops, nbytes = roofline.attention_fwd_work(16, 8, 4096, 4096, 40)
    assert ops == 343_597_383_680
    ms, by = roofline.bound_ms(ops, nbytes)
    assert by == "operations" and ms == pytest.approx(0.3474, abs=1e-4)
    ops, nbytes = roofline.group_norm_work(16, 320, 4096, 2)
    assert nbytes == 83_886_080
    ms, by = roofline.bound_ms(ops, nbytes, peak_flops=roofline.PEAK_F32_FLOPS)
    assert by == "bytes" and ms == pytest.approx(0.02504, abs=1e-5)
    # the padded head dim does not count: d=40 is 40, not 48 or 64
    assert roofline.attention_fwd_work(1, 1, 128, 128, 40)[0] == 4 * 128 * 128 * 40


def test_bound_says_which_side_is_larger():
    assert roofline.bound_ms(989e12, 1) == (pytest.approx(1e3), "operations")
    assert roofline.bound_ms(1, 3.35e12) == (pytest.approx(1e3), "bytes")
    assert roofline.bound_ms(67e12, 1, peak_flops=roofline.PEAK_F32_FLOPS)[0] == \
        pytest.approx(1e3)


@pytest.mark.parametrize("sq,sk,d", ATTN)
def test_attention_dispatch_of_the_path(sq, sk, d):
    """The wgmma kernel takes every shape of the path: the long
    self-attentions, the 77-key cross-attentions (its short-key tile) and
    head dim 160 (its instance of that width), as measured on the card."""
    assert fa.select_kernel(d) == "wgmma"
    assert fa.select_kernel(d, scale=d ** -0.5) == "wgmma"
    assert fa.kernels_for(d) == ["mma", "wgmma"] and fa.wgmma_instance(d) == d
    # a scale that is not positive never reaches the kernel that takes the
    # running max before scaling
    assert fa.select_kernel(d, scale=-1.0) == "mma"
    assert fa.kernels_for(d, scale=0.0) == ["mma"]


@pytest.mark.parametrize("d", [8, 32, 48, 56, 96, 160])
def test_other_head_dims_stay_on_mma(d):
    """A head dim without an instance of its own runs on the wgmma kernel's
    next wider instance, its columns past d zero-filled (as the mma.sync
    kernel pads to 48, 80, 160 and 256); the dispatch sends it there too."""
    assert fa.kernels_for(d) == ["mma", "wgmma"] and fa.select_kernel(d) == "wgmma"
    assert fa.wgmma_instance(d) == {8: 40, 32: 40, 48: 64, 56: 64, 96: 160, 160: 160}[d]


def test_attention_dispatch_threshold_is_one_key_tile():
    """No key threshold any more: one key tile, or none but a short one, goes
    to wgmma too (its 80-key tile at S_k <= 80), so the gate reads the head
    dim and the scale and no length."""
    assert list(inspect.signature(fa.select_kernel).parameters) == ["d", "scale"]
    assert fa.select_kernel(40) == fa.select_kernel(40, 0.5) == "wgmma"
    assert not hasattr(fa, "WGMMA_MIN_KEYS")


@pytest.mark.parametrize("d", [160, 256])
def test_new_wgmma_instances_take_their_head_dims(d):
    """Head dims 160 (SD1.5's 16x16 and 8x8 levels) and 256 (the CIFAR UNets'
    one head) have wgmma instances of their own; only what has no tensor map
    or a non-positive scale stays on mma.sync."""
    assert d in fa.WGMMA_HEAD_DIMS and fa.kernels_for(d) == ["mma", "wgmma"]
    assert fa.wgmma_instance(d) == d and fa.kernels_for(d, scale=-0.5) == ["mma"]
    assert fa.select_kernel(d) == "wgmma" and fa.select_kernel(d, scale=-0.5) == "mma"


@pytest.mark.parametrize("d", range(8, 520, 8))
def test_every_head_dim_maps_to_its_wgmma_instance(d):
    """Up to 512 the narrowest instance at least as wide (264-504 on the d=512
    instance, O's columns split over its two consumer warpgroups)."""
    want = next(w for w in (40, 64, 72, 80, 160, 256, 512) if w >= d)
    assert fa.wgmma_instance(d) == want
    assert fa.kernels_for(d) == ["mma", "wgmma"]
    assert fa.select_kernel(d) == "wgmma"


def test_k1_launch_splits_of_the_paths_follow_the_gate():
    """What phases 5, 15, 16 and 18 count on the card: every K1 call of an
    SD1.5 UNet forward (32), an SDXL call (140), a CIFAR UNet call (6) and a
    CelebA-HQ call (6 at d=512) goes to wgmma."""
    def split(calls):
        plan = {"mma": 0, "wgmma": 0}
        for (sq, sk, d), n in calls:
            plan[fa.select_kernel(d)] += n
        return plan

    assert split(chip_smoke.ATTN_CALLS.items()) == {"mma": 0, "wgmma": 32}
    assert split(((sq, sk, 64), n) for (sq, sk, _), n in chip_smoke.SDXL_ATTN.items()) == \
        {"mma": 0, "wgmma": 140}
    assert split(((s, s, 256), n) for (s, _), n in chip_smoke.CIFAR_TRAIN_ATTN.items()) == \
        {"mma": 0, "wgmma": 6}
    assert split(((sq, sk, d), n) for (_, sq, sk, d), n in chip_smoke.CELEBAHQ_ATTN.items()) == \
        {"mma": 0, "wgmma": 6}


@pytest.mark.parametrize("sq,sk,d", ATTN)
def test_attention_backward_dispatch_of_the_path(sq, sk, d):
    """K2's wgmma kernel takes every shape of the path: head dims 40 and 80 on
    their own instances, 160 on its column-split instance, the
    cross-attention shapes too.  The gate reads the head dim only (K2 reads
    the saved lse: the scale does not matter to it)."""
    assert fa.select_bwd_kernel(d) == "wgmma"
    assert list(inspect.signature(fa.select_bwd_kernel).parameters) == ["d"]
    assert fa.bwd_kernels_for(d) == ["mma", "wgmma"] and fa.wgmma_bwd_instance(d) == d


@pytest.mark.parametrize("d", [8, 32, 48, 56, 96, 160])
def test_other_head_dims_stay_on_mma_in_the_backward(d):
    """Head dims without a wgmma instance (below 40, 48 and 56) stay on
    mma.sync; 96 and 160 run on the column-split instance of 160 (96's
    columns past the head dim zero-filled)."""
    want = {8: None, 32: None, 48: None, 56: None, 96: 160, 160: 160}[d]
    assert fa.wgmma_bwd_instance(d) == want
    assert fa.bwd_kernels_for(d) == (["mma", "wgmma"] if want else ["mma"])
    assert fa.select_bwd_kernel(d) == ("wgmma" if want else "mma")


def test_attention_backward_at_dit_xl2_shape():
    """DiT-XL/2's 28 self-attentions a step (S=256, 16 heads of 72, two key
    tiles) go to K2's wgmma kernel; at b32 the call moves 151.5 MB (q, k, v,
    o, dO read, dq, dk, dv written, the f32 lse read) and is bound by bytes."""
    assert fa.bwd_kernels_for(72) == ["mma", "wgmma"]
    assert fa.select_bwd_kernel(72) == "wgmma" and 256 > fa.WGMMA_BWD_KEY_TILE
    ops, nbytes = roofline.attention_bwd_work(32, 16, 256, 256, 72)
    assert nbytes == 2 * 32 * 16 * 72 * 8 * 256 + 4 * 32 * 16 * 256 == 151_519_232
    assert ops == 10 * 32 * 16 * 256 * 256 * 72
    ms, by = roofline.bound_ms(ops, nbytes)
    assert by == "bytes" and abs(ms - nbytes / 3.35e9) < 1e-12 and 0.045 < ms < 0.046


@pytest.mark.parametrize("sk", [1, 64, 77, 128, 129, 4096])
def test_attention_backward_dispatch_has_no_key_threshold(sk):
    """Unlike K1's once, K2's wgmma kernel is the faster one with a single key
    tile as well (a CTA still walks every Q row), so the gate reads the head
    dim only; the key count decides only whether a CTA holds every key and
    writes dq itself (128 keys up to d=80, 64 on the column-split instances)."""
    assert fa.select_bwd_kernel(40) == fa.select_bwd_kernel(80) == "wgmma"
    assert fa.select_bwd_kernel(160) == fa.select_bwd_kernel(256) == "wgmma"
    assert (sk <= fa.wgmma_bwd_key_tile(80)) == (sk <= 128)
    assert (sk <= fa.wgmma_bwd_key_tile(160)) == (sk <= fa.wgmma_bwd_key_tile(256)) == (sk <= 64)


def test_attention_backward_launch_plan_of_a_train_step():
    """32 K2 launches a step, all through wgmma: the 20 of head dims 40 and 80
    and the 12 of head dim 160 (its column-split instance); the wgmma
    kernel's f32 scratch is padded to whole steps of 128 (d=40) or 64 (every
    other instance) rows."""
    plan = {"mma": 0, "wgmma": 0}
    for (sq, sk, d), calls in chip_smoke.ATTN_CALLS.items():
        plan[fa.select_bwd_kernel(d)] += calls
    assert plan == {"wgmma": 32, "mma": 0}
    assert fa._BWD_ROWS == {40: 128, 64: 64, 72: 64, 80: 64, 160: 64, 256: 64}
    assert set(fa._BWD_ROWS) == set(fa.WGMMA_BWD_HEAD_DIMS)
    # the cross-attention shapes have one key tile: dq written once, in bf16
    assert fa.WGMMA_BWD_KEY_TILE == 128
    assert {sk <= fa.WGMMA_BWD_KEY_TILE for (_, sk, _) in ATTN} == {True, False}
    assert set(fa._BWD_ENTRY_POINTS) == {"mma", "wgmma"}
    assert [fa._round_up(n, 128) for n in (1, 128, 129, 333)] == [128, 128, 256, 384]


@pytest.mark.parametrize("c,hw,dtype,silu,eps", GN)
def test_group_norm_plan_of_the_path(c, hw, dtype, silu, eps):
    esize = 2 if dtype == "bf16" else 4
    assert gn.plan(c, hw, 32, esize, False) == {"kernel": "nchw"}
    how = gn.plan(c, hw, 32, esize, True, B)
    assert how["kernel"] == "rows"
    cpr = c // 8
    # a thread owns 8 channels of a pixel: in at most two groups
    assert c % 8 == 0 and c // 32 >= 8
    assert how["rows"] >= 1 and how["rows"] * cpr <= how["threads"] <= gn.ROWS_THREADS
    assert how["threads"] % 32 == 0 and how["threads"] - how["rows"] * cpr < 32
    assert how["cluster"] in (1, 2, 4, 8) and B * how["cluster"] <= gn.ROWS_TARGET_CTAS
    assert hw // how["cluster"] >= how["rows"]  # every CTA has a full pass of pixels
    assert gn.kernels_for(c, hw, 32, True) == ("groups", "rows")
    assert gn.kernels_for(c, hw, 32, False) == ("nchw",)


@pytest.mark.parametrize("n,want", [(1, 8), (2, 8), (4, 8), (8, 8), (16, 4), (32, 2), (64, 1),
                                    (100, 1)])
def test_group_norm_cluster_follows_the_batch(n, want):
    assert gn.plan(320, 4096, 32, 2, True, n)["cluster"] == want


@pytest.mark.parametrize("c,hw,groups,kernels", [
    (64, 64, 32, ("groups",)),          # 2 channels a group: a chunk would span 4 groups
    (132, 64, 33, ("groups",)),         # C is no multiple of 8
    (66, 64, 33, ("groups",)),
    (72, 16, 8, ("rows",)),             # 9 channels a group: odd, so only whole rows
    (8192, 64, 32, ("groups",)),        # a pixel row wider than the largest CTA
    (96, 25, 8, ("groups", "rows")),
])
def test_group_norm_kernels_for_other_shapes(c, hw, groups, kernels):
    assert gn.kernels_for(c, hw, groups, True) == kernels
    assert gn.plan(c, hw, groups, 4, True)["kernel"] == kernels[-1]


def test_group_norm_small_images_get_small_clusters():
    how = gn.plan(96, 25, 8, 4, True, 1)
    assert how == {"kernel": "rows", "cluster": 1, "rows": 42, "threads": 512}
    assert gn.plan(2560, 64, 32, 2, True, 2)["cluster"] == 8


def test_roofline_peaks_are_the_data_sheet():
    assert (roofline.PEAK_BF16_FLOPS, roofline.PEAK_F32_FLOPS, roofline.PEAK_BYTES_PER_S) == \
        (989e12, 67e12, 3.35e12)
    assert math.isclose(roofline.PEAK_BF16_FLOPS / roofline.PEAK_BYTES_PER_S, 295.2, abs_tol=0.1)


# ---- the VAE's GroupNorms at 512x512 (phase 3's second table, phase 8) ---------

def _group_norm_calls(module, run):
    """(C, H*W, silu) -> calls of ``module``'s GroupNorms in ``run()``, on the
    meta device: shapes only, at the full size, no arithmetic."""
    seen = collections.Counter()

    def note(_, args, kwargs):
        x = args[0]
        seen[(x.shape[1], x.shape[2] * x.shape[3], bool(kwargs.get("silu", False)))] += 1

    hooks = [m.register_forward_pre_hook(note, with_kwargs=True)
             for m in module.modules() if isinstance(m, GroupNorm32)]
    with torch.no_grad(), plain_ops():
        run()
    for h in hooks:
        h.remove()
    return dict(seen)


def test_vae_group_norm_tables_are_the_module_tree_s():
    from dmtpu_torch.utils.config import instantiate_from_config

    conf = chip_smoke.SD15_CONF["model"]["params"]["vae_config"]
    vae = instantiate_from_config(conf, device="meta")
    side = chip_smoke.T2I_SIZE
    z = torch.empty(1, 4, side // 8, side // 8, device="meta")
    x = torch.empty(1, 3, side, side, device="meta")
    assert _group_norm_calls(vae, lambda: vae.decode(z)) == chip_smoke.VAE_DECODE_GN
    assert _group_norm_calls(vae, lambda: vae.encode_moments(x)) == chip_smoke.VAE_ENCODE_GN
    count = lambda root: sum(isinstance(m, GroupNorm32) for m in root.modules())  # noqa: E731
    assert (count(vae.decoder), count(vae.encoder)) == \
        (chip_smoke.GN_PER_DECODE, chip_smoke.GN_PER_ENCODE) == (30, 22)
    with torch.no_grad(), plain_ops():
        assert vae.decode(z).shape == (1, 3, side, side)
        assert vae.encode_moments(x).shape == (1, 8, side // 8, side // 8)
    assert all(m.eps == 1e-6 for m in vae.modules() if isinstance(m, GroupNorm32))


def test_sd15_conf_is_the_full_width_stack():
    """CLIP-L, the SD1.5 VAE and the SD1.5 UNet, by parameter count (meta device)."""
    from dmtpu_torch.utils.config import instantiate_from_config

    sd = instantiate_from_config(chip_smoke.SD15_CONF["model"], device="meta")
    size = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert size(sd.unet) == 859_520_964 and sd.unet.torso_dtype == torch.bfloat16
    assert size(sd.vae) == 83_653_863
    assert size(sd.text_encoder) == 123_060_480
    assert (sd.text_encoder.max_length, sd.text_encoder.model.vocab_size) == (77, 49408)


@pytest.mark.parametrize("c,hw,silu", VAE_GN)
def test_vae_group_norm_work_bound_and_plan(c, hw, silu):
    ops, nbytes = roofline.group_norm_work(B, c, hw, 4, silu)
    assert nbytes == 2 * B * c * hw * 4 and ops == B * c * hw * (10 if silu else 6)
    ms, by = roofline.bound_ms(ops, nbytes, peak_flops=roofline.PEAK_F32_FLOPS)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    # contiguous NCHW, as the f32 VAE gives it: one CTA per (sample, group)
    assert gn.plan(c, hw, 32, 4, False, B) == {"kernel": "nchw"} and hw % 8 == 0
    assert gn.kernels_for(c, hw, 32, False) == ("nchw",)
    # channels-last: 4 channels a group (C = 128) cannot go by whole rows
    how = gn.plan(c, hw, 32, 4, True, B)
    if c == 128:
        assert how == {"kernel": "groups"} and gn.kernels_for(c, hw, 32, True) == ("groups",)
    else:
        assert how["kernel"] == "rows" and gn.kernels_for(c, hw, 32, True) == ("groups", "rows")
        assert how["rows"] * (c // 8) <= how["threads"] <= gn.ROWS_THREADS
        assert B * how["cluster"] <= gn.ROWS_TARGET_CTAS and hw // how["cluster"] >= how["rows"]


def test_the_largest_vae_activation_needs_64_bit_offsets():
    c, hw, _ = max(VAE_GN, key=lambda k: k[0] * k[1])
    assert (c, hw) == (256, 262144) and B * c * hw == 2 ** 30   # elements: fits an int32
    assert B * c * hw * 4 == 2 ** 32                            # bytes: does not
    ops, nbytes = roofline.group_norm_work(B, 128, 262144, 4)
    assert nbytes == 4_294_967_296
    ms, _ = roofline.bound_ms(ops, nbytes, peak_flops=roofline.PEAK_F32_FLOPS)
    assert ms == pytest.approx(1.2821, abs=1e-4)


@pytest.mark.parametrize("c,hw,dtype,silu,eps", GN)
def test_group_norm_plan_at_the_cfg_doubled_batch(c, hw, dtype, silu, eps):
    """A b16 text-to-image request calls the UNet on 32 samples: the rows
    kernel's cluster halves against b16's, its CTA does not change."""
    esize = 2 if dtype == "bf16" else 4
    b16, b32 = gn.plan(c, hw, 32, esize, True, B), gn.plan(c, hw, 32, esize, True, 2 * B)
    assert b32["kernel"] == "rows" and 2 * B * b32["cluster"] <= gn.ROWS_TARGET_CTAS
    assert b32["cluster"] == max(1, b16["cluster"] // 2) == 2
    assert (b32["rows"], b32["threads"]) == (b16["rows"], b16["threads"])


def test_launches_of_one_text_to_image_request():
    """What phase 8 checks on the card, from the tables: 50 guided steps and
    one decode; img2img and inpainting add one encode."""
    steps = chip_smoke.T2I_STEPS
    assert steps * sum(chip_smoke.ATTN_CALLS.values()) == 1600
    assert steps * sum(chip_smoke.GN_CALLS.values()) + chip_smoke.GN_PER_DECODE == 3080
    assert chip_smoke.GN_PER_DECODE + chip_smoke.GN_PER_ENCODE == 52


@pytest.mark.parametrize("config", ["configs/sd15_finetune.yaml", "configs/sd15_lora.yaml"])
def test_finetune_configs_give_the_launches_and_adapters_chip_smoke_expects(config):
    """Phase 9's launches per CLI step (no remat: 32 K1, 32 K2, 61 K3 in the
    UNet and 22 in the VAE encoder) and the rank-16 LoRA's adapters, read off
    the configs' module trees on the meta device."""
    from dmtpu_torch.models.lora import init_lora, lora_param_count
    from dmtpu_torch.utils.config import instantiate_from_config, load_config

    conf = load_config(str(Path(__file__).resolve().parents[1] / config))
    sd = instantiate_from_config(conf.model, device="meta")
    assert not sd.unet.use_checkpoint
    assert chip_smoke.per_step_launches(sd.unet) == {"K1": 32, "K2": 32, "K3": 61}
    assert sum(isinstance(m, GroupNorm32) for m in sd.vae.encoder.modules()) == \
        chip_smoke.GN_PER_ENCODE
    assert sum(isinstance(m, GroupNorm32) for m in sd.vae.decoder.modules()) == \
        chip_smoke.GN_PER_DECODE
    if conf.train.get("lora"):
        lora = init_lora(sd.unet, rank=int(conf.train.lora.rank))
        assert len(lora.paths) == 4 * 32 and lora_param_count(dict(lora.named_parameters())) \
            == 3_188_736


# MMDiT's joint attention at head dim 64 (chip_smoke phase 13): (b, h, S, calls
# a forward)
MMDIT_ATTN = {"sd3_medium_b4": (4, 24, 4250, 24), "mmdit_b2_b64": (64, 12, 333, 12)}


@pytest.mark.parametrize("name", sorted(MMDIT_ATTN))
def test_mmdit_attention_goes_to_wgmma_and_its_bound(name):
    b, h, s, calls = MMDIT_ATTN[name]
    assert fa.kernels_for(64) == ["mma", "wgmma"] and fa.select_kernel(64) == "wgmma"
    assert s % 128 and s > 128  # a masked last key tile, more than one tile
    ops, nbytes = roofline.attention_fwd_work(b, h, s, s, 64)
    assert ops == 4 * b * h * s * s * 64
    assert nbytes == 2 * b * h * 64 * 4 * s + 4 * b * h * s
    # SD3-medium's call is bound by its operations; at S=333 the bytes weigh more
    want_ms, want_by = {"sd3_medium_b4": (0.4488, "operations"),
                        "mmdit_b2_b64": (0.03939, "bytes")}[name]
    assert roofline.bound_ms(ops, nbytes) == (pytest.approx(want_ms, rel=1e-3), want_by)
    assert (chip_smoke.MMDIT_ATTN[name], chip_smoke.MMDIT_ATTN_PER_FORWARD[name]) == \
        ((b, h, s), calls)


def test_mmdit_request_launches():
    """672 K1 a 28-step SD3 request (24 a forward) and 30 K3 a decode; 240 K1
    a 20-step MMDiT-B/2 request; K2 in neither."""
    assert chip_smoke.SD3_STEPS * chip_smoke.MMDIT_ATTN_PER_FORWARD["sd3_medium_b4"] == 672
    assert chip_smoke.MMDIT_B2_STEPS * chip_smoke.MMDIT_ATTN_PER_FORWARD["mmdit_b2_b64"] == 240
    assert chip_smoke.GN_PER_DECODE == 30


@pytest.mark.parametrize("name", sorted(chip_smoke.MMDIT_TRAIN_ATTN))
def test_mmdit_train_attention_backward_goes_to_wgmma_and_its_bound(name):
    """K2 at head dim 64 (chip_smoke phase 14): the dispatch takes wgmma at
    both train steps' joint attention; MMDiT-B/2's b128 call is bound by its
    bytes (8 tensors of 65.5 MB and the lse), SD3-medium's b32 call by its
    8.9e12 operations."""
    b, h, s = chip_smoke.MMDIT_TRAIN_ATTN[name]
    assert fa.bwd_kernels_for(64) == ["mma", "wgmma"] and fa.select_bwd_kernel(64) == "wgmma"
    assert s % 128 and s > fa.WGMMA_BWD_KEY_TILE and fa._BWD_ROWS[64] == 64
    ops, nbytes = roofline.attention_bwd_work(b, h, s, s, 64)
    assert ops == 10 * b * h * s * s * 64
    assert nbytes == 2 * b * h * 64 * 8 * s + 4 * b * h * s
    want_ms, want_by = {"mmdit_train_b128": (0.15696, "bytes"),
                        "sd3_train_b32": (8.9768, "operations")}[name]
    assert roofline.bound_ms(ops, nbytes) == (pytest.approx(want_ms, rel=1e-4), want_by)
    # a step's calls: K1 in the forward (twice under SD3-medium's remat), K2 once
    blocks = {"mmdit_train_b128": 12, "sd3_train_b32": 24}[name]
    remat = 2 if name == "sd3_train_b32" else 1
    assert chip_smoke.MMDIT_TRAIN_CALLS[name] == {"K1": remat * blocks, "K2": blocks, "K3": 0}


def test_forward_flops_counts_every_product_of_an_mmdit_forward():
    """chip_smoke.forward_flops (phase 14's MFU) against the closed form of a
    small MMDiT's forward on one sample: the patch convolution, the
    conditioning MLPs, the context embedder, each block's modulations, q/k/v,
    projections, MLPs and joint attention (the last block's context stream
    makes q, k and v only), and the final layer."""
    import torch

    from dmtpu_torch.models.mmdit import MMDiT

    d, depth, p, c, dc, dp, length = 64, 3, 2, 4, 16, 12, 5
    m = MMDiT(input_size=8, patch_size=p, in_channels=c, hidden_size=d, depth=depth,
              num_heads=2, context_dim=dc, pooled_dim=dp)
    t_img = (8 // p) ** 2
    y = {"context": torch.zeros(1, length, dc), "pooled": torch.zeros(1, dp)}
    got = chip_smoke.forward_flops(m, torch.zeros(1, c, 8, 8), torch.zeros(1), y)
    stream = 2 * d * (3 * d + d + 2 * 4 * d)  # qkv, proj, fc1 and fc2, a token
    want = (2 * t_img * p * p * c * d + 2 * (256 * d + d * d) + 2 * (dp * d + d * d)
            + 2 * length * dc * d
            + (depth - 1) * (2 * 2 * d * 6 * d + (t_img + length) * stream)
            + 2 * d * 6 * d + 2 * d * 2 * d + t_img * stream + length * 2 * d * 3 * d
            + depth * 4 * (t_img + length) ** 2 * d
            + 2 * d * 2 * d + 2 * t_img * d * p * p * c)
    assert got == want


def test_celebahq_train_step_launch_plan_and_k2_bound_at_head_dim_512():
    """``configs/ddpm_celebahq.yaml``'s UNet at full width (113.7M, bf16 torso,
    256x256), its loss and backward traced on the meta device (chip_smoke
    phase 19): the attention's 5 calls at S=256 and 1 at S=64, one head of
    512 each, and 71 GroupNorms give 6 K1 + 6 K2 + 71 K3 a step, K2 on its
    mma.sync instance; at b16 K2's call at S=256 moves 33.6 MB (q, k, v, o,
    dO and the lse read, dq, dk, dv written) for 5.4 GFLOP and is bound by
    its bytes, 0.0100 ms; the one at S=64 by 8.4 MB, 0.0025 ms."""
    from dmtpu_torch.utils.config import instantiate_from_config, load_config, merge_dotlist

    conf = merge_dotlist(load_config(str(Path(__file__).resolve().parents[1]
                                         / chip_smoke.CELEBAHQ_CONFIG)),
                         chip_smoke.PIXEL_OVERRIDES)
    model = instantiate_from_config(conf.model, device="meta")
    assert sum(p.numel() for p in model.parameters()) == chip_smoke.CELEBAHQ_PARAMS
    x = torch.zeros(1, 3, 256, 256, device="meta")
    with chip_smoke.recorded_ops({}) as calls, plain_ops():
        out = model(x, torch.zeros(1, dtype=torch.long, device="meta"), train=True)
        out.float().square().mean().backward()
    assert dict(calls["attention"]) == chip_smoke.CELEBAHQ_ATTN
    plan = {"K1": sum(calls["attention"].values()), "K2": 0,
            "K3": sum(calls["group_norm"].values())}
    for (h, sq, sk, d), n in calls["attention"].items():
        assert fa.bwd_kernels_for(d) == ["mma"] and fa.select_bwd_kernel(d) == "mma"
        assert fa.MMA_NARROW_HEAD_DIM < d <= fa.MAX_HEAD_DIM
        plan["K2"] += n
    assert plan == chip_smoke.CELEBAHQ_TRAIN_STEP == {"K1": 6, "K2": 6, "K3": 71}
    rows = {(b, s, d): n for b, s, d, n in chip_smoke.K2_D512_ROWS}
    assert {(s, d): n for (b, s, d), n in rows.items() if n} == {(256, 512): 5, (64, 512): 1}
    ops, nbytes = roofline.attention_bwd_work(16, 1, 256, 256, 512)
    assert (ops, nbytes) == (5_368_709_120, 33_570_816)
    assert roofline.bound_ms(ops, nbytes) == (pytest.approx(0.0100212, rel=1e-5), "bytes")
    ops, nbytes = roofline.attention_bwd_work(16, 1, 64, 64, 512)
    assert nbytes == 8_392_704 and roofline.bound_ms(ops, nbytes)[1] == "bytes"
    step = sum(n * roofline.bound_ms(*roofline.attention_bwd_work(b, 1, s, s, d))[0]
               for (b, s, d), n in rows.items())
    assert step == pytest.approx(0.052611, rel=1e-4)
