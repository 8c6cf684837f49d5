"""dmtpu_torch.ops.roofline and the kernels' dispatch plans, on the CPU.

The operations, bytes and bounds of every attention and GroupNorm call of one
SD1.5 UNet forward (the shapes ``chip_smoke.py`` checks on the card), counted
here a second way, from the tensors a call reads and writes; and what the
redesigned kernels decide in Python: which attention kernel a shape goes to,
and the launch shape of the channels-last GroupNorm kernel.
"""
import importlib
import importlib.util
import math
from pathlib import Path

import pytest

from dmtpu_torch.ops import groupnorm as gn
from dmtpu_torch.ops import roofline

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
    """The wgmma kernel takes the two long self-attention shapes; everything
    with 77 keys, a short sequence or head dim 160 stays on mma.sync."""
    want = "wgmma" if (sq, sk, d) in BIG_SELF_ATTENTION else "mma"
    assert fa.select_kernel(sq, sk, d) == want
    assert fa.select_kernel(sq, sk, d, scale=d ** -0.5) == want
    assert fa.kernels_for(d) == (["mma", "wgmma"] if d in (40, 80) else ["mma"])
    # a scale that is not positive never reaches the kernel that takes the
    # running max before scaling
    assert fa.select_kernel(sq, sk, d, scale=-1.0) == "mma"
    assert fa.kernels_for(d, scale=0.0) == ["mma"]


@pytest.mark.parametrize("d", [8, 48, 64, 72, 96, 160])
def test_other_head_dims_stay_on_mma(d):
    assert fa.kernels_for(d) == ["mma"] and fa.select_kernel(4096, 4096, d) == "mma"


def test_attention_dispatch_threshold_is_one_key_tile():
    assert fa.select_kernel(4096, 128, 40) == "mma"
    assert fa.select_kernel(64, 129, 40) == "wgmma"


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
