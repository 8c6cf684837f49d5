"""K1's wgmma instance at head dim 512 and K2's column-split instances at 160
and 256, on the CPU: the head dim each call goes to, the launch plans of the
paths that run them (as ``chip_smoke.py`` counts them on the card), the
shared memory each instance asks for, and the C entry points that stand
behind them.  The kernels themselves run only on the card: the ``gpu`` cases
in ``tests/test_torch_kernels.py``.
"""
import importlib
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from dmtpu_torch.ops import _build, attention, plain_ops

# the package exports a function of the same name as this module
fa = importlib.import_module("dmtpu_torch.ops.flash_attention")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMEM_LIMIT = 232_448  # the dynamic shared memory a block may use on the H100


@pytest.mark.parametrize("d", range(8, 520, 8))
def test_every_head_dim_maps_to_its_k2_instance(d):
    """K2: 40, 64, 72 and 80 on their own instances; every multiple of 8 in
    (80, 256] on the narrower of 160 and 256 that is at least as wide; below
    40, 48, 56 and above 256 on mma.sync alone."""
    if d in (40, 64, 72, 80):
        want = d
    elif 80 < d <= 256:
        want = 160 if d <= 160 else 256
    else:
        want = None
    assert fa.wgmma_bwd_instance(d) == want
    assert fa.bwd_kernels_for(d) == (["mma", "wgmma"] if want else ["mma"])
    assert fa.select_bwd_kernel(d) == ("wgmma" if want else "mma")
    # K1: every head dim on the narrowest wgmma instance at least as wide
    assert fa.wgmma_instance(d) == next(w for w in fa.WGMMA_HEAD_DIMS if w >= d)
    assert fa.select_kernel(d) == "wgmma"
    if want:
        assert want in fa._BWD_ROWS and fa.wgmma_bwd_key_tile(d) == (128 if want <= 80 else 64)


def _k2_split(calls):
    plan = {"mma": 0, "wgmma": 0}
    for d, n in calls:
        plan[fa.select_bwd_kernel(d)] += n
    return plan


def test_k2_launch_plan_of_the_sd15_step():
    """32 K2 launches a b16 SD1.5 step, all wgmma (20 at d=40 / 80, 12 at
    d=160 on the column-split instance)."""
    calls = [(d, n) for (_, _, d), n in chip_smoke.ATTN_CALLS.items()]
    assert _k2_split(calls) == {"mma": 0, "wgmma": 32}
    assert sum(n for d, n in calls if d == 160) == 12


def test_k2_launch_plans_of_the_pixel_steps():
    """The CIFAR UNet's b128 step (6 at d=256) and the AdaGN UNet's (10 at
    d=64, 1 at d=256): every K2 launch through wgmma; phase 17's rows at
    d=256 and d=248 are dispatched to the d=256 instance."""
    assert _k2_split((d, n) for (_, d), n in chip_smoke.CIFAR_TRAIN_ATTN.items()) == \
        {"mma": 0, "wgmma": 6}
    assert _k2_split(chip_smoke.ADAGN_ATTN.items()) == {"mma": 0, "wgmma": 11}
    assert {fa.wgmma_bwd_instance(d) for _, _, d in chip_smoke.K2_D256_ROWS} == {256}


def test_celebahq_launch_plans():
    """CelebA-HQ's UNet: 6 K1 a call, all wgmma (300 a b16 DDIM-50
    request); a train step's 6 K1 through wgmma and 6 K2 on mma.sync (its
    d=512 instance, the one K2 kernel not yet redesigned)."""
    calls = [(d, n) for (_, _, _, d), n in chip_smoke.CELEBAHQ_ATTN.items()]
    k1 = {"mma": 0, "wgmma": 0}
    for d, n in calls:
        k1[fa.select_kernel(d)] += n
    assert k1 == {"mma": 0, "wgmma": 6}
    assert chip_smoke.CELEBAHQ_STEPS * k1["wgmma"] == 300
    assert _k2_split(calls) == {"mma": 6, "wgmma": 0}
    assert all(d > fa.MMA_NARROW_HEAD_DIM for d, _ in calls)
    # phase 18's rows: every one through wgmma, b128 among them
    assert {fa.select_kernel(d) for _, _, d, _ in chip_smoke.K1_D512_ROWS} == {"wgmma"}
    assert (128, 256, 512, 0) in chip_smoke.K1_D512_ROWS


def test_the_ring_hops_go_to_wgmma():
    """Phase 21's ring fold: K1 and K2 at every hop through wgmma, the CIFAR
    UNet's d=256 hops too."""
    for _, _, _, d in chip_smoke.RING_SHAPES.values():
        assert fa.select_kernel(d) == fa.select_bwd_kernel(d) == "wgmma"


@pytest.mark.parametrize("d", sorted(chip_smoke.K2_WGMMA_SMEM))
def test_k2_instance_shared_memory_fits_a_block(d):
    """Each K2 wgmma instance's shared memory, as reckoned in chip_smoke
    (which holds the library's answer to it on the card), fits the 232,448
    bytes a block may use; the column-split ones as the source lays them
    out: K and V of 64 keys, two stages of Q and dO (at d=256 66 KiB, the
    padded f32 dQ rows of a step staged over them), two dS^T tiles."""
    smem = chip_smoke.K2_WGMMA_SMEM[d]
    assert 0 < smem <= SMEM_LIMIT
    if d in fa.WGMMA_BWD_SPLIT_HEAD_DIMS:
        tiles = -(-d // 64)
        stage = max(2 * tiles * 64 * 128, 64 * (4 * d + 32))  # Q + dO, or the staged rows
        stage = -(-stage // 1024) * 1024
        assert smem == 1024 + 2 * tiles * 8192 + 2 * stage + 2 * 8192 + 2 * 512 + 8 * 5
    assert {64: 133_160, 72: 202_792, 80: 206_888}.get(d, smem) == smem


def test_k1_d512_shared_memory_fits_a_block():
    """K1's d=512 instance: Q of 64 rows (64 KiB) and two stages of 32-key K
    and V tiles (32 KiB each), its barriers: one CTA per SM."""
    assert chip_smoke.K1_D512_SMEM == 197_696 <= SMEM_LIMIT
    assert (512, 32) in chip_smoke.K1_WGMMA_INSTANCES


def test_the_new_entry_point_has_its_signature():
    """The K2 shared-memory query stands in ``_build._SIGNATURES`` as the C
    source declares it; the K1 one answers for d=512 through its own."""
    assert _build._SIGNATURES["dmtpu_flash_attn_bwd_smem"] == [_build._I]
    assert _build._SIGNATURES["dmtpu_flash_attn_fwd_smem"] == [_build._I, _build._I]
    source = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    assert re.search(r'extern "C" int dmtpu_flash_attn_bwd_smem\(int D\)', source)
    fwd = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    assert "X(512, 32, false)" in fwd and "D > 512" in fwd


@pytest.mark.parametrize("d", [160, 256, 512])
def test_a_cpu_call_at_the_new_head_dims_is_the_plain_version(d):
    """On the CPU the wrappers run their plain versions at these head dims
    too, whatever ``kernel`` says, and the differentiable operator agrees."""
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(1, 9, 1, d, generator=g) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, kernel="wgmma")
    want_o, want_lse = fa.flash_attention_reference(q, k, v)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, kernel="wgmma")
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attention(*leaves).backward(do)
    with plain_ops():
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        attention(*plain).backward(do)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)
