"""K3 over contiguous NCHW on the CPU: the "team" kernel's launch plan at every
NCHW GroupNorm shape of the repository's paths (the VAE decodes, the pixel
UNets), its shared-memory reckoning and C interface, and the plain GroupNorm
(what a CPU call runs, whatever kernel it names) against the JAX package's at
the VAE's channel and group layouts.  The kernels themselves run only on the
card: the ``gpu`` cases in ``tests/test_torch_kernels.py``.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from dmtpu.ops import groupnorm as jgn
from dmtpu_torch.dev import k3_probe
from dmtpu_torch.ops import _build
from dmtpu_torch.ops import groupnorm as gn
from tests._torch_helpers import nhwc, t

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMEM_LIMIT = 232_448  # the dynamic shared memory a block may use on the H100
SMS = 132

# (path, batch, C, H*W, element size): every contiguous NCHW GroupNorm shape of
# the paths, from chip_smoke's decode tables and the probe's pixel-UNet tables
NCHW_SHAPES = sorted(
    {("sd15_decode", chip_smoke.B, c, hw, 4) for c, hw, _ in chip_smoke.VAE_DECODE_GN}
    | {("sd15_encode", chip_smoke.B, c, hw, 4) for c, hw, _ in chip_smoke.VAE_ENCODE_GN}
    | {("dit_decode", chip_smoke.DIT_B, c, hw, 4) for c, hw, _ in chip_smoke.DIT_DECODE_GN}
    | {("sd3_decode", chip_smoke.SD3_B, c, hw, 4) for c, hw, _ in chip_smoke.SD3_DECODE_GN}
    | {("sdxl_decode", chip_smoke.SDXL_B, c, hw, 4) for c, hw, _ in chip_smoke.SDXL_DECODE_GN}
    | {(label, n, c, hw, 2 if dname == "bf16" else 4)
       for label, (n, _, table) in k3_probe.PATHS.items() if label.startswith(("adm", "cel", "cif"))
       for c, hw, dname, _ in table})


@pytest.mark.parametrize("path,n,c,hw,esize", NCHW_SHAPES)
def test_k3_plan_and_kernels_at_every_nchw_shape_of_the_paths(path, n, c, hw, esize):
    """Contiguous NCHW goes to "team" (the old one-CTA-a-slab "nchw" stays
    forcible beside it), in the form the slab's size gives: a warp a slab up
    to 4 KB, a CTA up to 32 KB, else teams of CTAs that divide the card's
    SMs, at most one CTA an SM (they launch cooperatively) and at most the
    4096 CTAs the scratch has room for; the slabs in flight stay within the
    L2 budget wherever a slab fits it."""
    how = gn.plan(c, hw, 32, esize, False, n)
    assert gn.kernels_for(c, hw, 32, False) == ("nchw", "team")
    assert how["kernel"] == "team"
    slab = c // 32 * hw * esize
    if slab <= 4096:
        assert how["form"] == "warp" and how["team"] == 0
        assert how["ctas"] <= SMS * gn.TEAM_HELD_CTAS_PER_SM
    elif slab <= 32768:
        assert how["form"] == "cta" and how["team"] == 1
        assert how["ctas"] == min(n * 32, SMS * gn.TEAM_HELD_CTAS_PER_SM)
    else:
        assert how["form"] == "stream" and SMS % how["team"] == 0
        assert how["ctas"] % how["team"] == 0 and how["ctas"] <= SMS <= gn.TEAM_MAX_CTAS
        assert how["in_flight"] == how["ctas"] // how["team"] * slab
        if slab <= gn.TEAM_REREAD_BUDGET:
            assert how["in_flight"] <= gn.TEAM_REREAD_BUDGET < gn.L2_BYTES
        # a share of one slot is normalised in place, a larger one re-read
        share = -(-slab // how["team"])
        assert bool(how["reread"]) == (share > gn.TEAM_SLOT_BYTES)


@pytest.mark.parametrize("c,hw", sorted({(c, hw) for c, hw, _ in chip_smoke.SDXL_DECODE_GN}))
def test_k3_plan_spreads_a_b1_1024_decode_over_every_sm(c, hw):
    """SDXL's b1 decode at 1024x1024: 32 slabs of 1 to 32 MB, which the old
    kernel gave 32 CTAs; the plan gives every one of the 132 SMs a CTA, the
    teams a divisor of 132 apart."""
    how = gn.plan(c, hw, 32, 4, False, 1)
    assert how["form"] == "stream" and how["ctas"] == SMS
    assert how["ctas"] // how["team"] <= 32 and how["team"] * 32 >= SMS


def test_k3_plan_follows_the_card():
    """The plan takes the card's SM count: on a card of 114 SMs the teams
    divide 114; its held forms hold as many CTAs as 3 an SM."""
    how = gn.plan(128, 262144, 32, 4, False, 16, 114)
    assert 114 % how["team"] == 0 and how["ctas"] <= 114
    assert gn.plan(128, 1024, 32, 2, False, 500, 114)["ctas"] == 3 * 114


def test_k3_team_shared_memory_and_constants_match_the_source():
    """The stream form's three 64 KiB slots and their barriers fit the
    232,448 bytes a block may use (one CTA an SM); the Python plan's
    constants are the source's."""
    src = (_build.CSRC / "group_norm_silu.cu").read_text()
    consts = {name: int(eval(value, {"__builtins__": {}}, {}))
              for name, value in re.findall(r"constexpr int (k\w+) = ([\d *]+);", src)}
    assert consts["kSlots"] * consts["kSlotBytes"] + 2 * consts["kSlots"] * 8 <= SMEM_LIMIT
    assert consts["kSlotBytes"] == gn.TEAM_SLOT_BYTES
    assert consts["kTeamThreads"] == gn.TEAM_THREADS
    assert consts["kRegBlocks"] == gn.TEAM_HELD_CTAS_PER_SM
    assert consts["kMaxTeamCtas"] == gn.TEAM_MAX_CTAS
    assert gn.TEAM_FORMS == {"warp": 0, "cta": 1, "stream": 2}
    assert re.search(r'extern "C" int dmtpu_group_norm_team\(', src)
    assert _build._SIGNATURES["dmtpu_group_norm_team"] == \
        [_build._P] * 4 + [_build._I] * 4 + [_build._F] + [_build._I] * 5 + \
        [_build._P, _build._L, _build._P]


@pytest.mark.parametrize("c", [128, 256, 512])
@pytest.mark.parametrize("side", [4, 8])
@pytest.mark.parametrize("silu", [True, False])
def test_plain_group_norm_at_the_vae_layouts_matches_jax(c, side, silu):
    """NCHW at the VAE's channel and group layouts (C = 128, 256, 512 over 32
    groups; f32, eps 1e-6): the port's plain GroupNorm, and a CPU call that
    names either NCHW kernel (it runs the plain version), against the JAX
    package's reference and its Pallas kernel in interpret mode."""
    rs = np.random.RandomState(c + side)
    x = (rs.randn(2, c, side, side) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    bias = (0.1 * rs.randn(c)).astype(np.float32)
    want = np.asarray(jgn.group_norm_silu_reference(
        jnp.asarray(nhwc(x)), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6, silu))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jgn._pallas_forward(jnp.asarray(nhwc(x)), jnp.asarray(scale),
                                                jnp.asarray(bias), 32, 1e-6, silu))
    np.testing.assert_allclose(pallas, want, rtol=2e-5, atol=2e-5)
    plain = gn.group_norm_silu_reference(t(x), t(scale), t(bias), 32, 1e-6, silu)
    np.testing.assert_allclose(nhwc(plain.numpy()), want, rtol=2e-5, atol=2e-5)
    for kernel in (None, "nchw", "team"):
        got = gn.group_norm_silu(t(x), t(scale), t(bias), 32, 1e-6, silu, kernel=kernel)
        assert np.array_equal(got.numpy(), plain.numpy())
