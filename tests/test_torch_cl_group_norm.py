"""K3 over channels-last where the "rows" kernel does not take the call, on the
CPU: the "chunks" kernel's launch plan at every channels-last small-group
shape of the pixel UNets (the CIFAR-10, CelebA-HQ, MNIST and AdaGN UNets,
their tables checked against the module trees), its shared-memory reckoning
and C interface, the odd shapes it takes (C no multiple of 8, 1 to 6
channels a group, more than 4096 channels or 128 groups), and the plain
GroupNorm (what a CPU call runs, whatever kernel it names) on channels-last
tensors against the JAX package's reference in NHWC.  The kernels themselves
run only on the card: the ``gpu`` cases in ``tests/test_torch_kernels.py``.
"""
import collections
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.ops import groupnorm as jgn
from dmtpu_torch.dev import k3_probe
from dmtpu_torch.ops import _build, plain_ops
from dmtpu_torch.ops import groupnorm as gn
from tests._torch_helpers import nhwc, t

SMEM_LIMIT = 232_448  # the dynamic shared memory a block may use on the H100
PIXEL_OVERRIDES = ["model.params.dtype=bfloat16"]  # the pixel paths' bf16 torso

# the AdaGN UNet's small-group GroupNorms of one call, as the probe's tables
ADAGN_SMALL = {(128, 256, "bf16", False): 1, (128, 256, "bf16", True): 1,
               (128, 1024, "bf16", False): 5, (128, 1024, "bf16", True): 3,
               (128, 1024, "f32", True): 1}
# config: (the probe's table of its small-group calls, extra forward arguments)
MODELS = {
    "configs/ddpm_cifar10.yaml": (k3_probe.CIFAR_SMALL, 0),
    "configs/ddpm_celebahq.yaml": (k3_probe.CELEBAHQ_SMALL, 0),
    "configs/ddpm_mnist.yaml": (k3_probe.MNIST_SMALL, 0),
    "configs/ddpm_cfg_cifar10.yaml": (ADAGN_SMALL, 1),
}
# (path, batch, C, H*W, element size): every small-group shape of the paths;
# the AdaGN UNet's on the 20 samples of a CFG batch
SMALL_SHAPES = sorted(
    {(label, n, c, hw, 2 if dname == "bf16" else 4)
     for label, (n, _, table) in k3_probe.CL_PATHS.items() for c, hw, dname, _ in table}
    | {("adagn_b20", 20, c, hw, 2 if dname == "bf16" else 4) for c, hw, dname, _ in ADAGN_SMALL})


def _small_group_calls(path: str, extra: int) -> dict:
    """(C, H*W, dtype, silu) -> calls of the UNet's GroupNorms with fewer than 8
    channels a group or C % 8 != 0 (32 groups, eps 1e-5 each, checked), in a
    b1 forward on the meta device: shapes only, at full width, no arithmetic."""
    from dmtpu_torch.models import adm, modules
    from dmtpu_torch.utils.config import instantiate_from_config, load_config, merge_dotlist

    conf = merge_dotlist(load_config(path), PIXEL_OVERRIDES)
    model = instantiate_from_config(conf.model, device="meta").eval()
    seen = collections.Counter()
    originals = {mod: mod.group_norm for mod in (adm, modules)}

    def recording(fn):
        def group_norm(x, w, b, groups=32, eps=1e-5, silu=False):
            assert groups == 32 and eps == 1e-5
            c = x.shape[1]
            if c % 8 or c // groups < 8:
                seen[(c, x.shape[2] * x.shape[3],
                      "bf16" if x.dtype == torch.bfloat16 else "f32", bool(silu))] += 1
            return fn(x, w, b, groups, eps, silu)
        return group_norm

    img, ch = conf.data.params.img_size, conf.data.get("img_channels", 3)
    args = [torch.empty(1, img, img, ch, device="meta").permute(0, 3, 1, 2)]
    args += [torch.zeros(1, dtype=torch.long, device="meta")] * (1 + extra)
    for mod, fn in originals.items():
        mod.group_norm = recording(fn)
    try:
        with torch.no_grad(), plain_ops():
            model(*args)
    finally:
        for mod, fn in originals.items():
            mod.group_norm = fn
    return dict(seen)


@pytest.mark.parametrize("path", sorted(MODELS))
def test_small_group_tables_are_the_module_trees(path):
    """The probe's tables of the channels-last calls "rows" does not take are
    the UNets' own: 9 of the CIFAR UNet's 51 GroupNorms, 16 of CelebA-HQ's 71,
    43 of the MNIST UNet's 51, 11 of the AdaGN UNet's 68."""
    table, extra = MODELS[path]
    assert _small_group_calls(path, extra) == table
    assert sum(table.values()) == {"configs/ddpm_cifar10.yaml": 9,
                                   "configs/ddpm_celebahq.yaml": 16,
                                   "configs/ddpm_mnist.yaml": 43,
                                   "configs/ddpm_cfg_cifar10.yaml": 11}[path]


@pytest.mark.parametrize("path,n,c,hw,esize", SMALL_SHAPES)
def test_chunks_plan_at_every_small_group_shape_of_the_paths(path, n, c, hw, esize):
    """A channels-last call with 2, 4 or 6 channels a group goes to "chunks"
    ("groups" stays forcible beside it, "rows" does not take it): a cluster of
    at most 8 CTAs a sample, at most 232,448 bytes of shared memory a CTA, a
    CTA of whole warps that covers every chunk of a period; the sample is
    held in the cluster's shared memory where a CTA's share fits, else
    streamed."""
    how = gn.plan(c, hw, 32, esize, True, n)
    assert gn.kernels_for(c, hw, 32, True) == ("groups", "chunks")
    assert how["kernel"] == "chunks"
    assert how["cluster"] in (1, 2, 4, 8) and how["smem"] <= SMEM_LIMIT
    period = c * 8 // np.gcd(c, 8)
    cols = min(period // 8, gn.CHUNKS_COLS)
    assert how["threads"] % 32 == 0 and cols * how["periods"] <= how["threads"] <= 512
    share = -(-(hw * c // period) // how["cluster"]) * period * esize
    assert how["held"] == (-(-(hw * c // period) // 8) * period * esize <= gn.CHUNKS_HOLD_MAX)
    if how["held"]:
        assert share <= gn.CHUNKS_HOLD_MAX and how["smem"] >= share
        assert share <= gn.CHUNKS_HOLD_TARGET or how["cluster"] == 8
        # a smaller cluster only where the batch gives every SM two CTAs
        assert how["cluster"] == 8 or n * how["cluster"] >= 2 * gn.H100_SMS
    else:
        assert n * how["cluster"] <= gn.ROWS_TARGET_CTAS or how["cluster"] == 1
    assert how["smem"] == gn.chunks_smem(c, hw, 32, esize, how["held"], how["cluster"],
                                         how["threads"])


def test_chunks_plan_holds_the_cifar_and_streams_the_celebahq_samples():
    """The CIFAR UNet's 128 x 32 x 32 samples (256 KB in bf16, 512 KB in f32)
    are held in 64 KB shares, x read once, by clusters of 4 and 8 at b500, and
    by clusters of 8 at the reconstruction's 8 images (64 CTAs); CelebA-HQ's
    128 x 256 x 256 (16 MB) are streamed by clusters of 4 at b16, 64 CTAs as
    "rows" has them."""
    assert gn.plan(128, 1024, 32, 2, True, 500) == gn.chunks_plan(128, 1024, 32, 2, 500)
    for esize, cluster in ((2, 4), (4, 8)):
        how = gn.plan(128, 1024, 32, esize, True, 500)
        assert how["held"] and how["cluster"] == cluster and how["threads"] == 128
        assert gn.plan(128, 1024, 32, esize, True, 8)["cluster"] == 8
    how = gn.plan(128, 65536, 32, 2, True, 16)
    assert not how["held"] and how["cluster"] == 4 and how["threads"] == 512
    assert gn.plan(128, 1024, 32, 2, True, 500, 114) == gn.chunks_plan(128, 1024, 32, 2, 500,
                                                                      sms=114)


@pytest.mark.parametrize("c,hw", [(256, 16), (256, 64), (256, 256), (256, 1024), (384, 256),
                                  (384, 1024), (512, 16), (512, 64), (512, 256)])
@pytest.mark.parametrize("n", [16, 32, 500])
def test_rows_shapes_at_large_batches_go_to_chunks_where_a_cluster_holds_the_sample(c, hw, n):
    """The CIFAR UNet's channels-last shapes that "rows" takes: at batches
    above 32 (rows would have one CTA a sample and read it twice) the held
    chunks kernel takes them, since each sample fits a cluster's shared
    memory; at 32 and below rows keeps them."""
    how = gn.plan(c, hw, 32, 2, True, n)
    assert gn.kernels_for(c, hw, 32, True) == ("groups", "chunks", "rows")
    if n > 32:
        assert how == gn.chunks_plan(c, hw, 32, 2, n) and how["held"]
        # forced, rows runs in its own launch shape: one CTA a sample
        assert gn.rows_plan(c, hw, n)["kernel"] == "rows" and gn.rows_plan(c, hw, n)["cluster"] == 1
    else:
        assert how == gn.rows_plan(c, hw, n)
    # a sample too large to hold stays with rows at any batch
    assert gn.plan(320, 4096, 32, 2, True, n)["kernel"] == "rows"


@pytest.mark.parametrize("c,hw,groups", [
    (33, 64, 33), (66, 49, 33), (99, 25, 33), (198, 36, 33), (36, 15, 6), (12, 9, 2),
    (96, 1024, 32),       # 3 channels a group: odd, so "groups" does not take it
    (8192, 64, 32),       # a pixel row wider than "rows"' largest CTA
    (1001, 16, 7),        # 1001 chunks a period: two column blocks
    (512, 64, 256),       # more groups than "rows" takes
    (8192, 16, 8192),     # 8192 groups: their arrays leave no room to hold the sample
])
def test_chunks_takes_the_shapes_the_other_kernels_refuse(c, hw, groups):
    """Odd channel counts a group and C % 8 != 0 are taken, not refused: a
    period of lcm(C, 8) values, H*W*C % 8 != 0 streamed value by value."""
    names = gn.kernels_for(c, hw, groups, True)
    assert "chunks" in names and "rows" not in names
    assert ("groups" in names) == ((c // groups) % 2 == 0)
    how = gn.plan(c, hw, groups, 4, True, 2)
    assert how["kernel"] == "chunks" and how["smem"] <= SMEM_LIMIT
    assert all(gn.plan(c, hw, groups, esize, True, n)["smem"] <= SMEM_LIMIT
               for esize in (2, 4) for n in (1, 16, 500))
    if (hw * c) % 8:
        assert not how["held"]
    period = c * 8 // np.gcd(c, 8)
    assert min(period // 8, gn.CHUNKS_COLS) * how["periods"] <= how["threads"] <= 512


def test_chunks_past_its_groups_falls_back_to_the_per_group_kernel():
    """More than 8192 groups: the per-group kernel where C/groups is even;
    none takes an odd count, and the wrapper refuses such a call."""
    assert gn.kernels_for(16384, 16, 16384, True) == ()
    assert gn.kernels_for(32768, 16, 16384, True) == ("groups",)
    assert gn.plan(32768, 16, 16384, 2, True, 1) == {"kernel": "groups"}


@pytest.mark.parametrize("cpg", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("silu", [True, False])
def test_plain_group_norm_on_channels_last_matches_jax(cpg, dtype, silu):
    """The port's plain GroupNorm on a channels-last tensor (and a CPU call
    that names "chunks", or no kernel: it runs the plain version) against the
    JAX package's reference on the same values in NHWC, with C % 8 != 0 where
    C/groups is odd.  f32: summation order only (2e-5); bf16: both round the
    same f32 result to bf16, one step (2^-8 relative) apart at most."""
    c = {1: 33, 2: 66, 3: 99, 4: 128, 6: 198}[cpg]
    groups = c // cpg
    rs = np.random.RandomState(17 * cpg + silu)
    x = (rs.randn(2, c, 5, 6) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    bias = (0.1 * rs.randn(c)).astype(np.float32)
    if dtype == "bf16":
        xt = t(x).bfloat16().contiguous(memory_format=torch.channels_last)
        xj = jnp.asarray(nhwc(xt.float().numpy())).astype(jnp.bfloat16)
        tol = 2.0 ** -7
    else:
        xt = t(x).contiguous(memory_format=torch.channels_last)
        xj = jnp.asarray(nhwc(x))
        tol = 2e-5
    want = np.asarray(jgn.group_norm_silu_reference(xj, jnp.asarray(scale), jnp.asarray(bias),
                                                    groups, 1e-5, silu)).astype(np.float32)
    plain = gn.group_norm_silu_reference(xt, t(scale), t(bias), groups, 1e-5, silu)
    assert plain.dtype == xt.dtype
    np.testing.assert_allclose(nhwc(plain.float().numpy()), want, rtol=tol, atol=tol)
    for kernel in (None, "chunks"):
        got = gn.group_norm_silu(xt, t(scale), t(bias), groups, 1e-5, silu, kernel=kernel)
        assert torch.equal(got, plain)


def test_chunks_c_interface_and_constants_match_the_source():
    """The kernel's C entry and its shared-memory query, their argument types,
    and the Python plan's constants are the source's."""
    src = (_build.CSRC / "group_norm_silu.cu").read_text()
    consts = {name: int(value) for name, value in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kChunkCols"] == gn.CHUNKS_COLS
    assert consts["kChunkMaxGroups"] == gn.CHUNKS_MAX_GROUPS
    assert consts["kChunkPieces"] == gn.CHUNKS_PIECES
    assert consts["kSmemLimit"] == gn.SMEM_LIMIT == SMEM_LIMIT
    assert re.search(r'extern "C" int dmtpu_group_norm_chunks\(', src)
    assert re.search(r'extern "C" int dmtpu_group_norm_chunks_smem\(', src)
    assert _build._SIGNATURES["dmtpu_group_norm_chunks"] == \
        [_build._P] * 4 + [_build._I] * 4 + [_build._F] + [_build._I] * 6 + [_build._P]
    assert _build._SIGNATURES["dmtpu_group_norm_chunks_smem"] == [_build._I] * 7
    assert gn.group_norm_silu.launches_by_kernel.keys() == \
        {"nchw", "groups", "rows", "team", "chunks"}
