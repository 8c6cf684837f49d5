"""dmtpu_torch's CUDA kernels against their plain versions, on the card.

Every test is marked ``gpu`` and skips without a CUDA device.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: K1 writes bf16, so its output may differ from its plain version
by one bf16 step (2^-8 relative) of the largest outputs, on top of P rounded
to bf16 in both versions: the bound is 1e-2 of max|o|, which a skipped or
doubled K/V tile (an error of about a tenth of max|o|) does not meet.  Its
f32 logsumexp is compared at 1e-4; K3 at 1e-4 in f32 and 2e-2 in bf16 (one
rounding of the output).  K2's dq, dk and dv are held to 1e-2 of their
largest value and to a relative L2 error of 1e-2: both versions round P and
dS to bf16, but from f32 values that differ in their last bits (exp2 against
exp, other summation orders, and dq's f32 adds, atomics in one kernel and
bulk reduce-adds in the other, whose order changes from run to run), so
single elements may land one bf16 step apart (2^-9 relative
in L2); a skipped or doubled tile of keys or rows moves the L2 error by
1/sqrt(tiles), 25% at 16 tiles.  Against f32 autograd through ``mha`` on
the same bf16 values the bound is 2e-2: the kernel rounds P, dS and its
outputs to bf16, which the f32 path never does.
"""
import pytest
import torch

from dmtpu_torch.ops import (
    attention,
    flash_attention_backward_reference,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_reference,
    group_norm,
    group_norm_silu,
    group_norm_silu_reference,
    mha,
    plain_ops,
)
from dmtpu_torch.ops.flash_attention import bwd_kernels_for as k2_kernels_for
from dmtpu_torch.ops.flash_attention import kernels_for as k1_kernels_for
from dmtpu_torch.ops.flash_attention import select_bwd_kernel, select_kernel
from dmtpu_torch.ops.groupnorm import kernels_for as k3_kernels_for
from dmtpu_torch.ops.groupnorm import plan as k3_plan


@pytest.fixture
def cuda():
    """The CUDA device, or skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_k1_close(o: torch.Tensor, want: torch.Tensor) -> None:
    """max|o - want| <= 1e-2 max|want| (see the module docstring)."""
    err = (o.float() - want.float()).abs().max().item()
    bound = 1e-2 * want.float().abs().max().item()
    assert err <= bound, f"K1 max abs err {err:.3e} > {bound:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 4096, 4096, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 256, 8, 160),
    (2, 100, 77, 3, 64), (1, 64, 64, 8, 160)])
def test_k1_kernel_matches_reference(cuda, b, sq, sk, h, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).bfloat16()
               for s in (sq, sk, sk))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == before + 1
    want_o, want_lse = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert_k1_close(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_k1_kernel_reads_strided_projections(cuda):
    """q/k/v as views of one [B, S, 3*H*D] projection, as strided [B, S, H, D]."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, d = 2, 200, 4, 40
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, s, h, d) for i in range(3))
    o, _ = flash_attention_fwd(q, k, v)
    assert_k1_close(o, flash_attention_reference(q, k, v)[0])


@pytest.mark.gpu
def test_plain_ops_switch_bypasses_the_kernels(cuda):
    """The dispatching ops launch the kernels, and inside plain_ops() they
    do not; the counters move only with a launch."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 64, 2, 40, generator=g, device=cuda).bfloat16()
    x = torch.randn(1, 64, 4, 4, generator=g, device=cuda)
    w = torch.ones(64, device=cuda)

    def counts():
        return flash_attention_fwd.launches, group_norm_silu.launches

    before = counts()
    with plain_ops():
        plain = attention(q, q, q), group_norm(x, w, w, silu=True)
    assert counts() == before
    assert torch.equal(plain[0], mha(q, q, q))
    assert torch.equal(plain[1], group_norm_silu_reference(x, w, w, 32, 1e-5, True))
    attention(q, q, q), group_norm(x, w, w, silu=True)
    assert counts() == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_k1_kernel_rejects_unsupported_inputs(cuda):
    q = torch.zeros(1, 64, 1, 40, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 64, 1, 192, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 160"):
        flash_attention_fwd(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("c,hw", [(320, 4096), (960, 4096), (1280, 64), (2560, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
def test_k3_kernel_matches_reference(cuda, c, hw, dtype, silu, eps, layout):
    g = torch.Generator(device=cuda).manual_seed(2)
    side = int(hw ** 0.5)
    x = (torch.randn(2, c, side, side, generator=g, device=cuda) * 3 + 2).to(
        dtype=dtype, memory_format=layout)
    w = torch.randn(c, generator=g, device=cuda)
    bias = torch.randn(c, generator=g, device=cuda)
    before = group_norm_silu.launches
    got = group_norm_silu(x, w, bias, 32, eps, silu)
    assert group_norm_silu.launches == before + 1
    want = group_norm_silu_reference(x, w, bias, 32, eps, silu)
    assert got.is_contiguous(memory_format=layout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_k3_kernel_rejects_unsupported_layouts(cuda):
    x = torch.zeros(2, 64, 6, 6, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        group_norm_silu(x[:, :, :, :5], w, w)
    with pytest.raises(ValueError, match="on cuda"):
        group_norm_silu(x, w.cpu(), w)


def assert_grads_close(got, want, bound: float) -> None:
    """Each of (dq, dk, dv): max abs error <= bound * max|want| and relative
    L2 error <= bound (see the module docstring)."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        rel = ((a - b).norm() / b.norm()).item()
        top = b.abs().max().item()
        assert err <= bound * top and rel <= bound, \
            f"{name}: max abs err {err:.3e} (max {top:.3e}), rel L2 {rel:.3e}"


def _qkv_do(cuda, seed, b, sq, sk, h, d):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g, device=cuda).bfloat16()
            for s in (sq, sk, sk, sq)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 1024, 1024, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 77, 8, 160), (1, 100, 333, 3, 64)])
def test_k2_kernel_matches_reference_and_mha(cuda, b, sq, sk, h, d):
    q, k, v, do = _qkv_do(cuda, 4, b, sq, sk, h, d)
    o, lse = flash_attention_fwd(q, k, v)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do)
    assert flash_attention_bwd.launches == before + 1
    torch.cuda.synchronize()
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in got)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    mha(*leaves).backward(do.float())
    assert_grads_close(got, [t.grad for t in leaves], 2e-2)


@pytest.mark.gpu
def test_k2_kernel_reads_strided_inputs_and_a_broadcast_gradient(cuda):
    """q/k/v as views of one [B, S, 3*H*D] projection, and the zero-stride
    gradient that autograd hands for a ``sum()``."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, s, h, d = 2, 200, 4, 40
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, s, h, d) for i in range(3))
    o, lse = flash_attention_fwd(q, k, v)
    do = torch.ones((), device=cuda, dtype=torch.bfloat16).expand(b, s, h, d)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)


@pytest.mark.gpu
def test_gradients_flow_through_attention_and_group_norm(cuda):
    """The dispatching ops are differentiable on CUDA: the attention's
    backward is K2 and GroupNorm's goes through its plain version, and both
    agree with plain autograd."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do = _qkv_do(cuda, 7, 2, 256, 77, 4, 40)
    before = flash_attention_fwd.launches, flash_attention_bwd.launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    attention(*leaves).backward(do)
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    with plain_ops():
        attention(*plain).backward(do)
    assert_grads_close([t.grad for t in leaves], [t.grad for t in plain], 3e-2)

    x = (torch.randn(2, 64, 8, 8, generator=g, device=cuda) * 2 + 1).bfloat16()
    w = torch.randn(64, generator=g, device=cuda)
    bias = torch.randn(64, generator=g, device=cuda)
    gy = torch.randn(2, 64, 8, 8, generator=g, device=cuda).bfloat16()
    grads = []
    for kernels in (True, False):
        inputs = [t.clone().requires_grad_() for t in (x, w, bias)]
        before = group_norm_silu.launches
        if kernels:
            group_norm(*inputs, silu=True).backward(gy)
        else:
            with plain_ops():
                group_norm(*inputs, silu=True).backward(gy)
        assert group_norm_silu.launches == before + int(kernels)
        grads.append([t.grad for t in inputs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_k2_kernel_rejects_unsupported_inputs(cuda):
    q = torch.zeros(1, 64, 1, 40, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_bwd(q.float(), q.float(), q.float(), q, lse, q)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, lse[..., :32], q)
    q = torch.zeros(1, 64, 1, 192, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 160"):
        flash_attention_bwd(q, q, q, q, lse, q)


# ---- K1: the wgmma kernel and the dispatch between the two kernels ----------

ATTN_SHAPES = [(4096, 4096, 40), (1024, 1024, 80), (256, 256, 160), (64, 64, 160),
               (4096, 77, 40), (1024, 77, 80), (256, 77, 160), (64, 77, 160)]


def _k1_case(cuda, seed, b, sq, sk, h, d):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g, device=cuda).bfloat16() for s in (sq, sk, sk)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [None, "mma", "wgmma"])
@pytest.mark.parametrize("sq,sk,d", ATTN_SHAPES)
def test_k1_every_shape_of_the_path_through_every_kernel_that_takes_it(cuda, sq, sk, d, kernel):
    """b2 h8 at the eight shapes of the SD1.5 UNet: the dispatch, and each
    kernel forced; a kernel that does not take the head dim raises."""
    q, k, v = _k1_case(cuda, 10, 2, sq, sk, 8, d)
    if kernel is not None and kernel not in k1_kernels_for(d):
        with pytest.raises(ValueError, match="does not take"):
            flash_attention_fwd(q, k, v, kernel=kernel)
        return
    before = dict(flash_attention_fwd.launches_by_kernel)
    o, lse = flash_attention_fwd(q, k, v, kernel=kernel)
    took = kernel or select_kernel(sq, sk, d)
    assert flash_attention_fwd.launches_by_kernel[took] == before[took] + 1
    want_o, want_lse = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert_k1_close(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 64, 72, 80, 160])
@pytest.mark.parametrize("sq,sk", [(333, 77), (77, 333), (200, 333), (129, 129), (1, 130)])
def test_k1_ragged_lengths_at_every_head_dim(cuda, sq, sk, d):
    """Lengths that are no multiple of a tile, through every kernel that takes
    the head dim: keys past S_k are masked, rows past S_q are not written."""
    q, k, v = _k1_case(cuda, 11, 2, sq, sk, 3, d)
    want_o, want_lse = flash_attention_reference(q, k, v)
    for kernel in k1_kernels_for(d):
        o, lse = flash_attention_fwd(q, k, v, kernel=kernel)
        torch.cuda.synchronize()
        assert_k1_close(o, want_o)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["mma", "wgmma"])
def test_k1_each_kernel_reads_strided_projections(cuda, kernel):
    """q/k/v as views of one [B, S, 3*H*D] projection: the wgmma kernel's
    tensor maps and the mma.sync kernel's pointers both follow the strides."""
    g = torch.Generator(device=cuda).manual_seed(12)
    b, s, h, d = 2, 300, 4, 80
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, s, h, d) for i in range(3))
    o, lse = flash_attention_fwd(q, k, v, kernel=kernel)
    want_o, want_lse = flash_attention_reference(q, k, v)
    assert_k1_close(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_k1_dispatch_leaves_what_wgmma_cannot_take_to_mma(cuda):
    """A scale that is not positive, and a broadcast (zero-stride) k, go to the
    mma.sync kernel by themselves and are refused when wgmma is forced."""
    q, k, v = _k1_case(cuda, 13, 1, 256, 256, 2, 40)
    before = dict(flash_attention_fwd.launches_by_kernel)
    o, _ = flash_attention_fwd(q, k, v, scale=-0.1)
    assert_k1_close(o, flash_attention_reference(q, k, v, scale=-0.1)[0])
    kb = k[:, :, :1].expand(-1, -1, 2, -1)
    o, _ = flash_attention_fwd(q, kb, v)
    assert_k1_close(o, flash_attention_reference(q, kb, v)[0])
    assert flash_attention_fwd.launches_by_kernel == {"mma": before["mma"] + 2,
                                                      "wgmma": before["wgmma"]}
    for kwargs, keys in (({"scale": -0.1}, k), ({}, kb)):
        with pytest.raises(ValueError, match="does not take"):
            flash_attention_fwd(q, keys, v, kernel="wgmma", **kwargs)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,d", [(4096, 4096, 40), (1024, 1024, 80), (300, 200, 40)])
def test_k2_consumes_the_wgmma_forward(cuda, sq, sk, d):
    """Either K2 kernel reads o and lse of whichever K1 kernel ran: the same
    gradients from all four pairs."""
    q, k, v, do = _qkv_do(cuda, 14, 2, sq, sk, 8, d)
    want = flash_attention_backward_reference(q, k, v, *flash_attention_reference(q, k, v), do)
    for kernel in ("wgmma", "mma"):
        o, lse = flash_attention_fwd(q, k, v, kernel=kernel)
        for bwd_kernel in ("wgmma", "mma"):
            got = flash_attention_bwd(q, k, v, o, lse, do, kernel=bwd_kernel)
            assert_grads_close(got, want, 1e-2)


# ---- K2: the wgmma kernel and the dispatch between the two kernels ----------

@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [None, "mma", "wgmma"])
@pytest.mark.parametrize("sq,sk,d", ATTN_SHAPES)
def test_k2_every_shape_of_the_path_through_every_kernel_that_takes_it(cuda, sq, sk, d, kernel):
    """b2 h8 at the eight shapes of the SD1.5 UNet: the dispatch, and each
    kernel forced; a kernel that does not take the head dim raises."""
    q, k, v, do = _qkv_do(cuda, 15, 2, sq, sk, 8, d)
    o, lse = flash_attention_fwd(q, k, v)
    if kernel is not None and kernel not in k2_kernels_for(d):
        with pytest.raises(ValueError, match="does not take"):
            flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
        return
    before = dict(flash_attention_bwd.launches_by_kernel)
    got = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
    took = kernel or select_bwd_kernel(sq, sk, d)
    assert flash_attention_bwd.launches_by_kernel[took] == before[took] + 1
    torch.cuda.synchronize()
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all() for x in got)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 64, 72, 80, 160])
@pytest.mark.parametrize("sq,sk", [(333, 77), (77, 333), (200, 333), (129, 129), (1, 130)])
def test_k2_ragged_lengths_at_every_head_dim(cuda, sq, sk, d):
    """Lengths that are no multiple of a tile, through every kernel that takes
    the head dim: keys past S_k get P = 0 and no dk / dv row, rows past S_q
    add nothing and get no dq row."""
    q, k, v, do = _qkv_do(cuda, 16, 2, sq, sk, 3, d)
    o, lse = flash_attention_reference(q, k, v)
    want = flash_attention_backward_reference(q, k, v, o, lse, do)
    for kernel in k2_kernels_for(d):
        got = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
        torch.cuda.synchronize()
        assert_grads_close(got, want, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["mma", "wgmma"])
def test_k2_each_kernel_reads_strided_projections_and_a_strided_gradient(cuda, kernel):
    """q/k/v as views of one [B, S, 3*H*D] projection and dO as a view of a
    wider tensor: the wgmma kernel's tensor maps and the mma.sync kernel's
    pointers both follow the strides."""
    g = torch.Generator(device=cuda).manual_seed(17)
    b, s, h, d = 2, 300, 4, 80
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, s, h, d) for i in range(3))
    do = torch.randn(b, s, h, 2 * d, generator=g, device=cuda).bfloat16()[..., d:]
    o, lse = flash_attention_fwd(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)


@pytest.mark.gpu
def test_k2_dispatch_leaves_what_wgmma_cannot_take_to_mma(cuda):
    """A dO or a k broadcast over the heads (stride 0) has no tensor map: it
    goes to the mma.sync kernel by itself and is refused when wgmma is forced.
    The gradient autograd hands for a ``sum()`` is broadcast along the head
    dim too: that one is copied, and the copy goes to wgmma."""
    q, k, v, do = _qkv_do(cuda, 18, 1, 256, 256, 2, 40)
    o, lse = flash_attention_fwd(q, k, v)
    dob = do[:, :, :1].expand(-1, -1, 2, -1)
    kb = k[:, :, :1].expand(-1, -1, 2, -1)
    ob, lseb = flash_attention_fwd(q, kb, v)
    before = dict(flash_attention_bwd.launches_by_kernel)
    got = flash_attention_bwd(q, k, v, o, lse, dob)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, dob), 1e-2)
    got = flash_attention_bwd(q, kb, v, ob, lseb, do)
    assert_grads_close(got, flash_attention_backward_reference(q, kb, v, ob, lseb, do), 1e-2)
    assert flash_attention_bwd.launches_by_kernel == {"mma": before["mma"] + 2,
                                                      "wgmma": before["wgmma"]}
    for keys, grad in ((k, dob), (kb, do)):
        with pytest.raises(ValueError, match="does not take"):
            flash_attention_bwd(q, keys, v, o, lse, grad, kernel="wgmma")
    ones = torch.ones((), device=cuda, dtype=torch.bfloat16).expand(1, 256, 2, 40)
    got = flash_attention_bwd(q, k, v, o, lse, ones)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, ones), 1e-2)
    assert flash_attention_bwd.launches_by_kernel["wgmma"] == before["wgmma"] + 1
    with pytest.raises(ValueError, match="unknown kernel"):
        flash_attention_bwd(q, k, v, o, lse, do, kernel="tma")


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,d", [(4096, 77, 40), (1024, 77, 80), (333, 128, 40), (64, 5, 80)])
def test_k2_one_key_tile_gives_the_same_bits_in_every_run(cuda, sq, sk, d):
    """With S_k <= 128 the wgmma kernel's CTA holds all of a dq row's sum and
    writes it in bf16 itself: no adds across CTAs, so three runs agree bit
    for bit (and with the plain version within the usual bound)."""
    q, k, v, do = _qkv_do(cuda, 20, 2, sq, sk, 8, d)
    o, lse = flash_attention_fwd(q, k, v)
    runs = [flash_attention_bwd(q, k, v, o, lse, do, kernel="wgmma") for _ in range(3)]
    torch.cuda.synchronize()
    assert_grads_close(runs[0], flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.gpu
def test_k2_gradient_through_the_autograd_function_takes_the_wgmma_kernel(cuda):
    """attention(...).backward at a head dim of 40 launches K1 once and K2's
    wgmma kernel once, and agrees with plain autograd."""
    q, k, v, do = _qkv_do(cuda, 19, 2, 512, 512, 4, 40)
    before = dict(flash_attention_bwd.launches_by_kernel)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attention(*leaves).backward(do)
    assert flash_attention_bwd.launches_by_kernel == {"mma": before["mma"],
                                                      "wgmma": before["wgmma"] + 1}
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    with plain_ops():
        attention(*plain).backward(do)
    assert_grads_close([x.grad for x in leaves], [x.grad for x in plain], 3e-2)


# ---- K3: the rows kernel (channels-last) beside the per-group kernels --------

GN_PAIRS = [(320, 1024), (320, 4096), (640, 256), (640, 1024), (640, 4096), (960, 1024),
            (960, 4096), (1280, 64), (1280, 256), (1280, 1024), (1920, 256), (1920, 1024),
            (2560, 64), (2560, 256)]


def _k3_case(cuda, seed, n, c, hw, dtype, layout):
    g = torch.Generator(device=cuda).manual_seed(seed)
    side = int(hw ** 0.5)
    x = (torch.randn(n, c, side, hw // side, generator=g, device=cuda) * 3 + 2).to(
        dtype=dtype, memory_format=layout)
    return x, torch.randn(c, generator=g, device=cuda), torch.randn(c, generator=g, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("c,hw", GN_PAIRS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
def test_k3_every_shape_of_the_path_through_every_kernel_that_takes_it(cuda, c, hw, dtype, silu,
                                                                       eps, layout):
    """Every (C, H*W) pair of the SD1.5 UNet, both dtypes and layouts, SiLU on
    and off, through each kernel that takes the call; two runs agree bit for
    bit (the statistics are merged in a fixed order, with no atomics)."""
    x, w, bias = _k3_case(cuda, 20, 2, c, hw, dtype, layout)
    want = group_norm_silu_reference(x, w, bias, 32, eps, silu)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    channels_last = layout == torch.channels_last
    names = k3_kernels_for(c, hw, 32, channels_last)
    assert names == (("groups", "rows") if channels_last else ("nchw",))
    for kernel in names:
        got = group_norm_silu(x, w, bias, 32, eps, silu, kernel=kernel)
        again = group_norm_silu(x, w, bias, 32, eps, silu, kernel=kernel)
        assert got.is_contiguous(memory_format=layout) and torch.equal(got, again)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 16, 70])
@pytest.mark.parametrize("c,side,groups", [(320, 16, 32), (96, 5, 8), (72, 4, 8), (2560, 8, 32)])
def test_k3_rows_kernel_at_every_cluster_size(cuda, n, c, side, groups):
    """The cluster shrinks as the batch grows and for small images; a group
    of 9 channels (72 / 8) makes every chunk straddle two groups."""
    x, w, bias = _k3_case(cuda, 21, n, c, side * side, torch.float32, torch.channels_last)
    how = k3_plan(c, side * side, groups, 4, True, n)
    assert how["kernel"] == "rows"
    got = group_norm_silu(x, w, bias, groups, 1e-5, True)
    want = group_norm_silu_reference(x, w, bias, groups, 1e-5, True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_k3_statistics_survive_a_large_mean(cuda):
    """mean >> std: the shifted sums of the rows kernel and the Welford chunks
    of the per-group kernels both keep the variance (E[x^2] - E[x]^2 in f32
    would lose it: 100^2 against 1e-4).  The bound is 1e-2: the kernels apply
    y = x * (w * rstd) + (b - mean * w * rstd), two terms of about 1e4 |w|
    that cancel, so y carries a few f32 roundings of 1e4 |w| (|w| up to 4)."""
    x, w, bias = _k3_case(cuda, 22, 2, 320, 1024, torch.float32, torch.channels_last)
    x = (x - 2) / 3 * 0.01 + 100  # std 0.01 around 100
    want = group_norm_silu_reference(x.double(), w.double(), bias.double(), 32, 1e-8, False)
    for kernel in ("rows", "groups"):
        got = group_norm_silu(x, w, bias, 32, 1e-8, False, kernel=kernel)
        torch.testing.assert_close(got.double(), want, rtol=1e-2, atol=1e-2)
    got = group_norm_silu(x.contiguous(), w, bias, 32, 1e-8, False)
    torch.testing.assert_close(got.double(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
def test_k3_channels_last_shapes_the_rows_kernel_does_not_take(cuda):
    """Two channels a group go to the per-group kernel; an odd count that is
    no multiple of 8 is refused; a forced kernel that does not fit raises."""
    x, w, bias = _k3_case(cuda, 23, 2, 64, 64, torch.float32, torch.channels_last)
    assert k3_kernels_for(64, 64, 32, True) == ("groups",)
    torch.testing.assert_close(group_norm_silu(x, w, bias), group_norm_silu_reference(x, w, bias),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="does not take"):
        group_norm_silu(x, w, bias, kernel="rows")
    x, w, bias = _k3_case(cuda, 23, 2, 33, 64, torch.float32, torch.channels_last)
    with pytest.raises(ValueError, match="channels-last"):
        group_norm_silu(x, w, bias, 11)
