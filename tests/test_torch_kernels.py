"""dmtpu_torch's CUDA kernels against their plain versions, on the card.

Every test that launches a kernel is marked ``gpu`` and skips without a CUDA
device; the few unmarked ones check the kernels' gates and the shapes a
model hands them, on the CPU.  The file imports no JAX, so it also runs on a
machine that has only PyTorch:

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
from dmtpu_torch.ops.flash_attention import MAX_HEAD_DIM, _check_qkv
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
    (2, 100, 77, 3, 64), (1, 64, 64, 8, 160), (8, 256, 256, 1, 256), (16, 16, 16, 1, 256),
    (2, 200, 200, 1, 248), (16, 256, 256, 1, 512), (16, 64, 64, 1, 512), (4, 200, 200, 1, 512),
    (4, 256, 256, 1, 504), (2, 77, 333, 2, 512), (1, 1, 33, 1, 264)])
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
    q = torch.zeros(1, 64, 1, 520, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 512"):
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
    (2, 1024, 1024, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 77, 8, 160), (1, 100, 333, 3, 64),
    # the pixel UNets' one head of 256 (S = 256 at 16x16, 16 in the middle),
    # a ragged length and a padded head dim
    (8, 256, 256, 1, 256), (16, 16, 16, 1, 256), (8, 200, 200, 1, 256), (8, 256, 256, 1, 248),
    # CelebA-HQ's one head of 512 (S = 256 at 16x16, 64 in the middle), a
    # ragged length, a padded head dim and cross-attention over two heads
    (4, 256, 256, 1, 512), (4, 64, 64, 1, 512), (4, 200, 200, 1, 512), (4, 256, 256, 1, 504),
    (2, 77, 333, 2, 512)])
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
    q = torch.zeros(1, 64, 1, 520, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 512, got 520"):
        flash_attention_bwd(q, q, q, q, lse, q)


@pytest.mark.gpu
def test_a_gradient_through_head_dim_256_goes_through_k2(cuda):
    """The pixel UNets' one head of 256: K1 forward, K2's wgmma column-split
    instance backward, against plain autograd on the same bf16 values."""
    q, k, v, do = _qkv_do(cuda, 19, 2, 256, 256, 1, 256)
    before = flash_attention_bwd.launches_by_head_dim[256], flash_attention_bwd.launches
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attention(*leaves).backward(do)
    assert (flash_attention_bwd.launches_by_head_dim[256], flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert select_bwd_kernel(256) == "wgmma" and k2_kernels_for(256) == ["mma", "wgmma"]
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    with plain_ops():
        attention(*plain).backward(do)
    assert_grads_close([x.grad for x in leaves], [x.grad for x in plain], 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", [(16, 256, 512), (16, 64, 512), (4, 200, 512), (4, 256, 504)])
def test_a_gradient_through_head_dim_512_goes_through_k2(cuda, b, s, d):
    """CelebA-HQ's one head of 512 (S = 256 and 64 at b16), a ragged length
    and a padded head dim: K1's d=512 instance (wgmma) and K2's (mma.sync),
    one launch each, against K2's plain version on K1's outputs and against
    plain autograd on the same bf16 values; a wider head raises in both
    directions."""
    q, k, v, do = _qkv_do(cuda, 23, b, s, s, 1, d)
    def counts():
        return (flash_attention_fwd.launches_by_head_dim[d],
                flash_attention_bwd.launches_by_head_dim[d],
                flash_attention_bwd.launches_by_kernel["mma"])

    before = counts()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attention(*leaves).backward(do)
    assert counts() == tuple(x + 1 for x in before)
    assert select_bwd_kernel(d) == "mma" and k2_kernels_for(d) == ["mma"]
    o, lse = flash_attention_fwd(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all() for x in got)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    with plain_ops():
        attention(*plain).backward(do)
    assert_grads_close([x.grad for x in leaves], [x.grad for x in plain], 3e-2)
    q = torch.zeros(1, 16, 1, 520, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K1 takes head dims .* up to 512, got 520"):
        attention(q, q, q)
    with pytest.raises(ValueError, match="K2 takes head dims .* up to 512, got 520"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 1, 16, device=cuda), q)


# ---- K1's d=512 wgmma instance and K2's column-split instances -------------

@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (16, 256, 256, 1, 512), (16, 64, 64, 1, 512), (4, 200, 200, 1, 512), (4, 256, 256, 1, 504),
    (2, 77, 333, 2, 512), (2, 333, 40, 1, 264), (2, 100, 77, 2, 384)])
def test_k1_d512_wgmma_instance_and_its_mma_sync_twin(cuda, b, sq, sk, h, d):
    """K1's d=512 instance (O's columns split over its two consumer
    warpgroups) at CelebA-HQ's shapes, ragged lengths, S_q != S_k, 77 keys
    and padded head dims (504, 384, 264): the dispatch launches wgmma, and it
    and the mma.sync instance, forced, agree with the plain version."""
    q, k, v = _k1_case(cuda, 31, b, sq, sk, h, d)
    assert select_kernel(d) == "wgmma" and k1_kernels_for(d) == ["mma", "wgmma"]
    before = dict(flash_attention_fwd.launches_by_kernel)
    o, lse = flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches_by_kernel == {"mma": before["mma"],
                                                      "wgmma": before["wgmma"] + 1}
    o_mma, lse_mma = flash_attention_fwd(q, k, v, kernel="mma")
    want_o, want_lse = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    for got_o, got_lse in ((o, lse), (o_mma, lse_mma)):
        assert_k1_close(got_o, want_o)
        torch.testing.assert_close(got_lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 256, 256, 8, 160), (2, 64, 64, 8, 160), (2, 256, 77, 8, 160), (2, 64, 77, 8, 160),
    (2, 200, 333, 3, 152), (2, 333, 200, 2, 160), (2, 100, 50, 2, 96), (8, 256, 256, 1, 256),
    (8, 16, 16, 1, 256), (8, 200, 200, 1, 256), (4, 256, 256, 1, 248), (2, 77, 333, 2, 256)])
def test_k2_split_instances_against_plain_and_f32_autograd(cuda, b, sq, sk, h, d):
    """K2's column-split instances (160 and 256; 96, 152 and 248 padded) at
    SD1.5's d=160 shapes, the pixel UNets' d=256, ragged lengths, S_q != S_k
    and 77 keys: the dispatch launches wgmma, whose gradients agree with K2's
    plain version (1e-2) and with f32 autograd through ``mha`` on the same
    bf16 values (2e-2); with one key tile two runs agree bit for bit; the
    mma.sync kernel, forced, agrees too."""
    from dmtpu_torch.ops.flash_attention import wgmma_bwd_instance, wgmma_bwd_key_tile
    q, k, v, do = _qkv_do(cuda, 33, b, sq, sk, h, d)
    assert select_bwd_kernel(d) == "wgmma" and wgmma_bwd_instance(d) in (160, 256)
    o, lse = flash_attention_fwd(q, k, v)
    before = dict(flash_attention_bwd.launches_by_kernel)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    assert flash_attention_bwd.launches_by_kernel == {"mma": before["mma"],
                                                      "wgmma": before["wgmma"] + 1}
    torch.cuda.synchronize()
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all() for x in got)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    mha(*leaves).backward(do.float())
    assert_grads_close(got, [x.grad for x in leaves], 2e-2)
    if sk <= wgmma_bwd_key_tile(d):  # the CTA writes dq itself
        again = flash_attention_bwd(q, k, v, o, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    forced = flash_attention_bwd(q, k, v, o, lse, do, kernel="mma")
    assert_grads_close(forced, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [160, 256, 512])
def test_a_broadcast_q_falls_to_mma_at_the_new_head_dims(cuda, d):
    """A q broadcast over the batch (stride 0: no tensor map) goes to
    mma.sync in both directions, where K1 at d=512 and K2 at 160 and 256
    otherwise take wgmma; forcing wgmma on it raises."""
    g = torch.Generator(device=cuda).manual_seed(35)
    q = torch.randn(1, 64, 1, d, generator=g, device=cuda).bfloat16().expand(2, 64, 1, d)
    k, v, do = (torch.randn(2, 64, 1, d, generator=g, device=cuda).bfloat16() for _ in range(3))
    assert q.stride()[0] == 0
    before = dict(flash_attention_fwd.launches_by_kernel)
    o, lse = flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches_by_kernel["mma"] == before["mma"] + 1
    with pytest.raises(ValueError, match="does not take"):
        flash_attention_fwd(q, k, v, kernel="wgmma")
    want_o, _ = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert_k1_close(o, want_o)
    if d > 256:  # K2 at 512 is mma.sync either way
        return
    before = dict(flash_attention_bwd.launches_by_kernel)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    assert flash_attention_bwd.launches_by_kernel["mma"] == before["mma"] + 1
    with pytest.raises(ValueError, match="does not take"):
        flash_attention_bwd(q, k, v, o, lse, do, kernel="wgmma")
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)


# ---- the gates, on the CPU ----------------------------------------------------

def test_the_forward_takes_head_dims_to_512_and_the_backward_to_256():
    """Both directions take every multiple of 8 up to 512 (the mma.sync
    kernels' widest instances, CelebA-HQ's one head; the backward's limit was
    256 until its d=512 instance came) and refuse anything else, naming the
    kernel and the limit.  At 512 the forward has a wgmma instance too, and
    the dispatch takes it; the backward stays on mma.sync."""
    assert MAX_HEAD_DIM == 512
    for d in (8, 256, 264, 504, 512):
        assert k1_kernels_for(d)[0] == "mma" and k2_kernels_for(d)[0] == "mma"
        q = torch.zeros(2, 16, 1, d, dtype=torch.bfloat16)
        _check_qkv(q, q, q)
        _check_qkv(q, q, q, backward=True)
    assert k1_kernels_for(512) == ["mma", "wgmma"] and k2_kernels_for(512) == ["mma"]
    assert select_kernel(512) == "wgmma" and select_bwd_kernel(512) == "mma"
    for d in (520, 1024, 500):
        q = torch.zeros(2, 16, 1, d, dtype=torch.bfloat16)
        for backward, name in ((False, "K1"), (True, "K2")):
            with pytest.raises(ValueError, match=f"{name} takes head dims that are multiples of "
                                                 f"8 up to 512, got {d}$"):
                _check_qkv(q, q, q, backward=backward)


def test_the_celebahq_unet_hands_k1_one_head_of_512():
    """configs/ddpm_celebahq.yaml's UNet (113.7M parameters, built on the
    meta device, its forward traced there at 256x256): 5 attention calls at
    S=256 (the 16x16 level) and 1 at S=64 (the middle), one head of 512."""
    import collections
    import os

    from dmtpu_torch.models import modules
    from dmtpu_torch.utils.config import instantiate_from_config, load_config

    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "ddpm_celebahq.yaml")
    model = instantiate_from_config(load_config(config).model, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 113_673_219
    calls = collections.Counter()
    attention_fn = modules.attention

    def recorded(q, k, v, *args, **kwargs):
        calls[(q.shape[2], q.shape[1], k.shape[1], q.shape[3])] += 1
        return attention_fn(q, k, v, *args, **kwargs)

    modules.attention = recorded
    try:
        with torch.no_grad(), plain_ops():
            out = model(torch.zeros(1, 3, 256, 256, device="meta"),
                        torch.zeros(1, dtype=torch.long, device="meta"))
    finally:
        modules.attention = attention_fn
    assert tuple(out.shape) == (1, 3, 256, 256)
    assert dict(calls) == {(1, 256, 256, 512): 5, (1, 64, 64, 512): 1}


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
    took = kernel or select_kernel(d)
    assert flash_attention_fwd.launches_by_kernel[took] == before[took] + 1
    want_o, want_lse = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert_k1_close(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,d", ATTN_SHAPES)
def test_k1_every_shape_of_the_path_at_the_cfg_doubled_batch(cuda, sq, sk, d):
    """b32 h8, what a 16-image request with classifier-free guidance gives K1:
    the dispatched kernel against the plain version, which runs in slices of
    8 samples (its f32 logits at S = 4096 are 4 GiB for 8)."""
    q, k, v = _k1_case(cuda, 12, 32, sq, sk, 8, d)
    o, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    for i in range(0, 32, 8):
        want_o, want_lse = flash_attention_reference(q[i:i + 8], k[i:i + 8], v[i:i + 8])
        assert_k1_close(o[i:i + 8], want_o)
        torch.testing.assert_close(lse[i:i + 8], want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 64, 72, 80, 160, 256])
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
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 333, 200, 3, 160), (2, 200, 333, 3, 152), (2, 64, 77, 8, 160), (2, 100, 65, 2, 160),
    (8, 200, 200, 1, 256), (4, 256, 256, 1, 248), (2, 77, 333, 2, 248), (8, 16, 16, 1, 256),
    (2, 100, 80, 2, 80), (2, 100, 81, 2, 80), (2, 300, 1, 2, 40), (2, 130, 150, 2, 96)])
def test_k1_wide_instances_and_the_short_key_tile(cuda, b, sq, sk, h, d):
    """The wgmma kernel's instances of 160 and 256 at ragged lengths and at
    head dims between instances (152, 248 and 96 run on the next wider one),
    and its short-key tile on either side of 80 keys: the dispatch launches
    wgmma, whose output and logsumexp agree with the plain version."""
    q, k, v = _k1_case(cuda, 15, b, sq, sk, h, d)
    assert select_kernel(d) == "wgmma"
    before = dict(flash_attention_fwd.launches_by_kernel)
    o, lse = flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches_by_kernel == {"mma": before["mma"],
                                                      "wgmma": before["wgmma"] + 1}
    want_o, want_lse = flash_attention_reference(q, k, v)
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
@pytest.mark.parametrize("kernel", [None, "mma", "wgmma"])
def test_k1_at_dit_xl2_shape_through_every_kernel(cuda, kernel):
    """DiT-XL/2's self-attention, S=256 over 16 heads of 72, q, k and v the
    strided views of one [B, S, 3, H, D] projection that ``TimmAttention``
    hands K1; the dispatch sends d=72 with two key tiles to wgmma."""
    g = torch.Generator(device=cuda).manual_seed(14)
    qkv = torch.randn(4, 256, 3, 16, 72, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert select_kernel(72) == "wgmma" and k1_kernels_for(72) == ["mma", "wgmma"]
    before = dict(flash_attention_fwd.launches_by_kernel)
    o, lse = flash_attention_fwd(q, k, v, kernel=kernel)
    took = kernel or "wgmma"
    assert flash_attention_fwd.launches_by_kernel[took] == before[took] + 1
    want_o, want_lse = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("sq,sk,d", [(4096, 4096, 40), (1024, 1024, 80), (300, 200, 40),
                                     (256, 256, 72), (333, 333, 64)])
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
    took = kernel or select_bwd_kernel(d)
    assert flash_attention_bwd.launches_by_kernel[took] == before[took] + 1
    torch.cuda.synchronize()
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all() for x in got)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 64, 72, 80, 160, 256, 512])
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
@pytest.mark.parametrize("kernel", [None, "mma", "wgmma"])
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_k2_at_dit_xl2_shape_through_every_kernel(cuda, kernel, layout):
    """DiT-XL/2's self-attention backward, S=256 over 16 heads of 72 (two key
    tiles: dq summed across CTAs in f32): q, k and v as the strided views of
    one [B, S, 3, H, D] projection that ``TimmAttention`` hands the kernels,
    and as contiguous tensors; the dispatch sends d=72 to wgmma."""
    g = torch.Generator(device=cuda).manual_seed(21)
    b, s, h, d = 4, 256, 16, 72
    if layout == "strided":
        qkv = torch.randn(b, s, 3, h, d, generator=g, device=cuda).bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        assert q.stride() == (s * 3 * h * d, 3 * h * d, d, 1)
    else:
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).bfloat16() for _ in range(3))
    do = torch.randn(b, s, h, d, generator=g, device=cuda).bfloat16()
    assert select_bwd_kernel(d) == "wgmma" and k2_kernels_for(d) == ["mma", "wgmma"]
    o, lse = flash_attention_fwd(q, k, v)
    before = dict(flash_attention_bwd.launches_by_kernel)
    got = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
    took = kernel or "wgmma"
    assert flash_attention_bwd.launches_by_kernel[took] == before[took] + 1
    torch.cuda.synchronize()
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all() for x in got)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    mha(*leaves).backward(do.float())
    assert_grads_close(got, [x.grad for x in leaves], 2e-2)


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
@pytest.mark.parametrize("sq,sk,d", [(4096, 77, 40), (1024, 77, 80), (333, 128, 40), (64, 5, 80),
                                     (256, 128, 72), (100, 77, 72), (333, 77, 64)])
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
@pytest.mark.parametrize("c,hw", GN_PAIRS)
@pytest.mark.parametrize("dtype,silu,eps", [(torch.bfloat16, True, 1e-5),
                                            (torch.bfloat16, False, 1e-6),
                                            (torch.float32, True, 1e-5)])
def test_k3_every_shape_of_the_path_at_the_cfg_doubled_batch(cuda, c, hw, dtype, silu, eps):
    """32 samples, channels-last, what a 16-image request with classifier-free
    guidance gives K3: the plan spreads a sample over fewer CTAs there than at
    batch 16 (a cluster of 2 where the image has the rows for it)."""
    x, w, bias = _k3_case(cuda, 24, 32, c, hw, dtype, torch.channels_last)
    how = k3_plan(c, hw, 32, x.element_size(), True, 32)
    assert how["kernel"] == "rows" and how["cluster"] == 2
    got = group_norm_silu(x, w, bias, 32, eps, silu)
    again = group_norm_silu(x, w, bias, 32, eps, silu)
    want = group_norm_silu_reference(x, w, bias, 32, eps, silu)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert got.is_contiguous(memory_format=torch.channels_last) and torch.equal(got, again)
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


# ---- K3 at the VAE's GroupNorm shapes, and the VAE through it ---------------------

VAE_GN_PAIRS = [(128, 65536), (128, 262144), (256, 16384), (256, 65536), (256, 262144),
                (512, 4096), (512, 16384), (512, 65536)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,hw", VAE_GN_PAIRS)
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
def test_k3_every_group_norm_shape_of_the_vae(cuda, c, hw, silu, layout):
    """The SD1.5 VAE at 512x512: f32, eps 1e-6, SiLU on (ResNet blocks, the
    output norm) and off (the attention's norm), b2, through each kernel that
    takes the call; two runs agree bit for bit."""
    x, w, bias = _k3_case(cuda, 30, 2, c, hw, torch.float32, layout)
    want = group_norm_silu_reference(x, w, bias, 32, 1e-6, silu)
    channels_last = layout == torch.channels_last
    names = k3_kernels_for(c, hw, 32, channels_last)
    assert names == (("nchw",) if not channels_last else
                     ("groups",) if c == 128 else ("groups", "rows"))
    for kernel in names:
        got = group_norm_silu(x, w, bias, 32, 1e-6, silu, kernel=kernel)
        again = group_norm_silu(x, w, bias, 32, 1e-6, silu, kernel=kernel)
        assert got.is_contiguous(memory_format=layout) and torch.equal(got, again)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("c,layout", [(128, torch.contiguous_format), (256, torch.channels_last)])
def test_k3_past_two_gib(cuda, c, layout):
    """b16 at 512x512: 2 GiB (C = 128) and 4 GiB (C = 256) tensors, byte
    offsets beyond an int32; the last sample is compared, where they are largest."""
    x, w, bias = _k3_case(cuda, 31, 16, c, 262144, torch.float32, layout)
    assert x.numel() * 4 >= 2 ** 31
    got = group_norm_silu(x, w, bias, 32, 1e-6, True)
    want = group_norm_silu_reference(x[-1:], w, bias, 32, 1e-6, True)
    torch.testing.assert_close(got[-1:], want, rtol=1e-4, atol=1e-4)
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.gpu
def test_vae_and_clip_run_k3_and_no_attention_kernel(cuda):
    """A small VAE on the card: every GroupNorm launches K3, the mid-block's
    one-head attention stays on the plain ``mha``, and the result is the plain
    path's (f32, TF32 off: 1e-4)."""
    from dmtpu_torch.models.adm import GroupNorm32
    from dmtpu_torch.models.stablediffusion import AutoencoderKL

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    vae = AutoencoderKL(ch=64, ch_mult=(1, 2), num_res_blocks=1, resolution=32, device=cuda).eval()
    norms = sum(isinstance(m, GroupNorm32) for m in vae.modules())
    x = torch.randn(2, 3, 32, 32, device=cuda)
    with torch.no_grad():
        group_norm_silu.launches = flash_attention_fwd.launches = 0
        got, _ = vae(x, sample_posterior=False)
        assert (group_norm_silu.launches, flash_attention_fwd.launches) == (norms, 0)
        with plain_ops():
            want, _ = vae(x, sample_posterior=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---- K1 at head dim 64: MMDiT's joint attention ------------------------------

# (b, h, S): SD3-medium's 154 + 4096 tokens over 24 heads, and bench's MMDiT-B/2
# at 77 + 256 over 12; both have a masked last key tile
MMDIT_ATTN = [(1, 24, 4250), (4, 12, 333)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [None, "mma", "wgmma"])
@pytest.mark.parametrize("b,h,s", MMDIT_ATTN)
def test_k1_at_mmdit_shapes_through_every_kernel(cuda, b, h, s, kernel):
    """Contiguous q, k and v made by ``torch.cat`` of the context and image
    streams, as the joint attention hands them; the dispatch sends d=64 with
    more than one key tile to wgmma."""
    g = torch.Generator(device=cuda).manual_seed(15)
    lc = 154 if s == 4250 else 77
    q, k, v = (torch.cat([torch.randn(b, lc, h, 64, generator=g, device=cuda),
                          torch.randn(b, s - lc, h, 64, generator=g, device=cuda)], 1).bfloat16()
               for _ in range(3))
    assert select_kernel(64) == "wgmma" and k1_kernels_for(64) == ["mma", "wgmma"]
    before = dict(flash_attention_fwd.launches_by_kernel)
    o, lse = flash_attention_fwd(q, k, v, kernel=kernel)
    took = kernel or "wgmma"
    assert flash_attention_fwd.launches_by_kernel[took] == before[took] + 1
    want_o, want_lse = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert_k1_close(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("qk_norm", [False, True])
def test_mmdit_runs_one_k1_a_block_and_agrees_with_the_plain_path(cuda, qk_norm):
    """A small bf16 MMDiT at head dim 64 (4 heads, 3 blocks, 9 + 256 tokens):
    one K1 launch a block, through wgmma, no K2 or K3; its output within 2e-2
    relative L2 of the same model through the plain ops (both bf16: the
    kernel rounds P and O where ``mha`` rounds its logits and weights)."""
    from dmtpu_torch.models.mmdit import MMDiT

    torch.manual_seed(0)
    m = MMDiT(input_size=32, patch_size=2, in_channels=4, hidden_size=256, depth=3,
              num_heads=4, context_dim=32, pooled_dim=16, qk_norm=qk_norm, dtype="bfloat16",
              device=cuda).eval()
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.randn(2, 4, 32, 32, device=cuda)
    t = torch.tensor([10.5, 900.0], device=cuda)
    y = {"context": torch.randn(2, 9, 32, device=cuda), "pooled": torch.randn(2, 16, device=cuda)}
    with torch.no_grad():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)
        got = m(x, t, y)
        assert (flash_attention_fwd.launches, flash_attention_bwd.launches,
                group_norm_silu.launches) == (3, 0, 0)
        assert flash_attention_fwd.launches_by_kernel == {"mma": 0, "wgmma": 3}
        with plain_ops():
            want = m(x, t, y)
    err = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert got.shape == (2, 4, 32, 32) and bool(torch.isfinite(got).all()) and err <= 2e-2


# ---- K2 at head dim 64: MMDiT's joint attention backward ----------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [None, "mma", "wgmma"])
@pytest.mark.parametrize("b,h,s", MMDIT_ATTN)
def test_k2_at_mmdit_shapes_through_every_kernel(cuda, b, h, s, kernel):
    """The joint attention's backward at both ragged MMDiT lengths (4250 =
    33 * 128 + 26, 333 = 2 * 128 + 77), q, k and v made by ``torch.cat`` of
    the two streams: the dispatch sends d=64 to wgmma, and each kernel agrees
    with the plain version, with f32 autograd through ``mha`` and (wgmma)
    with the mma.sync kernel."""
    g = torch.Generator(device=cuda).manual_seed(22)
    lc = 154 if s == 4250 else 77
    q, k, v = (torch.cat([torch.randn(b, lc, h, 64, generator=g, device=cuda),
                          torch.randn(b, s - lc, h, 64, generator=g, device=cuda)], 1).bfloat16()
               for _ in range(3))
    do = torch.randn(b, s, h, 64, generator=g, device=cuda).bfloat16()
    assert select_bwd_kernel(64) == "wgmma" and k2_kernels_for(64) == ["mma", "wgmma"]
    o, lse = flash_attention_fwd(q, k, v)
    before = dict(flash_attention_bwd.launches_by_kernel)
    got = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
    took = kernel or "wgmma"
    assert flash_attention_bwd.launches_by_kernel[took] == before[took] + 1
    torch.cuda.synchronize()
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all() for x in got)
    assert_grads_close(got, flash_attention_backward_reference(q, k, v, o, lse, do), 1e-2)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    mha(*leaves).backward(do.float())
    assert_grads_close(got, [x.grad for x in leaves], 2e-2)
    if took == "wgmma":
        assert_grads_close(got, flash_attention_bwd(q, k, v, o, lse, do, kernel="mma"), 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("param_dtype", [None, "bfloat16"])
def test_mmdit_train_step_runs_k1_and_k2_a_block_and_agrees_with_the_plain_path(cuda,
                                                                              param_dtype):
    """A small bf16 MMDiT at head dim 64 (4 heads, 3 blocks, 9 + 256 tokens),
    its parameters f32 or stored in bf16: a forward and backward launch one
    K1 and one K2 a block, all through wgmma, and the gradient is within 3e-2
    relative L2 of the same model's through the plain ops (both bf16)."""
    from dmtpu_torch.models.mmdit import MMDiT

    torch.manual_seed(0)
    m = MMDiT(input_size=32, patch_size=2, in_channels=4, hidden_size=256, depth=3,
              num_heads=4, context_dim=32, pooled_dim=16, dtype="bfloat16",
              param_dtype=param_dtype, device=cuda).train()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.05 * torch.randn(p.shape, device=cuda))
    x = torch.randn(2, 4, 32, 32, device=cuda)
    t = torch.tensor([10.5, 900.0], device=cuda)
    y = {"context": torch.randn(2, 9, 32, device=cuda), "pooled": torch.randn(2, 16, device=cuda)}

    def grads():
        m.zero_grad(set_to_none=True)
        m(x, t, y, train=True).float().square().mean().backward()
        return [p.grad.float().clone() for p in m.parameters()]

    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)
    flash_attention_bwd.launches_by_kernel.update(mma=0, wgmma=0)
    got = grads()
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches_by_kernel == {"mma": 0, "wgmma": 3}
    assert flash_attention_bwd.launches_by_kernel == {"mma": 0, "wgmma": 3}
    with plain_ops():
        want = grads()
    err = (sum((a - b).square().sum() for a, b in zip(got, want)).sqrt()
           / sum(b.square().sum() for b in want).sqrt()).item()
    assert err <= 3e-2 and all(bool(torch.isfinite(a).all()) for a in got)
