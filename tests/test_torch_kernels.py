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
exp, other summation orders, and dq's f32 atomics, whose order changes from
run to run), so single elements may land one bf16 step apart (2^-9 relative
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
