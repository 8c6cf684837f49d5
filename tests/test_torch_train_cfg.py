"""Class-conditional training of the port's DiT and MDTv2 against dmtpu's.

- The diffusion loss with label dropout (``make_diffusion_loss_fn`` with
  ``p_uncond`` and the null class) through DiT and through MDTv2 (unmasked,
  and masked with ``len_keep`` from ``sample_len_keep``): the loss and every
  parameter's gradient against ``jax.value_and_grad`` of the JAX package's
  loss on the same params (through the bridge), t, eps and drop mask.  The
  port's loss draws t, eps and the mask from torch; here those draws are
  JAX's arrays (``_jax_draws``), and MDT's masking permutation is JAX's
  uniform draw through ``models/mdt.py::_uniform``.
- One full train step (AdamW and adafactor, clipping, a gradual EMA) of DiT
  from the same params against ``dmtpu.parallel.make_train_step``; the
  entries whose gradient is below 1e-5 of the largest (the key projection's
  bias among them: zero by the model's math) are left out of that
  comparison, since both optimizers scale their rounding up to steps of
  about lr.
- ``micro_batches`` through DiT with labels: two halves average to the batch.

Sizes are tiny: DiT depth 2, hidden 64, 4 heads (and hidden 144, 2 heads:
head dim 72, DiT-XL/2's); MDT depth 6 with 2 decoder layers, hidden 32.
Tolerances, relative L2 over all gradients (and the loss relative): f32
1e-5 (the same math summed in other orders; 6e-7 seen); a bf16 torso 1e-2
(the torso's bf16 rounding at other places in the two frameworks; 6e-3
seen); each tensor's own within ten times that.  After one optimizer step at
lr 1e-3 the parameters agree to 2e-6 absolute (a skipped or doubled step is
500 times that) and the f32 EMA shadow to 2e-6 as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDPM as JaxDDPM
from dmtpu.models import dit as jdit
from dmtpu.models import mdt as jmdt
from dmtpu.parallel import TrainState as JaxTrainState
from dmtpu.parallel import make_diffusion_loss_fn as jax_loss_fn
from dmtpu.parallel import make_train_step as jax_make_train_step
from dmtpu.utils import optim as joptim
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.diffusions import DDPM
from dmtpu_torch.models import dit as tdit
from dmtpu_torch.models import mdt as tmdt
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
from dmtpu_torch.utils import optim
from tests._torch_helpers import jax_random_params, nhwc, t

F32, BF16 = 1e-5, 1e-2
TOTAL, NULL, P_UNCOND = 100, 5, 0.5
DIT_TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2, num_heads=4,
                num_classes=NULL, learn_sigma=False)
DIT_D72 = dict(DIT_TINY, hidden_size=144, num_heads=2)  # head dim 72
MDT_TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=6, num_heads=4,
                num_classes=NULL, decode_layer=2, mask_ratio=0.3, learn_sigma=False)
DIFFUSION = dict(total_steps=TOTAL, beta_schedule="linear", beta_start=1e-4, beta_end=0.02)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _params(jmod, seed):
    return jax_random_params(jmod, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1,), jnp.int32), seed=seed)


def _batch(seed, n=4):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 4, 8, 8).astype(np.float32), rs.randint(0, NULL, n)


def _jax_draws(rng, b):
    """t, eps (NCHW) and the drop mask that JAX's diffusion loss draws from
    ``rng`` for a batch of ``b`` 4x8x8 images (its split of the key)."""
    k_t, k_eps, k_drop, _ = jax.random.split(rng, 4)
    ts = np.asarray(jax.random.randint(k_t, (b,), 0, TOTAL))
    eps = np.asarray(jax.random.normal(k_eps, (b, 8, 8, 4)))
    drop = np.asarray(jax.random.bernoulli(k_drop, P_UNCOND, (b,)))
    return ts, np.ascontiguousarray(np.transpose(eps, (0, 3, 1, 2))), drop


def _feed_draws(monkeypatch, draws):
    """The port's loss draws (``torch.randint``, ``torch.randn``,
    ``torch.rand``) answered with JAX's arrays, one set per loss call."""
    queue = list(draws)
    current = {}

    def randint(low, high, size, generator=None, device=None):
        current["ts"], current["eps"], current["drop"] = queue.pop(0)
        assert tuple(size) == current["ts"].shape and high == TOTAL
        return torch.from_numpy(current["ts"].copy()).long()

    def randn(size, generator=None, device=None, dtype=None):
        assert tuple(size) == current["eps"].shape
        return torch.from_numpy(current["eps"]).to(dtype)

    def rand(size, generator=None, device=None):
        # u < p_uncond exactly where JAX's Bernoulli dropped the label
        return torch.from_numpy(np.where(current["drop"], 0.0, 1.0).astype(np.float32))

    monkeypatch.setattr(torch, "randint", randint)
    monkeypatch.setattr(torch, "randn", randn)
    monkeypatch.setattr(torch, "rand", rand)
    return queue


def _grads(model) -> dict:
    """Each parameter's gradient (zeros where autograd left none: a block
    the forward did not run)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
            for n, p in model.named_parameters()}


def _compare_loss_and_grads(loss, grads, jloss, jgrads, tol):
    want = state_dict_from_flax(jax.device_get(jgrads))
    assert sorted(want) == sorted(grads)
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
    flat = lambda d: np.concatenate([d[k].numpy().ravel() for k in sorted(d)])  # noqa: E731
    assert _rel_l2(flat(grads), flat(want)) <= tol
    # no tensor hides behind the others: each is within 10x the global bound
    # of its own norm, or the gradient is zero in both (labels not drawn)
    for name, g in grads.items():
        w = want[name].numpy()
        if not np.abs(w).max():
            assert not g.abs().max(), name
            continue
        assert _rel_l2(g.numpy(), w) <= 10 * tol, name


def _loss_and_grads(jmod, tmod, params, monkeypatch, seed, jax_kw=None, torch_kw=None):
    """(port loss, port grads, JAX loss, JAX grads) of the diffusion loss with
    label dropout on one batch, the port's draws being JAX's."""
    x0, y = _batch(seed)
    rng = jax.random.PRNGKey(seed)
    jd = JaxDDPM(**DIFFUSION)
    jfn = jax_loss_fn(jd, lambda p, x, tt, **kw: jmod.apply(p, x, tt, train=True,
                                                           **(jax_kw or {}), **kw),
                      TOTAL, p_uncond=P_UNCOND, null_label=NULL)
    jloss, jgrads = jax.jit(jax.value_and_grad(jfn))(
        params, (jnp.asarray(nhwc(x0)), jnp.asarray(y)), rng)
    draws = _jax_draws(rng, len(y))
    assert 0 < draws[2].sum() < len(y)  # some labels dropped, some kept
    queue = _feed_draws(monkeypatch, [draws])
    fn = make_diffusion_loss_fn(DDPM(**DIFFUSION),
                                lambda x, tt, **kw: tmod(x, tt, train=True, **(torch_kw or {}),
                                                         **kw),
                                TOTAL, p_uncond=P_UNCOND, null_label=NULL)
    loss = fn((t(x0), torch.from_numpy(y)), None)
    loss.backward()
    assert not queue
    return loss.detach(), _grads(tmod), jloss, jgrads


@pytest.mark.parametrize("dtype,tol", [(None, F32), ("bfloat16", BF16)], ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [DIT_TINY, DIT_D72], ids=["d16", "d72"])
def test_dit_loss_and_gradients_match_jax(monkeypatch, cfg, dtype, tol):
    jmod = jdit.DiT(**cfg, dtype=None if dtype is None else jnp.bfloat16)
    params = _params(jmod, seed=11)
    tmod = load_flax_params(tdit.DiT(**cfg, dtype=dtype), params).train()
    loss, grads, jloss, jgrads = _loss_and_grads(jmod, tmod, params, monkeypatch, seed=3)
    _compare_loss_and_grads(loss, grads, jloss, jgrads, tol)
    # the null row of the label table takes a gradient: dropped labels reach it
    assert grads["y_embedder.embedding_table.weight"][NULL].abs().max() > 0


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_mdt_loss_and_gradients_match_jax(monkeypatch, masked):
    jmod = jmdt.MDTv2(**MDT_TINY)
    params = _params(jmod, seed=12)
    tmod = load_flax_params(tmdt.MDTv2(**MDT_TINY), params).train()
    jax_kw = torch_kw = None
    if masked:
        key, len_keep = jax.random.PRNGKey(21), jmdt.sample_len_keep(16, 0.3, 0.6)
        assert len_keep == tmdt.sample_len_keep(16, 0.3, 0.6) < 16
        jax_kw = dict(enable_mask=True, len_keep=len_keep, mask_rng=key)
        torch_kw = dict(enable_mask=True, len_keep=len_keep)
        uniform = torch.from_numpy(np.array(jax.random.uniform(key, (4, 16))))
        monkeypatch.setattr(tmdt, "_uniform", lambda shape, generator, device: uniform)
    loss, grads, jloss, jgrads = _loss_and_grads(jmod, tmod, params, monkeypatch, seed=4,
                                                 jax_kw=jax_kw, torch_kw=torch_kw)
    _compare_loss_and_grads(loss, grads, jloss, jgrads, F32)
    side = [n for n in grads if n.startswith("sideblocks.")]
    moved = max(float(grads[n].abs().max()) for n in side + ["mask_token"])
    # the side interpolater and the mask token learn only from a masked pass
    assert (moved > 0) == masked


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_dit_train_step_matches_jax(monkeypatch, opt):
    """One step: loss, grad norm (clipped at 0.1, so the clip acts), the
    parameters and a gradual f32 EMA shadow."""
    jmod = jdit.DiT(**DIT_TINY)
    params = _params(jmod, seed=13)
    x0, y = _batch(5)
    rng = jax.random.PRNGKey(8)
    tx = getattr(joptim, opt)(lr=1e-3)
    jstate = JaxTrainState.create(params, tx, ema_decay=0.999, ema_gradual=True)
    jfn = jax_loss_fn(JaxDDPM(**DIFFUSION),
                      lambda p, x, tt, **kw: jmod.apply(p, x, tt, train=True, **kw),
                      TOTAL, p_uncond=P_UNCOND, null_label=NULL)
    jstep = jax_make_train_step(jfn, tx, clip_grad_norm=0.1)
    # the JAX step folds nothing into the key: the loss sees ``rng`` itself
    jstate, jm = jstep(jstate, (jnp.asarray(nhwc(x0)), jnp.asarray(y)), rng)

    model = load_flax_params(tdit.DiT(**DIT_TINY), params).train()
    state = TrainState.create(model, getattr(optim, opt)(model.parameters(), lr=1e-3),
                              ema_decay=0.999, ema_gradual=True)
    fn = make_diffusion_loss_fn(DDPM(**DIFFUSION),
                                lambda x, tt, **kw: model(x, tt, train=True, **kw), TOTAL,
                                p_uncond=P_UNCOND, null_label=NULL)
    queue = _feed_draws(monkeypatch, [_jax_draws(rng, len(y))])
    m = make_train_step(fn, clip_grad_norm=0.1)(state, (t(x0), torch.from_numpy(y)))
    assert not queue
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=F32)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    assert float(jm["grad_norm"]) > 0.1
    want = state_dict_from_flax(jax.device_get(jstate.params))
    start = state_dict_from_flax(params)
    shadow = state_dict_from_flax(jax.device_get(jstate.ema.shadow))
    assert state.ema.num_updates == int(jstate.ema.num_updates) == 1
    # Entries whose gradient is below 1e-5 of the largest (under 1% of them)
    # are left out: AdamW's first step is lr * g / (|g| + 1e-8) and
    # adafactor's follows g's sign, so there the two frameworks' rounding of
    # g becomes a good part of a step.  The
    # key projection's bias is among them in full: it adds the same q.b to
    # every logit of a row, so its gradient is zero by the math.
    top = max(float(p.grad.abs().max()) for p in model.parameters())
    blind = total = 0
    for name, p in model.named_parameters():
        keep = (p.grad.abs() > 1e-5 * top).numpy()
        if name.endswith("attn.qkv.bias"):
            d = DIT_TINY["hidden_size"]
            assert not keep[d:2 * d].any(), name
        blind, total = blind + int((~keep).sum()), total + keep.size
        np.testing.assert_allclose(p.detach().numpy()[keep], want[name].numpy()[keep], rtol=0,
                                   atol=2e-6, err_msg=name)
        np.testing.assert_allclose(state.ema.shadow[name].numpy()[keep],
                                   shadow[name].numpy()[keep], rtol=0, atol=2e-6, err_msg=name)
        assert torch.isfinite(p).all() and (p.detach() != start[name]).any(), name
    assert blind < 1e-2 * total, (blind, total)


def test_dit_micro_batches_average_loss_and_grads():
    """Two micro-batches of 2 (each split of the (images, labels) pair) give
    the loss, grad norm and update of one batch of 4 when t and eps come with
    the batch."""
    jmod = jdit.DiT(**DIT_TINY)
    params = _params(jmod, seed=14)
    x0, y = _batch(6)
    rs = np.random.RandomState(7)
    ts, eps = rs.randint(0, TOTAL, 4), rs.randn(4, 4, 8, 8).astype(np.float32)
    diffuser = DDPM(**DIFFUSION)
    results = []
    for micro in (1, 2):
        model = load_flax_params(tdit.DiT(**DIT_TINY), params).train()

        def loss_fn(batch, generator):
            x, labels, tt, e = batch
            return diffuser.loss_func(lambda xt, t_: model(xt, t_, labels, train=True), x, tt,
                                      eps=e)

        state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                  ema_decay=None)
        batch = (t(x0), torch.from_numpy(y), torch.from_numpy(ts), t(eps))
        metrics = make_train_step(loss_fn, micro_batches=micro)(state, batch)
        results.append((metrics, [p.detach().clone() for p in model.parameters()]))
    (m1, p1), (m2, p2) = results
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5, atol=1e-6)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)
