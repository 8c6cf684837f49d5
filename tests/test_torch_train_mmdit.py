"""MMDiT rectified-flow training in the port against dmtpu's, on the CPU.

- The flow-matching loss through MMDiT with its per-sample conditioning
  dropout: the loss and every parameter's gradient against
  ``jax.value_and_grad`` of the JAX CLI's loss (``make_diffusion_loss_fn``
  over ``FlowMatching``, the loss rng's dropout key as MMDiT's
  ``force_drop_rng``) on the same params (through the bridge), t, eps and
  drop mask.  The port's loss draws t and eps from torch and the model its
  mask; here those draws are JAX's arrays (``_feed_draws``), some samples
  dropped and some kept, and the dropped ones reach the context embedder as
  zeros.  f32, a bf16 torso (``dtype``) and a bf16 torso stored in bf16
  (``param_dtype``), with and without QK norm, at hidden 32 (2 heads) and at
  MMDiT's head dim of 64 (hidden 128, 2 heads).
- One full train step (adafactor and adam, the clip acting, a gradual bf16
  EMA) against ``dmtpu.parallel.make_train_step`` from the same params, at
  f32 and bf16 ``param_dtype`` (the torso computing in f32, so that the
  gradients agree to f32 rounding and the step is what is compared), and
  with two micro-batches: loss, grad norm, the parameters, the optimizer
  state and the EMA shadow.
- ``param_dtype``: the dtypes of storage and compute, the SD UNet and DiT
  unchanged, and the bridge loading a bf16 JAX params tree exactly.

Tolerances.  Loss and gradients, relative L2 over all gradients (and the
loss relative): f32 1e-5 (sums in other orders); a bf16 torso 1e-2 and a
bf16-stored one 2e-2 (the torso's bf16 rounding at other places in the two
frameworks); each tensor within ten times that.  After one step: f32
parameters and the f32 EMA to 2e-6 absolute (a skipped or doubled step is
500 times that); bf16 parameters, the bf16 EMA and adafactor's bf16
statistics to one bf16 spacing of the JAX value (both frameworks round the
same f32 sums, in other orders, and a bf16 gradient one ulp apart doubles
in g^2): over the model at most 0.5% of the parameters and of the EMA
entries (0.18% seen) and 3% of adafactor's statistics (0.97% seen) off by
more than one spacing of the larger of their values before and after the
step, none by more than 16 (7.5 seen; a skipped step is some 5 spacings of
every entry), leaving out, as for f32, the entries whose gradient is below
1e-5 of the largest (their first step is the rounding of g; for a
statistic, those whose root-mean-square gradient is); with micro-batches a
statistic's spacing is that of the larger of its value and the value the
largest micro-batch gradient alone would give (both packages sum the
micro-batches in bf16, so where they cancel the sum keeps the rounding of
its terms: one term's gradient one bf16 ulp apart was 24 spacings of the
cancelled sum's g^2); f32
statistics to 1e-4 relative L2, or 2e-3 beside bf16 leaves (the clip
scale follows optax's norm, below); adam's moments to 1e-2 relative L2 (optax computes them in the
parameter's dtype, torch in f32 and rounds once); the grad norm to 1e-3
relative (optax sums each bf16 leaf's squares in bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import FlowMatching as JaxFlowMatching
from dmtpu.models import mmdit as jmmdit
from dmtpu.parallel import TrainState as JaxTrainState
from dmtpu.parallel import make_diffusion_loss_fn as jax_loss_fn
from dmtpu.parallel import make_train_step as jax_make_train_step
from dmtpu.utils import optim as joptim
from dmtpu_torch.convert import load_flax_params, mmdit_key, state_dict_from_flax
from dmtpu_torch.convert.flax_bridge import _flatten, torch_name
from dmtpu_torch.diffusions import FlowMatching
from dmtpu_torch.models import dit as tdit
from dmtpu_torch.models import mmdit as tmmdit
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
from dmtpu_torch.parallel.train import global_norm
from dmtpu_torch.scripts.train_mmdit import train_apply
from dmtpu_torch.utils import optim
from tests._torch_helpers import jax_random_params, nhwc, t

F32, BF16, BF16_STORED = 1e-5, 1e-2, 2e-2
TOTAL, P_DROP, CTX = 1000, 0.5, 5
TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=2, num_heads=2,
            context_dim=16, pooled_dim=12, cond_dropout_prob=P_DROP)
D64 = dict(TINY, hidden_size=128)  # MMDiT's head dim
# the loss rng of each case: JAX's Bernoulli(0.5) of its dropout key drops
# some of the 4 samples and keeps the others (two micro-batches: in each)
LOSS_KEY = 4
MODES = {"f32": (None, None, F32), "bf16": ("bfloat16", None, BF16),
         "bf16_stored": ("bfloat16", "bfloat16", BF16_STORED)}
JAX_DTYPES = {None: None, "bfloat16": jnp.bfloat16}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _models(cfg, dtype, param_dtype, seed, **kw):
    """(JAX module, its seeded params, the port's module with them)."""
    jmod = jmmdit.MMDiT(**cfg, **kw, dtype=JAX_DTYPES[dtype],
                        param_dtype=JAX_DTYPES[param_dtype] or jnp.float32)
    y = {"context": jnp.zeros((1, CTX, cfg["context_dim"])),
         "pooled": jnp.zeros((1, cfg["pooled_dim"]))}
    params = jax_random_params(jmod, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), y, seed=seed)
    tmod = tmmdit.MMDiT(**cfg, **kw, dtype=dtype, param_dtype=param_dtype)
    return jmod, params, load_flax_params(tmod, params).train()


def _batch(cfg, seed, n=4):
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(n, 4, 8, 8).astype(np.float32),
            "context": rs.randn(n, CTX, cfg["context_dim"]).astype(np.float32),
            "pooled": rs.randn(n, cfg["pooled_dim"]).astype(np.float32)}


def _jax_batch(batch):
    return {"image": jnp.asarray(nhwc(batch["image"])), "context": jnp.asarray(batch["context"]),
            "pooled": jnp.asarray(batch["pooled"])}


def _torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def _jax_loss(jmod):
    """The JAX CLI's loss: the loss rng's dropout key drives MMDiT's dropout."""

    def apply_fn(p, x, tt, rngs=None, context=None, pooled=None, **kw):
        return jmod.apply(p, x, tt, {"context": context, "pooled": pooled}, train=True,
                          force_drop_rng=None if rngs is None else rngs.get("dropout"))

    return jax_loss_fn(JaxFlowMatching(total_steps=TOTAL), apply_fn, TOTAL)


def _jax_draws(rng, b):
    """t, eps (NCHW) and the dropout mask that the JAX loss draws from ``rng``
    for a batch of ``b`` 4x8x8 images (its four-way split of the key)."""
    k_t, k_eps, _, k_dropout = jax.random.split(rng, 4)
    ts = np.asarray(jax.random.randint(k_t, (b,), 0, TOTAL))
    eps = np.asarray(jax.random.normal(k_eps, (b, 8, 8, 4)))
    drop = np.asarray(jax.random.bernoulli(k_dropout, P_DROP, (b,)))
    return ts, np.ascontiguousarray(np.transpose(eps, (0, 3, 1, 2))), drop


def _feed_draws(monkeypatch, draws):
    """The port's loss draws (``torch.randint``, ``torch.randn``) and the
    model's dropout draw (``torch.rand``) answered with JAX's arrays, one set
    per loss call."""
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
        # u < cond_dropout_prob exactly where JAX's Bernoulli dropped the sample
        assert generator is not None and size == len(current["drop"])
        return torch.from_numpy(np.where(current["drop"], 0.0, 1.0).astype(np.float32))

    monkeypatch.setattr(torch, "randint", randint)
    monkeypatch.setattr(torch, "randn", randn)
    monkeypatch.setattr(torch, "rand", rand)
    return queue


def _grads(model) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().clone()
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("cfg,mode,qk_norm", [
    (TINY, "f32", True), (TINY, "bf16", False), (TINY, "bf16_stored", True),
    (D64, "f32", False), (D64, "bf16", True), (D64, "bf16_stored", False)],
    ids=["h32-f32-qk", "h32-bf16", "h32-bf16_stored-qk", "d64-f32", "d64-bf16-qk",
         "d64-bf16_stored"])
def test_mmdit_loss_and_gradients_match_jax(monkeypatch, cfg, mode, qk_norm):
    dtype, param_dtype, tol = MODES[mode]
    jmod, params, tmod = _models(cfg, dtype, param_dtype, seed=11, qk_norm=qk_norm)
    batch = _batch(cfg, seed=3)
    rng = jax.random.PRNGKey(LOSS_KEY)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss(jmod)))(params, _jax_batch(batch), rng)
    draws = _jax_draws(rng, 4)
    assert 0 < draws[2].sum() < 4  # some samples dropped, some kept
    seen = []
    tmod.context_embedder.register_forward_hook(lambda m, inp, out: seen.append(inp[0]))
    queue = _feed_draws(monkeypatch, [draws])
    loss = make_diffusion_loss_fn(FlowMatching(total_steps=TOTAL), train_apply(tmod), TOTAL)(
        _torch_batch(batch), None)
    loss.backward()
    assert not queue
    # the dropped samples' context reaches the model as the all-zeros null
    ctx = seen[0].float().numpy()
    assert not ctx[draws[2]].any()
    np.testing.assert_array_equal(ctx[~draws[2]], batch["context"][~draws[2]])

    want = state_dict_from_flax(jax.device_get(jgrads), mmdit_key)
    grads = _grads(tmod)
    assert sorted(want) == sorted(grads)
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
    flat = lambda d: np.concatenate([d[k].numpy().ravel() for k in sorted(d)])  # noqa: E731
    assert _rel_l2(flat(grads), flat(want)) <= tol
    for name, g in grads.items():
        w = want[name].numpy()
        if not np.abs(w).max():  # the last block's context q-norm: its q is unused
            assert not g.abs().max(), name
            continue
        assert _rel_l2(g.numpy(), w) <= 10 * tol, name
    # the gradients of a bf16-stored torso are bf16, the conditioning MLPs' f32
    p = dict(tmod.named_parameters())
    assert p["joint_blocks.0.x_block.attn.qkv.weight"].grad.dtype == \
        (torch.bfloat16 if param_dtype else torch.float32)
    assert p["t_embedder.mlp.0.weight"].grad.dtype == torch.float32


def _spacing(w: np.ndarray) -> np.ndarray:
    """One bf16 spacing at each value of ``w`` (the subnormal floor below)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)


def _assert_close(got: np.ndarray, want: np.ndarray, before: np.ndarray, stored_bf16: bool,
                  name: str, offs: list) -> None:
    """f32: within 2e-6; bf16: each entry's distance from JAX's in bf16
    spacings of the larger of its values before and after the step (an
    entry that the step takes near zero keeps the rounding of the larger),
    into ``offs`` (the caller bounds them over the whole model)."""
    if stored_bf16:
        offs.append((np.abs(got - want) / _spacing(np.maximum(np.abs(want), np.abs(before))))
                    .ravel())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, err_msg=name)


def _state_by_name(tree, params) -> dict:
    """The leaves of an optax state tree that mirrors ``params``, keyed by
    their parameter's torch name, in the torch layout where a leaf has the
    parameter's shape (adafactor's factored statistics, vectors, as they are)."""
    strip = lambda tr: tr["params"] if set(tr) == {"params"} else tr  # noqa: E731
    leaves = dict(_flatten(strip(tree)))
    out = {}
    for path, p in _flatten(strip(params)):
        p, leaf = np.asarray(p), np.asarray(leaves[path], np.float32)
        key, perm = torch_name(path, p.ndim)
        out[mmdit_key(key)] = leaf.transpose(perm) if perm and leaf.shape == p.shape else leaf
    return out


def _port_statistics(g_sq: torch.Tensor, st: dict) -> list:
    """Adafactor's first-step statistics of ``g_sq`` in the port's layout:
    ``[v]``, or ``[v_row, v_col]`` (the means over the factored dims)."""
    if "v" in st:
        return [g_sq.numpy()]
    d1, d0 = optim.factored_dims(g_sq.shape, 128)
    return [g_sq.mean(d0).numpy(), g_sq.mean(d1).numpy()]


def _factored_pairs(st: dict, jax_row: np.ndarray, jax_col: np.ndarray, shape) -> list:
    """(port, JAX) pairs of adafactor's statistics of one 2-D weight, matched
    by the axis they reduce: a torch [out, in] weight is the JAX [in, out]
    kernel transposed, and for a square one the two pick their row and
    column axes the other way round."""
    _, d0 = optim.factored_dims(torch.Size(shape), 128)
    _, jax_d0 = optim.factored_dims(torch.Size(shape[::-1]), 128)
    if 1 - d0 == jax_d0:
        return [(st["v_row"], jax_row), (st["v_col"], jax_col)]
    return [(st["v_row"], jax_col), (st["v_col"], jax_row)]


@pytest.mark.parametrize("opt,param_dtype,micro", [
    ("adafactor", None, 1), ("adafactor", "bfloat16", 1), ("adam", None, 1),
    ("adam", "bfloat16", 1), ("adafactor", "bfloat16", 2)],
    ids=["adafactor-f32", "adafactor-bf16", "adam-f32", "adam-bf16", "adafactor-bf16-micro2"])
def test_mmdit_train_step_matches_jax(monkeypatch, opt, param_dtype, micro):
    """One step at head dim 64: loss, grad norm (clipped at 0.1, so the clip
    acts), the parameters, the optimizer state and a gradual EMA in the
    parameters' dtype."""
    stored = param_dtype is not None
    jmod, params, model = _models(D64, None, param_dtype, seed=13)
    batch = _batch(D64, seed=5)
    rng = jax.random.PRNGKey(LOSS_KEY)
    tx = getattr(joptim, opt)(lr=1e-3)
    ema_dtype = "bfloat16" if stored else None
    jstate = JaxTrainState.create(params, tx, ema_decay=0.999, ema_gradual=True,
                                  ema_dtype=ema_dtype)
    jstep = jax_make_train_step(_jax_loss(jmod), tx, clip_grad_norm=0.1, micro_batches=micro)
    jstate, jm = jstep(jstate, _jax_batch(batch), rng)

    state = TrainState.create(model, getattr(optim, opt)(model.parameters(), lr=1e-3),
                              ema_decay=0.999, ema_gradual=True, ema_dtype=ema_dtype)
    keys = jax.random.split(rng, micro) if micro > 1 else [rng]
    draws = [_jax_draws(k, 4 // micro) for k in keys]
    assert all(0 < d[2].sum() < 4 // micro for d in draws)
    queue = _feed_draws(monkeypatch, draws)
    terms = {}  # per entry, the largest micro-batch gradient (before the mean)
    for name, p in model.named_parameters():
        p.register_hook(lambda g, name=name: terms.__setitem__(
            name, torch.maximum(terms.get(name, torch.zeros(())), g.detach().float().abs())))
    loss_fn = make_diffusion_loss_fn(FlowMatching(total_steps=TOTAL), train_apply(model), TOTAL)
    m = make_train_step(loss_fn, clip_grad_norm=0.1, micro_batches=micro)(
        state, _torch_batch(batch))
    assert not queue
    clip = min(1.0, 0.1 / (m["grad_norm"].item() + 1e-6))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=F32)
    assert m["grad_norm"].dtype == torch.float32 and float(jm["grad_norm"]) > 0.1
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-3 if stored else 1e-5)

    want = state_dict_from_flax(jax.device_get(jstate.params), mmdit_key)
    start = state_dict_from_flax(params, mmdit_key)
    shadow = state_dict_from_flax(jax.device_get(jstate.ema.shadow), mmdit_key)
    assert state.ema.num_updates == int(jstate.ema.num_updates) == 1
    top = max(float(p.grad.abs().max()) for p in model.parameters())
    jopt = jax.device_get(jstate.opt_state[0])
    fields = ("v_row", "v_col", "v") if opt == "adafactor" else ("mu", "nu")
    jax_state = {f: _state_by_name(getattr(jopt, f), params) for f in fields}
    moments = {"mu": [], "nu": []}
    offs = {"params": [], "ema": [], "stats": []}
    for name, p in model.named_parameters():
        torso = p.dtype == torch.bfloat16
        assert torso == (stored and not name.startswith(("t_embedder.", "y_embedder."))
                         and ".ln_" not in name), name
        got, w = p.detach().float().numpy(), want[name].numpy()
        keep = (p.grad.float().abs() > 1e-5 * top).numpy()
        before = start[name].numpy()[keep]
        _assert_close(got[keep], w[keep], before, torso, name, offs["params"])
        # a bf16 EMA keeps every shadow in bf16, the f32 conditioning MLPs' too
        assert state.ema.shadow[name].dtype == (torch.bfloat16 if stored else torch.float32)
        _assert_close(state.ema.shadow[name].float().numpy()[keep], shadow[name].numpy()[keep],
                      before, stored, name, offs["ema"])
        moved = np.abs(got - start[name].numpy()) > 0
        assert moved.mean() > 0.5 or not p.grad.abs().max(), name
        # the optimizer's state, in the parameter's dtype as optax keeps it
        st = state.optimizer.state[p]
        if opt == "adafactor":
            pairs = ([(st["v"], jax_state["v"][name])] if "v" in st else
                     _factored_pairs(st, jax_state["v_row"][name], jax_state["v_col"][name],
                                     tuple(p.shape)))
            # the statistics the largest micro-batch term alone would give
            term_stats = _port_statistics((terms[name] / micro * clip).square(), st)
            for (a, b), term_stat in zip(pairs, term_stats):
                assert a.dtype == p.dtype and a.shape == b.shape, name
                a = a.float().numpy()
                if torso:
                    kept = np.sqrt(b) > 1e-5 * top
                    ref = np.maximum(b, term_stat)
                    offs["stats"].append((np.abs(a - b) / _spacing(ref))[kept].ravel())
                else:
                    # with bf16 leaves optax's norm, hence the clip scale, is
                    # 1e-3 off, and g^2 twice that
                    assert _rel_l2(a, b) <= (2e-3 if stored else 1e-4), name
        else:
            for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                assert st[key].dtype == p.dtype
                moments[field].append((st[key].float().numpy().ravel(),
                                       jax_state[field][name].ravel()))
    for field, pairs in moments.items() if opt == "adam" else ():
        got = np.concatenate([a for a, _ in pairs])
        w = np.concatenate([b for _, b in pairs])
        assert _rel_l2(got, w) <= (1e-2 if stored else 1e-5), field
    # bf16 entries, over the whole model: (share beyond one spacing, most spacings)
    bounds = {"params": (5e-3, 16), "ema": (5e-3, 16), "stats": (3e-2, 16)}
    for what, spacings in offs.items():
        assert bool(spacings) == (stored and (what != "stats" or opt == "adafactor")), what
        if spacings:
            spacings = np.concatenate(spacings)
            share, most = bounds[what]
            assert (spacings > 1).mean() <= share and spacings.max() <= most, what


@pytest.mark.parametrize("micro", [2, 3])
def test_micro_batch_gradients_sum_in_the_parameter_dtype_then_divide(micro):
    """The port's gradient accumulation is the JAX step's, bit for bit: the
    micro-batch gradients of a bf16 parameter summed in bf16, then divided
    by the count.  Each micro-batch's gradient is its row of ``c`` (bf16
    values): a sum that bf16 rounds away (1 + 3 * 2^-10 + 3 * 2^-10), one
    that cancels, and others; dividing each term before the sum (by 3)
    rounds another way.  SGD at learning rate 1 from zero makes the
    parameter the gradient."""
    import optax

    c = np.zeros((micro, 4), np.float32)
    c[:, 0] = [1.0] + [3 * 2.0 ** -10] * (micro - 1)
    c[:2, 1] = [0.006072998046875, -0.00543212890625]
    c[:, 2] = np.arange(1, micro + 1) * 0.1015625
    c[:, 3] = [3.0] + [-1.0] * (micro - 1)
    assert np.array_equal(c, c.astype(jnp.bfloat16).astype(np.float32))

    def jax_loss(params, batch, rng):
        return jnp.sum(params["w"].astype(jnp.float32) * batch["c"].sum(0))

    tx = optax.sgd(-1.0)
    jstate = JaxTrainState.create({"w": jnp.zeros((4,), jnp.bfloat16)}, tx)
    jstate, _ = jax_make_train_step(jax_loss, tx, micro_batches=micro)(
        jstate, {"c": jnp.asarray(c)}, jax.random.PRNGKey(0))
    want = np.asarray(jstate.params["w"].astype(jnp.float32))

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(4, dtype=torch.bfloat16))
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=1.0, maximize=True))
    make_train_step(lambda batch, generator: (model.w.float() * batch["c"].sum(0)).sum(),
                    micro_batches=micro)(state, {"c": torch.from_numpy(c)})
    np.testing.assert_array_equal(model.w.detach().float().numpy(), want)
    divided_first = torch.zeros(4, dtype=torch.bfloat16)
    for row in torch.from_numpy(c / micro).bfloat16():
        divided_first += row
    assert np.array_equal(divided_first.float().numpy(), want) == (micro == 2)


def test_global_norm_is_f32_over_mixed_dtypes():
    rs = np.random.RandomState(0)
    a, b = rs.randn(300).astype(np.float32), rs.randn(7, 5).astype(np.float32)
    ta = torch.from_numpy(a).bfloat16()
    got = global_norm([ta, torch.from_numpy(b)])
    want = np.sqrt(np.sum(ta.float().numpy().astype(np.float64) ** 2) + np.sum(b ** 2.0))
    assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-6 * want


def test_param_dtype_stores_the_torso_in_bf16():
    m = tmmdit.MMDiT(**D64, qk_norm=True, dtype="bfloat16", param_dtype="bfloat16")
    bf16 = {n for n, p in m.named_parameters() if p.dtype == torch.bfloat16}
    f32 = {n for n, p in m.named_parameters() if p.dtype == torch.float32}
    assert bf16 | f32 == set(dict(m.named_parameters()))
    assert f32 == {n for n in f32 if n.startswith(("t_embedder.", "y_embedder."))
                   or ".attn.ln_" in n}
    assert {n.split(".")[0] for n in bf16} == {"x_embedder", "context_embedder", "joint_blocks",
                                               "final_layer"}
    for part in ("adaLN_modulation.1", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
        assert f"joint_blocks.0.x_block.{part}.weight" in bf16
    # the final linear computes in bf16 only when both dtypes are bf16, as Flax promotes
    assert m.final_layer.linear.compute_dtype == torch.bfloat16
    assert tmmdit.MMDiT(**D64, dtype="bfloat16").final_layer.linear.compute_dtype == \
        torch.float32
    f32_stored = tmmdit.MMDiT(**D64, param_dtype="bfloat16")
    assert f32_stored.final_layer.linear.compute_dtype == torch.float32
    assert f32_stored.joint_blocks[0].x_block.attn.qkv.compute_dtype == torch.float32
    # the SD UNet and DiT keep f32 parameters under a bf16 torso (R3)
    dit = tdit.DiT(input_size=8, in_channels=4, hidden_size=32, depth=1, num_heads=2,
                   num_classes=3, dtype="bfloat16")
    unet = SDUNetModel(in_channels=4, out_channels=4, model_channels=32,
                       attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                       num_heads=2, context_dim=16, torso_dtype="bfloat16")
    for mod in (dit, unet):
        assert {p.dtype for p in mod.parameters()} == {torch.float32}


def test_bridge_loads_a_bf16_params_tree_exactly():
    jmod, params, tmod = _models(D64, "bfloat16", "bfloat16", seed=2, qk_norm=True)
    leaves = jax.tree.leaves(params)
    assert {np.asarray(x).dtype.name for x in leaves} == {"bfloat16", "float32"}
    sd = tmod.state_dict()
    for name, w in state_dict_from_flax(params, mmdit_key).items():
        assert torch.equal(sd[name].float(), w), name
    # an f32 upstream file loads into bf16 storage, rounded once
    f32_sd = {k: v.float() + 1e-4 for k, v in sd.items()}
    tmod.load_state_dict(f32_sd)
    got = tmod.state_dict()
    assert all(torch.equal(got[k], f32_sd[k].to(got[k].dtype)) for k in got)
