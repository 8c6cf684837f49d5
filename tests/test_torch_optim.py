"""dmtpu_torch.utils.optim and dmtpu_torch.models.ema against dmtpu's.

The same parameters and gradients, made with numpy from a seed, go through
the JAX package's optax factories and ``EMAState`` and through the port's
optimizers and ``EMAState`` for a few steps.  4-D parameters are HWIO in
JAX and OIHW here, so a factored second moment is also checked for not
depending on the layout.  Tolerance rtol/atol 1e-5 on the parameters
(about 100 f32 ulps of a unit parameter; the steps are 1e-2): f32 math in
another order, ``rsqrt`` against ``x ** -0.5``.  The bf16 EMA shadow is
compared at one bf16 step (up to 2^-7 relative): the two may round an f32 value
that differs in its last bits to neighbouring bf16 values.

The options that keep a state in a dtype of its own or rescale the update
(``mu_dtype``, adafactor's ``momentum`` / ``momentum_dtype`` /
``multiply_by_parameter_scale``) are held tighter: f32 parameters to 1e-6
relative, with 1e-6 absolute for entries near zero (1e-4 of a step); bf16
parameters to one bf16 ulp or 1e-6; a bf16 first moment or momentum to one bf16 ulp
(its f32 value may differ in the last bits and round to the neighbour); an
f32 one to 1e-5 relative; both with 1e-6 of the largest entry absolute,
where the two parts of the moment nearly cancel.  These JAX steps are
jitted, as the JAX train step is: XLA then keeps a bf16 product that an
f32 sum promotes unrounded, which an op-by-op step would round.  A state
saved after one step and loaded into a fresh optimizer goes on as the
uninterrupted run, bit for bit, its dtypes kept.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmtpu.models.ema import EMAState as JaxEMA
from dmtpu.utils import optim as joptim
from dmtpu_torch.models.ema import EMAState
from dmtpu_torch.utils import optim
from dmtpu_torch.utils.optim import factored_dims

# name -> (torch shape, permutation from the JAX layout to the torch layout)
PARAMS = {
    "bias": ((300,), None),
    "dense": ((160, 256), (1, 0)),                  # factored: 160 >= 128
    "conv_factored": ((256, 128, 3, 3), (3, 2, 0, 1)),
    "conv_unfactored": ((32, 16, 3, 3), (3, 2, 0, 1)),
}
TOL = dict(rtol=1e-5, atol=1e-5)
NEW_TOL = dict(rtol=1e-6, atol=1e-6)
NEW_OPTIONS = {"adam": ("mu_dtype",), "adamw": ("mu_dtype",),
               "adafactor": ("momentum", "momentum_dtype", "multiply_by_parameter_scale")}
SCHEDULE = {"target": "optax.warmup_cosine_decay_schedule",
            "params": {"init_value": 1e-3, "peak_value": 1e-2, "warmup_steps": 1,
                       "decay_steps": 3, "end_value": 1e-4}}


def _jax_shape(shape, perm):
    if perm is None:
        return shape
    inv = np.argsort(perm)
    return tuple(shape[i] for i in inv)


def _arrays(seed, steps=3):
    """Initial params and ``steps`` gradients, in the JAX layouts."""
    rs = np.random.RandomState(seed)
    params = {n: rs.randn(*_jax_shape(s, perm)).astype(np.float32)
              for n, (s, perm) in PARAMS.items()}
    grads = [{n: (rs.randn(*a.shape) * 0.1).astype(np.float32) for n, a in params.items()}
             for _ in range(steps)]
    return params, grads


def _to_torch(tree):
    return {n: torch.from_numpy(np.array(
        a if PARAMS[n][1] is None else np.transpose(a, PARAMS[n][1]))) for n, a in tree.items()}


@pytest.mark.parametrize("name,kwargs", [
    ("adafactor", dict(lr=1e-2)),
    ("adafactor", dict(lr=1e-2, weight_decay=1e-2)),
    ("adam", dict(lr=1e-2)),
    ("adam", dict(lr=1e-2, weight_decay=1e-2)),
    ("adamw", dict(lr=1e-2)),
    ("sgd", dict(lr=1e-2)),
    ("sgd", dict(lr=1e-2, momentum=0.9, weight_decay=1e-2)),
    ("sgd", dict(lr=1e-2, momentum=0.9, nesterov=True)),
    # the options that keep a state in a dtype of its own or rescale the update
    ("adam", dict(lr=1e-2, mu_dtype="bfloat16")),
    ("adam", dict(lr=1e-2, weight_decay=1e-2, mu_dtype="bf16")),
    ("adamw", dict(lr=1e-2, mu_dtype="bfloat16")),
    ("adam", dict(lr=1e-2, mu_dtype="bfloat16", param_dtype="bfloat16")),
    ("adamw", dict(lr=SCHEDULE, mu_dtype="float32", param_dtype="bfloat16")),
    ("adafactor", dict(lr=1e-2, momentum=0.9)),
    ("adafactor", dict(lr=1e-2, momentum=0.9, momentum_dtype="float32")),
    ("adafactor", dict(lr=1e-2, multiply_by_parameter_scale=True, weight_decay=1e-2)),
    ("adafactor", dict(lr=SCHEDULE, multiply_by_parameter_scale=True, momentum=0.9)),
])
def test_optimizer_matches_optax(name, kwargs):
    kwargs = dict(kwargs)
    dtype = kwargs.pop("param_dtype", None)
    new_option = dtype is not None or any(k in kwargs for k in NEW_OPTIONS.get(name, ()))
    params, grads = _arrays(0)
    tx = getattr(joptim, name)(**kwargs)
    jparams = {n: jnp.asarray(a, dtype) for n, a in params.items()}
    jstate = tx.init(jparams)
    tparams = {n: p.to(_torch_dtype(dtype)).requires_grad_()
               for n, p in _to_torch(params).items()}
    opt = getattr(optim, name)(tparams.values(), **kwargs)
    jstep = _jax_step(tx, jit=new_option)
    for g in grads:
        jparams, jstate = jstep({n: jnp.asarray(a, dtype) for n, a in g.items()}, jstate,
                                jparams)
        for n, tg in _to_torch(g).items():
            tparams[n].grad = tg.to(_torch_dtype(dtype))
        opt.step()
        want = _to_torch({n: np.asarray(a, np.float32) for n, a in jparams.items()})
        for n, p in tparams.items():
            if not new_option:
                np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), err_msg=n,
                                           **TOL)
            elif dtype == "bfloat16":
                assert p.dtype == torch.bfloat16
                _within_a_bf16_ulp(p.detach(), want[n], n, NEW_TOL["atol"])
            else:
                np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), err_msg=n,
                                           **NEW_TOL)
        if new_option:
            _moments_match(name, kwargs, opt, tparams, jstate)
    # the parameters moved by many times the tolerance
    start = _to_torch(params)
    assert all((tparams[n].detach().float() - start[n]).abs().max() > 1e-3 for n in PARAMS)


def _jax_step(tx, jit):
    """One update applied; jitted as the JAX train step runs it, where XLA
    computes a fused step's bf16 arithmetic in f32 and rounds what it stores
    (op by op, each bf16 operation is rounded: the eager form)."""
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    return jax.jit(step) if jit else step


def _torch_dtype(name):
    return getattr(torch, name or "float32")


def _within_a_bf16_ulp(got, want, msg, floor=0.0):
    """|got - want| at most the bf16 spacing at the larger of the two, or
    ``floor``."""
    got, want = got.float(), want.float()
    top = torch.maximum(got.abs(), want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=2.0 ** -126))) - 7)
    bad = (got - want).abs() > ulp.clamp(min=floor)
    assert not bad.any(), f"{msg}: {int(bad.sum())} entries more than a bf16 ulp apart, " \
                          f"worst {(got - want).abs().max().item():.3e}"


def _moments_match(name, kwargs, opt, tparams, jstate):
    """The stored first moment (adam) or momentum (adafactor), in its dtype,
    against optax's.  A bf16 one is then set to optax's, so that the next
    step starts from the same state: an entry rounded to the neighbouring
    bf16 value would otherwise carry a step's 2^-8 of itself into the
    parameters and the next rounding."""
    if name == "adafactor":
        if kwargs.get("momentum") is None:
            return
        key, want_dtype = "momentum", kwargs.get("momentum_dtype", "bfloat16")
        jtree = optax.tree_utils.tree_get(jstate, "ema")
    else:
        key, want_dtype = "exp_avg", kwargs["mu_dtype"]
        jtree = optax.tree_utils.tree_get(jstate, "mu")
    want_dtype = {"bf16": "bfloat16"}.get(want_dtype, want_dtype)
    want = _to_torch({n: np.asarray(a, np.float32) for n, a in jtree.items()})
    for n, p in tparams.items():
        got = opt.state[p][key]
        assert got.dtype == getattr(torch, want_dtype), (n, got.dtype)
        assert str(jtree[n].dtype) == want_dtype, (n, jtree[n].dtype)
        if want_dtype == "bfloat16":
            # an entry where (1 - b) g and b m nearly cancel keeps the f32
            # difference of the two parts, ~1e-6 of the largest
            _within_a_bf16_ulp(got, want[n], f"{n} {key}", 1e-6 * float(want[n].abs().max()))
            got.copy_(want[n])
        else:
            np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=1e-5,
                                       atol=1e-6 * float(want[n].abs().max()),
                                       err_msg=f"{n} {key}")


@pytest.mark.parametrize("name,kwargs,dtype", [
    ("adamw", dict(lr=SCHEDULE, mu_dtype="bfloat16"), torch.float32),
    ("adam", dict(lr=1e-2, mu_dtype="bfloat16"), torch.bfloat16),
    ("adafactor", dict(lr=SCHEDULE, momentum=0.9, multiply_by_parameter_scale=True),
     torch.float32),
])
def test_optimizer_state_resumes(name, kwargs, dtype, tmp_path):
    """Three steps in one run against one step, a checkpoint of the train
    state, a fresh optimizer loaded from it and two more steps: the same
    bits, and the state's dtypes as the optimizer keeps them."""
    from dmtpu_torch.parallel import TrainState
    from dmtpu_torch.utils import checkpoint as ckpt_lib

    params, grads = _arrays(3)

    def fresh():
        model = torch.nn.ParameterDict({n: torch.nn.Parameter(p.to(dtype))
                                        for n, p in _to_torch(params).items()})
        return TrainState.create(model, getattr(optim, name)(model.parameters(), **kwargs),
                                 ema_decay=None)

    def steps(state, gs):
        for g in gs:
            for n, tg in _to_torch(g).items():
                state.model[n].grad = tg.to(dtype)
            state.optimizer.step()
            state.step += 1

    straight = fresh()
    steps(straight, grads)
    part = fresh()
    steps(part, grads[:1])
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), 1, part)
    resumed = fresh()
    ckpt_lib.load_checkpoint(path, resumed)
    steps(resumed, grads[1:])
    for n in PARAMS:
        assert torch.equal(straight.model[n], resumed.model[n]), n
        a, b = straight.optimizer.state[straight.model[n]], resumed.optimizer.state[resumed.model[n]]
        assert a.keys() == b.keys()
        for key, v in a.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(b[key])), (n, key)
            assert torch.as_tensor(v).dtype == torch.as_tensor(b[key]).dtype, (n, key)
        kept = b["exp_avg"] if name != "adafactor" else b["momentum"]
        assert kept.dtype == torch.bfloat16, (n, kept.dtype)
    if "lr_updates" in straight.optimizer.param_groups[0]:
        assert resumed.optimizer.param_groups[0]["lr_updates"] == 3


@pytest.mark.parametrize("shape", [(300,), (127, 300), (128, 300), (300, 128), (3, 3, 128, 256),
                                   (256, 128, 3, 3), (3, 3, 16, 32), (640, 640)])
def test_factored_dims_match_optax(shape):
    from optax._src.factorized import _factored_dims

    want = _factored_dims(shape, True, 128)
    got = factored_dims(torch.Size(shape), 128)
    # equal dims may be taken in either order: the estimate is symmetric
    assert (got is None) == (want is None)
    if got is not None:
        assert sorted(shape[i] for i in got) == sorted(shape[i] for i in want)


def test_adafactor_keeps_factored_state_small():
    p = torch.zeros(256, 128, 3, 3, requires_grad=True)
    opt = optim.adafactor([p], lr=1e-3)
    p.grad = torch.ones_like(p)
    opt.step()
    assert sorted(tuple(v.shape) for k, v in opt.state[p].items() if k != "step") == \
        [(128, 3, 3), (256, 3, 3)]


@pytest.mark.parametrize("dtype,gradual", [(None, True), ("bfloat16", True), (None, False)])
def test_ema_matches_jax(dtype, gradual):
    params, grads = _arrays(1, steps=5)
    jema = JaxEMA.create({n: jnp.asarray(a) for n, a in params.items()}, 0.999, gradual,
                         dtype=dtype)
    tema = EMAState.create(_to_torch(params), 0.999, gradual,
                           dtype=getattr(torch, dtype) if dtype else None)
    cur = dict(params)
    for g in grads:
        cur = {n: a - g[n] for n, a in cur.items()}
        jema = jema.update({n: jnp.asarray(a) for n, a in cur.items()})
        tema.update(_to_torch(cur))
        assert tema.num_updates == int(jema.num_updates)
        assert tema.get_decay() == float(jema.get_decay())
    want = _to_torch({n: np.asarray(a, np.float32) for n, a in jema.shadow.items()})
    for n, s in tema.shadow.items():
        assert s.dtype == (torch.bfloat16 if dtype else torch.float32)
        if dtype:
            torch.testing.assert_close(s.float(), want[n], rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_allclose(s.numpy(), want[n].numpy(), rtol=1e-6, atol=1e-6)
