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
])
def test_optimizer_matches_optax(name, kwargs):
    params, grads = _arrays(0)
    tx = getattr(joptim, name)(**kwargs)
    jparams = {n: jnp.asarray(a) for n, a in params.items()}
    jstate = tx.init(jparams)
    tparams = {n: p.clone().requires_grad_() for n, p in _to_torch(params).items()}
    opt = getattr(optim, name)(tparams.values(), **kwargs)
    for g in grads:
        updates, jstate = tx.update({n: jnp.asarray(a) for n, a in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, tg in _to_torch(g).items():
            tparams[n].grad = tg
        opt.step()
        want = _to_torch({n: np.asarray(a) for n, a in jparams.items()})
        for n, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), err_msg=n, **TOL)
    # the parameters moved by many times the tolerance
    start = _to_torch(params)
    assert all((tparams[n].detach() - start[n]).abs().max() > 1e-3 for n in PARAMS)


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
