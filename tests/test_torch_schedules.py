"""Learning-rate schedules given as ``{target:, params:}`` configs
(``dmtpu_torch/utils/optim.py``) against optax and the JAX package.

- Each supported optax schedule gives optax's values over steps 0..50
  (f32; 1e-6 relative, about eight f32 roundings).
- A scheduled optimizer applies ``schedule(k)`` at update k: three train
  steps of two micro-batches each through ``make_train_step`` against the
  JAX ``make_train_step`` with the same optax optimizer and schedule, for
  SGD with momentum, Adam and adafactor (parameters 1e-6 absolute after
  three steps of up to 1e-2), and the lr each update used.
- ``lr_fn`` gives the JAX ``lr_fn``'s values; an unknown target raises,
  listing the supported names.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmtpu.parallel import TrainState as JaxTrainState
from dmtpu.parallel import make_train_step as jax_make_train_step
from dmtpu.utils import optim as joptim
from dmtpu.utils.config import instantiate_from_config as jax_instantiate
from dmtpu_torch.parallel import TrainState, make_train_step
from dmtpu_torch.utils import optim as toptim
from dmtpu_torch.utils.config import instantiate_from_config

SCHEDULES = [
    ("optax.constant_schedule", dict(value=3e-4)),
    ("optax.linear_schedule", dict(init_value=1e-3, end_value=1e-5, transition_steps=20,
                                   transition_begin=5)),
    ("optax.polynomial_schedule", dict(init_value=1e-3, end_value=1e-5, power=2.5,
                                       transition_steps=30)),
    ("optax.cosine_decay_schedule", dict(init_value=1e-3, decay_steps=40, alpha=0.1,
                                         exponent=1.5)),
    ("optax.warmup_cosine_decay_schedule", dict(init_value=0.0, peak_value=1e-3,
                                                warmup_steps=10, decay_steps=45,
                                                end_value=1e-5)),
    ("optax.exponential_decay", dict(init_value=1e-3, transition_steps=7, decay_rate=0.5,
                                     transition_begin=3, staircase=True, end_value=1e-4)),
    ("optax.exponential_decay", dict(init_value=1e-3, transition_steps=7, decay_rate=1.25,
                                     end_value=4e-3)),
    ("optax.piecewise_constant_schedule", dict(init_value=1e-3,
                                               boundaries_and_scales={10: 0.5, 30: 0.1})),
]


@pytest.mark.parametrize("target,params", SCHEDULES, ids=[f"{t}-{i}" for i, (t, _) in
                                                         enumerate(SCHEDULES)])
def test_schedule_matches_optax(target, params):
    want = getattr(optax, target.split(".")[1])(**params)
    got = toptim.build_schedule({"target": target, "params": params})
    for step in range(51):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=0, err_msg=str(step))
    assert set(toptim.SCHEDULES) == {t for t, _ in SCHEDULES}


OPTIMS = [
    {"target": "torch.optim.SGD", "params": {"momentum": 0.9}},
    {"target": "torch.optim.Adam", "params": {}},
    {"target": "dmtpu.utils.optim.adafactor", "params": {"min_dim_size_to_factor": 4}},
]
LR = {"target": "optax.warmup_cosine_decay_schedule",
      "params": {"init_value": 1e-3, "peak_value": 1e-2, "warmup_steps": 1, "decay_steps": 3,
                 "end_value": 1e-4}}


@pytest.mark.parametrize("optim", OPTIMS, ids=lambda c: c["target"].rpartition(".")[2])
def test_update_k_applies_schedule_k_with_micro_batches(optim):
    conf = {"target": optim["target"], "params": {**optim["params"], "lr": LR}}
    rs = np.random.RandomState(0)
    w0, b0 = rs.randn(6, 5).astype(np.float32), rs.randn(5).astype(np.float32)
    batches = [rs.randn(8, 6).astype(np.float32) for _ in range(3)]

    def jloss(params, batch, rng):
        return jnp.mean(jnp.tanh(batch @ params["w"] + params["b"]) ** 2)

    tx = jax_instantiate(conf)
    jstate = JaxTrainState.create({"w": jnp.asarray(w0), "b": jnp.asarray(b0)}, tx,
                                  ema_decay=None)
    jstep = jax_make_train_step(jloss, tx, micro_batches=2)
    for batch in batches:
        jstate, _ = jstep(jstate, jnp.asarray(batch), jax.random.PRNGKey(0))

    model = torch.nn.Linear(6, 5)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0.T))
        model.bias.copy_(torch.from_numpy(b0))
    optimizer = instantiate_from_config(conf, params=model.parameters())
    state = TrainState.create(model, optimizer, ema_decay=None)
    step = make_train_step(lambda batch, gen: torch.tanh(model(batch)).square().mean(),
                           micro_batches=2)
    applied = []
    optimizer.register_step_post_hook(lambda opt, a, k: applied.append(opt.param_groups[0]["lr"]))
    for batch in batches:
        step(state, torch.from_numpy(batch))
    schedule = toptim.build_schedule(LR)
    assert applied == [schedule(k) for k in range(3)]
    assert [g["lr_updates"] for g in optimizer.param_groups] == [3]
    np.testing.assert_allclose(model.weight.detach().numpy().T, np.asarray(jstate.params["w"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(model.bias.detach().numpy(), np.asarray(jstate.params["b"]),
                               rtol=0, atol=1e-6)
    # the count lives in the state dict: a resumed optimizer goes on at update 3
    fresh = instantiate_from_config(conf, params=model.parameters())
    fresh.load_state_dict(optimizer.state_dict())
    assert fresh.param_groups[0]["lr_updates"] == 3


@pytest.mark.parametrize("target,params", SCHEDULES[:5], ids=[t for t, _ in SCHEDULES[:5]])
def test_lr_fn_matches_jax(target, params):
    conf = {"target": "dmtpu.utils.optim.adamw", "params": {
        "lr": {"target": target, "params": params}}}
    got, want = toptim.lr_fn(conf), joptim.lr_fn(conf)
    for step in (0, 1, 9, 10, 11, 44, 60):
        np.testing.assert_allclose(got(step), want(step), rtol=1e-6, atol=0)


def test_unknown_schedule_target_raises():
    for target in ("optax.sgdr_schedule", "torch.optim.lr_scheduler.StepLR"):
        with pytest.raises(ValueError, match="supported optax schedules") as e:
            toptim.adam([torch.nn.Parameter(torch.zeros(2))], lr={"target": target})
        assert "optax.piecewise_constant_schedule" in str(e.value)
    with pytest.raises(ValueError, match="positive decay_steps"):
        toptim.build_schedule({"target": "optax.cosine_decay_schedule",
                               "params": {"init_value": 1.0, "decay_steps": 0}})
