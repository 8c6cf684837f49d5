"""The port's training slice against dmtpu's, in f32 on the CPU.

- the DDPM forward process and loss (``diffuse``, ``get_v``, ``loss_func``);
- the tiny SD UNet's gradients with ``use_checkpoint`` on and off, against
  each other (equal: the recompute runs the same ops) and against jax.grad;
- three train steps (adafactor, gradient clipping, a bf16 EMA shadow)
  against ``dmtpu.parallel.make_train_step``; the parameters whose gradient
  is zero by the model's math (a per-channel offset right before a
  GroupNorm of one channel per group) are left out of that comparison,
  since adafactor scales their rounding noise up to steps of about ``lr``;
- the step's own mechanics: micro-batching, the per-step generator and the
  order of the loss's draws.

Inputs, noise and timesteps are made with numpy from a seed and handed to
both frameworks.  Tolerances: 1e-5 for the DDPM math (elementwise f32);
rtol/atol 3e-4 for the UNet's gradients (relative to each tensor's largest
entry for the atol), as the SD UNet parity tests: f32 convolutions and
matmuls summed in different orders; the train steps' parameters at 2e-6
absolute after three adafactor steps of 1e-3 (so a skipped or doubled step
is 500 times the bound), their loss and grad norm at 3e-4, and the bf16
EMA shadow at one bf16 step (up to 2^-7 relative) of the larger of its
start and end values, plus the parameters' 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDPM as JaxDDPM
from dmtpu.models.stablediffusion import SDUNetModel as JaxUNet
from dmtpu.parallel import TrainState as JaxTrainState
from dmtpu.parallel import make_train_step as jax_make_train_step
from dmtpu.utils import optim as joptim
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.diffusions import DDPM
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step, step_generator
from dmtpu_torch.utils import optim
from tests._torch_helpers import TINY_SD_UNET_CFG, nhwc, perturb, t

GRAD_TOL = 3e-4


@pytest.mark.parametrize("objective", ["pred_eps", "pred_x0", "pred_v"])
def test_ddpm_loss_matches_jax(objective):
    rs = np.random.RandomState(0)
    x0, eps = rs.randn(2, 2, 3, 4, 4).astype(np.float32)
    ts = np.array([0, 613])
    jd, td = JaxDDPM(objective=objective), DDPM(objective=objective)

    def jmodel(xt, tt):
        return 0.3 * xt + jnp.asarray(tt, jnp.float32)[:, None, None, None] / 1000.0

    def tmodel(xt, tt):
        return 0.3 * xt + tt.float()[:, None, None, None] / 1000.0

    jx0, jeps, jt = jnp.asarray(nhwc(x0)), jnp.asarray(nhwc(eps)), jnp.asarray(ts)
    np.testing.assert_allclose(nhwc(td.diffuse(t(x0), t(ts), t(eps)).numpy()),
                               np.asarray(jd.diffuse(jx0, jt, jeps)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(td.get_v(t(x0), t(eps), t(ts)).numpy()),
                               np.asarray(jd.get_v(jx0, jeps, jt)), rtol=1e-5, atol=1e-5)
    want = float(jd.loss_func(jmodel, jx0, jt, eps=jeps))
    got = td.loss_func(tmodel, t(x0), t(ts), eps=t(eps))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    # eps drawn from the generator when not given
    drawn = td.loss_func(tmodel, t(x0), t(ts), generator=torch.Generator().manual_seed(3))
    eps3 = torch.randn(x0.shape, generator=torch.Generator().manual_seed(3))
    assert drawn.item() == td.loss_func(tmodel, t(x0), t(ts), eps=eps3).item()


def _tiny_setup(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 4, 8, 8).astype(np.float32)
    ctx = rs.randn(2, 7, 24).astype(np.float32)
    jmodel = JaxUNet(**TINY_SD_UNET_CFG)
    params = perturb(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x)),
                                 jnp.asarray(np.array([1, 2])), jnp.asarray(ctx)), seed + 1)
    return jmodel, params, rs


def _jax_loss_fn(jmodel):
    """(params, batch, rng) -> eps-MSE, with t and eps taken from the batch."""
    diffuser = JaxDDPM(total_steps=1000)

    def loss_fn(params, batch, rng):
        return diffuser.loss_func(
            lambda xt, tt: jmodel.apply(params, xt, tt, batch["context"]),
            batch["image"], batch["t"], eps=batch["eps"])

    return loss_fn


def _torch_loss_fn(model):
    """(batch, generator) -> eps-MSE, with t and eps taken from the batch."""
    diffuser = DDPM(total_steps=1000)

    def loss_fn(batch, generator):
        return diffuser.loss_func(model, batch["image"], batch["t"], eps=batch["eps"],
                                  model_kwargs={"context": batch["context"]})

    return loss_fn


def _batch(rs, n=2):
    x0, eps = rs.randn(2, n, 4, 8, 8).astype(np.float32)
    return {"image": x0, "eps": eps, "t": rs.randint(0, 1000, n),
            "context": rs.randn(n, 7, 24).astype(np.float32)}


def _jax_batch(batch):
    return {k: jnp.asarray(nhwc(v) if v.ndim == 4 else v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def _assert_grads_close(torch_named, flax_tree):
    """Each torch gradient against its Flax leaf (through the param bridge),
    at rtol GRAD_TOL and atol GRAD_TOL * the largest entry of any leaf (some
    are zero up to rounding: a conv bias ahead of a GroupNorm of one
    channel per group)."""
    want = state_dict_from_flax(flax_tree)
    assert sorted(want) == sorted(torch_named)
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for name, got in torch_named.items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL * top, err_msg=name)


def test_tiny_unet_grads_with_and_without_remat_match_jax():
    jmodel, params, rs = _tiny_setup(20)
    batch = _batch(rs)
    want = jax.jit(jax.grad(_jax_loss_fn(jmodel)))(params, _jax_batch(batch), None)
    grads = []
    for remat in (False, True):
        model = load_flax_params(SDUNetModel(**TINY_SD_UNET_CFG, use_checkpoint=remat), params)
        _torch_loss_fn(model)(_torch_batch(batch), None).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
    _assert_grads_close(grads[1], jax.device_get(want))


def test_remat_wraps_each_resblock_and_spatial_transformer(monkeypatch):
    """use_checkpoint=True recomputes exactly the ResBlock and
    SpatialTransformer calls (where the JAX model calls remat_call); the
    UNet's blocks are ``models/adm.py``'s ``TimestepEmbedSequential``."""
    from dmtpu_torch.models import adm as adm_module
    from dmtpu_torch.models.adm import ResBlock
    from dmtpu_torch.models.stablediffusion.attention import SpatialTransformer

    wrapped = []
    real = adm_module.remat_call

    def counting(module, *args):
        wrapped.append(type(module))
        return real(module, *args)

    monkeypatch.setattr(adm_module, "remat_call", counting)
    model = SDUNetModel(**TINY_SD_UNET_CFG, use_checkpoint=True)
    want = [type(m) for m in model.modules() if isinstance(m, (ResBlock, SpatialTransformer))]
    model(torch.randn(1, 4, 8, 8), torch.tensor([5]), torch.randn(1, 7, 24)).sum().backward()
    assert sorted(map(str, wrapped)) == sorted(map(str, want)) and len(want) == 15


def test_dropout_follows_train_mode_and_replays_under_remat():
    cfg = dict(TINY_SD_UNET_CFG, dropout=0.5)
    torch.manual_seed(0)
    models = [SDUNetModel(**cfg, use_checkpoint=remat) for remat in (False, True)]
    models[1].load_state_dict(models[0].state_dict())
    x, ts, ctx = torch.randn(2, 4, 8, 8), torch.tensor([3, 500]), torch.randn(2, 7, 24)
    with torch.no_grad():
        for m in models:  # the zero-initialised layers would hide the dropout
            for p in m.parameters():
                p.add_(0.05)
    grads = []
    for m in models:
        m.eval()
        with torch.no_grad():
            assert torch.equal(m(x, ts, ctx), m(x, ts, ctx))
        m.train()
        with torch.no_grad():
            assert not torch.equal(m(x, ts, ctx), m(x, ts, ctx))
        torch.manual_seed(1)
        m(x, ts, ctx).square().mean().backward()
        grads.append([p.grad for p in m.parameters()])
    # the recompute replays the RNG, so it drops the same units
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(*grads))


def _rounding_noise_grads(model):
    """Names of the parameters whose gradient is below 1e-6 of the largest
    entry of any gradient: zero by the model's math, rounding noise here."""
    top = max(p.grad.abs().max() for p in model.parameters())
    return {n for n, p in model.named_parameters() if p.grad.abs().max() <= 1e-6 * top}


def test_train_steps_match_jax():
    """Three steps of adafactor (lr 1e-3), clip 1.0 and a gradual EMA with a
    bf16 shadow: loss, grad norm, params and the EMA shadow after each."""
    jmodel, params, rs = _tiny_setup(30)
    batches = [_batch(rs) for _ in range(3)]
    tx = joptim.adafactor(lr=1e-3)
    jstate = JaxTrainState.create(params, tx, ema_decay=0.9999, ema_gradual=True,
                                  ema_dtype="bfloat16")
    jstep = jax_make_train_step(_jax_loss_fn(jmodel), tx, clip_grad_norm=1.0)

    model = load_flax_params(SDUNetModel(**TINY_SD_UNET_CFG), params)
    state = TrainState.create(model, optim.adafactor(model.parameters(), lr=1e-3),
                              ema_decay=0.9999, ema_gradual=True, ema_dtype=torch.bfloat16)
    step = make_train_step(_torch_loss_fn(model), clip_grad_norm=1.0)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, _jax_batch(batch), jax.random.PRNGKey(i))
        m = step(state, _torch_batch(batch))
        if i == 0:
            blind = _rounding_noise_grads(model)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=GRAD_TOL)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=GRAD_TOL)
        assert float(jm["grad_norm"]) > 1.0  # so clipping acted
    assert state.step == 3 and state.ema.num_updates == int(jstate.ema.num_updates) == 3
    want = state_dict_from_flax(jax.device_get(jstate.params))
    start = state_dict_from_flax(params)
    # a per-channel offset ahead of a GroupNorm of one channel per group
    # (the 32-channel ResBlocks and the output head) is normalised away
    assert 0 < len(blind) <= 16
    assert all(n.endswith((".bias", "emb_layers.1.weight")) for n in blind), sorted(blind)
    for name, p in model.named_parameters():
        moved = (p.detach() - start[name]).abs().max()
        if name in blind:  # adafactor scales rounding noise up to steps of about lr
            assert torch.isfinite(p).all(), name
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)
        assert moved > 1e-3, name
    shadow = state_dict_from_flax(jax.device_get(
        jax.tree.map(lambda a: a.astype(jnp.float32), jstate.ema.shadow)))
    for name, s in state.ema.shadow.items():
        assert s.dtype == torch.bfloat16
        if name in blind:
            continue
        # each update rounds the shadow to bf16 at a size between its start
        # and end values
        bound = 2 ** -7 * (start[name].abs() + shadow[name].abs()) + 2e-6
        assert ((s.float() - shadow[name]).abs() <= bound).all(), name


def test_micro_batches_average_loss_and_grads():
    """Two micro-batches of 2 give the loss and the update of one batch of 4
    (the loss is a mean over equal-sized splits)."""
    jmodel, params, rs = _tiny_setup(40)
    batch = _torch_batch(_batch(rs, n=4))
    results = []
    for micro in (1, 2):
        model = load_flax_params(SDUNetModel(**TINY_SD_UNET_CFG), params)
        state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                  ema_decay=None)
        metrics = make_train_step(_torch_loss_fn(model), micro_batches=micro)(state, batch)
        results.append((metrics, [p.detach().clone() for p in model.parameters()]))
    (m1, p1), (m2, p2) = results
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5, atol=1e-6)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="micro-batches"):
        make_train_step(_torch_loss_fn(model), micro_batches=3)(state, batch)


def test_diffusion_loss_draws_t_eps_and_label_mask_in_order():
    """One generator per step, seeded from (seed, step); the loss draws t,
    then eps, then the label-dropout mask from it, and hands it on to the
    diffuser's ``loss_func`` (DDPM_IP draws its perturbation there)."""
    seen = {}

    class Recorder:
        def loss_func(self, model, x0, t, eps=None, generator=None, model_kwargs=None):
            seen.update(t=t, eps=eps, y=model_kwargs["y"], generator=generator)
            return torch.zeros(())

    loss_fn = make_diffusion_loss_fn(Recorder(), None, total_steps=1000, p_uncond=0.5,
                                     null_label=10)
    x0, y = torch.zeros(64, 3, 2, 2), torch.arange(64) % 10
    handed = step_generator(7, 3, torch.device("cpu"))
    loss_fn((x0, y), handed)
    assert seen["generator"] is handed
    g = step_generator(7, 3, torch.device("cpu"))
    t_want = torch.randint(0, 1000, (64,), generator=g)
    eps_want = torch.randn(x0.shape, generator=g)
    drop = torch.rand(64, generator=g) < 0.5
    assert torch.equal(seen["t"], t_want) and torch.equal(seen["eps"], eps_want)
    assert torch.equal(seen["y"], torch.where(drop, torch.tensor(10), y))
    assert 0 < int(drop.sum()) < 64
    other = torch.randint(0, 1000, (64,), generator=step_generator(7, 4, torch.device("cpu")))
    assert not torch.equal(other, t_want)
