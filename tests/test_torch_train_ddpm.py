"""Pixel-space DDPM training in the port against dmtpu's, in f32 on the CPU.

- ``DDPM_IP.loss_func`` against ``dmtpu.diffusions.DDPM_IP`` with the same
  eps and perturbation, for the three objectives, and the order in which
  it draws what it is not given.
- ``make_diffusion_loss_fn`` hands the step's generator on to the
  diffuser: DDPM_IP draws its perturbation from it after t and eps, while
  DDPM, DDPMCFG and flow matching draw nothing more (their losses and the
  generator's state are those of t and eps alone).
- A tiny ``UNet`` (dim 32, mults (1, 2), attention at the second level:
  one head of 64) and a tiny ``UNetCategorialAdaGN`` (the same, labels of 5
  classes, one head of 64): the DDPM_IP loss of the model called with
  ``train=True`` (dropout 0) and every parameter's gradient, at fixed t,
  eps and perturbation, against ``jax.value_and_grad`` of the JAX loss on
  the same params (through the bridge, which maps JAX's dense q / k / v /
  proj onto the port's 1x1 convolutions).
- One Adam step (clip 1.0, acting; a gradual EMA) against
  ``dmtpu.parallel.make_train_step`` from the same params: loss, grad norm,
  parameters, Adam's moments and the EMA shadow.
- The pixel models' ``train`` keyword (the JAX modules'): with dropout 0.5,
  ``train=False`` (and no keyword) gives the eval output whatever the
  module's mode, and ``train=True`` drops units drawn from the device's
  default generator, which the train step seeds from (seed, step).

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: the losses 1e-5 relative (f32 sums in other orders); the
gradients 1e-4 relative L2 over all of them and each tensor within 3e-4 of
the largest gradient entry of any tensor (some are zero by the model's
math, a bias ahead of a GroupNorm of one channel per group, and are
rounding noise in both); after the step the parameters and the EMA to 2e-6
absolute (a step of Adam moves an entry by about lr = 1e-3, so a skipped or
doubled step is 500 times that), leaving out the entries whose gradient is
below 1e-5 of the largest (Adam's first step turns their rounding into a
full step of lr), and Adam's moments to 1e-5 relative L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDPM_IP as JaxDDPM_IP
from dmtpu.models.unet import UNet as JaxUNet
from dmtpu.models.unet_categorial_adagn import UNetCategorialAdaGN as JaxAdaGN
from dmtpu.parallel import TrainState as JaxTrainState
from dmtpu.parallel import make_train_step as jax_make_train_step
from dmtpu.utils import optim as joptim
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.convert.flax_bridge import fit_to_module
from dmtpu_torch.diffusions import DDPM, DDPM_IP, DDPMCFG, FlowMatching
from dmtpu_torch.models.adm import EncoderUNetModel, SuperResModel, UNetCombined, UNetModel
from dmtpu_torch.models.pesser import PesserUNet
from dmtpu_torch.models.unet import UNet
from dmtpu_torch.models.unet_categorial_adagn import UNetCategorialAdaGN
from dmtpu_torch.parallel import (TrainState, make_diffusion_loss_fn, make_train_step,
                                  step_generator)
from dmtpu_torch.parallel.train import dropout_rng
from dmtpu_torch.utils import optim
from tests._torch_helpers import jax_random_params, nhwc, t

F32 = 1e-5
GAMMA = 0.15
TOTAL = 1000


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jmodel(xt, tt):
    return 0.3 * xt + jnp.asarray(tt, jnp.float32)[:, None, None, None] / 1000.0


def _tmodel(xt, tt):
    return 0.3 * xt + tt.float()[:, None, None, None] / 1000.0


@pytest.mark.parametrize("objective", ["pred_eps", "pred_x0", "pred_v"])
def test_ddpm_ip_loss_matches_jax(objective):
    x0, eps, pert = np.random.RandomState(0).randn(3, 2, 3, 4, 4).astype(np.float32)
    ts = np.array([5, 613])
    jd = JaxDDPM_IP(gamma=GAMMA, objective=objective)
    td = DDPM_IP(gamma=GAMMA, objective=objective)
    assert td.gamma == GAMMA and td.total_steps == TOTAL
    want = float(jd.loss_func(_jmodel, jnp.asarray(nhwc(x0)), jnp.asarray(ts),
                              eps=jnp.asarray(nhwc(eps)), perturb_eps=jnp.asarray(nhwc(pert))))
    got = td.loss_func(_tmodel, t(x0), t(ts), eps=t(eps), perturb_eps=t(pert))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=F32)
    # the perturbation moves the input, not the target
    plain = DDPM(objective=objective).loss_func(_tmodel, t(x0), t(ts), eps=t(eps)).item()
    assert abs(got.item() - plain) > 1e-4 * plain
    assert td.loss_func(_tmodel, t(x0), t(ts), eps=t(eps), perturb_eps=t(0 * pert)).item() \
        == pytest.approx(plain, rel=F32)


def test_ddpm_ip_draws_eps_then_the_perturbation():
    x0 = t(np.random.RandomState(1).randn(2, 3, 4, 4).astype(np.float32))
    ts = torch.tensor([7, 400])
    d = DDPM_IP(gamma=GAMMA)
    drawn = d.loss_func(_tmodel, x0, ts, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    eps, pert = torch.randn(x0.shape, generator=g), torch.randn(x0.shape, generator=g)
    assert drawn.item() == d.loss_func(_tmodel, x0, ts, eps=eps, perturb_eps=pert).item()
    # with eps given, the perturbation is the generator's first draw
    g = torch.Generator().manual_seed(3)
    given = d.loss_func(_tmodel, x0, ts, eps=pert, generator=g)
    assert given.item() == d.loss_func(_tmodel, x0, ts, eps=pert,
                                       perturb_eps=eps).item()


@pytest.mark.parametrize("name", ["DDPM", "DDPMCFG", "FlowMatching", "DDPM_IP"])
def test_the_loss_hands_its_generator_on(name):
    """t, then eps, come from the step's generator; only DDPM_IP draws
    more from it (its perturbation), the others leave it as t and eps did."""
    diffuser = {"DDPM": DDPM(), "DDPMCFG": DDPMCFG(guidance_scale=1.0),
                "FlowMatching": FlowMatching(total_steps=TOTAL),
                "DDPM_IP": DDPM_IP(gamma=GAMMA)}[name]
    x0 = t(np.random.RandomState(2).randn(4, 3, 4, 4).astype(np.float32))
    handed = step_generator(5, 2, torch.device("cpu"))
    got = make_diffusion_loss_fn(diffuser, _tmodel, TOTAL)(x0, handed)
    g = step_generator(5, 2, torch.device("cpu"))
    ts = torch.randint(0, TOTAL, (4,), generator=g)
    eps = torch.randn(x0.shape, generator=g)
    extra = {}
    if name == "DDPM_IP":
        extra["perturb_eps"] = torch.randn(x0.shape, generator=g)
    want = diffuser.loss_func(_tmodel, x0, ts, eps=eps, **extra)
    assert got.item() == want.item()
    assert torch.equal(handed.get_state(), g.get_state())


UNET = dict(in_channels=3, out_channels=3, dim=32, dim_mults=(1, 2), use_attn=(False, True),
            num_res_blocks=1, n_heads=1, dropout=0.0)
ADAGN = dict(in_channels=3, out_channels=3, dim=32, dim_mults=(1, 2), use_attn=(False, True),
             num_res_blocks=1, num_classes=5, attn_head_dims=64, dropout=0.0)
SIZE = 8


def _tiny(kind: str, seed: int):
    """(JAX module, its seeded params, the port's module with them, labels or None)."""
    x, ts = jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,), jnp.int32)
    if kind == "unet":
        jmod, args, tmod, y = JaxUNet(**UNET), (x, ts), UNet(**UNET), None
    else:
        jmod, tmod, y = JaxAdaGN(**ADAGN), UNetCategorialAdaGN(**ADAGN), np.array([1, 4])
        args = (x, ts, ts)
    params = jax_random_params(jmod, *args, seed=seed)
    return jmod, params, load_flax_params(tmod, params), y


def _batch(seed: int, n: int = 2) -> dict:
    rs = np.random.RandomState(seed)
    x0, eps, pert = rs.randn(3, n, 3, SIZE, SIZE).astype(np.float32)
    return {"image": x0, "eps": eps, "pert": pert, "t": rs.randint(0, TOTAL, n)}


def _jax_loss_fn(jmod, y):
    """(params, batch, rng) -> the DDPM_IP loss of the model with ``train=True``."""
    diffuser = JaxDDPM_IP(gamma=GAMMA)
    extra = () if y is None else (jnp.asarray(y),)

    def loss_fn(params, batch, rng):
        return diffuser.loss_func(
            lambda xt, tt: jmod.apply(params, xt, tt, *extra, train=True), batch["image"],
            batch["t"], eps=batch["eps"], perturb_eps=batch["pert"])

    return loss_fn


def _torch_loss_fn(model, y):
    diffuser = DDPM_IP(gamma=GAMMA)
    kw = {} if y is None else {"y": t(y)}

    def loss_fn(batch, generator):
        return diffuser.loss_func(lambda xt, tt: model(xt, tt, train=True, **kw), batch["image"],
                                  batch["t"], eps=batch["eps"], perturb_eps=batch["pert"])

    return loss_fn


def _jax_batch(batch):
    return {k: jnp.asarray(nhwc(v) if v.ndim == 4 else v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def _by_name(tree, model) -> dict:
    """A JAX params-shaped tree as the port's parameters, by name."""
    return fit_to_module(state_dict_from_flax(jax.device_get(tree)),
                         dict(model.named_parameters()))


@pytest.mark.parametrize("kind", ["unet", "adagn"])
def test_tiny_unet_loss_and_gradients_match_jax(kind):
    jmod, params, model, y = _tiny(kind, seed=10)
    batch = _batch(11)
    want_loss, jgrads = jax.jit(jax.value_and_grad(_jax_loss_fn(jmod, y)))(
        params, _jax_batch(batch), None)
    loss = _torch_loss_fn(model, y)(_torch_batch(batch), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=F32)
    want = _by_name(jgrads, model)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(want) == sorted(got)
    flat_got = np.concatenate([got[n].numpy().ravel() for n in sorted(got)])
    flat_want = np.concatenate([want[n].numpy().ravel() for n in sorted(got)])
    assert _rel_l2(flat_got, flat_want) <= 1e-4
    top = np.abs(flat_want).max()
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0,
                                   atol=3e-4 * top, err_msg=name)
    # the attention's one head of 64 is on the path
    assert got["mid_attn.q.weight"].abs().max() > 1e-3 * top


def test_one_adam_step_matches_jax():
    """Adam (lr 1e-3), clip at 1.0 (acting) and a gradual f32 EMA."""
    jmod, params, model, _ = _tiny("unet", seed=20)
    batch = _batch(21, n=4)
    tx = joptim.adam(lr=1e-3)
    jstate = JaxTrainState.create(params, tx, ema_decay=0.999, ema_gradual=True)
    jstate, jm = jax_make_train_step(_jax_loss_fn(jmod, None), tx, clip_grad_norm=1.0)(
        jstate, _jax_batch(batch), jax.random.PRNGKey(0))

    state = TrainState.create(model, optim.adam(model.parameters(), lr=1e-3), ema_decay=0.999,
                              ema_gradual=True)
    m = make_train_step(_torch_loss_fn(model, None), clip_grad_norm=1.0)(
        state, _torch_batch(batch))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=F32)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=F32)
    assert float(jm["grad_norm"]) > 1.0  # so the clip acts
    assert state.step == 1 and state.ema.num_updates == int(jstate.ema.num_updates) == 1

    start = _by_name(params, model)
    want, shadow = _by_name(jstate.params, model), _by_name(jstate.ema.shadow, model)
    jopt = jax.device_get(jstate.opt_state[0])
    mu, nu = _by_name(jopt.mu, model), _by_name(jopt.nu, model)
    top = max(float(p.grad.abs().max()) for p in model.parameters())
    moments = {"exp_avg": [], "exp_avg_sq": []}
    for name, p in model.named_parameters():
        keep = (p.grad.abs() > 1e-5 * top).numpy()
        got = p.detach().numpy()
        np.testing.assert_allclose(got[keep], want[name].numpy()[keep], rtol=0, atol=2e-6,
                                   err_msg=name)
        np.testing.assert_allclose(state.ema.shadow[name].numpy()[keep],
                                   shadow[name].numpy()[keep], rtol=0, atol=2e-6, err_msg=name)
        assert np.abs(got - start[name].numpy())[keep].min(initial=1.0) > 5e-4, name
        st = state.optimizer.state[p]
        moments["exp_avg"].append((st["exp_avg"].numpy().ravel(), mu[name].numpy().ravel()))
        moments["exp_avg_sq"].append((st["exp_avg_sq"].numpy().ravel(),
                                      nu[name].numpy().ravel()))
    for field, pairs in moments.items():
        assert _rel_l2(np.concatenate([a for a, _ in pairs]),
                       np.concatenate([b for _, b in pairs])) <= F32, field


ADM = dict(image_size=SIZE, in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
           attention_resolutions=[2], dropout=0.5, channel_mult=(1, 2), num_head_channels=32)
PIXEL_MODELS = {
    "UNet": (lambda: UNet(**dict(UNET, dropout=0.5)), {}),
    "UNetCategorialAdaGN": (lambda: UNetCategorialAdaGN(**dict(ADAGN, dropout=0.5)),
                            {"y": torch.tensor([1, 5])}),
    "PesserUNet": (lambda: PesserUNet(ch=32, out_ch=3, num_res_blocks=1, attn_resolutions=(4,),
                                      in_channels=3, resolution=SIZE, ch_mult=(1, 2),
                                      dropout=0.5), {}),
    "UNetModel": (lambda: UNetModel(**ADM), {}),
    "SuperResModel": (lambda: SuperResModel(**ADM),
                      {"low_res": torch.randn(2, 3, SIZE // 2, SIZE // 2,
                                              generator=torch.Generator().manual_seed(4))}),
    "EncoderUNetModel": (lambda: EncoderUNetModel(**ADM, pool="adaptive"), {}),
    "UNetCombined": (lambda: UNetCombined(dict(ADM, num_classes=5)), {"y": torch.tensor([0, 3])}),
}


@pytest.mark.parametrize("name", list(PIXEL_MODELS))
def test_the_train_keyword_drives_dropout(name):
    build, kw = PIXEL_MODELS[name]
    torch.manual_seed(0)
    model = build()
    with torch.no_grad():  # the zero-initialised output layers would hide the dropout
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    x = torch.randn(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(1))
    ts = torch.tensor([3, 500])
    with torch.no_grad():
        want = model.eval()(x, ts, **kw)
        for mode in (True, False):  # train=False is the eval output in either mode
            model.train(mode)
            assert torch.equal(model(x, ts, train=False, **kw), want)
            assert torch.equal(model(x, ts, **kw), want)

        def dropped(step):
            with dropout_rng(7, step, x.device):
                return model(x, ts, train=True, **kw)

        model.eval()  # train=True drops units in either mode
        a = dropped(0)
        assert not torch.equal(a, want) and torch.isfinite(a).all()
        model.train()
        assert torch.equal(dropped(0), a)  # a function of (seed, step)
        assert not torch.equal(dropped(1), a)
