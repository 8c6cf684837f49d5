"""``configs/ddpm_celebahq.yaml``'s training in the port against dmtpu's, on the CPU.

The config's UNet has one attention head as wide as its 512 channels (K1 and
K2 at head dim 512 on the card; their plain versions here).  At reduced depth
with that head kept: ``dim`` 128, ``dim_mults`` (1, 4), ``use_attn`` (False,
True), one ResBlock a level, 16x16 images (the head of 512 at 8x8), b2:

- the config's DDPM loss (linear schedule, pred_eps) at fixed t and eps, and
  every parameter's gradient, against ``jax.value_and_grad`` of the JAX UNet
  on the same params (through the bridge), f32: the loss and each gradient
  tensor to 1e-5 relative (L2), and all of them together;
- one step of the config's Adam, clip 1.0 (acting) and its gradual EMA
  against ``dmtpu.parallel.make_train_step`` from the same params: loss,
  grad norm, parameters, the EMA shadow and Adam's moments.  The step runs at
  lr 1e-3 in place of the config's 2e-5, so that it moves an entry by far
  more than f32 rounding (a skipped or doubled step is 500 times the
  parameters' tolerance of 2e-6); entries whose gradient is below 1e-5 of the
  largest are left out (Adam's first step turns their rounding into a full
  step of lr);
- ``train_ddpm`` on ``configs/ddpm_celebahq.yaml`` with ``Synthetic`` data in
  place of CelebA-HQ and the same reduced UNet: 3 steps with a save and an
  eval grid, then ``-r latest`` to 5.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from dmtpu.diffusions import DDPM as JaxDDPM
from dmtpu.models.unet import UNet as JaxUNet
from dmtpu.parallel import TrainState as JaxTrainState
from dmtpu.parallel import make_train_step as jax_make_train_step
from dmtpu.utils import optim as joptim
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.convert.flax_bridge import fit_to_module
from dmtpu_torch.models.unet import UNet
from dmtpu_torch.parallel import TrainState, make_train_step
from dmtpu_torch.scripts import train_ddpm
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils.config import instantiate_from_config, load_config
from tests._torch_helpers import jax_random_params, nhwc, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "ddpm_celebahq.yaml")
CONF = load_config(CONFIG)
SIZE, LR = 16, 1e-3
REDUCED = {"dim_mults": [1, 4], "use_attn": [False, True], "num_res_blocks": 1}
PARAMS = dict(CONF.model.params.to_dict(), **REDUCED)
F32 = 1e-5


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _models(seed: int):
    jmod = JaxUNet(**PARAMS)
    params = jax_random_params(jmod, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,), jnp.int32),
                               seed=seed)
    model = load_flax_params(UNet(**PARAMS), params)
    return jmod, params, model


def _batch(seed: int, n: int = 2) -> dict:
    rs = np.random.RandomState(seed)
    x0, eps = rs.randn(2, n, 3, SIZE, SIZE).astype(np.float32)
    return {"image": x0, "eps": eps, "t": rs.randint(0, 1000, n)}


def _jax_loss_fn(jmod):
    diffuser = JaxDDPM(**CONF.diffusion.params.to_dict())

    def loss_fn(params, batch, rng):
        return diffuser.loss_func(lambda xt, tt: jmod.apply(params, xt, tt, train=True),
                                  batch["image"], batch["t"], eps=batch["eps"])

    return loss_fn


def _torch_loss_fn(model):
    diffuser = instantiate_from_config(CONF.diffusion)

    def loss_fn(batch, generator):
        return diffuser.loss_func(lambda xt, tt: model(xt, tt, train=True), batch["image"],
                                  batch["t"], eps=batch["eps"])

    return loss_fn


def _jax_batch(batch):
    return {k: jnp.asarray(nhwc(v) if v.ndim == 4 else v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def _by_name(tree, model) -> dict:
    return fit_to_module(state_dict_from_flax(jax.device_get(tree)),
                         dict(model.named_parameters()))


def test_the_head_of_512_is_on_the_path():
    model = UNet(**PARAMS)
    q = model.mid_attn.q.weight
    assert PARAMS["dim"] * PARAMS["dim_mults"][-1] == 512 and PARAMS["n_heads"] == 1
    assert q.shape[:2] == (512, 512)
    assert CONF.model.params.dropout == 0.0 and CONF.train.ema_gradual


def test_celebahq_unet_loss_and_gradients_match_jax():
    jmod, params, model = _models(seed=30)
    batch = _batch(31)
    want_loss, jgrads = jax.jit(jax.value_and_grad(_jax_loss_fn(jmod)))(
        params, _jax_batch(batch), None)
    loss = _torch_loss_fn(model)(_torch_batch(batch), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=F32)
    want = _by_name(jgrads, model)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(want) == sorted(got)
    top = max(float(w.abs().max()) for w in want.values())
    for name in got:
        if name.endswith(".k.bias"):
            # zero by the attention's math (it adds one constant to a row's
            # logits): rounding noise in both
            assert max(float(got[name].abs().max()), float(want[name].abs().max())) <= 1e-6 * top
        else:
            assert _rel_l2(got[name], want[name]) <= F32, name
    assert _rel_l2(np.concatenate([got[n].numpy().ravel() for n in sorted(got)]),
                   np.concatenate([want[n].numpy().ravel() for n in sorted(got)])) <= F32
    assert got["mid_attn.q.weight"].abs().max() > 0


def test_one_adam_step_with_clip_and_ema_matches_jax():
    jmod, params, model = _models(seed=40)
    batch = _batch(41)
    assert CONF.train.optim.target == "torch.optim.Adam"
    tx = joptim.adam(lr=LR)
    jstate = JaxTrainState.create(params, tx, ema_decay=CONF.train.ema_decay,
                                  ema_gradual=CONF.train.ema_gradual)
    jstate, jm = jax_make_train_step(_jax_loss_fn(jmod), tx,
                                     clip_grad_norm=CONF.train.clip_grad_norm)(
        jstate, _jax_batch(batch), jax.random.PRNGKey(0))

    optim = instantiate_from_config(dict(CONF.train.optim.to_dict(), params={"lr": LR}),
                                    params=model.parameters())
    state = TrainState.create(model, optim, ema_decay=CONF.train.ema_decay,
                              ema_gradual=CONF.train.ema_gradual)
    m = make_train_step(_torch_loss_fn(model), clip_grad_norm=CONF.train.clip_grad_norm)(
        state, _torch_batch(batch))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=F32)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=F32)
    assert float(jm["grad_norm"]) > CONF.train.clip_grad_norm  # so the clip acts
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


def test_global_norm_of_a_512_wide_convolution_s_gradient_is_the_f64_norm():
    """The train step's grad norm at the config's widest layer (a 3x3
    convolution of 1024 to 512 channels): PyTorch's f32 CPU norm is 1e-4 off
    there, the JAX package's within 1e-7; the port sums the squares in f64."""
    from dmtpu_torch.parallel.train import global_norm

    rs = np.random.RandomState(5)
    a = (1e-3 * rs.randn(512, 1024, 3, 3)).astype(np.float32)
    b = rs.randn(512).astype(np.float32)
    got = global_norm([torch.from_numpy(a), torch.from_numpy(b).bfloat16()])
    want = np.sqrt(np.sum(a.astype(np.float64) ** 2)
                   + np.sum(torch.from_numpy(b).bfloat16().double().numpy() ** 2))
    assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-7 * want


def test_train_ddpm_on_the_celebahq_config_trains_saves_and_resumes(tmp_path):
    exp = str(tmp_path / "exp")
    base = ["-c", CONFIG, "-e", exp, "-ni", "--device", "cpu",
            "data.target=datasets.synthetic.Synthetic", f"data.params.img_size={SIZE}",
            "data.params.n=8", "dataloader.num_workers=0", "train.batch_size=2",
            "train.print_freq=1", "train.n_samples=4", "train.save_freq=2",
            "diffusion.params.respace_type=uniform", "diffusion.params.respace_steps=3",
            *(f"model.params.{k}={v}".replace("False", "false").replace("True", "true")
              for k, v in REDUCED.items())]
    first = train_ddpm.main(base + ["train.n_steps=3", "train.sample_freq=2"])
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["step000001", "step000002"]
    assert len(first["losses"]) == 3 and np.isfinite(first["losses"]).all()
    with Image.open(os.path.join(exp, "samples", "step000001.png")) as im:
        assert im.mode == "RGB" and im.size == (2 * (SIZE + 2) + 2,) * 2
    again = train_ddpm.main(base + ["-r", "latest", "train.n_steps=5", "train.sample_freq=0"])
    assert len(again["losses"]) == 2 and np.isfinite(again["losses"]).all()
    blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000004"))
    assert blob["step"] == 5 and blob["ema"]["num_updates"] == 5
    assert tuple(blob["model"]["mid_attn.q.weight"].shape[:2]) == (512, 512)
    log = "\n".join(open(f).read() for f in glob.glob(os.path.join(exp, "output-*.log")))
    assert "Resumed from" in log and "lr: 0.000020" in log
