"""``python -m dmtpu_torch.scripts.train_sd`` against ``scripts/train_sd.py``.

- The CLI's loss (``make_sd_loss_fn``: latent encode, caption dropout, text
  encode, eps-loss) and the UNet's gradient at one step, against the same
  computation assembled from the JAX wrapper and ``jax.grad`` on the same
  weights, token ids, t, eps, posterior noise and drop mask: 1e-5 relative
  on the loss, 1e-4 relative L2 on the gradient (f32 on both sides, sums in
  another order through the VAE encoder, two CLIP layers and the UNet).
- The CLI end to end on the tiny fixture config, on the CPU: train, save,
  preview, resume (the twin of ``tests/test_train_sd.py``); without
  ``--device cpu`` and without a card it refuses to run.
- Resume equals uninterrupted, bit for bit on the CPU: the train state after
  2 steps, a save, a load into a fresh state and 2 more steps equals 4
  steps straight (the twin of ``tests/test_checkpoint.py``).
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmtpu.diffusions import DDPM as JaxDDPM
from dmtpu.models.stablediffusion.autoencoder import (
    DiagonalGaussianDistribution as JaxPosterior,
)
from dmtpu.utils.config import instantiate_from_config as jax_instantiate
from dmtpu_torch.convert import load_flax_params, state_dict_from_flax
from dmtpu_torch.diffusions import DDPM
from dmtpu_torch.models.stablediffusion import SDUNetModel
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step, step_generator
from dmtpu_torch.scripts import train_sd
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils import optim
from dmtpu_torch.utils.config import instantiate_from_config
from tests._tiny_fixtures import _tiny_sd_model, tiny_sd_train_config
from tests._torch_helpers import TINY_SD_UNET_CFG, char_tokenizer_dir, jax_sd_params, nhwc, t

IMG, TOTAL = 32, 100
DIFFUSION = dict(total_steps=TOTAL, beta_schedule="quad", beta_start=0.00085, beta_end=0.012)


def _draws(step, b, p_uncond):
    """What ``make_sd_loss_fn`` draws from the step's generator, in order."""
    g = step_generator(0, step, torch.device("cpu"))
    noise = torch.randn(b, 4, IMG // 8, IMG // 8, generator=g)
    drop = torch.rand(b, generator=g) < p_uncond
    ts = torch.randint(0, TOTAL, (b,), generator=g)
    eps = torch.randn(b, 4, IMG // 8, IMG // 8, generator=g)
    return noise.numpy(), drop.numpy(), ts.numpy(), eps.numpy()


def test_sd_loss_and_unet_gradient_match_jax():
    conf = _tiny_sd_model()
    jsd = jax_instantiate(conf)
    params = jax_sd_params(jsd, IMG)
    tsd = instantiate_from_config(conf)
    load_flax_params(tsd.unet, params["unet"])
    load_flax_params(tsd.vae, params["vae"])
    load_flax_params(tsd.text_encoder.model, params["text_encoder"])
    for frozen in (tsd.vae, tsd.text_encoder):
        frozen.requires_grad_(False).eval()

    rs = np.random.RandomState(0)
    b, p_uncond = 4, 0.5
    images = rs.uniform(-1, 1, (b, 3, IMG, IMG)).astype(np.float32)
    ids = rs.randint(0, 256, (b, 16))
    empty = rs.randint(0, 256, (1, 16))
    # a step whose mask drops some captions and keeps others
    step = next(s for s in range(100) if 0 < _draws(s, b, p_uncond)[1].sum() < b)
    noise, drop, ts, eps = _draws(step, b, p_uncond)

    loss_fn = train_sd.make_sd_loss_fn(tsd, DDPM(**DIFFUSION), torch.from_numpy(empty), p_uncond,
                                       TOTAL)
    loss = loss_fn({"image": t(images), "input_ids": torch.from_numpy(ids)},
                   step_generator(0, step, torch.device("cpu")))
    loss.backward()
    grads = {n: p.grad for n, p in tsd.unet.named_parameters()}
    assert all(p.grad is None for m in (tsd.vae, tsd.text_encoder) for p in m.parameters())

    moments = jax.jit(lambda p, x: jsd.vae.apply(p, x, method=jsd.vae.encode_moments))(
        params["vae"], jnp.asarray(nhwc(images)))
    post = JaxPosterior(moments)
    z0 = jsd.scale_factor * (post.mean + post.std * jnp.asarray(nhwc(noise)))
    ctx = jax.jit(jsd.text_encoder_encode_tokens)(
        params, jnp.asarray(np.where(drop[:, None], empty, ids)))
    jdiffuser = JaxDDPM(**DIFFUSION)

    def jloss(unet_params):
        return jdiffuser.loss_func(lambda xt, tt: jsd.unet.apply(unet_params, xt, tt, ctx), z0,
                                   jnp.asarray(ts), eps=jnp.asarray(nhwc(eps)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params["unet"])
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = state_dict_from_flax(jax.device_get(want_grads))
    assert sorted(want) == sorted(grads)
    diff = sum(float((grads[n] - want[n]).square().sum()) for n in want)
    norm = sum(float(w.square().sum()) for w in want.values())
    assert norm > 0 and (diff / norm) ** 0.5 <= 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_sd")
    return d, tiny_sd_train_config(d / "conf.yaml", char_tokenizer_dir(d / "tokenizer"))


def test_train_sd_end_to_end_and_resume(setup):
    d, cfg = setup
    exp = str(d / "exp")
    first = train_sd.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu"])
    ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
    assert ckpts == ["step000001", "step000002"], ckpts
    assert os.listdir(os.path.join(exp, "ckpt", "step000002")) == ["state.pt"]
    assert glob.glob(os.path.join(exp, "samples", "*.png"))
    assert glob.glob(os.path.join(exp, "tensorboard", "events.out.tfevents.*"))
    text = open(glob.glob(os.path.join(exp, "output-*.log"))[0]).read()
    assert "End of training" in text and "RANDOM-INIT" in text
    assert text.count("[Train] step:") == 3 and "imgs_per_sec" in text and "grad_norm" in text
    assert len(first["losses"]) == 3 and all(np.isfinite(first["losses"]))
    assert len(first["save_seconds"]) == 2 and len(first["step_seconds"]) == 2

    # the checkpoint: the UNet, adafactor's state, the bf16 EMA and the step
    blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000002"))
    assert blob["step"] == 3 and blob["ema"]["num_updates"] == 3
    assert all(s.dtype == torch.bfloat16 for s in blob["ema"]["shadow"].values())
    assert "input_blocks.0.0.weight" in blob["model"] and "vae" not in str(list(blob["model"]))

    again = train_sd.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu", "-r", "latest",
                           "train.n_steps=5"])
    assert "step000004" in os.listdir(os.path.join(exp, "ckpt"))
    text = "\n".join(open(f).read() for f in glob.glob(os.path.join(exp, "output-*.log")))
    assert "Resumed from" in text and again["load_seconds"] is not None
    assert ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000004"))["step"] == 5

    with pytest.raises(SystemExit, match="unrecognized arguments"):
        train_sd.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu", "train.n_steps", "5"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="train_sd: no CUDA device; pass --device cpu"):
            train_sd.main(["-c", cfg, "-e", str(d / "other"), "-ni"])
        assert not os.path.exists(d / "other")


@pytest.mark.parametrize("overrides,key,group", [
    (["train.optim.target=dmtpu.utils.optim.adamw", "train.optim.params.mu_dtype=bfloat16"],
     "exp_avg", {"mu_dtype": torch.bfloat16, "weight_decay": 0.01}),
    (["train.optim.params.momentum=0.9", "train.optim.params.multiply_by_parameter_scale=true"],
     "momentum", {"momentum": 0.9, "multiply_by_parameter_scale": True}),
])
def test_train_sd_takes_the_optimizer_options(setup, overrides, key, group):
    """A config's ``mu_dtype`` (adamw) and ``momentum`` / parameter scaling
    (adafactor) reach the optimizer: one step, a checkpoint whose state
    holds the option's bf16 tensor for every UNet parameter."""
    d, cfg = setup
    exp = str(d / f"exp_{key}")
    out = train_sd.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu", "train.n_steps=1",
                         "train.sample_freq=0", *overrides])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    (ckpt,) = glob.glob(os.path.join(exp, "ckpt", "step*"))
    blob = ckpt_lib.load_checkpoint_host(ckpt)
    state = blob["optimizer"]["state"]
    assert len(state) == len(blob["model"]) > 0
    assert all(entry[key].dtype == torch.bfloat16 for entry in state.values())
    (saved,) = blob["optimizer"]["param_groups"]
    assert {k: saved[k] for k in group} == group


def test_resume_equals_uninterrupted(tmp_path):
    rs = np.random.RandomState(4)
    batches = [{"image": t(rs.randn(2, 4, 8, 8).astype(np.float32)),
                "context": t(rs.randn(2, 7, 24).astype(np.float32))} for _ in range(4)]
    diffuser = DDPM(**DIFFUSION)

    def fresh(seed):
        torch.manual_seed(seed)
        model = SDUNetModel(**TINY_SD_UNET_CFG)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape))
        state = TrainState.create(model, optim.adafactor(model.parameters(), lr=1e-3),
                                  ema_decay=0.99, ema_dtype="bfloat16")
        return state, make_train_step(make_diffusion_loss_fn(diffuser, model, TOTAL),
                                      clip_grad_norm=1.0, seed=2)

    straight, step = fresh(0)
    for i in range(4):
        step(straight, batches[i])
    part, step = fresh(0)
    for i in range(2):
        step(part, batches[i])
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), 1, part)
    assert path.endswith("step000001")
    resumed, step = fresh(7)  # other weights, as after a restart with another init
    ckpt_lib.load_checkpoint(path, resumed)
    assert resumed.step == 2 and resumed.ema.num_updates == 2
    for i in range(2, 4):
        step(resumed, batches[i])

    assert resumed.step == straight.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(straight.ema.shadow[k], resumed.ema.shadow[k]) for k in a)
    assert straight.ema.num_updates == resumed.ema.num_updates == 4
    sa, sb = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for key, v in sa[k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[k][key])), (k, key)
    moved = straight.model.state_dict()
    start, _ = fresh(0)
    assert any(not torch.equal(moved[k], v) for k, v in start.model.state_dict().items())
    with pytest.raises(ValueError, match="EMA"):
        no_ema = TrainState.create(start.model, optim.adafactor(start.model.parameters()),
                                   ema_decay=None)
        ckpt_lib.load_checkpoint(path, no_ema)
