"""``python -m dmtpu_torch.scripts.train_ddpm_cfg`` against ``scripts/train_ddpm_cfg.py``.

- The CLI end to end on the CPU from a tiny DiT config (depth 2, hidden 64,
  4 heads, ``Synthetic`` 8x8x4 latents of 5 classes): train, save, sample,
  log, resume; the same for MDTv2; without ``--device cpu`` and without a
  card it refuses to run; a stray non-``key=value`` token raises.
- The pixel-space ``UNetCategorialAdaGN`` (dim 32, 8x8x3 images of 5
  classes) trains through the CLI, and its loss at fixed t, eps and labels
  (one of them the null class) is the JAX CLI's: ``DDPMCFG.loss_func`` over
  the model called with ``train=True`` (dropout 0), on the same params
  through the bridge, to 1e-5 relative (f32 sums in other orders).
- ``train.micro_batch`` reaches the train step as its number of splits.
- The sample grid is the file the JAX package's ``save_image_grid`` writes
  for the same 4-channel array: an RGBA PNG, one row a class.
- The eval sampler is the JAX CLI's: DDPMCFG at guidance 1.0, uniformly
  respaced to ``total_steps // 20``, the same tape.
- Resume equals uninterrupted, bit for bit on the CPU: DiT with label
  dropout, adafactor and a bf16 EMA, 2 steps, a save, a load into a fresh
  state and 2 more steps equal 4 steps straight (the twin of
  ``tests/test_torch_train_sd.py::test_resume_equals_uninterrupted``).
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dmtpu.diffusions import DDPMCFG as JaxDDPMCFG
from dmtpu.models.unet_categorial_adagn import UNetCategorialAdaGN as JaxAdaGN
from dmtpu.utils.image import save_image_grid as jax_save_image_grid
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.diffusions import DDPM, DDPMCFG
from dmtpu_torch.models.dit import DiT
from dmtpu_torch.models.mdt import MDTv2
from dmtpu_torch.models.unet_categorial_adagn import UNetCategorialAdaGN
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
from dmtpu_torch.scripts import train_ddpm_cfg
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils import optim
from dmtpu_torch.utils.config import Config
from dmtpu_torch.utils.image import save_image_grid
from tests._torch_helpers import jax_random_params, nhwc, t

CLASSES, SIZE = 5, 8
DIT = {"target": "models.dit.model.DiT",
       "params": dict(input_size=SIZE, patch_size=2, in_channels=4, hidden_size=64, depth=2,
                      num_heads=4, num_classes=CLASSES, learn_sigma=False)}
MDT = {"target": "models.mdt.model.MDTv2",
       "params": dict(input_size=SIZE, patch_size=2, in_channels=4, hidden_size=32, depth=6,
                      num_heads=4, num_classes=CLASSES, decode_layer=2, learn_sigma=False)}
ADAGN = {"target": "models.unet_categorial_adagn.UNetCategorialAdaGN",
         "params": dict(in_channels=3, out_channels=3, dim=32, dim_mults=[1, 2],
                        use_attn=[False, True], num_res_blocks=1, num_classes=CLASSES,
                        attn_head_dims=32, dropout=0.1)}


def _conf(model=DIT, **train):
    return {
        "seed": 3,
        "data": {"target": "datasets.synthetic.Synthetic",
                 "params": {"img_size": SIZE, "channels": 4, "n": 16, "num_classes": CLASSES,
                            "seed": 1},
                 "img_channels": 4, "num_classes": CLASSES},
        "dataloader": {"num_workers": 2},
        "model": model,
        "diffusion": {"target": "diffusions.ddpm.DDPM",
                      "params": {"total_steps": 100, "beta_schedule": "linear",
                                 "beta_start": 0.0001, "beta_end": 0.02,
                                 "objective": "pred_eps", "var_type": "fixed_large"}},
        "train": dict({"n_steps": 4, "batch_size": 4, "micro_batch": 0, "clip_grad_norm": 1.0,
                       "ema_decay": 0.9999, "ema_gradual": True, "ema_dtype": "bfloat16",
                       "print_freq": 1, "save_freq": 2, "sample_freq": 3,
                       "n_samples_each_class": 2, "p_uncond": 0.1,
                       "optim": {"target": "dmtpu.utils.optim.adafactor",
                                 "params": {"lr": 1e-4}}}, **train),
    }


def _write(path, conf) -> str:
    path.write_text(yaml.safe_dump(conf))
    return str(path)


def _log(exp) -> str:
    return "\n".join(open(f).read() for f in sorted(glob.glob(os.path.join(exp, "output-*.log"))))


def test_train_ddpm_cfg_end_to_end_and_resume(tmp_path):
    cfg = _write(tmp_path / "dit.yaml", _conf())
    exp = str(tmp_path / "exp")
    first = train_ddpm_cfg.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["step000001", "step000003"]
    assert os.listdir(os.path.join(exp, "ckpt", "step000003")) == ["state.pt"]
    assert glob.glob(os.path.join(exp, "tensorboard", "events.out.tfevents.*"))
    text = _log(exp)
    assert "End of training" in text and "Model parameters" in text
    assert text.count("[Train] step:") == 4 and "grad_norm" in text and "lr: 0.000100" in text
    assert len(first["losses"]) == 4 and all(np.isfinite(first["losses"]))
    assert len(first["save_seconds"]) == 2 and len(first["step_seconds"]) == 3
    # the eval grid after step 2: min(10, 5) classes x 2 samples of 8x8x4
    # latents, one row a class, written as RGBA
    with Image.open(os.path.join(exp, "samples", "step000002.png")) as im:
        assert im.mode == "RGBA" and im.size == (2 * (SIZE + 2) + 2, CLASSES * (SIZE + 2) + 2)

    # the checkpoint: DiT's parameters, adafactor's state, the bf16 EMA, the step
    blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000003"))
    assert blob["step"] == 4 and blob["ema"]["num_updates"] == 4
    assert all(s.dtype == torch.bfloat16 for s in blob["ema"]["shadow"].values())
    assert "blocks.1.attn.qkv.weight" in blob["model"] and "pos_embed" not in blob["model"]

    again = train_ddpm_cfg.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu", "-r", "latest",
                                 "train.n_steps=6"])
    assert "step000005" in os.listdir(os.path.join(exp, "ckpt"))
    assert "Resumed from" in _log(exp) and again["load_seconds"] is not None
    assert len(again["losses"]) == 2
    resumed = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000005"))
    assert resumed["step"] == 6 and resumed["ema"]["num_updates"] == 6
    assert any(not torch.equal(resumed["model"][k], v) for k, v in blob["model"].items())

    with pytest.raises(SystemExit, match="unrecognized arguments"):
        train_ddpm_cfg.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu", "train.n_steps",
                             "5"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="train_ddpm_cfg: no CUDA device; pass --device cpu"):
            train_ddpm_cfg.main(["-c", cfg, "-e", str(tmp_path / "other"), "-ni"])
        assert not os.path.exists(tmp_path / "other")


def test_mdt_trains_from_a_config(tmp_path):
    """MDTv2 trains unmasked, as the JAX CLI trains it; no EMA here, so the
    grid samples the trained weights."""
    cfg = _write(tmp_path / "mdt.yaml", _conf(MDT, n_steps=2, save_freq=5, sample_freq=2,
                                              ema_decay=None, n_samples_each_class=1))
    exp = str(tmp_path / "exp")
    got = train_ddpm_cfg.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu"])
    assert len(got["losses"]) == 2 and all(np.isfinite(got["losses"]))
    assert os.listdir(os.path.join(exp, "ckpt")) == ["step000001"]
    blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000001"))
    assert blob["ema"] is None and "sideblocks.0.attn.qkv.weight" in blob["model"]
    assert os.path.isfile(os.path.join(exp, "samples", "step000001.png"))


def test_micro_batch_reaches_the_train_step(tmp_path, monkeypatch):
    seen = []
    real = train_ddpm_cfg.make_train_step

    def recording(loss_fn, **kw):
        seen.append(kw["micro_batches"])
        return real(loss_fn, **kw)

    monkeypatch.setattr(train_ddpm_cfg, "make_train_step", recording)
    cfg = _write(tmp_path / "dit.yaml", _conf(n_steps=1, sample_freq=0))
    got = train_ddpm_cfg.main(["-c", cfg, "-e", str(tmp_path / "exp"), "-ni", "--device", "cpu",
                               "train.micro_batch=2"])
    assert seen == [2] and np.isfinite(got["losses"]).all()


def test_build_model_is_seeded_and_names_the_unported_models():
    conf = Config(_conf())
    a, b = (train_ddpm_cfg.build_model(conf, torch.device("cpu"), seed=5) for _ in range(2))
    c = train_ddpm_cfg.build_model(conf, torch.device("cpu"), seed=6)
    assert isinstance(a, DiT)
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
    assert not torch.equal(a.blocks[0].attn.qkv.weight, c.blocks[0].attn.qkv.weight)
    state = torch.random.get_rng_state()
    train_ddpm_cfg.build_model(conf, torch.device("cpu"), seed=7)
    assert torch.equal(torch.random.get_rng_state(), state)  # the caller's stream is kept
    assert isinstance(train_ddpm_cfg.build_model(Config(_conf(MDT)), torch.device("cpu"), 5),
                      MDTv2)
    # the pixel-space UNets are built as well (refused before they trained)
    assert isinstance(train_ddpm_cfg.build_model(Config(_conf(ADAGN)), torch.device("cpu"), 5),
                      UNetCategorialAdaGN)


def _pixel_conf(**train) -> dict:
    conf = _conf(ADAGN, **train)
    conf["data"]["params"]["channels"] = conf["data"]["img_channels"] = 3
    return conf


def test_the_adagn_target_trains_and_its_loss_is_the_jax_cli_s(tmp_path):
    cfg = _write(tmp_path / "adagn.yaml", _pixel_conf(n_steps=2, save_freq=5, sample_freq=2,
                                                      n_samples_each_class=1, ema_dtype=None))
    exp = str(tmp_path / "exp")
    got = train_ddpm_cfg.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu"])
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    assert os.listdir(os.path.join(exp, "ckpt")) == ["step000001"]
    with Image.open(os.path.join(exp, "samples", "step000001.png")) as im:
        assert im.mode == "RGB" and im.size == (SIZE + 4, CLASSES * (SIZE + 2) + 2)

    conf = Config(_pixel_conf())
    conf.model.params.dropout = 0.0
    model = train_ddpm_cfg.build_model(conf, torch.device("cpu"), 5)
    jmod = JaxAdaGN(**conf.model.params.to_dict())
    zeros = jnp.zeros((1,), jnp.int32)
    params = jax_random_params(jmod, jnp.zeros((1, SIZE, SIZE, 3)), zeros, zeros, seed=6)
    load_flax_params(model, params)
    rs = np.random.RandomState(7)
    x0, eps = rs.randn(2, 4, 3, SIZE, SIZE).astype(np.float32)
    ts, y = np.array([3, 25, 61, 99]), np.array([1, CLASSES, 4, CLASSES])
    kw = conf.diffusion.params.to_dict()
    want = JaxDDPMCFG(guidance_scale=1.0, **kw).loss_func(
        lambda xt, tt, y: jmod.apply(params, xt, tt, y, train=True), jnp.asarray(nhwc(x0)),
        jnp.asarray(ts), eps=jnp.asarray(nhwc(eps)), model_kwargs={"y": jnp.asarray(y)})
    loss = DDPMCFG(guidance_scale=1.0, **kw).loss_func(
        lambda xt, tt, y: model(xt, tt, y, train=True), t(x0), t(ts), eps=t(eps),
        model_kwargs={"y": t(y)})
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)


def test_grid_is_the_jax_package_s_file(tmp_path):
    images = np.random.RandomState(0).uniform(-1.2, 1.2, (6, SIZE, SIZE, 4)).astype(np.float32)
    save_image_grid(np.clip(images, -1, 1), str(tmp_path / "port.png"), nrow=2)
    jax_save_image_grid(np.clip(images, -1, 1), str(tmp_path / "jax.png"), nrow=2)
    with Image.open(tmp_path / "port.png") as a, Image.open(tmp_path / "jax.png") as b:
        assert a.mode == b.mode == "RGBA" and a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_eval_sampler_is_the_jax_cli_s():
    conf = Config(_conf())
    got = train_ddpm_cfg.eval_sampler(conf)
    want = JaxDDPMCFG(guidance_scale=1.0,
                      **{**conf.diffusion.params.to_dict(), "respace_type": "uniform",
                         "respace_steps": conf.diffusion.params.total_steps // 20})
    assert got.guidance_scale == want.guidance_scale == 1.0 and got.cond_kwarg == "y"
    np.testing.assert_array_equal(np.asarray(got.respaced_seq), np.asarray(want.respaced_seq))
    assert len(got.respaced_seq) in (5, 6)
    for key, value in got.pair_tape(np.asarray(got.respaced_seq)[1:],
                                    np.asarray(got.respaced_seq)[:-1]).items():
        np.testing.assert_array_equal(
            value, np.asarray(want.pair_tape(np.asarray(want.respaced_seq)[1:],
                                             np.asarray(want.respaced_seq)[:-1])[key]), key)


def test_resume_equals_uninterrupted(tmp_path):
    rs = np.random.RandomState(4)
    batches = [(torch.from_numpy(rs.randn(4, 4, SIZE, SIZE).astype(np.float32)),
                torch.from_numpy(rs.randint(0, CLASSES, 4))) for _ in range(4)]
    diffuser = DDPM(total_steps=100)

    def fresh(seed):
        torch.manual_seed(seed)
        model = DiT(**DIT["params"])
        with torch.no_grad():  # adaLN-Zero would leave most gradients at zero
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape))
        state = TrainState.create(model, optim.adafactor(model.parameters(), lr=1e-3),
                                  ema_decay=0.99, ema_dtype="bfloat16")
        loss_fn = make_diffusion_loss_fn(
            diffuser, lambda x, t, **kw: model(x, t, train=True, **kw), 100, p_uncond=0.5,
            null_label=CLASSES)
        return state, make_train_step(loss_fn, clip_grad_norm=1.0, seed=2)

    straight, step = fresh(0)
    for i in range(4):
        step(straight, batches[i])
    part, step = fresh(0)
    for i in range(2):
        step(part, batches[i])
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), 1, part)
    resumed, step = fresh(7)  # other weights, as after a restart with another init
    ckpt_lib.load_checkpoint(path, resumed)
    assert resumed.step == 2 and resumed.ema.num_updates == 2
    for i in range(2, 4):
        step(resumed, batches[i])

    assert resumed.step == straight.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(straight.ema.shadow[k], resumed.ema.shadow[k])
               for k in straight.ema.shadow)
    sa, sb = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for key, v in sa[k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[k][key])), (k, key)
    start, _ = fresh(0)
    assert any(not torch.equal(a[k], v) for k, v in start.model.state_dict().items())
