"""``python -m dmtpu_torch.scripts.train_ddpm`` against ``scripts/train_ddpm.py``, on the CPU.

- The CLI end to end from a copy of ``configs/ddpm_synthetic.yaml`` cut to
  8x8 images (``Synthetic``, 16 of them, batch 4): train, save, sample the
  EMA weights into one grid with the config's own diffuser, log, resume
  with ``-r latest``; a stray non-``key=value`` token raises; without
  ``--device cpu`` and without a card it exits before anything is written.
- ``configs/flow_synthetic.yaml`` (``FlowMatching`` over the same UNet) and
  a ``diffusion.target=diffusions.ddpm_ip.DDPM_IP`` override train through
  the same CLI, the diffuser reaching the loss as the config names it.
- Every pixel model the JAX CLI trains takes a step: the repo's ``UNet``
  and ``UNetCategorialAdaGN``, the ADM ``UNetModel`` and ``PesserUNet``.
- ``--profile DIR`` writes a ``torch.profiler`` trace of the window
  ``PROFILE_STEPS`` (set to the run's first two steps here) into DIR.
- Resume equals uninterrupted, bit for bit on the CPU, through the CLI's
  pieces (the model built from the config by ``seeded_instance``, DDPM_IP's
  loss with dropout on, Adam, clipping and the EMA, the checkpoint): 2
  steps, a save, a load into a fresh state and 1 more step equal 3 steps
  straight.  (The CLI's loader restarts its epochs on resume, as the JAX
  CLI's does, so the run itself sees other batches after a resume.)
"""
import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dmtpu_torch.diffusions import DDPM_IP, FlowMatching
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
from dmtpu_torch.scripts import _common, train_ddpm
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils import optim
from dmtpu_torch.utils.config import Config, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
TINY = ["data.params.img_size=8", "data.params.n=16", "dataloader.num_workers=2",
        "train.batch_size=4", "train.print_freq=1", "train.n_samples=4"]


def _config(name: str) -> str:
    return os.path.join(ROOT, "configs", name)


def _log(exp) -> str:
    return "\n".join(open(f).read() for f in sorted(glob.glob(os.path.join(exp, "output-*.log"))))


def _run(tmp_path, config, *overrides, exp="exp"):
    path = str(tmp_path / exp)
    return path, train_ddpm.main(["-c", config, "-e", path, "-ni", "--device", "cpu", *TINY,
                                  *overrides])


def test_train_ddpm_end_to_end_and_resume(tmp_path):
    exp, first = _run(tmp_path, _config("ddpm_synthetic.yaml"), "train.n_steps=3",
                      "train.save_freq=2", "train.sample_freq=2",
                      "diffusion.params.respace_steps=4")
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["step000001", "step000002"]
    assert glob.glob(os.path.join(exp, "tensorboard", "events.out.tfevents.*"))
    text = _log(exp)
    assert "End of training" in text and "Model parameters: 0.70M" in text
    assert text.count("[Train] step:") == 3 and "grad_norm" in text and "lr: 0.000200" in text
    assert len(first["losses"]) == 3 and all(np.isfinite(first["losses"]))
    assert len(first["save_seconds"]) == 2 and len(first["step_seconds"]) == 2
    # the eval grid after step 2: 4 samples of 8x8x3 in a 2x2 grid
    with Image.open(os.path.join(exp, "samples", "step000001.png")) as im:
        assert im.mode == "RGB" and im.size == (2 * (SIZE + 2) + 2,) * 2
        assert np.asarray(im).std() > 0
    blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000002"))
    assert blob["step"] == 3 and blob["ema"]["num_updates"] == 3
    assert "mid_attn.q.weight" in blob["model"] and "down_1_attn_0.proj.bias" in blob["model"]
    assert set(blob["optimizer"]["state"][0]) >= {"exp_avg", "exp_avg_sq"}

    again = train_ddpm.main(["-c", _config("ddpm_synthetic.yaml"), "-e", exp, "-ni", "--device",
                             "cpu", "-r", "latest", *TINY, "train.n_steps=5",
                             "train.save_freq=2", "train.sample_freq=0"])
    assert "step000004" in os.listdir(os.path.join(exp, "ckpt"))
    assert "Resumed from" in _log(exp) and again["load_seconds"] is not None
    assert len(again["losses"]) == 2
    resumed = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000004"))
    assert resumed["step"] == 5 and resumed["ema"]["num_updates"] == 5
    assert any(not torch.equal(resumed["model"][k], v) for k, v in blob["model"].items())

    with pytest.raises(SystemExit, match="unrecognized arguments"):
        train_ddpm.main(["-c", _config("ddpm_synthetic.yaml"), "-e", exp, "-ni", "--device",
                         "cpu", "train.n_steps", "5"])


def test_without_a_card_cuda_exits_before_anything_is_written(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    with pytest.raises(SystemExit, match="train_ddpm: no CUDA device; pass --device cpu"):
        train_ddpm.main(["-c", _config("ddpm_synthetic.yaml"), "-e", str(tmp_path / "exp"),
                         "-ni"])
    assert not os.path.exists(tmp_path / "exp")


def _recording(monkeypatch):
    seen = []
    real = train_ddpm.make_diffusion_loss_fn

    def recording(diffuser, *args, **kwargs):
        seen.append(diffuser)
        return real(diffuser, *args, **kwargs)

    monkeypatch.setattr(train_ddpm, "make_diffusion_loss_fn", recording)
    return seen


def test_flow_matching_config_trains(tmp_path, monkeypatch):
    seen = _recording(monkeypatch)
    exp, got = _run(tmp_path, _config("flow_synthetic.yaml"), "train.n_steps=2",
                    "train.save_freq=5", "train.sample_freq=2", "diffusion.params.respace_steps=2")
    assert [type(d) for d in seen] == [FlowMatching]
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    assert os.path.isfile(os.path.join(exp, "samples", "step000001.png"))
    assert os.listdir(os.path.join(exp, "ckpt")) == ["step000001"]


def test_ddpm_ip_override_trains(tmp_path, monkeypatch):
    seen = _recording(monkeypatch)
    _, got = _run(tmp_path, _config("ddpm_synthetic.yaml"), "train.n_steps=2",
                  "train.sample_freq=0", "diffusion.target=diffusions.ddpm_ip.DDPM_IP",
                  "diffusion.params.gamma=0.2")
    assert [type(d) for d in seen] == [DDPM_IP] and seen[0].gamma == 0.2
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()


PIXEL_MODELS = {
    "unet": "model.params.dropout=0.1",
    "adagn": ["model.target=models.unet_categorial_adagn.UNetCategorialAdaGN",
              "model.params={in_channels: 3, out_channels: 3, dim: 32, dim_mults: [1, 2], "
              "use_attn: [false, true], num_res_blocks: 1, attn_head_dims: 32, dropout: 0.1}"],
    "adm": ["model.target=models.adm.unet.UNetModel",
            "model.params={image_size: 8, in_channels: 3, model_channels: 32, out_channels: 3, "
            "num_res_blocks: 1, attention_resolutions: [2], channel_mult: [1, 2], "
            "num_head_channels: 32, dropout: 0.1}"],
    "pesser": ["model.target=models.pesser.model.Model",
               "model.params={ch: 32, out_ch: 3, ch_mult: [1, 2], num_res_blocks: 1, "
               "attn_resolutions: [4], dropout: 0.1, in_channels: 3, resolution: 8}"],
}


@pytest.mark.parametrize("name", list(PIXEL_MODELS))
def test_each_pixel_model_takes_a_step(tmp_path, name):
    overrides = PIXEL_MODELS[name]
    overrides = [overrides] if isinstance(overrides, str) else overrides
    exp, got = _run(tmp_path, _config("ddpm_synthetic.yaml"), "train.n_steps=1",
                    "train.sample_freq=0", *overrides)
    assert len(got["losses"]) == 1 and np.isfinite(got["losses"]).all()
    assert os.listdir(os.path.join(exp, "ckpt")) == ["step000000"]


def test_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(_common, "PROFILE_STEPS", (0, 1))
    trace = tmp_path / "trace"
    exp, got = _run(tmp_path, _config("ddpm_synthetic.yaml"), "train.n_steps=2",
                    "train.sample_freq=0", "--profile", str(trace))
    files = glob.glob(str(trace / "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert "Wrote profiler trace to" in _log(exp) and len(got["losses"]) == 2


def test_resume_equals_uninterrupted(tmp_path):
    conf = load_config(_config("ddpm_synthetic.yaml"))
    model_conf = Config(dict(conf.model.to_dict(), params=dict(conf.model.params.to_dict(),
                                                               dropout=0.1)))
    rs = np.random.RandomState(4)
    batches = [torch.from_numpy(rs.randn(4, 3, SIZE, SIZE).astype(np.float32))
               for _ in range(3)]
    diffuser = DDPM_IP(gamma=0.1, total_steps=100)

    def fresh(seed):
        model = _common.seeded_instance(model_conf, torch.device("cpu"), seed)
        state = TrainState.create(model, optim.adam(model.parameters(), lr=2e-4),
                                  ema_decay=0.999)
        loss_fn = make_diffusion_loss_fn(
            diffuser, lambda x, t, **kw: model(x, t, train=True, **kw), 100)
        return state, make_train_step(loss_fn, clip_grad_norm=1.0, seed=2)

    straight, step = fresh(0)
    for batch in batches:
        step(straight, batch)
    part, step = fresh(0)
    for batch in batches[:2]:
        step(part, batch)
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), 1, part)
    resumed, step = fresh(7)  # other weights, as after a restart with another init
    ckpt_lib.load_checkpoint(path, resumed)
    assert resumed.step == 2 and resumed.ema.num_updates == 2
    step(resumed, batches[2])

    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(straight.ema.shadow[k], resumed.ema.shadow[k])
               for k in straight.ema.shadow)
    sa, sb = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for k in sa:
        for key, v in sa[k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[k][key])), (k, key)
