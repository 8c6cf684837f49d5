"""``python -m dmtpu_torch.scripts.train_mmdit`` against ``scripts/train_mmdit.py``.

- The CLI end to end on the CPU from the JAX CLI test's tiny config
  (``tests/test_mmdit.py::test_train_mmdit_cli``: MMDiT depth 2, hidden 32,
  ``SyntheticEmbedded`` 8x8x3 images, two micro-batches of 4, adam, an EMA):
  the same sample and checkpoint paths, a log with the parameter count, a
  resume; without ``--device cpu`` and without a card it refuses to run.
- ``configs/mmdit_flow_synthetic.yaml`` itself, cut to 3 steps.
- A dataset of other items and a diffusion outside the flow family are
  refused with the JAX CLI's messages.
- ``train.micro_batch`` reaches the train step as its number of splits.
- The eval sampler is the JAX CLI's: ``FlowMatchingCFG`` at
  ``train.sample_guidance_scale`` with the config's CFG keys dropped, and its
  samples from the same weights, conditioning and noise equal the JAX CLI's
  ``sample_fn``'s to 1e-5 relative L2 (f32: sums in other orders).
- Resume equals uninterrupted, bit for bit on the CPU: MMDiT with bf16
  parameter storage, its conditioning dropout, adafactor and a bf16 EMA, 2
  steps, a save, a load into a fresh state and 2 more steps equal 4 steps
  straight; the dropout masks are a function of seed and step.
- Both MMDiT configs instantiate through the registry (SD3-medium on the meta
  device, with ``param_dtype=bfloat16``: its 2.03e9 parameters take 4.06 GB).
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmtpu.diffusions import FlowMatchingCFG as JaxFlowMatchingCFG
from dmtpu.models import mmdit as jmmdit
from dmtpu_torch.convert import load_flax_params
from dmtpu_torch.data.captioned import SyntheticEmbedded
from dmtpu_torch.diffusions import FlowMatching
from dmtpu_torch.models.mmdit import MMDiT
from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
from dmtpu_torch.scripts import train_mmdit
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils import optim
from dmtpu_torch.utils.config import Config, instantiate_from_config, load_config
from tests._torch_helpers import jax_random_params, nhwc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(input_size=8, patch_size=2, in_channels=3, hidden_size=32, depth=2, num_heads=2,
             context_dim=8, pooled_dim=8)


def _conf(**train):
    """The JAX CLI test's config."""
    return {
        "seed": 0,
        "data": {"target": "dmtpu.data.captioned.SyntheticEmbedded",
                 "params": {"img_size": 8, "channels": 3, "n": 32, "context_len": 4,
                            "context_dim": 8, "pooled_dim": 8, "n_classes": 2},
                 "img_channels": 3},
        "dataloader": {"num_workers": 0},
        "model": {"target": "models.mmdit.MMDiT", "params": dict(MODEL)},
        "diffusion": {"target": "diffusions.flow.FlowMatching",
                      "params": {"total_steps": 1000, "respace_steps": 4}},
        "train": dict({"n_steps": 6, "batch_size": 8, "micro_batch": 4, "clip_grad_norm": 1.0,
                       "ema_decay": 0.99, "print_freq": 2, "save_freq": 5, "sample_freq": 5,
                       "n_samples": 2,
                       "optim": {"target": "torch.optim.Adam", "params": {"lr": 0.001}}},
                      **train),
    }


def _write(path, conf) -> str:
    path.write_text(yaml.safe_dump(conf))
    return str(path)


def _log(exp) -> str:
    return "\n".join(open(f).read() for f in sorted(glob.glob(os.path.join(exp, "output-*.log"))))


def test_train_mmdit_end_to_end_and_resume(tmp_path):
    cfg = _write(tmp_path / "mmdit.yaml", _conf())
    exp = str(tmp_path / "exp")
    first = train_mmdit.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu"])
    # the JAX CLI test's paths: check_freq fires at step 4, the final save adds step 5
    assert os.path.isfile(os.path.join(exp, "samples", "step000004.png"))
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == ["step000004", "step000005"]
    text = _log(exp)
    assert "Model parameters: 0.08M" in text and "End of training" in text
    assert len(first["losses"]) == 6 and all(np.isfinite(first["losses"]))
    blob = ckpt_lib.load_checkpoint_host(os.path.join(exp, "ckpt", "step000005"))
    assert blob["step"] == 6 and blob["ema"]["num_updates"] == 6
    assert "joint_blocks.1.context_block.attn.qkv.weight" in blob["model"]

    again = train_mmdit.main(["-c", cfg, "-e", exp, "-ni", "--device", "cpu", "-r", "latest",
                              "train.n_steps=8"])
    assert "Resumed from" in _log(exp) and again["load_seconds"] is not None
    assert len(again["losses"]) == 2 and "step000007" in os.listdir(os.path.join(exp, "ckpt"))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="train_mmdit: no CUDA device; pass --device cpu"):
            train_mmdit.main(["-c", cfg, "-e", str(tmp_path / "other"), "-ni"])
        assert not os.path.exists(tmp_path / "other")


def test_the_synthetic_config_trains(tmp_path):
    exp = str(tmp_path / "exp")
    got = train_mmdit.main(["-c", os.path.join(REPO, "configs", "mmdit_flow_synthetic.yaml"),
                            "-e", exp, "-ni", "--device", "cpu", "train.n_steps=3",
                            "train.sample_freq=3", "train.batch_size=8",
                            "dataloader.num_workers=0"])
    assert len(got["losses"]) == 3 and all(np.isfinite(got["losses"]))
    assert os.listdir(os.path.join(exp, "samples")) == ["step000002.png"]


@pytest.mark.parametrize("block,value,message", [
    ("data", {"target": "datasets.synthetic.Synthetic",
              "params": {"img_size": 8, "channels": 3, "n": 16, "num_classes": 2}},
     "train_mmdit needs dataset items {'image','context','pooled'} (precomputed text "
     "embeddings), got <class 'tuple'>"),
    ("diffusion", {"target": "diffusions.ddpm.DDPM", "params": {"total_steps": 100}},
     "train_mmdit trains the flow-matching objective; got diffusion.target=diffusions.ddpm.DDPM")],
    ids=["dataset", "diffusion"])
def test_wrong_items_or_diffusion_are_refused(tmp_path, block, value, message):
    conf = _conf()
    conf[block] = value
    with pytest.raises(ValueError) as e:
        train_mmdit.main(["-c", _write(tmp_path / "bad.yaml", conf), "-e", str(tmp_path / "exp"),
                          "-ni", "--device", "cpu"])
    assert str(e.value) == message


def test_micro_batch_reaches_the_train_step(tmp_path, monkeypatch):
    seen = []
    real = train_mmdit.make_train_step

    def recording(loss_fn, **kw):
        seen.append(kw["micro_batches"])
        return real(loss_fn, **kw)

    monkeypatch.setattr(train_mmdit, "make_train_step", recording)
    cfg = _write(tmp_path / "mmdit.yaml", _conf(n_steps=1, sample_freq=0))
    got = train_mmdit.main(["-c", cfg, "-e", str(tmp_path / "exp"), "-ni", "--device", "cpu",
                            "train.micro_batch=2"])
    assert seen == [4] and np.isfinite(got["losses"]).all()


def test_eval_sampler_and_samples_are_the_jax_cli_s():
    conf = Config(_conf(sample_guidance_scale=3.0))
    conf.diffusion.params.update(guidance_scale=7.0, cond_kwarg="x", solver="heun")
    sampler = train_mmdit.eval_sampler(conf)
    assert (sampler.guidance_scale, sampler.cond_kwarg, sampler.solver) == (3.0, "y", "heun")
    del conf.train["sample_guidance_scale"]
    assert train_mmdit.eval_sampler(conf).guidance_scale == 7.0

    jmod = jmmdit.MMDiT(**MODEL)
    y0 = {"context": jnp.zeros((1, 4, 8)), "pooled": jnp.zeros((1, 8))}
    params = jax_random_params(jmod, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)), y0, seed=4)
    data = SyntheticEmbedded(**conf.data.params.to_dict())
    eval_y = train_mmdit.eval_conditioning(data, 2, torch.device("cpu"))
    noise = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    # the JAX CLI's sample_fn
    diff = {k: v for k, v in conf.diffusion.params.to_dict().items()
            if k not in ("guidance_scale", "cond_kwarg", "guidance_interval")}
    jsampler = JaxFlowMatchingCFG(guidance_scale=7.0, cond_kwarg="y", **diff)
    jy = {k: jnp.asarray(v.numpy()) for k, v in eval_y.items()}
    want = np.clip(np.asarray(jsampler.sample(
        lambda x, t, y=None, **kw: jmod.apply(params, x, t, y), jnp.asarray(nhwc(noise)), None,
        uncond_conditioning=jax.tree.map(jnp.zeros_like, jy), model_kwargs={"y": jy})), -1, 1)
    model = load_flax_params(MMDiT(**MODEL), params).eval()
    got = train_mmdit.eval_samples(model, dict(model.named_parameters()),
                                   train_mmdit.eval_sampler(conf), eval_y, torch.from_numpy(noise))
    got = nhwc(got.numpy())
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want) and 0 < np.abs(got).max()


def test_resume_equals_uninterrupted(tmp_path):
    data = SyntheticEmbedded(img_size=8, channels=3, n=16, context_len=4, context_dim=8,
                             pooled_dim=8)
    batches = [train_mmdit.embedded_batch(
        {k: np.stack([data[i][k] for i in range(4 * j, 4 * j + 4)]) for k in data[0]},
        torch.device("cpu")) for j in range(4)]

    def fresh(seed):
        torch.manual_seed(seed)
        model = MMDiT(**MODEL, cond_dropout_prob=0.5, dtype="bfloat16",
                      param_dtype="bfloat16")
        with torch.no_grad():  # adaLN-Zero would leave most gradients at zero
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape))
        state = TrainState.create(model, optim.adafactor(model.parameters(), lr=1e-3),
                                  ema_decay=0.99, ema_dtype="bfloat16")
        loss_fn = make_diffusion_loss_fn(FlowMatching(), train_apply_recording(model), 1000)
        return state, make_train_step(loss_fn, clip_grad_norm=1.0, seed=2)

    masks = []

    def train_apply_recording(model):
        apply = train_mmdit.train_apply(model)

        def recorded(x, t, **kw):
            seen = []
            hook = model.context_embedder.register_forward_hook(
                lambda m, inp, out: seen.append(inp[0].abs().sum((1, 2)) == 0))
            try:
                return apply(x, t, **kw)
            finally:
                hook.remove()
                masks.append(seen[0].tolist())

        return recorded

    straight, step = fresh(0)
    for i in range(4):
        step(straight, batches[i])
    straight_masks, masks[:] = list(masks), []
    part, step = fresh(0)
    for i in range(2):
        step(part, batches[i])
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), 1, part)
    resumed, step = fresh(7)  # other weights, as after a restart with another init
    ckpt_lib.load_checkpoint(path, resumed)
    assert resumed.step == 2 and resumed.ema.num_updates == 2
    for i in range(2, 4):
        step(resumed, batches[i])

    # the dropout masks are a function of (seed, step): the same in both runs
    assert masks == straight_masks and any(any(m) for m in masks) and \
        not all(all(m) for m in masks)
    assert resumed.step == straight.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {p.dtype for p in straight.model.parameters()} == {torch.bfloat16, torch.float32}
    assert all(torch.equal(straight.ema.shadow[k], resumed.ema.shadow[k])
               for k in straight.ema.shadow)
    sa, sb = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for key, v in sa[k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[k][key])), (k, key)


def test_both_mmdit_configs_instantiate_through_the_registry():
    small = load_config(os.path.join(REPO, "configs", "mmdit_flow_synthetic.yaml"))
    assert isinstance(instantiate_from_config(small.model), MMDiT)
    assert isinstance(instantiate_from_config(small.diffusion), FlowMatching)
    assert isinstance(instantiate_from_config(small.data)[0], dict)
    sd3 = load_config(os.path.join(REPO, "configs", "sd3_medium.yaml"))
    model = instantiate_from_config(sd3.model, param_dtype="bfloat16", dtype="bfloat16",
                                    device="meta")
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert 2.0e9 < n < 2.1e9 and 4.0e9 < nbytes < 4.2e9
    assert isinstance(instantiate_from_config(sd3.diffusion), FlowMatching)
    assert sd3.train.optim.target == "dmtpu.utils.optim.adafactor"
    assert isinstance(instantiate_from_config(sd3.train.optim, params=[torch.zeros(2)]),
                      optim.Adafactor)
