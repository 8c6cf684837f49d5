"""The training CLI's utilities against dmtpu.utils': misc helpers, the
StatusTracker and its TensorBoard writer (the same bytes, with the clock
fixed), the step timer and ``lr_fn``; and the port's checkpoint layout."""
import json
import logging
import os
import subprocess

import numpy as np
import pytest
import torch

from dmtpu.utils import logger as jlogger
from dmtpu.utils import misc as jmisc
from dmtpu.utils import optim as joptim
from dmtpu.utils import profiling as jprofiling
from dmtpu.utils import tensorboard_writer as jtb
from dmtpu_torch.models.ema import EMAState
from dmtpu_torch.parallel import TrainState
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils import logger as tlogger
from dmtpu_torch.utils import misc as tmisc
from dmtpu_torch.utils import optim as toptim
from dmtpu_torch.utils import profiling as tprofiling
from dmtpu_torch.utils import tensorboard_writer as ttb


def test_misc_helpers_match_jax(tmp_path):
    for freq, step in [(1, 0), (2, 1), (2, 2), (0, 5), (5, 4)]:
        assert tmisc.check_freq(freq, step) == jmisc.check_freq(freq, step)
    with pytest.raises(TypeError):
        tmisc.check_freq(2.0, 1)
    for n, b in [(10, 4), (8, 4), (3, 5)]:
        assert tmisc.amortize(n, b) == jmisc.amortize(n, b)
    assert len(tmisc.get_time_str()) == len(jmisc.get_time_str()) == 19
    gen = tmisc.get_data_generator([1, 2])
    assert [next(gen) for _ in range(5)] == [1, 2, 1, 2, 1]
    meters = tmisc.AverageMeter(), jmisc.AverageMeter()
    for m in meters:
        m.update(2.0, 3)
        m.update(4.0)
    assert vars(meters[0]) == vars(meters[1])

    made = []
    for mod in (tmisc, jmisc):
        exp = tmp_path / mod.__name__
        mod.create_exp_dir(str(exp), "a: 1\n", time_str="T", no_interaction=True)
        (exp / "ckpt" / "step000010").mkdir()
        (exp / "ckpt" / "step000002").mkdir()
        (exp / "ckpt" / "best").mkdir()
        (exp / "ckpt" / "step000099.txt").write_text("not a directory")
        made.append(sorted(str(p.relative_to(exp)) for p in exp.rglob("*")))
        assert mod.find_resume_checkpoint(str(exp), "latest").endswith("step000010")
        assert mod.find_resume_checkpoint(str(exp), "best").endswith("best")
        path = str(exp / "ckpt" / "step000002")
        assert mod.find_resume_checkpoint(str(exp), path) == path
        # an existing directory is replaced without asking under no_interaction
        mod.create_exp_dir(str(exp), "b: 2\n", time_str="U", no_interaction=True)
        assert sorted(os.listdir(exp)) == ["ckpt", "config-U.yaml", "samples"]
    assert made[0] == made[1]
    with pytest.raises(ValueError, match="invalid"):
        tmisc.find_resume_checkpoint(str(tmp_path), "earliest")
    with pytest.raises(ValueError, match="no checkpoints"):
        tmisc.find_resume_checkpoint(str(tmp_path / tmisc.__name__), "latest")


def test_status_tracker_writes_the_jax_writer_s_bytes(tmp_path, monkeypatch):
    clock = iter(np.arange(1000.0, 1100.0, 0.25))
    now = {"t": 0.0}

    def fake_time():
        now["t"] = next(clock)
        return now["t"]

    files, lines = [], []
    for tb, lg, name in ((jtb, jlogger, "jax"), (ttb, tlogger, "torch")):
        clock = iter(np.arange(1000.0, 1100.0, 0.25))
        monkeypatch.setattr(tb.time, "time", fake_time)
        logger = logging.getLogger(f"tracker-{name}")
        seen = []
        handler = logging.Handler()
        handler.emit = lambda record, seen=seen: seen.append(record.getMessage())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        tracker = lg.StatusTracker(logger, str(tmp_path / name), print_freq=2)
        for step in range(4):
            tracker.track_status("Train", {"loss": 1.0 / (step + 1), "grad_norm": np.float32(0.5),
                                           "lr": 1e-4, "imgs_per_sec": 12.5 * step}, step)
        tracker.track_status("Eval", {"fid": 3.0, "skip": 1.0}, 4, write_tb=[True, False])
        tracker.close()
        tracker.close()  # a second close does nothing
        logger.removeHandler(handler)
        (event,) = os.listdir(tmp_path / name / "tensorboard")
        files.append((event, (tmp_path / name / "tensorboard" / event).read_bytes()))
        lines.append(seen)
    assert files[0] == files[1] and len(files[0][1]) > 200
    assert lines[0] == lines[1] == [
        "[Train] step: 1, loss: 0.500000, grad_norm: 0.500000, lr: 0.000100, "
        "imgs_per_sec: 12.500000",
        "[Train] step: 3, loss: 0.250000, grad_norm: 0.500000, lr: 0.000100, "
        "imgs_per_sec: 37.500000"]


def test_step_timer_matches_jax(monkeypatch):
    timers = []
    for mod in (tprofiling, jprofiling):
        clock = iter([10.0, 10.5, 11.5, 11.75])
        monkeypatch.setattr(mod.time, "perf_counter", lambda clock=clock: next(clock))
        timer = mod.StepTimer(window=2)
        assert timer.throughput(8) == 0.0
        ticks = [timer.tick() for _ in range(4)]
        timers.append((ticks, timer.mean, timer.throughput(8)))
    assert timers[0] == timers[1] == ([None, 0.5, 1.0, 0.25], 0.625, 12.8)


@pytest.mark.parametrize("conf", [
    {"target": "dmtpu.utils.optim.adafactor", "params": {"lr": 1e-5}},
    {"target": "dmtpu.utils.optim.adafactor"},
    {"target": "dmtpu.utils.optim.adamw", "params": {"lr": 1e-4}},
    {"target": "dmtpu.utils.optim.adamw", "params": {}},
    {"target": "torch.optim.SGD", "params": {"momentum": 0.9}},
    {"target": "torch.optim.Adam", "params": {"learning_rate": 3e-4}},
    {"target": "somewhere.else.Opt"},
])
def test_lr_fn_matches_jax(conf):
    got, want = toptim.lr_fn(conf), joptim.lr_fn(conf)
    for step in (0, 7):
        assert got(step) == want(step) or (np.isnan(got(step)) and np.isnan(want(step)))


def test_lr_schedule_config_is_not_ported():
    """Schedules given as configs, once refused, are ported
    (``tests/test_torch_schedules.py``): the named optax schedules log their
    values as the JAX ``lr_fn`` does, and any other target raises, listing
    the supported names."""
    conf = {"target": "dmtpu.utils.optim.adamw", "params": {
        "lr": {"target": "optax.cosine_decay_schedule",
               "params": {"init_value": 1.0, "decay_steps": 10}}}}
    got, want = toptim.lr_fn(conf), joptim.lr_fn(conf)
    for step in (0, 3, 12):
        assert got(step) == pytest.approx(want(step), rel=1e-6, abs=1e-7)
    conf["params"]["lr"]["target"] = "optax.sgdr_schedule"
    with pytest.raises(ValueError, match="optax.warmup_cosine_decay_schedule"):
        toptim.lr_fn(conf)


def test_checkpoint_layout_and_host_load(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(200, 130), torch.nn.Linear(130, 3))
    opt = toptim.adafactor(model.parameters(), lr=1e-3)
    state = TrainState.create(model, opt, ema_decay=0.9, ema_dtype="bf16")
    model(torch.randn(4, 200)).square().sum().backward()
    opt.step()
    state.ema.update(dict(model.named_parameters()))
    state.step = 7
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), 6, state)
    assert path == str(tmp_path / "ckpt" / "step000006")
    assert os.listdir(path) == [ckpt_lib.STATE_FILE]
    blob = ckpt_lib.load_checkpoint_host(path)
    assert blob["step"] == 7 and sorted(blob) == ["ema", "model", "optimizer", "step"]
    assert blob["ema"] == {"shadow": blob["ema"]["shadow"], "num_updates": 1, "decay": 0.9,
                           "gradual": True}
    assert all(v.device.type == "cpu" for v in blob["model"].values())
    factored = blob["optimizer"]["state"][0]
    assert sorted(factored) == ["step", "v_col", "v_row"] and factored["step"] == 1
    # a restore writes into the state's own tensors; the shadow keeps its dtype
    other = torch.nn.Sequential(torch.nn.Linear(200, 130), torch.nn.Linear(130, 3))
    restored = TrainState(other, toptim.adafactor(other.parameters(), lr=1e-3),
                          EMAState.create(dict(other.named_parameters()), 0.5, False, "bf16"))
    shadow = restored.ema.shadow["0.weight"]
    ckpt_lib.load_checkpoint(path, restored)
    assert restored.ema.shadow["0.weight"] is shadow and shadow.dtype == torch.bfloat16
    assert (restored.step, restored.ema.num_updates, restored.ema.decay, restored.ema.gradual) \
        == (7, 1, 0.9, True)
    assert all(torch.equal(a, b) for a, b in zip(other.parameters(), model.parameters()))
    assert torch.equal(restored.optimizer.state[other[0].weight]["v_row"],
                       opt.state[model[0].weight]["v_row"])


def test_compare_runs_the_trees_in_turns(monkeypatch, capsys):
    from dmtpu_torch.dev import compare

    ran = []

    def fake_run(cmd, **kw):
        ran.append((cmd[cmd.index("--one") + 1], cmd[cmd.index("--workloads") + 1:]))
        return subprocess.CompletedProcess(cmd, 0, json.dumps({"tree": ran[-1][0]}) + "\n", "")

    monkeypatch.setattr(compare.subprocess, "run", fake_run)
    assert compare.main(["/a", "/b", "--workloads", "train", "txt2img"]) == 0
    assert ran == [(tree, ["train", "txt2img"]) for tree in ("/a", "/b", "/b", "/a")]
    assert [json.loads(x)["tree"] for x in capsys.readouterr().out.splitlines()] == \
        ["/a", "/b", "/b", "/a"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            compare.run_one(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            compare.WORKLOADS, 1)
