"""dmtpu_torch.scripts.evaluate and accept against scripts/evaluate.py and
scripts/accept.py on the CPU.

``evaluate``: both CLIs read the same two PNG directories with the same
fabricated pt_inception ``.pth`` (``tests/test_accept.py``'s); their JSON
lines agree within 1e-4 relative (features within 1e-5 relative L2 of each
other, through two frameworks' f32 convolutions and a float64 ``sqrtm``).
``accept``: the row tables, the flags (``--device`` aside) and the machinery
are the JAX script's; a run on ``configs/ddpm_synthetic.yaml`` with
fabricated artifacts ends with exit code 1 and finite metrics, as the JAX
script's does; the uint8 conversion truncates as the JAX script's.
"""
import argparse
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dmtpu_torch.scripts import accept, evaluate
from tests._torch_helpers import fake_inception_pth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = jax.devices("cpu")[0]


def _jax_script(name):
    """scripts/<name>.py as a module of its own name (``evaluate`` is also a
    package's name)."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _parser_of(main, argv):
    """The ``ArgumentParser`` that ``main`` builds, caught at its parse."""
    from unittest import mock

    caught = []

    def catch(self, *args, **kwargs):
        caught.append(self)
        raise KeyboardInterrupt

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch), \
            mock.patch.object(sys, "argv", argv), pytest.raises(KeyboardInterrupt):
        main()
    return caught[0]


def _flags(parser):
    return {a.option_strings[0]: (a.dest, a.default, a.type, a.choices, a.required,
                                  type(a).__name__, a.help)
            for a in parser._actions if a.option_strings and a.dest not in ("help", "device")}


@pytest.fixture(scope="module")
def inception_pth(tmp_path_factory):
    return fake_inception_pth(tmp_path_factory.mktemp("inception"))


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    """Two directories of 12 seeded 32x32 PNGs: smooth fields plus noise,
    the fake side brighter."""
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:32, 0:32] / 31.0
    for side, shift in (("real", 0.0), ("fake", 0.25)):
        os.makedirs(root / side)
        for i in range(12):
            a, b, c = rs.rand(3)
            base = np.stack([a * xx + (1 - a) * yy, b * xx * yy, c + 0 * xx], -1)
            img = np.clip(base * 0.7 + shift + 0.15 * rs.rand(32, 32, 3), 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(root / side / f"{i:03d}.png")
    return str(root / "real"), str(root / "fake")


def test_evaluate_prints_the_jax_cli_s_numbers(inception_pth, image_dirs, monkeypatch,
                                               capsys):
    real, fake = image_dirs
    args = ["--real_dir", real, "--fake_dir", fake, "--batch_size", "16",
            "--inception_weights", inception_pth, "--is_splits", "2",
            "--kid", "--kid_subsets", "4", "--kid_subset_size", "8"]
    jax_cli = _jax_script("evaluate")
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *args])
    with jax.default_device(CPU):
        jax_cli.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    results = evaluate.main([*args, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want) == ["fid", "is_mean", "is_std", "kid_mean", "kid_std"]
    assert all(np.isfinite(v) for v in got.values()) and got["fid"] > 0
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-4), key
    # the printed line is the returned results at the JAX CLI's precision
    assert got["fid"] == round(results["fid"], 4) and got["kid_mean"] == results["kid_mean"]


def test_evaluate_flags_and_refusals_are_the_jax_cli_s(monkeypatch, capsys):
    jax_cli = _jax_script("evaluate")
    want = _flags(_parser_of(jax_cli.main, ["evaluate.py"]))
    assert _flags(evaluate.build_parser()) == want
    for argv in (["--real_dir", "a", "--fake_dir", "b"],
                 ["--real_dir", "a", "--fake_dir", "b", "--clip_pretrained", "c", "--kid"]):
        monkeypatch.setattr(sys, "argv", ["evaluate.py", *argv])
        with pytest.raises(SystemExit) as e:
            jax_cli.main()
        jax_err = capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1]
        with pytest.raises(SystemExit) as e2:
            evaluate.main(argv)
        err = capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1]
        assert e.value.code == e2.value.code == 2 and err == jax_err


def test_load_images_keeps_native_size_and_resizes_stragglers(tmp_path):
    from PIL import Image

    jax_cli = _jax_script("evaluate")
    rs = np.random.RandomState(1)
    for i, size in enumerate([(24, 16), (24, 16), (30, 20)]):
        Image.fromarray(rs.randint(0, 256, (size[1], size[0], 3)).astype(np.uint8)).save(
            tmp_path / f"{i}.png")
    for kw in ({}, {"img_size": 12}, {"limit": 2}):
        got = evaluate.load_images_u8(str(tmp_path), **kw)
        assert np.array_equal(got, jax_cli.load_images_u8(str(tmp_path), **kw))
    assert evaluate.load_images_u8(str(tmp_path)).shape == (3, 16, 24, 3)


def test_accept_tables_and_flags_are_the_jax_script_s(monkeypatch):
    jax_cli = _jax_script("accept")
    assert accept.ROWS == jax_cli.ROWS and len(accept.ROWS) == 41
    assert accept.GROUP_CONFIG == jax_cli.GROUP_CONFIG
    assert accept.GROUP_OBJECTIVE == jax_cli.GROUP_OBJECTIVE
    monkeypatch.delenv("DMTPU_ACCEPT_WEIGHTS", raising=False)
    want = _flags(_parser_of(jax_cli.main, ["accept.py"]))
    assert _flags(accept.build_parser()) == want
    for args in [(3.1, 3.0459, 0.05, 0.3), (3.8, 3.0459, 0.05, 0.3), (270.0, 266.754, 0.05, 0.3)]:
        assert accept.within_tolerance(*args) == jax_cli.within_tolerance(*args)
    results = {"ddim_50": {"fid": 9.9, "is_mean": 8.7}, "heun_5": {"fid": 82.0, "is_mean": 2.0}}
    assert accept.diff_table(results, 0.05, 0.3, 0.03) == jax_cli.diff_table(results, 0.05,
                                                                              0.3, 0.03)


@pytest.mark.parametrize("argv,code", [(["--self_test"], 0), (["--list"], 0),
                                       (["--rows", "ddim_10,heun_5", "--list"], 0),
                                       (["--group", "cfg"], 2),
                                       (["--rows", "ddim_10,cfg_s1"], 2),
                                       (["--rows", "nope"], 2)])
def test_accept_exits_and_prints_as_the_jax_script(argv, code, monkeypatch, capsys):
    for name in ("DMTPU_INCEPTION_WEIGHTS", "DMTPU_DATA_DIR", "DMTPU_ACCEPT_WEIGHTS"):
        monkeypatch.delenv(name, raising=False)
    jax_cli = _jax_script("accept")
    monkeypatch.setattr(sys, "argv", ["accept.py", *argv])
    with pytest.raises(SystemExit) as e:
        jax_cli.main()
    want = capsys.readouterr()
    with pytest.raises(SystemExit) as e2:
        accept.main(argv)
    got = capsys.readouterr()
    assert e.value.code == e2.value.code == code
    if code == 2 and "missing" in got.out:
        # the port names what it loads, not the torch->Flax converter
        assert all(w in got.out for w in ("inception weights", "CIFAR-10", "checkpoint"))
        assert "convert_checkpoint" not in got.out and got.out.count("  - ") == 3
    else:
        assert got.out == want.out
        assert got.err.splitlines()[-1:] == want.err.splitlines()[-1:]


def test_to_uint8_truncates_as_the_jax_script():
    x = np.array([-1.5, -1.0, -0.9999, -0.5, 0.0, 0.001, 0.5, 0.99, 0.9999, 1.0, 2.0],
                 np.float32)
    x = np.concatenate([x, np.random.RandomState(0).uniform(-1.2, 1.2, 373).astype(np.float32)])
    samples = torch.from_numpy(x.reshape(4, 1, 3, 32).repeat(3, axis=1))  # [B, C, H, W]
    want = ((np.clip(samples.numpy(), -1, 1) + 1) * 127.5).astype(np.uint8).transpose(0, 2, 3, 1)
    got = accept.to_uint8(samples)
    assert got.dtype == np.uint8 and got.shape == (4, 3, 32, 3)
    assert np.array_equal(got, want)
    assert accept.to_uint8(torch.zeros(1, 3, 1, 1)).max() == 127  # 127.5 is not rounded up


def _fake_cifar10(root, n_per_batch=8):
    import pickle

    base = root / "cifar-10-batches-py"
    base.mkdir()
    rs = np.random.RandomState(1)
    for i in range(1, 6):
        with open(base / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n_per_batch, 3072), dtype=np.uint8),
                         b"labels": list(rs.randint(0, 10, n_per_batch))}, f)
    return str(root)


def test_accept_end_to_end_on_fabricated_artifacts(inception_pth, tmp_path, capsys):
    """One row through the whole runner on the CPU: random weights cannot
    reach a published FID, so the run completes with finite metrics, a FAIL
    verdict and exit code 1 (``tests/test_accept.py``'s expectation)."""
    from dmtpu_torch.utils.config import instantiate_from_config, load_config

    config = os.path.join(REPO, "configs", "ddpm_synthetic.yaml")
    torch.manual_seed(0)
    model = instantiate_from_config(load_config(config)["model"])
    torch.save(model.state_dict(), tmp_path / "ckpt.pt")
    out_json = tmp_path / "accept.json"
    with pytest.raises(SystemExit) as e:
        accept.main(["--rows", "ddim_10", "--config", config,
                     "--weights", str(tmp_path / "ckpt.pt"), "--inception_weights", inception_pth,
                     "--cifar10_dir", _fake_cifar10(tmp_path), "--n_samples", "6",
                     "--batch_size", "4", "--eval_batch_size", "8", "--is_splits", "2",
                     "--out", str(out_json), "--device", "cpu"])
    assert e.value.code == 1
    res = json.loads(out_json.read_text())
    row = res["rows"]["ddim_10"]
    assert np.isfinite(row["fid"]) and row["fid"] > 0 and row["is_mean"] >= 1.0
    assert res["failed"] == 1 and res["n_samples"] == 6
    out = capsys.readouterr().out
    assert "FAIL" in out and "ddim_10" in out


def test_sample_row_draws_balanced_classes_for_the_cfg_group():
    seen = []

    def model(x, t, y=None):
        seen.append(y.clone())
        return torch.zeros_like(x)

    from dmtpu_torch.diffusions import DDIMCFG

    diffuser = DDIMCFG(guidance_scale=3.0, eta=0.0, total_steps=1000, respace_type="uniform",
                       respace_steps=2)
    images = accept.sample_row(model, diffuser, 7, 4, (3, 2, 2), seed=0,
                               device=torch.device("cpu"), num_classes=3)
    assert images.shape == (7, 2, 2, 3) and images.dtype == np.uint8
    # each call takes the CFG-doubled batch: the classes, then the null class
    assert seen[0].tolist() == [0, 1, 2, 0, 3, 3, 3, 3]
    assert seen[-1].tolist() == [1, 2, 0, 3, 3, 3]  # the second batch goes on from index 4
