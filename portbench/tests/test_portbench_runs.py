"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: the plain reference agrees with the program where both
compute in float32, and each fault the timed path can have turns
``correct`` false under the cell's own limits.  And the cells on the card
(``-m gpu``)."""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import faults, run
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _f32(conf):
    p = conf["model"]["params"]
    if "unet_config" in p:
        p["unet_config"]["params"]["torso_dtype"] = None
    if "vit_config" in p:
        p["vit_config"]["params"]["dtype"] = None
    return conf


def _run(name, seed=7, trace=0, f32=True):
    work = tiny.workload(name)
    conf = tiny.config(work["config"])
    cell = run.load_cell(name, seed, 0.5, bool(trace), torch.device("cpu"), work,
                         _f32(conf) if f32 else conf)
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.5, trace=trace)
    return cell, run.measure(cell, args, BENCH, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_in_float32(name):
    _, result = _run(name)
    assert result["correct"], result["checks"]
    for check in result["checks"].values():
        assert check["value"] < 1e-4
    assert result["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_per_layer_metrics(name):
    _, result = _run(name, trace=1)
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    mfu = [k for k in result["metrics"] if k.startswith("mfu.")]
    assert mfu and all(0 < result["metrics"][k]["value"] <= 100 for k in mfu)


TRAFFIC = {w["name"]: w["traffic"] for w in BENCH["workloads"]}


def _faults(name):
    return faults.SAMPLING if TRAFFIC[name] in ("txt2img", "class_sample") else faults.TRAINING


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in _faults(n)])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault):
    with faults.planted(TRAFFIC[name], fault):
        _, result = _run(name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    """The reference one precision below the configured one, in the
    program's place, reads above the cell's limit."""
    work = tiny.workload(name)
    cell = run.load_cell(name, 3, 0.5, False, torch.device("cpu"), work,
                         tiny.config(work["config"]))
    cell.setup()
    from portbench import harness

    harness.run_window(cell, 0.5, torch.device("cpu"))
    cell.release()
    numbers = cell.control("fp8")
    assert any(value > limit for _, value, limit in numbers), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
