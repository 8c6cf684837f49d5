"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Loads the cell (``portbench/workloads/<cell>.json``),
its configuration (``portbench/configs/<config>.json``) and its traffic kind
(``portbench/traffic/<kind>.py``); sets up and warms up (``setup_s``);
measures for ``--seconds``; with ``--trace 1`` profiles a short sub-window
after it and reads the cell's per-layer metrics (``portbench/metrics/<name>.py``);
frees the program's state and checks what the window produced against the
plain reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error).

Exits non-zero, printing no result, without as many CUDA devices as the cell
asks for, or if a JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, before the heavy imports

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional, Sequence  # noqa: E402

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through a library."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("DMTPU_CLIP_TOKENIZER", None)  # the demo ids, as the reference has them


def load_cell(name: str, seed: int, seconds: float, trace: bool, device,
              workload: Optional[Dict] = None, config: Optional[Dict] = None):
    from portbench.harness import Context, load_json

    workload = workload or load_json(ROOT / "workloads" / f"{name}.json")
    config = config or load_json(ROOT / "configs" / f"{workload['config']}.json")
    kind = importlib.import_module(f"portbench.traffic.{workload['traffic']}")
    return kind.Cell(Context(name, workload, config, seed, seconds, trace, device))


def _metric_reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _cell_metrics(bench: Dict[str, Any], cell: str, section: str) -> List[Dict[str, Any]]:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def _counters() -> Dict[str, int]:
    from dmtpu_torch.ops import flash_attention, groupnorm

    return {"k1": flash_attention.flash_attention_fwd.launches,
            "k2": flash_attention.flash_attention_bwd.launches,
            "k3": groupnorm.group_norm_silu.launches}


def measure(cell, args, bench: Dict[str, Any], device) -> Dict[str, Any]:
    """Set-up, the window, the trace and the check; the result's fields."""
    import torch

    from portbench import harness
    from portbench.roofline import PEAK_BF16_FLOPS

    cell.setup()
    harness.sync(device)
    setup_s = time.perf_counter() - T0
    spans = dict(getattr(cell, "host_ms", {}))
    window = harness.run_window(cell, args.seconds, device)
    stats = {"setup_s": setup_s, "window_s": window.seconds, "units": window.units,
             "images_per_s": window.images / window.seconds,
             "mfu": 100.0 * cell.flops_per_unit * window.units / window.seconds
                     / PEAK_BF16_FLOPS}
    if cell.unit == "step":
        stats["train_images_per_s"] = stats.pop("images_per_s")
        stats["train_step_ms_p90"] = harness.percentile(window.unit_ms, 90)
        stats["train_step_ms_p50"] = harness.percentile(window.unit_ms, 50)
    stats["host_ms"] = {k: (v - spans[k]) / window.units
                        for k, v in getattr(cell, "host_ms", {}).items()}
    result: Dict[str, Any] = {"metrics": {}}
    if args.trace:
        units = int(cell.ctx.workload["trace_units"])
        trace = harness.profile_units(cell, window.units, units,
                                      int(cell.ctx.workload["trace_host_units"]), device,
                                      getattr(cell, "device_under_names", ()), _counters)
        trace.stats = stats
        for m in _cell_metrics(bench, args.workload, "per_layer"):
            value = _metric_reader(m["name"])(trace)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = trace.breakdown()
        busy = trace.busy_s()
    else:
        for m in _cell_metrics(bench, args.workload, "end_to_end"):
            result["metrics"][m["name"]] = {"value": stats[m["name"]], "unit": m["unit"]}
    cuda = device.type == "cuda"
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    if args.trace:
        result["device"].update(busy_s=busy, window_s=trace.window_s)
    result["attempted"] = window.units
    print(f"window: {window.units} {cell.unit}s, {window.images} images in "
          f"{window.seconds:.3f} s; set-up {setup_s:.3f} s; "
          f"{json.dumps({k: v for k, v in stats.items() if k != 'setup_s'})}", file=sys.stderr)
    if args.trace:
        print(f"trace: {trace.units} {cell.unit}s on the card alone in {trace.window_s:.3f} s, "
              f"{trace.host_units} with the host", file=sys.stderr)
    cell.release()
    checks = cell.check()
    result["correct"] = all(value <= limit for _, value, limit in checks)
    result["failed"] = int(getattr(cell, "failed", 0))
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    _environment()
    import torch

    from portbench.harness import load_json

    workload = load_json(ROOT / "workloads" / f"{args.workload}.json")
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, workload)
    result = measure(cell, args, bench, device)
    return emit(result)


def emit(result: Dict[str, Any]) -> int:
    """Print the compared numbers and the result's line, unless a JAX
    package was loaded: then name it and fail."""
    from portbench.harness import forbidden_modules

    loaded = forbidden_modules(list(sys.modules))
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded[:20])}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
