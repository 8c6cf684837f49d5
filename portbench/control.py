"""Readings for the limits of a cell's correctness check.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--seconds 5]
        [--control fp8 [--control-seeds N]] [--program] [--fault NAME]

For each seed: set-up, a short window at the cell's own load, then the
check's numbers for the program (``--program``: the lower readings), for
the control (``--control``: the reference computed one precision below the
configured one, put in the program's place) and for the program with a
fault planted (``--fault``, ``portbench/faults.py``): the upper readings.  One JSON
line a seed and side.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from portbench import faults, harness, run


def _report(cell, numbers, seed: int, side: str, units: int) -> None:
    every = getattr(cell, "all_numbers", None) or {n: v for n, v, _ in numbers}
    print(json.dumps({"seed": seed, "side": side, "units": units, "numbers": every}),
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="take the control's readings on the first N seeds only")
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault", default=None,
                   help="plant this fault (portbench/faults.py) and read the program")
    args = p.parse_args(argv)
    run._environment()
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for k, seed in enumerate(args.seeds):
        cell = run.load_cell(args.workload, seed, args.seconds, False, device)
        planted = (faults.planted(cell.ctx.workload["traffic"], args.fault) if args.fault
                   else contextlib.nullcontext())
        with planted:
            cell.setup()
            window = harness.run_window(cell, args.seconds, device)
        cell.release()
        if args.program or args.fault:
            side = f"fault:{args.fault}" if args.fault else "program"
            _report(cell, cell.check(), seed, side, window.units)
        if args.control and (args.control_seeds is None or k < args.control_seeds):
            _report(cell, cell.control(args.control), seed, args.control, window.units)
        del cell
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
