"""What every cell shares: seeds, files, the measured window, the trace.

A cell's traffic module (``portbench/traffic/<kind>.py``) defines ``Cell``
with:

- ``unit``: ``"request"`` (a closed loop of requests, one client) or
  ``"step"`` (train steps back to back);
- ``setup()``: build the program's model with the benchmark's weights and
  warm up every shape the window uses (a train cell also takes its first
  steps here, which the check follows);
- ``run(i)``: unit ``i`` of the window, enqueued; a request returns the
  number of images it put on the host, a step returns its images too;
- ``flops_per_unit``, ``denoiser_calls_per_unit``, ``kernel_calls``: what
  one unit computes, from the reference's shapes (``portbench.flops``);
- ``release()``: drop the program's state; ``check()``: the numbers of the
  correctness check, each ``(name, value, limit)``.

``run.measure`` runs the window and, with ``trace``, the profiled sub-windows
after it; ``Trace`` holds what the per-layer readers (``portbench/metrics``)
read.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dmtpu")


def sub_seed(seed: int, *tags: str) -> int:
    """A 63-bit seed of its own for each use of ``seed``."""
    entropy = [int(seed) % 2 ** 64] + [zlib.crc32(t.encode()) for t in tags]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]) >> 1


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules: Sequence[str]) -> List[str]:
    """The modules of ``modules`` whose top-level name is one of FORBIDDEN,
    compared whole (``dmtpu_torch`` is not ``dmtpu``)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """Points on the device's timeline: CUDA events on the card, host times
    (after a synchronise) elsewhere.  ``elapsed_ms(a, b)`` after a
    synchronise."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def mark(self) -> Any:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def elapsed_ms(self, a: Any, b: Any) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


@dataclasses.dataclass
class Context:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device


@dataclasses.dataclass
class Window:
    units: int = 0
    images: int = 0
    seconds: float = 0.0
    unit_ms: List[float] = dataclasses.field(default_factory=list)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def run_window(cell: Any, seconds: float, device: torch.device) -> Window:
    """Units back to back until ``seconds`` have passed on the host clock.
    A request ends with its images on the host; a run of steps ends in a
    synchronise.  Each step's time is taken between marks recorded after
    each enqueue."""
    w = Window()
    marks = Marks(device)
    sync(device)
    start = time.perf_counter()
    points = [marks.mark()]
    while time.perf_counter() - start < seconds:
        w.images += cell.run(w.units)
        w.units += 1
        points.append(marks.mark())
    sync(device)
    w.seconds = time.perf_counter() - start
    w.unit_ms = [marks.elapsed_ms(a, b) for a, b in zip(points, points[1:])]
    return w


# --- the trace -----------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """What the profiled sub-windows left.  The first traced the card alone
    (``units`` units, ``window_s`` seconds): its activities (``name``,
    start and end in microseconds), the program's launch counters and the
    stage marks.  The second traced the host too (``host_units`` units):
    every host event as a range, the card's activities beside them, and the
    device seconds under each named host range.  ``cell`` gives the tables,
    ``stats`` the untraced window's numbers."""

    cell: Any
    units: int
    window_s: float
    device_ops: List[tuple]          # (name, start_us, end_us)
    launches: Dict[str, int]
    stage_ms: Dict[str, float]
    host_units: int = 0
    host_ranges: List[tuple] = dataclasses.field(default_factory=list)  # (+ thread)
    host_device_ops: List[tuple] = dataclasses.field(default_factory=list)
    device_under: Dict[str, float] = dataclasses.field(default_factory=dict)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def busy_s(self) -> float:
        total, end = 0.0, -math.inf
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total / 1e6

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.device_ops if match(n)) / 1e6

    def kernel_count(self) -> int:
        return len(self.device_ops)

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations of most time (seconds in the first
        sub-window), and the card's idle seconds in the second by the
        innermost host range open in each gap (the 200 longest gaps), the
        ten largest."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        ops = sorted(self.host_device_ops, key=lambda o: o[1])
        found = []  # (length, midpoint) of each idle gap between device activities
        end = ops[0][2] if ops else 0.0
        for _, s, e in ops[1:]:
            if s > end:
                found.append((s - end, (s + end) / 2))
            end = max(end, e)
        gaps: Dict[str, float] = {}
        if found and self.host_ranges:
            starts = np.array([r[1] for r in self.host_ranges])
            ends = np.array([r[2] for r in self.host_ranges])
            for length, mid in sorted(found, reverse=True)[:200]:
                open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
                # the innermost range open at the gap: the latest to start
                name = (self.host_ranges[open_[np.argmax(starts[open_])]][0]
                        if len(open_) else "(no host range)")
                gaps[name] = gaps.get(name, 0.0) + length / 1e6
        return {"device_ops": [[n[:120], v] for n, v in top],
                "idle_gaps": [[n[:120], v] for n, v in
                              sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}


def read_profile(prof: Any, host_names: Sequence[str]) -> tuple:
    """(device ops, host ranges, device seconds under each host name) from a
    finished ``torch.profiler.profile``.  Device ops are the card's
    activities (kernels, copies, sets) without the annotations mirrored
    onto its timeline; host ranges are every event of the host's threads
    (operators, annotations, runtime calls)."""
    events = prof.profiler.kineto_results.events()
    device_ops, host, kinds = [], [], {}
    for e in events:
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        kind = ("card" if on_card else "host", e.is_user_annotation())
        kinds[kind] = kinds.get(kind, 0) + 1
        s = e.start_ns() / 1e3
        if on_card and not e.is_user_annotation():
            device_ops.append((e.name(), s, s + e.duration_ns() / 1e3))
        elif not on_card:
            host.append((e.name(), s, s + e.duration_ns() / 1e3, e.start_thread_id()))
    under = {}
    for name in host_names:
        total = 0.0
        for fe in prof.events():
            if fe.name == name and fe.device_type == torch.autograd.DeviceType.CPU:
                total += fe.device_time_total / 1e6
        under[name] = total
    print(f"trace: {len(events)} events by (device, activity): {kinds}", file=sys.stderr)
    return device_ops, host, under


def _profiled(cell: Any, first: int, units: int, device: torch.device, host: bool):
    """(profiler, seconds) of units ``first`` .. ``first + units - 1``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    sync(device)
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        for i in range(first, first + units):
            cell.run(i)
        sync(device)
        seconds = time.perf_counter() - start
    return prof, seconds


def profile_units(cell: Any, first: int, units: int, host_units: int, device: torch.device,
                  host_names: Sequence[str], counters: Callable[[], Dict[str, int]]) -> Trace:
    """Two profiled sub-windows from unit ``first``: ``units`` units with the
    card's activities alone (a trace of the host's operators would slow the
    host, and with it the card's pace), then ``host_units`` with the host's
    operators too."""
    cell.stage_marks, cell.stages = Marks(device), []
    before = counters()
    prof, window_s = _profiled(cell, first, units, device, host=False)
    after = counters()
    stage_ms: Dict[str, float] = {}
    for a, b, name in cell.stages:
        stage_ms[name] = stage_ms.get(name, 0.0) + cell.stage_marks.elapsed_ms(a, b)
    cell.stage_marks = None
    device_ops, _, _ = read_profile(prof, ())
    del prof
    trace = Trace(cell, units, window_s, device_ops,
                  {k: after[k] - before[k] for k in after}, stage_ms)
    prof, _ = _profiled(cell, first + units, host_units, device, host=True)
    trace.host_device_ops, trace.host_ranges, trace.device_under = read_profile(prof, host_names)
    trace.host_units = host_units
    return trace
