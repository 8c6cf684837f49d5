"""The arithmetic of the per-layer metrics, from a ``harness.Trace``.  Each
file of ``portbench/metrics`` names one metric and calls one of these; a
reader that finds nothing to read returns None and the metric is left out
of the result."""
from __future__ import annotations

import re
from typing import Optional

from portbench import roofline

# the kernels of each of the program's hand-written kernels, by name
KERNEL_NAMES = {
    "k1": re.compile(r"\bflash_fwd(_wgmma|_d512)?_kernel\b"),
    "k2": re.compile(r"\bflash_bwd(_wgmma|_split|_pair|_d512|_wgmma_prep|_split_prep"
                     r"|_wgmma_cast)?_kernel\b"),
    "k3": re.compile(r"\bgroup_norm_(rows_|held_|stream_|chunks_)?kernel\b"),
}


def idle_pct(trace) -> float:
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def mfu(trace) -> float:
    """The untraced window's operations over its time and the dense bf16
    peak, in percent."""
    return trace.stats["mfu"]


def _bound_s(kernel: str, call: tuple) -> float:
    if kernel == "k3":
        n, c, hw, esize, silu = call
        ops, nbytes = roofline.group_norm_work(n, c, hw, esize, silu)
    else:
        b, h, sq, sk, d, esize = call
        work = roofline.attention_fwd_work if kernel == "k1" else roofline.attention_bwd_work
        ops, nbytes = work(b, h, sq, sk, d, esize)
    return roofline.bound_ms(ops, nbytes)[0] / 1e3


def kernel_roofline_pct(trace, kernel: str) -> Optional[float]:
    """The least time of the kernel's calls in the sub-window (the cell's
    table of calls, by ``portbench/roofline.py``) over the device time of
    its kernels, in percent.  None where the program's launch counter does
    not match the table, or no such kernel ran."""
    calls = trace.cell.kernel_calls.get(kernel, [])
    if not calls or trace.launches.get(kernel) != len(calls) * trace.units:
        return None
    spent = trace.kernel_s(KERNEL_NAMES[kernel].search)
    if spent <= 0:
        return None
    return 100.0 * trace.units * sum(_bound_s(kernel, c) for c in calls) / spent


def kernels_per_call(trace) -> Optional[float]:
    calls = trace.cell.denoiser_calls_per_unit * trace.units
    return trace.kernel_count() / calls if trace.kernel_count() else None


def stage_pct(trace, stage: str) -> Optional[float]:
    total = sum(trace.stage_ms.values())
    return 100.0 * trace.stage_ms[stage] / total if total and stage in trace.stage_ms else None


def host_ms(trace, *spans: str) -> Optional[float]:
    """Host milliseconds a unit of the untraced window in the benchmark's
    spans ``spans`` (the calls it times into a layer)."""
    timed = trace.stats.get("host_ms", {})
    return sum(timed[s] for s in spans) if all(s in timed for s in spans) else None


def device_ms_under(trace, name: str) -> Optional[float]:
    """Device milliseconds a unit of the kernels launched under the host
    range ``name`` (second sub-window)."""
    seconds = trace.device_under.get(name, 0.0)
    return 1e3 * seconds / trace.host_units if seconds > 0 else None
