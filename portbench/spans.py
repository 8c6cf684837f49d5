"""The program's own spans and counts (``dmtpu_torch.utils.profiling``) read
against the card's activities of a traced run (``harness.Trace``).

The program records spans while a ``torch.profiler`` session is active, so a
traced run leaves those of its two profiled sub-windows: ``trace.units``
roots (requests or train steps) on the card alone, then
``trace.host_units`` with the host's operators.  The card-only sub-window's
spans are the first ``trace.units`` of the last ``units + host_units`` roots
recorded, with their descendants.  Host times are Unix-epoch nanoseconds, as
the profiler stamps its events, so spans and the card's activities share one
time axis.

Idle attribution: the sub-window runs from the earlier of its first root's
start and its first device activity to the later of its last root's end and
its last activity.  Each stretch of it with no activity on the card is split
exactly, by overlap, over the span innermost on the host across each part of
it: the deepest open span of any thread (a span of autograd's device thread
lies under the span its caller waits in), the latest to start among equals;
where no span is open the idle is unspanned.

A reader returns None where there is nothing to read: a program without
spans, a run without the spans it reads, or device extents or activities a
CPU run does not have.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

UNSPANNED = "(unspanned)"


def program_spans() -> Optional[list]:
    """Every span the program kept (``profiling.recorded()``), or None for a
    program that records none."""
    try:
        from dmtpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    return recorded()


def window_spans(trace) -> List:
    """The card-only sub-window's closed spans, in the order they opened."""
    spans = program_spans()
    if not spans:
        return []
    roots = [s for s in spans if s.parent is None]
    last = roots[max(0, len(roots) - trace.units - trace.host_units):]
    keep = {r.id for r in last[:trace.units]}
    return [s for s in spans if s.root in keep and s.end_ns is not None]


def _depths(spans: Sequence) -> Dict[int, int]:
    by_id = {s.id: s for s in spans}
    depth: Dict[int, int] = {}
    for s in spans:
        chain, p = [s], by_id.get(s.parent)
        while p is not None and p.id not in depth:
            chain.append(p)
            p = by_id.get(p.parent)
        d = depth[p.id] + 1 if p is not None else 0
        for q in reversed(chain):
            depth[q.id] = d
            d += 1
    return depth


def busy(device_ops: Iterable[tuple]) -> List[Tuple[float, float]]:
    """The union of the activities' (start, end) in microseconds, sorted."""
    out: List[List[float]] = []
    for _, s, e in sorted(device_ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost(spans: Sequence, lo: float, hi: float) -> List[Tuple[float, float, Optional[int]]]:
    """[lo, hi] (microseconds) cut where the innermost open span changes:
    (start, end, span id or None)."""
    depth = _depths(spans)
    cuts = sorted({lo, hi} | {min(max(t, lo), hi) for s in spans
                             for t in (s.start_ns / 1e3, s.end_ns / 1e3)})
    starts = sorted(spans, key=lambda s: s.start_ns)
    open_: list = []
    out, k = [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(starts) and starts[k].start_ns / 1e3 <= a:
            open_.append(starts[k])
            k += 1
        open_ = [s for s in open_ if s.end_ns / 1e3 > a]
        top = max(open_, key=lambda s: (depth[s.id], s.start_ns), default=None)
        out.append((a, b, top.id if top is not None else None))
    return out


def idle_by_span(device_ops: Sequence[tuple], spans: Sequence) -> Tuple[Dict, float]:
    """({span id or None: idle seconds}, the window's idle seconds): the
    card's idle time over the window of ``spans`` and ``device_ops``, each
    part put down to the span innermost on the host across it."""
    runs = busy(device_ops)
    if not runs or not spans:
        return {}, 0.0
    lo = min(runs[0][0], min(s.start_ns for s in spans) / 1e3)
    hi = max(runs[-1][1], max(s.end_ns for s in spans) / 1e3)
    idle, end = [], lo
    for s, e in runs + [(hi, hi)]:
        if s > end:
            idle.append((end, s))
        end = max(end, e)
    segments = innermost(spans, lo, hi)
    out: Dict = {}
    i = j = 0
    while i < len(idle) and j < len(segments):
        a, b = max(idle[i][0], segments[j][0]), min(idle[i][1], segments[j][1])
        if b > a:
            out[segments[j][2]] = out.get(segments[j][2], 0.0) + (b - a) / 1e6
        if idle[i][1] < segments[j][1]:
            i += 1
        else:
            j += 1
    return out, sum(b - a for a, b in idle) / 1e6


def _attribution(trace) -> Tuple[List, Dict, float]:
    cached = getattr(trace, "_span_attribution", None)
    if cached is None:
        spans = window_spans(trace)
        by_span, total = idle_by_span(trace.device_ops, spans)
        cached = trace._span_attribution = (spans, by_span, total)
    return cached


def idle_by_name(trace) -> Tuple[Dict[str, float], float]:
    """({innermost span's name or UNSPANNED: idle seconds}, the window's
    idle seconds) of the card-only sub-window."""
    spans, by_span, total = _attribution(trace)
    name = {s.id: s.name for s in spans}
    out: Dict[str, float] = {}
    for sid, seconds in by_span.items():
        key = name[sid] if sid is not None else UNSPANNED
        out[key] = out.get(key, 0.0) + seconds
    return out, total


def _under(spans: Sequence, names: Sequence[str]) -> set:
    """Ids of the spans named in ``names`` and of their descendants."""
    parent = {s.id: s.parent for s in spans}
    name = {s.id: s.name for s in spans}
    out = set()
    for s in spans:
        sid = s.id
        while sid is not None:
            if name.get(sid) in names:
                out.add(s.id)
                break
            sid = parent.get(sid)
    return out


def idle_ms(trace, names: Sequence[str], outside: Sequence[str] = ()) -> Optional[float]:
    """Milliseconds a unit of the card's idle time while the host's
    innermost span is one of ``names`` or under one, and not under any of
    ``outside``."""
    spans, by_span, _ = _attribution(trace)
    if not trace.device_ops or not any(s.name in names for s in spans):
        return None
    inside = _under(spans, names) - _under(spans, outside)
    return 1e3 * sum(v for sid, v in by_span.items() if sid in inside) / trace.units


def _named(trace, name: str) -> List:
    return [s for s in window_spans(trace) if s.name == name]


def device_ms_mean(trace, name: str) -> Optional[float]:
    """The mean device extent of the ``name`` spans, in milliseconds."""
    extents = [s.device_ms for s in _named(trace, name)]
    if not extents or any(e is None for e in extents):
        return None
    return sum(extents) / len(extents)


def device_pct(trace, part: Sequence[str], whole: str) -> Optional[float]:
    """The ``part`` spans' device extent under the ``whole`` spans, as a
    share of the ``whole`` spans', in percent."""
    spans = window_spans(trace)
    inside = _under(spans, (whole,))
    wholes = [s.device_ms for s in spans if s.name == whole]
    parts = [s.device_ms for s in spans if s.name in part and s.id in inside]
    if not wholes or not parts or any(e is None for e in wholes + parts) or sum(wholes) <= 0:
        return None
    return 100.0 * sum(parts) / sum(wholes)


def host_ms(trace, names: Sequence[str]) -> Optional[float]:
    """Host milliseconds a unit inside the ``names`` spans."""
    spans = [s for s in window_spans(trace) if s.name in names]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / trace.units


def count_per_span(trace, counter: str, name: str) -> Optional[float]:
    """Count ``counter`` under the ``name`` spans (theirs and their
    descendants'), a span."""
    spans = window_spans(trace)
    n = sum(s.name == name for s in spans)
    if not n:
        return None
    inside = _under(spans, (name,))
    return sum((s.counts or {}).get(counter, 0) for s in spans if s.id in inside) / n
