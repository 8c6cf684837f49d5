"""Profiling: a trace of a region, the program's own spans and counters, and
step timing for the train loop.

Counterpart of ``dmtpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of the region inside it
  (the JAX file's is a ``jax.profiler`` one), written under ``logdir`` as a
  ``*.pt.trace.json`` that TensorBoard's profiler plugin and Perfetto read:
  CPU activity, and the card's when one is there.  ``start()`` / ``stop()``
  do the same for a window that is not one block of code (``--profile``).
- ``span(name, device=False)`` / ``spanned(name, device=False)``: a named
  range of the program (a request, a train step, the denoiser call, ...),
  recorded while any ``torch.profiler`` session is active and nowhere else;
  ``count(name, n)`` adds to the innermost open span's counts.
  ``recorded()`` gives the spans, ``clear()`` drops them.
- ``StepTimer``: a rolling window of host-clock step times.  It adds no
  synchronisation: on the card a step's time is the time between two ticks
  of the host loop, which the loop's own reads of a metric hold to the
  card's pace.

Spans.  Recording is on exactly while torch's profiler is enabled (its own
flag, ``torch.autograd.profiler._is_profiler_enabled``): ``trace``,
``--profile`` and any other ``torch.profiler.profile`` record, nothing else
does, and there is no switch of its own.  Off, ``span`` costs that one check
and hands back a shared no-op context.  On, each span takes an id, its
parent's and its root's (one root a request or train step), its thread, and
host start and end in Unix-epoch nanoseconds, the clock in which the
profiler stamps its events (``time.time_ns``), so a span and the card's
activities of one trace lie on one time axis; it also enters
``torch.profiler.record_function(name)``, so the trace shows it.  With
``device=True`` a CUDA event is recorded on the current stream at each end;
``Span.device_ms`` reads the interval between them after the caller's
synchronise (recording never synchronises).  A span opened inside a
backward pass on a thread with no open span (autograd's device thread runs
the backward of CUDA tensors) takes as parent the newest open span of the
other threads: the one whose thread waits in ``.backward()``.  The newest
``SPAN_BUFFER`` spans are kept.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _torch_profiler

SPAN_BUFFER = 200_000


def recording() -> bool:
    """Whether spans and counts are recorded: a ``torch.profiler`` session
    is active."""
    return _torch_profiler._is_profiler_enabled


class trace:
    """Trace the region inside ``with trace(logdir):``, or from ``start()``
    to ``stop()``, into ``logdir``: the host's activity, and the card's where
    there is one.  ``stop`` waits for the card's queued work first."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None

    def start(self) -> "trace":
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities,
                             on_trace_ready=tensorboard_trace_handler(self.logdir))
        self._prof.start()
        return self

    def stop(self) -> None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof = None

    __enter__ = start

    def __exit__(self, *exc: Any) -> None:
        self.stop()


class Span:
    """One recorded range of the program; its own context manager."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "counts",
                 "_device", "_events", "_device_ms", "_range")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.id = self.parent = self.root = self.thread = None
        self.start_ns = self.end_ns = None
        self.counts: Optional[Dict[str, int]] = None
        self._device = device
        self._events = None
        self._device_ms: Optional[float] = None
        self._range = None

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = stack[-1] if stack else _adopting_parent()
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_ident()
        self.start_ns = time.time_ns()
        self._range = _torch_profiler.record_function(self.name)
        self._range.__enter__()
        if self._device and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = [start, None]
        stack.append(self)
        _spans.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events[1] = end
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        self.end_ns = time.time_ns()

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds on the card's stream between the span's two events
        (None without them, or while the span is open)."""
        if self._events is not None and self._events[1] is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


_spans: deque = deque(maxlen=SPAN_BUFFER)
_ids = itertools.count(1)
_local = threading.local()
_stacks: Dict[int, List[Span]] = {}  # each thread's open spans, innermost last
_OFF = contextlib.nullcontext()


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = _stacks[threading.get_ident()] = []
        return _local.stack


def _adopting_parent() -> Optional[Span]:
    """The parent of a span opened on a thread with no open span: inside a
    backward pass, the newest open span of the other threads; else none (a
    root)."""
    if torch._C._current_graph_task_id() == -1:
        return None
    me = threading.get_ident()
    innermost = [s[-1] for t, s in list(_stacks.items()) if t != me and s]
    return max(innermost, key=lambda s: s.start_ns, default=None)


def span(name: str, device: bool = False):
    """A context manager: a recorded span ``name`` while a profiler session
    is active (with CUDA events at its ends when ``device``), else nothing."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device)


def spanned(name: str, device: bool = False) -> Callable[[Callable], Callable]:
    """A decorator: each call of the function in ``span(name, device)``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args: Any, **kwargs: Any) -> Any:
            if not _torch_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with Span(name, device):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to count ``name`` of this thread's innermost open span
    while recording; nothing otherwise."""
    if not _torch_profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        s = stack[-1]
        if s.counts is None:
            s.counts = {}
        s.counts[name] = s.counts.get(name, 0) + n


def recorded() -> List[Span]:
    """The kept spans in the order they opened, device extents resolved
    (call after synchronising the card)."""
    spans = list(_spans)
    for s in spans:
        s.device_ms
    return spans


def clear() -> None:
    _spans.clear()


class StepTimer:
    def __init__(self, window: int = 50):
        self.times: deque = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.mean else 0.0
