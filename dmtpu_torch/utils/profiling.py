"""Profiling: a trace of a region, and step timing for the train loop.

Counterpart of ``dmtpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of the region inside it
  (the JAX file's is a ``jax.profiler`` one), written under ``logdir`` as a
  ``*.pt.trace.json`` that TensorBoard's profiler plugin and Perfetto read:
  CPU activity, and the card's when one is there.
- ``StepTimer``: a rolling window of host-clock step times.  It adds no
  synchronisation: on the card a step's time is the time between two ticks
  of the host loop, which the loop's own reads of a metric hold to the
  card's pace.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Trace the region inside into ``logdir``: the host's activity, and the
    card's where there is one."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


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
