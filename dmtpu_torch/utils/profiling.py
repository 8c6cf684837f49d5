"""Step timing for the train loop.

Counterpart of ``StepTimer`` in ``dmtpu/utils/profiling.py``: a rolling
window of host-clock step times.  It adds no synchronisation: on the card a
step's time is the time between two ticks of the host loop, which the
loop's own reads of a metric hold to the card's pace.  The JAX file's
``trace`` (a ``jax.profiler`` context) is not ported: ``torch.profiler`` is
called where a trace is wanted.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional


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
