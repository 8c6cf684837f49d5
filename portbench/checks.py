"""The numbers that decide ``correct``, each computed from what the program
produced and what the reference works out for the same inputs."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import numpy as np


def image_rms(program: np.ndarray, reference: np.ndarray) -> float:
    """Root mean square difference of two uint8 images, in levels of 255."""
    d = program.astype(np.float64) - reference.astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


def relative(program: float, reference: float) -> float:
    return abs(program - reference) / abs(reference)


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's |program - reference| of its norm, over the larger of the
    reference's norm of that leaf and of the median leaf (some gradients
    are all but zero)."""
    names = list(reference if leaves is None else leaves)
    floor = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], floor) for n in names}


def worst_leaves(gaps: Dict[str, float], n: int = 3) -> list:
    """The ``n`` largest of ``leaf_gaps``, and the median leaf's."""
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return top + [("median", statistics.median(gaps.values()))]


def moving_leaves(first_grads: Dict[str, float]) -> list:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move by round-off alone."""
    floor = 1e-3 * statistics.median(first_grads.values())
    return [n for n, g in first_grads.items() if g >= floor]
