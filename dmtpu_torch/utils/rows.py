"""Per-row random draws, and the generator of some rows of a batch.

Under data parallelism each rank holds some rows of the global batch, yet
the run must be the one-rank run: every per-row draw (timesteps, noise,
label dropout, a sampler's per-step noise) must be the value the one-rank
run draws for that row.  The code that splits the batch (the train step,
``DataParallelSampler``) hands the code below it a ``RowGenerator`` in
place of its ``torch.Generator``: the generator, the batch's size and the
rows this rank holds.  A per-row draw through it (``randn`` / ``rand`` /
``randint`` here) is made for the whole batch from the generator, as the
one-rank run makes it, and the held rows of it are kept, so every rank
leaves the generator in the same state.  A per-row draw whose leading dim
is not the held row count raises.  With a ``torch.Generator`` (or None)
these are ``torch.randn`` / ``torch.rand`` / ``torch.randint``.  The JAX
package gets this from one program over the mesh: its draws are of the
global batch's shape.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch

Shape = Union[int, Sequence[int]]


@dataclasses.dataclass(frozen=True)
class RowGenerator:
    """The rows ``rows`` (indices into a batch of ``batch``) of the draws
    that ``generator`` makes for the whole batch."""

    generator: torch.Generator
    batch: int
    rows: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.generator.device


Generator = Union[torch.Generator, RowGenerator, None]


def _draw(shape: Shape, generator: Generator,
          draw: Callable[[Shape, Optional[torch.Generator]], torch.Tensor]) -> torch.Tensor:
    if not isinstance(generator, RowGenerator):
        return draw(shape, generator)
    dims = (shape,) if isinstance(shape, int) else tuple(shape)
    if not dims or dims[0] != len(generator.rows):
        raise ValueError(f"a per-row draw of shape {dims} through a generator of "
                         f"{len(generator.rows)} rows of {generator.batch}")
    full = draw((generator.batch,) + dims[1:], generator.generator)
    return full[generator.rows.to(full.device)]


def randn(shape: Shape, generator: Generator = None, device=None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    kw = {} if dtype is None else {"dtype": dtype}
    return _draw(shape, generator, lambda s, g: torch.randn(s, generator=g, device=device, **kw))


def rand(shape: Shape, generator: Generator = None, device=None) -> torch.Tensor:
    return _draw(shape, generator, lambda s, g: torch.rand(s, generator=g, device=device))


def randint(low: int, high: int, shape: Shape, generator: Generator = None,
            device=None) -> torch.Tensor:
    return _draw(shape, generator,
                 lambda s, g: torch.randint(low, high, s, generator=g, device=device))
