"""Faults planted under the timed path, to show that the check catches each
one the cell can have.  Not used by a benchmark run: ``control.py --fault``
reads them on the card, and the CPU tests plant them in tiny runs.

- ``state_unchanged`` (training): the optimizer's step returns, changing
  nothing;
- ``half_batch`` (training): the loss takes the first half of each batch
  and the mean over it; (sampling): the second half of each request's
  images is a copy of the first;
- ``answer_altered`` (sampling): each image of a request is replaced by
  another row's, the first inverted.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Iterator

import torch

TRAINING = ("state_unchanged", "half_batch")
SAMPLING = ("answer_altered", "half_batch")


def _half(batch):
    if isinstance(batch, dict):
        return {k: v[: len(v) // 2] for k, v in batch.items()}
    return type(batch)(t[: len(t) // 2] for t in batch)


def _halving(make):
    def make_halved(*args, **kwargs):
        loss_fn = make(*args, **kwargs)
        return lambda batch, generator: loss_fn(_half(batch), generator)
    return make_halved


def _altered(images):
    images = images[::-1].copy()
    images[0] = 255 - images[0]
    return images


def _duplicated(images):
    images = images.copy()
    half = len(images) // 2
    images[len(images) - half:] = images[:half]
    return images


@contextlib.contextmanager
def planted(traffic: str, fault: str) -> Iterator[None]:
    """``fault`` under the program while the block runs, for a cell of kind
    ``traffic``."""
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if traffic in ("txt2img", "class_sample"):
        kind = importlib.import_module(f"portbench.traffic.{traffic}")
        corrupt = {"answer_altered": _altered, "half_batch": _duplicated}[fault]
        serve = kind.Cell.serve
        patch(kind.Cell, "serve", lambda self, req, on_stage, **kw: corrupt(
            serve(self, req, on_stage, **kw)))
    elif fault == "state_unchanged":
        from dmtpu_torch.utils import optim

        for cls in (torch.optim.AdamW, torch.optim.Adam, optim.Adafactor):
            patch(cls, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        import dmtpu_torch.parallel as parallel
        from dmtpu_torch.scripts import train_sd

        patch(parallel, "make_diffusion_loss_fn", _halving(parallel.make_diffusion_loss_fn))
        patch(train_sd, "make_sd_loss_fn", _halving(train_sd.make_sd_loss_fn))
    else:
        raise ValueError(f"no fault {fault!r} for traffic {traffic!r}")
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
