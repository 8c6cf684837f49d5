"""What the two training kinds share: one train state, built in set-up and
driven from the seed through its first steps through the window's own
call and feed (on batches that all differ), then handed to the window; and
the check, in which the reference follows those first steps.

Compared, each against the reference working the same steps out in
float32 from the same weights, batches and draws:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: each leaf's first gradient as the optimizer got it (worked out
  from its state after one step), by the worst leaf;
- ``update``: each leaf's change after the first steps, by the worst leaf;
- ``ema``: each leaf's EMA shadow's change after the first steps;
- ``grad_median``, ``update_median``, ``ema_median``: the same, by the
  median leaf.

A cell's file names the numbers it compares, with their limits.

The changes leave out the leaves whose first gradient in the reference is
under a thousandth of the median leaf's (``checks.moving_leaves``).
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from portbench import checks, weights
from portbench.harness import Context, sub_seed


def step_seed(seed: int, step: int) -> int:
    """The seed of train step ``step``'s generator, worked out as the train
    step derives it: NumPy's SeedSequence of (seed, step), one 64-bit word,
    halved."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]) >> 1


class TrainingCell:
    unit = "step"
    device_under_names: tuple = ()  # host ranges whose kernels a metric times
    prefix = ""  # of the trained model's leaves among the weights drawn

    def __init__(self, ctx: Context):
        self.ctx, self.device = ctx, ctx.device
        self.params = ctx.workload["params"]
        self.batch = int(self.params["batch"])
        self.first_steps = int(self.params["first_steps"])
        self.pool_size = int(self.params["pool"])
        self.weight_seed = sub_seed(ctx.seed, "weights")
        self.train_seed = sub_seed(ctx.seed, "train") % 2 ** 62
        self.stage_marks, self.stages = None, []

    # --- subclasses -----------------------------------------------------------
    def build_program(self) -> None:
        """``self.state`` (a ``TrainState``), ``self.step_fn``, ``self.pool``."""
        raise NotImplementedError

    def program_first_grads(self) -> Dict[str, float]:
        raise NotImplementedError

    def reference_steps(self, precision) -> Dict[str, Any]:
        """The reference's losses, first gradients, updates and EMA moves."""
        raise NotImplementedError

    # --- the program ------------------------------------------------------------
    def feed(self, k: int) -> Any:
        """The batch of step ``k`` (from 0): the pool, cycled."""
        return self.pool[k % self.pool_size]

    def setup(self) -> None:
        self.build_program()
        # the benchmark's spans around the step's calls into the update layer
        self.host_ms = {"optimizer.step": 0.0, "ema.update": 0.0}
        self.state.optimizer.step = self._timed(self.state.optimizer.step, "optimizer.step")
        self.state.ema.update = self._timed(self.state.ema.update, "ema.update")
        self.losses: List[float] = []
        for k in range(self.first_steps):
            out = self.step_fn(self.state, self.feed(k))
            self.losses.append(float(out["loss"]))
            if k == 0:
                self.first_grads = self.program_first_grads()
        w0 = weights.make(self.shapes, self.weight_seed, self.device)
        named = dict(self.state.model.named_parameters())
        self.updates = {n: float((p.detach() - w0[self.prefix + n]).double().norm())
                        for n, p in named.items()}
        self.ema_moves = {n: float((s.float() - w0[self.prefix + n]).double().norm())
                          for n, s in self.state.ema.shadow.items()}
        del w0

    def _timed(self, fn: Callable, span: str) -> Callable:
        def call(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.host_ms[span] += 1e3 * (time.perf_counter() - start)
        return call

    def run(self, i: int) -> int:
        self.step_fn(self.state, self.feed(self.first_steps + i))
        return self.batch

    def release(self) -> None:
        del self.state, self.step_fn, self.pool
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ------------------------------------------------------------
    def limit(self, name: str) -> float:
        return float(self.ctx.workload["check"]["limits"][name])

    def _numbers(self, prog: Dict[str, Any], ref: Dict[str, Any]) -> List[tuple]:
        moving = checks.moving_leaves(ref["grads"])
        print(f"leaves: {len(ref['grads'])}, {len(ref['grads']) - len(moving)} of them left out "
              f"of the changes (a first gradient under a thousandth of the median leaf's)",
              file=sys.stderr)
        gaps = {"grad": checks.leaf_gaps(prog["grads"], ref["grads"]),
                "update": checks.leaf_gaps(prog["updates"], ref["updates"], moving),
                "ema": checks.leaf_gaps(prog["ema"], ref["ema"], moving)}
        numbers = {"loss": max(checks.relative(p, r) for p, r in zip(prog["losses"],
                                                                    ref["losses"]))}
        for key, by_leaf in gaps.items():
            print(f"leaves of {key}: {checks.worst_leaves(by_leaf)}", file=sys.stderr)
            numbers[key] = max(by_leaf.values())
            numbers[f"{key}_median"] = statistics.median(by_leaf.values())
        self.all_numbers = numbers
        limits = self.ctx.workload["check"]["limits"]
        out = [(name, value, float(limits[name])) for name, value in numbers.items()
               if name in limits]
        self.failed = sum(value > limit for _, value, limit in out)
        return out

    def check(self) -> List[tuple]:
        prog = {"losses": self.losses, "grads": self.first_grads, "updates": self.updates,
                "ema": self.ema_moves}
        return self._numbers(prog, self._reference())

    def control(self, precision: str) -> List[tuple]:
        return self._numbers(self.reference_steps(precision), self._reference())

    def _reference(self) -> Dict[str, Any]:
        """The float32 reference's first steps, worked out once."""
        if getattr(self, "_ref", None) is None:
            self._ref = self.reference_steps(None)
        return self._ref


def follow(model: torch.nn.Module, optimizer: Any, ema: Any, steps: int,
           loss_of: Callable[[int, int, int], torch.Tensor], chunks: int,
           clip: float = None) -> Dict[str, Any]:
    """Run the reference's first ``steps`` steps: step k's loss is the mean
    over ``chunks`` equal blocks of rows of ``loss_of(k, block, chunks)``,
    each block's backward taken on its own (the gradients add up);
    ``optimizer.step`` and ``ema.update`` take the named parameters."""
    params = dict(model.named_parameters())
    w0 = {n: p.detach().clone() for n, p in params.items()}
    losses, first = [], None
    for k in range(steps):
        for p in params.values():
            p.grad = None
        total = 0.0
        for c in range(chunks):
            loss = loss_of(k, c, chunks) / chunks
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {n: p.grad for n, p in params.items()}
        if clip is not None:
            from portbench.reference.optim import clip_

            clip_(grads, clip)
        if k == 0:
            first = {n: float(g.double().norm()) for n, g in grads.items()}
        optimizer.step({n: p.data for n, p in params.items()}, grads)
        ema.update({n: p.data for n, p in params.items()})
    return {"losses": losses, "grads": first,
            "updates": {n: float((p.detach() - w0[n]).double().norm())
                        for n, p in params.items()},
            "ema": {n: float((s.float() - w0[n]).double().norm())
                    for n, s in ema.shadow.items()}}
