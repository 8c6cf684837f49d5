"""Runs a function on n gloo ranks of the CPU, for the port's parallel tests.

``spawn(fn, world, tmp_path, *args)`` starts ``world`` processes
(``torch.multiprocessing``), each with one thread and a process group
joined through a ``FileStore`` in ``tmp_path``, calls ``fn(rank, world,
*args)`` in each and returns the ranks' results in rank order.  ``fn`` must
be a module-level function of a module that imports no JAX (the children
import it).  The children set ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` as
``torchrun`` does, so the CLIs see a launch.
"""
from __future__ import annotations

import os
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(rank, world, store, out, fn, args):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        result = fn(rank, world, *args)
        dist.destroy_process_group()
        torch.save({"ok": result}, f"{out}.{rank}")
    except BaseException:
        torch.save({"error": traceback.format_exc()}, f"{out}.{rank}")
        raise


def spawn(fn, world: int, tmp_path, *args):
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``."""
    store, out = str(tmp_path / f"store{world}"), str(tmp_path / f"out{world}")
    for rank in range(world):
        if os.path.exists(f"{out}.{rank}"):
            os.remove(f"{out}.{rank}")
    ctx = mp.start_processes(_child, args=(world, store, out, fn, args), nprocs=world,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=120):
            pass
    except Exception:
        errors = [torch.load(f"{out}.{r}", weights_only=False).get("error")
                  for r in range(world) if os.path.exists(f"{out}.{r}")]
        raise RuntimeError("\n".join(e for e in errors if e) or "a rank failed")
    finally:
        if os.path.exists(store):
            os.remove(store)
    return [torch.load(f"{out}.{r}", weights_only=False)["ok"] for r in range(world)]
