"""Helpers shared by the CLIs.

Counterpart of ``scripts/_common.py``: ``base_parser``, ``load_conf``,
``diffusion_params``, ``image_shape`` and the ``.npz`` and torch-file
branches of ``load_model_params``, with ``load_torch_weights`` (the JAX
package's ``dmtpu.convert.load_torch_weights``) beside them.  The orbax
train-state directory of the JAX loader has no counterpart (the port's
checkpoints are torch files).  The training CLIs share ``TrainRun`` (their
flags, experiment directory, loader, mesh, resume and loop; overrides are
``key=value`` items only: the JAX package's ``train_dotlist`` pairs a stray
token with its neighbour, which is not carried over), ``seeded_instance``
and ``to_device``.  The sampling CLIs share ``DataParallelSampler``.

Under ``torchrun --nproc_per_node N`` every CLI runs on N ranks (one card
each; gloo with ``--device cpu``): a training CLI's ranks read the same
data order and each takes its rows of every batch (``TrainRun``), a
sampling CLI's ranks each sample their rows of every batch
(``DataParallelSampler``); rank 0 alone writes files and logs.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dmtpu_torch.data import DataLoader
from dmtpu_torch.parallel import make_mesh, shard_batch, shard_train_state, step_generator
from dmtpu_torch.parallel.mesh import all_gather_cat, init_distributed, is_main, launched
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.utils import checkpoint as ckpt_lib
from dmtpu_torch.utils.rows import RowGenerator
from dmtpu_torch.utils.config import Config, instantiate_from_config, load_config, merge_dotlist
from dmtpu_torch.utils.logger import StatusTracker, get_logger
from dmtpu_torch.utils.misc import (
    check_freq,
    create_exp_dir,
    find_resume_checkpoint,
    get_data_generator,
    get_time_str,
)
from dmtpu_torch.utils.optim import lr_fn
from dmtpu_torch.utils.profiling import StepTimer, trace


def base_parser(description: Optional[str] = None) -> argparse.ArgumentParser:
    """The flags every sampling CLI takes, plus ``--device``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--respace_type", type=str, default="uniform")
    p.add_argument("--respace_steps", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def train_parser(doc: str, profile: bool = False) -> argparse.ArgumentParser:
    """The flags every training CLI takes: ``-c -e -r -ni`` and ``--device``;
    with ``profile``, ``--profile DIR`` too."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("-e", "--exp_dir", type=str)
    p.add_argument("-r", "--resume", type=str,
                   help="resume from a checkpoint: a path, `best` or `latest`")
    p.add_argument("-ni", "--no_interaction", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    if profile:
        first, last = PROFILE_STEPS
        p.add_argument("--profile", type=str, default=None,
                       help=f"write a torch.profiler trace of the run's steps {first}-{last} "
                            "into this directory")
    return p


# the steps of a run (counted from its first, resumed or not) that a
# ``--profile`` trace covers, first and last
PROFILE_STEPS = (10, 15)


def parse_overrides(unknown: Sequence[str]) -> List[str]:
    """``key=value`` items (leading dashes dropped); anything else is an
    error, never a value paired with its neighbour."""
    bad = [a for a in unknown if "=" not in a]
    if bad:
        raise SystemExit(f"unrecognized arguments: {bad} (config overrides are key=value)")
    return [a.lstrip("-") for a in unknown]


def seeded_instance(conf: Mapping, device: torch.device, seed: int) -> Any:
    """The object of the config block ``conf`` (``target`` / ``params``)
    built on ``device`` with its modules' own initialisation, drawn from the
    device's generator seeded with ``seed``; the caller's generator state is
    left as it was."""
    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices, device_type="cuda"):
        torch.manual_seed(seed)
        return instantiate_from_config(conf, device=device)


def open_device(requested: str, cli: str) -> torch.device:
    """The device of a CLI's ``--device`` (``cuda`` without a card exits
    before anything is written); under ``torchrun`` the process group is
    started and the device is this rank's (``cuda:LOCAL_RANK``)."""
    try:
        device = resolve_device(requested, cli=cli)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    return init_distributed(device) if launched() else device


class DataParallelSampler:
    """Data-parallel sampling over the ranks of a ``torchrun`` launch
    (reference: scripts/sample_uncond.py:183-190's amortize and
    ``accelerator.gather``), as the JAX package's ``DataParallelSampler``
    shards a batch over its devices.  A batch is padded by wrapping its rows
    to a multiple of the rank count; each rank samples its block of the
    padded rows; the rows are gathered on every rank and trimmed.  The
    sampling gets ``row_generator(generator, batch)`` in place of its
    generator: its per-row draws are the one-rank run's draws for the whole
    batch, at the rank's rows (``utils/rows.py``), so a padded row draws
    what its original draws and the result is the one-rank result.  One
    rank (no launch): everything is the identity.  Only ``is_main`` writes
    files.

    Usage::

        dp = DataParallelSampler()
        out = dp.run(lambda noise, generator: sampler.sample(model_fn, noise, generator),
                     noise, generator=generator)
    """

    def __init__(self):
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.is_main = self.rank == 0

    def rows(self, batch: int) -> np.ndarray:
        """This rank's rows (indices into ``batch``) of the batch padded by
        wrapping to a multiple of the rank count."""
        padded = batch + (-batch) % self.world
        per = padded // self.world
        return np.arange(self.rank * per, (self.rank + 1) * per) % batch

    def pad_shard(self, batch_tree: Any) -> Tuple[Any, int]:
        """(this rank's padded rows of every tensor of ``batch_tree`` (a
        tensor, or a tuple / list / dict of them), the true batch size)."""
        leaves = (list(batch_tree.values()) if isinstance(batch_tree, dict) else
                  list(batch_tree) if isinstance(batch_tree, (tuple, list)) else [batch_tree])
        b = leaves[0].shape[0]
        if self.world == 1:
            return batch_tree, b
        idx = self.rows(b)

        def one(x):
            if x.shape[0] != b:
                raise ValueError(f"batch-axis mismatch: {x.shape[0]} != {b}")
            return x[torch.as_tensor(idx, device=x.device) if torch.is_tensor(x) else idx]

        if isinstance(batch_tree, dict):
            return {k: one(v) for k, v in batch_tree.items()}, b
        if isinstance(batch_tree, (tuple, list)):
            return type(batch_tree)(one(v) for v in batch_tree), b
        return one(batch_tree), b

    def row_generator(self, generator: Optional[torch.Generator], batch: int) -> Any:
        """``generator`` for this rank's rows of a batch of ``batch``: a
        ``RowGenerator`` over ranks, the generator itself on one."""
        if self.world == 1 or generator is None:
            return generator
        return RowGenerator(generator, batch, torch.as_tensor(self.rows(batch)))

    def gather(self, out: torch.Tensor, true_bs: int, dim: int = 0) -> torch.Tensor:
        """The rows of every rank along ``dim``, on every rank, trimmed to
        ``true_bs``."""
        if self.world == 1:
            return out
        return all_gather_cat(out, dim).narrow(dim, 0, true_bs)

    def run(self, fn: Callable[..., Any], *batch: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> Any:
        """``fn(*batch)`` for the whole batch, each rank computing its rows
        (with ``generator``: ``fn(*batch, generator=...)``, handed the
        rank's ``row_generator``); ``fn``'s output (a tensor or a tuple of
        them, batch first) gathered."""
        local, b = self.pad_shard(tuple(batch))
        kw = {} if generator is None else {"generator": self.row_generator(generator, b)}
        out = fn(*local, **kw)
        if isinstance(out, tuple):
            return tuple(self.gather(o, b) for o in out)
        return self.gather(out, b)


def to_device(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """A loader's [B, H, W, C] float32 batch -> contiguous [B, C, H, W] on
    ``device``, through pinned memory on a card."""
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x.permute(0, 3, 1, 2).contiguous()


class _QuietTracker:
    """A rank's tracker other than rank 0's: it writes and logs nothing."""

    def track_status(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


@dataclasses.dataclass
class TrainRun:
    """One run of a training CLI (``train_sd``, ``train_ddpm``,
    ``train_ddpm_cfg``, ``train_mmdit``): its flags, device, config, experiment directory,
    logger and status tracker, and the parts of the reference's train
    scripts that do not depend on the model: the loader, the resume and the
    loop."""

    args: argparse.Namespace
    device: torch.device
    conf: Config
    exp_dir: str
    logger: logging.Logger
    tracker: Any
    mesh: Any = None

    @classmethod
    def open(cls, argv: Optional[Sequence[str]], doc: str, cli: str,
             profile: bool = False) -> "TrainRun":
        """Parse ``argv`` (``train_parser``'s flags, ``--profile`` with
        ``profile``, and ``key=value`` overrides), resolve the device
        (``cuda`` without a card exits before anything is written) and
        create the experiment directory with the run's config, its log file
        and tensorboard tracker.  Under ``torchrun`` the ranks form a
        data-parallel mesh (fsdp 1, as the JAX CLIs' ``make_mesh()``), share
        rank 0's experiment directory, and only rank 0 writes it."""
        args, unknown = train_parser(doc, profile).parse_known_args(argv)
        overrides = parse_overrides(unknown)
        device = open_device(args.device, cli)
        main = is_main()
        time_str = get_time_str()
        if dist.is_initialized():  # every rank takes rank 0's name for the run
            shared = [time_str]
            dist.broadcast_object_list(shared, src=0)
            time_str = shared[0]
        exp_dir = args.exp_dir or os.path.join("runs", f"exp-{time_str}")
        conf = merge_dotlist(load_config(args.config), overrides)
        import yaml

        if main:
            create_exp_dir(exp_dir, yaml.safe_dump(conf.to_dict()),
                           exist_ok=args.resume is not None, time_str=time_str,
                           no_interaction=args.no_interaction)
        if dist.is_initialized():
            dist.barrier()
        logger = get_logger(log_file=os.path.join(exp_dir, f"output-{time_str}.log"),
                            is_main_process=main)
        tracker = (StatusTracker(logger, exp_dir, print_freq=conf.train.print_freq) if main
                   else _QuietTracker())
        mesh = make_mesh(device.type) if launched() else None
        logger.info(f"Experiment directory: {exp_dir}")
        logger.info("Device: " + (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else str(device))
                    + (f" x {mesh.size()} ranks, mesh {tuple(mesh.shape)}" if mesh else ""))
        return cls(args, device, conf, exp_dir, logger, tracker, mesh)

    def place(self, state):
        """``state`` placed on the run's mesh (``shard_train_state``; as it
        is without one).  Call before ``resume``."""
        return state if self.mesh is None else shard_train_state(state, self.mesh)

    @property
    def seed(self) -> int:
        return self.conf.get("seed", 0)

    @property
    def micro_batches(self) -> int:
        """Splits of a batch (``train.micro_batch``; 0 or absent: one)."""
        batch_size = self.conf.train.batch_size
        return max(1, batch_size // (self.conf.train.get("micro_batch", 0) or batch_size))

    def loader(self) -> DataLoader:
        """The shuffled loader of ``conf.data`` (whole batches, ``seed``,
        the ``dataloader`` block's settings)."""
        batch_size = self.conf.train.batch_size
        train_set = instantiate_from_config(self.conf.data)
        loader = DataLoader(train_set, batch_size=batch_size, shuffle=True, drop_last=True,
                            seed=self.seed, **self.conf.get("dataloader", {}))
        self.logger.info(f"Size of training set: {len(train_set)}")
        if len(loader) == 0:
            raise ValueError(f"the training set holds {len(train_set)} items, fewer than a "
                             f"batch of {batch_size}")
        return loader

    def resume(self, state) -> Optional[float]:
        """With ``-r``, restore its checkpoint into ``state`` and return the
        seconds the load took; else None."""
        if self.args.resume is None:
            return None
        path = find_resume_checkpoint(self.exp_dir, self.args.resume)
        t0 = time.perf_counter()
        ckpt_lib.load_checkpoint(path, state)
        seconds = time.perf_counter() - t0
        self.logger.info(f"Resumed from {path} at step {state.step}")
        return seconds

    def train(self, state, train_step: Callable, loader: DataLoader,
              to_batch: Callable[[Any], Any],
              sample: Callable[[str, torch.Generator], None]) -> Dict[str, Any]:
        """The loop from ``state.step`` to ``train.n_steps``: each loader
        batch (this rank's rows of it, micro-batch by micro-batch, under a
        mesh) goes through ``to_batch`` into ``train_step``; the metrics stay
        on the device until a print, save or sample boundary or the last
        step; every ``save_freq`` steps, and at the end, a checkpoint; every
        ``sample_freq`` steps ``sample(<exp_dir>/samples/stepNNNNNN.png,
        generator)`` on rank 0; with
        ``--profile DIR``, a trace of the run's steps
        ``PROFILE_STEPS`` into DIR.  Returns what the run measured: the
        steps' host times between ticks (``step_seconds``, from the second
        step of the run on), the seconds of each save, the logged losses and
        the experiment directory (``load_seconds`` is the caller's)."""
        train = self.conf.train
        lr_at = lr_fn(train.optim)
        result: Dict[str, Any] = {"exp_dir": self.exp_dir, "save_seconds": [], "losses": []}
        step = run_start = state.step
        profile_dir, tracer = getattr(self.args, "profile", None), None

        def save_ckpt() -> None:
            t0 = time.perf_counter()
            ckpt_lib.save_checkpoint(os.path.join(self.exp_dir, "ckpt"), step, state)
            result["save_seconds"].append(time.perf_counter() - t0)

        self.logger.info("Start training...")
        gen = get_data_generator(loader)
        timer = StepTimer()
        pending = []
        try:
            while step < train.n_steps:
                if profile_dir and step - run_start == PROFILE_STEPS[0]:
                    tracer = trace(profile_dir).start()
                metrics = train_step(state, to_batch(
                    shard_batch(next(gen), self.mesh, self.micro_batches)))
                timer.tick()
                if tracer is not None and step - run_start == PROFILE_STEPS[1]:
                    tracer.stop()
                    tracer = None
                    self.logger.info(f"Wrote profiler trace to {profile_dir}")
                # the throughput is read at tick time, so each logged step
                # keeps its own reading; the metrics stay on the device until
                # a print
                pending.append((step, metrics, timer.throughput(train.batch_size)))
                if check_freq(train.print_freq, step) or check_freq(train.save_freq, step) \
                        or check_freq(train.sample_freq, step) or step + 1 == train.n_steps:
                    for s, m, tput in pending:
                        loss = float(m["loss"])
                        result["losses"].append(loss)
                        self.tracker.track_status(
                            "Train", {"loss": loss, "grad_norm": m["grad_norm"], "lr": lr_at(s),
                                      "imgs_per_sec": tput}, s)
                    pending.clear()
                if check_freq(train.save_freq, step):
                    save_ckpt()
                if check_freq(train.sample_freq, step) and is_main():
                    sample(os.path.join(self.exp_dir, "samples", f"step{step:0>6d}.png"),
                           step_generator(self.seed, 2 ** 30 + step, self.device))
                step += 1
        finally:
            gen.close()  # stops the loader's threads
            if tracer is not None:  # the run ended inside the window
                tracer.stop()
                self.logger.info(f"Wrote profiler trace to {profile_dir}")
        if not check_freq(train.save_freq, step - 1):
            step -= 1
            save_ckpt()
        self.tracker.close()
        self.logger.info("End of training")
        result["step_seconds"] = list(timer.times)
        return result


def load_conf(args: argparse.Namespace, unknown: Sequence[str]) -> Config:
    """The config file with ``key=value`` overrides merged over it.

    ``--key=value`` is taken too (the dashes are stripped); anything else
    among the unknown arguments is a mistyped flag and aborts rather than
    being dropped."""
    overrides, bad = [], []
    for a in unknown:
        if "=" in a:
            overrides.append(a.lstrip("-"))
        else:
            bad.append(a)
    if bad:
        raise SystemExit(f"unrecognized arguments: {bad} (config overrides must be key=value)")
    return merge_dotlist(load_config(args.config), overrides)


def diffusion_params(args: argparse.Namespace, conf: Mapping, **extra: Any) -> Dict[str, Any]:
    """The sampler's constructor arguments: the config's
    ``diffusion.params``, the CLI's respacing when ``--respace_steps`` is
    given, then ``extra``; the reference's ``device`` key is dropped."""
    params = dict(conf["diffusion"].get("params", None) or {})
    if args.respace_steps is not None:
        params.update(respace_type=args.respace_type, respace_steps=args.respace_steps)
    params.pop("device", None)
    params.update(extra)
    return params


def image_shape(conf: Mapping) -> Tuple[int, int, int]:
    """(C, H, W) of the config's images (NCHW; the JAX helper gives HWC)."""
    s = conf["data"]["params"]["img_size"]
    return (conf["data"].get("img_channels", 3), s, s)


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file as a flat state dict: ``.safetensors``, or a torch
    file holding the state dict itself or under ``state_dict``,
    ``ema.shadow`` or ``model`` (reference: utils/load.py:7-19)."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError("loading a .safetensors file needs the `safetensors` package") from e
        return dict(load_file(path))
    weights = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in weights:
        weights = weights["state_dict"]
    elif "ema" in weights:
        weights = weights["ema"]["shadow"]
    elif "model" in weights:
        weights = weights["model"]
    return {k: torch.as_tensor(v) for k, v in weights.items()}


def load_npz_params(path: str) -> Dict[str, Any]:
    """The params tree of a JAX-package ``.npz`` export (``params`` as a
    pickled object array: the JAX package's own file, read as it reads it)."""
    with np.load(path, allow_pickle=True) as data:
        return data["params"].item()


def load_model_params(path: str, model: nn.Module,
                      converter: Optional[Callable[[Dict[str, torch.Tensor], nn.Module],
                                                   Dict[str, Any]]] = None) -> nn.Module:
    """``model`` with the weights of ``path`` loaded: a JAX-package ``.npz``
    export (through the Flax bridge) or a torch file, in ``model``'s keys or
    mapped onto them by ``converter(state_dict, model)`` (``sample_mmdit``
    passes ``convert_mmdit`` for the SD3 release layout).  A ``UNetCombined``
    also takes two upstream files, ``COND,UNCOND`` (guided-diffusion's
    class-conditional and unconditional releases), combined by
    ``UNetCombined.combine_state_dicts``.  Returns the model."""
    from dmtpu_torch.models.adm import UNetCombined

    if isinstance(model, UNetCombined) and "," in path:
        cond, uncond = path.split(",")
        model.load_state_dict(UNetCombined.combine_state_dicts(load_torch_weights(cond),
                                                               load_torch_weights(uncond)))
        return model
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: the JAX package's orbax train states are not read here; "
            "give a .npz export or a torch file")
    if path.endswith(".npz"):
        from dmtpu_torch.convert import load_flax_params

        return load_flax_params(model, load_npz_params(path))
    state_dict = load_torch_weights(path)
    model.load_state_dict(converter(state_dict, model) if converter else state_dict)
    return model
