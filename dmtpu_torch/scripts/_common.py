"""Helpers shared by the CLIs.

Counterpart of ``scripts/_common.py``: ``base_parser``, ``load_conf``,
``diffusion_params``, ``image_shape`` and the ``.npz`` and torch-file
branches of ``load_model_params``, with ``load_torch_weights`` (the JAX
package's ``dmtpu.convert.load_torch_weights``) beside them.  The orbax
train-state directory of the JAX loader has no counterpart (the port's
checkpoints are torch files), and the data-parallel sampler is not ported:
one device.  The training CLIs share ``TrainRun`` (their flags, experiment
directory, loader, resume and loop; overrides are ``key=value`` items only:
the JAX package's ``train_dotlist`` pairs a stray token with its neighbour,
which is not carried over), ``seeded_instance`` and ``to_device``.
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
from torch import nn

from dmtpu_torch.data import DataLoader
from dmtpu_torch.parallel import step_generator
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.utils import checkpoint as ckpt_lib
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
from dmtpu_torch.utils.profiling import StepTimer


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


def start_trace(directory: str, device: torch.device) -> torch.profiler.profile:
    """A running ``torch.profiler`` trace of the host and, on a card, the
    device, written into ``directory`` as a TensorBoard trace file when it
    stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(directory))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, device: torch.device) -> None:
    """Waits for the card's queued work, then stops and writes the trace."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()


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


def to_device(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """A loader's [B, H, W, C] float32 batch -> contiguous [B, C, H, W] on
    ``device``, through pinned memory on a card."""
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x.permute(0, 3, 1, 2).contiguous()


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
    tracker: StatusTracker

    @classmethod
    def open(cls, argv: Optional[Sequence[str]], doc: str, cli: str,
             profile: bool = False) -> "TrainRun":
        """Parse ``argv`` (``train_parser``'s flags, ``--profile`` with
        ``profile``, and ``key=value`` overrides), resolve the device
        (``cuda`` without a card exits before anything is written) and
        create the experiment directory with the run's config, its log file
        and tensorboard tracker."""
        args, unknown = train_parser(doc, profile).parse_known_args(argv)
        overrides = parse_overrides(unknown)
        try:
            device = resolve_device(args.device, cli=cli)
        except RuntimeError as e:
            raise SystemExit(str(e)) from None
        time_str = get_time_str()
        exp_dir = args.exp_dir or os.path.join("runs", f"exp-{time_str}")
        conf = merge_dotlist(load_config(args.config), overrides)
        import yaml

        create_exp_dir(exp_dir, yaml.safe_dump(conf.to_dict()), exist_ok=args.resume is not None,
                       time_str=time_str, no_interaction=args.no_interaction)
        logger = get_logger(log_file=os.path.join(exp_dir, f"output-{time_str}.log"))
        tracker = StatusTracker(logger, exp_dir, print_freq=conf.train.print_freq)
        logger.info(f"Experiment directory: {exp_dir}")
        logger.info("Device: " + (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else str(device)))
        return cls(args, device, conf, exp_dir, logger, tracker)

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
        batch goes through ``to_batch`` into ``train_step``; the metrics stay
        on the device until a print, save or sample boundary or the last
        step; every ``save_freq`` steps, and at the end, a checkpoint; every
        ``sample_freq`` steps ``sample(<exp_dir>/samples/stepNNNNNN.png,
        generator)``; with ``--profile DIR``, a trace of the run's steps
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
                    tracer = start_trace(profile_dir, self.device)
                metrics = train_step(state, to_batch(next(gen)))
                timer.tick()
                if tracer is not None and step - run_start == PROFILE_STEPS[1]:
                    stop_trace(tracer, self.device)
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
                if check_freq(train.sample_freq, step):
                    sample(os.path.join(self.exp_dir, "samples", f"step{step:0>6d}.png"),
                           step_generator(self.seed, 2 ** 30 + step, self.device))
                step += 1
        finally:
            gen.close()  # stops the loader's threads
            if tracer is not None:  # the run ended inside the window
                stop_trace(tracer, self.device)
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
