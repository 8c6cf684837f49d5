"""Logging and scalar tracking.  Counterpart of ``dmtpu/utils/logger.py``."""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional


def get_logger(name: str = "exp", log_file: Optional[str] = None,
               log_level: int = logging.INFO, file_mode: str = "w",
               is_main_process: bool = True) -> logging.Logger:
    """(reference: utils/logger.py:8-37; non-main processes log at ERROR)

    A second call in one process reuses the logger only if its handlers
    match this request: the same log file, or none asked for and none
    attached.  Otherwise the old handlers are closed and replaced.
    """
    logger = logging.getLogger(name)
    want = os.path.abspath(log_file) if (is_main_process and log_file) else None
    if logger.handlers:
        have = [h.baseFilename for h in logger.handlers if isinstance(h, logging.FileHandler)]
        if (want in have) if want is not None else (not have):
            return logger
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
    logger.propagate = False
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if want is not None:
        handlers.append(logging.FileHandler(log_file, file_mode))
    formatter = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    level = log_level if is_main_process else logging.ERROR
    for h in handlers:
        h.setFormatter(formatter)
        h.setLevel(level)
        logger.addHandler(h)
    logger.setLevel(level)
    return logger


def get_tb_writer(log_dir: str):
    """A TensorBoard scalar writer (``tensorboard_writer``: no dependency)."""
    from dmtpu_torch.utils.tensorboard_writer import SummaryWriter

    os.makedirs(log_dir, exist_ok=True)
    return SummaryWriter(log_dir)


class StatusTracker:
    """Scalars to TensorBoard and a printed line every ``print_freq`` steps.
    (reference: utils/logger.py:53-81)"""

    def __init__(self, logger: logging.Logger, exp_dir: str, print_freq: int = 0):
        self.logger = logger
        self.print_freq = print_freq
        self.tb_writer = get_tb_writer(os.path.join(exp_dir, "tensorboard"))

    def close(self):
        self.tb_writer.close()

    def track_status(self, name: str, status: Dict, step: int,
                     write_tb: Optional[List[bool]] = None):
        message = f"[{name}] step: {step}"
        for i, (k, v) in enumerate(status.items()):
            v = float(v)
            message += f", {k}: {v:.6f}"
            if write_tb is None or write_tb[i]:
                self.tb_writer.add_scalar(f"{name}/{k}", v, step)
        if self.print_freq > 0 and (step + 1) % self.print_freq == 0:
            self.logger.info(message)
