"""Logging.  Counterpart of ``dmtpu/utils/logger.py::get_logger``."""
from __future__ import annotations

import logging
import os
from typing import Optional


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
