"""Rank-gated logging to a file and the screen.

Port of ``iisan_tpu/utils/logging.py``: on process 0 the
``iisan_tpu_torch`` logger logs INFO to one file handler and one screen
handler with the same format; elsewhere it logs warnings only.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Tuple

import torch

FORMAT = "[%(levelname)s %(asctime)s] %(message)s"


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 when no
    group is initialised."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def setup_logger(log_dir: str, label: str, mode: str = "train",
                 process_index: int = None) -> logging.Logger:
    """The ``iisan_tpu_torch`` logger with its handlers replaced: INFO to
    ``<log_dir>/log_<mode>_<label>-<time>.log`` and the screen on process 0
    (``process_index``, default ``process_rank()``), warnings only
    elsewhere."""
    if process_index is None:
        process_index = process_rank()
    logger = logging.getLogger("iisan_tpu_torch")
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logger.propagate = False
    if process_index != 0:
        logger.setLevel(logging.WARN)
        return logger
    logger.setLevel(logging.INFO)
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("-%Y%m%d-%H%M%S", time.localtime())
    fh = logging.FileHandler(
        os.path.join(log_dir, f"log_{mode}_{label}{stamp}.log"),
        encoding="utf-8")
    fh.setFormatter(logging.Formatter(FORMAT))
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(FORMAT))
    logger.addHandler(sh)
    return logger


def get_time(start: float, end: float) -> Tuple[int, int, int]:
    """(hours, minutes, seconds) between two ``time.time()`` readings."""
    t = int(end - start)
    return t // 3600, (t // 60) % 60, t % 60
