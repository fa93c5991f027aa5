"""TPME, the paper's composite training-efficiency metric.

Port of ``iisan_tpu/utils/tpme.py``:

    TPME_i = a1 * t_hat_i + a2 * p_hat_i + a3 * m_hat_i

with min-max-normalised per-method time per epoch (t), trainable
parameters (p) and peak device memory (m), and the paper's weights
a = (0.45, 0.10, 0.45).  ``TPMETracker`` records the three raw numbers of
a run; ``tpme_scores`` normalises across any set of records.  Peak memory
is ``torch.cuda.max_memory_allocated()``.  The JAX module's
``compiled_memory_bytes`` (an XLA executable's memory analysis) has no
counterpart here.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

log = logging.getLogger("iisan_tpu_torch")

ALPHA = (0.45, 0.10, 0.45)  # the paper's weights


def device_peak_memory_bytes() -> Optional[int]:
    """Peak bytes allocated on the current card, None without one."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return int(torch.cuda.max_memory_allocated())


def trainable_param_count(trainer) -> int:
    """Parameters that the trainer's optimizer updates (0 without one)."""
    opt = getattr(trainer, "optimizer", None)
    if opt is None:
        return 0
    return int(sum(p.numel() for g in opt.param_groups for p in g["params"]))


@dataclass
class RunRecord:
    label: str
    epoch_seconds: float
    trainable_params: int
    peak_memory_bytes: Optional[int]
    # what epoch_seconds measured
    epoch_seconds_basis: str = "median measured epoch wall (train-only)"


@dataclass
class TPMETracker:
    runs: List[RunRecord] = field(default_factory=list)

    def record_run(self, total_seconds: float, trainer, label: str = "run",
                   result=None, memory_bytes: Optional[int] = None):
        """Capture one method's (t, p, m).  The epoch time is the median of
        the result's measured epoch times (the training loop's, without the
        evaluations); with none, the run's total wall time over
        ``cfg.epoch``."""
        epoch_times = getattr(result, "epoch_times", None)
        basis = "median measured epoch wall (train-only)"
        if epoch_times:
            epoch_s = float(np.median(epoch_times))
        elif hasattr(trainer, "cfg") and getattr(trainer.cfg, "epoch", 0):
            epoch_s = total_seconds / max(trainer.cfg.epoch, 1)
            basis = "total wall / cfg.epoch (fallback; includes evals)"
        else:
            epoch_s = total_seconds
            basis = "total wall (fallback; includes evals)"
        self.runs.append(RunRecord(
            label=label,
            epoch_seconds=epoch_s,
            trainable_params=trainable_param_count(trainer),
            peak_memory_bytes=memory_bytes or device_peak_memory_bytes(),
            epoch_seconds_basis=basis,
        ))

    def summary(self) -> Dict:
        return {r.label: {
            "epoch_s": round(r.epoch_seconds, 4),
            "epoch_s_basis": r.epoch_seconds_basis,
            "trainable_params": r.trainable_params,
            "peak_mem_mb": round(r.peak_memory_bytes / 2**20, 1)
            if r.peak_memory_bytes else None,
        } for r in self.runs}


def tpme_scores(records: List[RunRecord],
                alpha=ALPHA) -> Dict[str, float]:
    """Min-max-normalise t / p / m across the records and combine.  With a
    single record every normalised term is 0; a record without a memory
    reading takes the mean of the measured memory terms."""

    def norm(vals):
        vals = np.asarray(vals, dtype=np.float64)
        avail = ~np.isnan(vals)
        if not avail.any():
            return np.zeros_like(vals)
        lo, hi = vals[avail].min(), vals[avail].max()
        out = np.zeros_like(vals)
        if hi > lo:
            out[avail] = (vals[avail] - lo) / (hi - lo)
        out[~avail] = out[avail].mean()
        return out

    t = norm([r.epoch_seconds for r in records])
    p = norm([r.trainable_params for r in records])
    m = norm([float(r.peak_memory_bytes) if r.peak_memory_bytes is not None
              else np.nan for r in records])
    return {r.label: float(alpha[0] * t[i] + alpha[1] * p[i] + alpha[2] * m[i])
            for i, r in enumerate(records)}
