"""Timing and tracing of the port's runs.

Port of ``iisan_tpu/utils/profiling.py``:

- ``report_time_train`` / ``report_time_eval``: the reference's timing
  lines, kept for log parity;
- ``StepTimer``: per-step host time, each timing ended by a
  ``torch.cuda.synchronize`` so it covers the device's work, with a
  percentile summary;
- ``trace``: a ``torch.profiler`` trace written by its trace handler
  (a Chrome trace under ``log_dir``);
- ``annotate``: a named region on that trace (``record_function``);
- ``log_memory``: the card's allocator statistics;
- ``kernel_launches``: the launch counts of the port's CUDA kernels, which
  ``train.pipelines.run_from_config`` logs at the end of a run.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .logging import get_time

log = logging.getLogger("iisan_tpu_torch")


def report_time_train(batch_index: int, epoch: int, loss: float,
                      set_start: float, run_start: float) -> float:
    """Per-epoch-set timing lines; returns now."""
    log.info("epoch: %d end, train_loss: %.5f", epoch, loss)
    now = time.time()
    h, m, s = get_time(set_start, now)
    log.info("##### (time) this epoch set: %d hours %d minutes %d seconds #####",
             h, m, s)
    h, m, s = get_time(run_start, now)
    log.info("##### (time) start until now: %d hours %d minutes %d seconds #####",
             h, m, s)
    return now


def report_time_eval(start: float) -> None:
    h, m, s = get_time(start, time.time())
    log.info("##### (time) eval(valid and test): %d hours %d minutes %d "
             "seconds #####", h, m, s)


def _sync() -> None:
    """Wait for the card when this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Per-step timing with a p50 / p95 / max summary; each timing ends
    with a synchronise, so it covers the work the step queued."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"n": len(a), "p50_ms": float(np.median(a) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "max_ms": float(a.max() * 1e3),
                "total_s": float(a.sum())}


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host, and the card where
    there is one), written to ``log_dir`` by the profiler's trace handler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
    log.info("profiler trace written to %s", log_dir)


def annotate(name: str):
    """Label a region so that it shows on the trace's timeline."""
    return torch.profiler.record_function(name)


def log_memory(tag: str = "") -> Optional[dict]:
    """The card's allocated and reserved MiB (current and peak), logged; None
    where this process has no card."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = torch.cuda.memory_stats()
    mb = {k: round(stats[k] / 2**20, 1) for k in (
        "allocated_bytes.all.current", "allocated_bytes.all.peak",
        "reserved_bytes.all.current", "reserved_bytes.all.peak")
        if k in stats}
    log.info("memory%s: %s", f" ({tag})" if tag else "", mb)
    return mb


def kernel_launches() -> Dict[str, int]:
    """{kernel wrapper: launches so far in this process} over every kernel
    of the port (each wrapper counts the launches of its kernel)."""
    from ..ops import fused_attention as fa
    from ..ops import fused_attn_subblock as fsb
    from ..ops import fused_san as fs
    from ..ops import fused_user_encoder as fue
    from ..ops import fused_w8a8 as fw

    wrappers = (fue.user_encoder_fwd, fue.user_encoder_bwd,
                fs.san_cascade_fwd, fs.san_cascade_streamed_fwd,
                fa.mha_fwd, fa.mha_bwd, fa.mha_mask_replay,
                fsb.fused_attn_subblock, fsb.fused_attn_subblock_v2,
                fw.w8a8_quant_rows, fw.w8a8_gemm)
    return {w.__name__: w.launches for w in wrappers}
