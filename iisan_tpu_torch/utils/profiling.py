"""Timing lines, spans and kernel counters of the port's runs.

Port of ``iisan_tpu/utils/profiling.py``:

- ``report_time_eval``: the reference's evaluation timing line, kept for
  log parity;
- ``annotate``: the port's span helper.  Each layer boundary on the hot
  path opens a span named ``iisan.<layer>`` (the training step, its
  inputs, the towers, the side network, the user encoder, the loss, the
  backward, the optimizer, the tower attention; ``Recommender.top_k`` and
  its phases).  While a ``torch.profiler`` records, a span is a
  ``record_function`` range, so it lands in the same trace as the
  device's operations, on one clock; otherwise it is one shared no-op
  context, so the hot path pays a check and no more;
- ``kernel_launches``: the launch counts of the port's CUDA kernels, which
  ``train.pipelines.run_from_config`` logs at the end of a run.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

from .logging import get_time

log = logging.getLogger("iisan_tpu_torch")

_NO_SPAN = contextlib.nullcontext()


def report_time_eval(start: float) -> None:
    h, m, s = get_time(start, time.time())
    log.info("##### (time) eval(valid and test): %d hours %d minutes %d "
             "seconds #####", h, m, s)


def annotate(name: str):
    """A span named ``name``: a ``record_function`` range while a profiler
    records, else the shared no-op context.  The profiler's state is read
    here, at each span's entry.  Torch offers no public check of it; the
    flag read is the one its profilers set on start and clear on stop, and
    costs a module attribute lookup, where an ungated ``record_function``
    costs about ten microseconds a span with no profiler running."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
