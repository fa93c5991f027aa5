"""The port's run utilities against the JAX package's: logging
(``utils/logging.py``), timing and tracing (``utils/profiling.py``) and
TPME (``utils/tpme.py``).

TPME scores are equal to the JAX function's on the same records (the
normalisation is numpy in both); ``get_time`` is the JAX one; the logger
writes one file and one screen handler in the JAX format; ``StepTimer``
summarises as the JAX one; ``trace`` writes a trace file; on the CPU the
memory readers return None; ``kernel_launches`` names every counted
kernel wrapper.
"""

import logging
import os

import pytest

from iisan_tpu.utils import logging as jlogging
from iisan_tpu.utils import tpme as jtpme
from iisan_tpu_torch.utils import logging as tlogging
from iisan_tpu_torch.utils import profiling, tpme

RECORDS = [("fft", 443.0, 194_000_000, 47 << 30),
           ("iisan_cached", 22.0, 4_000_000, 3 << 30),
           ("lora", 380.0, 5_000_000, 39 << 30),
           ("no_memory", 100.0, 3_000_000, None)]


@pytest.mark.parametrize("n", [1, 3, 4])
def test_tpme_scores_are_the_jax_ones(n):
    ours = tpme.tpme_scores([tpme.RunRecord(*r) for r in RECORDS[:n]])
    theirs = jtpme.tpme_scores([jtpme.RunRecord(*r) for r in RECORDS[:n]])
    assert ours == pytest.approx(theirs, abs=1e-12)
    assert tpme.ALPHA == jtpme.ALPHA


def test_tpme_tracker_counts_what_the_optimizer_updates():
    import torch

    class Trainer:
        cfg = type("Cfg", (), {"epoch": 2})()
        model = torch.nn.Linear(4, 3)
        optimizer = torch.optim.Adam([model.weight])

    tracker = tpme.TPMETracker()
    tracker.record_run(10.0, Trainer(), label="x")
    (rec,) = tracker.runs
    assert rec.trainable_params == 12 and rec.epoch_seconds == 5.0
    assert rec.peak_memory_bytes is None  # no card here
    assert tracker.summary()["x"]["peak_mem_mb"] is None


def test_logger_and_time_lines(tmp_path):
    assert tlogging.get_time(0.0, 3725.9) == jlogging.get_time(0.0, 3725.9)
    assert tlogging.FORMAT == jlogging.FORMAT
    shared = logging.getLogger("iisan_tpu_torch")
    saved = list(shared.handlers), shared.level, shared.propagate
    try:
        logger = tlogging.setup_logger(str(tmp_path), "lab", "test")
        assert logger.name == "iisan_tpu_torch" and logger.level == logging.INFO
        assert len(logger.handlers) == 2
        logger.info("hello")
        (name,) = os.listdir(tmp_path)
        assert name.startswith("log_test_lab-") and name.endswith(".log")
        for h in logger.handlers:
            h.flush()
        assert "] hello" in (tmp_path / name).read_text()
        quiet = tlogging.setup_logger(str(tmp_path / "other"), "lab",
                                      process_index=1)
        assert quiet.level == logging.WARN and not quiet.handlers
        assert not (tmp_path / "other").exists()
    finally:  # the process's later tests find the logger as it was
        for h in shared.handlers:
            h.close()
        shared.handlers[:] = saved[0]
        shared.setLevel(saved[1])
        shared.propagate = saved[2]


def test_step_timer_trace_and_memory(tmp_path):
    import torch

    timer = profiling.StepTimer()
    assert timer.summary() == {}
    for _ in range(3):
        with timer:
            torch.ones(8).sum()
    s = timer.summary()
    assert s["n"] == 3 and 0 <= s["p50_ms"] <= s["max_ms"]
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    assert profiling.log_memory("x") is None


def test_kernel_launches_names_every_wrapper():
    counts = profiling.kernel_launches()
    assert set(counts) == {
        "user_encoder_fwd", "user_encoder_bwd", "san_cascade_fwd",
        "san_cascade_streamed_fwd", "mha_fwd", "mha_bwd", "mha_mask_replay",
        "fused_attn_subblock", "fused_attn_subblock_v2", "w8a8_quant_rows",
        "w8a8_gemm"}
    assert all(isinstance(v, int) for v in counts.values())
