"""How ``spans.read`` reads the program's spans, on synthetic Chrome traces.

A device operation counts for every span whose interval holds the start of
its launch (the runtime call of the same ``correlation``), on whichever
thread: a kernel the autograd thread launches while the step's thread
waits inside ``iisan.backward`` counts for the backward.  A union of
several spans counts an operation once, however its spans nest.  The
synchronising calls inside a step are counted under the innermost span of
the calling thread.  A trace without program spans gives empty spans.
"""

import json

import pytest

from h100_bench import spans
from h100_bench import trace as tracing


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _launch(corr, ts, tid=1, dur=4.0):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, dur, tid, correlation=corr)


def _kernel(name, corr, ts, dur):
    return _x(name, "kernel", ts, dur, tid=7, correlation=corr, stream=7)


def _read(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return spans.read(str(path))


def _step(t0=0.0):
    """One training step in microseconds: the step's thread (1) in
    ``iisan.inputs``, ``iisan.image_tower`` around ``iisan.attention``,
    and ``iisan.backward``, in which the autograd thread (2) runs
    ``iisan.attention`` again and launches one kernel outside it."""
    t = t0
    return [
        _x(tracing.STEP, "user_annotation", t, 1000),
        _x("iisan.step", "user_annotation", t + 10, 980),
        _x("iisan.inputs", "user_annotation", t + 20, 80),
        _launch(1 + t0, t + 30), _kernel("elementwise_a", 1 + t0, t + 40, 50),
        _x("cudaStreamSynchronize", "cuda_runtime", t + 50, 45),
        _x("iisan.image_tower", "user_annotation", t + 100, 200),
        _launch(2 + t0, t + 120), _kernel("gemm_b", 2 + t0, t + 125, 40),
        _x("iisan.attention", "user_annotation", t + 150, 100),
        _launch(3 + t0, t + 160), _kernel("mha_fwd", 3 + t0, t + 170, 90),
        _x("iisan.backward", "user_annotation", t + 400, 500),
        _x("iisan.attention", "user_annotation", t + 450, 150, tid=2),
        _launch(4 + t0, t + 500, tid=2), _kernel("mha_bwd", 4 + t0, t + 510, 190),
        _x("cudaStreamSynchronize", "cuda_runtime", t + 550, 10, tid=2),
        _x("cudaStreamSynchronize", "cuda_runtime", t + 620, 10, tid=2),
        _launch(5 + t0, t + 700, tid=2), _kernel("elementwise_c", 5 + t0, t + 710, 90),
    ]


def _ms(sp, *names):
    s = sp.device_under(*names)
    return None if s is None else 1e3 * s


def test_operations_count_under_every_span_that_holds_their_launch(tmp_path):
    events = _step() + _step(2000.0)
    # outside any step range: counted by no span
    events.append(_x("cudaDeviceSynchronize", "cuda_runtime", 3500, 5))
    sp = _read(tmp_path, events)
    assert sp.steps == 2
    # the autograd thread's kernels, in and out of its own span, are the
    # backward's: 190 + 90 us a step
    assert _ms(sp, "iisan.backward") == pytest.approx(0.28)
    # #5 inside the tower span and #6 inside the backward
    assert _ms(sp, "iisan.attention") == pytest.approx(0.28)
    assert _ms(sp, "iisan.image_tower", "iisan.text_tower") == pytest.approx(0.13)
    assert sp.device_s["iisan.step"] == pytest.approx(460e-6)
    assert sp.host_s["iisan.attention"] == pytest.approx(250e-6)
    assert sp.host_s["iisan.backward"] == pytest.approx(500e-6)
    # spans that never appear read None, never 0
    for name in ("iisan.san", "iisan.user_encoder", "iisan.loss", "iisan.optimizer",
                 "iisan.top_k.score"):
        assert _ms(sp, name) is None and name not in sp.device_s


def test_nested_spans_count_once_in_a_union(tmp_path):
    sp = _read(tmp_path, _step())
    # mha_fwd lies under the tower span and under the attention span inside it
    assert sp.device_under("iisan.image_tower", "iisan.attention") == pytest.approx(320e-6)
    assert sp.device_s["iisan.image_tower"] + sp.device_s["iisan.attention"] == \
        pytest.approx(410e-6)
    assert sp.device_under("iisan.step", "iisan.inputs", "iisan.backward") == \
        pytest.approx(460e-6)


def test_synchronising_calls_are_counted_under_their_span(tmp_path):
    events = _step() + _step(2000.0)
    events.append(_x("cudaDeviceSynchronize", "cuda_runtime", 3500, 5))
    events.append(_x("cudaMemcpyAsync", "cuda_runtime", 30, 2))  # not blocking
    sp = _read(tmp_path, events)
    # the step's thread in iisan.inputs; the autograd thread inside its own
    # attention span, then outside it, where the innermost span on any
    # thread is iisan.backward
    assert sp.syncs == {"iisan.inputs": 1.0, "iisan.attention": 1.0,
                        "iisan.backward": 1.0}


def test_serving_phases_and_host_time(tmp_path):
    events = [
        _x(tracing.STEP, "user_annotation", 0, 500),
        _x("iisan.top_k", "user_annotation", 1, 498),
        _x("iisan.top_k.prep", "user_annotation", 2, 30),
        _x("iisan.top_k.encode", "user_annotation", 40, 60),
        _x("iisan.user_encoder", "user_annotation", 45, 50),
        _launch(1, 50), _kernel("user_encoder_fwd_f32_kernel", 1, 55, 20),
        _x("iisan.top_k.score", "user_annotation", 100, 20),
        _launch(2, 105), _kernel("sm80_xmma_gemm_f32f32", 2, 110, 80),
        _x("iisan.top_k.mask", "user_annotation", 120, 20),
        _launch(3, 125), _kernel("scatter_kernel", 3, 190, 30),
        _x("iisan.top_k.select", "user_annotation", 140, 20),
        _launch(4, 145), _kernel("topk_kernel", 4, 220, 120),
        _x("iisan.top_k.fetch", "user_annotation", 160, 330),
        _x("cudaMemcpyAsync", "cuda_runtime", 165, 5),
        _x("cudaStreamSynchronize", "cuda_runtime", 170, 180),
    ]
    sp = _read(tmp_path, events)
    assert _ms(sp, "iisan.top_k.score") == pytest.approx(0.08)
    assert _ms(sp, "iisan.top_k.mask") == pytest.approx(0.03)
    assert _ms(sp, "iisan.top_k.select") == pytest.approx(0.12)
    assert _ms(sp, "iisan.top_k.encode") == _ms(sp, "iisan.user_encoder") == \
        pytest.approx(0.02)
    assert sp.host_s["iisan.top_k.prep"] == pytest.approx(30e-6)
    assert sp.syncs == {"iisan.top_k.fetch": 1.0}
    # the device idles from 340 to 500 while the host waits in the fetch
    assert sp.idle_s["iisan.top_k.fetch"] == pytest.approx(160e-6)
    assert _ms(sp, "iisan.image_tower", "iisan.text_tower") is None


def _unlabelled_trace():
    """Two steps of named kernels, host operations and runtime calls, and
    no program span."""
    events = []
    for s, t in enumerate((0.0, 1500.0)):
        events += [
            _x(tracing.STEP, "user_annotation", t, 1200),
            _x("aten::mm", "cpu_op", t + 5, 300),
            _launch(10 * s + 1, t + 10),
            _kernel("sm90_xmma_gemm_bf16bf16", 10 * s + 1, t + 20, 200),
            _launch(10 * s + 2, t + 30),
            _kernel("mha_fwd_kernel", 10 * s + 2, t + 230, 100),
            _x("aten::add", "cpu_op", t + 400, 30),
            _launch(10 * s + 3, t + 405),
            _kernel("vectorized_elementwise_kernel", 10 * s + 3, t + 500, 60),
            _x("cudaStreamSynchronize", "cuda_runtime", t + 600, 200),
            _launch(10 * s + 4, t + 900),
            _kernel("mha_bwd_kernel", 10 * s + 4, t + 905, 150),
            _launch(10 * s + 5, t + 1000),
            _kernel("multi_tensor_apply_kernel", 10 * s + 5, t + 1100, 50),
        ]
    return events


def test_a_trace_without_spans_gives_empty_spans(tmp_path):
    sp = _read(tmp_path, _unlabelled_trace())
    assert sp.steps == 2
    assert sp.device_s == sp.host_s == sp.idle_s == {}
    assert all(under == frozenset() for _, under in sp.ops) and len(sp.ops) == 10
    assert sp.device_under("iisan.step") is None
    # one synchronise a step, made outside any program span
    assert sp.syncs == {spans.OUTSIDE: 1.0}


def test_a_trace_without_step_ranges_has_no_spans(tmp_path):
    events = [e for e in _unlabelled_trace() if e["name"] != tracing.STEP]
    assert _read(tmp_path, events) is None
