"""Tracing a few steps or calls with ``torch.profiler``.

``profile`` traces ``n`` steps twice.  The first trace records the
device's activity alone, so the host runs at its own pace: its kernels,
copies and fills give the window (from the first device operation to the
last), the busy time (the union of the operations) and every per-layer
metric.  The second, of ``label_steps`` steps, records the host's
operations too, each step in a ``record_function`` range named ``STEP``;
the idle gaps between device operations there are labelled by the
innermost host operation running at each gap's middle (``STEP`` itself
where the host was between operations of the step).  Recording the host
slows it, so the second trace's gaps are longer than the first's; they
say what the host was doing, the first trace how long the device idled.
"""

from __future__ import annotations

import heapq
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

STEP = "h100_bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# Kernel families by name (lower case); the first family with a matching
# pattern wins.
GEMM = ("gemm", "xmma", "cutlass", "splitk", "nvjet", "cublas", "sm90_xmma",
        "subblock", "w8a8")
PORT = ("mha_", "user_encoder", "cascade", "philox", "mask_replay")
ADAM = ("adam", "multi_tensor")


def family(name: str) -> str:
    key = name.lower()
    for fam, pats in (("gemm", GEMM), ("port", PORT), ("adam", ADAM)):
        if any(p in key for p in pats):
            return fam
    return "other"


@dataclass
class Trace:
    ops: List[Tuple[str, float, float]]          # device ops: name, start s, seconds
    window: Tuple[float, float]                  # s
    steps: int
    busy_s: float
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # host label, s

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def seconds_where(self, pred) -> float:
        """Device seconds of the operations whose name satisfies ``pred``."""
        return sum(d for n, _, d in self.ops if pred(n))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            out[n] += d
        return dict(out)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(path: str, steps: int = 0) -> Trace:
    """The trace at ``path``: its window runs from the first ``STEP``
    range, or without one from the first device operation, to the last
    device operation or range; ``steps`` counts the steps where no range
    does."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, ranges, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        if cat in DEVICE_CATS:
            ops.append((e["name"], ts, dur))
        elif cat in HOST_CATS:
            host.append((e["name"], ts, dur))
            if e["name"] == STEP and cat == "user_annotation":
                ranges.append((ts, ts + dur))
    if not ranges and not ops:
        raise RuntimeError("the trace holds neither a step nor a device operation")
    start = min(s for s, _ in ranges) if ranges else min(t for _, t, _ in ops)
    end = max([e for _, e in ranges] + [t + d for _, t, d in ops])
    ops = [o for o in ops if o[1] + o[2] > start]
    merged = _merge([(max(t, start), t + d) for _, t, d in ops])
    busy = sum(e - s for s, e in merged)
    edges = [start] + [x for iv in merged for x in iv] + [end]
    spans = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    return Trace(ops=ops, window=(start, end), steps=len(ranges) or steps,
                 busy_s=busy, gaps=_label(spans, host) if ranges else [])


def _label(spans, host):
    """(label, seconds) of each idle span: the shortest host operation
    that covers its middle, found in one sweep over both in time order."""
    host = sorted(host, key=lambda h: h[1])
    active, j, out = [], 0, []
    for s, e in sorted(spans, key=lambda sp: sp[0] + sp[1]):
        mid = 0.5 * (s + e)
        while j < len(host) and host[j][1] <= mid:
            name, t, d = host[j]
            heapq.heappush(active, (t + d, d, name))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        covering = [(d, n) for end, d, n in active if end >= mid]
        label = min(covering)[1] if covering else "host: no traced operation"
        out.append(("host: Python inside the step" if label == STEP else label, e - s))
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each at most ``top`` [name, seconds] pairs."""
    idle: Dict[str, float] = defaultdict(float)
    for label, s in trace.gaps:
        idle[label] += s
    ops = sorted(trace.by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in gaps]}


def profile(one_step, n: int, device, label_steps: int = 2) -> Trace:
    """``n`` calls of ``one_step(i)`` traced on the device alone, and
    ``label_steps`` more traced with the host for the idle gaps' labels;
    the trace files go under the run's TMPDIR and are deleted."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    cuda = torch.device(device).type == "cuda"

    def traced(acts, count, first, ranged):
        if cuda:
            torch.cuda.synchronize(device)
        with torch_profile(activities=acts) as prof:
            for i in range(first, first + count):
                if ranged:
                    with record_function(STEP):
                        one_step(i)
                else:
                    one_step(i)
            if cuda:
                torch.cuda.synchronize(device)
        fd, path = tempfile.mkstemp(prefix="h100_bench_", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            return read(path, count)
        finally:
            os.unlink(path)

    host = [ProfilerActivity.CPU]
    if not cuda:
        return traced(host, n, 0, True)
    main = traced([ProfilerActivity.CUDA], n, 0, False)
    main.gaps = traced(host + [ProfilerActivity.CUDA], label_steps, n, True).gaps
    return main
