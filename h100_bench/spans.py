"""The program's own spans in a trace recorded with the host.

The port opens ``record_function`` ranges named ``iisan.<layer>`` while a
``torch.profiler`` records (``PROGRAM``); they share the Kineto trace's
clock with the device's operations.  ``read`` takes the host-recorded
trace that ``trace.profile`` takes for its idle labels (each step in a
``trace.STEP`` range) and gives ``Spans``: the device seconds a step of
the operations launched inside each span, the host seconds a step inside
it, the idle seconds a step while the host was inside it, and the
synchronising calls a step (``SYNC_CALLS``) by the innermost span that
made each.

A device operation belongs to every span whose interval holds the start
of its launch, the runtime call of the same ``correlation`` id, on
whichever thread: the autograd engine launches the backward's kernels
from its own thread while the step's thread waits inside
``iisan.backward``.  A union of spans counts each operation once.

Nothing in ``trace.py`` calls this yet; what ``trace.read`` computes does
not depend on it.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from h100_bench import trace as tracing

PROGRAM = "iisan."
# CUDA runtime calls that block the host until the device has caught up:
# the synchronisations themselves, and the blocking copy.  PyTorch's
# blocking copies, a device tensor made from a Python number, and
# ``.item()`` or ``int()`` of a device tensor show as ``cudaMemcpyAsync``
# followed by ``cudaStreamSynchronize``, so each counts once.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
OUTSIDE = "(no program span)"


@dataclass
class Spans:
    """What the program's spans saw, each a step: ``device_s``, ``host_s``
    and ``idle_s`` by span name (a name that never appears has no key);
    ``syncs``, the synchronising calls by the innermost span on the calling
    thread that holds the call's start (else the innermost on any thread,
    else ``OUTSIDE``); ``ops``, each device operation's seconds with the
    names of the spans its launch lies in; ``steps``, the steps traced."""
    device_s: Dict[str, float]
    host_s: Dict[str, float]
    idle_s: Dict[str, float]
    syncs: Dict[str, float]
    ops: List[Tuple[float, FrozenSet[str]]]
    steps: int

    def device_under(self, *names: str) -> Optional[float]:
        """Device seconds a step of the operations launched inside any of
        ``names`` (each counted once); None where none of them appears."""
        if not any(n in self.host_s for n in names):
            return None
        want = set(names)
        return sum(d for d, under in self.ops if under & want) / self.steps


def read(path: str) -> Optional[Spans]:
    """The spans of the trace at ``path``; None where it holds no
    ``trace.STEP`` range.  Only synchronising calls inside a step count."""
    tr = tracing.read(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges, program, syncs, launched, launches = [], [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, ts = e.get("cat"), e["name"], e["ts"] * 1e-6
        corr = e.get("args", {}).get("correlation")
        if cat in tracing.DEVICE_CATS:
            launched.append((corr, e.get("dur", 0) * 1e-6))
        elif cat == "user_annotation":
            if name == tracing.STEP:
                ranges.append((ts, ts + e.get("dur", 0) * 1e-6))
            elif name.startswith(PROGRAM):
                program.append((name, ts, ts + e.get("dur", 0) * 1e-6, e.get("tid")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if corr is not None:
                launches.setdefault(corr, ts)
            if name in SYNC_CALLS:
                syncs.append((ts, e.get("tid")))
    if not ranges:
        return None
    n = len(ranges)
    # the idle intervals of the window, as ``trace.read`` finds them
    start, end = tr.window
    merged = tracing._merge([(max(t, start), t + d) for _, t, d in tr.ops])
    edges = [start] + [x for iv in merged for x in iv] + [end]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]

    by_name: Dict[str, list] = defaultdict(list)
    for name, s, e, _ in program:
        by_name[name].append((s, e))
    intervals = {name: tracing._merge(iv) for name, iv in by_name.items()}
    starts = {name: [s for s, _ in iv] for name, iv in intervals.items()}

    def names_at(t) -> FrozenSet[str]:
        if t is None:
            return frozenset()
        out = []
        for name, iv in intervals.items():
            i = bisect_right(starts[name], t) - 1
            if i >= 0 and t <= iv[i][1]:
                out.append(name)
        return frozenset(out)

    ops = [(d, names_at(launches.get(c))) for c, d in launched]
    device: Dict[str, float] = defaultdict(float)
    for d, under in ops:
        for name in under:
            device[name] += d
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        inner = _innermost(program, 0.5 * (s + e), None)
        if inner is not None:
            idle[inner] += (e - s) / n
    calls: Dict[str, float] = defaultdict(float)
    for t, tid in syncs:
        if any(s <= t <= e for s, e in ranges):
            calls[_innermost(program, t, tid) or OUTSIDE] += 1.0 / n
    return Spans(device_s={k: v / n for k, v in device.items()},
                 host_s={k: sum(e - s for s, e in iv) / n for k, iv in intervals.items()},
                 idle_s=dict(idle), syncs=dict(calls), ops=ops, steps=n)


def _innermost(program, t, tid) -> Optional[str]:
    """The name of the shortest span holding ``t``: on thread ``tid`` where
    one there does, else on any thread; None where none does."""
    holding = [(e - s, name, th) for name, s, e, th in program if s <= t <= e]
    same = [h for h in holding if h[2] == tid]
    pick = min(same or holding, default=None)
    return None if pick is None else pick[1]
