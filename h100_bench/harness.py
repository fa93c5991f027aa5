"""One run of one cell: what every traffic runner shares.

``run_cell`` finds the cell in ``BENCHMARK.json``, its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json`` and
its correctness limits in ``workloads/<cell>.json``, runs the traffic's
runner (``runners/<runner>.py``), reads the cell's per-layer metrics from
``metrics/<metric>.py`` when traced, and returns the result line.  A
later cell, mix or metric is new files and a new entry in
``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "iisan_tpu")


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of ours, by path: metric files carry dots in
    their names, so they cannot be imported by name."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``iisan_tpu_torch`` is not ``iisan_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys set, nested dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclass
class Cell:
    """What a runner is given: the cell's configuration and traffic, the
    run's arguments, the device and the hooks a test plants faults with."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    hooks: Dict[str, Callable] = field(default_factory=dict)


def cell_files(workload: str, overrides: Optional[dict] = None):
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    overrides = overrides or {}
    config = merge(load_json(HERE / "configs" / f"{entry['config']}.json"),
                   overrides.get("config", {}))
    traffic = merge(load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                    overrides.get("traffic", {}))
    limits = load_json(HERE / "workloads" / f"{workload}.json")["limits"]
    return bench, entry, config, traffic, limits


def cell_metrics(bench: dict, workload: str, kind: str) -> List[dict]:
    """The cell's end-to-end (``kind="end_to_end"``) or per-layer metrics:
    those that list it, or list no cells and move a metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def worst(values) -> float:
    """The largest of ``values``, infinite where one is not a number (a
    plain ``max`` passes over NaN)."""
    vals = list(values)
    return float("inf") if any(v != v for v in vals) else max(vals, default=0.0)


def check_line(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """{name: {"value", "limit", "ok"}}; a value that is not a number at or
    under its limit fails."""
    return {k: {"value": v, "limit": limits[k], "ok": bool(v <= limits[k])}
            for k, v in numbers.items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[dict] = None,
             hooks: Optional[dict] = None, t_start: Optional[float] = None) -> dict:
    """The result line of one run: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``check`` and, traced, ``breakdown``.
    ``t_start``, the process's start on ``time.perf_counter``'s clock,
    begins the set-up time (this call's start when not given)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    bench, entry, config, traffic, limits = cell_files(workload, overrides)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            raise NoDevice(f"{workload} needs {entry['chips']} CUDA device(s); "
                           f"{torch.cuda.device_count()} visible")
    cell = Cell(config, traffic, seed, seconds, trace, device, t_start, dict(hooks or {}))
    runner = load_module(HERE / "runners" / f"{traffic['runner']}.py",
                         f"h100_bench_runner_{traffic['runner']}")
    out = runner.run(cell)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, kind):
        if kind == "end_to_end":
            value = out["end_to_end"].get(m["name"])
        else:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "h100_bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out["context"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    check = check_line(out["check"], limits)
    line = {"correct": all(c["ok"] for c in check.values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"]}
    if trace and out.get("trace") is not None:
        from .trace import breakdown

        tr = out["trace"]
        line["device"] = dict(line["device"], busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = breakdown(tr)
    line["check"] = {k: [c["value"], c["limit"]] for k, c in check.items()}
    return line
