"""The benchmark's files: every cell, configuration, traffic mix, limits
file and metric reader loads by its name, ``BENCHMARK.json`` keeps to the
contract's shape, and a new cell is new files only."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    # the check's budget with the full 24 cells at this run length
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load(workload):
    bench, entry, config, traffic, limits = harness.cell_files(workload)
    assert (ROOT / "h100_bench" / "runners" / f"{traffic['runner']}.py").is_file()
    assert limits and all(isinstance(v, float) for v in limits.values())
    e2e = {m["name"] for m in harness.cell_metrics(bench, workload, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(bench, workload, "per_layer")
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


@pytest.mark.parametrize("metric", PER_LAYER)
def test_metric_reader_loads(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = harness.load_module(ROOT / "h100_bench" / "metrics" / f"{metric}.py",
                                 "test_metric_" + metric.replace(".", "_"))
    assert reader.LAYER == entry["layer"] and reader.MOVES == entry["moves"]
    assert reader.read({"kind": "none", "trace": None}) is None


def test_a_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell (a smaller serving mix) through
    a traffic file, a limits file and a ``BENCHMARK.json`` entry, and runs
    it, tiny, on the CPU, with no other file touched."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "h100_bench", copy / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (copy / "h100_bench").rglob("*") if p.is_file()}
    traffic = json.loads((copy / "h100_bench/traffic/serve-topk-4m.json").read_text())
    traffic.update(catalogue_rows=300, batch_users=4, requests=3, check_requests=2,
                   reference_block=4)
    (copy / "h100_bench/traffic/serve-small.json").write_text(json.dumps(traffic))
    limits = (copy / "h100_bench/workloads/iisan-base.serve-topk-4m.json").read_text()
    (copy / "h100_bench/workloads/iisan-base.serve-small.json").write_text(limits)
    bench["workloads"].append({"name": "iisan-base.serve-small", "config": "iisan-base",
                               "traffic": "serve-small", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "iisan-base.serve-topk-4m" in m.get("workloads", []):
            m["workloads"].append("iisan-base.serve-small")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in (copy / "h100_bench").rglob("*")
             if p.is_file() and p in before}
    assert after == before
    code = ("import sys, json; sys.path.insert(0, '.'); "
            "from h100_bench.harness import run_cell; "
            "print(json.dumps(run_cell('iisan-base.serve-small', 5, 0.3, False, "
            "device='cpu', overrides={'config': {'user_encoder': {'dropout': 0.0}}})))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {
        "serve_users_per_s", "serve_p95_ms", "setup_s"}
