"""No run loads JAX or the JAX package, the reference imports nothing of
the port, and a run without a card prints no result."""

import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from h100_bench import harness

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "h100_bench"
BANNED = {"jax", "jaxlib", "flax", "iisan_tpu", "bench", "chip_smoke", "scripts"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "iisan_tpu_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "iisan_tpu.config", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["iisan_tpu", "jax"]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not {m.split(".")[0] for m in _imports(path)} & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not any(m.split(".")[0] == "iisan_tpu_torch" for m in _imports(path))


def _python(code: str, timeout: int = 600):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_reference_loads_no_module_of_the_port():
    out = _python("import sys, json; import h100_bench.reference.train, "
                  "h100_bench.reference.serve; print(json.dumps(sorted("
                  "m for m in sys.modules if m.split('.')[0] in "
                  "('iisan_tpu_torch', 'iisan_tpu', 'jax'))))")
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_runs_load_no_jax():
    """Every cell, run tiny on the CPU in a fresh process, then the
    harness's own look at ``sys.modules``."""
    code = ("import sys, json; sys.path.insert(0, 'h100_bench'); "
            "from h100_bench.harness import run_cell, forbidden_modules; "
            "from test_h100bench_reference import tiny; "
            "ws = ['iisan-base.uncached-train', 'fft-base.train-b32', "
            "'iisan-base.serve-topk-4m']; "
            "ok = [run_cell(w, 11, 0.2, False, device='cpu', overrides=tiny(w))['correct'] "
            "for w in ws]; print(json.dumps([ok, forbidden_modules(), "
            "'iisan_tpu_torch' in sys.modules]))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    ok, loaded, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(ok) and loaded == [] and port


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "iisan-base.serve-topk-4m", "--seed", str(2 ** 33),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
