"""The port's sweep launchers against the JAX package's scripts.

``iisan_tpu_torch.tools.run_iisan``, ``run_baselines`` and
``run_iisan_versa`` against ``scripts/run_IISAN.py``,
``scripts/run_baselines.py`` and ``scripts/run_IISAN_versa.py``, for
every dataset, method and variant of their command lines: each side's
``run_sweep`` is replaced by a recorder and each command line is run, the
JAX script as ``__main__``.  The base overrides and grids they hand to
``run_sweep`` are equal, and every grid point gives an ``IISANConfig``
equal field for field (after the sweep's label and ``with_bert_dims``).
A dry run prints the labels the JAX ``run_sweep(..., dry_run=True)``
logs, and ``DATASETS`` is ``scripts/datasets.py``'s.  Nothing trains.
"""

import dataclasses
import logging
import runpy
import sys

import pytest

import iisan_tpu.sweep as jax_sweep
from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu_torch import sweep
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.tools import run_baselines, run_iisan, run_iisan_versa
from iisan_tpu_torch.tools.datasets import DATASETS

DATASET_NAMES = ("scientific", "instrument", "office", "micro")
CASES = ([(run_iisan, "scripts.run_IISAN", [d]) for d in DATASET_NAMES]
         + [(run_baselines, "scripts.run_baselines", [m])
            for m in ("fft", "lora", "houlsby", "bitfit")]
         + [(run_iisan_versa, "scripts.run_IISAN_versa", [v, d])
            for v in ("llama", "eva", "bertlarge")
            for d in ("scientific", "micro")]
         + [(run_iisan, "scripts.run_IISAN", []),
            (run_baselines, "scripts.run_baselines", []),
            (run_iisan_versa, "scripts.run_IISAN_versa", [])])
IDS = [f"{mod.__name__.rsplit('.', 1)[1]}-{'-'.join(args) or 'default'}"
       for mod, _, args in CASES]


def _recorder(calls):
    def run_sweep(base_overrides, grid, dry_run=False, **kw):
        calls.append((dict(base_overrides), dict(grid)))
        return []
    return run_sweep


def _jax_sweep_args(monkeypatch, script, args):
    """(base, grid) that the JAX script hands to ``run_sweep``."""
    calls = []
    monkeypatch.setattr(jax_sweep, "run_sweep", _recorder(calls))
    monkeypatch.setattr(sys, "argv", [script, *args])
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script inserts "."
    runpy.run_module(script, run_name="__main__")
    assert len(calls) == 1
    return calls[0]


def _port_sweep_args(monkeypatch, module, args):
    calls = []
    monkeypatch.setattr(sweep, "run_sweep", _recorder(calls))
    module.main(args)
    assert len(calls) == 1
    return calls[0]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("module,script,args", CASES, ids=IDS)
def test_launcher_configs_equal_the_jax_scripts(monkeypatch, module, script, args):
    jax_base, jax_grid = _jax_sweep_args(monkeypatch, script, args)
    base, grid = _port_sweep_args(monkeypatch, module, args)
    assert base == jax_base
    assert grid == jax_grid
    points = sweep.expand_grid(grid)
    assert points == jax_sweep.expand_grid(jax_grid)
    for point in points:
        label = sweep.point_label(point)
        got = IISANConfig(**{**base, **point}).replace(
            label_screen=label).with_bert_dims()
        want = JaxConfig(**{**jax_base, **point}).replace(
            label_screen=label).with_bert_dims()
        assert _fields(got) == _fields(want)


@pytest.mark.parametrize("module,script,args", CASES[::3], ids=IDS[::3])
def test_dry_run_lists_the_jax_labels(monkeypatch, capsys, caplog, module,
                                      script, args):
    jax_base, jax_grid = _jax_sweep_args(monkeypatch, script, args)
    monkeypatch.undo()
    # an earlier setup_logger in this process leaves the logger unpropagated,
    # out of caplog's reach
    monkeypatch.setattr(logging.getLogger("iisan_tpu"), "propagate", True)
    with caplog.at_level(logging.INFO, logger="iisan_tpu"):
        jax_results = jax_sweep.run_sweep(jax_base, jax_grid, dry_run=True)
    jax_labels = [r.getMessage().split("=== sweep point ")[1].rstrip(" =")
                  for r in caplog.records if r.name == "iisan_tpu"
                  and "sweep point" in r.getMessage()]
    capsys.readouterr()
    results = module.main([*args, "--dry-run"])
    out = capsys.readouterr().out.splitlines()
    assert [p for p, _ in results] == [p for p, _ in jax_results]
    assert all(res is None for _, res in results)
    assert out[0] == f"{len(jax_labels)} grid point(s)"
    assert out[1:] == jax_labels
    assert len(jax_labels) == 1


def test_datasets_equal_the_jax_registry():
    from scripts.datasets import DATASETS as JAX_DATASETS

    assert DATASETS == JAX_DATASETS
    assert list(DATASETS) == list(DATASET_NAMES)


def test_launchers_refuse_unknown_names_and_take_the_device(monkeypatch):
    calls = []

    def run_sweep(base, grid, dry_run=False, device=None):
        calls.append((dry_run, device))
        return []

    monkeypatch.setattr(sweep, "run_sweep", run_sweep)
    run_baselines.main(["lora", "--device", "cpu"])
    run_iisan_versa.main(["eva", "office", "--dry-run"])
    assert calls == [(False, "cpu"), (True, None)]
    for module, args in ((run_iisan, ["nowhere"]), (run_baselines, ["qlora"]),
                         (run_iisan_versa, ["llama", "nowhere"])):
        with pytest.raises(SystemExit):
            module.main(args)
