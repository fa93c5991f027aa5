"""Grid sweeps over ``run_from_config``, in one process.

Port of ``iisan_tpu/sweep.py``.  The reference's sweep scripts format one
command per grid point; here a declarative grid is expanded and each point
runs in this process, on the device the caller names (default the first
CUDA card):

    from iisan_tpu_torch.sweep import run_sweep
    run_sweep(base_overrides={...}, grid={"lr": [1e-4, 2e-4], "seed": [1, 2]})

The canonical grids of the reference's shipped scripts are the launchers
``tools/run_iisan.py``, ``tools/run_baselines.py`` and
``tools/run_iisan_versa.py``, whose command lines ``add_launcher_flags``
and ``launch`` share.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import os
from typing import Any, Dict, Iterable, List, Tuple

from .config import IISANConfig

log = logging.getLogger("iisan_tpu_torch")


def expand_grid(grid: Dict[str, Iterable]) -> List[Dict[str, Any]]:
    keys = list(grid)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(grid[k] for k in keys))]


def point_label(point: Dict[str, Any]) -> str:
    """The label a grid point logs under: its values, path separators
    replaced so that the label is one file name."""
    label = "_".join(f"{k}{v}" for k, v in point.items())
    return label.replace(os.sep, "-").replace("/", "-")


def run_sweep(base_overrides: Dict[str, Any], grid: Dict[str, Iterable],
              dry_run: bool = False, device=None) -> List[Tuple[Dict, Any]]:
    """Run every grid point; returns [(point, TrainResult or None)].  Each
    point logs under its ``point_label``."""
    from .train.pipelines import run_from_config

    results = []
    for point in expand_grid(grid):
        cfg = IISANConfig(**{**base_overrides, **point})
        label = point_label(point)
        cfg = cfg.replace(label_screen=label).with_bert_dims()
        log.info("=== sweep point %s ===", label)
        if dry_run:
            results.append((point, None))
            continue
        _, res = run_from_config(cfg, device=device)
        results.append((point, res))
    return results


def add_launcher_flags(parser: argparse.ArgumentParser) -> None:
    """A launcher's two flags: ``--dry-run`` (``run_sweep``'s ``dry_run``)
    and ``--device`` (default the first CUDA card)."""
    parser.add_argument("--dry-run", action="store_true",
                        help="list the grid's points without training")
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu (default: cuda:0)")


def launch(base_overrides: Dict[str, Any], grid: Dict[str, Iterable],
           args: argparse.Namespace) -> List[Tuple[Dict, Any]]:
    """``run_sweep`` under a launcher's parsed flags; a dry run prints the
    count of points and each point's label."""
    results = run_sweep(base_overrides, grid, dry_run=args.dry_run,
                        device=args.device)
    if args.dry_run:
        print(f"{len(results)} grid point(s)")
        for point, _ in results:
            print(point_label(point))
    return results
