"""Grid sweeps over ``run_from_config``, in one process.

Port of ``iisan_tpu/sweep.py``.  The reference's sweep scripts format one
command per grid point; here a declarative grid is expanded and each point
runs in this process, on the device the caller names (default the first
CUDA card):

    from iisan_tpu_torch.sweep import run_sweep
    run_sweep(base_overrides={...}, grid={"lr": [1e-4, 2e-4], "seed": [1, 2]})
"""

from __future__ import annotations

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


def run_sweep(base_overrides: Dict[str, Any], grid: Dict[str, Iterable],
              dry_run: bool = False, device=None) -> List[Tuple[Dict, Any]]:
    """Run every grid point; returns [(point, TrainResult or None)].  Each
    point logs under a label made of its values, path separators replaced
    so that the label is one file name."""
    from .train.pipelines import run_from_config

    results = []
    for point in expand_grid(grid):
        cfg = IISANConfig(**{**base_overrides, **point})
        label = "_".join(f"{k}{v}" for k, v in point.items())
        label = label.replace(os.sep, "-").replace("/", "-")
        cfg = cfg.replace(label_screen=label).with_bert_dims()
        log.info("=== sweep point %s ===", label)
        if dry_run:
            results.append((point, None))
            continue
        _, res = run_from_config(cfg, device=device)
        results.append((point, res))
    return results
