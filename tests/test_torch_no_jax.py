"""The port imports no JAX and builds nothing at import time.

A fresh interpreter imports every module of iisan_tpu_torch (the trainers
included); afterwards no ``jax`` / ``flax`` / ``optax`` module and no
module of the JAX package (``iisan_tpu`` or ``iisan_tpu.*``) is loaded,
and the kernel library has not been built or loaded.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, json, pkgutil, sys
import iisan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(iisan_tpu_torch.__path__,
                                               "iisan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from iisan_tpu_torch.kernels import build
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
reference = sorted(m for m in sys.modules if m.split(".")[0] == "iisan_tpu")
print(json.dumps({"modules": names, "jax": loaded, "reference": reference,
                  "built": build._lib is not None}))
"""


def test_port_imports_no_jax_and_builds_nothing():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "iisan_tpu_torch.serve" in out["modules"]
    assert "iisan_tpu_torch.ops.fused_san" in out["modules"]
    assert "iisan_tpu_torch.train.cached" in out["modules"]
    assert "iisan_tpu_torch.train.uncached" in out["modules"]
    assert "iisan_tpu_torch.ops.fused_attention" in out["modules"]
    assert out["jax"] == [], f"JAX modules loaded by the port: {out['jax']}"
    assert out["reference"] == [], (
        f"JAX-package modules loaded by the port: {out['reference']}")
    assert not out["built"]
