"""The port imports no JAX and builds nothing at import time.

A fresh interpreter imports every module of iisan_tpu_torch (the trainers
included, and the run path: the command line, the pipelines, the sweep
and the utilities); afterwards no ``jax`` / ``flax`` / ``optax`` /
``orbax`` module, no module of the JAX package (``iisan_tpu`` or
``iisan_tpu.*``) or of its ``scripts/`` (which the port's launchers and
TPME report replace) and no ``transformers`` module (the GPU machine has none:
the ``params_from_*`` importers read a state dict without it,
``load_tokenizer`` returns the port's WordPiece tokenizer, and the
cache-build command line imports it only when called) is loaded, and
neither the kernel library nor the JPEG decoder (``data/fastimage.py``)
has been built or loaded.  The same holds for the module the rank tests
start their worlds from (``tests/test_torch_ranks.py``), which is imported in
the same interpreter; every spawned rank also reports what it loaded
(``test_torch_ranks.run_world`` fails on any such module).
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
sys.path.insert(0, "tests")
import test_torch_ranks
from iisan_tpu_torch.kernels import build
from iisan_tpu_torch.data import fastimage
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "orbax"))
reference = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("iisan_tpu", "scripts"))
hf = sorted(m for m in sys.modules if m.split(".")[0] == "transformers")
print(json.dumps({"modules": names, "jax": loaded, "reference": reference,
                  "transformers": hf,
                  "built": build._lib is not None or fastimage._lib is not None}))
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
    assert "iisan_tpu_torch.ops.quant" in out["modules"]
    assert "iisan_tpu_torch.data.cache_store" in out["modules"]
    assert "iisan_tpu_torch.train.pipelines" in out["modules"]
    assert "iisan_tpu_torch.ops.int8_linear" in out["modules"]
    assert "iisan_tpu_torch.ops.fused_w8a8" in out["modules"]
    assert "iisan_tpu_torch.ops.fused_attn_subblock" in out["modules"]
    assert "iisan_tpu_torch.models.peft" in out["modules"]
    for name in ("data.preprocess", "cache_builder", "tools.build_caches",
                 "models.llama", "models.clip_vit", "models.eva", "cli",
                 "train.pipelines", "train.id_pipeline", "sweep",
                 "utils.logging", "utils.checkpoint", "utils.profiling",
                 "utils.tpme", "utils.torch_import", "utils.jax_params",
                 "data.lmdbfile", "data.fastimage", "data.images",
                 "data.wordpiece", "tools.build_lmdb", "utils.flops",
                 "parallel", "parallel.mesh", "parallel.distributed",
                 "tools.datasets", "tools.run_iisan", "tools.run_baselines",
                 "tools.run_iisan_versa", "tools.tpme_single",
                 "tools.tpme_report"):
        assert f"iisan_tpu_torch.{name}" in out["modules"]
    assert out["jax"] == [], f"JAX modules loaded by the port: {out['jax']}"
    assert out["reference"] == [], (
        f"JAX-package modules loaded by the port: {out['reference']}")
    assert out["transformers"] == [], (
        f"transformers modules loaded by the port: {out['transformers'][:5]}")
    assert not out["built"]
