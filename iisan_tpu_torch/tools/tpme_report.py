"""TPME across methods: the paper's efficiency table, on the port.

Port of ``scripts/tpme_report.py``.  Runs every method in its own process
(``python -m iisan_tpu_torch.tools.tpme_single``), collects each one's
(t, p, m), scores TPME with the paper's weights alpha = (0.45, 0.10, 0.45)
(``utils/tpme.tpme_scores``), prints the table sorted by score and writes
``{"alpha", "records", "tpme"}`` to ``TPME_torch.json``:

    python -m iisan_tpu_torch.tools.tpme_report [method ...] [--merge]
        [--users N] [--lmdb PATH] [--device cpu] [--out DIR]

Default methods: all six.  ``--users``, ``--lmdb`` and ``--device`` are
passed to every method's process.  The records are also written to
``TPME_torch_partial.json`` after each method.  ``--merge`` starts from the
records of earlier runs in ``DIR`` (``TPME_torch.json``, then the partial
file, whose records win) for the methods not measured now, and keeps an
earlier record of a method whose process fails.  A process that runs out
of device memory (``torch.OutOfMemoryError``) is run once more, in a new
process, with ``--remat`` (tower remat), and its record says so.  Any
other failure ends the report with exit code 1, unless ``--merge`` has an
earlier record of that method.  Runs from any working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from .tpme_single import METHODS

OUT_NAME, PARTIAL_NAME = "TPME_torch.json", "TPME_torch_partial.json"
PACKAGE_ROOT = Path(__file__).resolve().parents[2]
CHILD = (sys.executable, "-m", "iisan_tpu_torch.tools.tpme_single")
OOM_MARKERS = ("torch.OutOfMemoryError", "CUDA out of memory")


def _run(child, method: str, extra) -> subprocess.CompletedProcess:
    """One method's process, with this package first on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
    return subprocess.run([*child, method, *extra], capture_output=True,
                          text=True, env=env)


def measure(child, method: str, extra):
    """(record, None) or (None, the failed process): the retry with
    ``--remat`` after an out-of-memory failure, in a new process."""
    res = _run(child, method, extra)
    if res.returncode != 0 and any(m in res.stderr for m in OOM_MARKERS):
        print("  out of device memory - running again with --remat",
              flush=True)
        res = _run(child, method, [*extra, "--remat"])
    if res.returncode != 0:
        return None, res
    return json.loads(res.stdout.strip().splitlines()[-1]), None


def prior_records(out: Path) -> dict:
    """{label: record} of the earlier runs' files in ``out``."""
    prior = {}
    if (out / OUT_NAME).exists():
        prior.update((r["label"], r)
                     for r in json.loads((out / OUT_NAME).read_text())["records"])
    if (out / PARTIAL_NAME).exists():
        prior.update((r["label"], r)
                     for r in json.loads((out / PARTIAL_NAME).read_text()))
    return prior


def _mib(n) -> str:
    return "n/a" if n is None else f"{n / 2**20:.0f}"


def print_table(records, scores, alpha) -> None:
    print(f"\nTPME (alpha={tuple(alpha)}; lower is better)")
    for dev in sorted({r.get("device", "not recorded") for r in records}):
        print(f"device: {dev}")
    print(f"{'method':<16}{'epoch_s':>10}{'e2e_s':>10}{'params':>14}"
          f"{'mem_MiB':>10}{'TPME':>8}  remat")
    for r in sorted(records, key=lambda r: scores[r["label"]]):
        e2e = r.get("epoch_seconds_e2e")
        print(f"{r['label']:<16}{r['epoch_seconds']:>10.2f}"
              f"{'-' if e2e is None else f'{e2e:.2f}':>10}"
              f"{r['trainable_params']:>14,}{_mib(r.get('memory_bytes')):>10}"
              f"{scores[r['label']]:>8.3f}  {bool(r.get('remat_towers'))}")


def main(argv=None, child=CHILD) -> int:
    """The report; returns the exit code.  ``child``: the command a
    method's process runs, before the method and its flags."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("methods", nargs="*", metavar="method",
                    help=" | ".join(METHODS) + " (default: all)")
    ap.add_argument("--merge", action="store_true")
    ap.add_argument("--users", type=int, default=None)
    ap.add_argument("--lmdb", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=".", help="directory of the JSON files")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.methods) - set(METHODS))
    if unknown:
        ap.error(f"unknown method(s) {unknown}; choose from {list(METHODS)}")
    methods = args.methods or list(METHODS)
    extra = []
    if args.users is not None:
        extra += ["--users", str(args.users)]
    if args.lmdb is not None:
        extra += ["--lmdb", os.path.abspath(args.lmdb)]
    if args.device is not None:
        extra += ["--device", args.device]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    prior = prior_records(out) if args.merge else {}
    records = [r for label, r in prior.items() if label not in methods]
    for m in methods:
        print(f"measuring {m} ...", flush=True)
        rec, failed = measure(child, m, extra)
        if failed is not None:
            print(f"  FAILED (exit {failed.returncode}): "
                  f"{failed.stderr[-1500:]}", file=sys.stderr)
            if m not in prior:
                return 1
            print(f"  keeping the earlier record of {m}", flush=True)
            rec = prior[m]
        records.append(rec)
        print(f"  epoch {rec['epoch_seconds']:.2f}s  params "
              f"{rec['trainable_params']:,}  mem "
              f"{_mib(rec.get('memory_bytes'))} MiB", flush=True)
        (out / PARTIAL_NAME).write_text(json.dumps(records, indent=1))

    from ..utils.tpme import ALPHA, RunRecord, tpme_scores

    scores = tpme_scores([RunRecord(r["label"], r["epoch_seconds"],
                                    r["trainable_params"], r.get("memory_bytes"))
                          for r in records])
    print_table(records, scores, ALPHA)
    (out / OUT_NAME).write_text(json.dumps(
        {"alpha": list(ALPHA), "records": records, "tpme": scores}, indent=1))
    print(f"\nwritten {out / OUT_NAME}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
