"""Run one cell of the benchmark of ``iisan_tpu_torch`` once.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic and limits
come from ``BENCHMARK.json`` and the files beside this one.  The run makes
its inputs and weights from the seed, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain reference, prints
each compared number beside its limit as the last lines of standard error,
and prints one JSON line last on standard output.  It exits non-zero and
prints no result when the cell's CUDA devices are missing, or when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _number(x):
    return x if math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Libraries that would load JAX on their own are told not to.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    from h100_bench.harness import NoDevice, forbidden_modules, run_cell

    try:
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                        t_start=T_START)
    except NoDevice as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 2
    loaded = forbidden_modules()
    if loaded:
        print(f"h100_bench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in line["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    line["check"] = {k: [_number(v), l] for k, (v, l) in line["check"].items()}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
