#!/usr/bin/env python3
"""Time the PyTorch port's SAN cascade kernels (#3 ``san_cascade_fwd``, #4
``san_cascade_streamed_fwd``, ``iisan_tpu_torch.ops.fused_san``) on one
NVIDIA GPU.

    python3 scripts/torch_cascade_bench.py [--runs 3] [--package-root DIR]
                                           [--cases step,table,image,versa,chunk]
                                           [--plain] [--clusters 16,8,4]

Cases, bf16 with K=7 taps and R=64 (``chip_smoke.py``'s shapes): #3 at the
cached step's launch ("step": S=1, N=704, D=768), the Versa image side
("image": D=192) and an item-table chunk ("table": S=3, N=8192, D=768); #4
at the Versa step ("versa": N=704, D=8192) and a Versa table chunk
("chunk": N=8192).  For each, ``--runs`` medians of 10 CUDA-event timings
of the call and the device time of its kernels from torch.profiler over 5
calls (``chip_smoke.kernel_device_ms``, a median of ``--runs`` profiles),
beside the bound (``chip_smoke.cascade_bound``); ``--plain`` adds the
plain version's call time.  ``--clusters`` also times the checkout's
kernels with the row tile's D split over that many blocks instead of the
plan's, with the carry slice in shared memory (where it fits) and in
device memory (where the wrappers take a ``plan``).
Prints the card's name and power limit, one line a case, then one JSON
line.

``--package-root`` imports ``iisan_tpu_torch`` from another checkout (its
kernels build there), so that two versions can be timed in turns in one
call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--cases", default="step,table,image,versa,chunk")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--clusters", default="")
    args = ap.parse_args()
    package_root = Path(args.package_root).resolve()
    sys.path.insert(0, str(package_root))
    import torch

    if not torch.cuda.is_available():
        print("torch_cascade_bench: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from iisan_tpu_torch.ops import fused_san as fs

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 7)
    K, R = cs.K_TAPS, cs.BOTTLENECK
    cases = {"step": ("#3", *cs.CASCADE_STEP), "image": ("#3", *cs.CASCADE_VERSA_IMAGE),
             "table": ("#3", *cs.CASCADE_TABLE),
             "versa": ("#4", 1, cs.STEP_ROWS, cs.VERSA_TEXT_DIM),
             "chunk": ("#4", 1, cs.TABLE_CHUNK, cs.VERSA_TEXT_DIM)}
    takes_plan = "plan" in inspect.signature(fs.san_cascade_fwd).parameters
    clusters = [int(c) for c in args.clusters.split(",") if c] if takes_plan else []
    results = []
    for name in args.cases.split(","):
        kernel, S, N, D = cases[name]
        a = cs.cascade_inputs(device, gen, S, N, K, D, R)
        if kernel == "#3":
            fn, plain = fs.san_cascade_fwd, fs.san_cascade_fwd_plain
        else:
            a = tuple(t[0] for t in a)
            fn, plain = fs.san_cascade_streamed_fwd, fs.san_cascade_streamed_fwd_plain

        def call(**kw):
            return fn(*a, **kw)

        bnd = cs.cascade_bound(S, N, D, R)
        row = {"case": name, "kernel": kernel, "S": S, "N": N, "K": K, "D": D, "R": R,
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "ms": [cs.cuda_timed(call, 10) for _ in range(args.runs)]}
        profiles = [cs.kernel_device_ms(call) for _ in range(args.runs)]
        row["device_ms"] = median([sum(p.values()) for p in profiles])
        if args.plain:
            row["plain_ms"] = [cs.cuda_timed(lambda: plain(*a), 5) for _ in range(args.runs)]
        line = (f"{kernel} {name} S={S} N={N} K={K} D={D} R={R}: call "
                f"{median(row['ms']):.4f} ms (runs {', '.join(f'{t:.4f}' for t in row['ms'])}), "
                f"device {row['device_ms']:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
        if args.plain:
            line += f"; plain {median(row['plain_ms']):.4f} ms"
        if takes_plan:
            streamed = kernel == "#4"
            plan = fs.cascade_plan(S, N, K, D, R, torch.bfloat16, streamed=streamed)
            row["plan"] = plan._asdict()
            line += f"; plan {plan.cluster} x {plan.d_slice} columns, carry {plan.carry}"
            chunks = -(-D // 64)
            for c in clusters:
                per = -(-chunks // c)
                for carry in ("smem", "global"):
                    cb = 64 * (per * 64 + 8) * (4 if streamed else 2) if carry == "smem" else 0
                    smem = fs.cascade_smem_bytes(plan.r_chunk, plan.stages, -(-R // 64), cb)
                    if smem > fs.SMEM_OPTIN_BYTES:
                        continue
                    alt = plan._replace(cluster=-(-chunks // per), d_slice=per * 64,
                                        carry=carry, smem_bytes=smem)
                    t = [cs.cuda_timed(lambda: call(plan=alt), 10) for _ in range(args.runs)]
                    row.setdefault("alternatives", []).append(
                        {"cluster": alt.cluster, "d_slice": alt.d_slice, "carry": carry, "ms": t})
                    line += f"; {alt.cluster} x {alt.d_slice} {carry}: {median(t):.4f} ms"
        print(line, flush=True)
        results.append(row)
        del a
        torch.cuda.empty_cache()
    print(json.dumps({"package_root": str(package_root), "device": smi,
                      "cases": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
