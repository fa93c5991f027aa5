#!/usr/bin/env python3
"""Time the PyTorch port's W8A8 linear (kernel #10,
``iisan_tpu_torch.ops.fused_w8a8.fused_w8a8_matmul``) on one NVIDIA GPU.

    python3 scripts/torch_w8a8_bench.py [--runs 3] [--package-root DIR]
                                        [--shapes vit,bert,large]

The shapes are ``chip_smoke.py``'s phase-16 tower shapes: every tower dense
layer's (K, N) = (768, 768), (768, 3072), (3072, 768) at the uncached
step's ViT rows (704 images x 197 tokens, "vit") and BERT rows (704 x 30,
"bert"), and BERT-large's FFN output layer (4096, 1024) at the BERT rows
("large"); bf16 in and out, with bias.  For each, ``--runs`` medians of 10
CUDA-event timings of the call, of bf16 ``F.linear`` on the same x (another
function, for context) and of ``torch._int_mm`` on the quantised operands
(the int8 product alone); and the device time of each CUDA kernel the call
launches, from torch.profiler over 5 calls (``chip_smoke.kernel_device_ms``,
a median of ``--runs`` profiles), beside the bound.  Prints the card's
name and power limit, one line a shape, then one JSON line.

``--package-root`` imports ``iisan_tpu_torch`` from another checkout (its
kernels build there), so that two versions can be timed in turns in one
call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--shapes", default="vit,bert,large")
    args = ap.parse_args()
    package_root = Path(args.package_root).resolve()
    sys.path.insert(0, str(package_root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_w8a8_bench: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from iisan_tpu_torch.ops import fused_w8a8 as fw
    from iisan_tpu_torch.ops.int8_linear import quantize_kernel, quantize_rows

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 4)
    shapes = {"vit": [(cs.VIT_ROWS, K, N) for K, N in cs.W8A8_SHAPES],
              "bert": [(cs.BERT_ROWS, K, N) for K, N in cs.W8A8_SHAPES],
              "large": [(cs.BERT_ROWS, *cs.W8A8_LARGE)]}
    dt = torch.bfloat16
    results = []
    for name in args.shapes.split(","):
        for M, K, N in shapes[name]:
            x = torch.randn(M, K, generator=gen, device=device).to(dt)
            w = torch.randn(K, N, generator=gen, device=device) * 0.05
            q, s = (torch.as_tensor(a, device=device) for a in quantize_kernel(w.cpu().numpy()))
            b = torch.randn(N, generator=gen, device=device)
            # the weight layout the checkout's Int8Dense caches
            qt = fw.transposed_weight(q) if hasattr(fw, "transposed_weight") else q.t().contiguous()

            def call():
                return fw.fused_w8a8_matmul(x, q, s, b, dt, kernel_qt=qt)

            xq = quantize_rows(x)[0].to(torch.int8)
            wb = w.t().contiguous().to(dt)
            bnd = cs.w8a8_bound(M, K, N)
            row = {"M": M, "K": K, "N": N, "bound_ms": bnd[0], "bound_by": bnd[1],
                   "ms": [cs.cuda_timed(call, 10) for _ in range(args.runs)],
                   "linear_ms": [cs.cuda_timed(lambda: F.linear(x, wb), 10)
                                 for _ in range(args.runs)],
                   "int_mm_ms": [cs.cuda_timed(lambda: torch._int_mm(xq, q), 10)
                                 for _ in range(args.runs)]}
            profiles = [cs.kernel_device_ms(call) for _ in range(args.runs)]
            row["kernels_ms"] = {k: median([p.get(k, 0.0) for p in profiles])
                                 for k in {k for p in profiles for k in p}}
            row["device_ms"] = median([sum(p.values()) for p in profiles])
            results.append(row)
            split = ", ".join(f"{re.search(r'w8a8_\w+', k).group(0) if 'w8a8_' in k else k[:40]} "
                              f"{t:.4f}" for k, t in sorted(row["kernels_ms"].items()))
            print(f"M={M} K={K} N={N}: call {median(row['ms']):.4f} ms (runs {row['ms']}, "
                  f"{2 * M * K * N / median(row['ms']) / 1e9:.0f} TOPS), device "
                  f"{row['device_ms']:.4f} ms = {split}; bf16 F.linear "
                  f"{median(row['linear_ms']):.4f} ms, torch._int_mm "
                  f"{median(row['int_mm_ms']):.4f} ms (other functions); bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
            del x, xq, wb
            torch.cuda.empty_cache()
    print(json.dumps({"package_root": str(package_root), "device": smi,
                      "shapes": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
