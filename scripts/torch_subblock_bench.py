#!/usr/bin/env python3
"""Time the PyTorch port's attention subblocks (kernels #8 and #9,
``iisan_tpu_torch.ops.fused_attn_subblock``) on one NVIDIA GPU.

    python3 scripts/torch_subblock_bench.py [--runs 3] [--package-root DIR]
                                            [--cases vit,bert,257,325]

The cases are ``chip_smoke.py``'s phase-18 shapes at the uncached step's
704 rows (64 users x 11 items), 768 wide, 12 heads, bf16, eval mode: ViT
images (197 tokens), BERT titles (30 tokens, padded key bias with an
all-pad row), a 256-pixel ViT (257) and a 288-pixel one (325).  For each
op and case, ``--runs`` medians of 10 CUDA-event timings of the op, of
``F.multi_head_attention_forward`` on the same inputs (the library call),
and of ``torch.matmul`` of the op's two products alone (x . Wqkv and
ctx . Wo, a yardstick for the projections); and the device time of each
CUDA kernel the op launches, from torch.profiler over 5 calls
(``chip_smoke.kernel_device_ms``, a median of ``--runs`` profiles), beside
the bound.  First, the time of ``torch.cat`` of a layer's q, k and v
kernels, which ``models/bert.py`` runs before each call.  A case the checkout's predicate
refuses is reported as such.  Prints the card's name and power limit, one
line a case, then one JSON line.

``--package-root`` imports ``iisan_tpu_torch`` from another checkout (its
kernels build there), so that two versions can be timed in turns in one
call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = {"vit": 197, "bert": 30, "257": 257, "325": 325}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    package_root = Path(args.package_root).resolve()
    sys.path.insert(0, str(package_root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_subblock_bench: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from iisan_tpu_torch.ops import fused_attn_subblock as fsb

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 3)
    D, H, B, dt = cs.TOWER_D, cs.TOWER_H, cs.STEP_ROWS, torch.bfloat16
    wqkv = (torch.randn(D, 3 * D, generator=gen, device=device) / D ** 0.5).to(dt)
    bqkv = torch.randn(3 * D, generator=gen, device=device) * 0.3
    wo = (torch.randn(D, D, generator=gen, device=device) / D ** 0.5).to(dt)
    bo = torch.randn(D, generator=gen, device=device) * 0.3
    in_w, out_w, in_b, out_b = wqkv.t().contiguous(), wo.t().contiguous(), bqkv.to(dt), bo.to(dt)
    # models/bert.py concatenates a layer's q, k, v kernels on every call
    wq, wk, wv = (w.clone() for w in wqkv.split(D, dim=1))
    cat = {"ms": [cs.cuda_timed(lambda: torch.cat([wq, wk, wv], 1), 10) for _ in range(args.runs)],
           "device_ms": sum(cs.kernel_device_ms(lambda: torch.cat([wq, wk, wv], 1)).values())}
    print(f"weights: torch.cat of the q, k, v kernels ({D} x {3 * D}) {median(cat['ms']):.4f} ms "
          f"(runs {cat['ms']}), device {cat['device_ms']:.4f} ms", flush=True)
    results = []
    for case in args.cases.split(","):
        T = CASES[case]
        x = torch.randn(B, T, D, generator=gen, device=device).to(dt)
        bias = pad = None
        if case == "bert":
            lengths = torch.randint(1, T + 1, (B,), generator=gen, device=device)
            lengths[0] = 0
            bias = torch.where(torch.arange(T, device=device)[None] < lengths[:, None],
                               0.0, -1e9)
            pad = bias < 0
        xt = x.transpose(0, 1)
        x2, ctx2 = x.reshape(B * T, D), torch.randn(B * T, D, generator=gen,
                                                    device=device).to(dt)
        lib = [cs.cuda_timed(lambda: F.multi_head_attention_forward(
            xt, xt, xt, D, H, in_w, in_b, None, None, False, 0.0, out_w, out_b,
            training=False, key_padding_mask=pad, need_weights=False), 10)
            for _ in range(args.runs)]
        mm = {"qkv": [cs.cuda_timed(lambda: torch.matmul(x2, wqkv), 10)
                      for _ in range(args.runs)],
              "out": [cs.cuda_timed(lambda: torch.matmul(ctx2, wo), 10)
                      for _ in range(args.runs)]}
        for v2 in (False, True):
            name = "#9" if v2 else "#8"
            ok = fsb.supported_v2(B, T, D, H) if v2 else fsb.supported(B, T, D, H)
            bnd = cs.subblock_bound(B, T, bias is not None)
            row = {"op": name, "case": case, "B": B, "T": T, "supported": ok,
                   "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
                   "matmul_ms": mm}
            if ok:
                op = fsb.fused_attn_subblock_v2 if v2 else fsb.fused_attn_subblock

                def call():
                    return op(x, wqkv, bqkv, wo, bo, H, key_bias=bias)

                row["ms"] = [cs.cuda_timed(call, 10) for _ in range(args.runs)]
                profiles = [cs.kernel_device_ms(call) for _ in range(args.runs)]
                row["kernels_ms"] = {k: median([p.get(k, 0.0) for p in profiles])
                                     for k in profiles[0]}
                row["device_ms"] = median([sum(p.values()) for p in profiles])
            results.append(row)
            split = ", ".join(f"{k[:48]} {t:.4f}" for k, t in row.get("kernels_ms", {}).items())
            print(f"{name} {case} {B} x {T}: "
                  + (f"op {median(row['ms']):.4f} ms (runs {row['ms']}), device "
                     f"{row['device_ms']:.4f} ms = {split}; " if ok else "not supported; ")
                  + f"F.multi_head_attention_forward {median(lib):.4f} ms; torch.matmul "
                  f"qkv {median(mm['qkv']):.4f} / out {median(mm['out']):.4f} ms; bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]})", flush=True)
        del x, x2, ctx2, xt
        torch.cuda.empty_cache()
    print(json.dumps({"package_root": str(package_root), "device": smi,
                      "weight_cat": cat, "cases": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
