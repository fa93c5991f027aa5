#!/usr/bin/env python3
"""Time the PyTorch port's dropout-mask replay kernel (kernel #7,
``iisan_tpu_torch.ops.fused_attention.mha_mask_replay``) on one NVIDIA GPU.

    python3 scripts/torch_mask_replay_bench.py [--runs 3] [--package-root DIR]

Two shapes: the BERT step's train-mode attention (704 rows x 12 heads x
30 x 30: 30.4 MB of fp32 masks) and the FFT step's ViT attention (88 x 12
x 197 x 197: 163.9 MB, every plane starting misaligned).  For each, first
the kernel's masks against the plain version's (``attention_dropout_masks``,
``torch.equal``), then ``--runs`` times: the median of 20 CUDA-event
timings of one call (``event_ms``: allocation and launch included, the
window the host's launch can stretch on an idle card), the CUDA-event time
a call over 50 back-to-back calls (``loop_ms``) and the kernel's device
time from torch.profiler over 10 calls (``device_ms``); the plain version
by CUDA events (3 calls) and by the profiler (its kernels summed, 2
calls).  The bound is the bytes written over 3.35 TB/s; beside it, the
device time of ``fill_`` on a tensor of the same size (``fill_device_ms``),
the card's own write of those bytes.  Prints the card's name and power
limit, a line a shape, then one JSON line.

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
SHAPES = (("BERT", 704, 30), ("ViT", 88, 197))  # name, rows, tokens
HEADS, RATE, SEED, LAYER = 12, 0.1, 20251016, 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--package-root", default=str(ROOT))
    args = ap.parse_args()
    package_root = Path(args.package_root).resolve()
    sys.path.insert(0, str(package_root))
    import torch

    if not torch.cuda.is_available():
        print("torch_mask_replay_bench: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from iisan_tpu_torch.ops import fused_attention as fa

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    cases = []
    for name, B, T in SHAPES:
        def kernel():
            return fa.mha_mask_replay(SEED, B, T, HEADS, RATE, LAYER, device)

        def plain():
            return fa.attention_dropout_masks(SEED, B, T, HEADS, RATE, LAYER, device)

        equal = torch.equal(kernel(), plain())
        torch.cuda.empty_cache()
        event, loop, dev = [], [], []
        for _ in range(args.runs):
            event.append(cs.cuda_timed(kernel, 20))
            loop.append(cs.cuda_loop_ms(kernel, 50))
            dev.append(sum(ms for key, ms in cs.kernel_device_ms(kernel, 10).items()
                           if "mask_replay" in key))
        buf = torch.empty((B, HEADS, T, T), device=device)
        fill = sorted(cs.device_ms(lambda: buf.fill_(0.5), 10) for _ in range(args.runs))
        del buf
        plain_ms = cs.cuda_timed(plain, 3)
        plain_dev = sum(cs.kernel_device_ms(plain, 2).values())
        bnd = cs.bound(B * HEADS * T * T * 4, 0)
        cases.append({"case": name, "B": B, "H": HEADS, "T": T, "bit_equal": equal,
                      "event_ms": event, "loop_ms": loop, "device_ms": dev,
                      "plain_ms": plain_ms, "plain_device_ms": plain_dev,
                      "bound_ms": bnd[0], "bound_by": bnd[1], "fill_device_ms": fill})
        med = sorted(dev)[len(dev) // 2]
        print(f"{name} {B} x {HEADS} x {T} x {T}: bit-equal {equal}; kernel event "
              f"{sorted(event)[len(event) // 2]:.4f} ms, loop "
              f"{sorted(loop)[len(loop) // 2]:.4f} ms, device {med:.4f} ms "
              f"({bnd[0] / med:.0%} of the bound {bnd[0]:.4f} ms; fill_ "
              f"{fill[len(fill) // 2]:.4f} ms); plain "
              f"{plain_ms:.3f} ms (device {plain_dev:.3f})", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"package_root": str(package_root), "device": smi,
                      "cases": cases}), flush=True)
    return 0 if all(c["bit_equal"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
