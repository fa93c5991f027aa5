#!/usr/bin/env python3
"""Time the PyTorch port's tower-attention backward (kernel #6,
``iisan_tpu_torch.ops.fused_attention.mha_bwd``) on one NVIDIA GPU.

    python3 scripts/torch_mha_bwd_bench.py [--runs 3] [--package-root DIR]

The cases are ``chip_smoke.py``'s (``MHA_BWD_CASES``), at the FFT step's
shapes (88 rows: 8 users x 11 items, 768 wide, 12 heads): BERT titles (30
tokens, padded key bias, dropout 0.1), ViT images (197 tokens) in bf16
and in fp32, and 257 tokens in train mode.  For each case, ``--runs``
medians of 10 CUDA-event timings of the kernel and of the backward alone
of ``scaled_dot_product_attention`` on the same inputs (``sdpa_bwd_ms``:
timing only in train mode, its masks are not the port's), beside the
bound; and device times from torch.profiler over 5 calls, which leave
out the host time that the CUDA-event window holds when the card waits
for the launch: each of the kernel call's kernels (the query-side and the
key-side one) and the sum of the SDPA backward's.  Prints the card's
name and power limit, then one JSON line.

``--both-modes`` also times each bf16 case in the other mode (eval for a
train case, train at layer 0 for an eval case): the share of the dropout
masks, which the kernels recompute from Philox.

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
    ap.add_argument("--both-modes", action="store_true")
    args = ap.parse_args()
    package_root = Path(args.package_root).resolve()
    sys.path.insert(0, str(package_root))
    import torch

    if not torch.cuda.is_available():
        print("torch_mha_bwd_bench: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from torch.profiler import ProfilerActivity, profile

    from iisan_tpu_torch.ops import fused_attention as fa

    def device_ms(fn, reps=5):
        """Device ms per call of each CUDA kernel ``fn`` launches."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
                if e.self_device_time_total > 0}

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    cases = []
    todo = list(cs.MHA_BWD_CASES)
    if args.both_modes:
        todo += [(f"{name} as {'eval' if layer is not None else 'train'}", T, padded, dtype,
                  None if layer is not None else 0)
                 for name, T, padded, dtype, layer in cs.MHA_BWD_CASES if dtype == "bfloat16"]
    for name, T, padded, dtype, layer in todo:
        q, k, v, g, bias, kw = cs.mha_bwd_case(device, gen, T, padded, dtype, layer)
        ms = [cs.cuda_timed(lambda: fa.mha_bwd(q, k, v, bias, g, **kw), 10)
              for _ in range(args.runs)]
        lib = [cs.sdpa_bwd_ms(q, k, v, g, bias, kw.get("rate", 0.0))
               for _ in range(args.runs)]
        split = {re.search(r"mha_bwd\w*", key).group(0): t for key, t in
                 device_ms(lambda: fa.mha_bwd(q, k, v, bias, g, **kw)).items()
                 if "mha_bwd" in key}
        sdpa_dev = sum(device_ms(cs.sdpa_bwd(q, k, v, g, bias, kw.get("rate", 0.0))).values())
        B = q.shape[0]
        bnd = cs.mha_bound(B, T, cs.TOWER_D, cs.TOWER_H, padded, True, q.element_size())
        design = (fa.bwd_design(T, q.element_size()) if hasattr(fa, "bwd_design")
                  else "earlier")
        cases.append({"case": name, "B": B, "T": T, "dtype": dtype, "design": design,
                      "ms": ms, "sdpa_bwd_ms": lib, "bound_ms": bnd[0],
                      "bound_by": bnd[1], "kernels_ms": split,
                      "sdpa_bwd_device_ms": sdpa_dev})
        print(f"{name}: kernel {sorted(ms)[len(ms) // 2]:.4f} ms ({design}), SDPA "
              f"backward {sorted(lib)[len(lib) // 2]:.4f} ms, bound {bnd[0]:.4f} ms; "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in split.items())
              + f" (device); SDPA backward {sdpa_dev:.4f} ms (device)", flush=True)
        del q, k, v, g, bias
        torch.cuda.empty_cache()
    print(json.dumps({"package_root": str(package_root), "device": smi,
                      "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
