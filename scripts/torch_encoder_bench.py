#!/usr/bin/env python3
"""Time the PyTorch port's user-encoder kernels (#1 ``user_encoder_fwd``,
#2 ``user_encoder_bwd``, ``iisan_tpu_torch.ops.fused_user_encoder``) on
one NVIDIA GPU.

    python3 scripts/torch_encoder_bench.py [--runs 3] [--package-root DIR]
                                           [--cases eval1,eval32,eval256,train64,topk1]
                                           [--dtype bfloat16|float32] [--n-sm N]

Shapes are ``chip_smoke.py``'s serving and training geometry (L=10, D=64,
H=2, F=256, 2 blocks), in ``--dtype`` (bf16, the main path, by default;
float32 is the route of every ``--use_scale`` but "half"): the eval-mode
forward at batch 1, 32 and 256
("evalB"), and at batch 64 the train-mode forward and the backward
(dropout 0.1, "train64"), each called as its main path calls it: serving
with the module's cached weight image, the training forward making one,
the backward reading the forward's (a checkout whose wrappers take no
image makes its own each call).  "topk1" times ``Recommender.top_k`` at
batch 1 over a random 20,826-row bf16 table (the Scientific catalogue).
For each call, ``--runs`` times:

- the device time of each CUDA kernel it launches, by kernel name
  (torch.profiler over 5 calls, ``chip_smoke.kernel_device_ms``);
- the CUDA-event time per call over a run of 50 back-to-back calls
  (``chip_smoke.cuda_loop_ms``);
- the host time of the call alone (enqueue, no synchronise; ``top_k``
  synchronises, so there it is the latency), median of 50;
- its peak extra device memory: the most allocated during the call
  beyond what was allocated before it (outputs included).

Prints the card's name and power limit, one line a case, then one JSON
line.  ``--package-root`` imports ``iisan_tpu_torch`` from another
checkout (its kernels build there), so that two versions can be timed in
turns in one call: parent, change, change, parent.  ``--n-sm N`` plans the
fp32 route's tiles for N SMs instead of the card's (``--n-sm 256`` at
batch 256: one sequence a tile, against two on the H100's 132).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--cases", default="eval1,eval32,eval256,train64,topk1")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--n-sm", type=int, default=None)
    args = ap.parse_args()
    package_root = Path(args.package_root).resolve()
    sys.path.insert(0, str(package_root))
    import torch

    if not torch.cuda.is_available():
        print("torch_encoder_bench: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from iisan_tpu_torch.models.user_encoder import UserEncoder, causal_additive_mask
    from iisan_tpu_torch.ops import fused_user_encoder as fue

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    L, D, H, NL = cs.SEQ_LEN, cs.EMB, cs.HEADS, cs.BLOCKS
    gen = torch.Generator().manual_seed(cs.SEED + 11)
    dtype = getattr(torch, args.dtype)
    enc = UserEncoder(D, L, H, NL, cs.DROP, generator=gen).to(device)
    params = enc.packed_params(dtype)
    kw = dict(n_layers=NL, n_heads=H, d_ff=4 * D, n_position=L)
    if args.n_sm is not None:
        kw["n_sm"] = args.n_sm

    def inputs(B):
        x = torch.randn(B, L, D, generator=gen).to(device, dtype)
        lengths = torch.randint(1, L + 1, (B,), generator=gen)
        log_mask = torch.arange(L)[None] >= L - lengths[:, None]
        mask3 = causal_additive_mask(log_mask.float().to(device)).reshape(B, L, L)
        return x, mask3

    def host_call_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return median(times)

    def measure(name, fn, extra_memory=True):
        row = {"case": name, "device_ms": [], "kernels": [], "event_ms": [], "host_ms": []}
        for _ in range(args.runs):
            split = cs.kernel_device_ms(fn)
            row["kernels"].append(split)
            row["device_ms"].append(sum(split.values()))
            row["event_ms"].append(cs.cuda_loop_ms(fn, 50))
            row["host_ms"].append(host_call_ms(fn))
        if extra_memory:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            out = fn()
            torch.cuda.synchronize()
            row["peak_extra_bytes"] = torch.cuda.max_memory_allocated(device) - before
            del out
        names = sorted({k for s in row["kernels"] for k in s})
        per_kernel = ", ".join(
            f"{k[:48]} {median([s.get(k, 0.0) for s in row['kernels']]):.4f}" for k in names)
        line = (f"{name}: device {median(row['device_ms']):.4f} ms "
                f"(runs {', '.join(f'{t:.4f}' for t in row['device_ms'])}; {per_kernel}); "
                f"events over 50 back-to-back calls {median(row['event_ms']):.4f} ms a call; "
                f"host enqueue {median(row['host_ms']):.4f} ms")
        if extra_memory:
            line += f"; peak extra memory {row['peak_extra_bytes'] / 2**20:.3f} MiB"
        print(line, flush=True)
        return row

    # the weight image as the main path holds it, where the wrappers take one
    # for this dtype: serving's (the forward's half on the fp32 route) and
    # the training step's, which the forward makes and the backward reads
    image = train_image = {}
    if dtype == torch.bfloat16 and hasattr(fue, "weight_image"):
        image = train_image = {"image": fue.weight_image(params, D, 4 * D, NL, L)}
    elif hasattr(fue, "f32_image_floats"):
        image = {"image": fue.weight_image(params, D, 4 * D, NL, L, dtype, backward=False)}
        train_image = {"image": fue.weight_image(params, D, 4 * D, NL, L, dtype)}
    results = []
    for case in args.cases.split(","):
        if case.startswith("eval"):
            B = int(case[4:])
            x, mask3 = inputs(B)
            results.append(measure(
                f"user_encoder_fwd eval B={B}",
                lambda: fue.user_encoder_fwd(x, mask3, params, **image, **kw)))
        elif case == "topk1":
            from iisan_tpu_torch.models.model import IISANRecModel
            from iisan_tpu_torch.serve import Recommender

            model = IISANRecModel(san=None, embedding_dim=D, max_seq_len=L,
                                  num_attention_heads=H, transformer_block=NL,
                                  drop_rate=cs.DROP, dtype=dtype,
                                  generator=gen).to(device).eval()
            table = torch.randn(20826, D, generator=gen).to(device, dtype)
            rec = Recommender(model, table, L)
            seqs = [[int(i) for i in torch.randint(1, 20826, (L,), generator=gen)]]
            results.append(measure("top_k B=1", lambda: rec.top_k(seqs, k=10)))
        else:
            B = int(case[5:])
            x, mask3 = inputs(B)
            gout = torch.randn(B, L, D, generator=gen).to(device, dtype)
            tkw = dict(kw, seed=20251016, rate=cs.DROP)
            results.append(measure(f"user_encoder_fwd train B={B}",
                                   lambda: fue.user_encoder_fwd(x, mask3, params, **tkw)))
            results.append(measure(
                f"user_encoder_bwd train B={B}",
                lambda: fue.user_encoder_bwd(x, mask3, params, gout, **train_image, **tkw)))
    print(json.dumps({"package_root": str(package_root), "device": smi,
                      "dtype": args.dtype, "n_sm": args.n_sm, "cases": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
