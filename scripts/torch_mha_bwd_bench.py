#!/usr/bin/env python3
"""Time the PyTorch port's tower-attention backward (kernel #6,
``iisan_tpu_torch.ops.fused_attention.mha_bwd``) on one NVIDIA GPU, alone
and inside the training steps that run it.

    python3 scripts/torch_mha_bwd_bench.py [--runs 3] [--package-root DIR] [--both-modes]

The kernel alone at ``chip_smoke.py``'s cases (``MHA_BWD_CASES``), 768 wide, 12
heads: at the FFT step's 88 rows (8 users x 11 items) BERT titles (30
tokens, padded key bias, dropout 0.1) in bf16 and in fp32, ViT images (197
tokens) in bf16 and in fp32, and in train mode 257 and 325 tokens and 448
and 512 keys (the cluster design, up to its 512 keys) and 577 tokens
(``CV_resize=384``: the split design), 577 tokens at ViT-tiny's 192 wide (3
heads, eval mode), and ViT at the TPME report's batch of 32 users (352
images) in bf16 and in fp32 (fp32: the three-pass TF32 pair, its bound
both ways, ``chip_smoke.mha_bounds_fp32``).  For each
case, the design the call runs (``bwd_design``), ``--runs`` medians of
10 CUDA-event timings of the kernel and of the backward alone of ``scaled_dot_product_attention`` on the same
inputs (``sdpa_bwd_ms``: timing only in train mode, its masks are not the
port's), beside the bound; and device times from torch.profiler over 5
calls, which leave out the host time that the CUDA-event window holds when
the card waits for the launch: each of the call's kernels and the sum of
the SDPA backward's.

Then the steps: a full fine-tuning step at batch 8 (88 images and
titles, ``chip_smoke.train_fft``'s trainer), the same at ``CV_resize=288``
(325 image tokens) and ``CV_resize=384`` (577) and in fp32 (``fft8_fp32``),
and a LoRA step at batch
32 (352), each on a staged batch of ``chip_smoke.py``'s synthetic corpus:
``--runs`` times, the host ms of a synchronised step (median of 3), the
step's device-busy ms over 3 profiled steps, the attention kernels' ms
(#5 and #6) and #6's alone, a step.

``--both-modes`` also times each bf16 kernel case in the other mode (eval
for a train case, train at layer 0 for an eval case): the share of the
dropout masks, which the kernels recompute from Philox.

``--package-root`` imports ``iisan_tpu_torch`` from another checkout (its
kernels build there), so that two versions can be timed in turns in one
call: parent, change, change, parent.  Prints the card's name and power
limit, a line a case, then one JSON line.
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
# step case: (users a batch, trainer options)
FFT = dict(adding_adapter_to="None", adapter_type="houslby")
STEPS = {"fft8": (8, FFT), "fft8_288": (8, dict(FFT, CV_resize=288)),
         "fft8_384": (8, dict(FFT, CV_resize=384)),
         "fft8_fp32": (8, dict(FFT, compute_dtype="float32")),
         "lora32": (32, dict(adapter_type="lora"))}


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

    def median(xs):
        return sorted(xs)[len(xs) // 2]

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
    results = []
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    cases = list(cs.MHA_BWD_CASES)
    if args.both_modes:
        cases += [(f"{name} as {'eval' if layer is not None else 'train'}", B, T, padded,
                   dtype, None if layer is not None else 0, heads)
                  for name, B, T, padded, dtype, layer, heads in cs.MHA_BWD_CASES
                  if dtype == "bfloat16"]
    for name, B, T, padded, dtype, layer, heads in cases:
        q, k, v, g, bias, kw = cs.mha_bwd_case(device, gen, B, T, padded, dtype, layer, heads)
        ms = [cs.cuda_timed(lambda: fa.mha_bwd(q, k, v, bias, g, **kw), 10)
              for _ in range(args.runs)]
        lib = [cs.sdpa_bwd_ms(q, k, v, g, bias, kw.get("rate", 0.0))
               for _ in range(args.runs)]
        split = {re.search(r"mha_bwd\w*", key).group(0): t for key, t in
                 device_ms(lambda: fa.mha_bwd(q, k, v, bias, g, **kw)).items()
                 if "mha_bwd" in key}
        sdpa_dev = sum(device_ms(cs.sdpa_bwd(q, k, v, g, bias,
                                             kw.get("rate", 0.0))).values())
        D = 64 * heads
        bnd = cs.mha_bound(B, T, D, heads, padded, True, q.element_size())
        row = {}
        if dtype == "float32":  # the kernels' three TF32 passes; the CUDA cores' beside
            row.update(cuda_core_bound_ms=bnd[0], cuda_core_bound_by=bnd[1])
            bnd = cs.mha_bounds_fp32(B, T, D, heads, padded, True)[1]
        design = fa.bwd_design(T, q.element_size())
        results.append({"case": name, "B": B, "T": T, "D": D, "dtype": dtype, "design": design,
                        "ms": ms, "sdpa_bwd_ms": lib, "bound_ms": bnd[0],
                        "bound_by": bnd[1], **row, "kernels_ms": split,
                        "device_ms": sum(split.values()),
                        "sdpa_bwd_device_ms": sdpa_dev})
        print(f"{name} {B} x {T} x {D}: kernel {median(ms):.4f} ms ({design}), SDPA backward "
              f"{median(lib):.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
              + (f", on the CUDA cores {row['cuda_core_bound_ms']:.4f} ms" if row else "")
              + "; " + ", ".join(f"{n} {t:.4f} ms" for n, t in split.items())
              + f" (device); SDPA backward {sdpa_dev:.4f} ms (device)", flush=True)
        del q, k, v, g, bias
        torch.cuda.empty_cache()
    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    for case, (users, options) in STEPS.items():
        corpus = synthetic_corpus(n_users=3 * users, item_num=800, max_seq_len=cs.SEQ_LEN,
                                  seed=0)
        tr = cs.uncached_trainer(device, corpus, batch_size=users, **options)
        batch = cs.staged_batch(tr, 0)
        row = {"case": case, "users": users, "method": tr.method,
               "CV_resize": tr.cfg.CV_resize, "dtype": tr.cfg.compute_dtype, "host_ms": [],
               "busy_ms": [], "attention_ms": [], "mha_bwd_ms": []}
        for _ in range(args.runs):
            host = cs.host_timed(lambda: (tr.train_step(*batch), torch.cuda.synchronize()), 3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    tr.train_step(*batch)
                torch.cuda.synchronize()
            kernels = [(e.key, e.self_device_time_total / 3 / 1e3) for e in prof.key_averages()
                       if e.self_device_time_total > 0]
            row["host_ms"].append(host)
            row["busy_ms"].append(sum(t for _, t in kernels))
            row["attention_ms"].append(sum(t for key, t in kernels if "mha_" in key))
            row["mha_bwd_ms"].append(sum(t for key, t in kernels if "mha_bwd" in key))
        print(f"{case}: {tr.method} step at batch {users} ({users * (cs.SEQ_LEN + 1)} "
              f"images, CV_resize={tr.cfg.CV_resize}, staged): device-busy "
              f"{row['busy_ms']} ms, attention kernels {row['attention_ms']} ms, #6 "
              f"{row['mha_bwd_ms']} ms, host {row['host_ms']} ms", flush=True)
        results.append(row)
        del tr, batch
        torch.cuda.empty_cache()
    print(json.dumps({"package_root": str(package_root), "device": smi,
                      "cases": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
