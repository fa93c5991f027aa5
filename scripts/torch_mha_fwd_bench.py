#!/usr/bin/env python3
"""Time the PyTorch port's tower-attention forward (kernel #5,
``iisan_tpu_torch.ops.fused_attention.mha_fwd``) and the subblocks'
attention step on one NVIDIA GPU.

    python3 scripts/torch_mha_fwd_bench.py [--runs 3] [--package-root DIR]
        [--cases bert,bert_train,vit,257,325,bert_fp32,bert_fp32_train,vit_fp32,
                 subblock,uncached,uncached_fp32]

The cases are at the uncached step's 704 rows (64 users x 11 items), 768
wide, 12 heads, bf16: BERT titles (30 tokens, a padded key bias with an
all-pad row) in eval mode and in train mode at dropout 0.1; ViT images
(197 tokens), a 256-pixel ViT (257) and a 288-pixel one (325, past the
resident keys' limit) in eval mode; the fp32 compute dtype's BERT eval and
train and ViT (``*_fp32``: fp32 values that use all 24 bits, the kernel's
three TF32 passes, the fp32 bound 1e-4, and the bound both ways,
``chip_smoke.mha_bounds_fp32``); and #8's attention step at ViT
(``subblock``: the device time of its attention kernel within a
``fused_attn_subblock`` call, ``chip_smoke.subblock_split``); and the
IISAN (Uncached) training step at the published batch of 64 users
(``uncached``: ``chip_smoke.uncached_trainer`` over chip_smoke phase 8's
synthetic corpus, one staged batch, ``chip_smoke.uncached_breakdown``:
host ms, device-busy ms and the attention kernels' ms a step from the
profiler, ``--runs`` times; ``uncached_fp32`` the same step in fp32).
For each #5 case: max |kernel - plain| /
(max|plain| + |plain|) over the first 64 images (``chip_smoke.mha_ratio``,
against ``mha_fwd_plain``); ``--runs`` medians of 10 CUDA-event timings
of the call; the device time of its kernels from torch.profiler over 5
calls (the median of ``--runs`` profiles), which leaves out the host time
a CUDA-event window holds when the card waits for the launch; the device
time of ``scaled_dot_product_attention`` on the same heads (the key bias
as its mask; in train mode its own dropout, timing only); and the bound
(``chip_smoke.mha_bound``).  Prints the card's name and power limit, one
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
# name: (tokens, padded keys, train mode, dtype)
CASES = {"bert": (30, True, False, "bfloat16"), "bert_train": (30, True, True, "bfloat16"),
         "vit": (197, False, False, "bfloat16"), "257": (257, False, False, "bfloat16"),
         "325": (325, False, False, "bfloat16"),
         "bert_fp32": (30, True, False, "float32"),
         "bert_fp32_train": (30, True, True, "float32"),
         "vit_fp32": (197, False, False, "float32"),
         "subblock": (197, False, False, "bfloat16"),
         "uncached": (197, False, False, "bfloat16"),
         "uncached_fp32": (197, False, False, "float32")}


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
        print("torch_mha_fwd_bench: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from iisan_tpu_torch.ops import fused_attention as fa
    from iisan_tpu_torch.ops import fused_attn_subblock as fsb

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    def device_ms(fn, pattern=""):
        """Median over ``--runs`` profiles of the device ms a call of the
        kernels whose names hold ``pattern``."""
        return median([sum(t for key, t in cs.kernel_device_ms(fn).items() if pattern in key)
                       for _ in range(args.runs)])

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 5)
    D, H, B = cs.TOWER_D, cs.TOWER_H, cs.STEP_ROWS
    results = []
    for case in args.cases.split(","):
        T, padded, train, dtype = CASES[case]
        dt = getattr(torch, dtype)
        row = {"case": case, "B": B, "T": T, "train": train, "dtype": dtype}
        if case.startswith("uncached"):
            from iisan_tpu_torch.data.synthetic import synthetic_corpus

            corpus = synthetic_corpus(n_users=512, item_num=800, max_seq_len=cs.SEQ_LEN, seed=0)
            tr = cs.uncached_trainer(device, corpus, compute_dtype=dtype)
            batch = cs.staged_batch(tr, 1)
            steps = [cs.uncached_breakdown(tr, batch, 5) for _ in range(args.runs)]
            row.update(host_ms=[h for h, _, _ in steps], busy_ms=[b for _, b, _ in steps],
                       attention_ms=[f["attention kernels"] for _, _, f in steps])
            print(f"IISAN uncached step ({dtype}, staged batch of 64 users): device-busy "
                  f"{row['busy_ms']} ms, attention kernels {row['attention_ms']} ms, host "
                  f"{row['host_ms']} ms", flush=True)
            results.append(row)
            del tr, batch
            torch.cuda.empty_cache()
            continue
        if case == "subblock":
            x = torch.randn(B, T, D, generator=gen, device=device).to(dt)
            wqkv = (torch.randn(D, 3 * D, generator=gen, device=device) / D ** 0.5).to(dt)
            bqkv = torch.randn(3 * D, generator=gen, device=device) * 0.3
            wo = (torch.randn(D, D, generator=gen, device=device) / D ** 0.5).to(dt)
            bo = torch.randn(D, generator=gen, device=device) * 0.3

            def call():
                return fsb.fused_attn_subblock(x, wqkv, bqkv, wo, bo, H)

            splits = [cs.subblock_split(call) for _ in range(args.runs)]
            row.update(attention_device_ms=median([s["attention"] for s in splits]),
                       op_device_ms=median([sum(s.values()) for s in splits]),
                       ms=[cs.cuda_timed(call, 10) for _ in range(args.runs)])
            print(f"#8 attention step ViT {B} x {T}: {row['attention_device_ms']:.4f} ms "
                  f"(device) of the op's {row['op_device_ms']:.4f}; op "
                  f"{median(row['ms']):.4f} ms (runs {row['ms']})", flush=True)
            results.append(row)
            del x
            torch.cuda.empty_cache()
            continue
        q, k, v = (torch.randn(B, T, D, generator=gen, device=device).to(dt) for _ in range(3))
        bias = cs.padding_bias(device, gen, B, T) if padded else None
        kw = dict(n_heads=H)
        if train:
            kw.update(seed=cs.ATTN_SEED, rate=cs.DROP, layer=5)
        got = fa.mha_fwd(q, k, v, bias, **kw)[:64]
        want = fa.mha_fwd_plain(q[:64], k[:64], v[:64], None if bias is None else bias[:64],
                                **kw)
        row["ratio"] = cs.mha_ratio([got], [want])

        def call():
            return fa.mha_fwd(q, k, v, bias, **kw)

        heads = [t.reshape(B, T, H, D // H).transpose(1, 2).contiguous() for t in (q, k, v)]
        mask = None if bias is None else bias[:, None, None, :].to(dt)

        def sdpa():
            return F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                                  dropout_p=cs.DROP if train else 0.0)

        if dt == torch.bfloat16:
            tol, bnd = cs.MHA_TOL["fwd"], cs.mha_bound(B, T, D, H, padded, False)
            bound_text = f"bound {bnd[0]:.4f} ms ({bnd[1]})"
        else:
            tol, b32 = cs.MHA_TOL_FP32, cs.mha_bounds_fp32(B, T, D, H, padded, False)
            bnd, bound_text = b32[1], cs.bounds_text(b32)
            row.update(cuda_core_bound_ms=b32[0][0], cuda_core_bound_by=b32[0][1])
        row.update(ms=[cs.cuda_timed(call, 10) for _ in range(args.runs)],
                   device_ms=device_ms(call, "mha_fwd"), sdpa_device_ms=device_ms(sdpa),
                   bound_ms=bnd[0], bound_by=bnd[1])
        print(f"#5 {case} {B} x {T}{' train' if train else ''}: ratio to plain "
              f"{row['ratio']:.4g} (tol {tol}); kernel {median(row['ms']):.4f} ms "
              f"(runs {row['ms']}), device {row['device_ms']:.4f} ms; SDPA device "
              f"{row['sdpa_device_ms']:.4f} ms; {bound_text}", flush=True)
        results.append(row)
        del q, k, v, heads, got, want
        torch.cuda.empty_cache()
    print(json.dumps({"package_root": str(package_root), "device": smi, "cases": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
