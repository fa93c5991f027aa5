#!/usr/bin/env python3
"""Drive the PyTorch port's cached serving and training paths and its
uncached training paths (IISAN and full fine-tuning) once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. Print the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``iisan_tpu_torch/csrc`` and print the
   build time and ptxas's per-kernel report.
3. Hold each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the serving path gives it: the user-encoder forward
   at batch 1 and 256 (L=10, D=64, H=2, F=256, 2 blocks), the SAN cascade
   at S=3 branches x N=8192 rows (one item-table chunk), K=7, D=768, R=64,
   with ReLU and GELU, element by element.  Planted faults (a dropped bias,
   the other activation, step 0's weights at every step) must each break
   the cascade's bound in every branch.  Times are medians of CUDA-event
   timings.
4. Run the slice at the published cached configuration (the defaults of
   ``IISANConfig``) over a synthetic Scientific-size catalogue (20,825
   items + pad, 12,076 users), seeded random weights: once with the
   default SAN dispatch (the three branch cascades batched in plain
   PyTorch) and once with ``use_pallas=True`` (each intra branch through
   the cascade kernel).  Each run builds the fused item table, evaluates
   HR@10 / nDCG@10 on the valid split, answers top-K requests at batch 1,
   32 and 256, and answers the same requests over HTTP, which must give
   the direct call's ids, and from a save -> load round trip, which must
   give the ids of an fp32 Recommender over the same weights (the artifact
   is fp32 and loads as fp32, as in the JAX package).  The kernels'
   launch counters are reset before the runs and must show both kernels
   on the path.
5. Hold the training kernels against their plain versions: the
   user-encoder forward in train mode (dropout 0.1, bf16, batch 64, the
   same Philox masks on both sides) and the user-encoder backward at
   batch 64 and 1, train mode, bf16 and fp32, ``gx`` and every parameter
   gradient.  Two planted faults (the backward run with another seed than
   the forward, and the ReLU's gradient dropped) must break the backward's
   bound.
6. Train at the benchmark's cached configuration (``bench.py``: the
   ``IISANConfig`` defaults with lr 2e-4, batch 64, K=7, D=768, R=64, emb
   64, dropout 0.1, bf16) over a synthetic Scientific-size corpus (12,076
   users, 20,825 items: 189 steps an epoch): one full epoch and a valid
   evaluation on the default SAN route, then on ``use_pallas=True``.  The
   launch counters must show the encoder kernels once per step on both
   routes and the cascade kernel twice per step on the kernel route only;
   the loss must be finite and its last 20 steps lower than its first 20.
   Then, from one set of weights at dropout 0, five steps through the
   kernels and five through the module path must give losses within 2e-2
   and a nonzero gradient for every parameter on both.
7. Hold the tower-attention kernels against their plain versions in bf16
   (``check_attention``): the forward at the BERT step geometry (704
   titles x 30 tokens, D=768, 12 heads, padded key bias with an all-pad
   row) in eval mode and in train mode (dropout 0.1, the same Philox masks
   on both sides), at the ViT step geometry (704 images x 197 tokens,
   compared on a 64-image slice, timed at 704) in eval mode; the backward
   at the FFT step's shapes (88 rows), BERT in train mode and ViT in eval
   mode; the mask replay kernel bit for bit.  Planted faults (the key bias
   dropped on the padded batch, the backward run with another seed, the
   softmax row term dropped from the backward) must break the bounds;
   all-pad rows must stay finite.  The library call
   ``scaled_dot_product_attention`` is timed on the eval-mode shapes.
8. IISAN (Uncached) training at the published configuration
   (``scripts/bench_uncached.py``'s, at the default batch of 64):
   BERT-base and ViT-base geometry (12 layers, 768 wide, 12 heads, 224 x
   224 images, 30-word titles), SAN K=7 R=64, embedding 64, bf16, BERT
   dropout 0.1, ViT 0.0, seeded random tower weights, a synthetic corpus
   of 512 users over 800 items: one epoch (8 steps), then the item table
   over 801 items and a valid evaluation.  Per step the launch counters
   must show 24 ``mha_fwd`` (12 BERT layers in train mode, 12 ViT), one
   ``user_encoder_fwd`` and ``_bwd`` and no ``mha_bwd``; the loss must be
   finite; the tower weights must be bit-unchanged and a SAN weight moved.
   Host step time, device-busy time and device time by kernel family are
   printed.
9. The full fine-tuning baseline at the same geometry, batch 8 (88 images
   a step), 3 steps: 24 ``mha_bwd`` launches a step, a finite loss and a
   nonzero gradient for every tower parameter.
10. From one set of weights at tower and user-encoder dropout 0, 3 IISAN
   and 3 FFT steps through the kernels and through the module path: the
   losses agree within 2e-2.
11. Print one JSON line of per-kernel results, then the final status line.

fp32 matrix products in the plain versions run in full fp32: TF32 is
switched off for matmuls and cuDNN below.  The script imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# IISANConfig() defaults for the cached pipeline (iisan_tpu/config.py).
ITEMS, USERS = 20825, 12076
K_TAPS, TAP_DIM, BOTTLENECK = 7, 768, 64
EMB, HEADS, BLOCKS, SEQ_LEN, DROP = 64, 2, 2, 10, 0.1
EVAL_BATCH, TABLE_CHUNK = 256, 8192
SEED = 12345

# bf16 tolerances.  Kernel and plain version sum in different orders, so a
# value may round to the neighbouring bf16 number (2^-8 relative) and carry
# that through the later steps.  User encoder: |diff| <= 5e-2 + 5e-2 *
# |plain|, as the JAX package's own bf16 encoder test.  Cascade: element by
# element, |diff| <= four bf16 ulps of the row's largest |carry| + 1e-3
# (``fused_san.carry_tolerance``): the carry is additive across the K
# steps, so a one-ulp difference at a large intermediate value survives
# into a final value that may be small.  The cascade check draws weights
# whose every term moves the carry by O(1), and shows that the bound
# rejects a planted fault in each branch.
UE_TOL = (5e-2, 5e-2)
# Encoder backward: per tensor (gx and each parameter gradient), |diff| <=
# tol * (max|plain| + |plain|): the kernel sums a sequence's rows and then
# the sequences, the plain version all rows at once.  bf16 as the forward;
# fp32 1e-4 (summation order only).
BWD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# Tower attention (bf16): per tensor, |diff| <= tol * (max|plain| + |plain|),
# 2e-2 forward and 5e-2 backward: a probability may round to the
# neighbouring bf16 value on one side only.
MHA_TOL = {"fwd": 2e-2, "bwd": 5e-2}
# The uncached step: BERT-base titles and ViT-base images of a batch of 64
# users x (L+1) items.
TOWER_D, TOWER_H, TITLE_T, IMAGE_T = 768, 12, 30, 197
STEP_ROWS, FFT_BATCH = 64 * (SEQ_LEN + 1), 8
# The H100 SXM's published peaks (NVIDIA data sheet, dense), for the bounds.
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# scripts/bench_uncached.py's configuration at the published batch of 64.
UNCACHED_CFG = dict(batch_size=64, epoch=1, embedding_dim=EMB,
                    adapter_type="IISAN", adding_adapter_to="all",
                    fine_tune_to="None", lr=2e-4, adapter_cv_lr=1e-4,
                    adapter_bert_lr=1e-4, seed=SEED)
# The benchmark's training configuration (bench.py), over the field names
# of iisan_tpu_torch.config.IISANConfig.
TRAIN_CFG = dict(batch_size=64, epoch=1, lr=2e-4, adapter_cv_lr=1e-4,
                 adapter_bert_lr=1e-4, fine_tune_lr_image=1e-4,
                 fine_tune_lr_text=5e-5, embedding_dim=EMB,
                 bert_adapter_down_size=BOTTLENECK,
                 cv_adapter_down_size=BOTTLENECK, seed=SEED)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_timed(fn, reps: int):
    """Median milliseconds of ``reps`` calls, each between CUDA events."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def host_timed(fn, reps: int):
    """Median wall milliseconds of ``reps`` calls that end synchronised."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def device_ms(fn, reps: int):
    """Device-busy milliseconds per call: the summed CUDA kernel time of
    ``reps`` calls under torch.profiler, divided by ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / reps / 1e3


def max_err(got, want, tol):
    """max |got - want|; raises unless every |diff| <= atol + rtol * |want|
    with (atol, rtol) = tol."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    if not torch_finite(got) or bool(bad.any()):
        raise AssertionError(f"results disagree: max "
                             f"|diff| {float(diff.max())}, {int(bad.sum())} "
                             f"values beyond atol {atol} + rtol {rtol}")
    return float(diff.max())


def torch_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def check_user_encoder(device):
    import torch

    from iisan_tpu_torch.models.user_encoder import (UserEncoder,
                                                     causal_additive_mask)
    from iisan_tpu_torch.ops import fused_user_encoder as fue

    gen = torch.Generator().manual_seed(SEED)
    enc = UserEncoder(EMB, SEQ_LEN, HEADS, BLOCKS, DROP,
                      dtype=torch.bfloat16, generator=gen).to(device)
    params = enc.packed_params(torch.bfloat16)
    kw = dict(n_layers=BLOCKS, n_heads=HEADS, d_ff=4 * EMB, n_position=SEQ_LEN)
    rows = {}
    for b in (1, 256):
        x = torch.randn(b, SEQ_LEN, EMB, generator=gen).to(device, torch.bfloat16)
        lengths = torch.randint(1, SEQ_LEN + 1, (b,), generator=gen)
        log_mask = (torch.arange(SEQ_LEN)[None] >= SEQ_LEN - lengths[:, None])
        mask3 = causal_additive_mask(log_mask.float().to(device)).reshape(
            b, SEQ_LEN, SEQ_LEN)
        got = fue.user_encoder_fwd(x, mask3, params, **kw)
        want = fue.user_encoder_fwd_plain(x, mask3, params, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want, UE_TOL)
        ms = cuda_timed(lambda: fue.user_encoder_fwd(x, mask3, params, **kw), 50)
        plain_ms = cuda_timed(
            lambda: fue.user_encoder_fwd_plain(x, mask3, params, **kw), 50)
        dev = device_ms(lambda: fue.user_encoder_fwd(x, mask3, params, **kw), 20)
        plain_dev = device_ms(
            lambda: fue.user_encoder_fwd_plain(x, mask3, params, **kw), 20)
        rows[b] = (err, ms, plain_ms)
        log(f"user_encoder_fwd B={b}: max|kernel-plain| {err:.6g} "
            f"(tol atol {UE_TOL[0]} rtol {UE_TOL[1]}); per call kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 50, CUDA "
            f"events); device-busy kernel {dev:.4f} ms, plain {plain_dev:.4f} "
            f"ms (profiler)")
    return rows


def check_cascade(device):
    import torch

    from iisan_tpu_torch.ops import fused_san as fs

    gen = torch.Generator(device=device).manual_seed(SEED)
    S, N, K, D, R = 3, TABLE_CHUNK, K_TAPS, TAP_DIM, BOTTLENECK

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    # Every term moves the carry by O(1): wd ~ N(0, 1/D) and wu ~ N(0, 1/R)
    # keep z and the up projection near unit scale, the biases are N(0,
    # 0.25), and the gates are spread around 0.5.
    gates = torch.randn(S, K, generator=gen, device=device) * 0.1
    coef_a = torch.sigmoid(gates / fs.GATE_TEMPERATURE)
    coef_a[2] = 1.0  # branch 2 is the additive (inter) form
    coef_b = 1.0 - coef_a
    coef_b[2] = 1.0
    args = (coef_a, coef_b, rand(S, N, K, D), rand(S, K, D, R, scale=D ** -0.5),
            rand(S, K, R, scale=0.5), rand(S, K, R, D, scale=R ** -0.5),
            rand(S, K, D, scale=0.5), rand(S, N, D))

    def beyond(got, want):
        """Per branch, the largest |got - want| / carry_tolerance(want)."""
        ratio = (got.float() - want.float()).abs() / fs.carry_tolerance(want)
        return [float(r.max()) for r in ratio]

    errs = {}
    for act in ("RELU", "GELU"):
        got = fs.san_cascade_fwd(*args, activation=act)
        want = fs.san_cascade_fwd_plain(*args, activation=act)
        torch.cuda.synchronize()
        ratios = beyond(got, want)
        errs[act] = float((got.float() - want.float()).abs().max())
        differ = float((got != want).float().mean())
        log(f"san_cascade_fwd {act}: max|kernel-plain| {errs[act]:.6g}; per "
            f"branch max |diff| / bound {', '.join(f'{r:.3f}' for r in ratios)}"
            f" (must be <= 1); {differ:.2%} of values not bit-equal")
        if not torch_finite(got) or max(ratios) > 1.0:
            raise AssertionError(f"san_cascade_fwd {act} disagrees with its "
                                 "plain version")

    # Planted faults: what a kernel with a wrong body would return, made by
    # the kernel itself from altered arguments, against the true plain
    # result.  Each must break the bound in every branch.
    want = fs.san_cascade_fwd_plain(*args)
    a, b, taps, wd, bd, wu, bu, c0 = args
    step0 = [w[:, :1].expand_as(w) for w in (wd, bd, wu, bu)]
    faults = {
        "bd dropped": ((a, b, taps, wd, torch.zeros_like(bd), wu, bu, c0), "RELU"),
        "bu dropped": ((a, b, taps, wd, bd, wu, torch.zeros_like(bu), c0), "RELU"),
        "GELU for ReLU": (args, "GELU"),
        "step-0 weights": ((a, b, taps, step0[0], step0[1], step0[2], step0[3],
                            c0), "RELU"),
    }
    for name, (fargs, act) in faults.items():
        ratios = beyond(fs.san_cascade_fwd(*fargs, activation=act), want)
        log(f"  planted fault '{name}': per branch max |diff| / bound "
            f"{', '.join(f'{r:.3g}' for r in ratios)} (must be > 1)")
        if min(ratios) <= 1.0:
            raise AssertionError(f"the cascade bound admits the fault {name}")

    ms = cuda_timed(lambda: fs.san_cascade_fwd(*args), 10)
    plain_ms = cuda_timed(lambda: fs.san_cascade_fwd_plain(*args), 10)
    dev = device_ms(lambda: fs.san_cascade_fwd(*args), 5)
    plain_dev = device_ms(lambda: fs.san_cascade_fwd_plain(*args), 5)
    gflop = S * N * K * 2 * 2 * D * R / 1e9
    log(f"san_cascade_fwd S={S} N={N} K={K} D={D} R={R} ReLU: kernel "
        f"{ms:.4f} ms ({gflop / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms "
        f"(median of 10, CUDA events); device-busy kernel {dev:.4f} ms, plain "
        f"{plain_dev:.4f} ms (profiler)")
    return max(errs.values()), ms, plain_ms


def grad_ratio(got, want, tol, unpack):
    """Largest |got - want| / (tol * (max|want| + |want|)) over gx and each
    parameter gradient; the backward agrees when it is <= 1."""
    worst = 0.0
    pairs = [(got[0], want[0])] + list(zip(unpack(got[1]), unpack(want[1])))
    for g, w in pairs:
        g, w = g.float(), w.float()
        if not torch_finite(g):
            return float("inf")
        bound = tol * (w.abs().max() + w.abs())
        worst = max(worst, float(((g - w).abs() / bound.clamp_min(1e-30)).max()))
    return worst


def relu_grad_dropped(x, mask3, params, gout, kw):
    """The gradients a backward without the ReLU's gradient would give:
    autograd of the plain forward with the ReLU's gradient passed on
    unmasked (its values unchanged)."""
    import torch

    from iisan_tpu_torch.ops import fused_user_encoder as fue

    relu = torch.relu
    torch.relu = lambda t: t + (relu(t) - t).detach()
    try:
        xx = x.detach().clone().requires_grad_(True)
        pp = params.detach().clone().requires_grad_(True)
        y = fue.user_encoder_fwd_plain(xx, mask3, pp, **kw)
        return torch.autograd.grad(y, (xx, pp), gout)
    finally:
        torch.relu = relu


def check_user_encoder_train(device):
    """Train-mode forward and the backward kernel against their plain
    versions at the training shapes; returns the kernel JSON numbers."""
    import torch

    from iisan_tpu_torch.models.user_encoder import (UserEncoder,
                                                     causal_additive_mask)
    from iisan_tpu_torch.ops import fused_user_encoder as fue

    seed, rate = 20251016, DROP
    kw = dict(n_layers=BLOCKS, n_heads=HEADS, d_ff=4 * EMB, n_position=SEQ_LEN)

    def unpack(t):
        return fue.unpack_encoder_params(t, EMB, 4 * EMB, BLOCKS, SEQ_LEN)

    gen = torch.Generator().manual_seed(SEED)
    enc = UserEncoder(EMB, SEQ_LEN, HEADS, BLOCKS, DROP, generator=gen)
    with torch.no_grad():  # move LayerNorms and biases off their init
        for p in enc.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    enc = enc.to(device)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        params = enc.packed_params(dtype)
        for b in (64, 1):
            x = torch.randn(b, SEQ_LEN, EMB, generator=gen).to(device, dtype)
            lengths = torch.randint(1, SEQ_LEN + 1, (b,), generator=gen)
            lengths[-1] = 0 if b > 1 else lengths[-1]  # an all-pad row
            log_mask = torch.arange(SEQ_LEN)[None] >= SEQ_LEN - lengths[:, None]
            mask3 = causal_additive_mask(log_mask.float().to(device)).reshape(
                b, SEQ_LEN, SEQ_LEN)
            gout = torch.randn(b, SEQ_LEN, EMB, generator=gen).to(device, dtype)
            tkw = dict(kw, seed=seed, rate=rate)
            if b == 64 and dtype == torch.bfloat16:
                got = fue.user_encoder_fwd(x, mask3, params, **tkw)
                want = fue.user_encoder_fwd_plain(x, mask3, params, **tkw)
                torch.cuda.synchronize()
                out["fwd_err"] = max_err(got, want, UE_TOL)
                out["fwd_ms"] = cuda_timed(
                    lambda: fue.user_encoder_fwd(x, mask3, params, **tkw), 50)
                out["fwd_plain_ms"] = cuda_timed(
                    lambda: fue.user_encoder_fwd_plain(x, mask3, params, **tkw), 10)
                log(f"user_encoder_fwd train B=64 rate {rate} bf16: max|kernel-"
                    f"plain| {out['fwd_err']:.6g} (tol atol {UE_TOL[0]} rtol "
                    f"{UE_TOL[1]}); kernel {out['fwd_ms']:.4f} ms, plain "
                    f"{out['fwd_plain_ms']:.4f} ms (medians, CUDA events)")
            want = fue.user_encoder_bwd_plain(x, mask3, params, gout, **tkw)
            got = fue.user_encoder_bwd(x, mask3, params, gout, **tkw)
            torch.cuda.synchronize()
            tol = BWD_TOL[name]
            ratio = grad_ratio(got, want, tol, unpack)
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            log(f"user_encoder_bwd B={b} {name} train: max |diff| / bound "
                f"{ratio:.4f} (must be <= 1; tol {tol} * (max|plain| + "
                f"|plain|) per tensor), max|kernel-plain| {err:.6g}")
            if ratio > 1.0:
                raise AssertionError(f"user_encoder_bwd B={b} {name} disagrees "
                                     "with its plain version")
            out["bwd_err"] = max(out.get("bwd_err", 0.0), err)
            if b != 64:
                continue
            faults = {
                "backward seed != forward seed": fue.user_encoder_bwd(
                    x, mask3, params, gout, **dict(tkw, seed=seed + 1)),
                "ReLU gradient dropped": relu_grad_dropped(
                    x, mask3, params, gout, tkw),
            }
            for fault, fgot in faults.items():
                fr = grad_ratio(fgot, want, tol, unpack)
                log(f"  planted fault '{fault}': max |diff| / bound {fr:.4g} "
                    "(must be > 1)")
                if fr <= 1.0:
                    raise AssertionError(f"the backward bound admits '{fault}'")
            if dtype == torch.bfloat16:
                out["bwd_ms"] = cuda_timed(
                    lambda: fue.user_encoder_bwd(x, mask3, params, gout, **tkw), 50)
                out["bwd_plain_ms"] = cuda_timed(
                    lambda: fue.user_encoder_bwd_plain(x, mask3, params, gout,
                                                       **tkw), 10)
                log(f"user_encoder_bwd B=64 bf16 train: kernel "
                    f"{out['bwd_ms']:.4f} ms, plain {out['bwd_plain_ms']:.4f} ms "
                    "(medians, CUDA events)")
    return out


# Device-kernel families of a training step, by kernel name (the first
# pattern that matches wins).
KERNEL_FAMILIES = (("encoder kernels", ("user_encoder", "grad_reduce")),
                   ("cascade kernel", ("san_cascade",)),
                   ("attention kernels", ("mha_",)),
                   ("Adam", ("adam", "multi_tensor")),
                   ("matmul", ("gemm", "xmma", "cutlass", "splitk", "nvjet")),
                   ("other", ("",)))


def kernel_families(prof, reps):
    """Device ms per step by ``KERNEL_FAMILIES`` from a profile of ``reps``
    steps, and the (ms, name) of each kernel in "other"."""
    families = {name: 0.0 for name, _ in KERNEL_FAMILIES}
    other = []
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        key = e.key.lower()
        name = next(n for n, pats in KERNEL_FAMILIES
                    if any(pat in key for pat in pats))
        ms = e.self_device_time_total / 1e3 / reps
        families[name] += ms
        if name == "other":
            other.append((ms, e.key[:60]))
    return families, other


def step_breakdown(tr, batch, reps):
    """Where one training step's time goes: host-clock medians of its
    phases, each ended by a synchronise (gather, SAN + heads + com_dense,
    user encoder + loss, backward, Adam), and the device time of the
    step's kernels by family (profiler, ``reps`` steps).  Returns
    (phase ms, family ms), both per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iisan_tpu_torch.ops.losses import sequence_train_loss

    model, ids, log_mask = tr.model, *batch
    phases = {k: [] for k in ("gather", "SAN + heads", "encoder + loss",
                              "backward", "Adam")}

    def step(times):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        flat = ids.reshape(-1)
        cv, text = tr.cv_table[flat], tr.text_table[flat]
        mark()
        score = model.fuse(*model.san(cv, text))
        mark()
        loss = sequence_train_loss(model.user_encoder, score, ids, log_mask,
                                   tr.pop_prob, SEQ_LEN, EMB, False,
                                   tr.generator)
        mark()
        tr.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark()
        tr.optimizer.step()
        mark()
        if times is not None:
            for k, a, b in zip(phases, marks, marks[1:]):
                times[k].append((b - a) * 1e3)

    step(None)
    for _ in range(reps):
        step(phases)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(None)
        torch.cuda.synchronize()
    families, _ = kernel_families(prof, reps)
    return ({k: sorted(v)[len(v) // 2] for k, v in phases.items()}, families)


def train_route(device, corpus, taps, use_pallas, counters):
    """One full epoch and a valid evaluation of the cached trainer on one
    SAN route; returns the trainer and the epoch's kernel launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.train.cached import CachedTrainer

    name = "use_pallas" if use_pallas else "default"
    cfg = IISANConfig(use_pallas=use_pallas, **TRAIN_CFG)
    tr = CachedTrainer(cfg, corpus, *taps, device=device)
    steps = -(-USERS // cfg.batch_size)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_loss = tr.run_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    losses = tr._last_step_losses.float().cpu().numpy()
    t0 = time.perf_counter()
    hit, ndcg = tr.evaluate_split("valid")
    eval_s = time.perf_counter() - t0
    perm = torch.as_tensor(tr.epoch_permutation(2), device=device).long()
    batch = (tr.train_seqs[perm[0]], tr.train_log_mask[perm[0]])
    busy = device_ms(lambda: tr.train_step(*batch), 10)
    phases, families = step_breakdown(tr, batch, 10)
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    log(f"train[{name}]: {steps} steps in {epoch_s:.3f} s "
        f"({epoch_s / steps * 1e3:.3f} ms/step, host clock); device-busy "
        f"{busy:.3f} ms/step (profiler, 10 steps); mean loss {mean_loss:.5f}, "
        f"first 20 steps {first:.5f}, last 20 {last:.5f}; valid HR@10 "
        f"{hit:.6f} nDCG@10 {ndcg:.6f} in {eval_s:.3f} s; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    log(f"train[{name}] step breakdown: host-clock medians of 10, each phase "
        "ended by a synchronise: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in phases.items())
        + "; device time per step by kernel family (profiler): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in families.items()))
    if len(losses) != steps or not np.isfinite(losses).all() or last >= first:
        raise AssertionError(f"train[{name}]: the loss did not fall")
    if not (np.isfinite(hit) and 0 <= ndcg <= hit <= 1):
        raise AssertionError(f"train[{name}]: bad metrics {hit} {ndcg}")
    want = {"user_encoder_fwd": steps, "user_encoder_bwd": steps,
            "san_cascade_fwd": 2 * steps if use_pallas else 0}
    if launches != want:
        raise AssertionError(f"train[{name}]: launches {launches}, expected {want}")
    return tr, launches


def check_gradients_reach_parameters(device, corpus, taps):
    """Five steps through the kernels (use_pallas, fused encoder) and five
    through the module path (default route, fused=False) from the same
    weights at dropout 0: the losses agree and every parameter gets a
    nonzero gradient on both."""
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.train.cached import CachedTrainer

    runs = {}
    for name, kw in (("kernels", dict(use_pallas=True)),
                     ("module", dict(fused_user_encoder=False))):
        cfg = IISANConfig(**dict(TRAIN_CFG, drop_rate=0.0, **kw))
        runs[name] = CachedTrainer(cfg, corpus, *taps, device=device)
    runs["module"].model.load_state_dict(runs["kernels"].model.state_dict())
    perm = torch.as_tensor(runs["kernels"].epoch_permutation(1), device=device)
    losses = {}
    for name, tr in runs.items():
        losses[name] = []
        for step in range(5):
            ids = perm[step].long()
            losses[name].append(float(tr.train_step(tr.train_seqs[ids],
                                                    tr.train_log_mask[ids])))
            if step == 0:
                dead = [n for n, p in tr.model.named_parameters()
                        if p.grad is None or not bool(p.grad.abs().sum() > 0)]
                if dead:
                    raise AssertionError(f"{name}: no gradient for {dead[:5]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernels"], losses["module"]))
    log("5 steps from one set of weights at dropout 0: kernels "
        + ", ".join(f"{v:.5f}" for v in losses["kernels"]) + "; module path "
        + ", ".join(f"{v:.5f}" for v in losses["module"])
        + f"; max relative difference {rel:.3g} (tol 2e-2); every parameter "
        "has a nonzero gradient on both")
    if rel > 2e-2:
        raise AssertionError("the kernel path's losses leave the module path's")


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the H100 could take
    to move ``nbytes`` and do ``flops`` bf16 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mha_bound(B, T, D, H, bias: bool, bwd: bool):
    """The attention kernels' bound at one shape: q, k, v (and g) read,
    o (or gq, gk, gv) written, bf16, the bias read once; the forward's two
    products, the backward's five (the scores are recomputed)."""
    tensors = 7 if bwd else 4
    nbytes = tensors * B * T * D * 2 + (B * T * 4 if bias else 0)
    flops = (10 if bwd else 4) * B * H * T * T * (D // H)
    return bound(nbytes, flops)


def encoder_flops(B: int) -> float:
    """Forward operations of the user encoder over B sequences: per block
    the four projections, the two attention products and the FFN."""
    L, D, F = SEQ_LEN, EMB, 4 * EMB
    return B * BLOCKS * (8 * L * D * D + 4 * L * L * D + 4 * L * D * F)


def encoder_param_count() -> int:
    import math

    from iisan_tpu_torch.ops import fused_user_encoder as fue

    return sum(math.prod(s) for s in fue.param_shapes(EMB, 4 * EMB, BLOCKS, SEQ_LEN))


def encoder_bounds(B_fwd: int, B_bwd: int):
    """Bounds of the user-encoder kernels: the forward reads x, the mask
    and the packed fp32 parameters and writes its output; the backward
    also reads g and writes gx and the fp32 parameter gradient, and does
    the forward's products three times (recompute, two gradients)."""
    P, L, D = encoder_param_count(), SEQ_LEN, EMB
    fwd = bound(2 * B_fwd * L * D * 2 + B_fwd * L * L * 4 + P * 4,
                encoder_flops(B_fwd))
    bwd = bound(3 * B_bwd * L * D * 2 + B_bwd * L * L * 4 + 2 * P * 4,
                3 * encoder_flops(B_bwd))
    return fwd, bwd


def cascade_bound(S: int, N: int):
    """The cascade reads its taps, carry and bf16 weights once and writes
    the final carry; two products of D x R per tap."""
    K, D, R = K_TAPS, TAP_DIM, BOTTLENECK
    nbytes = (S * N * K * D + 2 * S * N * D + S * K * (2 * D * R + R + D)) * 2
    return bound(nbytes, S * N * K * 4 * D * R)


def mha_ratio(got, want):
    """max |got - want| / (max|want| + |want|) over paired tensors; inf
    when a value of ``got`` is not finite."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if not torch_finite(a):
            return float("inf")
        scale = (b.abs().max() + b.abs()).clamp_min(1e-30)
        worst = max(worst, float(((a - b).abs() / scale).max()))
    return worst


def check_attention(device):
    """The tower-attention kernels against their plain versions at the
    uncached step's shapes; returns their JSON entries' numbers."""
    import torch
    import torch.nn.functional as F

    from iisan_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED)
    D, H = TOWER_D, TOWER_H

    def qkvg(B, T):
        return [torch.randn(B, T, D, generator=gen, device=device).to(torch.bfloat16)
                for _ in range(4)]

    def require(ratio, tol, what):
        if not ratio <= tol:
            raise AssertionError(f"{what}: |diff| / bound {ratio:.4g} > {tol}")

    out = {"fwd_err": 0.0, "bwd_err": 0.0}

    def err(got, want):
        return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))

    # BERT titles: 30 tokens, padded keys, the pad item's all-pad row
    B, T = STEP_ROWS, TITLE_T
    q, k, v, g = qkvg(B, T)
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=device)
    lengths[0] = 0
    bias = torch.where(torch.arange(T, device=device)[None] < lengths[:, None],
                       0.0, -1e9)
    seed, rate = 20251016, DROP
    for name, kw in (("eval", dict(n_heads=H)),
                     ("train", dict(n_heads=H, seed=seed, rate=rate, layer=5))):
        got = fa.mha_fwd(q, k, v, bias, **kw)
        want = fa.mha_fwd_plain(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        ratio = mha_ratio([got], [want])
        out["fwd_err"] = max(out["fwd_err"], err([got], [want]))
        log(f"mha_fwd BERT {name} B={B} T={T} D={D} H={H} bf16, padded keys: "
            f"max |diff| / (max|plain| + |plain|) {ratio:.4g} (tol "
            f"{MHA_TOL['fwd']}); all-pad row finite {torch_finite(got[0])}")
        require(ratio, MHA_TOL["fwd"], f"mha_fwd BERT {name}")
        if not torch_finite(got[0]):
            raise AssertionError("mha_fwd: the all-pad row is not finite")
    r0 = fa.mha_mask_replay.launches
    masks = fa.mha_mask_replay(seed, B, T, H, rate, 5, device)
    plain_masks = fa.attention_dropout_masks(seed, B, T, H, rate, 5, device)
    oracle = fa.reference_mha_masked(q, k, v, bias, H, torch.bfloat16, masks)
    got = fa.mha_fwd(q, k, v, bias, n_heads=H, seed=seed, rate=rate, layer=5)
    keep = float((masks > 0).float().mean())
    log(f"mha_mask_replay B={B} T={T} H={H} rate {rate}: bit-equal to the "
        f"plain masks {torch.equal(masks, plain_masks)}, keep share {keep:.4f}; "
        f"train-mode mha_fwd vs the explicit-mask oracle: "
        f"{mha_ratio([got], [oracle]):.4g} (tol {MHA_TOL['fwd']})")
    if not torch.equal(masks, plain_masks) or abs(keep - (1 - rate)) > 0.01:
        raise AssertionError("mha_mask_replay differs from its plain version")
    require(mha_ratio([got], [oracle]), MHA_TOL["fwd"], "mha_fwd vs the mask oracle")
    out["replay_ms"] = cuda_timed(
        lambda: fa.mha_mask_replay(seed, B, T, H, rate, 5, device), 20)
    out["replay_plain_ms"] = cuda_timed(
        lambda: fa.attention_dropout_masks(seed, B, T, H, rate, 5, device), 5)
    out["replay_oracle_launches"] = fa.mha_mask_replay.launches - r0
    out["replay_bound"] = bound(B * H * T * T * 4, 0)
    fault = mha_ratio([fa.mha_fwd(q, k, v, None, n_heads=H)],
                      [fa.mha_fwd_plain(q, k, v, bias, n_heads=H)])
    log(f"  planted fault 'key bias dropped' (padded batch): {fault:.4g} "
        f"(must be > {MHA_TOL['fwd']})")
    if fault <= MHA_TOL["fwd"]:
        raise AssertionError("the forward bound admits a dropped key bias")
    sdpa_mask = bias[:, None, None, :].to(torch.bfloat16)
    heads = [t.reshape(B, T, H, D // H).transpose(1, 2).contiguous() for t in (q, k, v)]
    out["bert_fwd_ms"] = cuda_timed(lambda: fa.mha_fwd(q, k, v, bias, n_heads=H), 20)
    out["bert_fwd_plain_ms"] = cuda_timed(
        lambda: fa.mha_fwd_plain(q, k, v, bias, n_heads=H), 10)
    out["bert_sdpa_ms"] = cuda_timed(
        lambda: F.scaled_dot_product_attention(*heads, attn_mask=sdpa_mask), 20)
    log(f"mha_fwd BERT eval B={B}: kernel {out['bert_fwd_ms']:.4f} ms, plain "
        f"{out['bert_fwd_plain_ms']:.4f} ms, scaled_dot_product_attention "
        f"{out['bert_sdpa_ms']:.4f} ms (medians, CUDA events); bound "
        f"{mha_bound(B, T, D, H, True, False)[0]:.4f} ms")

    # ViT images: 197 tokens, eval mode, no bias
    T = IMAGE_T
    q, k, v, g = qkvg(B, T)
    got = fa.mha_fwd(q, k, v, None, n_heads=H)[:64]
    want = fa.mha_fwd_plain(q[:64], k[:64], v[:64], None, n_heads=H)
    torch.cuda.synchronize()
    ratio = mha_ratio([got], [want])
    out["fwd_err"] = max(out["fwd_err"], err([got], [want]))
    log(f"mha_fwd ViT eval B={B} T={T} (first 64 rows vs plain): {ratio:.4g} "
        f"(tol {MHA_TOL['fwd']})")
    require(ratio, MHA_TOL["fwd"], "mha_fwd ViT")
    heads = [t.reshape(B, T, H, D // H).transpose(1, 2).contiguous() for t in (q, k, v)]
    out["fwd_ms"] = cuda_timed(lambda: fa.mha_fwd(q, k, v, None, n_heads=H), 10)
    out["fwd_sdpa_ms"] = cuda_timed(
        lambda: F.scaled_dot_product_attention(*heads), 10)
    out["fwd_plain_ms"] = cuda_timed(
        lambda: fa.mha_fwd_plain(q, k, v, None, n_heads=H), 5)
    out["fwd_bound"] = mha_bound(B, T, D, H, False, False)
    log(f"mha_fwd ViT eval B={B}: kernel {out['fwd_ms']:.4f} ms, plain "
        f"{out['fwd_plain_ms']:.4f} ms, scaled_dot_product_attention "
        f"{out['fwd_sdpa_ms']:.4f} ms; bound {out['fwd_bound'][0]:.4f} ms "
        f"({out['fwd_bound'][1]})")
    del heads

    # The backward at the FFT step's shapes (88 rows)
    B = FFT_BATCH * (SEQ_LEN + 1)
    cases = (("BERT train", TITLE_T, True, dict(n_heads=H, seed=seed, rate=rate, layer=3)),
             ("ViT eval", IMAGE_T, False, dict(n_heads=H)))
    for name, T, padded, kw in cases:
        q, k, v, g = qkvg(B, T)
        b = None
        if padded:
            lengths = torch.randint(1, T + 1, (B,), generator=gen, device=device)
            lengths[0] = 0
            b = torch.where(torch.arange(T, device=device)[None] < lengths[:, None],
                            0.0, -1e9)
        got = fa.mha_bwd(q, k, v, b, g, **kw)
        want = fa.mha_bwd_plain(q, k, v, b, g, **kw)
        torch.cuda.synchronize()
        ratio = mha_ratio(got, want)
        out["bwd_err"] = max(out["bwd_err"], err(got, want))
        log(f"mha_bwd {name} B={B} T={T} bf16: gq, gk, gv max |diff| / (max|plain| "
            f"+ |plain|) {ratio:.4g} (tol {MHA_TOL['bwd']}); finite "
            f"{all(torch_finite(t) for t in got)}")
        require(ratio, MHA_TOL["bwd"], f"mha_bwd {name}")
        faults = {}
        if padded:
            faults["backward seed != forward seed"] = fa.mha_bwd(
                q, k, v, b, g, **dict(kw, seed=seed + 1))
        softmax_bwd = fa._softmax_bwd
        fa._softmax_bwd = lambda p32, gp: p32 * gp
        try:
            faults["softmax row term dropped"] = fa.mha_bwd_plain(q, k, v, b, g, **kw)
        finally:
            fa._softmax_bwd = softmax_bwd
        for fault, fgot in faults.items():
            fr = mha_ratio(fgot, got)
            log(f"  planted fault '{fault}': {fr:.4g} (must be > {MHA_TOL['bwd']})")
            if fr <= MHA_TOL["bwd"]:
                raise AssertionError(f"the backward bound admits '{fault}'")
        ms = cuda_timed(lambda: fa.mha_bwd(q, k, v, b, g, **kw), 10)
        plain_ms = cuda_timed(lambda: fa.mha_bwd_plain(q, k, v, b, g, **kw), 5)
        bnd = mha_bound(B, T, D, H, padded, True)
        log(f"mha_bwd {name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        if not padded:
            out["bwd_ms"], out["bwd_plain_ms"], out["bwd_bound"] = ms, plain_ms, bnd
    return out


def uncached_trainer(device, corpus, **kw):
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.images import (SyntheticImageStore,
                                             synthetic_token_table)
    from iisan_tpu_torch.train.uncached import UncachedTrainer

    cfg = IISANConfig(**{**UNCACHED_CFG, **kw})
    tokens = synthetic_token_table(corpus.item_num, cfg.num_words_title, seed=0)
    tr = UncachedTrainer(cfg, corpus, tokens, SyntheticImageStore(cfg.CV_resize),
                         device=device)
    torch.cuda.synchronize()
    return tr


def staged_batch(tr, step: int = 0):
    """One training batch of the trainer's epoch-1 order, on the card."""
    c = tr.corpus
    users = tr.epoch_permutation(1)[step]
    flat = c.train_seqs[users].reshape(-1)
    images = next(iter(tr.loader.iter_batches([tr._names(flat)])))
    return (tr._put(c.train_seqs[users]), tr._put(images),
            tr._put(tr.token_table[flat]), tr._put(c.train_log_mask[users]))


def uncached_breakdown(tr, batch, reps):
    """(host ms per step, median of ``reps`` synchronised steps on a
    staged batch; device-busy ms per step; device ms per step by kernel
    family, from the profiler).  Also logs the largest kernels of the
    "other" family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    host = host_timed(lambda: (tr.train_step(*batch), torch.cuda.synchronize()), reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            tr.train_step(*batch)
        torch.cuda.synchronize()
    families, other = kernel_families(prof, reps)
    log("  largest 'other' kernels per step: " + "; ".join(
        f"{k} {ms:.2f} ms" for ms, k in sorted(other, reverse=True)[:6]))
    return host, sum(families.values()), families


def counted(counters, fn):
    """Run ``fn`` with every counter at 0; returns (its result, the
    counts)."""
    for c in counters:
        c.launches = 0
    result = fn()
    return result, {c.__name__: c.launches for c in counters}


def train_iisan_uncached(device, counters):
    """Phase 8: one IISAN (Uncached) epoch, the item table and a valid
    evaluation at the published configuration; returns the launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    corpus = synthetic_corpus(n_users=512, item_num=800, max_seq_len=SEQ_LEN, seed=0)
    tr = uncached_trainer(device, corpus)
    steps = tr.epoch_permutation(1).shape[0]
    model = tr.model
    towers = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(("text_tower.", "image_tower."))}
    san_before = model.san.fc_cv.kernel.detach().clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_loss, launches = counted(counters, lambda: tr.run_epoch(1))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    losses = tr._last_step_losses.float().cpu().numpy()
    t0 = time.perf_counter()
    table, table_launches = counted(counters, tr.item_embedding_tables)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hit, ndcg = tr.evaluate_split("valid")
    eval_s = time.perf_counter() - t0
    unchanged = all(torch.equal(p, towers[n]) for n, p in model.named_parameters()
                    if n in towers)
    moved = not torch.equal(model.san.fc_cv.kernel, san_before)
    batch = staged_batch(tr, 1)
    host, busy, families = uncached_breakdown(tr, batch, 5)
    log(f"uncached IISAN: {steps} steps of {tr.cfg.batch_size} users "
        f"({STEP_ROWS} images + titles) in {epoch_s:.3f} s ({epoch_s / steps * 1e3:.1f} "
        f"ms/step with image decoding, host clock); losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f" (mean {mean_loss:.5f}); "
        f"launches {launches}; tower weights unchanged {unchanged}, SAN moved {moved}")
    log(f"uncached IISAN item table: {table.shape[0]} rows in {table_s:.3f} s, "
        f"launches {table_launches}; valid HR@10 {hit:.6f} nDCG@10 {ndcg:.6f} "
        f"(table + evaluation {eval_s:.3f} s)")
    log(f"uncached IISAN step on a staged batch: host {host:.2f} ms (median of 5, "
        f"synchronised), device-busy {busy:.2f} ms (profiler): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items()))
    want = {"mha_fwd": 24 * steps, "mha_bwd": 0, "user_encoder_fwd": steps,
            "user_encoder_bwd": steps}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"uncached IISAN: launches {launches}, expected {want}")
    if not np.isfinite(losses).all() or len(losses) != steps:
        raise AssertionError("uncached IISAN: the loss is not finite")
    if not (unchanged and moved):
        raise AssertionError("uncached IISAN: a frozen tower moved or the SAN did not")
    if table.shape != (801, EMB) or not torch_finite(table):
        raise AssertionError(f"uncached IISAN: bad item table {tuple(table.shape)}")
    if not (np.isfinite(hit) and 0 <= ndcg <= hit <= 1):
        raise AssertionError(f"uncached IISAN: bad metrics {hit} {ndcg}")
    if table_launches["mha_fwd"] != 24 * 4:
        raise AssertionError(f"uncached IISAN table: launches {table_launches}")
    return {k: launches[k] + table_launches[k] for k in launches}


def train_fft(device, counters):
    """Phase 9: three full fine-tuning steps of batch 8; returns the
    launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    corpus = synthetic_corpus(n_users=3 * FFT_BATCH, item_num=800,
                              max_seq_len=SEQ_LEN, seed=0)
    tr = uncached_trainer(device, corpus, batch_size=FFT_BATCH,
                          adding_adapter_to="None", adapter_type="houslby")
    if tr.method != "fft":
        raise AssertionError(f"expected the fft method, got {tr.method}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    mean_loss, launches = counted(counters, lambda: tr.run_epoch(1))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    losses = tr._last_step_losses.float().cpu().numpy()
    towers = [(n, p) for n, p in tr.model.named_parameters()
              if n.startswith(("text_tower.", "image_tower."))]
    dead = [n for n, p in towers if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    host, busy, families = uncached_breakdown(tr, staged_batch(tr, 0), 3)
    log(f"FFT: 3 steps of {FFT_BATCH} users ({FFT_BATCH * (SEQ_LEN + 1)} images) in "
        f"{epoch_s:.3f} s; losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches}; {len(towers) - len(dead)} of {len(towers)} tower "
        f"parameters have a nonzero gradient; peak memory {peak:.2f} GiB")
    log(f"FFT step on a staged batch: host {host:.2f} ms (median of 3, "
        f"synchronised), device-busy {busy:.2f} ms (profiler): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items()))
    if launches["mha_bwd"] != 24 * 3 or launches["mha_fwd"] != 24 * 3:
        raise AssertionError(f"FFT: launches {launches}")
    if not np.isfinite(losses).all() or dead:
        raise AssertionError(f"FFT: loss {losses}, no gradient for {dead[:5]}")
    return launches


def check_uncached_routes(device):
    """Phase 10: 3 IISAN and 3 FFT steps from one set of weights at dropout
    0, through the kernels and through the module path."""
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    for name, corpus, kw in (
            ("IISAN", synthetic_corpus(n_users=3 * 64, item_num=800,
                                       max_seq_len=SEQ_LEN, seed=0), {}),
            ("FFT", synthetic_corpus(n_users=3 * FFT_BATCH, item_num=800,
                                     max_seq_len=SEQ_LEN, seed=0),
             dict(batch_size=FFT_BATCH, adding_adapter_to="None",
                  adapter_type="houslby"))):
        losses = {}
        state = None
        for route, rkw in (("kernels", {}),
                           ("module", dict(fused_tower_attention=False,
                                           fused_user_encoder=False))):
            tr = uncached_trainer(device, corpus, tower_dropout=0.0,
                                  drop_rate=0.0, **kw, **rkw)
            if state is None:
                state = {k: v.clone() for k, v in tr.model.state_dict().items()}
            else:
                tr.model.load_state_dict(state)
            tr.run_epoch(1)
            losses[route] = tr._last_step_losses.float().cpu().tolist()
            del tr
            torch.cuda.empty_cache()
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernels"], losses["module"]))
        log(f"{name}, 3 steps from one set of weights at dropout 0: kernels "
            + ", ".join(f"{v:.5f}" for v in losses["kernels"]) + "; module path "
            + ", ".join(f"{v:.5f}" for v in losses["module"])
            + f"; max relative difference {rel:.3g} (tol 2e-2)")
        if rel > 2e-2:
            raise AssertionError(f"{name}: the kernel route's losses leave the module path's")


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def run_slice(device, use_pallas, cv_taps, text_taps, split, requests, tmp):
    import numpy as np
    import torch

    from iisan_tpu_torch.eval.evaluate import compute_item_tables, evaluate
    from iisan_tpu_torch.models.model import IISANRecModel
    from iisan_tpu_torch.models.san import SideAdapterNetwork
    from iisan_tpu_torch.serve import Recommender, serve_http
    from iisan_tpu_torch.utils.jax_params import (export_jax_params,
                                                  load_jax_params)

    gen = torch.Generator().manual_seed(SEED)
    san = SideAdapterNetwork(EMB, TAP_DIM, TAP_DIM, K_TAPS, K_TAPS, BOTTLENECK,
                             BOTTLENECK, use_pallas=use_pallas,
                             batch_intra=True, dtype=torch.bfloat16,
                             generator=gen)
    model = IISANRecModel(san, EMB, SEQ_LEN, HEADS, BLOCKS, DROP,
                          dtype=torch.bfloat16, generator=gen).to(device).eval()
    name = "use_pallas" if use_pallas else "default"

    def build_table():
        out = compute_item_tables(model, cv_taps, text_taps, chunk=TABLE_CHUNK)
        torch.cuda.synchronize()
        return out

    table = build_table()
    table_ms = host_timed(build_table, 3)
    table_busy = device_ms(build_table, 1)
    if table.shape != (ITEMS + 1, EMB) or not torch_finite(table):
        raise AssertionError(f"bad item table {tuple(table.shape)}")

    hit, ndcg = evaluate(model, table, *split, batch_size=EVAL_BATCH)
    eval_ms = host_timed(
        lambda: evaluate(model, table, *split, batch_size=EVAL_BATCH), 3)
    if not (np.isfinite(hit) and np.isfinite(ndcg) and 0 <= ndcg <= hit <= 1):
        raise AssertionError(f"bad metrics HR@10 {hit} nDCG@10 {ndcg}")

    rec = Recommender(model, table, SEQ_LEN)
    latency, busy, direct = {}, {}, {}
    for b, seqs in requests.items():
        direct[b] = rec.top_k(seqs, k=10)
        latency[b] = host_timed(lambda s=seqs: rec.top_k(s, k=10), 20)
        busy[b] = device_ms(lambda s=seqs: rec.top_k(s, k=10), 10)
        if not np.isfinite(direct[b][1]).all() or (direct[b][0] < 1).any():
            raise AssertionError(f"bad top-K at batch {b}")

    server = serve_http(rec, "127.0.0.1", 0, max_batch=256)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/recommend"
        for b, seqs in requests.items():
            got = post(url, {"sequences": seqs, "k": 10})["items"]
            if got != direct[b][0].tolist():
                raise AssertionError(f"HTTP top-K differs at batch {b}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    # The artifact is fp32 and loads as an fp32 user encoder over an fp32
    # table, as in the JAX package: hold it against an fp32 Recommender
    # built directly from the same table and encoder weights.
    path = str(Path(tmp) / f"rec_{name}.npz")
    rec.save(path)
    loaded = Recommender.load(path, device=device)
    ref_model = IISANRecModel(None, EMB, SEQ_LEN, HEADS, BLOCKS, 0.0,
                              dtype=torch.float32, device=device)
    load_jax_params(ref_model.user_encoder,
                    export_jax_params(model.user_encoder))
    ref = Recommender(ref_model.eval(), table.float(), SEQ_LEN)
    same_as_bf16 = []
    for b, seqs in requests.items():
        ids = loaded.top_k(seqs, k=10)[0]
        if not np.array_equal(ids, ref.top_k(seqs, k=10)[0]):
            raise AssertionError(f"save -> load top-K differs at batch {b}")
        same_as_bf16.append(float((ids == direct[b][0]).mean()))

    log(f"slice[{name}]: item table {ITEMS + 1} rows in {table_ms:.3f} ms "
        f"(device-busy {table_busy:.3f} ms); valid HR@10 {hit:.6f} nDCG@10 "
        f"{ndcg:.6f} over {USERS} users in {eval_ms:.3f} ms (medians of 3 "
        f"after a warm-up); top_k median latency of 20 (device-busy) "
        + ", ".join(f"batch {b} {ms:.3f} ms ({busy[b]:.3f} ms)"
                    for b, ms in latency.items())
        + "; HTTP ids identical to direct; save->load ids identical to an "
        f"fp32 Recommender (which shares {min(same_as_bf16):.1%} or more of "
        "its ids with the bf16 one)")
    return model, table


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "iisan_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no iisan_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    from iisan_tpu_torch.kernels import build
    from iisan_tpu_torch.ops import fused_san as fs
    from iisan_tpu_torch.ops import fused_user_encoder as fue

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"kernels built from {build.CSRC.relative_to(ROOT)} into "
        f"{lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    ue = check_user_encoder(device)
    cascade = check_cascade(device)

    import numpy as np

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    corpus = synthetic_corpus(n_users=USERS, item_num=ITEMS,
                              max_seq_len=SEQ_LEN, seed=SEED)
    split = (corpus.valid_tokens, corpus.valid_log_mask, corpus.valid_target,
             corpus.valid_history)
    # a request is a user's items but the last (the test target)
    requests = {b: [row[row > 0].tolist() for row in corpus.test_history[:b]]
                for b in (1, 32, 256)}
    gen = torch.Generator(device=device).manual_seed(SEED)
    taps = []
    for _ in range(2):  # cv, text: (items + pad, K, D) in bf16 on the card
        t = torch.randn((ITEMS + 1, K_TAPS, TAP_DIM), generator=gen,
                        device=device).to(torch.bfloat16)
        t[0] = 0  # the pad item's row
        taps.append(t)

    import tempfile

    fue.user_encoder_fwd.launches = 0
    fs.san_cascade_fwd.launches = 0
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        model, table_plain = run_slice(device, False, *taps, split, requests, tmp)
        counts_default = (fue.user_encoder_fwd.launches,
                          fs.san_cascade_fwd.launches)
        _, table_kernel = run_slice(device, True, *taps, split, requests, tmp)
    counts = (fue.user_encoder_fwd.launches, fs.san_cascade_fwd.launches)
    log(f"launches: default run user_encoder_fwd {counts_default[0]}, "
        f"san_cascade_fwd {counts_default[1]}; use_pallas run "
        f"user_encoder_fwd {counts[0] - counts_default[0]}, san_cascade_fwd "
        f"{counts[1] - counts_default[1]}")
    if counts_default[0] == 0 or counts[0] - counts_default[0] == 0:
        raise AssertionError("the user-encoder kernel was not launched")
    if counts_default[1] != 0 or counts[1] - counts_default[1] == 0:
        raise AssertionError("the cascade kernel ran off its dispatch")

    # Both runs share their weights: the kernel route's table agrees with
    # the plain route's up to the cascades' cast chains (one bf16 rounding
    # of the carry per step in the kernel, two in the batched reference).
    diff = float((table_kernel.float() - table_plain.float()).abs().max())
    scale = float(table_plain.float().abs().max())
    log(f"item table, kernel route vs plain route: max |diff| {diff:.6g} "
        f"(max |value| {scale:.4g})")
    if diff > 0.05 * max(scale, 1.0):
        raise AssertionError("the two SAN routes disagree")

    # The user encoder through the kernel vs its module path, same requests.
    tokens = torch.as_tensor(np.asarray(split[0][:EVAL_BATCH]), device=device)
    log_mask = torch.as_tensor(split[1][:EVAL_BATCH], device=device)
    with torch.no_grad():
        embs = table_plain[tokens.long()]
        fused = model.user_scores(embs, log_mask)
        model.user_encoder.fused = False
        module = model.user_scores(embs, log_mask)
    ue_diff = max_err(fused, module, UE_TOL)
    log(f"user encoder, kernel vs module path at batch {EVAL_BATCH}: max "
        f"|diff| {ue_diff:.6g} (tol atol {UE_TOL[0]} rtol {UE_TOL[1]})")

    # Training: the kernels at the training shapes, then the trainer on
    # both SAN routes over the same tap tables.
    train = check_user_encoder_train(device)
    del model, table_plain, table_kernel, embs, fused, module
    torch.cuda.empty_cache()
    counters = (fue.user_encoder_fwd, fue.user_encoder_bwd, fs.san_cascade_fwd)
    trained = {}
    for use_pallas in (False, True):
        tr, trained[use_pallas] = train_route(device, corpus, taps, use_pallas,
                                              counters)
        del tr
        torch.cuda.empty_cache()
    check_gradients_reach_parameters(device, corpus, taps)
    train_counts = {k: trained[False][k] + trained[True][k]
                    for k in trained[False]}
    del taps
    torch.cuda.empty_cache()

    # Uncached training: the attention kernels at the step's shapes, then
    # IISAN (Uncached), the FFT baseline and the two attention routes.
    from iisan_tpu_torch.ops import fused_attention as fa

    attn = check_attention(device)
    torch.cuda.empty_cache()
    ucounters = (fa.mha_fwd, fa.mha_bwd, fa.mha_mask_replay,
                 fue.user_encoder_fwd, fue.user_encoder_bwd, fs.san_cascade_fwd)
    iisan_counts = train_iisan_uncached(device, ucounters)
    torch.cuda.empty_cache()
    fft_counts = train_fft(device, ucounters)
    torch.cuda.empty_cache()
    check_uncached_routes(device)
    uncached = {k: iisan_counts[k] + fft_counts[k] for k in iisan_counts}
    ue_bound, ue_bwd_bound = encoder_bounds(256, 64)

    def entry(name, replaces, launches, err, ms, plain_ms, bnd, library_ms):
        return {"name": name, "route": "cuda",
                "source": f"iisan_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    kernels = [
        entry("user_encoder_fwd", "iisan_tpu/ops/fused_user_encoder.py:264",
              counts[0] + train_counts["user_encoder_fwd"]
              + uncached["user_encoder_fwd"],
              max([r[0] for r in ue.values()] + [train["fwd_err"]]),
              ue[256][1], ue[256][2], ue_bound, None),
        entry("user_encoder_bwd", "iisan_tpu/ops/fused_user_encoder.py:327",
              train_counts["user_encoder_bwd"] + uncached["user_encoder_bwd"],
              train["bwd_err"], train["bwd_ms"], train["bwd_plain_ms"],
              ue_bwd_bound, None),
        entry("san_cascade_fwd", "iisan_tpu/ops/fused_san.py:49",
              counts[1] + train_counts["san_cascade_fwd"], cascade[0],
              cascade[1], cascade[2], cascade_bound(3, TABLE_CHUNK), None),
        entry("mha_fwd", "iisan_tpu/ops/fused_attention.py:73",
              uncached["mha_fwd"], attn["fwd_err"], attn["fwd_ms"],
              attn["fwd_plain_ms"], attn["fwd_bound"], attn["fwd_sdpa_ms"]),
        entry("mha_bwd", "iisan_tpu/ops/fused_attention.py:106",
              uncached["mha_bwd"], attn["bwd_err"], attn["bwd_ms"],
              attn["bwd_plain_ms"], attn["bwd_bound"], None),
        entry("mha_mask_replay", "iisan_tpu/ops/fused_attention.py:165",
              uncached["mha_mask_replay"], 0.0, attn["replay_ms"],
              attn["replay_plain_ms"], attn["replay_bound"], None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
