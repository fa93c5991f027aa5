#!/usr/bin/env python3
"""Drive the PyTorch port's cached serving and training paths once on one
NVIDIA GPU.

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
7. Print one JSON line of per-kernel results, then the final status line.

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
                   ("Adam", ("adam", "multi_tensor")),
                   ("matmul", ("gemm", "xmma", "cutlass", "splitk")),
                   ("other", ("",)))


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
    families = {name: 0.0 for name, _ in KERNEL_FAMILIES}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        key = e.key.lower()
        name = next(n for n, pats in KERNEL_FAMILIES
                    if any(pat in key for pat in pats))
        families[name] += e.self_device_time_total / 1e3 / reps
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

    kernels = [
        {"name": "user_encoder_fwd", "route": "cuda",
         "source": "iisan_tpu_torch/csrc/user_encoder_fwd.cu",
         "replaces": "iisan_tpu/ops/fused_user_encoder.py:264",
         "launches": counts[0] + train_counts["user_encoder_fwd"],
         "max_abs_err": max([r[0] for r in ue.values()] + [train["fwd_err"]]),
         "ms": ue[256][1], "plain_ms": ue[256][2]},
        {"name": "user_encoder_bwd", "route": "cuda",
         "source": "iisan_tpu_torch/csrc/user_encoder_bwd.cu",
         "replaces": "iisan_tpu/ops/fused_user_encoder.py:327",
         "launches": train_counts["user_encoder_bwd"],
         "max_abs_err": train["bwd_err"],
         "ms": train["bwd_ms"], "plain_ms": train["bwd_plain_ms"]},
        {"name": "san_cascade_fwd", "route": "cuda",
         "source": "iisan_tpu_torch/csrc/san_cascade_fwd.cu",
         "replaces": "iisan_tpu/ops/fused_san.py:49",
         "launches": counts[1] + train_counts["san_cascade_fwd"],
         "max_abs_err": cascade[0],
         "ms": cascade[1], "plain_ms": cascade[2]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
