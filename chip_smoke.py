#!/usr/bin/env python3
"""Drive the PyTorch port's cached serving and training paths, its
uncached training paths (IISAN and full fine-tuning, and IISAN's W8A8 and
attention-subblock tower options) and IISAN-Versa
(``pipeline="cached_asym"``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. Print the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``iisan_tpu_torch/csrc`` and print the
   build time, ptxas's per-kernel report and the count of tensor-core
   instructions (HMMA, HGMMA, from ``cuobjdump -sass``) in each
   user-encoder kernel; the bf16 route's three must have some.
3. Hold each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the serving path gives it: the user-encoder forward
   at batch 1 and 256 (L=10, D=64, H=2, F=256, 2 blocks); the SAN cascade
   (#3) at S=3 branches x N=8192 rows (one item-table chunk), at the
   cached step's launch (S=1, N=704) and at the Versa image side (D=192),
   K=7, D=768, R=64, with ReLU and GELU, element by element, each repeated
   bit for bit and timed beside its bound.  Planted faults (a dropped bias,
   the other activation, step 0's weights at every step; at the step, one
   cluster rank's partial of z dropped) must each break the cascade's bound
   in every branch.  Then #3 at the geometries it once refused:
   (K, D, R) = (1, 4096, 64) and (2, 3584, 64) bf16, (1, 2048, 64) fp32,
   (7, 768, 48) bf16.  Times are medians of CUDA-event timings.
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
   batch 64 and 1, train mode, bf16 (tensor cores) and fp32 (CUDA cores),
   ``gx`` and every parameter gradient.  Planted faults (the backward run
   with another seed than the forward, the ReLU's gradient dropped, and in
   bf16 the weight-gradient pass run without the last layer's gq|gk|gv
   rows) must break the backward's bound; the bf16 backward's device
   memory at batch 64 must stay under 4 MB.  Both encoder kernels report
   their device time by kernel name (profiler) beside their CUDA-event
   times, per call and over 50 back-to-back calls.
6. Train at the benchmark's cached configuration (``bench.py``: the
   ``IISANConfig`` defaults with lr 2e-4, batch 64, K=7, D=768, R=64, emb
   64, dropout 0.1, bf16) over a synthetic Scientific-size corpus (12,076
   users, 20,825 items: 189 steps an epoch): one full epoch and a valid
   evaluation on the default SAN route, then on ``use_pallas=True``.  The
   launch counters must show the encoder kernels once per step on both
   routes and the cascade kernel twice per step on the kernel route only;
   the loss must be finite and its last 20 steps lower than its first 20.
   The step's device-busy time and the cascade kernels' share of it are
   printed for both routes.
   Then, from one set of weights at dropout 0, five steps through the
   kernels and five through the module path must give losses within 2e-2
   and a nonzero gradient for every parameter on both; then three steps at
   ``max_seq_len=20`` (the encoder backward's stash in its global
   scratch), the encoder kernels once a step.
7. Hold the tower-attention kernels against their plain versions in bf16
   (``check_attention``): the forward at the BERT step geometry (704
   titles x 30 tokens, D=768, 12 heads, padded key bias with an all-pad
   row) in eval mode and in train mode (dropout 0.1, the same Philox masks
   on both sides), at the ViT step geometry (704 images x 197 tokens,
   compared on a 64-image slice, timed at 704) in eval mode and in fp32,
   and at 257 tokens (a 256-pixel ViT) in eval and train mode; the
   backward at the FFT step's shapes (88 rows, ``MHA_BWD_CASES``), BERT
   and 257 tokens in train mode and ViT in eval mode (bf16: the
   tensor-core design), ViT in fp32 (the CUDA-core one), each case's
   design printed, and two launches bit-equal at ViT's shape; the mask
   replay kernel bit for bit.  Planted faults (the key bias dropped on the
   padded batch, the backward run with another seed, the softmax row term
   dropped from the backward) must break the bounds; all-pad rows must
   stay finite.  The library call ``scaled_dot_product_attention`` is
   timed beside every case: on the eval-mode forward shapes (fp32 too),
   and its backward alone beside each #6 case (the padding bias as
   ``attn_mask``, ``dropout_p`` in train mode: timing only).
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
11. Hold the streamed cascade kernel (#4) against its plain version in
   bf16 at the Versa text geometry (K=7, D=8192): N=8192 (a table chunk)
   and 704 (a training step), R=64 and 128, ReLU and GELU, gated and
   additive, element by element under ``carry_tolerance``.  Planted faults
   (bd dropped, GELU for ReLU, step 0's weights at every step, g and 1-g
   swapped) must each break the bound.  CUDA-event medians of kernel and
   plain version beside the bound.  Then the "eva" width (K=6, D=5120) and
   R = 96 and 320 at D=2048 at the step's rows, each repeated bit for bit.
12. The dispatch on the card: ``fused_cascade`` launches #4 and not #3 at
   (K, D, R) = (7, 8192, 64) bf16, #3 and not #4 at (7, 192, 64), neither
   at (7, 8192, 64) fp32; #3 at phase 3's once-refused geometries and #4 at (7,
   2048, 320), each within ``carry_tolerance`` of the route's plain
   version.
13. IISAN-Versa training at the published Llama-3-70B x ViT-tiny geometry
   (``scripts/run_IISAN_versa.py``'s "llama" variant and GRID): random
   bf16 tap tables on the card, text (20,826, 7, 8192) and image (20,826,
   7, 192), pad row 0; one full epoch (189 steps) and a valid evaluation
   on the default route (no cascade kernel) and on ``use_pallas`` (#4 and
   #3 once a step each), the encoder kernels once a step on both; the loss
   must fall; the learned gates are printed.  Then five kernel-route and
   five module-route steps from one set of weights at dropout 0 agree
   within 2e-2, every parameter (``down_project_list_*`` included) with a
   nonzero gradient.  The step's device-busy time and each cascade
   kernel's share are printed for both routes.
14. The same taps as int8 tables (``cache_quant="int8"``, quantised on the
   card): resident bytes of each table in both forms, 20 steps with a
   finite loss, the item table within 0.05 x its largest value of the one
   the bf16 tables give from the same weights, a valid evaluation.
15. Serving the trained Versa model: ``Recommender.from_trainer``, top-K at
   batch 1, 32 and 256, HTTP and save -> load checks as in phase 4.
16. Hold the W8A8 linear (#10: the quantise kernel and the int8 wgmma
   GEMM) against ``int8_matmul`` on the card, bit for bit, at every tower
   dense layer's (K, N) = (768, 768), (768, 3072), (3072, 768) at the
   step's ViT rows (138,688) and BERT rows (21,120), bf16 with bias, plus
   an fp32 case, one without bias, BERT-large's (4096, 1024), K = 8192,
   ViT-tiny's D = 192 layers and ragged M, K and N in bf16 and fp32, zero
   rows in each; the quantise kernel alone bit-equal to ``quantize_rows``;
   planted faults (bias dropped, rounding toward zero, one activation scale
   for the tensor, the last K slice dropped, the weight read MN-major) must
   each break equality.  CUDA-event medians beside the bounds, each call's
   device split (quantise / GEMM, profiler); bf16 ``F.linear`` and
   ``torch._int_mm`` timed for context at the tower shapes (other
   functions).
17. IISAN (Uncached) with ``tower_quant="int8"`` at phase 8's
   configuration: a float trainer's tower trees, exported with the bridge,
   grafted into an int8 trainer (quantised at graft time) with the same
   other weights.  The item table through #10 is bit-equal to the one
   through ``int8_matmul`` on the card and within 0.15 (relative Frobenius)
   of the float towers' table; one epoch (8 steps: 145 ``fused_w8a8_matmul``
   calls, each one quantise and one GEMM launch, and 24 ``mha_fwd`` a step,
   580 and 96 for the table), a finite loss, int8 weights, scales and tower
   biases bit-unchanged, a SAN weight moved, a valid evaluation, the step's
   breakdown and its device-busy time beside ``fused_mha``'s (phase 8).
18. Hold the attention subblocks (#8, #9) against their plain versions in
   bf16 at the BERT step geometry (704 x 30, padded keys, an all-pad row;
   eval and train with the same Philox masks), the ViT one (704 x 197,
   compared on 64 images, timed at 704) and at 257 and 325 tokens (64
   images, padded keys, eval and train; timed at 704), within
   ``MHA_TOL["fwd"]``; planted faults (key bias dropped, one head's rows
   of Wo skipped, masks of another seed) must break the bound.  Each op's
   device split (qkv GEMM, attention, output GEMM) is printed with the
   GEMMs' TFLOP/s beside ``torch.matmul`` of the same products (a
   yardstick the port never calls); ``F.multi_head_attention_forward`` is
   the library call.
19. IISAN (Uncached) with ``fused_tower_attention="subblock"`` and
   ``"subblock_v2"``: 3 steps and the item table each (24 calls of the
   route's kernel a step, none of the other and no ``mha_fwd``), the
   step's breakdown; then 3 steps of each and of ``fused_mha`` from one
   set of weights at dropout 0, losses within 2e-2.
20. IISAN (Uncached) at ``CV_resize=256`` (257 image tokens): 3 steps
   through ``fused_mha`` (24 #5 launches a step) and 3 through the
   ``subblock`` route (24 #8); at ``CV_resize=288`` (325 tokens) 3 steps
   through ``subblock``; each with its step breakdown.
21. Print the uncached step's device-busy time on each tower route of this
   run, one JSON line of per-kernel results, then the final status line.

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
# fp32 attention (the fp32 compute dtype): the same form at 1e-4, summation
# order only, as tests/test_torch_kernels_cuda.py.
MHA_TOL_FP32 = 1e-4
# The uncached step: BERT-base titles and ViT-base images of a batch of 64
# users x (L+1) items.
TOWER_D, TOWER_H, TITLE_T, IMAGE_T = 768, 12, 30, 197
# A ViT at CV_resize=256 and 288: 16 x 16 and 18 x 18 patches and the CLS
# token.
IMAGE_T_256, IMAGE_T_288 = 257, 325
STEP_ROWS, FFT_BATCH = 64 * (SEQ_LEN + 1), 8
# The H100 SXM's published peaks (NVIDIA data sheet, dense), for the bounds.
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
# The W8A8 kernels' shapes on the step: every tower dense layer's (K, N) at
# the ViT rows (704 images x 197 tokens) and the BERT rows (704 x 30); and
# BERT-large's FFN output layer (K = 4096, N = 1024) at the BERT rows.
W8A8_SHAPES = ((768, 768), (768, 3072), (3072, 768))
W8A8_LARGE = (4096, 1024)
# Shapes past the earlier kernel's limits: K = 8192 (past 6,272), ViT-tiny's
# D = 192 layers at the ViT rows, and ragged M, K and N: (M, K, N).
W8A8_WIDE = ((STEP_ROWS * TITLE_T, 8192, 1024), (STEP_ROWS * IMAGE_T, 192, 192),
             (STEP_ROWS * IMAGE_T, 192, 768), (STEP_ROWS * IMAGE_T, 768, 192))
W8A8_RAGGED = ((1, 256, 384), (127, 768, 768), (129, 768, 768), (300, 320, 384),
               (300, 100, 256), (300, 77, 200), (129, 256, 100))
VIT_ROWS, BERT_ROWS = STEP_ROWS * IMAGE_T, STEP_ROWS * TITLE_T
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
# IISAN-Versa at its published geometry (scripts/run_IISAN_versa.py:19-40,
# "llama"): Llama-3-70B text states 81 x 8192 with taps 4,19,...,79 and
# ViT-tiny image states 13 x 192 with taps 1,3,...,11, under the GRID of
# :59-65, which is TRAIN_CFG's (lr 2e-4, adapter lrs 1e-4, batch 64, emb 64,
# bottleneck 64, dropout 0.1, bf16).
VERSA_TEXT_DIM, VERSA_IMAGE_DIM = 8192, 192
VERSA_CFG = dict(TRAIN_CFG, pipeline="cached_asym", adapter_type="IISAN",
                 adding_adapter_to="all", fine_tune_to="None",
                 text_embedding_dim=VERSA_TEXT_DIM,
                 image_embedding_dim=VERSA_IMAGE_DIM, text_layers=80,
                 image_layers=12, side_adapter_bert_list="4,19,34,49,64,79",
                 side_adapter_vit_list="1,3,5,7,9,11",
                 cached_text_model="llama70b_GPTQ_embeddings",
                 cached_image_model="vit_tiny_outputs",
                 cached_text_prefix="llama", cached_image_prefix="vit")


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


def cuda_loop_ms(fn, reps: int):
    """Milliseconds a call over ``reps`` back-to-back calls between two
    CUDA events: the device's pace where the host keeps ahead of it."""
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    # the serving path's packed vector and its cached bf16 weight image
    params, image = enc._serving_params(torch.bfloat16)
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

        def call():
            return fue.user_encoder_fwd(x, mask3, params, image=image, **kw)

        ms = cuda_timed(call, 50)
        plain_ms = cuda_timed(
            lambda: fue.user_encoder_fwd_plain(x, mask3, params, **kw), 50)
        split = kernel_device_ms(call)
        plain_dev = device_ms(
            lambda: fue.user_encoder_fwd_plain(x, mask3, params, **kw), 20)
        rows[b] = (err, ms, plain_ms, sum(split.values()))
        log(f"user_encoder_fwd B={b}: max|kernel-plain| {err:.6g} "
            f"(tol atol {UE_TOL[0]} rtol {UE_TOL[1]}); per call kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 50, CUDA "
            f"events), {cuda_loop_ms(call, 50):.4f} ms a call over 50 back to "
            f"back; device {split_text(split)}, plain {plain_dev:.4f} ms "
            "(profiler)")
    return rows


def split_text(split) -> str:
    """'a ms (kernel b ms, ...)' of a kernel_device_ms split."""
    parts = ", ".join(f"{k.split('(')[0].split(' ')[-1]} {v:.4f}"
                      for k, v in sorted(split.items()))
    return f"{sum(split.values()):.4f} ms ({parts})"


def sass_mma_counts(lib_path, pattern: str):
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of each kernel of
    the built library whose name holds ``pattern`` (cuobjdump -sass)."""
    from iisan_tpu_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            if pattern in name:
                counts[name] = 0
        elif name in counts and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def cascade_inputs(device, gen, S, N, K, D, R, dtype=None):
    """#3's arguments at (S, N, K, D, R), bf16 unless given: every term
    moves the carry by O(1) (wd ~ N(0, 1/D) and wu ~ N(0, 1/R) keep z and
    the up projection near unit scale, the biases are N(0, 0.25)); the
    gates spread around 0.5, the last branch additive (a = b = 1) when
    S > 1."""
    import torch

    from iisan_tpu_torch.ops import fused_san as fs

    dtype = dtype or torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    coef_a = torch.sigmoid(torch.randn(S, K, generator=gen, device=device) * 0.1
                           / fs.GATE_TEMPERATURE)
    coef_b = 1.0 - coef_a
    if S > 1:
        coef_a[-1], coef_b[-1] = 1.0, 1.0
    return (coef_a, coef_b, rand(S, N, K, D), rand(S, K, D, R, scale=D ** -0.5),
            rand(S, K, R, scale=0.5), rand(S, K, R, D, scale=R ** -0.5),
            rand(S, K, D, scale=0.5), rand(S, N, D))


def carry_ratios(got, want):
    """Per branch, the largest |got - want| / carry_tolerance(want); inf
    where a value is not finite."""
    from iisan_tpu_torch.ops import fused_san as fs

    if not torch_finite(got):
        return [float("inf")] * got.shape[0]
    ratio = (got.float() - want.float()).abs() / fs.carry_tolerance(want)
    return [float(r.max()) for r in ratio]


# #3's shapes on the main path: (S, N, D) at K=7, R=64 -- the cached step's
# launch (twice a step), the Versa image side (once a Versa step), an item
# table chunk.  The geometries the kernels once refused (D past shared memory,
# R not dividing 256):
# (K, D, R, dtype) at the step's rows.
CASCADE_STEP, CASCADE_VERSA_IMAGE, CASCADE_TABLE = (1, STEP_ROWS, TAP_DIM), \
    (1, STEP_ROWS, VERSA_IMAGE_DIM), (3, TABLE_CHUNK, TAP_DIM)
ONCE_REFUSED = ((1, 4096, 64, "bfloat16"), (2, 3584, 64, "bfloat16"),
                (1, 2048, 64, "float32"), (7, TAP_DIM, 48, "bfloat16"))
# #4 beyond phase 11's grid: (K, D, R), the eva width and R = 96, 320.
STREAMED_EXTRA = ((6, 5120, 64), (7, 2048, 96), (7, 2048, 320))


def check_cascade(device):
    """#3 against its plain version at the main path's shapes (ReLU and
    GELU, element by element under ``carry_tolerance``), with planted
    faults, timed beside the bound at each shape; then the geometries it
    once refused.
    Returns the JSON numbers (the table chunk's times) and every shape's."""
    import torch

    from iisan_tpu_torch.ops import fused_san as fs

    gen = torch.Generator(device=device).manual_seed(SEED)
    K, R = K_TAPS, BOTTLENECK
    errs, times = {}, {}
    for S, N, D in (CASCADE_TABLE, CASCADE_STEP, CASCADE_VERSA_IMAGE):
        args = cascade_inputs(device, gen, S, N, K, D, R)
        plan = fs.cascade_plan(S, N, K, D, R, torch.bfloat16)
        for act in ("RELU", "GELU"):
            got = fs.san_cascade_fwd(*args, activation=act)
            want = fs.san_cascade_fwd_plain(*args, activation=act)
            torch.cuda.synchronize()
            ratios = carry_ratios(got, want)
            err = float((got.float() - want.float()).abs().max())
            errs[(S, N, D, act)] = err
            log(f"san_cascade_fwd S={S} N={N} D={D} {act} ({plan.cluster}-block "
                f"clusters of {plan.d_slice} columns): max|kernel-plain| {err:.6g}; "
                f"per branch max |diff| / bound {', '.join(f'{r:.3f}' for r in ratios)}"
                f" (must be <= 1); {float((got != want).float().mean()):.2%} of values "
                "not bit-equal")
            if max(ratios) > 1.0:
                raise AssertionError(f"san_cascade_fwd {act} disagrees with its "
                                     "plain version")
            if not torch.equal(got, fs.san_cascade_fwd(*args, activation=act)):
                raise AssertionError("san_cascade_fwd does not repeat bit for bit")

        # Planted faults: what a kernel with a wrong body would return, made
        # by the kernel itself from altered arguments, against the true plain
        # result.  Each must break the bound in every branch.
        want = fs.san_cascade_fwd_plain(*args)
        a, b, taps, wd, bd, wu, bu, c0 = args
        faults = {}
        if (S, N, D) == CASCADE_TABLE:
            step0 = [w[:, :1].expand_as(w) for w in (wd, bd, wu, bu)]
            faults = {
                "bd dropped": ((a, b, taps, wd, torch.zeros_like(bd), wu, bu, c0), "RELU"),
                "bu dropped": ((a, b, taps, wd, bd, wu, torch.zeros_like(bu), c0), "RELU"),
                "GELU for ReLU": (args, "GELU"),
                "step-0 weights": ((a, b, taps, *step0, c0), "RELU"),
            }
        elif plan.cluster > 1:  # z's partial of one cluster rank's D slice dropped
            rank = plan.cluster // 2
            cut = wd.clone()
            cut[..., rank * plan.d_slice:(rank + 1) * plan.d_slice, :] = 0
            faults = {f"rank {rank} of {plan.cluster}'s partial dropped":
                      ((a, b, taps, cut, bd, wu, bu, c0), "RELU")}
        for name, (fargs, act) in faults.items():
            ratios = carry_ratios(fs.san_cascade_fwd(*fargs, activation=act), want)
            log(f"  planted fault '{name}': per branch max |diff| / bound "
                f"{', '.join(f'{r:.3g}' for r in ratios)} (must be > 1)")
            if min(ratios) <= 1.0:
                raise AssertionError(f"the cascade bound admits the fault {name}")

        ms = cuda_timed(lambda: fs.san_cascade_fwd(*args), 20)
        plain_ms = cuda_timed(lambda: fs.san_cascade_fwd_plain(*args), 10)
        dev = device_ms(lambda: fs.san_cascade_fwd(*args), 10)
        bnd = cascade_bound(S, N, D, R)
        times[(S, N, D)] = (ms, plain_ms, bnd)
        gflop = S * N * K * 2 * 2 * D * R / 1e9
        log(f"san_cascade_fwd S={S} N={N} K={K} D={D} R={R} ReLU: kernel "
            f"{ms:.4f} ms ({gflop / ms:.1f} TFLOP/s), plain {plain_ms:.4f} ms "
            f"(medians, CUDA events); device-busy kernel {dev:.4f} ms "
            f"(profiler); bound {bnd[0]:.4f} ms ({bnd[1]})")
        del args, want, got
    for K, D, R, dt in ONCE_REFUSED:
        dtype = getattr(torch, dt)
        args = cascade_inputs(device, gen, 1, STEP_ROWS, K, D, R, dtype)
        before = fs.san_cascade_fwd.launches
        got = fs.san_cascade_fwd(*args)
        want = fs.san_cascade_fwd_plain(*args)
        torch.cuda.synchronize()
        ratio = carry_ratios(got, want)[0]
        plan = fs.cascade_plan(1, STEP_ROWS, K, D, R, dtype)
        log(f"san_cascade_fwd at once-refused (K, D, R) = ({K}, {D}, {R}) {dt}, N={STEP_ROWS} "
            f"({plan.cluster} x {plan.d_slice} columns, R padded to {plan.r_pad}, "
            f"carry {plan.carry}): max |diff| / bound {ratio:.3f} (must be <= 1)")
        if ratio > 1.0 or fs.san_cascade_fwd.launches != before + 1:
            raise AssertionError(f"san_cascade_fwd at {(K, D, R, dt)}")
    torch.cuda.empty_cache()
    ms, plain_ms, _ = times[CASCADE_TABLE]
    return {"err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "times": times}


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

    B, L, D = x.shape
    xx = x.detach().clone().requires_grad_(True)
    pp = params.detach().clone().requires_grad_(True)
    flat = fue.unpack_encoder_params(pp, D, kw["d_ff"], kw["n_layers"],
                                     kw["n_position"])
    masks = fue.dropout_masks(kw["seed"], kw["rate"], B, L, D, kw["n_heads"],
                              kw["n_layers"], x.device)
    y = fue._encoder_fwd(xx, mask3, flat, kw["n_layers"], kw["n_heads"], masks,
                         relu=lambda t: t + (torch.relu(t) - t).detach())
    return torch.autograd.grad(y, (xx, pp), gout)


def check_relu_band_fault(x, mask3, params, gout, kw):
    """A planted fault for the bf16 backward's reference: the kernel's
    ReLU decisions with one more flipped just outside the rounding band
    must be refused."""
    import torch

    from iisan_tpu_torch import testing as et

    positive, x1 = et.tc_relu_inputs(x, mask3, params, gout, **kw)
    bad, ratio = et.flip_outside_band(x, mask3, params, positive, **kw)
    try:
        et.plain_bwd_at_decisions(x, mask3, params, gout, bad, x1, **kw)
    except ValueError as e:
        log(f"  planted fault 'a ReLU decision flipped at {ratio:.4g} x the "
            f"rounding band': refused ({e})")
        return
    torch.cuda.synchronize()
    raise AssertionError("the backward's reference takes a ReLU decision "
                         "outside the rounding band")


def check_encoder_layout(device):
    """The Python plan of the bf16 encoder kernels (which the wrappers
    allocate by) against the layout the library computes, at the serving
    and training geometries and the max_seq_len=20 one."""
    import torch

    from iisan_tpu_torch.ops import fused_user_encoder as fue

    keys = ("xin", "ctx", "x1", "hf", "gqkv", "go2", "ghpre", "gh2", "layer",
            "part", "gx32", "scratch", "total")
    for B, L in ((1, SEQ_LEN), (64, SEQ_LEN), (256, SEQ_LEN), (16, 20)):
        lib = fue.library_tc_layout(B, L, EMB, HEADS, 4 * EMB, BLOCKS)
        fwd = fue.encoder_plan(B, L, EMB, HEADS, 4 * EMB, BLOCKS, torch.bfloat16)
        bwd = fue.encoder_plan(B, L, EMB, HEADS, 4 * EMB, BLOCKS, torch.bfloat16,
                               backward=True)
        py = fue.tc_work_layout(B, L, EMB, 4 * EMB, BLOCKS, bwd.scratch_bytes)
        same = ((lib["fwd_place"], lib["fwd_smem"], lib["fwd_scratch"]) == fwd[1:4]
                and (lib["bwd_place"], lib["bwd_smem"], lib["bwd_scratch"]) == bwd[1:4]
                and lib["image"] == fue.tc_image_elems(EMB, 4 * EMB, BLOCKS)
                and all(lib[k] == py[k] for k in keys))
        if not same:
            raise AssertionError(f"encoder_plan differs from the library's layout "
                                 f"at B={B} L={L}: {lib}")
    log("encoder_plan equals the library's bf16 layout at B=1, 64, 256 (L=10) "
        "and B=16 L=20")


def check_user_encoder_train(device):
    """Train-mode forward and the backward kernel against their plain
    versions at the training shapes; returns the kernel JSON numbers."""
    import torch

    from iisan_tpu_torch import testing as et
    from iisan_tpu_torch.models.user_encoder import (UserEncoder,
                                                     causal_additive_mask)
    from iisan_tpu_torch.ops import fused_user_encoder as fue

    check_encoder_layout(device)
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
                def fwd():
                    return fue.user_encoder_fwd(x, mask3, params, **tkw)

                out["fwd_ms"] = cuda_timed(fwd, 50)
                out["fwd_plain_ms"] = cuda_timed(
                    lambda: fue.user_encoder_fwd_plain(x, mask3, params, **tkw), 10)
                split = kernel_device_ms(fwd)
                out["fwd_device_ms"] = sum(split.values())
                log(f"user_encoder_fwd train B=64 rate {rate} bf16: max|kernel-"
                    f"plain| {out['fwd_err']:.6g} (tol atol {UE_TOL[0]} rtol "
                    f"{UE_TOL[1]}); kernel {out['fwd_ms']:.4f} ms, plain "
                    f"{out['fwd_plain_ms']:.4f} ms (medians, CUDA events), "
                    f"{cuda_loop_ms(fwd, 50):.4f} ms a call over 50 back to back; "
                    f"device {split_text(split)}")
            # bf16: the plain backward at the tensor-core kernel's own ReLU
            # decisions, which it takes only where the kernel's FFN input
            # explains them, within four bf16 ulps of the operands' scale
            # (iisan_tpu_torch/testing.py says why)
            *want, flips = et.plain_bwd_at_kernel_decisions(x, mask3, params,
                                                            gout, **tkw)
            got = fue.user_encoder_bwd(x, mask3, params, gout, **tkw)
            torch.cuda.synchronize()
            tol = BWD_TOL[name]
            ratio = grad_ratio(got, want, tol, unpack)
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            taken = ("" if flips is None else
                     f"; plain taken at the kernel's ReLU decisions: {flips.count} "
                     f"differ (at most {flips.limit}), the farthest at "
                     f"{flips.band:.3g} x the rounding band and "
                     f"{flips.explained:.3g} x what the x1 difference explains")
            log(f"user_encoder_bwd B={b} {name} train: max |diff| / bound "
                f"{ratio:.4f} (must be <= 1; tol {tol} * (max|plain| + "
                f"|plain|) per tensor), max|kernel-plain| {err:.6g}{taken}")
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
            if dtype == torch.bfloat16:
                faults["weight gradients without the last layer's gq|gk|gv rows"] = \
                    et.wgrad_rows_dropped(x, mask3, params, gout, tkw)
                check_relu_band_fault(x, mask3, params, gout, tkw)
            for fault, fgot in faults.items():
                fr = grad_ratio(fgot, want, tol, unpack)
                log(f"  planted fault '{fault}': max |diff| / bound {fr:.4g} "
                    "(must be > 1)")
                if fr <= 1.0:
                    raise AssertionError(f"the backward bound admits '{fault}'")
            if dtype == torch.bfloat16:
                # as in a training step: the forward's weight image
                image = fue.weight_image(params, EMB, 4 * EMB, BLOCKS, SEQ_LEN)

                def bwd():
                    return fue.user_encoder_bwd(x, mask3, params, gout,
                                                image=image, **tkw)

                out["bwd_ms"] = cuda_timed(bwd, 50)
                out["bwd_plain_ms"] = cuda_timed(
                    lambda: fue.user_encoder_bwd_plain(x, mask3, params, gout,
                                                       **tkw), 10)
                split = kernel_device_ms(bwd)
                out["bwd_device_ms"] = sum(split.values())
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                bwd()
                torch.cuda.synchronize()
                extra = torch.cuda.max_memory_allocated(device) - before
                log(f"user_encoder_bwd B=64 bf16 train: kernel "
                    f"{out['bwd_ms']:.4f} ms, plain {out['bwd_plain_ms']:.4f} ms "
                    f"(medians, CUDA events), {cuda_loop_ms(bwd, 50):.4f} ms a "
                    f"call over 50 back to back; device {split_text(split)}; "
                    f"peak device memory beyond its inputs {extra} bytes")
                if extra > 4 * 2 ** 20:
                    raise AssertionError("the bf16 encoder backward takes more "
                                         "than 4 MB of device memory")
    return out


# Device-kernel families of a training step, by kernel name (the first
# pattern that matches wins).
KERNEL_FAMILIES = (("encoder kernels", ("user_encoder", "grad_reduce")),
                   ("cascade #3", ("cascade::resident", "san_cascade_f32")),
                   ("cascade #4", ("cascade::streamed",)),
                   ("w8a8", ("w8a8",)),
                   ("subblock kernels", ("subblock",)),
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
    from iisan_tpu_torch.ops.quant import gather_rows

    model, ids, log_mask = tr.model, *batch
    phases = {k: [] for k in ("gather", "SAN + heads", "encoder + loss",
                              "backward", "Adam")}

    def step(times):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        flat = ids.reshape(-1)
        cv, text = gather_rows(tr.cv_table, flat), gather_rows(tr.text_table, flat)
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


# Each cached-trainer route's step: device-busy ms (profiler) and device ms by
# kernel family, filled by ``train_route``.
STEP_SPLITS = {}


def log_step_split(kind, routes):
    """One line: the ``kind`` step's device-busy time on each route of this
    run and the cascade kernels' share of it."""
    parts = []
    for name in routes:
        busy, fam = STEP_SPLITS[name]
        casc = fam["cascade #3"] + fam["cascade #4"]
        parts.append(f"{name} {busy:.3f} ms (cascade #3 {fam['cascade #3']:.3f} ms, "
                     f"#4 {fam['cascade #4']:.3f} ms: {casc / busy:.1%})")
    log(f"{kind} step device-busy by SAN route, this run (profiler, 10 steps): "
        + "; ".join(parts))


def train_route(device, corpus, taps, cfg_kw, counters, per_step, name):
    """One full epoch and a valid evaluation of the cached trainer at
    ``IISANConfig(**cfg_kw)``.  The epoch's launches must be ``per_step``
    times its steps.  Returns the trainer and the launches of the epoch and
    the evaluation's item table."""
    import numpy as np
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.train.cached import CachedTrainer

    cfg = IISANConfig(**cfg_kw)
    tr = CachedTrainer(cfg, corpus, *taps, device=device)
    steps = -(-USERS // cfg.batch_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_loss, launches = counted(counters, lambda: tr.run_epoch(1))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    losses = tr._last_step_losses.float().cpu().numpy()
    t0 = time.perf_counter()
    hit, ndcg = tr.evaluate_split("valid")
    eval_s = time.perf_counter() - t0
    total = {c.__name__: c.launches for c in counters}
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
    STEP_SPLITS[name] = (busy, families)
    if len(losses) != steps or not np.isfinite(losses).all() or last >= first:
        raise AssertionError(f"train[{name}]: the loss did not fall")
    if not (np.isfinite(hit) and 0 <= ndcg <= hit <= 1):
        raise AssertionError(f"train[{name}]: bad metrics {hit} {ndcg}")
    want = {k: v * steps for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"train[{name}]: launches {launches}, expected {want}")
    return tr, total


def check_gradients_reach_parameters(device, corpus, taps, cfg_kw, name):
    """Five steps through the kernels (use_pallas, fused encoder) and five
    through the module path (default route, fused=False) from the same
    weights at dropout 0: the losses agree and every parameter gets a
    nonzero gradient on both."""
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.train.cached import CachedTrainer

    runs = {}
    for route, kw in (("kernels", dict(use_pallas=True)),
                      ("module", dict(fused_user_encoder=False))):
        cfg = IISANConfig(**dict(cfg_kw, drop_rate=0.0, **kw))
        runs[route] = CachedTrainer(cfg, corpus, *taps, device=device)
    runs["module"].model.load_state_dict(runs["kernels"].model.state_dict())
    perm = torch.as_tensor(runs["kernels"].epoch_permutation(1), device=device)
    losses = {}
    for route, tr in runs.items():
        losses[route] = []
        for step in range(5):
            ids = perm[step].long()
            losses[route].append(float(tr.train_step(tr.train_seqs[ids],
                                                     tr.train_log_mask[ids])))
            if step == 0:
                dead = [n for n, p in tr.model.named_parameters()
                        if p.grad is None or not bool(p.grad.abs().sum() > 0)]
                if dead:
                    raise AssertionError(f"{name} {route}: no gradient for "
                                         f"{dead[:5]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["kernels"], losses["module"]))
    n_params = len(list(runs["kernels"].model.parameters()))
    log(f"{name}, 5 steps from one set of weights at dropout 0: kernels "
        + ", ".join(f"{v:.5f}" for v in losses["kernels"]) + "; module path "
        + ", ".join(f"{v:.5f}" for v in losses["module"])
        + f"; max relative difference {rel:.3g} (tol 2e-2); all {n_params} "
        "parameters have a nonzero gradient on both")
    if rel > 2e-2:
        raise AssertionError(f"{name}: the kernel path's losses leave the "
                             "module path's")


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the H100 could take
    to move ``nbytes`` and do ``flops`` operations at ``peak`` (bf16 unless
    given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def w8a8_bound(M: int, K: int, N: int, xsz: int = 2, osz: int = 2):
    """#10 reads x, the int8 weight, kscale and bias once and writes y;
    2 M K N int8 operations."""
    return bound(M * K * xsz + K * N + 8 * N + M * N * osz, 2 * M * K * N,
                 PEAK_INT8_OPS)


def w8a8_quant_bound(M: int, K: int, xsz: int = 2):
    """#10's quantise kernel reads x once and writes xq (M, K_p) and sx."""
    return bound(M * K * xsz + M * (-(-K // 16) * 16) + 4 * M, 0)


def w8a8_gemm_bound(M: int, K: int, N: int, osz: int = 2):
    """#10's GEMM reads xq, sx, the (N, K_p) weight, kscale and bias once
    and writes y; 2 M K N int8 operations."""
    Kp = -(-K // 16) * 16
    return bound(M * Kp + 4 * M + N * Kp + 8 * N + M * N * osz, 2 * M * K * N,
                 PEAK_INT8_OPS)


def subblock_bound(B: int, T: int, bias: bool):
    """#8 / #9 read x, the bf16 weights and fp32 biases (and the key bias)
    once and write the bf16 output; the qkv projection, attention's two
    products and the output projection."""
    D, H = TOWER_D, TOWER_H
    nbytes = B * T * D * 4 + 4 * D * D * 2 + 4 * D * 4 + (B * T * 4 if bias else 0)
    flops = 2 * B * T * D * 4 * D + 4 * B * H * T * T * (D // H)
    return bound(nbytes, flops)


def mha_bound(B, T, D, H, bias: bool, bwd: bool, itemsize: int = 2):
    """The attention kernels' bound at one shape: q, k, v (and g) read,
    o (or gq, gk, gv) written in bf16 (itemsize 2) or fp32, the bias read
    once; the forward's two products, the backward's five (the function's,
    without recomputation), at the bf16 tensor-core or the fp32 peak."""
    tensors = 7 if bwd else 4
    nbytes = tensors * B * T * D * itemsize + (B * T * 4 if bias else 0)
    flops = (10 if bwd else 4) * B * H * T * T * (D // H)
    return bound(nbytes, flops, PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS)


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


def cascade_bound(S: int, N: int, D: int = TAP_DIM, R: int = BOTTLENECK,
                  K: int = K_TAPS):
    """A cascade kernel reads its taps, carry and bf16 weights once and
    writes the final carry; two products of D x R per tap."""
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


# The attention phase's dropout seed, and the backward's cases at the FFT
# step's shapes (88 rows): name, tokens, padded keys (a -1e9 key bias with
# an all-pad row), dtype, dropout layer (None: eval mode).
ATTN_SEED = 20251016
MHA_BWD_CASES = (("BERT train", TITLE_T, True, "bfloat16", 3),
                 ("ViT eval", IMAGE_T, False, "bfloat16", None),
                 ("ViT eval fp32", IMAGE_T, False, "float32", None),
                 ("ViT-256 train", IMAGE_T_256, True, "bfloat16", 4))


def padding_bias(device, gen, B: int, T: int):
    """(B, T) fp32 key bias: random lengths, row 0 all padding (-1e9)."""
    import torch

    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=device)
    lengths[0] = 0
    return torch.where(torch.arange(T, device=device)[None] < lengths[:, None], 0.0, -1e9)


def mha_bwd_case(device, gen, T: int, padded: bool, dtype: str, layer):
    """(q, k, v, g, bias, kw) of one backward case: bf16-rounded normal
    values in ``dtype``, the padding bias or None, the kernels' keywords."""
    import torch

    B, D = FFT_BATCH * (SEQ_LEN + 1), TOWER_D
    q, k, v, g = (torch.randn(B, T, D, generator=gen, device=device).to(torch.bfloat16)
                  .to(getattr(torch, dtype)) for _ in range(4))
    bias = padding_bias(device, gen, B, T) if padded else None
    kw = dict(n_heads=TOWER_H)
    if layer is not None:
        kw.update(seed=ATTN_SEED, rate=DROP, layer=layer)
    return q, k, v, g, bias, kw


def sdpa_bwd(q, k, v, g, bias, rate: float):
    """A function running the backward alone of ``scaled_dot_product_attention``
    on heads-unsplit (B, T, D) inputs: the key bias as ``attn_mask``,
    ``dropout_p`` = rate (its masks are not the port's: timing only).  The
    forward runs here, outside any timed region; its graph is kept for the
    repeated backward."""
    import torch
    import torch.nn.functional as F

    B, T, D = q.shape
    heads = [t.reshape(B, T, TOWER_H, D // TOWER_H).transpose(1, 2) for t in (q, k, v, g)]
    hq = [t.detach().requires_grad_(True) for t in heads[:3]]
    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    ho = F.scaled_dot_product_attention(*hq, attn_mask=mask, dropout_p=rate)
    return lambda: torch.autograd.grad(ho, hq, heads[3], retain_graph=True)


def sdpa_bwd_ms(q, k, v, g, bias, rate: float, reps: int = 10):
    """Median CUDA-event ms of ``sdpa_bwd``'s backward."""
    return cuda_timed(sdpa_bwd(q, k, v, g, bias, rate), reps)


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
    bias = padding_bias(device, gen, B, T)
    seed, rate = ATTN_SEED, DROP
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

    # ViT images: 197 tokens (224 pixels) and 257 (256 pixels), no bias;
    # compared on the first 64 images, timed at 704.  257 in eval and train
    # mode; 197 also in fp32 (the fp32 compute dtype's CUDA-core path).
    for T in (IMAGE_T, IMAGE_T_256):
        q, k, v, g = qkvg(B, T)
        modes = [("eval", dict(n_heads=H))]
        if T == IMAGE_T_256:
            modes.append(("train", dict(n_heads=H, seed=seed, rate=rate, layer=2)))
        for mode, kw in modes:
            got = fa.mha_fwd(q, k, v, None, **kw)[:64]
            want = fa.mha_fwd_plain(q[:64], k[:64], v[:64], None, **kw)
            torch.cuda.synchronize()
            ratio = mha_ratio([got], [want])
            out["fwd_err"] = max(out["fwd_err"], err([got], [want]))
            log(f"mha_fwd ViT {mode} B={B} T={T} (first 64 rows vs plain): "
                f"{ratio:.4g} (tol {MHA_TOL['fwd']})")
            require(ratio, MHA_TOL["fwd"], f"mha_fwd ViT T={T} {mode}")
        heads = [t.reshape(B, T, H, D // H).transpose(1, 2).contiguous() for t in (q, k, v)]
        ms = cuda_timed(lambda: fa.mha_fwd(q, k, v, None, n_heads=H), 10)
        sdpa_ms = cuda_timed(lambda: F.scaled_dot_product_attention(*heads), 10)
        plain_ms = cuda_timed(lambda: fa.mha_fwd_plain(q, k, v, None, n_heads=H), 5)
        bnd = mha_bound(B, T, D, H, False, False)
        log(f"mha_fwd ViT eval B={B} T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, scaled_dot_product_attention {sdpa_ms:.4f} ms; bound {bnd[0]:.4f} "
            f"ms ({bnd[1]})")
        if T == IMAGE_T:
            out.update(fwd_ms=ms, fwd_sdpa_ms=sdpa_ms, fwd_plain_ms=plain_ms, fwd_bound=bnd)
            q32, k32, v32 = (t.float() for t in (q, k, v))
            got = fa.mha_fwd(q32, k32, v32, None, n_heads=H)[:64]
            want = fa.mha_fwd_plain(q32[:64], k32[:64], v32[:64], None, n_heads=H)
            torch.cuda.synchronize()
            ratio = mha_ratio([got], [want])
            ms32 = cuda_timed(lambda: fa.mha_fwd(q32, k32, v32, None, n_heads=H), 3)
            heads32 = [t.reshape(B, T, H, D // H).transpose(1, 2).contiguous()
                       for t in (q32, k32, v32)]
            sdpa32 = cuda_timed(lambda: F.scaled_dot_product_attention(*heads32), 3)
            log(f"mha_fwd ViT eval B={B} T={T} fp32 (first 64 rows vs plain): {ratio:.4g} "
                f"(tol {MHA_TOL_FP32}); kernel {ms32:.4f} ms (CUDA cores), "
                f"scaled_dot_product_attention fp32 {sdpa32:.4f} ms")
            require(ratio, MHA_TOL_FP32, "mha_fwd ViT fp32")
            del q32, k32, v32, heads32
        del heads

    # The backward at the FFT step's shapes (88 rows): bf16 runs the
    # tensor-core design at every T, fp32 the CUDA-core one
    bf16 = torch.bfloat16
    for name, T, padded, dtype, layer in MHA_BWD_CASES:
        q, k, v, g, b, kw = mha_bwd_case(device, gen, T, padded, dtype, layer)
        B = q.shape[0]
        tol = MHA_TOL["bwd"] if q.dtype == bf16 else MHA_TOL_FP32
        got = fa.mha_bwd(q, k, v, b, g, **kw)
        want = fa.mha_bwd_plain(q, k, v, b, g, **kw)
        torch.cuda.synchronize()
        ratio = mha_ratio(got, want)
        if q.dtype == bf16:
            out["bwd_err"] = max(out["bwd_err"], err(got, want))
        design = fa.bwd_design(T, q.element_size())
        log(f"mha_bwd {name} B={B} T={T} {dtype} ({design}): gq, gk, gv max "
            f"|diff| / (max|plain| + |plain|) {ratio:.4g} (tol {tol}); finite "
            f"{all(torch_finite(t) for t in got)}")
        require(ratio, tol, f"mha_bwd {name}")
        if name == "ViT eval":
            again = fa.mha_bwd(q, k, v, b, g, **kw)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            log(f"  two launches bit-equal: {same}")
            if not same:
                raise AssertionError("mha_bwd: two launches on the same inputs differ")
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
            log(f"  planted fault '{fault}': {fr:.4g} (must be > {tol})")
            if fr <= tol:
                raise AssertionError(f"the backward bound admits '{fault}'")
        ms = cuda_timed(lambda: fa.mha_bwd(q, k, v, b, g, **kw), 10)
        plain_ms = cuda_timed(lambda: fa.mha_bwd_plain(q, k, v, b, g, **kw), 5)
        lib_ms = sdpa_bwd_ms(q, k, v, g, b, kw.get("rate", 0.0))
        bnd = mha_bound(B, T, D, H, padded, True, q.element_size())
        if name == "ViT eval":
            out.update(bwd_ms=ms, bwd_plain_ms=plain_ms, bwd_bound=bnd, bwd_sdpa_ms=lib_ms)
        log(f"mha_bwd {name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention backward {lib_ms:.4f} ms"
            f"{' (timing only: other dropout masks)' if 'rate' in kw else ''}; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    return out


def uncached_trainer(device, corpus, tower_params=None, **kw):
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.images import (SyntheticImageStore,
                                             synthetic_token_table)
    from iisan_tpu_torch.train.uncached import UncachedTrainer

    cfg = IISANConfig(**{**UNCACHED_CFG, **kw})
    tokens = synthetic_token_table(corpus.item_num, cfg.num_words_title, seed=0)
    tr = UncachedTrainer(cfg, corpus, tokens, SyntheticImageStore(cfg.CV_resize),
                         tower_params=tower_params, device=device)
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


def train_iisan_uncached(device, counters, busy_by_route):
    """Phase 8: one IISAN (Uncached) epoch, the item table and a valid
    evaluation at the published configuration; returns the launches and
    records the step's device-busy ms in ``busy_by_route``."""
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
    busy_by_route["fused_mha"] = busy
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


def w8a8_split(fn):
    """Device ms per call of ``fn`` (#10) by kernel: quantise, GEMM, other;
    None where three profiles in a row held no kernel (the profiler's trace
    sometimes comes back empty)."""
    for _ in range(3):
        split = {"quantise": 0.0, "GEMM": 0.0, "other": 0.0}
        for key, ms in kernel_device_ms(fn).items():
            split["quantise" if "w8a8_quant_rows" in key else
                  "GEMM" if "w8a8_gemm" in key else "other"] += ms
        if split["quantise"] and split["GEMM"]:
            return split
    return None


def check_w8a8(device):
    """Phase 16: #10 (quantise kernel + int8 wgmma GEMM) against
    ``int8_matmul`` on the card, bit for bit, at the six tower shapes (bf16
    with bias), one fp32 case and one without bias, BERT-large's, K = 8192,
    ViT-tiny's D = 192 and ragged M, K and N, zero rows in each; the
    quantise kernel alone against ``quantize_rows``; planted faults;
    CUDA-event medians beside the bounds, each call's device split
    (quantise / GEMM), and bf16 ``F.linear`` and ``torch._int_mm`` for
    context at the tower shapes (neither computes this function).  Returns
    the JSON entries' numbers."""
    import torch
    import torch.nn.functional as F

    from iisan_tpu_torch.ops import fused_w8a8 as fw
    from iisan_tpu_torch.ops.int8_linear import (int8_matmul, quantize_kernel,
                                                 quantize_rows)

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    towers = [(M, K, N) for M in (VIT_ROWS, BERT_ROWS) for K, N in W8A8_SHAPES]
    cases = [(M, K, N, torch.bfloat16, torch.bfloat16, True) for M, K, N in towers]
    cases += [(BERT_ROWS, 768, 3072, torch.float32, torch.float32, True),
              (BERT_ROWS, 3072, 768, torch.bfloat16, torch.bfloat16, False),
              (BERT_ROWS, *W8A8_LARGE, torch.bfloat16, torch.bfloat16, True)]
    cases += [(M, K, N, torch.bfloat16, torch.bfloat16, True) for M, K, N in W8A8_WIDE]
    cases += [(M, K, N, dt, dt, True) for M, K, N in W8A8_RAGGED
              for dt in (torch.bfloat16, torch.float32)]
    out = {"err": 0.0}
    for M, K, N, dt, odt, with_bias in cases:
        x = torch.randn(M, K, generator=gen, device=device).to(dt)
        x[::97] = 0.0  # zero rows: their output is the bias exactly
        w = torch.randn(K, N, generator=gen, device=device) * 0.05
        q, s = (torch.as_tensor(a, device=device) for a in quantize_kernel(w.cpu().numpy()))
        b = torch.randn(N, generator=gen, device=device) if with_bias else None
        qt = fw.transposed_weight(q)

        def call():
            return fw.fused_w8a8_matmul(x, q, s, b, odt, kernel_qt=qt)

        got = call()
        want = int8_matmul(x, q, s, b, odt)
        torch.cuda.synchronize()
        ndiff = int((got != want).sum())
        out["err"] = max(out["err"], float((got.float() - want.float()).abs().max()))
        ms = cuda_timed(call, 10)
        plain_ms = cuda_timed(lambda: int8_matmul(x, q, s, b, odt), 3)
        split = w8a8_split(call)
        bnd = w8a8_bound(M, K, N, x.element_size(), got.element_size())
        split_text = ("not measured (empty traces)" if split is None else
                      f"quantise {split['quantise']:.4f} + GEMM {split['GEMM']:.4f} + "
                      f"other {split['other']:.4f} ms")
        log(f"w8a8 M={M} K={K} N={N} {str(dt)[6:]} -> {str(odt)[6:]}"
            f"{'' if with_bias else ' no bias'}: {ndiff} of {got.numel()} values differ "
            f"from int8_matmul; call {ms:.4f} ms ({2 * M * K * N / ms / 1e9:.1f} TOPS), "
            f"device {split_text}; plain {plain_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
        if ndiff:
            raise AssertionError("w8a8 is not bit-equal to int8_matmul")
        if (M, K, N) in towers and dt == torch.bfloat16:
            xq = quantize_rows(x)[0].to(torch.int8)
            wb = torch.randn(N, K, generator=gen, device=device).to(dt)
            lin_ms = cuda_timed(lambda: F.linear(x, wb), 10)
            int_mm_ms = cuda_timed(lambda: torch._int_mm(xq, q), 10)
            log(f"  for context at this shape (other functions): bf16 F.linear "
                f"{lin_ms:.4f} ms, torch._int_mm on the quantised operands "
                f"{int_mm_ms:.4f} ms")
            del xq, wb
        if (M, K, N, dt) == (VIT_ROWS, 768, 3072, torch.bfloat16):
            # each kernel alone, and the quantise kernel bit for bit
            xq, sx = fw.w8a8_quant_rows(x)
            want_q, want_s = fw.w8a8_quant_rows_plain(x)
            if not (torch.equal(xq, want_q) and torch.equal(sx, want_s)):
                raise AssertionError("w8a8_quant_rows is not quantize_rows")
            out["quant"] = {
                "err": 0.0, "ms": cuda_timed(lambda: fw.w8a8_quant_rows(x), 10),
                "plain_ms": cuda_timed(lambda: fw.w8a8_quant_rows_plain(x), 3),
                "bound": w8a8_quant_bound(M, K, x.element_size())}
            out["gemm"] = {
                "err": 0.0, "ms": cuda_timed(lambda: fw.w8a8_gemm(xq, sx, qt, s, b, dt), 10),
                "plain_ms": cuda_timed(lambda: fw.w8a8_gemm_plain(xq, sx, qt, s, b, dt), 3),
                "bound": w8a8_gemm_bound(M, K, N, got.element_size())}
            log(f"  quantise alone {out['quant']['ms']:.4f} ms (plain "
                f"{out['quant']['plain_ms']:.4f}, bound {out['quant']['bound'][0]:.4f}); "
                f"GEMM alone {out['gemm']['ms']:.4f} ms (plain {out['gemm']['plain_ms']:.4f}, "
                f"bound {out['gemm']['bound'][0]:.4f}); xq and sx bit-equal to quantize_rows")
            # planted faults, on the first 4096 rows
            xs, flat = x[:4096], got[:4096]
            _, sx4 = quantize_rows(xs)
            trunc = torch.clamp(torch.trunc(xs.float() / sx4.clamp_min(1e-30)), -127, 127)
            one = sx4.max()
            xq4, sxq4 = xq[:4096], sx[:4096]
            dropped = xq4.clone()
            dropped[:, -128:] = 0
            mn_major = qt.reshape(N // 128, 128, K // 128, 128).transpose(1, 3).reshape(N, K)
            faults = {
                "bias dropped": int8_matmul(xs, q, s, None, dt),
                "rint -> toward zero": ((trunc.double() @ q.double()).float()
                                        * (sx4 * s) + b).to(dt),
                "one activation scale": ((torch.round(xs.float() / one).double()
                                          @ q.double()).float() * (one * s) + b).to(dt),
                "last K slice dropped": fw.w8a8_gemm_plain(dropped, sxq4, qt, s, b, dt),
                "B read MN-major": fw.w8a8_gemm_plain(xq4, sxq4, mn_major, s, b, dt),
            }
            for name, faulty in faults.items():
                nf = int((faulty != flat).sum())
                log(f"  planted fault '{name}': {nf} of {flat.numel()} values differ")
                if nf == 0:
                    raise AssertionError(f"w8a8: equality admits '{name}'")
            del xq, sx, dropped, faults
        del x, got, want
        torch.cuda.empty_cache()
    return out


def train_uncached_257(device, counters):
    """IISAN (Uncached) past the first kernels' limits: at CV_resize=256
    (257 image tokens) 3 steps through ``fused_mha`` (#5) and 3 through the
    ``subblock`` route (#8), and at CV_resize=288 (325 tokens, past the
    subblocks' earlier 320 keys) 3 steps through ``subblock``, each with
    its step breakdown.  Returns the launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    corpus = synthetic_corpus(n_users=3 * 64, item_num=800, max_seq_len=SEQ_LEN, seed=0)
    totals = {c.__name__: 0 for c in counters}
    for size, route, counter in ((256, True, "mha_fwd"),
                                 (256, "subblock", "fused_attn_subblock"),
                                 (288, "subblock", "fused_attn_subblock")):
        name = "fused_mha" if route is True else route
        tokens = (size // 16) ** 2 + 1
        tr = uncached_trainer(device, corpus, CV_resize=size, fused_tower_attention=route)
        _, launches = counted(counters, lambda: tr.run_epoch(1))
        losses = tr._last_step_losses.float().cpu().numpy()
        host, busy, families = uncached_breakdown(tr, staged_batch(tr, 1), 3)
        log(f"uncached IISAN at {tokens} image tokens, {name}: 3 steps, losses "
            + ", ".join(f"{x:.4f}" for x in losses) + f"; launches {launches}")
        log(f"uncached IISAN at {tokens} tokens, {name}, step on a staged batch: host "
            f"{host:.2f} ms (median of 3, synchronised), device-busy {busy:.2f} ms "
            "(profiler): " + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items()))
        if launches[counter] != 24 * 3 or not np.isfinite(losses).all():
            raise AssertionError(f"uncached at {tokens} tokens, {name}: launches "
                                 f"{launches}, losses {losses}")
        for k in totals:
            totals[k] += launches[k]
        del tr
        torch.cuda.empty_cache()
    return totals


def train_cached_long(device, taps, counters):
    """Three cached training steps at max_seq_len=20 (the encoder kernels
    at L=20: the backward's stash in its global scratch); returns the
    launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.synthetic import synthetic_corpus
    from iisan_tpu_torch.ops import fused_user_encoder as fue
    from iisan_tpu_torch.train.cached import CachedTrainer

    L = 20
    corpus = synthetic_corpus(n_users=3 * 64, item_num=ITEMS, max_seq_len=L, seed=SEED)
    tr = CachedTrainer(IISANConfig(**dict(TRAIN_CFG, max_seq_len=L)), corpus, *taps,
                       device=device)
    _, launches = counted(counters, lambda: tr.run_epoch(1))
    losses = tr._last_step_losses.float().cpu().numpy()
    plan = fue.bwd_plan(L, EMB, HEADS, 4 * EMB, BLOCKS)
    log(f"cached, max_seq_len={L}: 3 steps, losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches}; backward placement {plan[0]} (0 shared, 1 slots "
        f"global), {plan[2]} scratch floats a sequence")
    if launches["user_encoder_fwd"] != 3 or launches["user_encoder_bwd"] != 3 \
            or not np.isfinite(losses).all():
        raise AssertionError(f"cached at L={L}: launches {launches}, losses {losses}")
    return launches


def int8_modules(model, fused: bool):
    from iisan_tpu_torch.ops.int8_linear import Int8Dense

    for m in model.modules():
        if isinstance(m, Int8Dense):
            m.fused = fused


def train_int8_uncached(device, counters, busy_by_route):
    """Phase 17: IISAN (Uncached) with ``tower_quant="int8"``: the float
    trainer's tower trees grafted (quantised at graft time) into an int8
    trainer with the same other weights; the item table through #10 and
    through ``int8_matmul`` on the card, and against the float towers';
    one epoch, a valid evaluation.  Returns the launches; records the
    step's device-busy ms in ``busy_by_route`` beside phase 8's."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus
    from iisan_tpu_torch.utils.jax_params import export_jax_params

    corpus = synthetic_corpus(n_users=512, item_num=800, max_seq_len=SEQ_LEN, seed=0)
    ftr = uncached_trainer(device, corpus)
    float_table = ftr.item_embedding_tables()
    trees = {"text_tower/bert": export_jax_params(ftr.model.text_tower.bert),
             "image_tower/vit": export_jax_params(ftr.model.image_tower.vit)}
    rest = {k: v.clone() for k, v in ftr.model.state_dict().items()
            if not k.startswith(("text_tower.bert.", "image_tower.vit."))}
    del ftr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = uncached_trainer(device, corpus, tower_params=trees, tower_quant="int8")
    graft_s = time.perf_counter() - t0
    res = tr.model.load_state_dict(rest, strict=False)
    if res.unexpected_keys:
        raise AssertionError(f"int8 trainer: unexpected {res.unexpected_keys[:4]}")
    del trees, rest
    t0 = time.perf_counter()
    table, table_launches = counted(counters, tr.item_embedding_tables)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    int8_modules(tr.model, False)
    plain_table = tr.item_embedding_tables()
    int8_modules(tr.model, True)
    equal = torch.equal(table, plain_table)
    t, f = table.float()[1:], float_table.float()[1:]
    rel = float((t - f).norm() / f.norm().clamp_min(1e-9))
    cos = float(torch.nn.functional.cosine_similarity(t, f, dim=1).min())
    log(f"uncached int8: float towers grafted and quantised in {graft_s:.2f} s "
        f"(trainer build included); item table {table.shape[0]} rows in "
        f"{table_s:.3f} s, launches {table_launches}; through #10 bit-equal to "
        f"int8_matmul on the card: {equal}; vs the float towers' table from the "
        f"same weights: relative Frobenius {rel:.4f} (tol 0.15), minimum "
        f"cosine {cos:.4f}")
    del plain_table, float_table
    frozen = {n: b.clone() for n, b in tr.model.named_buffers() if b.dtype == torch.int8}
    frozen.update((n, p.detach().clone()) for n, p in tr.model.named_parameters()
                  if n.startswith(("text_tower.bert.", "image_tower.vit.")))
    san_before = tr.model.san.fc_cv.kernel.detach().clone()
    steps = tr.epoch_permutation(1).shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_loss, launches = counted(counters, lambda: tr.run_epoch(1))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    losses = tr._last_step_losses.float().cpu().numpy()
    hit, ndcg = tr.evaluate_split("valid")
    now = dict(tr.model.named_buffers(), **dict(tr.model.named_parameters()))
    unchanged = all(torch.equal(now[n], v) for n, v in frozen.items())
    moved = not torch.equal(tr.model.san.fc_cv.kernel, san_before)
    host, busy, families = uncached_breakdown(tr, staged_batch(tr, 1), 3)
    busy_by_route["int8"] = busy
    log(f"uncached int8: {steps} steps in {epoch_s:.3f} s ({epoch_s / steps * 1e3:.1f} "
        "ms/step with image decoding, host clock); losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f" (mean {mean_loss:.5f}); "
        f"launches {launches}; kernel_q, kscale and tower biases unchanged "
        f"{unchanged} ({len(frozen)} tensors), SAN moved {moved}; valid HR@10 "
        f"{hit:.6f} nDCG@10 {ndcg:.6f}")
    log(f"uncached int8 step on a staged batch: host {host:.2f} ms (median of 3, "
        f"synchronised), device-busy {busy:.2f} ms (profiler): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items())
        + f"; fused_mha's bf16 step in this run (phase 8): device-busy "
        f"{busy_by_route['fused_mha']:.2f} ms")
    want = {"fused_w8a8_matmul": 145 * steps, "w8a8_quant_rows": 145 * steps,
            "w8a8_gemm": 145 * steps, "mha_fwd": 24 * steps,
            "user_encoder_fwd": steps, "user_encoder_bwd": steps}
    want_table = {"fused_w8a8_matmul": 145 * 4, "w8a8_quant_rows": 145 * 4,
                  "w8a8_gemm": 145 * 4, "mha_fwd": 24 * 4}
    if any(launches[k] != v for k, v in want.items()) or any(
            table_launches[k] != v for k, v in want_table.items()):
        raise AssertionError(f"uncached int8: launches {launches} / {table_launches}, "
                             f"expected {want} / {want_table}")
    if not equal:
        raise AssertionError("uncached int8: the kernel's table is not int8_matmul's")
    if not rel < 0.15:
        raise AssertionError(f"uncached int8: table {rel} from the float towers'")
    if not np.isfinite(losses).all() or len(losses) != steps:
        raise AssertionError("uncached int8: the loss is not finite")
    if not (unchanged and moved):
        raise AssertionError("uncached int8: a frozen tower moved or the SAN did not")
    if not (np.isfinite(hit) and 0 <= ndcg <= hit <= 1):
        raise AssertionError(f"uncached int8: bad metrics {hit} {ndcg}")
    return {k: launches[k] + table_launches[k] for k in launches}


def kernel_device_ms(fn, reps: int = 5):
    """Device ms per call of each CUDA kernel ``fn`` launches, by kernel
    name (profiler, ``reps`` calls): its mean time a launch times its
    launches a call, which holds where the trace keeps only some of a
    kernel's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count / 1e3 * max(1, round(e.count / reps))
            for e in prof.key_averages() if e.self_device_time_total > 0}


def subblock_split(fn):
    """Device ms per call of ``fn`` (a subblock op) by step: the qkv GEMM,
    the attention kernel, the output GEMM and every other kernel."""
    split = {"qkv GEMM": 0.0, "attention": 0.0, "output GEMM": 0.0, "other": 0.0}
    for key, ms in kernel_device_ms(fn).items():
        step = ("qkv GEMM" if "subblock_qkv_gemm" in key else
                "output GEMM" if "subblock_out_gemm" in key else
                "attention" if "subblock_attn" in key else "other")
        split[step] += ms
    return split


def check_subblock(device):
    """Phase 18: #8 and #9 against their plain versions in bf16 at the
    BERT step geometry (padded keys with an all-pad row; eval and train
    with the same Philox masks), the ViT one (eval, compared on 64 images,
    timed at 704) and past the earlier 320 keys at 257 and 325 tokens (eval
    and train on 64 images); planted faults; each op's device split (qkv
    GEMM, attention, output GEMM) with the GEMMs' TFLOP/s beside
    ``torch.matmul`` of the same two products (a yardstick only);
    ``F.multi_head_attention_forward`` (in-projection, attention and
    out-projection in one call) timed as the library call.  Returns the
    JSON entries' numbers."""
    import torch
    import torch.nn.functional as F

    from iisan_tpu_torch.ops import fused_attn_subblock as fsb

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    D, H, dt = TOWER_D, TOWER_H, torch.bfloat16

    def weights():
        return ((torch.randn(D, 3 * D, generator=gen, device=device) / D ** 0.5).to(dt),
                torch.randn(3 * D, generator=gen, device=device) * 0.3,
                (torch.randn(D, D, generator=gen, device=device) / D ** 0.5).to(dt),
                torch.randn(D, generator=gen, device=device) * 0.3)

    def require(ratio, what):
        if not ratio <= MHA_TOL["fwd"]:
            raise AssertionError(f"{what}: |diff| / bound {ratio:.4g} > {MHA_TOL['fwd']}")

    def padding(B, T):
        lengths = torch.randint(1, T + 1, (B,), generator=gen, device=device)
        lengths[0] = 0
        return torch.where(torch.arange(T, device=device)[None] < lengths[:, None], 0.0, -1e9)

    out = {}
    for v2, name in ((False, "attn_subblock_fwd"), (True, "attn_subblock_v2_fwd")):
        op = fsb.fused_attn_subblock_v2 if v2 else fsb.fused_attn_subblock
        res = {"err": 0.0}
        wqkv, bqkv, wo, bo = weights()
        in_w, out_w = wqkv.t().contiguous(), wo.t().contiguous()
        in_b, out_b = bqkv.to(dt), bo.to(dt)

        def library(xx, mask):
            xt = xx.transpose(0, 1)
            return F.multi_head_attention_forward(
                xt, xt, xt, D, H, in_w, in_b, None, None, False, 0.0, out_w, out_b,
                training=False, key_padding_mask=mask, need_weights=False)[0]

        def split_line(what, xx, bias_):
            M = xx.shape[0] * xx.shape[1]
            split = subblock_split(lambda: op(xx, wqkv, bqkv, wo, bo, H, key_bias=bias_))
            x2 = xx.reshape(M, D)
            mm_qkv = cuda_timed(lambda: torch.matmul(x2, wqkv), 10)
            mm_out = cuda_timed(lambda: torch.matmul(x2, wo), 10)
            f_qkv, f_out = 2 * M * D * 3 * D, 2 * M * D * D
            log(f"  {name} {what} device split (profiler, 5 calls): "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
                + f"; qkv GEMM {f_qkv / max(split['qkv GEMM'], 1e-9) / 1e9:.1f} TFLOP/s, "
                f"output GEMM {f_out / max(split['output GEMM'], 1e-9) / 1e9:.1f} TFLOP/s; "
                "torch.matmul of the "
                f"same products (yardstick only) {mm_qkv:.4f} / {mm_out:.4f} ms "
                f"({f_qkv / mm_qkv / 1e9:.1f} / {f_out / mm_out / 1e9:.1f} TFLOP/s)")

        # BERT titles: 30 tokens, padded keys, the pad item's all-pad row
        B, T = STEP_ROWS, TITLE_T
        x = torch.randn(B, T, D, generator=gen, device=device).to(dt)
        bias = padding(B, T)
        seed, rate = 20251017, DROP
        for mode, kw in (("eval", {}), ("train", dict(drop_rate=rate, seed=seed, layer=5))):
            got = op(x, wqkv, bqkv, wo, bo, H, key_bias=bias, **kw)
            want = fsb.subblock_fwd_plain(
                x, wqkv, bqkv, wo, bo, bias, n_heads=H, seed=seed,
                rate=rate if kw else 0.0, layer=5, v2=v2)
            torch.cuda.synchronize()
            ratio = mha_ratio([got], [want])
            res["err"] = max(res["err"], float((got.float() - want.float()).abs().max()))
            log(f"{name} BERT {mode} B={B} T={T} D={D} H={H} bf16, padded keys: "
                f"max |diff| / (max|plain| + |plain|) {ratio:.4g} (tol "
                f"{MHA_TOL['fwd']}); all-pad row finite {torch_finite(got[0])}")
            require(ratio, f"{name} BERT {mode}")
            if not torch_finite(got[0]):
                raise AssertionError(f"{name}: the all-pad row is not finite")
            if mode == "train":
                skipped = wo.clone()
                skipped[64:128] = 0  # head 1's rows of Wo
                faults = {"key bias dropped": op(x, wqkv, bqkv, wo, bo, H, **kw),
                          "one head's Wo rows skipped": op(
                              x, wqkv, bqkv, skipped, bo, H, key_bias=bias, **kw),
                          "masks of another seed": op(
                              x, wqkv, bqkv, wo, bo, H, key_bias=bias,
                              **dict(kw, seed=seed + 1))}
                for fault, fgot in faults.items():
                    fr = mha_ratio([fgot], [want])
                    log(f"  planted fault '{fault}': {fr:.4g} (must be > {MHA_TOL['fwd']})")
                    if fr <= MHA_TOL["fwd"]:
                        raise AssertionError(f"{name}: the bound admits '{fault}'")
        pad = bias < 0
        bert_ms = cuda_timed(lambda: op(x, wqkv, bqkv, wo, bo, H, key_bias=bias), 10)
        bert_plain = cuda_timed(lambda: fsb.subblock_fwd_plain(
            x, wqkv, bqkv, wo, bo, bias, n_heads=H, v2=v2), 3)
        bert_lib = cuda_timed(lambda: library(x, pad), 10)
        bert_bnd = subblock_bound(B, T, True)
        log(f"{name} BERT eval B={B}: kernel {bert_ms:.4f} ms, plain {bert_plain:.4f} ms, "
            f"F.multi_head_attention_forward {bert_lib:.4f} ms; bound "
            f"{bert_bnd[0]:.4f} ms ({bert_bnd[1]})")
        split_line("BERT", x, bias)
        # ViT images: 197 tokens, eval mode, no bias
        T = IMAGE_T
        x = torch.randn(B, T, D, generator=gen, device=device).to(dt)
        got = op(x, wqkv, bqkv, wo, bo, H)[:64]
        want = fsb.subblock_fwd_plain(x[:64], wqkv, bqkv, wo, bo, None, n_heads=H, v2=v2)
        torch.cuda.synchronize()
        ratio = mha_ratio([got], [want])
        res["err"] = max(res["err"], float((got.float() - want.float()).abs().max()))
        log(f"{name} ViT eval B={B} T={T} (first 64 rows vs plain): {ratio:.4g} "
            f"(tol {MHA_TOL['fwd']})")
        require(ratio, f"{name} ViT")
        res["ms"] = cuda_timed(lambda: op(x, wqkv, bqkv, wo, bo, H), 5)
        res["plain_ms"] = cuda_timed(lambda: fsb.subblock_fwd_plain(
            x, wqkv, bqkv, wo, bo, None, n_heads=H, v2=v2), 3)
        res["library_ms"] = cuda_timed(lambda: library(x, None), 5)
        res["bound"] = subblock_bound(B, T, False)
        log(f"{name} ViT eval B={B}: kernel {res['ms']:.4f} ms "
            f"({2 * B * T * D * 4 * D / res['ms'] / 1e9:.1f} TFLOP/s of projections), "
            f"plain {res['plain_ms']:.4f} ms, F.multi_head_attention_forward "
            f"{res['library_ms']:.4f} ms; bound {res['bound'][0]:.4f} ms "
            f"({res['bound'][1]})")
        split_line("ViT", x, None)
        del x, got, want
        # Past the earlier 320 keys: 257 (CV_resize=256) and 325 (288)
        # tokens, padded keys, eval and train on 64 images, timed at 704.
        for T in (IMAGE_T_256, IMAGE_T_288):
            x = torch.randn(64, T, D, generator=gen, device=device).to(dt)
            bias = padding(64, T)
            for mode, kw in (("eval", {}), ("train", dict(drop_rate=rate, seed=seed, layer=3))):
                got = op(x, wqkv, bqkv, wo, bo, H, key_bias=bias, **kw)
                want = fsb.subblock_fwd_plain(
                    x, wqkv, bqkv, wo, bo, bias, n_heads=H, seed=seed,
                    rate=rate if kw else 0.0, layer=3, v2=v2)
                torch.cuda.synchronize()
                ratio = mha_ratio([got], [want])
                res["err"] = max(res["err"], float((got.float() - want.float()).abs().max()))
                log(f"{name} {T} tokens {mode} B=64, padded keys: {ratio:.4g} (tol "
                    f"{MHA_TOL['fwd']})")
                require(ratio, f"{name} {T} tokens {mode}")
            x = torch.randn(B, T, D, generator=gen, device=device).to(dt)
            ms = cuda_timed(lambda: op(x, wqkv, bqkv, wo, bo, H), 5)
            lib_ms = cuda_timed(lambda: library(x, None), 5)
            bnd = subblock_bound(B, T, False)
            log(f"{name} {T} tokens eval B={B}: kernel {ms:.4f} ms, "
                f"F.multi_head_attention_forward {lib_ms:.4f} ms; bound {bnd[0]:.4f} ms "
                f"({bnd[1]})")
            split_line(f"{T} tokens", x, None)
            del x, got, want
        out[v2] = res
        torch.cuda.empty_cache()
    return out


def train_subblock_routes(device, counters, busy_by_route):
    """Phase 19: IISAN (Uncached) with ``fused_tower_attention="subblock"``
    and ``"subblock_v2"`` at full width, 3 steps and the item table each;
    then 3 steps of each subblock route and of ``fused_mha`` from one set of
    weights at dropout 0.  Returns the launches; records each route's
    step device-busy ms in ``busy_by_route``."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    corpus = synthetic_corpus(n_users=3 * 64, item_num=800, max_seq_len=SEQ_LEN, seed=0)
    totals = {c.__name__: 0 for c in counters}
    kernel = {"subblock": "fused_attn_subblock", "subblock_v2": "fused_attn_subblock_v2"}
    for route, counter in kernel.items():
        tr = uncached_trainer(device, corpus, fused_tower_attention=route)
        mean_loss, launches = counted(counters, lambda: tr.run_epoch(1))
        losses = tr._last_step_losses.float().cpu().numpy()
        table, table_launches = counted(counters, tr.item_embedding_tables)
        host, busy, families = uncached_breakdown(tr, staged_batch(tr, 1), 3)
        busy_by_route[route] = busy
        log(f"uncached {route}: 3 steps, losses " + ", ".join(f"{x:.4f}" for x in losses)
            + f"; launches {launches}; item table {tuple(table.shape)}, launches "
            f"{table_launches}")
        log(f"uncached {route} step on a staged batch: host {host:.2f} ms (median of 3, "
            f"synchronised), device-busy {busy:.2f} ms (profiler): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items()))
        other = kernel["subblock_v2" if route == "subblock" else "subblock"]
        want = {counter: 24 * 3, other: 0, "mha_fwd": 0, "fused_w8a8_matmul": 0,
                "w8a8_gemm": 0}
        if any(launches[k] != v for k, v in want.items()) or \
                table_launches[counter] != 24 * 4:
            raise AssertionError(f"uncached {route}: launches {launches} / "
                                 f"{table_launches}, expected {want}")
        if not np.isfinite(losses).all() or not torch_finite(table):
            raise AssertionError(f"uncached {route}: loss {losses}")
        for k in totals:
            totals[k] += launches[k] + table_launches[k]
        del tr, table
        torch.cuda.empty_cache()
    losses, state = {}, None
    for route in ("subblock", "subblock_v2", True):
        tr = uncached_trainer(device, corpus, tower_dropout=0.0, drop_rate=0.0,
                              fused_tower_attention=route)
        if state is None:
            state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(state)
        tr.run_epoch(1)
        losses[route] = tr._last_step_losses.float().cpu().tolist()
        del tr
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for r in ("subblock", "subblock_v2")
              for a, b in zip(losses[r], losses[True]))
    log("IISAN, 3 steps from one set of weights at dropout 0: "
        + "; ".join(f"{'fused_mha' if r is True else r} "
                    + ", ".join(f"{v:.5f}" for v in ls) for r, ls in losses.items())
        + f"; max relative difference to fused_mha {rel:.3g} (tol 2e-2)")
    if rel > 2e-2:
        raise AssertionError("the subblock routes' losses leave fused_mha's")
    return totals


def check_streamed_cascade(device):
    """The streamed cascade kernel (#4) against its plain version in bf16 at
    the Versa text geometry (K=7, D=8192): N=8192 (a table chunk) and 704
    (a training step), R=64 and 128, ReLU and GELU, gated and additive,
    element by element under ``carry_tolerance``.  Four planted faults
    must break the bound.  Returns the JSON numbers and the step-shape
    times."""
    import torch

    from iisan_tpu_torch.ops import fused_san as fs

    gen = torch.Generator(device=device).manual_seed(SEED)
    K, D = K_TAPS, VERSA_TEXT_DIM

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    def ratio(got, want):
        if not torch_finite(got):
            return float("inf")
        return float(((got.float() - want.float()).abs()
                      / fs.carry_tolerance(want)).max())

    out = {"err": 0.0}
    for N, R in ((TABLE_CHUNK, 64), (STEP_ROWS, 64), (STEP_ROWS, 128),
                 (TABLE_CHUNK, 128)):
        for gated in (True, False):
            # every term moves the carry by O(1), as in check_cascade
            a, b = fs.cascade_coefs(
                torch.randn(K, generator=gen, device=device) * 0.1, gated)
            args = (a, b, rand(N, K, D), rand(K, D, R, scale=D ** -0.5),
                    rand(K, R, scale=0.5), rand(K, R, D, scale=R ** -0.5),
                    rand(K, D, scale=0.5), rand(N, D))
            for act in ("RELU", "GELU"):
                got = fs.san_cascade_streamed_fwd(*args, activation=act)
                want = fs.san_cascade_streamed_fwd_plain(*args, activation=act)
                torch.cuda.synchronize()
                r = ratio(got, want)
                err = float((got.float() - want.float()).abs().max())
                out["err"] = max(out["err"], err)
                log(f"san_cascade_streamed_fwd N={N} K={K} D={D} R={R} "
                    f"{'gated' if gated else 'additive'} {act}: max|kernel-plain| "
                    f"{err:.6g}; max |diff| / bound {r:.3f} (must be <= 1); "
                    f"{float((got != want).float().mean()):.2%} of values not "
                    "bit-equal")
                if r > 1.0:
                    raise AssertionError("san_cascade_streamed_fwd disagrees with "
                                         "its plain version")
            if R != 64 or not gated:
                continue
            if N == TABLE_CHUNK:
                want = fs.san_cascade_streamed_fwd_plain(*args)
                a, b, taps, wd, bd, wu, bu, c0 = args
                step0 = [w[:1].expand_as(w) for w in (wd, bd, wu, bu)]
                faults = {
                    "bd dropped": ((a, b, taps, wd, torch.zeros_like(bd), wu, bu,
                                    c0), "RELU"),
                    "GELU for ReLU": (args, "GELU"),
                    "step-0 weights": ((a, b, taps, *step0, c0), "RELU"),
                    "g and 1-g swapped": ((b, a, taps, wd, bd, wu, bu, c0), "RELU"),
                }
                for fault, (fargs, act) in faults.items():
                    r = ratio(fs.san_cascade_streamed_fwd(*fargs, activation=act),
                              want)
                    log(f"  planted fault '{fault}': max |diff| / bound {r:.4g} "
                        "(must be > 1)")
                    if r <= 1.0:
                        raise AssertionError(f"the streamed bound admits '{fault}'")
            key = "" if N == TABLE_CHUNK else "_step"
            out["ms" + key] = cuda_timed(
                lambda: fs.san_cascade_streamed_fwd(*args), 10)
            out["plain_ms" + key] = cuda_timed(
                lambda: fs.san_cascade_streamed_fwd_plain(*args), 5)
            out["bound" + key] = cascade_bound(1, N, D, R)
            gflop = N * K * 4 * D * R / 1e9
            log(f"san_cascade_streamed_fwd N={N} K={K} D={D} R={R} ReLU: kernel "
                f"{out['ms' + key]:.4f} ms ({gflop / out['ms' + key]:.1f} "
                f"TFLOP/s), plain {out['plain_ms' + key]:.4f} ms (medians, CUDA "
                f"events); bound {out['bound' + key][0]:.4f} ms "
                f"({out['bound' + key][1]})")
            del want
        del args, got
        torch.cuda.empty_cache()
    # The "eva" variant's EVA-CLIP width (scripts/run_IISAN_versa.py:41-48:
    # K=6, D=5120) and bottlenecks that do not divide 256 or pass it, at a
    # width that streams, at the step's rows; each repeats bit for bit.
    for K, D, R in STREAMED_EXTRA:
        a, b = fs.cascade_coefs(torch.randn(K, generator=gen, device=device) * 0.1, True)
        args = (a, b, rand(STEP_ROWS, K, D), rand(K, D, R, scale=D ** -0.5),
                rand(K, R, scale=0.5), rand(K, R, D, scale=R ** -0.5),
                rand(K, D, scale=0.5), rand(STEP_ROWS, D))
        assert fs.cascade_route(K, D, R, torch.bfloat16) == "streamed"
        for act in ("RELU", "GELU"):
            got = fs.san_cascade_streamed_fwd(*args, activation=act)
            want = fs.san_cascade_streamed_fwd_plain(*args, activation=act)
            torch.cuda.synchronize()
            r = ratio(got, want)
            out["err"] = max(out["err"], float((got.float() - want.float()).abs().max()))
            same = torch.equal(got, fs.san_cascade_streamed_fwd(*args, activation=act))
            log(f"san_cascade_streamed_fwd N={STEP_ROWS} K={K} D={D} R={R} {act}: "
                f"max |diff| / bound {r:.3f} (must be <= 1); repeat bit-equal {same}")
            if r > 1.0 or not same:
                raise AssertionError(f"san_cascade_streamed_fwd at {(K, D, R)}")
    return out


def check_dispatch(device):
    """``fused_cascade`` on the card follows the JAX package's dispatch:
    #4 and not #3 at (7, 8192, 64) bf16, #3 and not #4 at (7, 192, 64), no
    kernel at (7, 8192, 64) fp32 (``reference_cascade``); and at the
    geometries the kernels once refused the kernel the route names,
    within ``carry_tolerance`` of that kernel's plain version."""
    import torch

    from iisan_tpu_torch.ops import fused_san as fs

    counters = (fs.san_cascade_fwd, fs.san_cascade_streamed_fwd)
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = [((7, 8192, 64), torch.bfloat16, (0, 1)),
             ((7, 192, 64), torch.bfloat16, (1, 0)),
             ((7, 8192, 64), torch.float32, (0, 0))]
    cases += [((K, D, R), getattr(torch, dt), (1, 0)) for K, D, R, dt in ONCE_REFUSED]
    cases += [((7, 2048, 320), torch.bfloat16, (0, 1))]
    for (K, D, R), dtype, want in cases:
        args = [torch.randn(s, generator=gen, device=device).to(dtype) * sc
                for s, sc in (((64, K, D), 1.0), ((K, D, R), D ** -0.5),
                              ((K, R), 0.5), ((K, R, D), R ** -0.5),
                              ((K, D), 0.5), ((64, D), 1.0))]
        gates = torch.randn(K, generator=gen, device=device) * 0.1
        out, launches = counted(counters, lambda: fs.fused_cascade(gates, *args))
        torch.cuda.synchronize()
        got = tuple(launches[c.__name__] for c in counters)
        route = fs.cascade_route(K, D, R, dtype)
        a, b = fs.cascade_coefs(gates, True)
        if route == "resident":
            plain = fs.san_cascade_fwd_plain(a[None], b[None], *(t[None] for t in args))[0]
        elif route == "streamed":
            plain = fs.san_cascade_streamed_fwd_plain(a, b, *args)
        else:
            plain = fs.reference_cascade(gates, *args)
        r = carry_ratios(out[None], plain[None])[0]
        log(f"dispatch (K={K}, D={D}, R={R}) {str(dtype).split('.')[-1]}: route "
            f"{route}, launches san_cascade_fwd {got[0]}, san_cascade_streamed_fwd "
            f"{got[1]}; max |diff| / bound against the route's plain version {r:.3f}")
        if got != want or out.dtype != dtype or r > 1.0:
            raise AssertionError(f"fused_cascade at {(K, D, R, dtype)}: launches "
                                 f"{got}, expected {want}; ratio {r}")


def versa_taps(device):
    """Random bf16 tap tables at the Versa geometry on the card: image
    (items + pad, 7, 192) and text (items + pad, 7, 8192), pad row 0."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    taps = []
    for dim in (VERSA_IMAGE_DIM, VERSA_TEXT_DIM):
        t = torch.randn((ITEMS + 1, K_TAPS, dim), generator=gen, device=device,
                        dtype=torch.bfloat16)
        t[0] = 0
        taps.append(t)
    return tuple(taps)


def train_versa_int8(device, corpus, taps, counters):
    """Versa with ``cache_quant="int8"`` over the same taps on the kernel
    route: resident bytes of each table in both forms, 20 steps with a
    finite loss, the item table against the bf16 tables' from the same
    weights, a valid evaluation.  Returns the launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.eval.evaluate import compute_item_tables
    from iisan_tpu_torch.train.cached import CachedTrainer

    cfg = IISANConfig(**dict(VERSA_CFG, use_pallas=True, cache_quant="int8"))
    t0 = time.perf_counter()
    tr = CachedTrainer(cfg, corpus, *taps, device=device)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    sizes = ", ".join(
        f"{name} bf16 {t.numel() * 2 / 1e9:.4f} GB -> int8 {q.nbytes / 1e9:.4f} GB"
        for name, t, q in (("image", taps[0], tr.cv_table),
                           ("text", taps[1], tr.text_table)))
    perm = torch.as_tensor(tr.epoch_permutation(1), device=device).long()

    def steps():
        return [float(tr.train_step(tr.train_seqs[perm[i]],
                                    tr.train_log_mask[perm[i]]))
                for i in range(20)]

    losses, launches = counted(counters, steps)
    table = tr.fused_item_table()
    table_launches = {c.__name__: c.launches - launches[c.__name__]
                      for c in counters}
    plain = compute_item_tables(tr.model, *taps)
    diff = float((table.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    hit, ndcg = tr.evaluate_split("valid")
    log(f"versa int8 tap tables: {sizes} (quantised on the card, trainer built "
        f"in {quant_s:.2f} s); 20 steps, losses {losses[0]:.5f} ... "
        f"{losses[-1]:.5f}; launches {launches}; item table vs the bf16 "
        f"tables from the same weights: max |diff| {diff:.6g} (max |value| "
        f"{scale:.4g}, tol 0.05 x max); valid HR@10 {hit:.6f} nDCG@10 {ndcg:.6f}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"versa int8: loss {losses}")
    if not torch_finite(table) or diff > 0.05 * scale:
        raise AssertionError("versa int8: the item table leaves the bf16 one")
    if not (np.isfinite(hit) and 0 <= ndcg <= hit <= 1):
        raise AssertionError(f"versa int8: bad metrics {hit} {ndcg}")
    want = {"user_encoder_fwd": 20, "user_encoder_bwd": 20,
            "san_cascade_fwd": 20, "san_cascade_streamed_fwd": 20}
    if launches != want:
        raise AssertionError(f"versa int8: launches {launches}, expected {want}")
    return {k: launches[k] + table_launches[k] for k in launches}


def run_versa(device, corpus, requests, counters):
    """IISAN-Versa (``pipeline="cached_asym"``) at the published Llama-3-70B
    x ViT-tiny geometry: one epoch on each SAN route, five kernel and five
    module steps from one set of weights, int8 tap tables, and serving the
    kernel route's trained model.  Returns the launches of the path."""
    import tempfile

    import torch

    from iisan_tpu_torch.serve import Recommender

    taps = versa_taps(device)
    totals = {c.__name__: 0 for c in counters}

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    for use_pallas in (False, True):
        route = "use_pallas" if use_pallas else "default"
        per_step = {"user_encoder_fwd": 1, "user_encoder_bwd": 1,
                    "san_cascade_fwd": int(use_pallas),
                    "san_cascade_streamed_fwd": int(use_pallas)}
        tr, launches = train_route(device, corpus, taps,
                                   dict(VERSA_CFG, use_pallas=use_pallas),
                                   counters, per_step, f"versa {route}")
        add(launches)
        log(f"train[versa {route}] learned gates: " + "; ".join(
            f"{k} {[round(float(x), 4) for x in v]}"
            for k, v in tr.gate_values().items()))
        if use_pallas:
            rec, launches = counted(counters, lambda: Recommender.from_trainer(tr))
            add(launches)
            with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
                latency, busy, shared = check_serving(device, rec, requests, tmp,
                                                      "versa")
            log("serve[versa]: Recommender.from_trainer (table launches "
                f"{launches}); top_k median latency of 20 (device-busy) "
                + ", ".join(f"batch {b} {ms:.3f} ms ({busy[b]:.3f} ms)"
                            for b, ms in latency.items())
                + "; HTTP ids identical to direct; save->load ids identical to "
                f"an fp32 Recommender (which shares {shared:.1%} or more of its "
                "ids with the bf16 one)")
            del rec
        del tr
        torch.cuda.empty_cache()
    log_step_split("Versa", ("versa default", "versa use_pallas"))
    check_gradients_reach_parameters(device, corpus, taps, VERSA_CFG, "versa")
    torch.cuda.empty_cache()
    add(train_versa_int8(device, corpus, taps, counters))
    return totals


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def check_serving(device, rec, requests, tmp, name):
    """top_k at each request batch (host-clock and device-busy medians);
    the HTTP server must give the direct call's ids, and a save -> load
    round trip those of an fp32 Recommender over the same table and
    user-encoder weights (the artifact is fp32 and loads as fp32, as in the
    JAX package).  Returns (latency ms, device-busy ms, the smallest share
    of ids the fp32 Recommender shares with ``rec``), each by batch."""
    import numpy as np
    import torch

    from iisan_tpu_torch.models.model import IISANRecModel
    from iisan_tpu_torch.serve import Recommender, serve_http
    from iisan_tpu_torch.utils.jax_params import (export_jax_params,
                                                  load_jax_params)

    latency, busy, direct = {}, {}, {}
    for b, seqs in requests.items():
        direct[b] = rec.top_k(seqs, k=10)
        latency[b] = host_timed(lambda s=seqs: rec.top_k(s, k=10), 20)
        busy[b] = device_ms(lambda s=seqs: rec.top_k(s, k=10), 10)
        if not np.isfinite(direct[b][1]).all() or (direct[b][0] < 1).any():
            raise AssertionError(f"{name}: bad top-K at batch {b}")

    server = serve_http(rec, "127.0.0.1", 0, max_batch=256)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/recommend"
        for b, seqs in requests.items():
            got = post(url, {"sequences": seqs, "k": 10})["items"]
            if got != direct[b][0].tolist():
                raise AssertionError(f"{name}: HTTP top-K differs at batch {b}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)

    path = str(Path(tmp) / f"rec_{name}.npz")
    rec.save(path)
    loaded = Recommender.load(path, device=device)
    ref_model = IISANRecModel(None, EMB, SEQ_LEN, HEADS, BLOCKS, 0.0,
                              dtype=torch.float32, device=device)
    load_jax_params(ref_model.user_encoder,
                    export_jax_params(rec.model.user_encoder))
    ref = Recommender(ref_model.eval(), rec.fused_table.float(), SEQ_LEN)
    same_as_bf16 = []
    for b, seqs in requests.items():
        ids = loaded.top_k(seqs, k=10)[0]
        if not np.array_equal(ids, ref.top_k(seqs, k=10)[0]):
            raise AssertionError(f"{name}: save -> load top-K differs at batch {b}")
        same_as_bf16.append(float((ids == direct[b][0]).mean()))
    return latency, busy, min(same_as_bf16)


def run_slice(device, use_pallas, cv_taps, text_taps, split, requests, tmp):
    import numpy as np
    import torch

    from iisan_tpu_torch.eval.evaluate import compute_item_tables, evaluate
    from iisan_tpu_torch.models.model import IISANRecModel
    from iisan_tpu_torch.models.san import SideAdapterNetwork
    from iisan_tpu_torch.serve import Recommender

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

    latency, busy, same_as_bf16 = check_serving(
        device, Recommender(model, table, SEQ_LEN), requests, tmp, name)

    log(f"slice[{name}]: item table {ITEMS + 1} rows in {table_ms:.3f} ms "
        f"(device-busy {table_busy:.3f} ms); valid HR@10 {hit:.6f} nDCG@10 "
        f"{ndcg:.6f} over {USERS} users in {eval_ms:.3f} ms (medians of 3 "
        f"after a warm-up); top_k median latency of 20 (device-busy) "
        + ", ".join(f"batch {b} {ms:.3f} ms ({busy[b]:.3f} ms)"
                    for b, ms in latency.items())
        + "; HTTP ids identical to direct; save->load ids identical to an "
        f"fp32 Recommender (which shares {same_as_bf16:.1%} or more of "
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
    mma = sass_mma_counts(lib_path, "user_encoder")
    for name, n in sorted(mma.items()):
        log(f"  SASS: {n} HMMA/HGMMA in {name}")
    for kernel in ("user_encoder_fwd_tc_kernel", "user_encoder_bwd_tc_kernel",
                   "user_encoder_wgrad_kernel"):
        if not any(kernel in name and n > 0 for name, n in mma.items()):
            raise AssertionError(f"{kernel}: no tensor-core instruction in its SASS")

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
    counters = (fue.user_encoder_fwd, fue.user_encoder_bwd, fs.san_cascade_fwd,
                fs.san_cascade_streamed_fwd)
    trained = {}
    for use_pallas in (False, True):
        per_step = {"user_encoder_fwd": 1, "user_encoder_bwd": 1,
                    "san_cascade_fwd": 2 if use_pallas else 0,
                    "san_cascade_streamed_fwd": 0}
        tr, trained[use_pallas] = train_route(
            device, corpus, taps, dict(TRAIN_CFG, use_pallas=use_pallas),
            counters, per_step, "use_pallas" if use_pallas else "default")
        del tr
        torch.cuda.empty_cache()
    log_step_split("cached", ("default", "use_pallas"))
    check_gradients_reach_parameters(device, corpus, taps, TRAIN_CFG, "cached")
    long_counts = train_cached_long(device, taps, counters)
    train_counts = {k: trained[False][k] + trained[True][k] + long_counts[k]
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
    busy_by_route = {}  # the uncached step's device-busy ms on each tower route
    iisan_counts = train_iisan_uncached(device, ucounters, busy_by_route)
    torch.cuda.empty_cache()
    fft_counts = train_fft(device, ucounters)
    torch.cuda.empty_cache()
    check_uncached_routes(device)
    uncached = {k: iisan_counts[k] + fft_counts[k] for k in iisan_counts}

    # IISAN-Versa: the streamed cascade kernel and the dispatch on the card,
    # then training, int8 tap tables and serving at the published geometry.
    streamed = check_streamed_cascade(device)
    check_dispatch(device)
    torch.cuda.empty_cache()
    versa = run_versa(device, corpus, requests, counters)
    torch.cuda.empty_cache()

    # The frozen-tower options of IISAN (Uncached): the W8A8 kernel and the
    # int8 towers, then the attention-subblock kernels and their routes.
    from iisan_tpu_torch.ops import fused_attn_subblock as fsb
    from iisan_tpu_torch.ops import fused_w8a8 as fw

    w8a8 = check_w8a8(device)
    tcounters = (fw.fused_w8a8_matmul, fw.w8a8_quant_rows, fw.w8a8_gemm,
                 fsb.fused_attn_subblock,
                 fsb.fused_attn_subblock_v2, fa.mha_fwd, fa.mha_bwd,
                 fue.user_encoder_fwd, fue.user_encoder_bwd)
    int8 = train_int8_uncached(device, tcounters, busy_by_route)
    torch.cuda.empty_cache()
    subblock = check_subblock(device)
    torch.cuda.empty_cache()
    routes = train_subblock_routes(device, tcounters, busy_by_route)
    long_tokens = train_uncached_257(device, tcounters)
    towers = {k: int8[k] + routes[k] + long_tokens[k] for k in int8}
    ue_bound, ue_bwd_bound = encoder_bounds(256, 64)
    log("uncached IISAN step device-busy by tower route, this run (staged batch, "
        "profiler): " + ", ".join(f"{k} {v:.2f} ms" for k, v in busy_by_route.items()))

    def entry(name, replaces, launches, err, ms, plain_ms, bnd, library_ms, source=None,
              device=None):
        row = {"name": name, "route": "cuda",
               "source": f"iisan_tpu_torch/csrc/{source or name}.cu",
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}
        if device is not None:
            row["device_ms"] = device
        return row

    kernels = [
        entry("user_encoder_fwd", "iisan_tpu/ops/fused_user_encoder.py:264",
              counts[0] + train_counts["user_encoder_fwd"]
              + uncached["user_encoder_fwd"] + versa["user_encoder_fwd"]
              + towers["user_encoder_fwd"],
              max([r[0] for r in ue.values()] + [train["fwd_err"]]),
              ue[256][1], ue[256][2], ue_bound, None, device=ue[256][3]),
        entry("user_encoder_bwd", "iisan_tpu/ops/fused_user_encoder.py:327",
              train_counts["user_encoder_bwd"] + uncached["user_encoder_bwd"]
              + versa["user_encoder_bwd"] + towers["user_encoder_bwd"],
              train["bwd_err"], train["bwd_ms"], train["bwd_plain_ms"],
              ue_bwd_bound, None, "user_encoder_bwd_tc", device=train["bwd_device_ms"]),
        entry("san_cascade_fwd", "iisan_tpu/ops/fused_san.py:49",
              counts[1] + train_counts["san_cascade_fwd"]
              + versa["san_cascade_fwd"], cascade["err"], cascade["ms"],
              cascade["plain_ms"], cascade_bound(*CASCADE_TABLE), None),
        entry("san_cascade_streamed_fwd", "iisan_tpu/ops/fused_san.py:94",
              versa["san_cascade_streamed_fwd"], streamed["err"],
              streamed["ms"], streamed["plain_ms"], streamed["bound"], None),
        entry("mha_fwd", "iisan_tpu/ops/fused_attention.py:73",
              uncached["mha_fwd"] + towers["mha_fwd"], attn["fwd_err"], attn["fwd_ms"],
              attn["fwd_plain_ms"], attn["fwd_bound"], attn["fwd_sdpa_ms"]),
        entry("mha_bwd", "iisan_tpu/ops/fused_attention.py:106",
              uncached["mha_bwd"], attn["bwd_err"], attn["bwd_ms"],
              attn["bwd_plain_ms"], attn["bwd_bound"], attn["bwd_sdpa_ms"]),
        entry("mha_mask_replay", "iisan_tpu/ops/fused_attention.py:165",
              uncached["mha_mask_replay"], 0.0, attn["replay_ms"],
              attn["replay_plain_ms"], attn["replay_bound"], None),
        entry("attn_subblock_fwd", "iisan_tpu/ops/fused_attn_subblock.py:107",
              towers["fused_attn_subblock"], subblock[False]["err"],
              subblock[False]["ms"], subblock[False]["plain_ms"],
              subblock[False]["bound"], subblock[False]["library_ms"]),
        entry("attn_subblock_v2_fwd", "iisan_tpu/ops/fused_attn_subblock.py:293",
              towers["fused_attn_subblock_v2"], subblock[True]["err"],
              subblock[True]["ms"], subblock[True]["plain_ms"],
              subblock[True]["bound"], subblock[True]["library_ms"]),
        entry("w8a8_quant_rows", "iisan_tpu/ops/int8_pallas.py:96",
              towers["w8a8_quant_rows"], w8a8["quant"]["err"], w8a8["quant"]["ms"],
              w8a8["quant"]["plain_ms"], w8a8["quant"]["bound"], None, "w8a8_linear"),
        entry("w8a8_gemm", "iisan_tpu/ops/int8_pallas.py:96",
              towers["w8a8_gemm"], w8a8["err"], w8a8["gemm"]["ms"],
              w8a8["gemm"]["plain_ms"], w8a8["gemm"]["bound"], None, "w8a8_linear"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
