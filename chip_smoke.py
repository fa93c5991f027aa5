#!/usr/bin/env python3
"""Drive the PyTorch port's cached serving and training paths, its
uncached training paths (IISAN and full fine-tuning, IISAN's W8A8 and
attention-subblock tower options, and the LoRA, Houlsby and BitFit
baselines with multi-attribute text, tower remat and the transformers
weight import), IISAN-Versa (``pipeline="cached_asym"``) and the
hidden-state cache builders with the Versa towers (Llama, EVA, CLIP), the
run path from the command line (training, resume, test mode, warm
starts), and uncached training and cache builds from the real-data image
stores (LMDB, JPEG) with ``device_bench``, int8 and sharded serving and
training on ``torch.distributed`` ranks, and the paper's efficiency table
(TPME over six methods) and the canonical sweep launchers, once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. Print the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``iisan_tpu_torch/csrc`` and print the
   build time, ptxas's per-kernel report and the count of tensor-core
   instructions (HMMA, HGMMA, from ``cuobjdump -sass``) in each
   user-encoder kernel; the bf16 route's three must have some; every
   instance of the bf16 attention forward (#5's and the subblocks'
   resident and streamed kernels) must have HGMMA and no HMMA.
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
   and in fp32 (three TF32 passes; fp32 inputs use all 24 bits)
   (``check_attention``): the forward at the BERT step geometry (704
   titles x 30 tokens, D=768, 12 heads, padded key bias with an all-pad
   row) in eval mode and in train mode (dropout 0.1, the same Philox masks
   on both sides), both dtypes, at the ViT step geometry (704 images x 197
   tokens, compared on a 64-image slice, timed at 704) in eval mode, and
   at 257 tokens (a 256-pixel ViT) in eval and train mode, and both in
   fp32; at every edge of the forward's tiling (``ATTN_FWD_EDGES``, 1 to
   4,097 tokens, two images) in both dtypes, eval and train mode, with and
   without the key bias, each image's eval output bit-equal to a launch of
   its own, and a train-mode forward with #6's gradient of it at 197 and
   257 tokens; the
   backward at the FFT step's shapes (88 rows, ``MHA_BWD_CASES``), BERT,
   257 and 325 tokens and 448 and 512 keys in train mode and ViT in eval mode
   (bf16: the cluster design, one to eight blocks of 64 keys), 577 tokens
   in train mode (``CV_resize=384``, past 512 keys: the split design, a
   query-tile and a key-tile kernel) and at ViT-tiny's width (192, 3
   heads) in eval mode, ViT in eval mode and BERT in train mode in fp32
   (the three-pass TF32 pair), and ViT at the TPME report's batch of 32
   users (352 rows) in both dtypes, each case's design and device time
   beside SDPA's backward and the bound printed (fp32: both ways, three
   TF32 passes on the tensor cores and the function on the CUDA cores),
   and two launches bit-equal in
   every case, with the clusters the card holds of each cluster instance
   (``cudaOccupancyMaxActiveClusters``); the mask
   replay kernel bit for bit at the BERT step (704 x 30) and the FFT
   step's ViT attention (88 x 197), timed by CUDA events and profiler.
   Planted faults (the key bias dropped on the padded batch, the backward
   run with another seed, the softmax row term dropped from the backward)
   must break the bounds; all-pad rows must stay finite.  The library
   call ``scaled_dot_product_attention`` is timed beside every case: on
   the eval-mode forward shapes (fp32 too), and its backward alone beside
   each #6 case (the padding bias as ``attn_mask``, ``dropout_p`` in train
   mode: timing only).
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
10a. The fp32 compute dtype (any ``--use_scale`` but "half"): one staged
   IISAN (Uncached) step at batch 64 and one FFT step at batch 8, with the
   counters at 0: 24 ``mha_fwd`` a step, and 0 / 24 ``mha_bwd``, as in
   bf16 (the three-pass TF32 kernels; their launches are the fp32 kernels'
   in the kernel line), a finite loss, the step's host and device-busy
   time by kernel family.
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
21. The tower-training baselines at phase 9's geometry and batch 8 (88
   images and titles), 3 steps each, with UNCACHED_CFG's settings
   (adapters on both towers, the towers' own weights frozen): LoRA
   (``adapter_type="lora"``, rank 64 on q and v), Houlsby adapters
   (``"houslby"``, 64 / 64) and BitFit (``"bitfit"``).  Per step 24
   ``mha_fwd`` and 24 ``mha_bwd`` (LoRA's factors get their gradient only
   through #6's dq and dv; Houlsby 22: each tower's first attention has
   nothing trainable below it) and the encoder kernels once; finite losses; a
   nonzero gradient on every trainable parameter after step 3 (LoRA's A
   has none on step 1, its B starting at zero); every frozen tower
   parameter bit-unchanged.  Host step time, device-busy time by kernel
   family and peak memory are printed beside FFT's (phase 9).
22. From one set of weights at dropout 0, 3 LoRA and 3 Houlsby steps
   through the kernels and through the module path: losses within 2e-2
   (phase 10's bound).
23. Multi-attribute text items (title, abstract, body at 30 / 50 / 50
   words; the packed table is three synthetic tables side by side): LoRA,
   3 steps of batch 8, 48 ``mha_fwd`` and ``mha_bwd`` a step (BERT three
   times, the ViT once); then IISAN at batch 64, 2 steps: 24 ``mha_fwd``
   a step (only the title block runs), and its item table (bit-equal),
   first loss (equal) and second loss (within 1e-3) are the title-only
   model's from the same weights.
24. Tower remat at the reference's FFT batch of 32 (``FFT_ATTN_AB.json``):
   FFT with ``remat_towers`` False, True and "mlp".  The first step at
   dropout 0 from one set of weights: its loss within 1e-3 relative and
   every tower gradient within the bf16 bound of no remat's.  Then 3 steps
   each (48 ``mha_fwd`` a step under remat: #5 replayed in the backward),
   peak memory, host and device-busy step time.
25. transformers weights: BERT-base and ViT-base towers with random
   weights written as transformers state dicts (``hf_state_dict``, the
   inverse of ``params_from_hf_torch``), read back through
   ``params_from_hf_torch`` into fresh towers on the card: hidden stacks
   bit-equal to the source towers'.
26. Last, after phases 27-34: print the uncached step's device-busy time
   on each tower route of this run, one JSON line of per-kernel results
   (the launches of phases 21, 23, 24 and 27-34 counted in #5, #6, the
   encoder and the cascade rows), then the final status line.
27. IISAN's caches (``cache_builder``): BERT-base x ViT-base towers from
   ``towers_from_config(IISANConfig(...))`` (bf16, #5, seeded random
   weights) over a synthetic catalogue of 4,096 items (titles of 4-30
   words; the only cut) at batch 128: text and image stores in fp16 and
   the text store in int8, 12 ``mha_fwd`` launches a batch; build time per
   1,000 items, bytes written, and two batches of each build under the
   profiler (device-busy by kernel family, idle share).  The stores
   against the module path (``fused_tower_attention=False``, same
   weights) within ``MHA_TOL["fwd"]``; rows 1, 2, 129 and 4,095 bit-equal
   to a direct forward of their own batch rounded to fp16; a 3-shard
   build on one store (``create_or_open``), 3 shard stores merged by the
   command line's ``--finalize-shards``, and a build stopped after two
   batches and resumed, each bit-equal to the single build.  Then
   ``CachedTrainer`` opens the stores through ``open_cache`` and trains 20
   steps at ``bench.py``'s settings on each SAN route (the encoder
   kernels once a step, #3 twice on ``use_pallas``); and at tower dropout
   0, from one set of SAN, head and encoder weights, its item table from
   the stores is within ``TABLE_TOL`` of ``UncachedTrainer``'s over the
   same towers, and the text taps shifted by one layer break that bound.
28. Llama-3-70B text states: ``LlamaEncoder`` at the published width
   (``LLAMA_70B``), depth 4 of 80 (80 bf16 layers are about 140 GB),
   random bf16 weights built on the card, ``build_text_cache(pool="mean")``
   over 1,024 titles of 30 tokens in ``tokenize_titles_llama``'s layout
   (a word-hash tokenizer) at batch 128: rows (5, 8192), finite, the first
   16 rows bit-equal to the mean of their batch's full stack.  Then the
   Versa "llama" preset (text taps cut to the 5 rows built) trains 10
   steps on ``use_pallas`` from this store and a ViT-tiny store built here
   (192 wide, 12 layers, 3 heads, #5): #4 and #3 once a step.
29. EVA-CLIP-18B image states: ``eva18b_geometry()`` at full depth (48
   layers, 5,120 wide; about 35 GB in bf16, random weights built on the
   card), 256 synthetic images at batch 32: rows (49, 5120), finite;
   ``collect="cls"`` bit-equal to the full stack's CLS on 4 images; a
   2-layer EVA at the same width in bf16 within ``TABLE_TOL`` of its
   fp32 copy.  The tower is freed before the next phase.
30. CLIP ViT-L/14 image states (``CLIP_L14``, full depth, bf16), 512
   images at batch 128: phase 29's checks with rows (25, 1024); the build
   time per 1,000 images beside EVA's and ViT-base's.
31. The run path from the command line: a Scientific-size dataset in the
   reference's format (20,825 items, 12,076 users; two fp16 stores of
   (20,826, 13, 768) random rows) is written to a temporary directory;
   ``python -m iisan_tpu_torch.cli --pipeline cached`` at ``bench.py``'s
   settings trains 1 epoch as a subprocess (checkpoints, an artifact,
   finite losses, each epoch's host time and valid HR@10 / nDCG@10 from
   its log) and tests its checkpoint (``--mode test``: its artifact's
   ``top_k`` ids at batch 1, 32 and 256 equal those of
   ``Recommender.from_trainer`` of the trainer resumed from it).  In this
   process (the flags' parsing, ``--load_ckpt_name`` included, is the CPU
   tests' ``tests/test_torch_cli.py``), an epoch with ``use_pallas`` (#3
   launched) and 1 epoch with ``item_tower="id"`` (export and ``top_k``);
   ``run_from_config`` for 2 epochs and for 1 epoch, a checkpoint, a resume
   and 1 more agree bit for bit (parameters and Adam moments), and a fresh
   trainer warm-started from a reference ``.pt`` of the trained model
   (``--pretrained_recsys_model``) gives its test HR@10 / nDCG@10.  Each
   command line logs its kernel launches; they join the kernel line.
32. The real-data image stores: the machine's image libraries (Pillow,
   pandas, lmdb, libjpeg, g++); an LMDB of 1,024 seeded 500 x 375 images
   written by the port's backend; where Pillow is here, the JPEG fixtures
   of ``iisan_tpu_torch/data/fixtures`` under the 800 training names
   through ``python -m iisan_tpu_torch.tools.build_lmdb`` (records equal to
   Pillow's decode, the bad-file report), and the JPEG directory's store
   (the libjpeg its decoder links, or Pillow where none is found); ``python -m
   iisan_tpu_torch.cli --pipeline uncached`` trains one epoch of 8 steps
   (512 users x 800 items, BERT-base x ViT-base, batch 64) from the LMDB
   (#5 24 times a step); the feed alone on 4 and 8 threads and its
   one-thread split (LMDB read, unpickle, resize), the staged step's
   device-busy time and the fed step's idle share (P9); the
   ViT-base image cache of the 1,024 items from the LMDB through
   ``--image-source``'s routing, per 1,000 items; ``device_bench(10)`` at
   batch 64 with its TFLOP/s against 989.
33. int8 and sharded serving and the parallel layer: phase 31's dataset
   again; one cached epoch in this process without a mesh (its artifact
   exported) and one through ``torchrun --nproc_per_node 1 -m
   iisan_tpu_torch.cli --mesh_shape data:1`` (NCCL): the two artifacts
   bit-equal and the logged losses equal, each step time printed.  Then
   ``Recommender`` over that artifact (20,826 x 64, 2 blocks, L=10) against
   ``quantize_table()`` at batch 1, 32 and 256, and the same at a
   4,000,000-row random catalogue: host-clock medians, device-busy time,
   the table's resident bytes and the peak memory of a batch-256 call; the
   int8 ids equal dense scoring of the dequantised table up to ties, scores
   within 1e-5 relative.  ``python -m iisan_tpu_torch.serve --quant int8
   --save-as`` writes the in-process quantisation bit for bit and serves
   its ids.  On a one-rank NCCL group in this process,
   ``ShardedRecommender`` (fp32 and int8) gives ``top_k``'s ids and scores,
   and ``run_from_config`` trains 5 uncached steps at ``data:1`` from a
   JPEG directory (the fixtures; the decoder's libjpeg route, or Pillow,
   printed).  ``--shard`` through ``torchrun`` writes the one-process ids,
   and ``--shard --http`` answers them.  Launches join the kernel line.
34. The paper's efficiency table and the sweep launchers: ``python -m
   iisan_tpu_torch.tools.tpme_report --users 32 --out <tmp>`` measures the six
   methods (IISAN cached and uncached, FFT, LoRA, Houlsby, BitFit) at the
   reference protocol, each in a process of its own: the cached epoch at
   Scientific size (12,076 users, batch 64; median of 3), the uncached
   methods at batch 32 (``device_bench(8)`` x 378 steps, and a host-fed
   epoch over 32 users, one batch, scaled to 12,076: the report's default
   of 256 is cut to keep the run's time), peak memory by
   ``max_memory_allocated``.  The six-row table (epoch seconds
   device-bound and host-fed, trainable parameters, peak bytes, TPME,
   remat) is printed with the card's name and power limit.  Every value
   must be finite, each method's trainable parameters ``TPME.json``'s,
   the encoder kernels launched in every method, #5 in the five uncached
   ones and #6 in FFT, LoRA, Houlsby and BitFit.  Then ``run_iisan``'s
   ``BASE | DATASETS["scientific"]`` and ``GRID`` through ``run_sweep``
   for one epoch over phase 31's dataset under the registry's file names
   (finite loss, valid HR@10 / nDCG@10), and the three launchers' dry
   runs (one point per dataset, method and variant).  Launches join the
   kernel line.

fp32 matrix products in the plain versions run in full fp32: TF32 is
switched off for matmuls and cuDNN below.  The script imports no JAX.
"""

from __future__ import annotations

import contextlib
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
# A ViT at CV_resize=256, 288 and 384: 16 x 16, 18 x 18 and 24 x 24
# patches and the CLS token.
IMAGE_T_256, IMAGE_T_288, IMAGE_T_384 = 257, 325, 577
STEP_ROWS, FFT_BATCH = 64 * (SEQ_LEN + 1), 8
# The H100 SXM's published peaks (NVIDIA data sheet, dense), for the bounds.
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # the tensor cores' TF32 rate: the fp32 attention kernels take 3 passes
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
# IISAN's caches (phase 27): BERT-base x ViT-base over a synthetic
# catalogue of CACHE_ITEMS items at the builder's batch; phases 28-30: the
# Versa towers at their published widths.
CACHE_ITEMS, CACHE_USERS, CACHE_BATCH = 4096, 2048, 128
CACHE_STEPS = 20
# Rows held against a direct forward: the first two, one in the second
# batch and one in the last.
CACHE_ROWS = (1, 2, 129, 4095)
LLAMA_ITEMS, LLAMA_DEPTH, LLAMA_USERS, LLAMA_STEPS = 1024, 4, 704, 10
LLAMA_CHECK_ROWS = 16  # rows held against the full stack's mean
# meta-llama/Meta-Llama-3-70B's config (80 layers; built at LLAMA_DEPTH).
LLAMA_70B = dict(vocab_size=128256, hidden_dim=VERSA_TEXT_DIM, num_heads=64,
                 num_kv_heads=8, intermediate_dim=28672, rope_theta=500000.0,
                 rms_eps=1e-5)
VIT_TINY = dict(hidden_dim=192, num_layers=12, num_heads=3, intermediate_dim=768)
EVA_IMAGES, EVA_BATCH, CLIP_IMAGES = 256, 32, 512
# openai/clip-vit-large-patch14's vision config.
CLIP_L14 = dict(image_size=224, patch_size=14, hidden_dim=1024, num_layers=24,
                num_heads=16, intermediate_dim=4096, hidden_act="quick_gelu")
# The bf16 bound of the item tables and the towers' fp32-vs-bf16 checks:
# max |diff| <= 0.05 x max |reference| (phase 4's table bound).
TABLE_TOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


# (phase, host seconds) of this run, in order, for the summary at the end
PHASE_SECONDS = []


@contextlib.contextmanager
def phase(label: str):
    """Logs the host seconds of the block it wraps and keeps them for the
    run's summary."""
    t0 = time.perf_counter()
    yield
    seconds = time.perf_counter() - t0
    PHASE_SECONDS.append((label, seconds))
    log(f"[{label}: {seconds:.1f} s]")


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
    from iisan_tpu_torch.utils import flops

    return bound(M * K * xsz + K * N + 8 * N + M * N * osz, flops.w8a8(M, K, N),
                 PEAK_INT8_OPS)


def w8a8_quant_bound(M: int, K: int, xsz: int = 2):
    """#10's quantise kernel reads x once and writes xq (M, K_p) and sx."""
    return bound(M * K * xsz + M * (-(-K // 16) * 16) + 4 * M, 0)


def w8a8_gemm_bound(M: int, K: int, N: int, osz: int = 2):
    """#10's GEMM reads xq, sx, the (N, K_p) weight, kscale and bias once
    and writes y; 2 M K N int8 operations."""
    from iisan_tpu_torch.utils import flops

    Kp = -(-K // 16) * 16
    return bound(M * Kp + 4 * M + N * Kp + 8 * N + M * N * osz, flops.w8a8(M, K, N),
                 PEAK_INT8_OPS)


def subblock_bound(B: int, T: int, bias: bool):
    """#8 / #9 read x, the bf16 weights and fp32 biases (and the key bias)
    once and write the bf16 output; the qkv projection, attention's two
    products and the output projection."""
    from iisan_tpu_torch.utils import flops

    D, H = TOWER_D, TOWER_H
    nbytes = B * T * D * 4 + 4 * D * D * 2 + 4 * D * 4 + (B * T * 4 if bias else 0)
    return bound(nbytes, flops.subblock(B, T, D, H))


def mha_bound(B, T, D, H, bias: bool, bwd: bool, itemsize: int = 2):
    """The attention kernels' bound at one shape: q, k, v (and g) read,
    o (or gq, gk, gv) written in bf16 (itemsize 2) or fp32, the bias read
    once; the forward's two products, the backward's five (the function's,
    without recomputation), at the bf16 tensor-core or the fp32 peak."""
    from iisan_tpu_torch.utils import flops

    tensors = 7 if bwd else 4
    nbytes = tensors * B * T * D * itemsize + (B * T * 4 if bias else 0)
    return bound(nbytes, flops.mha(B, T, D, H, bwd),
                 PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS)


def mha_bounds_fp32(B, T, D, H, bias: bool, bwd: bool):
    """The fp32 attention kernels' two bounds at one shape: the function's
    operations on the CUDA cores (``mha_bound`` at itemsize 4) and the
    three TF32 passes the kernels run on the tensor cores, each product
    three times at 495 TFLOP/s; the same bytes either way."""
    from iisan_tpu_torch.utils import flops

    tensors = 7 if bwd else 4
    nbytes = tensors * B * T * D * 4 + (B * T * 4 if bias else 0)
    return (mha_bound(B, T, D, H, bias, bwd, 4),
            bound(nbytes, 3 * flops.mha(B, T, D, H, bwd), PEAK_TF32_FLOPS))


def bounds_text(b32) -> str:
    (c_ms, c_by), (t_ms, t_by) = b32
    return (f"bound {t_ms:.4f} ms ({t_by}, three TF32 passes) / {c_ms:.4f} ms "
            f"({c_by}, the CUDA cores)")


def encoder_flops(B: int) -> float:
    """Forward operations of the user encoder over B sequences: per block
    the four projections, the two attention products and the FFN."""
    from iisan_tpu_torch.utils import flops

    return flops.encoder(B, SEQ_LEN, EMB, 4 * EMB, BLOCKS)


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
    from iisan_tpu_torch.utils import flops

    nbytes = (S * N * K * D + 2 * S * N * D + S * K * (2 * D * R + R + D)) * 2
    return bound(nbytes, flops.cascade(S, N, K, D, R))


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
# step's shapes (88 rows) and the TPME report's batch of 32 users (352):
# name, rows, tokens, padded keys (a -1e9 key bias with an all-pad row),
# dtype, dropout layer (None: eval mode), heads of 64 (12: ViT-base's and
# BERT-base's 768 wide; 3: ViT-tiny's 192).  bf16 runs the cluster design
# up to 512 keys (325: six blocks, 448: seven, 512: eight) and the split
# design at 577 (ViT at CV_resize=384; at ViT-tiny's width the JAX kernel
# itself takes these keys); fp32 the three-pass TF32 pair at every T.
ATTN_SEED = 20251016
FFT_ROWS, TPME_ROWS = FFT_BATCH * (SEQ_LEN + 1), 32 * (SEQ_LEN + 1)
VIT_TINY_H = 3
MHA_BWD_CASES = (("BERT train", FFT_ROWS, TITLE_T, True, "bfloat16", 3, TOWER_H),
                 ("ViT eval", FFT_ROWS, IMAGE_T, False, "bfloat16", None, TOWER_H),
                 ("ViT eval fp32", FFT_ROWS, IMAGE_T, False, "float32", None, TOWER_H),
                 ("BERT train fp32", FFT_ROWS, TITLE_T, True, "float32", 3, TOWER_H),
                 ("ViT eval batch 32 fp32", TPME_ROWS, IMAGE_T, False, "float32", None,
                  TOWER_H),
                 ("ViT-256 train", FFT_ROWS, IMAGE_T_256, True, "bfloat16", 4, TOWER_H),
                 ("ViT-288 train", FFT_ROWS, IMAGE_T_288, True, "bfloat16", 5, TOWER_H),
                 ("448 keys train", FFT_ROWS, 448, True, "bfloat16", 6, TOWER_H),
                 ("512 keys train", FFT_ROWS, 512, True, "bfloat16", 7, TOWER_H),
                 ("ViT-384 train", FFT_ROWS, IMAGE_T_384, True, "bfloat16", 8, TOWER_H),
                 ("ViT-tiny-384 eval", FFT_ROWS, IMAGE_T_384, False, "bfloat16", None,
                  VIT_TINY_H),
                 ("ViT eval batch 32", TPME_ROWS, IMAGE_T, False, "bfloat16", None, TOWER_H))


def padding_bias(device, gen, B: int, T: int):
    """(B, T) fp32 key bias: random lengths, row 0 all padding (-1e9)."""
    import torch

    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=device)
    lengths[0] = 0
    return torch.where(torch.arange(T, device=device)[None] < lengths[:, None], 0.0, -1e9)


def mha_bwd_case(device, gen, B: int, T: int, padded: bool, dtype: str, layer,
                 heads: int = TOWER_H):
    """(q, k, v, g, bias, kw) of one backward case, ``heads`` heads of 64:
    normal values in ``dtype`` (fp32 values use all 24 bits: bf16-rounded
    ones would need no TF32 lo part), the padding bias or None, the
    kernels' keywords."""
    import torch

    D = 64 * heads
    q, k, v, g = (torch.randn(B, T, D, generator=gen, device=device).to(getattr(torch, dtype))
                  for _ in range(4))
    bias = padding_bias(device, gen, B, T) if padded else None
    kw = dict(n_heads=heads)
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
    heads = [t.reshape(B, T, D // 64, 64).transpose(1, 2) for t in (q, k, v, g)]
    hq = [t.detach().requires_grad_(True) for t in heads[:3]]
    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    ho = F.scaled_dot_product_attention(*hq, attn_mask=mask, dropout_p=rate)
    return lambda: torch.autograd.grad(ho, hq, heads[3], retain_graph=True)


def sdpa_bwd_ms(q, k, v, g, bias, rate: float, reps: int = 10):
    """Median CUDA-event ms of ``sdpa_bwd``'s backward."""
    return cuda_timed(sdpa_bwd(q, k, v, g, bias, rate), reps)


# The attention kernels on wgmma: #5's and the subblocks' attention step's
# in bf16 (csrc/mha_fwd.cu, csrc/attn_subblock_fwd.cu: the resident design
# at each key-chunk count, eval and train, and the streamed one), #6's
# cluster design (csrc/mha_bwd.cu, one to eight key blocks, eval and
# train) and split design (its query-tile and key-tile kernels), and the
# fp32 kernels (#5's, #6's query-tile and key-tile pair; eval and train),
# with the number of instances of each: every #6 instance.
ATTN_WGMMA_KERNELS = {"mha_fwd_resident_kernel": 10, "mha_fwd_streamed_kernel": 2,
                      "subblock_attn_resident_kernel": 10, "subblock_attn_streamed_kernel": 2,
                      "mha_bwd_cluster_kernel": 16, "mha_bwd_dq_split_kernel": 2,
                      "mha_bwd_dkv_split_kernel": 2, "mha_fwd_tf32_kernel": 2,
                      "mha_bwd_dq_tf32_kernel": 2, "mha_bwd_dkv_tf32_kernel": 2}


# Key counts at every edge of the bf16 forward's tiling (128 wide, 2 heads
# past the resident limit's 321).
ATTN_FWD_EDGES = (1, 5, 63, 64, 65, 128, 197, 256, 257, 320, 321, 1000, 4097)


def check_attention_sass(counts):
    """Every instance of each attention kernel of ``ATTN_WGMMA_KERNELS``
    is built and runs its products on wgmma: HGMMA in its SASS, and no HMMA
    (mma.sync); ``counts`` is ``build.sass_mma_counts``' of every kernel."""
    for pattern, instances in ATTN_WGMMA_KERNELS.items():
        mine = {name: n for name, n in counts.items() if pattern in name}
        log(f"  SASS {pattern}: {len(mine)} instances, HGMMA "
            f"{sorted({n['HGMMA'] for n in mine.values()})}, HMMA "
            f"{sorted({n['HMMA'] for n in mine.values()})}")
        if len(mine) != instances:
            raise AssertionError(f"{pattern}: {len(mine)} instances built, not {instances}")
        if any(n["HGMMA"] == 0 or n["HMMA"] > 0 for n in mine.values()):
            raise AssertionError(f"{pattern}: an instance without wgmma, or with mma.sync")
    listed = sum(n for pattern, n in ATTN_WGMMA_KERNELS.items() if "mha_bwd" in pattern)
    if sum("mha_bwd" in name for name in counts) != listed:
        raise AssertionError(f"#6 has instances outside the {listed} listed")


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

    out = {"fwd_err": 0.0, "bwd_err": 0.0, "fwd32_err": 0.0, "bwd32_err": 0.0}

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
    # the replay kernel at the BERT step and at the FFT step's ViT attention
    # (88 x 197: planes start misaligned, 197^2 = 1 mod 4), bit-equal, timed
    # per call (CUDA events) and on the device (profiler)
    for shape, (Bm, Tm) in (("", (B, T)), ("_vit", (FFT_BATCH * (SEQ_LEN + 1), IMAGE_T))):
        def replay():
            return fa.mha_mask_replay(seed, Bm, Tm, H, rate, 5, device)
        if shape:
            equal = torch.equal(replay(), fa.attention_dropout_masks(
                seed, Bm, Tm, H, rate, 5, device))
            log(f"mha_mask_replay B={Bm} T={Tm} H={H} rate {rate}: bit-equal to "
                f"the plain masks {equal}")
            if not equal:
                raise AssertionError("mha_mask_replay differs from its plain version at ViT")
        out[f"replay{shape}_ms"] = cuda_timed(replay, 20)
        out[f"replay{shape}_device_ms"] = sum(
            ms for key, ms in kernel_device_ms(replay, 10).items() if "mask_replay" in key)
        out[f"replay{shape}_plain_ms"] = cuda_timed(
            lambda: fa.attention_dropout_masks(seed, Bm, Tm, H, rate, 5, device), 3)
        out[f"replay{shape}_bound"] = bound(Bm * H * Tm * Tm * 4, 0)
        log(f"mha_mask_replay B={Bm} T={Tm} H={H}: kernel "
            f"{out[f'replay{shape}_ms']:.4f} ms (device "
            f"{out[f'replay{shape}_device_ms']:.4f}), plain "
            f"{out[f'replay{shape}_plain_ms']:.4f} ms, bound "
            f"{out[f'replay{shape}_bound'][0]:.4f} ms")
        torch.cuda.empty_cache()
    out["replay_oracle_launches"] = fa.mha_mask_replay.launches - r0
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
    # The same titles in fp32 (the fp32 compute dtype: three TF32 passes on
    # the tensor cores), eval and train, from fp32 values that use all 24
    # bits; timed beside SDPA fp32, the bound both ways.
    q32, k32, v32 = (torch.randn(B, T, D, generator=gen, device=device) for _ in range(3))
    for name, kw in (("eval", dict(n_heads=H)),
                     ("train", dict(n_heads=H, seed=seed, rate=rate, layer=5))):
        got = fa.mha_fwd(q32, k32, v32, bias, **kw)
        want = fa.mha_fwd_plain(q32, k32, v32, bias, **kw)
        torch.cuda.synchronize()
        ratio = mha_ratio([got], [want])
        out["fwd32_err"] = max(out["fwd32_err"], err([got], [want]))
        log(f"mha_fwd BERT {name} B={B} T={T} fp32, padded keys: {ratio:.4g} (tol "
            f"{MHA_TOL_FP32}); all-pad row finite {torch_finite(got[0])}")
        require(ratio, MHA_TOL_FP32, f"mha_fwd BERT fp32 {name}")
        if not torch_finite(got[0]):
            raise AssertionError("mha_fwd fp32: the all-pad row is not finite")
    fault = mha_ratio([fa.mha_fwd(q32, k32, v32, None, n_heads=H)],
                      [fa.mha_fwd_plain(q32, k32, v32, bias, n_heads=H)])
    log(f"  planted fault 'key bias dropped' (fp32): {fault:.4g} (must be > {MHA_TOL_FP32})")
    if fault <= MHA_TOL_FP32:
        raise AssertionError("the fp32 forward bound admits a dropped key bias")
    heads32 =[t.reshape(B, T, H, D // H).transpose(1, 2).contiguous() for t in (q32, k32, v32)]
    mask32 = bias[:, None, None, :]
    bert32 = cuda_timed(lambda: fa.mha_fwd(q32, k32, v32, bias, n_heads=H), 20)
    bert32_dev = sum(t for key, t in kernel_device_ms(
        lambda: fa.mha_fwd(q32, k32, v32, bias, n_heads=H)).items() if "mha_fwd" in key)
    bert32_sdpa = cuda_timed(
        lambda: F.scaled_dot_product_attention(*heads32, attn_mask=mask32), 20)
    bert32_plain = cuda_timed(lambda: fa.mha_fwd_plain(q32, k32, v32, bias, n_heads=H), 5)
    log(f"mha_fwd BERT eval B={B} fp32: kernel {bert32:.4f} ms, device {bert32_dev:.4f} ms; "
        f"plain {bert32_plain:.4f} ms; scaled_dot_product_attention fp32 {bert32_sdpa:.4f} "
        f"ms; {bounds_text(mha_bounds_fp32(B, T, D, H, True, False))}")
    del q32, k32, v32, heads32

    # The forward at every edge of its tiling (64-row query tiles, 64-key
    # chunks, 8-key groups, the bf16 resident limit; two images, the first
    # all padding) in bf16 and fp32, eval and train, with and without the
    # key bias; an image's output bit-equal to a launch of its own (eval);
    # and a train-mode forward with #6's gradient of it at ViT's token
    # counts.
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for T in ATTN_FWD_EDGES:
        Dn, Hn = (D, H) if T <= 321 else (128, 2)
        for dt in worst:
            ftol, btol = ((MHA_TOL["fwd"], MHA_TOL["bwd"]) if dt == torch.bfloat16
                          else (MHA_TOL_FP32, MHA_TOL_FP32))
            qe, ke, ve, ge = (torch.randn(2, T, Dn, generator=gen, device=device).to(dt)
                              for _ in range(4))
            be = padding_bias(device, gen, 2, T)
            for mode, kw in (("eval", dict(n_heads=Hn)),
                             ("train", dict(n_heads=Hn, seed=seed, rate=rate, layer=6))):
                for b_ in (None, be):
                    got = fa.mha_fwd(qe, ke, ve, b_, **kw)
                    ratio = mha_ratio([got], [fa.mha_fwd_plain(qe, ke, ve, b_, **kw)])
                    worst[dt] = max(worst[dt], ratio)
                    require(ratio, ftol, f"mha_fwd T={T} {dt} {mode} bias {b_ is not None}")
                    if mode == "eval" and not torch.equal(got[1:], fa.mha_fwd(
                            qe[1:], ke[1:], ve[1:], None if b_ is None else b_[1:], **kw)):
                        raise AssertionError(f"mha_fwd T={T} {dt}: an image's output "
                                             "depends on its batch")
            if T in (IMAGE_T, IMAGE_T_256):
                kw = dict(n_heads=Hn, seed=seed, rate=rate, layer=6)
                leaves = [t.clone().requires_grad_(True) for t in (qe, ke, ve)]
                o = fa.fused_mha(*leaves, Hn, key_bias=be, drop_rate=rate, seed=seed, layer=6)
                o.backward(ge)
                fr = mha_ratio([o.detach()], [fa.mha_fwd_plain(qe, ke, ve, be, **kw)])
                gr = mha_ratio([t.grad for t in leaves],
                               fa.mha_bwd_plain(qe, ke, ve, be, ge, **kw))
                log(f"fused_mha train T={T} {dt}: forward {fr:.4g} (tol {ftol}), #6's "
                    f"gradient of it {gr:.4g} (tol {btol})")
                require(fr, ftol, f"fused_mha train T={T} {dt} forward")
                require(gr, btol, f"fused_mha train T={T} {dt} gradient")
    log(f"mha_fwd at the tile edges T={list(ATTN_FWD_EDGES)}, eval and train, with and "
        f"without the key bias: worst ratio bf16 {worst[torch.bfloat16]:.4g} (tol "
        f"{MHA_TOL['fwd']}), fp32 {worst[torch.float32]:.4g} (tol {MHA_TOL_FP32}); each "
        "image's eval output bit-equal to its own launch")

    # ViT images: 197 tokens (224 pixels) and 257 (256 pixels), no bias;
    # compared on the first 64 images, timed at 704.  257 in eval and train
    # mode; then both in fp32.
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
        del heads
    del q, k, v, g
    torch.cuda.empty_cache()
    for T in (IMAGE_T, IMAGE_T_256):
        q32, k32, v32 = (torch.randn(B, T, D, generator=gen, device=device) for _ in range(3))
        got = fa.mha_fwd(q32, k32, v32, None, n_heads=H)[:64]
        want = fa.mha_fwd_plain(q32[:64], k32[:64], v32[:64], None, n_heads=H)
        torch.cuda.synchronize()
        ratio = mha_ratio([got], [want])
        out["fwd32_err"] = max(out["fwd32_err"], err([got], [want]))
        log(f"mha_fwd ViT eval B={B} T={T} fp32 (first 64 rows vs plain): {ratio:.4g} "
            f"(tol {MHA_TOL_FP32})")
        require(ratio, MHA_TOL_FP32, f"mha_fwd ViT T={T} fp32")

        def call32():
            return fa.mha_fwd(q32, k32, v32, None, n_heads=H)

        heads32 = [t.reshape(B, T, H, D // H).transpose(1, 2).contiguous()
                   for t in (q32, k32, v32)]
        ms32 = cuda_timed(call32, 10)
        dev32 = sum(t for key, t in kernel_device_ms(call32).items() if "mha_fwd" in key)
        sdpa32 = cuda_timed(lambda: F.scaled_dot_product_attention(*heads32), 10)
        sdpa32_dev = sum(kernel_device_ms(
            lambda: F.scaled_dot_product_attention(*heads32)).values())
        del heads32
        plain32 = cuda_timed(lambda: fa.mha_fwd_plain(q32, k32, v32, None, n_heads=H), 3)
        b32 = mha_bounds_fp32(B, T, D, H, False, False)
        log(f"mha_fwd ViT eval B={B} T={T} fp32: kernel {ms32:.4f} ms, device {dev32:.4f} "
            f"ms; plain {plain32:.4f} ms; scaled_dot_product_attention fp32 {sdpa32:.4f} ms, "
            f"device {sdpa32_dev:.4f} ms; {bounds_text(b32)}")
        if T == IMAGE_T:
            out.update(fwd32_ms=ms32, fwd32_device_ms=dev32, fwd32_plain_ms=plain32,
                       fwd32_sdpa_ms=sdpa32, fwd32_bound=b32[1])
        del q32, k32, v32
        torch.cuda.empty_cache()

    # The backward at the FFT step's shapes (88 rows) and the TPME report's
    # batch (352): bf16 runs the cluster design up to fa.CLUSTER_KEYS (512)
    # and the split design beyond, fp32 the three-pass TF32 pair.  First the
    # clusters the card holds at once of each cluster instance (the wrapper
    # raises at 0).
    for train in (False, True):
        held = [fa.active_clusters(64 * nc, train, device) for nc in range(1, 9)]
        log(f"mha_bwd cluster instances ({'train' if train else 'eval'}), one to eight "
            f"blocks: {held} clusters the card holds at once")
        if min(held) < 1:
            raise AssertionError("mha_bwd: a cluster instance cannot be scheduled")
    bf16 = torch.bfloat16
    out["bwd_designs"] = {}
    for name, B, T, padded, dtype, layer, heads in MHA_BWD_CASES:
        q, k, v, g, b, kw = mha_bwd_case(device, gen, B, T, padded, dtype, layer, heads)
        tol = MHA_TOL["bwd"] if q.dtype == bf16 else MHA_TOL_FP32
        got = fa.mha_bwd(q, k, v, b, g, **kw)
        want = fa.mha_bwd_plain(q, k, v, b, g, **kw)
        torch.cuda.synchronize()
        ratio = mha_ratio(got, want)
        err_key = "bwd_err" if q.dtype == bf16 else "bwd32_err"
        out[err_key] = max(out[err_key], err(got, want))
        design = fa.library_bwd_design(T, q.element_size())
        if design != fa.bwd_design(T, q.element_size()):
            raise AssertionError(f"mha_bwd {name}: the library runs {design}, "
                                 f"bwd_design names {fa.bwd_design(T, q.element_size())}")
        log(f"mha_bwd {name} B={B} T={T} D={64 * heads} {dtype} ({design}): gq, gk, gv max "
            f"|diff| / (max|plain| + |plain|) {ratio:.4g} (tol {tol}); finite "
            f"{all(torch_finite(t) for t in got)}")
        require(ratio, tol, f"mha_bwd {name}")
        again = fa.mha_bwd(q, k, v, b, g, **kw)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        log(f"  two launches bit-equal: {same}")
        if not same:
            raise AssertionError(f"mha_bwd {name}: two launches on the same inputs differ")
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
        dev_ms = sum(t for key, t in kernel_device_ms(
            lambda: fa.mha_bwd(q, k, v, b, g, **kw)).items() if "mha_bwd" in key)
        lib_dev_ms = sum(kernel_device_ms(sdpa_bwd(q, k, v, g, b, kw.get("rate", 0.0))).values())
        bnd = mha_bound(B, T, 64 * heads, heads, padded, True, q.element_size())
        if q.dtype == bf16:
            bound_line = f"bound {bnd[0]:.4f} ms ({bnd[1]})"
            # each bf16 design's first case, for the kernel line
            out["bwd_designs"].setdefault(design, {
                "case": name, "B": B, "T": T, "D": 64 * heads, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": lib_ms})
        else:
            b32 = mha_bounds_fp32(B, T, 64 * heads, heads, padded, True)
            bound_line, bnd = bounds_text(b32), b32[1]
        if name == "ViT eval":
            out.update(bwd_ms=ms, bwd_plain_ms=plain_ms, bwd_bound=bnd, bwd_sdpa_ms=lib_ms,
                       bwd_device_ms=dev_ms)
        if name == "ViT eval fp32":
            out.update(bwd32_ms=ms, bwd32_plain_ms=plain_ms, bwd32_bound=bnd,
                       bwd32_sdpa_ms=lib_ms, bwd32_device_ms=dev_ms)
        log(f"mha_bwd {name} B={B} T={T} ({design}): kernel {ms:.4f} ms, device "
            f"{dev_ms:.4f} ms; plain {plain_ms:.4f} ms; scaled_dot_product_attention "
            f"backward {lib_ms:.4f} ms, device {lib_dev_ms:.4f} ms"
            f"{' (timing only: other dropout masks)' if 'rate' in kw else ''}; "
            f"{bound_line}")
    return out


def uncached_trainer(device, corpus, tower_params=None, **kw):
    import torch

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.images import (SyntheticImageStore,
                                             synthetic_token_table)
    from iisan_tpu_torch.train.uncached import UncachedTrainer

    import numpy as np

    cfg = IISANConfig(**{**UNCACHED_CFG, **kw})
    # one synthetic table per active text attribute, side by side (the
    # title's alone by default)
    tokens = np.concatenate([synthetic_token_table(corpus.item_num, w, seed=i)
                             for i, w in enumerate(cfg.attr_num_words())], 1)
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


def train_fft(device, counters, stats):
    """Phase 9: three full fine-tuning steps of batch 8; returns the
    launches and records (host ms, device-busy ms, peak GiB) of the step
    in ``stats["FFT"]``."""
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
    stats["FFT"] = (host, busy, peak)
    return launches


# The fp32 compute dtype's steps (any --use_scale but "half"): IISAN
# (Uncached) at batch 64 and FFT at batch 8, with their #5 and #6 launches
# a step, which are bf16's.
FP32_STEPS = (("IISAN uncached", 64, {}, {"mha_fwd": 24, "mha_bwd": 0}),
              ("FFT", FFT_BATCH, dict(adding_adapter_to="None", adapter_type="houslby"),
               {"mha_fwd": 24, "mha_bwd": 24}))


def train_fp32_steps(device, counters):
    """Phase 10a: one staged step of each of ``FP32_STEPS`` in fp32 with
    the counters at 0 (the launches of #5 and #6 a step, which must be
    bf16's), then the step's host ms and device-busy ms (profiler, 3 steps)
    by kernel family; returns the launches of the two steps."""
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    totals = None
    for name, users, kw, want in FP32_STEPS:
        corpus = synthetic_corpus(n_users=users, item_num=800, max_seq_len=SEQ_LEN, seed=0)
        tr = uncached_trainer(device, corpus, batch_size=users, compute_dtype="float32", **kw)
        batch = staged_batch(tr, 0)
        loss, launches = counted(counters, lambda: tr.train_step(*batch))
        torch.cuda.synchronize()
        host, busy, families = uncached_breakdown(tr, batch, 3)
        log(f"fp32 {name} step at batch {users} ({users * (SEQ_LEN + 1)} images and "
            f"titles, staged): loss {float(loss):.5f}; launches {nonzero(launches)}; host "
            f"{host:.2f} ms (median of 3, synchronised), device-busy {busy:.2f} ms "
            "(profiler): " + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items()))
        if any(launches[k] != v for k, v in want.items()) or not torch_finite(loss):
            raise AssertionError(f"fp32 {name}: loss {loss}, launches {launches}, "
                                 f"expected {want} a step")
        totals = launches if totals is None else {k: totals[k] + launches[k] for k in totals}
        del tr, batch
        torch.cuda.empty_cache()
    return totals


def check_uncached_routes(device, cases):
    """Phase 10 (and 22): for each (name, users, trainer options), 3 steps
    from one set of weights at dropout 0, through the kernels and through
    the module path; the losses agree within 2e-2."""
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    for name, users, kw in cases:
        corpus = synthetic_corpus(n_users=users, item_num=800,
                                  max_seq_len=SEQ_LEN, seed=0)
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


# The tower-training baselines (SURVEY section 0's Code_Uncached: LoRA,
# Houlsby adapters, BitFit) at UNCACHED_CFG's settings (adapters added to
# both towers, fine_tune_to "None": the towers' own weights frozen); LoRA
# rank and Houlsby widths are the config's 64 / 64.  Each with its #6
# launches a step: Houlsby's first layer in each tower has nothing that
# trains below its attention (frozen q, k, v over frozen embeddings), so
# autograd runs no attention backward there.
BASELINES = (("LoRA", 24, dict(adapter_type="lora")),
             ("Houlsby", 22, dict(adapter_type="houslby")),
             ("BitFit", 24, dict(adapter_type="bitfit")))
# Multi-attribute items: title, abstract, body at the config's 30 / 50 / 50
# words.
MULTI_ATTRS = dict(news_attributes=("title", "abstract", "body"))
REMAT_BATCH = 32  # the reference's FFT batch (FFT_ATTN_AB.json)


def frozen_towers(tr):
    """Copies of the tower parameters the trainer's mask freezes."""
    return {n: p.detach().clone() for n, p in tr.model.named_parameters()
            if not tr.mask[n] and n.startswith(("text_tower.", "image_tower."))}


def train_baseline(device, counters, name, per_step, stats, **kw):
    """Phase 21 (and 23): three steps of FFT's batch 8 of one baseline;
    ``per_step`` (#5, #6) launches a step.  Checks the launches, finite
    losses, a nonzero gradient on every trainable parameter (after step 3:
    LoRA's A has none on step 1, B starting at zero) and the frozen tower
    weights bit-unchanged; records (host ms, device-busy ms, peak GiB) in
    ``stats[name]``; returns the launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    corpus = synthetic_corpus(n_users=3 * FFT_BATCH, item_num=800,
                              max_seq_len=SEQ_LEN, seed=0)
    tr = uncached_trainer(device, corpus, batch_size=FFT_BATCH, **kw)
    if tr.method != kw["adapter_type"]:
        raise AssertionError(f"{name}: method {tr.method}")
    frozen = frozen_towers(tr)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    _, launches = counted(counters, lambda: tr.run_epoch(1))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    losses = tr._last_step_losses.float().cpu().numpy()
    params = dict(tr.model.named_parameters())
    trained = [n for n in params if tr.mask[n]]
    tower_trained = [n for n in trained if n.startswith(("text_tower.", "image_tower."))]
    dead = [n for n in trained
            if params[n].grad is None or not bool(params[n].grad.abs().sum() > 0)]
    moved = [n for n, p in frozen.items() if not torch.equal(params[n], p)]
    n_train = sum(params[n].numel() for n in trained)
    host, busy, families = uncached_breakdown(tr, staged_batch(tr, 0), 3)
    stats[name] = (host, busy, peak)
    log(f"{name}: 3 steps of {FFT_BATCH} users ({FFT_BATCH * (SEQ_LEN + 1)} images) in "
        f"{epoch_s:.3f} s; losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches}; {len(trained)} trainable tensors ({n_train} values, "
        f"{len(tower_trained)} in the towers), {len(trained) - len(dead)} with a nonzero "
        f"gradient; {len(frozen)} frozen tower tensors, {len(moved)} moved; peak memory "
        f"{peak:.2f} GiB")
    log(f"{name} step on a staged batch: host {host:.2f} ms (median of 3, synchronised), "
        f"device-busy {busy:.2f} ms (profiler): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items()))
    want = {"mha_fwd": per_step[0] * 3, "mha_bwd": per_step[1] * 3,
            "user_encoder_fwd": 3, "user_encoder_bwd": 3}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    if not np.isfinite(losses).all() or len(losses) != 3:
        raise AssertionError(f"{name}: losses {losses}")
    if dead or moved or not tower_trained:
        raise AssertionError(f"{name}: no gradient for {dead[:5]}, frozen weights "
                             f"moved {moved[:5]}, tower tensors trained {len(tower_trained)}")
    return launches


def log_baselines(stats):
    log("tower-training step at batch 8, this run (staged batch): " + "; ".join(
        f"{k} host {h:.2f} ms, device-busy {b:.2f} ms, peak {m:.2f} GiB"
        for k, (h, b, m) in stats.items()))


def train_multi_attribute(device, counters, stats):
    """Phase 23: LoRA over title, abstract and body (three BERT passes a
    step: 48 #5 and #6 launches), three steps of batch 8; then IISAN over
    the same rows, whose item table and losses are the title-only model's
    from the same weights (it reads only the title block: 24 #5 a step).
    Returns the launches of both runs."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    launches = train_baseline(device, counters, "LoRA, 3 attributes", (48, 48),
                              stats, adapter_type="lora", **MULTI_ATTRS)
    torch.cuda.empty_cache()
    corpus = synthetic_corpus(n_users=2 * 64, item_num=800, max_seq_len=SEQ_LEN,
                              seed=0)
    runs, state = {}, None
    for name, kw in (("3 attributes", MULTI_ATTRS), ("title", {})):
        tr = uncached_trainer(device, corpus, **kw)
        if state is None:
            state = {k: v.clone() for k, v in tr.model.state_dict().items()}
            width = tr.token_table.shape[1]
        else:
            tr.model.load_state_dict(state)
        table = tr.item_embedding_tables()
        _, counts = counted(counters, lambda: tr.run_epoch(1))
        runs[name] = (table, tr._last_step_losses.float().cpu().numpy(), counts)
        del tr
        torch.cuda.empty_cache()
    (t3, l3, c3), (t1, l1, _) = runs["3 attributes"], runs["title"]
    same_table = torch.equal(t3, t1)
    rel = float(np.max(np.abs(l3 - l1) / np.abs(l1)))
    log(f"IISAN over 3 attributes ({width} token columns), 2 steps of 64 users: losses "
        + ", ".join(f"{x:.6f}" for x in l3) + "; title only "
        + ", ".join(f"{x:.6f}" for x in l1) + f" (max relative difference {rel:.3g}); "
        f"launches {c3}; item table bit-equal to the title-only one: {same_table}")
    if width != 2 * (30 + 50 + 50) or c3["mha_fwd"] != 24 * 2 or c3["mha_bwd"] != 0:
        raise AssertionError(f"IISAN over 3 attributes: width {width}, launches {c3}")
    if not (same_table and l3[0] == l1[0] and rel <= 1e-3):
        raise AssertionError("IISAN over 3 attributes leaves the title-only model")
    return {k: launches[k] + c3[k] for k in launches}


def train_remat(device, counters):
    """Phase 24: FFT at batch 32 with remat_towers False, True and "mlp":
    the first step at dropout 0 (``deterministic=True``) from one set of
    weights, its loss within 1e-3 relative and its tower gradients within
    the bf16 bound of no remat's; then one epoch of 3 steps, peak memory,
    and the step's breakdown.  Returns the epochs' launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.images import normalize_images
    from iisan_tpu_torch.data.synthetic import synthetic_corpus

    corpus = synthetic_corpus(n_users=3 * REMAT_BATCH, item_num=800,
                              max_seq_len=SEQ_LEN, seed=0)
    total, state, ref = None, None, None
    for remat in (False, True, "mlp"):
        tr = uncached_trainer(device, corpus, batch_size=REMAT_BATCH,
                              adding_adapter_to="None", remat_towers=remat)
        if state is None:
            state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(state)
        batch = staged_batch(tr, 0)
        model = tr.model
        model.zero_grad(set_to_none=True)
        out = model(batch[0].long(), normalize_images(batch[1], tr.dtype), batch[2],
                    batch[3], tr.pop_prob, deterministic=True)
        out.backward()
        loss = float(out.detach())
        grads = {n: p.grad for n, p in model.named_parameters()
                 if n.startswith(("text_tower.", "image_tower."))}
        if ref is None:  # kept on the host, out of the peaks measured below
            ref = (loss, {n: g.cpu() for n, g in grads.items()})
            worst = 0.0
        else:
            worst = max(tensor_ratio(grads[n], g.to(device), BWD_TOL["bfloat16"])
                        for n, g in ref[1].items())
        model.zero_grad(set_to_none=True)
        del out, grads
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        _, launches = counted(counters, lambda: tr.run_epoch(1))
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        losses = tr._last_step_losses.float().cpu().numpy()
        host, busy, families = uncached_breakdown(tr, batch, 2)
        rel = abs(loss - ref[0]) / abs(ref[0])
        log(f"FFT at batch {REMAT_BATCH}, remat_towers={remat!r}: first step at dropout 0 "
            f"loss {loss:.6f} (relative to no remat {rel:.3g}, tol 1e-3; tower gradients "
            f"at {worst:.3g} of the bf16 bound); 3 steps in {epoch_s:.3f} s, losses "
            + ", ".join(f"{x:.4f}" for x in losses) + f"; launches {launches}; peak "
            f"memory {peak:.2f} GiB; staged step host {host:.2f} ms (median of 2), "
            f"device-busy {busy:.2f} ms: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in families.items()))
        replay = 2 if remat else 1
        if launches["mha_fwd"] != 24 * 3 * replay or launches["mha_bwd"] != 24 * 3:
            raise AssertionError(f"remat {remat!r}: launches {launches}")
        if rel > 1e-3 or worst > 1.0 or not np.isfinite(losses).all():
            raise AssertionError(f"remat {remat!r} leaves no remat: loss {loss} vs "
                                 f"{ref[0]}, gradients at {worst} of the bound")
        total = launches if total is None else {k: total[k] + launches[k]
                                                for k in launches}
        del tr, model, batch
        torch.cuda.empty_cache()
    return total


def tensor_ratio(got, want, tol):
    """Largest |got - want| / (tol * (max|want| + |want|)): <= 1 agrees."""
    got, want = got.float(), want.float()
    if not torch_finite(got):
        return float("inf")
    bound = tol * (want.abs().max() + want.abs())
    return float(((got - want).abs() / bound.clamp_min(1e-30)).max())


# transformers' names of the port's tower parameters: (port name, HF name);
# per layer, the module names (a dense layer's weight is its kernel
# transposed, a LayerNorm's weight its scale).
BERT_TO_HF = (
    ("word_embeddings.embedding", "embeddings.word_embeddings.weight"),
    ("position_embeddings", "embeddings.position_embeddings.weight"),
    ("token_type_embeddings", "embeddings.token_type_embeddings.weight"),
    ("embeddings_layernorm.scale", "embeddings.LayerNorm.weight"),
    ("embeddings_layernorm.bias", "embeddings.LayerNorm.bias"))
BERT_LAYER_TO_HF = (
    ("attention.query", "attention.self.query"),
    ("attention.key", "attention.self.key"),
    ("attention.value", "attention.self.value"),
    ("attention_output", "attention.output.dense"),
    ("attention_layernorm", "attention.output.LayerNorm"),
    ("intermediate", "intermediate.dense"),
    ("output", "output.dense"),
    ("output_layernorm", "output.LayerNorm"))
VIT_LAYER_TO_HF = (
    ("layernorm_before", "layernorm_before"),
    ("attention.query", "attention.attention.query"),
    ("attention.key", "attention.attention.key"),
    ("attention.value", "attention.attention.value"),
    ("attention_output", "attention.output.dense"),
    ("layernorm_after", "layernorm_after"),
    ("intermediate", "intermediate.dense"),
    ("output", "output.dense"))


def hf_state_dict(enc, vit: bool):
    """transformers' state dict of a port encoder's weights (the inverse of
    ``params_from_hf_torch``), tensors on the encoder's device."""
    p = dict(enc.named_parameters())
    sd = {}
    if vit:
        k = p["patch_projection.kernel"]
        ps = enc.patch_size
        sd["embeddings.patch_embeddings.projection.weight"] = (
            k.reshape(ps, ps, 3, -1).permute(3, 2, 0, 1).contiguous())
        sd["embeddings.patch_embeddings.projection.bias"] = p["patch_projection.bias"]
        sd["embeddings.cls_token"] = p["cls_token"]
        sd["embeddings.position_embeddings"] = p["position_embeddings"]
        sd["layernorm.weight"] = p["final_layernorm.scale"]
        sd["layernorm.bias"] = p["final_layernorm.bias"]
    else:
        sd.update((hf, p[ours]) for ours, hf in BERT_TO_HF)
    for i in range(enc.num_layers):
        for ours, hf in (VIT_LAYER_TO_HF if vit else BERT_LAYER_TO_HF):
            a, b = f"layer_{i}.{ours}", f"encoder.layer.{i}.{hf}"
            if f"{a}.kernel" in p:
                sd[f"{b}.weight"] = p[f"{a}.kernel"].t().contiguous()
            else:
                sd[f"{b}.weight"] = p[f"{a}.scale"]
            sd[f"{b}.bias"] = p[f"{a}.bias"]
    return sd


def check_hf_import(device):
    """Phase 25: BERT-base and ViT-base towers with random weights, as
    transformers state dicts (``hf_state_dict``), through
    ``params_from_hf_torch`` into fresh towers on the card: the hidden
    stacks are bit-equal to the source towers'."""
    import torch

    from iisan_tpu_torch.models import bert, vit
    from iisan_tpu_torch.utils.jax_params import load_jax_params

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = FFT_BATCH * (SEQ_LEN + 1)
    for name, module, is_vit in (("BERT-base", bert, False), ("ViT-base", vit, True)):
        cls = module.ViTEncoder if is_vit else module.BertEncoder
        made = [cls(dtype=torch.bfloat16, fused_attention=True, collect="cls",
                    generator=torch.Generator().manual_seed(seed)).to(device)
                for seed in (1, 2)]
        source, fresh = made
        if is_vit:
            size = source.image_size
            args = (torch.randn((rows, size, size, 3), generator=gen,
                                device=device).to(torch.bfloat16),)
        else:
            vocab = source.word_embeddings.embedding.shape[0]
            ids = torch.randint(1, vocab, (rows, TITLE_T), generator=gen, device=device)
            mask = torch.ones_like(ids)
            mask[1, 17:] = 0
            args = (ids, mask)
        sd = hf_state_dict(source, is_vit)
        tree = (module.params_from_hf_torch(sd, source.num_layers, prefix="")
                if is_vit else module.params_from_hf_torch(sd, source.num_layers))
        load_jax_params(fresh, tree)
        with torch.no_grad():
            want, got = source(*args)[1], fresh(*args)[1]
        log(f"HF import, {name}: {len(sd)} transformers tensors -> params_from_hf_torch "
            f"-> a fresh tower on the card; hidden stack {tuple(got.shape)} bit-equal "
            f"{torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise AssertionError(f"HF import, {name}: the hidden stacks differ")
        del made, source, fresh, sd, tree, args
        torch.cuda.empty_cache()


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


class MemoImages:
    """An image store that keeps each image it has made (the first build
    pays the synthetic decode; the repeats of phase 27 do not)."""

    def __init__(self, store):
        self.store, self.resize, self.cache = store, store.resize, {}

    def get(self, name):
        if name not in self.cache:
            self.cache[name] = self.store.get(name)
        return self.cache[name]


class WordTokenizer:
    """A duck-typed tokenizer for ``tokenize_titles_llama``: Llama-3's
    begin-of-text id, then one id in [1, 128000) per word (CRC-32)."""

    def encode(self, text, add_special_tokens=True):
        import zlib

        ids = [zlib.crc32(w.encode()) % 127999 + 1 for w in text.split()]
        return ([128000] if add_special_tokens else []) + ids


def store_bytes(store) -> int:
    import os

    return sum(os.path.getsize(os.path.join(store.path, f))
               for f in os.listdir(store.path))


def same_store(a, b) -> bool:
    import numpy as np

    if not np.array_equal(np.asarray(a._arr), np.asarray(b._arr)):
        return False
    return a._scales is None or np.array_equal(np.asarray(a._scales),
                                               np.asarray(b._scales))


def build_profile(fn):
    """(host s, device-busy ms, ms by kernel family) of one call of ``fn``
    under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    families, _ = kernel_families(prof, 1)
    return host, sum(families.values()), families


def set_fused(enc, fused):
    """The attention route of every layer of a BERT / ViT tower."""
    for m in enc.modules():
        if hasattr(m, "fused"):
            m.fused = fused


def run_iisan_caches(device, counters, tmp):
    """Phase 27: IISAN's caches through #5 and cached training from them.
    Returns the launches (the builds' ``mha_fwd``, the training steps'
    encoder and cascade kernels)."""
    import numpy as np
    import torch

    from iisan_tpu_torch import cache_builder as cb
    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.cache_store import HiddenStateCache, write_shard_range
    from iisan_tpu_torch.data.images import (SyntheticImageStore, normalize_images,
                                             synthetic_token_table)
    from iisan_tpu_torch.data.synthetic import synthetic_corpus
    from iisan_tpu_torch.models.towers import towers_from_config
    from iisan_tpu_torch.tools import build_caches
    from iisan_tpu_torch.train.cached import CachedTrainer
    from iisan_tpu_torch.train.pipelines import open_cache
    from iisan_tpu_torch.train.uncached import UncachedTrainer

    totals = {c.__name__: 0 for c in counters}

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    cfg = IISANConfig(**dict(TRAIN_CFG, stored_vector_path=str(tmp)))
    text, image = towers_from_config(
        cfg, device=device, generator=torch.Generator(device).manual_seed(SEED))
    bert, vit = text.bert, image.vit
    n = CACHE_ITEMS + 1
    corpus = synthetic_corpus(n_users=CACHE_USERS, item_num=CACHE_ITEMS,
                              max_seq_len=SEQ_LEN, seed=SEED)
    tokens = synthetic_token_table(CACHE_ITEMS, TITLE_T, seed=SEED)
    lengths = np.random.default_rng(SEED).integers(4, TITLE_T + 1, size=CACHE_ITEMS)
    tokens[1:, :TITLE_T] *= np.arange(TITLE_T) < lengths[:, None]  # titles of 4-30 words
    tokens[1:, TITLE_T:] = np.arange(TITLE_T) < lengths[:, None]
    images = MemoImages(SyntheticImageStore(cfg.CV_resize))
    names = corpus.item_names

    def build(kind, path, enc=None, **kw):
        if kind == "text":
            return cb.build_text_cache(enc or bert, tokens, str(path),
                                       batch=CACHE_BATCH, device=device, **kw)
        return cb.build_image_cache(enc or vit, names, images, str(path),
                                    batch=CACHE_BATCH, device=device, **kw)

    # the fp16 stores (timed; the image build makes the synthetic images),
    # and the text store again as int8
    stores, per_1000 = {}, {}
    for kind, name in (("text", "bert_outputs"), ("image", "vit_outputs")):
        t0 = time.perf_counter()
        stores[kind], launches = counted(counters, lambda: build(
            kind, tmp / f"{name}.memmap"))
        torch.cuda.synchronize()
        per_1000[kind] = (time.perf_counter() - t0) / CACHE_ITEMS * 1e3
        add(launches)
        enc = bert if kind == "text" else vit
        want = enc.num_layers * (CACHE_ITEMS // CACHE_BATCH)
        if launches["mha_fwd"] != want:
            raise AssertionError(f"{kind} cache build: mha_fwd {launches['mha_fwd']}, "
                                 f"expected {want}")
        cb.verify_cache(stores[kind], *cb.state_geometry(enc), first_row=1)
    int8, launches = counted(counters, lambda: build(
        "text", tmp / "bert_int8.memmap", dtype="int8"))
    add(launches)
    fp16 = stores["text"].load_full()
    q = int8.load_full()
    q_err = float(np.abs(q - fp16).max())
    q_bound = float((np.abs(fp16).max(-1) / 254).max()) + 1e-2
    log(f"phase 27 cache builds (BERT-base x ViT-base, {CACHE_ITEMS} items, batch "
        f"{CACHE_BATCH}, bf16 towers, #5): text {per_1000['text'] * 1e3:.1f} ms and "
        f"image {per_1000['image'] * 1e3:.1f} ms per 1,000 items (host clock; the "
        f"image build makes its synthetic images); mha_fwd {bert.num_layers} "
        f"launches a batch; bytes written: text fp16 {store_bytes(stores['text'])}, image "
        f"fp16 {store_bytes(stores['image'])}, text int8 {store_bytes(int8)}; int8 vs "
        f"fp16 store max |diff| {q_err:.5g} (bound {q_bound:.5g})")
    if q_err > q_bound:
        raise AssertionError("the int8 store leaves the fp16 one")

    # the device-busy split of two batches of each build
    for kind, enc in (("text", bert), ("image", vit)):
        host, busy, fam = build_profile(lambda: build(
            kind, tmp / f"profiled_{kind}", enc, end_item=1 + 2 * CACHE_BATCH))
        log(f"phase 27 {kind} build, 2 batches of {CACHE_BATCH} under the profiler: "
            f"host {host * 1e3:.1f} ms, device-busy {busy:.2f} ms (idle share "
            f"{1 - busy / (host * 1e3):.1%}); attention kernels "
            f"{fam['attention kernels']:.2f} ms ({fam['attention kernels'] / busy:.1%}), "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in fam.items()
                        if v > 0 and k != "attention kernels"))

    # against the module path: the same weights with fused_tower_attention=False
    for kind, enc in (("text", bert), ("image", vit)):
        set_fused(enc, False)
        try:
            plain, launches = counted(counters, lambda: build(kind, tmp / f"plain_{kind}"))
        finally:
            set_fused(enc, True)
        if launches["mha_fwd"]:
            raise AssertionError("the module path launched #5")
        got = torch.as_tensor(stores[kind].load_full()[1:])
        ratio = mha_ratio([got], [torch.as_tensor(plain.load_full()[1:])])
        log(f"phase 27 {kind} store, #5 vs the module path: max |diff| / (max |plain| + "
            f"|plain|) {ratio:.3g} (tol {MHA_TOL['fwd']})")
        if ratio > MHA_TOL["fwd"]:
            raise AssertionError(f"{kind} store: #5 and the module path disagree")

    # against a direct forward of the rows' own batches (the same M)
    with torch.inference_mode():
        for row in CACHE_ROWS:
            s = 1 + (row - 1) // CACHE_BATCH * CACHE_BATCH
            ids = np.resize(np.arange(s, min(s + CACHE_BATCH, n)), CACHE_BATCH)
            tok = torch.as_tensor(tokens[ids]).to(device)
            direct = {"text": bert(tok[:, :TITLE_T], tok[:, TITLE_T:])[1]}
            u8 = torch.as_tensor(np.stack([images.get(names[i]) for i in ids])).to(device)
            direct["image"] = vit(normalize_images(u8, torch.float32))[1]
            for kind, h in direct.items():
                want = h[:, row - s].float().cpu().numpy().astype(np.float16)
                if not np.array_equal(np.asarray(stores[kind]._arr[row]), want):
                    raise AssertionError(f"{kind} store row {row} is not the direct forward's")
    log(f"phase 27: store rows {CACHE_ROWS} equal a direct forward's CLS rows of "
        f"each layer (their own batch of {CACHE_BATCH}), rounded to fp16, bit for bit")

    # shard invariance and resume, bit for bit
    for kind, name in (("text", "bert_outputs"), ("image", "vit_outputs")):
        shard_dir = tmp / f"shards_{kind}"
        for shard in range(3):
            lo, hi = build_caches.shard_range(n, shard, 3)
            _, launches = counted(counters, lambda: build(
                kind, tmp / f"shared_{kind}", start_item=lo, end_item=hi))
            add(launches)
            path = shard_dir / f"{name}.memmap.shard{shard}"
            _, launches = counted(counters, lambda: build(
                kind, path, start_item=lo, end_item=hi))
            add(launches)
            write_shard_range(str(path), lo, hi)
        build_caches.main(["--out", str(shard_dir), "--finalize-shards"])
        stop = 1 + 2 * CACHE_BATCH
        _, launches = counted(counters, lambda: build(kind, tmp / f"resume_{kind}",
                                                      end_item=stop))
        add(launches)
        _, launches = counted(counters, lambda: build(kind, tmp / f"resume_{kind}",
                                                      start_item=stop))
        add(launches)
        checks = {"3 shards, one store": HiddenStateCache.open(str(tmp / f"shared_{kind}")),
                  "3 shard stores merged": HiddenStateCache.open(str(shard_dir / f"{name}.memmap")),
                  "stopped after 2 batches, resumed": HiddenStateCache.open(str(tmp / f"resume_{kind}"))}
        bad = [k for k, st in checks.items() if not same_store(st, stores[kind])]
        log(f"phase 27 {kind}: " + ", ".join(checks) + " -> bit-equal to the single "
            f"build: {not bad}")
        if bad:
            raise AssertionError(f"{kind}: {bad} differ from the single build")

    # cached training from the stores on both SAN routes
    cv_taps = open_cache(cfg, "image", corpus).load_taps(cfg.san_image_taps())
    text_taps = open_cache(cfg, "text", corpus).load_taps(cfg.san_text_taps())
    for use_pallas in (False, True):
        tr = CachedTrainer(cfg.replace(use_pallas=use_pallas), corpus, cv_taps,
                           text_taps, device=device)
        perm = torch.as_tensor(tr.epoch_permutation(1), device=device).long()
        t0 = time.perf_counter()
        losses, launches = counted(counters, lambda: [
            float(tr.train_step(tr.train_seqs[perm[i]], tr.train_log_mask[perm[i]]))
            for i in range(CACHE_STEPS)])
        step_ms = (time.perf_counter() - t0) / CACHE_STEPS * 1e3
        add(launches)
        want = {"user_encoder_fwd": CACHE_STEPS, "user_encoder_bwd": CACHE_STEPS,
                "san_cascade_fwd": 2 * CACHE_STEPS if use_pallas else 0,
                "san_cascade_streamed_fwd": 0, "mha_fwd": 0}
        log(f"phase 27 train from the stores [{'use_pallas' if use_pallas else 'default'}]: "
            f"{CACHE_STEPS} steps, {step_ms:.2f} ms/step (host clock, with the loss "
            f"fetched each step), losses {losses[0]:.5f} ... {losses[-1]:.5f}; launches "
            f"{launches}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"training from the stores: losses {losses}")
        if launches != want:
            raise AssertionError(f"training from the stores: launches {launches}, "
                                 f"expected {want}")
        del tr
    del cv_taps, text_taps

    # Cached == Uncached: the uncached trainer's item table over the same
    # towers against the cached trainer's from the built stores
    ucfg = IISANConfig(**dict(UNCACHED_CFG, tower_dropout=0.0, stored_vector_path=str(tmp)))
    uc = UncachedTrainer(ucfg, corpus, tokens, images, device=device)
    uc.model.text_tower.bert.load_state_dict(bert.state_dict())
    uc.model.image_tower.vit.load_state_dict(vit.state_dict())
    del text, image, bert, vit
    torch.cuda.empty_cache()

    def cached_table(text_taps):
        ct = CachedTrainer(ucfg.replace(pipeline="cached"), corpus,
                           open_cache(ucfg, "image", corpus).load_taps(ucfg.san_image_taps()),
                           open_cache(ucfg, "text", corpus).load_taps(text_taps),
                           device=device)
        for part in ("san", "user_encoder", "fuse"):
            getattr(ct.model, part).load_state_dict(getattr(uc.model, part).state_dict())
        return ct.fused_item_table()[1:].float()

    table, launches = counted(counters, lambda: uc.item_embedding_tables(CACHE_BATCH))
    add(launches)
    ref = table[1:].float()
    scale = float(ref.abs().max())
    diff = float((cached_table(ucfg.san_text_taps()) - ref).abs().max())
    shifted = tuple(min(i + 1, ucfg.text_layers) for i in ucfg.san_text_taps())
    shift_diff = float((cached_table(shifted) - ref).abs().max())
    log(f"phase 27 Cached == Uncached (tower dropout 0, one set of SAN, head and "
        f"encoder weights, items 1..{CACHE_ITEMS}): max |cached - uncached| "
        f"{diff:.5g} = {diff / scale:.3%} of max |uncached| {scale:.4g} (tol "
        f"{TABLE_TOL:.0%}); text taps shifted by one layer: {shift_diff:.5g} = "
        f"{shift_diff / scale:.3%} (must break the bound); uncached table launches "
        f"{launches}")
    if not np.isfinite(scale) or diff > TABLE_TOL * scale:
        raise AssertionError("the cached item table leaves the uncached one")
    if shift_diff <= TABLE_TOL * scale:
        raise AssertionError("the tap shift stays within the bound: it has no teeth")
    return totals, per_1000


def tower_checks(name, enc, make, images_u8):
    """Phases 29 and 30: ``collect="cls"`` of the built tower ``enc``
    bit-equal to its full stack's CLS on 4 images; then (``enc`` freed by
    the caller) a 2-layer tower at the same width from ``make(dtype,
    depth)`` in fp32 against its bf16 copy, within ``TABLE_TOL``.  Returns
    the second check, a callable."""
    import torch

    from iisan_tpu_torch.data.images import normalize_images

    x = normalize_images(images_u8, torch.float32)
    with torch.inference_mode():
        enc.collect = "full"
        full = enc(x)[1][:, :, 0]
        enc.collect = "cls"
        cls = enc(x)[1]
    if not torch.equal(full, cls):
        raise AssertionError(f"{name}: collect='cls' is not the full stack's CLS")

    def fp32_vs_bf16():
        ref = make(torch.float32, 2)
        low = make(torch.bfloat16, 2)
        low.load_state_dict(ref.state_dict())
        with torch.inference_mode():
            want = ref(x)[1].float()
            got = low(x)[1].float()
        ratio = float((got - want).abs().max() / want.abs().max())
        log(f"{name}: collect='cls' bit-equal to the full stack's CLS on 4 images; "
            f"2 layers at the same width, bf16 vs fp32: max |diff| / max |fp32| "
            f"{ratio:.4g} (tol {TABLE_TOL})")
        if ratio > TABLE_TOL:
            raise AssertionError(f"{name}: bf16 leaves fp32")

    return fp32_vs_bf16


def run_versa_caches(device, counters, tmp, vit_base_per_1000):
    """Phases 28-30: Llama-3-70B text states (depth 4) and Versa training
    from them, EVA-CLIP-18B and CLIP ViT-L/14 image states.  Returns the
    launches."""
    import numpy as np
    import torch

    from iisan_tpu_torch import cache_builder as cb
    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.images import SyntheticImageStore
    from iisan_tpu_torch.data.preprocess import tokenize_titles_llama
    from iisan_tpu_torch.data.synthetic import synthetic_corpus
    from iisan_tpu_torch.models import clip_vit, eva
    from iisan_tpu_torch.models.llama import LlamaEncoder
    from iisan_tpu_torch.models.modules import hidden_reducer
    from iisan_tpu_torch.models.vit import ViTEncoder
    from iisan_tpu_torch.train.cached import CachedTrainer
    from iisan_tpu_torch.train.pipelines import open_cache

    totals = {c.__name__: 0 for c in counters}

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    # 28: Llama-3-70B at depth 4, mean-pooled over tokenize_titles_llama's rows
    cfg = IISANConfig(**dict(VERSA_CFG, use_pallas=True, stored_vector_path=str(tmp),
                             text_layers=LLAMA_DEPTH,
                             side_adapter_bert_list="0,1,2,3"))
    corpus = synthetic_corpus(n_users=LLAMA_USERS, item_num=LLAMA_ITEMS,
                              max_seq_len=SEQ_LEN, seed=SEED)
    rng = np.random.default_rng(SEED)
    words = [f"w{i}" for i in range(5000)]
    titles = {i: " ".join(rng.choice(words, size=int(rng.integers(3, 40))))
              for i in range(1, LLAMA_ITEMS + 1)}
    tokens = tokenize_titles_llama(titles, WordTokenizer(), TITLE_T)
    t0 = time.perf_counter()
    llm = LlamaEncoder(num_layers=LLAMA_DEPTH, dtype=torch.bfloat16, device=device,
                       generator=torch.Generator(device).manual_seed(SEED + 28),
                       **LLAMA_70B)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = cb.build_text_cache(llm, tokens, str(tmp / f"{cfg.cached_text_model}.memmap"),
                                batch=CACHE_BATCH, pool="mean", device=device)
    torch.cuda.synchronize()
    llama_per_1000 = (time.perf_counter() - t0) / LLAMA_ITEMS * 1e3
    cb.verify_cache(store, LLAMA_DEPTH + 1, VERSA_TEXT_DIM, first_row=1)
    with torch.inference_mode():  # the first batch, full stack, reduced per layer
        batch = torch.as_tensor(tokens[1:1 + CACHE_BATCH]).to(device)
        llm.collect = "full"
        _, full = llm(batch[:, :TITLE_T], batch[:, TITLE_T:])
        llm.collect = "mean"
        reduce = hidden_reducer("mean", batch[:, TITLE_T:])
        want = torch.stack([reduce(h) for h in full], 1)[:LLAMA_CHECK_ROWS].cpu().numpy()
    rows = np.asarray(store._arr[1:1 + LLAMA_CHECK_ROWS])
    full_rows = store.load_full()
    if not np.array_equal(rows, want.astype(np.float16)):
        raise AssertionError("llama: the collect='mean' store is not the full stack's mean")
    if store._arr.shape[1:] != (LLAMA_DEPTH + 1, VERSA_TEXT_DIM) or not np.isfinite(full_rows).all():
        raise AssertionError(f"llama: rows {store._arr.shape[1:]}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del llm, full, batch
    torch.cuda.empty_cache()
    vit = ViTEncoder(dtype=torch.bfloat16, fused_attention=True, collect="cls",
                     device=device, generator=torch.Generator(device).manual_seed(SEED),
                     **VIT_TINY)
    images = MemoImages(SyntheticImageStore(cfg.CV_resize))
    image_store, launches = counted(counters, lambda: cb.build_image_cache(
        vit, corpus.item_names, images, str(tmp / f"{cfg.cached_image_model}.memmap"),
        batch=CACHE_BATCH, device=device))
    add(launches)
    want_mha = vit.num_layers * (LLAMA_ITEMS // CACHE_BATCH)
    g = LLAMA_70B
    log(f"phase 28 Llama-3-70B text states ({g['hidden_dim']} wide, {g['num_heads']} / "
        f"{g['num_kv_heads']} heads, FFN {g['intermediate_dim']}, vocab {g['vocab_size']}, "
        f"depth {LLAMA_DEPTH} of 80, bf16, random weights built on the "
        f"card in {init_s:.2f} s): {LLAMA_ITEMS} titles of {TITLE_T} tokens, batch "
        f"{CACHE_BATCH}, {llama_per_1000 * 1e3:.1f} ms per 1,000 items (host clock); "
        f"rows ({LLAMA_DEPTH + 1}, {VERSA_TEXT_DIM}), finite, {store_bytes(store)} "
        f"bytes; rows 1-{LLAMA_CHECK_ROWS} equal the mean of their batch's full stack bit for bit; "
        f"peak memory {peak:.2f} GiB; ViT-tiny image store: mha_fwd "
        f"{launches['mha_fwd']} launches (expected {want_mha})")
    if launches["mha_fwd"] != want_mha:
        raise AssertionError("ViT-tiny build: mha_fwd launches")
    tr = CachedTrainer(cfg, corpus,
                       open_cache(cfg, "image", corpus).load_taps(cfg.san_image_taps()),
                       open_cache(cfg, "text", corpus).load_taps(cfg.san_text_taps()),
                       device=device)
    perm = torch.as_tensor(tr.epoch_permutation(1), device=device).long()
    losses, launches = counted(counters, lambda: [
        float(tr.train_step(tr.train_seqs[perm[i]], tr.train_log_mask[perm[i]]))
        for i in range(LLAMA_STEPS)])
    add(launches)
    want = {"user_encoder_fwd": LLAMA_STEPS, "user_encoder_bwd": LLAMA_STEPS,
            "san_cascade_fwd": LLAMA_STEPS, "san_cascade_streamed_fwd": LLAMA_STEPS,
            "mha_fwd": 0}
    log(f"phase 28 Versa 'llama' preset, text taps cut to the {LLAMA_DEPTH + 1} rows "
        f"built (0,1,2,3 -> rows 0-4), use_pallas: {LLAMA_STEPS} steps from the built "
        f"stores, losses {losses[0]:.5f} ... {losses[-1]:.5f}; launches {launches}")
    if not np.isfinite(losses).all() or launches != want:
        raise AssertionError(f"versa from built stores: losses {losses}, launches "
                             f"{launches}, expected {want}")
    del tr, vit
    torch.cuda.empty_cache()

    per_1000 = {"ViT-base (phase 27)": vit_base_per_1000}
    for phase, name, n_img, batch, geometry, make in (
            (29, "EVA-CLIP-18B", EVA_IMAGES, EVA_BATCH, eva.eva18b_geometry(),
             lambda dt, depth, g: eva.EvaVisionEncoder(
                 dtype=dt, device=device, generator=torch.Generator(device).manual_seed(SEED + 29),
                 **dict(g, num_layers=depth or g["num_layers"]))),
            (30, "CLIP ViT-L/14", CLIP_IMAGES, CACHE_BATCH, CLIP_L14,
             lambda dt, depth, g: clip_vit.CLIPVisionEncoder(
                 dtype=dt, device=device, generator=torch.Generator(device).manual_seed(SEED + 30),
                 **dict(g, num_layers=depth or g["num_layers"])))):
        names = ["<pad>"] + [f"item{i}" for i in range(1, n_img + 1)]
        images = MemoImages(SyntheticImageStore(geometry["image_size"]))  # each build makes its images
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        enc = make(torch.bfloat16, None, geometry)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in enc.parameters())
        t0 = time.perf_counter()
        st = cb.build_image_cache(enc, names, images, str(tmp / f"phase{phase}.memmap"),
                                  batch=batch, device=device)
        torch.cuda.synchronize()
        per_1000[name] = (time.perf_counter() - t0) / n_img * 1e3
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        full_rows = st.load_full()
        shape = (geometry["num_layers"] + 1, geometry["hidden_dim"])
        log(f"phase {phase} {name} image states (full depth {geometry['num_layers']}, "
            f"width {geometry['hidden_dim']}, {geometry['num_heads']} heads, FFN "
            f"{geometry['intermediate_dim']}, {n_params / 1e9:.2f}B parameters in bf16 "
            f"built on the card in {init_s:.2f} s): {n_img} images at batch {batch}, "
            f"{per_1000[name] * 1e3:.1f} ms per 1,000 images (host clock), rows "
            f"{st._arr.shape[1:]}, finite {bool(np.isfinite(full_rows).all())}, "
            f"{store_bytes(st)} bytes, peak memory {peak:.2f} GiB")
        if st._arr.shape[1:] != shape or not np.isfinite(full_rows).all():
            raise AssertionError(f"{name}: rows {st._arr.shape[1:]}, expected {shape}")
        u8 = torch.as_tensor(np.stack([images.get(names[i]) for i in range(1, 5)])).to(device)
        second = tower_checks(name, enc, lambda dt, depth: make(dt, depth, geometry), u8)
        del enc, st, full_rows
        torch.cuda.empty_cache()
        second()
        torch.cuda.empty_cache()
    log("build time per 1,000 images (host clock): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in per_1000.items()))
    return totals


CLI_EPOCHS = 1
# The fp16 stores of phase 31 are written in chunks of this many rows.
STORE_CHUNK = 4096


def write_cli_dataset(device, root: Path):
    """Phase 31's dataset: ``items.tsv`` and ``users.tsv`` in the reference
    format at the Scientific size (every item in some sequence of 5-13
    items, from a seeded numpy generator) and two fp16 stores of seeded
    random rows (made on the card), ``bert_outputs.memmap`` and
    ``vit_outputs.memmap``, (items + 1, 13, 768).  Returns the bytes
    written."""
    import numpy as np
    import torch

    from iisan_tpu_torch.data.cache_store import HiddenStateCache

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(5, SEQ_LEN + 4, USERS)
    stream = np.concatenate([rng.permutation(ITEMS),
                             rng.integers(0, ITEMS, int(lengths.sum()) - ITEMS)])
    rng.shuffle(stream)
    with open(root / "items.tsv", "w") as f:
        f.writelines(f"I{i:05d}\tTitle of item {i}\n" for i in range(ITEMS))
    with open(root / "users.tsv", "w") as f:
        for u, seq in enumerate(np.split(stream, np.cumsum(lengths)[:-1])):
            f.write(f"U{u}\t" + " ".join(f"I{i:05d}" for i in seq) + "\n")
    gen = torch.Generator(device=device).manual_seed(SEED)
    for name in ("bert_outputs", "vit_outputs"):
        store = HiddenStateCache.create(str(root / "vecs" / f"{name}.memmap"),
                                        ITEMS + 1, 13, TAP_DIM, "float16")
        for start in range(1, ITEMS + 1, STORE_CHUNK):
            n = min(STORE_CHUNK, ITEMS + 1 - start)
            rows = torch.randn((n, 13, TAP_DIM), generator=gen, device=device)
            store.write_rows(start, rows.half().cpu().numpy())
        store.flush()
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def cli_args(device, root: Path, name: str, *extra):
    """``python -m iisan_tpu_torch.cli`` at ``bench.py``'s settings over
    phase 31's dataset on ``device``, its checkpoints and logs under
    ``root / name``."""
    cfg = dict(TRAIN_CFG, device=device, pipeline="cached", side_adapter_vit_list="1,3,5,7,9,11",
               side_adapter_bert_list="1,3,5,7,9,11", modality="intra_inter",
               root_data_dir=str(root), dataset="", behaviors="users.tsv",
               news="items.tsv", stored_vector_path=str(root / "vecs"),
               ckpt_dir=str(root / name / "ckpt"), log_dir=str(root / name / "logs"))
    del cfg["epoch"]
    return [a for k, v in cfg.items() for a in (f"--{k}", str(v))] + list(extra)


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def run_cli(args, what: str, phase: int = 31, launcher=(sys.executable,)):
    """Run the port's command line on the card (under ``launcher``, e.g.
    ``TORCHRUN``); returns (its log lines, {"launches": kernel launches,
    "epochs": [(epoch, loss, hit, ndcg, s)], "test": (hit, ndcg) or None,
    "seconds": wall})."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.run([*launcher, "-m", "iisan_tpu_torch.cli", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stderr.splitlines()
    if proc.returncode != 0:
        print("\n".join(lines[-40:]), file=sys.stderr)
        raise AssertionError(f"phase {phase} {what}: the command line exited "
                             f"{proc.returncode}")
    out = {"seconds": seconds, "launches": None, "epochs": [], "test": None}
    for line in lines:
        m = re.search(r"epoch (\d+) loss (\S+) valid Hit10 (\S+) nDCG10 (\S+) "
                      r"\((\S+)s\)", line)
        if m:
            out["epochs"].append((int(m[1]), float(m[2]), float(m[3]) / 100,
                                  float(m[4]) / 100, float(m[5])))
        m = re.search(r"test_results\s+(\S+)\s+(\S+)", line)
        if m:
            out["test"] = (float(m[1]) / 100, float(m[2]) / 100)
        if "kernel launches: " in line:
            out["launches"] = json.loads(line.split("kernel launches: ", 1)[1])
    if out["launches"] is None:
        raise AssertionError(f"phase {phase} {what}: no launch counts in the log")
    return lines, out


def run_cli_path(device, counters, root: Path):
    """Phase 31: the run path from the command line over a Scientific-size
    dataset.  Returns the launches of the user-encoder kernels and #3."""
    import numpy as np
    import torch

    from iisan_tpu_torch.cli import parse_args
    from iisan_tpu_torch.serve import Recommender
    from iisan_tpu_torch.train.pipelines import run_from_config
    from iisan_tpu_torch.utils.checkpoint import latest_checkpoint
    from iisan_tpu_torch.utils.torch_import import save_reference_checkpoint
    from iisan_tpu_torch.utils.jax_params import export_jax_params

    t_phase = time.perf_counter()
    names = ("user_encoder_fwd", "user_encoder_bwd", "san_cascade_fwd")
    totals = dict.fromkeys(names, 0)

    def add(launches):
        for k in names:
            totals[k] += launches[k]

    t0 = time.perf_counter()
    nbytes = write_cli_dataset(device, root)
    log(f"phase 31 dataset: {ITEMS} items, {USERS} users (TSVs) and two fp16 stores "
        f"({ITEMS + 1}, 13, {TAP_DIM}): {nbytes} bytes written in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = -(-USERS // 64)

    # train from the command line
    rec_path = root / "rec.npz"
    _, train = run_cli(cli_args(device, root, "cli", "--epoch", str(CLI_EPOCHS),
                                "--export_recommender", str(rec_path)), "train")
    add(train["launches"])
    ckpt_dir = root / "cli" / "ckpt"
    latest = latest_checkpoint(str(ckpt_dir))
    losses = [e[1] for e in train["epochs"]]
    log(f"phase 31 CLI train (cached, bench.py's settings, {CLI_EPOCHS} epochs of "
        f"{steps} steps): process wall {train['seconds']:.2f} s; "
        + "; ".join(f"epoch {e} host {s:.3f} s (the loop's epoch_times), loss "
                    f"{loss:.5f}, valid HR@10 {h:.6f} nDCG@10 {n:.6f}"
                    for e, loss, h, n, s in train["epochs"])
        + f"; checkpoint {latest}; launches {nonzero(train['launches'])}")
    if (len(losses) != CLI_EPOCHS or not np.isfinite(losses).all()
            or latest is None or not rec_path.is_file()):
        raise AssertionError(f"phase 31 train: epochs {train['epochs']}, checkpoint "
                             f"{latest}, artifact {rec_path.is_file()}")
    if (train["launches"]["user_encoder_bwd"] != CLI_EPOCHS * steps
            or train["launches"]["user_encoder_fwd"] < CLI_EPOCHS * steps):
        raise AssertionError(f"phase 31 train: launches {train['launches']}")
    # in this process: 2 uninterrupted epochs against 1 + resume + 1
    cfg, _ = parse_args(cli_args(device, root, "a"))

    def in_process(name, **kw):  # (trainer, TrainResult, launches)
        (tr, res), launches = counted(counters, lambda: run_from_config(
            cfg.replace(ckpt_dir=str(root / name), **kw), device=device))
        add(launches)
        return tr, res, launches

    t0 = time.perf_counter()
    straight = in_process("straight", epoch=2)[0]
    in_process("split", epoch=1)
    split = in_process("split", epoch=1, load_ckpt_name="epoch-1")[0]
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(straight.model.parameters(), split.model.parameters())]
    moments = [float((sa[k] - sb[k]).abs().max())
               for sa, sb in zip(straight.optimizer.state.values(),
                                 split.optimizer.state.values())
               for k in ("exp_avg", "exp_avg_sq")]
    log(f"phase 31 resume in-process (run_from_config, 2 epochs vs 1 + checkpoint + "
        f"resume + 1, {time.perf_counter() - t0:.2f} s): max |diff| over "
        f"{len(diffs)} parameters {max(diffs):.6g}, over the Adam moments "
        f"{max(moments):.6g}")
    if max(diffs) != 0.0 or max(moments) != 0.0:
        raise AssertionError("phase 31: the resumed run is not the uninterrupted one")
    del straight, split
    torch.cuda.empty_cache()

    # test mode re-exports; its artifact is the resumed trainer's
    test_path = root / "rec_test.npz"
    _, tested = run_cli(cli_args(device, root, "cli", "--mode", "test", "--load_ckpt_name",
                                 latest, "--export_recommender", str(test_path)),
                        "test mode")
    add(tested["launches"])
    loaded, launches = counted(counters, lambda: run_from_config(
        cfg.replace(ckpt_dir=str(ckpt_dir), load_ckpt_name=latest, epoch=0),
        device=device)[0])
    add(launches)
    mine = root / "rec_in_process.npz"
    Recommender.from_trainer(loaded).save(str(mine))
    corpus = loaded.corpus
    requests = {b: [row[row > 0].tolist() for row in corpus.test_history[:b]]
                for b in (1, 32, 256)}
    with np.load(test_path) as za, np.load(mine) as zb:
        if za.files != zb.files or not all(np.array_equal(za[k], zb[k])
                                           for k in za.files):
            raise AssertionError("phase 31 test mode: the CLI's artifact is not the "
                                 "in-process export")
    a = Recommender.load(str(test_path), device=device)
    b = Recommender.load(str(mine), device=device)
    for n, seqs in requests.items():
        ids_a, ids_b = a.top_k(seqs, k=10)[0], b.top_k(seqs, k=10)[0]
        if not np.array_equal(ids_a, ids_b) or ids_a.min() < 1:
            raise AssertionError(f"phase 31 test mode: top_k ids differ at batch {n}")
    source = loaded.evaluate_split("test")
    if tested["test"] is None or max(
            abs(t - s) for t, s in zip(tested["test"], source)) > 1e-7:
        raise AssertionError(f"phase 31 test mode: {tested['test']} vs {source}")
    log(f"phase 31 CLI test mode ({latest}): test HR@10 {tested['test'][0]:.6f} "
        f"nDCG@10 {tested['test'][1]:.6f} (in this process {source[0]:.6f} / "
        f"{source[1]:.6f}); the re-exported artifact is bit-equal to "
        f"Recommender.from_trainer(resumed trainer).save, and its top_k ids at batch "
        f"1, 32 and 256 equal those of that export")

    # a warm start from a reference-layout .pt of the trained model
    pt = root / "epoch-9.pt"
    save_reference_checkpoint(export_jax_params(loaded.model), str(pt))
    warm, launches = counted(counters, lambda: run_from_config(
        cfg.replace(ckpt_dir=str(root / "warm"), pretrained_recsys_model=str(pt),
                    mode="test"), eval_only=True, device=device)[0])
    add(launches)
    got = warm.evaluate_split("test")
    log(f"phase 31 warm start from a reference .pt (--pretrained_recsys_model, "
        f"--mode test): test HR@10 {got[0]:.6f} nDCG@10 {got[1]:.6f}, the source "
        f"trainer's {source[0]:.6f} / {source[1]:.6f}")
    if got != source:
        raise AssertionError("phase 31: the warm start serves other numbers")
    del loaded, warm, a, b
    torch.cuda.empty_cache()

    # --use_pallas true (one cached epoch through #3) and --item_tower id
    # (CLI_EPOCHS epochs, the export and top_k) in this process: the flags'
    # parsing is the CPU tests' (tests/test_torch_cli.py), and a process
    # start-up costs more here than the epoch it runs
    _, res, pallas = in_process("pallas", epoch=1, use_pallas=True, save_checkpoints=False)
    log(f"phase 31 --use_pallas true (run_from_config): epoch host "
        f"{res.epoch_times[0]:.3f} s, loss {res.losses[0]:.5f}; launches {nonzero(pallas)} "
        f"({2 * steps} of san_cascade_fwd in the steps, the rest building item tables)")
    if pallas["san_cascade_fwd"] < 2 * steps:
        raise AssertionError(f"phase 31 use_pallas: launches {pallas}")
    id_path = root / "id.npz"
    _, res, ided = in_process("id", epoch=CLI_EPOCHS, item_tower="id",
                              export_recommender=str(id_path))
    rec = Recommender.load(str(id_path), device=device)
    for n, seqs in requests.items():
        ids = rec.top_k(seqs, k=10)[0]
        hist = [set(s) for s in seqs]
        if ids.shape != (n, 10) or ids.min() < 1 or any(
                set(row) & h for row, h in zip(ids.tolist(), hist)):
            raise AssertionError(f"phase 31 id: top_k at batch {n}: {ids[:2]}")
    log(f"phase 31 --item_tower id (run_from_config, {CLI_EPOCHS} epochs): "
        + "; ".join(f"epoch {e + 1} host {t:.3f} s, loss {loss:.5f}, valid HR@10 {h:.6f}"
                    for e, (t, loss, (h, _)) in enumerate(zip(res.epoch_times, res.losses,
                                                              res.valid_history)))
        + f"; table {tuple(rec.fused_table.shape)}, top_k at batch 1, 32, 256 "
        f"(history excluded); launches {nonzero(ided)}")
    if ided["user_encoder_bwd"] != CLI_EPOCHS * steps or not np.isfinite(res.losses).all():
        raise AssertionError(f"phase 31 id: {res.losses} {ided}")
    log(f"phase 31 wall time {time.perf_counter() - t_phase:.2f} s; launches {totals}")
    return totals


# Phase 32: the real-data image stores.  One LMDB holds the uncached
# cell's 800 items and the cache build's catalogue of 1,024, each a seeded
# random original of 500 x 375 (not square and larger than 224, so the
# resize does real work); the users are STORE_USERS (8 steps of 64: cut
# from 32 to keep the run's time).
STORE_ITEMS, STORE_TRAIN_ITEMS, STORE_USERS = 1024, 800, 512
STORE_SHAPE = (375, 500, 3)
FEED_BATCHES = 6  # the first one (pool start-up) is not timed
FED_WARM, FED_TIMED = 2, 5  # fed steps before and in each timed window (cut from 4, 10)
FIXTURES = ROOT / "iisan_tpu_torch" / "data" / "fixtures"


def image_inventory():
    """This machine's image libraries: Pillow, pandas and lmdb (versions or
    "missing"), g++, and libjpeg as the port's JPEG decoder finds it (its
    build error's first line where it does not build)."""
    import importlib
    import shutil

    from iisan_tpu_torch.data import fastimage

    out = {}
    for mod in ("PIL", "pandas", "lmdb"):
        try:
            out[mod] = getattr(importlib.import_module(mod), "__version__", "present")
        except ImportError:
            out[mod] = "missing"
    gxx = shutil.which("g++")
    out["g++"] = subprocess.run([gxx, "-dumpfullversion"], capture_output=True,
                                text=True).stdout.strip() if gxx else "missing"
    out["Pillow's bundled libjpeg"] = fastimage.pillow_libjpeg() or "none"
    try:
        out["libjpeg"] = "the port's JPEG decoder built against " + fastimage.route()
    except fastimage.DecoderUnavailable as e:
        out["libjpeg"] = "missing: " + str(e).splitlines()[0]
    return out


def write_image_dataset(root: Path):
    """Phase 32's dataset: ``ds/items.tsv`` (the 800 training items),
    ``ds/users.tsv`` (STORE_USERS users of 5-13 items), a BERT vocabulary
    for the port's tokenizer, and ``ds/image.lmdb`` written by the port's
    LMDB backend (STORE_ITEMS records in the reference layout, one
    commit).  Returns (seconds to write the LMDB, its bytes)."""
    import pickle

    import numpy as np

    from iisan_tpu_torch.data import images

    rng = np.random.default_rng(SEED)
    ds = root / "ds"
    ds.mkdir(parents=True)
    with open(ds / "items.tsv", "w") as f:
        f.writelines(f"I{i:05d}\tTitle of item {i}\n" for i in range(STORE_TRAIN_ITEMS))
    lengths = rng.integers(5, SEQ_LEN + 4, STORE_USERS)
    stream = np.concatenate([rng.permutation(STORE_TRAIN_ITEMS), rng.integers(
        0, STORE_TRAIN_ITEMS, int(lengths.sum()) - STORE_TRAIN_ITEMS)])
    rng.shuffle(stream)
    with open(ds / "users.tsv", "w") as f:
        for u, seq in enumerate(np.split(stream, np.cumsum(lengths)[:-1])):
            f.write(f"U{u}\t" + " ".join(f"I{i:05d}" for i in seq) + "\n")
    vocab = root / "pretrained_models" / "bert" / "bert_base_uncased"
    vocab.mkdir(parents=True)
    (vocab / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title", "of", "item"]
        + [str(d) for d in range(10)] + [f"##{d}" for d in range(10)]) + "\n")
    path = ds / "image.lmdb"
    t0 = time.perf_counter()
    env = images.lmdb.open(str(path), subdir=False, map_size=2 ** 40)
    names = [f"I{i:05d}" for i in range(STORE_ITEMS)]
    with env.begin(write=True) as txn:
        for name in names:
            img = rng.integers(0, 256, STORE_SHAPE, dtype=np.uint8)
            txn.put(name.encode(), pickle.dumps(images.LMDBImage(img, name)))
        txn.put(b"__keys__", pickle.dumps([n.encode() for n in names]))
        txn.put(b"__len__", pickle.dumps(len(names)))
    env.close()
    return time.perf_counter() - t0, path.stat().st_size


def check_jpeg_paths(root: Path, inventory, smi):
    """The JPEG side: with Pillow here, the fixtures copied under the 800
    training names (and one listed name without a file) go through
    ``python -m iisan_tpu_torch.tools.build_lmdb``; its records must hold
    the pixels Pillow decodes from each fixture, and its report the
    missing name.  The directory store decodes with the port's libjpeg
    build: where that is missing, routing the directory must raise the
    decoder's named error."""
    import shutil

    import numpy as np

    from iisan_tpu_torch.data import fastimage, images

    jpgs = root / "jpgs"
    jpgs.mkdir()
    fixtures = sorted(FIXTURES.glob("*.jpg"))
    names = [f"I{i:05d}" for i in range(STORE_TRAIN_ITEMS)]
    for i, name in enumerate(names):
        shutil.copyfile(fixtures[i % len(fixtures)], jpgs / f"{name}.jpg")
    if inventory["PIL"] == "missing":
        log("phase 32: no JPEG decoder for build_lmdb on this machine (Pillow is "
            "missing); the build-lmdb command line is not run")
    else:
        (root / "jpg_items.tsv").write_text(
            "".join(f"{n}\tTitle\n" for n in names + ["I_MISSING"]))
        out = root / "jpeg.lmdb"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "iisan_tpu_torch.tools.build_lmdb", "--items",
             str(root / "jpg_items.tsv"), "--images", str(jpgs), "--out", str(out),
             "--bad-report", str(root / "bad.tsv")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "done; 1 bad files" not in proc.stdout:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError("phase 32: the build-lmdb command line failed")
        if (root / "bad.tsv").read_text() != "I_MISSING\n":
            raise AssertionError("phase 32: wrong bad-file report")
        from PIL import Image

        env = images.lmdb.open(str(out), subdir=False, readonly=True)
        with env.begin() as txn:
            for i, fx in enumerate(fixtures):
                with Image.open(fx) as im:
                    want = np.asarray(im.convert("RGB"))
                got = images.load_record(txn.get(names[i].encode())).get_image()
                if not np.array_equal(got, want):
                    raise AssertionError(f"phase 32: record {names[i]} is not {fx.name}")
        env.close()
        log(f"phase 32 build-lmdb command line: {len(names)} JPEGs (copies of "
            f"{len(fixtures)} 500 x 375 fixtures, one grayscale) + 1 missing in "
            f"{seconds:.2f} s (process wall), {out.stat().st_size:,} bytes; "
            f"records equal Pillow's decode of each fixture; bad-file report "
            f"I_MISSING ({smi})")
    log(f"phase 32 JPEG directory store: {jpeg_route(images.open_image_source(str(jpgs), 224))}")


def jpeg_route(store) -> str:
    """Which decoder a ``DirImageStore`` runs: the libjpeg the port's
    decoder links, or Pillow where none was found."""
    from iisan_tpu_torch.data import fastimage

    if store.native:
        return f"the port's decoder (csrc/fastimage.cc) linked against {fastimage.route()}"
    return "Pillow's decode and bilinear resize for every image (no libjpeg found)"


def feed_ms(store, name_batches, threads: int) -> float:
    """Host ms a batch of ``ParallelImageLoader`` over ``store`` on
    ``threads`` threads, with nothing consuming but the loop: the feed
    alone (the first batch, the pool's start, untimed)."""
    from iisan_tpu_torch.data.images import ParallelImageLoader

    loader = ParallelImageLoader(store, num_threads=threads)
    it = loader.iter_batches(name_batches)
    next(it)
    t0 = time.perf_counter()
    n = sum(1 for _ in it)
    loader.pool.shutdown()
    return (time.perf_counter() - t0) / n * 1e3


def feed_split(store, names):
    """Host ms an image, on one thread, of the LMDB read, the unpickle and
    the rest of ``store.get`` (Pillow's resize), over ``names``."""
    from iisan_tpu_torch.data.images import load_record

    read = unpickle = whole = 0.0
    for name in names:
        t0 = time.perf_counter()
        with store.env.begin() as txn:
            raw = txn.get(store.key(name))
        t1 = time.perf_counter()
        load_record(raw).get_image()
        t2 = time.perf_counter()
        store.get(name)
        t3 = time.perf_counter()
        read, unpickle, whole = read + t1 - t0, unpickle + t2 - t1, whole + t3 - t2
    n = len(names) / 1e3
    return read / n, unpickle / n, (whole - read - unpickle) / n


def fed_profile(tr, batch, warm: int, timed: int):
    """P9 traced on the fed steps themselves: one pass of the trainer's
    epoch-2 order through its own ``ParallelImageLoader``, stepped as
    ``run_epoch`` steps it.  After ``warm`` steps (the loader's prefetch
    filled), ``timed`` steps untraced, then ``timed`` under the profiler;
    each window starts and ends synchronised.  Returns ms per step: the
    untraced and the traced window's wall time, the device-busy time from
    the trace, and the launching thread's split of the traced window into
    waiting for the loader, the four uploads and the ``train_step`` call;
    and the ``train_step`` call's median on the staged ``batch`` with the
    loader idle (the launches alone, the device drained first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    c = tr.corpus
    perm = tr.epoch_permutation(2)[: warm + 2 * timed]
    flat = [c.train_seqs[p].reshape(-1) for p in perm]
    it = tr.loader.iter_batches([tr._names(f) for f in flat])

    def steps(lo, hi):
        wait = put = call = 0.0
        for p, f in zip(perm[lo:hi], flat[lo:hi]):
            t0 = time.perf_counter()
            imgs = next(it)
            t1 = time.perf_counter()
            args = (tr._put(c.train_seqs[p]), tr._put(imgs),
                    tr._put(tr.token_table[f]), tr._put(c.train_log_mask[p]))
            t2 = time.perf_counter()
            tr.train_step(*args)
            t3 = time.perf_counter()
            wait, put, call = wait + t1 - t0, put + t2 - t1, call + t3 - t2
        return wait / timed * 1e3, put / timed * 1e3, call / timed * 1e3

    launches = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(*batch)
        launches.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    steps(0, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(warm, warm + timed)
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) / timed * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        split = steps(warm + timed, warm + 2 * timed)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / timed * 1e3
    if next(it, None) is not None:
        raise AssertionError("fed_profile: the loader gave more batches than asked")
    families, _ = kernel_families(prof, timed)
    return dict(untraced=untraced, traced=traced, busy=sum(families.values()),
                wait=split[0], put=split[1], call=split[2],
                staged_call=sorted(launches)[1])


def product_count(fn) -> int:
    """2 M K N for every matrix product PyTorch dispatches while ``fn``
    runs (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``convolution``): a
    count independent of ``utils/flops.py`` and of ``FlopCounterMode``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class ProductCount(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            op = func.overloadpacket
            if op in (aten.mm, aten.bmm, aten.addmm, aten.baddbmm):
                a, b = args[:2] if op in (aten.mm, aten.bmm) else args[1:3]
                batch = a.shape[0] if a.dim() == 3 else 1
                self.total += 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
            elif op is aten.convolution:
                self.total += 2 * out.numel() * args[1][0].numel()
            return out

    with ProductCount() as counter:
        fn()
    return counter.total


def device_bench_batch(tr):
    """The batch ``UncachedTrainer.device_bench`` stages, made again."""
    import numpy as np

    cfg, c = tr.cfg, tr.corpus
    bs, L, R = cfg.batch_size, cfg.max_seq_len, cfg.CV_resize
    seqs = np.resize(c.train_seqs, (bs, L + 1))
    images = np.random.default_rng(0).integers(0, 256, (bs * (L + 1), R, R, 3), np.uint8)
    return (tr._put(seqs), tr._put(images), tr._put(tr.token_table[seqs.reshape(-1)]),
            tr._put(np.resize(c.train_log_mask, (bs, L))))


def run_image_stores(device, counters, root: Path, smi: str, staged_busy: float,
                     synthetic_per_1000: float):
    """Phase 32: the real-data image stores; ``staged_busy`` and
    ``synthetic_per_1000`` are phase 8's step and phase 27's ViT-base
    build (ms per 1,000 synthetic images) of this run.  Returns the
    launches of the uncached command line, the cache build and
    ``device_bench``."""
    import math

    import numpy as np
    import torch

    from iisan_tpu_torch import cache_builder as cb
    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.images import LmdbImageStore, open_image_source
    from iisan_tpu_torch.train.pipelines import _image_store, load_corpus
    from iisan_tpu_torch.train.uncached import UncachedTrainer

    inv = image_inventory()
    log("phase 32 inventory: " + "; ".join(f"{k} {v}" for k, v in inv.items()))
    lmdb_s, lmdb_bytes = write_image_dataset(root)
    log(f"phase 32 LMDB: {STORE_ITEMS} records of {STORE_SHAPE[1]} x {STORE_SHAPE[0]} "
        f"uint8 written by the port's backend in {lmdb_s:.2f} s ({lmdb_bytes:,} bytes; "
        f"{smi})")
    check_jpeg_paths(root, inv, smi)

    fields = dict(UNCACHED_CFG, pipeline="uncached", root_data_dir=str(root),
                  dataset="ds", behaviors="users.tsv", news="items.tsv",
                  lmdb_data="image.lmdb")
    args = dict(fields, device=device, ckpt_dir=str(root / "ckpt"),
                log_dir=str(root / "logs"))
    lines, cli = run_cli([a for k, v in args.items() for a in (f"--{k}", str(v))],
                         "uncached train from the LMDB", phase=32)
    cfg = IISANConfig(**fields)
    corpus, tokens = load_corpus(cfg)
    steps = math.ceil(corpus.n_users / cfg.batch_size)
    tables = len(cli["epochs"]) + sum("test Hit10" in ln for ln in lines)
    per_step = cfg.text_layers + cfg.image_layers  # #5 once a tower layer
    per_table = per_step * math.ceil((corpus.item_num + 1) / 256)
    launches = cli["launches"]
    mha_per_step = (launches["mha_fwd"] - per_table * tables) / steps
    (_, loss, hit, ndcg, epoch_s), = cli["epochs"]
    fed_ms = epoch_s / steps * 1e3

    store = _image_store(cfg)
    if not isinstance(store, LmdbImageStore):
        raise AssertionError(f"phase 32: run_from_config routed to {type(store).__name__}")
    tr = UncachedTrainer(cfg, corpus, tokens, store, device=device)
    perm = tr.epoch_permutation(1)
    name_batches = [tr._names(corpus.train_seqs[p].reshape(-1))
                    for p in perm[:FEED_BATCHES]]
    feed = {n: feed_ms(store, name_batches, n) for n in (cfg.num_workers, 8)}
    split = feed_split(store, [n for n in name_batches[0] if n is not None][:128])
    batch = staged_batch(tr, 0)
    host, busy, families = uncached_breakdown(tr, batch, 5)
    fed = fed_profile(tr, batch, FED_WARM, FED_TIMED)
    log(f"phase 32 CLI uncached IISAN from the LMDB (scripts/bench_uncached.py's "
        f"geometry, BERT-base x ViT-base, batch 64, {STEP_ROWS} images a step): "
        f"{steps} steps in {epoch_s:.3f} s, {fed_ms:.1f} ms a step with the feed "
        f"(host clock, {cfg.num_workers} loader threads); loss {loss:.5f}, valid "
        f"HR@10 {hit:.6f} nDCG@10 {ndcg:.6f}; mha_fwd {mha_per_step:.1f} a step "
        f"({launches['mha_fwd']} over {steps} steps and {tables} item tables of "
        f"{per_table}); launches {nonzero(launches)} ({smi})")
    log(f"phase 32 P9: the feed alone (LMDB read, unpickle, Pillow's bilinear "
        f"resize to 224) {feed[cfg.num_workers]:.1f} ms a batch of {STEP_ROWS} on "
        f"{cfg.num_workers} threads, {feed[8]:.1f} ms on 8 (one thread, an image: "
        f"LMDB read {split[0]:.3f} ms, unpickle {split[1]:.3f}, resize "
        f"{split[2]:.3f}); the staged step "
        f"host {host:.2f} ms, device-busy {busy:.2f} ms (phase 8: "
        f"{staged_busy:.2f}) ({smi})")
    log(f"phase 32 P9 traced on fed steps (this trainer, its {cfg.num_workers}-thread "
        f"loader, {FED_WARM} steps' warm-up, {FED_TIMED} steps a window): "
        f"{fed['untraced']:.1f} ms a step untraced, {fed['traced']:.1f} traced, "
        f"device-busy {fed['busy']:.2f} ms a step in the trace: device idle "
        f"{100 * (1 - fed['busy'] / fed['traced']):.1f}% of a fed step; the launching "
        f"thread a step: waiting for the loader {fed['wait']:.1f} ms, the uploads "
        f"{fed['put']:.1f}, the train_step call {fed['call']:.1f} (on the staged "
        f"batch with the loader idle: {fed['staged_call']:.1f}) ({smi})")
    if (mha_per_step != per_step or launches["user_encoder_bwd"] != steps
            or not (np.isfinite(loss) and 0 <= ndcg <= hit <= 1)):
        raise AssertionError(f"phase 32 CLI: launches {launches}, expected {per_step} "
                             f"mha_fwd and one user_encoder_bwd a step; loss {loss}, "
                             f"HR@10 {hit}")

    names = ["<pad>"] + [f"I{i:05d}" for i in range(STORE_ITEMS)]
    source = open_image_source(str(root / "ds" / "image.lmdb"), cfg.CV_resize)
    vit = tr.model.image_tower.vit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    built, build_launches = counted(counters, lambda: cb.build_image_cache(
        vit, names, source, str(root / "vit_outputs.memmap"), batch=CACHE_BATCH,
        device=device))
    torch.cuda.synchronize()
    per_1000 = (time.perf_counter() - t0) / STORE_ITEMS * 1e6
    cb.verify_cache(built, *cb.state_geometry(vit), first_row=1)
    rows = built.load_full()
    want_mha = vit.num_layers * math.ceil(STORE_ITEMS / CACHE_BATCH)
    # two batches again under the profiler: does the device wait on the feed?
    (p_host, p_busy, _), p_launches = counted(counters, lambda: build_profile(
        lambda: cb.build_image_cache(vit, names, source, str(root / "profiled.memmap"),
                                     batch=CACHE_BATCH, end_item=1 + 2 * CACHE_BATCH,
                                     device=device)))
    build_launches = {k: v + p_launches[k] for k, v in build_launches.items()}
    log(f"phase 32 ViT-base image cache from the LMDB (--image-source routing, "
        f"{STORE_ITEMS} items, batch {CACHE_BATCH}): {per_1000:.1f} ms per 1,000 items "
        f"(host clock; phase 27's synthetic images: {synthetic_per_1000:.1f}); rows "
        f"{tuple(rows.shape)}; 2 batches under the profiler: host {p_host * 1e3:.1f} "
        f"ms, device-busy {p_busy:.2f} ms (idle {1 - p_busy / (p_host * 1e3):.1%}); "
        f"mha_fwd {build_launches['mha_fwd']} ({smi})")
    want_mha += vit.num_layers * 2
    if (build_launches["mha_fwd"] != want_mha or not np.isfinite(rows).all()
            or rows[0].any() or not rows[1:].any()):
        raise AssertionError(f"phase 32 cache build: launches {build_launches}, "
                             f"finite {np.isfinite(rows).all()}")

    bench, bench_launches = counted(counters, lambda: tr.device_bench(10))
    tflops = bench["flops_per_step"] / bench["seconds_per_step"] / 1e12
    # device_bench's count (the counter's plus the kernels' from their
    # shapes) against the products of one step of its batch on the module
    # route, where every product goes through the dispatcher.  The kernel
    # route does more by one user-encoder forward (#2 recomputes it),
    # under 1e-5 of the step.
    routes = {m: m.fused for m in tr.model.modules() if hasattr(m, "fused")}
    set_fused(tr.model, False)
    plain_flops, plain_launches = counted(counters, lambda: product_count(
        lambda: tr.train_step(*device_bench_batch(tr))))
    for m, fused in routes.items():
        m.fused = fused
    log(f"phase 32 device_bench(10) at batch {cfg.batch_size}: seconds_per_step "
        f"{bench['seconds_per_step']:.6f}, flops_per_step {bench['flops_per_step']:.6g}, "
        f"users_per_sec {bench['users_per_sec']:.2f}, memory_bytes "
        f"{bench['memory_bytes']:,}; {tflops:.2f} TFLOP/s = "
        f"{100 * tflops * 1e12 / PEAK_BF16_FLOPS:.2f}% of 989; the module route's "
        f"products of one step {plain_flops:.6g} (device_bench's count "
        f"{100 * (bench['flops_per_step'] / plain_flops - 1):+.4f}%) (staged step "
        f"device-busy, phase 8: {staged_busy:.2f} ms; {bench['device']}; {smi})")
    if not (all(np.isfinite(bench[k]) and bench[k] > 0 for k in (
            "seconds_per_step", "flops_per_step", "users_per_sec", "memory_bytes"))
            and bench_launches["mha_fwd"] == per_step * 12
            and abs(bench["flops_per_step"] - plain_flops) <= 0.01 * plain_flops
            and not any(plain_launches.values())):
        raise AssertionError(f"phase 32 device_bench: {bench}, launches {bench_launches}, "
                             f"module-route products {plain_flops}, launches "
                             f"{nonzero(plain_launches)}")
    del tr, vit
    torch.cuda.empty_cache()
    totals = {c.__name__: build_launches[c.__name__] + bench_launches[c.__name__]
              + launches.get(c.__name__, 0) for c in counters}
    return totals


# Phase 33: int8 and sharded serving, and training on torch.distributed
# ranks.  One process under torchrun (the card takes one NCCL rank).
TORCHRUN = (sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1")
SERVE_BIG = 4_000_000  # rows of the large synthetic catalogue
SERVE_TOL = 1e-5  # int8 scores against dense scoring of the dequantised table
JPEG_USERS, JPEG_ITEMS = 320, 200  # 5 uncached steps of 64


def topk_mismatch(got, want, tol=SERVE_TOL):
    """Where two top-K answers differ other than by ties: scores past
    ``tol`` relative, or an id whose score ties with no id of the other at
    its position.  Returns a message or None."""
    import numpy as np

    (gi, gs), (wi, ws) = got, want
    if not np.allclose(gs, ws, rtol=tol, atol=1e-6):
        return f"scores differ by up to {np.abs(gs - ws).max():.3g}"
    for row in range(len(gi)):
        for j in np.flatnonzero(gi[row] != wi[row]):
            tied = np.isclose(ws[row], ws[row, j], rtol=tol, atol=1e-6)
            if gi[row, j] not in wi[row][tied]:
                return f"row {row}: ids {gi[row].tolist()} vs {wi[row].tolist()}"
    return None


def serve_profile(rec, requests):
    """top_k at each batch: (host-clock median ms, device-busy ms), the
    table's resident bytes, and the extra peak bytes of a batch-256 call."""
    import torch

    out = {b: (host_timed(lambda s=seqs: rec.top_k(s, k=10), 20),
               device_ms(lambda s=seqs: rec.top_k(s, k=10), 10))
           for b, seqs in requests.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec.top_k(requests[256], k=10)
    torch.cuda.synchronize()
    return out, rec.table_bytes, torch.cuda.max_memory_allocated() - base


def compare_int8(dense, quant, requests, name, smi):
    """fp32 against int8 serving of one catalogue; the int8 answers against
    dense scoring of the dequantised table."""
    from iisan_tpu_torch.ops.quant import dequantize
    from iisan_tpu_torch.serve import Recommender

    deq = Recommender(dense.model, dequantize(quant.fused_table)[:, 0, :],
                      dense.max_seq_len)
    for b, seqs in requests.items():
        bad = topk_mismatch(quant.top_k(seqs, k=10), deq.top_k(seqs, k=10))
        if bad:
            raise AssertionError(f"phase 33 {name} int8 vs dequantised at batch {b}: {bad}")
    del deq
    rows = []
    for label, rec in (("fp32", dense), ("int8", quant)):
        times, resident, peak = serve_profile(rec, requests)
        rows.append(f"{label}: " + ", ".join(
            f"batch {b} {t:.3f} ms host / {d:.4f} ms device-busy"
            for b, (t, d) in times.items())
            + f"; table resident {resident:,} bytes; batch-256 call peak +{peak:,} bytes")
    log(f"phase 33 serving {name} ({dense.n_rows:,} rows x {EMB}, {BLOCKS} blocks, "
        f"L={SEQ_LEN}): " + " | ".join(rows) + f"; int8 ids equal dense scoring of the "
        f"dequantised table up to ties, scores within {SERVE_TOL} ({smi})")


def write_jpeg_dataset(root: Path):
    """A JPEG directory of JPEG_ITEMS items (copies of the fixtures), its
    items and users TSVs (JPEG_USERS users of 5-13 items) and a BERT
    vocabulary, under ``root``; returns the dataset directory's name."""
    import shutil

    import numpy as np

    rng = np.random.default_rng(SEED)
    ds = root / "jds"
    (ds / "jpgs").mkdir(parents=True)
    fixtures = sorted(FIXTURES.glob("*.jpg"))
    names = [f"J{i:04d}" for i in range(JPEG_ITEMS)]
    for i, name in enumerate(names):
        shutil.copyfile(fixtures[i % len(fixtures)], ds / "jpgs" / f"{name}.jpg")
    (ds / "items.tsv").write_text("".join(f"{n}\tTitle of item {i}\n"
                                          for i, n in enumerate(names)))
    with open(ds / "users.tsv", "w") as f:
        for u in range(JPEG_USERS):
            seq = rng.integers(0, JPEG_ITEMS, int(rng.integers(5, SEQ_LEN + 4)))
            f.write(f"U{u}\t" + " ".join(names[i] for i in seq) + "\n")
    vocab = root / "pretrained_models" / "bert" / "bert_base_uncased"
    vocab.mkdir(parents=True)
    (vocab / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title", "of", "item"]
        + [str(d) for d in range(10)] + [f"##{d}" for d in range(10)]) + "\n")
    return ds.name


def run_parallel(device, counters, root: Path, smi: str):
    """Phase 33: int8 and sharded serving, and training on one NCCL rank.
    Returns the launches of the user-encoder kernels and #5."""
    import signal
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from iisan_tpu_torch.cli import parse_args
    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.serve import Recommender, ShardedRecommender
    from iisan_tpu_torch.train.pipelines import _image_store, run_from_config

    t_phase = time.perf_counter()
    names = tuple(c.__name__ for c in counters)
    totals = dict.fromkeys(names, 0)

    def add(launches):
        for k in names:
            totals[k] += launches.get(k, 0)

    write_cli_dataset(device, root)
    steps = -(-USERS // 64)

    # one cached epoch without a mesh, then at data:1 through torchrun
    plain_path, ranked_path = root / "plain.npz", root / "ranked.npz"
    cfg, _ = parse_args(cli_args(device, root, "plain"))
    (tr, res), launches = counted(counters, lambda: run_from_config(cfg.replace(
        epoch=1, save_checkpoints=False, export_recommender=str(plain_path)),
        device=device))
    add(launches)
    corpus, plain_s = tr.corpus, res.epoch_times[0]
    del tr
    torch.cuda.empty_cache()
    _, ranked = run_cli(cli_args(device, root, "ranked", "--epoch", "1", "--mesh_shape",
                                 "data:1", "--save_checkpoints", "false",
                                 "--export_recommender", str(ranked_path)),
                        "torchrun --mesh_shape data:1", phase=33, launcher=TORCHRUN)
    add(ranked["launches"])
    with np.load(plain_path) as za, np.load(ranked_path) as zb:
        same = za.files == zb.files and all(np.array_equal(za[k], zb[k]) for k in za.files)
    (_, ranked_loss, _, _, ranked_s), = ranked["epochs"]
    log(f"phase 33 cached epoch at bench.py's settings ({steps} steps): without a mesh "
        f"(this process) {plain_s:.3f} s, {plain_s / steps * 1e3:.2f} ms a step, loss "
        f"{res.losses[0]:.5f}; torchrun --nproc_per_node 1 --mesh_shape data:1 (one NCCL "
        f"rank) {ranked_s:.3f} s, {ranked_s / steps * 1e3:.2f} ms a step, loss "
        f"{ranked_loss:.5f}, process wall {ranked['seconds']:.2f} s; exported artifacts "
        f"bit-equal: {same}; launches {nonzero(ranked['launches'])} ({smi})")
    if not same or f"{res.losses[0]:.5f}" != f"{ranked_loss:.5f}" or \
            ranked["launches"]["user_encoder_bwd"] != steps:
        raise AssertionError("phase 33: the data:1 epoch is not the unsharded one")

    # fp32 against int8 serving, at 20,826 and 4,000,000 rows
    requests = {b: [row[row > 0].tolist() for row in corpus.test_history[:b]]
                for b in (1, 32, 256)}
    dense = Recommender.load(str(plain_path), device=device)
    quant = dense.quantize_table()
    _, launches = counted(counters, lambda: compare_int8(
        dense, quant, requests, "Scientific", smi))
    add(launches)
    gen = torch.Generator(device=device).manual_seed(SEED)
    big = Recommender(dense.model, torch.randn((SERVE_BIG, EMB), generator=gen,
                                               device=device), SEQ_LEN)
    big_q = big.quantize_table()
    _, launches = counted(counters, lambda: compare_int8(
        big, big_q, requests, "4M-row catalogue", smi))
    add(launches)
    del big, big_q
    torch.cuda.empty_cache()

    # the command line's --quant int8 --save-as
    small = root / "small.npz"
    proc = subprocess.run([sys.executable, "-m", "iisan_tpu_torch.serve", str(plain_path),
                           "--quant", "int8", "--save-as", str(small)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError("phase 33: serve --quant int8 --save-as failed")
    served = Recommender.load(str(small), device=device)
    if not (torch.equal(served.fused_table.q, quant.fused_table.q)
            and torch.equal(served.fused_table.scale, quant.fused_table.scale)):
        raise AssertionError("phase 33: the --save-as table is not quantize_table's")
    for b, seqs in requests.items():
        if not np.array_equal(served.top_k(seqs, k=10)[0], quant.top_k(seqs, k=10)[0]):
            raise AssertionError(f"phase 33: the int8 artifact serves other ids at {b}")
    log(f"phase 33 serve --quant int8 --save-as: {small.stat().st_size:,} bytes against "
        f"{plain_path.stat().st_size:,} fp32; q and scales bit-equal to this process's "
        f"quantize_table, the same ids at batch 1, 32 and 256")

    # one NCCL rank in this process: sharded serving, 5 uncached steps at data:1
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device_id=device)
    try:
        for label, rec in (("fp32", dense), ("int8", quant)):
            sharded = ShardedRecommender(rec)
            for b, seqs in requests.items():
                bad = topk_mismatch(sharded.top_k(seqs, k=10), rec.top_k(seqs, k=10))
                if bad:
                    raise AssertionError(f"phase 33 ShardedRecommender {label} at {b}: {bad}")
            ms = host_timed(lambda: sharded.top_k(requests[256], k=10), 10)
            log(f"phase 33 ShardedRecommender {label} on one NCCL rank: ids and scores "
                f"of Recommender.top_k at batch 1, 32 and 256; batch 256 {ms:.3f} ms "
                f"host ({smi})")
        jname = write_jpeg_dataset(root)
        jcfg = IISANConfig(**dict(UNCACHED_CFG, pipeline="uncached", root_data_dir=str(root),
                                  dataset=jname, behaviors="users.tsv", news="items.tsv",
                                  lmdb_data="jpgs", mesh_shape="data:1",
                                  save_checkpoints=False, ckpt_dir=str(root / "jckpt"),
                                  log_dir=str(root / "jlogs")))
        route = jpeg_route(_image_store(jcfg))
        t0 = time.perf_counter()
        (utr, ures), launches = counted(counters, lambda: run_from_config(jcfg, device=device))
        add(launches)
        useconds = time.perf_counter() - t0
        usteps = utr.epoch_permutation(1).shape[0]
        users = utr.corpus.n_users
        per_step = jcfg.text_layers + jcfg.image_layers
        log(f"phase 33 uncached IISAN at data:1 from a JPEG directory through "
            f"run_from_config (one NCCL rank; BERT-base x ViT-base, batch 64, "
            f"{users} users, {usteps} steps): {route}; epoch {ures.epoch_times[0]:.3f} s, "
            f"{ures.epoch_times[0] / usteps * 1e3:.1f} ms a step, loss {ures.losses[0]:.5f}, "
            f"valid HR@10 {ures.best_hit10:.6f}; run_from_config {useconds:.2f} s; launches "
            f"{nonzero(launches)} ({smi})")
        if (usteps != -(-users // 64) or usteps < 2
                or launches["user_encoder_bwd"] != usteps
                or launches["mha_fwd"] < per_step * usteps
                or not np.isfinite(ures.losses[0]) or utr.shard is None):
            raise AssertionError(f"phase 33 uncached data:1: {launches} {ures.losses}")
        del utr
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # --shard and --shard --http through torchrun
    inp, out = root / "requests.tsv", root / "recs.tsv"
    inp.write_text("".join(f"U{i}\t{' '.join(map(str, s))}\n"
                           for i, s in enumerate(requests[256])))
    t0 = time.perf_counter()
    proc = subprocess.run([*TORCHRUN, "-m", "iisan_tpu_torch.serve", str(plain_path),
                           "--shard", "--input", str(inp), "--out", str(out), "--k", "10"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError("phase 33: serve --shard under torchrun failed")
    rows = [line.split("\t") for line in out.read_text().splitlines()]
    got = (np.array([list(map(int, r[1].split())) for r in rows]),
           np.array([list(map(float, r[2].split())) for r in rows]))
    bad = topk_mismatch(got, dense.top_k(requests[256], k=10), tol=1e-4)
    if bad:
        raise AssertionError(f"phase 33 --shard: {bad}")
    log(f"phase 33 torchrun serve --shard ({len(rows)} users, one NCCL rank): the ids of "
        f"Recommender.top_k; process wall {time.perf_counter() - t0:.2f} s")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        http_port = sock.getsockname()[1]
    server = subprocess.Popen([*TORCHRUN, "-m", "iisan_tpu_torch.serve", str(plain_path),
                               "--shard", "--http", f"127.0.0.1:{http_port}"], cwd=ROOT,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        url = f"http://127.0.0.1:{http_port}"
        deadline = time.monotonic() + 180
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                    json.load(r)
                break
            except OSError:
                if server.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("phase 33: the --shard --http server did not start")
                time.sleep(0.5)
        for b, seqs in requests.items():
            body = post(url + "/recommend", {"sequences": seqs, "k": 10})
            bad = topk_mismatch((np.array(body["items"]), np.array(body["scores"])),
                                dense.top_k(seqs, k=10))
            if bad:
                raise AssertionError(f"phase 33 --shard --http at batch {b}: {bad}")
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.communicate()
    log("phase 33 torchrun serve --shard --http: the ids of Recommender.top_k at batch "
        f"1, 32 and 256; phase 33 wall time {time.perf_counter() - t_phase:.2f} s; "
        f"launches {totals} ({smi})")
    return totals


# Phase 34: the paper's efficiency table (TPME) over its six methods, then
# the canonical sweep launchers.
TPME_METHODS = ("iisan_cached", "iisan_uncached", "fft", "lora", "houlsby", "bitfit")
TPME_BWD = ("fft", "lora", "houlsby", "bitfit")  # the methods that train through #6
TPME_USERS = 32  # users of each uncached method's host-fed epoch: one batch


def run_tpme_report(out: Path, timeout: int = 600) -> None:
    """``python -m iisan_tpu_torch.tools.tpme_report --users TPME_USERS --out
    out`` in a session of its own (so that a timeout stops its method
    processes too); its output is printed only if it fails."""
    import os
    import signal

    proc = subprocess.Popen([sys.executable, "-m", "iisan_tpu_torch.tools.tpme_report",
                             "--users", str(TPME_USERS), "--out", str(out)], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"phase 34: the TPME report ran past {timeout} s")
    if proc.returncode != 0:
        print(stdout[-2000:], file=sys.stderr)
        print(stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"phase 34: the TPME report exited {proc.returncode}")


def check_tpme(report, published):
    """Phase 34's checks of ``TPME_torch.json``: every value finite, the six
    methods' trainable parameters those of ``TPME.json`` (``published``:
    label -> count), and the kernels of each method's path launched."""
    import math

    records = {r["label"]: r for r in report["records"]}
    if sorted(records) != sorted(TPME_METHODS):
        raise AssertionError(f"phase 34: records of {sorted(records)}")
    for label, r in records.items():
        values = [r["epoch_seconds"], r["trainable_params"], r["memory_bytes"],
                  report["tpme"][label]]
        if label != "iisan_cached":
            values += [r["epoch_seconds_e2e"], r["step_seconds"], r["tflops_per_step"]]
        if not all(v is not None and math.isfinite(v) for v in values):
            raise AssertionError(f"phase 34 {label}: a value is not finite: {values}")
        if r["trainable_params"] != published[label]:
            raise AssertionError(f"phase 34 {label}: {r['trainable_params']} trainable "
                                 f"parameters, TPME.json has {published[label]}")
        n = r["launches"]
        need = ["user_encoder_fwd", "user_encoder_bwd"]
        need += ["mha_fwd"] if label != "iisan_cached" else []
        need += ["mha_bwd"] if label in TPME_BWD else []
        if not all(n[k] > 0 for k in need):
            raise AssertionError(f"phase 34 {label}: launches {nonzero(n)}")
    return records


def run_tpme_and_sweeps(device, counters, root: Path, smi: str):
    """Phase 34: the TPME report over the six methods at the reference
    protocol (each method a process of its own), then ``run_iisan``'s
    Scientific sweep point for one epoch over phase 31's dataset, then the
    three launchers' dry runs.  Returns the launches of the phase's kernels
    (the report's processes' and this process's)."""
    import contextlib
    import io
    import math

    from iisan_tpu_torch import sweep
    from iisan_tpu_torch.tools import run_baselines, run_iisan, run_iisan_versa
    from iisan_tpu_torch.tools.datasets import DATASETS

    t_phase = time.perf_counter()
    names = tuple(c.__name__ for c in counters)
    totals = dict.fromkeys(names, 0)

    out = root / "tpme"
    run_tpme_report(out)
    report = json.loads((out / "TPME_torch.json").read_text())
    published = {r["label"]: r["trainable_params"]
                 for r in json.loads((ROOT / "TPME.json").read_text())["records"]}
    records = check_tpme(report, published)
    for r in records.values():
        for k in names:
            totals[k] += r["launches"].get(k, 0)
    scores = report["tpme"]
    log(f"phase 34 TPME (alpha {tuple(report['alpha'])}; lower is better; each method "
        f"a process of its own; {smi}; devices recorded: "
        f"{sorted({r['device'] for r in records.values()})}):")
    log(f"  {'method':<15}{'epoch_s':>12}{'epoch_s_e2e':>13}{'params':>14}"
        f"{'peak_bytes':>17}{'TPME':>8}  remat  step_ms  TFLOP/step")
    for label in sorted(records, key=scores.get):
        r = records[label]
        e2e, step, tflop = (r.get(k) for k in ("epoch_seconds_e2e", "step_seconds",
                                                "tflops_per_step"))
        log(f"  {label:<15}{r['epoch_seconds']:>12.4f}"
            f"{'-' if e2e is None else f'{e2e:.4f}':>13}{r['trainable_params']:>14,}"
            f"{r['memory_bytes']:>17,}{scores[label]:>8.4f}  {r.get('remat_towers', False)!s:<5}"
            f"  {'-' if step is None else f'{step * 1e3:.2f}':>7}"
            f"  {'-' if tflop is None else f'{tflop:.4f}'}")
    log("phase 34 TPME order: " + " < ".join(sorted(records, key=scores.get))
        + "; launches by method: "
        + "; ".join(f"{label} {nonzero(r['launches'])}" for label, r in records.items()))

    # run_iisan's Scientific point for one epoch, over phase 31's dataset
    # under the registry's file names
    t0 = time.perf_counter()
    write_cli_dataset(device, root)
    sci = DATASETS["scientific"]
    data = root / sci["dataset"]
    data.mkdir(parents=True)
    (data / sci["behaviors"]).symlink_to(root / "users.tsv")
    (data / sci["news"]).symlink_to(root / "items.tsv")
    base = {**run_iisan.BASE, **sci, "root_data_dir": str(root),
            "stored_vector_path": str(root / "vecs"), "epoch": 1,
            "log_dir": str(root / "sweep" / "logs"),
            "ckpt_dir": str(root / "sweep" / "ckpt")}
    results, launches = counted(counters, lambda: sweep.run_sweep(
        base, run_iisan.GRID, device=device))
    for k in names:
        totals[k] += launches[k]
    if len(results) != 1 or results[0][1] is None:
        raise AssertionError(f"phase 34 run_iisan: {len(results)} points")
    point, res = results[0]
    loss = res.losses[0]
    hit, ndcg = res.valid_history[0]
    log(f"phase 34 run_iisan scientific (BASE | DATASETS['scientific'] and GRID, epoch 1, "
        f"over phase 31's dataset): label {sweep.point_label(point)}; epoch "
        f"{res.epoch_times[0]:.3f} s host, loss {loss:.5f}, valid HR@10 {hit:.6f} "
        f"nDCG@10 {ndcg:.6f}; {time.perf_counter() - t0:.2f} s with the dataset "
        f"written; launches {nonzero(launches)}")
    if not (math.isfinite(loss) and math.isfinite(hit) and math.isfinite(ndcg)
            and 0 <= hit <= 1 and launches["user_encoder_fwd"] > 0
            and launches["user_encoder_bwd"] > 0):
        raise AssertionError(f"phase 34 run_iisan: loss {loss}, HR@10 {hit}, "
                             f"launches {launches}")

    # the three launchers' dry runs: one point per dataset, method, variant
    dry = []
    for module, choices in ((run_iisan, [[]]),
                            (run_baselines, [[m] for m in run_baselines.METHODS]),
                            (run_iisan_versa, [[v] for v in run_iisan_versa.VARIANTS])):
        for args in choices:
            with contextlib.redirect_stdout(io.StringIO()):
                n = len(module.main([*args, "--dry-run"]))
            dry.append((module.__name__.rsplit(".", 1)[1], args, n))
    log("phase 34 dry runs: " + ", ".join(f"{m} {' '.join(a) or '(default)'} {n} point(s)"
                                          for m, a, n in dry))
    if any(n != 1 for _, _, n in dry):
        raise AssertionError(f"phase 34 dry runs: {dry}")
    log(f"phase 34 wall time {time.perf_counter() - t_phase:.2f} s; launches {totals} "
        f"({smi})")
    return totals


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

    with phase("build and SASS checks"):
        t0 = time.perf_counter()
        lib_path = build.build()
        build.library()
        log(f"kernels built from {build.CSRC.relative_to(ROOT)} into "
            f"{lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
        for line in (lib_path.parent / "build.log").read_text().splitlines():
            if ("registers" in line or "Compiling entry" in line or "spill" in line) \
                    and "C7519" not in line:  # not the injected-arrive notes
                log("  ptxas: " + line.strip())
        mma = build.sass_mma_counts("_kernel")  # one cuobjdump for every check
        for name, n in sorted(mma.items()):
            if "user_encoder" in name:
                log(f"  SASS: {n['HMMA']} HMMA, {n['HGMMA']} HGMMA in {name}")
        for kernel in ("user_encoder_fwd_tc_kernel", "user_encoder_bwd_tc_kernel",
                       "user_encoder_wgrad_kernel"):
            if not any(kernel in name and sum(n.values()) > 0 for name, n in mma.items()):
                raise AssertionError(f"{kernel}: no tensor-core instruction in its SASS")
        check_attention_sass(mma)

    with phase("1-3 encoder and cascade kernels"):
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
    with phase("4 serving slice, both SAN routes"):
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
    with phase("5 encoder training kernels"):
        train = check_user_encoder_train(device)
    del model, table_plain, table_kernel, embs, fused, module
    torch.cuda.empty_cache()
    counters = (fue.user_encoder_fwd, fue.user_encoder_bwd, fs.san_cascade_fwd,
                fs.san_cascade_streamed_fwd)
    trained = {}
    with phase("6 cached training"):
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

    with phase("7 attention kernels"):
        attn = check_attention(device)
    torch.cuda.empty_cache()
    ucounters = (fa.mha_fwd, fa.mha_bwd, fa.mha_mask_replay,
                 fue.user_encoder_fwd, fue.user_encoder_bwd, fs.san_cascade_fwd)
    busy_by_route = {}  # the uncached step's device-busy ms on each tower route
    with phase("8 IISAN uncached"):
        iisan_counts = train_iisan_uncached(device, ucounters, busy_by_route)
    torch.cuda.empty_cache()
    step_stats = {}  # (host ms, device-busy ms, peak GiB) of each tower-training step
    with phase("9 FFT"):
        fft_counts = train_fft(device, ucounters, step_stats)
    torch.cuda.empty_cache()
    with phase("10 kernel vs module routes"):
        check_uncached_routes(device, (
            ("IISAN", 3 * 64, {}),
            ("FFT", 3 * FFT_BATCH, dict(batch_size=FFT_BATCH, adding_adapter_to="None",
                                        adapter_type="houslby"))))
    uncached = {k: iisan_counts[k] + fft_counts[k] for k in iisan_counts}
    with phase("10a fp32 IISAN and FFT steps"):
        fp32_counts = train_fp32_steps(device, ucounters)
    torch.cuda.empty_cache()

    # IISAN-Versa: the streamed cascade kernel and the dispatch on the card,
    # then training, int8 tap tables and serving at the published geometry.
    with phase("11-12 streamed cascade and dispatch"):
        streamed = check_streamed_cascade(device)
        check_dispatch(device)
    torch.cuda.empty_cache()
    with phase("13-15 Versa"):
        versa = run_versa(device, corpus, requests, counters)
    torch.cuda.empty_cache()

    # The frozen-tower options of IISAN (Uncached): the W8A8 kernel and the
    # int8 towers, then the attention-subblock kernels and their routes.
    from iisan_tpu_torch.ops import fused_attn_subblock as fsb
    from iisan_tpu_torch.ops import fused_w8a8 as fw

    with phase("16 W8A8 kernel"):
        w8a8 = check_w8a8(device)
    tcounters = (fw.fused_w8a8_matmul, fw.w8a8_quant_rows, fw.w8a8_gemm,
                 fsb.fused_attn_subblock,
                 fsb.fused_attn_subblock_v2, fa.mha_fwd, fa.mha_bwd,
                 fue.user_encoder_fwd, fue.user_encoder_bwd)
    with phase("17 int8 towers"):
        int8 = train_int8_uncached(device, tcounters, busy_by_route)
    torch.cuda.empty_cache()
    with phase("18 subblock kernels"):
        subblock = check_subblock(device)
    torch.cuda.empty_cache()
    with phase("19-20 subblock routes, 257 tokens"):
        routes = train_subblock_routes(device, tcounters, busy_by_route)
        long_tokens = train_uncached_257(device, tcounters)
    towers = {k: int8[k] + routes[k] + long_tokens[k] for k in int8}
    torch.cuda.empty_cache()

    # The tower-training baselines: LoRA, Houlsby and BitFit at FFT's batch,
    # their kernel and module routes, multi-attribute text, tower remat and
    # the transformers weight import.
    with phase("21 baselines"):
        peft = [train_baseline(device, ucounters, name, (24, bwd), step_stats, **kw)
                for name, bwd, kw in BASELINES]
    torch.cuda.empty_cache()
    with phase("22 baseline routes"):
        check_uncached_routes(device, tuple(
            (name, 3 * FFT_BATCH, dict(batch_size=FFT_BATCH, **kw))
            for name, _, kw in BASELINES if name != "BitFit"))
    with phase("23 multi-attribute"):
        peft.append(train_multi_attribute(device, ucounters, step_stats))
    log_baselines(step_stats)
    with phase("24 remat"):
        peft.append(train_remat(device, ucounters))
    with phase("25 transformers import"):
        check_hf_import(device)
    peft = {k: sum(c[k] for c in peft) for k in peft[0]}
    torch.cuda.empty_cache()

    # IISAN's caches through #5 and cached training from them, then the
    # Versa towers' caches (phases 27-30).
    ccounters = (fa.mha_fwd, fue.user_encoder_fwd, fue.user_encoder_bwd,
                 fs.san_cascade_fwd, fs.san_cascade_streamed_fwd)
    with phase("27-30 cache builds"):
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            caches, per_1000 = run_iisan_caches(device, ccounters, Path(tmp))
            torch.cuda.empty_cache()
            versa_caches = run_versa_caches(device, ccounters, Path(tmp), per_1000["image"])
    caches = {k: caches[k] + versa_caches[k] for k in caches}
    torch.cuda.empty_cache()

    # The run path from the command line (phase 31).
    with phase("31 command line"):
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            cli = run_cli_path(device, counters, Path(tmp))
    torch.cuda.empty_cache()
    # The real-data image stores, uncached training and a cache build from
    # them, and device_bench (phase 32).
    with phase("32 image stores"):
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            stores = run_image_stores(
                device, (fa.mha_fwd, fue.user_encoder_fwd, fue.user_encoder_bwd),
                Path(tmp), smi, busy_by_route["fused_mha"], per_1000["image"] * 1e3)
    torch.cuda.empty_cache()
    # int8 and sharded serving, training on one NCCL rank (phase 33)
    with phase("33 int8 and sharded serving, ranks"):
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            par = run_parallel(device, (fa.mha_fwd, fue.user_encoder_fwd,
                                        fue.user_encoder_bwd, fs.san_cascade_fwd),
                               Path(tmp), smi)
    torch.cuda.empty_cache()
    # the TPME report over six methods and the sweep launchers (phase 34)
    with phase("34 TPME report and sweeps"):
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            tpme = run_tpme_and_sweeps(
                device, (fa.mha_fwd, fa.mha_bwd, fa.mha_mask_replay, fue.user_encoder_fwd,
                         fue.user_encoder_bwd, fs.san_cascade_fwd), Path(tmp), smi)
    torch.cuda.empty_cache()
    ue_bound, ue_bwd_bound = encoder_bounds(256, 64)
    log("uncached IISAN step device-busy by tower route, this run (staged batch, "
        "profiler): " + ", ".join(f"{k} {v:.2f} ms" for k, v in busy_by_route.items()))

    def entry(name, replaces, launches, err, ms, plain_ms, bnd, library_ms, source=None,
              device=None, designs=None):
        row = {"name": name, "route": "cuda",
               "source": f"iisan_tpu_torch/csrc/{source or name}.cu",
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}
        if device is not None:
            row["device_ms"] = device
        if designs is not None:
            row["designs"] = designs
        return row

    kernels = [
        entry("user_encoder_fwd", "iisan_tpu/ops/fused_user_encoder.py:264",
              counts[0] + train_counts["user_encoder_fwd"]
              + uncached["user_encoder_fwd"] + versa["user_encoder_fwd"]
              + towers["user_encoder_fwd"] + peft["user_encoder_fwd"]
              + caches["user_encoder_fwd"] + cli["user_encoder_fwd"]
              + stores["user_encoder_fwd"] + par["user_encoder_fwd"]
              + tpme["user_encoder_fwd"],
              max([r[0] for r in ue.values()] + [train["fwd_err"]]),
              ue[256][1], ue[256][2], ue_bound, None, device=ue[256][3]),
        entry("user_encoder_bwd", "iisan_tpu/ops/fused_user_encoder.py:327",
              train_counts["user_encoder_bwd"] + uncached["user_encoder_bwd"]
              + versa["user_encoder_bwd"] + towers["user_encoder_bwd"]
              + peft["user_encoder_bwd"] + caches["user_encoder_bwd"]
              + cli["user_encoder_bwd"] + stores["user_encoder_bwd"]
              + par["user_encoder_bwd"] + tpme["user_encoder_bwd"],
              train["bwd_err"], train["bwd_ms"], train["bwd_plain_ms"],
              ue_bwd_bound, None, "user_encoder_bwd_tc", device=train["bwd_device_ms"]),
        entry("san_cascade_fwd", "iisan_tpu/ops/fused_san.py:49",
              counts[1] + train_counts["san_cascade_fwd"]
              + versa["san_cascade_fwd"] + caches["san_cascade_fwd"]
              + cli["san_cascade_fwd"] + par["san_cascade_fwd"]
              + tpme["san_cascade_fwd"],
              cascade["err"], cascade["ms"],
              cascade["plain_ms"], cascade_bound(*CASCADE_TABLE), None),
        entry("san_cascade_streamed_fwd", "iisan_tpu/ops/fused_san.py:94",
              versa["san_cascade_streamed_fwd"] + caches["san_cascade_streamed_fwd"],
              streamed["err"],
              streamed["ms"], streamed["plain_ms"], streamed["bound"], None),
        entry("mha_fwd", "iisan_tpu/ops/fused_attention.py:73",
              uncached["mha_fwd"] + towers["mha_fwd"] + peft["mha_fwd"]
              + caches["mha_fwd"] + stores["mha_fwd"] + par["mha_fwd"]
              + tpme["mha_fwd"],
              attn["fwd_err"], attn["fwd_ms"], attn["fwd_plain_ms"],
              attn["fwd_bound"], attn["fwd_sdpa_ms"]),
        entry("mha_bwd", "iisan_tpu/ops/fused_attention.py:106",
              uncached["mha_bwd"] + towers["mha_bwd"] + peft["mha_bwd"]
              + tpme["mha_bwd"],
              attn["bwd_err"], attn["bwd_ms"], attn["bwd_plain_ms"],
              attn["bwd_bound"], attn["bwd_sdpa_ms"], device=attn["bwd_device_ms"],
              designs=attn["bwd_designs"]),
        entry("mha_fwd_tf32", "iisan_tpu/ops/fused_attention.py:73", fp32_counts["mha_fwd"],
              attn["fwd32_err"], attn["fwd32_ms"], attn["fwd32_plain_ms"],
              attn["fwd32_bound"], attn["fwd32_sdpa_ms"], "mha_fwd",
              device=attn["fwd32_device_ms"]),
        entry("mha_bwd_tf32", "iisan_tpu/ops/fused_attention.py:106", fp32_counts["mha_bwd"],
              attn["bwd32_err"], attn["bwd32_ms"], attn["bwd32_plain_ms"],
              attn["bwd32_bound"], attn["bwd32_sdpa_ms"], "mha_bwd",
              device=attn["bwd32_device_ms"]),
        entry("mha_mask_replay", "iisan_tpu/ops/fused_attention.py:165",
              uncached["mha_mask_replay"] + peft["mha_mask_replay"]
              + tpme["mha_mask_replay"], 0.0,
              attn["replay_ms"], attn["replay_plain_ms"], attn["replay_bound"], None,
              device=attn["replay_device_ms"]),
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
    log("seconds by phase (host clock): " + "; ".join(
        f"{label} {sec:.1f}" for label, sec in PHASE_SECONDS)
        + f"; all phases {sum(sec for _, sec in PHASE_SECONDS):.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
