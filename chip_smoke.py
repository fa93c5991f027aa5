#!/usr/bin/env python3
"""Drive the PyTorch port's cached serving path once on one NVIDIA GPU.

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
5. Print one JSON line of per-kernel results, then the final status line.

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


def synthetic_valid_split(rng):
    """Valid split of a synthetic corpus (the layout of the JAX package's
    ``data/synthetic.py``): sequences of 5..13 uniform items, left-padded
    tokens of the sequence up to its second-to-last item, the
    second-to-last item as target, the training prefix as history."""
    import numpy as np

    L = SEQ_LEN
    tokens = np.zeros((USERS, L), np.int32)
    log_mask = np.zeros((USERS, L), np.float32)
    target = np.zeros(USERS, np.int32)
    history = np.zeros((USERS, L + 2), np.int32)
    seqs = []
    for u in range(USERS):
        n = int(rng.integers(5, L + 4))
        seq = rng.integers(1, ITEMS + 1, size=n)
        vt = seq[-(L + 2):-1][:-1]
        tokens[u, L - len(vt):] = vt
        log_mask[u, L - len(vt):] = 1.0
        target[u] = seq[-2]
        history[u, :n - 2] = seq[:-2]
        seqs.append(seq[:-1].tolist())
    return (tokens, log_mask, target, history), seqs


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

    rng = np.random.default_rng(SEED)
    split, seqs = synthetic_valid_split(rng)
    requests = {b: seqs[:b] for b in (1, 32, 256)}
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

    kernels = [
        {"name": "user_encoder_fwd", "route": "cuda",
         "source": "iisan_tpu_torch/csrc/user_encoder_fwd.cu",
         "replaces": "iisan_tpu/ops/fused_user_encoder.py:264",
         "launches": counts[0],
         "max_abs_err": max(r[0] for r in ue.values()),
         "ms": ue[256][1], "plain_ms": ue[256][2]},
        {"name": "san_cascade_fwd", "route": "cuda",
         "source": "iisan_tpu_torch/csrc/san_cascade_fwd.cu",
         "replaces": "iisan_tpu/ops/fused_san.py:49",
         "launches": counts[1], "max_abs_err": cascade[0],
         "ms": cascade[1], "plain_ms": cascade[2]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
