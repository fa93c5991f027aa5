"""Batch top-K traffic: ``Recommender.top_k`` from one caller, closed loop.

Set-up makes the user encoder's weights and the catalogue's item table
(``catalogue_rows`` rows of the embedding width and the pad row, on the
device) from the seed, builds the serving model as the published serving
path builds it (``IISANRecModel`` without a side network, in
``serve_dtype``, in eval mode) and a ``Recommender`` over the table, and
makes ``requests`` batches of ``batch_users`` histories.  ``warmup_calls``
calls warm it up.  In the window the caller sends the batches one after
another, cycling, each as the batch command line sends one (``k``,
history excluded, the history width of the longest history), and times
each from the call until its ids are on the host.  A traced run profiles
``traced_calls`` more calls after the window.  Then the program is freed
and the reference scores every row of the table for the users of
``check_requests`` answered calls drawn from the seed, the call with the
longest histories among them, and judges the program's ids and scores.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from h100_bench import data
from h100_bench.harness import worst
from h100_bench import trace as tracing
from h100_bench.runners.train import cuda_ready, log_phases, quiet_gc
from h100_bench.reference import serve as ref_serve
from h100_bench.weights import make_weights, serve_spec


def build_recommender(cell, weights, table):
    from iisan_tpu_torch.models.model import IISANRecModel
    from iisan_tpu_torch.serve import Recommender

    c = cell.config
    ue = c["user_encoder"]
    model = IISANRecModel(san=None, embedding_dim=c["embedding_dim"],
                          max_seq_len=c["max_seq_len"], num_attention_heads=ue["heads"],
                          transformer_block=ue["blocks"], drop_rate=0.0,
                          dtype=getattr(torch, c["serve_dtype"]), device=cell.device)
    params = dict(model.user_encoder.named_parameters(prefix="user_encoder"))
    if set(params) != set(weights):
        raise ValueError("the serving model's parameters are not the benchmark's")
    with torch.no_grad():
        for name, w in weights.items():
            params[name].copy_(w)
    return Recommender(model.eval(), table, c["max_seq_len"])


def run(cell) -> dict:
    c, t, dev = cell.config, cell.traffic, cell.device
    cuda = dev != "cpu"
    E, k, bs = c["embedding_dim"], t["k"], t["batch_users"]
    phases = {"imports and CUDA": cuda_ready(dev)}
    weights = make_weights(serve_spec(c), cell.seed, dev)
    table = torch.randn((t["catalogue_rows"] + 1, E),
                        generator=data.torch_generator(cell.seed, "catalogue", dev),
                        device=dev)
    table[0] = 0.0
    requests = data.serve_requests(t["requests"], bs, t["catalogue_rows"],
                                   t["history_min"], t["history_max"], cell.seed)
    phases["inputs"] = time.perf_counter()
    rec = build_recommender(cell, weights, table)
    phases["recommender"] = time.perf_counter()
    call = cell.hooks.get("call", lambda r, seqs: r.top_k(
        seqs, k=k, exclude_history=True, hist_len=t["history_max"]))

    for i in range(t["warmup_calls"]):
        call(rec, requests[i % len(requests)])
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    quiet_gc()
    latencies, answers = [], []
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    phases["warm-up"] = t0
    log_phases(cell.t_start, phases)
    while time.perf_counter() - t0 < cell.seconds:
        r = len(latencies) % len(requests)
        s = time.perf_counter()
        ids, scores = call(rec, requests[r])
        latencies.append(time.perf_counter() - s)
        answers.append((r, ids, scores))
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    traced = None
    if cell.trace:
        traced = tracing.profile(lambda i: call(rec, requests[i % len(requests)]),
                                 t["traced_calls"], dev)
    del rec
    gc.collect()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1,
              "memory_peak_bytes": int(max(setup_peak, window_peak)) if cuda else 0}
    if cuda:
        torch.cuda.empty_cache()

    rng = np.random.default_rng(data.stream_seed(cell.seed, "sample"))
    longest = max(range(len(answers)), key=lambda i: sum(map(len, requests[answers[i][0]])))
    picks = {longest} | set(rng.choice(len(answers), min(t["check_requests"], len(answers)),
                                       replace=False).tolist())
    rank_gap = score_gap = 0.0
    block = t["reference_block"]
    for i in sorted(picks):
        r, ids, scores = answers[i]
        for s in range(0, bs, block):
            ref = ref_serve.score_users(weights, table, requests[r][s:s + block], c)
            g = ref_serve.judge(ref, ids[s:s + block], scores[s:s + block])
            rank_gap, score_gap = worst([rank_gap, g[0]]), worst([score_gap, g[1]])
    calls = len(latencies)
    end_to_end = {"serve_users_per_s": calls * bs / window_s,
                  "serve_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
                  "setup_s": setup_s}
    context = {"kind": "serve", "trace": traced, "config": c, "users": bs}
    return {"end_to_end": end_to_end,
            "check": {"rank_gap": rank_gap, "score_gap": score_gap},
            "attempted": calls, "failed": 0, "device": device,
            "context": context, "trace": traced}
