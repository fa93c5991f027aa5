"""Measure one method's TPME inputs (t, p, m) in a process of its own.

Port of ``scripts/tpme_single.py``.  ``tools/tpme_report.py`` runs it once
per method, so that no allocator state or peak-memory count carries from
one method to the next.  Prints one JSON line: {label, epoch_seconds,
trainable_params, memory_bytes, ..., device, launches}.

``epoch_seconds`` is scaled to the Amazon Scientific epoch (12,076 users)
at each method's reference batch size, so the numbers compare the way the
paper's table does: the cached method times full epochs at that size; the
uncached ones time steps on a staged batch (``device_bench``, CUDA events)
times the epoch's steps, and a host-fed ``run_epoch`` over ``--users``
users scaled to 12,076 (``epoch_seconds_e2e``).  ``memory_bytes`` is
``torch.cuda.max_memory_allocated()`` over the timed work (the JAX
version read XLA's compiled-executable memory analysis); ``launches``
counts each kernel of the port that the process launched.  On the CPU
(``--device cpu``) the times are host times and ``memory_bytes`` is null.

    python -m iisan_tpu_torch.tools.tpme_single \\
        iisan_cached|iisan_uncached|fft|lora|houlsby|bitfit \\
        [--remat] [--users N] [--lmdb PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SCIENTIFIC_USERS = 12076  # Dataset/Scientific scale
METHODS = ("iisan_cached", "iisan_uncached", "fft", "lora", "houlsby",
           "bitfit")

# The reference's method configs (scripts/run_{IISAN,fft,lora,adapter,
# bitfit}.py).  The PEFT rows pass fine_tune_to='None', as every shipped
# reference script does: with 'all' the towers would train too.
UNCACHED_OVERRIDES = {
    "iisan_uncached": dict(adapter_type="IISAN", adding_adapter_to="all",
                           fine_tune_to="None"),
    "fft": dict(adapter_type="fft", adding_adapter_to="None",
                fine_tune_to="all"),
    "lora": dict(adapter_type="lora", adding_adapter_to="all",
                 fine_tune_to="None",
                 bert_adapter_down_size=8, cv_adapter_down_size=8),
    "houlsby": dict(adapter_type="houslby", adding_adapter_to="all",
                    fine_tune_to="None",
                    bert_adapter_down_size=64, cv_adapter_down_size=64),
    "bitfit": dict(adapter_type="bitfit", adding_adapter_to="all",
                   fine_tune_to="None"),
}


def device_label(device: torch.device) -> str:
    """The device's name; for a card, its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them."""
    if device.type != "cuda":
        return str(device)
    index = device.index or 0
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _common(device: torch.device) -> dict:
    from ..utils.profiling import kernel_launches

    return {"device": device_label(device), "launches": kernel_launches()}


def cached_config(**overrides):
    """The cached method's reference config: ``IISANConfig`` defaults at
    batch 64, embedding 64, seed 12345."""
    from ..config import IISANConfig

    return IISANConfig(**{**dict(batch_size=64, epoch=1, embedding_dim=64,
                                 seed=12345), **overrides})


def uncached_config(method: str, remat=False, **overrides):
    """An uncached method's reference config: batch 32, embedding 64, seed
    12345, SAN lists "1,3,5,7,9,11", the method's overrides."""
    from ..config import IISANConfig

    return IISANConfig(**{**dict(
        pipeline="uncached", batch_size=32, epoch=1, embedding_dim=64,
        seed=12345, side_adapter_vit_list="1,3,5,7,9,11",
        side_adapter_bert_list="1,3,5,7,9,11", remat_towers=remat,
        **UNCACHED_OVERRIDES[method]), **overrides})


def measure_cached(device=None, n_users: int = SCIENTIFIC_USERS,
                   item_num: int = 20825, timed_epochs: int = 3,
                   **overrides) -> dict:
    """Full cached epochs over a synthetic Scientific-size corpus and tap
    tables: one warm epoch, then the median of ``timed_epochs``, each ending
    synchronised.  ``overrides`` go into the config (the tests' small
    widths)."""
    from ..data.synthetic import synthetic_corpus, synthetic_taps
    from ..device import resolve_device
    from ..train.cached import CachedTrainer
    from ..utils.tpme import trainable_param_count

    device = resolve_device(device)
    cfg = cached_config(**overrides)
    corpus = synthetic_corpus(n_users=n_users, item_num=item_num,
                              max_seq_len=cfg.max_seq_len, seed=0)
    tr = CachedTrainer(
        cfg, corpus,
        synthetic_taps(item_num, len(cfg.san_image_taps()),
                       cfg.image_embedding_dim, seed=1),
        synthetic_taps(item_num, len(cfg.san_text_taps()),
                       cfg.word_embedding_dim, seed=2),
        device=device)
    tr.run_epoch(0)  # warm
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for ep in range(1, timed_epochs + 1):
        t0 = time.perf_counter()
        tr.run_epoch(ep)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return {
        "label": "iisan_cached",
        "epoch_seconds": float(np.median(times)),
        "epoch_seconds_basis":
            f"MEASURED full epochs ({n_users:,} users, "
            f"{-(-n_users // cfg.batch_size)} steps of {cfg.batch_size}; "
            f"median of {timed_epochs} after a warm epoch, host clock, each "
            "ending synchronised); memory_bytes is "
            "torch.cuda.max_memory_allocated over the timed epochs (peak "
            "reset after the warm epoch, both tap tables resident), where "
            "the JAX record read XLA's compiled memory analysis",
        "trainable_params": trainable_param_count(tr),
        "memory_bytes": int(torch.cuda.max_memory_allocated(device))
        if cuda else None,
        "batch_size": cfg.batch_size,
        **_common(device),
    }


def token_table(item_num: int, words: int) -> np.ndarray:
    """Title rows ``[ids | mask]``: ``words`` random ids in [1, 30000) and
    an all-ones mask for every item, the pad row zero (seeded as the JAX
    script's table)."""
    rng = np.random.default_rng(0)
    tokens = np.zeros((item_num + 1, 2 * words), np.int32)
    tokens[1:, :words] = rng.integers(1, 30000, size=(item_num, words))
    tokens[1:, words:] = 1
    return tokens


def measure_uncached(method: str, device=None, n_users: int = 256,
                     item_num: int = 600, remat=False, lmdb=None,
                     bench_steps: int = 8, **overrides) -> dict:
    """One uncached method: ``device_bench(bench_steps)`` on a staged batch,
    scaled to the Scientific epoch's steps, then one warm and one timed
    host-fed ``run_epoch`` over ``n_users`` users, scaled to 12,076.
    Images from ``SyntheticImageStore`` (seeded pixels, no decode), or with
    ``lmdb`` from a reference-layout LMDB (read, unpickle, resize).
    ``remat``: ``remat_towers``.  ``overrides`` go into the config."""
    from ..data.images import LmdbImageStore, SyntheticImageStore
    from ..data.synthetic import synthetic_corpus
    from ..device import resolve_device
    from ..train.uncached import UncachedTrainer
    from ..utils.tpme import trainable_param_count

    device = resolve_device(device)
    cfg = uncached_config(method, remat=remat, **overrides)
    corpus = synthetic_corpus(n_users=n_users, item_num=item_num,
                              max_seq_len=cfg.max_seq_len, seed=0)
    tokens = token_table(corpus.item_num, cfg.num_words_title)
    if lmdb:
        store, store_kind = LmdbImageStore(lmdb, cfg.CV_resize), "lmdb"
    else:
        store, store_kind = SyntheticImageStore(cfg.CV_resize), "synthetic"
    tr = UncachedTrainer(cfg, corpus, tokens, store, device=device)
    b = tr.device_bench(n_steps=bench_steps)
    steps_per_epoch = -(-SCIENTIFIC_USERS // cfg.batch_size)

    tr.run_epoch(0)  # warm: the loader's threads, the allocator's pools
    _sync(device)
    t0 = time.perf_counter()
    tr.run_epoch(1)
    _sync(device)
    e2e_wall = time.perf_counter() - t0

    clock = "CUDA events" if device.type == "cuda" else "host clock"
    feed = ("images read from a reference-layout LMDB (read, unpickle, "
            "Pillow resize, on the loader's threads)" if store_kind == "lmdb"
            else "images from SyntheticImageStore (seeded pixels, no decode "
                 "or LMDB read)")
    return {
        "label": method,
        "epoch_seconds": b["seconds_per_step"] * steps_per_epoch,
        "epoch_seconds_basis":
            f"device_bench step on a staged batch ({bench_steps} steps, "
            f"{clock}) x {steps_per_epoch} steps (EXTRAPOLATED to the "
            "Scientific epoch; the cross-method basis the TPME score uses)",
        "epoch_seconds_e2e": e2e_wall * (SCIENTIFIC_USERS / corpus.n_users),
        "epoch_seconds_e2e_basis":
            (f"MEASURED host-fed run_epoch over {corpus.n_users} users "
             f"({e2e_wall:.1f}s wall, host clock, after a warm epoch)"
             + ("" if corpus.n_users == SCIENTIFIC_USERS else
                f" scaled linearly to {SCIENTIFIC_USERS} users")
             + f"; {feed}; {cfg.num_workers} loader threads"),
        "e2e_image_store": store_kind,
        "e2e_measured_users": corpus.n_users,
        "e2e_measured_seconds": e2e_wall,
        "trainable_params": trainable_param_count(tr),
        "memory_bytes": b["memory_bytes"] if device.type == "cuda" else None,
        "batch_size": cfg.batch_size,
        "step_seconds": b["seconds_per_step"],
        "tflops_per_step": b["flops_per_step"] / 1e12,
        "remat_towers": bool(remat),
        **_common(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("method", choices=METHODS)
    ap.add_argument("--remat", action="store_true",
                    help="rematerialise the towers' layers (uncached)")
    ap.add_argument("--users", type=int, default=256,
                    help="users of the host-fed epoch (uncached; 12076 "
                         "measures a whole Scientific epoch unscaled)")
    ap.add_argument("--lmdb", default=None,
                    help="feed the host-fed epoch from this LMDB (uncached)")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu (default: cuda:0)")
    args = ap.parse_args(argv)
    if args.users < 1:
        ap.error("--users needs a positive integer")
    if args.method == "iisan_cached":
        rec = measure_cached(device=args.device)
    else:
        rec = measure_uncached(args.method, device=args.device,
                               n_users=args.users, remat=args.remat,
                               lmdb=args.lmdb)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
