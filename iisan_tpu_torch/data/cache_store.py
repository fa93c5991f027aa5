"""Dense on-disk hidden-state store of the cached pipelines.

Port of ``iisan_tpu/data/cache_store.py``, reading and writing its format
byte for byte: one directory per tower with ``meta.json`` (``CacheMeta``),
``states.bin``, a C-order memmap ``(n_items, n_layers, dim)`` keyed by
dense item id (row 0 is the all-zero pad item), and for ``int8`` stores
``scales.bin``, the fp32 ``(n_items, n_layers)`` scale of each row.
``load_taps`` gathers only the SAN's selected layers: a dense numpy array
for a float store, ``QuantTaps`` for an int8 one.

Sharded builds (``cache_builder``, ``tools/build_caches.py``): processes
on one host share one store through ``HiddenStateCache.create_or_open``
(an atomic create-else-open) and write disjoint rows; processes on
several hosts each write a ``<store>.shard<i>`` store with its
``range.json`` (``write_shard_range``), and ``merge_shard_stores`` tiles
them into the final store.  ``import_reference_pt_dir`` converts the
reference's directory of per-item ``{prefix}_{item}.pt`` files into a
store.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import mmap as _mmap
import os
import shutil
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

META_NAME = "meta.json"
DATA_NAME = "states.bin"
SCALES_NAME = "scales.bin"  # int8 stores: fp32 (n_items, n_layers) sidecar
RANGE_NAME = "range.json"  # shard stores: {"lo": int, "hi": int}


@dataclass
class CacheMeta:
    n_items: int     # includes the padding row 0
    n_layers: int    # layers + 1 (embeddings first)
    dim: int
    dtype: str = "float16"  # "float16" / "float32" raw, or "int8" + scales

    def to_json(self):
        return json.dumps(self.__dict__)


class HiddenStateCache:
    """Dense on-disk per-item hidden-state store."""

    def __init__(self, path: str, meta: CacheMeta, mode: str = "r"):
        self.path = path
        self.meta = meta
        self._arr = np.memmap(os.path.join(path, DATA_NAME),
                              dtype=np.dtype(meta.dtype), mode=mode,
                              shape=(meta.n_items, meta.n_layers, meta.dim))
        self._scales = None
        if meta.dtype == "int8":
            self._scales = np.memmap(os.path.join(path, SCALES_NAME),
                                     dtype=np.float32, mode=mode,
                                     shape=(meta.n_items, meta.n_layers))

    @classmethod
    def create(cls, path: str, n_items: int, n_layers: int, dim: int,
               dtype: str = "float16",
               resume: bool = False) -> "HiddenStateCache":
        """A fresh store (truncates).  With ``resume=True`` an existing
        store of the same geometry is reopened writable instead; a missing
        or different one raises (a fresh create would zero the rows
        already built)."""
        os.makedirs(path, exist_ok=True)
        meta = CacheMeta(n_items, n_layers, dim, dtype)
        meta_path = os.path.join(path, META_NAME)
        if resume:
            need = [meta_path, os.path.join(path, DATA_NAME)]
            if dtype == "int8":
                need.append(os.path.join(path, SCALES_NAME))
            if not all(os.path.exists(p) for p in need):
                raise FileNotFoundError(
                    f"cannot resume: no existing store at {path} "
                    f"(missing {META_NAME} or {DATA_NAME}); start from "
                    f"item 1 for a fresh build")
            with open(meta_path) as f:
                existing = CacheMeta(**json.loads(f.read()))
            if existing != meta:
                raise ValueError(
                    f"cannot resume into {path}: existing geometry "
                    f"{existing} != requested {meta}")
            return cls(path, meta, mode="r+")
        with open(meta_path, "w") as f:
            f.write(meta.to_json())
        store = cls(path, meta, mode="w+")
        store._arr[0] = 0  # the pad item is all zeros
        return store

    @classmethod
    def create_or_open(cls, path: str, n_items: int, n_layers: int,
                       dim: int, dtype: str = "float16") -> "HiddenStateCache":
        """Atomic create-else-open-writable, for shard builds on one host.

        Every shard process calls this; the one that wins the ``O_EXCL``
        create of the meta file sizes the files, the others check the
        geometry and reopen writable.  Disjoint row writes never overlap,
        but mmap writeback is page-granular, so the processes must share
        one page cache (one host); builds on several hosts write shard
        stores and merge them (``merge_shard_stores``)."""
        os.makedirs(path, exist_ok=True)
        meta = CacheMeta(n_items, n_layers, dim, dtype)
        meta_path = os.path.join(path, META_NAME)
        try:
            fd = os.open(meta_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # the winner may still be writing the meta file or sizing the
            # data files: wait up to 30 s for each
            raw = ""
            for _ in range(150):
                with open(meta_path) as f:
                    raw = f.read()
                if raw:
                    break
                time.sleep(0.2)
            if not raw:
                raise RuntimeError(
                    f"shard-build: {meta_path} exists but stayed empty for "
                    "30 s - the creator shard likely died mid-create; "
                    f"delete {path} and rerun the shards")
            existing = CacheMeta(**json.loads(raw))
            if existing != meta:
                raise ValueError(
                    f"cannot shard-build into {path}: existing geometry "
                    f"{existing} != requested {meta}")
            need = [(os.path.join(path, DATA_NAME),
                     n_items * n_layers * dim * np.dtype(meta.dtype).itemsize)]
            if meta.dtype == "int8":
                need.append((os.path.join(path, SCALES_NAME),
                             n_items * n_layers * 4))
            for p, size in need:
                for _ in range(150):
                    try:
                        if os.path.getsize(p) >= size:
                            break
                    except OSError:
                        pass
                    time.sleep(0.2)
                else:
                    raise FileNotFoundError(
                        f"shard-build: {p} never reached {size} bytes - the "
                        "creator shard likely died before sizing the files; "
                        f"delete {path} (at least {META_NAME}) and rerun "
                        "the shards")
            return cls(path, meta, mode="r+")
        with os.fdopen(fd, "w") as f:
            f.write(meta.to_json())
        store = cls(path, meta, mode="w+")
        store._arr[0] = 0  # the pad item is all zeros
        return store

    @classmethod
    def open(cls, path: str) -> "HiddenStateCache":
        with open(os.path.join(path, META_NAME)) as f:
            meta = CacheMeta(**json.loads(f.read()))
        return cls(path, meta)

    def write_rows(self, start: int, states: np.ndarray):
        """Write per-item float states at rows ``start...``: a float store
        casts them, an int8 store quantises each (item, layer) row and
        records its scale."""
        end = start + states.shape[0]
        if self._scales is not None:
            from ..ops.quant import quantize_taps

            t = quantize_taps(np.asarray(states, np.float32))
            self._arr[start:end] = t.q.numpy()
            self._scales[start:end] = t.scale[..., 0].numpy()
            return
        self._arr[start:end] = states

    def flush(self):
        self._arr.flush()
        if self._scales is not None:
            self._scales.flush()

    def load_taps(self, layer_ids: Sequence[int], dtype: str = "float32",
                  num_threads: int = 8):
        """The selected layers of every item, (n_items, K, dim): a numpy
        array in ``dtype`` for a float store, ``QuantTaps`` (int8 rows and
        their scales, ``out_dtype=dtype``) for an int8 store.  The gather
        is chunked over threads with ``madvise(WILLNEED)`` readahead."""
        idx = np.asarray(layer_ids)
        taps = self._gather_items(self._arr, idx, num_threads)
        if self._scales is not None:
            from ..ops.quant import QuantTaps

            s = np.ascontiguousarray(self._scales[:, idx])[..., None]
            return QuantTaps(torch.from_numpy(taps), torch.from_numpy(s),
                             out_dtype=dtype)
        return taps.astype(dtype, copy=False)

    def _gather_items(self, arr: np.memmap, idx: np.ndarray,
                      num_threads: int) -> np.ndarray:
        """arr[:, idx, :] as a parallel chunked copy with readahead."""
        n = arr.shape[0]
        out = np.empty((n, len(idx), arr.shape[2]), arr.dtype)
        if len(idx) == 0:
            return out
        # ~64 MB of source rows per chunk
        row_bytes = arr.shape[1] * arr.shape[2] * arr.dtype.itemsize
        layer_bytes = arr.shape[2] * arr.dtype.itemsize
        chunk = max(1, (64 << 20) // max(row_bytes, 1))
        mm = getattr(arr, "_mmap", None)
        page = getattr(_mmap, "PAGESIZE", 4096)
        # consecutive selected layers coalesce into (first, count) runs, so
        # a sparse selection prefetches only its own byte ranges; a dense
        # one streams the whole range
        sorted_idx = np.unique(idx)
        runs, run_start = [], int(sorted_idx[0])
        for a, b in zip(sorted_idx[:-1], sorted_idx[1:]):
            if b != a + 1:
                runs.append((run_start, int(a) - run_start + 1))
                run_start = int(b)
        runs.append((run_start, int(sorted_idx[-1]) - run_start + 1))
        dense = len(sorted_idx) / arr.shape[1] >= 0.5

        def willneed(start, length):
            start_al = start - start % page
            length = min(length + start - start_al, len(mm) - start_al)
            if length > 0:
                mm.madvise(_mmap.MADV_WILLNEED, start_al, length)

        def advise(lo, hi):
            if mm is None:
                return
            try:
                if dense:
                    willneed(lo * row_bytes, (hi - lo) * row_bytes)
                else:
                    for i in range(lo, hi):
                        for first, count in runs:
                            willneed(i * row_bytes + first * layer_bytes,
                                     count * layer_bytes)
            except (AttributeError, ValueError, OSError):
                pass  # madvise is advisory

        def copy(lo):
            hi = min(lo + chunk, n)
            advise(lo, hi)
            out[lo:hi] = arr[lo:hi, idx, :]

        starts = range(0, n, chunk)
        if num_threads <= 1 or n <= chunk:
            for lo in starts:
                copy(lo)
        else:
            with cf.ThreadPoolExecutor(num_threads) as ex:
                list(ex.map(copy, starts))  # re-raises a worker's exception
        return out

    def load_full(self, dtype: str = "float32") -> np.ndarray:
        if self._scales is not None:
            return (np.asarray(self._arr, dtype=np.float32)
                    * np.asarray(self._scales, dtype=np.float32)[..., None]
                    ).astype(dtype)
        return np.asarray(self._arr).astype(dtype)


def write_shard_range(path: str, lo: int, hi: int) -> None:
    """Record the rows [lo, hi) a shard store holds."""
    with open(os.path.join(path, RANGE_NAME), "w") as f:
        json.dump({"lo": lo, "hi": hi}, f)


def _replace_dir(staging: str, out_path: str) -> None:
    if os.path.isdir(out_path):
        shutil.rmtree(out_path)
    os.rename(staging, out_path)


def merge_shard_stores(out_path: str, remove_shards: bool = True,
                       chunk: int = 4096) -> HiddenStateCache:
    """Merge the ``{out_path}.shard*`` stores (each a full-geometry store
    with its ``range.json``) into ``out_path``.  Their ranges must tile
    rows 1..n_items-1; the merge is written to ``{out_path}.merging`` and
    renamed when complete.  Run once, after every shard finished."""
    import glob

    shard_dirs = sorted(glob.glob(out_path.rstrip("/\\") + ".shard*"))
    if not shard_dirs:
        raise FileNotFoundError(f"no shard stores match {out_path}.shard*")
    metas, ranges = [], []
    for d in shard_dirs:
        with open(os.path.join(d, META_NAME)) as f:
            metas.append(CacheMeta(**json.loads(f.read())))
        with open(os.path.join(d, RANGE_NAME)) as f:
            r = json.loads(f.read())
        ranges.append((r["lo"], r["hi"]))
    if any(m != metas[0] for m in metas):
        raise ValueError(f"shard stores disagree on geometry: {metas}")
    ordered = sorted(zip(ranges, shard_dirs))
    expect = 1
    for (lo, hi), _ in ordered:
        if lo != expect:
            raise ValueError(
                f"shard ranges do not tile rows 1..{metas[0].n_items - 1}: "
                f"expected next range to start at {expect}, got {lo} "
                f"(ranges: {sorted(ranges)}) - is a shard still "
                "running/missing?")
        expect = hi
    if expect != metas[0].n_items:
        raise ValueError(
            f"shard ranges stop at {expect}, not {metas[0].n_items} "
            f"(ranges: {sorted(ranges)}) - is the last shard missing?")

    m = metas[0]
    staging = out_path.rstrip("/\\") + ".merging"
    final = HiddenStateCache.create(staging, m.n_items, m.n_layers, m.dim,
                                    m.dtype)
    for (lo, hi), d in ordered:
        src = HiddenStateCache(d, m, mode="r")
        for s in range(lo, hi, chunk):
            e = min(s + chunk, hi)
            final._arr[s:e] = src._arr[s:e]
            if final._scales is not None:
                final._scales[s:e] = src._scales[s:e]
        del src
    final.flush()
    del final
    _replace_dir(staging, out_path)
    if remove_shards:
        for d in shard_dirs:
            shutil.rmtree(d)
    return HiddenStateCache.open(out_path)


def import_reference_pt_dir(pt_dir: str, prefix: str,
                            item_names: Sequence[str], out_path: str,
                            dtype: str = "float16",
                            key_fn=None) -> HiddenStateCache:
    """Convert a directory of per-item ``{prefix}_{key}.pt`` tensors
    ((layers+1, dim) each, the reference builders' layout) into a store
    whose dense ids follow ``item_names`` (row 0 stays zero).  The import
    is written to ``{out_path}.importing`` and renamed when complete, so a
    missing file never leaves a store with zero rows behind."""

    def path_of(name):
        return os.path.join(pt_dir, f"{prefix}_{key_fn(name) if key_fn else name}.pt")

    first = next((torch.load(path_of(n), map_location="cpu")
                  for n in item_names[1:] if os.path.exists(path_of(n))), None)
    if first is None:
        raise FileNotFoundError(f"no {prefix}_*.pt files under {pt_dir}")
    n_layers, dim = first.shape
    staging = out_path.rstrip("/\\") + ".importing"
    store = HiddenStateCache.create(staging, len(item_names), n_layers,
                                    dim, dtype)
    for i, name in enumerate(item_names):
        if i == 0:
            continue
        p = path_of(name)
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} missing — the reference .pt directory is incomplete "
                f"(item {i}/{len(item_names) - 1}); finish the reference "
                "build (its skip-existing resume fills gaps) and re-import")
        t = torch.load(p, map_location="cpu")
        # float rows to write_rows: a float store casts them, an int8 store
        # quantises them there
        store.write_rows(i, t.float().numpy()[None])
    store.flush()
    del store
    _replace_dir(staging, out_path)
    return HiddenStateCache.open(out_path)
