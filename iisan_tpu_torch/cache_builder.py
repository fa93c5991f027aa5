"""Hidden-state cache builder: the frozen towers over the item catalogue.

Port of ``iisan_tpu/cache_builder.py``.  A tower runs once over the
catalogue, batch by batch, and each item's per-layer vector lands in a
dense ``HiddenStateCache`` (``data/cache_store.py``): the CLS row of every
hidden layer (``pool="cls"``, BERT and the image towers) or the
attention-masked token mean of every layer (``pool="mean"``, the Llama
builders).  Towers that take ``collect`` reduce each layer as they
produce it, so the full (layers+1, B, T, D) stack never exists; for any
other encoder the stack is reduced here (CLS in the hidden's dtype, the
mean in fp32).

Every batch has the same size: the last one wraps around to full size
(``np.resize``), as the JAX builder pads it, so every launch sees the same
shapes and a row's result does not depend on the batch it falls in (what
makes a sharded build bit-equal to a single one).  The forwards run under
``torch.inference_mode()`` on the build's device; each batch's states go
to the host through one of two pinned buffers while the next batch runs,
and images come from ``ParallelImageLoader`` one batch ahead.

Resume: ``start_item`` > 1 reopens the existing store (geometry-checked)
instead of truncating it.  Shards: ``end_item`` set makes the build write
rows [start_item, end_item) into a store opened with ``create_or_open``.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Sequence

import numpy as np
import torch

from .data.cache_store import HiddenStateCache
from .data.images import ParallelImageLoader, normalize_images
from .device import resolve_device
from .models.modules import hidden_reducer

log = logging.getLogger("iisan_tpu_torch")

POOLS = ("cls", "mean")


@contextlib.contextmanager
def _collecting(enc, collect: str):
    """``enc.collect`` set to ``collect`` for the block."""
    before = enc.collect
    enc.collect = collect
    try:
        yield enc
    finally:
        enc.collect = before


def text_states(enc, tokens: torch.Tensor, pool: str = "cls") -> torch.Tensor:
    """(B, 2*num_words) packed ``[ids | mask]`` rows -> (B, layers+1, D):
    each layer's CLS row (``pool="cls"``) or its masked token mean
    (``"mean"``).  An encoder with ``collect`` (BERT, Llama) reduces inside
    its forward; otherwise the full stack is reduced here, CLS in the
    hidden's dtype and the mean ``sum(h * w) / max(sum(w), 1)`` in fp32."""
    if pool not in POOLS:
        raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
    n = tokens.shape[1] // 2
    ids, mask = tokens[:, :n], tokens[:, n:]
    if hasattr(enc, "collect"):
        with _collecting(enc, pool):
            _, hiddens = enc(ids, mask)  # (L+1, B, D)
        return hiddens.transpose(0, 1)
    _, hiddens = enc(ids, mask)  # (L+1, B, T, D)
    reduce = hidden_reducer(pool, mask)
    return torch.stack([reduce(h) for h in hiddens], 1)


def image_states(enc, images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 images on the device -> (B, layers+1, D), each
    layer's CLS row.  Normalised to [-1, 1] in fp32, as the JAX builder
    does (the tower casts to its own dtype)."""
    images = normalize_images(images_u8, torch.float32)
    if hasattr(enc, "collect"):
        with _collecting(enc, "cls"):
            _, hiddens = enc(images)  # (L+1, B, D)
        return hiddens.transpose(0, 1)
    _, hiddens = enc(images)  # (L+1, B, T, D)
    return hiddens[:, :, 0, :].transpose(0, 1)


def state_geometry(enc):
    """(layers+1, D) of a tower's cache rows, from its configuration."""
    return enc.num_layers + 1, enc.hidden_dim


def _make_store(out_path, n, n_layers, dim, dtype, start_item, end_item):
    """Fresh, ``start_item`` resume, or a shard's range (``end_item`` set:
    ``create_or_open``, which concurrent shards share)."""
    if end_item is not None:
        return HiddenStateCache.create_or_open(out_path, n, n_layers, dim, dtype)
    return HiddenStateCache.create(out_path, n, n_layers, dim, dtype,
                                   resume=start_item > 1)


def _write_states(store, spans, states_iter, device, what: str) -> None:
    """Write each span's rows of the batches ``states_iter`` yields (on
    ``device``).  On a CUDA device a batch's states are copied into one of
    two pinned host buffers behind the forward, and written while the
    next batch runs."""
    buffers, pending = [], []

    def write(s, e, host, event):
        if event is not None:
            event.synchronize()
        # float rows: the store casts them, or quantises them (int8)
        store.write_rows(s, host[: e - s].numpy())

    for i, ((s, e), states) in enumerate(zip(spans, states_iter)):
        states = states.float()
        event = None
        if device.type == "cuda":
            if len(buffers) < 2:
                buffers.append(torch.empty(states.shape, dtype=torch.float32,
                                           pin_memory=True))
            host = buffers[i % 2]
            host.copy_(states, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = states
        pending.append((s, e, host, event))
        if len(pending) == 2:
            write(*pending.pop(0))
        if i % 20 == 0:
            log.info("%s cache %d/%d", what, e, spans[-1][1])
    for item in pending:
        write(*item)
    store.flush()


def _spans(start_item: int, stop: int, batch: int):
    return [(s, min(s + batch, stop)) for s in range(start_item, stop, batch)]


def build_text_cache(enc, token_table: np.ndarray, out_path: str,
                     batch: int = 128, pool: str = "cls",
                     dtype: str = "float16", start_item: int = 1,
                     end_item: int | None = None,
                     device=None) -> HiddenStateCache:
    """Run the text tower ``enc`` over ``token_table`` ((item_num+1,
    2*num_words) packed rows, row 0 the pad item) into a store at
    ``out_path`` of ``dtype`` ("float16", "float32", or "int8", which
    quantises each (item, layer) row).  Builds rows [start_item, end_item
    or the end); ``device`` defaults to the first CUDA card (the CPU only
    when named), and the tower is moved there."""
    if pool not in POOLS:
        raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
    device = resolve_device(device)
    enc = enc.to(device)
    n = token_table.shape[0]
    n_layers, dim = state_geometry(enc)
    store = _make_store(out_path, n, n_layers, dim, dtype, start_item, end_item)
    stop = n if end_item is None else min(end_item, n)
    spans = _spans(start_item, stop, batch)

    def states():
        for s, e in spans:
            toks = np.resize(token_table[s:e], (batch, token_table.shape[1]))
            yield text_states(enc, torch.as_tensor(toks).to(device), pool)

    with torch.inference_mode():
        _write_states(store, spans, states(), device, "text")
    return store


def build_image_cache(enc, item_names: Sequence[str], image_store,
                      out_path: str, batch: int = 128,
                      dtype: str = "float16", start_item: int = 1,
                      end_item: int | None = None,
                      device=None) -> HiddenStateCache:
    """Run the image tower ``enc`` over the images of ``item_names`` (index
    0 the pad item) from ``image_store`` (``.get(name)`` -> uint8 (H, W,
    3)) into a store at ``out_path``; the other arguments as
    ``build_text_cache``'s."""
    device = resolve_device(device)
    enc = enc.to(device)
    n = len(item_names)
    n_layers, dim = state_geometry(enc)
    store = _make_store(out_path, n, n_layers, dim, dtype, start_item, end_item)
    stop = n if end_item is None else min(end_item, n)
    spans = _spans(start_item, stop, batch)
    loader = ParallelImageLoader(image_store)
    name_batches = [[item_names[i] for i in np.resize(np.arange(s, e), batch)]
                    for s, e in spans]

    def states():
        for images in loader.iter_batches(name_batches):
            yield image_states(enc, torch.from_numpy(images).to(device))

    with torch.inference_mode():
        _write_states(store, spans, states(), device, "image")
    return store


def verify_cache(store: HiddenStateCache, expect_layers: int,
                 expect_dim: int, first_row: int = 0) -> None:
    """Shape and finiteness check of a built store (the reference
    builders' ``test()``); ``first_row`` is the first row this build wrote
    (a shard checks its own range)."""
    m = store.meta
    assert (m.n_layers, m.dim) == (expect_layers, expect_dim), \
        f"cache shape {(m.n_layers, m.dim)} != {(expect_layers, expect_dim)}"
    rows = np.asarray(store._arr[first_row:first_row + 2], np.float32)
    if store._scales is not None:
        rows = rows * np.asarray(store._scales[first_row:first_row + 2])[..., None]
    assert np.all(np.isfinite(rows)), "non-finite values in the cache"
    log.info("cache ok: %d items x %d layers x %d dim",
             m.n_items, m.n_layers, m.dim)
