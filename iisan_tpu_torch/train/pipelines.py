"""Pipeline helpers: opening a configuration's hidden-state stores.

Port of ``open_cache`` from ``iisan_tpu/train/pipelines.py``.  The rest of
that module (corpus loading, trainer dispatch) is not ported yet.
"""

from __future__ import annotations

import logging
import os

from ..data.cache_store import HiddenStateCache, import_reference_pt_dir

log = logging.getLogger("iisan_tpu_torch")


def open_cache(cfg, which: str, corpus) -> HiddenStateCache:
    """Open ``<stored_vector_path>/<cached_{text,image}_model>.memmap``
    (``which`` is "text" or "image").

    A reference-layout directory of per-item ``{prefix}_{item}.pt`` files
    (the store's name without ``.memmap``, prefix
    ``cached_{text,image}_prefix``) is imported into the ``.memmap`` store
    on first use, its rows in the order of ``corpus.item_names``.
    """
    if which == "text":
        sub, prefix = cfg.cached_text_model, cfg.cached_text_prefix
    else:
        sub, prefix = cfg.cached_image_model, cfg.cached_image_prefix
    memmap_dir = os.path.join(cfg.stored_vector_path, sub + ".memmap")
    if os.path.isdir(memmap_dir):
        return HiddenStateCache.open(memmap_dir)
    pt_dir = os.path.join(cfg.stored_vector_path, sub)
    if os.path.isdir(pt_dir):
        log.info("importing reference .pt cache %s -> %s", pt_dir, memmap_dir)
        return import_reference_pt_dir(pt_dir, prefix, corpus.item_names,
                                       memmap_dir)
    raise FileNotFoundError(
        f"no cache at {memmap_dir} or {pt_dir}; run the cache builder "
        "(iisan_tpu_torch.cache_builder) first")
