"""Pipeline helpers: opening a configuration's hidden-state stores.

Port of ``open_cache`` from ``iisan_tpu/train/pipelines.py``.  The rest of
that module (corpus loading, trainer dispatch) is not ported yet.
"""

from __future__ import annotations

import os

from ..data.cache_store import HiddenStateCache


def open_cache(cfg, which: str) -> HiddenStateCache:
    """Open ``<stored_vector_path>/<cached_{text,image}_model>.memmap``
    (``which`` is "text" or "image").

    A reference-layout directory of per-item ``.pt`` files (the store
    without the ``.memmap`` suffix) raises ``NotImplementedError``: its
    importer comes with the cache builders.
    """
    sub = cfg.cached_text_model if which == "text" else cfg.cached_image_model
    memmap_dir = os.path.join(cfg.stored_vector_path, sub + ".memmap")
    if os.path.isdir(memmap_dir):
        return HiddenStateCache.open(memmap_dir)
    pt_dir = os.path.join(cfg.stored_vector_path, sub)
    if os.path.isdir(pt_dir):
        raise NotImplementedError(
            f"{pt_dir} is a reference .pt cache; its importer is not ported "
            "yet (it comes with the cache builders, ROADMAP queue 1 item 8)")
    raise FileNotFoundError(
        f"no cache at {memmap_dir} or {pt_dir}; build the caches first")
