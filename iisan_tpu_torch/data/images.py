"""Item images and titles for the uncached pipeline (host side, numpy).

Port of the parts of ``iisan_tpu/data/images.py`` that the uncached trainer
reads, and of the synthetic token rows of ``scripts/bench_uncached.py``:

- ``normalize_images``: uint8 (N, H, W, 3) -> [-1, 1] in the compute dtype,
  on the device, by the JAX cast chain: the cast to the dtype first, then
  ``* (2/255)`` and ``- 1`` in that dtype, each rounded to it;
- ``SyntheticImageStore``: a seeded random image per item name;
- ``ParallelImageLoader``: a thread pool that decodes one batch of names
  while the device runs the previous one (prefetch depth 2); a ``None``
  name (the pad item, id 0) is an all-zero image;
- ``synthetic_token_table``: the packed ``[ids | mask]`` title rows.

LMDB and directory image stores are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch


def normalize_images(u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 -> ``u8 * (2/255) - 1`` computed in ``dtype``.  The scalars
    are ``dtype`` tensors, so each operation rounds to ``dtype`` as the JAX
    package's does (a Python scalar would keep fp32 precision in torch)."""
    x = u8.to(dtype)
    scale = torch.tensor(2.0 / 255.0, dtype=dtype, device=x.device)
    one = torch.tensor(1.0, dtype=dtype, device=x.device)
    return x * scale - one


class SyntheticImageStore:
    """Seeded random (resize, resize, 3) uint8 images, one per item name.

    The seed is a CRC-32 of the name, so an item's image is the same in
    every process (the JAX package's store seeds from ``hash(name)``, which
    Python salts per process)."""

    def __init__(self, resize: int = 224):
        self.resize = resize

    def get(self, name: str) -> np.ndarray:
        rng = np.random.default_rng(zlib.crc32(name.encode()) % (2 ** 31))
        return rng.integers(0, 256, (self.resize, self.resize, 3),
                            dtype=np.uint8)


class ParallelImageLoader:
    """Decodes batches of item names on a thread pool, ``prefetch``
    batches ahead of the consumer."""

    def __init__(self, store, num_threads: int = 8, prefetch: int = 2):
        self.store = store
        self.pool = ThreadPoolExecutor(max_workers=num_threads)
        self.prefetch = prefetch
        resize = getattr(store, "resize", 224)
        self._pad_image = np.zeros((resize, resize, 3), dtype=np.uint8)

    def iter_batches(self, name_batches: Iterable[Sequence[str]]
                     ) -> Iterator[np.ndarray]:
        """Yields one (len(names), H, W, 3) uint8 array per batch."""
        it = iter(name_batches)
        # The producer submits per-image tasks only (no nested batch tasks
        # on the same pool); the bounded queue paces it to the consumer.
        pending: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()

        def submit_all():
            for names in it:
                pending.put([self.pool.submit(self.store.get, n)
                             if n is not None else None for n in names])
            pending.put(done)

        threading.Thread(target=submit_all, daemon=True).start()
        while True:
            futs = pending.get()
            if futs is done:
                break
            yield np.stack([f.result() if f is not None else self._pad_image
                            for f in futs])


def synthetic_token_table(item_num: int, num_words: int = 30, seed: int = 0,
                          vocab: int = 30000) -> np.ndarray:
    """(item_num + 1, 2 * num_words) int32 packed title rows: random ids in
    [1, vocab) then an all-ones mask; row 0 (the pad item) is all zeros."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((item_num + 1, 2 * num_words), np.int32)
    tokens[1:, :num_words] = rng.integers(1, vocab, size=(item_num, num_words))
    tokens[1:, num_words:] = 1
    return tokens
