"""Where the port's entry points run.

Every entry point that takes a ``device=`` argument (``CachedTrainer``,
``UncachedTrainer``, ``Recommender.load``, ``serve.main``'s ``--device``)
resolves it here: no device means the first CUDA card, and the CPU only
when the caller names it.  There is no silent fallback to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without CUDA); anything else ->
    ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or "
                "--device cpu) to run on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)
