"""Checkpoints: model, optimizer and generator state, and the epoch.

Port of ``iisan_tpu/utils/checkpoint.py``.  A checkpoint is
``<ckpt_dir>/epoch-<n>/state.pt``, a ``torch.save`` of

- ``model``: ``model.state_dict()`` (int8 buffers included);
- ``optimizer``: ``optimizer.state_dict()``;
- ``generator``: the trainer's dropout generator, ``get_state()`` (a CPU
  ByteTensor, for a CPU or a CUDA generator);
- ``epoch``.

The directory name is the JAX package's, so ``--load_ckpt_name epoch-7``
means the same in both packages and never names a reference ``epoch-N.pt``
file.  Restoring reads with ``weights_only=True``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, epoch: int, state: Dict[str, Any]) -> str:
    """Write ``state`` as ``<ckpt_dir>/epoch-<epoch>/state.pt`` (through a
    temporary file, so a reader never sees half a checkpoint); returns the
    directory."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"epoch-{epoch}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def restore_checkpoint(ckpt_dir: str, name: str
                       ) -> Tuple[Dict[str, Any], int]:
    """``name`` e.g. "epoch-7"; returns (state, epoch), the epoch read from
    the name (0 when it holds none).  Tensors land on the CPU."""
    path = os.path.join(ckpt_dir, name, STATE_FILE)
    state = torch.load(path, map_location="cpu", weights_only=True)
    m = re.search(r"epoch-(\d+)", name)
    return state, int(m.group(1)) if m else 0


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``epoch-<n>`` directory of ``ckpt_dir`` with the largest n, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = {}
    for x in os.listdir(ckpt_dir):
        m = re.fullmatch(r"epoch-(\d+)", x)
        if m:
            cands[int(m.group(1))] = x
    if not cands:
        return None
    return cands[max(cands)]
