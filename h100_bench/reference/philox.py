"""Philox4x32-10 (Salmon et al., SC'11) in plain PyTorch, and the dropout
masks the program addresses with it.

The program draws its in-kernel dropout bits from Philox4x32-10, keyed by
(seed, 0), at counter (element // 4, site, sequence, 0), lane element % 4;
an element is kept where (bits >> 8) / 2^24 >= rate.  This module computes
the same bits from that published addressing, so the reference can apply
the masks the program's kernels draw without reading them from it.
uint32 words are carried in int64 tensors; each 32 x 32-bit product is
split into 16-bit halves so no intermediate passes 2^49.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    lo16, hi16 = m * (c & 0xFFFF), m * (c >> 16)
    low = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (low >> 32), low & MASK


def philox(ctr, key0: int, key1: int):
    """Ten rounds over the four counter words (broadcast int64 tensors)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key0 & MASK, key1 & MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: int, sites, rows: torch.Tensor, shape,
              rate: float) -> torch.Tensor:
    """(len(rows), len(sites), *shape) bool: where the program keeps an
    element of each dropout site in ``sites`` for sequences ``rows``,
    elements numbered row-major in ``shape``."""
    n = 1
    for s in shape:
        n *= s
    dev = rows.device
    e = torch.arange(n, dtype=torch.int64, device=dev)[None, None, :]
    site = torch.as_tensor(list(sites), dtype=torch.int64, device=dev)[None, :, None]
    b = rows.to(torch.int64)[:, None, None]
    words = philox((e >> 2, site, b, torch.zeros_like(b)), seed, 0)
    lane = e & 3
    bits = torch.where(lane == 0, words[0], torch.where(
        lane == 1, words[1], torch.where(lane == 2, words[2], words[3])))
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    rate32 = torch.tensor(rate, dtype=torch.float32, device=dev)
    return (u >= rate32).reshape(len(rows), len(site[0]), *shape)
