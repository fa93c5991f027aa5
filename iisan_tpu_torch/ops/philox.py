"""Counter-based dropout bits: Philox4x32-10 in plain PyTorch.

The TPU kernels draw their dropout masks from the chip's own PRNG
(``pltpu.prng_random_bits``), which no other device reproduces.  The port
draws them from Philox4x32-10 (Salmon et al., SC'11), the generator of
``curand_kernel.h``'s ``curandStatePhilox4_32_10``; ``csrc/philox.cuh`` is
the same function on the card, so the kernels and their plain versions
make bit-identical masks.

A dropout bit is addressed by (seed, sequence b, site, element e) and is
lane ``e % 4`` of Philox with key ``(seed, 0)`` and counter
``(e // 4, site, b, 0)``.  In curand's terms that is
``curand_init(seed, subsequence=b, offset=(site << 34) + e)`` followed by
one ``curand()``.  A mask therefore depends neither on how a batch is cut
into blocks nor on the device.

uint32 arithmetic is carried in int64 tensors: a 32 x 32-bit product is
split in 16-bit halves so that no intermediate exceeds 2^49.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key schedule (Weyl) increments
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * c, c uint32 in int64."""
    a = m * (c & 0xFFFF)          # < 2^48
    b = m * (c >> 16)             # < 2^48
    lo_part = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (lo_part >> 32), lo_part & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words (int64 tensors holding uint32,
    broadcast together) under the key (k0, k1); returns four words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_bits(seed: int, site: int, batch: torch.Tensor,
                n: int) -> torch.Tensor:
    """(len(batch), n) uint32 words (in int64) for elements 0..n-1 of
    ``site`` of each sequence index in ``batch``."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"dropout seed must lie in [0, 2^31), got {seed}")
    e = torch.arange(n, dtype=torch.int64, device=batch.device)[None, :]
    b = batch.to(torch.int64)[:, None]
    words = philox4x32_10(e >> 2, torch.full_like(e, site), b,
                          torch.zeros_like(b), seed, 0)
    lane = e & 3
    out = words[3]
    for i in (2, 1, 0):
        out = torch.where(lane == i, words[i], out)
    return out


def dropout_mask(seed: int, site: int, batch: int, shape, rate: float,
                 device=None, batch_offset: int = 0) -> torch.Tensor:
    """Scaled keep mask (batch, *shape) fp32 for one dropout site:
    ``1/(1-rate)`` where ``(bits >> 8) / 2^24 >= rate``, else 0 (the TPU
    kernels' ``_dropout_mask``).  Rows are sequences ``batch_offset ..
    batch_offset + batch - 1``; elements are numbered row-major in
    ``shape``."""
    n = 1
    for s in shape:
        n *= s
    rows = torch.arange(batch_offset, batch_offset + batch, device=device)
    u = (random_bits(seed, site, rows, n) >> 8).float() * (1.0 / (1 << 24))
    keep = u >= torch.tensor(rate, dtype=torch.float32, device=device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device)
    return (keep.float() * scale).reshape(batch, *shape)


def draw_seed(generator: torch.Generator) -> int:
    """One kernel seed in [0, 2^31 - 1) from ``generator``, drawn on the
    generator's own device (the JAX modules' ``jax.random.randint(rng,
    ...)``)."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))


def encoder_sites(n_layers: int, n_heads: int):
    """Dropout site numbers of the fused user encoder, in forward order:
    ``input`` (the input LayerNorm output, (L, D)) and per block ``probs``
    (a list, one (L, L) site per head), ``attn_out`` and ``ffn_out``
    (both (L, D))."""
    per = n_heads + 2
    return {"input": 0,
            "blocks": [{"probs": [1 + i * per + h for h in range(n_heads)],
                        "attn_out": 1 + i * per + n_heads,
                        "ffn_out": 2 + i * per + n_heads}
                       for i in range(n_layers)]}


def curand_check(seed: int, site: int, batch: int, n: int, device):
    """(ours, curand's) (batch, n) words from the card: the kernels' Philox
    bits and ``curand_kernel.h``'s Philox4_32_10 at the same address
    (``csrc/philox_check.cu``), as int64 tensors holding uint32."""
    from ..kernels.build import check, library

    ours = torch.empty((batch, n), dtype=torch.int32, device=device)
    theirs = torch.empty_like(ours)
    err = library().iisan_philox_check(
        seed, site, batch, n, ours.data_ptr(), theirs.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    check(err, "philox_check")
    return ours.long() & _MASK32, theirs.long() & _MASK32
