"""Int8 tap tables: symmetric absmax quantisation per (item, tap) row.

Port of ``iisan_tpu/ops/quant.py``.  A cached tap table
``(item_num+1, K, D)`` stays on the device for the whole run; at the
IISAN-Versa geometry (Llama-3-70B text states, K=7, D=8192) one bf16 table
over a Scientific-size catalogue is 2.39 GB, and int8 rows with one fp32
scale per (item, tap) row halve that and the bytes each training batch
gathers.

``quantize_taps`` gives the JAX function's numbers bit for bit (fp32
arithmetic with true divisions, round half to even), on the CPU for a
numpy array and on the tensor's own device for a tensor.  ``gather_rows``
is the one way every consumer reads a table, plain or quantised: it
gathers the int8 rows and their scales, multiplies in fp32 and casts to
the table's ``out_dtype``.  There is no kernel here (the JAX package has
none either): the gather and the multiply are plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch


class QuantTaps:
    """Int8 tap table: ``q`` (N, K, D) int8 and ``scale`` (N, K, 1) fp32
    tensors; ``out_dtype`` names the dtype dequantised rows come out in
    (the pipeline's compute dtype)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: str = "bfloat16"):
        self.q = q
        self.scale = scale
        self.out_dtype = str(out_dtype)

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() \
            + self.scale.numel() * self.scale.element_size()

    def to(self, device, out_dtype: str = None) -> "QuantTaps":
        return QuantTaps(self.q.to(device), self.scale.to(device),
                         out_dtype or self.out_dtype)

    def __repr__(self):
        return (f"QuantTaps(shape={tuple(self.q.shape)}, "
                f"out_dtype={self.out_dtype})")


def quantize_taps(x, out_dtype: str = "bfloat16",
                  chunk_rows: int = 2048) -> QuantTaps:
    """Symmetric absmax quantisation, one scale per (item, tap) row.

    x: (N, K, D) float numpy array or tensor.  Computes in fp32, ``chunk_rows``
    items at a time (so an fp32 copy of a multi-GB table never exists), on
    x's device.  All-zero rows (the pad item) keep scale 0 and quantise to
    0.  The divisions are tensor by tensor: PyTorch may turn a division by
    a Python scalar into a multiplication by its reciprocal, which is not
    the JAX package's (numpy's) arithmetic.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(tuple(x.shape[:-1]) + (1,), dtype=torch.float32,
                        device=x.device)
    for lo in range(0, x.shape[0], chunk_rows):
        xs = x[lo:lo + chunk_rows].float()
        absmax = xs.abs().amax(-1, keepdim=True)
        s = absmax / torch.full_like(absmax, 127.0)
        positive = s > 0
        inv = torch.where(positive,
                          torch.ones_like(s) / torch.where(positive, s,
                                                           torch.ones_like(s)),
                          torch.zeros_like(s))
        q[lo:lo + chunk_rows] = torch.clamp(torch.round(xs * inv), -127, 127).to(
            torch.int8)
        scale[lo:lo + chunk_rows] = s
    return QuantTaps(q, scale, out_dtype=out_dtype)


def dequantize(t: QuantTaps) -> torch.Tensor:
    """The whole table in ``out_dtype`` (tests and small tables)."""
    return (t.q.float() * t.scale).to(getattr(torch, t.out_dtype))


def n_rows(table) -> int:
    return table.shape[0]


def feature_shape(table):
    """(K, D) of one item's taps."""
    return tuple(table.shape[1:])


def gather_rows(table, ids) -> torch.Tensor:
    """``table[ids]`` (ids an index tensor or a slice) for a plain table;
    for ``QuantTaps`` the int8 rows and their scales are gathered and
    multiplied in fp32, then cast to ``out_dtype`` (as the float path casts
    fp32 host values)."""
    if isinstance(table, QuantTaps):
        q, s = table.q[ids], table.scale[ids]
        return (q.float() * s).to(getattr(torch, table.out_dtype))
    return table[ids]
