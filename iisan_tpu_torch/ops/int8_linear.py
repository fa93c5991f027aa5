"""Int8 (W8A8) linear layers of the frozen uncached towers.

Port of ``iisan_tpu/ops/int8_linear.py``.  Weights are quantised once, per
output channel (symmetric absmax to int8, ``quantize_kernel``, numpy, at
graft time); activations per row, on the fly, inside the step:

    sx = absmax_row(x) / 127;  xq = clip(rint(x / sx), -127, 127)  (int8)
    y  = dt(float(xq @ kernel_q) * (sx * kscale) + bias)

``int8_matmul`` is that function in plain PyTorch, in the JAX statement
order, and the plain version of kernel #10 (``ops/fused_w8a8.py``).  The
int8 x int8 product is exact in any summation order; ``torch.matmul``
has no int32 product on the card, so it is formed in fp64 from the int8
values, exact while K * 127^2 < 2^53 (fp32 is not: at K = 3072 a sum can
reach 5e7 > 2^24).  Divisions take a tensor divisor: PyTorch turns a
division by a Python scalar into a product with its reciprocal on the
card, which can differ by one ulp.

``Int8Dense`` holds ``kernel_q`` (in, out) int8 as a buffer (an int8
tensor cannot be an autograd parameter) and ``kscale``, ``bias`` as fp32
parameters: the JAX module's tree, which ``utils/jax_params`` carries bit
for bit.  On a CUDA input it launches #10, on a CPU input it runs
``int8_matmul``.  Rounding has a zero derivative, so the towers that use
it must be frozen (``models/towers.towers_from_config`` enforces that).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.modules import TorchLinear

# Uniform int8 in [-127, 127] has std 127/sqrt(3); the kscale init divides
# it out, so a fresh Int8Dense has nn.Dense's lecun-normal variance.
_INT8_UNIFORM_STD = 127.0 / math.sqrt(3.0)


def quantize_kernel(kernel) -> tuple:
    """Per-output-channel symmetric absmax quantisation of an (in, out)
    kernel: (kernel_q int8 (in, out), kscale fp32 (out,)).  The JAX
    package's numpy function, bit for bit."""
    k = np.asarray(kernel, dtype=np.float32)
    absmax = np.max(np.abs(k), axis=0)
    scale = (absmax / 127.0).astype(np.float32)
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    q = np.clip(np.rint(k * inv), -127, 127).astype(np.int8)
    return q, scale


def quantize_rows(x: torch.Tensor):
    """(xq, sx): per-row absmax int8 values of x (held in fp32) and the
    row scales (..., 1) fp32, in the JAX statement order."""
    xf = x.float()
    absmax = xf.abs().amax(-1, keepdim=True)
    sx = absmax / absmax.new_tensor(127.0)
    pos = sx > 0
    inv = torch.where(pos, absmax.new_tensor(1.0) / torch.where(
        pos, sx, absmax.new_tensor(1.0)), absmax.new_tensor(0.0))
    xq = torch.clamp(torch.round(xf * inv), -127.0, 127.0)
    return xq, sx


def int8_matmul(x, kernel_q, kscale, bias: Optional[torch.Tensor],
                out_dtype) -> torch.Tensor:
    """y = dequant(quant_rows(x) @ kernel_q) + bias, in out_dtype.

    x (..., K) float; kernel_q (K, N) int8; kscale (N,) fp32; bias (N,)
    fp32 or None.  Kernel #10's plain version; differentiable in x,
    kscale and bias (rounding passes no gradient; the row scale does)."""
    xq, sx = quantize_rows(x)
    acc = (xq.double() @ kernel_q.double()).float()
    y = acc * (sx * kscale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _kernel_init(shape, generator=None) -> torch.Tensor:
    """JAX's ``randint(-127, 128)``: int8 uniform in [-127, 127]."""
    return torch.randint(-127, 128, shape, generator=generator,
                         dtype=torch.int8)


class Int8Dense(nn.Module):
    """Dense layer with int8 weights and per-channel scales (JAX
    ``Int8Dense``): ``kernel_q`` buffer (in, out) int8, ``kscale`` (out,)
    and ``bias`` (out,) fp32 parameters.  A fresh layer draws uniform int8
    weights with lecun-matched scales; the graft path loads quantised
    float weights instead.

    ``fused`` (default True) launches kernel #10 on CUDA inputs; setting
    it False runs ``int8_matmul`` there, for comparing the two."""

    fused = True

    def __init__(self, in_features: int, features: int, dtype=None,
                 use_bias: bool = True, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", _kernel_init(
            (in_features, features), generator).to(device))
        std = (1.0 / math.sqrt(in_features)) / _INT8_UNIFORM_STD
        self.kscale = nn.Parameter(torch.full((features,), std, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        self._wt_key, self._wt = None, None

    def transposed_kernel(self) -> torch.Tensor:
        """(out, in) contiguous copy of ``kernel_q`` (the kernel's weight
        layout), made again only when ``kernel_q`` changes."""
        w = self.kernel_q
        key = (w.data_ptr(), w._version, w.device)
        if key != self._wt_key:
            self._wt, self._wt_key = w.t().contiguous(), key
        return self._wt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if x.is_cuda and self.fused:
            from .fused_w8a8 import fused_w8a8_matmul

            return fused_w8a8_matmul(x, self.kernel_q, self.kscale, self.bias,
                                     dt, kernel_qt=self.transposed_kernel())
        return int8_matmul(x, self.kernel_q, self.kscale, self.bias, dt)


def dense_or_int8(in_features: int, features: int, dtype, quant: str = "none",
                  device=None, generator=None):
    """The towers' dense factory: ``quant="none"`` gives flax's
    ``nn.Dense`` (lecun-normal ``TorchLinear``), ``"int8"`` an
    ``Int8Dense``; anything else raises, as the JAX factory does."""
    if quant == "int8":
        return Int8Dense(in_features, features, dtype, device=device,
                         generator=generator)
    if quant != "none":
        raise ValueError(
            f"unknown tower quant {quant!r}: expected 'none' or 'int8' "
            "(the 'int8_pallas' kernel was demoted to a benchmark-only "
            "path, Int8Dense(impl='pallas') - INT8_IMPL_BENCH.json)")
    return TorchLinear(in_features, features, dtype=dtype, init="lecun",
                       device=device, generator=generator)


def quantize_dense_tree(tree):
    """Every {kernel, bias} / {kernel} dict with a 2-D kernel in a float
    tree becomes Int8Dense's {kernel_q, kscale, bias} (numpy); every other
    node stays as it is.  The graft-time conversion of
    ``tower_quant="int8"``."""
    if not isinstance(tree, dict):
        return tree
    keys = set(tree)
    if ("kernel" in keys and keys <= {"kernel", "bias"}
            and np.ndim(tree["kernel"]) == 2):
        q, s = quantize_kernel(tree["kernel"])
        out = {"kernel_q": q, "kscale": s}
        if "bias" in tree:
            out["bias"] = np.asarray(tree["bias"], np.float32)
        return out
    return {k: quantize_dense_tree(v) for k, v in tree.items()}
