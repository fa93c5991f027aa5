"""W8A8 linear: the CUDA kernel #10, its wrapper and its autograd.

Port of ``iisan_tpu/ops/int8_pallas.py`` (``_w8a8_kernel``): one kernel
quantises the activation rows per row (absmax / 127, ``rint``, clip),
multiplies them with the int8 weight on the int8 tensor cores with int32
sums, and dequantises on the way out (``float(acc) * (sx * kscale) +
bias``, then the output dtype).  ``csrc/w8a8_linear.cu`` has the design.

The int32 sums are exact in any order, and the kernel rounds every other
step as ``ops/int8_linear.int8_matmul`` does (IEEE division, ``rint``,
separately rounded products and sums), so on the card the two agree bit
for bit.  On a CPU tensor ``fused_w8a8_matmul`` runs ``int8_matmul``; on
a CUDA tensor it launches the kernel or raises.

``W8A8Fn`` is the autograd function: its backward differentiates
``int8_matmul`` (the JAX custom VJP's rule), in x, kscale and bias.  The
frozen towers never run it: their taps are detached.
"""

from __future__ import annotations

from typing import Optional

import torch

from .int8_linear import int8_matmul

BN, BK, STAGES = 128, 64, 3   # csrc/w8a8_linear.cu's tiles
_SMEM_LIMIT = 227 * 1024
_DTYPES = (torch.float32, torch.bfloat16)


def smem_bytes(K: int, bm: int) -> int:
    """Shared memory of a block that owns bm rows: its quantised rows (row
    stride K + 16 bytes), STAGES weight tiles (BN x (BK + 16)), the row
    scales."""
    return bm * (K + 16) + STAGES * BN * (BK + 16) + bm * 4


def block_rows(K: int) -> int:
    """Rows a block owns: 64 where they fit shared memory at full K (K <=
    3,072), else 32 (``launch`` in the source)."""
    return 64 if smem_bytes(K, 64) <= _SMEM_LIMIT else 32


def supported(K: int, N: int) -> bool:
    """Geometries the kernel takes: K a multiple of 64, N of 128, and 32
    quantised rows in shared memory (K <= 6,272).  Every tower dense layer
    of BERT-base and ViT-base ((768, 768), (768, 3072), (3072, 768)) and of
    BERT-large ((1024, 1024), (1024, 4096), (4096, 1024)) fits."""
    return (K >= BK and N >= BN and K % BK == 0 and N % BN == 0
            and smem_bytes(K, 32) <= _SMEM_LIMIT)


def _check(x, kernel_q, kscale, bias, out_dtype, kernel_qt):
    K, N = kernel_q.shape
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"fused_w8a8_matmul takes float32 or bfloat16, got "
                        f"x {x.dtype}, out {out_dtype}")
    if not supported(K, N):
        raise ValueError(f"fused_w8a8_matmul does not take K={K} N={N} (K a "
                         f"multiple of {BK} up to 6272, N a multiple of {BN})")
    if x.shape[-1] != K:
        raise ValueError(f"x has {x.shape[-1]} features, the weight {K}")
    if kernel_q.dtype != torch.int8 or kernel_qt.dtype != torch.int8 \
            or tuple(kernel_qt.shape) != (N, K):
        raise ValueError("kernel_q must be (K, N) int8 and kernel_qt its "
                         "(N, K) transpose")
    for name, t in (("kscale", kscale), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (N,) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be ({N},) float32")
    for t in (kernel_q, kernel_qt, kscale, bias):
        if t is not None and t.device != x.device:
            raise ValueError("fused_w8a8_matmul: all inputs on one device")


def _forward(x, kernel_q, kscale, bias, out_dtype, kernel_qt):
    if not x.is_cuda:
        return int8_matmul(x, kernel_q, kscale, bias, out_dtype)
    from ..kernels.build import check, library

    if kernel_qt is None:
        kernel_qt = kernel_q.t().contiguous()
    _check(x, kernel_q, kscale, bias, out_dtype, kernel_qt)
    lead, (K, N) = x.shape[:-1], kernel_q.shape
    x2 = x.detach().reshape(-1, K).contiguous()
    kscale = kscale.detach().contiguous()
    bias = None if bias is None else bias.detach().contiguous()
    out = torch.empty((x2.shape[0], N), dtype=out_dtype, device=x.device)
    if x2.shape[0]:
        err = library().iisan_w8a8_linear(
            x2.data_ptr(), kernel_qt.data_ptr(), kscale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            x2.shape[0], K, N, int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "w8a8_linear")
        fused_w8a8_matmul.launches += 1
    return out.reshape(*lead, N)


class W8A8Fn(torch.autograd.Function):
    """The W8A8 linear under autograd: forward the kernel (CPU: the plain
    version), backward the gradient of ``int8_matmul`` in x, kscale and
    bias (recomputed from the saved inputs).

    apply(x, kernel_q, kscale, bias, out_dtype, kernel_qt)."""

    @staticmethod
    def forward(ctx, x, kernel_q, kscale, bias, out_dtype, kernel_qt):
        ctx.out_dtype = out_dtype
        ctx.save_for_backward(x, kernel_q, kscale, bias)
        return _forward(x, kernel_q, kscale, bias, out_dtype, kernel_qt)

    @staticmethod
    def backward(ctx, g):
        x, kernel_q, kscale, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) if t is not None else None
                      for t in (x, kscale, bias)]
            y = int8_matmul(leaves[0], kernel_q, leaves[1], leaves[2],
                            ctx.out_dtype)
            wanted = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(y, wanted, g, allow_unused=True))
        gx, gs, gb = (next(grads) if t is not None else None for t in leaves)
        return gx, None, gs, gb, None, None


def fused_w8a8_matmul(x, kernel_q, kscale, bias: Optional[torch.Tensor],
                      out_dtype, kernel_qt: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One-kernel W8A8 linear: y = dequant(quant_rows(x) @ kernel_q) + bias.

    x (..., K) float32 or bfloat16; kernel_q (K, N) int8; kscale (N,)
    fp32; bias (N,) fp32 or None; kernel_qt the (N, K) transpose of
    kernel_q if the caller keeps one (else it is made here).  Returns (...,
    N) in out_dtype.  On a CUDA tensor the kernel runs, or the call raises
    on what it does not take; ``fused_w8a8_matmul.launches`` counts its
    launches."""
    return W8A8Fn.apply(x, kernel_q, kscale, bias, out_dtype, kernel_qt)


fused_w8a8_matmul.launches = 0
