"""W8A8 linear: the CUDA kernels of #10, their wrappers and the autograd.

Port of ``iisan_tpu/ops/int8_pallas.py`` (``_w8a8_kernel``): y =
dequant(quant_rows(x) @ kernel_q) + bias, with per-row absmax / 127,
``rint`` and a clip to +-127 (``ops/int8_linear.int8_matmul``).  Two
kernels a call (``csrc/w8a8_linear.cu`` has the design):

* ``w8a8_quant_rows`` quantises x (M, K) into int8 rows of K_p = K rounded
  up to 16 (zero columns past K: TMA needs 16-byte row strides) and the
  fp32 row scales;
* ``w8a8_gemm`` multiplies them with the weight's (N, K_p) transpose on
  the int8 ``wgmma`` tensor cores (s32 sums, TMA loads, 128 x 256 tiles,
  ``csrc/sm90_gemm.cuh``) and dequantises in its epilogue.

The int32 sums are exact in any order and the kernels round every other
step as ``int8_matmul`` does (IEEE division, ``rint``, separately rounded
products and sums), so on the card the two agree bit for bit.  The zero
columns add nothing to the sums: ``w8a8_gemm_plain`` on the padded
operands is ``int8_matmul`` bit for bit.  On a CPU tensor each wrapper runs
its plain version; on a CUDA tensor it launches its kernel or raises.

``W8A8Fn`` is the autograd function: its backward differentiates
``int8_matmul`` (the JAX custom VJP's rule), in x, kscale and bias.  The
frozen towers never run it: their taps are detached.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import flops
from .int8_linear import int8_matmul, quantize_rows

TILE_M, TILE_N, STAGES = 128, 256, 3   # the GEMM's tile and ring depth
SLICE_K = 128                # int8 K values of a slice
K_ALIGN = 16                 # TMA row strides are multiples of 16 bytes
# |acc| <= K 127^2 stays below 2^31 (int32 sums exact): the largest
# multiple of K_ALIGN that does.
K_MAX = (2 ** 31 - 1) // (127 * 127) // K_ALIGN * K_ALIGN
_DTYPES = (torch.float32, torch.bfloat16)


def padded_k(K: int) -> int:
    """K_p: K rounded up to ``K_ALIGN``, the row length of xq and of the
    transposed weight."""
    return -(-K // K_ALIGN) * K_ALIGN


def smem_bytes() -> int:
    """Shared memory of a GEMM block (``GemmLayout`` in
    csrc/sm90_gemm.cuh): STAGES stages of a 128 x 128-byte slice of xq and
    a 256 x 128-byte slice of the weight, a 64 x 256 bf16 output tile for
    each of the two consumer warpgroups, the ring's barriers and 1 KB of
    alignment."""
    return (STAGES * (TILE_M + TILE_N) * SLICE_K + 2 * 64 * TILE_N * 2
            + 2 * STAGES * 8 + 1024)


def supported(K: int, N: int) -> bool:
    """Geometries the kernels take: every N >= 1 and every K from 1 to
    ``K_MAX`` (133,136, where the int32 sums stop being exact).  Rows past
    a tile and columns past K or N come in as TMA zeros and are not
    stored."""
    return 1 <= K <= K_MAX and N >= 1


def out_stride(N: int, out_dtype) -> int:
    """Row stride of the GEMM's result: a bf16 result is stored with TMA,
    whose rows are a multiple of 16 bytes apart (N rounded up to 8; the
    wrapper slices the padding off); an fp32 one is stored from registers
    (N)."""
    return -(-N // 8) * 8 if out_dtype == torch.bfloat16 else N


def transposed_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """The (N, K_p) int8 transpose of ``kernel_q`` (K, N) with zero
    columns past K: the GEMM's weight layout (``Int8Dense`` caches it)."""
    K, N = kernel_q.shape
    wt = kernel_q.new_zeros((N, padded_k(K)))
    wt[:, :K] = kernel_q.t()
    return wt


def w8a8_quant_rows_plain(x2: torch.Tensor):
    """(xq (M, K_p) int8 with zero columns past K, sx (M,) fp32):
    ``quantize_rows`` in the kernel's layout."""
    M, K = x2.shape
    xq, sx = quantize_rows(x2)
    q = torch.zeros((M, padded_k(K)), dtype=torch.int8, device=x2.device)
    q[:, :K] = xq.to(torch.int8)
    return q, sx.reshape(M)


def w8a8_gemm_plain(xq, sx, wt, kscale, bias, out_dtype) -> torch.Tensor:
    """``int8_matmul``'s product and dequantisation on the padded
    operands: xq (M, K_p) int8, sx (M,), wt (N, K_p) int8."""
    acc = (xq.double() @ wt.double().t()).float()
    y = acc * (sx[:, None] * kscale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def w8a8_quant_rows(x2: torch.Tensor):
    """The quantise kernel: x2 (M, K) float32 or bfloat16, contiguous ->
    (xq (M, K_p) int8, sx (M,) fp32).  A CPU tensor runs the plain
    version; ``w8a8_quant_rows.launches`` counts the kernel's launches."""
    if not x2.is_cuda:
        return w8a8_quant_rows_plain(x2)
    from ..kernels.build import check, library

    M, K = x2.shape
    if x2.dtype not in _DTYPES or not x2.is_contiguous():
        raise ValueError("w8a8_quant_rows takes a contiguous float32 or "
                         f"bfloat16 (M, K) tensor, got {x2.dtype}")
    xq = torch.empty((M, padded_k(K)), dtype=torch.int8, device=x2.device)
    sx = torch.empty(M, dtype=torch.float32, device=x2.device)
    if M:
        err = library().iisan_w8a8_quant_rows(
            x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), M, K,
            int(x2.dtype == torch.bfloat16),
            torch.cuda.current_stream(x2.device).cuda_stream)
        check(err, "w8a8_quant_rows")
        w8a8_quant_rows.launches += 1
    return xq, sx


w8a8_quant_rows.launches = 0


def w8a8_gemm(xq, sx, wt, kscale, bias, out_dtype) -> torch.Tensor:
    """The GEMM kernel: xq (M, K_p) int8, sx (M,) fp32, wt (N, K_p) int8,
    kscale (N,) and bias (N,) fp32 (bias may be None) -> (M, N) in
    out_dtype.  A CPU tensor runs the plain version;
    ``w8a8_gemm.launches`` counts the kernel's launches."""
    if not xq.is_cuda:
        return w8a8_gemm_plain(xq, sx, wt, kscale, bias, out_dtype)
    from ..kernels.build import check, library

    M, Kp = xq.shape
    N = wt.shape[0]
    ld = out_stride(N, out_dtype)
    out = torch.empty((M, ld), dtype=out_dtype, device=xq.device)
    if M:
        err = library().iisan_w8a8_gemm(
            xq.data_ptr(), sx.data_ptr(), wt.data_ptr(), kscale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M, N,
            Kp, ld, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(xq.device).cuda_stream)
        check(err, "w8a8_gemm")
        w8a8_gemm.launches += 1
        w8a8_gemm.flops += flops.w8a8(M, Kp, N)
    return out if ld == N else out[:, :N]


w8a8_gemm.launches = 0
w8a8_gemm.flops = 0


def _check(x, kernel_q, kscale, bias, out_dtype, kernel_qt):
    K, N = kernel_q.shape
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"fused_w8a8_matmul takes float32 or bfloat16, got "
                        f"x {x.dtype}, out {out_dtype}")
    if not supported(K, N):
        raise ValueError(f"fused_w8a8_matmul does not take K={K} N={N} "
                         f"(K from 1 to {K_MAX}: int32 sums exact)")
    if x.shape[-1] != K:
        raise ValueError(f"x has {x.shape[-1]} features, the weight {K}")
    if x.numel() // K >= 2 ** 31:
        raise ValueError(f"fused_w8a8_matmul does not take {x.numel() // K} "
                         "rows (TMA coordinates are 32-bit)")
    if kernel_q.dtype != torch.int8 or kernel_qt.dtype != torch.int8 \
            or tuple(kernel_qt.shape) != (N, padded_k(K)) \
            or not kernel_qt.is_contiguous() or kernel_qt.data_ptr() % 16:
        raise ValueError("kernel_q must be (K, N) int8 and kernel_qt its "
                         "(N, K_p) transpose, contiguous and 16-byte aligned "
                         "(transposed_weight)")
    for name, t in (("kscale", kscale), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (N,) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be ({N},) float32")
    for t in (kernel_q, kernel_qt, kscale, bias):
        if t is not None and t.device != x.device:
            raise ValueError("fused_w8a8_matmul: all inputs on one device")


def _forward(x, kernel_q, kscale, bias, out_dtype, kernel_qt):
    if not x.is_cuda:
        return int8_matmul(x, kernel_q, kscale, bias, out_dtype)
    if kernel_qt is None:
        kernel_qt = transposed_weight(kernel_q)
    _check(x, kernel_q, kscale, bias, out_dtype, kernel_qt)
    lead, (K, N) = x.shape[:-1], kernel_q.shape
    x2 = x.detach().reshape(-1, K).contiguous()
    kscale = kscale.detach().contiguous()
    bias = None if bias is None else bias.detach().contiguous()
    if x2.shape[0]:
        xq, sx = w8a8_quant_rows(x2)
        out = w8a8_gemm(xq, sx, kernel_qt, kscale, bias, out_dtype)
        fused_w8a8_matmul.launches += 1
    else:
        out = torch.empty((0, N), dtype=out_dtype, device=x.device)
    return out.reshape(*lead, N)


class W8A8Fn(torch.autograd.Function):
    """The W8A8 linear under autograd: forward the kernels (CPU: the plain
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
    """The W8A8 linear: y = dequant(quant_rows(x) @ kernel_q) + bias.

    x (..., K) float32 or bfloat16; kernel_q (K, N) int8; kscale (N,)
    fp32; bias (N,) fp32 or None; kernel_qt the (N, K_p) padded transpose
    of kernel_q (``transposed_weight``) if the caller keeps one (else it is
    made here).  Returns (..., N) in out_dtype.  On a CUDA tensor the
    quantise and GEMM kernels run, or the call raises on what they do not
    take; ``fused_w8a8_matmul.launches`` counts the calls that launched
    them."""
    return W8A8Fn.apply(x, kernel_q, kscale, bias, out_dtype, kernel_qt)


fused_w8a8_matmul.launches = 0
