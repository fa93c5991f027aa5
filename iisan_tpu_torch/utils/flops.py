"""Operation counts of the port's kernels, from their shapes.

A kernel runs outside PyTorch's dispatcher, so
``torch.utils.flop_counter.FlopCounterMode`` sees none of its work.  Each
kernel wrapper therefore adds its launch's count here to its own
``flops`` attribute where it launches (beside ``launches``), and
``UncachedTrainer.device_bench`` adds those to what the counter saw.  A
count is the products of the function the kernel computes, two operations
a multiply-add, as the bounds of ``chip_smoke.py`` take them:

- ``mha``: tower attention over B sequences of T tokens, width D, H
  heads: the forward's two products (``Q K^T``, ``P V``), 4 B H T^2
  (D / H); the backward's five, 10 B H T^2 (D / H);
- ``encoder``: the SASRec user encoder's forward over B sequences of L
  items, width D, FFN width F, ``n_layers`` blocks: per block the four
  projections, the two attention products and the FFN; its backward is
  three times that (the recomputed forward and the two gradients);
- ``subblock``: an attention subblock: the qkv and output projections
  around ``mha``'s forward;
- ``w8a8``: the int8 product of an (M, K) by (K, N) layer;
- ``cascade``: a SAN cascade of S branches over N rows, K taps of width
  D, bottleneck R: the down and up products of every tap.
"""

from __future__ import annotations


def mha(B: int, T: int, D: int, H: int, bwd: bool = False) -> int:
    return (10 if bwd else 4) * B * H * T * T * (D // H)


def encoder(B: int, L: int, D: int, F: int, n_layers: int,
            bwd: bool = False) -> int:
    fwd = B * n_layers * (8 * L * D * D + 4 * L * L * D + 4 * L * D * F)
    return 3 * fwd if bwd else fwd


def subblock(B: int, T: int, D: int, H: int) -> int:
    return 2 * B * T * D * 4 * D + mha(B, T, D, H)


def w8a8(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def cascade(S: int, N: int, K: int, D: int, R: int) -> int:
    return S * N * K * 4 * D * R


def kernel_wrappers():
    """The wrappers that count their kernels' operations."""
    from ..ops import fused_attention as fa
    from ..ops import fused_attn_subblock as fsb
    from ..ops import fused_san as fs
    from ..ops import fused_user_encoder as fue
    from ..ops import fused_w8a8 as fw

    return (fue.user_encoder_fwd, fue.user_encoder_bwd, fs.san_cascade_fwd,
            fs.san_cascade_streamed_fwd, fa.mha_fwd, fa.mha_bwd,
            fsb.fused_attn_subblock, fsb.fused_attn_subblock_v2, fw.w8a8_gemm)
