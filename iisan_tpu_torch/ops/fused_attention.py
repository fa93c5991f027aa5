"""Fused encoder self-attention: CUDA kernels, plain versions and autograd.

Port of ``iisan_tpu/ops/fused_attention.py``, the attention of every BERT
and ViT layer of the uncached towers.  Three kernels:

- ``mha_fwd`` (``csrc/mha_fwd.cu``): per head, scores, an fp32 softmax with
  the optional key bias, train-mode dropout, and the product with V; in
  bf16 the operands arrive by TMA and both products run on wgmma, keys
  held whole up to 320 (one pass a query tile) and streamed beyond (two),
  so T up to 46,340 fits; heads unsplit in and out;
- ``mha_bwd`` (``csrc/mha_bwd.cu``): recomputes the probabilities (and the
  dropout masks) from (q, k, v, bias, seed) and returns gq, gk, gv; two
  kernels, one over query tiles (gQ and each row's softmax statistics and
  row term, into an fp32 scratch) and one over key tiles (gK, gV), for any
  T the forward takes; in bf16 all ten of their products run on the tensor
  cores;
- ``mha_mask_replay`` (``csrc/mha_mask_replay.cu``): the scaled keep masks
  the two draw, as a (B, H, T, T) tensor, the oracle of train mode; one
  Philox call per four elements, written at the card's write rate.

``FusedMHAFn`` ties the first two into autograd, as the JAX package's
custom VJP does; ``fused_mha`` is the entry point.  On a CPU tensor each
wrapper runs its plain PyTorch version; on a CUDA tensor it launches the
kernel or raises.

The cast chain is the Pallas kernels' (T is the compute dtype): scores
``(q_h . k_h^T) * (1/sqrt(dk)) [+ bias]`` in fp32 from T operands, ``p =
exp(s - max) / sum`` in fp32, ``pd = T(T(p) * keep)`` (train) or ``T(p)``,
``o = T(pd . v_h)``.  The backward follows ``_mha_bwd_kernel``: ``gS`` is
rounded to T before its two products, and every product takes T operands
with fp32 sums.

Dropout masks are Philox (``ops/philox.py``) at (seed, image b, site =
``layer * H + head``, element ``query * T + key``): one seed per tower
call, one site per (layer, head), so no mask depends on the block layout
and no two layers share one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import philox
from ..utils import flops

DK = 64                     # head width the kernels take
MAX_GRID = 65535            # B and H are grid dimensions
MAX_T = 46340               # dropout elements i * T + j stay below 2^31
_DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------------------
# Geometry (mirrors csrc/mha.cuh)
# ----------------------------------------------------------------------


def supported(B: int, T: int, D: int, H: int, itemsize: int = 2) -> bool:
    """Shapes the forward kernel takes (either dtype): head width 64, and
    any T from 1 to 46,340 keys, which go through shared memory in tiles;
    B and H at most 65,535 (grid dimensions)."""
    del itemsize  # the tiles do not depend on it
    return (1 <= B <= MAX_GRID and 1 <= H <= MAX_GRID and 1 <= T <= MAX_T
            and D == H * DK)


def bwd_design(T: int, itemsize: int) -> str:
    """The backward design a call runs (``iisan_mha_bwd`` in
    csrc/mha_bwd.cu): ``"tensor_cores"`` in bf16 (mma.sync, at every T),
    ``"rows"`` in fp32 (the CUDA cores)."""
    del T  # both designs take every T
    return "tensor_cores" if itemsize == 2 else "rows"


def bwd_supported(B: int, T: int, D: int, H: int, itemsize: int = 2) -> bool:
    """Shapes the backward kernels take: the forward's (any T, either
    dtype)."""
    return supported(B, T, D, H, itemsize)


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------


def attention_dropout_masks(seed: int, B: int, T: int, H: int, rate: float,
                            layer: int, device=None) -> torch.Tensor:
    """(B, H, T, T) fp32 scaled keep masks of one train-mode call: head h
    of layer ``layer`` is Philox site ``layer * H + h``, element ``i * T +
    j``, row = image index."""
    return torch.stack([philox.dropout_mask(seed, layer * H + h, B, (T, T),
                                            rate, device)
                        for h in range(H)], 1)


def _split(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, dk) fp32."""
    B, T, D = t.shape
    return t.float().reshape(B, T, H, D // H).transpose(1, 2)


def _merge(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(B, H, T, dk) -> (B, T, H * dk) in dt."""
    B, H, T, dk = t.shape
    return t.transpose(1, 2).reshape(B, T, H * dk).to(dt)


def _probs(q, k, bias, H: int) -> torch.Tensor:
    """fp32 ``exp(s - max) / sum`` of s = (q_h . k_h^T) * (1/sqrt(dk))
    [+ bias], (B, H, T, T)."""
    dk = q.shape[-1] // H
    s = (_split(q, H) @ _split(k, H).transpose(-1, -2)) * (1.0 / math.sqrt(dk))
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def reference_mha(q, k, v, bias, H: int, dt: torch.dtype) -> torch.Tensor:
    """The forward kernel's eval-mode arithmetic: q, k, v (B, T, D) in dt,
    bias (B, T) fp32 or None; returns (B, T, D) in dt."""
    p = _probs(q, k, bias, H).to(dt)
    return _merge((p.float() @ _split(v, H)).to(dt), dt)


def reference_mha_masked(q, k, v, bias, H: int, dt: torch.dtype,
                         masks: torch.Tensor) -> torch.Tensor:
    """Train mode with explicit (B, H, T, T) fp32 scaled keep masks, which
    autograd treats as constants: the oracle of the kernels' train mode."""
    p = _probs(q, k, bias, H).to(dt)
    pd = (p.float() * masks).to(dt)
    return _merge((pd.float() @ _split(v, H)).to(dt), dt)


def _masks(seed: int, rate: float, layer: int, B: int, T: int, H: int,
           device) -> Optional[torch.Tensor]:
    return (attention_dropout_masks(seed, B, T, H, rate, layer, device)
            if rate > 0.0 else None)


def mha_fwd_plain(q, k, v, bias, *, n_heads: int, seed: int = 0,
                  rate: float = 0.0, layer: int = 0) -> torch.Tensor:
    """The forward kernel in plain PyTorch; ``rate`` > 0 is train mode with
    the Philox masks of (seed, layer)."""
    B, T, _ = q.shape
    masks = _masks(seed, rate, layer, B, T, n_heads, q.device)
    if masks is None:
        return reference_mha(q, k, v, bias, n_heads, q.dtype)
    return reference_mha_masked(q, k, v, bias, n_heads, q.dtype, masks)


def _softmax_bwd(p32: torch.Tensor, gp: torch.Tensor) -> torch.Tensor:
    """gS before its scale: p * (gP - sum_j gP p)."""
    return p32 * (gp - (gp * p32).sum(-1, keepdim=True))


def mha_bwd_plain(q, k, v, bias, g, *, n_heads: int, seed: int = 0,
                  rate: float = 0.0, layer: int = 0):
    """The backward kernel in plain PyTorch (``_mha_bwd_kernel``):
    recompute p and the masks, then gV = pd^T g, gP = (g v^T) * keep, gS =
    T(p (gP - sum gP p) / sqrt(dk)), gQ = gS k, gK = gS^T q.  g (B, T, D)
    in q's dtype; returns (gq, gk, gv) in q's dtype."""
    dt = q.dtype
    B, T, D = q.shape
    H = n_heads
    inv = 1.0 / math.sqrt(D // H)
    masks = _masks(seed, rate, layer, B, T, H, q.device)
    p32 = _probs(q, k, bias, H)
    pd = p32.to(dt).float()
    if masks is not None:
        pd = (pd * masks).to(dt).float()
    gh = _split(g.to(dt), H)
    g_pd = gh @ _split(v, H).transpose(-1, -2)
    g_v = pd.transpose(-1, -2) @ gh
    g_p = g_pd * masks if masks is not None else g_pd
    g_s = (_softmax_bwd(p32, g_p) * inv).to(dt).float()
    g_q = g_s @ _split(k, H)
    g_k = g_s.transpose(-1, -2) @ _split(q, H)
    return _merge(g_q, dt), _merge(g_k, dt), _merge(g_v, dt)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _check(name, q, k, v, bias, n_heads, seed, rate, ok):
    B, T, D = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if not ok:
        raise ValueError(f"{name} does not take B={B} T={T} D={D} H={n_heads} "
                         f"{q.dtype} (head width {DK}; T from 1 to {MAX_T}, "
                         f"B and H to {MAX_GRID})")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k, v must share shape, dtype and "
                             "device")
    if bias is not None and (bias.shape != (B, T) or bias.dtype != torch.float32
                             or bias.device != q.device):
        raise ValueError(f"{name}: bias must be ({B}, {T}) float32 on "
                         f"{q.device}")
    if not 0 <= seed < 2 ** 31 or not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout seed {seed} or rate {rate} out of range")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dropout_args(seed: int, rate: float, layer: int):
    """(seed, rate, keep scale, layer) for the C entry points; the scale
    is 1/(1-rate), rounded to fp32 by ctypes as the plain version rounds
    it."""
    return seed, rate, 1.0 / (1.0 - rate), layer


def mha_fwd(q, k, v, bias, *, n_heads: int, seed: int = 0, rate: float = 0.0,
            layer: int = 0) -> torch.Tensor:
    """Attention forward; the CUDA kernel for a CUDA ``q``.

    q, k, v (B, T, D) in the compute dtype; bias (B, T) fp32 additive key
    bias or None; ``rate`` > 0 is train mode with the Philox masks of
    (seed, layer).  Returns (B, T, D).  ``mha_fwd.launches`` counts kernel
    launches.
    """
    if not q.is_cuda:
        return mha_fwd_plain(q, k, v, bias, n_heads=n_heads, seed=seed,
                             rate=rate, layer=layer)
    from ..kernels.build import check, library

    B, T, D = q.shape
    _check("mha_fwd", q, k, v, bias, n_heads, seed, rate,
           supported(B, T, D, n_heads, q.element_size()))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mha_fwd: bf16 q, k and v must start on 16-byte "
                         "boundaries (the kernel reads them by TMA)")
    bias = None if bias is None else bias.contiguous()
    out = torch.empty_like(q)
    err = library().iisan_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), out.data_ptr(),
        B, T, D, n_heads, int(q.dtype == torch.bfloat16),
        *_dropout_args(seed, rate, layer),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "mha_fwd")
    mha_fwd.launches += 1
    mha_fwd.flops += flops.mha(B, T, D, n_heads)
    return out


mha_fwd.launches = 0
mha_fwd.flops = 0


def mha_bwd(q, k, v, bias, g, *, n_heads: int, seed: int = 0,
            rate: float = 0.0, layer: int = 0):
    """Attention backward; the CUDA kernel for a CUDA ``q``.

    The forward's arguments plus g (B, T, D) in q's dtype; returns (gq,
    gk, gv).  ``mha_bwd.launches`` counts kernel launches.
    """
    if not q.is_cuda:
        return mha_bwd_plain(q, k, v, bias, g, n_heads=n_heads, seed=seed,
                             rate=rate, layer=layer)
    from ..kernels.build import check, library

    B, T, D = q.shape
    _check("mha_bwd", q, k, v, bias, n_heads, seed, rate,
           bwd_supported(B, T, D, n_heads, q.element_size()))
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must be {tuple(q.shape)} {q.dtype} on {q.device}")
    q, k, v, g = q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous()
    bias = None if bias is None else bias.contiguous()
    gq, gk, gv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    # each query row's (max, sum, row term), from the first kernel to the second
    stats = torch.empty((B, n_heads, T, 3), dtype=torch.float32, device=q.device)
    err = library().iisan_mha_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), g.data_ptr(),
        gq.data_ptr(), gk.data_ptr(), gv.data_ptr(), stats.data_ptr(),
        B, T, D, n_heads, int(q.dtype == torch.bfloat16),
        *_dropout_args(seed, rate, layer),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "mha_bwd")
    mha_bwd.launches += 1
    mha_bwd.flops += flops.mha(B, T, D, n_heads, bwd=True)
    return gq, gk, gv


mha_bwd.launches = 0
mha_bwd.flops = 0


def mha_mask_replay(seed: int, B: int, T: int, H: int, rate: float,
                    layer: int, device, out: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The (B, H, T, T) fp32 scaled keep masks that ``mha_fwd`` and
    ``mha_bwd`` draw for (seed, rate, layer); the CUDA kernel on a CUDA
    ``device``, ``attention_dropout_masks`` on the CPU.  Written into
    ``out`` (contiguous (B, H, T, T) fp32 on ``device``) where given.  Both
    routes raise ``ValueError`` on the same inputs.
    ``mha_mask_replay.launches`` counts kernel launches."""
    if (not 0 <= seed < 2 ** 31 or not 1 <= B < 2 ** 31
            or not 1 <= H < 2 ** 31 or not 1 <= T <= MAX_T or layer < 0
            or (layer + 1) * H > 2 ** 32
            or not 0.0 <= rate < 1.0 or philox.to_fp32(rate) >= 1.0):
        raise ValueError(
            f"mha_mask_replay takes a seed in [0, 2^31), B, H >= 1, T in "
            f"[1, {MAX_T}], layer >= 0 with sites layer * H + h below 2^32 and "
            f"an fp32 rate in [0, 1); got seed {seed}, B {B}, T {T}, H {H}, "
            f"layer {layer}, rate {rate}")
    device = torch.device(device)
    if out is not None and (out.shape != (B, H, T, T) or out.dtype != torch.float32
                            or out.device.type != device.type
                            or not out.is_contiguous()):
        raise ValueError(f"mha_mask_replay: out must be a contiguous ({B}, {H}, "
                         f"{T}, {T}) fp32 tensor on {device}")
    if device.type != "cuda":
        masks = attention_dropout_masks(seed, B, T, H, rate, layer, device)
        return masks if out is None else out.copy_(masks)
    from ..kernels.build import check, library

    if out is None:
        out = torch.empty((B, H, T, T), dtype=torch.float32, device=device)
    err = library().iisan_mha_mask_replay(
        out.data_ptr(), B, T, H, seed, philox.keep_threshold(rate),
        1.0 / (1.0 - rate), layer * H, torch.cuda.current_stream(out.device).cuda_stream)
    check(err, "mha_mask_replay")
    mha_mask_replay.launches += 1
    return out


mha_mask_replay.launches = 0


class FusedMHAFn(torch.autograd.Function):
    """Fused attention under autograd: forward ``mha_fwd``, backward
    ``mha_bwd``, which regenerates the forward's masks from (seed, layer)
    instead of storing them.  Saves only q, k, v and the bias; the bias
    gets no gradient (it is the constant padding mask).

    apply(q, k, v, bias, n_heads, seed, rate, layer)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, n_heads: int, seed: int, rate: float,
                layer: int):
        ctx.kw = dict(n_heads=n_heads, seed=seed, rate=rate, layer=layer)
        ctx.save_for_backward(q, k, v, bias)
        return mha_fwd(q, k, v, bias, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        gq, gk, gv = mha_bwd(q, k, v, bias, g.to(q.dtype), **ctx.kw)
        return gq, gk, gv, None, None, None, None, None


def fused_mha(q, k, v, n_heads: int, key_bias: Optional[torch.Tensor] = None,
              drop_rate: float = 0.0, seed: Optional[int] = None,
              layer: int = 0) -> torch.Tensor:
    """Fused encoder self-attention under autograd.

    q, k, v (B, T, D) head-unsplit projection outputs; key_bias (B, T)
    additive (0 / -1e9) or None; train mode when ``seed`` (in [0, 2^31))
    is given and ``drop_rate`` > 0, with masks at sites ``layer * H + h``.
    Returns (B, T, D) context, heads merged.
    """
    train = seed is not None and drop_rate > 0.0
    bias = None if key_bias is None else key_bias.float()
    return FusedMHAFn.apply(q, k, v, bias, n_heads, seed if train else 0,
                            drop_rate if train else 0.0, layer)
