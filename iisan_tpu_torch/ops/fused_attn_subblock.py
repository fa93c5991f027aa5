"""Fused attention subblock: qkv projection + attention + output projection.

Port of ``iisan_tpu/ops/fused_attn_subblock.py``: one op for the attention
half of a BERT or ViT layer, from the post-LayerNorm hidden states to the
pre-residual attention output, with the two layouts of the JAX package:

- ``fused_attn_subblock`` (#8, ``csrc/attn_subblock_fwd.cu``), whose plain
  version is ``reference_subblock``:
      qkv = dt(x . Wqkv + bqkv)  (fp32 sums, fp32 bias)
      per head: p = dt(softmax(q_h k_h^T / sqrt(64) [+ key bias]))
                (train: p = dt(p * keep / (1 - rate)));  ctx_h = dt(p v_h)
      out = dt(ctx . Wo + bo)
- ``fused_attn_subblock_v2`` (#9, ``csrc/attn_subblock_v2_fwd.cu``), whose
  plain version is ``reference_subblock_v2``: the weights regrouped by
  ``group_weights`` into head groups of 4, the biases rounded to dt first,
  and the output ``bo + sum_g ctx_g . Wo_g`` accumulated in fp32 in group
  order, then rounded to dt.  A different function from #8's, kept as the
  JAX package has it.

On a CPU tensor each op runs its plain version; on a CUDA tensor it
launches its kernels (bf16 only) or raises.  On the card either op is three
kernels (``csrc/attn_subblock.cuh``): the qkv projection on ``wgmma``
(``qkv_projection`` runs it alone), #5's attention core, and the output
projection on ``wgmma`` with the group-sum epilogue; #9's q, k, v are #8's
values, so only its rounded biases and its output groups differ.  v2 with
heads that split into no groups of 4 is #8's function (the JAX op's
fallback), on the card too: ``kernel_for`` says which kernel a call runs.
Train-mode masks are Philox at the sites of ``ops/fused_attention``
(``layer * H + head``), so ``attention_dropout_masks`` and the mask replay
kernel regenerate them.

``SubblockFn`` is the autograd function, as the JAX custom VJPs: in eval
mode its backward differentiates the plain version; with dropout on it
raises ``NotImplementedError``, and ``models/towers.py`` sends methods that
train the towers to ``fused_mha`` instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import flops
from .fused_attention import (DK, MAX_GRID, MAX_T, attention_dropout_masks,
                              reference_mha, reference_mha_masked)
from .fused_attention import supported as _mha_supported

GROUP = 4                  # heads a group of the v2 layout
MAX_KEYS = MAX_T           # #5's attention core, which the subblocks run
MAX_ROWS = 2 ** 31 - 1     # B T: a TMA row coordinate is a signed 32-bit int


# ----------------------------------------------------------------------
# Geometry (mirrors csrc/attn_subblock.cuh)
# ----------------------------------------------------------------------


def supported(B: int, T: int, D: int, H: int) -> bool:
    """Shapes #8 takes: #5's (head width 64, 1 to 46,340 keys, B and H at
    most 65,535) with at most 2^31 - 1 rows B T.  The GEMMs' own conditions
    follow from D = 64 H: 64-deep K slices and 64-column TMA boxes, rows of
    a multiple of 16 bytes, 3D a whole number of 192-column tiles, and D a
    whole number of 128- or 64-column output tiles."""
    return _mha_supported(B, T, D, H) and B * T <= MAX_ROWS


def supported_v2(B: int, T: int, D: int, H: int, G: int = GROUP) -> bool:
    """Shapes #9 takes: #8's, with the heads in whole groups of G (an
    output group of 64 G rows of Wo), and D a multiple of 128 where there
    is more than one group (the grouped output tile)."""
    return (supported(B, T, D, H) and G >= 1 and H % G == 0
            and (G == H or D % 128 == 0))


def kernel_for(v2: bool, B: int, T: int, D: int, H: int) -> Optional[str]:
    """The kernel a CUDA call runs: ``"attn_subblock_v2_fwd"`` (#9) for v2
    with heads in whole groups of ``GROUP``, else ``"attn_subblock_fwd"``
    (#8; v2 with other head counts is #8's function with the original
    biases, as the JAX op's fallback); None where the shape is not taken."""
    if v2 and H % GROUP == 0:
        return "attn_subblock_v2_fwd" if supported_v2(B, T, D, H) else None
    return "attn_subblock_fwd" if supported(B, T, D, H) else None


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------


def _attend(q, k, v, bias, H: int, dt, masks):
    """#5's plain attention of (B, T, H * dk) q, k, v in dt; masks (B, H, T,
    T) fp32 scaled keep masks (train mode) or None."""
    if masks is None:
        return reference_mha(q, k, v, bias, H, dt)
    return reference_mha_masked(q, k, v, bias, H, dt, masks)


def reference_subblock(x, wqkv, bqkv, wo, bo, bias, n_heads: int, dt,
                       masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """#8's plain version: x (B, T, D) and the weights wqkv (D, 3D), wo (D,
    D) in dt; bqkv (3D,), bo (D,) and bias (B, T) fp32 (bias may be
    None); masks (B, H, T, T) for train mode or None.  (B, T, D) in dt."""
    D = x.shape[-1]
    qkv = (x.float() @ wqkv.float() + bqkv.float()).to(dt)
    ctx = _attend(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], bias,
                  n_heads, dt, masks)
    return (ctx.float() @ wo.float() + bo.float()).to(dt)


def group_weights(wqkv, bqkv, wo, n_heads: int, group_size: int = GROUP):
    """(D, 3D) / (3D,) / (D, D) -> per-group slices: wg (ng, D, 3 G dk)
    with head i of a group at columns [3 i dk, 3 (i + 1) dk) in [q | k |
    v] order; bg (ng, 3 G dk); wog (ng, G dk, D).  The JAX
    ``_group_weights``."""
    D = wqkv.shape[0]
    dk, ng = D // n_heads, n_heads // group_size
    w3 = wqkv.reshape(D, 3, n_heads, dk).permute(2, 0, 1, 3)
    wg = w3.reshape(ng, group_size, D, 3 * dk).permute(0, 2, 1, 3)
    wg = wg.reshape(ng, D, group_size * 3 * dk)
    bg = bqkv.reshape(3, n_heads, dk).permute(1, 0, 2).reshape(ng, -1)
    return wg, bg, wo.reshape(ng, group_size * dk, D)


def reference_subblock_v2(x, wg, bg, wog, bo, bias, n_heads: int,
                          group_size: int, dt,
                          masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """#9's plain version over grouped weights (``group_weights``): per
    group g, qkv_g = dt(x . wg[g] + bg[g]), its heads' attention ctx_g, and
    out = ((bo + ctx_0 . wog[0]) + ctx_1 . wog[1]) + ... in fp32.  The
    caller rounds bg and bo to dt (as ``fused_attn_subblock_v2`` does).
    Returns (B, T, D) fp32."""
    G, dk = group_size, x.shape[-1] // n_heads
    out = None
    for g in range(wg.shape[0]):
        qkv = (x.float() @ wg[g].float() + bg[g].float()).to(dt)
        qkv = qkv.reshape(*x.shape[:2], G, 3, dk)
        q, k, v = (qkv[..., i, :].flatten(2) for i in range(3))
        m = None if masks is None else masks[:, g * G:(g + 1) * G]
        contrib = _attend(q, k, v, bias, G, dt, m).float() @ wog[g].float()
        out = contrib + bo.float() if out is None else out + contrib
    return out


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _check(name, x, wqkv, bqkv, wo, bo, bias, n_heads, seed, rate, ok):
    B, T, D = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bfloat16 on the card, got {x.dtype}")
    if not ok:
        raise ValueError(f"{name} does not take B={B} T={T} D={D} H={n_heads} "
                         f"(head width {DK}, 1 to {MAX_KEYS} keys, B and H at "
                         f"most {MAX_GRID}, B T at most {MAX_ROWS}; v2: whole "
                         f"groups of {GROUP} heads or #8's function)")
    shapes = ((wqkv, (D, 3 * D)), (bqkv, (3 * D,)), (wo, (D, D)), (bo, (D,)))
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: weights of shape {shape} on {x.device} "
                             f"expected, got {tuple(t.shape)} on {t.device}")
    if bias is not None and (bias.shape != (B, T) or bias.dtype != torch.float32
                             or bias.device != x.device):
        raise ValueError(f"{name}: bias must be ({B}, {T}) float32 on {x.device}")
    if not 0 <= seed < 2 ** 31 or not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout seed {seed} or rate {rate} out of range")


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """t as the GEMMs' TMA loads read it: contiguous, 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(entry, x, wqkv, bqkv, wo, bo, bias, n_heads, seed, rate, layer,
            *group):
    """One call of a subblock entry point: the q | k | v and ctx scratch
    allocated here, the weights as the caller holds them ((in, out)
    layout, no transposed copy)."""
    from ..kernels.build import check, library

    B, T, D = x.shape
    x, wqkv, wo = (_tma_operand(t) for t in (x, wqkv, wo))
    bqkv, bo = bqkv.contiguous(), bo.contiguous()
    qkv = torch.empty((3, B, T, D), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    err = getattr(library(), entry)(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), None if bias is None else bias.data_ptr(),
        qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(), B, T, D, n_heads,
        *group, seed, rate, 1.0 / (1.0 - rate), layer,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, entry)
    return out


def _operands(v2: bool, x, wqkv, bqkv, wo, bo, n_heads: int):
    """(grouped, wqkv, bqkv, wo, bo) as either op takes them: weights in
    x's dtype, biases fp32, rounded to x's dtype first where the v2 head
    groups run.  v2 with heads that split into no groups of 4 is #8's
    function, as the JAX op's fallback."""
    dt = x.dtype
    grouped = v2 and n_heads % GROUP == 0
    bqkv, bo = bqkv.float(), bo.float()
    if grouped:
        bqkv, bo = bqkv.to(dt).float(), bo.to(dt).float()
    return grouped, wqkv.to(dt), bqkv, wo.to(dt), bo


def subblock_fwd_plain(x, wqkv, bqkv, wo, bo, bias, *, n_heads: int,
                       seed: int = 0, rate: float = 0.0, layer: int = 0,
                       v2: bool = False) -> torch.Tensor:
    """#8's (or, with ``v2``, #9's) function in plain PyTorch on x's
    device, with the Philox masks of (seed, layer) when ``rate`` > 0.
    Returns (B, T, D) in x's dtype."""
    dt = x.dtype
    B, T, _ = x.shape
    grouped, wqkv, bqkv, wo, bo = _operands(v2, x, wqkv, bqkv, wo, bo, n_heads)
    masks = (attention_dropout_masks(seed, B, T, n_heads, rate, layer, x.device)
             if rate > 0.0 else None)
    if not grouped:
        return reference_subblock(x, wqkv, bqkv, wo, bo, bias, n_heads, dt, masks)
    wg, bg, wog = group_weights(wqkv, bqkv, wo, n_heads)
    return reference_subblock_v2(x, wg, bg, wog, bo, bias, n_heads, GROUP, dt,
                                 masks).to(dt)


def _forward(v2: bool, x, wqkv, bqkv, wo, bo, bias, n_heads: int, seed: int,
             rate: float, layer: int) -> torch.Tensor:
    """Either op's forward: the kernels on a CUDA ``x`` (``kernel_for``
    names them), else the plain version."""
    if not x.is_cuda:
        return subblock_fwd_plain(x, wqkv, bqkv, wo, bo, bias, n_heads=n_heads,
                                  seed=seed, rate=rate, layer=layer, v2=v2)
    B, T, D = x.shape
    grouped, wqkv, bqkv, wo, bo = _operands(v2, x, wqkv, bqkv, wo, bo, n_heads)
    kernel = kernel_for(v2, B, T, D, n_heads)
    name = "fused_attn_subblock_v2" if v2 else "fused_attn_subblock"
    _check(name, x, wqkv, bqkv, wo, bo, bias, n_heads, seed, rate, kernel is not None)
    bias = None if bias is None else bias.contiguous()
    if grouped:
        out = _launch("iisan_attn_subblock_v2_fwd", x, wqkv, bqkv, wo, bo, bias,
                      n_heads, seed, rate, layer, GROUP)
        fused_attn_subblock_v2.launches += 1
        fused_attn_subblock_v2.flops += flops.subblock(B, T, D, n_heads)
        return out
    out = _launch("iisan_attn_subblock_fwd", x, wqkv, bqkv, wo, bo, bias,
                  n_heads, seed, rate, layer)
    fused_attn_subblock.launches += 1
    fused_attn_subblock.flops += flops.subblock(B, T, D, n_heads)
    return out


def qkv_projection_plain(x, wqkv, bqkv) -> torch.Tensor:
    """The subblocks' projection step in plain PyTorch: x (..., D) in dt,
    wqkv (D, 3D), bqkv (3D,) -> (3, ..., D) = q, k, v of dt(x . wqkv (fp32
    sums) + bqkv (fp32))."""
    D = x.shape[-1]
    out = (x.float() @ wqkv.float() + bqkv.float()).to(x.dtype)
    return torch.stack(out.split(D, dim=-1))


def qkv_projection(x, wqkv, bqkv) -> torch.Tensor:
    """The subblocks' projection step alone (``qkv_projection_plain``'s
    function): on a CUDA ``x`` (bf16, D a multiple of 64) the wgmma GEMM
    of ``csrc/sm90_gemm.cuh``, else the plain version.
    ``qkv_projection.launches`` counts kernel calls."""
    if not x.is_cuda:
        return qkv_projection_plain(x, wqkv, bqkv)
    from ..kernels.build import check, library

    D = x.shape[-1]
    M = x.numel() // D
    if x.dtype != torch.bfloat16 or D % DK or M < 1 or M > MAX_ROWS:
        raise ValueError(f"qkv_projection does not take {tuple(x.shape)} "
                         f"{x.dtype} (bf16, D a multiple of {DK})")
    if tuple(wqkv.shape) != (D, 3 * D) or tuple(bqkv.shape) != (3 * D,):
        raise ValueError(f"qkv_projection: wqkv ({D}, {3 * D}) and bqkv "
                         f"({3 * D},) expected")
    x, w = _tma_operand(x), _tma_operand(wqkv.to(x.dtype))
    b = bqkv.float().contiguous()
    out = torch.empty((3, *x.shape), dtype=x.dtype, device=x.device)
    check(library().iisan_subblock_qkv_gemm(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, D,
        torch.cuda.current_stream(x.device).cuda_stream), "iisan_subblock_qkv_gemm")
    qkv_projection.launches += 1
    return out


class SubblockFn(torch.autograd.Function):
    """Either subblock under autograd.  Forward: the kernel (CPU: the
    plain version).  Backward, eval mode: the gradient of the plain
    version in x and the four weights, recomputed from the saved inputs;
    with dropout on it raises, as the JAX custom VJPs do.

    apply(x, wqkv, bqkv, wo, bo, bias, n_heads, seed, rate, layer, v2)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, bias, n_heads: int, seed: int,
                rate: float, layer: int, v2: bool):
        ctx.kw = dict(n_heads=n_heads, rate=rate, v2=v2)
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, bias)
        return _forward(v2, x, wqkv, bqkv, wo, bo, bias, n_heads, seed, rate,
                        layer)

    @staticmethod
    def backward(ctx, g):
        if ctx.kw["rate"] > 0.0:
            raise NotImplementedError(
                "fused_attn_subblock backward with active attention dropout; "
                "use fused_mha (replay backward) or the module path for "
                "methods that train the towers")
        x, wqkv, bqkv, wo, bo, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (x, wqkv, bqkv, wo, bo)]
            y = subblock_fwd_plain(*leaves, bias, n_heads=ctx.kw["n_heads"],
                                   v2=ctx.kw["v2"])
            grads = torch.autograd.grad(y, leaves, g.to(y.dtype),
                                        allow_unused=True)
        return (*grads, None, None, None, None, None, None)


def fused_attn_subblock(x, wqkv, bqkv, wo, bo, n_heads: int,
                        key_bias: Optional[torch.Tensor] = None,
                        drop_rate: float = 0.0, seed: Optional[int] = None,
                        layer: int = 0) -> torch.Tensor:
    """Fused qkv projection + attention + output projection (#8).

    x (B, T, D) post-LayerNorm hidden states; wqkv (D, 3D) the query | key |
    value kernels side by side; bqkv (3D,); wo (D, D), bo (D,); key_bias
    (B, T) additive (0 / -1e9) or None; train mode when ``seed`` (in [0,
    2^31)) is given and ``drop_rate`` > 0, with masks at sites ``layer * H
    + h``.  Returns the pre-residual output (B, T, D) in x's dtype.
    ``fused_attn_subblock.launches`` counts calls that ran the kernel."""
    train = seed is not None and drop_rate > 0.0
    bias = None if key_bias is None else key_bias.float()
    return SubblockFn.apply(x, wqkv, bqkv, wo, bo, bias, n_heads,
                            seed if train else 0, drop_rate if train else 0.0,
                            layer, False)


def fused_attn_subblock_v2(x, wqkv, bqkv, wo, bo, n_heads: int,
                           key_bias: Optional[torch.Tensor] = None,
                           drop_rate: float = 0.0, seed: Optional[int] = None,
                           layer: int = 0) -> torch.Tensor:
    """The head-group layout (#9): ``fused_attn_subblock``'s contract, the
    weights regrouped by ``group_weights`` (groups of 4 heads), biases
    rounded to x's dtype, the output accumulated in fp32 over groups and
    rounded to x's dtype; heads that split into no groups of 4 give #8's
    function (counted on ``fused_attn_subblock.launches``).
    ``fused_attn_subblock_v2.launches`` counts calls that ran #9."""
    train = seed is not None and drop_rate > 0.0
    bias = None if key_bias is None else key_bias.float()
    return SubblockFn.apply(x, wqkv, bqkv, wo, bo, bias, n_heads,
                            seed if train else 0, drop_rate if train else 0.0,
                            layer, True)


fused_attn_subblock.launches = 0
fused_attn_subblock_v2.launches = 0
fused_attn_subblock.flops = 0
fused_attn_subblock_v2.flops = 0
qkv_projection.launches = 0
