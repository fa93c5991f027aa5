"""Fused SASRec user-encoder forward: CUDA kernel wrapper and plain version.

Port of the forward half of ``iisan_tpu/ops/fused_user_encoder.py``.  The
kernel (``csrc/user_encoder_fwd.cu``) runs the whole eval-mode encoder in one
launch; see its header for the design.  Training-mode dropout and the
backward kernel come with the training port.

The kernel reads its parameters as one packed fp32 vector, in the order of
``flatten_encoder_params`` (the JAX kernel's own order):
``position_embedding, ln scale, ln bias`` then per block
``wq wk wv wo ln1s ln1b w1 b1 w2 b2 ln2s ln2b``.  ``pack_encoder_params``
builds it and ``unpack_encoder_params`` splits it back into views, so the
kernel and its plain version read the same tensor.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

_EPS = 1e-6
PER_BLOCK = 12  # wq wk wv wo ln1s ln1b w1 b1 w2 b2 ln2s ln2b
_SMEM_LIMIT = 227 * 1024  # bytes of shared memory a block may use
_DTYPES = (torch.float32, torch.bfloat16)


def flatten_encoder_params(encoder, n_layers: int) -> List[torch.Tensor]:
    """A ``TransformerEncoder``'s parameters in the JAX kernel's order."""
    flat = [encoder.position_embedding, encoder.layer_norm.scale,
            encoder.layer_norm.bias]
    for i in range(n_layers):
        blk = getattr(encoder, f"transformer_blocks_{i}")
        mha, ff = blk.multi_head_attention, blk.feed_forward
        flat += [mha.w_Q.kernel, mha.w_K.kernel, mha.w_V.kernel, mha.fc.kernel,
                 mha.layer_norm.scale, mha.layer_norm.bias,
                 ff.w_1.kernel, ff.w_1.bias, ff.w_2.kernel, ff.w_2.bias,
                 ff.layer_norm.scale, ff.layer_norm.bias]
    return flat


# Entries of the flattened list that the cast chain rounds to the compute
# dtype before use (position table, projections, FFN weights and biases);
# the LayerNorm parameters stay fp32.
_ROUNDED_HEAD = (True, False, False)
_ROUNDED_BLOCK = (True, True, True, True, False, False,
                  True, True, True, True, False, False)


def pack_encoder_params(flat: Sequence[torch.Tensor],
                        compute_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """One contiguous fp32 vector of the flattened parameters, for the
    kernel at ``compute_dtype``: the entries the cast chain rounds are
    stored rounded to it already, so the kernel's inner loops convert
    nothing.  Rounding twice changes nothing, so the plain version reads
    the same vector."""
    n_layers = (len(flat) - 3) // PER_BLOCK
    rounded = _ROUNDED_HEAD + _ROUNDED_BLOCK * n_layers
    return torch.cat([(p.detach().to(compute_dtype) if r else p.detach())
                      .float().reshape(-1) for p, r in zip(flat, rounded)])


def param_shapes(D: int, F: int, n_layers: int, n_position: int):
    block = [(D, D)] * 4 + [(D,), (D,), (D, F), (F,), (F, D), (D,), (D,), (D,)]
    return [(n_position, D), (D,), (D,)] + block * n_layers


def unpack_encoder_params(packed: torch.Tensor, D: int, F: int, n_layers: int,
                          n_position: int) -> List[torch.Tensor]:
    shapes = param_shapes(D, F, n_layers, n_position)
    sizes = [math.prod(s) for s in shapes]
    if packed.numel() != sum(sizes):
        raise ValueError(f"packed encoder params hold {packed.numel()} values, "
                         f"expected {sum(sizes)}")
    return [t.view(s) for t, s in zip(torch.split(packed, sizes), shapes)]


_WBUF = 16384  # floats of the kernel's staged-weight buffer


def smem_bytes(L: int, D: int, H: int, F: int) -> int:
    """Shared memory of one kernel block, all fp32: the staged-weight
    buffer, five (L, D) activations, the (L, F) FFN hidden and the
    (H, L, L) scores."""
    return 4 * (_WBUF + 5 * L * D + L * F + H * L * L)


def supported(B: int, L: int, D: int, H: int, F: int = None,
              n_position: int = None) -> bool:
    """Shapes the Hopper kernel accepts: any batch, heads dividing the
    width, widths in multiples of 8 (16-byte weight loads), a sequence no
    longer than the position table, and a working set that fits one
    block's shared memory."""
    F = 4 * D if F is None else F
    return (B >= 1 and L >= 1 and H >= 1 and D % H == 0
            and D % 8 == 0 and F % 8 == 0
            and (n_position is None or L <= n_position)
            and smem_bytes(L, D, H, F) <= _SMEM_LIMIT)


def _layernorm(x32, scale, bias):
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + _EPS) * scale.float() + bias.float()


def user_encoder_fwd_plain(x, mask3, params, *, n_layers: int, n_heads: int,
                           d_ff: int, n_position: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (cast chain of the JAX
    kernel's ``_encoder_fwd_body`` / ``_attn_fwd`` with train=False).

    x (B, L, D) in the compute dtype; mask3 (B, L, L) fp32 additive;
    params the packed fp32 vector (``pack_encoder_params`` at x's dtype).
    Returns (B, L, D) in x's dtype.
    """
    dt = x.dtype
    B, L, D = x.shape
    H, dk = n_heads, D // n_heads
    flat = unpack_encoder_params(params, D, d_ff, n_layers, n_position)

    def bdot(a, w):  # T-rounded operands, fp32 accumulation, T result
        return (a.to(dt).float() @ w.to(dt).float()).to(dt)

    def split(t):  # (B, L, D) -> (B, H, L, dk) fp32
        return t.float().reshape(B, L, H, dk).transpose(1, 2)

    pos, ln0s, ln0b = flat[:3]
    x = _layernorm((x + pos[:L].to(dt)).float(), ln0s, ln0b).to(dt)
    for i in range(n_layers):
        (wq, wk, wv, wo, s1, b1n, w1, b1, w2, b2, s2, b2n) = \
            flat[3 + PER_BLOCK * i:3 + PER_BLOCK * (i + 1)]
        q, k, v = split(bdot(x, wq)), split(bdot(x, wk)), split(bdot(x, wv))
        s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dk)) + mask3[:, None]
        p = torch.softmax(s, dim=-1).to(dt).float()
        o = (p @ v).to(dt).transpose(1, 2).reshape(B, L, D)
        o2 = bdot(o, wo)
        x1 = _layernorm(x.float() + o2.float(), s1, b1n).to(dt)
        hf = torch.relu(bdot(x1, w1) + b1.to(dt))
        h2 = bdot(hf, w2) + b2.to(dt)
        x = _layernorm(x1.float() + h2.float(), s2, b2n).to(dt)
    return x


def user_encoder_fwd(x, mask3, params, *, n_layers: int, n_heads: int,
                     d_ff: int, n_position: int) -> torch.Tensor:
    """Eval-mode encoder forward; the CUDA kernel for a CUDA ``x``.

    Same arguments and result as ``user_encoder_fwd_plain``, which runs
    for a CPU ``x``.  ``user_encoder_fwd.launches`` counts kernel launches.
    """
    if not x.is_cuda:
        return user_encoder_fwd_plain(x, mask3, params, n_layers=n_layers,
                                      n_heads=n_heads, d_ff=d_ff,
                                      n_position=n_position)
    from ..kernels.build import check, library

    B, L, D = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"user_encoder_fwd takes float32 or bfloat16, got {x.dtype}")
    if not supported(B, L, D, n_heads, d_ff, n_position):
        raise ValueError(f"user_encoder_fwd does not take B={B} L={L} D={D} "
                         f"H={n_heads} F={d_ff} n_position={n_position}")
    if mask3.shape != (B, L, L) or mask3.dtype != torch.float32:
        raise ValueError(f"mask must be ({B}, {L}, {L}) float32, got "
                         f"{tuple(mask3.shape)} {mask3.dtype}")
    if params.dtype != torch.float32 or params.numel() != sum(
            math.prod(s) for s in param_shapes(D, d_ff, n_layers, n_position)):
        raise ValueError("params must be the packed float32 encoder vector")
    for t in (mask3, params):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}")
    x, mask3, params = x.contiguous(), mask3.contiguous(), params.contiguous()
    if params.data_ptr() % 16:
        raise ValueError("packed params must be 16-byte aligned")
    out = torch.empty_like(x)
    err = library().iisan_user_encoder_fwd(
        x.data_ptr(), mask3.data_ptr(), params.data_ptr(), out.data_ptr(),
        B, L, D, n_heads, d_ff, n_layers, n_position,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "user_encoder_fwd")
    user_encoder_fwd.launches += 1
    return out


user_encoder_fwd.launches = 0


def apply_fused_encoder(params, x, additive_mask, *, n_layers: int,
                        n_heads: int, d_ff: int, n_position: int,
                        compute_dtype: torch.dtype = torch.bfloat16):
    """Fused TransformerEncoder forward (eval mode).

    params: the packed vector (``pack_encoder_params`` at
    ``compute_dtype``); x (B, L, D);
    additive_mask (B, 1, L, L) fp32.  Returns (B, L, D) in x's dtype.
    """
    B, L, _ = x.shape
    mask3 = additive_mask.reshape(B, L, L).float()
    out = user_encoder_fwd(x.to(compute_dtype), mask3, params,
                           n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
                           n_position=n_position)
    return out.to(x.dtype)
