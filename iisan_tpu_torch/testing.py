"""Checks that hold the user-encoder kernels to their plain versions.

Used by the CUDA tests and ``chip_smoke.py``; no model path imports it.

The backward is compared with the plain backward taken at the kernel's
own FFN ReLU decisions.  The bf16 tensor-core forward rounds like the
plain version's products in all but a few elements, each one bf16 ulp
apart; the fp32 route's three TF32 passes keep about 22 of fp32's 24
bits.  Either difference in a block's FFN input x1 or in its product can
carry a pre-activation that lies within rounding of zero across it, on
one side only.  That decision passes or stops a whole element of the
FFN's gradient, which can put a weight- or bias-gradient column past the
comparison's bound by itself.  So ``plain_bwd_at_decisions`` runs the
plain forward with the kernel's decisions, and accepts one that differs
from its own only

- where the difference between the kernel's x1 and the plain one (both
  read back) explains it: |pre| within ``explained``, the inputs'
  difference carried through w1 plus the kernel's product and bias-add
  error (a bf16 rounding of each, or 2^-18 of the terms in fp32) on each
  side;
- and within ``relu_band``: four units of the route's precision (bf16
  ulps, 2^-8; in fp32 2^-20) of the operands' scale, the root-sum-square
  of the product's terms plus the bias;
- for at most ``max_flips`` elements (16, or one in 4,096 of a call's
  pre-activations).

Measured on the H100: in bf16 2-4 of 164K decisions differ at 64
sequences of the training geometry, 29 of 165K at D = 1,376 (the
farthest at 0.2 of the band).  Past any limit it raises.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from .ops import fused_user_encoder as fue

BAND_ULPS = 4  # units of the route's precision a decision may move


def relu_band(x1, w1, b1, dtype, tf32: bool = False):
    """Per element of pre = x1 . w1 + b1 (operands rounded to ``dtype``),
    how far rounding can move it: ``BAND_ULPS`` units of
    sqrt(sum_j (x1_j w1_jk)^2) + |b1_k|, a unit a bf16 ulp (2^-8), or with
    ``tf32`` (the fp32 route's three TF32 passes) 2^-20."""
    x1 = x1.float().reshape(-1, x1.shape[-1])
    w1, b1 = w1.to(dtype).float(), b1.to(dtype).float()
    scale = torch.sqrt((x1 * x1) @ (w1 * w1)) + b1.abs()
    return (BAND_ULPS * (2.0 ** -20 if tf32 else 2.0 ** -8)) * scale


def explained(x1, other_x1, w1, b1, pre, dtype, tf32: bool = False):
    """Per element of pre = x1 . w1 + b1, how far another computation's
    pre can lie from it given that computation's FFN input ``other_x1``:
    (1 + u) |x1 - other_x1| . |w1| (the inputs' difference), u (|x1 . w1| +
    |pre|) (the product and the bias add each rounded to bf16 on both
    sides, u = 2^-6; with ``tf32``, the fp32 route's three TF32 passes,
    u = 2^-18 and u |x1| . |w1| more for their error in the terms) and
    D 2^-24 |x1| . |w1| (fp32 sums in another order)."""
    D = x1.shape[-1]
    x1 = x1.float().reshape(-1, D)
    other = other_x1.float().reshape(-1, D)
    w1 = w1.to(dtype).float()
    aw1 = w1.abs()
    u = 2.0 ** -18 if tf32 else 2.0 ** -6
    terms = u * (x1.abs() @ aw1) if tf32 else 0.0
    return ((1 + u) * ((x1 - other).abs() @ aw1)
            + u * ((x1 @ w1).abs() + pre.float().reshape(x1.shape[0], -1).abs())
            + terms + D * 2.0 ** -24 * (x1.abs() @ aw1))


def max_flips(n: int) -> int:
    """Decisions that may differ among n pre-activations."""
    return max(16, n >> 12)


class Flips(NamedTuple):
    """Decisions taken from the kernel that differ from the plain
    forward's: their count, its limit, and among them the largest |pre| /
    ``relu_band`` and |pre| / ``explained`` (0 when none)."""
    count: int
    limit: int
    band: float
    explained: float


def _forward_at(x, mask3, params, positive, kw):
    """The plain forward with the FFN's decisions ``positive`` (per block
    a (B, L, F) bool tensor, or None for its own): (flat, masks, stash,
    per-block pre-activations)."""
    B, L, D = x.shape
    NL, H = kw["n_layers"], kw["n_heads"]
    flat = fue.unpack_encoder_params(params, D, kw["d_ff"], NL, kw["n_position"])
    masks = fue.dropout_masks(kw.get("seed", 0), kw.get("rate", 0.0), B, L, D,
                              H, NL, x.device)
    pres: list = []

    def relu(pre):
        pres.append(pre)
        if positive is None:
            return torch.relu(pre)
        take = positive[len(pres) - 1]
        return torch.where(take, pre.clamp_min(torch.finfo(pre.dtype).tiny),
                           torch.zeros_like(pre))

    stash: list = []
    fue._encoder_fwd(x, mask3, flat, NL, H, masks, stash, relu)
    return flat, masks, stash, pres


def _windows(flat, stash, pres, other_x1, dtype, tf32: bool = False):
    """Per block (|pre|, ``relu_band``, ``explained``), flattened."""
    out = []
    for i, pre in enumerate(pres):
        k0 = 3 + fue.PER_BLOCK * i
        x1, w1, b1 = stash[1 + i][8], flat[k0 + 6], flat[k0 + 7]
        out.append((pre.float().abs().reshape(-1),
                    relu_band(x1, w1, b1, dtype, tf32).reshape(-1),
                    explained(x1, other_x1[i], w1, b1, pre, dtype, tf32).reshape(-1)))
    return out


def plain_bwd_at_decisions(x, mask3, params, gout, positive, other_x1,
                           tf32: bool = False, **kw):
    """``user_encoder_bwd_plain`` with the FFN's ReLU decisions
    ``positive`` of another computation whose FFN inputs were
    ``other_x1`` (per block (B, L, F) bool and (B, L, D)): (gx, the packed
    parameter gradient, ``Flips``).  Raises ValueError where a decision
    differs from the plain forward's outside ``explained`` or
    ``relu_band``, or more than ``max_flips`` do."""
    flat, masks, stash, pres = _forward_at(x, mask3, params, positive, kw)
    count, band, expl = 0, 0.0, 0.0
    for take, pre, (apre, bnd, exp) in zip(
            positive, pres, _windows(flat, stash, pres, other_x1, x.dtype, tf32)):
        differ = take.reshape(-1) != (pre.reshape(-1) > 0)
        count += int(differ.sum())
        if bool(differ.any()):
            band = max(band, float((apre[differ] / bnd[differ]).max()))
            expl = max(expl, float((apre[differ] / exp[differ]).max()))
    limit = max_flips(sum(p.numel() for p in pres))
    if count > limit or band > 1.0 or expl > 1.0:
        raise ValueError(f"{count} ReLU decisions differ from the plain forward's "
                         f"(at most {limit}); the farthest at {band:.3g} x the "
                         f"rounding band and {expl:.3g} x what the inputs' "
                         "difference explains")
    gx, gp = fue._encoder_bwd(x, flat, masks, stash, gout, kw["n_layers"],
                              kw["n_heads"], kw["n_position"])
    return gx, gp, Flips(count, limit, band, expl)


def plain_relu_inputs(x, mask3, params, **kw):
    """The plain forward's own FFN decisions and inputs: per block (B, L,
    F) bool and (B, L, D) x1."""
    _, _, stash, pres = _forward_at(x, mask3, params, None, kw)
    return [p > 0 for p in pres], [stash[1 + i][8] for i in range(len(pres))]


def flip_outside_band(x, mask3, params, positive, tf32: bool = False, **kw):
    """``positive`` with one decision flipped where the plain forward's
    pre-activation lies just outside ``relu_band`` (the smallest |pre| /
    band above 1; ``tf32`` the fp32 route's band): (the decisions, that
    ratio).  A planted fault that ``plain_bwd_at_decisions`` (with the
    same ``tf32``) must refuse."""
    flat, _, stash, pres = _forward_at(x, mask3, params, None, kw)
    own_x1 = [stash[1 + i][8] for i in range(len(pres))]
    best = None
    for i, (apre, band, _) in enumerate(_windows(flat, stash, pres, own_x1, x.dtype, tf32)):
        ratio = torch.where(apre > band, apre / band, torch.full_like(apre, float("inf")))
        j = int(ratio.argmin())
        if best is None or float(ratio[j]) < best[2]:
            best = (i, j, float(ratio[j]))
    i, j, ratio = best
    out = [p.clone() for p in positive]
    out[i].view(-1)[j] = not bool(pres[i].reshape(-1)[j] > 0)
    return out, ratio


def tc_relu_inputs(x, mask3, params, gout, **kw):
    """The bf16 backward kernel's FFN decisions and inputs in its forward
    recompute, read from the hf and x1 rows its sweep writes (offsets from
    the library, ``fue.library_tc_layout``): per block (B, L, F) bool,
    hf > 0, and (B, L, D) bf16 x1.  x bf16 on the card."""
    B, L, D = x.shape
    NL, H, F = kw["n_layers"], kw["n_heads"], kw["d_ff"]
    lay = fue.library_tc_layout(B, L, D, H, F, NL)
    rows = sweep(x, mask3, params, gout, kw)[1][:lay["part"]].view(torch.bfloat16)

    def read(i, name, n):
        w = fue._r8(n)
        at = i * lay["layer"] + lay[name]
        return rows[at:at + B * L * w].view(B * L, w)[:, :n].reshape(B, L, n)

    return ([read(i, "hf", F) > 0 for i in range(NL)],
            [read(i, "x1", D) for i in range(NL)])


def f32_relu_inputs(x, mask3, params, gout, **kw):
    """The fp32 backward kernel's FFN decisions and inputs in its forward
    recompute, read from the hf and x1 rows its sweep writes (offsets from
    the library, ``fue.library_f32_layout``): per block (B, L, F) bool,
    hf > 0, and (B, L, D) fp32 x1.  x fp32 on the card."""
    B, L, D = x.shape
    NL, H, F = kw["n_layers"], kw["n_heads"], kw["d_ff"]
    lay = fue.library_f32_layout(B, L, D, H, F, NL)
    work = sweep(x, mask3, params, gout, kw)[1]

    def read(i, name, n):
        at = i * lay["layer"] + lay[name]
        return work[at:at + 4 * B * L * n].view(torch.float32).view(B, L, n)

    return ([read(i, "hf", F) > 0 for i in range(NL)],
            [read(i, "x1", D) for i in range(NL)])


def plain_bwd_at_kernel_decisions(x, mask3, params, gout, **kw):
    """The plain backward the kernel backward is held to: on the card at
    the kernel's own ReLU decisions (``tc_relu_inputs`` in bf16,
    ``f32_relu_inputs`` in fp32; ``plain_bwd_at_decisions``), else the
    plain backward itself.  (gx, the parameter gradient, ``Flips`` or
    None)."""
    if x.is_cuda:
        tf32 = x.dtype != torch.bfloat16
        read = f32_relu_inputs if tf32 else tc_relu_inputs
        positive, x1 = read(x, mask3, params, gout, **kw)
        return plain_bwd_at_decisions(x, mask3, params, gout, positive, x1, tf32, **kw)
    return fue.user_encoder_bwd_plain(x, mask3, params, gout, **kw) + (None,)


def sweep(x, mask3, params, gout, kw):
    """The backward's sweep alone (x's route, fp32 tiles planned for x's
    card), into a new device buffer: (gx, the buffer)."""
    B, L, D = x.shape
    NL, H, F, n_pos = kw["n_layers"], kw["n_heads"], kw["d_ff"], kw["n_position"]
    n_sm = fue.sm_count(x.device)
    total = fue.encoder_plan(B, L, D, H, F, NL, x.dtype, backward=True,
                             n_sm=n_sm).work_bytes
    work = torch.empty(total, dtype=torch.uint8, device=x.device)
    gx = torch.empty_like(x)
    image = fue.weight_image(params, D, F, NL, n_pos, x.dtype)
    fue._bwd_sweep(x.contiguous(), mask3.contiguous(), params.contiguous(), image,
                   gout.contiguous(), gx, work, NL, H, F, n_pos,
                   kw.get("seed", 0), kw.get("rate", 0.0), n_sm)
    return gx, work


def wgrad_rows_dropped(x, mask3, params, gout, kw):
    """A planted fault: the backward (x's route) with its weight-gradient
    pass run on a buffer whose last block lost its gq|gk|gv rows: (gx, the
    parameter gradient).  Offsets from the library (``library_tc_layout``,
    ``library_f32_layout``)."""
    B, L, D = x.shape
    NL, H, F, n_pos = kw["n_layers"], kw["n_heads"], kw["d_ff"], kw["n_position"]
    gx, work = sweep(x, mask3, params, gout, kw)
    if x.dtype == torch.bfloat16:
        lay = fue.library_tc_layout(B, L, D, H, F, NL)
        start = (NL - 1) * lay["layer"] + lay["gqkv"]
        work[:lay["part"]].view(torch.bfloat16)[start:start + B * L * fue._r8(3 * D)] = 0
    else:
        lay = fue.library_f32_layout(B, L, D, H, F, NL)
        start = (NL - 1) * lay["layer"] + lay["qkv"]
        work[start:start + 4 * B * L * 3 * D] = 0
    gp = torch.empty(params.numel(), dtype=torch.float32, device=x.device)
    fue._bwd_wgrad(work, gp, B, L, D, NL, H, F, n_pos, x.dtype, fue.sm_count(x.device))
    return gx, gp
