"""Fused SASRec user encoder: CUDA kernels, plain versions and autograd.

Port of ``iisan_tpu/ops/fused_user_encoder.py``.  Two kernels:

- ``user_encoder_fwd`` (``csrc/user_encoder_fwd.cu``) runs the whole
  encoder forward in one launch, eval or train mode;
- ``user_encoder_bwd`` recomputes the forward from ``(x, mask, seed)`` and
  back-propagates through it, writing ``gx`` and the packed parameter
  gradient.

Each has two routes, chosen by the compute dtype, both on the tensor
cores: bf16 (the main path) on mma.sync, a block a sequence
(``csrc/user_encoder_tc.cuh``; the backward is a per-sequence sweep and a
weight-gradient pass, ``csrc/user_encoder_bwd_tc.cu``), and fp32 in three
TF32 passes on wgmma, a block a tile of several sequences, its weights
streamed by bulk copies (``csrc/user_encoder_f32.cuh``,
``csrc/user_encoder_f32.cu``; the backward again a sweep and a
weight-gradient pass).  Each route reads a weight image of the packed
parameters (``weight_image``).  ``encoder_plan`` repeats their placement
and memory arithmetic.

``FusedEncoderFn`` ties them into autograd, as the JAX package's custom VJP
does; it is the one entry point on every device.  On a CPU tensor each
wrapper runs its plain PyTorch version (``user_encoder_fwd_plain``,
``user_encoder_bwd_plain``, transcriptions of the JAX kernels' bodies); on
a CUDA tensor it launches the kernel or raises.

Train-mode dropout draws its bits from Philox (``ops/philox.py``,
``csrc/philox.cuh``), addressed by (seed, sequence, site, element), so the
plain versions regenerate the kernels' masks bit for bit.

The kernels read their parameters as one packed fp32 vector, in the order
of ``flatten_encoder_params`` (the JAX kernel's own order):
``position_embedding, ln scale, ln bias`` then per block
``wq wk wv wo ln1s ln1b w1 b1 w2 b2 ln2s ln2b``.  ``pack_encoder_params``
builds it and ``unpack_encoder_params`` splits it back into views, so the
kernel and its plain version read the same tensor; the parameter gradient
comes back in the same layout.  Both round the entries that the cast chain
rounds where they use them, so they take the vector rounded or not.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from . import philox
from ..utils import flops

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
                        compute_dtype: torch.dtype = torch.float32,
                        differentiable: bool = False) -> torch.Tensor:
    """One contiguous fp32 vector of the flattened parameters.

    ``differentiable=True`` (the training path) is one ``cat`` of the fp32
    parameters, in the autograd graph: the packed gradient flows back to
    each parameter through it, as the JAX kernel's VJP hands its fp32
    gradient straight to the fp32 parameter.  Otherwise (serving, cached by
    ``UserEncoder.packed_params``) the entries the cast chain rounds are
    stored rounded to ``compute_dtype`` already.  The kernels and the plain
    versions round those entries where they use them, and rounding twice
    changes nothing, so the two packs give the same results."""
    if differentiable:
        return torch.cat([p.float().reshape(-1) for p in flat])
    n_layers = (len(flat) - 3) // PER_BLOCK
    rounded = _ROUNDED_HEAD + _ROUNDED_BLOCK * n_layers
    return torch.cat([
        (p.detach().to(compute_dtype) if r else p.detach()).float().reshape(-1)
        for p, r in zip(flat, rounded)])


def param_shapes(D: int, F: int, n_layers: int, n_position: int):
    block = [(D, D)] * 4 + [(D,), (D,), (D, F), (F,), (F, D), (D,), (D,), (D,)]
    return [(n_position, D), (D,), (D,)] + block * n_layers


@functools.lru_cache(maxsize=64)
def _param_count(D: int, F: int, n_layers: int, n_position: int) -> int:
    return sum(math.prod(s) for s in param_shapes(D, F, n_layers, n_position))


def unpack_encoder_params(packed: torch.Tensor, D: int, F: int, n_layers: int,
                          n_position: int) -> List[torch.Tensor]:
    shapes = param_shapes(D, F, n_layers, n_position)
    sizes = [math.prod(s) for s in shapes]
    if packed.numel() != sum(sizes):
        raise ValueError(f"packed encoder params hold {packed.numel()} values, "
                         f"expected {sum(sizes)}")
    return [t.view(s) for t, s in zip(torch.split(packed, sizes), shapes)]


# Where a kernel's areas live (``Placement`` in csrc/user_encoder.cuh): all
# in shared memory; the layer slots in a per-sequence global scratch (the
# bf16 route); all but the ring in a scratch in device memory.
RESIDENT, SLOTS_GLOBAL, SPILLED = 0, 1, 2

# The fp32 route (csrc/user_encoder_f32.cuh): a block takes a tile of
# whole sequences; its ring holds three 64 x 64 weight tiles (TF32 hi and
# lo halves, 16 KB each) and their barriers, after up to 1,024 bytes of
# alignment.
_F32_TILE = 64 * 64 * 4
_F32_RING = 1024 + 3 * 2 * _F32_TILE + 64


def _nt64(n: int) -> int:
    return (n + 63) // 64


def _lds(n: int) -> int:
    """Row stride (floats) of an fp32 area n columns wide: 4 mod 32."""
    return (n + 31) // 32 * 32 + 4


def _f32_area_floats(G: int, L: int, D: int, H: int, F: int, backward: bool) -> int:
    """Floats of a tile's areas (``area_floats``): the forward's res, xin,
    x1, q|k|v beside ctx (the FFN's hidden rows over both) and scores; the
    sweep's res, g, ga, g_o, gq|gk|gv, scores and keep factors."""
    Ma, GHLL = G * L, G * H * L * L
    sD, s3D, sF = _lds(D), _lds(3 * D), _lds(F)
    if backward:
        return Ma * (4 * sD + s3D) + 2 * GHLL
    return Ma * (3 * sD + max(s3D + sD, sF)) + GHLL


H100_SMS = 132  # SMs of the H100 SXM: the fp32 tile plan's default count


def sm_count(device=None) -> int:
    """SMs of ``device`` (the current CUDA card by default; ``H100_SMS``
    where there is none): the count the fp32 wrappers plan their tiles
    for."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(
            torch.cuda.current_device() if device is None else device).multi_processor_count
    return H100_SMS


def f32_tile_plan(L: int, D: int, H: int, F: int, backward: bool = False, B: int = 1,
                  n_sm: int = H100_SMS):
    """The fp32 route's tile (``tile_plan`` in csrc/user_encoder_f32.cuh):
    (sequences a tile, placement, shared-memory bytes, scratch bytes a
    tile).  As many sequences as give each of the card's n_sm SMs a tile of
    B, up to as many as fill 64 rows (one past L = 64); fewer where that
    keeps the areas in shared memory, else that many with the areas in a
    per-tile scratch."""
    want = min(64 // L if L <= 64 else 1, max(1, -(-B // n_sm)))
    for g in range(want, 0, -1):
        nbytes = _F32_RING + 4 * _f32_area_floats(g, L, D, H, F, backward)
        if nbytes <= _SMEM_LIMIT:
            return g, RESIDENT, nbytes, 0
    return want, SPILLED, _F32_RING, _r16(4 * _f32_area_floats(want, L, D, H, F, backward))


def f32_image_floats(D: int, F: int, n_layers: int, backward: bool = True) -> int:
    """fp32 entries of the fp32 kernels' weight image (``F32Image``): per
    layer the fp32 64 x 64 tiles of q|k|v, wo, w1 and w2, as their products
    read them (W^T's), and with ``backward`` the same tiles of W after
    them."""
    tD, t3D, tF = _nt64(D), _nt64(3 * D), _nt64(F)
    per_layer = t3D * tD + tD * tD + 2 * tF * tD
    return (2 if backward else 1) * per_layer * n_layers * 4096


def f32_work_layout(B: int, L: int, D: int, H: int, F: int, n_layers: int,
                    G: int, per_tile: int) -> dict:
    """The fp32 backward's device buffer (``F32Work`` in
    csrc/user_encoder_f32.cu), byte offsets: per layer the fp32 rows (B*L,
    width) of "xin", "ctx", "x1", "hf", "qkv" (then gq|gk|gv), "xh1"
    (LN1's xhat, then g_o2), "xh2" (LN2's xhat, then g_h2), "ghp" (g_hpre),
    "p" (the probabilities) and "rs" (the rstds), inside a layer's block of
    "layer" bytes; then "xh0", "rs0", the partial rows ("part", "Qp"
    floats a tile), the tiles' scratch and the total."""
    R4 = 4 * B * L
    out, at = {}, 0
    for name, w in (("xin", D), ("ctx", D), ("x1", D), ("hf", F), ("qkv", 3 * D),
                    ("xh1", D), ("xh2", D), ("ghp", F), ("p", H * L), ("rs", 2)):
        out[name] = at
        at = _r16(at + R4 * w)
    out["layer"] = at
    at *= n_layers
    nblk = -(-B // G)
    out["Qp"] = 2 * D + n_layers * (5 * D + F) + L * D
    for name, nbytes in (("xh0", R4 * D), ("rs0", R4), ("part", 4 * nblk * out["Qp"]),
                         ("scratch", nblk * per_tile)):
        out[name] = at
        at = _r16(at + nbytes)
    out["total"] = at
    return out


_LIBRARY_F32_LAYOUT = ("fwd_G", "fwd_place", "fwd_smem", "fwd_scratch", "bwd_G",
                       "bwd_place", "bwd_smem", "bwd_scratch", "image_fwd", "image",
                       "xin", "ctx", "x1", "hf", "qkv", "xh1", "xh2", "ghp", "p", "rs",
                       "layer", "xh0", "rs0", "part", "scratch", "total", "Qp")


def library_f32_layout(B: int, L: int, D: int, H: int, F: int,
                       n_layers: int, n_sm: Optional[int] = None) -> dict:
    """The fp32 route's layout as the kernels compute it for tiles planned
    for ``n_sm`` SMs (the card's by default; ``iisan_user_encoder_f32_layout``;
    needs the built library): each pass's tile (sequences, placement,
    shared-memory and per-tile scratch bytes), the weight image's entries
    (forward part, whole) and the backward buffer's offsets under
    ``f32_work_layout``'s names.  ``f32_tile_plan``, ``f32_image_floats``
    and ``f32_work_layout`` are the CPU's copy of this arithmetic, held to
    it on the card."""
    import ctypes

    from ..kernels.build import library

    out = (ctypes.c_longlong * len(_LIBRARY_F32_LAYOUT))()
    n = library().iisan_user_encoder_f32_layout(
        B, L, D, H, F, n_layers, L, sm_count() if n_sm is None else n_sm, out, len(out))
    if n != len(out):
        raise RuntimeError(f"iisan_user_encoder_f32_layout returned {n}")
    return dict(zip(_LIBRARY_F32_LAYOUT, out))


# The bf16 kernels' ring of staged weights (csrc/user_encoder_tc.cuh): two
# stages of 36,864 bytes.
_TC_RING = 2 * 36864


def _r8(n: int) -> int:
    return (n + 7) // 8 * 8


def _r16(n: int) -> int:
    """n rounded up to a multiple of 16 (rows, or bytes of an area)."""
    return (n + 15) // 16 * 16


def _tc_layout(L: int, D: int, H: int, F: int, n_layers: int, stash: bool):
    """(slot, head, work) bytes of one sequence's areas on the bf16 route,
    as ``TcLayout`` in csrc/user_encoder_tc.cuh: a layer's bf16 operands
    (rows padded to 16, row strides of 16 + a multiple of 16 bytes) and,
    with ``stash`` (the backward), its fp32 stash; the scores,
    pre-LayerNorm sums, mask and the parameters that are not matrices;
    the backward's working set."""
    dk = D // H
    Lp, dkp = _r16(L), _r16(dk)
    sD, sF, sdk, sL, s3D = (_r16(n) + 8 for n in (D, F, dk, L, 3 * D))
    LD4, HLL4 = 4 * L * D, 4 * H * L * L
    slot = [2 * Lp * sD, 2 * H * Lp * sdk, 2 * H * Lp * sdk, 2 * H * dkp * sL,
            2 * H * Lp * sL, 2 * Lp * sD, 2 * Lp * sD, 2 * Lp * sF]
    head = [HLL4, LD4, 4 * L * L, 4 * (2 * D + n_layers * (5 * D + F))]
    work = []
    if stash:
        slot += [HLL4, LD4, LD4, 4 * L, 4 * L]
        head += [LD4, 4 * L]
        work = [LD4] * 4 + [2 * Lp * sD, 4 * L * F, 2 * Lp * sF, HLL4, 2 * Lp * s3D]
    return tuple(sum(_r16(n) for n in area) for area in (slot, head, work))


def tc_image_elems(D: int, F: int, n_layers: int) -> int:
    """bf16 entries of the weight image the bf16 kernels stream (``WImage``
    in csrc/user_encoder_tc.cuh): per layer q|k|v side by side, wo, w1 and
    w2, rows padded to whole 16-byte units."""
    return n_layers * (D * _r8(3 * D) + D * _r8(D) + D * _r8(F) + F * _r8(D))


def tc_work_layout(B: int, L: int, D: int, F: int, n_layers: int,
                   per_seq: int) -> dict:
    """The bf16 backward's device buffer, as ``TcWork`` in
    csrc/user_encoder_bwd_tc.cu: per layer the bf16 rows (B*L, r8(width))
    of the weight-gradient operands ("xin", "ctx", "x1", "hf"; "gqkv",
    "go2", "ghpre", "gh2"; element offsets inside a layer's block of
    ``layer`` elements), then the byte offsets of the fp32 partial rows
    (B, Q), the fp32 input gradient (B, L, D), the areas' scratch
    (B x per_seq) and the total."""
    widths = dict(xin=_r8(D), ctx=_r8(D), x1=_r8(D), hf=_r8(F), gqkv=_r8(3 * D),
                  go2=_r8(D), ghpre=_r8(F), gh2=_r8(D))
    out, at = {}, 0
    for name, w in widths.items():
        out[name] = at
        at += B * L * w
    out["layer"] = at
    out["Q"] = 2 * D + n_layers * (5 * D + F)
    out["part"] = _r16(2 * at * n_layers)
    out["gx32"] = out["part"] + _r16(4 * B * out["Q"])
    out["scratch"] = out["gx32"] + _r16(4 * B * L * D)
    out["total"] = out["scratch"] + _r16(B * per_seq)
    return out


_LIBRARY_LAYOUT = ("fwd_place", "fwd_smem", "fwd_scratch", "bwd_place",
                   "bwd_smem", "bwd_scratch", "image", "xin", "ctx", "x1", "hf",
                   "gqkv", "go2", "ghpre", "gh2", "layer", "part", "gx32",
                   "scratch", "total")


def library_tc_layout(B: int, L: int, D: int, H: int, F: int,
                      n_layers: int) -> dict:
    """The bf16 route's layout as the kernels compute it
    (``iisan_user_encoder_tc_layout``; needs the built library): each
    pass's placement, shared-memory and per-sequence scratch bytes, the
    weight image's entries, and the backward buffer's offsets under
    ``tc_work_layout``'s names.  Code that reads the device buffers takes
    its offsets from here; ``encoder_plan``, ``tc_image_elems`` and
    ``tc_work_layout`` are the CPU's copy of this arithmetic, held to it on
    the card."""
    import ctypes

    from ..kernels.build import library

    out = (ctypes.c_longlong * len(_LIBRARY_LAYOUT))()
    n = library().iisan_user_encoder_tc_layout(B, L, D, H, F, n_layers, L, out,
                                               len(out))
    if n != len(out):
        raise RuntimeError(f"iisan_user_encoder_tc_layout returned {n}")
    return dict(zip(_LIBRARY_LAYOUT, out))


class EncoderPlan(NamedTuple):
    """How a kernel lays out a call: ``route`` "tensor cores" (bf16,
    mma.sync) or "tf32 wgmma" (fp32); where the areas live (``RESIDENT``,
    ``SLOTS_GLOBAL``, ``SPILLED``); the block's shared-memory bytes; the
    scratch bytes in device memory a sequence (bf16) or a tile (fp32); the
    backward's whole device buffer (0 in the forward); the sequences a
    block takes (fp32: planned for ``encoder_plan``'s ``n_sm`` SMs)."""
    route: str
    place: int
    smem_bytes: int
    scratch_bytes: int
    work_bytes: int
    tile_seqs: int = 1


@functools.lru_cache(maxsize=256)
def encoder_plan(B: int, L: int, D: int, H: int, F: int, n_layers: int,
                 dtype: torch.dtype, backward: bool = False,
                 n_sm: int = H100_SMS) -> EncoderPlan:
    """The placement and memory of the kernel a CUDA call at these shapes
    launches, the fp32 route's tiles planned for ``n_sm`` SMs (the
    wrappers pass the card's); the only arithmetic the kernels check it
    against is their own (a smaller buffer is refused)."""
    if dtype != torch.bfloat16:
        G, place, smem, scratch = f32_tile_plan(L, D, H, F, backward, B, n_sm)
        work = (f32_work_layout(B, L, D, H, F, n_layers, G, scratch)["total"]
                if backward else 0)
        return EncoderPlan("tf32 wgmma", place, smem, scratch, work, G)
    slot, head, work = _tc_layout(L, D, H, F, n_layers, backward)
    n = n_layers if backward else 1
    if _TC_RING + head + n * slot + work <= _SMEM_LIMIT:
        place, smem, scratch = RESIDENT, _TC_RING + head + n * slot + work, 0
    elif _TC_RING + head + work <= _SMEM_LIMIT:
        place, smem, scratch = SLOTS_GLOBAL, _TC_RING + head + work, n * slot
    else:
        place, smem, scratch = SPILLED, _TC_RING, head + n * slot + work
    total = tc_work_layout(B, L, D, F, n_layers, scratch)["total"] if backward else 0
    return EncoderPlan("tensor cores", place, smem, scratch, total)


# The kernels index the packed parameters with 32-bit ints.
MAX_PARAMS = 2 ** 31 - 1


def _block_params(D: int, F: int) -> int:
    return 4 * D * D + 2 * D * F + F + 5 * D


def supported(B: int, L: int, D: int, H: int, F: int = None,
              n_position: int = None) -> bool:
    """Shapes the forward kernels take: every width the JAX kernel takes
    (heads dividing D, D >= 8), any F >= 1 (4D by default), any batch, and
    any L up to the position table (what does not fit shared memory goes to
    a global scratch, ``encoder_plan``; the weights stream in tiles).  The one limit is arithmetic: the packed
    parameters are indexed with 32-bit ints, so a block's, with the
    position table, stays below 2^31 entries (D up to 13,376 at F = 4D;
    the whole vector is checked at the call)."""
    F = 4 * D if F is None else F
    return (B >= 1 and L >= 1 and H >= 1 and D >= 8 and D % H == 0 and F >= 1
            and (n_position is None or L <= n_position)
            and _block_params(D, F) + (n_position or L) * D + 2 * D <= MAX_PARAMS)


def bwd_supported(B: int, L: int, D: int, H: int, F: int, n_layers: int,
                  n_position: int = None) -> bool:
    """Shapes the backward kernels take: the forward's, at any depth whose
    packed parameters stay below 2^31 entries."""
    return (supported(B, L, D, H, F, n_position) and n_layers >= 1
            and n_layers * _block_params(D, F) + (n_position or L) * D + 2 * D
            <= MAX_PARAMS)


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------


def _layernorm(x32, scale, bias):
    """fp32 LayerNorm; returns (y, xhat, rstd)."""
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + _EPS)
    xhat = xc * rstd
    return xhat * scale.float() + bias.float(), xhat, rstd


def _layernorm_bwd(gy, xhat, rstd, scale):
    """``_layernorm_bwd`` of the JAX kernel, rows flattened: returns
    (gx, gscale, gbias)."""
    D = gy.shape[-1]
    gy, xhat, rstd = gy.reshape(-1, D), xhat.reshape(-1, D), rstd.reshape(-1, 1)
    gxhat = gy * scale.float()
    m1 = gxhat.mean(-1, keepdim=True)
    m2 = (gxhat * xhat).mean(-1, keepdim=True)
    return (rstd * (gxhat - m1 - xhat * m2), (gy * xhat).sum(0), gy.sum(0))


def dropout_masks(seed: int, rate: float, B: int, L: int, D: int, H: int,
                  n_layers: int, device=None) -> Optional[dict]:
    """The scaled keep masks of one train-mode call, site by site
    (``philox.encoder_sites``): ``input`` (B, L, D), and per block
    ``probs`` (B, H, L, L), ``attn_out`` and ``ffn_out`` (B, L, D).  None
    when ``rate`` is 0 (eval mode)."""
    if rate <= 0.0:
        return None
    sites = philox.encoder_sites(n_layers, H)

    def mask(site, shape):
        return philox.dropout_mask(seed, site, B, shape, rate, device)

    return {"input": mask(sites["input"], (L, D)),
            "blocks": [{"probs": torch.stack([mask(s, (L, L)) for s in blk["probs"]], 1),
                        "attn_out": mask(blk["attn_out"], (L, D)),
                        "ffn_out": mask(blk["ffn_out"], (L, D))}
                       for blk in sites["blocks"]]}


def _encoder_fwd(x, mask3, flat, n_layers: int, n_heads: int, masks,
                 stash: Optional[list] = None, relu=None):
    """The forward body (``_encoder_fwd_body`` / ``_attn_fwd`` of the JAX
    kernel) over the whole batch.  With ``stash`` a list, it is filled
    with what the backward needs.  ``relu`` is the FFN's activation,
    called once a block in order (``torch.relu``, looked up at the call,
    when None)."""
    dt = x.dtype
    B, L, D = x.shape
    H, dk = n_heads, D // n_heads

    def bdot(a, w):  # T-rounded operands, fp32 accumulation, T result
        return (a.to(dt).float() @ w.to(dt).float()).to(dt)

    def split(t):  # (B, L, D) -> (B, H, L, dk) fp32
        return t.float().reshape(B, L, H, dk).transpose(1, 2)

    pos, ln0s, ln0b = flat[:3]
    y0, xhat0, rstd0 = _layernorm((x + pos[:L].to(dt)).float(), ln0s, ln0b)
    x = y0.to(dt)
    if masks is not None:
        x = (x.float() * masks["input"]).to(dt)
    if stash is not None:
        stash.append((xhat0, rstd0))
    for i in range(n_layers):
        (wq, wk, wv, wo, s1, b1n, w1, b1, w2, b2, s2, b2n) = \
            flat[3 + PER_BLOCK * i:3 + PER_BLOCK * (i + 1)]
        m = masks["blocks"][i] if masks is not None else None
        q, k, v = split(bdot(x, wq)), split(bdot(x, wk)), split(bdot(x, wv))
        s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dk)) + mask3[:, None]
        p = torch.softmax(s, dim=-1)
        pd = p.to(dt).float()
        if m is not None:
            pd = pd * m["probs"]
        o = (pd @ v).to(dt).transpose(1, 2).reshape(B, L, D)
        o2 = bdot(o, wo)
        if m is not None:
            o2 = (o2.float() * m["attn_out"]).to(dt)
        y1, xhat1, rstd1 = _layernorm(x.float() + o2.float(), s1, b1n)
        x1 = y1.to(dt)
        pre = bdot(x1, w1) + b1.to(dt)
        hf = torch.relu(pre) if relu is None else relu(pre)
        h2 = bdot(hf, w2) + b2.to(dt)
        if m is not None:
            h2 = (h2.float() * m["ffn_out"]).to(dt)
        if stash is not None:
            stash.append((x, q, k, v, p, o, xhat1, rstd1, x1, hf))
        y2, xhat2, rstd2 = _layernorm(x1.float() + h2.float(), s2, b2n)
        if stash is not None:
            stash[-1] += (xhat2, rstd2)
        x = y2.to(dt)
    return x


def user_encoder_fwd_plain(x, mask3, params, *, n_layers: int, n_heads: int,
                           d_ff: int, n_position: int, seed: int = 0,
                           rate: float = 0.0) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch.

    x (B, L, D) in the compute dtype; mask3 (B, L, L) fp32 additive;
    params the packed fp32 vector (``pack_encoder_params`` at x's dtype).
    ``rate`` > 0 is train mode, with the Philox masks of ``seed``.
    Returns (B, L, D) in x's dtype.
    """
    B, L, D = x.shape
    flat = unpack_encoder_params(params, D, d_ff, n_layers, n_position)
    masks = dropout_masks(seed, rate, B, L, D, n_heads, n_layers, x.device)
    return _encoder_fwd(x, mask3, flat, n_layers, n_heads, masks)


def user_encoder_bwd_plain(x, mask3, params, gout, *, n_layers: int,
                           n_heads: int, d_ff: int, n_position: int,
                           seed: int = 0, rate: float = 0.0):
    """The backward kernel's arithmetic in plain PyTorch: the JAX
    ``_bwd_kernel`` (with ``_attn_bwd`` and ``_layernorm_bwd``) over the
    whole batch.  It recomputes the forward, masks included, then
    back-propagates with the kernel's cast chain: weight- and
    input-gradient products take operands rounded to the compute dtype
    with fp32 results; bias, LayerNorm and softmax gradients are fp32.

    gout (B, L, D) in x's dtype.  Returns (gx (B, L, D) in x's dtype, the
    fp32 parameter gradient in the packed layout); the position gradient
    is zero past row L.
    """
    B, L, D = x.shape
    flat = unpack_encoder_params(params, D, d_ff, n_layers, n_position)
    masks = dropout_masks(seed, rate, B, L, D, n_heads, n_layers, x.device)
    stash: list = []
    _encoder_fwd(x, mask3, flat, n_layers, n_heads, masks, stash)
    return _encoder_bwd(x, flat, masks, stash, gout, n_layers, n_heads,
                        n_position)


def _encoder_bwd(x, flat, masks, stash, gout, n_layers: int, n_heads: int,
                 n_position: int):
    """The backward body over the whole batch, from ``_encoder_fwd``'s
    stash of the same forward: (gx, the packed parameter gradient)."""
    dt = x.dtype
    B, L, D = x.shape
    H, dk = n_heads, D // n_heads

    def r(t):  # round to the compute dtype, carry in fp32
        return t.to(dt).float()

    def rows(t):  # (B, L, D) -> (B*L, D) fp32
        return t.float().reshape(B * L, -1)

    def merge(t):  # (B, H, L, dk) -> (B*L, D), rounded
        return r(t.transpose(1, 2).reshape(B * L, D))

    g = gout.float().reshape(B * L, D)
    gflat: list = [None] * len(flat)
    for i in range(n_layers - 1, -1, -1):
        k0 = 3 + PER_BLOCK * i
        (wq, wk, wv, wo, s1, b1n, w1, b1, w2, b2, s2, b2n) = flat[k0:k0 + PER_BLOCK]
        (x_in, q, k, v, p, o, xhat1, rstd1, x1, hf, xhat2, rstd2) = stash[1 + i]
        m = masks["blocks"][i] if masks is not None else None

        # x_out = LN2(x1 + dropout(hf @ w2 + b2))
        g_pre2, g_s2, g_b2n = _layernorm_bwd(g, xhat2, rstd2, s2)
        g_h2 = g_pre2 * rows(m["ffn_out"]) if m is not None else g_pre2
        g_b2 = g_h2.sum(0)
        g_w2 = rows(hf).T @ r(g_h2)
        g_hf = r(g_h2) @ r(w2).T
        g_hpre = torch.where(rows(hf) > 0, g_hf, torch.zeros_like(g_hf))
        g_b1 = g_hpre.sum(0)
        g_w1 = rows(x1).T @ r(g_hpre)
        g_x1 = g_pre2 + r(g_hpre) @ r(w1).T

        # x1 = LN1(x_in + dropout(o @ wo))
        g_pre1, g_s1, g_b1n = _layernorm_bwd(g_x1, xhat1, rstd1, s1)
        g_o2 = r(g_pre1 * rows(m["attn_out"]) if m is not None else g_pre1)
        g_wo = rows(o).T @ g_o2
        g_o = (g_o2 @ r(wo).T).reshape(B, L, H, dk).transpose(1, 2)

        # attention (``_attn_bwd``), all heads at once
        pd = r(p) * m["probs"] if m is not None else r(p)
        g_pd = g_o @ v.transpose(-1, -2)
        g_v = pd.transpose(-1, -2) @ g_o
        g_p = g_pd * m["probs"] if m is not None else g_pd
        g_s = p * (g_p - (g_p * p).sum(-1, keepdim=True)) * (1.0 / math.sqrt(dk))
        g_q, g_k, g_v = merge(g_s @ k), merge(g_s.transpose(-1, -2) @ q), merge(g_v)
        xr = rows(x_in)
        g = g_pre1 + g_q @ r(wq).T + g_k @ r(wk).T + g_v @ r(wv).T
        gflat[k0:k0 + PER_BLOCK] = [xr.T @ g_q, xr.T @ g_k, xr.T @ g_v, g_wo,
                                    g_s1, g_b1n, g_w1, g_b1, g_w2, g_b2,
                                    g_s2, g_b2n]

    xhat0, rstd0 = stash[0]
    if masks is not None:
        g = g * rows(masks["input"])
    g_x, g_ln0s, g_ln0b = _layernorm_bwd(g, xhat0, rstd0, flat[1])
    g_pos = torch.zeros((n_position, D), dtype=torch.float32, device=x.device)
    g_pos[:L] = g_x.reshape(B, L, D).sum(0)
    gflat[:3] = [g_pos, g_ln0s, g_ln0b]
    return (g_x.reshape(B, L, D).to(dt),
            torch.cat([t.reshape(-1) for t in gflat]))


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------


def _check(name, x, mask3, params, n_layers, n_heads, d_ff, n_position, seed,
           rate, ok):
    B, L, D = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not ok:
        raise ValueError(f"{name} does not take B={B} L={L} D={D} H={n_heads} "
                         f"F={d_ff} n_layers={n_layers} n_position={n_position}")
    if mask3.shape != (B, L, L) or mask3.dtype != torch.float32:
        raise ValueError(f"mask must be ({B}, {L}, {L}) float32, got "
                         f"{tuple(mask3.shape)} {mask3.dtype}")
    P = _param_count(D, d_ff, n_layers, n_position)
    if P > MAX_PARAMS:
        raise ValueError(f"{name} does not take {P} packed parameters (the "
                         f"kernels index at most {MAX_PARAMS})")
    if params.dtype != torch.float32 or params.numel() != P:
        raise ValueError("params must be the packed float32 encoder vector")
    if not 0 <= seed < 2 ** 31 or not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout seed {seed} or rate {rate} out of range")
    for t in (mask3, params):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}")


def _bytes(n: int, device) -> Optional[torch.Tensor]:
    """A device buffer of n bytes for a kernel's scratch (None when n is
    0)."""
    return torch.empty(n, dtype=torch.uint8, device=device) if n else None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dropout_args(seed: int, rate: float):
    """(seed, rate, keep scale) for the C entry points; the scale is
    1/(1-rate), rounded to fp32 by ctypes as the plain version rounds
    it."""
    return seed, rate, 1.0 / (1.0 - rate)


def weight_image(params, D: int, F: int, n_layers: int, n_position: int,
                 dtype: torch.dtype = torch.bfloat16, backward: bool = True):
    """The weight image of the packed parameters that the kernels of
    ``dtype``'s route stream (one launch of its image kernel; a CUDA
    ``params``): bf16, the bf16 matrices (``iisan_user_encoder_weights``);
    fp32, the 64 x 64 tiles (``iisan_user_encoder_f32_weights``), the
    backward's half only with ``backward``.  Made once, it serves every
    call on the same parameters: ``FusedEncoderFn`` passes the forward's to
    the backward, and ``UserEncoder.packed_params`` caches one for
    serving."""
    from ..kernels.build import check, library

    stream = torch.cuda.current_stream(params.device).cuda_stream
    if dtype != torch.bfloat16:
        n = f32_image_floats(D, F, n_layers, backward)
        image = torch.empty(n, dtype=torch.float32, device=params.device)
        err = library().iisan_user_encoder_f32_weights(
            params.data_ptr(), image.data_ptr(), n, D, F, n_layers, n_position,
            int(backward), stream)
        check(err, "user_encoder fp32 weight image")
        return image
    n = tc_image_elems(D, F, n_layers)
    image = torch.empty(n, dtype=torch.bfloat16, device=params.device)
    err = library().iisan_user_encoder_weights(
        params.data_ptr(), image.data_ptr(), n, D, F, n_layers, n_position, stream)
    check(err, "user_encoder weight image")
    return image


def _image_for(image, params, D: int, F: int, n_layers: int, n_position: int,
               dtype: torch.dtype, backward: bool):
    """``image`` checked against the parameters' shapes and the route, or
    made anew (an fp32 forward makes the forward's half only)."""
    if image is None:
        return weight_image(params, D, F, n_layers, n_position, dtype, backward)
    if dtype == torch.bfloat16:
        ok = image.dtype == torch.bfloat16 and image.numel() == tc_image_elems(D, F, n_layers)
    else:
        sizes = {f32_image_floats(D, F, n_layers, True)}
        if not backward:
            sizes.add(f32_image_floats(D, F, n_layers, False))
        ok = image.dtype == torch.float32 and image.numel() in sizes
    if not ok or image.device != params.device:
        raise ValueError("image must be the weight image of params for this "
                         "route (weight_image)")
    return image.contiguous()


def user_encoder_fwd(x, mask3, params, *, n_layers: int, n_heads: int,
                     d_ff: int, n_position: int, seed: int = 0,
                     rate: float = 0.0, image=None,
                     n_sm: Optional[int] = None) -> torch.Tensor:
    """Encoder forward; the CUDA kernel for a CUDA ``x`` (bf16: mma.sync,
    a block a sequence; fp32: three-pass TF32 on wgmma, a block a tile of
    sequences).

    Same arguments and result as ``user_encoder_fwd_plain``, which runs
    for a CPU ``x``.  ``image``: ``weight_image`` of ``params`` for x's
    route where the caller holds one (made here when None).  ``n_sm``: the
    SMs the fp32 route plans its tiles for (x's card's when None; the
    result is the same for any count).  ``user_encoder_fwd.launches``
    counts kernel launches.
    """
    if not x.is_cuda:
        return user_encoder_fwd_plain(x, mask3, params, n_layers=n_layers,
                                      n_heads=n_heads, d_ff=d_ff,
                                      n_position=n_position, seed=seed,
                                      rate=rate)
    from ..kernels.build import check, library

    B, L, D = x.shape
    _check("user_encoder_fwd", x, mask3, params, n_layers, n_heads, d_ff,
           n_position, seed, rate,
           supported(B, L, D, n_heads, d_ff, n_position))
    x, mask3, params = x.contiguous(), mask3.contiguous(), params.contiguous()
    out = torch.empty_like(x)
    n_sm = _plan_sms(x, n_sm)
    plan = encoder_plan(B, L, D, n_heads, d_ff, n_layers, x.dtype, n_sm=n_sm)
    image = _image_for(image, params, D, d_ff, n_layers, n_position, x.dtype, False)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        scratch = _bytes(B * plan.scratch_bytes, x.device)
        err = library().iisan_user_encoder_fwd(
            x.data_ptr(), mask3.data_ptr(), params.data_ptr(), image.data_ptr(),
            out.data_ptr(), _ptr(scratch), B * plan.scratch_bytes,
            B, L, D, n_heads, d_ff, n_layers, n_position,
            *_dropout_args(seed, rate), stream)
    else:
        n = -(-B // plan.tile_seqs) * plan.scratch_bytes
        scratch = _bytes(n, x.device)
        err = library().iisan_user_encoder_f32_fwd(
            x.data_ptr(), mask3.data_ptr(), params.data_ptr(), image.data_ptr(),
            image.numel(), out.data_ptr(), _ptr(scratch), n,
            B, L, D, n_heads, d_ff, n_layers, n_position,
            *_dropout_args(seed, rate), n_sm, stream)
    check(err, "user_encoder_fwd")
    user_encoder_fwd.launches += 1
    user_encoder_fwd.flops += flops.encoder(B, L, D, d_ff, n_layers)
    return out


user_encoder_fwd.launches = 0
user_encoder_fwd.flops = 0


def _plan_sms(x, n_sm: Optional[int]) -> int:
    """The SMs a call on x plans its fp32 tiles for: n_sm, else x's card's."""
    if n_sm is None:
        return sm_count(x.device)
    if n_sm < 1:
        raise ValueError(f"n_sm must be at least 1, got {n_sm}")
    return n_sm


def _bwd_sweep(x, mask3, params, image, gout, gx, work, n_layers, n_heads,
               d_ff, n_position, seed, rate, n_sm):
    """The backward's first kernel, the sweep (x's route): gx, and in
    ``work`` (``tc_work_layout`` or ``f32_work_layout``, for tiles planned
    for n_sm SMs) the weight-gradient operands and the partial rows."""
    from ..kernels.build import check, library

    B, L, D = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        err = library().iisan_user_encoder_bwd_tc(
            x.data_ptr(), mask3.data_ptr(), params.data_ptr(), image.data_ptr(),
            gout.data_ptr(), gx.data_ptr(), work.data_ptr(), work.numel(), B, L, D,
            n_heads, d_ff, n_layers, n_position, *_dropout_args(seed, rate), stream)
    else:
        err = library().iisan_user_encoder_f32_bwd(
            x.data_ptr(), mask3.data_ptr(), params.data_ptr(), image.data_ptr(),
            image.numel(), gout.data_ptr(), gx.data_ptr(), work.data_ptr(),
            work.numel(), B, L, D, n_heads, d_ff, n_layers, n_position,
            *_dropout_args(seed, rate), n_sm, stream)
    check(err, "user_encoder_bwd (sweep)")


def _bwd_wgrad(work, gparams, B, L, D, n_layers, n_heads, d_ff, n_position,
               dtype=torch.bfloat16, n_sm: int = H100_SMS):
    """The backward's second kernel: every entry of ``gparams`` from the
    sweep's ``work`` (``dtype``'s route; fp32: the sweep's ``n_sm``)."""
    from ..kernels.build import check, library

    stream = torch.cuda.current_stream(work.device).cuda_stream
    if dtype == torch.bfloat16:
        err = library().iisan_user_encoder_wgrad(
            work.data_ptr(), work.numel(), gparams.data_ptr(), B, L, D, n_heads,
            d_ff, n_layers, n_position, stream)
    else:
        err = library().iisan_user_encoder_f32_wgrad(
            work.data_ptr(), work.numel(), gparams.data_ptr(), B, L, D, n_heads,
            d_ff, n_layers, n_position, n_sm, stream)
    check(err, "user_encoder_bwd (weight gradients)")


def user_encoder_bwd(x, mask3, params, gout, *, n_layers: int, n_heads: int,
                     d_ff: int, n_position: int, seed: int = 0,
                     rate: float = 0.0, image=None, n_sm: Optional[int] = None):
    """Encoder backward; the CUDA kernels for a CUDA ``x``.

    Same arguments and results as ``user_encoder_bwd_plain``, which runs
    for a CPU ``x``.  On both routes a sweep reruns the forward and writes
    gx and the operands of every weight gradient to one device buffer,
    then a weight-gradient pass forms them over all rows in a fixed order
    (``encoder_plan(...).work_bytes``; at B=64, L=10, D=64, 2 blocks: 3.1
    MB in bf16, whose operands are bf16, and 6.0 MB in fp32).  bf16: a
    block a sequence on mma.sync; fp32: a block a tile of sequences, three
    TF32 passes on wgmma.  Areas that do not fit shared memory go to a
    scratch in the buffer (``encoder_plan``).  ``image`` as in
    ``user_encoder_fwd`` (on the fp32 route with its backward half), and
    ``n_sm`` too.  ``user_encoder_bwd.launches`` counts calls that launch
    the kernels.
    """
    if not x.is_cuda:
        return user_encoder_bwd_plain(x, mask3, params, gout,
                                      n_layers=n_layers, n_heads=n_heads,
                                      d_ff=d_ff, n_position=n_position,
                                      seed=seed, rate=rate)
    B, L, D = x.shape
    _check("user_encoder_bwd", x, mask3, params, n_layers, n_heads, d_ff,
           n_position, seed, rate,
           bwd_supported(B, L, D, n_heads, d_ff, n_layers, n_position))
    if gout.shape != x.shape or gout.dtype != x.dtype or gout.device != x.device:
        raise ValueError(f"gout must be {tuple(x.shape)} {x.dtype} on {x.device}")
    x, mask3, params = x.contiguous(), mask3.contiguous(), params.contiguous()
    gout = gout.contiguous()
    gx = torch.empty_like(x)
    gparams = torch.empty(params.numel(), dtype=torch.float32, device=x.device)
    n_sm = _plan_sms(x, n_sm)
    plan = encoder_plan(B, L, D, n_heads, d_ff, n_layers, x.dtype, backward=True,
                        n_sm=n_sm)
    image = _image_for(image, params, D, d_ff, n_layers, n_position, x.dtype, True)
    work = torch.empty(plan.work_bytes, dtype=torch.uint8, device=x.device)
    _bwd_sweep(x, mask3, params, image, gout, gx, work, n_layers, n_heads,
               d_ff, n_position, seed, rate, n_sm)
    _bwd_wgrad(work, gparams, B, L, D, n_layers, n_heads, d_ff, n_position, x.dtype,
               n_sm)
    user_encoder_bwd.launches += 1
    user_encoder_bwd.flops += flops.encoder(B, L, D, d_ff, n_layers, bwd=True)
    return gx, gparams


user_encoder_bwd.launches = 0
user_encoder_bwd.flops = 0


class FusedEncoderFn(torch.autograd.Function):
    """The fused encoder under autograd: forward ``user_encoder_fwd``,
    backward ``user_encoder_bwd``, which recomputes the forward (and its
    dropout masks) from the saved (x, mask, seed).  Both read one weight
    image, the caller's or one made in the forward (on the fp32 route with
    the backward's half where a gradient is needed).

    apply(x, mask3, packed, seed, rate, dims, image) with ``dims`` =
    (n_layers, n_heads, d_ff, n_position) and ``image`` the weight image of
    ``packed`` for x's route or None; ``rate`` > 0 is train mode.  The
    gradient reaches ``x`` and ``packed``."""

    @staticmethod
    def forward(ctx, x, mask3, packed, seed: int, rate: float, dims, image=None):
        n_layers, n_heads, d_ff, n_position = dims
        ctx.kw = dict(n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
                      n_position=n_position, seed=seed, rate=rate)
        backward = any(ctx.needs_input_grad[:3])
        if x.is_cuda and (image is None or (
                backward and x.dtype != torch.bfloat16
                and image.numel() != f32_image_floats(x.shape[-1], d_ff, n_layers))):
            image = weight_image(packed, x.shape[-1], d_ff, n_layers, n_position,
                                 x.dtype, backward)
        ctx.save_for_backward(x, mask3, packed, image)
        return user_encoder_fwd(x, mask3, packed, **_image_kw(image), **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        x, mask3, packed, image = ctx.saved_tensors
        gx, gpacked = user_encoder_bwd(x, mask3, packed, g.to(x.dtype),
                                       **_image_kw(image), **ctx.kw)
        return gx, None, gpacked, None, None, None, None


def _image_kw(image) -> dict:
    """The wrappers' ``image`` argument, passed only where there is one."""
    return {} if image is None else {"image": image}


def apply_fused_encoder(params, x, additive_mask, *, n_layers: int,
                        n_heads: int, d_ff: int, n_position: int,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        drop_rate: float = 0.0, seed: Optional[int] = None,
                        image=None):
    """Fused TransformerEncoder under autograd.

    params: the packed vector (``pack_encoder_params`` at
    ``compute_dtype``); x (B, L, D); additive_mask (B, 1, L, L) fp32.
    ``seed`` (in [0, 2^31)) with ``drop_rate`` > 0 is train mode; None is
    eval mode.  ``image``: ``weight_image`` of ``params`` where the caller
    keeps one (on the card, for x's route), else None.  Returns (B, L, D) in x's
    dtype.
    """
    B, L, _ = x.shape
    mask3 = additive_mask.reshape(B, L, L).float()
    train = seed is not None and drop_rate > 0.0
    out = FusedEncoderFn.apply(x.to(compute_dtype), mask3, params,
                               seed if train else 0,
                               drop_rate if train else 0.0,
                               (n_layers, n_heads, d_ff, n_position), image)
    return out.to(x.dtype)
