"""SAN adapter cascade: CUDA kernel wrappers, plain versions, references.

Port of ``iisan_tpu/ops/fused_san.py``.  The cascade is

    f_i   = a_i * tap_i + b_i * c_i      (gated: a = sigmoid(theta/0.1), b = 1 - a;
                                          additive: a = b = 1)
    c_i+1 = W_up_i @ act(W_dn_i @ f_i + b_dn_i) + b_up_i + f_i

Two kernels compute it, each following the cast chain of the Pallas kernel
it replaces:

- ``san_cascade_fwd`` (``csrc/san_cascade_fwd.cu``, TPU kernel
  ``_cascade_kernel``): S branches in one launch, per-step coefficients
  (S, K); f and the carry are rounded to the compute dtype every step.
  Its plain version is ``san_cascade_fwd_plain``.
- ``san_cascade_streamed_fwd`` (``csrc/san_cascade_streamed_fwd.cu``, TPU
  kernel ``_cascade_kernel_streamed``): one branch, bf16 only; the carry
  stays fp32 across the steps, f is rounded only as the down projection's
  operand, and the output is rounded once.  Plain version
  ``san_cascade_streamed_fwd_plain``.

In bf16 both run one Hopper body (``csrc/san_cascade.cuh``: wgmma products,
D split across a thread-block cluster); ``cascade_plan`` is its layout for
a geometry, as plain integers, and the only place the wrappers refuse a
shape the JAX package takes (R above 1,472 in bf16, 3,376 in fp32).

``fused_cascade`` is one branch under autograd.  Its forward follows the
JAX package's dispatch (``cascade_route``): the geometry and dtype pick the
resident kernel, the streamed kernel or ``reference_cascade``, so the port
computes the same function as the JAX package at every geometry.  Its
backward is ``cascade_bwd``, the JAX custom VJP's plain backward (the JAX
package has no kernel for it either).  ``reference_cascade`` and
``multi_reference_cascade`` are the module path's cascades, with the JAX
reference's own cast chain (the up projection is rounded before ``+ f``).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import flops

GATE_TEMPERATURE = 0.1
_DTYPES = (torch.float32, torch.bfloat16)
# Shared memory a block may opt in to on the H100 (227 KB); the kernels are
# built for sm_90a only, where every card has this limit.
SMEM_OPTIN_BYTES = 232_448


def _act(z, activation: str):
    if activation == "GELU":
        return F.gelu(z, approximate="none")
    return torch.relu(z)


def cascade_coefs(gates: torch.Tensor, gated: bool):
    """(K,) gate params -> per-step (a, b) fusion coefficients, fp32, on the
    gates' device (no host round trip)."""
    if gated:
        g = torch.sigmoid(gates.float() / GATE_TEMPERATURE)
        return g, 1.0 - g
    ones = torch.ones(gates.shape[0], dtype=torch.float32, device=gates.device)
    return ones, ones


def reference_cascade(gates, taps, wd, bd, wu, bu, c0, activation="RELU",
                      gated=True):
    """Module-path cascade over stacked weights.

    gates (K,), taps (N, K, D), wd (K, D, R), bd (K, R), wu (K, R, D),
    bu (K, D), c0 (N, D) -> (N, D) in c0's dtype.
    """
    dtype = c0.dtype
    c = c0
    for i in range(taps.shape[1]):
        if gated:
            g = torch.sigmoid(gates[i].float() / GATE_TEMPERATURE)
            f = (g * taps[:, i, :].float() + (1.0 - g) * c.float()).to(dtype)
        else:
            f = taps[:, i, :] + c
        z = f.float() @ wd[i].float() + bd[i].float()
        a = _act(z, activation).to(dtype)
        c = (a.float() @ wu[i].float() + bu[i].float()).to(dtype) + f
    return c


def _batched_cascade(coef_a, coef_b, taps, wd, bd, wu, bu, c0, activation,
                     round_up: bool):
    """S cascades as one loop of (S, ...)-batched products.  ``round_up``
    rounds the up projection to the compute dtype before ``+ f`` (the
    reference path); otherwise ``up + f`` adds in fp32 (the kernel)."""
    dtype = c0.dtype
    c = c0
    for i in range(taps.shape[2]):
        a_i, b_i = coef_a[:, i, None, None], coef_b[:, i, None, None]
        f = (a_i * taps[:, :, i, :].float() + b_i * c.float()).to(dtype)
        z = torch.bmm(f.float(), wd[:, i].float()) + bd[:, i, None, :].float()
        a = _act(z, activation).to(dtype)
        up = torch.bmm(a.float(), wu[:, i].float()) + bu[:, i, None, :].float()
        c = up.to(dtype) + f if round_up else (up + f.float()).to(dtype)
    return c


def multi_reference_cascade(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                            activation="RELU"):
    """S branch cascades as one loop of (S, ...)-batched products.

    coef_a/coef_b (S, K) fp32; taps (S, N, K, D); wd (S, K, D, R);
    bd (S, K, R); wu (S, K, R, D); bu (S, K, D); c0 (S, N, D).
    Returns (S, N, D) final carries.
    """
    return _batched_cascade(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                            activation, round_up=True)


def san_cascade_fwd_plain(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                          activation="RELU"):
    """The kernel's arithmetic in plain PyTorch (cast chain of the JAX
    ``_cascade_kernel``): f rounded to the compute dtype, z fp32 + bias,
    activation rounded, ``up + f`` in fp32 with one rounding per step.

    Shapes as ``multi_reference_cascade``; returns (S, N, D) in c0's dtype.
    """
    return _batched_cascade(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                            activation, round_up=False)


def carry_tolerance(want: torch.Tensor, ulps: int = 4,
                    atol: float = 1e-3) -> torch.Tensor:
    """Per-element bound on |got - want| for two bf16 cascades that differ
    only in rounding: ``ulps`` bf16 ulps of the row's largest |carry| plus
    ``atol``.  The carry is additive across the K steps, so a one-ulp
    rounding difference at a large value survives into a final value that
    may be small; a wrong term (a dropped bias, another activation, one
    step's weights) moves the carry by far more.  Shape (..., N, 1)."""
    m = want.float().abs().amax(-1, keepdim=True).clamp_min(2.0 ** -100)
    return ulps * torch.exp2(torch.floor(torch.log2(m)) - 7) + atol


def fits_vmem(k: int, d: int, r: int, tile: int = 128,
              budget_bytes: int = 12 * 2**20, bpe: int = 2) -> bool:
    """The JAX package's ``fits_vmem``, as plain integer arithmetic.

    It decides which cast chain the JAX package computes at a geometry:
    True where its dispatch runs the all-weights-resident
    ``_cascade_kernel`` (the carry rounded every step).  The numbers are a
    TPU VMEM estimate; they choose nothing about the H100's tiles.  ``bpe``
    is the element size of the inputs."""
    weights = k * (d * r + r + r * d + d) * bpe
    tiles = 2 * (tile * k * d + 3 * tile * d) * bpe
    return weights + tiles < budget_bytes


def streamed_tile_rows(d: int, r: int, budget_bytes: int = 14 * 2**20) -> int:
    """The JAX package's ``streamed_tile_rows``, as plain integer
    arithmetic: 0 where its dispatch falls back to ``reference_cascade``
    (one step's weights exceed the TPU budget), else the TPU row tile of
    ``_cascade_kernel_streamed``.  Only its being 0 matters to the port."""
    weights = 2 * ((d * r + r * d) * 2 + (r + d) * 2)
    per_row = 16 * d
    avail = budget_bytes - weights
    if avail < per_row * 8:
        return 0
    return min(avail // per_row // 8 * 8, 512)


def cascade_route(k: int, d: int, r: int, dtype: torch.dtype) -> str:
    """The JAX ``_dispatch_fwd`` rule: "resident" (``san_cascade_fwd``, the
    ``_cascade_kernel`` chain), "reference" (``reference_cascade``: fp32
    inputs that do not fit, or no streamed tile) or "streamed"
    (``san_cascade_streamed_fwd``)."""
    if fits_vmem(k, d, r, bpe=dtype.itemsize):
        return "resident"
    if dtype == torch.float32 or streamed_tile_rows(d, r) == 0:
        return "reference"
    return "streamed"


# The Hopper body (csrc/san_cascade.cuh) of #3 in bf16 and of #4: 64-row
# tiles, D in 64-column chunks split across a cluster of at most 16 blocks
# (about two blocks an SM asked of the 132 SMs), R padded to 64-column boxes
# and taken in passes of at most 256; the carry slice in shared memory where
# it fits.
_ROWS, _COLS, _BOX, _MAX_CLUSTER, _SMS = 64, 64, 8192, 16, 132
_TARGET_BLOCKS = 2 * _SMS
_SM_SMEM, _BLOCK_RESERVED = 233_472, 1024  # an SM's shared memory; each block's reserve
# #3 in fp32 (CUDA cores): 16-row tiles of 256 threads.
_F32_TILE, _F32_THREADS = 16, 256


class CascadePlan(NamedTuple):
    """How a kernel call is laid out on the card."""
    cluster: int     # blocks of a cluster: the D slices of one row tile
    d_slice: int     # columns of D a block owns
    r_pad: int       # R padded to the down product's passes
    smem_bytes: int  # dynamic shared memory of a block
    r_chunk: int     # columns of R a down-product pass (wgmma N); fp32: R
    stages: int      # weight boxes in flight (bf16); fp32: 0
    carry: str       # where the running carry lives: "smem" or "global"


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def cascade_smem_bytes(r_chunk: int, stages: int, r_slices: int,
                       carry_bytes: int = 0) -> int:
    """Shared memory of one bf16 block (``Layout`` in csrc/san_cascade.cuh):
    two f chunks or the fp32 partial of z (64 x (r_chunk + 8)), whichever
    is larger, to 1 KB; ``stages`` TMA stages of a tap box and ``r_chunk /
    64`` weight boxes; the activations (``r_slices`` boxes); the carry slice
    (``carry_bytes``, to 16); the ring's barriers and 1 KB of alignment."""
    front = _ceil(max(2 * _BOX, _ROWS * (r_chunk + 8) * 4), 1024) * 1024
    return (front + stages * (1 + r_chunk // _COLS) * _BOX + r_slices * _BOX
            + _ceil(carry_bytes, 16) * 16 + 8 * stages + 1024)


def _per_sm(smem: int) -> int:
    return _SM_SMEM // (smem + _BLOCK_RESERVED)


def cascade_plan(S: int, N: int, K: int, D: int, R: int, dtype: torch.dtype,
                 streamed: bool = False) -> CascadePlan:
    """The layout of a ``san_cascade_fwd`` (S branches) or, with
    ``streamed``, ``san_cascade_streamed_fwd`` (S=1, fp32 carry) call, as
    plain integers; raises ``ValueError`` where none fits.

    bf16: R is padded to 64, the down product runs in passes of
    ``r_chunk`` columns (the widest that fits, at most 256) and the
    activations take ``ceil(R / 64)`` boxes: R up to 1,472.  The cluster
    is the fewest blocks a row tile that gives about two blocks an SM
    (``_TARGET_BLOCKS``), at most 16; every block owns a whole number of
    64-column chunks and at least one.  The carry slice goes to shared
    memory at the first cluster size from there up whose slice fits with
    two blocks an SM, else with one; where none fits (D past 8,192 for
    #4's fp32 carry, 16,384 for #3's, at R = 64), it lives in device
    memory.  fp32 (#3 only): one block per 16 rows; the carry in shared
    memory where 16 x D fp32 fits beside the activations and the partial
    sums, else in the output; R up to 3,376."""
    if min(S, N, K, D, R) < 1:
        raise ValueError(f"san_cascade: empty geometry S={S} N={N} K={K} D={D} R={R}")
    if dtype == torch.float32:
        base = 4 * (_F32_TILE * R + _F32_THREADS * _F32_TILE)
        if base > SMEM_OPTIN_BYTES:
            raise ValueError(f"san_cascade_fwd: R={R} (float32) needs {base} bytes of "
                             f"shared memory a block, above the card's {SMEM_OPTIN_BYTES}")
        smem = base + 4 * _F32_TILE * D
        if smem <= SMEM_OPTIN_BYTES:
            return CascadePlan(1, D, R, smem, R, 0, "smem")
        return CascadePlan(1, D, R, base, R, 0, "global")
    r_slices = _ceil(R, _COLS)
    for r_chunk in range(_COLS * _ceil(r_slices, _ceil(r_slices, 4)), 0, -_COLS):
        for stages in ((4, 3, 2) if r_chunk <= 128 else (2,)):
            smem = cascade_smem_bytes(r_chunk, stages, r_slices)
            if smem <= SMEM_OPTIN_BYTES:
                break
        if smem <= SMEM_OPTIN_BYTES:
            break
    else:
        raise ValueError(f"san_cascade: R={R} needs {smem} bytes of shared memory a "
                         f"block, above the card's {SMEM_OPTIN_BYTES} (R up to 1,472)")
    r_pad = r_chunk * _ceil(r_slices * _COLS, r_chunk)
    chunks, tiles = _ceil(D, _COLS), S * _ceil(N, _ROWS)
    carry_size = 4 if streamed else 2

    def split(cluster):
        per_block = _ceil(chunks, cluster)
        return _ceil(chunks, per_block), per_block * _COLS

    fill = split(min(_MAX_CLUSTER, _ceil(chunks, _ceil(chunks * tiles, _TARGET_BLOCKS))))
    for want in (2, 1):
        for cluster in range(fill[0], min(_MAX_CLUSTER, chunks) + 1):
            cluster, d_slice = split(cluster)
            with_carry = cascade_smem_bytes(r_chunk, stages, r_slices,
                                            _ROWS * (d_slice + 8) * carry_size)
            if with_carry > SMEM_OPTIN_BYTES or _per_sm(with_carry) < want:
                continue
            return CascadePlan(cluster, d_slice, r_pad, with_carry, r_chunk, stages, "smem")
    return CascadePlan(fill[0], fill[1], r_pad, smem, r_chunk, stages, "global")


def _check(coef_a, coef_b, taps, wd, bd, wu, bu, c0):
    S, N, K, D = taps.shape
    R = wd.shape[-1]
    want = {"coef_a": (S, K), "coef_b": (S, K), "wd": (S, K, D, R),
            "bd": (S, K, R), "wu": (S, K, R, D), "bu": (S, K, D),
            "c0": (S, N, D)}
    got = dict(coef_a=coef_a, coef_b=coef_b, wd=wd, bd=bd, wu=wu, bu=bu, c0=c0)
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"san_cascade_fwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.device != taps.device:
            raise ValueError(f"san_cascade_fwd: {name} is on {t.device}, "
                             f"taps on {taps.device}")
    if taps.dtype not in _DTYPES:
        raise TypeError(f"san_cascade_fwd takes float32 or bfloat16, got {taps.dtype}")
    for name in ("wd", "bd", "wu", "bu", "c0"):
        if got[name].dtype != taps.dtype:
            raise TypeError(f"san_cascade_fwd: {name} is {got[name].dtype}, "
                            f"taps {taps.dtype}")
    return cascade_plan(S, max(N, 1), K, D, R, taps.dtype)


def _tma_rows(t):
    """``t`` as the bf16 kernels' TMA reads it: its last dimension a
    multiple of 8 elements (16 bytes) and 16-byte aligned (a zero-padded
    copy where it is not; the padding is never read as data)."""
    pad = -t.shape[-1] % 8
    if pad or t.data_ptr() % 16:
        return F.pad(t, (0, pad)) if pad else t.clone()
    return t


def san_cascade_fwd(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                    activation="RELU", plan=None):
    """S-branch cascade forward; the CUDA kernel for CUDA tensors (any D;
    R up to 1,472 in bf16, 3,376 in fp32).

    Same arguments and result as ``san_cascade_fwd_plain``, which runs for
    CPU tensors.  ``plan`` replaces ``cascade_plan``'s layout (to time
    another; the kernel refuses one that does not cover D and R).
    ``san_cascade_fwd.launches`` counts kernel launches.
    """
    if not taps.is_cuda:
        return san_cascade_fwd_plain(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                                     activation)
    from ..kernels.build import check, library

    plan = plan or _check(coef_a, coef_b, taps, wd, bd, wu, bu, c0)
    S, N, K, D = taps.shape
    R = wd.shape[-1]
    args = [t.contiguous() for t in (coef_a.float(), coef_b.float(), taps, wd,
                                     bd, wu, bu, c0)]
    bf16 = taps.dtype == torch.bfloat16
    if bf16:  # taps (S, N, K, D8), wd (S, K, D, R8), wu (S, K, R, D8)
        args[2], args[3], args[5] = (_tma_rows(args[j]) for j in (2, 3, 5))
    out = torch.empty((S, N, D), dtype=taps.dtype, device=taps.device)
    if N == 0:
        return out
    err = library().iisan_san_cascade_fwd(
        *[t.data_ptr() for t in args], out.data_ptr(), S, N, K, D, R,
        int(activation == "GELU"), int(bf16), plan.cluster, plan.d_slice,
        plan.r_chunk, plan.stages, int(plan.carry == "smem"),
        torch.cuda.current_stream(taps.device).cuda_stream)
    check(err, "san_cascade_fwd")
    san_cascade_fwd.launches += 1
    san_cascade_fwd.flops += flops.cascade(S, N, K, D, R)
    return out


san_cascade_fwd.launches = 0
san_cascade_fwd.flops = 0


def san_cascade_streamed_fwd_plain(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                                   activation="RELU"):
    """The streamed kernel's arithmetic in plain PyTorch (cast chain of the
    JAX ``_cascade_kernel_streamed``): the carry is fp32 across the steps;
    f = a * tap + b * c in fp32; z = round(f) @ wd + bd with an fp32 sum;
    the activation is rounded; c = (a @ wu + bu) + f in fp32; the output
    is rounded once, after the last step.

    coef_a/coef_b (K,) fp32; taps (N, K, D); wd (K, D, R); bd (K, R);
    wu (K, R, D); bu (K, D); c0 (N, D).  Returns (N, D) in c0's dtype.
    """
    dtype = c0.dtype
    c = c0.float()
    for i in range(taps.shape[1]):
        f = coef_a[i] * taps[:, i].float() + coef_b[i] * c
        z = f.to(dtype).float() @ wd[i].float() + bd[i].float()
        a = _act(z, activation).to(dtype)
        c = (a.float() @ wu[i].float() + bu[i].float()) + f
    return c.to(dtype)


def _check_streamed(coef_a, coef_b, taps, wd, bd, wu, bu, c0):
    N, K, D = taps.shape
    R = wd.shape[-1]
    want = {"coef_a": (K,), "coef_b": (K,), "wd": (K, D, R), "bd": (K, R),
            "wu": (K, R, D), "bu": (K, D), "c0": (N, D)}
    got = dict(coef_a=coef_a, coef_b=coef_b, wd=wd, bd=bd, wu=wu, bu=bu, c0=c0)
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"san_cascade_streamed_fwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.device != taps.device:
            raise ValueError(f"san_cascade_streamed_fwd: {name} is on "
                             f"{t.device}, taps on {taps.device}")
    if taps.dtype != torch.bfloat16:
        raise TypeError("san_cascade_streamed_fwd takes bfloat16 only (the "
                        f"JAX package never streams {taps.dtype}), got "
                        f"{taps.dtype}")
    for name in ("wd", "bd", "wu", "bu", "c0"):
        if got[name].dtype != taps.dtype:
            raise TypeError(f"san_cascade_streamed_fwd: {name} is "
                            f"{got[name].dtype}, taps {taps.dtype}")
    return cascade_plan(1, max(N, 1), K, D, R, taps.dtype, streamed=True)


def san_cascade_streamed_fwd(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                             activation="RELU", plan=None):
    """One branch's cascade with an fp32 carry; the CUDA kernel for CUDA
    tensors (bf16 only, any D, R up to 1,472).

    Same arguments and result as ``san_cascade_streamed_fwd_plain``, which
    runs for CPU tensors.  The kernel keeps the fp32 carry in shared
    memory where its slice fits, else in an (N, D) fp32 scratch that the
    wrapper allocates.  ``plan`` as ``san_cascade_fwd``'s.
    ``san_cascade_streamed_fwd.launches`` counts kernel launches.
    """
    if not taps.is_cuda:
        return san_cascade_streamed_fwd_plain(coef_a, coef_b, taps, wd, bd, wu,
                                              bu, c0, activation)
    from ..kernels.build import check, library

    plan = plan or _check_streamed(coef_a, coef_b, taps, wd, bd, wu, bu, c0)
    N, K, D = taps.shape
    R = wd.shape[-1]
    args = [t.contiguous() for t in (coef_a.float(), coef_b.float(), taps, wd,
                                     bd, wu, bu, c0)]
    # taps (N, K, D8), wd (K, D, R8), wu (K, R, D8)
    args[2], args[3], args[5] = (_tma_rows(args[j]) for j in (2, 3, 5))
    out = torch.empty((N, D), dtype=taps.dtype, device=taps.device)
    if N == 0:
        return out
    # the fp32 carry's scratch, where the plan keeps it in device memory
    carry = (torch.empty((N, D), dtype=torch.float32, device=taps.device)
             if plan.carry == "global" else out)
    err = library().iisan_san_cascade_streamed_fwd(
        *[t.data_ptr() for t in args], carry.data_ptr(), out.data_ptr(), N, K,
        D, R, int(activation == "GELU"), plan.cluster, plan.d_slice,
        plan.r_chunk, plan.stages, int(plan.carry == "smem"),
        torch.cuda.current_stream(taps.device).cuda_stream)
    check(err, "san_cascade_streamed_fwd")
    san_cascade_streamed_fwd.launches += 1
    san_cascade_streamed_fwd.flops += flops.cascade(1, N, K, D, R)
    return out


san_cascade_streamed_fwd.launches = 0
san_cascade_streamed_fwd.flops = 0


def _act_grad(z, activation: str):
    """d act(z) / dz, fp32."""
    if activation == "GELU":
        cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
        return cdf + z * torch.exp(-0.5 * z * z) * 0.3989422804014327
    return (z > 0).float()


def cascade_bwd(gates, taps, wd, bd, wu, bu, c0, dc_out, activation="RELU",
                gated=True):
    """Gradients of one branch's cascade, the JAX ``_recompute_carries`` +
    ``_bwd``: the carries are recomputed in fp32 from the inputs, then the
    K steps are walked back.  The gate gradient of step i is
    ``sum(df * (tap_i - c_i)) * g(1-g) / T``; additive fusion gives the
    gates zero.  Returns (dgates, dtaps, dwd, dbd, dwu, dbu, dc0), each in
    its input's dtype."""
    f32 = torch.float32
    k = taps.shape[1]
    coef = (torch.sigmoid(gates.float() / GATE_TEMPERATURE) if gated
            else torch.ones(k, dtype=f32, device=taps.device))
    c = c0.float()
    carries = [c]
    for i in range(k - 1):
        f = coef[i] * taps[:, i].float() + (1.0 - coef[i]) * c if gated \
            else taps[:, i].float() + c
        z = f @ wd[i].float() + bd[i].float()
        c = _act(z, activation) @ wu[i].float() + bu[i].float() + f
        carries.append(c)
    dc = dc_out.float()
    dgates, dtaps = torch.zeros(k, dtype=f32, device=taps.device), []
    dwd, dbd, dwu, dbu = [], [], [], []
    for i in range(k - 1, -1, -1):
        c_i, t_i, g = carries[i], taps[:, i].float(), coef[i]
        f = g * t_i + (1.0 - g) * c_i if gated else t_i + c_i
        z = f @ wd[i].float() + bd[i].float()
        dwu.append(_act(z, activation).T @ dc)
        dbu.append(dc.sum(0))
        dz = (dc @ wu[i].float().T) * _act_grad(z, activation)
        dwd.append(f.T @ dz)
        dbd.append(dz.sum(0))
        df = dz @ wd[i].float().T + dc
        if gated:
            dtaps.append(g * df)
            dgates[i] = (df * (t_i - c_i)).sum() * g * (1.0 - g) / GATE_TEMPERATURE
            dc = (1.0 - g) * df
        else:
            dtaps.append(df)
            dc = df
    return (dgates.to(gates.dtype), torch.stack(dtaps[::-1], 1).to(taps.dtype),
            torch.stack(dwd[::-1]).to(wd.dtype), torch.stack(dbd[::-1]).to(bd.dtype),
            torch.stack(dwu[::-1]).to(wu.dtype), torch.stack(dbu[::-1]).to(bu.dtype),
            dc.to(c0.dtype))


class FusedCascadeFn(torch.autograd.Function):
    """One branch's cascade under autograd.  Forward by ``cascade_route``:
    ``san_cascade_fwd`` with S=1, ``san_cascade_streamed_fwd`` (each the
    kernel on CUDA) or ``reference_cascade``; backward ``cascade_bwd``,
    which recomputes the carries in fp32 from the saved inputs and so
    serves every forward."""

    @staticmethod
    def forward(ctx, gates, taps, wd, bd, wu, bu, c0, activation, gated):
        ctx.activation, ctx.gated = activation, gated
        ctx.save_for_backward(gates, taps, wd, bd, wu, bu, c0)
        n, k, d = taps.shape
        route = cascade_route(k, d, wd.shape[-1], taps.dtype)
        if route == "reference":
            return reference_cascade(gates, taps, wd, bd, wu, bu, c0,
                                     activation, gated)
        a, b = cascade_coefs(gates, gated)
        if route == "streamed":
            return san_cascade_streamed_fwd(a, b, taps, wd, bd, wu, bu, c0,
                                            activation)
        return san_cascade_fwd(a[None], b[None], taps[None], wd[None],
                               bd[None], wu[None], bu[None], c0[None],
                               activation)[0]

    @staticmethod
    def backward(ctx, dc_out):
        grads = cascade_bwd(*ctx.saved_tensors, dc_out, ctx.activation,
                            ctx.gated)
        return grads + (None, None)


def fused_cascade(gates, taps, wd, bd, wu, bu, c0, activation="RELU",
                  gated=True):
    """One branch's fused K-step cascade, under autograd.

    gates (K,), taps (N, K, D), wd (K, D, R), bd (K, R), wu (K, R, D),
    bu (K, D), c0 (N, D) -> (N, D): forward by the JAX package's dispatch
    rule (``cascade_route``), backward ``cascade_bwd``.
    """
    return FusedCascadeFn.apply(gates, taps, wd, bd, wu, bu, c0, activation,
                                gated)
