"""SAN adapter cascade: CUDA kernel wrapper, plain versions, references.

Port of ``iisan_tpu/ops/fused_san.py`` (forward only).  The cascade is

    f_i   = a_i * tap_i + b_i * c_i      (gated: a = sigmoid(theta/0.1), b = 1 - a;
                                          additive: a = b = 1)
    c_i+1 = W_up_i @ act(W_dn_i @ f_i + b_dn_i) + b_up_i + f_i

``san_cascade_fwd`` is the kernel wrapper (``csrc/san_cascade_fwd.cu``): S
branches in one launch, per-step coefficients (S, K).  With S=1 and
``cascade_coefs`` it is exactly ``fused_cascade``.  ``san_cascade_fwd_plain``
is its arithmetic in plain PyTorch, following the cast chain of the JAX
Pallas kernel ``_cascade_kernel`` (one rounding of the carry per step).
``reference_cascade`` and ``multi_reference_cascade`` are the module
path's cascades, with the JAX reference's own cast chain (the up
projection is rounded before ``+ f``).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GATE_TEMPERATURE = 0.1
_THREADS = 256  # the kernel's block size; R must divide it
_DTYPES = (torch.float32, torch.bfloat16)


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
    if R > _THREADS or _THREADS % R:
        raise ValueError(f"san_cascade_fwd needs a bottleneck R dividing "
                         f"{_THREADS}, got {R}")


def san_cascade_fwd(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                    activation="RELU"):
    """S-branch cascade forward; the CUDA kernel for CUDA tensors.

    Same arguments and result as ``san_cascade_fwd_plain``, which runs for
    CPU tensors.  ``san_cascade_fwd.launches`` counts kernel launches.
    """
    if not taps.is_cuda:
        return san_cascade_fwd_plain(coef_a, coef_b, taps, wd, bd, wu, bu, c0,
                                     activation)
    from ..kernels.build import check, library

    _check(coef_a, coef_b, taps, wd, bd, wu, bu, c0)
    S, N, K, D = taps.shape
    R = wd.shape[-1]
    args = [t.contiguous() for t in (coef_a.float(), coef_b.float(), taps, wd,
                                     bd, wu, bu, c0)]
    out = torch.empty((S, N, D), dtype=taps.dtype, device=taps.device)
    if N == 0:
        return out
    err = library().iisan_san_cascade_fwd(
        *[t.data_ptr() for t in args], out.data_ptr(), S, N, K, D, R,
        int(activation == "GELU"), int(taps.dtype == torch.bfloat16),
        torch.cuda.current_stream(taps.device).cuda_stream)
    check(err, "san_cascade_fwd")
    san_cascade_fwd.launches += 1
    return out


san_cascade_fwd.launches = 0


def fused_cascade(gates, taps, wd, bd, wu, bu, c0, activation="RELU",
                  gated=True):
    """One branch's fused K-step cascade (forward).

    gates (K,), taps (N, K, D), wd (K, D, R), bd (K, R), wu (K, R, D),
    bu (K, D), c0 (N, D) -> (N, D): the kernel with S=1.
    """
    a, b = cascade_coefs(gates, gated)
    return san_cascade_fwd(a[None], b[None], taps[None], wd[None], bd[None],
                           wu[None], bu[None], c0[None], activation)[0]
