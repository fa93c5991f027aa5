"""SAN adapter cascade: CUDA kernel wrapper, plain versions, references.

Port of ``iisan_tpu/ops/fused_san.py``.  The cascade is

    f_i   = a_i * tap_i + b_i * c_i      (gated: a = sigmoid(theta/0.1), b = 1 - a;
                                          additive: a = b = 1)
    c_i+1 = W_up_i @ act(W_dn_i @ f_i + b_dn_i) + b_up_i + f_i

``san_cascade_fwd`` is the kernel wrapper (``csrc/san_cascade_fwd.cu``): S
branches in one launch, per-step coefficients (S, K).  ``fused_cascade``
is one branch under autograd: its forward is the kernel with S=1 and
``cascade_coefs``, its backward ``cascade_bwd``, the JAX custom VJP's
plain backward (the JAX package has no kernel for it either).  ``san_cascade_fwd_plain``
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
    """One branch's cascade under autograd: forward ``san_cascade_fwd``
    (the kernel on CUDA) with S=1, backward ``cascade_bwd``.  Only the
    inputs are saved; the backward recomputes the carries."""

    @staticmethod
    def forward(ctx, gates, taps, wd, bd, wu, bu, c0, activation, gated):
        ctx.activation, ctx.gated = activation, gated
        ctx.save_for_backward(gates, taps, wd, bd, wu, bu, c0)
        a, b = cascade_coefs(gates, gated)
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
    bu (K, D), c0 (N, D) -> (N, D): the kernel with S=1 forward,
    ``cascade_bwd`` backward.
    """
    return FusedCascadeFn.apply(gates, taps, wd, bd, wu, bu, c0, activation,
                                gated)
