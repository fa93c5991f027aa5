"""Port parity for ``fused_cascade`` under autograd.

On the CPU the port's ``fused_cascade`` runs the plain forward and
``cascade_bwd``, the transcription of the JAX custom VJP
(``_recompute_carries`` + ``_bwd``).  Its gradients for the gates, taps,
adapter weights and biases and the initial carry are held against
``jax.grad`` of the JAX ``fused_cascade(..., interpret=True)``, gated and
additive, ReLU and GELU, fp32: |diff| <= 1e-4 * (1 + |want|) (the two
recompute the carries in fp32 and differ in summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.ops import fused_san as jfs
from iisan_tpu_torch.ops import fused_san as fs

N, K, DIM, R = 24, 3, 32, 8
NAMES = ("gates", "taps", "wd", "bd", "wu", "bu", "c0")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (rand(K, scale=0.2), rand(N, K, DIM), rand(K, DIM, R, scale=DIM ** -0.5),
            rand(K, R, scale=0.5), rand(K, R, DIM, scale=R ** -0.5),
            rand(K, DIM, scale=0.5), rand(N, DIM)), rand(N, DIM)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("activation", ["RELU", "GELU"])
def test_cascade_gradients_match_jax(activation, gated):
    args, proj = _inputs()

    def jloss(*a):
        out = jfs.fused_cascade(*a, activation=activation, interpret=True,
                                gated=gated)
        return jnp.sum(out * proj)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fs.fused_cascade(*targs, activation=activation, gated=gated)
    (out * torch.from_numpy(proj)).sum().backward()
    for name, t, w in zip(NAMES, targs, want):
        got, w = t.grad.numpy(), np.asarray(w)
        assert got.shape == w.shape, name
        assert (np.abs(got - w) <= 1e-4 * (1 + np.abs(w))).all(), name
    if not gated:
        assert not targs[0].grad.any()


def test_cascade_kernel_path_gives_gradients(monkeypatch):
    """The kernel's result is written outside autograd; the function's own
    backward must still give every input its gradient (stand-in: the plain
    result, detached)."""
    args, proj = _inputs(1)
    plain = fs.san_cascade_fwd_plain
    monkeypatch.setattr(fs, "san_cascade_fwd",
                        lambda *a, **k: plain(*a, **k).detach())
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (fs.fused_cascade(*targs) * torch.from_numpy(proj)).sum().backward()
    ref = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (fs.reference_cascade(*ref) * torch.from_numpy(proj)).sum().backward()
    for name, t, r in zip(NAMES, targs, ref):
        assert t.grad is not None and t.grad.abs().sum() > 0, name
        torch.testing.assert_close(t.grad, r.grad, rtol=1e-4, atol=1e-4)


def test_cascade_bf16_gradients_keep_dtypes():
    args, proj = _inputs(2)
    targs = [torch.from_numpy(a) for a in args]
    targs = [targs[0]] + [t.to(torch.bfloat16) for t in targs[1:]]
    for t in targs:
        t.requires_grad_(True)
    out = fs.fused_cascade(*targs)
    (out.float() * torch.from_numpy(proj)).sum().backward()
    for t in targs:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()
