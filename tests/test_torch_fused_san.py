"""Port parity: the SAN cascade kernel's plain PyTorch version and the
module-path cascades (iisan_tpu_torch.ops.fused_san) against the JAX
package (iisan_tpu.ops.fused_san).

- S=1 plain version vs the Pallas ``fused_cascade(..., interpret=True)``:
  gated and additive, ReLU and GELU, N=37 (not a multiple of 8).
- The S=3 coefficient form vs ``multi_reference_cascade``.
- ``reference_cascade`` vs the JAX ``reference_cascade``.
- ``carry_tolerance``, the bound the card's kernel checks use: it admits
  another rounding order and rejects each planted fault in every branch.

Tolerances: fp32 2e-5, as tests/test_fused_san.py uses (summation order
only); bf16 5e-2 for the cast chain: XLA on the CPU may keep the
additive fused tap in fp32 where the kernel rounds it to bf16, which
moves a carry of magnitude ~7 by up to two bf16 ulps (0.0625 there).
Where the cast chains are the same the bf16 results agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.ops import fused_san as jfs
from iisan_tpu_torch.ops import fused_san as fs

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(seed, n=37, k=3, d=32, r=8, s=None):
    rng = np.random.default_rng(seed)
    lead = () if s is None else (s,)

    def a(*shape, scale=1.0):
        return (rng.standard_normal(lead + shape) * scale).astype(np.float32)

    return dict(gates=a(k, scale=0.3), taps=a(n, k, d), wd=a(k, d, r, scale=0.1),
                bd=a(k, r, scale=0.01), wu=a(k, r, d, scale=0.1),
                bu=a(k, d, scale=0.01), c0=a(n, d))


def _jax(inp, dtype):
    return {k: jnp.asarray(v) if k == "gates" else jnp.asarray(v).astype(dtype)
            for k, v in inp.items()}


def _torch(inp, dtype):
    return {k: torch.tensor(v) if k == "gates"
            else torch.tensor(v).to(getattr(torch, dtype))
            for k, v in inp.items()}


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("activation", ["RELU", "GELU"])
def test_plain_matches_pallas_fused_cascade(dtype, gated, activation):
    inp = _inputs(0)
    want = jfs.fused_cascade(**_jax(inp, dtype), activation=activation,
                             interpret=True, gated=gated)
    got = fs.fused_cascade(**_torch(inp, dtype), activation=activation,
                           gated=gated)
    assert got.shape == (37, 32) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["RELU", "GELU"])
def test_coefficient_form_matches_multi_reference(dtype, activation):
    inp = _inputs(1, s=3)
    a, b = jfs.cascade_coefs(jnp.asarray(inp["gates"][0]), True)
    ones = jnp.ones_like(a)
    # branch 0 gated, branch 1 additive, branch 2 gated with its own gates
    a2, b2 = jfs.cascade_coefs(jnp.asarray(inp["gates"][2]), True)
    coef_a = np.asarray(jnp.stack([a, ones, a2]))
    coef_b = np.asarray(jnp.stack([b, ones, b2]))
    j = _jax({k: v for k, v in inp.items() if k != "gates"}, dtype)
    want = jfs.multi_reference_cascade(jnp.asarray(coef_a), jnp.asarray(coef_b),
                                       j["taps"], j["wd"], j["bd"], j["wu"],
                                       j["bu"], j["c0"], activation=activation)
    t = _torch({k: v for k, v in inp.items() if k != "gates"}, dtype)
    args = (torch.tensor(coef_a), torch.tensor(coef_b), t["taps"], t["wd"],
            t["bd"], t["wu"], t["bu"], t["c0"])
    plain = fs.san_cascade_fwd(*args, activation=activation)
    assert plain.shape == (3, 37, 32)
    _close(plain, want, dtype)
    _close(fs.multi_reference_cascade(*args, activation=activation), want,
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False])
def test_reference_cascade_matches_jax(dtype, gated):
    inp = _inputs(2)
    want = jfs.reference_cascade(**_jax(inp, dtype), activation="GELU",
                                 gated=gated)
    got = fs.reference_cascade(**_torch(inp, dtype), activation="GELU",
                               gated=gated)
    _close(got, want, dtype)


def test_cascade_coefs_match_jax():
    gates = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    for gated in (True, False):
        want = jfs.cascade_coefs(jnp.asarray(gates), gated)
        got = fs.cascade_coefs(torch.tensor(gates), gated)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def _carry_inputs(s=3, n=64, k=7, d=128, r=16):
    """bf16 coefficient-form inputs in which every term moves the carry by
    O(1): wd ~ N(0, 1/D), wu ~ N(0, 1/R), biases ~ N(0, 0.25), gates mixed
    around 0.5; the last branch is additive."""
    rng = np.random.default_rng(5)

    def a(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32).to(torch.bfloat16)

    g = torch.tensor(rng.standard_normal((s, k)), dtype=torch.float32)
    coef_a = torch.sigmoid(0.1 * g / fs.GATE_TEMPERATURE)
    coef_a[-1] = 1.0
    coef_b = 1.0 - coef_a
    coef_b[-1] = 1.0
    return [coef_a, coef_b, a(s, n, k, d), a(s, k, d, r, scale=d ** -0.5),
            a(s, k, r, scale=0.5), a(s, k, r, d, scale=r ** -0.5),
            a(s, k, d, scale=0.5), a(s, n, d)]


@pytest.mark.parametrize("activation", ["RELU", "GELU"])
def test_carry_tolerance_admits_other_rounding(activation):
    # The module-path cascade rounds the up projection before `+ f` (two
    # roundings per step where the kernel has one): within the bound.
    args = _carry_inputs()
    want = fs.san_cascade_fwd_plain(*args, activation=activation)
    other = fs.multi_reference_cascade(*args, activation=activation)
    assert not torch.equal(other, want)
    assert ((other.float() - want.float()).abs()
            <= fs.carry_tolerance(want)).all()


@pytest.mark.parametrize("fault", ["bd dropped", "bu dropped",
                                   "other activation", "step-0 weights"])
def test_carry_tolerance_rejects_planted_fault(fault):
    # What a wrong kernel body would return, each beyond the bound in every
    # branch, gated and additive alike.
    args = _carry_inputs()
    want = fs.san_cascade_fwd_plain(*args)
    a, b, taps, wd, bd, wu, bu, c0 = args
    activation = "GELU" if fault == "other activation" else "RELU"
    if fault == "bd dropped":
        bd = torch.zeros_like(bd)
    elif fault == "bu dropped":
        bu = torch.zeros_like(bu)
    elif fault == "step-0 weights":
        wd, bd, wu, bu = (w[:, :1].expand_as(w) for w in (wd, bd, wu, bu))
    got = fs.san_cascade_fwd_plain(a, b, taps, wd, bd, wu, bu, c0,
                                   activation=activation)
    beyond = (got.float() - want.float()).abs() > fs.carry_tolerance(want)
    assert beyond.flatten(1).any(1).all()


def test_kernel_wrapper_rejects_bad_bottleneck():
    # A bottleneck that does not divide 256 (R=48) is taken; one whose
    # activations and partial sums exceed a block's shared memory (R above
    # 1,472 in bf16, 3,376 in fp32) is refused.  The check runs before any
    # build, and only for CUDA tensors, so call it directly.
    inp = _torch(_inputs(4, r=48, s=1), "float32")
    coefs = torch.ones(1, 3)
    assert fs._check(coefs, coefs, inp["taps"], inp["wd"], inp["bd"], inp["wu"],
                     inp["bu"], inp["c0"]).r_pad == 48
    for r, dtype in ((1473, torch.bfloat16), (3377, torch.float32)):
        shapes = ((1, 4, 3, 64), (1, 3, 64, r), (1, 3, r), (1, 3, r, 64), (1, 3, 64),
                  (1, 4, 64))
        args = [torch.empty(sh, dtype=dtype, device="meta") for sh in shapes]
        meta = torch.empty((1, 3), device="meta")
        with pytest.raises(ValueError, match=f"R={r}"):
            fs._check(meta, meta, *args)
