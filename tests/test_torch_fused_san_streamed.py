"""Port parity for the step-streamed SAN cascade (TPU kernel
``_cascade_kernel_streamed``) and the JAX package's cascade dispatch.

- The plain version ``san_cascade_streamed_fwd_plain`` against the JAX
  ``_fused_cascade_streamed_impl(..., interpret=True)`` (the Pallas kernel
  run by its interpreter on the CPU): n=21 (not a multiple of 8), k=3,
  d=64, r=8, fp32 and bf16, ReLU and GELU, gated and additive.
- ``fits_vmem`` / ``streamed_tile_rows`` / ``cascade_route`` against the
  JAX predicates and ``_dispatch_fwd`` on a grid of geometries.
- ``fused_cascade`` forward and gradients at (n=5, k=3, d=4096, r=64),
  where both packages stream in bf16 and take the reference in fp32,
  against the JAX ``fused_cascade(interpret=True)`` and ``jax.grad``.
- The resident kernel's cast chain (the carry rounded every step) is a
  different function at a streaming geometry: the port's forward before
  the dispatch was repaired fails the comparison the repaired one passes.
- ``cascade_plan``, the kernels' layout, over every geometry at which
  the JAX dispatch runs a Pallas kernel (K, R and both edges of D), and
  ``fused_cascade`` against JAX at geometries the kernels once refused.

Tolerances: fp32 2e-5 (summation order only, as tests/test_fused_san.py);
bf16 forward: bit-equal where the cast chains are the same (they are at
these sizes), and at most 1e-3 of values a bf16 ulp apart; bf16 gradients
5e-2 relative to each tensor's largest value (the backward recomputes in
fp32 from bf16 inputs in both packages, summing in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.ops import fused_san as jfs
from iisan_tpu_torch.ops import fused_san as fs

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(seed, n, k, d, r):
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(gates=a(k, scale=0.3), taps=a(n, k, d),
                wd=a(k, d, r, scale=d ** -0.5), bd=a(k, r, scale=0.1),
                wu=a(k, r, d, scale=r ** -0.5), bu=a(k, d, scale=0.1),
                c0=a(n, d))


def _jax(inp, dtype):
    return {k: jnp.asarray(v) if k == "gates" else jnp.asarray(v).astype(dtype)
            for k, v in inp.items()}


def _torch(inp, dtype, grad=False):
    out = {k: torch.tensor(v) if k == "gates"
           else torch.tensor(v).to(getattr(torch, dtype))
           for k, v in inp.items()}
    if grad:
        for t in out.values():
            t.requires_grad_(True)
    return out


def _f32(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("activation", ["RELU", "GELU"])
def test_streamed_plain_matches_pallas_interpret(dtype, gated, activation):
    inp = _inputs(0, 21, 3, 64, 8)
    j = _jax(inp, dtype)
    want = jfs._fused_cascade_streamed_impl(
        j["gates"], j["taps"], j["wd"], j["bd"], j["wu"], j["bu"], j["c0"],
        activation, True, gated)
    t = _torch(inp, dtype)
    a, b = fs.cascade_coefs(t["gates"], gated)
    got = fs.san_cascade_streamed_fwd(a, b, t["taps"], t["wd"], t["bd"],
                                      t["wu"], t["bu"], t["c0"],
                                      activation=activation)
    assert got.shape == (21, 64) and got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        assert (_f32(got) != _f32(want)).mean() <= 1e-3
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


GRID = [(7, 768, 64, "float32"), (7, 768, 64, "bfloat16"),
        (7, 192, 64, "bfloat16"), (7, 1024, 64, "float32"),
        (7, 1024, 64, "bfloat16"), (7, 5120, 64, "bfloat16"),
        (7, 8192, 64, "bfloat16"), (7, 8192, 128, "bfloat16"),
        (7, 8192, 64, "float32"), (13, 4096, 512, "float32"),
        (13, 4096, 512, "bfloat16"), (7, 1816, 64, "bfloat16"),
        (7, 1817, 64, "bfloat16"), (3, 4096, 64, "bfloat16"),
        (1, 65536, 256, "bfloat16")]


@pytest.mark.parametrize("k,d,r,dtype", GRID)
def test_dispatch_predicates_are_the_jax_ones(k, d, r, dtype):
    bpe = 4 if dtype == "float32" else 2
    assert fs.fits_vmem(k, d, r, bpe=bpe) == jfs.fits_vmem(k, d, r, bpe=bpe)
    assert fs.streamed_tile_rows(d, r) == jfs.streamed_tile_rows(d, r)
    # the route the JAX _dispatch_fwd takes, read from which impl it calls
    calls = []
    saved = (jfs._fused_cascade_fwd_impl, jfs._fused_cascade_streamed_impl,
             jfs.reference_cascade)
    jfs._fused_cascade_fwd_impl = lambda *a: calls.append("resident")
    jfs._fused_cascade_streamed_impl = lambda *a: calls.append("streamed")
    jfs.reference_cascade = lambda *a: calls.append("reference")
    try:
        taps = jax.ShapeDtypeStruct((8, k, d), jnp.dtype(dtype))
        wd = jax.ShapeDtypeStruct((k, d, r), jnp.dtype(dtype))
        jfs._dispatch_fwd(None, taps, wd, None, None, None, None, "RELU",
                          True, True)
    finally:
        (jfs._fused_cascade_fwd_impl, jfs._fused_cascade_streamed_impl,
         jfs.reference_cascade) = saved
    assert calls == [fs.cascade_route(k, d, r, getattr(torch, dtype))]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("gated", [True, False])
def test_fused_cascade_matches_jax_where_it_streams(dtype, gated):
    n, k, d, r = 5, 3, 4096, 64
    assert fs.cascade_route(k, d, r, getattr(torch, dtype)) == (
        "streamed" if dtype == "bfloat16" else "reference")
    inp = _inputs(1, n, k, d, r)
    proj = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    names = ("gates", "taps", "wd", "bd", "wu", "bu", "c0")

    def jloss(*args):
        out = jfs.fused_cascade(*args, activation="RELU", interpret=True,
                                gated=gated)
        return jnp.sum(out.astype(jnp.float32) * proj), out

    j = _jax(inp, dtype)
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(7)),
                                           has_aux=True)(*(j[x] for x in names))
    t = _torch(inp, dtype, grad=True)
    got = fs.fused_cascade(*(t[x] for x in names), activation="RELU",
                           gated=gated)
    (got.float() * torch.tensor(proj)).sum().backward()
    if dtype == "bfloat16":
        assert (_f32(got) != _f32(want)).mean() <= 1e-3
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    for name, jg in zip(names, jgrads):
        g, w = _f32(t[name].grad), _f32(jg)
        if not gated and name == "gates":
            assert not np.abs(w).any() and not np.abs(g).any()
            continue
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[dtype] * scale,
                                   err_msg=name)


def test_resident_chain_is_not_the_streamed_function():
    # What the port computed before its forward followed the JAX dispatch:
    # the resident kernel's chain (the carry rounded to bf16 every step) at
    # a geometry where the JAX package streams.  It fails the comparison
    # the repaired forward passes.
    n, k, d, r = 5, 3, 4096, 64
    inp = _inputs(1, n, k, d, r)
    want = _f32(jfs.fused_cascade(**_jax(inp, "bfloat16"), activation="RELU",
                                  interpret=True))
    t = _torch(inp, "bfloat16")
    a, b = fs.cascade_coefs(t["gates"], True)
    args = (t["taps"], t["wd"], t["bd"], t["wu"], t["bu"], t["c0"])
    old = _f32(fs.san_cascade_fwd(a[None], b[None], *(x[None] for x in args))[0])
    new = _f32(fs.fused_cascade(t["gates"], *args))
    assert (new != want).mean() <= 1e-3
    assert (old != want).mean() > 1e-2


def _largest(pred, lo=1, hi=1 << 22):
    """Largest d in [lo, hi) with pred(d), pred monotone (true then false);
    0 when pred(lo) is false."""
    if not pred(lo):
        return 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if pred(mid) else (lo, mid)
    return lo


def _meta_args(S, N, K, D, R, dtype):
    """The wrapper's arguments as meta tensors (shapes and dtypes, no memory)."""
    dt = getattr(torch, dtype)
    shapes = ((S, N, K, D), (S, K, D, R), (S, K, R), (S, K, R, D), (S, K, D),
              (S, N, D))
    coefs = torch.empty((S, K), device="meta")
    return (coefs, coefs) + tuple(torch.empty(s, dtype=dt, device="meta")
                                  for s in shapes)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("r", [1, 8, 48, 64, 96, 128, 256, 320])
@pytest.mark.parametrize("k", [1, 2, 3, 7, 13])
def test_cascade_plan_covers_every_jax_kernel_geometry(k, r, dtype):
    # Every D where the JAX dispatch runs a Pallas kernel: the resident one
    # while fits_vmem holds, then (bf16) the streamed one while
    # streamed_tile_rows is positive.  A grid of widths and both edges of
    # each range; at each, the wrapper's check takes the shapes and the
    # plan fits the card and covers D and R.
    bpe = 4 if dtype == "float32" else 2
    d_res = _largest(lambda d: jfs.fits_vmem(k, d, r, bpe=bpe))
    d_str = _largest(lambda d: jfs.streamed_tile_rows(d, r) > 0)
    assert d_res > 64
    top = d_res if dtype == "float32" else max(d_res, d_str)
    widths = set(range(1, top + 1, max(1, top // 60)))
    widths |= {d for e in (1, 64, d_res, d_str) for d in (e - 1, e, e + 1)}
    kernels = 0
    for d in sorted(w for w in widths if w >= 1):
        route = fs.cascade_route(k, d, r, getattr(torch, dtype))
        if route == "reference":
            assert d > d_res
            continue
        kernels += 1
        if route == "resident":
            plan = fs._check(*_meta_args(1, 5, k, d, r, dtype))
        else:
            a = _meta_args(1, 5, k, d, r, dtype)
            plan = fs._check_streamed(a[0][0], a[1][0], *(t[0] for t in a[2:]))
        assert plan == fs.cascade_plan(1, 5, k, d, r, getattr(torch, dtype),
                                       streamed=route == "streamed")
        assert plan.smem_bytes <= fs.SMEM_OPTIN_BYTES
        assert 1 <= plan.cluster <= 16 and plan.r_pad >= r
        assert plan.cluster * plan.d_slice >= d > (plan.cluster - 1) * plan.d_slice
        assert plan.carry in ("smem", "global")
        if dtype == "float32":
            assert plan.cluster == 1
        else:
            assert plan.d_slice % 64 == 0 and plan.r_pad % plan.r_chunk == 0
            assert plan.r_chunk in (64, 128, 192, 256) and plan.stages >= 2
    assert kernels > 50


def test_check_takes_d3584_bf16():
    # (K, D, R) = (2, 3584, 64) bf16: the JAX package runs its resident
    # kernel there; the port's check raised (shared memory above 227 KB).
    assert fs.cascade_route(2, 3584, 64, torch.bfloat16) == "resident"
    plan = fs._check(*_meta_args(1, 704, 2, 3584, 64, "bfloat16"))
    assert plan.smem_bytes <= fs.SMEM_OPTIN_BYTES
    assert plan.cluster * plan.d_slice >= 3584


REPAIRED = [(1, 4096, 64, "bfloat16", "resident"), (2, 3584, 64, "bfloat16", "resident"),
            (1, 2048, 64, "float32", "resident"), (7, 768, 48, "bfloat16", "resident"),
            (7, 2048, 320, "bfloat16", "streamed")]


@pytest.mark.parametrize("k,d,r,dtype,route", REPAIRED)
def test_fused_cascade_matches_jax_at_repaired_geometries(k, d, r, dtype, route):
    # Geometries the port's kernels refused before (D past 3,312 bf16 or
    # 1,656 fp32, R not dividing 256): the port's forward against the JAX
    # fused_cascade (Pallas in interpret mode) at a few rows.  The streamed
    # chain at K=7 keeps an fp32 carry across seven steps: where the two
    # frameworks' sums round one activation of a row to the other bf16
    # neighbour, the whole row moves by about a tenth of an output ulp, so
    # about a tenth of the outputs round the other way (9.2% here), small
    # values (made by cancellation) by many of their own ulps: there each
    # value is held to ``carry_tolerance``, four bf16 ulps of its row's
    # largest value plus 1e-3 (the kernels' bound), instead of the count.
    assert fs.cascade_route(k, d, r, getattr(torch, dtype)) == route
    inp = _inputs(3, 5, k, d, r)
    names = ("gates", "taps", "wd", "bd", "wu", "bu", "c0")
    j = _jax(inp, dtype)
    want = _f32(jfs.fused_cascade(*(j[x] for x in names), activation="RELU",
                                  interpret=True))
    t = _torch(inp, dtype)
    got = fs.fused_cascade(*(t[x] for x in names), activation="RELU")
    assert got.shape == (5, d) and got.dtype == getattr(torch, dtype)
    got = _f32(got)
    if route == "streamed" and k == 7:
        bound = fs.carry_tolerance(torch.from_numpy(want)).numpy()
        assert (np.abs(got - want) <= bound).all()
    elif dtype == "bfloat16":
        assert (got != want).mean() <= 1e-3
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
