"""The user-encoder kernels at every width the JAX kernel takes, the
kernels' memory plan, and the two parameter packs.

- ``supported`` / ``bwd_supported`` against the JAX kernel's ``supported``
  over every D from 8 to 1,024 and every head count that divides it (and
  some that do not): equal where the JAX predicate takes a batch of 8.
- The plain forward and backward against the JAX Pallas kernel in
  interpret mode at D=36, H=2 and D=24, H=3 (widths that are not a multiple
  of 8, and head widths of 18 and 8), batch 8 (the JAX kernel's batch rule),
  eval mode: fp32 rtol 1e-5 (forward) and rtol 5e-4 atol 5e-5 (gradients),
  bf16 5e-2 (forward) and 5e-2 * (max|want| + |want|) per tensor
  (gradients), the tolerances of tests/test_torch_fused_user_encoder.py and
  tests/test_torch_user_encoder_bwd.py.
- ``encoder_plan`` (the Python counterpart of the kernels' placement and
  memory arithmetic) at every geometry the CUDA tests and chip_smoke.py
  run: within 227 KB of shared memory on both routes, the serving and
  training geometries resident; on the fp32 route the tile's sequences,
  placement and exact bytes at L = 10, 20, 50, D = 64, 128, depth 1, 2, 6
  and B = 1, 64, 256, from the layout written out again.
- The plain versions give bit-equal results from the rounded pack (serving)
  and the unrounded one (training: one ``cat``).
- The plain backward at another computation's ReLU decisions (the
  reference of the tensor-core backward on the card,
  ``iisan_tpu_torch.testing``) takes a decision only where the other
  computation's FFN input explains it and its own pre-activation is within
  four bf16 ulps of the operands' scale, and at most 16 of them here;
  planted faults past each limit are refused.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iisan_tpu.models.user_encoder import UserEncoder as JaxUserEncoder
from iisan_tpu.models.user_encoder import causal_additive_mask as jax_mask
from iisan_tpu.ops import fused_user_encoder as jfue
from iisan_tpu_torch import testing as et
from iisan_tpu_torch.models.user_encoder import (UserEncoder,
                                                 causal_additive_mask)
from iisan_tpu_torch.ops import fused_user_encoder as fue
from iisan_tpu_torch.utils.jax_params import flatten_tree, load_jax_params

L, NL, B = 10, 2, 8


@pytest.fixture()
def interpret_pallas():
    """Force pallas_call into interpreter mode (CPU-runnable kernels)."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        yield


@pytest.mark.parametrize("lo", range(8, 1025, 128))
def test_supported_matches_jax_on_widths(lo):
    for D in range(lo, min(lo + 128, 1025)):
        for H in [h for h in range(1, D + 1) if D % h == 0] + [7, 5, 3]:
            want = jfue.supported(B, L, D, H)
            assert fue.supported(B, L, D, H, 4 * D, L) == want, (D, H)
            assert fue.bwd_supported(B, L, D, H, 4 * D, NL, L) == want, (D, H)


def _setup(D, H, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    log_mask = (rng.random((B, L)) > 0.2).astype(np.float32)
    log_mask[:, -1] = 1.0
    log_mask[0] = 0.0  # an all-pad row: the uniform softmax
    jue = JaxUserEncoder(max_seq_len=L, num_attention_heads=H, n_layers=NL,
                         dropout=0.0, dtype=jnp.float32, fused=False)
    params = jue.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                      jnp.asarray(log_mask))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    proj = rng.standard_normal((B, L, D)).astype(np.float32)
    tue = UserEncoder(D, L, H, NL, 0.0)
    load_jax_params(tue, params)
    return params, tue, x, log_mask, proj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,H", [(36, 2), (24, 3)])
def test_plain_matches_jax_kernel_at_odd_widths(interpret_pallas, D, H, dtype):
    params, tue, x, log_mask, proj = _setup(D, H)
    tdt = getattr(torch, dtype)

    def jax_loss(p, xx):
        y = jfue.apply_fused_encoder(
            p, xx.astype(dtype), jax_mask(jnp.asarray(log_mask)), n_layers=NL,
            n_heads=H, drop_rate=0.0, compute_dtype=dtype)
        return jnp.sum(y.astype(jnp.float32) * proj), y

    (_, y_j), (gp_j, gx_j) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params["transformer_encoder"],
                                                jnp.asarray(x))
    xx = torch.from_numpy(x).requires_grad_(True)
    flat = fue.flatten_encoder_params(tue.transformer_encoder, NL)
    y_t = fue.apply_fused_encoder(
        fue.pack_encoder_params(flat, tdt, differentiable=True), xx,
        causal_additive_mask(torch.from_numpy(log_mask)), n_layers=NL,
        n_heads=H, d_ff=4 * D, n_position=L, compute_dtype=tdt)
    (y_t.float() * torch.from_numpy(proj)).sum().backward()

    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y_t.detach().float().numpy(),
                               np.asarray(y_j, np.float32), rtol=tol, atol=tol)
    want = {k.replace(".", "/"): np.asarray(v, np.float32)
            for k, v in flatten_tree(gp_j).items()}
    got = {n.replace(".", "/"): p.grad.numpy()
           for n, p in tue.transformer_encoder.named_parameters()}
    got["x"], want["x"] = xx.grad.float().numpy(), np.asarray(gx_j, np.float32)
    assert got.keys() == want.keys()
    for name in want:
        assert np.isfinite(got[name]).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(got[name], want[name], rtol=5e-4,
                                       atol=5e-5, err_msg=name)
        else:
            bound = 5e-2 * (np.abs(want[name]).max() + np.abs(want[name]))
            assert (np.abs(got[name] - want[name]) <= bound).all(), name


# (B, L, D, H, n_layers): the geometries of tests/test_torch_kernels_cuda.py
# and chip_smoke.py (serving at B=1 and 256, training at B=64, L=20).
GEOMETRIES = [(1, 10, 64, 2, 2), (256, 10, 64, 2, 2), (64, 10, 64, 2, 2),
              (37, 7, 48, 3, 1), (5, 20, 128, 4, 3), (8, 20, 64, 2, 2),
              (4, 50, 64, 2, 2), (4, 50, 128, 2, 2), (3, 10, 64, 2, 6),
              (8, 10, 36, 2, 2), (6, 10, 12, 3, 1), (3, 10, 64, 2, 1),
              (16, 20, 64, 2, 2), (4, 20, 128, 2, 2), (2, 10, 5461, 43, 1),
              (2, 10, 1820, 2, 1)]


@pytest.mark.parametrize("B_,L_,D,H,n_layers", GEOMETRIES)
def test_encoder_plan_fits_shared_memory(B_, L_, D, H, n_layers):
    F = 4 * D
    for dtype in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            if backward and not fue.bwd_supported(B_, L_, D, H, F, n_layers):
                continue
            plan = fue.encoder_plan(B_, L_, D, H, F, n_layers, dtype, backward)
            assert plan.smem_bytes <= 227 * 1024
            assert (plan.scratch_bytes == 0) == (plan.place == fue.RESIDENT)
            assert plan.route == ("tensor cores" if dtype == torch.bfloat16
                                  else "tf32 wgmma")
            assert (plan.work_bytes > 0) == backward


def test_encoder_plan_at_the_main_path_geometry():
    # Serving and training (L=10, D=64, H=2, F=256, 2 blocks) keep every
    # area in shared memory; the bf16 forward takes 107,696 bytes (two
    # blocks an SM), and the bf16 backward's device buffer at B=64 is
    # 3,112,960 bytes: the weight-gradient operands (2.6 MB), the partial
    # rows and the fp32 input gradient, against a (B, P) scratch of 25.7 MB.
    fwd = fue.encoder_plan(256, 10, 64, 2, 256, 2, torch.bfloat16)
    bwd = fue.encoder_plan(64, 10, 64, 2, 256, 2, torch.bfloat16, backward=True)
    assert fwd == fue.EncoderPlan("tensor cores", fue.RESIDENT, 107696, 0, 0)
    assert bwd == fue.EncoderPlan("tensor cores", fue.RESIDENT, 185856, 0, 3112960)
    lay = fue.tc_work_layout(64, 10, 64, 256, 2, 0)
    assert lay["layer"] * 2 * 2 == 2621440 and lay["Q"] == 2 * 64 + 2 * (5 * 64 + 256)
    P = sum(np.prod(s) for s in fue.param_shapes(64, 256, 2, 10))
    assert 64 * P * 4 > 8 * bwd.work_bytes
    # a long or deep stash leaves shared memory, not the kernel
    assert fue.encoder_plan(4, 50, 128, 2, 512, 2, torch.bfloat16, True).place == fue.SPILLED
    assert fue.encoder_plan(3, 10, 64, 2, 256, 6, torch.bfloat16, True).place == fue.SLOTS_GLOBAL


def _f32_expected(B_, L_, D, H, F, n_layers, backward, n_sm=132):
    """The fp32 route's tile and buffer at n_sm SMs (an H100's 132 by
    default), written out from the layout csrc/user_encoder_f32.cu{,h}
    describes: a ring of three 32 KB stages (a weight tile, then its TF32
    hi and lo halves) and 64 bytes of barriers after 1,024 bytes of
    alignment; per tile (up to 64 rows of whole sequences, one tile an SM
    of B) fp32 areas with row strides of 32 k + 4 floats; the backward's
    per-layer rows (x, ctx, x1, hf, q|k|v, two xhats, g_hpre, the
    probabilities, two rstds) over all B L rows, then the input
    LayerNorm's xhat and rstd and a partial row a tile."""
    def stride(n):
        return -(-n // 32) * 32 + 4

    def a16(n):
        return -(-n // 16) * 16

    sD, s3D, sF = stride(D), stride(3 * D), stride(F)
    G = min(64 // L_ if L_ <= 64 else 1, -(-B_ // n_sm))
    while True:
        rows, scores = G * L_, G * H * L_ * L_
        if backward:
            floats = rows * (4 * sD + s3D) + 2 * scores
        else:
            floats = rows * (3 * sD + max(s3D + sD, sF)) + scores
        smem = 1024 + 3 * 32768 + 64 + 4 * floats
        if smem <= 232448 or G == 1:
            break
        G -= 1
    spilled = smem > 232448
    if spilled:  # the areas of every sequence a tile wants go to its scratch
        G = min(64 // L_ if L_ <= 64 else 1, -(-B_ // n_sm))
        rows, scores = G * L_, G * H * L_ * L_
        floats = (rows * (4 * sD + s3D) + 2 * scores if backward
                  else rows * (3 * sD + max(s3D + sD, sF)) + scores)
    scratch = a16(4 * floats) if spilled else 0
    work = 0
    if backward:
        R, nblk = B_ * L_, -(-B_ // G)
        per_layer = 4 * R * (8 * D + 2 * F + H * L_ + 2)
        Qp = 2 * D + n_layers * (5 * D + F) + L_ * D
        work = (n_layers * per_layer + a16(4 * R * D) + a16(4 * R)
                + a16(4 * nblk * Qp) + nblk * scratch)
    return G, spilled, (1024 + 3 * 32768 + 64 if spilled else smem), scratch, work


@pytest.mark.parametrize("B_", [1, 64, 256])
@pytest.mark.parametrize("n_layers", [1, 2, 6])
@pytest.mark.parametrize("L_,D", [(10, 64), (20, 64), (50, 64), (10, 128), (20, 128),
                                  (50, 128)])
def test_f32_encoder_plan_bytes(B_, n_layers, L_, D):
    F, H = 4 * D, 2
    for backward in (False, True):
        plan = fue.encoder_plan(B_, L_, D, H, F, n_layers, torch.float32, backward)
        G, spilled, smem, scratch, work = _f32_expected(B_, L_, D, H, F, n_layers, backward)
        assert plan == fue.EncoderPlan("tf32 wgmma", fue.SPILLED if spilled else fue.RESIDENT,
                                       smem, scratch, work, G)
        assert plan.smem_bytes <= 227 * 1024
    # the training geometry: every tile in shared memory, no (B, P) scratch
    if (B_, L_, D, n_layers) == (64, 10, 64, 2):
        assert plan == fue.EncoderPlan("tf32 wgmma", fue.RESIDENT, 119712, 0, 6013440, 1)
        P = sum(np.prod(s) for s in fue.param_shapes(D, F, n_layers, L_))
        assert 64 * P * 4 > 4 * plan.work_bytes


@pytest.mark.parametrize("B_,L_,D,n_sm,G", [(7, 10, 64, 1, 6), (133, 10, 64, 132, 2),
                                            (399, 10, 64, 132, 4), (700, 10, 64, 132, 6),
                                            (395, 20, 64, 132, 3), (256, 10, 64, 256, 1),
                                            (64, 10, 64, 16, 4), (10, 10, 128, 1, 3),
                                            (64, 10, 1376, 1, 6)])
def test_f32_encoder_plan_follows_the_sm_count(B_, L_, D, n_sm, G):
    # A tile takes the fewest whole sequences that give each of n_sm SMs
    # one tile, up to 64 rows; fewer where that keeps its areas in shared
    # memory (three at D = 128), else that many with its areas in its
    # scratch (D = 1,376).  The plan is the arithmetic's at any count.
    F, H, n_layers = 4 * D, 2, 2
    for backward in (False, True):
        plan = fue.encoder_plan(B_, L_, D, H, F, n_layers, torch.float32, backward, n_sm=n_sm)
        want = _f32_expected(B_, L_, D, H, F, n_layers, backward, n_sm)
        assert plan == fue.EncoderPlan("tf32 wgmma", fue.SPILLED if want[1] else fue.RESIDENT,
                                       *want[2:], want[0])
        assert fue.f32_tile_plan(L_, D, H, F, backward, B_, n_sm)[0] == plan.tile_seqs
    assert plan.tile_seqs == G


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_versions_take_either_pack(rate):
    gen = torch.Generator().manual_seed(5)
    D, H = 36, 2
    enc = UserEncoder(D, L, H, NL, 0.0, generator=gen)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    flat = fue.flatten_encoder_params(enc.transformer_encoder, NL)
    rounded = fue.pack_encoder_params(flat, torch.bfloat16)
    plain = fue.pack_encoder_params(flat, torch.bfloat16, differentiable=True)
    assert not torch.equal(rounded, plain.detach())
    x = torch.randn(B, L, D, generator=gen).to(torch.bfloat16)
    mask3 = causal_additive_mask(torch.ones(B, L)).reshape(B, L, L)
    gout = torch.randn(B, L, D, generator=gen).to(torch.bfloat16)
    kw = dict(n_layers=NL, n_heads=H, d_ff=4 * D, n_position=L, seed=11,
              rate=rate)
    a = fue.user_encoder_fwd_plain(x, mask3, rounded, **kw)
    b = fue.user_encoder_fwd_plain(x, mask3, plain.detach(), **kw)
    assert torch.equal(a, b)
    ga = fue.user_encoder_bwd_plain(x, mask3, rounded, gout, **kw)
    gb = fue.user_encoder_bwd_plain(x, mask3, plain.detach(), gout, **kw)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


def _relu_case():
    gen = torch.Generator().manual_seed(6)
    D, H = 36, 2
    enc = UserEncoder(D, L, H, NL, 0.0, generator=gen)
    flat = fue.flatten_encoder_params(enc.transformer_encoder, NL)
    packed = fue.pack_encoder_params(flat, torch.bfloat16)
    x = torch.randn(B, L, D, generator=gen).to(torch.bfloat16)
    mask3 = causal_additive_mask(torch.ones(B, L)).reshape(B, L, L)
    gout = torch.randn(B, L, D, generator=gen).to(torch.bfloat16)
    kw = dict(n_layers=NL, n_heads=H, d_ff=4 * D, n_position=L, seed=3, rate=0.1)
    return x, mask3, packed, gout, kw


def _ulp_away(t):
    """Each entry of a bf16 tensor moved one ulp away from zero."""
    return (t.view(torch.int16) + 1).view(torch.bfloat16)


def _last_block_window(x, mask3, packed, kw, other_x1):
    """Flat indices of the last block's pre-activations that another
    computation with FFN inputs ``other_x1`` may flip (within the band and
    what the inputs' difference explains), nearest zero first (flips there
    leave the other blocks as they are)."""
    flat, _, stash, pres = et._forward_at(x, mask3, packed, None, kw)
    apre, band, expl = et._windows(flat, stash, pres, other_x1, x.dtype)[-1]
    ok = (apre <= band) & (apre <= expl)
    ratio = torch.where(ok, apre / band, torch.full_like(apre, float("inf")))
    return torch.argsort(ratio)[:int(ok.sum())]


def test_plain_backward_takes_relu_decisions_only_near_zero():
    """``iisan_tpu_torch.testing.plain_bwd_at_decisions``: the plain
    backward at another computation's FFN ReLU decisions (the tensor-core
    kernel's, on the card) equals the plain backward at its own decisions,
    and takes one that differs where the other computation's FFN input
    (here the plain one, each entry a bf16 ulp away) explains it, within
    ``relu_band`` of zero."""
    x, mask3, packed, gout, kw = _relu_case()
    own, x1 = et.plain_relu_inputs(x, mask3, packed, **kw)
    base = fue.user_encoder_bwd_plain(x, mask3, packed, gout, **kw)
    gx, gp, flips = et.plain_bwd_at_decisions(x, mask3, packed, gout, own, x1, **kw)
    assert torch.equal(gx, base[0]) and torch.equal(gp, base[1])
    assert flips == (0, 16, 0.0, 0.0)
    other = [_ulp_away(t) for t in x1]
    near = [m.clone() for m in own]
    j = _last_block_window(x, mask3, packed, kw, other)[0]
    near[-1].view(-1)[j] = ~near[-1].view(-1)[j]
    moved = et.plain_bwd_at_decisions(x, mask3, packed, gout, near, other, **kw)
    assert not torch.equal(moved[1], base[1])
    assert moved[2].count == 1 and moved[2].band <= 1.0 and moved[2].explained <= 1.0


def test_relu_band_is_four_ulps_of_the_operands_scale():
    x1 = torch.tensor([[1.0, -2.0], [0.0, 0.5]])
    w1 = torch.tensor([[3.0, 0.0, 1.0], [4.0, 1.0, -1.0]])
    b1 = torch.tensor([0.5, -1.0, 0.0])
    want = 2.0 ** -6 * torch.tensor([[73 ** 0.5 + 0.5, 3.0, 5 ** 0.5],
                                     [2.5, 1.5, 0.5]])
    assert torch.allclose(et.relu_band(x1, w1, b1, torch.float32), want)
    # the inputs' difference through |w1|, the two roundings, the sums
    other = torch.tensor([[1.0, -2.5], [0.0, 0.5]])
    pre = x1 @ w1 + b1
    want = ((1 + 2.0 ** -6) * torch.tensor([[2.0, 0.5, 0.5], [0.0, 0.0, 0.0]])
            + 2.0 ** -6 * ((x1 @ w1).abs() + pre.abs())
            + 2 * 2.0 ** -24 * (x1.abs() @ w1.abs()))
    assert torch.allclose(et.explained(x1, other, w1, b1, pre, torch.float32), want)
    assert et.max_flips(164 * 1024) == 41 and et.max_flips(2 ** 15) == 16


def _tf32_relu_case(where):
    """An fp32 case whose last block holds one FFN pre-activation (its
    first) at ``where`` times the fp32 route's band (``relu_band`` with
    tf32): that block's first FFN bias moved to put it there."""
    gen = torch.Generator().manual_seed(6)
    D, H = 36, 2
    enc = UserEncoder(D, L, H, NL, 0.0, generator=gen)
    flat = fue.flatten_encoder_params(enc.transformer_encoder, NL)
    x = torch.randn(B, L, D, generator=gen)
    mask3 = causal_additive_mask(torch.ones(B, L)).reshape(B, L, L)
    gout = torch.randn(B, L, D, generator=gen)
    kw = dict(n_layers=NL, n_heads=H, d_ff=4 * D, n_position=L, seed=3, rate=0.1)
    k0 = 3 + fue.PER_BLOCK * (NL - 1)
    flat = [t.detach().float().clone() for t in flat]
    for _ in range(4):
        packed = fue.pack_encoder_params(flat, torch.float32)
        _, _, stash, pres = et._forward_at(x, mask3, packed, None, kw)
        band = et.relu_band(stash[NL][8], flat[k0 + 6], flat[k0 + 7], torch.float32,
                            tf32=True).reshape(-1)[0]
        flat[k0 + 7][0] += where * band - pres[-1].reshape(-1)[0]
    packed = fue.pack_encoder_params(flat, torch.float32)
    return x, mask3, packed, gout, kw


@pytest.mark.parametrize("where", [0.5, 1.2])
def test_tf32_band_takes_a_flip_inside_and_refuses_one_just_outside(where):
    """The fp32 route's window (``tf32``: four 2^-20 units of the
    operands' scale): a decision flipped at half the band is taken (the
    three passes' own error explains it), one just outside the band, the
    nearest past it (``flip_outside_band`` with ``tf32``), is refused."""
    x, mask3, packed, gout, kw = _tf32_relu_case(where)
    own, x1 = et.plain_relu_inputs(x, mask3, packed, **kw)
    flat, _, stash, pres = et._forward_at(x, mask3, packed, None, kw)
    apre, band, _ = et._windows(flat, stash, pres, x1, x.dtype, True)[-1]
    assert abs(float(apre[0] / band[0]) - where) < 0.05
    if where < 1:
        near = [m.clone() for m in own]
        near[-1].view(-1)[0] = ~near[-1].view(-1)[0]
        flips = et.plain_bwd_at_decisions(x, mask3, packed, gout, near, x1, True, **kw)[2]
        assert flips.count == 1 and flips.band <= 1.0 and flips.explained <= 1.0
        return
    bad, ratio = et.flip_outside_band(x, mask3, packed, own, tf32=True, **kw)
    assert 1.0 < ratio < where + 0.05
    with pytest.raises(ValueError, match="differ from the plain forward's"):
        et.plain_bwd_at_decisions(x, mask3, packed, gout, bad, x1, True, **kw)


@pytest.mark.parametrize("fault", ["just_outside", "far", "unexplained", "too_many"])
def test_plain_backward_refuses_relu_decisions_past_the_band(fault):
    """Planted faults: a decision flipped just outside the band (the
    smallest |pre| / band above 1), one flipped at the largest
    pre-activation, one within the band that the other computation's FFN
    input (here equal to the plain one) does not explain, and
    ``max_flips`` + 1 flipped within both; each is refused, while
    ``max_flips`` within both are taken."""
    x, mask3, packed, gout, kw = _relu_case()
    own, x1 = et.plain_relu_inputs(x, mask3, packed, **kw)
    other = [_ulp_away(t) for t in x1]
    if fault == "just_outside":
        bad, ratio = et.flip_outside_band(x, mask3, packed, own, **kw)
        assert 1.0 < ratio < 1.1
    elif fault == "far":
        flat, _, stash, pres = et._forward_at(x, mask3, packed, None, kw)
        bad = [m.clone() for m in own]
        bad[-1].view(-1)[pres[-1].float().argmax()] = False
    elif fault == "unexplained":
        j = _last_block_window(x, mask3, packed, kw, other)[-1]
        bad = [m.clone() for m in own]
        bad[-1].view(-1)[j] = ~bad[-1].view(-1)[j]
        et.plain_bwd_at_decisions(x, mask3, packed, gout, bad, other, **kw)
        other = x1  # no difference in the inputs: nothing explains the flip
    else:
        idx = _last_block_window(x, mask3, packed, kw, other)
        limit = et.max_flips(sum(m.numel() for m in own))
        assert len(idx) > limit
        ok = [m.clone() for m in own]
        ok[-1].view(-1)[idx[:limit]] = ~ok[-1].view(-1)[idx[:limit]]
        assert et.plain_bwd_at_decisions(x, mask3, packed, gout, ok, other,
                                         **kw)[2].count == limit
        bad = [m.clone() for m in own]
        bad[-1].view(-1)[idx[:limit + 1]] = ~bad[-1].view(-1)[idx[:limit + 1]]
    with pytest.raises(ValueError, match="differ from the plain forward's"):
        et.plain_bwd_at_decisions(x, mask3, packed, gout, bad, other, **kw)
