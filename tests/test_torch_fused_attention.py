"""Port parity for the fused encoder attention (``ops/fused_attention.py``).

On the CPU the wrappers run their plain versions, which transcribe the
Pallas kernels' cast chains.  The JAX side runs ``fused_mha`` with its
Pallas kernels in interpret mode, as tests/test_fused_attention.py does,
forward and backward (its custom VJP), from the same numpy inputs.

Tolerances: fp32 1e-5 (summation order only); bf16 max |diff| / max
|want| < 0.05, the JAX package's own bf16 bound for this kernel (a
probability may round to the neighbouring bf16 value in one framework and
not the other).  On the card fp32 runs every product in three TF32 passes; the emulation
below (``_tf32_attention``) holds that split within 1e-4 of JAX's fp32 and
shows one pass outside it.  Train mode cannot be matched with JAX (its masks come
from the TPU's generator or threefry), so it is held to the explicit-mask
oracle ``reference_mha_masked`` with the port's Philox masks.
"""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iisan_tpu.ops import fused_attention as jfa
from iisan_tpu_torch.ops import fused_attention as fa
from iisan_tpu_torch.ops import philox


@pytest.fixture()
def interpret_pallas():
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        yield


def _inputs(B=4, T=13, D=128, with_bias=True, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, D)).astype(np.float32)
                  for _ in range(4))
    bias = None
    if with_bias:
        bias = np.where(rng.random((B, T)) > 0.3, 0.0, -1e9).astype(np.float32)
        bias[-1] = -1e9  # an all-pad row (the pad item's title)
    return q, k, v, g, bias


def _t(x, dtype=torch.float32):
    return None if x is None else torch.tensor(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dtype)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("D,H", [(128, 2), (32, 2)])
def test_forward_and_backward_match_jax_fp32(interpret_pallas, with_bias, D, H):
    q, k, v, g, bias = _inputs(D=D, with_bias=with_bias)
    jq, jk, jv = _j(q), _j(k), _j(v)

    def jloss(q_, k_, v_):
        out = jfa.fused_mha(q_, k_, v_, n_heads=H, key_bias=_j(bias))
        return jnp.sum(out * _j(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = fa.fused_mha(tq, tk, tv, H, key_bias=_t(bias))
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)
    plain = fa.reference_mha(_t(q), _t(k), _t(v), _t(bias), H, torch.float32)
    np.testing.assert_array_equal(plain.numpy(), out.detach().numpy())
    assert np.isfinite(out.detach().numpy()).all()


def test_forward_and_backward_match_jax_bf16(interpret_pallas):
    q, k, v, g, bias = _inputs(B=3, T=17, D=128)
    bf = jnp.bfloat16

    def jloss(q_, k_, v_):
        out = jfa.fused_mha(q_, k_, v_, n_heads=2, key_bias=_j(bias))
        return jnp.sum(out.astype(jnp.float32) * _j(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(_j(q, bf), _j(k, bf),
                                                         _j(v, bf))
    tq, tk, tv = (_t(x, torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    out = fa.fused_mha(tq, tk, tv, 2, key_bias=_t(bias))
    assert out.dtype == torch.bfloat16
    out.float().backward(_t(g))
    assert _rel(out.detach().float().numpy(),
                np.asarray(jout, np.float32)) < 0.05
    for t, jg in zip((tq, tk, tv), jgrads):
        assert t.grad.dtype == torch.bfloat16
        assert _rel(t.grad.float().numpy(), np.asarray(jg, np.float32)) < 0.05


@pytest.mark.parametrize("with_bias", [False, True])
def test_forward_and_backward_match_jax_fp32_at_257_keys(interpret_pallas,
                                                          with_bias):
    """257 tokens (a 256-pixel ViT): past the first kernels' 256 keys."""
    q, k, v, g, bias = _inputs(B=2, T=257, D=128, with_bias=with_bias, seed=5)

    def jloss(q_, k_, v_):
        out = jfa.fused_mha(q_, k_, v_, n_heads=2, key_bias=_j(bias))
        return jnp.sum(out * _j(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = fa.fused_mha(tq, tk, tv, 2, key_bias=_t(bias))
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


def test_forward_and_backward_match_jax_bf16_at_257_keys(interpret_pallas):
    q, k, v, g, bias = _inputs(B=2, T=257, D=128, seed=6)
    bf = jnp.bfloat16

    def jloss(q_, k_, v_):
        out = jfa.fused_mha(q_, k_, v_, n_heads=2, key_bias=_j(bias))
        return jnp.sum(out.astype(jnp.float32) * _j(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(_j(q, bf), _j(k, bf),
                                                         _j(v, bf))
    tq, tk, tv = (_t(x, torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    out = fa.fused_mha(tq, tk, tv, 2, key_bias=_t(bias))
    out.float().backward(_t(g))
    assert _rel(out.detach().float().numpy(),
                np.asarray(jout, np.float32)) < 0.05
    for t, jg in zip((tq, tk, tv), jgrads):
        assert _rel(t.grad.float().numpy(), np.asarray(jg, np.float32)) < 0.05


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) as the kernels' cvt.rna.tf32.f32
    rounds it: to nearest, ties away from zero, on the bits (half of the 13
    dropped bits added to the magnitude, then the 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _hi_lo(x: torch.Tensor):
    """The kernels' split x = hi + lo: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_tf32(passes: int):
    """a @ b as wgmma's .tf32 path takes it: three passes lo_a hi_b + hi_a
    lo_b + hi_a hi_b (the kernels'), or the one pass hi_a hi_b; each product
    of two TF32 values is exact in fp32, the sums are fp32."""
    def mm(a, b):
        (ah, al), (bh, bl) = _hi_lo(a), _hi_lo(b)
        return ah @ bh if passes == 1 else al @ bh + ah @ bl + ah @ bh
    return mm


def _tf32_attention(q, k, v, bias, g, H, mm):
    """The fp32 kernels' eval-mode forward and backward with each product
    taken by ``mm`` on the operands the kernels split: S = Q . K^T, O = e .
    V / sum (e = exp(s - max), unnormalised, as #5 streams it), gPd = g .
    V^T, gV = p^T . g, gS = p (gPd - sum_j gPd p) / sqrt(dk), gQ = gS . K,
    gK = gS^T . Q.  q, k, v, g (B, T, D) fp32, bias (B, T) or None;
    returns (out, gq, gk, gv)."""
    inv = 1.0 / math.sqrt(q.shape[-1] // H)
    qh, kh, vh, gh = (fa._split(t, H) for t in (q, k, v, g))
    s = mm(qh, kh.transpose(-1, -2)) * inv
    if bias is not None:
        s = s + bias[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    total = e.sum(-1, keepdim=True)
    p = e / total
    g_s = fa._softmax_bwd(p, mm(gh, vh.transpose(-1, -2))) * inv
    return tuple(fa._merge(t, torch.float32) for t in (
        mm(e, vh) / total, mm(g_s, kh), mm(g_s.transpose(-1, -2), qh),
        mm(p.transpose(-1, -2), gh)))


def test_tf32_split_rounds_as_cvt_rna():
    """The emulation's TF32 rounding is cvt.rna's (ties away from zero, in
    both signs), and hi + lo holds x to 2^-21 of its size."""
    u = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 2 - 2.0 ** -23, 1 + 1.5 * u,
                      -(1 + 1.5 * u), 3.0, 0.0])
    want = torch.tensor([1 + u, -(1 + u), 1.0, 1 + 2 * u, -(1 + 2 * u), 3.0, 0.0])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    hi, lo = _hi_lo(r)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (r.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * r.double().abs()).all())
    assert bool(((r - hi).abs() > 2.0 ** -14 * r.abs()).any())  # one pass drops bits


# The fp32 JAX parity inputs above: 13 keys at two widths, with and without
# the key bias, and 257 keys.
_TF32_CASES = {"13 keys D=128": dict(D=128, with_bias=False),
               "13 keys D=128 bias": dict(D=128),
               "13 keys D=32": dict(D=32, with_bias=False),
               "13 keys D=32 bias": dict(D=32),
               "257 keys": dict(B=2, T=257, D=128, with_bias=False, seed=5),
               "257 keys bias": dict(B=2, T=257, D=128, seed=5)}


@pytest.mark.parametrize("case", list(_TF32_CASES))
def test_three_pass_tf32_keeps_jax_fp32_and_one_pass_does_not(interpret_pallas, case):
    """The fp32 kernels' arithmetic (``_tf32_attention`` with three TF32
    passes) against JAX's fp32 ``fused_mha`` (Pallas in interpret mode):
    forward and gradients within 1e-4 (max |diff| / max |JAX|); one pass,
    on the same inputs, outside 1e-4 in every tensor."""
    q, k, v, g, bias = _inputs(**_TF32_CASES[case])

    def jloss(q_, k_, v_):
        out = jfa.fused_mha(q_, k_, v_, n_heads=2, key_bias=_j(bias))
        return jnp.sum(out * _j(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(_j(q), _j(k), _j(v))
    want = [np.asarray(x, np.float32) for x in (jout, *jgrads)]
    args = (_t(q), _t(k), _t(v), _t(bias), _t(g), 2)
    three = [_rel(t.numpy(), w) for t, w in zip(_tf32_attention(*args, _mm_tf32(3)), want)]
    one = [_rel(t.numpy(), w) for t, w in zip(_tf32_attention(*args, _mm_tf32(1)), want)]
    assert max(three) < 1e-4, three
    assert min(one) > 1e-4, one


def test_hand_backward_is_the_autograd_of_the_forward():
    """mha_bwd_plain against autograd of reference_mha, fp32."""
    q, k, v, g, bias = _inputs(B=3, T=11, D=128, seed=4)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    fa.reference_mha(tq, tk, tv, _t(bias), 2, torch.float32).backward(_t(g))
    got = fa.mha_bwd_plain(_t(q), _t(k), _t(v), _t(bias), _t(g), n_heads=2)
    for a, t in zip(got, (tq, tk, tv)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_dropout_masks_keep_rate_and_addressing():
    B, T, H, rate = 3, 30, 4, 0.1
    m = fa.attention_dropout_masks(7, B, T, H, rate, layer=2)
    assert m.shape == (B, H, T, T) and m.dtype == torch.float32
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    assert set(torch.unique(m).tolist()) <= {0.0, float(scale)}
    assert abs(float((m > 0).float().mean()) - (1 - rate)) < 0.05
    assert torch.equal(m, fa.attention_dropout_masks(7, B, T, H, rate, 2))
    assert torch.equal(m, fa.mha_mask_replay(7, B, T, H, rate, 2, "cpu"))
    others = [fa.attention_dropout_masks(8, B, T, H, rate, 2),
              fa.attention_dropout_masks(7, B, T, H, rate, 3)]
    for other in others:
        assert float((other != m).float().mean()) > 0.1
    # heads of one layer, and the image rows, draw distinct masks
    assert not torch.equal(m[:, 0], m[:, 1]) and not torch.equal(m[0], m[1])
    # a row's masks do not depend on how many images the call holds
    assert torch.equal(m[:2], fa.attention_dropout_masks(7, 2, T, H, rate, 2))


@pytest.mark.parametrize("T", [3, 197])
def test_dropout_masks_are_philox_lanes_of_four_element_counters(T):
    """Element (b, h, i, j) is lane (i*T + j) % 4 of Philox at counter
    (i*T + j) // 4, site layer*H + h, row b: the addressing the replay
    kernel computes once per four elements."""
    seed, B, H, rate, layer = 31, 2, 3, 0.1, 4
    masks = fa.attention_dropout_masks(seed, B, T, H, rate, layer)
    e = torch.arange(T * T, dtype=torch.int64)
    scale = np.float32(1.0 / (1.0 - rate))
    for b in range(B):
        for h in range(H):
            words = torch.stack(philox.philox4x32_10(
                e // 4, torch.full_like(e, layer * H + h), torch.full_like(e, b),
                torch.zeros_like(e), seed, 0))
            bits = words[e % 4, e].numpy()
            u = (bits >> 8).astype(np.float64) / 2.0 ** 24
            want = np.where(u >= np.float32(rate), scale, np.float32(0))
            np.testing.assert_array_equal(masks[b, h].reshape(-1).numpy(), want)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1 / 3, 2.0 ** -24, 0.75 + 2.0 ** -24,
                                  1 - 2.0 ** -24])
def test_keep_threshold_is_the_float_keep_test(rate):
    """``bits >= keep_threshold(rate)`` (the kernel's integer test) keeps
    exactly the words the fp32 test (bits >> 8) / 2^24 >= rate keeps,
    random words and the words around the threshold alike."""
    t = philox.keep_threshold(rate)
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, t - 257, t - 256, t - 1, t, t + 1, t + 255, t + 256,
                     2 ** 32 - 1], dtype=np.int64)
    bits = torch.from_numpy(np.concatenate([
        rng.integers(0, 2 ** 32, 100_000, dtype=np.int64), edge.clip(0, 2 ** 32 - 1)]))
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    assert torch.equal(bits >= t, u >= torch.tensor(rate, dtype=torch.float32))


_REPLAY_ARGS = dict(seed=7, B=2, T=5, H=3, rate=0.1, layer=2)


@pytest.mark.parametrize("bad", [dict(rate=-0.1), dict(rate=1.0), dict(rate=1 - 1e-10),
                                 dict(seed=-1), dict(seed=2 ** 31), dict(layer=-1),
                                 dict(layer=2 ** 30, H=4), dict(B=0), dict(T=0),
                                 dict(T=46341), dict(H=0)],
                         ids=lambda bad: ",".join(f"{k}={v}" for k, v in bad.items()))
def test_mask_replay_routes_reject_the_same_inputs(bad):
    """Both routes of ``mha_mask_replay`` check their inputs before the
    device branch (the CUDA route raises before it needs a card)."""
    args = {**_REPLAY_ARGS, **bad}
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="mha_mask_replay takes"):
            fa.mha_mask_replay(args["seed"], args["B"], args["T"], args["H"],
                               args["rate"], args["layer"], device)
    B, T, H = _REPLAY_ARGS["B"], _REPLAY_ARGS["T"], _REPLAY_ARGS["H"]
    assert fa.mha_mask_replay(**_REPLAY_ARGS, device="cpu").shape == (B, H, T, T)


def test_mask_replay_writes_only_its_view():
    seed, B, T, H, rate, layer = 3, 2, 7, 3, 0.25, 1
    n = B * H * T * T
    buf = torch.full((n + 9,), -7.0)
    got = fa.mha_mask_replay(seed, B, T, H, rate, layer, "cpu",
                             out=buf[5:5 + n].view(B, H, T, T))
    assert got.data_ptr() == buf[5:].data_ptr()
    assert torch.equal(got, fa.attention_dropout_masks(seed, B, T, H, rate, layer))
    assert bool((buf[:5] == -7).all()) and bool((buf[5 + n:] == -7).all())
    with pytest.raises(ValueError, match="out must be"):
        fa.mha_mask_replay(seed, B, T, H, rate, layer, "cpu", out=buf[:n].view(B, T, H, T))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_mode_is_the_explicit_mask_oracle(dtype):
    q, k, v, g, bias = _inputs(B=3, T=30, D=128, seed=2)
    seed, rate, layer, H = 11, 0.1, 5, 2
    masks = fa.attention_dropout_masks(seed, 3, 30, H, rate, layer)
    tq, tk, tv = (_t(x, dtype).requires_grad_(True) for x in (q, k, v))
    out = fa.fused_mha(tq, tk, tv, H, key_bias=_t(bias), drop_rate=rate,
                       seed=seed, layer=layer)
    want = fa.reference_mha_masked(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                   _t(bias), H, dtype, masks)
    assert torch.equal(out, want)
    assert not torch.equal(out, fa.fused_mha(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), H, key_bias=_t(bias)))
    out.float().backward(_t(g))
    oq, ok, ov = (_t(x, dtype).requires_grad_(True) for x in (q, k, v))
    fa.reference_mha_masked(oq, ok, ov, _t(bias), H, dtype,
                            masks).float().backward(_t(g))
    tol = 1e-5 if dtype == torch.float32 else 0.05
    for a, b in zip((tq, tk, tv), (oq, ok, ov)):
        assert _rel(a.grad.float().numpy(), b.grad.float().numpy()) < tol


def test_all_pad_rows_are_uniform_and_finite():
    q, k, v, _, _ = _inputs(B=2, T=9, D=128, with_bias=False, seed=3)
    bias = np.full((2, 9), -1e9, np.float32)
    out = fa.fused_mha(_t(q), _t(k), _t(v), 2, key_bias=_t(bias))
    uniform = _t(v).reshape(2, 9, 2, 64).mean(1, keepdim=True).expand(
        2, 9, 2, 64).reshape(2, 9, 128)
    np.testing.assert_allclose(out.numpy(), uniform.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_kernel_geometry():
    assert fa.supported(704, 197, 768, 12) and fa.bwd_supported(704, 197, 768, 12)
    assert fa.supported(704, 30, 768, 12) and fa.bwd_supported(704, 30, 768, 12)
    # bf16 runs the cluster design up to 512 keys (clusters of one to eight
    # blocks of 64) and the split design (a query-tile and a key-tile kernel
    # on wgmma) beyond, fp32 the query-tile and key-tile pair in three TF32
    # passes on wgmma
    assert fa.CLUSTER_KEYS == 512
    assert fa.bwd_design(197, 2) == fa.bwd_design(30, 2) == "wgmma_cluster"
    assert fa.bwd_design(320, 2) == fa.bwd_design(321, 2) == "wgmma_cluster"
    assert fa.bwd_design(325, 2) == fa.bwd_design(512, 2) == "wgmma_cluster"
    assert fa.bwd_design(513, 2) == "wgmma_split"
    assert [fa.cluster_blocks(T) for T in (1, 64, 65, 320, 321, 448, 449, 512)] == \
        [1, 1, 2, 5, 6, 7, 8, 8]
    assert fa.bwd_design(197, 4) == fa.bwd_design(30, 4) == "wgmma_tf32"
    assert fa.BWD_DESIGNS == ("wgmma_tf32", "wgmma_cluster", "wgmma_split")
    assert not fa.supported(8, 30, 96, 2)            # head width 48
    assert fa.supported(8, 257, 768, 12)             # keys stream in tiles
    assert fa.supported(8, 197, 768, 12, 4) and fa.bwd_supported(8, 197, 768, 12, 4)
    assert not fa.bwd_supported(8, 30, 96, 2, 4)     # fp32 takes the same heads
    assert not fa.supported(8, 0, 768, 12) and not fa.supported(70000, 30, 768, 12)
    assert fa.supported(1, 46340, 64, 1) and not fa.supported(1, 46341, 64, 1)


@pytest.mark.parametrize("T", [1, 197, 256, 257, 325, 512, 513, 1024, 46340])
def test_kernels_take_any_number_of_keys(T):
    """#5 and #6 take every T, in bf16 and fp32; the backward's design
    depends on the dtype and, in bf16, on whether a cluster holds the keys
    (up to 512)."""
    for itemsize in (2, 4):
        assert fa.supported(704, T, 768, 12, itemsize)
        assert fa.bwd_supported(88, T, 768, 12, itemsize)
        want = ("wgmma_tf32" if itemsize == 4 else
                "wgmma_cluster" if T <= 512 else "wgmma_split")
        assert fa.bwd_design(T, itemsize) == want


@pytest.mark.parametrize("T,with_bias", [(30, True), (64, False), (65, True),
                                         (197, False)]
                         + [(T, b) for T in (513, 577, 640) for b in (False, True)])
def test_backward_matches_jax_bf16_at_tile_edges(interpret_pallas, T, with_bias):
    """bf16 at the backward's tile edges (64-row query tiles, 64-key tiles):
    BERT's 30 tokens with a padded key bias and an all-pad row, one whole
    key tile, one key past it, ViT's 197, and past the cluster design's 512
    keys, where the split design runs on the card: one key past it, ViT's
    577 tokens at 384 pixels and ten whole tiles, at D = 128, where the JAX
    kernel itself takes these keys (``_pick_batch_block`` 2, 2 and 1 at B =
    2; it stops at 903).  The JAX kernels' gradients and the port's (its
    plain backward on the CPU) agree within the bf16 bound; the card's
    tests hold the kernels to this plain version."""
    assert jfa._pick_batch_block(2, T, 128, 2) > 0  # the Pallas kernel runs
    q, k, v, g, bias = _inputs(B=2, T=T, D=128, with_bias=with_bias, seed=7)
    bf = jnp.bfloat16

    def jloss(q_, k_, v_):
        out = jfa.fused_mha(q_, k_, v_, n_heads=2, key_bias=_j(bias))
        return jnp.sum(out.astype(jnp.float32) * _j(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(_j(q, bf), _j(k, bf),
                                                         _j(v, bf))
    tq, tk, tv = (_t(x, torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    out = fa.fused_mha(tq, tk, tv, 2, key_bias=_t(bias))
    out.float().backward(_t(g))
    assert _rel(out.detach().float().numpy(),
                np.asarray(jout, np.float32)) < 0.05
    for t, jg in zip((tq, tk, tv), jgrads):
        got = t.grad.float().numpy()
        assert np.isfinite(got).all()
        assert _rel(got, np.asarray(jg, np.float32)) < 0.05


def _cluster_bwd(q, k, v, bias, g, *, n_heads, seed=0, rate=0.0, layer=0):
    """The bf16 backward's cluster design (csrc/mha_bwd.cu, up to 512
    keys, one to eight blocks) in plain PyTorch: each block of the cluster
    holds 64 keys, and
    the rows' max, sum of exp(s - max) and term sum_j gP p are combined
    from the blocks' partials in rank order 0, 1, ..., as are the blocks'
    partial products gS . K_r of gQ; every other step is
    ``mha_bwd_plain``'s cast chain."""
    dt = q.dtype
    B, T, D = q.shape
    H = n_heads
    inv = 1.0 / np.sqrt(D // H)
    qh, kh, vh, gh = (fa._split(t, H) for t in (q, k, v, g))
    s = (qh @ kh.transpose(-1, -2)) * inv
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    ranks = [slice(j0, min(j0 + 64, T)) for j0 in range(0, T, 64)]
    mx = s[..., ranks[0]].amax(-1, keepdim=True)
    for r in ranks[1:]:
        mx = torch.maximum(mx, s[..., r].amax(-1, keepdim=True))
    e = torch.exp(s - mx)
    total = sum(e[..., r].sum(-1, keepdim=True) for r in ranks)
    p = e / total
    masks = fa._masks(seed, rate, layer, B, T, H, q.device)
    pd = p.to(dt).float()
    g_p = gh @ vh.transpose(-1, -2)
    if masks is not None:
        pd = (pd * masks).to(dt).float()
        g_p = g_p * masks
    term = sum((g_p * p)[..., r].sum(-1, keepdim=True) for r in ranks)
    g_s = (p * (g_p - term) * inv).to(dt).float()
    g_q = sum(g_s[..., r] @ kh[..., r, :] for r in ranks)
    g_k = g_s.transpose(-1, -2) @ qh
    g_v = pd.transpose(-1, -2) @ gh
    return fa._merge(g_q, dt), fa._merge(g_k, dt), fa._merge(g_v, dt)


def _hashed_keep(b, h, i, j, T, H, rate, xp):
    """A scaled keep mask from an integer hash of (image, head, query,
    key) in uint32 arithmetic, the same in numpy and in jax.numpy: the
    masks both frameworks take in train mode below."""
    x = ((b * H + h) * T + i) * T + j
    x = x * xp.uint32(2654435761)
    x = x ^ (x >> xp.uint32(15))
    x = x * xp.uint32(2246822519)
    x = x ^ (x >> xp.uint32(13))
    keep = (x >> xp.uint32(8)) >= xp.uint32(int(np.ceil(rate * 2 ** 24)))
    return keep.astype(xp.float32) * xp.float32(1.0 / (1.0 - rate))


def _three_backwards(model, B, T, dtype, rate):
    """(``model``'s, ``mha_bwd_plain``'s, JAX's) gradients at B images of T
    tokens, D = 128, 2 heads, the padded key bias, from one set of numpy
    inputs: JAX's ``fused_mha`` VJP runs ``_mha_bwd_kernel`` (interpret
    mode).  In train mode the three take one set of masks: the JAX kernels'
    per-head mask draw and the port's ``_masks`` are both patched, in the
    calling test only, to ``_hashed_keep`` (a Pallas kernel takes no
    captured array, so the port's Philox masks cannot be handed in).  Each
    JAX kernel draws H masks of (B / grid, T, T) in head order as it is
    traced, its images offset by the grid program's index."""
    D, H, seed, layer = 128, 2, 19, 4
    bb = jfa._pick_batch_block(B, T, D, 4 if dtype == torch.float32 else 2)
    assert bb > 0  # the Pallas kernel runs, not the XLA path
    q, k, v, g, bias = _inputs(B=B, T=T, D=D, seed=T)
    tq, tk, tv, tg = (_t(x, dtype) for x in (q, k, v, g))
    kw = dict(n_heads=H, seed=seed, rate=rate, layer=layer)
    idx = np.ix_(np.arange(B, dtype=np.uint32), np.arange(H, dtype=np.uint32),
                 np.arange(T, dtype=np.uint32), np.arange(T, dtype=np.uint32))
    masks = torch.from_numpy(_hashed_keep(*idx, T, H, rate, np)) if rate else None
    draws = iter(range(10 ** 6))

    def jax_mask(shape, rate_):
        assert shape == (bb, T, T) and rate_ == rate
        b, i, j = (jax.lax.broadcasted_iota(jnp.uint32, shape, d) for d in range(3))
        b = b + pl.program_id(0).astype(jnp.uint32) * jnp.uint32(bb)
        return _hashed_keep(b, jnp.uint32(next(draws) % H), i, j, T, H, rate, jnp)

    def jloss(q_, k_, v_):
        out = jfa.fused_mha(q_, k_, v_, n_heads=H, key_bias=_j(bias), drop_rate=rate,
                            dropout_rng=jax.random.PRNGKey(0) if rate else None)
        return jnp.sum(out.astype(jnp.float32) * _j(g)), out

    from iisan_tpu.ops import fused_user_encoder as jfue

    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with mock.patch.object(fa, "_masks", lambda *a: masks), \
            mock.patch.object(jfue, "_dropout_mask", jax_mask), \
            mock.patch.object(jfa.pltpu, "prng_seed", lambda *a: None):
        mine = model(tq, tk, tv, _t(bias), tg, **kw)
        plain = fa.mha_bwd_plain(tq, tk, tv, _t(bias), tg, **kw)
        _, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            _j(q, jd), _j(k, jd), _j(v, jd))
    return mine, plain, jgrads


def _assert_three_agree(mine, plain, jgrads, dtype):
    """fp32 1e-5 (summation order only); bf16 max |diff| / max |want| <
    0.05, the file's bf16 bound (a probability may round to the
    neighbouring bf16 value on one side)."""
    for got, want, jg in zip(mine, plain, jgrads):
        got, want, jg = (np.asarray(x, np.float32) for x in
                         (got.float().numpy(), want.float().numpy(), jg))
        assert np.isfinite(got).all()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, jg, rtol=1e-5, atol=1e-5)
        else:
            assert _rel(got, want) < 0.05 and _rel(got, jg) < 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", [197, 257, 325, 512])
def test_cluster_rank_order_combine_matches_plain_and_jax(interpret_pallas, dtype, rate,
                                                          T):
    """The cluster design's combine (4, 5, 6 and 8 blocks of 64 keys at
    ViT's 197, 257 and 325 tokens and at 512, the most keys the JAX kernel
    takes at ViT width) against ``mha_bwd_plain`` and against the JAX
    ``_mha_bwd_kernel`` (interpret mode, through ``fused_mha``'s VJP), in
    eval and train mode (``_three_backwards``'s shared masks), within
    ``_assert_three_agree``'s bounds."""
    assert jfa._pick_batch_block(2, T, 128, 2) == 2  # one grid program
    _assert_three_agree(*_three_backwards(_cluster_bwd, 2, T, dtype, rate),
                        dtype)


def _split_bwd(q, k, v, bias, g, *, n_heads, seed=0, rate=0.0, layer=0):
    """The bf16 backward's split design (csrc/mha_bwd.cu, past 512 keys) in
    plain PyTorch: the query-tile kernel forms each row's max, sum of exp(s
    - max) and term sum_j gP e over 64-key tiles in order, both sums
    rescaled by exp(old max - new max) as the max grows, and the term
    divided by the sum at the end; gQ sums gS . K over the key tiles in
    order; the key-tile kernel takes p = exp(s - max) / sum from those
    statistics.  Every other step is ``mha_bwd_plain``'s cast chain."""
    dt = q.dtype
    B, T, D = q.shape
    H = n_heads
    inv = 1.0 / np.sqrt(D // H)
    qh, kh, vh, gh = (fa._split(t, H) for t in (q, k, v, g))
    s = (qh @ kh.transpose(-1, -2)) * inv
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    masks = fa._masks(seed, rate, layer, B, T, H, q.device)
    g_p = gh @ vh.transpose(-1, -2)
    if masks is not None:
        g_p = g_p * masks
    tiles = [slice(j0, min(j0 + 64, T)) for j0 in range(0, T, 64)]
    mx = torch.full(s.shape[:-1] + (1,), -torch.finfo(torch.float32).max)
    total, term = torch.zeros_like(mx), torch.zeros_like(mx)
    for r in tiles:
        new = torch.maximum(mx, s[..., r].amax(-1, keepdim=True))
        corr = torch.exp(mx - new)
        e = torch.exp(s[..., r] - new)
        mx, total = new, total * corr + e.sum(-1, keepdim=True)
        term = term * corr + (g_p[..., r] * e).sum(-1, keepdim=True)
    term = term / total
    p = torch.exp(s - mx) / total
    pd = p.to(dt).float()
    if masks is not None:
        pd = (pd * masks).to(dt).float()
    g_s = (p * (g_p - term) * inv).to(dt).float()
    g_q = sum(g_s[..., r] @ kh[..., r, :] for r in tiles)
    g_k = g_s.transpose(-1, -2) @ qh
    g_v = pd.transpose(-1, -2) @ gh
    return fa._merge(g_q, dt), fa._merge(g_k, dt), fa._merge(g_v, dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T", [577, 640])
def test_split_order_of_sums_matches_plain_and_jax(interpret_pallas, dtype, rate, T):
    """The split design's order of sums (``_split_bwd``: the rows'
    statistics over ten 64-key tiles in order with the online rescale)
    against ``mha_bwd_plain`` and the JAX ``_mha_bwd_kernel`` (interpret
    mode; two grid programs at 640 keys in bf16 and at both in fp32), in
    eval and train mode (``_three_backwards``'s shared masks), within
    ``_assert_three_agree``'s bounds."""
    _assert_three_agree(*_three_backwards(_split_bwd, 2, T, dtype, rate),
                        dtype)
