"""Port parity for the fused encoder attention (``ops/fused_attention.py``).

On the CPU the wrappers run their plain versions, which transcribe the
Pallas kernels' cast chains.  The JAX side runs ``fused_mha`` with its
Pallas kernels in interpret mode, as tests/test_fused_attention.py does,
forward and backward (its custom VJP), from the same numpy inputs.

Tolerances: fp32 1e-5 (summation order only); bf16 max |diff| / max
|want| < 0.05, the JAX package's own bf16 bound for this kernel (a
probability may round to the neighbouring bf16 value in one framework and
not the other).  Train mode cannot be matched with JAX (its masks come
from the TPU's generator or threefry), so it is held to the explicit-mask
oracle ``reference_mha_masked`` with the port's Philox masks.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iisan_tpu.ops import fused_attention as jfa
from iisan_tpu_torch.ops import fused_attention as fa


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
    assert fa.bwd_resident(197, 2) and fa.bwd_resident(30, 2)
    assert fa.bwd_smem_bytes(197, 2) == 214176      # BwdLayout, bf16
    assert fa.bwd_resident(214, 2) and not fa.bwd_resident(215, 2)
    assert not fa.supported(8, 30, 96, 2)            # head width 48
    assert fa.supported(8, 257, 768, 12)             # keys stream in tiles
    assert fa.supported(8, 197, 768, 12, 4) and fa.bwd_supported(8, 197, 768, 12, 4)
    assert fa.bwd_resident(165, 4) and not fa.bwd_resident(197, 4)  # fp32: tiled
    assert not fa.supported(8, 0, 768, 12) and not fa.supported(70000, 30, 768, 12)
    assert fa.supported(1, 46340, 64, 1) and not fa.supported(1, 46341, 64, 1)


@pytest.mark.parametrize("T", [1, 197, 256, 257, 1024])
def test_kernels_take_any_number_of_keys(T):
    """#5 and #6 take every T, in bf16 and fp32; the backward's resident
    block runs where it fits, its tiled design elsewhere."""
    for itemsize in (2, 4):
        assert fa.supported(704, T, 768, 12, itemsize)
        assert fa.bwd_supported(88, T, 768, 12, itemsize)
        limit = 214 if itemsize == 2 else 165
        assert fa.bwd_resident(T, itemsize) == (T <= limit)
