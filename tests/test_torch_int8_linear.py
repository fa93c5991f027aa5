"""Port parity for the W8A8 linear (``ops/int8_linear.py``,
``ops/fused_w8a8.py``) and the weight bridge's int8 leaves.

Inputs come from numpy seeds and go through the JAX function and the
port's counterpart.  ``quantize_kernel`` and ``quantize_dense_tree`` are
bit-equal to JAX's.  ``int8_matmul`` (the port's plain version of kernel
#10, which ``fused_w8a8_matmul`` runs on a CPU tensor) against JAX's
``int8_matmul`` and against JAX's ``fused_w8a8_matmul`` in interpret
mode: relative Frobenius error below 1e-3, the bound of the JAX package's
own test (a division that differs by one ulp flips ``rint`` on an exact
.5, moving one output by at most one quantum); zero rows give exact zeros.
The gradient of the port's W8A8 autograd in x, kscale and bias matches
``jax.grad`` of JAX's ``int8_matmul`` (rtol 1e-4, the JAX test's, with an
atol of 1e-5 of the tensor's largest |value|: kscale's cotangent is an
fp32 sum over 300 rows of terms in the thousands, taken in another order
by each framework).  ``Int8Dense`` loaded through the bridge from JAX's
``quantize_dense_tree`` output reproduces JAX's ``Int8Dense.apply``; a
quantised tower tree makes the round trip JAX -> port -> JAX unchanged,
int8 dtypes included.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iisan_tpu.models.vit import ViTEncoder as JaxViT
from iisan_tpu.ops import int8_linear as jil
from iisan_tpu.ops.int8_pallas import fused_w8a8_matmul as jax_fused_w8a8
from iisan_tpu_torch.models.vit import ViTEncoder
from iisan_tpu_torch.ops import fused_w8a8 as fw
from iisan_tpu_torch.ops import int8_linear as til
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-9)


def _case(M, K, N, with_bias, seed=0, lead=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    x[M // 2] = 0.0  # a zero row
    if lead is not None:
        x = x.reshape(*lead, K)
    q, s = jil.quantize_kernel(rng.standard_normal((K, N)).astype(np.float32) * 0.05)
    b = rng.standard_normal(N).astype(np.float32) if with_bias else None
    return x, q, s, b


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def test_quantize_kernel_is_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 40)).astype(np.float32) * 0.07
    w[:, 3] = 0.0                      # a zero column: scale 0, values 0
    w[5, 7] = 0.5 * (w[:, 7].max() / 127.0) * 127.0  # near a tie
    q, s = til.quantize_kernel(w)
    jq, js = jil.quantize_kernel(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert not q[:, 3].any() and s[3] == 0.0


@pytest.fixture()
def interpret_pallas():
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        yield


@pytest.mark.parametrize("M,K,N,with_bias,lead", [
    (300, 256, 384, True, None),
    (512, 128, 128, False, None),
    (7, 256, 256, True, None),
    (300, 256, 128, False, (4, 75)),   # 3-D input
    (64, 4096, 1024, True, None),      # BERT-large's FFN output layer
    (64, 1024, 4096, True, None),      # and its FFN input layer
])
def test_int8_matmul_matches_jax(interpret_pallas, M, K, N, with_bias, lead):
    x, q, s, b = _case(M, K, N, with_bias, lead=lead)
    got = til.int8_matmul(_t(x), _t(q), _t(s), _t(b), torch.float32).numpy()
    via_op = fw.fused_w8a8_matmul(_t(x), _t(q), _t(s), _t(b), torch.float32)
    assert torch.equal(via_op, torch.from_numpy(got))  # the CPU path is the plain one
    want = np.asarray(jil.int8_matmul(jnp.asarray(x), q, s, b, jnp.float32))
    pallas = np.asarray(jax_fused_w8a8(jnp.asarray(x), jnp.asarray(q),
                                       jnp.asarray(s),
                                       None if b is None else jnp.asarray(b),
                                       jnp.float32, interpret=True))
    assert got.shape == want.shape == (*(lead or (M,)), N)
    assert _rel(got, want) < 1e-3
    assert _rel(got, pallas) < 1e-3
    zero = got.reshape(-1, N)[M // 2]
    np.testing.assert_array_equal(zero, b if with_bias else np.zeros(N, np.float32))


def test_w8a8_geometry_takes_bert_large():
    """#10 takes every K from 1 to K_MAX and every N: each pair JAX's Pallas
    kernel takes, BERT-large's widths, K past the earlier 6,272 limit, and
    ViT-tiny's D = 192 layers; the GEMM's ring fits shared memory."""
    from iisan_tpu.ops import int8_pallas

    jax_pairs = [(K, N) for K in range(128, 8193, 128) for N in range(128, 8193, 128)
                 if int8_pallas.supported(K, N)]
    assert (768, 3072) in jax_pairs and (4096, 1024) in jax_pairs
    for K, N in jax_pairs + [(6336, 128), (8192, 1024), (8192, 8192), (192, 192),
                             (192, 768), (768, 192), (1, 1), (77, 37), (fw.K_MAX, 1)]:
        assert fw.supported(K, N), (K, N)
    assert not fw.supported(fw.K_MAX + 1, 128) and not fw.supported(0, 128)
    assert not fw.supported(768, 0)
    # int32 sums stay exact: K_MAX 127^2 < 2^31 <= (K_MAX + 16) 127^2
    assert fw.K_MAX * 127 ** 2 < 2 ** 31 <= (fw.K_MAX + fw.K_ALIGN) * 127 ** 2
    assert [fw.padded_k(k) for k in (1, 16, 17, 100, 192, 200, 768)] == \
        [16, 16, 32, 112, 192, 208, 768]
    assert fw.smem_bytes() == 3 * 48 * 1024 + 64 * 1024 + 48 + 1024 <= 227 * 1024
    assert fw.out_stride(100, torch.bfloat16) == 104
    assert fw.out_stride(100, torch.float32) == 100


@pytest.mark.parametrize("K", [100, 192, 200])
def test_w8a8_padding_is_exact(K):
    """Zero columns past K in xq and in the transposed weight (K_p = K
    rounded up to 16) leave the product bit-equal to ``int8_matmul``; the
    wrappers run these plain versions on CPU tensors."""
    x, q, s, b = _case(150, K, 96, True, seed=7)
    xt, qt = _t(x), _t(q)
    xq, sx = fw.w8a8_quant_rows(xt)
    assert xq.dtype == torch.int8 and xq.shape == (150, fw.padded_k(K))
    assert not xq[:, K:].any() and sx.shape == (150,)
    wt = fw.transposed_weight(qt)
    assert wt.shape == (96, fw.padded_k(K)) and not wt[:, K:].any()
    assert torch.equal(wt[:, :K], qt.t())
    for dt in (torch.float32, torch.bfloat16):
        want = til.int8_matmul(xt, qt, _t(s), _t(b), dt)
        got = fw.w8a8_gemm(xq, sx, wt, _t(s), _t(b), dt)
        assert torch.equal(got, want)
        assert torch.equal(got, fw.fused_w8a8_matmul(xt, qt, _t(s), _t(b), dt))
    assert torch.equal(fw.w8a8_gemm(xq, sx, wt, _t(s), None, torch.float32),
                       til.int8_matmul(xt, qt, _t(s), None, torch.float32))
    dense = til.Int8Dense(K, 96)
    load_jax_params(dense, {"kernel_q": q, "kscale": s, "bias": b})
    assert torch.equal(dense.transposed_kernel(), wt)


@pytest.mark.parametrize("K,N", [(192, 192), (192, 768), (768, 192)])
def test_int8_matmul_matches_jax_at_d192(K, N):
    """ViT-tiny's tower layers (D = 192: q, k, v, output (192, 192), FFN
    (192, 768) and (768, 192)), which JAX's XLA int8 path answers."""
    x, q, s, b = _case(197 * 2, K, N, True, seed=8)
    got = til.int8_matmul(_t(x), _t(q), _t(s), _t(b), torch.float32).numpy()
    want = np.asarray(jil.int8_matmul(jnp.asarray(x), q, s, b, jnp.float32))
    assert got.shape == want.shape == (197 * 2, N)
    assert _rel(got, want) < 1e-3
    assert torch.equal(fw.fused_w8a8_matmul(_t(x), _t(q), _t(s), _t(b), torch.float32),
                       torch.from_numpy(got))


def test_int8_matmul_bf16_output_matches_jax():
    x, q, s, b = _case(64, 256, 128, True, seed=2)
    got = til.int8_matmul(_t(x).bfloat16(), _t(q), _t(s), _t(b), torch.bfloat16)
    want = jil.int8_matmul(jnp.asarray(x, jnp.bfloat16), q, s, b, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2


def test_w8a8_gradient_matches_jax():
    x, q, s, b = _case(300, 256, 128, True, seed=3, lead=(4, 75))
    leaves = [_t(a).clone().requires_grad_(True) for a in (x, s, b)]
    fw.fused_w8a8_matmul(leaves[0], _t(q), leaves[1], leaves[2],
                         torch.float32).sum().backward()
    want = jax.grad(lambda xx, ss, bb: jil.int8_matmul(
        xx, q, ss, bb, jnp.float32).sum(), argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    assert float(jnp.abs(want[1]).max()) > 0  # kscale's cotangent is live
    for got, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-6 + 1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_from_jax_tree_matches_jax_apply(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 9, 128)) * 0.5).astype(np.float32)
    float_tree = {"kernel": rng.standard_normal((128, 256)).astype(np.float32) * 0.1,
                  "bias": rng.standard_normal(256).astype(np.float32)}
    tree = jil.quantize_dense_tree(float_tree)
    want = jil.Int8Dense(256, dtype=jdt).apply({"params": tree},
                                               jnp.asarray(x, jdt))
    dense = til.Int8Dense(128, 256, tdt)
    load_jax_params(dense, tree)
    got = dense(torch.tensor(x).to(tdt)).detach()
    assert got.dtype == tdt
    assert dense.kernel_q.dtype == torch.int8
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < (
        1e-3 if dtype == "float32" else 1e-2)


def test_quantize_dense_tree_and_factory_follow_jax():
    rng = np.random.default_rng(5)
    tree = {"layer": {"dense": {"kernel": rng.standard_normal((8, 4)).astype(np.float32),
                                "bias": rng.standard_normal(4).astype(np.float32)},
                      "ln": {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}},
            "nobias": {"kernel": rng.standard_normal((4, 4)).astype(np.float32)},
            "table": rng.standard_normal((5, 4)).astype(np.float32)}
    got = flatten_tree(til.quantize_dense_tree(tree))
    want = flatten_tree(jax.device_get(jil.quantize_dense_tree(tree)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert isinstance(til.dense_or_int8(8, 4, None, "int8"), til.Int8Dense)
    assert not isinstance(til.dense_or_int8(8, 4, None, "none"), til.Int8Dense)
    with pytest.raises(ValueError, match="int8_pallas"):
        til.dense_or_int8(8, 4, None, "int8_pallas")


def test_fresh_int8_dense_matches_the_jax_init_distribution():
    dense = til.Int8Dense(768, 3072, generator=torch.Generator().manual_seed(0))
    q = dense.kernel_q
    assert q.dtype == torch.int8 and tuple(q.shape) == (768, 3072)
    assert int(q.min()) == -127 and int(q.max()) == 127
    # lecun-normal variance: std(q * kscale) = 1 / sqrt(in)
    std = float((q.float() * dense.kscale.detach()).std())
    assert abs(std * np.sqrt(768) - 1.0) < 0.01
    assert not dense.bias.detach().any()


def test_bridge_round_trips_a_quantised_tower_tree():
    images = np.random.default_rng(6).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    kw = dict(image_size=32, hidden_dim=128, num_layers=2, num_heads=2,
              intermediate_dim=512)
    jm = JaxViT(dtype=jnp.float32, collect="cls", quant="int8", **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), images)["params"])
    assert params["patch_projection"]["kernel_q"].dtype == np.int8
    tm = ViTEncoder(dtype=torch.float32, collect="cls", quant="int8", **kw)
    load_jax_params(tm, params)
    back = flatten_tree(export_jax_params(tm))
    want = flatten_tree(params)
    assert back.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert back[k].dtype == w.dtype, k
        np.testing.assert_array_equal(back[k], w)
    n_int8 = sum(np.asarray(v).dtype == np.int8 for v in want.values())
    assert n_int8 == 1 + 2 * 6  # the patch projection and six per layer
    # the strict check counts int8 leaves: one missing, or one in float
    short = dict(params)
    short["patch_projection"] = {k: v for k, v in params["patch_projection"].items()
                                 if k != "kernel_q"}
    with pytest.raises(KeyError, match="kernel_q"):
        load_jax_params(tm, short)
    as_float = dict(params)
    as_float["patch_projection"] = dict(params["patch_projection"],
                                        kernel_q=np.zeros((768, 128), np.float32))
    with pytest.raises(TypeError, match="int8"):
        load_jax_params(tm, as_float)
    # the towers' output through the bridge is JAX's
    want_last, want_hid = jm.apply({"params": params}, images)
    last, hid = tm(torch.tensor(images))
    assert _rel(hid.detach().numpy(), np.asarray(want_hid)) < 1e-3
