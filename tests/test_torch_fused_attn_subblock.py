"""Port parity for the attention subblocks (``ops/fused_attn_subblock.py``).

The port's plain versions, which its ops run on a CPU tensor, against the
JAX package's ``fused_attn_subblock`` / ``fused_attn_subblock_v2`` run as
its own tests run them on the CPU (Pallas in interpret mode), on inputs
made with numpy: fp32 within 1e-5 (#8) and 1e-4 (#9, whose output sums
over head groups in another order), with and without a key bias.  A bf16
case with biases that are no bf16 numbers shows that each port function
tracks its own JAX function's cast chain: #9 rounds the biases to bf16
first, #8 does not, and the two JAX functions differ by more than either
port function differs from its own.  ``group_weights`` matches JAX's and
round-trips; train mode is the explicit-mask formulation over
``attention_dropout_masks``; the eval-mode backward matches ``jax.grad``
of the JAX ops, and the train-mode backward raises as theirs does.  Past
the earlier 320 keys (325 and 577 tokens) the plain versions still match
the Pallas kernels at widths those admit; v2 at 6 heads is the JAX op's
fallback; the shape predicates and ``kernel_for`` (which kernel a CUDA call
runs) are checked as arithmetic.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iisan_tpu.ops import fused_attn_subblock as jfs
from iisan_tpu_torch.ops import fused_attn_subblock as fsb
from iisan_tpu_torch.ops.fused_attention import attention_dropout_masks

JAX_OPS = {False: jfs.fused_attn_subblock, True: jfs.fused_attn_subblock_v2}
PORT_OPS = {False: fsb.fused_attn_subblock, True: fsb.fused_attn_subblock_v2}


@pytest.fixture()
def interpret_pallas():
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        yield


def _inputs(B=3, T=17, D=128, H=4, seed=0, bias_scale=0.01):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, D)) * 0.3).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    bqkv = (rng.standard_normal(3 * D) * bias_scale).astype(np.float32)
    wo = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    bo = (rng.standard_normal(D) * bias_scale).astype(np.float32)
    lengths = rng.integers(1, T + 1, B)
    lengths[0] = T
    bias = np.where(np.arange(T)[None] < lengths[:, None], 0.0, -1e9).astype(np.float32)
    return x, wqkv, bqkv, wo, bo, bias


def _t(*arrays, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_versions_match_jax_fp32(interpret_pallas, v2, with_bias):
    x, wqkv, bqkv, wo, bo, bias = _inputs(seed=int(v2))
    bias = bias if with_bias else None
    want = JAX_OPS[v2](*map(jnp.asarray, (x, wqkv, bqkv, wo, bo)), n_heads=4,
                       key_bias=None if bias is None else jnp.asarray(bias))
    got = PORT_OPS[v2](*_t(x, wqkv, bqkv, wo, bo), 4,
                       key_bias=None if bias is None else torch.tensor(bias))
    assert got.dtype == torch.float32 and got.shape == x.shape
    tol = 1e-4 if v2 else 1e-5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_each_port_function_tracks_its_own_jax_cast_chain(interpret_pallas):
    dt = torch.bfloat16
    x, wqkv, bqkv, wo, bo, bias = _inputs(B=4, T=13, seed=3, bias_scale=1.0)
    # biases half a bf16 step off the grid: #9 rounds them, #8 keeps them
    ulp = 2.0 ** (np.floor(np.log2(np.abs(bo))) - 7)
    bo = (torch.tensor(bo).to(dt).float().numpy() + 0.45 * ulp).astype(np.float32)
    jx, jw, jwo = (jnp.asarray(a, jnp.bfloat16) for a in (x, wqkv, wo))
    jax_out = {v2: np.asarray(JAX_OPS[v2](jx, jw, jnp.asarray(bqkv), jwo,
                                          jnp.asarray(bo), n_heads=4,
                                          key_bias=jnp.asarray(bias)), np.float32)
               for v2 in (False, True)}
    tx, tw, two = _t(x, wqkv, wo, dtype=dt)
    port = {v2: PORT_OPS[v2](tx, tw, torch.tensor(bqkv), two, torch.tensor(bo), 4,
                             key_bias=torch.tensor(bias)).float().numpy()
            for v2 in (False, True)}

    def differ(a, b):
        return float(np.mean(a != b))

    own = max(differ(port[v], jax_out[v]) for v in (False, True))
    cross = differ(jax_out[False], jax_out[True])
    assert port[False].dtype == np.float32 and own < 0.05 and cross > 0.25
    assert differ(port[True], jax_out[False]) > 0.25


def test_group_weights_matches_jax_and_round_trips():
    _, wqkv, bqkv, wo, _, _ = _inputs(D=256)
    got = fsb.group_weights(*_t(wqkv, bqkv, wo), 4, 2)
    want = jfs._group_weights(jnp.asarray(wqkv), jnp.asarray(bqkv),
                              jnp.asarray(wo), 4, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    wg, bg, wog = got
    # head h = 2 g + i: its q, k, v columns sit side by side in wg[g]
    for h in range(4):
        g, i = divmod(h, 2)
        for part in range(3):
            cols = slice(part * 256 + h * 64, part * 256 + (h + 1) * 64)
            mine = slice(i * 192 + part * 64, i * 192 + (part + 1) * 64)
            np.testing.assert_array_equal(wg[g][:, mine].numpy(), wqkv[:, cols])
            np.testing.assert_array_equal(bg[g][mine].numpy(), bqkv[cols])
    np.testing.assert_array_equal(wog.reshape(256, 256).numpy(), wo)


@pytest.mark.parametrize("v2", [False, True])
def test_train_mode_is_the_explicit_mask_formulation(v2):
    x, wqkv, bqkv, wo, bo, bias = _inputs(B=5, T=11, seed=4)
    tx, tw, tb, two, tbo, tbias = _t(x, wqkv, bqkv, wo, bo, bias)
    got = PORT_OPS[v2](tx, tw, tb, two, tbo, 4, key_bias=tbias, drop_rate=0.1,
                       seed=1234, layer=2)
    masks = attention_dropout_masks(1234, 5, 11, 4, 0.1, 2)
    if v2:
        wg, bg, wog = fsb.group_weights(tw, tb, two, 4)
        want = fsb.reference_subblock_v2(tx, wg, bg, wog, tbo, tbias, 4, 4,
                                         torch.float32, masks)
    else:
        want = fsb.reference_subblock(tx, tw, tb, two, tbo, tbias, 4,
                                      torch.float32, masks)
    assert torch.equal(got, want)
    eval_out = PORT_OPS[v2](tx, tw, tb, two, tbo, 4, key_bias=tbias)
    assert not torch.allclose(got, eval_out)
    assert (masks == 0).float().mean().item() == pytest.approx(0.1, abs=0.03)


@pytest.mark.parametrize("v2", [False, True])
def test_backward_matches_jax_and_refuses_train_mode(interpret_pallas, v2):
    x, wqkv, bqkv, wo, bo, bias = _inputs(seed=5)

    def jloss(*args):
        return jnp.sum(JAX_OPS[v2](*args, n_heads=4,
                                   key_bias=jnp.asarray(bias)) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, wqkv, bqkv, wo, bo)))
    leaves = [t.requires_grad_(True) for t in _t(x, wqkv, bqkv, wo, bo)]
    (PORT_OPS[v2](*leaves, 4, key_bias=torch.tensor(bias)) ** 2).sum().backward()
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    out = PORT_OPS[v2](*leaves, 4, drop_rate=0.1, seed=7)
    with pytest.raises(NotImplementedError, match="dropout"):
        out.sum().backward()


def test_supported_geometry():
    assert fsb.supported(704, 197, 768, 12) and fsb.supported(704, 30, 768, 12)
    assert fsb.supported_v2(704, 197, 768, 12)
    assert fsb.supported(4, 257, 768, 12)          # 257 tokens: a 256-pixel ViT
    assert fsb.supported_v2(4, 257, 768, 12) and fsb.supported(4, 320, 768, 12)
    assert fsb.supported(4, 321, 768, 12)          # past the earlier 320 keys
    assert fsb.supported(4, 325, 768, 12) and fsb.supported(4, 577, 768, 12)
    assert not fsb.supported(4, 30, 96, 2)         # head width 48
    assert fsb.supported(4, 30, 192, 3)            # D = 192: three 64-wide heads
    assert not fsb.supported_v2(4, 30, 384, 6)     # 6 heads, groups of 4
    assert fsb.MAX_KEYS == 46340 and fsb.supported(1, 46340, 768, 12)
    assert not fsb.supported(1, 46341, 768, 12)    # #5's dropout elements
    assert not fsb.supported(65535, 46340, 64, 1)  # B T past a TMA coordinate


# The wrapper's dispatch on the card, as plain arithmetic: #9 for v2 with
# heads in whole groups of 4, #8 for #8 and for v2 with other head counts
# (the JAX op's fallback), nothing past #5's limits or at another head
# width.
@pytest.mark.parametrize("v2,B,T,D,H,want", [
    (False, 704, 197, 768, 12, "attn_subblock_fwd"),
    (True, 704, 197, 768, 12, "attn_subblock_v2_fwd"),
    (True, 704, 30, 768, 12, "attn_subblock_v2_fwd"),
    (True, 4, 325, 256, 4, "attn_subblock_v2_fwd"),   # one group: kg = D
    (True, 4, 30, 384, 6, "attn_subblock_fwd"),       # 6 heads
    (True, 4, 30, 192, 3, "attn_subblock_fwd"),       # 3 heads
    (False, 4, 577, 128, 2, "attn_subblock_fwd"),
    (False, 4, 30, 96, 2, None),                      # head width 48
    (True, 4, 46341, 768, 12, None),                  # past 46,340 keys
    (False, 65536, 30, 768, 12, None),                # B past a grid dimension
])
def test_kernel_for_is_the_dispatch_arithmetic(v2, B, T, D, H, want):
    assert fsb.kernel_for(v2, B, T, D, H) == want


@pytest.mark.parametrize("v2,D,H", [(False, 128, 2), (True, 256, 4)])
@pytest.mark.parametrize("T", [325, 577])
def test_plain_versions_match_jax_past_320_keys(interpret_pallas, v2, D, H, T):
    """325 tokens (CV_resize=288) and 577 (384 pixels), at widths where the
    JAX op still runs its Pallas kernel, not its fallback."""
    x, wqkv, bqkv, wo, bo, bias = _inputs(B=2, T=T, D=D, seed=6 + T)
    jax_takes = (jfs.supported_v2(2, T, D, H, 4, 4) if v2
                 else jfs.supported(2, T, D, H, 4))
    assert jax_takes and fsb.kernel_for(v2, 2, T, D, H) is not None
    want = JAX_OPS[v2](*map(jnp.asarray, (x, wqkv, bqkv, wo, bo)), n_heads=H,
                       key_bias=jnp.asarray(bias))
    got = PORT_OPS[v2](*_t(x, wqkv, bqkv, wo, bo), H, key_bias=torch.tensor(bias))
    tol = 1e-4 if v2 else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_v2_at_six_heads_is_the_jax_fallback(interpret_pallas):
    """6 heads split into no groups of 4: the JAX v2 op computes #8's
    function with the original biases, and so does the port's (on the card
    it launches #8's kernels).  bf16, with biases off the bf16 grid, so
    that the rounded-bias function differs."""
    dt = torch.bfloat16
    x, wqkv, bqkv, wo, bo, bias = _inputs(B=4, T=13, D=384, seed=3, bias_scale=1.0)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(bo))) - 7)
    bo = (torch.tensor(bo).to(dt).float().numpy() + 0.45 * ulp).astype(np.float32)
    want = np.asarray(JAX_OPS[True](
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, wqkv)), jnp.asarray(bqkv),
        jnp.asarray(wo, jnp.bfloat16), jnp.asarray(bo), n_heads=6,
        key_bias=jnp.asarray(bias)), np.float32)
    tx, tw, two = _t(x, wqkv, wo, dtype=dt)
    args = (tx, tw, torch.tensor(bqkv), two, torch.tensor(bo), 6)
    got = PORT_OPS[True](*args, key_bias=torch.tensor(bias))
    assert torch.equal(got, PORT_OPS[False](*args, key_bias=torch.tensor(bias)))
    rounded = fsb.reference_subblock(tx, tw, torch.tensor(bqkv).to(dt).float(), two,
                                     torch.tensor(bo).to(dt).float(),
                                     torch.tensor(bias), 6, dt).float().numpy()
    got = got.float().numpy()
    assert np.mean(got != want) < 0.05 and np.mean(rounded != want) > 0.25
