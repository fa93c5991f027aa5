"""Port parity: the fused user-encoder kernel's plain PyTorch version
(iisan_tpu_torch.ops.fused_user_encoder) against the JAX Pallas kernel
``apply_fused_encoder`` run in interpret mode on the CPU, eval mode.

Tolerances: fp32 1e-5 (the algorithm: only summation order differs);
bf16 5e-2, as tests/test_fused_user_encoder.py uses for its bf16 cast
chain (a product rounded to the neighbouring bf16 value propagates
through the post-LN blocks).  The CUDA test holds the kernel against the
plain version on the card (tests/test_torch_kernels_cuda.py).
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
from iisan_tpu_torch.models.user_encoder import (UserEncoder,
                                                 causal_additive_mask)
from iisan_tpu_torch.ops import fused_user_encoder as fue
from iisan_tpu_torch.utils.jax_params import load_jax_params

L, D, H, NL = 10, 64, 2, 2
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture()
def interpret_pallas():
    """Force pallas_call into interpreter mode (CPU-runnable kernels)."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        yield


def _setup(B=16, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    log_mask = (rng.random((B, L)) > 0.2).astype(np.float32)
    log_mask[:, -1] = 1.0
    log_mask[0] = 0.0  # an all-pad row: JAX gives the uniform softmax
    jue = JaxUserEncoder(max_seq_len=L, num_attention_heads=H, n_layers=NL,
                         dropout=0.0, dtype=jnp.float32, fused=False)
    params = jue.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      jnp.asarray(log_mask))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    tue = UserEncoder(D, L, H, NL, 0.0)
    load_jax_params(tue, params)
    return params, tue, x, log_mask


def test_flatten_encoder_params_matches_jax():
    params, tue, _, _ = _setup()
    want = jfue.flatten_encoder_params(params["transformer_encoder"], NL)
    got = fue.flatten_encoder_params(tue.transformer_encoder, NL)
    assert len(got) == len(want) == 3 + fue.PER_BLOCK * NL
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    packed = fue.pack_encoder_params(got)
    for g, u in zip(got, fue.unpack_encoder_params(packed, D, 4 * D, NL, L)):
        np.testing.assert_array_equal(g.detach().numpy(), u.numpy())
    # bf16 packing pre-rounds what the cast chain rounds, nothing else
    packed16 = fue.unpack_encoder_params(
        fue.pack_encoder_params(got, torch.bfloat16), D, 4 * D, NL, L)
    for i, (g, u) in enumerate(zip(got, packed16)):
        rounded = i == 0 or (i >= 3 and (i - 3) % fue.PER_BLOCK in (
            0, 1, 2, 3, 6, 7, 8, 9))
        want = g.detach().to(torch.bfloat16).float() if rounded else g.detach()
        assert torch.equal(u, want), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(interpret_pallas, dtype):
    params, tue, x, log_mask = _setup()
    want = jfue.apply_fused_encoder(
        params["transformer_encoder"], jnp.asarray(x).astype(dtype),
        jax_mask(jnp.asarray(log_mask)), n_layers=NL, n_heads=H,
        drop_rate=0.0, compute_dtype=dtype)
    tdt = getattr(torch, dtype)
    got = fue.apply_fused_encoder(
        tue.packed_params(tdt), torch.from_numpy(x).to(tdt),
        causal_additive_mask(torch.from_numpy(log_mask)), n_layers=NL,
        n_heads=H, d_ff=4 * D, n_position=L, compute_dtype=tdt)
    out = got.float().numpy()
    assert got.dtype == tdt and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_supported_takes_serving_batches():
    # Batch 1 serving reaches the kernel: no TPU-style B % 32 / B >= 8 limit.
    for b in (1, 3, 32, 256, 1000):
        assert fue.supported(b, L, D, H, 4 * D, L)
    assert not fue.supported(4, L, D, 3)          # heads must divide D
    assert not fue.supported(4, L, 20, 2)         # width a multiple of 8
    assert not fue.supported(4, L + 1, D, H, 4 * D, L)  # longer than pos table
    assert not fue.supported(4, 512, 1024, H)     # exceeds shared memory


def test_packed_params_follow_parameter_updates():
    _, tue, _, _ = _setup()
    first = tue.packed_params(torch.float32).clone()
    assert tue.packed_params(torch.float32) is tue.packed_params(torch.float32)
    assert not torch.equal(tue.packed_params(torch.bfloat16), first)
    with torch.no_grad():
        tue.transformer_encoder.layer_norm.bias.add_(1.0)
    assert not torch.equal(tue.packed_params(torch.float32), first)
