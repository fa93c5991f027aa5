"""Port parity: the torch TransformerEncoder / UserEncoder / causal mask
against the JAX modules (iisan_tpu.models.modules / user_encoder).

The same JAX-initialised weights (perturbed so LayerNorm and biases are
not at their init values) go through both packages on the CPU.

Tolerances: fp32 compares the algorithm, 1e-5 (summation order and
LayerNorm's variance formula differ in the last bits); bf16 compares the
cast chain, 5e-2 (one bf16 ulp is 2^-8 relative, and a value rounded to
the neighbouring bf16 number in one package propagates through LN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.models.modules import TransformerEncoder as JaxEncoder
from iisan_tpu.models.user_encoder import UserEncoder as JaxUserEncoder
from iisan_tpu.models.user_encoder import causal_additive_mask as jax_mask
from iisan_tpu_torch.models.modules import TransformerEncoder
from iisan_tpu_torch.models.user_encoder import (UserEncoder,
                                                 causal_additive_mask)
from iisan_tpu_torch.utils.jax_params import load_jax_params

B, L, D, H, NL = 16, 10, 64, 2, 2
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _perturb(params, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(p.shape)
        .astype(np.float32), params)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    log_mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    log_mask[:, -1] = 1.0
    log_mask[0] = 0.0  # an all-pad row
    return rng, x, log_mask


def test_causal_additive_mask_matches_jax():
    _, _, log_mask = _inputs()
    want = np.asarray(jax_mask(jnp.asarray(log_mask)))
    got = causal_additive_mask(torch.from_numpy(log_mask))
    assert got.dtype == torch.float32 and got.shape == (B, 1, L, L)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0.0, -1e9}  # -1e9, never -inf
    assert (got.numpy()[0] == -1e9).all()       # all-pad row fully masked


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_encoder_matches_jax(dtype):
    rng, x, log_mask = _inputs()
    mask = np.array(jax_mask(jnp.asarray(log_mask)))
    jenc = JaxEncoder(n_position=L, n_heads=H, n_layers=NL, dropout=0.0,
                      dtype=jnp.dtype(dtype))
    params = _perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(mask))["params"], rng)
    want = jenc.apply({"params": params}, jnp.asarray(x).astype(dtype),
                      jnp.asarray(mask))

    tenc = TransformerEncoder(D, L, H, NL, 0.0, dtype=getattr(torch, dtype))
    load_jax_params(tenc, params)
    with torch.no_grad():
        got = tenc(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_user_encoder_matches_jax(dtype):
    rng, x, log_mask = _inputs(1)
    jue = JaxUserEncoder(max_seq_len=L, num_attention_heads=H, n_layers=NL,
                         dropout=0.1, dtype=jnp.dtype(dtype), fused=False)
    params = _perturb(jue.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               jnp.asarray(log_mask))["params"], rng)
    want = jue.apply({"params": params}, jnp.asarray(x), jnp.asarray(log_mask))

    tue = UserEncoder(D, L, H, NL, 0.1, dtype=getattr(torch, dtype))
    load_jax_params(tue, params)
    with torch.no_grad():
        got = tue(torch.from_numpy(x), torch.from_numpy(log_mask))
    out = got.float().numpy()
    assert np.isfinite(out).all()  # the all-pad row is not NaN
    np.testing.assert_allclose(out, np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
