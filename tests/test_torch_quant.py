"""Port parity for int8 tap tables (``ops/quant.py``) against the JAX
package's ``iisan_tpu/ops/quant.py``.

``quantize_taps`` is bit-equal to the JAX (numpy) function: int8 values
and fp32 scales, zero rows (the pad item) included, from fp32, fp16 and
bf16-valued inputs, in one chunk and in many.  ``gather_rows`` and
``dequantize`` are bit-equal in fp32 and bf16 (one fp32 multiply, then one
cast), as is the plain-table gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.ops import quant as jq
from iisan_tpu_torch.ops import quant as q


def _taps(dtype=np.float32, n=37, k=3, d=50, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, k, d)) * rng.uniform(0.01, 30, (n, k, 1)))
    x[0] = 0.0          # the pad item
    x[5, 1] = 0.0       # one zero (item, tap) row
    x[7, 2, :] = 1e-30  # a tiny row: scale underflows to a denormal
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("chunk_rows", [2048, 4])
def test_quantize_taps_is_bit_equal_to_jax(dtype, chunk_rows):
    x = _taps(dtype)
    want = jq.quantize_taps(x)
    got = q.quantize_taps(x, chunk_rows=chunk_rows)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.shape == x.shape and got.scale.shape == (37, 3, 1)
    np.testing.assert_array_equal(got.q.numpy(), want.q)
    np.testing.assert_array_equal(got.scale.numpy(), want.scale)
    assert not got.q[0].any() and not got.scale[0].any()
    assert got.out_dtype == want.out_dtype == "bfloat16"


def test_quantize_taps_of_a_bf16_tensor_is_bit_equal():
    x = torch.tensor(_taps()).to(torch.bfloat16)
    want = jq.quantize_taps(np.asarray(x.float().numpy()))
    got = q.quantize_taps(x, out_dtype="float32")
    np.testing.assert_array_equal(got.q.numpy(), want.q)
    np.testing.assert_array_equal(got.scale.numpy(), want.scale)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_gather_and_dequantize_are_bit_equal(out_dtype):
    x = _taps()
    jt = jq.quantize_taps(x, out_dtype=out_dtype)
    jt = jq.QuantTaps(jnp.asarray(jt.q), jnp.asarray(jt.scale), out_dtype)
    tt = q.quantize_taps(x, out_dtype=out_dtype)
    ids = np.array([3, 0, 36, 3, 7, 5], np.int32)
    want = np.asarray(jq.gather_rows(jt, jnp.asarray(ids)).astype(jnp.float32))
    got = q.gather_rows(tt, torch.tensor(ids).long())
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        q.dequantize(tt).float().numpy(),
        np.asarray(jnp.asarray(jq.dequantize(jt)).astype(jnp.float32)))
    # a slice reads the same rows as their ids
    assert torch.equal(q.gather_rows(tt, slice(2, 9)),
                       q.gather_rows(tt, torch.arange(2, 9)))
    plain = torch.tensor(x)
    assert torch.equal(q.gather_rows(plain, torch.tensor(ids).long()),
                       plain[torch.tensor(ids).long()])
    assert q.n_rows(tt) == 37 and q.feature_shape(tt) == (3, 50)
    assert tt.nbytes == 37 * 3 * 50 + 37 * 3 * 4
