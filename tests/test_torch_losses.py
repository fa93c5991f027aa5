"""Port parity for the in-batch debiased CE loss (``ops/losses.py``).

The loss and its gradients with respect to ``prec_vec`` and
``score_embs`` against the JAX ``inbatch_ce_loss`` on the CPU, fp32,
|diff| <= 1e-5 * (1 + |want|), on batches with repeated items, padded
rows and an all-pad user.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.ops.losses import inbatch_ce_loss as jax_loss
from iisan_tpu_torch.ops.losses import inbatch_ce_loss

BS, L, D, ITEMS = 6, 10, 16, 12


def _batch(seed, all_pad_user):
    rng = np.random.default_rng(seed)
    # few items, so ids repeat within and across users
    ids = rng.integers(1, ITEMS + 1, size=(BS, L + 1)).astype(np.int32)
    lengths = rng.integers(1, L + 1, size=BS)
    log_mask = (np.arange(L)[None] >= L - lengths[:, None]).astype(np.float32)
    ids[:, :-1] = np.where(log_mask > 0, ids[:, :-1], 0)
    if all_pad_user:
        log_mask[2] = 0.0
        ids[2, :-1] = 0
    pop = rng.random(ITEMS + 1).astype(np.float32) + 0.1
    pop[0] = 1.0
    prec = rng.standard_normal((BS, L, D)).astype(np.float32)
    score = rng.standard_normal((BS * (L + 1), D)).astype(np.float32)
    return prec, score, ids, log_mask, pop / pop.sum()


@pytest.mark.parametrize("all_pad_user", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_jax(seed, all_pad_user):
    prec, score, ids, log_mask, pop = _batch(seed, all_pad_user)
    assert len(np.unique(ids)) < ids.size  # repeated items are in the batch
    j_loss, (j_gp, j_gs) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(prec), jnp.asarray(score), jnp.asarray(ids),
        jnp.asarray(log_mask), jnp.asarray(pop))
    tp = torch.from_numpy(prec).requires_grad_(True)
    ts = torch.from_numpy(score).requires_grad_(True)
    t_loss = inbatch_ce_loss(tp, ts, torch.from_numpy(ids),
                             torch.from_numpy(log_mask), torch.from_numpy(pop))
    t_loss.backward()
    assert t_loss.dtype == torch.float32 and t_loss.ndim == 0
    for got, want in ((t_loss.detach(), j_loss), (tp.grad, j_gp), (ts.grad, j_gs)):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        assert (np.abs(got - want) <= 1e-5 * (1 + np.abs(want))).all()


def test_all_pad_batch_gives_zero_loss():
    prec, score, ids, log_mask, pop = _batch(3, False)
    zero = inbatch_ce_loss(torch.from_numpy(prec), torch.from_numpy(score),
                           torch.from_numpy(ids), torch.zeros(BS, L),
                           torch.from_numpy(pop))
    assert float(zero) == 0.0
