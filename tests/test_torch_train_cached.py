"""Port parity for IISAN (Cached) training (``train/cached.py``).

Both packages' ``CachedTrainer`` start from the same JAX parameters and
train two epochs on the same synthetic corpus (64 users, 200 items, tap
width 32, K=3 taps, bottleneck 8, embedding 16, dropout 0, batch 16).  On
the CPU both run the module path of the user encoder and the batched
reference cascade, so they compute the same function:

- fp32: per-step losses within 1e-4 relative in epoch 1 and 1e-3 in epoch
  2 (Adam turns summation-order differences into parameter differences
  that grow step by step); every parameter within 1e-3 of its tensor's
  largest |value| afterwards; valid HR@10 / nDCG@10 within 1e-6;
- bf16: per-step losses within 2e-2 relative (the cast chains round at
  different places in the two frameworks' autodiff).

The loop's bookkeeping (NaN abort, patience, test metrics at the best
epoch) runs the port's trainer with ``run_epoch`` / ``evaluate_split``
patched, as tests/test_loop.py does for the JAX trainer.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.data.synthetic import synthetic_corpus as jax_corpus
from iisan_tpu.data.synthetic import synthetic_taps
from iisan_tpu.train.cached import CachedTrainer as JaxTrainer
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.data.synthetic import synthetic_taps as port_taps
from iisan_tpu_torch.train.cached import CachedTrainer
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

USERS, ITEMS, DIM, K = 64, 200, 32, 3
SMALL = dict(batch_size=16, epoch=2, embedding_dim=16,
             side_adapter_vit_list="1,3", side_adapter_bert_list="1,3",
             word_embedding_dim=DIM, image_embedding_dim=DIM,
             bert_adapter_down_size=8, cv_adapter_down_size=8, drop_rate=0.0,
             eval_batch_size=32, lr=1e-3, adapter_cv_lr=1e-3,
             adapter_bert_lr=1e-3, fine_tune_lr_image=1e-3,
             fine_tune_lr_text=1e-3)


def _taps():
    return synthetic_taps(ITEMS, K, DIM, 1), synthetic_taps(ITEMS, K, DIM, 2)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trained_pair(request):
    """Both trainers after two epochs from the same weights, with each
    epoch's per-step losses."""
    cfg = JaxConfig(compute_dtype=request.param, fused_epoch_eval=False, **SMALL)
    corpus = jax_corpus(n_users=USERS, item_num=ITEMS, seed=3)
    cv, text = _taps()
    jt = JaxTrainer(cfg, corpus, cv, text)
    tt = CachedTrainer(cfg, corpus, cv, text, device="cpu")
    load_jax_params(tt.model, jax.device_get(jt.params))
    losses, perms_equal = [], []
    for epoch in (1, 2):
        perms_equal.append(np.array_equal(jt.epoch_permutation(epoch),
                                          tt.epoch_permutation(epoch)))
        jt.run_epoch(epoch)
        tt.run_epoch(epoch)
        losses.append((np.asarray(jt._last_step_losses),
                       tt._last_step_losses.numpy()))
    return request.param, jt, tt, losses, perms_equal


def test_trainers_see_the_same_batches(trained_pair):
    _, _, tt, losses, perms_equal = trained_pair
    assert all(perms_equal)
    assert tt.epoch_permutation(1).shape == (USERS // 16, 16)
    assert losses[0][1].shape == (USERS // 16,)


def test_step_losses_track_jax(trained_pair):
    dtype, _, _, losses, _ = trained_pair
    tols = (1e-4, 1e-3) if dtype == "float32" else (2e-2, 2e-2)
    for (want, got), tol in zip(losses, tols):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=0)


def test_parameters_and_metrics_track_jax(trained_pair):
    dtype, jt, tt, _, _ = trained_pair
    fp32 = dtype == "float32"
    want = flatten_tree(jax.device_get(jt.params))
    got = flatten_tree(export_jax_params(tt.model))
    assert got.keys() == want.keys()
    for name in want:
        w = np.asarray(want[name])
        assert np.isfinite(got[name]).all(), name
        if fp32:
            assert np.abs(got[name] - w).max() <= 1e-3 * np.abs(w).max(), name
    # bf16: the two rank the catalogue alike up to rounding near the cut
    tol = 1e-6 if fp32 else 5e-2
    for split in ("valid", "test"):
        j_hit, j_ndcg = jt.evaluate_split(split)
        t_hit, t_ndcg = tt.evaluate_split(split)
        assert abs(t_hit - j_hit) <= tol and abs(t_ndcg - j_ndcg) <= tol
    if not fp32:
        return
    gates = tt.gate_values()
    assert set(gates) == {"side_gate_params_text", "side_gate_params_cv",
                          "side_gate_params_mm"}
    for name, vals in jt.gate_values().items():
        np.testing.assert_allclose(gates[name], vals, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("item_num, k, dim, seed", [(200, 3, 32, 1), (7, 1, 5, 0),
                                                   (40, 7, 768, 2)])
def test_synthetic_taps_are_the_jax_ones(item_num, k, dim, seed):
    got, want = port_taps(item_num, k, dim, seed), synthetic_taps(item_num, k, dim, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()


def test_port_config_and_corpus_are_the_jax_ones():
    ours, theirs = IISANConfig(), JaxConfig()
    assert ([(f.name, f.type) for f in dataclasses.fields(ours)]
            == [(f.name, f.type) for f in dataclasses.fields(theirs)])
    for f in dataclasses.fields(theirs):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    for load in ("bert_large_uncased", "bert_mini", "vit"):
        assert (IISANConfig(bert_model_load=load).with_bert_dims()
                == IISANConfig(**dataclasses.asdict(JaxConfig(
                    bert_model_load=load).with_bert_dims())))
    small = IISANConfig(side_adapter_vit_list="1,3",
                        side_adapter_bert_list="1,3", remove_first="TRUE",
                        fusion_method="add")
    assert small.san_image_taps() == (0, 2, 4) == small.san_text_taps()
    assert small.remove_first_bool and not small.gated
    a = synthetic_corpus(n_users=50, item_num=30, seed=5)
    b = jax_corpus(n_users=50, item_num=30, seed=5)
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _port_trainer(**kw):
    cfg = IISANConfig(compute_dtype="float32", **{**SMALL, **kw})
    corpus = synthetic_corpus(n_users=24, item_num=40)
    cv, text = synthetic_taps(40, K, DIM, 1), synthetic_taps(40, K, DIM, 2)
    return CachedTrainer(cfg, corpus, cv, text, device="cpu")


def test_port_trainer_trains_with_dropout_reproducibly(tmp_path):
    a, b = _port_trainer(drop_rate=0.1), _port_trainer(drop_rate=0.1)
    res = a.train()
    b.run_epoch(1)
    assert res.epochs_run == 2 and len(res.losses) == 2
    assert np.isfinite(res.losses).all() and res.best_test_metrics is not None
    first = a.epoch_permutation(1)
    assert np.array_equal(first, b.epoch_permutation(1))
    # same seed, same dropout draws: the first epochs agree exactly
    c = _port_trainer(drop_rate=0.1)
    c.run_epoch(1)
    assert torch.equal(b._last_step_losses, c._last_step_losses)
    # checkpoints are written on a new best or every 10th epoch
    a.cfg = a.cfg.replace(ckpt_dir=str(tmp_path / "ckpt"))
    res = a.train(save_checkpoints=True, start_epoch=2)
    saved = sorted(os.listdir(tmp_path / "ckpt"))
    assert saved and set(saved) <= {"epoch-3", "epoch-4"}
    assert "epoch-3" in saved  # the first epoch of a run is always tested
    with pytest.raises(ValueError, match="tap table"):
        CachedTrainer(a.cfg, a.corpus, np.zeros((5, K, DIM), np.float32),
                      np.zeros((41, K, DIM), np.float32), device="cpu")


def test_nan_loss_aborts_training(monkeypatch):
    tr = _port_trainer(epoch=5)
    calls = []

    def bad_epoch(epoch):
        calls.append(epoch)
        return float("nan")

    monkeypatch.setattr(tr, "run_epoch", bad_epoch)
    res = tr.train()
    assert len(calls) == 1 and res.epochs_run == 0


def test_early_stop_patience(monkeypatch):
    tr = _port_trainer(epoch=5, early_stop_patience=2)
    monkeypatch.setattr(tr, "run_epoch", lambda e: 1.0)
    vals = iter([0.5] + [0.1] * 50)
    monkeypatch.setattr(tr, "evaluate_split",
                        lambda split: (next(vals), 0.0)
                        if split == "valid" else (0.0, 0.0))
    res = tr.train()
    assert res.epochs_run == 4 and res.best_epoch == 1


def test_best_test_metrics_taken_at_best_valid_epoch(monkeypatch):
    tr = _port_trainer(epoch=12, early_stop_patience=20)
    monkeypatch.setattr(tr, "run_epoch", lambda e: 1.0)
    valid = iter([0.5, 0.9] + [0.1] * 50)
    state = {"ep": 0}

    def fake_eval(split):
        if split == "valid":
            state["ep"] += 1
            return (next(valid), 0.0)
        return (float(state["ep"]), 0.0)

    monkeypatch.setattr(tr, "evaluate_split", fake_eval)
    res = tr.train()
    assert res.best_epoch == 2
    assert res.best_test_metrics == (2.0, 0.0)
    assert res.test_metrics == (11.0, 0.0)  # the every-10th-epoch rule
