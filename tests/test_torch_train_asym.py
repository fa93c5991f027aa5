"""Port parity for IISAN-Versa training (``pipeline="cached_asym"``).

Both packages' ``CachedTrainer`` start from the same JAX parameters and
train two epochs on one synthetic corpus (64 users, 200 items, batch 16,
dropout 0, fp32).  The taps come from on-disk stores the JAX package
wrote, opened through each package's ``open_cache`` and ``load_taps``:
text states 9 x 48 with 5 selected taps, image states 5 x 24 with 3
(unequal widths and tap counts: dimension-transform alignment and group
layer-drop).  Two table forms:

- ``cache_quant="none"`` over float16 stores;
- ``cache_quant="int8"``: an int8 text store (``QuantTaps`` straight from
  ``load_taps``) and a float16 image store quantised by the trainer.

Checks, as tests/test_torch_train_cached.py: per-step losses within 1e-4
relative in epoch 1 and 1e-3 in epoch 2 (Adam turns summation-order
differences into parameter differences that grow step by step); the fused
item tables within 1e-4 of their largest value; valid and test HR@10 /
nDCG@10 within 1e-6; the learned gates within 1e-3; ``Recommender.
from_trainer`` gives the JAX package's top-K ids (up to ties within 1e-4).
"""

import jax
import numpy as np
import pytest
import torch

from iisan_tpu import serve as jax_serve
from iisan_tpu.config import IISANConfig
from iisan_tpu.data.cache_store import HiddenStateCache
from iisan_tpu.data.synthetic import synthetic_corpus
from iisan_tpu.train.cached import CachedTrainer as JaxTrainer
from iisan_tpu.train.pipelines import open_cache as jax_open_cache
from iisan_tpu_torch.ops.quant import QuantTaps
from iisan_tpu_torch.serve import Recommender
from iisan_tpu_torch.train.cached import CachedTrainer
from iisan_tpu_torch.train.pipelines import open_cache
from iisan_tpu_torch.utils.jax_params import load_jax_params

USERS, ITEMS = 64, 200
SMALL = dict(pipeline="cached_asym", batch_size=16, epoch=2, embedding_dim=16,
             text_embedding_dim=48, image_embedding_dim=24, text_layers=8,
             image_layers=4, side_adapter_bert_list="1,3,5,7",
             side_adapter_vit_list="1,3", bert_adapter_down_size=8,
             cv_adapter_down_size=4, drop_rate=0.0, eval_batch_size=32,
             lr=1e-3, adapter_cv_lr=1e-3, adapter_bert_lr=1e-3,
             fine_tune_lr_image=1e-3, fine_tune_lr_text=1e-3,
             compute_dtype="float32", fused_epoch_eval=False,
             cached_text_model="llama_states", cached_image_model="vit_states")
SEQS = [[1, 5, 9], [2, 2, 7, 12, 3], list(range(1, 14)), [200], [30, 31, 32]]


def _write_store(path, n_layers, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    store = HiddenStateCache.create(str(path), ITEMS + 1, n_layers, dim, dtype)
    store.write_rows(1, rng.standard_normal((ITEMS, n_layers, dim)).astype(np.float32))
    store.flush()


@pytest.fixture(scope="module", params=["none", "int8"])
def trained_pair(request, tmp_path_factory):
    quant = request.param
    root = tmp_path_factory.mktemp(f"versa_{quant}")
    cfg = IISANConfig(stored_vector_path=str(root), cache_quant=quant, **SMALL)
    _write_store(root / "llama_states.memmap", cfg.text_num_hidden, 48,
                 "int8" if quant == "int8" else "float16", 1)
    _write_store(root / "vit_states.memmap", cfg.image_num_hidden, 24,
                 "float16", 2)
    corpus = synthetic_corpus(n_users=USERS, item_num=ITEMS, seed=3)
    taps = {}
    for pkg, opener in (("jax", lambda c, w: jax_open_cache(c, w, corpus)),
                        ("port", lambda c, w: open_cache(c, w, corpus))):
        taps[pkg] = (opener(cfg, "image").load_taps(cfg.san_image_taps()),
                     opener(cfg, "text").load_taps(cfg.san_text_taps()))
    jt = JaxTrainer(cfg, corpus, *taps["jax"])
    tt = CachedTrainer(cfg, corpus, *taps["port"], device="cpu")
    load_jax_params(tt.model, jax.device_get(jt.params))
    losses = []
    for epoch in (1, 2):
        jt.run_epoch(epoch)
        tt.run_epoch(epoch)
        losses.append((np.asarray(jt._last_step_losses),
                       tt._last_step_losses.numpy()))
    return quant, jt, tt, taps, losses


def test_tables_take_the_configured_form(trained_pair):
    quant, _, tt, taps, _ = trained_pair
    assert isinstance(taps["port"][1], QuantTaps) == (quant == "int8")
    for table in (tt.cv_table, tt.text_table):
        assert isinstance(table, QuantTaps) == (quant == "int8")
        if quant == "int8":
            assert table.out_dtype == "float32" and table.q.dtype == torch.int8
    assert tt.text_table.shape == (ITEMS + 1, 5, 48)
    assert tt.cv_table.shape == (ITEMS + 1, 3, 24)


def test_versa_step_losses_track_jax(trained_pair):
    _, _, _, _, losses = trained_pair
    for (want, got), tol in zip(losses, (1e-4, 1e-3)):
        assert got.shape == (USERS // 16,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=0)


def test_versa_tables_metrics_gates_and_serving_track_jax(trained_pair):
    _, jt, tt, _, _ = trained_pair
    want_table = np.asarray(jt.fused_item_table())
    got_table = tt.fused_item_table().numpy()
    assert got_table.shape == (ITEMS + 1, 16)
    np.testing.assert_allclose(got_table, want_table, rtol=0,
                               atol=1e-4 * np.abs(want_table).max())
    for split in ("valid", "test"):
        j_hit, j_ndcg = jt.evaluate_split(split)
        t_hit, t_ndcg = tt.evaluate_split(split)
        assert abs(t_hit - j_hit) <= 1e-6 and abs(t_ndcg - j_ndcg) <= 1e-6
    gates = tt.gate_values()
    assert set(gates) == {"side_gate_params_text", "side_gate_params_cv",
                          "side_gate_params_mm"}
    assert gates["side_gate_params_text"].shape == (5,)
    assert gates["side_gate_params_mm"].shape == (3,)
    for name, vals in jt.gate_values().items():
        np.testing.assert_allclose(gates[name], vals, rtol=1e-3, atol=1e-5)
    want_ids, want_scores = jax_serve.Recommender.from_trainer(jt).top_k(SEQS, k=10)
    got_ids, got_scores = Recommender.from_trainer(tt).top_k(SEQS, k=10)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4, atol=1e-4)
    for row, col in zip(*np.nonzero(got_ids != want_ids)):
        # ids differ only where two scores tie within the tolerance
        assert abs(got_scores[row, col] - want_scores[row, col]) <= 1e-4
