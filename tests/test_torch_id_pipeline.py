"""The ID-SASRec baseline (``train/id_pipeline.py``, ``IDRecModel``) against
the JAX package's.

Both packages' ``IDTrainer`` start from one JAX parameter tree and train
two epochs on one synthetic corpus (64 users, 200 items, embedding 16,
batch 16, fp32, dropout 0, lr 1e-3), both on the CPU, where the port's user
encoder runs its module path:

- the weight bridge carries the tree both ways (``id_embedding.embedding``
  is the ``nn.Embedding``'s weight), array for array;
- per-step losses agree within 1e-4 relative over both epochs, and the
  valid and test HR@10 / nDCG@10 within 1e-6;
- the port's serving artifact (``Recommender.from_trainer``, the table is
  the embedding weight) ranks as the JAX package's ``Recommender.load`` of
  the same file.
"""

import jax
import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.data.synthetic import synthetic_corpus as jax_corpus
from iisan_tpu.serve import Recommender as JaxRecommender
from iisan_tpu.train.id_pipeline import IDTrainer as JaxIDTrainer
from iisan_tpu_torch.models.model import IDRecModel
from iisan_tpu_torch.serve import Recommender
from iisan_tpu_torch.train.id_pipeline import IDTrainer
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

SMALL = dict(batch_size=16, epoch=2, embedding_dim=16, drop_rate=0.0,
             eval_batch_size=32, lr=1e-3, compute_dtype="float32",
             item_tower="id")


@pytest.fixture(scope="module")
def trained_pair():
    cfg = JaxConfig(**SMALL)
    corpus = jax_corpus(n_users=64, item_num=200, seed=3)
    jt = JaxIDTrainer(cfg, corpus)
    tt = IDTrainer(cfg, corpus, device="cpu")
    tree = jax.device_get(jt.params)
    load_jax_params(tt.model, tree)
    exported = flatten_tree(export_jax_params(tt.model))
    bridged = all(np.array_equal(exported[k], np.asarray(v))
                  for k, v in flatten_tree(tree).items()) and \
        exported.keys() == flatten_tree(tree).keys()
    losses = []
    for epoch in (1, 2):
        jt.run_epoch(epoch)
        tt.run_epoch(epoch)
        losses.append((np.asarray(jt._last_step_losses),
                       tt._last_step_losses.numpy()))
    return jt, tt, losses, bridged


def test_bridge_carries_the_id_tree(trained_pair):
    _, tt, _, bridged = trained_pair
    assert bridged
    assert isinstance(tt.model.id_embedding, torch.nn.Embedding)
    assert tt.model.id_embedding.weight.shape == (201, 16)


def test_step_losses_track_jax(trained_pair):
    _, _, losses, _ = trained_pair
    for want, got in losses:
        assert got.shape == (4,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_metrics_track_jax(trained_pair):
    jt, tt, _, _ = trained_pair
    for split in ("valid", "test"):
        j_hit, j_ndcg = jt.evaluate_split(split)
        t_hit, t_ndcg = tt.evaluate_split(split)
        assert abs(t_hit - j_hit) <= 1e-6 and abs(t_ndcg - j_ndcg) <= 1e-6


def test_artifact_ranks_as_the_jax_recommender(trained_pair, tmp_path):
    _, tt, _, _ = trained_pair
    rec = Recommender.from_trainer(tt)
    assert torch.equal(rec.fused_table, tt.model.id_embedding.weight.detach())
    path = str(tmp_path / "id.npz")
    rec.save(path)
    seqs = [[1, 2, 3], [5, 17, 102, 4], [9]]
    ids, _ = rec.top_k(seqs, k=10)
    want, _ = JaxRecommender.load(path).top_k(seqs, k=10)
    np.testing.assert_array_equal(ids, np.asarray(want))


def test_id_model_initialises_from_the_generator():
    def make(seed):
        return IDRecModel(30, 8, 10, 2, 2, 0.1,
                          generator=torch.Generator().manual_seed(seed))

    a, b, c = make(1), make(1), make(2)
    assert torch.equal(a.id_embedding.weight, b.id_embedding.weight)
    assert not torch.equal(a.id_embedding.weight, c.id_embedding.weight)
    std = float(a.id_embedding.weight.detach().std())
    assert 0.5 * (2 / 39) ** 0.5 < std < 1.5 * (2 / 39) ** 0.5
