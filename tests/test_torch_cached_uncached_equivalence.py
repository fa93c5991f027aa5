"""Cached == Uncached in the port: training on caches that the port's
builder made from the port's towers is the same model as running those
towers in the step (the counterpart of
``tests/test_cached_uncached_equivalence.py``).

An ``UncachedTrainer`` (IISAN, frozen 2-layer BERT and ViT of width 32)
gives its towers to ``cache_builder``, which writes fp32 text and image
stores; a ``CachedTrainer`` opens them through ``open_cache`` with the
uncached trainer's SAN, user encoder and ``com_dense`` weights.  In fp32
at dropout 0 (towers, adapters and user encoder) over full-length
sequences (no pad item enters a batch: cached training embeds it as zeros,
uncached as a zero image), both give the same per-step losses over two
epochs within rtol 5e-5, and the same weights after them within 1e-4.
Shifting the text taps by one layer breaks the match: the test has teeth.
"""

import numpy as np
import pytest
import torch

from iisan_tpu_torch.cache_builder import build_image_cache, build_text_cache
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import SyntheticImageStore
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.train.cached import CachedTrainer
from iisan_tpu_torch.train.optim import build_optimizer
from iisan_tpu_torch.train.pipelines import open_cache
from iisan_tpu_torch.train.uncached import UncachedTrainer

L = 4  # max_seq_len
SHARED = ("san", "user_encoder", "fuse")


def equiv_cfg(tmp_path, **kw):
    base = dict(
        pipeline="uncached", batch_size=8, epoch=1, embedding_dim=16,
        word_embedding_dim=32, image_embedding_dim=32, text_layers=2,
        image_layers=2, CV_resize=16, num_words_title=6,
        side_adapter_vit_list="0,1", side_adapter_bert_list="0,1",
        bert_adapter_down_size=8, cv_adapter_down_size=8, adapter_type="IISAN",
        adding_adapter_to="all", fine_tune_to="None", compute_dtype="float32",
        max_seq_len=L, min_seq_len=3, drop_rate=0.0, tower_dropout=0.0,
        fused_tower_attention=False, fused_user_encoder=False,
        stored_vector_path=str(tmp_path), cached_text_model="text",
        cached_image_model="image")
    base.update(kw)
    return IISANConfig(**base)


def build_both_trainers(tmp_path, text_taps=None):
    cfg = equiv_cfg(tmp_path)
    corpus = synthetic_corpus(n_users=16, item_num=24, max_seq_len=L,
                              min_seq_len=L + 3, seed=3)
    assert (corpus.train_seqs > 0).all() and (corpus.train_log_mask == 1).all()
    rng = np.random.default_rng(0)
    nw = cfg.num_words_title
    tokens = np.zeros((corpus.item_num + 1, 2 * nw), np.int32)
    tokens[1:, :nw] = rng.integers(1, 99, size=(corpus.item_num, nw))
    tokens[1:, nw:] = 1
    images = SyntheticImageStore(cfg.CV_resize)
    uc = UncachedTrainer(cfg, corpus, tokens, images, device="cpu")
    build_text_cache(uc.model.text_tower.bert, tokens,
                     str(tmp_path / "text.memmap"), batch=8, dtype="float32",
                     device="cpu")
    build_image_cache(uc.model.image_tower.vit, corpus.item_names, images,
                      str(tmp_path / "image.memmap"), batch=8, dtype="float32",
                      device="cpu")
    ccfg = cfg.replace(pipeline="cached")
    ct = CachedTrainer(
        ccfg, corpus,
        open_cache(ccfg, "image", corpus).load_taps(cfg.san_image_taps()),
        open_cache(ccfg, "text", corpus).load_taps(text_taps or cfg.san_text_taps()),
        device="cpu")
    for name in SHARED:  # one starting point for the trained parts
        getattr(ct.model, name).load_state_dict(getattr(uc.model, name).state_dict())
    ct.optimizer = build_optimizer(ccfg, ct.model)
    return uc, ct


def _losses(trainer, epoch):
    loss = trainer.run_epoch(epoch)
    assert np.isfinite(loss)
    return trainer._last_step_losses.float().numpy()


def test_cached_equals_uncached_per_step_losses(tmp_path):
    uc, ct = build_both_trainers(tmp_path)
    for epoch in range(2):
        lu, lc = _losses(uc, epoch), _losses(ct, epoch)
        assert lu.shape == lc.shape and lu.shape[0] >= 2
        np.testing.assert_allclose(lc, lu, rtol=5e-5, atol=5e-5)
    for name in SHARED:
        want = getattr(uc.model, name).state_dict()
        for key, value in getattr(ct.model, name).state_dict().items():
            torch.testing.assert_close(value, want[key], rtol=1e-4, atol=1e-5,
                                       msg=f"{name}.{key}")


def test_equivalence_catches_tap_misindexing(tmp_path):
    cfg = equiv_cfg(tmp_path)
    wrong = tuple(min(i + 1, cfg.text_layers) for i in cfg.san_text_taps())
    uc, ct = build_both_trainers(tmp_path, text_taps=wrong)
    lu, lc = _losses(uc, 0), _losses(ct, 0)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(lc, lu, rtol=5e-5, atol=5e-5)
