"""Port parity for IISAN (Uncached) and full fine-tuning training
(``train/uncached.py``).

Both packages' ``UncachedTrainer`` start from the same JAX parameters and
train one epoch (two steps of batch 4) on the same synthetic corpus (8
users, 20 items), with the same uint8 images (the port's
``SyntheticImageStore``, handed to both) and title rows: towers of 2
layers, width 128, 2 heads, 32 x 32 images, 6-word titles, sequences of 4,
fp32, tower and user-encoder dropout 0.  On the CPU both run the module
path of the tower attention and of the user encoder, so they compute the
same function: per-step losses within 1e-4 relative; the item table
within 1e-4 of its largest |value|; valid HR@10 / nDCG@10 within 1e-6;
the first step's gradient of every parameter within 1e-4 of its tensor's
largest |value| (plus 1e-7 for gradients that are zero in exact
arithmetic, as the key projections' biases are: softmax is invariant to
them); after the epoch, every parameter outside the trained towers within
1e-3 of its tensor's largest |value| plus 1e-5 (a hundredth of one Adam
step at lr 1e-3, for tensors that start at zero).  The trained towers'
weights are left out of that last check: Adam divides each gradient by
its own magnitude, so an element whose gradient is at rounding level
moves by up to a full step in one package and not the other.  IISAN must
leave every tower weight as it was; FFT must move them.
"""

import jax
import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.train.uncached import UncachedTrainer as JaxTrainer
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.train.uncached import UncachedTrainer
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

ITEMS, WORDS, IMAGE = 20, 6, 32
SMALL = dict(batch_size=4, epoch=1, embedding_dim=16,
             side_adapter_vit_list="0,1", side_adapter_bert_list="0,1",
             word_embedding_dim=128, image_embedding_dim=128, text_layers=2,
             image_layers=2, CV_resize=IMAGE, num_words_title=WORDS,
             max_seq_len=4, compute_dtype="float32", bert_adapter_down_size=8,
             cv_adapter_down_size=8, eval_batch_size=8, lr=1e-3,
             adapter_cv_lr=1e-3, adapter_bert_lr=1e-3, fine_tune_lr_image=1e-3,
             fine_tune_lr_text=1e-3, num_workers=2)
IISAN = dict(adapter_type="IISAN", adding_adapter_to="all", fine_tune_to="None")


def _data():
    return (synthetic_corpus(n_users=8, item_num=ITEMS, max_seq_len=4, seed=0),
            synthetic_token_table(ITEMS, WORDS, seed=0, vocab=500),
            SyntheticImageStore(IMAGE))


def _tower_weights(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if ".bert." in n or ".vit." in n}


@pytest.fixture(scope="module", params=["iisan", "fft"])
def trained_pair(request):
    """Both trainers after one epoch from the same weights."""
    method = dict(IISAN) if request.param == "iisan" else {}
    cfg = JaxConfig(pipeline="uncached", mesh_shape="data:1", tower_dropout=0.0,
                    drop_rate=0.0, **SMALL, **method)
    corpus, tokens, store = _data()
    jt = JaxTrainer(cfg, corpus, tokens, store)
    tt = UncachedTrainer(cfg, corpus, tokens, store, device="cpu")
    init = jax.device_get(jt.params)
    load_jax_params(tt.model, init)
    before = _tower_weights(tt.model)
    grads = _first_step_gradients(jt, tt, init, corpus, tokens, store)
    jt.run_epoch(1)
    tt.run_epoch(1)
    losses = (np.asarray(jt._last_step_losses), tt._last_step_losses.numpy())
    return request.param, jt, tt, losses, before, grads


def _first_step_gradients(jt, tt, init, corpus, tokens, store):
    """(JAX, port) gradients of the training loss at the initial weights
    on the first 4 users: the JAX model's own ``jax.grad``, and the port
    model's ``backward`` (no gradient for frozen towers)."""
    from iisan_tpu.data.images import normalize_images as jax_normalize
    from iisan_tpu_torch.data.images import normalize_images

    ids, mask = corpus.train_seqs[:4], corpus.train_log_mask[:4]
    flat = ids.reshape(-1)
    images = np.stack([store.get(corpus.item_names[i]) if i else
                       np.zeros((IMAGE, IMAGE, 3), np.uint8) for i in flat])
    tok, pop = tokens[flat], corpus.pop_prob

    def loss(params):
        return jt.model.apply({"params": params}, ids,
                              jax_normalize(images, np.float32), tok, mask,
                              pop, deterministic=True)

    want = flatten_tree(jax.device_get(jax.grad(loss)(init)))
    tt.model.zero_grad(set_to_none=True)
    tt.model(torch.tensor(ids).long(),
             normalize_images(torch.tensor(images), torch.float32),
             torch.tensor(tok), torch.tensor(mask), torch.tensor(pop),
             deterministic=True).backward()
    got = {n: p.grad for n, p in tt.model.named_parameters()}
    tt.model.zero_grad(set_to_none=True)
    return want, got


def test_step_losses_track_jax(trained_pair):
    method, _, tt, (want, got), _, _ = trained_pair
    assert tt.method == method and got.shape == (2,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_first_step_gradients_track_jax(trained_pair):
    method, _, _, _, before, (want, got) = trained_pair
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w)
        if got[name] is None:  # a frozen tower: JAX stops its gradient
            assert method == "iisan" and name.split(".")[0] in (
                "text_tower", "image_tower") and not w.any(), name
            continue
        g = got[name].numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, name
    trained = [n for n in before if got[n] is not None and got[n].abs().sum() > 0]
    assert len(trained) == (0 if method == "iisan" else len(before))


def test_parameters_track_jax(trained_pair):
    method, jt, tt, _, before, _ = trained_pair
    want = flatten_tree(jax.device_get(jt.params))
    got = flatten_tree(export_jax_params(tt.model))
    assert got.keys() == want.keys()
    for name in want:
        if method == "fft" and name in before:
            continue
        w = np.asarray(want[name])
        assert np.abs(got[name] - w).max() <= 1e-3 * np.abs(w).max() + 1e-5, name
    after = _tower_weights(tt.model)
    moved = [n for n in before if not torch.equal(before[n], after[n])]
    if method == "iisan":
        assert moved == []
        assert set(tt.gate_values()) == {"side_gate_params_text",
                                         "side_gate_params_cv",
                                         "side_gate_params_mm"}
        for name, vals in jt.gate_values().items():
            np.testing.assert_allclose(tt.gate_values()[name], vals,
                                       rtol=1e-3, atol=1e-5)
    else:
        assert len(moved) > len(before) // 2 and tt.gate_values() == {}


def test_item_table_and_metrics_track_jax(trained_pair):
    _, jt, tt, _, _, _ = trained_pair
    want = np.asarray(jt.item_embedding_tables())
    got = tt.item_embedding_tables().numpy()
    assert got.shape == (ITEMS + 1, 16)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    for split in ("valid", "test"):
        j_hit, j_ndcg = jt.evaluate_split(split)
        t_hit, t_ndcg = tt.evaluate_split(split)
        assert abs(t_hit - j_hit) <= 1e-6 and abs(t_ndcg - j_ndcg) <= 1e-6


def test_port_trainer_trains_with_dropout_reproducibly():
    """BERT's train-mode dropout and the user encoder's draw from the
    trainer's seeded generator: two trainers agree step for step."""
    cfg = IISANConfig(**{**SMALL, "epoch": 2}, **IISAN)
    runs = [UncachedTrainer(cfg, *_data(), device="cpu") for _ in range(2)]
    res = runs[0].train()
    runs[1].run_epoch(1)
    assert res.epochs_run == 2 and np.isfinite(res.losses).all()
    assert res.best_test_metrics is not None
    assert runs[0].epoch_permutation(1).shape == (2, 4)
    # epoch 1 of the first run was the same as the second's
    first = UncachedTrainer(cfg, *_data(), device="cpu")
    first.run_epoch(1)
    assert torch.equal(first._last_step_losses, runs[1]._last_step_losses)
    no_drop = UncachedTrainer(cfg.replace(tower_dropout=0.0, drop_rate=0.0),
                              *_data(), device="cpu")
    no_drop.run_epoch(1)
    assert not torch.equal(no_drop._last_step_losses, first._last_step_losses)


def test_tower_params_are_grafted():
    cfg = IISANConfig(**SMALL, **IISAN)
    donor = UncachedTrainer(cfg.replace(seed=7), *_data(), device="cpu")
    tree = export_jax_params(donor.model.text_tower.bert)
    tr = UncachedTrainer(cfg, *_data(), tower_params={"text_tower/bert": tree},
                         device="cpu")
    for name, p in tr.model.text_tower.bert.named_parameters():
        assert torch.equal(p, donor.model.text_tower.bert.get_parameter(name))
    with pytest.raises(KeyError):
        UncachedTrainer(cfg, *_data(), device="cpu",
                        tower_params={"image_tower/vit": tree})
