"""transformers weights into the port's towers (``params_from_hf_torch``).

transformers ``BertModel`` and ``ViTModel`` built from small configs with
random weights (no download): the port's ``params_from_hf_torch`` gives,
leaf for leaf, the JAX package's tree from the same state dict (plain and
``lora=True``, where q and v sit under ``base``; exactly equal, both are
transposes and reshapes); loaded into the port's encoders, the hidden
states match transformers' in fp32 as ``tests/test_towers.py`` holds the
JAX encoders (BERT on the unpadded positions, atol 2e-5; ViT everywhere,
atol 3e-5).  A LoRA tree, completed with the model's own factors
(``with_lora_factors``), loads into a LoRA encoder, whose hiddens at init
(B = 0) are the plain encoder's; the uncached trainer grafts such a tree.
"""

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from iisan_tpu.models import bert as jbert
from iisan_tpu.models import vit as jvit
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.models import bert as tbert
from iisan_tpu_torch.models import vit as tvit
from iisan_tpu_torch.train.uncached import UncachedTrainer
from iisan_tpu_torch.utils.jax_params import (flatten_tree, load_jax_params,
                                              with_lora_factors)


def _hf_bert():
    cfg = transformers.BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        output_hidden_states=True)
    torch.manual_seed(0)
    return transformers.BertModel(cfg).eval()


def _hf_vit():
    cfg = transformers.ViTConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=64, image_size=32, patch_size=8,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        output_hidden_states=True)
    torch.manual_seed(1)
    return transformers.ViTModel(cfg, add_pooling_layer=False).eval()


BERT_DIMS = dict(vocab_size=120, hidden_dim=32, num_layers=3, num_heads=4,
                 intermediate_dim=64, max_position=40)
VIT_DIMS = dict(image_size=32, patch_size=8, hidden_dim=32, num_layers=3,
                num_heads=4, intermediate_dim=64)


def _assert_same_tree(got, want):
    got, want = flatten_tree(got), flatten_tree(jax.device_get(want))
    assert got.keys() == want.keys()
    for name in want:
        assert isinstance(got[name], np.ndarray), name
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("lora", [False, True])
def test_bert_tree_is_the_jax_packages(lora):
    sd = _hf_bert().state_dict()
    _assert_same_tree(tbert.params_from_hf_torch(sd, 3, lora=lora),
                      jbert.params_from_hf_torch(sd, 3, lora=lora))


@pytest.mark.parametrize("lora", [False, True])
def test_vit_tree_is_the_jax_packages(lora):
    sd = _hf_vit().state_dict()
    _assert_same_tree(tvit.params_from_hf_torch(sd, 3, prefix="", lora=lora),
                      jvit.params_from_hf_torch(sd, 3, prefix="", lora=lora))
    # ViTForImageClassification's keys carry the "vit." prefix
    prefixed = {"vit." + k: v for k, v in sd.items()}
    _assert_same_tree(tvit.params_from_hf_torch(prefixed, 3, lora=lora),
                      jvit.params_from_hf_torch(sd, 3, prefix="", lora=lora))


def _bert_inputs():
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 120, (2, 9), generator=g)
    mask = torch.ones(2, 9, dtype=torch.long)
    mask[1, 6:] = 0
    return ids, mask


@pytest.mark.parametrize("lora", [False, True])
def test_bert_matches_transformers(lora):
    hf = _hf_bert()
    ids, mask = _bert_inputs()
    with torch.no_grad():
        want = [h.numpy() for h in hf(input_ids=ids, attention_mask=mask).hidden_states]
    enc = tbert.BertEncoder(**BERT_DIMS, lora_rank=4 if lora else 0)
    tree = tbert.params_from_hf_torch(hf.state_dict(), 3, lora=lora)
    if lora:
        with pytest.raises(KeyError, match="missing"):
            load_jax_params(enc, tree)  # the factors are not in a checkpoint
        tree = with_lora_factors(enc, tree)
        assert "lora_A" in tree["layer_2"]["attention"]["value"]
    load_jax_params(enc, tree)
    with torch.no_grad():
        _, hiddens = enc(ids, mask)
    assert hiddens.shape == (4, 2, 9, 32)
    for i, w in enumerate(want):
        # padded positions may differ (HF masks only attention)
        np.testing.assert_allclose(hiddens[i, :, :6].numpy(), w[:, :6],
                                   atol=2e-5, err_msg=f"layer {i}")


@pytest.mark.parametrize("lora", [False, True])
def test_vit_matches_transformers(lora):
    hf = _hf_vit()
    imgs = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = hf(pixel_values=imgs)
    enc = tvit.ViTEncoder(**VIT_DIMS, lora_rank=4 if lora else 0)
    tree = tvit.params_from_hf_torch(hf.state_dict(), 3, prefix="", lora=lora)
    load_jax_params(enc, with_lora_factors(enc, tree) if lora else tree)
    with torch.no_grad():
        last, hiddens = enc(imgs.permute(0, 2, 3, 1))
    assert hiddens.shape == (4, 2, 17, 32)
    for i, w in enumerate(out.hidden_states):
        np.testing.assert_allclose(hiddens[i].numpy(), w.numpy(), atol=3e-5,
                                   err_msg=f"layer {i}")
    np.testing.assert_allclose(last.numpy(), out.last_hidden_state.numpy(),
                               atol=3e-5)


def test_with_lora_factors_fills_only_the_factors():
    enc = tbert.BertEncoder(**BERT_DIMS, lora_rank=4)
    tree = tbert.params_from_hf_torch(_hf_bert().state_dict(), 3, lora=True)
    before = flatten_tree(tree)
    done = flatten_tree(with_lora_factors(enc, tree))
    assert flatten_tree(tree).keys() == before.keys()  # the input is untouched
    added = sorted(done.keys() - before.keys())
    assert added == sorted(n for n, _ in enc.named_parameters() if "lora_" in n)
    assert len(added) == 3 * 2 * 2
    np.testing.assert_array_equal(done["layer_0.attention.query.lora_A"],
                                  enc.layer_0.attention.query.lora_A.detach().numpy())
    # a tree that lacks anything else still fails the strict load
    del tree["layer_1"]["intermediate"]
    with pytest.raises(KeyError, match="intermediate"):
        load_jax_params(enc, with_lora_factors(enc, tree))


def test_uncached_trainer_grafts_a_lora_checkpoint():
    # towers_from_config's geometry at width 32: one head, MLP 4x, BERT-base
    # vocabulary and positions
    hf = transformers.BertModel(transformers.BertConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=1,
        intermediate_size=128), add_pooling_layer=False)
    cfg = IISANConfig(embedding_dim=16, side_adapter_vit_list="0,1",
                      side_adapter_bert_list="0,1", word_embedding_dim=32,
                      image_embedding_dim=32, text_layers=3, image_layers=2,
                      CV_resize=32, num_words_title=6, max_seq_len=4,
                      compute_dtype="float32", bert_adapter_down_size=4,
                      cv_adapter_down_size=4, batch_size=4, num_workers=1,
                      adapter_type="lora", adding_adapter_to="all",
                      fine_tune_to="None")
    tree = tbert.params_from_hf_torch(hf.state_dict(), 3, lora=True)
    corpus = synthetic_corpus(n_users=8, item_num=20, max_seq_len=4, seed=0)
    tr = UncachedTrainer(cfg, corpus, synthetic_token_table(20, 6),
                         SyntheticImageStore(32), tower_params={"text_tower/bert": tree},
                         device="cpu")
    q = tr.model.text_tower.bert.layer_0.attention.query
    np.testing.assert_array_equal(
        q.base.kernel.detach().numpy(),
        hf.state_dict()["encoder.layer.0.attention.self.query.weight"].numpy().T)
    assert tr.mask["text_tower.bert.layer_0.attention.query.lora_A"]
    assert not tr.mask["text_tower.bert.layer_0.attention.query.base.kernel"]
    assert np.isfinite(tr.run_epoch(1))
