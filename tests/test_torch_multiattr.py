"""Multi-attribute text items (``news_attributes``) against the JAX package.

``TextTower`` with ``attr_num_words`` (title 6, abstract 10, body 8
words: three ``[ids | mask]`` blocks side by side, padded rows and one
item whose body is all padding) from the same JAX parameters as the JAX
``TextTower`` (2 layers, width 128): the mean vector and the title
block's hidden stack, and in fp32 the gradients of a fixed projection of
both with respect to every parameter.  fp32 to rtol 1e-4, atol 1e-5 (a
gradient's atol in units of its tensor's largest |value| where that
exceeds 1, as in ``test_torch_peft.py``); bf16 to max |diff| / max |want|
< 0.05.  Then the full fine-tuning model's loss over such rows equals the
JAX model's from the same parameters (fp32, 1e-5 relative); the IISAN
model's item embeddings over the packed rows equal, bit for bit, the
title-only model's over the title block (IISAN reads only the title
block's hiddens, so the other blocks do not run); and the port's trainer
takes a packed table of ``cfg.packed_text_width()`` columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.models.bert import BertEncoder as JaxBert
from iisan_tpu.models.towers import TextTower as JaxTextTower
from iisan_tpu.train.uncached import build_uncached_model as jax_build
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.models.bert import BertEncoder
from iisan_tpu_torch.models.towers import TextTower
from iisan_tpu_torch.train.uncached import UncachedTrainer, build_uncached_model
from iisan_tpu_torch.utils.jax_params import flatten_tree, load_jax_params

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DIMS = dict(hidden_dim=128, num_layers=2, num_heads=2, intermediate_dim=512)
WIDTHS = (6, 10, 8)
ATTRS = dict(news_attributes=("title", "abstract", "body"), num_words_title=6,
             num_words_abstract=10, num_words_body=8)
SMALL = dict(embedding_dim=16, side_adapter_vit_list="0,1",
             side_adapter_bert_list="0,1", word_embedding_dim=128,
             image_embedding_dim=128, text_layers=2, image_layers=2,
             CV_resize=32, max_seq_len=4, compute_dtype="float32",
             bert_adapter_down_size=8, cv_adapter_down_size=8)


def _packed(n, seed=0, vocab=500):
    """(n, 2 * sum(WIDTHS)) rows: per block random ids and a mask with a
    ragged tail; row 1's body is all padding."""
    rng = np.random.default_rng(seed)
    blocks = []
    for w in WIDTHS:
        ids = rng.integers(1, vocab, (n, w))
        mask = (np.arange(w)[None] < rng.integers(1, w + 1, (n, 1))).astype(np.int64)
        blocks.append(np.concatenate([ids * mask, mask], 1))
    tokens = np.concatenate(blocks, 1).astype(np.int32)
    tokens[1, -2 * WIDTHS[2]:] = 0
    return tokens


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(
            np.float32), jax.device_get(params))


def _assert_close(got, want, dtype, what="", scaled=False):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    if dtype == "float32":
        unit = max(1.0, float(np.abs(want).max())) if scaled else 1.0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * unit,
                                   err_msg=what)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < 0.05, what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_attribute_text_tower_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    tokens = _packed(5)
    jm = JaxTextTower(JaxBert(vocab_size=500, dtype=jdt, collect="cls", **DIMS),
                      embedding_dim=16, num_words=6, attr_num_words=WIDTHS)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), tokens)["params"], 1)
    want_vec, want_hid = jm.apply({"params": params}, tokens)
    tm = TextTower(BertEncoder(vocab_size=500, dtype=tdt, collect="cls", **DIMS),
                   128, 16, 6, WIDTHS)
    assert tm.widths == WIDTHS
    load_jax_params(tm, params)
    vec, hid = tm(torch.tensor(tokens))
    assert vec.dtype == tdt
    _assert_close(vec, want_vec, dtype, "vector")
    _assert_close(hid, want_hid, dtype, "hiddens")
    # the hiddens are the title block's
    title_hid = tm.bert(torch.tensor(tokens[:, :6]), torch.tensor(tokens[:, 6:12]))[1]
    assert torch.equal(hid, title_hid)
    assert torch.equal(tm.hiddens(torch.tensor(tokens)), title_hid)
    if dtype != "float32":
        return
    rng = np.random.default_rng(2)
    cv, ch = (rng.standard_normal(np.shape(a)).astype(np.float32)
              for a in (want_vec, want_hid))

    def loss(p):
        v, h = jm.apply({"params": p}, tokens)
        return jnp.sum(v * cv) + jnp.sum(h * ch)

    jg = flatten_tree(jax.device_get(jax.grad(loss)(params)))
    ((vec * torch.tensor(cv)).sum() + (hid * torch.tensor(ch)).sum()).backward()
    for name, p in tm.named_parameters():
        _assert_close(p.grad, jg[name], dtype, name, scaled=True)


def test_multi_attribute_fft_loss_matches_jax():
    cfg = IISANConfig(**SMALL, **ATTRS)
    jcfg = JaxConfig(**SMALL, **ATTRS)
    assert cfg.packed_text_width() == jcfg.packed_text_width() == 48
    jmodel, _ = jax_build(jcfg)
    rng = np.random.default_rng(3)
    bs, L = 2, cfg.max_seq_len
    ids = rng.integers(1, 21, (bs, L + 1)).astype(np.int32)
    images = rng.standard_normal((bs * (L + 1), 32, 32, 3)).astype(np.float32)
    tokens = _packed(bs * (L + 1), seed=4, vocab=30000)
    mask = np.ones((bs, L), np.float32)
    pop = np.full((21,), 1 / 21, np.float32)
    params = _perturbed(jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        ids, images, tokens, mask, pop, deterministic=True)["params"], 5)
    want = jmodel.apply({"params": params}, ids, images, tokens, mask, pop,
                        deterministic=True)
    model, method = build_uncached_model(cfg)
    assert method == "fft" and model.text_tower.widths == WIDTHS
    load_jax_params(model, params)
    got = model(torch.tensor(ids), torch.tensor(images), torch.tensor(tokens),
                torch.tensor(mask), torch.tensor(pop), deterministic=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


def test_iisan_item_embeddings_read_the_title_block_alone():
    kw = dict(adapter_type="IISAN", adding_adapter_to="all", fine_tune_to="None")
    multi, _ = build_uncached_model(IISANConfig(**SMALL, **ATTRS, **kw),
                                    generator=torch.Generator().manual_seed(0))
    title, _ = build_uncached_model(IISANConfig(**SMALL, num_words_title=6, **kw),
                                    generator=torch.Generator().manual_seed(0))
    title.load_state_dict(multi.state_dict())
    tokens = torch.tensor(_packed(7))
    images = torch.randn((7, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    calls = []
    multi.text_tower.bert.register_forward_hook(lambda *_: calls.append(1))
    got = multi.item_embeddings(images, tokens)
    assert len(calls) == 1
    want = title.item_embeddings(images, tokens[:, :12])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_trainer_takes_the_packed_table():
    cfg = IISANConfig(**SMALL, **ATTRS, batch_size=4, epoch=1, num_workers=2,
                      lr=1e-3, adapter_type="lora", adding_adapter_to="all")
    corpus = synthetic_corpus(n_users=8, item_num=20, max_seq_len=4, seed=0)
    table = np.concatenate([synthetic_token_table(20, w, seed=i, vocab=500)
                            for i, w in enumerate(WIDTHS)], 1)
    assert table.shape == (21, cfg.packed_text_width())
    tr = UncachedTrainer(cfg, corpus, table, SyntheticImageStore(32), device="cpu")
    calls = []
    tr.model.text_tower.bert.register_forward_hook(lambda *_: calls.append(1))
    loss = tr.run_epoch(1)
    steps = tr.epoch_permutation(1).shape[0]
    assert np.isfinite(loss) and len(calls) == 3 * steps
