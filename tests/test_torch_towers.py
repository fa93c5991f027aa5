"""Port parity for the uncached towers and what feeds them.

``BertEncoder`` and ``ViTEncoder`` (2 layers, width 128, 2 heads of 64,
32 x 32 images = 4 patches, 6-word titles) run from the same JAX
parameters as the JAX modules, the parameters moved off their initial
values so that every LayerNorm and bias matters.  On the CPU both run the
module path of the attention.  fp32: last output and hidden stack within
1e-4 relative + 1e-5 (flax's LayerNorm takes the variance as E[x^2] -
E[x]^2, torch's in two passes, and the ViT's residual stream grows to
O(10)); bf16: max |diff| / max |want| < 0.05 (the two frameworks round
the cast chain at different places).

Also: ``normalize_images`` bit for bit against JAX in bf16 and fp32, the
stable synthetic images and token rows, ``take_cls_taps``, ``com_dense``
on the "fft" modality, ``towers_from_config``'s refusals, and
``trainable_mask`` against the JAX package's path predicates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.data.images import normalize_images as jax_normalize
from iisan_tpu.models.bert import BertEncoder as JaxBert
from iisan_tpu.models.model import ComDense as JaxComDense
from iisan_tpu.models.towers import take_cls_taps as jax_take_cls_taps
from iisan_tpu.models.vit import ViTEncoder as JaxViT
from iisan_tpu.train.peft_masks import trainable_mask as jax_trainable_mask
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import (SyntheticImageStore, normalize_images,
                                         synthetic_token_table)
from iisan_tpu_torch.models.bert import BertEncoder
from iisan_tpu_torch.models.model import ComDense
from iisan_tpu_torch.models.towers import take_cls_taps, towers_from_config
from iisan_tpu_torch.models.vit import ViTEncoder
from iisan_tpu_torch.train.peft_masks import trainable_mask
from iisan_tpu_torch.train.uncached import build_uncached_model
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

DIMS = dict(hidden_dim=128, num_layers=2, num_heads=2, intermediate_dim=512)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _perturbed(params, seed):
    """Params moved off their initial values (LayerNorms, zero biases)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(
            np.float32), jax.device_get(params))


def _assert_close(got, want, dtype):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("collect", ["full", "cls"])
def test_bert_encoder_matches_jax(dtype, collect):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1000, (5, 6)).astype(np.int32)
    mask = np.ones((5, 6), np.int32)
    mask[1, 4:] = 0
    mask[4] = 0          # the pad item: every key masked
    ids[4] = 0
    jm = JaxBert(vocab_size=1000, dtype=jdt, collect=collect, **DIMS)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), ids, mask)["params"], 1)
    want_last, want_hid = jm.apply({"params": params}, ids, mask)
    tm = BertEncoder(vocab_size=1000, dtype=tdt, collect=collect, **DIMS)
    load_jax_params(tm, params)
    last, hid = tm(torch.tensor(ids), torch.tensor(mask))
    assert last.dtype == tdt and hid.shape == want_hid.shape
    _assert_close(last, want_last, dtype)
    _assert_close(hid, want_hid, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("collect", ["full", "cls"])
def test_vit_encoder_matches_jax(dtype, collect):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    jm = JaxViT(image_size=32, dtype=jdt, collect=collect, **DIMS)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), images)["params"], 2)
    want_last, want_hid = jm.apply({"params": params}, jnp.asarray(images, jdt))
    tm = ViTEncoder(image_size=32, dtype=tdt, collect=collect, **DIMS)
    load_jax_params(tm, params)
    last, hid = tm(torch.tensor(images).to(tdt))
    assert last.shape == (3, 5, 128) and hid.shape == want_hid.shape
    _assert_close(last, want_last, dtype)
    _assert_close(hid, want_hid, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_images_is_the_jax_cast_chain(dtype):
    jdt, tdt = DTYPES[dtype]
    u8 = np.arange(256, dtype=np.uint8).reshape(4, 4, 16, 1).repeat(3, -1)
    got = normalize_images(torch.tensor(u8), tdt)
    want = np.asarray(jax_normalize(jnp.asarray(u8), jdt), np.float32)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_synthetic_images_and_tokens_are_stable():
    store = SyntheticImageStore(8)
    a = store.get("item17")
    assert a.shape == (8, 8, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, SyntheticImageStore(8).get("item17"))
    assert not np.array_equal(a, store.get("item18"))
    tokens = synthetic_token_table(20, 6, seed=0)
    assert tokens.shape == (21, 12) and tokens.dtype == np.int32
    assert not tokens[0].any()                     # the pad item
    assert (tokens[1:, :6] >= 1).all() and (tokens[1:, 6:] == 1).all()
    np.testing.assert_array_equal(tokens, synthetic_token_table(20, 6, seed=0))


def test_take_cls_taps_matches_jax():
    rng = np.random.default_rng(2)
    for shape in ((4, 3, 5, 8), (4, 3, 8)):
        hid = rng.standard_normal(shape).astype(np.float32)
        got = take_cls_taps(torch.tensor(hid), (0, 2, 3))
        want = np.asarray(jax_take_cls_taps(jnp.asarray(hid), (0, 2, 3)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_com_dense_fft_falls_through_to_the_pair():
    rng = np.random.default_rng(3)
    cv, text = (rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    jm = JaxComDense(16, "fft")
    params = jm.init(jax.random.PRNGKey(0), cv, text, None)["params"]
    tm = ComDense(16, "fft")
    assert tuple(tm.com_dense.kernel.shape) == (32, 16)
    load_jax_params(tm, params)
    got = tm(torch.tensor(cv), torch.tensor(text), None)
    want = jm.apply({"params": params}, cv, text, None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


SMALL = dict(embedding_dim=16, side_adapter_vit_list="0,1",
             side_adapter_bert_list="0,1", word_embedding_dim=128,
             image_embedding_dim=128, text_layers=2, image_layers=2,
             CV_resize=32, num_words_title=6, max_seq_len=4,
             bert_adapter_down_size=8, cv_adapter_down_size=8)
IISAN = dict(adapter_type="IISAN", adding_adapter_to="all", fine_tune_to="None")


@pytest.mark.parametrize("kw", [
    dict(fused_tower_attention="subblock"),
    dict(fused_tower_attention="subblock_v2", **IISAN),
    dict(tower_quant="int8", **IISAN),
    dict(remat_towers=True),
    dict(remat_towers="mlp"),
    dict(adapter_type="lora", adding_adapter_to="all"),
    dict(adapter_type="houslby", adding_adapter_to="all"),
    dict(news_attributes=("title", "abstract")),
])
def test_towers_from_config_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError):
        towers_from_config(IISANConfig(**{**SMALL, **kw}))


def test_towers_from_config_geometry():
    with pytest.raises(ValueError, match="fused_tower_attention"):
        towers_from_config(IISANConfig(fused_tower_attention="Subblock", **SMALL))
    text, image = towers_from_config(IISANConfig(**SMALL))
    assert text.bert.dropout == 0.1 and image.vit.dropout == 0.0
    assert text.bert.collect == image.vit.collect == "cls"
    assert text.bert.fused is True and image.vit.num_layers == 2
    text, image = towers_from_config(IISANConfig(tower_dropout=0.0, **SMALL))
    assert text.bert.dropout == 0.0 == image.vit.dropout


@pytest.mark.parametrize("method_cfg,kw", [
    (IISAN, {}),
    (IISAN, dict(finetune_layernorm=True)),
    (IISAN, dict(fine_tune_to_all=True, freeze_paras_before=9)),
    ({}, {}),
    ({}, dict(freeze_paras_before=21)),
    (dict(adapter_type="bitfit", adding_adapter_to="all"), {}),
])
def test_trainable_mask_matches_jax(method_cfg, kw):
    cfg = IISANConfig(**SMALL, **method_cfg)
    model, method = build_uncached_model(cfg)
    assert method == ("iisan" if method_cfg is IISAN else
                      method_cfg.get("adapter_type", "fft"))
    mask = trainable_mask(model, method, **kw)
    want = flatten_tree(jax_trainable_mask(export_jax_params(model), method, **kw))
    assert mask == {k: bool(v) for k, v in want.items()}
    assert all(p.requires_grad == mask[n] for n, p in model.named_parameters())
    assert any(mask.values()) and not (method == "iisan" and not kw
                                       and any(v for n, v in mask.items()
                                               if ".bert." in n or ".vit." in n))


def test_port_config_uncached_fields_are_the_jax_ones():
    ours, theirs = IISANConfig(**SMALL, **IISAN), JaxConfig(**SMALL, **IISAN)
    assert ours.is_iisan() and ours.towers_frozen()
    for name in ("is_iisan", "towers_frozen", "active_text_attributes",
                 "attr_num_words", "packed_text_width"):
        assert getattr(ours, name)() == getattr(theirs, name)(), name
    multi = dict(news_attributes="title,body")
    assert (IISANConfig(**multi).packed_text_width()
            == JaxConfig(**multi).packed_text_width() == 160)
    assert not IISANConfig(**SMALL, **dict(IISAN, fine_tune_to="all")).towers_frozen()
