"""Port parity: the asymmetric (IISAN-Versa, ``pipeline="cached_asym"``)
SAN and model of iisan_tpu_torch against the JAX package on the CPU.

The JAX model is initialised, its parameters perturbed (gates and biases
off their zero init) and the same tree loaded into the port, a strict
rename: ``down_project_list_{i}`` and the "asym" heads keep the JAX names.
Geometries: the text tower wider (48 vs 24) and the image tower wider,
uneven tap lists (5 vs 3, either side longer: group layer-drop), equal
widths with uneven lists, ``modality`` intra_inter / inter / intra,
``remove_first`` with additive fusion, GELU, ``use_pallas`` (on the CPU both
packages then run ``reference_cascade``).  The two bottlenecks differ (8
text, 4 image), so the inter branch's choice between them is checked too.

Tolerances, as tests/test_torch_model.py: fp32 1e-5 (the algorithm); bf16
5e-2 (the cast chain: one bf16 ulp is 2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig
from iisan_tpu.models.model import rec_model_from_config as jax_model
from iisan_tpu.train.optim import label_for_path as jax_label
from iisan_tpu_torch.models.model import rec_model_from_config
from iisan_tpu_torch.models.san import SideAdapterNetwork
from iisan_tpu_torch.train.optim import param_labels
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

ITEMS, EMB = 41, 16
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def make_config(dtype="float32", text=48, image=24, text_list="1,3,5,7",
                image_list="1,3", **kw):
    return IISANConfig(pipeline="cached_asym", embedding_dim=EMB,
                       text_embedding_dim=text, image_embedding_dim=image,
                       side_adapter_bert_list=text_list,
                       side_adapter_vit_list=image_list,
                       bert_adapter_down_size=8, cv_adapter_down_size=4,
                       compute_dtype=dtype, **kw)


def build_pair(cfg, seed=0):
    """(JAX model, perturbed JAX params, port model loaded with them)."""
    jm = jax_model(cfg)
    L = cfg.max_seq_len
    kc, kt = len(cfg.san_image_taps()), len(cfg.san_text_taps())
    variables = jm.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, L + 1), jnp.int32),
        jnp.zeros((2 * (L + 1), kc, cfg.image_embedding_dim)),
        jnp.zeros((2 * (L + 1), kt, cfg.text_embedding_dim)),
        jnp.zeros((2, L)), jnp.ones((ITEMS + 1,)), deterministic=True)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), variables["params"])
    tm = rec_model_from_config(cfg, generator=torch.Generator().manual_seed(seed))
    load_jax_params(tm, params)
    return jm, params, tm.eval()


def make_taps(cfg, seed=1):
    rng = np.random.default_rng(seed)
    cv = rng.standard_normal((ITEMS + 1, len(cfg.san_image_taps()),
                              cfg.image_embedding_dim)).astype(np.float32)
    text = rng.standard_normal((ITEMS + 1, len(cfg.san_text_taps()),
                                cfg.text_embedding_dim)).astype(np.float32)
    cv[0] = text[0] = 0.0
    return cv, text


CASES = {
    "text_wider": {},
    "image_wider": dict(text=24, image=48),
    "image_list_longer": dict(text=24, image=48, text_list="1,3",
                              image_list="1,3,5,7"),
    "equal_widths_uneven_lists": dict(text=32, image=32),
    "inter_only": dict(modality="inter"),
    "intra_only": dict(modality="intra"),
    "remove_first_additive": dict(remove_first="TRUE", fusion_method="add"),
    "gelu_unbatched": dict(adapter_activation="GELU",
                           batch_intra_branches=False),
    "use_pallas": dict(use_pallas=True, batch_intra_branches=False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_asym_item_embeddings_match_jax(name, dtype):
    cfg = make_config(dtype, **CASES[name])
    jm, params, tm = build_pair(cfg)
    cv, text = make_taps(cfg)
    emb = jm.apply({"params": params}, jnp.asarray(cv), jnp.asarray(text),
                   method=jm.item_embeddings)
    want = jm.apply({"params": params}, *emb, method=jm.fuse_embeddings)
    with torch.no_grad():
        got_emb = tm.item_embeddings(torch.tensor(cv), torch.tensor(text))
        got = tm.fuse_embeddings(*got_emb)
    assert got.shape == (ITEMS + 1, EMB) and got.dtype == getattr(torch, dtype)
    for g, w in zip(got_emb, emb):  # each branch on its own, then fused
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_asym_training_loss_matches_jax(dtype):
    # the whole model's training forward at dropout off: SAN, com_dense,
    # user encoder and the in-batch loss
    cfg = make_config(dtype)
    jm, params, tm = build_pair(cfg)
    cv, text = make_taps(cfg)
    rng = np.random.default_rng(4)
    L = cfg.max_seq_len
    ids = rng.integers(1, ITEMS + 1, (3, L + 1)).astype(np.int32)
    mask = np.ones((3, L), np.float32)
    mask[0, :4] = 0.0
    pop = rng.random(ITEMS + 1).astype(np.float32)
    flat = ids.reshape(-1)
    want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(cv[flat]),
                    jnp.asarray(text[flat]), jnp.asarray(mask), jnp.asarray(pop),
                    deterministic=True)
    with torch.no_grad():
        got = tm(torch.tensor(ids).long(), torch.tensor(cv[flat]),
                 torch.tensor(text[flat]), torch.tensor(mask), torch.tensor(pop),
                 deterministic=True)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL[dtype])


def test_versa_parameters_are_the_jax_tree():
    # Versa's published shape, narrowed: text 4x wider than the image side,
    # 7 taps each, so the inter branch has 7 down projections.
    cfg = make_config(text=64, image=16, text_list="4,19,34,49,64,79",
                      image_list="1,3,5,7,9,11", text_layers=80)
    jm, params, tm = build_pair(cfg)
    want = {k: np.shape(v) for k, v in flatten_tree(params).items()}
    got = {k: tuple(v.shape) for k, v in flatten_tree(export_jax_params(tm)).items()}
    assert got == want
    assert {f"san.down_project_list_{i}.kernel" for i in range(7)} <= got.keys()
    assert got["san.down_project_list_0.kernel"] == (64, 16)
    assert got["san.mm_adapter_list_wd"] == (7, 16, 4)  # cv bottleneck
    assert got["san.fc_bert.kernel"] == (64, EMB)
    assert got["san.bert_pre_fc.kernel"] == (EMB, EMB)
    # every parameter lands in the JAX optimizer group; the down
    # projections in "recsys"
    labels = param_labels(tm)
    for name, label in labels.items():
        assert label == jax_label(name.replace(".", "/")), name
    assert labels["san.down_project_list_3.bias"] == "recsys"


def test_symmetric_and_batched_dispatch_need_equal_widths():
    # equal tap counts and bottlenecks but unequal widths: the intra
    # branches cannot be stacked, so the batched dispatch must not run
    san = SideAdapterNetwork(EMB, text_dim=48, image_dim=24, num_text_taps=3,
                             num_image_taps=3, bert_down_size=4, cv_down_size=4,
                             head_mode="asym", batch_intra=True,
                             generator=torch.Generator().manual_seed(0))
    cv = torch.randn(5, 3, 24)
    text = torch.randn(5, 3, 48)
    with torch.no_grad():
        emb_cv, emb_text, emb_mm = san(cv, text)
    assert emb_cv.shape == emb_text.shape == emb_mm.shape == (5, EMB)
    with pytest.raises(ValueError, match="head_mode"):
        SideAdapterNetwork(EMB, head_mode="other")
