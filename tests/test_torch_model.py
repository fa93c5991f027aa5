"""Port parity: the weight bridge and the SAN + com_dense item embeddings
of iisan_tpu_torch against the JAX IISANRecModel on the CPU.

The JAX model is initialised and its parameters perturbed (so gates and
biases are off their zero init); the same tree is loaded into the port.
On the CPU the JAX SAN takes ``reference_cascade`` on every dispatch
branch, and so does the port.

Tolerances: fp32 1e-5 (the algorithm); bf16 5e-2 (the cast chain: one
bf16 ulp is 2^-8 relative, here the two agree bit for bit in practice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig
from iisan_tpu.data.synthetic import synthetic_taps
from iisan_tpu.models.model import rec_model_from_config as jax_model
from iisan_tpu_torch.models.model import rec_model_from_config
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

ITEMS, K, DIM = 49, 3, 32
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def make_config(dtype="float32", **kw):
    return IISANConfig(embedding_dim=16, side_adapter_vit_list="1,3",
                       side_adapter_bert_list="1,3", word_embedding_dim=DIM,
                       image_embedding_dim=DIM, bert_adapter_down_size=8,
                       cv_adapter_down_size=8, compute_dtype=dtype, **kw)


def build_pair(cfg, seed=0):
    """(JAX model, perturbed JAX params, port model loaded with them)."""
    jm = jax_model(cfg)
    L, k = cfg.max_seq_len, len(cfg.san_image_taps())
    variables = jm.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, L + 1), jnp.int32), jnp.zeros((2 * (L + 1), k, DIM)),
        jnp.zeros((2 * (L + 1), k, DIM)), jnp.zeros((2, L)),
        jnp.ones((ITEMS + 1,)), deterministic=True)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), variables["params"])
    tm = rec_model_from_config(cfg, generator=torch.Generator().manual_seed(seed))
    load_jax_params(tm, params)
    return jm, params, tm.eval()


def make_taps():
    return (synthetic_taps(ITEMS, K, DIM, seed=1),
            synthetic_taps(ITEMS, K, DIM, seed=2))


def test_bridge_round_trip_is_exact():
    _, params, tm = build_pair(make_config())
    exported = flatten_tree(export_jax_params(tm))
    want = flatten_tree(params)
    assert exported.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(exported[key], want[key])
    fresh = rec_model_from_config(make_config(),
                                  generator=torch.Generator().manual_seed(9))
    load_jax_params(fresh, export_jax_params(tm))
    for (n1, p1), (n2, p2) in zip(tm.named_parameters(),
                                  fresh.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_is_strict(fault):
    _, params, _ = build_pair(make_config())
    model = rec_model_from_config(make_config(),
                                  generator=torch.Generator().manual_seed(3))
    before = {n: p.clone() for n, p in model.named_parameters()}
    tree = jax.tree_util.tree_map(np.copy, params)
    if fault == "missing":
        del tree["san"]["fc_mm"]["bias"]
    elif fault == "extra":
        tree["san"]["fc_mm"]["unused"] = np.zeros(3, np.float32)
    else:
        tree["fuse"]["com_dense"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        load_jax_params(model, tree)
    for n, p in model.named_parameters():  # nothing was copied
        assert torch.equal(p, before[n])


CONFIGS = {
    "tri": {},
    "batch_intra_off": {"batch_intra_branches": False},
    "use_pallas": {"batch_intra_branches": False, "use_pallas": True},
    "remove_first_additive": {"remove_first": "TRUE", "fusion_method": "add"},
    "gelu": {"batch_intra_branches": False, "adapter_activation": "GELU"},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_item_embeddings_match_jax(name, dtype):
    cfg = make_config(dtype, **CONFIGS[name])
    jm, params, tm = build_pair(cfg)
    cv, text = make_taps()
    emb = jm.apply({"params": params}, jnp.asarray(cv), jnp.asarray(text),
                   method=jm.item_embeddings)
    want = jm.apply({"params": params}, *emb, method=jm.fuse_embeddings)
    with torch.no_grad():
        got = tm.fuse_embeddings(*tm.item_embeddings(torch.tensor(cv),
                                                     torch.tensor(text)))
    assert got.shape == (ITEMS + 1, 16) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])

