"""Port parity for the five-group Adam (``train/optim.py``).

``label_for_path`` on the port's parameter names gives the JAX package's
labels on every leaf of a JAX ``IISANRecModel`` tree, and one Adam step
from identical parameters and gradients equals ``optax.multi_transform``
Adam, fp32, |diff| <= 1e-6 (a step moves a parameter by at most its
learning rate; the two order the same arithmetic differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from iisan_tpu.config import IISANConfig
from iisan_tpu.models.model import rec_model_from_config as jax_model
from iisan_tpu.train.optim import build_optimizer as jax_build_optimizer
from iisan_tpu.train.optim import param_labels as jax_param_labels
from iisan_tpu_torch.models.model import rec_model_from_config
from iisan_tpu_torch.train import optim
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

DIM = 32


def _config(**kw):
    return IISANConfig(embedding_dim=16, side_adapter_vit_list="1,3",
                       side_adapter_bert_list="1,3", word_embedding_dim=DIM,
                       image_embedding_dim=DIM, bert_adapter_down_size=8,
                       cv_adapter_down_size=8, compute_dtype="float32",
                       lr=1e-3, adapter_cv_lr=4e-3, adapter_bert_lr=2e-3,
                       fine_tune_lr_image=5e-4, fine_tune_lr_text=3e-4, **kw)


def _jax_params(cfg):
    L, k = cfg.max_seq_len, len(cfg.san_image_taps())
    return jax_model(cfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, L + 1), jnp.int32), jnp.zeros((2 * (L + 1), k, DIM)),
        jnp.zeros((2 * (L + 1), k, DIM)), jnp.zeros((2, L)), jnp.ones((50,)),
        deterministic=True)["params"]


def test_labels_match_jax_on_every_leaf():
    for kw in ({}, {"fusion_method": "add", "modality": "intra"}):
        cfg = _config(**kw)
        want = flatten_tree(jax_param_labels(_jax_params(cfg)))
        model = rec_model_from_config(cfg)
        assert optim.param_labels(model) == want
        counts = optim.log_group_sizes(cfg, model)
        assert sum(counts.values()) == len(want)
        if not kw:  # the published configuration fills all five groups
            assert set(want.values()) == set(optim.GROUPS)


def test_one_adam_step_matches_optax():
    cfg = _config()
    params = jax.tree_util.tree_map(np.asarray, _jax_params(cfg))
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    tx = jax_build_optimizer(cfg, params)
    state = tx.init(params)
    want = params
    for _ in range(2):
        updates, state = tx.update(grads, state, want)
        want = optax.apply_updates(want, updates)

    model = rec_model_from_config(cfg)
    load_jax_params(model, params)
    opt = optim.build_optimizer(cfg, model)
    assert [g["name"] for g in opt.param_groups] == list(optim.GROUPS)
    flat_grads = flatten_tree(grads)
    for _ in range(2):
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(flat_grads[name].copy())
        opt.step()
    got, want = flatten_tree(export_jax_params(model)), flatten_tree(want)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=0,
                                   atol=1e-6, err_msg=name)
