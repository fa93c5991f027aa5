"""Port parity for IISAN (Uncached) training with W8A8 towers
(``tower_quant="int8"``).

Both packages' ``UncachedTrainer`` start from one JAX parameter tree, its
int8 tower weights carried bit for bit by the bridge, and train one epoch
(two steps of batch 4) on the same synthetic corpus, images and titles, at
``test_torch_train_uncached.py``'s geometry (towers of 2 layers, width
128, 32 x 32 images, 6-word titles, fp32, dropout 0).  On the CPU both run
the plain ``int8_matmul`` in every tower dense layer: per-step losses
within 1e-4 relative, that file's tolerance.  The frozen int8 weights,
their scales and the tower biases stay bit for bit; the SAN moves.

The graft path: float ``tower_params`` trees given to an int8 trainer are
quantised per output channel bit-equal to JAX's ``quantize_kernel`` (the
JAX package's ``test_int8_graft_path_through_trainer``); the heads stay
float.
"""

import jax
import numpy as np
import torch

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.ops.int8_linear import quantize_kernel as jax_quantize_kernel
from iisan_tpu.train.uncached import UncachedTrainer as JaxTrainer
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.models.modules import TorchLinear
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
             adapter_cv_lr=1e-3, adapter_bert_lr=1e-3, num_workers=2)
IISAN = dict(adapter_type="IISAN", adding_adapter_to="all", fine_tune_to="None")


def _data():
    return (synthetic_corpus(n_users=8, item_num=ITEMS, max_seq_len=4, seed=0),
            synthetic_token_table(ITEMS, WORDS, seed=0, vocab=500),
            SyntheticImageStore(IMAGE))


def _frozen(model):
    """The towers' int8 weights, scales and biases."""
    out = {n: b.clone() for n, b in model.named_buffers() if b.dtype == torch.int8}
    out.update((n, p.detach().clone()) for n, p in model.named_parameters()
               if (".bert." in n or ".vit." in n))
    return out


def test_int8_trainers_track_jax():
    cfg = JaxConfig(pipeline="uncached", mesh_shape="data:1", tower_dropout=0.0,
                    drop_rate=0.0, tower_quant="int8", **SMALL, **IISAN)
    corpus, tokens, store = _data()
    jt = JaxTrainer(cfg, corpus, tokens, store)
    tt = UncachedTrainer(cfg, corpus, tokens, store, device="cpu")
    init = jax.device_get(jt.params)
    assert init["image_tower"]["vit"]["layer_0"]["intermediate"]["kernel_q"].dtype == np.int8
    load_jax_params(tt.model, init)
    before = _frozen(tt.model)
    assert sum(t.dtype == torch.int8 for t in before.values()) == 2 * 2 * 6 + 1
    san = tt.model.san.fc_cv.kernel.detach().clone()
    jt.run_epoch(1)
    tt.run_epoch(1)
    want, got = np.asarray(jt._last_step_losses), tt._last_step_losses.numpy()
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    after = _frozen(tt.model)
    assert all(torch.equal(before[n], after[n]) for n in before)
    assert not torch.equal(san, tt.model.san.fc_cv.kernel)


def test_int8_graft_quantises_float_tower_trees():
    cfg = IISANConfig(**SMALL, **IISAN)
    donor = UncachedTrainer(cfg.replace(seed=7), *_data(), device="cpu")
    trees = {"text_tower/bert": export_jax_params(donor.model.text_tower.bert),
             "image_tower/vit": export_jax_params(donor.model.image_tower.vit)}
    tr = UncachedTrainer(cfg.replace(tower_quant="int8"), *_data(),
                         tower_params=trees, device="cpu")
    n_dense = 0
    for key, tree in trees.items():
        enc = tr.model.get_submodule(key.replace("/", "."))
        for name, leaf in flatten_tree(tree).items():
            if not name.endswith(".kernel"):
                continue
            q, s = jax_quantize_kernel(leaf)
            prefix = name[:-len("kernel")]
            kq = enc.get_buffer(prefix + "kernel_q")
            assert kq.dtype == torch.int8
            np.testing.assert_array_equal(kq.numpy(), q)
            np.testing.assert_array_equal(
                enc.get_parameter(prefix + "kscale").detach().numpy(), s)
            np.testing.assert_array_equal(
                enc.get_parameter(prefix + "bias").detach().numpy(),
                flatten_tree(tree)[prefix + "bias"])
            n_dense += 1
    assert n_dense == 2 * 2 * 6 + 1
    assert isinstance(tr.model.text_tower.fc, TorchLinear)
    assert isinstance(tr.model.image_tower.classifier, TorchLinear)
