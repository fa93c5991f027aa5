"""Checkpoints of the port (``utils/checkpoint.py``, ``TrainLoopMixin``).

- save / restore round trip and ``latest_checkpoint``, as
  tests/test_checkpoint.py holds the JAX package's;
- resume is bit-equal on the CPU, dropout on (0.1), for the cached and the
  ID trainers: two uninterrupted epochs against one epoch, a checkpoint, a
  new trainer resumed from it and one more epoch give equal per-step
  losses in the second epoch, equal parameters and equal Adam moments;
- a resumed trainer evaluates as the trainer that saved it, and the user
  encoder's serving parameters follow a ``load_state_dict``;
- tests/test_pipelines.py's orchestrated save / resume workflow, through
  the port's ``run_from_config``.
"""

import os

import numpy as np
import pytest
import torch

from iisan_tpu.data.synthetic import synthetic_taps
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.train.cached import CachedTrainer
from iisan_tpu_torch.train.id_pipeline import IDTrainer
from iisan_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                              restore_checkpoint,
                                              save_checkpoint)

SMALL = dict(batch_size=8, epoch=1, embedding_dim=16,
             side_adapter_vit_list="1,3", side_adapter_bert_list="1,3",
             word_embedding_dim=24, image_embedding_dim=24,
             bert_adapter_down_size=8, cv_adapter_down_size=8,
             compute_dtype="float32", eval_batch_size=16, drop_rate=0.1,
             lr=1e-3, adapter_cv_lr=1e-3, adapter_bert_lr=1e-3)


def make_trainer(tmp_path, kind, seed=12345):
    cfg = IISANConfig(ckpt_dir=str(tmp_path / "ckpt"), seed=seed, **SMALL)
    corpus = synthetic_corpus(n_users=24, item_num=40)
    if kind == "id":
        return IDTrainer(cfg, corpus, device="cpu")
    k = len(cfg.san_image_taps())
    return CachedTrainer(cfg, corpus, synthetic_taps(40, k, 24, 1),
                         synthetic_taps(40, k, 24, 2), device="cpu")


def adam_moments(tr):
    return [(s["exp_avg"], s["exp_avg_sq"], s["step"])
            for s in tr.optimizer.state.values()]


@pytest.mark.parametrize("kind", ["cached", "id"])
def test_save_restore_roundtrip(tmp_path, kind):
    tr = make_trainer(tmp_path, kind)
    tr.run_epoch(1)
    path = save_checkpoint(tr.cfg.ckpt_dir, 1, tr.checkpoint_state(1))
    assert path.endswith("epoch-1")
    state, epoch = restore_checkpoint(tr.cfg.ckpt_dir, "epoch-1")
    assert epoch == 1 and state["epoch"] == 1
    assert set(state) == {"model", "optimizer", "generator", "epoch"}
    for name, value in tr.model.state_dict().items():
        assert torch.equal(state["model"][name], value), name
    assert torch.equal(state["generator"], tr.generator.get_state())

    tr2 = make_trainer(tmp_path, kind, seed=7)
    assert tr2.resume("epoch-1") == 1
    for (n, a), b in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_latest_checkpoint(tmp_path):
    tr = make_trainer(tmp_path, "cached")
    assert latest_checkpoint(tr.cfg.ckpt_dir) is None
    for ep in (1, 3, 2):
        save_checkpoint(tr.cfg.ckpt_dir, ep, tr.checkpoint_state(ep))
    os.makedirs(os.path.join(tr.cfg.ckpt_dir, "epoch-9.pt"))
    assert latest_checkpoint(tr.cfg.ckpt_dir) == "epoch-3"


@pytest.mark.parametrize("kind", ["cached", "id"])
def test_resume_is_bit_equal_with_dropout(tmp_path, kind):
    straight = make_trainer(tmp_path, kind)
    straight.run_epoch(1)
    save_checkpoint(straight.cfg.ckpt_dir, 1, straight.checkpoint_state(1))
    straight.run_epoch(2)

    # a new trainer: its model, moments and generator are the init's, and
    # the permutations come from cfg.seed, so the seed stays
    resumed = make_trainer(tmp_path, kind)
    assert resumed.resume("epoch-1") == 1
    resumed.run_epoch(2)
    assert torch.equal(resumed._last_step_losses, straight._last_step_losses)
    for (name, a), b in zip(straight.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(adam_moments(straight), adam_moments(resumed)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())
    for split in ("valid", "test"):
        assert resumed.evaluate_split(split) == straight.evaluate_split(split)


def test_serving_parameters_follow_a_loaded_state(tmp_path):
    a, b = make_trainer(tmp_path, "id"), make_trainer(tmp_path, "id", seed=5)
    enc = b.model.user_encoder
    before = enc.packed_params(torch.float32).clone()
    b.model.load_state_dict(a.model.state_dict())
    after = enc.packed_params(torch.float32)
    assert not torch.equal(before, after)
    assert torch.equal(after, a.model.user_encoder.packed_params(torch.float32))


def write_dataset(root):
    rng = np.random.default_rng(0)
    with open(root / "items.tsv", "w") as f:
        for i in range(30):
            f.write(f"I{i:04d}\tTitle of item {i}\n")
    with open(root / "users.tsv", "w") as f:
        for u in range(15):
            seq = " ".join(f"I{int(x):04d}" for x in
                           rng.integers(0, 30, size=int(rng.integers(5, 12))))
            f.write(f"U{u}\t{seq}\n")


def test_orchestrated_run_saves_and_resumes_checkpoints(tmp_path):
    from iisan_tpu_torch.train.pipelines import run_from_config

    write_dataset(tmp_path)
    cfg = IISANConfig(
        root_data_dir=str(tmp_path), dataset="", behaviors="users.tsv",
        news="items.tsv", epoch=2, batch_size=8, embedding_dim=16,
        compute_dtype="float32", eval_batch_size=16, pipeline="id",
        log_dir=str(tmp_path / "logs"), ckpt_dir=str(tmp_path / "ckpts"))
    trainer, res = run_from_config(cfg, device="cpu")
    latest = latest_checkpoint(cfg.ckpt_dir)
    assert latest is not None, "orchestrated run wrote no checkpoints"

    # a fresh run resumed with no epochs left holds the saved state
    trainer2, _ = run_from_config(cfg.replace(load_ckpt_name=latest, epoch=0),
                                  device="cpu")
    want, saved_epoch = restore_checkpoint(cfg.ckpt_dir, latest)
    for name, value in trainer2.model.state_dict().items():
        assert torch.equal(value, want["model"][name]), name
    assert trainer2.evaluate_split("test") == res.test_metrics

    # with epochs left, training goes on past the saved epoch
    _, res3 = run_from_config(cfg.replace(load_ckpt_name=latest, epoch=1),
                              device="cpu")
    assert res3.epochs_run == saved_epoch + 1

    # a checkpoint name as a warm start loads the model only
    cold = run_from_config(cfg.replace(pretrained_recsys_model=latest, epoch=0,
                                       seed=3), device="cpu")[0]
    for name, value in cold.model.state_dict().items():
        assert torch.equal(value, want["model"][name]), name
    assert not cold.optimizer.state
