"""The ID-embedding baseline (``item_tower="id"``) on one device or a mesh.

Port of ``iisan_tpu/train/id_pipeline.py``: item embeddings are rows of a
learned table (``models/model.IDRecModel``); the user encoder, the
in-batch loss and the evaluation are the cached pipeline's.  One Adam at
``cfg.lr`` updates every parameter (the reference's single-learning-rate
optimizer).  An epoch is a loop of steps whose losses stay on the device
until its end; the evaluation scores the catalogue against the table.  A
``data`` axis (``cfg.mesh_shape``) splits each step's users as in the
cached trainer (``train/cached.py``).
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..eval.evaluate import evaluate
from ..models.model import id_model_from_config
from .loop import TrainLoopMixin

log = logging.getLogger("iisan_tpu_torch")


class IDTrainer(TrainLoopMixin):
    """Training of ``IDRecModel``.

    cfg: an ``IISANConfig`` (either package's); corpus: a ``Corpus``.  The
    model is initialised on the CPU from ``cfg.seed`` and moved to
    ``device`` (default the first CUDA card; the CPU only when asked for);
    train-mode dropout draws from a CPU generator seeded from ``cfg.seed``
    (per data rank, ``TrainLoopMixin.dropout_seed``).  ``mesh``: a
    ``parallel.mesh.Mesh``, default ``make_mesh(cfg.mesh_shape)``.
    """

    def __init__(self, cfg, corpus, device=None, mesh=None):
        self.cfg, self.corpus = cfg, corpus
        self.device = resolve_device(device)
        self._init_mesh(mesh)
        self.model = id_model_from_config(
            cfg, corpus.item_num,
            generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self._replicate()
        self.generator = torch.Generator().manual_seed(self.dropout_seed())
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

        def put(x):
            return torch.as_tensor(np.asarray(x), device=self.device)

        self.pop_prob = put(corpus.pop_prob)
        self.train_seqs = put(corpus.train_seqs).long()
        self.train_log_mask = put(corpus.train_log_mask)
        self._last_step_losses = None
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("##### trainable_num %d #####", n_params)

    def train_step(self, ids: torch.Tensor, log_mask: torch.Tensor) -> torch.Tensor:
        """One step on a (bs, L+1) id batch; returns the loss, this rank's
        share on a split batch (on the device, not synchronised)."""
        loss = self.model(ids, log_mask, self.pop_prob, deterministic=False,
                          generator=self.generator, shard=self.shard)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.reduce_gradients()
        self.optimizer.step()
        return loss.detach()

    def run_epoch(self, epoch: int) -> float:
        perm = torch.as_tensor(self.epoch_permutation(epoch),
                               device=self.device).long()
        ids_all, mask_all = self.train_seqs[perm], self.train_log_mask[perm]
        losses = self.epoch_losses([self.train_step(ids, mask)
                                    for ids, mask in zip(ids_all, mask_all)])
        self._last_step_losses = losses
        return float(losses.mean())

    def evaluate_split(self, split: str = "valid") -> Tuple[float, float]:
        c = self.corpus
        if split == "valid":
            args = (c.valid_tokens, c.valid_log_mask, c.valid_target, c.valid_history)
        else:
            args = (c.test_tokens, c.test_log_mask, c.test_target, c.test_history)
        return evaluate(self.model, self.model.item_table().detach(), *args,
                        batch_size=self.cfg.eval_batch_size,
                        axis=self.data_axis)
