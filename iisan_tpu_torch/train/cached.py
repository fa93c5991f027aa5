"""IISAN (Cached) training on one device.

Port of ``iisan_tpu/train/cached.py``.  The two tap tables
``(item_num+1, K, dim)`` live on the device in the compute dtype, so a
training batch is a gather.  An epoch is a Python loop over steps (the JAX
package's ``lax.scan``): gather the batch's taps, run the model's training
forward, ``backward``, one Adam step.  The per-step losses stay on the
device and are fetched once per epoch.

Not ported: int8 tap tables (``cache_quant="int8"``), meshes, the
multi-epoch dispatch (``run_epochs``) and the fused epoch + evaluation
dispatch; the loop runs the epoch and the evaluation one after the other,
which the JAX package's ``fused_epoch_eval=False`` shows to give the same
numbers.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..eval.evaluate import compute_item_tables, evaluate
from ..models.model import rec_model_from_config
from .loop import TrainLoopMixin
from .optim import build_optimizer, log_group_sizes

log = logging.getLogger("iisan_tpu_torch")


class CachedTrainer(TrainLoopMixin):
    """Cached-mode training of ``IISANRecModel``.

    cfg: an ``IISANConfig`` (either package's); corpus: a ``Corpus``
    (either package's); cv_taps / text_taps: (item_num+1, K, dim) arrays
    or tensors.  The model is initialised on the CPU from ``cfg.seed`` and
    moved to ``device`` (default the first CUDA card; the CPU only when
    asked for, ``device="cpu"``); train-mode dropout draws from a CPU
    generator seeded from ``cfg.seed``.
    """

    def __init__(self, cfg, corpus, cv_taps, text_taps, device=None):
        if getattr(cfg, "cache_quant", "none") != "none":
            raise NotImplementedError("int8 tap tables are not ported yet")
        self.cfg, self.corpus = cfg, corpus
        self.device = resolve_device(device)
        # Every id in [0, item_num] must have a row: a leave-one-out
        # target may be an item no training sequence holds.
        need = corpus.item_num + 1
        for name, table in (("cv", cv_taps), ("text", text_taps)):
            if table.shape[0] < need:
                raise ValueError(
                    f"{name} tap table has {table.shape[0]} rows but the "
                    f"behaviors file references {corpus.item_num} items "
                    f"(need {need} rows incl. the pad row); cache and "
                    "behaviors files are out of sync")
        dt = getattr(torch, cfg.compute_dtype)
        self.cv_table = torch.as_tensor(cv_taps).to(self.device, dt)
        self.text_table = torch.as_tensor(text_taps).to(self.device, dt)

        def put(x):
            return torch.as_tensor(np.asarray(x), device=self.device)

        self.pop_prob = put(corpus.pop_prob)
        self.train_seqs = put(corpus.train_seqs).long()
        self.train_log_mask = put(corpus.train_log_mask)

        self.model = rec_model_from_config(
            cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.optimizer = build_optimizer(cfg, self.model)
        log_group_sizes(cfg, self.model)
        self._last_step_losses = None
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("##### trainable_num %d #####", n_params)

    def train_step(self, ids: torch.Tensor, log_mask: torch.Tensor) -> torch.Tensor:
        """One step on a (bs, L+1) id batch; returns the loss (on the
        device, not synchronised)."""
        flat = ids.reshape(-1)
        loss = self.model(ids, self.cv_table[flat], self.text_table[flat],
                          log_mask, self.pop_prob, deterministic=False,
                          generator=self.generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def run_epoch(self, epoch: int) -> float:
        perm = torch.as_tensor(self.epoch_permutation(epoch),
                               device=self.device).long()
        ids_all, mask_all = self.train_seqs[perm], self.train_log_mask[perm]
        losses = torch.stack([self.train_step(ids, mask)
                              for ids, mask in zip(ids_all, mask_all)])
        self._last_step_losses = losses
        return float(losses.mean())

    def fused_item_table(self) -> torch.Tensor:
        return compute_item_tables(self.model, self.cv_table, self.text_table)

    def evaluate_split(self, split: str = "valid") -> Tuple[float, float]:
        c = self.corpus
        if split == "valid":
            args = (c.valid_tokens, c.valid_log_mask, c.valid_target, c.valid_history)
        else:
            args = (c.test_tokens, c.test_log_mask, c.test_target, c.test_history)
        return evaluate(self.model, self.fused_item_table(), *args,
                        batch_size=self.cfg.eval_batch_size)

    def gate_values(self) -> Dict[str, np.ndarray]:
        """The learned fusion gates, sigmoid(theta / 0.1)."""
        out = {}
        for name in ("side_gate_params_text", "side_gate_params_cv",
                     "side_gate_params_mm"):
            p = getattr(self.model.san, name, None)
            if p is not None:
                out[name] = torch.sigmoid(p.detach().float() / 0.1).cpu().numpy()
        return out
