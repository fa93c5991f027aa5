"""IISAN (Cached) training on one device or a mesh of ranks.

Port of ``iisan_tpu/train/cached.py``, for ``pipeline="cached"`` and
IISAN-Versa's ``"cached_asym"``.  The two tap tables ``(item_num+1, K,
dim)`` live on the device, in the compute dtype or, with
``cache_quant="int8"`` (or ``QuantTaps`` from an int8 store), as int8 rows
with one fp32 scale per (item, tap) row; a training batch is a gather
(``ops/quant.gather_rows``, which dequantises).  An epoch is a Python loop
over steps (the JAX package's ``lax.scan``): gather the batch's taps, run
the model's training forward, ``backward``, one Adam step.  The per-step
losses stay on the device and are fetched once per epoch.

On a mesh (``cfg.mesh_shape`` over the ranks of ``torch.distributed``,
``parallel/mesh.py``) every rank holds the model and the optimizer:

- the ``data`` axis splits each step's users (``Axis.rows``; replicated
  where the batch does not divide it); the loss stays the global batch's
  (``ops/losses.py``) and the gradients are summed over the axis;
- the ``model`` axis splits the tap tables along the feature dim, as the
  JAX package's ``P(None, None, "model")``; an int8 table's ``q`` takes the
  split and its scales are whole on every rank.  A step gathers its rows
  from the local columns and all-gathers the columns over the axis, so the
  SAN runs on whole rows, as on one device, and the tables' memory stays
  split.  The item table is built the same way, chunk by chunk.

Not ported: the multi-epoch dispatch (``run_epochs``) and the fused epoch
+ evaluation dispatch; the loop runs the epoch and the evaluation one
after the other, which the JAX package's ``fused_epoch_eval=False`` shows
to give the same numbers.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..eval.evaluate import compute_item_tables, evaluate
from ..models.model import rec_model_from_config
from ..ops.quant import QuantTaps, gather_rows, quantize_taps
from ..parallel.distributed import all_gather_columns
from .loop import TrainLoopMixin
from .optim import build_optimizer, log_group_sizes

log = logging.getLogger("iisan_tpu_torch")


class CachedTrainer(TrainLoopMixin):
    """Cached-mode training of ``IISANRecModel``.

    cfg: an ``IISANConfig`` (either package's); corpus: a ``Corpus``
    (either package's); cv_taps / text_taps: (item_num+1, K, dim) arrays,
    tensors or ``QuantTaps``.  The model is initialised on the CPU from
    ``cfg.seed`` and moved to ``device`` (default the first CUDA card; the
    CPU only when asked for, ``device="cpu"``); train-mode dropout draws
    from a CPU generator seeded from ``cfg.seed`` (per data rank:
    ``TrainLoopMixin.dropout_seed``).  ``mesh``: a ``parallel.mesh.Mesh``,
    default ``make_mesh(cfg.mesh_shape)``.
    """

    def __init__(self, cfg, corpus, cv_taps, text_taps, device=None,
                 mesh=None):
        self.cfg, self.corpus = cfg, corpus
        self.device = resolve_device(device)
        self._init_mesh(mesh)
        self.model_axis = self.mesh.axis("model")
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
        self.cv_table = self._put_table(cv_taps)
        self.text_table = self._put_table(text_taps)

        def put(x):
            return torch.as_tensor(np.asarray(x), device=self.device)

        self.pop_prob = put(corpus.pop_prob)
        self.train_seqs = put(corpus.train_seqs).long()
        self.train_log_mask = put(corpus.train_log_mask)

        self.model = rec_model_from_config(
            cfg, generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self._replicate()
        self.generator = torch.Generator().manual_seed(self.dropout_seed())
        self.optimizer = build_optimizer(cfg, self.model)
        log_group_sizes(cfg, self.model)
        self._last_step_losses = None
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("##### trainable_num %d #####", n_params)
        if cfg.pipeline == "cached_asym":  # the initial learned gates
            for name, vals in self.gate_values().items():
                log.info("%s: %s", name, np.round(vals, 4).tolist())

    def _put_table(self, taps):
        """A tap table on the device per ``cfg.cache_quant``: "none" keeps
        it in the compute dtype, "int8" quantises it (on the table's own
        device).  ``QuantTaps`` (an int8 store's ``load_taps``) is used as
        it is, relabelled to the compute dtype, whatever cache_quant says.
        On a ``model`` axis only this rank's feature columns move to the
        device (an int8 table's scales whole)."""
        quant = getattr(self.cfg, "cache_quant", "none")
        if quant not in ("none", "int8"):
            raise ValueError(f"unsupported cache_quant={quant!r} "
                             "(expected 'none' or 'int8')")
        name = self.cfg.compute_dtype
        if not isinstance(taps, QuantTaps) and quant == "int8":
            taps = quantize_taps(taps, out_dtype=name)
        cols = self.model_axis.columns(taps.shape[-1])
        if isinstance(taps, QuantTaps):
            return QuantTaps(taps.q[..., cols], taps.scale,
                             taps.out_dtype).to(self.device, out_dtype=name)
        return torch.as_tensor(taps)[..., cols].to(self.device,
                                                   getattr(torch, name))

    def tap_rows(self, table, ids) -> torch.Tensor:
        """Whole rows ``ids`` of a tap table in the compute dtype: gathered
        (and dequantised) from this rank's columns, then all-gathered over
        the ``model`` axis."""
        return all_gather_columns(gather_rows(table, ids), self.model_axis)

    def train_step(self, ids: torch.Tensor, log_mask: torch.Tensor) -> torch.Tensor:
        """One step on a (bs, L+1) id batch (on a ``data`` axis, every
        rank passes the whole batch and computes its own users); returns
        the loss, this rank's share on a split batch (on the device, not
        synchronised)."""
        flat = ids[self.batch_rows(ids.shape[0])].reshape(-1)
        loss = self.model(ids, self.tap_rows(self.cv_table, flat),
                          self.tap_rows(self.text_table, flat), log_mask,
                          self.pop_prob, deterministic=False,
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

    def fused_item_table(self) -> torch.Tensor:
        return compute_item_tables(self.model, self.cv_table, self.text_table,
                                   rows=self.tap_rows)

    def evaluate_split(self, split: str = "valid") -> Tuple[float, float]:
        c = self.corpus
        if split == "valid":
            args = (c.valid_tokens, c.valid_log_mask, c.valid_target, c.valid_history)
        else:
            args = (c.test_tokens, c.test_log_mask, c.test_target, c.test_history)
        return evaluate(self.model, self.fused_item_table(), *args,
                        batch_size=self.cfg.eval_batch_size,
                        axis=self.data_axis)

    def gate_values(self) -> Dict[str, np.ndarray]:
        """The learned fusion gates, sigmoid(theta / 0.1)."""
        out = {}
        for name in ("side_gate_params_text", "side_gate_params_cv",
                     "side_gate_params_mm"):
            p = getattr(self.model.san, name, None)
            if p is not None:
                out[name] = torch.sigmoid(p.detach().float() / 0.1).cpu().numpy()
        return out
