"""Shared training loop: epochs, validation, early stop, test-on-best.

Port of ``iisan_tpu/train/loop.py``: per-epoch validation with early-stop
patience (``early_stop_count > early_stop_patience``), a NaN-loss abort,
a test-set evaluation on a new best or every 10th epoch, then a
checkpoint there with ``save_checkpoints`` (``utils/checkpoint.py``: the
model, the optimizer, the dropout generator and the epoch), and the
per-step loss lines.  ``resume`` loads such a checkpoint and returns its
epoch; training on from it runs what the uninterrupted run would have run.

On a mesh of ranks (``_init_mesh``) every rank trains and evaluates; only
rank 0 writes the checkpoint, with a barrier after it, and every rank
resumes from the same file, so all hold the same state.  A checkpoint of a
split batch also holds each data rank's dropout generator
(``generators``).
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.distributed import (all_reduce_grads, all_reduce_sum, barrier,
                                    broadcast_, is_main, rank_seed)
from ..parallel.mesh import make_mesh
from ..utils import checkpoint as ckpt_lib
from ..utils.profiling import report_time_eval

log = logging.getLogger("iisan_tpu_torch")


@dataclass
class TrainResult:
    best_hit10: float
    best_ndcg10: float
    best_epoch: int
    epochs_run: int
    epoch_times: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    valid_history: list = field(default_factory=list)
    # The last test evaluation run (the reference's literal behaviour: the
    # every-10th-epoch rule can overwrite it after the best epoch).
    test_metrics: Optional[Tuple[float, float]] = None
    # The test evaluation taken at the best-valid epoch.
    best_test_metrics: Optional[Tuple[float, float]] = None


class TrainLoopMixin:
    """Requires: self.cfg, self.corpus, self.device, self.model,
    self.optimizer, self.generator (the dropout generator),
    self.run_epoch(epoch) -> loss, self.evaluate_split(split) -> (hit,
    ndcg)."""

    def _init_mesh(self, mesh=None) -> None:
        """The run's mesh (``make_mesh(cfg.mesh_shape)`` unless given),
        ``data_axis``, and ``shard``: the data axis where it splits a
        step's batch (``Axis.splits``), else None (one rank, or every data
        rank computing the whole batch)."""
        self.mesh = mesh if mesh is not None else make_mesh(
            getattr(self.cfg, "mesh_shape", ""))
        self.data_axis = self.mesh.axis("data")
        self.shard = (self.data_axis if self.data_axis.splits(self.cfg.batch_size)
                      else None)

    def dropout_seed(self) -> int:
        """The seed of this rank's dropout generator: ``cfg.seed``, or per
        data rank on a split batch (``rank_seed``)."""
        index = self.data_axis.index if self.shard is not None else 0
        return rank_seed(self.cfg.seed, index)

    def batch_rows(self, bs: int) -> slice:
        """This rank's users of a step's batch of bs."""
        return self.shard.rows(bs) if self.shard is not None else slice(0, bs)

    def _replicate(self) -> None:
        """Every rank takes rank 0's parameters and buffers."""
        broadcast_(self.model.state_dict().values())

    def reduce_gradients(self) -> None:
        """Sum the gradients over the data axis of a split batch (each
        rank's are those of its share of the loss)."""
        if self.shard is not None:
            all_reduce_grads(self.model.parameters(), self.shard)

    def epoch_losses(self, losses) -> torch.Tensor:
        """The epoch's per-step losses: each rank's shares summed over the
        data axis of a split batch."""
        losses = torch.stack(losses)
        if self.shard is not None:
            all_reduce_sum(losses, self.shard)
        return losses

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        """Shuffled user indices wrapped to whole batches, (steps, batch)
        int32: the JAX trainers' permutation, number for number."""
        n = self.corpus.n_users
        bs = self.cfg.batch_size
        rng = np.random.default_rng(self.cfg.seed + epoch)
        perm = rng.permutation(n)
        n_pad = ((n + bs - 1) // bs) * bs
        perm = np.resize(perm, n_pad)  # cyclic wrap, handles bs > n_users
        return perm.reshape(-1, bs).astype(np.int32)

    def _sync(self) -> None:
        """Wait for the device, so an epoch's time covers its work."""
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log_step_losses(self, epoch: int) -> None:
        """Intra-epoch 'cnt / Ed / batch loss / sum loss' lines at
        ``logging_num`` intervals, from the epoch's per-step losses."""
        losses = getattr(self, "_last_step_losses", None)
        if losses is None:
            return
        losses = np.asarray(torch.as_tensor(losses).float().cpu())
        n = len(losses)
        interval = max(n // max(self.cfg.logging_num, 1), 1)
        csum = np.cumsum(losses)
        for i in range(interval - 1, n, interval):
            log.info("cnt: %d, Ed: %d, batch loss: %.5f, sum loss: %.5f",
                     i + 1, (i + 1) * self.cfg.batch_size,
                     csum[i] / (i + 1), csum[i])

    def train(self, save_checkpoints: bool = False,
              start_epoch: int = 0) -> TrainResult:
        cfg = self.cfg
        res = TrainResult(0.0, 0.0, 0, 0)
        max_hit10, early_stop_count = 0.0, 0
        start = time.time()
        for ep in range(cfg.epoch):
            now_epoch = start_epoch + ep + 1
            t0 = time.time()
            loss = self.run_epoch(now_epoch)
            self._sync()
            epoch_time = time.time() - t0
            res.epoch_times.append(epoch_time)
            res.losses.append(loss)
            if math.isnan(loss):
                log.warning("NaN loss at epoch %d - stopping", now_epoch)
                break
            self._log_step_losses(now_epoch)
            eval_t0 = time.time()
            hit, ndcg = self.evaluate_split("valid")
            report_time_eval(eval_t0)
            log.info("epoch %d loss %.5f valid Hit10 %.5f nDCG10 %.5f (%.2fs)",
                     now_epoch, loss, hit * 100, ndcg * 100, epoch_time)
            res.epochs_run = now_epoch
            res.valid_history.append((float(hit), float(ndcg)))
            new_best = hit > res.best_hit10
            if new_best:
                res.best_hit10, res.best_ndcg10 = hit, ndcg
                res.best_epoch = now_epoch
                early_stop_count = 0
            else:
                early_stop_count += 1
                if early_stop_count > cfg.early_stop_patience:
                    log.info("early stop at epoch %d", now_epoch)
                    break
            if hit > max_hit10 or max_hit10 == 0 or ep % 10 == 0:
                max_hit10 = max(max_hit10, hit)
                res.test_metrics = self.evaluate_split("test")
                if new_best:
                    res.best_test_metrics = res.test_metrics
                log.info("test Hit10 %.5f nDCG10 %.5f",
                         res.test_metrics[0] * 100, res.test_metrics[1] * 100)
                if save_checkpoints:
                    state = self.checkpoint_state(now_epoch)
                    if is_main():
                        ckpt_lib.save_checkpoint(cfg.ckpt_dir, now_epoch, state)
                    barrier()
        log.info("max eval Hit10 %.5f in epoch %d (total %.1fs)",
                 res.best_hit10 * 100, res.best_epoch, time.time() - start)
        return res

    def checkpoint_state(self, epoch: int) -> dict:
        """What a checkpoint holds (``utils/checkpoint.py``); on a split
        batch also every data rank's generator state, in axis order (every
        rank calls this)."""
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "generator": self.generator.get_state(), "epoch": epoch}
        if self.shard is not None:
            gens = [None] * self.shard.size
            torch.distributed.all_gather_object(
                gens, self.generator.get_state(), group=self.shard.group)
            state["generators"] = gens
        return state

    def resume(self, ckpt_name: str) -> int:
        """Load the model, the optimizer and the generator from
        ``<cfg.ckpt_dir>/<ckpt_name>`` (on every rank; a data rank takes
        its own generator where the checkpoint holds one for it, and
        re-seeds from ``dropout_seed`` otherwise); returns the epoch to go
        on from."""
        state, epoch = ckpt_lib.restore_checkpoint(self.cfg.ckpt_dir,
                                                   ckpt_name)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        index = self.data_axis.index if self.shard is not None else 0
        gens = state.get("generators") or [state["generator"]]
        if index < len(gens):
            self.generator.set_state(gens[index])
        else:
            log.warning("%s holds no dropout generator for data rank %d: "
                        "re-seeded", ckpt_name, index)
            self.generator.manual_seed(self.dropout_seed())
        return epoch
