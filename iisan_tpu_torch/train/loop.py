"""Shared training loop: epochs, validation, early stop, test-on-best.

Port of ``iisan_tpu/train/loop.py``: per-epoch validation with early-stop
patience (``early_stop_count > early_stop_patience``), a NaN-loss abort,
a test-set evaluation on a new best or every 10th epoch, and the per-step
loss lines.  Checkpoints are not ported yet: ``save_checkpoints=True`` and
``resume`` raise.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

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
    """Requires: self.cfg, self.corpus, self.device, self.run_epoch(epoch)
    -> loss, self.evaluate_split(split) -> (hit, ndcg)."""

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
        if save_checkpoints:
            raise NotImplementedError("checkpoints are not ported yet")
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
            log.info("##### (time) eval(valid and test): %.1f seconds #####",
                     time.time() - eval_t0)
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
        log.info("max eval Hit10 %.5f in epoch %d (total %.1fs)",
                 res.best_hit10 * 100, res.best_epoch, time.time() - start)
        return res

    def resume(self, ckpt_name: str) -> int:
        raise NotImplementedError("checkpoints are not ported yet")
