"""Faults planted under the timed path, each of which the check must
catch: the runner hooks (``Cell.hooks``) that stand in for the timed call.

Training (``step``):

- ``unchanged``: the step computes and back-propagates but leaves the
  model and the optimizer as they were;
- ``half_batch``: the step trains on the first half of its users only, the
  loss their mean.

Serving (``call``):

- ``half_batch``: the first half of the users are answered and their
  answers given to the second half too;
- ``answer_altered``: one id of the first user's answer is replaced by
  another catalogue row where it is produced.
"""

from __future__ import annotations

import numpy as np


def unchanged(tr, batch):
    tr.optimizer.step = lambda *args, **kw: None
    return tr.train_step(*batch)


def half_batch(tr, batch):
    ids, images, tokens, log_mask = batch
    h = ids.shape[0] // 2
    n = h * ids.shape[1]
    return tr.train_step(ids[:h], images[:n], tokens[:n], log_mask[:h])


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}


def serve_calls(k: int, hist_len: int) -> dict:
    """The serving faults for answers of ``k`` ids over histories padded
    to ``hist_len``."""

    def top(rec, seqs):
        return rec.top_k(seqs, k=k, exclude_history=True, hist_len=hist_len)

    def half(rec, seqs):
        ids, scores = top(rec, seqs[:len(seqs) // 2])
        return np.concatenate([ids, ids]), np.concatenate([scores, scores])

    def altered(rec, seqs):
        ids, scores = top(rec, seqs)
        ids = ids.copy()
        ids[0, 0] = (int(ids[0, 0]) + rec.n_rows // 2) % (rec.n_rows - 1) + 1
        return ids, scores

    return {"half_batch": half, "answer_altered": altered}
