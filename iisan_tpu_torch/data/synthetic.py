"""Synthetic corpora: random interaction sequences with the layout of the
JAX package's ``iisan_tpu/data/synthetic.py``, array for array from the
same seed, so both packages train on the same batches."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Corpus:
    """What the trainer and the evaluation read, as dense arrays (the
    fields of ``iisan_tpu.data.preprocess.Corpus``)."""

    item_num: int
    max_seq_len: int
    item_names: List[str]
    train_seqs: np.ndarray      # (n_users, L+1) int32, left-padded with 0
    train_log_mask: np.ndarray  # (n_users, L) float32
    valid_tokens: np.ndarray    # (n_users, L) int32
    valid_log_mask: np.ndarray  # (n_users, L) float32
    valid_target: np.ndarray    # (n_users,) int32, 1-based item id
    valid_history: np.ndarray   # (n_users, L+2) int32, 0-padded
    test_tokens: np.ndarray
    test_log_mask: np.ndarray
    test_target: np.ndarray
    test_history: np.ndarray
    pop_prob: np.ndarray        # (item_num+1,) float32, pop_prob[0] = 1

    @property
    def n_users(self) -> int:
        return self.train_seqs.shape[0]


def synthetic_corpus(n_users: int = 64, item_num: int = 200,
                     max_seq_len: int = 10, min_seq_len: int = 5,
                     seed: int = 0) -> Corpus:
    """Sequences of min_seq_len..L+3 uniform items per user, split
    leave-one-out: train on all but the last two, validate on the
    second-to-last, test on the last."""
    rng = np.random.default_rng(seed)
    L = max_seq_len
    train_seqs = np.zeros((n_users, L + 1), np.int32)
    train_log_mask = np.zeros((n_users, L), np.float32)
    split = {name: (np.zeros((n_users, L), np.int32),
                    np.zeros((n_users, L), np.float32),
                    np.zeros(n_users, np.int32),
                    np.zeros((n_users, L + 2), np.int32))
             for name in ("valid", "test")}
    counts = np.zeros(item_num + 1, np.int64)
    for u in range(n_users):
        n = int(rng.integers(min_seq_len, L + 4))
        seq = rng.integers(1, item_num + 1, size=n)
        train = seq[:-2]
        t = train[-(L + 1):]
        train_seqs[u, L + 1 - len(t):] = t
        train_log_mask[u, L - (len(t) - 1):] = 1.0
        np.add.at(counts, train, 1)
        for name, window, history in (("valid", seq[-(L + 2):-1], train),
                                      ("test", seq[-(L + 1):], seq[:-1])):
            tokens, log_mask, target, hist = split[name]
            head = window[:-1]
            tokens[u, L - len(head):] = head
            log_mask[u, L - len(head):] = 1.0
            target[u] = window[-1]
            hist[u, :len(history)] = history
    pop = np.maximum(counts[1:], 1).astype(np.float64)
    pop = pop / pop.sum()
    pop_prob = np.concatenate([[1.0], pop]).astype(np.float32)
    (vt, vm, vg, vh), (tt, tm, tg, th) = split["valid"], split["test"]
    return Corpus(
        item_num=item_num, max_seq_len=L,
        item_names=["<pad>"] + [f"item{i}" for i in range(1, item_num + 1)],
        train_seqs=train_seqs, train_log_mask=train_log_mask,
        valid_tokens=vt, valid_log_mask=vm, valid_target=vg, valid_history=vh,
        test_tokens=tt, test_log_mask=tm, test_target=tg, test_history=th,
        pop_prob=pop_prob)
