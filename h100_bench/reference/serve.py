"""The reference of batch top-K: SASRec over each history's last L items,
every catalogue row scored, the history and the pad row excluded.

``score_users`` gives, for a block of users, the float32 scores of every
catalogue row with excluded rows at -inf; ``judge`` reads the program's
answers against them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import model as M


def prepare(histories: List[List[int]], L: int, device):
    """Left-padded last-L tokens and their mask, as the published serving
    path prepares a request."""
    b = len(histories)
    tokens = np.zeros((b, L), np.int64)
    log_mask = np.zeros((b, L), np.float32)
    for i, s in enumerate(histories):
        last = s[-L:]
        tokens[i, L - len(last):] = last
        log_mask[i, L - len(last):] = 1.0
    return (torch.as_tensor(tokens, device=device),
            torch.as_tensor(log_mask, device=device))


@torch.no_grad()
def score_users(W, table: torch.Tensor, histories: List[List[int]], cfg: dict,
                precision: str = "fp32") -> torch.Tensor:
    """(B, N) scores of every row of ``table`` (N, E) for each history, the
    history's items and row 0 at -inf."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        prec = M.Precision(precision)
        tokens, log_mask = prepare(histories, cfg["max_seq_len"], table.device)
        x = table[tokens]
        out = M.user_encoder(W, x, log_mask, cfg["user_encoder"], prec)[:, -1]
        scores = prec.mm(out, table.T)
        for i, s in enumerate(histories):
            scores[i, torch.as_tensor(s, device=table.device)] = float("-inf")
        scores[:, 0] = float("-inf")
        return scores
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def judge(scores: torch.Tensor, ids: np.ndarray, got_scores: np.ndarray):
    """(rank gap, score gap) of one block of answers, each the widest over
    its users and ranks in units of the user's score spread (the standard
    deviation of the scores of the rows it may be shown): how far below the
    reference's j-th best the score of the program's j-th id lies, and how
    far the score the program reports lies from the reference's.  An
    excluded id reads an infinite gap."""
    k = ids.shape[1]
    finite = torch.isfinite(scores)
    spread = torch.where(finite, scores, 0.0)
    n = finite.sum(1, keepdim=True).float()
    mean = spread.sum(1, keepdim=True) / n
    std = (((spread - mean) * finite) ** 2).sum(1, keepdim=True).div(n).sqrt()
    best = torch.topk(scores, k, dim=1).values
    idx = torch.as_tensor(ids, device=scores.device).long()
    theirs = scores.gather(1, idx)
    rank_gap = ((best - theirs) / std).max()
    got = torch.as_tensor(got_scores, device=scores.device).float()
    score_gap = ((got - theirs).abs() / std).max()
    return float(rank_gap), float(score_gap)
