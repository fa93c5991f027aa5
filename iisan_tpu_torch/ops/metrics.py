"""Batched HR@K / nDCG@K ranking metrics on the device.

Port of ``iisan_tpu/ops/metrics.py``: the rank of the single target item is
``1 + #(scores strictly greater than the target's score)``.
"""

from __future__ import annotations

import torch


def hit_ndcg_at_k(scores: torch.Tensor, target: torch.Tensor,
                  k: int = 10) -> torch.Tensor:
    """scores (B, item_num) with the pad column dropped; target (B,) 0-based
    index into the score row.  Returns (B, 2): [hit@k, ndcg@k]."""
    tgt_score = scores.gather(1, target.long()[:, None])
    rank = 1 + (scores > tgt_score).sum(dim=-1)
    hit = (rank <= k).float()
    return torch.stack([hit, hit / torch.log2(rank.float() + 1.0)], dim=-1)


def mask_history(scores: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    """Set scores at each user's history ids (B, H), 0-padded, to -inf.
    Column 0 is the pad item, which the callers drop or mask anyway."""
    return scores.scatter(1, history.long(), float("-inf"))
