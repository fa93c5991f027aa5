"""In-batch popularity-debiased sampled-softmax cross-entropy loss.

Port of ``iisan_tpu/ops/losses.py``; plain PyTorch, as XLA (not a Pallas
kernel) computes it in the JAX package:

- scores = prec_vec @ score_embs.T over all bs*(L+1) in-batch items, minus
  log(pop_prob[item_id]) (the popularity debias);
- columns whose extended log-mask (log_mask plus an appended ones column)
  is 0 are filled with -1e4;
- for row-user i, every column whose item id occurs anywhere in user i's
  padded id list is filled with -1e4, except the true next-item target
  column i*(L+1)+j+1, which is re-allowed;
- the label of row (i, j) is its target column; the loss is the mean CE
  over rows where log_mask != 0, in fp32.
"""

from __future__ import annotations

import torch


def inbatch_ce_loss(prec_vec: torch.Tensor,    # (bs, L, D) user-encoder outputs
                    score_embs: torch.Tensor,  # (bs*(L+1), D) item embeddings
                    item_ids: torch.Tensor,    # (bs, L+1) item ids (0 = pad)
                    log_mask: torch.Tensor,    # (bs, L) {0, 1}
                    pop_prob: torch.Tensor     # (item_num+1,)
                    ) -> torch.Tensor:
    bs, L, d = prec_vec.shape
    n = bs * (L + 1)
    device = prec_vec.device
    flat_ids = item_ids.reshape(-1).long()
    debias = torch.log(pop_prob[flat_ids]).float()

    logits = prec_vec.reshape(bs * L, d).float() @ score_embs.float().T
    logits = logits - debias[None, :]

    ext_mask = torch.cat([log_mask, torch.ones((bs, 1), dtype=log_mask.dtype,
                                               device=device)], 1).reshape(-1)
    col_pad = ext_mask == 0
    member = (flat_ids[None, None, :] == item_ids.long()[:, :, None]).any(1)
    targets = ((torch.arange(bs, device=device) * (L + 1))[:, None]
               + torch.arange(1, L + 1, device=device)[None, :])
    col_idx = torch.arange(n, device=device)
    reject = member[:, None, :] & (col_idx[None, None, :] != targets[:, :, None])
    masked = (col_pad[None, None, :] | reject).reshape(bs * L, n)
    logits = logits.masked_fill(masked, -1e4)

    labels = targets.reshape(-1)
    ce = torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:, 0]
    w = log_mask.reshape(-1).float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def sequence_train_loss(user_encoder, score_embs, item_ids, log_mask,
                        pop_prob, max_seq_len: int, embedding_dim: int,
                        deterministic: bool, generator=None):
    """Model tail: (bs*(L+1), emb) item embeddings -> the user encoder over
    positions [:, :-1] -> debiased in-batch CE in fp32."""
    bs = log_mask.shape[0]
    input_embs = score_embs.reshape(bs, max_seq_len + 1, embedding_dim)
    prec_vec = user_encoder(input_embs[:, :-1, :], log_mask, deterministic,
                            generator)
    return inbatch_ce_loss(prec_vec.float(), score_embs.float(), item_ids,
                           log_mask, pop_prob)
