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

The loss is over the global batch.  Where a ``data`` axis splits the batch
over ranks (``sequence_train_loss``'s ``shard``), a rank scores its own
users' rows against every rank's item embeddings (``all_gather_rows``,
whose backward sums the gradients into each rank's rows), and returns its
rows' share: their CE summed, over the global count of valid rows.  The
shares sum to the one-rank loss, and the parameter gradients, summed over
the axis, to its gradients.
"""

from __future__ import annotations

import torch

from ..parallel.distributed import all_gather_rows
from ..utils.profiling import annotate


def inbatch_ce_loss(prec_vec: torch.Tensor,    # (b, L, D) user-encoder outputs
                    score_embs: torch.Tensor,  # (bs*(L+1), D) item embeddings
                    item_ids: torch.Tensor,    # (bs, L+1) item ids (0 = pad)
                    log_mask: torch.Tensor,    # (bs, L) {0, 1}
                    pop_prob: torch.Tensor,    # (item_num+1,)
                    row_offset: int = 0) -> torch.Tensor:
    """The loss share of the b users ``row_offset ..`` of a batch of bs
    (all of them by default: the loss)."""
    with annotate("iisan.loss"):
        bs, L, d = prec_vec.shape
        n = item_ids.shape[0] * (L + 1)
        device = prec_vec.device
        own_ids = item_ids[row_offset:row_offset + bs]
        flat_ids = item_ids.reshape(-1).long()
        debias = torch.log(pop_prob[flat_ids]).float()

        logits = prec_vec.reshape(bs * L, d).float() @ score_embs.float().T
        logits = logits - debias[None, :]

        ext_mask = torch.cat([log_mask, torch.ones((log_mask.shape[0], 1),
                                                   dtype=log_mask.dtype,
                                                   device=device)], 1).reshape(-1)
        col_pad = ext_mask == 0
        member = (flat_ids[None, None, :] == own_ids.long()[:, :, None]).any(1)
        targets = ((torch.arange(row_offset, row_offset + bs, device=device)
                    * (L + 1))[:, None]
                   + torch.arange(1, L + 1, device=device)[None, :])
        col_idx = torch.arange(n, device=device)
        reject = member[:, None, :] & (col_idx[None, None, :] != targets[:, :, None])
        masked = (col_pad[None, None, :] | reject).reshape(bs * L, n)
        logits = logits.masked_fill(masked, -1e4)

        labels = targets.reshape(-1)
        ce = torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:, 0]
        w = log_mask[row_offset:row_offset + bs].reshape(-1).float()
        w_all = log_mask.reshape(-1).float()
        return (ce * w).sum() / torch.clamp(w_all.sum(), min=1.0)


def sequence_train_loss(user_encoder, score_embs, item_ids, log_mask,
                        pop_prob, max_seq_len: int, embedding_dim: int,
                        deterministic: bool, generator=None, shard=None):
    """Model tail: (b*(L+1), emb) item embeddings -> the user encoder over
    positions [:, :-1] -> debiased in-batch CE in fp32.

    item_ids (bs, L+1) and log_mask (bs, L) are the global batch.  Without
    ``shard`` the embeddings are its rows (b = bs).  With ``shard`` (the
    ``data`` axis, ``parallel.mesh.Axis``) they are this rank's users'
    rows, ``shard.rows(bs)``, and the result is this rank's share."""
    b = score_embs.shape[0] // (max_seq_len + 1)
    rows = shard.rows(log_mask.shape[0]) if shard is not None else slice(0, b)
    all_embs = all_gather_rows(score_embs, shard) if shard is not None \
        else score_embs
    input_embs = score_embs.reshape(b, max_seq_len + 1, embedding_dim)
    prec_vec = user_encoder(input_embs[:, :-1, :], log_mask[rows],
                            deterministic, generator)
    return inbatch_ce_loss(prec_vec.float(), all_embs.float(), item_ids,
                           log_mask, pop_prob, rows.start)
