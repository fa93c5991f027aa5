"""Full-catalogue item table and ranking evaluation on the device.

Port of ``iisan_tpu/eval/evaluate.py``:

1. ``compute_item_tables`` runs the SAN and ``com_dense`` over the
   catalogue in chunks and returns the fused (item_num+1, emb) table;
2. ``evaluate`` gathers each user batch's sequence rows from that table,
   runs the user encoder, scores the full catalogue as one (B, items)
   product, masks each user's history to -inf, drops the pad column and
   takes HR@10 / nDCG@10.

The tap tables are expected on the device, in the compute dtype or as
int8 ``QuantTaps`` (``ops/quant.py``), which are dequantised one chunk of
ids at a time.

On a mesh, ``evaluate``'s ``axis`` (the ``data`` axis) splits each eval
batch's users over its ranks when the batch divides it (the JAX package's
``eval_sharding``; replicated otherwise); the per-user metrics are
all-gathered in user order and the wrap-padded rows cropped before the
mean, as the reference's ``eval_concat`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.metrics import hit_ndcg_at_k, mask_history
from ..ops.quant import gather_rows, n_rows
from ..parallel.distributed import all_gather_rows


@torch.no_grad()
def compute_item_tables(model, cv_taps, text_taps, chunk: int = 8192,
                        rows=gather_rows) -> torch.Tensor:
    """Chunked SAN + ``com_dense`` pass over the catalogue.

    cv_taps/text_taps: (item_num+1, K, dim) tensors or ``QuantTaps``; each
    chunk of ids is gathered (and dequantised) on its own by ``rows(table,
    ids)`` (a feature-sharded trainer passes its own), so the working set
    is one chunk.  Returns the fused (item_num+1, emb) table in the
    compute dtype.
    """
    outs = []
    for start in range(0, n_rows(cv_taps), chunk):
        ids = slice(start, start + chunk)
        emb = model.item_embeddings(rows(cv_taps, ids), rows(text_taps, ids))
        outs.append(model.fuse_embeddings(*emb))
    return torch.cat(outs)


def stack_eval_batches(arrays, batch_size: int, device=None):
    """Wrap-pad to whole batches (repeat the last row) and stack to
    (S, B, ...) tensors on ``device``.  Returns (tensors, n_real_rows)."""
    n = arrays[0].shape[0]
    n_pad = -(-n // batch_size) * batch_size

    def prep(x):
        x = np.asarray(x)
        if n_pad > n:
            x = np.concatenate([x, np.repeat(x[-1:], n_pad - n, axis=0)])
        x = x.reshape(n_pad // batch_size, batch_size, *x.shape[1:])
        return torch.as_tensor(x, device=device)

    return tuple(prep(x) for x in arrays), n


def _eval_step(model, fused_table, table32, tokens, log_mask, target,
               history) -> torch.Tensor:
    """One user batch -> (B, 2) [hit@10, ndcg@10]."""
    input_embs = fused_table[tokens.long()]                    # (B, L, emb)
    prec = model.user_scores(input_embs, log_mask)[:, -1, :]   # (B, emb)
    scores = prec.float() @ table32.T                          # (B, items+1)
    scores = mask_history(scores, history)[:, 1:]              # drop pad col
    return hit_ndcg_at_k(scores, target.long() - 1, k=10)


@torch.no_grad()
def evaluate(model, fused_table, tokens, log_mask, target, history,
             batch_size: int = 256, axis=None) -> Tuple[float, float]:
    """Mean HR@10 / nDCG@10 over all users; the index arrays are host
    arrays, moved to the table's device.  ``axis`` (a
    ``parallel.mesh.Axis``) splits each batch's users over its ranks, where
    the batch divides it."""
    (tokens, log_mask, target, history), n = stack_eval_batches(
        (tokens, log_mask, target, history), batch_size, fused_table.device)
    rows = axis.rows(batch_size) if axis is not None else slice(None)
    table32 = fused_table.float()
    out = torch.stack([
        _eval_step(model, fused_table, table32, tokens[s, rows],
                   log_mask[s, rows], target[s, rows], history[s, rows])
        for s in range(tokens.shape[0])])                      # (S, b, 2)
    if axis is not None and axis.splits(batch_size):
        out = all_gather_rows(out, axis).reshape(axis.size, *out.shape)
        out = out.transpose(0, 1)                              # (S, ranks, b, 2)
    hit, ndcg = out.reshape(-1, 2)[:n].mean(dim=0).tolist()
    return hit, ndcg
