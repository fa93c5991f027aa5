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
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.metrics import hit_ndcg_at_k, mask_history
from ..ops.quant import gather_rows, n_rows


@torch.no_grad()
def compute_item_tables(model, cv_taps, text_taps,
                        chunk: int = 8192) -> torch.Tensor:
    """Chunked SAN + ``com_dense`` pass over the catalogue.

    cv_taps/text_taps: (item_num+1, K, dim) tensors or ``QuantTaps``; each
    chunk of ids is gathered (and dequantised) on its own, so the working
    set is one chunk.  Returns the fused (item_num+1, emb) table in the
    compute dtype.
    """
    outs = []
    for start in range(0, n_rows(cv_taps), chunk):
        ids = slice(start, start + chunk)
        emb = model.item_embeddings(gather_rows(cv_taps, ids),
                                    gather_rows(text_taps, ids))
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
             batch_size: int = 256) -> Tuple[float, float]:
    """Mean HR@10 / nDCG@10 over all users; the index arrays are host
    arrays, moved to the table's device."""
    (tokens, log_mask, target, history), n = stack_eval_batches(
        (tokens, log_mask, target, history), batch_size, fused_table.device)
    table32 = fused_table.float()
    out = torch.cat([
        _eval_step(model, fused_table, table32, tokens[s], log_mask[s],
                   target[s], history[s])
        for s in range(tokens.shape[0])])
    hit, ndcg = out[:n].mean(dim=0).tolist()
    return hit, ndcg
