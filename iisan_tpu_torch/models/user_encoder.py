"""SASRec user encoder: a causal post-LN transformer over item embeddings.

Port of ``iisan_tpu/models/user_encoder.py``.  The additive attention mask
is 0 where (key <= query and log_mask[key] != 0) and -1e9 elsewhere.

Dispatch: unless ``fused`` is False, a CUDA input runs the fused forward
kernel over the same parameters, and a shape the kernel does not take
(``fused_user_encoder.supported``) raises there; there is no fallback on
the card.  A CPU input, or ``fused=False``, runs the module path, the
semantic reference, as the JAX module does off the TPU.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import fused_user_encoder as fue
from .modules import TransformerEncoder


def causal_additive_mask(log_mask: torch.Tensor) -> torch.Tensor:
    """(bs, L) log_mask -> (bs, 1, L, L) fp32 additive mask of {0, -1e9}."""
    l = log_mask.shape[-1]
    key_ok = (log_mask != 0)[:, None, None, :]
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=log_mask.device))[None, None]
    zero = torch.zeros((), dtype=torch.float32, device=log_mask.device)
    return torch.where(key_ok & causal, zero, zero - 1e9)


class UserEncoder(nn.Module):
    """TransformerEncoder under a causal mask (``transformer_encoder``)."""

    def __init__(self, d_model: int, max_seq_len: int,
                 num_attention_heads: int, n_layers: int, dropout: float,
                 dtype: Optional[torch.dtype] = None,
                 fused: Optional[bool] = None, device=None, generator=None):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.num_attention_heads = num_attention_heads
        self.n_layers = n_layers
        self.dropout = dropout
        self.dtype = dtype
        self.fused = fused
        self.transformer_encoder = TransformerEncoder(
            d_model, max_seq_len, num_attention_heads, n_layers, dropout,
            dtype, device, generator)
        self._packed = None  # (dtype and parameter versions, packed params)

    def packed_params(self, compute_dtype: torch.dtype) -> torch.Tensor:
        """The kernel's packed parameter vector for ``compute_dtype``,
        rebuilt when a parameter changes."""
        flat = fue.flatten_encoder_params(self.transformer_encoder,
                                          self.n_layers)
        key = (compute_dtype,) + tuple((p.data_ptr(), p._version) for p in flat)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, fue.pack_encoder_params(flat, compute_dtype))
        return self._packed[1]

    def forward(self, input_embs, log_mask, deterministic: bool = True):
        mask = causal_additive_mask(log_mask)
        if self._use_fused(input_embs):
            if not deterministic and self.dropout > 0.0:
                raise NotImplementedError(
                    "the fused user-encoder kernel is eval-mode only; pass "
                    "fused=False for train-mode dropout")
            dt = self.dtype or input_embs.dtype
            out = fue.apply_fused_encoder(
                self.packed_params(dt), input_embs, mask,
                n_layers=self.n_layers, n_heads=self.num_attention_heads,
                d_ff=4 * input_embs.shape[-1], n_position=self.max_seq_len,
                compute_dtype=dt)
            return out.to(dt)
        return self.transformer_encoder(input_embs, mask, deterministic)

    def _use_fused(self, x) -> bool:
        return self.fused is not False and x.is_cuda
