"""ViT encoder with per-layer hidden-state taps.

Port of ``iisan_tpu/models/vit.py`` (ViT-base/16 by default): patchify as
a reshape and one dense layer on a (p*p*3, D) kernel, channels last,
``(B, n, p, n, p, 3) -> (B, n*n, p*p*3)`` (not a convolution, so the JAX
weights carry across unchanged); a CLS token, then position embeddings;
pre-LN blocks (LN -> attention -> dense -> dropout -> residual, LN ->
intermediate -> exact GELU -> dense -> dropout -> residual); a final fp32
LayerNorm on the last hidden state only.  The hidden stack holds the raw
(pre-final-LN) block outputs, embeddings first, as HF's
``hidden_states``.  Attention dispatches as in ``models/bert.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bert import LN_EPS, SelfAttention, attention_seed, dense
from .modules import LayerNorm, _dropout


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_dim: int, dtype,
                 dropout: float, fused: bool, device=None, generator=None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.layernorm_before = LayerNorm(dim, LN_EPS, device)
        self.attention = SelfAttention(dim, num_heads, dtype, dropout, fused,
                                       device, generator)
        self.attention_output = dense(dim, dim, dtype, device, generator)
        self.layernorm_after = LayerNorm(dim, LN_EPS, device)
        self.intermediate = dense(dim, intermediate_dim, dtype, device, generator)
        self.output = dense(intermediate_dim, dim, dtype, device, generator)

    def forward(self, x, deterministic: bool = True, generator=None,
                seed: Optional[int] = None, layer: int = 0):
        dt = self.dtype or x.dtype
        h = self.layernorm_before(x.float()).to(dt)
        h = self.attention(h, None, deterministic, generator, seed, layer)
        h = _dropout(self.attention_output(h), self.dropout, deterministic,
                     generator)
        x = x + h
        h = self.layernorm_after(x.float()).to(dt)
        h = F.gelu(self.intermediate(h))
        h = _dropout(self.output(h), self.dropout, deterministic, generator)
        return x + h


class ViTEncoder(nn.Module):
    """``forward(images)`` on (B, H, W, 3) channels-last images, already
    normalised, returns (final-LN last hidden (B, 1+n*n, D), hidden stack
    (layers+1, B, 1+n*n, D) with ``collect="full"`` or the CLS rows
    (layers+1, B, D) with ``"cls"``)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 hidden_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_dim: int = 3072,
                 dtype=None, dropout: float = 0.0,
                 fused_attention: bool = False, collect: str = "full",
                 device=None, generator=None):
        super().__init__()
        if collect not in ("full", "cls"):
            raise ValueError(f"collect must be 'full' or 'cls', got {collect!r}")
        self.image_size, self.patch_size = image_size, patch_size
        self.num_layers, self.dtype, self.dropout = num_layers, dtype, dropout
        self.fused, self.collect = fused_attention, collect
        n = image_size // patch_size
        self.patch_projection = dense(patch_size * patch_size * 3, hidden_dim,
                                      dtype, device, generator)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, hidden_dim),
                                                  device=device))
        pos = torch.empty((1, n * n + 1, hidden_dim), device=device)
        self.position_embeddings = nn.Parameter(
            nn.init.normal_(pos, 0.0, 0.02, generator=generator))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ViTBlock(
                hidden_dim, num_heads, intermediate_dim, dtype, dropout,
                fused_attention, device, generator))
        self.final_layernorm = LayerNorm(hidden_dim, LN_EPS, device)

    def forward(self, images, deterministic: bool = True, generator=None):
        dt = self.dtype or torch.float32
        b, p = images.shape[0], self.patch_size
        n = self.image_size // p
        x = images.to(dt).reshape(b, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_projection(x.reshape(b, n * n, p * p * 3))
        cls = self.cls_token.to(dt).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], 1) + self.position_embeddings.to(dt)
        x = _dropout(x, self.dropout, deterministic, generator)
        seed = attention_seed(self, x, deterministic, generator)
        reduce = (lambda h: h[:, 0, :]) if self.collect == "cls" else (lambda h: h)
        hiddens = [reduce(x)]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, deterministic, generator, seed, i)
            hiddens.append(reduce(x))
        last = self.final_layernorm(x.float()).to(dt)
        return last, torch.stack(hiddens, 0)
