"""Core layers of the port: linears, LayerNorm and the post-LN transformer.

Torch counterparts of ``iisan_tpu/models/modules.py``.  Parameters live in
fp32 and activations run in ``dtype`` (the compute dtype, bf16 by default);
LayerNorm and softmax statistics are fp32, following the JAX cast chain.

Parameter names are the JAX tree's own (``kernel``, ``bias``, ``scale``,
``position_embedding``, ``transformer_blocks_{i}``), so the weight bridge
(utils/jax_params.py) maps a JAX leaf path to a torch parameter name by
joining with dots.  A linear's ``kernel`` keeps the JAX layout
``(in_features, out_features)``: ``y = x @ kernel + bias``.

Initialisers follow the JAX ones: torch-default uniform for
``TorchLinear``, truncated xavier-normal (JAX's ``glorot_normal``) for
``XavierLinear`` and the position table, N(0, 1e-2) for adapter weights and
zeros for adapter biases and gates.  They draw from an explicit
``torch.Generator``; the numbers differ from JAX's, and the tests carry JAX
weights across instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
# JAX's truncated normal is cut at +-2 std; this factor restores the variance.
_TRUNC_STD = 0.87962566103423978


def uniform_init(shape, bound: float, device=None, generator=None) -> torch.Tensor:
    t = torch.empty(shape, device=device)
    return nn.init.uniform_(t, -bound, bound, generator=generator)


def xavier_normal_init(shape, device=None, generator=None) -> torch.Tensor:
    """JAX ``xavier_normal`` (truncated normal, fan_avg) over the last two dims."""
    fan_in, fan_out = shape[-2], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    t = torch.empty(shape, device=device)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def lecun_normal_init(shape, fan_in: int, device=None,
                      generator=None) -> torch.Tensor:
    """JAX ``lecun_normal``: truncated normal of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t = torch.empty(shape, device=device)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def adapter_normal_init(shape, device=None, generator=None) -> torch.Tensor:
    t = torch.empty(shape, device=device)
    return nn.init.normal_(t, 0.0, 1e-2, generator=generator)


class TorchLinear(nn.Module):
    """Dense layer, ``kernel`` (in, out); torch-default uniform init, or
    ``init="xavier"`` / ``"lecun"`` (flax ``nn.Dense``) with zero bias."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, init: str = "torch",
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        shape = (in_features, features)
        bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
        if init == "torch":
            kernel = uniform_init(shape, bound, device, generator)
            bias = uniform_init((features,), bound, device, generator)
        elif init == "xavier":
            kernel = xavier_normal_init(shape, device, generator)
            bias = torch.zeros(features, device=device)
        elif init == "lecun":  # flax nn.Dense
            kernel = lecun_normal_init(shape, in_features, device, generator)
            bias = torch.zeros(features, device=device)
        else:
            raise ValueError(f"unknown init {init!r}")
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def XavierLinear(in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None) -> TorchLinear:
    """Dense layer with xavier-normal weights and zero bias."""
    return TorchLinear(in_features, features, use_bias, dtype, "xavier",
                       device, generator)


class LayerNorm(nn.Module):
    """LayerNorm in fp32 with JAX's parameter names (``scale``, ``bias``)."""

    def __init__(self, features: int, eps: float = LN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias,
                            self.eps)


def _dropout(x, rate: float, deterministic: bool, generator=None):
    """Inverted dropout, as flax's ``nn.Dropout``: kept values scaled by
    1/(1-rate) in x's dtype.  The bits come from ``generator`` (an explicit
    ``torch.Generator``, never the global one); train mode needs it."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = (u >= rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MultiHeadedAttention(nn.Module):
    """Post-LN self-attention: bias-free Q/K/V/out projections, fp32
    softmax over an additive (0 / -1e9) mask, LN(residual + out)."""

    def __init__(self, d_model: int, n_heads: int, dropout: float,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        self.n_heads, self.dropout, self.dtype = n_heads, dropout, dtype

        def proj():
            return XavierLinear(d_model, d_model, use_bias=False, dtype=dtype,
                                device=device, generator=generator)

        self.w_Q, self.w_K, self.w_V, self.fc = proj(), proj(), proj(), proj()
        self.layer_norm = LayerNorm(d_model, device=device)

    def forward(self, x, additive_mask, deterministic: bool = True,
                generator=None):
        b, l, d_model = x.shape
        d_k = d_model // self.n_heads
        dt = self.dtype or x.dtype

        def heads(lin):
            return lin(x).reshape(b, l, self.n_heads, d_k).transpose(1, 2)

        q, k, v = heads(self.w_Q), heads(self.w_K), heads(self.w_V)
        attn = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d_k)
        attn = attn + additive_mask.float()
        p = torch.softmax(attn, dim=-1).to(dt)
        p = _dropout(p, self.dropout, deterministic, generator)
        o = (p.float() @ v.float()).to(dt).transpose(1, 2).reshape(b, l, d_model)
        o = _dropout(self.fc(o), self.dropout, deterministic, generator)
        return self.layer_norm(x + o).to(dt)


class PositionwiseFeedForward(nn.Module):
    """Post-LN FFN: LN(residual + dropout(W2 relu(W1 x)))."""

    def __init__(self, d_model: int, d_inner: int, dropout: float,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.w_1 = XavierLinear(d_model, d_inner, dtype=dtype, device=device,
                                generator=generator)
        self.w_2 = XavierLinear(d_inner, d_model, dtype=dtype, device=device,
                                generator=generator)
        self.layer_norm = LayerNorm(d_model, device=device)

    def forward(self, x, deterministic: bool = True, generator=None):
        dt = self.dtype or x.dtype
        h = self.w_2(torch.relu(self.w_1(x)))
        h = _dropout(h, self.dropout, deterministic, generator)
        return self.layer_norm(x + h).to(dt)


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_inner: int, dropout: float,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        self.multi_head_attention = MultiHeadedAttention(
            d_model, n_heads, dropout, dtype, device, generator)
        self.feed_forward = PositionwiseFeedForward(
            d_model, d_inner, dropout, dtype, device, generator)

    def forward(self, x, additive_mask, deterministic: bool = True,
                generator=None):
        x = self.multi_head_attention(x, additive_mask, deterministic,
                                      generator)
        return self.feed_forward(x, deterministic, generator)


class TransformerEncoder(nn.Module):
    """Learned-positional post-LN encoder: blocks(dropout(LN(x + pos)))."""

    def __init__(self, d_model: int, n_position: int, n_heads: int,
                 n_layers: int, dropout: float,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        self.n_layers, self.dropout, self.dtype = n_layers, dropout, dtype
        self.position_embedding = nn.Parameter(
            xavier_normal_init((n_position, d_model), device, generator))
        self.layer_norm = LayerNorm(d_model, device=device)
        for i in range(n_layers):
            self.add_module(f"transformer_blocks_{i}", TransformerBlock(
                d_model, n_heads, d_model * 4, dropout, dtype, device,
                generator))

    def blocks(self):
        return [getattr(self, f"transformer_blocks_{i}")
                for i in range(self.n_layers)]

    def forward(self, input_embs, additive_mask, deterministic: bool = True,
                generator=None):
        dt = self.dtype or input_embs.dtype
        seq_len = input_embs.shape[1]
        x = input_embs + self.position_embedding[:seq_len].to(dt)
        x = self.layer_norm(x).to(dt)
        x = _dropout(x, self.dropout, deterministic, generator)
        for block in self.blocks():
            x = block(x, additive_mask, deterministic, generator)
        return x
