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
from torch.utils.checkpoint import checkpoint

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
    ``init="xavier"`` / ``"lecun"`` (flax ``nn.Dense``) / ``"adapter"``
    (N(0, 1e-2)) with zero bias.  Parameters are fp32 unless
    ``param_dtype`` names another dtype (the large frozen towers keep
    theirs in the compute dtype: the cast at every call rounds fp32 weights
    to the same values)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, init: str = "torch",
                 device=None, generator=None,
                 param_dtype: Optional[torch.dtype] = None):
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
        elif init == "adapter":
            kernel = adapter_normal_init(shape, device, generator)
            bias = torch.zeros(features, device=device)
        else:
            raise ValueError(f"unknown init {init!r}")
        if param_dtype is not None:  # weights kept in the compute dtype
            kernel, bias = kernel.to(param_dtype), bias.to(param_dtype)
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


def attention_core(q, k, v, dt, bias=None) -> torch.Tensor:
    """Plain attention over (B, H, T, dh) heads, the JAX towers' cast
    chain: fp32 scores of dt operands ``/ sqrt(dh) (+ bias)``, fp32
    softmax rounded to dt, fp32 product with V rounded to dt."""
    logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias
    p = torch.softmax(logits, dim=-1).to(dt)
    return (p.float() @ v.float()).to(dt)


def split_heads(y: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, n*dh) -> (B, n, T, dh)."""
    b, t, d = y.shape
    return y.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, n, T, dh) -> (B, T, n*dh)."""
    b, n, t, dh = o.shape
    return o.transpose(1, 2).reshape(b, t, n * dh)


def patchify(images: torch.Tensor, patch: int, dt) -> torch.Tensor:
    """(B, H, W, 3) channels-last -> (B, n*n, p*p*3) patch vectors in dt,
    row-major over the patch grid (the JAX towers' reshape)."""
    b, n = images.shape[0], images.shape[1] // patch
    x = images.to(dt).reshape(b, n, patch, n, patch, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n * n, patch * patch * 3)


def hidden_reducer(collect: str, mask=None, round_mean: bool = False):
    """The per-layer reduction of a tower's hidden states (B, T, D):
    ``"full"`` keeps them, ``"cls"`` takes token 0, ``"mean"`` the
    ``mask``-weighted token mean, an fp32 sum over max(sum(mask), 1), left
    in fp32 or, with ``round_mean``, rounded back to the hidden's dtype."""
    if collect == "cls":
        return lambda h: h[:, 0, :]
    if collect == "mean":
        w = mask.float()[:, :, None]
        denom = torch.clamp(w.sum(1), min=1.0)
        if round_mean:
            return lambda h: ((h.float() * w).sum(1) / denom).to(h.dtype)
        return lambda h: (h.float() * w).sum(1) / denom
    return lambda h: h


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


def checkpointed(fn, generator, *args):
    """``fn(*args, generator=...)`` under ``torch.utils.checkpoint``
    (non-reentrant, so parameters inside ``fn`` get their gradients even
    where no input needs one): its activations are recomputed in the
    backward instead of stored.

    Dropout inside ``fn`` draws from an explicit generator, which the
    checkpoint does not replay.  So ``fn`` runs on a generator of its own,
    set to ``generator``'s state at forward time both in the forward and
    in the recompute (the recompute draws the forward's masks), and
    ``generator`` ends where the forward left it, as without the
    checkpoint."""
    if generator is None:
        return checkpoint(fn, *args, generator=None, use_reentrant=False,
                          preserve_rng_state=False)
    start, end = generator.get_state(), []

    def replay(*a):
        g = torch.Generator(generator.device)
        g.set_state(start)
        out = fn(*a, generator=g)
        if not end:
            end.append(g.get_state())
        return out

    out = checkpoint(replay, *args, use_reentrant=False,
                     preserve_rng_state=False)
    generator.set_state(end[0])
    return out


def tower_layer(remat, attention_block, intermediate, mlp_block, x, generator):
    """One BERT or ViT layer, split at its stored pre-GELU hidden:
    ``attention_block(x, generator=g)`` -> (residual, MLP input), ``h =
    intermediate(MLP input)``, ``mlp_block(residual, h, generator=g)``.

    ``remat`` (the JAX encoders' ``remat``): False stores everything;
    True checkpoints the whole layer (``intermediate`` runs again in the
    backward); "mlp" checkpoints the two blocks around ``intermediate``,
    whose input and pre-GELU output are stored, so the backward does not
    run it again.  Without autograd (frozen towers under ``no_grad``)
    remat does nothing."""

    def whole(x, generator):
        residual, mlp_in = attention_block(x, generator=generator)
        return mlp_block(residual, intermediate(mlp_in), generator=generator)

    if not remat or not torch.is_grad_enabled():
        return whole(x, generator)
    if remat == "mlp":
        residual, mlp_in = checkpointed(attention_block, generator, x)
        return checkpointed(mlp_block, generator, residual,
                            intermediate(mlp_in))
    return checkpointed(whole, generator, x)


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
