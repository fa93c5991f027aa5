"""BERT encoder with per-layer hidden-state taps.

Port of ``iisan_tpu/models/bert.py``: learned word, position and token-type
embeddings with an fp32 LayerNorm (eps 1e-12), then post-LN blocks
(attention -> dense -> dropout -> LN(x + .), then intermediate -> exact
GELU -> dense -> dropout -> LN(x + .)).  Activations run in the compute
dtype; every LayerNorm is fp32 and cast back.  The padding mask becomes an
additive fp32 key bias ``(1 - mask) * -1e9``.

Attention: with ``fused_attention`` true, a CUDA input goes through
``ops.fused_attention.fused_mha`` (the attention kernels, forward and
backward), which raises on a shape it does not take; a CPU input, or
``fused_attention=False``, runs the module path, as the JAX module does off
the TPU.  Train mode (``deterministic=False``) draws from an explicit
``torch.Generator``: the hidden dropout at the three sites and the module
path's attention dropout draw their masks from it; the kernel path takes
one seed from it per encoder call and expands it with Philox per (layer,
head).

Parameter names and layouts are the JAX tree's (``layer_3.attention.query
.kernel`` of shape (in, out), ``word_embeddings.embedding``), so
``utils/jax_params.load_jax_params`` carries a JAX tree across unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import philox
from ..ops.fused_attention import fused_mha
from .modules import LayerNorm, TorchLinear, _dropout, lecun_normal_init

LN_EPS = 1e-12


def dense(in_features: int, features: int, dtype, device=None, generator=None):
    """flax ``nn.Dense``: lecun-normal kernel (in, out), zero bias."""
    return TorchLinear(in_features, features, dtype=dtype, init="lecun",
                       device=device, generator=generator)


def module_attention(q, k, v, n_heads: int, key_bias, dt, dropout: float,
                     deterministic: bool, generator) -> torch.Tensor:
    """The attention of the JAX modules' plain path: fp32 scores from dt
    operands, ``/ sqrt(dk) + bias``, softmax rounded to dt, dropout, fp32
    product with V rounded to dt.  (B, T, D) in and out."""
    b, t, d = q.shape
    dh = d // n_heads

    def split(y):
        return y.reshape(b, t, n_heads, dh).transpose(1, 2).float()

    logits = (split(q) @ split(k).transpose(-1, -2)) / math.sqrt(dh)
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    p = torch.softmax(logits, dim=-1).to(dt)
    p = _dropout(p, dropout, deterministic, generator)
    o = (p.float() @ split(v)).to(dt)
    return o.transpose(1, 2).reshape(b, t, d)


class SelfAttention(nn.Module):
    """Q/K/V projections and the attention (BERT's and ViT's alike)."""

    def __init__(self, dim: int, num_heads: int, dtype, dropout: float,
                 fused: bool, device=None, generator=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.dropout, self.fused = dropout, fused
        self.query = dense(dim, dim, dtype, device, generator)
        self.key = dense(dim, dim, dtype, device, generator)
        self.value = dense(dim, dim, dtype, device, generator)

    def forward(self, x, key_bias=None, deterministic: bool = True,
                generator=None, seed: Optional[int] = None, layer: int = 0):
        q, k, v = self.query(x), self.key(x), self.value(x)
        if self.fused and x.is_cuda:
            train = not deterministic and self.dropout > 0.0
            return fused_mha(q, k, v, self.num_heads, key_bias=key_bias,
                             drop_rate=self.dropout,
                             seed=seed if train else None, layer=layer)
        return module_attention(q, k, v, self.num_heads, key_bias,
                                self.dtype or x.dtype, self.dropout,
                                deterministic, generator)


def attention_seed(module: nn.Module, x: torch.Tensor, deterministic: bool,
                   generator) -> Optional[int]:
    """The encoder call's one kernel seed: drawn from ``generator`` only
    when the fused kernels run in train mode."""
    if deterministic or module.dropout <= 0.0 or not (module.fused and x.is_cuda):
        return None
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    return philox.draw_seed(generator)


class BertLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_dim: int, dtype,
                 dropout: float, fused: bool, device=None, generator=None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.attention = SelfAttention(dim, num_heads, dtype, dropout, fused,
                                       device, generator)
        self.attention_output = dense(dim, dim, dtype, device, generator)
        self.attention_layernorm = LayerNorm(dim, LN_EPS, device)
        self.intermediate = dense(dim, intermediate_dim, dtype, device, generator)
        self.output = dense(intermediate_dim, dim, dtype, device, generator)
        self.output_layernorm = LayerNorm(dim, LN_EPS, device)

    def forward(self, x, key_bias, deterministic: bool = True, generator=None,
                seed: Optional[int] = None, layer: int = 0):
        dt = self.dtype or x.dtype
        attn = self.attention(x, key_bias, deterministic, generator, seed, layer)
        attn = _dropout(self.attention_output(attn), self.dropout,
                        deterministic, generator)
        x = self.attention_layernorm((x + attn).float()).to(dt)
        h = F.gelu(self.intermediate(x))
        h = _dropout(self.output(h), self.dropout, deterministic, generator)
        return self.output_layernorm((x + h).float()).to(dt)


class Embed(nn.Module):
    """flax ``nn.Embed``'s parameter (``embedding``, (vocab, dim))."""

    def __init__(self, vocab: int, dim: int, device=None, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(
            lecun_normal_init((vocab, dim), dim, device, generator))


class BertEncoder(nn.Module):
    """BERT-base geometry by default; ``forward`` returns (last hidden
    (B, T, D), hidden stack): the stack is (layers+1, B, T, D) with
    ``collect="full"`` and the CLS rows (layers+1, B, D) with ``"cls"``,
    embeddings output first."""

    def __init__(self, vocab_size: int = 30522, hidden_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_dim: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2, dtype=None, dropout: float = 0.1,
                 fused_attention: bool = False, collect: str = "full",
                 device=None, generator=None):
        super().__init__()
        if collect not in ("full", "cls"):
            raise ValueError(f"collect must be 'full' or 'cls', got {collect!r}")
        self.num_layers, self.dtype, self.dropout = num_layers, dtype, dropout
        self.fused, self.collect = fused_attention, collect
        self.word_embeddings = Embed(vocab_size, hidden_dim, device, generator)

        def normal(shape):
            t = torch.empty(shape, device=device)
            return nn.Parameter(nn.init.normal_(t, 0.0, 0.02, generator=generator))

        self.position_embeddings = normal((max_position, hidden_dim))
        self.token_type_embeddings = normal((type_vocab_size, hidden_dim))
        self.embeddings_layernorm = LayerNorm(hidden_dim, LN_EPS, device)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", BertLayer(
                hidden_dim, num_heads, intermediate_dim, dtype, dropout,
                fused_attention, device, generator))

    def forward(self, input_ids, attention_mask, deterministic: bool = True,
                generator=None):
        dt = self.dtype or torch.float32
        t = input_ids.shape[1]
        x = (F.embedding(input_ids.long(), self.word_embeddings.embedding).to(dt)
             + self.position_embeddings[:t].to(dt)
             + self.token_type_embeddings[0].to(dt))
        x = self.embeddings_layernorm(x.float()).to(dt)
        x = _dropout(x, self.dropout, deterministic, generator)
        key_bias = (1.0 - attention_mask.float()) * -1e9
        seed = attention_seed(self, x, deterministic, generator)
        reduce = (lambda h: h[:, 0, :]) if self.collect == "cls" else (lambda h: h)
        hiddens = [reduce(x)]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_bias, deterministic,
                                            generator, seed, i)
            hiddens.append(reduce(x))
        return x, torch.stack(hiddens, 0)
