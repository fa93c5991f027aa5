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
the TPU.  ``fused_attention="subblock"`` / ``"subblock_v2"`` (with
``quant="none"``) runs the projections and the attention as one op,
``ops.fused_attn_subblock`` (kernels #8 / #9 on a CUDA input, their plain
versions on a CPU one), from the same parameters.  Train mode
(``deterministic=False``) draws from an explicit ``torch.Generator``: the
hidden dropout at the three sites and the module path's attention dropout
draw their masks from it; the kernel and subblock paths take one seed from
it per encoder call and expand it with Philox per (layer, head).

``quant="int8"`` makes every dense layer an ``ops.int8_linear.Int8Dense``
(W8A8, kernel #10 on a CUDA input): frozen towers only.

The baselines' tower options (``models/peft.py``): ``lora_rank > 0``
makes ``query`` and ``value`` ``LoRADense`` layers (never int8; the
subblock routes then run ``fused_mha``, as the JAX layers do), and
``houlsby_down > 0`` adds ``attention_adapter`` after the attention
output's dropout and ``output_adapter`` after the FFN's.  ``remat`` (False,
True or "mlp") rematerialises each layer in the backward
(``modules.tower_layer``).  ``params_from_hf_torch`` maps a transformers
``BertModel`` state dict onto this tree.

Parameter names and layouts are the JAX tree's (``layer_3.attention.query
.kernel`` of shape (in, out), ``word_embeddings.embedding``), so
``utils/jax_params.load_jax_params`` carries a JAX tree across unchanged.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import philox
from ..ops.fused_attention import fused_mha
from ..ops.fused_attn_subblock import fused_attn_subblock, fused_attn_subblock_v2
from ..ops.int8_linear import dense_or_int8
from .modules import (LayerNorm, _dropout, hidden_reducer, lecun_normal_init,
                      tower_layer)
from .peft import HoulsbyAdapter, LoRADense

LN_EPS = 1e-12
SUBBLOCK_OPS = {"subblock": fused_attn_subblock,
                "subblock_v2": fused_attn_subblock_v2}


def subblock_route(fused, quant: str, lora_rank: int = 0) -> bool:
    """The JAX layers' test for the subblock branch."""
    return fused in SUBBLOCK_OPS and lora_rank == 0 and quant == "none"


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
                 fused, quant: str = "none", lora_rank: int = 0, device=None,
                 generator=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.dropout, self.fused = dropout, fused

        def dense(lora: bool):  # LoRA layers are never int8, as in JAX
            if lora and lora_rank > 0:
                return LoRADense(dim, dim, lora_rank, dtype, device, generator)
            return dense_or_int8(dim, dim, dtype, quant, device, generator)

        self.query, self.key, self.value = dense(True), dense(False), dense(True)

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


def subblock_attention(route: str, attention: SelfAttention, attention_output,
                       x, key_bias, deterministic: bool, seed: Optional[int],
                       layer: int) -> torch.Tensor:
    """The subblock branch of a BERT or ViT layer: the layer's own q, k, v
    and output-projection parameters (the module path's names, as the JAX
    ``_SubblockProj`` / ``_ProjParams`` keep them) through one
    ``SUBBLOCK_OPS[route]`` call, wqkv concatenated here."""
    a = attention
    wqkv = torch.cat([a.query.kernel, a.key.kernel, a.value.kernel], 1)
    bqkv = torch.cat([a.query.bias, a.key.bias, a.value.bias])
    train = not deterministic and a.dropout > 0.0
    return SUBBLOCK_OPS[route](
        x, wqkv, bqkv, attention_output.kernel, attention_output.bias,
        a.num_heads, key_bias=key_bias, drop_rate=a.dropout,
        seed=seed if train else None, layer=layer)


def attention_seed(module: nn.Module, x: torch.Tensor, deterministic: bool,
                   generator) -> Optional[int]:
    """The encoder call's one kernel seed: drawn from ``generator`` only
    when the fused kernels (on the card) or the subblock op (anywhere)
    run in train mode."""
    if deterministic or module.dropout <= 0.0:
        return None
    if not (subblock_route(module.fused, module.quant, module.lora_rank)
            or (module.fused and x.is_cuda)):
        return None
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    return philox.draw_seed(generator)


def houlsby_adapter(dim: int, down: int, activation: str, dtype, device,
                    generator) -> nn.Module:
    """A Houlsby adapter of width ``down``; the identity for 0."""
    if down > 0:
        return HoulsbyAdapter(dim, down, activation, dtype, device, generator)
    return nn.Identity()


class BertLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_dim: int, dtype,
                 dropout: float, fused, quant: str = "none", lora_rank: int = 0,
                 houlsby_down: int = 0, adapter_activation: str = "RELU",
                 device=None, generator=None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.fused, self.quant, self.lora_rank = fused, quant, lora_rank
        self.attention = SelfAttention(dim, num_heads, dtype, dropout, fused,
                                       quant, lora_rank, device, generator)
        self.attention_output = dense_or_int8(dim, dim, dtype, quant, device,
                                              generator)
        self.attention_adapter = houlsby_adapter(
            dim, houlsby_down, adapter_activation, dtype, device, generator)
        self.attention_layernorm = LayerNorm(dim, LN_EPS, device)
        self.intermediate = dense_or_int8(dim, intermediate_dim, dtype, quant,
                                          device, generator)
        self.output = dense_or_int8(intermediate_dim, dim, dtype, quant, device,
                                    generator)
        self.output_adapter = houlsby_adapter(
            dim, houlsby_down, adapter_activation, dtype, device, generator)
        self.output_layernorm = LayerNorm(dim, LN_EPS, device)

    def attention_block(self, x, key_bias, deterministic, seed, layer,
                        generator=None):
        """x -> LN(x + adapter(dropout(attention))), twice: the residual
        and the FFN's input are one tensor in a post-LN layer."""
        dt = self.dtype or x.dtype
        if subblock_route(self.fused, self.quant, self.lora_rank):
            attn = subblock_attention(self.fused, self.attention,
                                      self.attention_output, x, key_bias,
                                      deterministic, seed, layer)
        else:
            attn = self.attention_output(self.attention(
                x, key_bias, deterministic, generator, seed, layer))
        attn = _dropout(attn, self.dropout, deterministic, generator)
        attn = self.attention_adapter(attn)
        x = self.attention_layernorm((x + attn).float()).to(dt)
        return x, x

    def mlp_block(self, x, h, deterministic, generator=None):
        """(residual, pre-GELU hidden) -> the layer's output."""
        dt = self.dtype or x.dtype
        h = _dropout(self.output(F.gelu(h)), self.dropout, deterministic,
                     generator)
        h = self.output_adapter(h)
        return self.output_layernorm((x + h).float()).to(dt)

    def forward(self, x, key_bias, deterministic: bool = True, generator=None,
                seed: Optional[int] = None, layer: int = 0, remat=False):
        return tower_layer(
            remat, functools.partial(self.attention_block, key_bias=key_bias,
                                     deterministic=deterministic, seed=seed,
                                     layer=layer),
            self.intermediate,
            functools.partial(self.mlp_block, deterministic=deterministic),
            x, generator)


class Embed(nn.Module):
    """flax ``nn.Embed``'s parameter (``embedding``, (vocab, dim)), fp32
    unless ``param_dtype`` names another dtype."""

    def __init__(self, vocab: int, dim: int, device=None, generator=None,
                 param_dtype=None):
        super().__init__()
        table = lecun_normal_init((vocab, dim), dim, device, generator)
        self.embedding = nn.Parameter(table.to(param_dtype or table.dtype))


class BertEncoder(nn.Module):
    """BERT-base geometry by default; ``forward`` returns (last hidden
    (B, T, D), hidden stack): the stack is (layers+1, B, T, D) with
    ``collect="full"``, the CLS rows (layers+1, B, D) with ``"cls"`` and
    with ``"mean"`` the attention-masked token mean of each layer (an fp32
    sum over the unmasked tokens over max(their count, 1), rounded back to
    the hidden's dtype), embeddings output first."""

    def __init__(self, vocab_size: int = 30522, hidden_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_dim: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2, dtype=None, dropout: float = 0.1,
                 lora_rank: int = 0, houlsby_down: int = 0,
                 adapter_activation: str = "RELU", remat=False,
                 fused_attention=False, collect: str = "full",
                 quant: str = "none", device=None, generator=None):
        super().__init__()
        if collect not in ("full", "cls", "mean"):
            raise ValueError(
                f"collect must be 'full', 'cls' or 'mean', got {collect!r}")
        self.num_layers, self.dtype, self.dropout = num_layers, dtype, dropout
        self.hidden_dim = hidden_dim
        self.fused, self.collect, self.quant = fused_attention, collect, quant
        self.lora_rank, self.remat = lora_rank, remat
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
                fused_attention, quant, lora_rank, houlsby_down,
                adapter_activation, device, generator))

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
        reduce = hidden_reducer(self.collect, attention_mask, round_mean=True)
        hiddens = [reduce(x)]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_bias, deterministic,
                                            generator, seed, i, self.remat)
            hiddens.append(reduce(x))
        return x, torch.stack(hiddens, 0)


def params_from_hf_torch(state_dict, num_layers: int = 12, lora: bool = False):
    """A transformers ``BertModel`` state dict (tensors on any device) ->
    ``BertEncoder``'s tree as numpy arrays (``kernel = weight.T``), for
    ``utils/jax_params.load_jax_params``.  ``lora=True`` nests q and v
    under ``base``; the LoRA factors are not in the state dict, and the
    caller completes the tree with the model's own
    (``utils/jax_params.with_lora_factors``)."""

    def t(name):
        return state_dict[name].detach().cpu().float().numpy()

    def lin(prefix):
        return {"kernel": np.ascontiguousarray(t(prefix + ".weight").T),
                "bias": t(prefix + ".bias")}

    def qv(prefix):
        return {"base": lin(prefix)} if lora else lin(prefix)

    def ln(prefix):
        return {"scale": t(prefix + ".weight"), "bias": t(prefix + ".bias")}

    p = {
        "word_embeddings": {"embedding": t("embeddings.word_embeddings.weight")},
        "position_embeddings": t("embeddings.position_embeddings.weight"),
        "token_type_embeddings": t("embeddings.token_type_embeddings.weight"),
        "embeddings_layernorm": ln("embeddings.LayerNorm"),
    }
    for i in range(num_layers):
        e = f"encoder.layer.{i}"
        p[f"layer_{i}"] = {
            "attention": {
                "query": qv(f"{e}.attention.self.query"),
                "key": lin(f"{e}.attention.self.key"),
                "value": qv(f"{e}.attention.self.value"),
            },
            "attention_output": lin(f"{e}.attention.output.dense"),
            "attention_layernorm": ln(f"{e}.attention.output.LayerNorm"),
            "intermediate": lin(f"{e}.intermediate.dense"),
            "output": lin(f"{e}.output.dense"),
            "output_layernorm": ln(f"{e}.output.LayerNorm"),
        }
    return p
