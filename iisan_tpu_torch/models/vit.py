"""ViT encoder with per-layer hidden-state taps.

Port of ``iisan_tpu/models/vit.py`` (ViT-base/16 by default): patchify as
a reshape and one dense layer on a (p*p*3, D) kernel, channels last,
``(B, n, p, n, p, 3) -> (B, n*n, p*p*3)`` (not a convolution, so the JAX
weights carry across unchanged); a CLS token, then position embeddings;
pre-LN blocks (LN -> attention -> dense -> dropout -> residual, LN ->
intermediate -> exact GELU -> dense -> dropout -> residual); a final fp32
LayerNorm on the last hidden state only.  The hidden stack holds the raw
(pre-final-LN) block outputs, embeddings first, as HF's
``hidden_states``.  Attention dispatches as in ``models/bert.py``
(``fused_attention`` True, False, "subblock" or "subblock_v2"), and
``quant="int8"`` makes every dense layer, the patch projection included,
an ``Int8Dense``.  ``lora_rank``, ``houlsby_down`` / ``adapter_activation``
and ``remat`` are BERT's (``models/bert.py``); the adapters sit after each
sublayer's dropout, before its residual.  ``params_from_hf_torch`` maps a
transformers ``ViTModel`` state dict onto this tree.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_linear import dense_or_int8
from .bert import (LN_EPS, SelfAttention, attention_seed, houlsby_adapter,
                   subblock_attention, subblock_route)
from .modules import LayerNorm, _dropout, hidden_reducer, patchify, tower_layer


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_dim: int, dtype,
                 dropout: float, fused, quant: str = "none", lora_rank: int = 0,
                 houlsby_down: int = 0, adapter_activation: str = "RELU",
                 device=None, generator=None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.fused, self.quant, self.lora_rank = fused, quant, lora_rank
        self.layernorm_before = LayerNorm(dim, LN_EPS, device)
        self.attention = SelfAttention(dim, num_heads, dtype, dropout, fused,
                                       quant, lora_rank, device, generator)
        self.attention_output = dense_or_int8(dim, dim, dtype, quant, device,
                                              generator)
        self.attention_adapter = houlsby_adapter(
            dim, houlsby_down, adapter_activation, dtype, device, generator)
        self.layernorm_after = LayerNorm(dim, LN_EPS, device)
        self.intermediate = dense_or_int8(dim, intermediate_dim, dtype, quant,
                                          device, generator)
        self.output = dense_or_int8(intermediate_dim, dim, dtype, quant, device,
                                    generator)
        self.output_adapter = houlsby_adapter(
            dim, houlsby_down, adapter_activation, dtype, device, generator)

    def attention_block(self, x, deterministic, seed, layer, generator=None):
        """x -> (x + adapter(dropout(attention(LN(x)))), its LN: the
        FFN's input)."""
        dt = self.dtype or x.dtype
        h = self.layernorm_before(x.float()).to(dt)
        if subblock_route(self.fused, self.quant, self.lora_rank):
            h = subblock_attention(self.fused, self.attention,
                                   self.attention_output, h, None,
                                   deterministic, seed, layer)
        else:
            h = self.attention_output(self.attention(
                h, None, deterministic, generator, seed, layer))
        h = _dropout(h, self.dropout, deterministic, generator)
        x = x + self.attention_adapter(h)
        return x, self.layernorm_after(x.float()).to(dt)

    def mlp_block(self, x, h, deterministic, generator=None):
        """(residual, pre-GELU hidden) -> the block's output."""
        h = _dropout(self.output(F.gelu(h)), self.dropout, deterministic,
                     generator)
        return x + self.output_adapter(h)

    def forward(self, x, deterministic: bool = True, generator=None,
                seed: Optional[int] = None, layer: int = 0, remat=False):
        return tower_layer(
            remat, functools.partial(self.attention_block,
                                     deterministic=deterministic, seed=seed,
                                     layer=layer),
            self.intermediate,
            functools.partial(self.mlp_block, deterministic=deterministic),
            x, generator)


class ViTEncoder(nn.Module):
    """``forward(images)`` on (B, H, W, 3) channels-last images, already
    normalised, returns (final-LN last hidden (B, 1+n*n, D), hidden stack
    (layers+1, B, 1+n*n, D) with ``collect="full"`` or the CLS rows
    (layers+1, B, D) with ``"cls"``)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 hidden_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_dim: int = 3072,
                 dtype=None, dropout: float = 0.0, lora_rank: int = 0,
                 houlsby_down: int = 0, adapter_activation: str = "RELU",
                 remat=False, fused_attention=False, collect: str = "full",
                 quant: str = "none", device=None, generator=None):
        super().__init__()
        if collect not in ("full", "cls"):
            raise ValueError(f"collect must be 'full' or 'cls', got {collect!r}")
        self.image_size, self.patch_size = image_size, patch_size
        self.hidden_dim = hidden_dim
        self.num_layers, self.dtype, self.dropout = num_layers, dtype, dropout
        self.fused, self.collect, self.quant = fused_attention, collect, quant
        self.lora_rank, self.remat = lora_rank, remat
        n = image_size // patch_size
        self.patch_projection = dense_or_int8(patch_size * patch_size * 3,
                                              hidden_dim, dtype, quant, device,
                                              generator)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, hidden_dim),
                                                  device=device))
        pos = torch.empty((1, n * n + 1, hidden_dim), device=device)
        self.position_embeddings = nn.Parameter(
            nn.init.normal_(pos, 0.0, 0.02, generator=generator))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ViTBlock(
                hidden_dim, num_heads, intermediate_dim, dtype, dropout,
                fused_attention, quant, lora_rank, houlsby_down,
                adapter_activation, device, generator))
        self.final_layernorm = LayerNorm(hidden_dim, LN_EPS, device)

    def forward(self, images, deterministic: bool = True, generator=None):
        dt = self.dtype or torch.float32
        x = self.patch_projection(patchify(images, self.patch_size, dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], 1) + self.position_embeddings.to(dt)
        x = _dropout(x, self.dropout, deterministic, generator)
        seed = attention_seed(self, x, deterministic, generator)
        reduce = hidden_reducer(self.collect)
        hiddens = [reduce(x)]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, deterministic, generator, seed,
                                            i, self.remat)
            hiddens.append(reduce(x))
        last = self.final_layernorm(x.float()).to(dt)
        return last, torch.stack(hiddens, 0)


def params_from_hf_torch(state_dict, num_layers: int = 12,
                         prefix: str = "vit.", lora: bool = False):
    """A transformers ``ViTModel`` / ``ViTForImageClassification`` state
    dict -> ``ViTEncoder``'s tree as numpy arrays, as ``models/bert.py``'s:
    the conv patch kernel (D, 3, p, p) becomes the (p*p*3, D) dense kernel
    of the channels-last patch vector."""

    def t(name):
        return state_dict[prefix + name].detach().cpu().float().numpy()

    def lin(name):
        return {"kernel": np.ascontiguousarray(t(name + ".weight").T),
                "bias": t(name + ".bias")}

    def qv(name):
        return {"base": lin(name)} if lora else lin(name)

    def ln(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    conv = t("embeddings.patch_embeddings.projection.weight")
    d, c, p1, p2 = conv.shape
    params = {
        "patch_projection": {
            "kernel": np.ascontiguousarray(
                conv.transpose(2, 3, 1, 0).reshape(p1 * p2 * c, d)),
            "bias": t("embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": t("embeddings.cls_token"),
        "position_embeddings": t("embeddings.position_embeddings"),
        "final_layernorm": ln("layernorm"),
    }
    for i in range(num_layers):
        e = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "layernorm_before": ln(f"{e}.layernorm_before"),
            "attention": {
                "query": qv(f"{e}.attention.attention.query"),
                "key": lin(f"{e}.attention.attention.key"),
                "value": qv(f"{e}.attention.attention.value"),
            },
            "attention_output": lin(f"{e}.attention.output.dense"),
            "layernorm_after": ln(f"{e}.layernorm_after"),
            "intermediate": lin(f"{e}.intermediate.dense"),
            "output": lin(f"{e}.output.dense"),
        }
    return params
