"""CLIP-style vision encoder with per-layer hidden-state taps.

Port of ``iisan_tpu/models/clip_vit.py`` (HF ``CLIPVisionModel``
semantics): channels-last images patchified as a reshape and one
bias-free dense layer, the class embedding prepended, learned absolute
position embeddings, then ``pre_layernorm``; pre-LN blocks (x +
attn(LN1(x)), x + mlp(LN2(x))) with fp32 LayerNorms and a quick_gelu
(``x * sigmoid(1.702 x)``, or exact GELU) MLP; attention in plain
PyTorch with the JAX cast chain (``modules.attention_core``).  The hidden
stack is the pre-normed embeddings, then each block's raw output;
``post_layernorm`` applies only to the pooled CLS (HF's ``pooler_output``).
``collect="cls"`` keeps each layer's CLS row alone.

Weights are kept in the compute dtype, drawn on ``device`` from
``generator``; LayerNorms stay fp32.  One submodule a layer
(``layers.<i>``), stacked under ``layers.block`` in the JAX tree
(``jax_scan``).  ``params_from_hf_torch`` reads HF's ``pre_layrnorm``
spelling; the module says ``pre_layernorm``, as the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .modules import (LayerNorm, TorchLinear, attention_core, hidden_reducer,
                      merge_heads, patchify, split_heads)


def quick_gelu(x):
    """``x * sigmoid(1.702 x)`` with 1.702 in x's dtype, as JAX rounds a
    Python scalar to it (PyTorch would keep it in fp32)."""
    return x * torch.sigmoid(torch.tensor(1.702, dtype=x.dtype, device=x.device) * x)


def _dense(d_in, d_out, dtype, device, generator, bias=True):
    return TorchLinear(d_in, d_out, use_bias=bias, dtype=dtype, init="lecun",
                       device=device, generator=generator, param_dtype=dtype)


def _param(shape, dtype, device, generator):
    t = torch.empty(shape, device=device)
    return nn.Parameter(nn.init.normal_(t, 0.0, 0.02, generator=generator).to(dtype))


class CLIPBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_dim: int,
                 hidden_act: str = "quick_gelu", ln_eps: float = 1e-5,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.num_heads, self.hidden_act, self.dtype = num_heads, hidden_act, dtype
        self.layer_norm1 = LayerNorm(dim, ln_eps, device)
        self.q_proj = _dense(dim, dim, dtype, device, generator)
        self.k_proj = _dense(dim, dim, dtype, device, generator)
        self.v_proj = _dense(dim, dim, dtype, device, generator)
        self.out_proj = _dense(dim, dim, dtype, device, generator)
        self.layer_norm2 = LayerNorm(dim, ln_eps, device)
        self.fc1 = _dense(dim, intermediate_dim, dtype, device, generator)
        self.fc2 = _dense(intermediate_dim, dim, dtype, device, generator)

    def forward(self, x):
        dt = self.dtype
        h = self.layer_norm1(x).to(dt)
        q, k, v = (split_heads(p(h), self.num_heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        x = x + self.out_proj(merge_heads(attention_core(q, k, v, dt)))
        h = self.fc1(self.layer_norm2(x).to(dt))
        h = quick_gelu(h) if self.hidden_act == "quick_gelu" else F.gelu(h)
        return x + self.fc2(h)


class CLIPVisionEncoder(nn.Module):
    """``forward(images)`` on (B, H, W, 3) normalised channels-last images
    returns (pooled CLS (B, D), hidden stack (layers+1, B, 1+n*n, D), or
    (layers+1, B, D) with ``collect="cls"``).  Defaults: the EVA-CLIP-18B
    vision width the JAX module defaults to."""

    jax_scan = ("layers",)

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 hidden_dim: int = 5120, num_layers: int = 48,
                 num_heads: int = 40, intermediate_dim: int = 20480,
                 hidden_act: str = "quick_gelu", ln_eps: float = 1e-5,
                 dtype=torch.float32, collect: str = "full", device=None,
                 generator=None):
        super().__init__()
        if collect not in ("full", "cls"):
            raise ValueError(f"collect must be 'full' or 'cls', got {collect!r}")
        self.image_size, self.patch_size = image_size, patch_size
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.dtype, self.collect = dtype, collect
        n = image_size // patch_size
        self.patch_projection = _dense(patch_size * patch_size * 3, hidden_dim,
                                       dtype, device, generator, bias=False)
        self.class_embedding = _param((hidden_dim,), dtype, device, generator)
        self.position_embeddings = _param((n * n + 1, hidden_dim), dtype, device,
                                          generator)
        self.pre_layernorm = LayerNorm(hidden_dim, ln_eps, device)
        self.layers = nn.ModuleList(
            CLIPBlock(hidden_dim, num_heads, intermediate_dim, hidden_act,
                      ln_eps, dtype, device, generator)
            for _ in range(num_layers))
        self.post_layernorm = LayerNorm(hidden_dim, ln_eps, device)

    def forward(self, images):
        dt = self.dtype
        x = self.patch_projection(patchify(images, self.patch_size, dt))
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.position_embeddings.to(dt)
        x = self.pre_layernorm(x).to(dt)
        reduce = hidden_reducer(self.collect)
        hiddens = [reduce(x)]
        for layer in self.layers:
            x = layer(x)
            hiddens.append(reduce(x))
        pooled = self.post_layernorm(x[:, 0]).to(dt)
        return pooled, torch.stack(hiddens, 0)


def params_from_hf_torch(state_dict, num_layers: int,
                         prefix: str = "vision_model."):
    """A transformers ``CLIPVisionModel`` state dict -> the JAX
    ``CLIPVisionEncoder`` tree as fp32 numpy arrays (layers stacked under
    ``layers.block``; the conv patch kernel (D, 3, p, p) as the (p*p*3, D)
    dense kernel of the channels-last patch vector).  No transformers
    import."""

    def t(name):
        return state_dict[prefix + name].detach().cpu().float().numpy()

    def stack(field, leaf):
        return np.stack([t(f"encoder.layers.{i}.{field}.{leaf}")
                         for i in range(num_layers)])

    def stack_lin(field):
        return {"kernel": np.stack([t(f"encoder.layers.{i}.{field}.weight").T
                                    for i in range(num_layers)]),
                "bias": stack(field, "bias")}

    def stack_ln(field):
        return {"scale": stack(field, "weight"), "bias": stack(field, "bias")}

    def ln(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    conv = t("embeddings.patch_embedding.weight")
    d, c, p1, p2 = conv.shape
    return {
        "patch_projection": {"kernel": conv.transpose(2, 3, 1, 0).reshape(p1 * p2 * c, d)},
        "class_embedding": t("embeddings.class_embedding"),
        "position_embeddings": t("embeddings.position_embedding.weight"),
        "pre_layernorm": ln("pre_layrnorm"),  # HF's spelling
        "post_layernorm": ln("post_layernorm"),
        "layers": {"block": {
            "layer_norm1": stack_ln("layer_norm1"),
            "layer_norm2": stack_ln("layer_norm2"),
            "q_proj": stack_lin("self_attn.q_proj"),
            "k_proj": stack_lin("self_attn.k_proj"),
            "v_proj": stack_lin("self_attn.v_proj"),
            "out_proj": stack_lin("self_attn.out_proj"),
            "fc1": stack_lin("mlp.fc1"),
            "fc2": stack_lin("mlp.fc2"),
        }},
    }


def encoder_from_hf_config(cfg, dtype=torch.float32, collect: str = "full",
                           device=None, generator=None) -> CLIPVisionEncoder:
    """A ``CLIPVisionEncoder`` at the geometry a transformers
    ``CLIPVisionConfig`` (or any object with its field names) gives."""
    return CLIPVisionEncoder(
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_dim=cfg.hidden_size, num_layers=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        intermediate_dim=cfg.intermediate_size,
        hidden_act=getattr(cfg, "hidden_act", "quick_gelu"),
        ln_eps=getattr(cfg, "layer_norm_eps", 1e-5), dtype=dtype,
        collect=collect, device=device, generator=generator)
