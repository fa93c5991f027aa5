"""Llama-architecture text encoder with per-layer hidden-state taps.

Port of ``iisan_tpu/models/llama.py``, the frozen text tower of
IISAN-Versa's Llama caches (each layer's token mean per item, 81 x 8192
for Llama-3-70B).  HF ``LlamaModel`` semantics:

- RMSNorm (fp32 variance, cast back) before the attention and the MLP;
- rotary position embeddings on q and k (half-split rotation, the fp32
  tables cast to q's dtype before the products);
- grouped-query attention: kv head j serves q heads ``j*rep .. j*rep +
  rep - 1`` (``repeat_interleave``, as ``jnp.repeat`` on the head axis);
  fp32 scores plus a causal and padding bias of -1e9, fp32 softmax
  rounded to the compute dtype; plain PyTorch with the JAX cast chain (the
  JAX tower reaches no Pallas kernel);
- SwiGLU MLP, ``down(silu(gate(x)) * up(x))``, no biases;
- the hidden stack in HF's layout: the token embeddings, the raw outputs
  of layers 1 .. L-1, then the final-normed output of layer L.

``collect`` reduces each layer as it is produced: ``"full"`` keeps (B, T,
D), ``"cls"`` token 0, ``"mean"`` the attention-masked token mean in fp32
(not rounded: the cache builder's reduction of a full stack).  The
reference builders pass no attention mask, so the callers hand an
all-ones mask and the 0 pads are attended and pooled.

Weights are kept in the compute dtype (a 70B-wide tower is never built in
fp32), drawn on ``device`` from ``generator``; the RMSNorm scales stay
fp32.  One submodule a layer (``layers.<i>``); the JAX tree stacks them
under ``layers.block`` (``jax_scan``, ``utils/jax_params.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bert import Embed
from .modules import (TorchLinear, attention_core, hidden_reducer, merge_heads,
                      split_heads)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (xf * self.scale.float()).to(x.dtype)


def rotary_tables(t: int, head_dim: int, theta: float):
    """(T, head_dim) fp32 numpy cos / sin tables, HF's default rope."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                                / head_dim))
    freqs = np.outer(np.arange(t, dtype=np.float32), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb), np.sin(emb)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rotary(q, k, cos, sin):
    """q, k: (B, H, T, dh); cos, sin: (T, dh), cast to q's dtype first."""
    cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def _dense(d_in, d_out, dtype, device, generator):
    return TorchLinear(d_in, d_out, use_bias=False, dtype=dtype, init="lecun",
                       device=device, generator=generator, param_dtype=dtype)


class LlamaLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_kv_heads: int,
                 intermediate_dim: int, rms_eps: float = 1e-5,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.num_heads, self.num_kv_heads, self.dtype = num_heads, num_kv_heads, dtype
        dh = dim // num_heads
        self.input_layernorm = RMSNorm(dim, rms_eps, device)
        self.q_proj = _dense(dim, num_heads * dh, dtype, device, generator)
        self.k_proj = _dense(dim, num_kv_heads * dh, dtype, device, generator)
        self.v_proj = _dense(dim, num_kv_heads * dh, dtype, device, generator)
        self.o_proj = _dense(dim, dim, dtype, device, generator)
        self.post_attention_layernorm = RMSNorm(dim, rms_eps, device)
        self.gate_proj = _dense(dim, intermediate_dim, dtype, device, generator)
        self.up_proj = _dense(dim, intermediate_dim, dtype, device, generator)
        self.down_proj = _dense(intermediate_dim, dim, dtype, device, generator)

    def forward(self, x, bias, cos, sin):
        h = self.input_layernorm(x)
        q = split_heads(self.q_proj(h), self.num_heads)
        k = split_heads(self.k_proj(h), self.num_kv_heads)
        v = split_heads(self.v_proj(h), self.num_kv_heads)
        q, k = apply_rotary(q, k, cos, sin)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        x = x + self.o_proj(merge_heads(attention_core(q, k, v, self.dtype, bias)))
        h = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlamaEncoder(nn.Module):
    """Decoder-only transformer, Llama-3-70B's geometry by default;
    ``forward(input_ids, attention_mask)`` returns (final-normed last
    hidden (B, T, D), hidden stack (layers+1, B, ...) reduced by
    ``collect``)."""

    jax_scan = ("layers",)

    def __init__(self, vocab_size: int = 128256, hidden_dim: int = 8192,
                 num_layers: int = 80, num_heads: int = 64,
                 num_kv_heads: int = 8, intermediate_dim: int = 28672,
                 rope_theta: float = 500000.0, rms_eps: float = 1e-5,
                 dtype=torch.float32, collect: str = "full", device=None,
                 generator=None):
        super().__init__()
        if collect not in ("full", "cls", "mean"):
            raise ValueError(
                f"collect must be 'full', 'cls' or 'mean', got {collect!r}")
        self.num_layers, self.hidden_dim, self.num_heads = num_layers, hidden_dim, num_heads
        self.rope_theta, self.dtype, self.collect = rope_theta, dtype, collect
        self.embed_tokens = Embed(vocab_size, hidden_dim, device, generator, dtype)
        self.layers = nn.ModuleList(
            LlamaLayer(hidden_dim, num_heads, num_kv_heads, intermediate_dim,
                       rms_eps, dtype, device, generator)
            for _ in range(num_layers))
        self.norm = RMSNorm(hidden_dim, rms_eps, device)

    def forward(self, input_ids, attention_mask):
        t = input_ids.shape[1]
        x = F.embedding(input_ids.long(), self.embed_tokens.embedding).to(self.dtype)
        cos, sin = (torch.as_tensor(a, device=x.device) for a in rotary_tables(
            t, self.hidden_dim // self.num_heads, self.rope_theta))
        causal = torch.triu(torch.full((t, t), -1e9, device=x.device), diagonal=1)
        pad = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
        bias = causal[None, None] + pad
        reduce = hidden_reducer(self.collect, attention_mask)
        hiddens = [reduce(x)]
        for i, layer in enumerate(self.layers):
            x = layer(x, bias, cos, sin)
            if i < self.num_layers - 1:
                hiddens.append(reduce(x))
        last = self.norm(x)
        hiddens.append(reduce(last))
        return last, torch.stack(hiddens, 0)


def params_from_hf_torch(state_dict, num_layers: int, prefix: str = "model."):
    """A transformers ``LlamaModel`` / ``LlamaForCausalLM`` state dict ->
    the JAX ``LlamaEncoder`` tree as fp32 numpy arrays (layers stacked
    under ``layers.block``), for ``utils/jax_params.load_jax_params``.
    No transformers import: any mapping of names to tensors."""

    def t(name):
        return state_dict[prefix + name].detach().cpu().float().numpy()

    def stack_lin(field):  # (out, in) weights -> (L, in, out) kernels
        return {"kernel": np.stack([t(f"layers.{i}.{field}.weight").T
                                    for i in range(num_layers)])}

    def stack_norm(field):
        return {"scale": np.stack([t(f"layers.{i}.{field}.weight")
                                   for i in range(num_layers)])}

    return {
        "embed_tokens": {"embedding": t("embed_tokens.weight")},
        "norm": {"scale": t("norm.weight")},
        "layers": {"block": {
            "input_layernorm": stack_norm("input_layernorm"),
            "post_attention_layernorm": stack_norm("post_attention_layernorm"),
            "q_proj": stack_lin("self_attn.q_proj"),
            "k_proj": stack_lin("self_attn.k_proj"),
            "v_proj": stack_lin("self_attn.v_proj"),
            "o_proj": stack_lin("self_attn.o_proj"),
            "gate_proj": stack_lin("mlp.gate_proj"),
            "up_proj": stack_lin("mlp.up_proj"),
            "down_proj": stack_lin("mlp.down_proj"),
        }},
    }


def encoder_from_hf_config(cfg, dtype=torch.float32, collect: str = "full",
                           device=None, generator=None) -> LlamaEncoder:
    """A ``LlamaEncoder`` at the geometry a transformers ``LlamaConfig``
    (or any object with its field names) gives."""
    return LlamaEncoder(
        vocab_size=cfg.vocab_size, hidden_dim=cfg.hidden_size,
        num_layers=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
        num_kv_heads=getattr(cfg, "num_key_value_heads", None)
        or cfg.num_attention_heads,
        intermediate_dim=cfg.intermediate_size,
        rope_theta=getattr(cfg, "rope_theta", 10000.0),
        rms_eps=getattr(cfg, "rms_norm_eps", 1e-5), dtype=dtype,
        collect=collect, device=device, generator=generator)
