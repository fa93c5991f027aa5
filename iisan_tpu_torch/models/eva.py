"""EVA-family vision encoder with per-layer hidden-state taps.

Port of ``iisan_tpu/models/eva.py``, the tower of IISAN-Versa's
EVA-CLIP-18B image caches (each layer's CLS row per item, 49 x 5120).
The EVA deltas over a plain ViT, each one a switch:

- separate q, k, v projections, k without a bias;
- 2D rotary embedding on the patch tokens' q and k (the CLS token
  bypasses it): half the head width per spatial axis, pairwise-interleaved
  rotation, fp32 tables built in float64 numpy with positions rescaled to
  the pretraining grid (``rope_pt_seq_len``), the product in fp32 and then
  rounded to the compute dtype;
- SwiGLU MLP ``w3(ffn_ln(silu(w1 x) * w2 x))`` and the attention's inner
  LayerNorm before its output projection (``sub_ln``);
- pre-norm blocks, or post-norm (``x + norm(f(x))``, reusing ``norm1`` /
  ``norm2``);
- a patch projection with a bias, no pre-encoder LayerNorm, ``final_norm``
  on the pooled CLS only.

The hidden stack is the embeddings, then each block's raw output;
``collect="cls"`` keeps each layer's CLS row alone.  Attention is plain
PyTorch with the JAX cast chain (``modules.attention_core``).  Weights are
kept in the compute dtype, drawn on ``device`` from ``generator`` (an
EVA-CLIP-18B tower is about 34 GB in bf16 and is never built in fp32);
LayerNorms stay fp32.  One submodule a layer, stacked under
``layers.block`` in the JAX tree (``jax_scan``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .clip_vit import _dense, _param
from .modules import (LayerNorm, attention_core, hidden_reducer, merge_heads,
                      patchify, split_heads)


def rope_2d_tables(grid: int, dim: int, pt_seq_len: int = 16,
                   theta: float = 10000.0):
    """(cos, sin), each (grid*grid, dim) fp32 numpy, for 2D vision RoPE of
    per-head width ``dim``: dim/4 frequencies repeated pairwise per axis,
    the row angles on the first half of the channels and the column angles
    on the second, positions ``arange(grid) * pt_seq_len / grid``;
    computed in float64 as the JAX module does."""
    if dim % 4:
        raise ValueError(f"2D RoPE needs head_dim % 4 == 0, got {dim}")
    axis_dim = dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, axis_dim, 2, dtype=np.float64) / axis_dim))
    t = np.arange(grid, dtype=np.float64) * (pt_seq_len / grid)
    ang = np.repeat(np.einsum("n,f->nf", t, freqs), 2, axis=-1)  # (grid, axis_dim)
    full = np.concatenate(
        [np.broadcast_to(ang[:, None, :], (grid, grid, axis_dim)),
         np.broadcast_to(ang[None, :, :], (grid, grid, axis_dim))],
        axis=-1).reshape(grid * grid, dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def _rotate_half_interleaved(x):
    """(..., 2k) -> the pairs (x1, x2) as (-x2, x1): the EVA convention,
    not Llama's half split."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def apply_rope_2d(x, cos, sin):
    """x: (B, H, T, dh) patch tokens; cos, sin: fp32 (T, dh).  The
    product is fp32 (x promoted); the caller rounds it."""
    return x.float() * cos + _rotate_half_interleaved(x).float() * sin


class EvaBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate_dim: int,
                 use_rope: bool = True, sub_ln: bool = True,
                 postnorm: bool = False, ln_eps: float = 1e-6,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.num_heads, self.use_rope, self.postnorm = num_heads, use_rope, postnorm
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, ln_eps, device)
        self.norm2 = LayerNorm(dim, ln_eps, device)
        self.q_proj = _dense(dim, dim, dtype, device, generator)
        self.k_proj = _dense(dim, dim, dtype, device, generator, bias=False)
        self.v_proj = _dense(dim, dim, dtype, device, generator)
        self.inner_attn_ln = LayerNorm(dim, ln_eps, device) if sub_ln else None
        self.out_proj = _dense(dim, dim, dtype, device, generator)
        self.w1 = _dense(dim, intermediate_dim, dtype, device, generator)
        self.w2 = _dense(dim, intermediate_dim, dtype, device, generator)
        self.ffn_ln = LayerNorm(intermediate_dim, ln_eps, device) if sub_ln else None
        self.w3 = _dense(intermediate_dim, dim, dtype, device, generator)

    def _ln(self, norm, y):
        return norm(y).to(self.dtype)

    def forward(self, x, cos, sin):
        dt = self.dtype
        h = x if self.postnorm else self._ln(self.norm1, x)
        q, k, v = (split_heads(p(h), self.num_heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        if self.use_rope:  # the CLS token (position 0) is not rotated
            q, k = (torch.cat([z[:, :, :1], apply_rope_2d(z[:, :, 1:], cos, sin).to(dt)], 2)
                    for z in (q, k))
        o = merge_heads(attention_core(q, k, v, dt))
        if self.inner_attn_ln is not None:
            o = self._ln(self.inner_attn_ln, o)
        o = self.out_proj(o)
        x = x + (self._ln(self.norm1, o) if self.postnorm else o)

        h = x if self.postnorm else self._ln(self.norm2, x)
        h = F.silu(self.w1(h)) * self.w2(h)
        if self.ffn_ln is not None:
            h = self._ln(self.ffn_ln, h)
        h = self.w3(h)
        return x + (self._ln(self.norm2, h) if self.postnorm else h)


class EvaVisionEncoder(nn.Module):
    """``forward(images)`` on (B, H, W, 3) normalised channels-last images
    returns (pooled CLS ``final_norm(last[:, 0])`` (B, D), hidden stack
    (layers+1, B, 1+n*n, D), or (layers+1, B, D) with ``collect="cls"``).
    Defaults: ``eva18b_geometry()``."""

    jax_scan = ("layers",)

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 hidden_dim: int = 5120, num_layers: int = 48,
                 num_heads: int = 40, intermediate_dim: int = 16384,
                 use_rope: bool = True, sub_ln: bool = True,
                 postnorm: bool = False, rope_pt_seq_len: int = 16,
                 ln_eps: float = 1e-6, dtype=torch.float32,
                 collect: str = "full", device=None, generator=None):
        super().__init__()
        if collect not in ("full", "cls"):
            raise ValueError(f"collect must be 'full' or 'cls', got {collect!r}")
        self.image_size, self.patch_size = image_size, patch_size
        self.hidden_dim, self.num_layers, self.num_heads = hidden_dim, num_layers, num_heads
        self.use_rope, self.rope_pt_seq_len = use_rope, rope_pt_seq_len
        self.dtype, self.collect = dtype, collect
        n = image_size // patch_size
        self.patch_projection = _dense(patch_size * patch_size * 3, hidden_dim,
                                       dtype, device, generator)
        self.cls_token = _param((hidden_dim,), dtype, device, generator)
        self.position_embeddings = _param((n * n + 1, hidden_dim), dtype, device,
                                          generator)
        self.layers = nn.ModuleList(
            EvaBlock(hidden_dim, num_heads, intermediate_dim, use_rope, sub_ln,
                     postnorm, ln_eps, dtype, device, generator)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(hidden_dim, ln_eps, device)

    def forward(self, images):
        dt = self.dtype
        x = self.patch_projection(patchify(images, self.patch_size, dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.position_embeddings.to(dt)
        cos = sin = None
        if self.use_rope:
            cos, sin = (torch.as_tensor(a, device=x.device) for a in rope_2d_tables(
                self.image_size // self.patch_size,
                self.hidden_dim // self.num_heads, self.rope_pt_seq_len))
        reduce = hidden_reducer(self.collect)
        hiddens = [reduce(x)]
        for layer in self.layers:
            x = layer(x, cos, sin)
            hiddens.append(reduce(x))
        pooled = self.final_norm(x[:, 0]).to(dt)
        return pooled, torch.stack(hiddens, 0)


def eva18b_geometry():
    """EVA-CLIP-18B's vision tower: 48 layers, width 5120, patch 14 at
    224 (published; the cache rows are 49 x 5120).  40 heads (head width
    128) and the SwiGLU width 16,384 are estimates from the published
    vision parameter count (about 17.5B), as in the JAX module; pass the
    real config's values when there is one."""
    return dict(image_size=224, patch_size=14, hidden_dim=5120,
                num_layers=48, num_heads=40, intermediate_dim=16384,
                use_rope=True, sub_ln=True, postnorm=False)


def encoder_from_hf_config(cfg, dtype=torch.float32, collect: str = "full",
                           device=None, generator=None) -> EvaVisionEncoder:
    """An ``EvaVisionEncoder`` at the geometry an EVA vision config (HF
    field names; ``rope``, ``subln``, ``postnorm`` default when absent)
    gives."""
    return EvaVisionEncoder(
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_dim=cfg.hidden_size, num_layers=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        intermediate_dim=cfg.intermediate_size,
        use_rope=getattr(cfg, "rope", True), sub_ln=getattr(cfg, "subln", True),
        postnorm=getattr(cfg, "postnorm", False),
        ln_eps=getattr(cfg, "layer_norm_eps", 1e-6), dtype=dtype,
        collect=collect, device=device, generator=generator)


def params_from_eva_torch(state_dict, num_layers: int, prefix: str = "visual.",
                          sub_ln: bool = True):
    """An EVA vision state dict (the public ``eva_clip`` naming:
    ``blocks.{i}.attn.{q,k,v}_proj.weight`` with standalone ``q_bias`` /
    ``v_bias``, ``attn.inner_attn_ln``, ``attn.proj``, ``mlp.w1/w2/w3``,
    ``mlp.ffn_ln``, ``patch_embed.proj``, ``cls_token``, ``pos_embed``,
    ``norm``) -> the JAX ``EvaVisionEncoder`` tree as fp32 numpy arrays,
    layers stacked under ``layers.block``."""

    def t(name):
        return state_dict[prefix + name].detach().cpu().float().numpy()

    def stack(fmt, transpose=False):
        arrs = [t(fmt.format(i)) for i in range(num_layers)]
        return np.stack([a.T for a in arrs] if transpose else arrs)

    def stack_lin(field):
        return {"kernel": stack(f"blocks.{{}}.{field}.weight", transpose=True),
                "bias": stack(f"blocks.{{}}.{field}.bias")}

    def stack_ln(field):
        return {"scale": stack(f"blocks.{{}}.{field}.weight"),
                "bias": stack(f"blocks.{{}}.{field}.bias")}

    conv = t("patch_embed.proj.weight")  # (D, 3, p, p)
    d, c, p1, p2 = conv.shape
    block = {
        "norm1": stack_ln("norm1"),
        "norm2": stack_ln("norm2"),
        "q_proj": {"kernel": stack("blocks.{}.attn.q_proj.weight", transpose=True),
                   "bias": stack("blocks.{}.attn.q_bias")},
        "k_proj": {"kernel": stack("blocks.{}.attn.k_proj.weight", transpose=True)},
        "v_proj": {"kernel": stack("blocks.{}.attn.v_proj.weight", transpose=True),
                   "bias": stack("blocks.{}.attn.v_bias")},
        "out_proj": stack_lin("attn.proj"),
        "w1": stack_lin("mlp.w1"),
        "w2": stack_lin("mlp.w2"),
        "w3": stack_lin("mlp.w3"),
    }
    if sub_ln:
        block["inner_attn_ln"] = stack_ln("attn.inner_attn_ln")
        block["ffn_ln"] = stack_ln("mlp.ffn_ln")
    return {
        "patch_projection": {"kernel": conv.transpose(2, 3, 1, 0).reshape(p1 * p2 * c, d),
                             "bias": t("patch_embed.proj.bias")},
        "cls_token": t("cls_token").reshape(-1),
        "position_embeddings": t("pos_embed").reshape(-1, d),
        "final_norm": {"scale": t("norm.weight"), "bias": t("norm.bias")},
        "layers": {"block": block},
    }
