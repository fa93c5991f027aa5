"""Weights made from the seed, on the device, in one call.

``weight_spec`` lists every parameter of a configuration's model under the
name the port gives it (its ``named_parameters()``), with its shape and
how it is drawn.  ``make_weights`` draws every normal leaf from one
``torch.randn`` on the card and scales views of it; LayerNorm scales are
ones and biases that start at zero are zeros.  The same dict is loaded
into the program and handed to the reference, which reads it by the same
names.  The scales are those of the published initialisations: 0.02 for
BERT and ViT, 0.01 for the side adapters, xavier for the user encoder,
PyTorch's default for the small heads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .data import torch_generator

Spec = List[Tuple[str, Tuple[int, ...], str, float]]  # name, shape, kind, std


def _tower_spec(prefix: str, tower: dict, vit: bool) -> Spec:
    D, F = tower["hidden_size"], tower["intermediate_size"]
    s = 0.02
    spec: Spec = []

    def dense(name, k, n):
        spec.extend([(f"{name}.kernel", (k, n), "normal", s),
                     (f"{name}.bias", (n,), "normal", s)])

    def ln(name):
        spec.extend([(f"{name}.scale", (D,), "ones", 0.0),
                     (f"{name}.bias", (D,), "zeros", 0.0)])

    if vit:
        n = (tower["image_size"] // tower["patch_size"]) ** 2
        spec.append((f"{prefix}.cls_token", (1, 1, D), "normal", s))
        spec.append((f"{prefix}.position_embeddings", (1, n + 1, D), "normal", s))
        dense(f"{prefix}.patch_projection", tower["patch_size"] ** 2 * 3, D)
    else:
        spec.append((f"{prefix}.word_embeddings.embedding",
                     (tower["vocab_size"], D), "normal", s))
        spec.append((f"{prefix}.position_embeddings",
                     (tower["max_position_embeddings"], D), "normal", s))
        spec.append((f"{prefix}.token_type_embeddings",
                     (tower["type_vocab_size"], D), "normal", s))
        ln(f"{prefix}.embeddings_layernorm")
    for i in range(tower["num_hidden_layers"]):
        p = f"{prefix}.layer_{i}"
        if vit:
            ln(f"{p}.layernorm_before")
        for proj in ("query", "key", "value"):
            dense(f"{p}.attention.{proj}", D, D)
        dense(f"{p}.attention_output", D, D)
        ln(f"{p}.layernorm_after" if vit else f"{p}.attention_layernorm")
        dense(f"{p}.intermediate", D, F)
        dense(f"{p}.output", F, D)
        if not vit:
            ln(f"{p}.output_layernorm")
    if vit:
        ln(f"{prefix}.final_layernorm")
    return spec


def _linear(name: str, k: int, n: int) -> Spec:
    """PyTorch's default: uniform of std 1 / sqrt(3 k), here a normal."""
    std = 1.0 / math.sqrt(3 * k)
    return [(f"{name}.kernel", (k, n), "normal", std),
            (f"{name}.bias", (n,), "normal", std)]


def _user_encoder_spec(E: int, L: int, blocks: int) -> Spec:
    p = "user_encoder.transformer_encoder"

    def xavier(k, n):
        return math.sqrt(2.0 / (k + n))

    spec: Spec = [(f"{p}.position_embedding", (L, E), "normal", xavier(L, E)),
                  (f"{p}.layer_norm.scale", (E,), "ones", 0.0),
                  (f"{p}.layer_norm.bias", (E,), "zeros", 0.0)]
    for i in range(blocks):
        b = f"{p}.transformer_blocks_{i}"
        for w in ("w_Q", "w_K", "w_V", "fc"):
            spec.append((f"{b}.multi_head_attention.{w}.kernel", (E, E),
                         "normal", xavier(E, E)))
        spec += [(f"{b}.multi_head_attention.layer_norm.scale", (E,), "ones", 0.0),
                 (f"{b}.multi_head_attention.layer_norm.bias", (E,), "zeros", 0.0),
                 (f"{b}.feed_forward.w_1.kernel", (E, 4 * E), "normal", xavier(E, 4 * E)),
                 (f"{b}.feed_forward.w_1.bias", (4 * E,), "zeros", 0.0),
                 (f"{b}.feed_forward.w_2.kernel", (4 * E, E), "normal", xavier(4 * E, E)),
                 (f"{b}.feed_forward.w_2.bias", (E,), "zeros", 0.0),
                 (f"{b}.feed_forward.layer_norm.scale", (E,), "ones", 0.0),
                 (f"{b}.feed_forward.layer_norm.bias", (E,), "zeros", 0.0)]
    return spec


def _san_spec(cfg: dict) -> Spec:
    san, D, E = cfg["san"], cfg["text_tower"]["hidden_size"], cfg["embedding_dim"]
    K, R = len(san["taps"]), san["down_size"]
    spec: Spec = []
    for branch in ("bert_adapter_list", "cv_adapter_list", "mm_adapter_list"):
        spec += [(f"san.{branch}_wd", (K, D, R), "normal", 0.01),
                 (f"san.{branch}_bd", (K, R), "zeros", 0.0),
                 (f"san.{branch}_wu", (K, R, D), "normal", 0.01),
                 (f"san.{branch}_bu", (K, D), "zeros", 0.0)]
    for gate in ("text", "cv", "mm"):
        spec.append((f"san.side_gate_params_{gate}", (K,), "zeros", 0.0))
    for name, k, n in (("fc_bert", D, D), ("fc_cv", D, D), ("bert_pre_fc", D, E),
                       ("cv_pre_fc", D, E), ("fc_mm", D, D), ("fc_mm_down", D, E)):
        spec += _linear(f"san.{name}", k, n)
    return spec


def weight_spec(cfg: dict) -> Spec:
    """Every parameter of the configuration's training model."""
    E = cfg["embedding_dim"]
    text, image = cfg["text_tower"], cfg["image_tower"]
    spec = (_tower_spec("text_tower.bert", text, False)
            + _linear("text_tower.fc", text["hidden_size"], E)
            + _tower_spec("image_tower.vit", image, True)
            + _linear("image_tower.classifier", image["hidden_size"], E))
    if cfg["method"] == "iisan":
        spec += _san_spec(cfg)
        fuse_in = 3 * E
    else:
        fuse_in = 2 * E
    spec += _user_encoder_spec(E, cfg["max_seq_len"], cfg["user_encoder"]["blocks"])
    spec += _linear("fuse.com_dense", fuse_in, E)
    return spec


def serve_spec(cfg: dict) -> Spec:
    """The serving model: the user encoder alone (its table is made apart)."""
    return _user_encoder_spec(cfg["embedding_dim"], cfg["max_seq_len"],
                              cfg["user_encoder"]["blocks"])


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} on ``device``: one ``torch.randn`` for every
    normal leaf, each a scaled view of it."""
    total = sum(math.prod(shape) for _, shape, kind, _ in spec if kind == "normal")
    flat = torch.randn(total, generator=torch_generator(seed, "weights", device),
                       device=device)
    out, off = {}, 0
    for name, shape, kind, std in spec:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
