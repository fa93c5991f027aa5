"""Trainability masks of the adapter methods.

Port of ``iisan_tpu/train/peft_masks.py``.  Each method is a predicate over
a parameter's path (its ``named_parameters()`` name with dots read as
slashes, and a trailing slash, as the JAX package spells tree paths):

  fft      everything trains (minus ``freeze_paras_before``)
  iisan    SAN + user encoder + com_dense + the towers' output heads
  lora     LoRA factors + heads        houslby  Houlsby adapters + heads
  bitfit   tower biases + heads

with the reference's precedence: the index freeze at load time <
``fine_tune_to`` < the method's re-enables < ``finetune_layernorm``.
``trainable_mask`` returns ``{name: bool}`` and sets ``requires_grad`` to
match.  LoRA's factors (``lora_A`` / ``lora_B``) and the Houlsby adapters
(``attention_adapter`` / ``output_adapter``) are ``models/peft.py``'s,
which ``towers_from_config`` builds only for ``adapter_type`` "lora" and
"houslby": under "houlsby" or "adapter" the towers are plain, and those
methods re-enable the heads alone, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict

from torch import nn

_HEAD_MARKERS = ("user_encoder", "fuse", "san")
# tower output heads re-enabled by every adapter method
_TOWER_HEADS = ("image_tower/classifier", "text_tower/fc/")


def param_path(name: str) -> str:
    """'a.b.c' -> 'a/b/c/'."""
    return name.replace(".", "/") + "/"


def _is_head(path: str) -> bool:
    return (any(m in path for m in _HEAD_MARKERS)
            or any(h in path for h in _TOWER_HEADS))


# torch ``named_parameters()`` order of the HF towers, for the index-based
# ``freeze_paras_before``.
_BERT_EMB = {"word_embeddings/embedding": 0, "position_embeddings": 1,
             "token_type_embeddings": 2, "embeddings_layernorm/scale": 3,
             "embeddings_layernorm/bias": 4}
_BERT_LAYER = {"attention/query/kernel": 0, "attention/query/bias": 1,
               "attention/key/kernel": 2, "attention/key/bias": 3,
               "attention/value/kernel": 4, "attention/value/bias": 5,
               "attention_output/kernel": 6, "attention_output/bias": 7,
               "attention_layernorm/scale": 8, "attention_layernorm/bias": 9,
               "intermediate/kernel": 10, "intermediate/bias": 11,
               "output/kernel": 12, "output/bias": 13,
               "output_layernorm/scale": 14, "output_layernorm/bias": 15}
_VIT_EMB = {"cls_token": 0, "position_embeddings": 1,
            "patch_projection/kernel": 2, "patch_projection/bias": 3}
_VIT_LAYER = {"attention/query/kernel": 0, "attention/query/bias": 1,
              "attention/key/kernel": 2, "attention/key/bias": 3,
              "attention/value/kernel": 4, "attention/value/bias": 5,
              "attention_output/kernel": 6, "attention_output/bias": 7,
              "intermediate/kernel": 8, "intermediate/bias": 9,
              "output/kernel": 10, "output/bias": 11,
              "layernorm_before/scale": 12, "layernorm_before/bias": 13,
              "layernorm_after/scale": 14, "layernorm_after/bias": 15}
_VIT_FINAL = {"final_layernorm/scale": 0, "final_layernorm/bias": 1}


def torch_param_index(path: str) -> int:
    """The HF ``named_parameters()`` index of a tower parameter; -1 for a
    parameter outside the towers' encoders; ``-2 - i`` for the ViT's
    final LayerNorm parameter i, whose index follows the last layer."""
    if "/bert/" in path:
        rel, emb, per_layer, final = (path.split("/bert/", 1)[1], _BERT_EMB,
                                      _BERT_LAYER, {})
    elif "/vit/" in path:
        rel, emb, per_layer, final = (path.split("/vit/", 1)[1], _VIT_EMB,
                                      _VIT_LAYER, _VIT_FINAL)
    else:
        return -1
    rel = rel.rstrip("/")
    if rel in emb:
        return emb[rel]
    m = re.match(r"layer_(\d+)/(.*)", rel)
    if m and m.group(2) in per_layer:
        return len(emb) + 16 * int(m.group(1)) + per_layer[m.group(2)]
    if rel in final:
        return -2 - final[rel]
    return -1


def _is_tower_layernorm(path: str) -> bool:
    if "adapter" in path or "lora" in path:
        return False
    if "/bert/" not in path and "/vit/" not in path:
        return False
    return "layernorm" in path.lower()


def trainable_mask(model: nn.Module, method: str, *,
                   finetune_layernorm: bool = False,
                   freeze_paras_before: int = 0,
                   fine_tune_to_all: bool = False) -> Dict[str, bool]:
    """{parameter name: trainable} for ``method``; sets each parameter's
    ``requires_grad`` to its entry."""
    method = method.lower()
    params = dict(model.named_parameters())
    max_vit_layer = -1
    if freeze_paras_before > 0:
        for name in params:
            path = param_path(name)
            m = re.search(r"layer_(\d+)/", path)
            if "/vit/" in path and m:
                max_vit_layer = max(max_vit_layer, int(m.group(1)))

    def index_frozen(path: str) -> bool:
        if freeze_paras_before <= 0:
            return False
        idx = torch_param_index(path)
        if idx <= -2:  # the ViT's final LayerNorm follows its last layer
            idx = len(_VIT_EMB) + 16 * (max_vit_layer + 1) + (-2 - idx)
        return 0 <= idx < freeze_paras_before

    def pred(path: str) -> bool:
        if method in ("fft", "all", "none"):
            base = not index_frozen(path)
        elif _is_head(path):
            base = True
        elif method == "iisan":
            base = False
        elif method == "lora":
            base = "lora_A" in path or "lora_B" in path
        elif method in ("houslby", "houlsby", "adapter"):
            base = "attention_adapter" in path or "output_adapter" in path
        elif method == "bitfit":
            base = path.endswith("bias/")
        else:
            raise ValueError(f"unknown PEFT method {method}")
        if not base and fine_tune_to_all:
            base = not index_frozen(path)
        if finetune_layernorm and _is_tower_layernorm(path):
            base = True
        return base

    mask = {name: pred(param_path(name)) for name in params}
    for name, p in params.items():
        p.requires_grad_(mask[name])
    return mask
