"""Role-based multi-learning-rate Adam.

Port of ``iisan_tpu/train/optim.py``.  Parameters are put in five groups
by their path, as the reference's name matching does; the port's dotted
parameter names are the JAX tree's paths (the weight bridge keeps them
equal), so ``label_for_path`` is the JAX function as it is, applied to the
name with dots read as slashes.  See the JAX module for the label table
and the reference's quirks it keeps.  A trainability mask
(``train/peft_masks.py``) leaves frozen parameters out of every group, as
the JAX package's masked Adam gives them no state and no update.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

log = logging.getLogger("iisan_tpu_torch")

GROUPS = ("text_tower", "image_tower", "recsys", "adapter_cv", "adapter_text")


def label_for_path(path: str) -> str:
    """Map a '/'-joined parameter path to its optimizer group."""
    if "bert_adapter_list" in path:
        return "adapter_text"
    if "cv_adapter_list" in path or "mm_adapter_list" in path:
        return "adapter_cv"
    if "side_gate_params_cv" in path:
        return "image_tower"
    if "side_gate_params" in path:
        return "recsys"
    if "fc_bert" in path:
        return "text_tower"
    if "fc_cv" in path:
        return "image_tower"
    if path.startswith("text_tower/"):
        if path.startswith("text_tower/fc/"):
            return "recsys"
        if "lora_" in path or "adapter" in path:
            return "adapter_text"
        return "text_tower"
    if path.startswith("image_tower/"):
        if path.startswith("image_tower/classifier/"):
            return "recsys"
        if "lora_" in path or "adapter" in path:
            return "adapter_cv"
        return "image_tower"
    return "recsys"


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: group} over the model's parameters."""
    return {name: label_for_path(name.replace(".", "/"))
            for name, _ in model.named_parameters()}


def group_lrs(cfg) -> Dict[str, float]:
    return {"text_tower": cfg.fine_tune_lr_text,
            "image_tower": cfg.fine_tune_lr_image,
            "recsys": cfg.lr,
            "adapter_cv": cfg.adapter_cv_lr,
            "adapter_text": cfg.adapter_bert_lr}


def log_group_sizes(cfg, model: torch.nn.Module,
                    trainable_mask: Optional[Dict[str, bool]] = None
                    ) -> Dict[str, int]:
    """Per-group counts of trainable parameter tensors, logged as the
    reference's '***** N parameters have learning rate LR *****' lines."""
    counts = {g: 0 for g in GROUPS}
    for name, label in param_labels(model).items():
        if trainable_mask is None or trainable_mask[name]:
            counts[label] += 1
    lrs = group_lrs(cfg)
    for g, n in counts.items():
        if n:
            log.info("***** %d parameters have learning rate %g *****", n, lrs[g])
    return counts


def build_optimizer(cfg, model: torch.nn.Module,
                    trainable_mask: Optional[Dict[str, bool]] = None
                    ) -> torch.optim.Adam:
    """One Adam with the five groups (torch defaults b1=.9 b2=.999
    eps=1e-8, as optax's ``adam`` in the JAX package); a group may be
    empty.  Each group carries its name under ``"name"``.  Parameters
    whose ``trainable_mask`` entry is False are in no group."""
    labels = param_labels(model)
    params = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if trainable_mask is None or trainable_mask[name]:
            params[labels[name]].append(p)
    lrs = group_lrs(cfg)
    return torch.optim.Adam(
        [{"params": params[g], "lr": lrs[g], "name": g} for g in GROUPS],
        betas=(0.9, 0.999), eps=1e-8)
