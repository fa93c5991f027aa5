"""Weight bridge between the JAX package's param trees and the port.

The port's modules keep the JAX tree's names, so a leaf at path
``("san", "fc_bert", "kernel")`` is the torch parameter
``san.fc_bert.kernel``.  Layouts are kept as well: a linear's ``kernel``
stays ``(in, out)`` in both packages, and stacked adapter weights stay
``(K, ...)``.  So the bridge is a rename with shape checks, nothing more.

Int8 leaves (the W8A8 towers' ``kernel_q``, ``ops/int8_linear.Int8Dense``)
live in int8 buffers, not parameters: autograd tracks no int8 tensor.  The
bridge carries them bit for bit both ways, and counts them in its strict
name and shape check like any parameter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def flatten_tree(tree, sep: str = ".", prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> {"a<sep>b<sep>c": leaf}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{sep}{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_tree(value, sep, name))
        else:
            out[name] = value
    return out


def _tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and its int8 buffers, by dotted name."""
    own = dict(model.named_parameters())
    own.update((n, b) for n, b in model.named_buffers()
               if b.dtype == torch.int8)
    return own


def load_jax_params(model: nn.Module, params) -> None:
    """Copy a JAX param tree (nested dicts of arrays) into ``model``.

    Strict: every leaf must name a parameter or int8 buffer of the model
    and every one of those must be set, with equal shapes; an int8 buffer
    takes only an int8 leaf.  Anything else raises before a single value
    is copied.  Float values are cast to the parameter's dtype; int8
    values are copied as they are.
    """
    leaves = flatten_tree(params)
    own = _tensors(model)
    missing = sorted(own.keys() - leaves.keys())
    extra = sorted(leaves.keys() - own.keys())
    if missing or extra:
        raise KeyError(f"JAX params do not match the model: missing "
                       f"{missing[:8]}, unexpected {extra[:8]}")
    arrays = {}
    for name, p in own.items():
        arr = np.asarray(leaves[name])
        if p.dtype == torch.int8:
            if arr.dtype != np.int8:
                raise TypeError(f"{name}: int8 buffer, JAX leaf of dtype "
                                f"{arr.dtype}")
        else:
            arr = arr.astype(np.float32)
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape}, torch shape "
                             f"{tuple(p.shape)}")
        arrays[name] = arr
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(torch.tensor(arrays[name]))


def with_lora_factors(model: nn.Module, params) -> dict:
    """``params`` completed with the model's own ``lora_A`` / ``lora_B``
    where it has none (a tree from ``params_from_hf_torch(lora=True)``:
    a pretrained checkpoint holds no LoRA factors), ready for the strict
    ``load_jax_params``.  Nothing else is filled in."""
    tree, have = dict(params), flatten_tree(params)
    for name, p in model.named_parameters():
        *parents, leaf = name.split(".")
        if leaf not in ("lora_A", "lora_B") or name in have:
            continue
        node = tree
        for part in parents:
            node[part] = dict(node.get(part, {}))
            node = node[part]
        node[leaf] = p.detach().cpu().float().numpy()
    return tree


def export_jax_params(model: nn.Module) -> dict:
    """The model's parameters as a JAX-layout tree of numpy arrays: fp32,
    and int8 for the int8 buffers."""
    tree: dict = {}
    for name, p in _tensors(model).items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        t = p.detach().cpu()
        node[leaf] = (t if p.dtype == torch.int8 else t.float()).numpy()
    return tree
