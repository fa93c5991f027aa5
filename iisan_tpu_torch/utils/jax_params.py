"""Weight bridge between the JAX package's param trees and the port.

The port's modules keep the JAX tree's names, so a leaf at path
``("san", "fc_bert", "kernel")`` is the torch parameter
``san.fc_bert.kernel``.  Layouts are kept as well: a linear's ``kernel``
stays ``(in, out)`` in both packages, and stacked adapter weights stay
``(K, ...)``.  So the bridge is a rename with shape checks, nothing more.
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


def load_jax_params(model: nn.Module, params) -> None:
    """Copy a JAX param tree (nested dicts of arrays) into ``model``.

    Strict: every leaf must name a parameter of the model and every
    parameter must be set, with equal shapes; anything else raises before
    a single value is copied.  Values are cast to the parameter's dtype.
    """
    leaves = flatten_tree(params)
    own = dict(model.named_parameters())
    missing = sorted(own.keys() - leaves.keys())
    extra = sorted(leaves.keys() - own.keys())
    if missing or extra:
        raise KeyError(f"JAX params do not match the model: missing "
                       f"{missing[:8]}, unexpected {extra[:8]}")
    arrays = {}
    for name, p in own.items():
        arr = np.asarray(leaves[name], dtype=np.float32)
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape}, torch shape "
                             f"{tuple(p.shape)}")
        arrays[name] = arr
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(torch.tensor(arrays[name]))


def export_jax_params(model: nn.Module) -> dict:
    """The model's parameters as a JAX-layout tree of fp32 numpy arrays."""
    tree: dict = {}
    for name, p in model.named_parameters():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().float().cpu().numpy()
    return tree
