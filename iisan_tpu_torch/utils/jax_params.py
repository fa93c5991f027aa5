"""Weight bridge between the JAX package's param trees and the port.

The port's modules keep the JAX tree's names, so a leaf at path
``("san", "fc_bert", "kernel")`` is the torch parameter
``san.fc_bert.kernel``.  Layouts are kept as well: a linear's ``kernel``
stays ``(in, out)`` in both packages, and stacked adapter weights stay
``(K, ...)``.  So the bridge is a rename with shape checks, nothing more.

Scanned stacks: the JAX Llama, CLIP and EVA towers run their layers as
one ``nn.scan``, so their trees hold every layer under ``layers.block.*``
with a leading layer axis.  The port's towers keep one submodule a layer
(``layers.0.*``, ``layers.1.*``, ...) and name such a child in their
``jax_scan`` attribute; the bridge unstacks that subtree on the way in and
stacks it on the way out, and its strict checks see the per-layer names.

Embedding tables: flax ``nn.Embed`` names its table ``embedding``, so an
``nn.Embedding``'s ``weight`` (the ID model's ``id_embedding``) crosses
the bridge under that name.

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


SCAN_BLOCK = "block"


def _scan_prefixes(model: nn.Module):
    """Dotted names of the children that the JAX tree stacks under
    ``<name>.block`` (modules' ``jax_scan`` attribute)."""
    return [f"{name}.{child}" if name else child
            for name, m in model.named_modules()
            for child in getattr(m, "jax_scan", ())]


def _unscan(leaves: Dict[str, object], prefixes) -> Dict[str, object]:
    """``<p>.block.<rest>`` of shape (L, ...) -> ``<p>.<i>.<rest>``."""
    out = {}
    for name, value in leaves.items():
        p = next((p for p in prefixes
                  if name.startswith(f"{p}.{SCAN_BLOCK}.")), None)
        if p is None:
            out[name] = value
            continue
        rest = name[len(p) + len(SCAN_BLOCK) + 2:]
        for i, layer in enumerate(np.asarray(value)):
            out[f"{p}.{i}.{rest}"] = layer
    return out


def _scan(flat: Dict[str, np.ndarray], prefixes) -> Dict[str, np.ndarray]:
    """The inverse of ``_unscan``: per-layer leaves stacked in layer order."""
    out, stacks = {}, {}
    for name, value in flat.items():
        p = next((p for p in prefixes if name.startswith(p + ".")), None)
        if p is None:
            out[name] = value
            continue
        i, rest = name[len(p) + 1:].split(".", 1)
        stacks.setdefault(f"{p}.{SCAN_BLOCK}.{rest}", {})[int(i)] = value
    for name, layers in stacks.items():
        out[name] = np.stack([layers[i] for i in sorted(layers)])
    return out


def _tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and its int8 buffers, by dotted name; an
    ``nn.Embedding``'s ``weight`` carries the name of flax ``nn.Embed``'s
    parameter, ``embedding``."""
    embeds = {name for name, m in model.named_modules()
              if isinstance(m, nn.Embedding)}
    own = {}
    for name, p in model.named_parameters():
        parent, _, leaf = name.rpartition(".")
        if leaf == "weight" and parent in embeds:
            name = f"{parent}.embedding" if parent else "embedding"
        own[name] = p
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
    leaves = _unscan(flatten_tree(params), _scan_prefixes(model))
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
    and int8 for the int8 buffers; scanned stacks stacked again."""
    flat = {}
    for name, p in _tensors(model).items():
        t = p.detach().cpu()
        flat[name] = (t if p.dtype == torch.int8 else t.float()).numpy()
    tree: dict = {}
    for name, value in _scan(flat, _scan_prefixes(model)).items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
