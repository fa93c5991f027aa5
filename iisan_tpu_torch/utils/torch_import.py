"""Reference-trained checkpoints to and from the port's parameter trees.

Port of ``iisan_tpu/utils/torch_import.py``.  The reference saves
``{'model_state_dict': ..., 'optimizer': ..., 'rng_state': ...,
'cuda_rng_state': ...}`` per epoch as ``epoch-N.pt``.  For the cached
IISAN model its state dict holds the adapter stacks, gates, head
projections and the user encoder, not the frozen towers, so a model
trained by the reference loads here for more training or for serving
(``--pretrained_recsys_model path/to/epoch-N.pt``).

The mappings are on state-dict keys and numpy arrays: a torch linear's
``weight`` (out, in) becomes the JAX-layout ``kernel`` (in, out), adapter
ModuleLists stack into the (K, ...) tensors of the vectorised cascades.
The result is a JAX-named numpy tree, which
``utils/jax_params.load_jax_params`` loads into a port model (checked
first against ``export_jax_params`` of that model, ``template=``).

Scope, as in the JAX package: the cached and cached_asym families, the ID
model and uncached FFT (unmodified transformers towers, through
``models/{bert,vit}.params_from_hf_torch``, plus the heads).  Uncached
IISAN, LoRA and Houlsby checkpoints are refused.
``reference_state_dict_from_params`` / ``save_reference_checkpoint`` are
the inverse for the cached and ID families.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class ImportError_(Exception):
    """Raised when a checkpoint does not match the expected layout."""


def _t2n(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _lin(sd, name: str) -> Dict[str, np.ndarray]:
    return {"kernel": _t2n(sd[f"{name}.weight"]).T,
            "bias": _t2n(sd[f"{name}.bias"])}


def _ln(sd, name: str) -> Dict[str, np.ndarray]:
    return {"scale": _t2n(sd[f"{name}.weight"]),
            "bias": _t2n(sd[f"{name}.bias"])}


def user_encoder_params_from_reference(sd, prefix: str = "user_encoder."
                                       ) -> Dict:
    """SASRec tower: ``{prefix}transformer_encoder...`` keys -> the
    ``UserEncoder`` tree."""
    te = f"{prefix}transformer_encoder."
    if f"{te}position_embedding.weight" not in sd:
        raise ImportError_(f"no user encoder under '{prefix}'")
    out = {"position_embedding": _t2n(sd[f"{te}position_embedding.weight"]),
           "layer_norm": _ln(sd, f"{te}layer_norm")}
    i = 0
    while f"{te}transformer_blocks.{i}.multi_head_attention.w_Q.weight" in sd:
        blk = f"{te}transformer_blocks.{i}."
        mha = blk + "multi_head_attention."
        out[f"transformer_blocks_{i}"] = {
            "multi_head_attention": {
                # the reference's projections have no bias
                **{proj: {"kernel": _t2n(sd[f"{mha}{proj}.weight"]).T}
                   for proj in ("w_Q", "w_K", "w_V", "fc")},
                "layer_norm": _ln(sd, mha + "layer_norm"),
            },
            "feed_forward": {
                "w_1": _lin(sd, blk + "feed_forward.w_1"),
                "w_2": _lin(sd, blk + "feed_forward.w_2"),
                "layer_norm": _ln(sd, blk + "feed_forward.layer_norm"),
            },
        }
        i += 1
    if i == 0:
        raise ImportError_(f"no transformer blocks under '{te}'")
    return {"transformer_encoder": out}


def san_params_from_reference(sd, prefix: str = "mm_encoder.") -> Dict:
    """SAN: adapter ModuleLists -> stacked (K, ...) weight groups, gate
    ParameterLists -> (K,) arrays, head and pre-fc Linears -> kernels.
    Branches the checkpoint lacks (modality other than intra_inter) are not
    emitted."""
    out: Dict = {}
    emitted = False
    for lst in ("bert_adapter_list", "cv_adapter_list", "mm_adapter_list"):
        wd, bd, wu, bu = [], [], [], []
        i = 0
        while f"{prefix}{lst}.{i}.fc_down.weight" in sd:
            wd.append(_t2n(sd[f"{prefix}{lst}.{i}.fc_down.weight"]).T)
            bd.append(_t2n(sd[f"{prefix}{lst}.{i}.fc_down.bias"]))
            wu.append(_t2n(sd[f"{prefix}{lst}.{i}.fc_up.weight"]).T)
            bu.append(_t2n(sd[f"{prefix}{lst}.{i}.fc_up.bias"]))
            i += 1
        if i:
            out[f"{lst}_wd"], out[f"{lst}_bd"] = np.stack(wd), np.stack(bd)
            out[f"{lst}_wu"], out[f"{lst}_bu"] = np.stack(wu), np.stack(bu)
            emitted = True
    for gates in ("side_gate_params_text", "side_gate_params_cv",
                  "side_gate_params_mm"):
        vals, i = [], 0
        while f"{prefix}{gates}.{i}" in sd:
            vals.append(_t2n(sd[f"{prefix}{gates}.{i}"]).reshape(-1)[0])
            i += 1
        if i:
            out[gates] = np.array(vals)
    for fc in ("fc_bert", "fc_cv", "fc_mm", "fc_mm_down",
               "cv_pre_fc", "bert_pre_fc"):
        if f"{prefix}{fc}.weight" in sd:
            out[fc] = _lin(sd, f"{prefix}{fc}")
            emitted = True
    # IISAN-Versa's dimension-alignment list
    i = 0
    while f"{prefix}down_project_list.{i}.weight" in sd:
        out[f"down_project_list_{i}"] = _lin(
            sd, f"{prefix}down_project_list.{i}")
        i += 1
    if not emitted:
        raise ImportError_(f"no SAN modules under '{prefix}'")
    return out


_BERT_PREFIX = "mm_encoder.bert_encoder.text_encoders.title.bert_model."
_IMAGE_NET_PREFIX = "mm_encoder.cv_encoder.image_net."   # ViTForImageClsf.


def fft_params_from_reference(sd) -> Dict:
    """Uncached FFT: unmodified transformers towers and the replaced title
    fc / classifier heads -> {text_tower, image_tower} trees."""
    from ..models import bert as bert_mod
    from ..models import vit as vit_mod

    bert_sd = {k[len(_BERT_PREFIX):]: v for k, v in sd.items()
               if k.startswith(_BERT_PREFIX)}
    # keep the inner "vit." prefix: the ViT importer reads the
    # ViTForImageClassification layout
    vit_sd = {k[len(_IMAGE_NET_PREFIX):]: v for k, v in sd.items()
              if k.startswith(_IMAGE_NET_PREFIX + "vit.")}
    if not bert_sd or not vit_sd:
        raise ImportError_("FFT checkpoint missing tower weights under "
                           f"'{_BERT_PREFIX}' / '{_IMAGE_NET_PREFIX}vit.'")

    def n_layers(tower_sd, prefix=""):
        return 1 + max(int(k[len(prefix):].split(".")[2]) for k in tower_sd
                       if k.startswith(prefix + "encoder.layer."))

    return {
        "text_tower": {
            "bert": bert_mod.params_from_hf_torch(
                bert_sd, num_layers=n_layers(bert_sd)),
            "fc": _lin(sd, "mm_encoder.bert_encoder.text_encoders.title.fc")},
        "image_tower": {
            "vit": vit_mod.params_from_hf_torch(
                vit_sd, num_layers=n_layers(vit_sd, "vit.")),
            "classifier": _lin(sd, _IMAGE_NET_PREFIX + "classifier")},
    }


def params_from_reference_checkpoint(ckpt, template: Optional[Dict] = None
                                     ) -> Dict:
    """A reference checkpoint -> a JAX-named numpy tree.

    ``ckpt``: the path of an ``epoch-N.pt`` (the reference's save layout or
    a bare state dict) or a loaded mapping.  ``template``: the target tree
    (``export_jax_params(model)``); imported leaves are checked against it
    in structure and shape and cast to its dtypes, and leaves the
    checkpoint does not cover keep the template's values.
    """
    if isinstance(ckpt, str):
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)

    out: Dict = {"user_encoder": user_encoder_params_from_reference(sd)}
    has_towers = any(k.startswith("mm_encoder.bert_encoder.") for k in sd)
    has_san = any(k.startswith(f"mm_encoder.{lst}.") for k in sd
                  for lst in ("bert_adapter_list", "cv_adapter_list",
                              "mm_adapter_list"))
    if has_towers and has_san:
        raise ImportError_(
            "uncached-IISAN checkpoints (towers + side network in one "
            "module) are not importable; train cached IISAN from rebuilt "
            "caches instead — the cached model is the same network")
    if has_towers:
        if any(".lora_" in k or ".adapter." in k or ".self_output." in k
               for k in sd):
            raise ImportError_(
                "LoRA/Houlsby checkpoints embed monkey-patched tower "
                "modules and are not importable — re-finetune (adapters "
                "retrain cheaply) or import base towers from HF weights")
        out.update(fft_params_from_reference(sd))
    elif any(k.startswith("mm_encoder.") for k in sd):
        out["san"] = san_params_from_reference(sd)
    elif "id_embedding.weight" in sd:
        out["id_embedding"] = {"embedding": _t2n(sd["id_embedding.weight"])}
    else:
        raise ImportError_(
            "checkpoint has neither mm_encoder.* nor id_embedding.* keys — "
            "not a reference ModelMM state dict")
    # The reference registers com_dense in ID mode too, where nothing reads
    # it; the ID model has no fuse layer, so those weights are dropped.
    if "com_dense.weight" in sd and "id_embedding" not in out:
        out["fuse"] = {"com_dense": _lin(sd, "com_dense")}

    if template is None:
        return out
    return _merge_into(template, out)


def reference_state_dict_from_params(params: Dict) -> Dict:
    """Inverse of the cached- and ID-family import: a {user_encoder, san |
    id_embedding, fuse} tree -> a reference ModelMM state dict of torch
    tensors, which the reference's ``load_state_dict`` takes.
    ``params_from_reference_checkpoint({'model_state_dict':
    reference_state_dict_from_params(p)}, p)`` gives ``p`` back."""
    sd: Dict = {}

    def tensor(x):
        return torch.tensor(np.asarray(x, dtype=np.float32))

    def put_lin(name, leaf):
        sd[f"{name}.weight"] = tensor(np.asarray(leaf["kernel"]).T)
        sd[f"{name}.bias"] = tensor(leaf["bias"])

    def put_ln(name, leaf):
        sd[f"{name}.weight"] = tensor(leaf["scale"])
        sd[f"{name}.bias"] = tensor(leaf["bias"])

    te = params["user_encoder"]["transformer_encoder"]
    base = "user_encoder.transformer_encoder"
    sd[f"{base}.position_embedding.weight"] = tensor(te["position_embedding"])
    put_ln(f"{base}.layer_norm", te["layer_norm"])
    i = 0
    while f"transformer_blocks_{i}" in te:
        blk = te[f"transformer_blocks_{i}"]
        name = f"{base}.transformer_blocks.{i}"
        mha, ff = blk["multi_head_attention"], blk["feed_forward"]
        for proj in ("w_Q", "w_K", "w_V", "fc"):
            sd[f"{name}.multi_head_attention.{proj}.weight"] = tensor(
                np.asarray(mha[proj]["kernel"]).T)
        put_ln(f"{name}.multi_head_attention.layer_norm", mha["layer_norm"])
        put_lin(f"{name}.feed_forward.w_1", ff["w_1"])
        put_lin(f"{name}.feed_forward.w_2", ff["w_2"])
        put_ln(f"{name}.feed_forward.layer_norm", ff["layer_norm"])
        i += 1

    if "san" in params:
        san = params["san"]
        for lst in ("bert_adapter_list", "cv_adapter_list",
                    "mm_adapter_list"):
            if f"{lst}_wd" not in san:
                continue
            for j in range(np.asarray(san[f"{lst}_wd"]).shape[0]):
                for half, w, b in (("fc_down", "wd", "bd"),
                                   ("fc_up", "wu", "bu")):
                    sd[f"mm_encoder.{lst}.{j}.{half}.weight"] = tensor(
                        np.asarray(san[f"{lst}_{w}"][j]).T)
                    sd[f"mm_encoder.{lst}.{j}.{half}.bias"] = tensor(
                        san[f"{lst}_{b}"][j])
        for gates in ("side_gate_params_text", "side_gate_params_cv",
                      "side_gate_params_mm"):
            if gates in san:
                for j, v in enumerate(np.asarray(san[gates])):
                    sd[f"mm_encoder.{gates}.{j}"] = tensor(
                        np.asarray(v).reshape(1))
        for fc in ("fc_bert", "fc_cv", "fc_mm", "fc_mm_down",
                   "cv_pre_fc", "bert_pre_fc"):
            if fc in san:
                put_lin(f"mm_encoder.{fc}", san[fc])
        j = 0
        while f"down_project_list_{j}" in san:
            put_lin(f"mm_encoder.down_project_list.{j}",
                    san[f"down_project_list_{j}"])
            j += 1
    elif "id_embedding" in params:
        sd["id_embedding.weight"] = tensor(
            params["id_embedding"]["embedding"])

    if "fuse" in params and "com_dense" in params["fuse"]:
        put_lin("com_dense", params["fuse"]["com_dense"])
    elif "id_embedding" in params:
        # ModelMM registers com_dense in ID mode too (never read there); a
        # fresh torch-default layer lets the reference's strict
        # load_state_dict take the export
        emb = int(np.asarray(params["id_embedding"]["embedding"]).shape[1])
        lin = torch.nn.Linear(emb * 2, emb)
        sd["com_dense.weight"] = lin.weight.detach()
        sd["com_dense.bias"] = lin.bias.detach()
    return sd


def save_reference_checkpoint(params: Dict, path: str) -> None:
    """Write a tree as a complete reference ``epoch-N.pt`` (the save layout
    with the rng fields the reference's warm start reads)."""
    torch.save({"model_state_dict": reference_state_dict_from_params(params),
                "optimizer": {},
                "rng_state": torch.get_rng_state(),
                "cuda_rng_state": torch.zeros(16, dtype=torch.uint8)}, path)


def _merge_into(template: Dict, imported: Dict, path: str = "") -> Dict:
    """The template's tree with the imported leaves in place; raises on a
    structure or shape mismatch (a silent one would train another model
    than the checkpoint's)."""
    merged = {}
    for k, tv in template.items():
        p = f"{path}/{k}"
        if k not in imported:
            merged[k] = tv
            continue
        iv = imported[k]
        if isinstance(tv, dict) != isinstance(iv, dict):
            raise ImportError_(f"{p}: tree/leaf structure mismatch")
        if isinstance(tv, dict):
            merged[k] = _merge_into(tv, iv, p)
        else:
            if tuple(np.shape(iv)) != tuple(np.shape(tv)):
                raise ImportError_(
                    f"{p}: shape {np.shape(iv)} != expected {np.shape(tv)} "
                    "(checkpoint geometry does not match the config)")
            merged[k] = np.asarray(iv, dtype=np.asarray(tv).dtype)
    extra = set(imported) - set(template)
    if extra:
        raise ImportError_(f"{path}: imported keys {sorted(extra)} not in "
                           "the target tree")
    return merged
