"""Decoupled intra-/inter-modal Side Adapter Network (SAN).

Port of ``iisan_tpu/models/san.py``, symmetric and asymmetric towers.  The
SAN reads the selected hidden-state rows ("taps") of two frozen towers and
runs three gated adapter cascades: text-intra, image-intra, and the inter
(mm) branch over gate-mixed taps.  The adapters of a branch are stacked
``(K, ...)`` parameters, which the cascade (and its kernels) consumes as
they are.

IISAN-Versa (asymmetric towers, ``pipeline="cached_asym"``):

- group layer-drop: with Kt != Kc taps the inter branch has
  ``k_mm = min(Kt, Kc)`` steps over the last ``k_mm`` taps of each side;
- dimension-transform alignment: the inter branch is ``min(text_dim,
  image_dim)`` wide, and the wider side's taps go through one
  ``down_project_list_{i}`` linear per step first;
- ``head_mode="asym"``: ``fc_bert``/``fc_cv`` map a carry to the
  embedding width and ``bert_pre_fc``/``cv_pre_fc`` are emb -> emb.

Dispatch, as in the JAX module:

- ``batch_intra`` with both intra branches and the inter branch at one
  geometry runs all three as one ``multi_reference_cascade`` (the default
  configuration);
- ``batch_intra`` otherwise batches the two intra branches;
- otherwise each intra branch runs on its own: ``fused_cascade`` when
  ``use_pallas`` and the taps are on the GPU (a CUDA kernel chosen by the
  JAX package's dispatch rule: the resident kernel at ViT widths, the
  streamed one at Versa's 8192), else ``reference_cascade``.  The inter
  branch always runs ``reference_cascade``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.fused_san import (GATE_TEMPERATURE, cascade_coefs, fused_cascade,
                             multi_reference_cascade, reference_cascade)
from .modules import TorchLinear, XavierLinear, adapter_normal_init


class SideAdapterNetwork(nn.Module):
    """IISAN side network, symmetric or asymmetric.

    Inputs: cv_states (N, Kc + first, image_dim), text_states
    (N, Kt + first, text_dim), where ``first`` is 1 with ``remove_first``
    (row 0 then is the cascade's initial carry) and 0 otherwise.
    Returns (emb_cv, emb_text, emb_mm), None for a branch not in
    ``modality``.
    """

    def __init__(self, embedding_dim: int, text_dim: int = 768,
                 image_dim: int = 768, num_text_taps: int = 7,
                 num_image_taps: int = 7, bert_down_size: int = 64,
                 cv_down_size: int = 64, activation: str = "RELU",
                 remove_first: bool = False, gated: bool = True,
                 modality: str = "intra_inter", head_mode: str = "cached",
                 use_pallas: bool = False, batch_intra: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        if head_mode not in ("cached", "asym"):
            raise ValueError(f"unknown head_mode {head_mode!r}")
        self.text_dim, self.image_dim = text_dim, image_dim
        self.kt, self.kc = num_text_taps, num_image_taps
        self.bert_down_size, self.cv_down_size = bert_down_size, cv_down_size
        self.activation = activation
        self.remove_first = remove_first
        self.gated = gated
        self.use_pallas = use_pallas
        self.batch_intra = batch_intra
        self.dtype = dtype
        self.intra = "intra" in modality
        self.inter = "inter" in modality
        self.mm_dim = min(text_dim, image_dim)
        self.k_mm = min(self.kt, self.kc)
        # the inter branch's bottleneck: the cv one only when the text
        # tower is strictly wider
        self.mm_down = cv_down_size if text_dim > image_dim else bert_down_size

        def stack(name, k, d, r):
            setattr(self, f"{name}_wd", nn.Parameter(
                adapter_normal_init((k, d, r), device, generator)))
            setattr(self, f"{name}_bd", nn.Parameter(
                torch.zeros(k, r, device=device)))
            setattr(self, f"{name}_wu", nn.Parameter(
                adapter_normal_init((k, r, d), device, generator)))
            setattr(self, f"{name}_bu", nn.Parameter(
                torch.zeros(k, d, device=device)))

        def linear(name, fan_in, fan_out, cls=TorchLinear):
            self.add_module(name, cls(fan_in, fan_out, dtype=dtype,
                                      device=device, generator=generator))

        if self.intra:
            stack("bert_adapter_list", self.kt, text_dim, bert_down_size)
            stack("cv_adapter_list", self.kc, image_dim, cv_down_size)
            if gated:
                self.side_gate_params_text = nn.Parameter(
                    torch.zeros(self.kt, device=device))
                self.side_gate_params_cv = nn.Parameter(
                    torch.zeros(self.kc, device=device))
        if self.inter:
            stack("mm_adapter_list", self.k_mm, self.mm_dim, self.mm_down)
            self.side_gate_params_mm = nn.Parameter(
                torch.zeros(self.k_mm, device=device))
            for i in range(self.k_mm if text_dim != image_dim else 0):
                linear(f"down_project_list_{i}", max(text_dim, image_dim),
                       self.mm_dim)
        if self.intra and head_mode == "cached":
            linear("fc_bert", text_dim, text_dim)
            linear("fc_cv", image_dim, image_dim)
            linear("bert_pre_fc", text_dim, embedding_dim)
            linear("cv_pre_fc", image_dim, embedding_dim, XavierLinear)
        elif self.intra:
            linear("fc_bert", text_dim, embedding_dim)
            linear("fc_cv", image_dim, embedding_dim)
            linear("bert_pre_fc", embedding_dim, embedding_dim)
            linear("cv_pre_fc", embedding_dim, embedding_dim)
        if self.inter:
            linear("fc_mm", self.mm_dim, self.mm_dim)
            linear("fc_mm_down", self.mm_dim, embedding_dim)

    def _stack(self, name: str, dtype) -> dict:
        return {key: getattr(self, f"{name}_{key}").to(dtype)
                for key in ("wd", "bd", "wu", "bu")}

    def _gates(self, branch: str, k: int, device) -> torch.Tensor:
        if self.gated:
            return getattr(self, f"side_gate_params_{branch}")
        return torch.zeros(k, device=device)  # read by no cascade

    def forward(self, cv_states, text_states):
        dtype = self.dtype or text_states.dtype
        cv_states = cv_states.to(dtype)
        text_states = text_states.to(dtype)
        n, device = text_states.shape[0], text_states.device
        kt, kc, k_mm = self.kt, self.kc, self.k_mm
        intra, inter = self.intra, self.inter

        if self.remove_first:
            carry_text, carry_cv = text_states[:, 0, :], cv_states[:, 0, :]
            text_taps, cv_taps = text_states[:, 1:, :], cv_states[:, 1:, :]
        else:
            carry_text = torch.zeros((n, self.text_dim), dtype=dtype, device=device)
            carry_cv = torch.zeros((n, self.image_dim), dtype=dtype, device=device)
            text_taps, cv_taps = text_states, cv_states
        carry_mm = torch.zeros((n, self.mm_dim), dtype=dtype, device=device)

        if intra:
            text_stack = self._stack("bert_adapter_list", dtype)
            cv_stack = self._stack("cv_adapter_list", dtype)
            gates_text = self._gates("text", kt, device)
            gates_cv = self._gates("cv", kc, device)
        if inter:
            mm_stack = self._stack("mm_adapter_list", dtype)
            # Inter-branch tap fusion: the gate mixes the two modalities'
            # taps; the mm recurrence is then the additive cascade.
            mm_text = text_taps[:, kt - k_mm:, :]
            mm_cv = cv_taps[:, kc - k_mm:, :]
            def project(taps):  # the wider side's taps to the mm width
                return torch.stack(
                    [getattr(self, f"down_project_list_{i}")(taps[:, i, :])
                     for i in range(k_mm)], dim=1)

            if self.text_dim > self.image_dim:
                mm_text = project(mm_text)
            elif self.image_dim > self.text_dim:
                mm_cv = project(mm_cv)
            g_mm = torch.sigmoid(self.side_gate_params_mm.float()
                                 / GATE_TEMPERATURE)[None, :, None]
            mm_taps = (g_mm * mm_cv.float()
                       + (1.0 - g_mm) * mm_text.float()).to(dtype)

        use_fused = intra and self.use_pallas and text_states.is_cuda
        symmetric = (kt == kc and self.text_dim == self.image_dim
                     and self.bert_down_size == self.cv_down_size)
        tri = (self.batch_intra and intra and inter and symmetric
               and not use_fused and kt == k_mm
               and self.mm_down == self.bert_down_size)

        def stacked(key, stacks):
            return torch.stack([s[key] for s in stacks])

        if tri:
            a_t, b_t = cascade_coefs(gates_text, self.gated)
            a_c, b_c = cascade_coefs(gates_cv, self.gated)
            ones = torch.ones(k_mm, dtype=torch.float32, device=device)
            stacks = (text_stack, cv_stack, mm_stack)
            out3 = multi_reference_cascade(
                torch.stack([a_t, a_c, ones]), torch.stack([b_t, b_c, ones]),
                torch.stack([text_taps, cv_taps, mm_taps]),
                stacked("wd", stacks), stacked("bd", stacks),
                stacked("wu", stacks), stacked("bu", stacks),
                torch.stack([carry_text, carry_cv, carry_mm]),
                activation=self.activation)
            carry_text, carry_cv, carry_mm = out3[0], out3[1], out3[2]
        else:
            if intra and self.batch_intra and symmetric and not use_fused:
                a_t, b_t = cascade_coefs(gates_text, self.gated)
                a_c, b_c = cascade_coefs(gates_cv, self.gated)
                stacks = (text_stack, cv_stack)
                out2 = multi_reference_cascade(
                    torch.stack([a_t, a_c]), torch.stack([b_t, b_c]),
                    torch.stack([text_taps, cv_taps]),
                    stacked("wd", stacks), stacked("bd", stacks),
                    stacked("wu", stacks), stacked("bu", stacks),
                    torch.stack([carry_text, carry_cv]),
                    activation=self.activation)
                carry_text, carry_cv = out2[0], out2[1]
            elif intra:
                run = fused_cascade if use_fused else reference_cascade

                def cascade(gates, stack, taps, c0):
                    return run(gates, taps, stack["wd"], stack["bd"],
                               stack["wu"], stack["bu"], c0,
                               activation=self.activation, gated=self.gated)

                carry_text = cascade(gates_text, text_stack, text_taps,
                                     carry_text)
                carry_cv = cascade(gates_cv, cv_stack, cv_taps, carry_cv)
            if inter:
                carry_mm = reference_cascade(
                    self.side_gate_params_mm, mm_taps, mm_stack["wd"],
                    mm_stack["bd"], mm_stack["wu"], mm_stack["bu"], carry_mm,
                    activation=self.activation, gated=False)

        emb_cv = emb_text = emb_mm = None
        if intra:
            emb_text = self.bert_pre_fc(self.fc_bert(carry_text))
            emb_cv = self.cv_pre_fc(self.fc_cv(carry_cv))
        if inter:
            emb_mm = self.fc_mm_down(self.fc_mm(carry_mm))
        return emb_cv, emb_text, emb_mm


def san_from_config(cfg, device=None, generator=None) -> SideAdapterNetwork:
    """Build the SAN from an ``IISANConfig``: for ``pipeline="cached_asym"``
    the text width is ``text_embedding_dim`` and the heads are "asym"."""
    first = 1 if cfg.remove_first_bool else 0
    asym = cfg.pipeline == "cached_asym"
    return SideAdapterNetwork(
        embedding_dim=cfg.embedding_dim,
        text_dim=cfg.text_embedding_dim if asym else cfg.word_embedding_dim,
        image_dim=cfg.image_embedding_dim,
        num_text_taps=len(cfg.san_text_taps()) - first,
        num_image_taps=len(cfg.san_image_taps()) - first,
        bert_down_size=cfg.bert_adapter_down_size,
        cv_down_size=cfg.cv_adapter_down_size,
        activation=cfg.adapter_activation,
        remove_first=cfg.remove_first_bool,
        gated=cfg.gated,
        modality=cfg.modality,
        head_mode="asym" if asym else "cached",
        use_pallas=cfg.use_pallas,
        batch_intra=getattr(cfg, "batch_intra_branches", False),
        dtype=getattr(torch, cfg.compute_dtype),
        device=device, generator=generator,
    )
