"""Tower wrappers and the uncached recommendation models.

Port of ``iisan_tpu/models/towers.py``:

- ``TextTower``: BERT over the packed ``[ids | mask]`` title row, then
  ``gelu(fc(CLS))`` and the hidden stack;
- ``ImageTower``: ViT, then ``gelu(classifier(CLS of the final-LN
  output))`` and the hidden stack;
- ``take_cls_taps``: hidden stack -> (N, K, D) CLS taps for the SAN;
- ``UncachedIISANModel``: both towers in the step, their CLS taps -> SAN
  -> ``com_dense`` -> SASRec -> in-batch loss.  Frozen towers run under
  ``torch.no_grad()`` and their taps are detached (the JAX package's
  ``stop_gradient``), so no tower activation is kept for a backward;
- ``FFTRecModel``: the full fine-tuning baseline, the towers' output heads
  fused by ``com_dense`` (the "fft" modality) and trained end to end;
- ``towers_from_config``: both towers at the configuration's geometry,
  with the JAX package's checks of ``tower_quant`` and
  ``fused_tower_attention``.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import sequence_train_loss
from .bert import BertEncoder
from .model import ComDense
from .modules import TorchLinear, XavierLinear
from .san import SideAdapterNetwork
from .user_encoder import UserEncoder
from .vit import ViTEncoder


class TextTower(nn.Module):
    """BERT + CLS head; ``tokens`` (N, 2 * num_words) int, ids then mask."""

    def __init__(self, bert: BertEncoder, hidden_dim: int, embedding_dim: int,
                 num_words: int, device=None, generator=None):
        super().__init__()
        self.bert, self.num_words = bert, num_words
        self.fc = TorchLinear(hidden_dim, embedding_dim, device=device,
                              generator=generator)

    def forward(self, tokens, deterministic: bool = True, generator=None):
        nw = self.num_words
        last, hiddens = self.bert(tokens[:, :nw], tokens[:, nw:2 * nw],
                                  deterministic, generator)
        return F.gelu(self.fc(last[:, 0])), hiddens


class ImageTower(nn.Module):
    """ViT + the re-initialised classifier head."""

    def __init__(self, vit: ViTEncoder, hidden_dim: int, embedding_dim: int,
                 device=None, generator=None):
        super().__init__()
        self.vit = vit
        self.classifier = XavierLinear(hidden_dim, embedding_dim,
                                       device=device, generator=generator)

    def forward(self, images, deterministic: bool = True, generator=None):
        pooled, hiddens = self.vit(images, deterministic, generator)
        return F.gelu(self.classifier(pooled[:, 0])), hiddens


def take_cls_taps(hiddens: torch.Tensor, tap_ids: Sequence[int]) -> torch.Tensor:
    """(layers+1, N, T, D) or CLS-only (layers+1, N, D) hidden stack ->
    (N, K, D) CLS taps of the listed rows."""
    taps = hiddens[list(tap_ids)]
    if taps.dim() == 4:
        taps = taps[:, :, 0, :]
    return taps.transpose(0, 1)


class UncachedIISANModel(nn.Module):
    """Towers in the step + SAN + user encoder (IISAN, uncached)."""

    def __init__(self, text_tower: TextTower, image_tower: ImageTower,
                 san: SideAdapterNetwork, embedding_dim: int, max_seq_len: int,
                 num_attention_heads: int, transformer_block: int,
                 drop_rate: float, text_tap_ids: Tuple[int, ...],
                 image_tap_ids: Tuple[int, ...], modality: str = "intra_inter",
                 freeze_towers: bool = True, dtype=None,
                 fused_user_encoder: Optional[bool] = None, device=None,
                 generator=None):
        super().__init__()
        self.text_tower, self.image_tower, self.san = text_tower, image_tower, san
        self.embedding_dim, self.max_seq_len = embedding_dim, max_seq_len
        self.text_tap_ids, self.image_tap_ids = text_tap_ids, image_tap_ids
        self.freeze_towers = freeze_towers
        self.user_encoder = UserEncoder(
            embedding_dim, max_seq_len, num_attention_heads, transformer_block,
            drop_rate, dtype, fused_user_encoder, device, generator)
        self.fuse = ComDense(embedding_dim, modality, dtype, device, generator)

    def encode_taps(self, images, tokens, deterministic: bool = True,
                    generator=None):
        """Both towers -> (cv taps, text taps), each (N, K, D)."""
        frozen = self.freeze_towers
        with torch.no_grad() if frozen else contextlib.nullcontext():
            _, h_cv = self.image_tower(images, deterministic, generator)
            _, h_text = self.text_tower(tokens, deterministic, generator)
        cv_taps = take_cls_taps(h_cv, self.image_tap_ids)
        text_taps = take_cls_taps(h_text, self.text_tap_ids)
        if frozen:
            cv_taps, text_taps = cv_taps.detach(), text_taps.detach()
        return cv_taps, text_taps

    def item_embeddings(self, images, tokens):
        return self.san(*self.encode_taps(images, tokens, True))

    def fuse_embeddings(self, emb_cv, emb_text, emb_mm):
        return self.fuse(emb_cv, emb_text, emb_mm)

    def user_scores(self, input_embs, log_mask, deterministic: bool = True):
        return self.user_encoder(input_embs, log_mask, deterministic)

    def forward(self, item_ids, images, tokens, log_mask, pop_prob,
                deterministic: bool = False, generator=None):
        """Training loss: item_ids (bs, L+1); images (bs*(L+1), H, W, 3)
        normalised; tokens (bs*(L+1), 2 * num_words); log_mask (bs, L)."""
        cv_taps, text_taps = self.encode_taps(images, tokens, deterministic,
                                              generator)
        score_embs = self.fuse(*self.san(cv_taps, text_taps))
        return sequence_train_loss(self.user_encoder, score_embs, item_ids,
                                   log_mask, pop_prob, self.max_seq_len,
                                   self.embedding_dim, deterministic, generator)


class FFTRecModel(nn.Module):
    """Two-tower full fine-tuning baseline: the towers' head outputs fused
    by ``com_dense`` ("fft": Linear(2*emb -> emb) on [cv, text])."""

    def __init__(self, text_tower: TextTower, image_tower: ImageTower,
                 embedding_dim: int, max_seq_len: int, num_attention_heads: int,
                 transformer_block: int, drop_rate: float, dtype=None,
                 fused_user_encoder: Optional[bool] = None, device=None,
                 generator=None):
        super().__init__()
        self.text_tower, self.image_tower = text_tower, image_tower
        self.embedding_dim, self.max_seq_len = embedding_dim, max_seq_len
        self.user_encoder = UserEncoder(
            embedding_dim, max_seq_len, num_attention_heads, transformer_block,
            drop_rate, dtype, fused_user_encoder, device, generator)
        self.fuse = ComDense(embedding_dim, "fft", dtype, device, generator)

    def item_embeddings(self, images, tokens):
        emb_cv, _ = self.image_tower(images, True)
        emb_text, _ = self.text_tower(tokens, True)
        return emb_cv, emb_text, None

    def fuse_embeddings(self, emb_cv, emb_text, emb_mm):
        return self.fuse(emb_cv, emb_text, emb_mm)

    def user_scores(self, input_embs, log_mask, deterministic: bool = True):
        return self.user_encoder(input_embs, log_mask, deterministic)

    def forward(self, item_ids, images, tokens, log_mask, pop_prob,
                deterministic: bool = False, generator=None):
        emb_cv, _ = self.image_tower(images, deterministic, generator)
        emb_text, _ = self.text_tower(tokens, deterministic, generator)
        score_embs = self.fuse(emb_cv, emb_text, None)
        return sequence_train_loss(self.user_encoder, score_embs, item_ids,
                                   log_mask, pop_prob, self.max_seq_len,
                                   self.embedding_dim, deterministic, generator)


def towers_from_config(cfg, dtype=None, device=None, generator=None):
    """(TextTower, ImageTower) at the configuration's geometry: heads of
    width 64, MLP 4x, BERT dropout 0.1 and ViT 0.0 unless
    ``tower_dropout`` >= 0 sets both; CLS-only hidden stacks;
    ``tower_quant="int8"`` gives W8A8 encoders (their heads stay float).
    Raises ``ValueError`` where the JAX package does (an unknown or
    removed quant value, int8 towers that train, an unknown attention
    route) and ``NotImplementedError`` for what the port does not have."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    quant = getattr(cfg, "tower_quant", "none")
    if quant == "int8_pallas":
        raise ValueError(
            "tower_quant='int8_pallas' was removed: the fused kernel "
            "measured slower than the XLA int8 path at every tower "
            "geometry (INT8_IMPL_BENCH.json sweep). Use tower_quant="
            "'int8'.")
    if quant not in ("none", "int8"):
        raise ValueError(f"unsupported tower_quant={quant!r} "
                         "(expected 'none' or 'int8')")
    if quant != "none" and not cfg.towers_frozen():
        raise ValueError("tower_quant='int8' requires frozen towers "
                         "(IISAN with fine_tune_to != 'all' and "
                         "finetune_layernorm 'None')")
    fta = getattr(cfg, "fused_tower_attention", True)
    if fta not in (True, False, "subblock", "subblock_v2"):
        raise ValueError(f"unknown fused_tower_attention {fta!r}: expected "
                         "True, False, 'subblock' or 'subblock_v2'")
    if fta in ("subblock", "subblock_v2") and not cfg.towers_frozen():
        # The subblock ops have no backward with dropout on; the JAX
        # package falls back to fused_mha here without a word.
        warnings.warn(f"fused_tower_attention={fta!r} has no training "
                      "backward: the towers train, so they run fused_mha "
                      "(fused_tower_attention=True) instead", stacklevel=2)
        fta = True
    if getattr(cfg, "remat_towers", False):
        raise NotImplementedError("remat_towers is not ported yet")
    if cfg.adding_adapter_to != "None" and cfg.adapter_type in (
            "lora", "houslby", "houlsby", "adapter"):
        raise NotImplementedError(f"adapter_type={cfg.adapter_type!r} (LoRA / "
                                  "Houlsby tower adapters) is not ported yet")
    if cfg.active_text_attributes() != ("title",):
        raise NotImplementedError("multi-attribute text items are not ported "
                                  "yet (news_attributes must be title only)")
    td = getattr(cfg, "tower_dropout", -1.0)
    D_t, D_v = cfg.word_embedding_dim, cfg.image_embedding_dim
    bert = BertEncoder(hidden_dim=D_t, num_layers=cfg.text_layers,
                       num_heads=max(1, D_t // 64), intermediate_dim=4 * D_t,
                       dtype=dtype, dropout=td if td >= 0 else 0.1,
                       fused_attention=fta, collect="cls", quant=quant,
                       device=device, generator=generator)
    vit = ViTEncoder(image_size=cfg.CV_resize, hidden_dim=D_v,
                     num_layers=cfg.image_layers, num_heads=max(1, D_v // 64),
                     intermediate_dim=4 * D_v, dtype=dtype,
                     dropout=td if td >= 0 else 0.0, fused_attention=fta,
                     collect="cls", quant=quant, device=device,
                     generator=generator)
    text = TextTower(bert, D_t, cfg.embedding_dim, cfg.num_words_title, device,
                     generator)
    image = ImageTower(vit, D_v, cfg.embedding_dim, device, generator)
    return text, image
