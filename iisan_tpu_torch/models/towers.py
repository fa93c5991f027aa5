"""Tower wrappers and the uncached recommendation models.

Port of ``iisan_tpu/models/towers.py``:

- ``TextTower``: BERT over the packed ``[ids | mask]`` title row, then
  ``gelu(fc(CLS))`` and the hidden stack; with several text attributes
  (``attr_num_words``) one ``[ids | mask]`` block each, all through the
  same BERT and ``fc``, the vector their mean and the hiddens the first
  block's;
- ``ImageTower``: ViT, then ``gelu(classifier(CLS of the final-LN
  output))`` and the hidden stack;
- ``take_cls_taps``: hidden stack -> (N, K, D) CLS taps for the SAN;
- ``UncachedIISANModel``: both towers in the step, their CLS taps -> SAN
  -> ``com_dense`` -> SASRec -> in-batch loss.  Frozen towers run under
  ``torch.no_grad()`` and their taps are detached (the JAX package's
  ``stop_gradient``), so no tower activation is kept for a backward;
- ``FFTRecModel``: the full fine-tuning baseline, the towers' output heads
  fused by ``com_dense`` (the "fft" modality) and trained end to end;
  with LoRA or Houlsby towers, or the BitFit mask, the same class is the
  parameter-efficient baselines;
- ``towers_from_config``: both towers at the configuration's geometry,
  with the JAX package's checks of ``tower_quant`` and
  ``fused_tower_attention`` and its reading of ``adapter_type``,
  ``remat_towers`` and ``news_attributes``.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import sequence_train_loss
from ..utils.profiling import annotate
from .bert import BertEncoder
from .model import ComDense
from .modules import TorchLinear, XavierLinear
from .san import SideAdapterNetwork
from .user_encoder import UserEncoder
from .vit import ViTEncoder


class TextTower(nn.Module):
    """BERT + CLS head; ``tokens`` (N, sum of 2 * width) int, each text
    attribute's ``[ids | mask]`` block in turn (the title alone by
    default: ``attr_num_words=()`` reads ``num_words``)."""

    def __init__(self, bert: BertEncoder, hidden_dim: int, embedding_dim: int,
                 num_words: int, attr_num_words: Tuple[int, ...] = (),
                 device=None, generator=None):
        super().__init__()
        self.bert, self.num_words = bert, num_words
        self.widths = tuple(attr_num_words) or (num_words,)
        self.fc = TorchLinear(hidden_dim, embedding_dim, device=device,
                              generator=generator)

    def blocks(self, tokens):
        """(ids, mask) of each attribute's block."""
        start = 0
        for nw in self.widths:
            yield tokens[:, start:start + nw], tokens[:, start + nw:start + 2 * nw]
            start += 2 * nw

    def hiddens(self, tokens, deterministic: bool = True, generator=None):
        """The first block's hidden stack alone (IISAN reads no text
        vector, so the other blocks would run for nothing)."""
        with annotate("iisan.text_tower"):
            return self.bert(*next(self.blocks(tokens)), deterministic,
                             generator)[1]

    def forward(self, tokens, deterministic: bool = True, generator=None):
        with annotate("iisan.text_tower"):
            vecs, hiddens0 = [], None
            for ids, mask in self.blocks(tokens):
                last, hiddens = self.bert(ids, mask, deterministic, generator)
                vecs.append(F.gelu(self.fc(last[:, 0])))
                hiddens0 = hiddens if hiddens0 is None else hiddens0
            if len(vecs) == 1:
                return vecs[0], hiddens0
            # the mean accumulates in fp32 and rounds once, as jnp.mean
            return (torch.stack(vecs, 1).float().mean(1).to(vecs[0].dtype),
                    hiddens0)


class ImageTower(nn.Module):
    """ViT + the re-initialised classifier head."""

    def __init__(self, vit: ViTEncoder, hidden_dim: int, embedding_dim: int,
                 device=None, generator=None):
        super().__init__()
        self.vit = vit
        self.classifier = XavierLinear(hidden_dim, embedding_dim,
                                       device=device, generator=generator)

    def forward(self, images, deterministic: bool = True, generator=None):
        with annotate("iisan.image_tower"):
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
            h_text = self.text_tower.hiddens(tokens, deterministic, generator)
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
                deterministic: bool = False, generator=None, shard=None):
        """Training loss: item_ids (bs, L+1); images (bs*(L+1), H, W, 3)
        normalised; tokens (bs*(L+1), packed text width); log_mask (bs, L)."""
        cv_taps, text_taps = self.encode_taps(images, tokens, deterministic,
                                              generator)
        with annotate("iisan.san"):
            embs = self.san(cv_taps, text_taps)
        score_embs = self.fuse(*embs)
        return sequence_train_loss(self.user_encoder, score_embs, item_ids,
                                   log_mask, pop_prob, self.max_seq_len,
                                   self.embedding_dim, deterministic, generator,
                                   shard)


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
                deterministic: bool = False, generator=None, shard=None):
        emb_cv, _ = self.image_tower(images, deterministic, generator)
        emb_text, _ = self.text_tower(tokens, deterministic, generator)
        score_embs = self.fuse(emb_cv, emb_text, None)
        return sequence_train_loss(self.user_encoder, score_embs, item_ids,
                                   log_mask, pop_prob, self.max_seq_len,
                                   self.embedding_dim, deterministic, generator,
                                   shard)


def towers_from_config(cfg, dtype=None, device=None, generator=None):
    """(TextTower, ImageTower) at the configuration's geometry: heads of
    width 64, MLP 4x, BERT dropout 0.1 and ViT 0.0 unless
    ``tower_dropout`` >= 0 sets both; CLS-only hidden stacks;
    ``tower_quant="int8"`` gives W8A8 encoders (their heads stay float);
    ``remat_towers`` on both encoders.  ``adapter_type="lora"`` puts LoRA
    of rank ``bert_adapter_down_size`` on both towers' q and v, and
    ``"houslby"`` (the reference's spelling, and the only one that adds
    adapters: ``"houlsby"`` and ``"adapter"`` build plain towers, as in
    the JAX package) Houlsby adapters of width ``bert_adapter_down_size``
    in BERT and ``cv_adapter_down_size`` in the ViT, each only when
    ``adding_adapter_to`` is not "None".  The text tower takes every
    active text attribute unless that is the title alone.  Raises
    ``ValueError`` where the JAX package does (an unknown or removed
    quant value, int8 towers that train, an unknown attention route)."""
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
    adapters = cfg.adding_adapter_to != "None"
    lora = cfg.bert_adapter_down_size if (
        adapters and cfg.adapter_type == "lora") else 0
    houlsby = adapters and cfg.adapter_type == "houslby"
    td = getattr(cfg, "tower_dropout", -1.0)
    remat = getattr(cfg, "remat_towers", False)
    D_t, D_v = cfg.word_embedding_dim, cfg.image_embedding_dim
    bert = BertEncoder(hidden_dim=D_t, num_layers=cfg.text_layers,
                       num_heads=max(1, D_t // 64), intermediate_dim=4 * D_t,
                       dtype=dtype, dropout=td if td >= 0 else 0.1,
                       lora_rank=lora,
                       houlsby_down=cfg.bert_adapter_down_size if houlsby else 0,
                       adapter_activation=cfg.adapter_activation, remat=remat,
                       fused_attention=fta, collect="cls", quant=quant,
                       device=device, generator=generator)
    vit = ViTEncoder(image_size=cfg.CV_resize, hidden_dim=D_v,
                     num_layers=cfg.image_layers, num_heads=max(1, D_v // 64),
                     intermediate_dim=4 * D_v, dtype=dtype,
                     dropout=td if td >= 0 else 0.0, lora_rank=lora,
                     houlsby_down=cfg.cv_adapter_down_size if houlsby else 0,
                     adapter_activation=cfg.adapter_activation, remat=remat,
                     fused_attention=fta, collect="cls", quant=quant,
                     device=device, generator=generator)
    # A single non-title attribute has its own width, so the widths go in
    # whenever the active set is anything but the title alone.
    attrs = (() if cfg.active_text_attributes() == ("title",)
             else cfg.attr_num_words())
    text = TextTower(bert, D_t, cfg.embedding_dim, cfg.num_words_title, attrs,
                     device, generator)
    image = ImageTower(vit, D_v, cfg.embedding_dim, device, generator)
    return text, image
