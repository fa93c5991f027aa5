"""Top-level recommendation model: SAN -> com_dense -> SASRec user encoder.

Port of ``IISANRecModel``, ``ComDense`` and ``IDRecModel`` from
``iisan_tpu/models/model.py``: ``item_embeddings`` (the SAN over tap
tensors), ``fuse_embeddings`` (``com_dense``), ``user_scores`` (the user
encoder) and ``forward``, the training loss; the ID baseline takes its item
embeddings from a learned table instead of the SAN.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.losses import sequence_train_loss
from ..utils.profiling import annotate
from .modules import TorchLinear, xavier_normal_init
from .san import SideAdapterNetwork, san_from_config
from .user_encoder import UserEncoder


class ComDense(nn.Module):
    """Modality-fusion projection ``com_dense``.

    intra_inter: Linear(3*emb -> emb) on [cv, text, mm];
    inter:       Linear(emb -> emb) on mm;
    otherwise:   Linear(2*emb -> emb) on [cv, text].
    """

    def __init__(self, embedding_dim: int, modality: str,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        self.modality = modality
        if "intra_inter" in modality:
            fan_in = 3 * embedding_dim
        elif "inter" in modality:
            fan_in = embedding_dim
        else:
            fan_in = 2 * embedding_dim
        self.com_dense = TorchLinear(fan_in, embedding_dim, dtype=dtype,
                                     device=device, generator=generator)

    def forward(self, emb_cv, emb_text, emb_mm):
        if "intra_inter" in self.modality:
            x = torch.cat([emb_cv, emb_text, emb_mm], dim=-1)
        elif "inter" in self.modality:
            x = emb_mm
        else:
            x = torch.cat([emb_cv, emb_text], dim=-1)
        return self.com_dense(x)


class IISANRecModel(nn.Module):
    """SAN + fusion + user encoder.  ``san`` may be None for a model that
    only serves from a finished item table (``Recommender.load``)."""

    def __init__(self, san: Optional[SideAdapterNetwork], embedding_dim: int,
                 max_seq_len: int, num_attention_heads: int,
                 transformer_block: int, drop_rate: float,
                 modality: str = "intra_inter",
                 dtype: Optional[torch.dtype] = None,
                 fused_user_encoder: Optional[bool] = None, device=None,
                 generator=None):
        super().__init__()
        self.san = san
        self.user_encoder = UserEncoder(
            embedding_dim, max_seq_len, num_attention_heads,
            transformer_block, drop_rate, dtype, fused_user_encoder, device,
            generator)
        self.fuse = ComDense(embedding_dim, modality, dtype, device, generator)

    def item_embeddings(self, cv_states, text_states):
        """Per-modality item embeddings from tap tensors."""
        return self.san(cv_states, text_states)

    def fuse_embeddings(self, emb_cv, emb_text, emb_mm):
        return self.fuse(emb_cv, emb_text, emb_mm)

    def user_scores(self, input_embs, log_mask, deterministic: bool = True):
        """Run the user tower; returns (B, L, emb)."""
        return self.user_encoder(input_embs, log_mask, deterministic)

    def forward(self, item_ids, cv_states, text_states, log_mask, pop_prob,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None, shard=None):
        """Training forward -> scalar fp32 loss (with ``shard``, this
        rank's share: ``ops.losses.sequence_train_loss``).

        item_ids (bs, L+1); cv_states / text_states (bs*(L+1), K, dim) tap
        tensors; log_mask (bs, L); pop_prob (item_num+1,).  Train-mode
        dropout draws from ``generator``.
        """
        with annotate("iisan.san"):
            emb_cv, emb_text, emb_mm = self.san(cv_states, text_states)
        score_embs = self.fuse(emb_cv, emb_text, emb_mm)
        return sequence_train_loss(self.user_encoder, score_embs, item_ids,
                                   log_mask, pop_prob,
                                   self.user_encoder.max_seq_len,
                                   score_embs.shape[-1], deterministic,
                                   generator, shard)


def rec_model_from_config(cfg, device=None, generator=None) -> IISANRecModel:
    """The cached-pipeline model of an ``IISANConfig`` (``pipeline`` "cached"
    or IISAN-Versa's "cached_asym"), initialised from
    ``generator`` (a seeded ``torch.Generator`` on ``device``)."""
    return IISANRecModel(
        san=san_from_config(cfg, device, generator),
        embedding_dim=cfg.embedding_dim,
        max_seq_len=cfg.max_seq_len,
        num_attention_heads=cfg.num_attention_heads,
        transformer_block=cfg.transformer_block,
        drop_rate=cfg.drop_rate,
        modality=cfg.modality,
        dtype=getattr(torch, cfg.compute_dtype),
        fused_user_encoder=None if getattr(cfg, "fused_user_encoder", True)
        else False,
        device=device, generator=generator,
    )


class IDRecModel(nn.Module):
    """The ID-embedding baseline (the reference's ``use_modal=False``):
    item embeddings are rows of a learned (item_num+1, emb) table,
    xavier-normal from ``generator``; the user encoder and the loss are the
    cached model's."""

    def __init__(self, item_num: int, embedding_dim: int, max_seq_len: int,
                 num_attention_heads: int, transformer_block: int,
                 drop_rate: float, dtype: Optional[torch.dtype] = None,
                 fused_user_encoder: Optional[bool] = None, device=None,
                 generator=None):
        super().__init__()
        self.id_embedding = nn.Embedding(item_num + 1, embedding_dim,
                                         device=device)
        with torch.no_grad():
            self.id_embedding.weight.copy_(xavier_normal_init(
                (item_num + 1, embedding_dim), device, generator))
        self.user_encoder = UserEncoder(
            embedding_dim, max_seq_len, num_attention_heads,
            transformer_block, drop_rate, dtype, fused_user_encoder, device,
            generator)

    def item_table(self) -> torch.Tensor:
        return self.id_embedding.weight

    def user_scores(self, input_embs, log_mask, deterministic: bool = True):
        return self.user_encoder(input_embs, log_mask, deterministic)

    def forward(self, item_ids, log_mask, pop_prob,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None, shard=None):
        """Training forward -> scalar fp32 loss (with ``shard``, this
        rank's share); item_ids (bs, L+1),
        log_mask (bs, L), pop_prob (item_num+1,)."""
        rows = shard.rows(item_ids.shape[0]) if shard is not None else slice(None)
        score_embs = self.id_embedding(item_ids[rows].reshape(-1).long())
        return sequence_train_loss(self.user_encoder, score_embs, item_ids,
                                   log_mask, pop_prob,
                                   self.user_encoder.max_seq_len,
                                   score_embs.shape[-1], deterministic,
                                   generator, shard)


def id_model_from_config(cfg, item_num: int, device=None,
                         generator=None) -> IDRecModel:
    """The ID model of an ``IISANConfig`` over ``item_num`` items."""
    return IDRecModel(
        item_num=item_num,
        embedding_dim=cfg.embedding_dim,
        max_seq_len=cfg.max_seq_len,
        num_attention_heads=cfg.num_attention_heads,
        transformer_block=cfg.transformer_block,
        drop_rate=cfg.drop_rate,
        dtype=getattr(torch, cfg.compute_dtype),
        fused_user_encoder=None if getattr(cfg, "fused_user_encoder", True)
        else False,
        device=device, generator=generator,
    )
