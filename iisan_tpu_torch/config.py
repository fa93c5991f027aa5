"""Configuration of the port's cached and uncached pipelines.

``IISANConfig`` here holds the fields of ``iisan_tpu.config.IISANConfig``
that the port reads, with the same names and defaults (the published
configuration), so that either object drives the port's models and
trainers: they take their configuration duck-typed.  The JAX package's
full dataclass (CLI flags, asymmetric pipelines, meshes) is not needed
here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple


def _parse_int_list(s: str) -> Tuple[int, ...]:
    s = s.strip()
    return tuple(int(x) for x in s.split(",")) if s else ()


@dataclass
class IISANConfig:
    # training
    batch_size: int = 64
    epoch: int = 1
    lr: float = 1e-4
    fine_tune_lr_image: float = 1e-4
    fine_tune_lr_text: float = 5e-5
    adapter_cv_lr: float = 4e-4
    adapter_bert_lr: float = 1e-4
    drop_rate: float = 0.1
    seed: int = 12345
    logging_num: int = 8
    early_stop_patience: int = 10
    eval_batch_size: int = 256
    num_workers: int = 4
    # adapter method (IISAN, or the full fine-tuning baseline)
    adapter_type: str = "houslby"
    adding_adapter_to: str = "None"
    fine_tune_to: str = "all"
    finetune_layernorm: str = "None"
    freeze_paras_before: int = 0
    # model
    embedding_dim: int = 64
    num_attention_heads: int = 2
    transformer_block: int = 2
    max_seq_len: int = 10
    min_seq_len: int = 5
    word_embedding_dim: int = 768
    # IISAN-Versa (``pipeline="cached_asym"``): the text tower's width
    text_embedding_dim: int = 768
    image_embedding_dim: int = 768
    text_layers: int = 12
    image_layers: int = 12
    CV_resize: int = 224
    # text items: packed [ids | mask] rows per attribute
    num_words_title: int = 30
    num_words_abstract: int = 50
    num_words_body: int = 50
    news_attributes: Tuple[str, ...] = ("title",)
    # side adapter network
    bert_adapter_down_size: int = 64
    cv_adapter_down_size: int = 64
    adapter_activation: str = "RELU"
    side_adapter_vit_list: str = "1,3,5,7,9,11"
    side_adapter_bert_list: str = "1,3,5,7,9,11"
    fusion_method: str = "gated"
    remove_first: str = "None"
    modality: str = "intra_inter"
    # cached hidden-state stores: <stored_vector_path>/<model>.memmap
    stored_vector_path: str = ""
    cached_text_model: str = "bert_outputs"
    cached_text_prefix: str = "bert"
    cached_image_model: str = "vit_outputs"
    cached_image_prefix: str = "vit"
    # execution
    pipeline: str = "cached"
    compute_dtype: str = "bfloat16"
    use_pallas: bool = False
    batch_intra_branches: bool = True
    fused_user_encoder: bool = True
    cache_quant: str = "none"
    # uncached towers: dropout override (< 0 keeps BERT 0.1 / ViT 0.0),
    # attention route (True: the fused kernels on the card; "subblock" /
    # "subblock_v2": kernels #8 / #9), rematerialised layers (not ported:
    # models/towers.py raises) and W8A8 projections ("int8": kernel #10)
    tower_dropout: float = -1.0
    fused_tower_attention: Any = True
    remat_towers: Any = False
    tower_quant: str = "none"

    def san_text_taps(self) -> Tuple[int, ...]:
        """Hidden-state rows the text branch reads: row 0, then each listed
        layer's output."""
        return (0,) + tuple(i + 1 for i in _parse_int_list(self.side_adapter_bert_list))

    def san_image_taps(self) -> Tuple[int, ...]:
        return (0,) + tuple(i + 1 for i in _parse_int_list(self.side_adapter_vit_list))

    @property
    def text_num_hidden(self) -> int:
        """Rows of a cached text state: the layers and the embeddings."""
        return self.text_layers + 1

    @property
    def image_num_hidden(self) -> int:
        return self.image_layers + 1

    @property
    def remove_first_bool(self) -> bool:
        return self.remove_first == "TRUE"

    @property
    def gated(self) -> bool:
        return self.fusion_method == "gated"

    def is_iisan(self) -> bool:
        """The IISAN adapter method is selected (else the full fine-tuning
        baseline, for the uncached pipeline)."""
        return "IISAN" in self.adapter_type and self.adding_adapter_to != "None"

    def towers_frozen(self) -> bool:
        """IISAN's towers are frozen unless ``fine_tune_to`` is 'all' or
        ``finetune_layernorm`` re-enables their LayerNorms."""
        return (self.is_iisan() and "all" not in self.fine_tune_to
                and "None" in self.finetune_layernorm)

    def active_text_attributes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("title", "abstract", "body")
                     if a in self.news_attributes)

    def attr_num_words(self) -> Tuple[int, ...]:
        words = {"title": self.num_words_title,
                 "abstract": self.num_words_abstract,
                 "body": self.num_words_body}
        return tuple(words[a] for a in self.active_text_attributes())

    def packed_text_width(self) -> int:
        """Width of a packed text row: ``[ids | mask]`` per attribute."""
        return sum(2 * w for w in self.attr_num_words())

    def replace(self, **kw) -> "IISANConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if isinstance(self.news_attributes, str):
            self.news_attributes = tuple(self.news_attributes.split(","))
