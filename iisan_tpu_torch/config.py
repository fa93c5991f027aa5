"""Configuration of the port: every field of ``iisan_tpu.config.IISANConfig``.

The dataclass has the JAX package's fields, with the same names, types and
defaults (the reference's flags and the published configuration), so that
a command line written for the reference or for the JAX package drives the
port unchanged (``iisan_tpu_torch/cli.py``), and either package's object
drives the port's models and trainers, which read their configuration
duck-typed.

Fields that select something the port does not do:

- ``epoch_scan_unroll`` and ``fused_epoch_eval`` are the JAX package's TPU
  dispatch knobs (the unroll of the epoch's ``lax.scan``, one dispatch for
  an epoch and its evaluation). They are accepted and ignored: the port's
  epoch is a loop of steps, then the evaluation.
- ``mesh_shape`` and ``dist_*`` lay a run over ranks of
  ``torch.distributed`` (``parallel/``; ``cli.main`` starts the group).
- ``dropout_prng`` names a JAX PRNG; the port draws its dropout bits from
  Philox4x32-10 whichever of the two JAX values is given.
- The reference's accepted-and-ignored flags (``arch``, ``l2_weight``,
  ``num_dnn``, ``use_cls``, ``testing_num`` and the other adapter-method
  knobs no method here reads) are kept for command-line parity, as in the
  JAX package.
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
    # data
    mode: str = "train"
    item_tower: str = "modal"
    root_data_dir: str = "../"
    dataset: str = "Dataset/Scientific"
    behaviors: str = "am_Industrial_and_Scientific_users.tsv"
    images: str = "Industrial_and_Scientific_items.tsv"
    lmdb_data: str = "image.lmdb"
    news: str = "Industrial_and_Scientific_items.tsv"

    # training
    batch_size: int = 64
    epoch: int = 1
    lr: float = 1e-4
    fine_tune_lr_image: float = 1e-4
    fine_tune_lr_text: float = 5e-5
    l2_weight: float = 0.0
    drop_rate: float = 0.1

    # model
    CV_model_load: str = "vit"
    freeze_paras_before: int = 0
    CV_resize: int = 224
    embedding_dim: int = 64
    num_attention_heads: int = 2
    transformer_block: int = 2
    max_seq_len: int = 10
    min_seq_len: int = 5
    arch: str = "sasrec"
    use_scale: str = "half"
    n_tokens: int = 10
    bert_model_load: str = "bert_base_uncased"
    word_embedding_dim: int = 768
    use_cls: bool = True

    # IISAN-Versa (``pipeline="cached_asym"``): the towers' widths and depths
    text_embedding_dim: int = 768
    image_embedding_dim: int = 768
    text_layers: int = 12
    image_layers: int = 12

    # text items: packed [ids | mask] rows per attribute
    num_words_title: int = 30
    num_words_abstract: int = 50
    num_words_body: int = 50
    news_attributes: Tuple[str, ...] = ("title",)

    # switches and logging
    num_workers: int = 4
    load_ckpt_name: str = "None"
    label_screen: str = "None"
    logging_num: int = 8
    testing_num: int = 1
    local_rank: int = -1
    pretrained_recsys_model: str = "None"

    # adapter methods (IISAN, the full fine-tuning baseline and the PEFT ones)
    adapter_down_size: int = 16
    adding_adapter_to: str = "None"
    fine_tune_to: str = "all"
    adapter_cv_lr: float = 4e-4
    adapter_bert_lr: float = 1e-4
    bert_adapter_down_size: int = 64
    adapter_sasrec_lr: float = 1e-4
    cv_adapter_down_size: int = 64
    adapter_dropout_rate: float = 0.1
    adapter_activation: str = "RELU"
    finetune_layernorm: str = "None"
    is_serial: str = "True"
    adapter_type: str = "houslby"
    k_adapter_bert_list: Tuple[int, ...] = (0, 11)
    k_adapter_bert_hidden_dim: int = 384
    num_adapter_heads_sasrec: int = 2
    num_adapter_heads_bert: int = 12
    num_dnn: int = 0
    hypercomplex_division: int = 8
    phm_init_range: float = 1e-4

    # side adapter network
    side_adapter_vit_list: str = "1,3,5,7,9,11"
    side_adapter_bert_list: str = "1,3,5,7,9,11"
    side_adapter_mm_list: str = "1,3,5,7,9,11"
    fusion_method: str = "gated"
    remove_first: str = "None"
    fusion_inter: str = "add"
    stored_vector_path: str = ""
    modality: str = "intra_inter"
    seed: int = 12345

    # cached hidden-state stores: <stored_vector_path>/<model>.memmap
    cached_image_model: str = "vit_outputs"
    cached_text_prefix: str = "bert"
    cached_image_prefix: str = "vit"
    cached_text_model: str = "bert_outputs"

    # execution
    pipeline: str = "cached"
    compute_dtype: str = "bfloat16"
    eval_batch_size: int = 256
    mesh_shape: str = ""
    # use_pallas: the SAN cascade kernels (#3 / #4 by the JAX dispatch rule)
    use_pallas: bool = False
    batch_intra_branches: bool = True
    # uncached towers: rematerialised layers (False, True or "mlp": the
    # pre-GELU hidden stored)
    remat_towers: Any = False
    fused_epoch_eval: bool = True
    epoch_scan_unroll: int = 1
    # tap tables on the device: "none" (compute dtype) or "int8"
    cache_quant: str = "none"
    # frozen IISAN towers: "int8" runs their dense layers through #10
    tower_quant: str = "none"
    # tower attention: True (#5 / #6 on the card), False (plain), or
    # "subblock" / "subblock_v2" (#8 / #9)
    fused_tower_attention: Any = True
    fused_user_encoder: bool = True
    # tower dropout: < 0 keeps BERT 0.1 / ViT 0.0, >= 0 forces the rate
    tower_dropout: float = -1.0
    dropout_prng: str = "threefry2x32"
    log_dir: str = "./logs"
    ckpt_dir: str = "./checkpoints"
    # epoch checkpoints on a new best or every 10th epoch
    save_checkpoints: bool = True
    # non-empty: after training, save a serving artifact (Recommender.save)
    export_recommender: str = ""
    dist_coordinator: str = ""
    dist_num_processes: int = 0
    dist_process_id: int = -1
    early_stop_patience: int = 10

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
        if isinstance(self.k_adapter_bert_list, str):
            self.k_adapter_bert_list = _parse_int_list(self.k_adapter_bert_list)

    def with_bert_dims(self) -> "IISANConfig":
        """``word_embedding_dim`` set from the BERT size that
        ``bert_model_load`` names (tiny 128, mini 256, medium 512, large
        1024, base 768), as the reference's trainer couples them; called by
        the command line, so configurations made in code keep their dims."""
        dim = {"tiny": 128, "mini": 256, "medium": 512,
               "large": 1024, "base": 768}
        for key, d in dim.items():
            if key in self.bert_model_load:
                return self.replace(word_embedding_dim=d)
        return self
