"""Configuration of the port's cached pipeline.

``IISANConfig`` here holds the fields of ``iisan_tpu.config.IISANConfig``
that the port reads, with the same names and defaults (the published
cached configuration), so that either object drives the port's model and
trainer: they take their configuration duck-typed.  The JAX package's
full dataclass (CLI flags, uncached and asymmetric pipelines, meshes) is
not needed here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


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
    # model
    embedding_dim: int = 64
    num_attention_heads: int = 2
    transformer_block: int = 2
    max_seq_len: int = 10
    min_seq_len: int = 5
    word_embedding_dim: int = 768
    image_embedding_dim: int = 768
    # side adapter network
    bert_adapter_down_size: int = 64
    cv_adapter_down_size: int = 64
    adapter_activation: str = "RELU"
    side_adapter_vit_list: str = "1,3,5,7,9,11"
    side_adapter_bert_list: str = "1,3,5,7,9,11"
    fusion_method: str = "gated"
    remove_first: str = "None"
    modality: str = "intra_inter"
    # execution
    pipeline: str = "cached"
    compute_dtype: str = "bfloat16"
    use_pallas: bool = False
    batch_intra_branches: bool = True
    fused_user_encoder: bool = True
    cache_quant: str = "none"

    def san_text_taps(self) -> Tuple[int, ...]:
        """Hidden-state rows the text branch reads: row 0, then each listed
        layer's output."""
        return (0,) + tuple(i + 1 for i in _parse_int_list(self.side_adapter_bert_list))

    def san_image_taps(self) -> Tuple[int, ...]:
        return (0,) + tuple(i + 1 for i in _parse_int_list(self.side_adapter_vit_list))

    @property
    def remove_first_bool(self) -> bool:
        return self.remove_first == "TRUE"

    @property
    def gated(self) -> bool:
        return self.fusion_method == "gated"

    def replace(self, **kw) -> "IISANConfig":
        return dataclasses.replace(self, **kw)
