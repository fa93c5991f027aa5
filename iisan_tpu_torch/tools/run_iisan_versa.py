"""IISAN-Versa asymmetric sweeps (``pipeline="cached_asym"``).

Port of ``scripts/run_IISAN_versa.py``: the canonical configs of the
reference's Code_Cached_Asym/script/:

- llama: Llama-3-70B text states (81 x 8192, group layer-drop list
  "4,19,34,49,64,79") x ViT-tiny image states (13 x 192)
  (run_IISAN.py:52-64);
- eva: EVA-CLIP-18B image states (49 x 5120, list "2,11,20,29,38,47")
  (run_IISAN_eva.py:57-65);
- bertlarge: BERT-large (25 x 1024) x ViT-base;

over one dataset of the registry (``tools/datasets.py``; MicroLens,
``micro``, is the published IISAN-Versa set, ``scientific`` the default),
run on the first CUDA card through ``sweep.run_sweep``:

    python -m iisan_tpu_torch.tools.run_iisan_versa llama|eva|bertlarge
        [scientific|instrument|office|micro] [--dry-run] [--device cpu]
"""

import argparse

from ..sweep import add_launcher_flags, launch
from .datasets import DATASETS, REFERENCE_ROOT

COMMON = dict(
    pipeline="cached_asym",
    root_data_dir=REFERENCE_ROOT,
    stored_vector_path="./stored_vectors_versa",
    mode="train",
    epoch=100,
    adapter_type="IISAN",
    adding_adapter_to="all",
    fine_tune_to="None",
    modality="intra_inter",
    fusion_method="gated",
)

VARIANTS = {
    "llama": dict(  # run_IISAN.py:52-64
        text_layers=80, text_embedding_dim=8192,
        image_layers=12, image_embedding_dim=192,
        side_adapter_bert_list="4,19,34,49,64,79",
        side_adapter_vit_list="1,3,5,7,9,11",
        cached_text_model="llama70b_GPTQ_embeddings",
        cached_image_model="vit_tiny_outputs",
        cached_text_prefix="llama", cached_image_prefix="vit"),
    "eva": dict(  # run_IISAN_eva.py:57-65
        text_layers=24, text_embedding_dim=1024,
        image_layers=48, image_embedding_dim=5120,
        side_adapter_bert_list="1,5,9,13,17,23",
        side_adapter_vit_list="2,11,20,29,38,47",
        cached_text_model="bert_large_outputs",
        cached_image_model="eva_clip_outputs",
        cached_text_prefix="bert", cached_image_prefix="eva"),
    "bertlarge": dict(
        text_layers=24, text_embedding_dim=1024,
        image_layers=12, image_embedding_dim=768,
        side_adapter_bert_list="1,5,9,13,17,23",
        side_adapter_vit_list="1,3,5,7,9,11",
        cached_text_model="bert_large_outputs",
        cached_image_model="vit_outputs",
        cached_text_prefix="bert", cached_image_prefix="vit"),
}

GRID = dict(
    embedding_dim=[64], batch_size=[64], lr=[2e-4],
    adapter_cv_lr=[1e-4], adapter_bert_lr=[1e-4],
    fine_tune_lr_image=[1e-4], fine_tune_lr_text=[5e-5],
    cv_adapter_down_size=[64], bert_adapter_down_size=[64],
    drop_rate=[0.1], seed=[12345],
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variant", nargs="?", default="llama",
                    choices=list(VARIANTS))
    ap.add_argument("dataset", nargs="?", default="scientific",
                    choices=list(DATASETS))
    add_launcher_flags(ap)
    args = ap.parse_args(argv)
    return launch({**COMMON, **DATASETS[args.dataset],
                   **VARIANTS[args.variant]}, GRID, args)


if __name__ == "__main__":
    main()
