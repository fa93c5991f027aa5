"""Canonical IISAN (Cached) sweep.

Port of ``scripts/run_IISAN.py``: the hyperparameter grid of the
reference's Code_Cached/scripts/run_IISAN.py:27-49 (the published headline
config): batch 64, lr 2e-4, adapter lrs 1e-4, embedding and adapter
bottleneck 64, SAN layers "1,3,5,7,9,11", gated intra_inter fusion, seed
12345, 100 epochs, over one dataset of the registry (``tools/datasets.py``)
under ``root_data_dir``, run on the first CUDA card through
``sweep.run_sweep``:

    python -m iisan_tpu_torch.tools.run_iisan [scientific|instrument|office|micro]
        [--dry-run] [--device cpu]

The cached stores are read from ``./stored_vectors_<dataset>``.
"""

import argparse

from ..sweep import add_launcher_flags, launch
from .datasets import DATASETS, REFERENCE_ROOT

BASE = dict(
    pipeline="cached",
    root_data_dir=REFERENCE_ROOT,
    stored_vector_path="./stored_vectors_sci",
    mode="train",
    item_tower="modal",
    epoch=100,
    adapter_type="IISAN",
    adding_adapter_to="all",
    fine_tune_to="None",
    side_adapter_vit_list="1,3,5,7,9,11",
    side_adapter_bert_list="1,3,5,7,9,11",
    side_adapter_mm_list="1,3,5,7,9,11",
    modality="intra_inter",
    fusion_method="gated",
    CV_model_load="vit",
    bert_model_load="bert_base_uncased",
    logging_num=4,
    testing_num=1,
)

GRID = dict(
    embedding_dim=[64],
    batch_size=[64],
    lr=[2e-4],
    adapter_cv_lr=[1e-4],
    adapter_bert_lr=[1e-4],
    fine_tune_lr_image=[1e-4],
    fine_tune_lr_text=[5e-5],
    cv_adapter_down_size=[64],
    bert_adapter_down_size=[64],
    drop_rate=[0.1],
    l2_weight=[0],
    seed=[12345],
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", nargs="?", default="scientific",
                    choices=list(DATASETS))
    add_launcher_flags(ap)
    args = ap.parse_args(argv)
    return launch({**BASE, **DATASETS[args.dataset],
                   "stored_vector_path": f"./stored_vectors_{args.dataset}"},
                  GRID, args)


if __name__ == "__main__":
    main()
