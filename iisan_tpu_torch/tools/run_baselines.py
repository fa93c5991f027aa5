"""Baseline PEFT sweeps (uncached, Amazon Scientific).

Port of ``scripts/run_baselines.py``: the canonical grids of the
reference's Code_Uncached/scripts/run_{fft,lora,adapter,bitfit}.py: FFT
batch 32 lr 1e-4; LoRA of rank ``bert_adapter_down_size`` (8) with adapter
lrs 4e-4; Houlsby adapters of 64 with adapter lrs 4e-4; BitFit bias-only;
all with fine_tune_lr_image 1e-4 / fine_tune_lr_text 5e-5, embedding 64,
100 epochs, run on the first CUDA card through ``sweep.run_sweep``:

    python -m iisan_tpu_torch.tools.run_baselines fft|lora|houlsby|bitfit
        [--dry-run] [--device cpu]
"""

import argparse

from ..sweep import add_launcher_flags, launch
from .datasets import REFERENCE_ROOT

COMMON = dict(
    pipeline="uncached",
    root_data_dir=REFERENCE_ROOT,
    dataset="Dataset/Scientific",
    behaviors="am_Industrial_and_Scientific_users.tsv",
    images="Industrial_and_Scientific_items.tsv",
    news="Industrial_and_Scientific_items.tsv",
    lmdb_data="am_is.lmdb",
    mode="train",
    epoch=100,
    freeze_paras_before=0,
    CV_model_load="vit",
    bert_model_load="bert_base_uncased",
)

METHODS = {
    # run_fft.py: full fine-tune, bs 32, user lr 1e-4
    "fft": (dict(adapter_type="fft", adding_adapter_to="None",
                 fine_tune_to="all"),
            dict(batch_size=[32], lr=[1e-4], embedding_dim=[64],
                 fine_tune_lr_image=[1e-4], fine_tune_lr_text=[5e-5],
                 drop_rate=[0.1], seed=[12345])),
    # run_lora.py: r=8 on q/v, adapter lrs 4e-4, user lr 2e-4
    "lora": (dict(adapter_type="lora", adding_adapter_to="all",
                  fine_tune_to="None", bert_adapter_down_size=8,
                  cv_adapter_down_size=8),
             dict(batch_size=[32], lr=[2e-4], embedding_dim=[64],
                  adapter_cv_lr=[4e-4], adapter_bert_lr=[4e-4],
                  fine_tune_lr_image=[1e-4], fine_tune_lr_text=[5e-5],
                  drop_rate=[0.1], seed=[12345])),
    # run_adapter.py: Houlsby 64, adapter lrs 4e-4
    "houlsby": (dict(adapter_type="houslby", adding_adapter_to="all",
                     fine_tune_to="None", bert_adapter_down_size=64,
                     cv_adapter_down_size=64, is_serial="True"),
                dict(batch_size=[32], lr=[2e-4], embedding_dim=[64],
                     adapter_cv_lr=[4e-4], adapter_bert_lr=[4e-4],
                     fine_tune_lr_image=[1e-4], fine_tune_lr_text=[5e-5],
                     drop_rate=[0.1], seed=[12345])),
    # run_bitfit.py: bias-only
    "bitfit": (dict(adapter_type="bitfit", adding_adapter_to="all",
                    fine_tune_to="None"),
               dict(batch_size=[32], lr=[2e-4], embedding_dim=[64],
                    fine_tune_lr_image=[1e-4], fine_tune_lr_text=[5e-5],
                    drop_rate=[0.1], seed=[12345])),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("method", nargs="?", default="fft", choices=list(METHODS))
    add_launcher_flags(ap)
    args = ap.parse_args(argv)
    base, grid = METHODS[args.method]
    return launch({**COMMON, **base}, grid, args)


if __name__ == "__main__":
    main()
