"""Dataset registry of the sweep launchers.

Port of ``scripts/datasets.py``: the per-dataset TSV and LMDB names that
the reference hard-codes in its per-dataset launcher copies
(Code_Cached_Asym/script/run_IISAN{,_ins,_off,_micro}.py:4-9), relative to
a config's ``root_data_dir``.  ``micro`` (MicroLens-100k) uses the same
two-column TSV formats as the Amazon sets; ``office`` ships behaviors only
in the reference snapshot.
"""

# The launchers' default root_data_dir, the JAX scripts' (scripts/run_IISAN.py:23).
REFERENCE_ROOT = "/root/reference"

DATASETS = {
    "scientific": dict(  # Code_Cached/scripts/run_IISAN.py:4-9
        dataset="Dataset/Scientific",
        behaviors="am_Industrial_and_Scientific_users.tsv",
        images="Industrial_and_Scientific_items.tsv",
        news="Industrial_and_Scientific_items.tsv",
        lmdb_data="am_is.lmdb"),
    "instrument": dict(  # Code_Cached_Asym/script/run_IISAN_ins.py:5-9
        dataset="Dataset/Instrument",
        behaviors="am_Musical_Instruments_users_10K.tsv",
        images="Musical_Instruments_items.tsv",
        news="Musical_Instruments_items.tsv",
        lmdb_data="am_mi.lmdb"),
    "office": dict(  # Code_Cached_Asym/script/run_IISAN_off.py:5-9
        dataset="Dataset/Office",
        behaviors="am_Office_Products_users_10K.tsv",
        images="Office_Products_items.tsv",
        news="Office_Products_items.tsv",
        lmdb_data="am_op.lmdb"),
    "micro": dict(  # Code_Cached_Asym/script/run_IISAN_micro.py:5-9
        dataset="Dataset/Microlens",
        behaviors="MicroLens-100k_pairs.tsv",
        images="MicroLens-100k_title_en.tsv",
        news="MicroLens-100k_title_en.tsv",
        lmdb_data="am_microlens.lmdb"),
}
