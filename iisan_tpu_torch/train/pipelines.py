"""The run path: data loading, configuration checks and trainer dispatch.

Port of ``iisan_tpu/train/pipelines.py``.  ``run_from_config`` reads the
item and behaviour TSVs (``load_corpus``), opens the hidden-state stores
(``open_cache``), builds the trainer that the configuration names
(``CachedTrainer`` for "cached" and "cached_asym", ``UncachedTrainer``,
``IDTrainer`` for ``item_tower="id"``), resumes a checkpoint or warm-starts
from a reference ``.pt`` or a checkpoint's model, trains (or, with
``eval_only``, evaluates the test split) and exports a serving artifact.

The uncached pipeline reads its images from ``<root_data_dir>/<dataset>/
<lmdb_data>``: an LMDB or a directory of JPEGs (``data/images.py``).
``mesh_shape`` lays the trainers over the ranks of the process group that
``cli.main`` starts from ``dist_*`` or ``torchrun`` (``parallel/``): every
rank trains and evaluates, rank 0 writes checkpoints, logs and the
artifact.  ``dropout_prng`` names a JAX PRNG; the port's dropout bits are
Philox4x32-10's under either accepted value.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Tuple

import numpy as np

from ..data import preprocess as prep
from ..data.cache_store import HiddenStateCache, import_reference_pt_dir
from ..device import resolve_device
from ..parallel.distributed import barrier, is_main
from ..parallel.mesh import parse_mesh_spec
from ..utils.logging import setup_logger
from ..utils.profiling import kernel_launches
from ..utils.tpme import TPMETracker

log = logging.getLogger("iisan_tpu_torch")


def load_tokenizer(cfg):
    """The BERT tokenizer of ``<root_data_dir>/pretrained_models/bert/
    <bert_model_load>``, else of the reference's shipped
    ``bert_base_uncased`` beside it: the port's WordPiece tokenizer over
    its ``vocab.txt`` (``data/wordpiece.py``, the ids of transformers'
    ``BertTokenizerFast``, which the GPU machine does not have).  Nothing
    is downloaded: without either directory this raises."""
    from ..data.wordpiece import BertWordPiece

    candidates = [
        os.path.join(cfg.root_data_dir, "pretrained_models/bert", name)
        for name in (cfg.bert_model_load, "bert_base_uncased")]
    for c in candidates:
        if os.path.isdir(c):
            return BertWordPiece.from_dir(c)
    raise FileNotFoundError(
        f"no BERT tokenizer at {candidates}; put the tokenizer's files "
        "(vocab.txt) in the first of these directories")


def load_corpus(cfg) -> Tuple[prep.Corpus, Optional[np.ndarray]]:
    """Items and behaviours, and the packed token table where the pipeline
    reads titles (uncached towers)."""
    items_path = os.path.join(cfg.root_data_dir, cfg.dataset, cfg.news)
    behaviors_path = os.path.join(cfg.root_data_dir, cfg.dataset, cfg.behaviors)
    needs_titles = cfg.pipeline in ("uncached", "fft") and \
        cfg.item_tower != "id"
    if os.path.exists(items_path) or needs_titles:
        titles, name_to_id, id_to_name = prep.read_items(items_path)
    else:
        # a pipeline without titles takes its item registry from the
        # behaviours: the ETL keeps only interacted items either way
        log.warning("items TSV %s missing - registry from behaviors "
                    "(title-free pipeline)", items_path)
        titles, name_to_id, id_to_name = prep.items_from_behaviors(
            behaviors_path)
    corpus = prep.read_behaviors(behaviors_path, name_to_id, id_to_name,
                                 cfg.max_seq_len, cfg.min_seq_len)
    token_table = None
    if needs_titles:
        tok = load_tokenizer(cfg)
        attrs = cfg.active_text_attributes()
        if attrs == ("title",):
            full = prep.tokenize_titles(titles, tok, cfg.num_words_title)
        else:
            attr_texts = prep.read_item_attributes(items_path)
            full = prep.tokenize_attributes(attr_texts, tok, attrs,
                                            cfg.attr_num_words())
        token_table = prep.remap_token_table(full, corpus.item_names, name_to_id)
    return corpus, token_table


def open_cache(cfg, which: str, corpus) -> HiddenStateCache:
    """Open ``<stored_vector_path>/<cached_{text,image}_model>.memmap``
    (``which`` is "text" or "image").

    A reference-layout directory of per-item ``{prefix}_{item}.pt`` files
    (the store's name without ``.memmap``, prefix
    ``cached_{text,image}_prefix``) is imported into the ``.memmap`` store
    on first use, its rows in the order of ``corpus.item_names``.
    """
    if which == "text":
        sub, prefix = cfg.cached_text_model, cfg.cached_text_prefix
    else:
        sub, prefix = cfg.cached_image_model, cfg.cached_image_prefix
    memmap_dir = os.path.join(cfg.stored_vector_path, sub + ".memmap")
    if os.path.isdir(memmap_dir):
        return HiddenStateCache.open(memmap_dir)
    pt_dir = os.path.join(cfg.stored_vector_path, sub)
    if os.path.isdir(pt_dir):
        log.info("importing reference .pt cache %s -> %s", pt_dir, memmap_dir)
        return import_reference_pt_dir(pt_dir, prefix, corpus.item_names,
                                       memmap_dir)
    raise FileNotFoundError(
        f"no cache at {memmap_dir} or {pt_dir}; run the cache builder "
        "(iisan_tpu_torch.cache_builder) first")


def validate_config(cfg) -> None:
    """Refuse, with a ValueError, every value that the JAX package refuses:
    a reference command either trains what it says or stops.  A mesh must
    hold the world the run will have (``dist_num_processes``, else
    ``torchrun``'s ``WORLD_SIZE``, else one process)."""
    if cfg.item_tower not in ("modal", "id"):
        raise ValueError(
            f"item_tower={cfg.item_tower!r}: supported values are 'modal' "
            "(multimodal towers) and 'id' (ID-embedding model, the "
            "reference's use_modal=False branches)")
    if (cfg.is_serial == "None" and "houslby" in cfg.adapter_type
            and cfg.adding_adapter_to != "None"):
        raise ValueError(
            "is_serial='None' (parallel Houlsby adapters) is not "
            "implemented; the reference's own parallel branch targets a "
            "module path that does not exist for ViT towers — use "
            "is_serial='True'")
    if cfg.use_scale not in ("half", "None", "none", "fp32", "float32"):
        raise ValueError(
            f"use_scale={cfg.use_scale!r}: 'half' (bf16 activations, the "
            "AMP analog) or 'None'/'fp32' (fp32 activations); other values "
            "are not supported")
    if not ("all" in cfg.fine_tune_to or "None" in cfg.fine_tune_to):
        raise ValueError(
            f"fine_tune_to={cfg.fine_tune_to!r} should contain 'all' or "
            "'None'")
    if "None" in cfg.fine_tune_to and cfg.adding_adapter_to == "None" \
            and cfg.item_tower != "id":
        raise ValueError(
            "fine_tune_to='None' with adding_adapter_to='None' freezes "
            "every parameter — nothing would train")
    if cfg.item_tower == "modal" and "vit" not in cfg.CV_model_load:
        raise ValueError(
            f"CV_model_load={cfg.CV_model_load!r}: only ViT towers are "
            "supported; the reference's resnet/mae branches reference "
            "encoder classes that do not exist in its cached trees")
    if cfg.cache_quant not in ("none", "int8"):
        raise ValueError(
            f"cache_quant={cfg.cache_quant!r}: supported values are 'none' "
            "and 'int8'")
    if cfg.cache_quant != "none" and (
            effective_pipeline(cfg) not in ("cached", "cached_asym")):
        raise ValueError(
            f"cache_quant={cfg.cache_quant!r} only applies to the cached "
            "pipelines (there is no resident tap table to quantize in "
            f"pipeline={effective_pipeline(cfg)!r})")
    if cfg.remat_towers not in (False, True, "mlp"):
        raise ValueError(
            f"remat_towers={cfg.remat_towers!r}: supported values are "
            "False (store activations), True (full per-layer remat) and "
            "'mlp' (full remat except the stored pre-GELU MLP hidden)")
    if cfg.dropout_prng not in ("threefry2x32", "rbg"):
        raise ValueError(
            f"dropout_prng={cfg.dropout_prng!r}: supported values are "
            "'threefry2x32' and 'rbg' (the JAX package's; the port draws "
            "Philox4x32-10 under either)")
    if cfg.dist_num_processes > 1 and not cfg.dist_coordinator:
        raise ValueError(
            f"dist_num_processes={cfg.dist_num_processes} needs "
            "dist_coordinator (host:port of process 0)")
    if cfg.dist_num_processes > 1 and not (
            0 <= cfg.dist_process_id < cfg.dist_num_processes):
        raise ValueError(
            f"dist_process_id={cfg.dist_process_id} is not a rank of "
            f"dist_num_processes={cfg.dist_num_processes}")
    world = cfg.dist_num_processes if cfg.dist_num_processes > 1 else \
        int(os.environ.get("WORLD_SIZE", 1))
    _, sizes = parse_mesh_spec(cfg.mesh_shape, world)
    if int(np.prod(sizes)) != world:
        raise ValueError(
            f"mesh_shape={cfg.mesh_shape!r} holds {int(np.prod(sizes))} "
            f"ranks but the run has {world} process(es)")


def effective_pipeline(cfg) -> str:
    """The pipeline after the reference's ``use_modal`` dispatch:
    ``item_tower="id"`` selects the ID-embedding model whatever
    ``pipeline`` says."""
    return "id" if cfg.item_tower == "id" else cfg.pipeline


def _image_store(cfg):
    """The uncached pipeline's images: the store at ``<root_data_dir>/
    <dataset>/<lmdb_data>`` (an LMDB, or a directory of JPEGs), synthetic
    ones with a warning where nothing is there (``open_image_source``)."""
    from ..data.images import open_image_source

    return open_image_source(
        os.path.join(cfg.root_data_dir, cfg.dataset, cfg.lmdb_data),
        cfg.CV_resize)


def build_trainer(cfg, corpus, token_table, device):
    """The trainer of ``effective_pipeline(cfg)`` on ``device``."""
    pipeline = effective_pipeline(cfg)
    if pipeline == "id" and cfg.pipeline != "id":
        log.info("item_tower='id' -> ID-embedding pipeline (use_modal=False)")
    if pipeline in ("cached", "cached_asym"):
        from .cached import CachedTrainer

        text_taps = open_cache(cfg, "text", corpus).load_taps(cfg.san_text_taps())
        cv_taps = open_cache(cfg, "image", corpus).load_taps(cfg.san_image_taps())
        return CachedTrainer(cfg, corpus, cv_taps, text_taps, device=device)
    if pipeline == "uncached":
        from .uncached import UncachedTrainer

        return UncachedTrainer(cfg, corpus, token_table, _image_store(cfg),
                               device=device)
    if pipeline == "id":
        from .id_pipeline import IDTrainer

        return IDTrainer(cfg, corpus, device=device)
    raise ValueError(f"unknown pipeline {pipeline}")


def warm_start(trainer, cfg) -> None:
    """``pretrained_recsys_model``'s parameters into the trainer's model: a
    ``.pt`` is a reference checkpoint (``utils/torch_import.py``), any
    other name a checkpoint of ``cfg.ckpt_dir`` (its model only)."""
    name = cfg.pretrained_recsys_model
    if name.endswith(".pt"):
        from ..utils.jax_params import export_jax_params, load_jax_params
        from ..utils.torch_import import params_from_reference_checkpoint

        load_jax_params(trainer.model, params_from_reference_checkpoint(
            name, template=export_jax_params(trainer.model)))
    else:
        from ..utils.checkpoint import restore_checkpoint

        state, _ = restore_checkpoint(cfg.ckpt_dir, name)
        trainer.model.load_state_dict(state["model"])
    log.info("warm-started params from %s", name)


def run_from_config(cfg, eval_only: bool = False, device=None):
    """Train (or, with ``eval_only``, test) the configuration's model on
    ``device`` (default the first CUDA card; the CPU only when asked for).
    Returns (trainer, TrainResult or None).  Logs the launch counts of the
    port's kernels at the end."""
    validate_config(cfg)
    setup_logger(cfg.log_dir, cfg.label_screen if cfg.label_screen != "None"
                 else cfg.pipeline, cfg.mode)
    log.info("config: %s", cfg)
    device = resolve_device(device)
    log.info("dropout_prng=%r names a JAX PRNG; the port draws its dropout "
             "bits from Philox4x32-10", cfg.dropout_prng)
    t0 = time.time()
    corpus, token_table = load_corpus(cfg)
    log.info("items %d users %d", corpus.item_num, corpus.n_users)
    trainer = build_trainer(cfg, corpus, token_table, device)

    start_epoch = 0
    if cfg.load_ckpt_name != "None":
        start_epoch = trainer.resume(cfg.load_ckpt_name)
        log.info("resumed from %s at epoch %d", cfg.load_ckpt_name,
                 start_epoch)
    elif cfg.pretrained_recsys_model != "None":
        warm_start(trainer, cfg)

    def finish():
        if cfg.export_recommender:
            from ..serve import Recommender

            # every rank builds the item table (a feature-sharded one takes
            # collectives); rank 0 writes the file
            rec = Recommender.from_trainer(trainer)
            if is_main():
                rec.save(cfg.export_recommender)
                log.info("exported serving artifact to %s",
                         cfg.export_recommender)
            barrier()
        log.info("kernel launches: %s", json.dumps(kernel_launches()))

    if eval_only:
        hit, ndcg = trainer.evaluate_split("test")
        log.info("test_methods   Hit10\tnDCG10")
        log.info("test_results   %.5f\t%.5f", hit * 100, ndcg * 100)
        finish()
        return trainer, None

    result = trainer.train(start_epoch=start_epoch,
                           save_checkpoints=cfg.save_checkpoints)
    tpme = TPMETracker()
    tpme.record_run(time.time() - t0, trainer, label=cfg.pipeline,
                    result=result)
    log.info("TPME inputs: %s", tpme.summary())
    finish()
    return trainer, result
