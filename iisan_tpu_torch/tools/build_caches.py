"""Build a dataset's hidden-state caches with the port's towers.

Port of ``iisan_tpu/tools/build_caches.py``: reads the item and behaviour
TSVs, loads the text and image towers' weights from transformers
checkpoints (or an EVA directory), and writes one store per tower under
``--out``:

- text: ``bert_outputs.memmap`` (``--text-arch bert``, CLS or ``--pool
  mean``) or ``llama_outputs.memmap`` (``llama``: the reference Llama
  builders' layout, 0-padded titles with an all-ones mask, mean-pooled);
- image: ``vit_outputs.memmap`` (``vit``), ``clip_outputs.memmap``
  (``clip``) or ``eva_clip_outputs.memmap`` (``eva``: a directory with
  ``config.json``, its vision fields at the top or under
  ``vision_config``, and ``pytorch_model.bin`` in the public ``eva_clip``
  naming).

The towers run on ``--device`` (default the first CUDA card; raises
without one; ``--device cpu`` for the CPU); BERT and ViT attention goes
through the attention kernel on the card.  ``--image-source`` names the
images (``data/images.open_image_source``): an LMDB (``python -m
iisan_tpu_torch.tools.build_lmdb`` writes one) or a directory of JPEGs;
empty, or nothing at the path, gives synthetic image states (one seeded
image per item name) with a warning.

Sharding: ``--num-shards N --shard-id i`` builds a contiguous range of
rows; processes on one host share each store, processes on several hosts
add ``--shard-files`` (each writes ``<store>.shard<i>``) and one
``--finalize-shards`` run merges them afterwards (it loads no tower and no
transformers).

    python -m iisan_tpu_torch.tools.build_caches --dataset DATA_DIR \\
        --items items.tsv --behaviors users.tsv \\
        --text-model bert-base-uncased \\
        --image-model google/vit-base-patch16-224 --out ./stored_vectors
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
from types import SimpleNamespace


def shard_range(n_rows: int, shard_id: int, num_shards: int):
    """This shard's [lo, hi) slice of the item rows [1, n_rows): ceil-sized
    contiguous ranges (row 0 is the pad item, made with the store); the
    last shards may be short or empty.  One shard: (1, None), the whole
    store with plain resume semantics."""
    if num_shards == 1:
        return 1, None
    per = -(-(n_rows - 1) // num_shards)
    lo = min(1 + shard_id * per, n_rows)
    hi = min(1 + (shard_id + 1) * per, n_rows)
    return lo, hi


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset")
    ap.add_argument("--items")
    ap.add_argument("--behaviors")
    ap.add_argument("--text-model", default="bert-base-uncased")
    ap.add_argument("--image-model", default="google/vit-base-patch16-224")
    ap.add_argument("--text-arch", default="bert", choices=["bert", "llama"],
                    help="llama: the Llama-3-70B Versa tower (mean-pooled, "
                         "all-ones mask)")
    ap.add_argument("--image-arch", default="vit", choices=["vit", "clip", "eva"],
                    help="clip: a CLIP vision tower; eva: the EVA-CLIP-18B "
                         "Versa tower from a local directory (config.json + "
                         "pytorch_model.bin in the eva_clip naming)")
    ap.add_argument("--image-source", default="",
                    help="an image LMDB (file or directory form) or a "
                         "directory of <name>.jpg; empty: synthetic images")
    ap.add_argument("--out", required=True)
    ap.add_argument("--pool", default="cls", choices=["cls", "mean"],
                    help="mean: the per-layer masked token mean")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--num-words-title", type=int, default=30)
    ap.add_argument("--resize", type=int, default=224)
    ap.add_argument("--max-seq-len", type=int, default=10)
    ap.add_argument("--min-seq-len", type=int, default=5)
    ap.add_argument("--dtype", default="float16",
                    help="store dtype: float16, float32, or int8 (each "
                         "(item, layer) row quantised with an fp32 scale)")
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--shard-files", action="store_true",
                    help="write this shard's rows into its own "
                         "<store>.shard<i> store (builds on several hosts); "
                         "merge with --finalize-shards")
    ap.add_argument("--finalize-shards", action="store_true",
                    help="merge every <store>.shard* under --out into its "
                         "final store and delete the shards")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; "
                         "raises without one; 'cpu' for the CPU)")
    return ap


def finalize_shards(out: str) -> int:
    """Merge every ``*.shard*`` store under ``out``; returns the count of
    stores merged."""
    from ..data.cache_store import merge_shard_stores

    bases = sorted({p.rsplit(".shard", 1)[0]
                    for p in glob.glob(os.path.join(out, "*.shard*"))
                    if os.path.isdir(p)})
    for base in bases:
        st = merge_shard_stores(base)
        print(f"merged {base}: {st.meta.n_items} items x "
              f"{st.meta.n_layers} layers x {st.meta.dim} dim")
    return len(bases)


def _text_tower(args, hf, titles, tok, device):
    """(encoder with the checkpoint's weights, packed token rows, pool,
    store name); ``hf`` holds transformers' ``AutoConfig`` and
    ``AutoModel``."""
    from ..data import preprocess as prep
    from ..models import bert, llama
    from ..utils.jax_params import load_jax_params

    cfg = hf.AutoConfig.from_pretrained(args.text_model)
    sd = hf.AutoModel.from_pretrained(args.text_model).state_dict()
    if args.text_arch == "llama":
        enc = llama.encoder_from_hf_config(cfg, device=device)
        params = llama.params_from_hf_torch(sd, cfg.num_hidden_layers, prefix="")
        tokens = prep.tokenize_titles_llama(titles, tok, args.num_words_title)
        pool, name = "mean", "llama_outputs.memmap"
    else:
        enc = bert.BertEncoder(
            vocab_size=cfg.vocab_size, hidden_dim=cfg.hidden_size,
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            intermediate_dim=cfg.intermediate_size,
            max_position=cfg.max_position_embeddings, dropout=0.0,
            fused_attention=True, device=device)
        params = bert.params_from_hf_torch(sd, cfg.num_hidden_layers)
        tokens = prep.tokenize_titles(titles, tok, args.num_words_title)
        pool, name = args.pool, "bert_outputs.memmap"
    load_jax_params(enc, params)
    return enc, tokens, pool, name


def _image_tower(args, hf, device):
    """(encoder with the checkpoint's weights, store name)."""
    import torch

    from ..models import clip_vit, eva, vit
    from ..utils.jax_params import load_jax_params

    if args.image_arch == "eva":
        with open(os.path.join(args.image_model, "config.json")) as f:
            raw = json.load(f)
        vraw = raw.get("vision_config", raw)
        cfg = SimpleNamespace(**vraw)
        enc = eva.encoder_from_hf_config(cfg, device=device)
        sd = torch.load(os.path.join(args.image_model, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
        params = eva.params_from_eva_torch(
            sd, cfg.num_hidden_layers, prefix=vraw.get("state_dict_prefix", ""),
            sub_ln=getattr(cfg, "subln", True))
        name = "eva_clip_outputs.memmap"
    elif args.image_arch == "clip":
        cfg = hf.AutoConfig.from_pretrained(args.image_model)
        cfg = getattr(cfg, "vision_config", cfg)
        sd = hf.AutoModel.from_pretrained(args.image_model).state_dict()
        enc = clip_vit.encoder_from_hf_config(cfg, device=device)
        params = clip_vit.params_from_hf_torch(sd, cfg.num_hidden_layers)
        name = "clip_outputs.memmap"
    else:
        cfg = hf.AutoConfig.from_pretrained(args.image_model)
        sd = hf.AutoModel.from_pretrained(args.image_model).state_dict()
        enc = vit.ViTEncoder(
            image_size=args.resize, patch_size=cfg.patch_size,
            hidden_dim=cfg.hidden_size, num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            intermediate_dim=cfg.intermediate_size, fused_attention=True,
            device=device)
        params = vit.params_from_hf_torch(sd, cfg.num_hidden_layers, prefix="")
        name = "vit_outputs.memmap"
    load_jax_params(enc, params)
    return enc, name


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if not 0 <= args.shard_id < args.num_shards:
        ap.error(f"--shard-id {args.shard_id} out of range for "
                 f"--num-shards {args.num_shards}")
    if args.finalize_shards:
        if not finalize_shards(args.out):
            ap.error(f"--finalize-shards: no *.shard* stores under {args.out}")
        return
    for flag in ("dataset", "items", "behaviors"):
        if getattr(args, flag) is None:
            ap.error(f"--{flag} is required (unless --finalize-shards)")
    from transformers import AutoConfig, AutoModel, AutoTokenizer

    from ..cache_builder import (build_image_cache, build_text_cache,
                                 state_geometry, verify_cache)
    from ..data import preprocess as prep
    from ..data.cache_store import write_shard_range
    from ..data.images import open_image_source
    from ..device import resolve_device

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = resolve_device(args.device)
    titles, n2i, i2n = prep.read_items(os.path.join(args.dataset, args.items))
    corpus = prep.read_behaviors(os.path.join(args.dataset, args.behaviors),
                                 n2i, i2n, args.max_seq_len, args.min_seq_len)

    def build(what, enc, n_rows, name, run):
        """Run one tower's build over this shard's rows, check and
        record it."""
        lo, hi = shard_range(n_rows, args.shard_id, args.num_shards)
        path = os.path.join(args.out, name)
        if args.shard_files:
            path += f".shard{args.shard_id}"
        store = run(path, lo, hi)
        verify_cache(store, *state_geometry(enc), first_row=lo)
        if args.shard_files:
            write_shard_range(path, lo, n_rows if hi is None else hi)
        print(f"{what} cache: {path} ({store.meta.n_items} items x "
              f"{store.meta.n_layers} layers x {store.meta.dim} dim)")

    # the image source is opened first: one that cannot be opened stops
    # the build before any tower runs
    images = open_image_source(args.image_source, args.resize)
    hf = SimpleNamespace(AutoConfig=AutoConfig, AutoModel=AutoModel)
    tok = AutoTokenizer.from_pretrained(args.text_model)
    enc, full_tokens, pool, name = _text_tower(args, hf, titles, tok, device)
    tokens = prep.remap_token_table(full_tokens, corpus.item_names, n2i)
    build("text", enc, tokens.shape[0], name, lambda path, lo, hi: build_text_cache(
        enc, tokens, path, batch=args.batch, pool=pool, dtype=args.dtype,
        start_item=lo, end_item=hi, device=device))
    del enc

    enc, name = _image_tower(args, hf, device)
    build("image", enc, len(corpus.item_names), name,
          lambda path, lo, hi: build_image_cache(
              enc, corpus.item_names, images, path, batch=args.batch,
              dtype=args.dtype, start_item=lo, end_item=hi, device=device))
    print("caches written to", args.out)


if __name__ == "__main__":
    main()
