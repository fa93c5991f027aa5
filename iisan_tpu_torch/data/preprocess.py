"""Dataset ETL: TSV readers, leave-one-out split, popularity priors and
title tokenisation.

Port of ``iisan_tpu/data/preprocess.py`` (numpy only there and here): the
item and behaviour TSVs become dense padded arrays (``Corpus``: sequences,
masks, histories, the popularity prior), and titles become the packed
``[ids | attention_mask]`` token rows the text towers read.  The tokenizer
is duck-typed (a ``transformers`` tokenizer, or anything with its
``__call__`` / ``encode``); this module never imports ``transformers``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

log = logging.getLogger("iisan_tpu_torch")


def read_items(path: str) -> Tuple[Dict[int, str], Dict[str, int], Dict[int, str]]:
    """Read the item TSV (name \t title): 1-based ids in file order.

    Merges read_images (preprocess.py:94-107) and read_news
    (preprocess.py:109-120); the LMDB key quirk (cached strips 'v' from
    names, preprocess.py:105) is applied by the LMDB store, not here.
    """
    item_id_to_name = {}
    item_name_to_id = {}
    item_id_to_title = {}
    idx = 1
    with open(path, "r") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            name, title = parts[0], parts[1] if len(parts) > 1 else ""
            item_name_to_id[name] = idx
            item_id_to_name[idx] = name
            item_id_to_title[idx] = title
            idx += 1
    return item_id_to_title, item_name_to_id, item_id_to_name


def items_from_behaviors(path: str):
    """Item registry synthesized from a behaviors TSV (first-seen order),
    for datasets shipped without their items TSV (Office in the reference
    snapshot: .MISSING_LARGE_BLOBS).  Equivalent for any pipeline that
    needs no titles (ID, cached with prebuilt caches, the accuracy
    proxy): read_behaviors re-densifies to interacted items regardless
    (preprocess.py:58-66), so catalog items absent from behaviors never
    survive the ETL anyway.  Titles come back empty."""
    item_id_to_name = {}
    item_name_to_id = {}
    item_id_to_title = {}
    idx = 1
    with open(path, "r") as f:
        for line in f:
            for name in line.rstrip("\n").split("\t")[1].split(" "):
                if name and name not in item_name_to_id:
                    item_name_to_id[name] = idx
                    item_id_to_name[idx] = name
                    item_id_to_title[idx] = ""
                    idx += 1
    return item_id_to_title, item_name_to_id, item_id_to_name


@dataclass
class Corpus:
    """Everything the trainer/eval need, as dense arrays."""

    item_num: int
    max_seq_len: int
    # Per (surviving) item, its original name / LMDB key, index 0 = padding.
    item_names: List[str]
    # Training: left-padded to max_seq_len+1 (dataset.py:65-92 layout).
    train_seqs: np.ndarray      # (n_users, L+1) int32, 0-padded
    train_log_mask: np.ndarray  # (n_users, L) float32
    # Eval: tokens seq[:-1] left-padded to L, plus target and history.
    valid_tokens: np.ndarray    # (n_users, L) int32
    valid_log_mask: np.ndarray  # (n_users, L) float32
    valid_target: np.ndarray    # (n_users,) int32 (1-based item id)
    valid_history: np.ndarray   # (n_users, H) int32, 0-padded
    test_tokens: np.ndarray
    test_log_mask: np.ndarray
    test_target: np.ndarray
    test_history: np.ndarray
    pop_prob: np.ndarray        # (item_num+1,) float32, pop_prob[0] = 1

    @property
    def n_users(self) -> int:
        return self.train_seqs.shape[0]


def read_behaviors(
    behaviors_path: str,
    item_name_to_id: Dict[str, int],
    item_id_to_name: Dict[int, str],
    max_seq_len: int,
    min_seq_len: int,
) -> Corpus:
    """Filter/truncate user sequences, re-densify item ids, leave-one-out
    split, popularity priors (preprocess.py:5-89), then pad to arrays.

    Split semantics (preprocess.py:58-66): for the (<= max_seq_len+3)-long
    truncated sequence, train = seq[:-2], valid = seq[-(L+2):-1],
    test = seq[-(L+1):]; histories are train items (valid) and seq[:-1]
    (test) (preprocess.py:73-74).
    """
    before_item_num = len(item_name_to_id)
    before_counts = np.zeros(before_item_num + 1, dtype=np.int64)
    user_seqs: List[List[int]] = []
    n_before = 0
    with open(behaviors_path, "r") as f:
        for line in f:
            n_before += 1
            parts = line.rstrip("\n").split("\t")
            names = parts[1].split(" ")
            if len(names) < min_seq_len:
                continue
            names = names[-(max_seq_len + 3):]
            ids = [item_name_to_id[x] for x in names]
            user_seqs.append(ids)
            for i in ids:
                before_counts[i] += 1
    log.info("user seqs before %d, after %d", n_before, len(user_seqs))

    # Re-densify surviving item ids preserving order (preprocess.py:36-48).
    old_to_new = {}
    item_names = ["<pad>"]
    for old_id in range(1, before_item_num + 1):
        if before_counts[old_id] != 0:
            old_to_new[old_id] = len(item_names)
            item_names.append(item_id_to_name[old_id])
    item_num = len(item_names) - 1

    L = max_seq_len
    n_users = len(user_seqs)
    train_seqs = np.zeros((n_users, L + 1), dtype=np.int32)
    train_log_mask = np.zeros((n_users, L), dtype=np.float32)
    valid_tokens = np.zeros((n_users, L), dtype=np.int32)
    valid_log_mask = np.zeros((n_users, L), dtype=np.float32)
    valid_target = np.zeros(n_users, dtype=np.int32)
    test_tokens = np.zeros((n_users, L), dtype=np.int32)
    test_log_mask = np.zeros((n_users, L), dtype=np.float32)
    test_target = np.zeros(n_users, dtype=np.int32)
    H = L + 2  # longest possible history (= truncated seq minus 1)
    valid_history = np.zeros((n_users, H), dtype=np.int32)
    test_history = np.zeros((n_users, H), dtype=np.int32)
    train_counts = np.zeros(item_num + 1, dtype=np.int64)

    for u, old_seq in enumerate(user_seqs):
        seq = [old_to_new[i] for i in old_seq]
        train = seq[:-2]
        valid = seq[-(L + 2):-1]
        test = seq[-(L + 1):]

        # Train sample layout (dataset.py:65-72): left-pad seq to L+1;
        # log_mask has len(seq)-1 ones.
        t = train[-(L + 1):]
        train_seqs[u, L + 1 - len(t):] = t
        train_log_mask[u, L - (len(t) - 1):] = 1.0
        for i in train:
            train_counts[i] += 1

        # Eval layout (dataset.py:185-191): tokens = seq[:-1] left-padded
        # to L (total L+1 slots minus the held-out target).
        vt = valid[:-1]
        valid_tokens[u, L - len(vt):] = vt
        valid_log_mask[u, L - len(vt):] = 1.0
        valid_target[u] = valid[-1]
        tt = test[:-1]
        test_tokens[u, L - len(tt):] = tt
        test_log_mask[u, L - len(tt):] = 1.0
        test_target[u] = test[-1]

        # Histories (preprocess.py:73-74): valid sees train items, test sees
        # everything but the final target.
        valid_history[u, :len(train)] = train
        hist_t = seq[:-1]
        test_history[u, :len(hist_t)] = hist_t

    # Popularity prior with prepended 1 for padding (preprocess.py:77-82).
    pop = train_counts[1:].astype(np.float64) ** 1.0
    pop = pop / pop.sum()
    pop_prob = np.concatenate([[1.0], pop]).astype(np.float32)

    return Corpus(
        item_num=item_num,
        max_seq_len=L,
        item_names=item_names,
        train_seqs=train_seqs,
        train_log_mask=train_log_mask,
        valid_tokens=valid_tokens,
        valid_log_mask=valid_log_mask,
        valid_target=valid_target,
        valid_history=valid_history,
        test_tokens=test_tokens,
        test_log_mask=test_log_mask,
        test_target=test_target,
        test_history=test_history,
        pop_prob=pop_prob,
    )


def tokenize_titles(
    item_id_to_title: Dict[int, str],
    tokenizer,
    num_words_title: int,
) -> np.ndarray:
    """Tokenize item titles into the packed [ids | attention_mask] layout.

    Rebuild of read_news_bert + get_doc_input_bert
    (preprocess.py:123-192): row 0 is the all-zero padding item; each row is
    ``num_words_title`` token ids followed by ``num_words_title`` mask
    entries - the packed layout Text_Encoder splits with torch.narrow
    (encoders.py:74-77).
    """
    n = len(item_id_to_title) + 1
    out = np.zeros((n, num_words_title * 2), dtype=np.int32)
    titles = [item_id_to_title[i].lower() for i in range(1, n)]
    enc = tokenizer(
        titles,
        max_length=num_words_title,
        padding="max_length",
        truncation=True,
    )
    out[1:, :num_words_title] = np.asarray(enc["input_ids"], dtype=np.int32)
    out[1:, num_words_title:] = np.asarray(enc["attention_mask"], dtype=np.int32)
    return out


def read_item_attributes(path: str) -> Dict[str, Dict[int, str]]:
    """Item TSV -> per-attribute text dicts {attr: {id: text}}.

    The shipped reference TSVs are two-column (name, title); columns 3/4
    are read as abstract/body when present.  NOTE the reference's own
    read_news_bert crashes (NameError) if 'abstract'/'body' are requested
    — those variables are never assigned (preprocess.py:138-145); this is
    the corrected implementation of that latent capability.
    """
    out = {"title": {}, "abstract": {}, "body": {}}
    idx = 1
    with open(path, "r") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            out["title"][idx] = parts[1] if len(parts) > 1 else ""
            out["abstract"][idx] = parts[2] if len(parts) > 2 else ""
            out["body"][idx] = parts[3] if len(parts) > 3 else ""
            idx += 1
    return out


def tokenize_attributes(
    attr_texts: Dict[str, Dict[int, str]],
    tokenizer,
    attributes: "Tuple[str, ...]",
    attr_words: "Tuple[int, ...]",
) -> np.ndarray:
    """Packed multi-attribute layout: for each active attribute, in the
    fixed title -> abstract -> body order, ``num_words`` ids followed by
    ``num_words`` mask entries (get_doc_input_bert concat order +
    Bert_Encoder.attributes2start, encoders.py:120-136).  Row 0 is the
    padding item.  Body text is truncated to 2000 chars before tokenizing
    (preprocess.py:144).
    """
    n = len(attr_texts["title"]) + 1
    width = sum(2 * w for w in attr_words)
    out = np.zeros((n, width), dtype=np.int32)
    start = 0
    for attr, nw in zip(attributes, attr_words):
        texts = [attr_texts[attr][i].lower() for i in range(1, n)]
        if attr == "body":
            texts = [t[:2000] for t in texts]
        enc = tokenizer(texts, max_length=nw, padding="max_length",
                        truncation=True)
        out[1:, start:start + nw] = np.asarray(enc["input_ids"], np.int32)
        out[1:, start + nw:start + 2 * nw] = np.asarray(
            enc["attention_mask"], np.int32)
        start += 2 * nw
    return out


def tokenize_titles_llama(
    item_id_to_title: Dict[int, str],
    tokenizer,
    num_words_title: int,
) -> np.ndarray:
    """Tokenize titles the way the reference Llama cache builders do
    (Code_Cached_Asym/preprocess_llama-3-70b_micro.py:33-42,58-61):
    ``tokenizer.encode(text, add_special_tokens=True)`` manually 0-padded /
    truncated to ``num_words_title``, with NO attention mask passed to the
    model - pads are attended and later mean-pooled.  The packed layout
    therefore carries an all-ones mask.  Row 0 is the padding item.
    """
    n = len(item_id_to_title) + 1
    out = np.zeros((n, num_words_title * 2), dtype=np.int32)
    for i in range(1, n):
        toks = tokenizer.encode(item_id_to_title[i], add_special_tokens=True)
        toks = toks[:num_words_title]
        out[i, : len(toks)] = np.asarray(toks, dtype=np.int32)
    out[:, num_words_title:] = 1
    return out


def remap_token_table(token_table: np.ndarray, item_names: List[str],
                      item_name_to_id: Dict[str, int]) -> np.ndarray:
    """Reindex a (before_item_num+1, ...) table to surviving dense ids."""
    rows = [0] + [item_name_to_id[n] for n in item_names[1:]]
    return token_table[np.asarray(rows)]
