"""Inputs made from the seed: the corpus, the title table, the image
catalogue and the serving requests.

``synthetic_corpus`` and ``synthetic_token_table`` are copies of the
port's generators (``data/synthetic.py``, ``data/images.py``), so that the
program cannot change what the benchmark feeds it.  Images are uniform
uint8 pixels made on the device in one call.  Every function takes the
seed and gives the same arrays for the same seed.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

# Streams drawn from one run seed, so no two inputs share a generator.
STREAMS = {"corpus": 1, "titles": 2, "images": 3, "weights": 4, "order": 5,
           "requests": 6, "catalogue": 7, "sample": 8}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of one input stream of the run seed ``seed``."""
    return (seed * 1_000_003 + STREAMS[stream]) % (2 ** 63)


def torch_generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def synthetic_corpus(n_users: int, item_num: int, max_seq_len: int,
                     min_seq_len: int, seed: int) -> SimpleNamespace:
    """Sequences of min_seq_len..L+3 uniform items per user, the last two
    held out as the port's generator holds them out: ``train_seqs`` (users,
    L+1) left-padded, ``train_log_mask`` (users, L), and ``pop_prob``
    (item_num+1,) the training items' popularity, 1 at the pad item."""
    rng = np.random.default_rng(seed)
    L = max_seq_len
    train_seqs = np.zeros((n_users, L + 1), np.int32)
    train_log_mask = np.zeros((n_users, L), np.float32)
    counts = np.zeros(item_num + 1, np.int64)
    for u in range(n_users):
        n = int(rng.integers(min_seq_len, L + 4))
        seq = rng.integers(1, item_num + 1, size=n)
        train = seq[:-2]
        t = train[-(L + 1):]
        train_seqs[u, L + 1 - len(t):] = t
        train_log_mask[u, L - (len(t) - 1):] = 1.0
        np.add.at(counts, train, 1)
    pop = np.maximum(counts[1:], 1).astype(np.float64)
    pop = pop / pop.sum()
    pop_prob = np.concatenate([[1.0], pop]).astype(np.float32)
    return SimpleNamespace(item_num=item_num, max_seq_len=L,
                           train_seqs=train_seqs,
                           train_log_mask=train_log_mask, pop_prob=pop_prob)


def synthetic_token_table(item_num: int, num_words: int, seed: int,
                          vocab: int) -> np.ndarray:
    """(item_num + 1, 2 * num_words) int32 packed title rows: random ids in
    [1, vocab) then an all-ones mask; row 0 (the pad item) is all zeros."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((item_num + 1, 2 * num_words), np.int32)
    tokens[1:, :num_words] = rng.integers(1, vocab, size=(item_num, num_words))
    tokens[1:, num_words:] = 1
    return tokens


def image_catalogue(item_num: int, size: int, seed: int, device) -> torch.Tensor:
    """(item_num + 1, size, size, 3) uint8 images made on the device; the
    pad item's image is zero, as the port's loader gives it."""
    gen = torch_generator(seed, "images", device)
    images = torch.randint(0, 256, (item_num + 1, size, size, 3),
                           dtype=torch.uint8, generator=gen, device=device)
    images[0] = 0
    return images


def epoch_order(n_users: int, batch: int, steps: int, seed: int) -> np.ndarray:
    """(steps, batch) user indices: seeded permutations of every user, one
    after another, cut into batches; no user repeats inside a batch."""
    rng = np.random.default_rng(stream_seed(seed, "order"))
    per = n_users // batch
    rows = []
    while len(rows) < steps:
        perm = rng.permutation(n_users)[:per * batch]
        rows.extend(perm.reshape(per, batch))
    return np.stack(rows[:steps]).astype(np.int64)


def serve_requests(n_requests: int, batch: int, catalogue_rows: int,
                   hist_min: int, hist_max: int, seed: int):
    """``n_requests`` batches of ``batch`` histories, each of hist_min..
    hist_max items uniform over 1..catalogue_rows.  Every seed gets the
    same set of lengths (each length equally often, in a seeded order), so
    a seed changes which items are asked for, not how much work a request
    is."""
    rng = np.random.default_rng(stream_seed(seed, "requests"))
    lengths = np.resize(np.arange(hist_min, hist_max + 1), n_requests * batch)
    lengths = rng.permutation(lengths).reshape(n_requests, batch)
    requests = []
    for row in lengths:
        items = rng.integers(1, catalogue_rows + 1, size=int(row.sum()))
        cuts = np.cumsum(row)[:-1]
        requests.append([s.tolist() for s in np.split(items, cuts)])
    return requests
