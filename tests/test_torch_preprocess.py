"""Port parity for the dataset ETL (``data/preprocess.py``).

Item and behaviour TSVs written here (four-column items: name, title,
abstract, body; users with short, long and duplicate-item sequences) and a
BERT tokenizer built from a ``vocab.txt`` written here (no download) go
through each function of both packages; every output is equal, array for
array and key for key.  The port module imports no transformers (the
tokenizer is handed in).
"""

import dataclasses

import numpy as np
import pytest

from iisan_tpu.data import preprocess as jprep
from iisan_tpu_torch.data import preprocess as tprep
from iisan_tpu_torch.data.synthetic import synthetic_corpus

transformers = pytest.importorskip("transformers")

WORDS = ("acid beaker burette clamp dish flask funnel gauge glove lamp lens "
         "magnet meter pipette probe rack scale sensor stand tongs tube valve "
         "wire")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    words = WORDS.split()
    with open(root / "items.tsv", "w") as f:
        for i in range(40):
            title = " ".join(rng.choice(words, size=int(rng.integers(1, 12))))
            f.write(f"V{i:03d}\t{title.title()}\tabout {words[i % 23]}\t"
                    f"{' '.join(rng.choice(words, size=30))}\n")
    with open(root / "users.tsv", "w") as f:
        for u in range(30):
            n = int(rng.integers(3, 20))
            seq = " ".join(f"V{int(x):03d}" for x in rng.integers(0, 36, size=n))
            f.write(f"U{u}\t{seq}\n")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                               + words + ["about", "##s"]) + "\n")
    tok = transformers.BertTokenizerFast(vocab_file=str(vocab))
    return root, tok


def _equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_read_items_and_items_from_behaviors(dataset):
    root, _ = dataset
    _equal(tprep.read_items(str(root / "items.tsv")),
           jprep.read_items(str(root / "items.tsv")))
    _equal(tprep.items_from_behaviors(str(root / "users.tsv")),
           jprep.items_from_behaviors(str(root / "users.tsv")))


@pytest.mark.parametrize("max_len,min_len", [(10, 5), (4, 3)])
def test_read_behaviors(dataset, max_len, min_len):
    root, _ = dataset
    corpora = []
    for prep in (tprep, jprep):
        _, n2i, i2n = prep.read_items(str(root / "items.tsv"))
        corpora.append(prep.read_behaviors(str(root / "users.tsv"), n2i, i2n,
                                           max_len, min_len))
    got, want = corpora
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        _equal(getattr(got, f.name), getattr(want, f.name))
    assert got.n_users == want.n_users and got.item_num < 40


def test_tokenize_titles_and_remap(dataset):
    root, tok = dataset
    titles, n2i, i2n = tprep.read_items(str(root / "items.tsv"))
    corpus = tprep.read_behaviors(str(root / "users.tsv"), n2i, i2n, 10, 5)
    for fn in ("tokenize_titles", "tokenize_titles_llama"):
        got = getattr(tprep, fn)(titles, tok, 8)
        want = getattr(jprep, fn)(titles, tok, 8)
        _equal(got, want)
        assert not got[0, :8].any()  # the pad item has no ids
        _equal(tprep.remap_token_table(got, corpus.item_names, n2i),
               jprep.remap_token_table(want, corpus.item_names, n2i))
    llama = tprep.tokenize_titles_llama(titles, tok, 8)
    assert (llama[:, 8:] == 1).all()  # the reference builders attend to pads
    assert (llama[1:, :8] == 0).any()


@pytest.mark.parametrize("attrs,words", [(("title",), (8,)),
                                         (("title", "abstract", "body"), (6, 4, 12)),
                                         (("body",), (10,))])
def test_attributes(dataset, attrs, words):
    root, tok = dataset
    texts = tprep.read_item_attributes(str(root / "items.tsv"))
    _equal(texts, jprep.read_item_attributes(str(root / "items.tsv")))
    _equal(tprep.tokenize_attributes(texts, tok, attrs, words),
           jprep.tokenize_attributes(texts, tok, attrs, words))


def test_synthetic_corpus_is_a_preprocess_corpus():
    """One ``Corpus`` class: the synthetic corpora are the ETL's type."""
    assert isinstance(synthetic_corpus(n_users=4, item_num=10), tprep.Corpus)
