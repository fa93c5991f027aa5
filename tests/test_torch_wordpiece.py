"""The port's BERT WordPiece tokenizer (``iisan_tpu_torch/data/wordpiece.py``)
against transformers' ``BertTokenizerFast``, which the JAX package's
``load_tokenizer`` returns.

A vocabulary written here (special tokens, words, "##" continuations,
punctuation, an accented and a CJK entry), saved by ``BertTokenizerFast``
with and without lowercasing: for fixed titles and a hypothesis sweep of
texts over letters, accents (composed and combining), CJK and
supplementary ideographs, punctuation, controls, tabs and zero-width
characters, the ids and attention masks are equal at ``max_length`` 6 and
16.  ``load_tokenizer`` returns it for a model directory.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.wordpiece import BertWordPiece
from iisan_tpu_torch.train.pipelines import load_tokenizer

transformers = pytest.importorskip("transformers")

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cafe", "café",
         "##s", "un", "##aff", "##able", "a", "b", "##b", "##a", ",", ".", "!",
         "-", "中", "x", "##x", "i", "ñ", "n", "Ab", "##A", "item", "title"]
ALPHABET = list("abxnABi .,!'-\t\n\r\x00\x7f") + [
    "\u4e2d", "\u56fd", "\u00f1", "\u00d1", "\u00e9", "\u00c9", "\u0301",
    "\u200b", "\u00a0", "\ufffd", "\U00020000", "\u0130", "\u00df"]


@pytest.fixture(scope="module", params=[True, False], ids=["lower", "cased"])
def pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("tok")
    (path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    hf = transformers.BertTokenizerFast(vocab_file=str(path / "vocab.txt"),
                                        do_lower_case=request.param)
    hf.save_pretrained(str(path))
    return hf, BertWordPiece.from_dir(str(path)), path


def _same(hf, mine, texts, n):
    want = hf(texts, max_length=n, padding="max_length", truncation=True)
    got = mine(texts, max_length=n)
    assert got["input_ids"] == want["input_ids"]
    assert got["attention_mask"] == want["attention_mask"]


@pytest.mark.parametrize("n", [6, 16])
def test_titles_match_bert_tokenizer_fast(pair, n):
    hf, mine, _ = pair
    _same(hf, mine, ["The Cafés, unaffable!", "中国 x", "ÑAB ab ba", "İi ß",
                     "a\tb\x00c​d", "x" * 120, "item-title.x", "", "   ",
                     "unaffables untitled"], n)


@settings(max_examples=200, deadline=None)
@given(texts=st.lists(st.text(alphabet=st.sampled_from(ALPHABET), max_size=24),
                      min_size=1, max_size=4))
def test_text_sweep_matches_bert_tokenizer_fast(pair, texts):
    hf, mine, _ = pair
    _same(hf, mine, texts, 16)


def test_load_tokenizer_returns_it(pair, tmp_path):
    hf, _, path = pair
    model = tmp_path / "pretrained_models" / "bert" / "bert_base_uncased"
    model.mkdir(parents=True)
    for f in path.iterdir():
        (model / f.name).write_bytes(f.read_bytes())
    tok = load_tokenizer(IISANConfig(root_data_dir=str(tmp_path)))
    assert isinstance(tok, BertWordPiece)
    assert tok.do_lower_case == hf.do_lower_case
    _same(hf, tok, ["The Café item"], 8)
