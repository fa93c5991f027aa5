"""BERT's WordPiece tokenizer over a ``vocab.txt``, without transformers.

The run path tokenizes item titles with BERT's tokenizer
(``train/pipelines.load_tokenizer``); the GPU machine has no
``transformers``, so the port carries the function that
``transformers.BertTokenizerFast`` computes for a BERT vocabulary, in the
order of its normalizer and pre-tokenizer:

1. clean: drop NUL, U+FFFD and control characters, map whitespace to " ";
2. put spaces around CJK ideographs (``tokenize_chinese_chars``);
3. strip accents (NFD, drop nonspacing marks) when ``strip_accents``, or
   when it is unset and the text is lowercased;
4. lowercase (``do_lower_case``);
5. split on whitespace, then split off every punctuation character;
6. WordPiece: greedy longest match from the vocabulary, continuations
   prefixed "##", a word that cannot be matched (or longer than 100
   characters) becomes ``[UNK]``.

A call adds ``[CLS]`` and ``[SEP]``, truncates the word pieces to
``max_length - 2`` and pads with ``[PAD]`` to ``max_length``.
``tests/test_torch_wordpiece.py`` holds it to ``BertTokenizerFast``.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

MAX_CHARS_PER_WORD = 100


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BertWordPiece:
    """``BertTokenizerFast``'s ids and attention masks for a vocabulary.

    vocab: token -> id (a ``vocab.txt``'s line numbers); the special
    tokens ``[CLS]``, ``[SEP]``, ``[PAD]`` and ``[UNK]`` must be in it.
    """

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True):
        missing = [t for t in ("[CLS]", "[SEP]", "[PAD]", "[UNK]")
                   if t not in vocab]
        if missing:
            raise ValueError(f"the vocabulary has no {missing}")
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.strip_accents = (do_lower_case if strip_accents is None
                              else strip_accents)
        self.tokenize_chinese_chars = tokenize_chinese_chars

    @classmethod
    def from_dir(cls, path: str) -> "BertWordPiece":
        """The tokenizer of a BERT model directory: its ``vocab.txt``, and
        ``do_lower_case`` / ``strip_accents`` / ``tokenize_chinese_chars``
        from its ``tokenizer_config.json`` where there is one."""
        vocab_file = os.path.join(path, "vocab.txt")
        if not os.path.isfile(vocab_file):
            raise FileNotFoundError(f"no vocab.txt in {path}")
        with open(vocab_file, "r", encoding="utf-8") as f:
            vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        opts = {}
        config = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(config):
            with open(config, "r", encoding="utf-8") as f:
                conf = json.load(f)
            opts = {k: conf[k] for k in ("do_lower_case", "strip_accents",
                                         "tokenize_chinese_chars") if k in conf}
        return cls(vocab, **opts)

    def _words(self, text: str) -> List[str]:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                out.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        text = "".join(out)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.do_lower_case:
            text = text.lower()
        words = []
        for word in text.split():
            start = 0
            for i, ch in enumerate(word):
                if _is_punctuation(ch):
                    if i > start:
                        words.append(word[start:i])
                    words.append(ch)
                    start = i + 1
            if start < len(word):
                words.append(word[start:])
        return words

    def _pieces(self, word: str) -> List[int]:
        unk = [self.vocab["[UNK]"]]
        if len(word) > MAX_CHARS_PER_WORD:
            return unk
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if end == start:
                return unk
            start = end
        return ids

    def encode(self, text: str, max_length: int) -> List[int]:
        """``[CLS]`` + the word pieces truncated to ``max_length - 2`` +
        ``[SEP]``."""
        ids = [i for w in self._words(text) for i in self._pieces(w)]
        return ([self.vocab["[CLS]"]] + ids[:max(max_length - 2, 0)]
                + [self.vocab["[SEP]"]])

    def __call__(self, texts: Sequence[str], max_length: int,
                 padding: str = "max_length", truncation: bool = True):
        """{"input_ids", "attention_mask"}: one row of ``max_length`` per
        text, as ``BertTokenizerFast(texts, max_length=max_length,
        padding="max_length", truncation=True)``."""
        if padding != "max_length" or not truncation:
            raise ValueError("only padding='max_length' with truncation=True")
        pad = self.vocab["[PAD]"]
        ids, mask = [], []
        for text in texts:
            row = self.encode(text, max_length)
            ids.append(row + [pad] * (max_length - len(row)))
            mask.append([1] * len(row) + [0] * (max_length - len(row)))
        return {"input_ids": ids, "attention_mask": mask}
