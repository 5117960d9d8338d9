# -*- coding: utf-8 -*-
"""Pure-Python BERT tokenizer (BasicTokenizer + WordPiece), compatible with
HF ``BertTokenizer`` given the same ``vocab.txt`` (the port's copy of
``drin_tpu/text/wordpiece.py``, its Python path).

Raw-text serving tokenizes on the host: sentences and candidate texts become
the token-id fields of an ``OnlineBatch`` (``data/online.py``), and
``MentionPositionProcessor`` counts tokens with attention-mask sums, so token
counts must match HF's exactly."""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting + optional lowercasing and accent
    stripping (bert-base-cased: do_lower_case=False, strip_accents=None)."""

    def __init__(self, do_lower_case: bool = False, strip_accents: Optional[bool] = None,
                 do_split_on_punc: bool = True):
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.do_split_on_punc = do_split_on_punc

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_chinese(text)
        tokens = text.strip().split() if text.strip() else []
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                if self.strip_accents is not False:
                    tok = self._strip_accents(tok)
            elif self.strip_accents:
                tok = self._strip_accents(tok)
            out.extend(self._split_punc(tok) if self.do_split_on_punc else [tok])
        return out

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_chinese(text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.append(" " + ch + " ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text) if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punc(text: str) -> List[str]:
        out: List[List[str]] = [[]]
        for ch in text:
            if _is_punctuation(ch):
                out.append([ch])
                out.append([])
            else:
                out[-1].append(ch)
        return ["".join(x) for x in out if x]


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece; a word longer than
    ``max_chars`` or with no matching piece becomes ``unk_token``."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]", max_chars: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens


class BertTokenizer:
    """HF-compatible interface subset: ``tokenize``, ``encode``,
    ``encode_batch`` and batched ``__call__`` with padding/truncation
    returning numpy arrays."""

    def __init__(self, vocab_file: Optional[str] = None, vocab: Optional[Dict[str, int]] = None,
                 do_lower_case: bool = False, model_max_length: int = 512,
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", unk_token: str = "[UNK]"):
        if vocab is None:
            if vocab_file is None:
                raise ValueError("BertTokenizer needs a vocab or a vocab_file (vocab.txt)")
            vocab = {}
            with open(vocab_file, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    vocab[line.rstrip("\n")] = i
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPieceTokenizer(vocab, unk_token)
        self.model_max_length = model_max_length
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def _word_ids(self, text: str) -> List[int]:
        # tokenize() only emits vocab tokens or [UNK]
        return [self.vocab[t] for t in self.tokenize(text)]

    def encode(self, text: str, truncation: bool = False) -> List[int]:
        ids = [self.cls_id] + self._word_ids(str(text)) + [self.sep_id]
        if truncation and len(ids) > self.model_max_length:
            ids = ids[: self.model_max_length - 1] + [self.sep_id]
        return ids

    def encode_batch(self, texts, truncation: bool = False) -> List[List[int]]:
        """``encode`` for many texts."""
        return [self.encode(t, truncation) for t in texts]

    def __call__(self, texts, padding=True, truncation: bool = False,
                 max_length: Optional[int] = None):
        if isinstance(texts, str):
            texts = [texts]
        cap = max_length or self.model_max_length
        seqs = []
        for t in texts:
            ids = [self.cls_id] + self._word_ids(str(t)) + [self.sep_id]
            if truncation and len(ids) > cap:
                ids = ids[: cap - 1] + [self.sep_id]
            seqs.append(ids)
        L = max((len(s) for s in seqs), default=1)
        if padding == "max_length":
            L = cap
        input_ids = np.full((len(seqs), L), self.pad_id, dtype=np.int64)
        attention_mask = np.zeros((len(seqs), L), dtype=np.int64)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            attention_mask[i, : len(s)] = 1
        return {
            "input_ids": input_ids,
            "token_type_ids": np.zeros_like(input_ids),
            "attention_mask": attention_mask,
        }


def build_tiny_vocab(texts: Iterable[str], extra: Iterable[str] = ()) -> Dict[str, int]:
    """Fabricate a WordPiece vocab covering ``texts`` (test/fixture helper):
    specials + whole words + the ``extra`` entries."""
    basic = BasicTokenizer(False)
    words = set()
    for t in texts:
        words.update(basic.tokenize(t))
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for w in sorted(words) + sorted(set(extra)):
        if w not in vocab:
            vocab[w] = len(vocab)
    return vocab
