# -*- coding: utf-8 -*-
"""Pure-Python CLIP BPE tokenizer (the port's copy of
``drin_tpu/text/clip_bpe.py``), compatible with HF ``CLIPTokenizer`` given
the same ``vocab.json``/``merges.txt`` (no ftfy path: lowercasing
BasicTokenizer + byte-level BPE with ``</w>`` word ends).

The CLIP preprocessing stage tokenizes with it on the host.  Texts over the
length cap are truncated keeping their end token (``[bos] + tokens[:cap-2]
+ [eos]``), so that CLIP's ``argmax(input_ids)`` pooling reads a real end
of text."""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

try:  # for the \p{L} / \p{N} classes of the split pattern
    import regex as re_
except ImportError:  # pragma: no cover
    # stdlib re cannot compile \p{L}/\p{N}: fail here, naming the package,
    # not at the compile below with "bad escape \p"
    raise ImportError(
        "drin_tpu_torch.text.clip_bpe requires the 'regex' package for the CLIP "
        "BPE split pattern's \\p{L} classes")

from drin_tpu_torch.text.wordpiece import BasicTokenizer

_PAT = re_.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re_.IGNORECASE,
)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The byte -> printable character table of byte-level BPE (256 entries)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class CLIPTokenizer:
    def __init__(self, vocab_file: Optional[str] = None, merges_file: Optional[str] = None,
                 vocab: Optional[Dict[str, int]] = None, merges: Optional[List[Tuple[str, str]]] = None,
                 model_max_length: int = 77):
        if vocab is None:
            with open(vocab_file, encoding="utf-8") as f:
                vocab = json.load(f)
        if merges is None:
            with open(merges_file, encoding="utf-8") as f:
                lines = f.read().strip().split("\n")[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(l.split()) for l in lines]
        self.encoder = vocab
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.nlp = BasicTokenizer(do_lower_case=True, strip_accents=False, do_split_on_punc=False)
        self.bos_id = vocab["<|startoftext|>"]
        self.eos_id = vocab["<|endoftext|>"]
        self.unk_id = self.eos_id
        self.pad_id = self.eos_id  # HF pads with eos
        self.model_max_length = model_max_length

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        text = " ".join(self.nlp.tokenize(text))
        out: List[str] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self.bpe(token).split(" "))
        return out

    def __call__(self, texts, padding: bool = True, truncation: bool = True,
                 max_length: Optional[int] = None):
        """``{"input_ids", "attention_mask"}`` as int64 arrays [N, L]:
        ``padding="max_length"`` pads to the cap, ``True`` to the longest."""
        if isinstance(texts, str):
            texts = [texts]
        cap = max_length or self.model_max_length
        seqs = []
        for t in texts:
            ids = [self.bos_id] + [self.encoder.get(tok, self.unk_id) for tok in self.tokenize(t)] + [self.eos_id]
            if truncation and len(ids) > cap:
                ids = ids[: cap - 1] + [self.eos_id]
            seqs.append(ids)
        L = max((len(s) for s in seqs), default=2)
        if padding == "max_length":
            L = cap
        input_ids = np.full((len(seqs), L), self.pad_id, dtype=np.int64)
        attention_mask = np.zeros((len(seqs), L), dtype=np.int64)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            attention_mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}
