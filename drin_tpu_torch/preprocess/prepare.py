# -*- coding: utf-8 -*-
"""Character span -> token span (the port's copy of
``drin_tpu/preprocess/prepare.py``'s ``MentionPositionProcessor``; the rest
of the prepare stage is not ported yet)."""

from __future__ import annotations

from typing import List

from drin_tpu_torch.text.wordpiece import BertTokenizer


class MentionPositionProcessor:
    """Char span -> token span: tokens(prefix) and tokens(mention) counted via
    attention-mask sums minus CLS/SEP.  Both are tokenized with
    ``truncation=True``, so a prefix longer than ``model_max_length`` is
    clipped, not counted."""

    def __init__(self, tokenizer: BertTokenizer):
        self.tokenizer = tokenizer

    def __call__(self, sentences: List[str], starts, ends):
        before = [s[:b] for s, b in zip(sentences, starts)]
        mentions = [s[b:e] for s, b, e in zip(sentences, starts, ends)]
        n_before = self.tokenizer(before, padding=True, truncation=True)["attention_mask"].sum(-1) - 2
        n_mention = self.tokenizer(mentions, padding=True, truncation=True)["attention_mask"].sum(-1) - 2
        return n_before, n_before + n_mention
