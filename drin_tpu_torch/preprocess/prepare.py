# -*- coding: utf-8 -*-
"""Stage 1: raw JSON/TSV -> uniform intermediate ``.npy`` arrays (the
port's copy of ``drin_tpu/preprocess/prepare.py``; host-only, no tensor).

Each raw record parses into a small dataclass through pure helpers (roster
assembly, brief composition, mention location); the split runners assemble
columns from the parsed records.  The semantics are the reference's:
- char-level mention spans become BERT token positions (double-tokenize +
  attention-mask count);
- the candidate roster is padded to ``num_candidates_data`` with
  ``"__nil__"`` and the gold answer appended as the extra candidate, with
  the gold index looked up against the UNPADDED roster first; unmatched
  answers get the sentinel index ``num_candidates_data``;
- entity images resolve through the md5-hashed filename scheme with suffix
  normalization and corrupt/too-small -> default fallback: that naming IS
  the on-disk format of the downloaded image store;
- missing briefs/answers are counted and defaulted.

Output fields: mention_text_raw, mention_image_path, start/end_pos,
entity_attr_raw / entity_name_raw, entity_image_path, answer.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Tuple
from urllib.parse import unquote

import numpy as np

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.common.npy_io import save_field
from drin_tpu_torch.text.wordpiece import BertTokenizer

# The raster-extension stem matcher is part of the image store's on-disk
# naming contract: a stored file is named md5(original_name) + whatever this
# regex leaves of the original name (the ".jpg"-style tail for known raster
# types, the full name otherwise).  The stored filenames need this exact
# pattern.
_RASTER_STEM = re.compile(
    r"(\S+(?=\.(jpg|JPG|png|PNG|svg|SVG)))|(\S+(?=\.(jpeg|JPEG)))")

NIL_NAME = "__nil__"


# ---------------------------------------------------------------------------
# pure per-record helpers


def wiki_title(url: str) -> str:
    """Percent-decoded final path segment of an entity URL
    (``.../wiki/New%20York`` -> ``New York``)."""
    return unquote(url.rsplit("/", 1)[-1])


def roster_with_answer(retrieved: List[str], gold: str,
                       n_slots: int) -> Tuple[List[str], Optional[int]]:
    """The on-disk candidate layout: the retrieved names, ``__nil__`` filler
    out to ``n_slots``, then the gold surface appended as the extra
    (n_slots+1)-th entry.  The gold index is resolved against the UNPADDED
    retrieved list; ``None`` marks a retrieval miss (callers store the
    sentinel index ``n_slots``)."""
    gold_at = retrieved.index(gold) if gold in retrieved else None
    filler = [NIL_NAME] * max(0, n_slots - len(retrieved))
    return retrieved + filler + [gold], gold_at


def brief_text(name: str, briefs: Dict[str, str], cap: int) -> Tuple[str, bool]:
    """Entity attribute line ``"Name: brief..."`` capped at ``cap`` chars.
    Unknown names degrade to the bare name, and the ``__nil__`` filler to an
    empty string.  Returns (text, found)."""
    body = briefs.get(name)
    if body is None:
        return ("" if name == NIL_NAME else name), False
    return f"{name}: {body}"[:cap], True


def locate_mention(sentence: str, surface: str) -> Optional[Tuple[int, int]]:
    """First char span of ``surface`` inside ``sentence``, or ``None`` when
    the mention string does not occur (such records are dropped)."""
    at = sentence.find(surface)
    return None if at < 0 else (at, at + len(surface))


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


# ---------------------------------------------------------------------------
# WikiDiverse


@dataclasses.dataclass
class WDRecord:
    """One parsed WikiDiverse mention (raw item layout: sentence at [0],
    image URL at [1], gold URL at [6], candidate URLs at [7], char span at
    [9]/[10])."""

    sentence: str
    image_url: str
    char_start: int
    char_end: int
    roster: List[str]  # padded, gold appended last
    gold_idx: Optional[int]  # None = retrieval miss


def parse_wd_record(item: list, n_slots: int) -> WDRecord:
    names = [wiki_title(u) for u in item[7]]
    roster, gold_at = roster_with_answer(names, wiki_title(item[6]), n_slots)
    return WDRecord(sentence=item[0], image_url=item[1],
                    char_start=item[9], char_end=item[10],
                    roster=roster, gold_idx=gold_at)


class WDPrepare:
    """WikiDiverse raw -> intermediate."""

    def __init__(self, cfg: Config, mpp: MentionPositionProcessor, check_images: bool = True):
        self.cfg = cfg
        self.mpp = mpp
        self.check_images = check_images
        self.entity2image = self._load_image_index(cfg.entity2image_path)

    @staticmethod
    def _load_image_index(path: str) -> Dict[str, List[str]]:
        """``name@@@@url[AND]url...`` lines (header skipped) -> name -> urls."""
        index: Dict[str, List[str]] = {}
        with open(path) as f:
            for line in list(f)[1:]:
                line = line.strip()
                if line:
                    fields = line.split("@@@@")
                    # segment [1] ONLY: a line with extra separators drops
                    # its tail, and a separator-less line fails loudly, as
                    # the reference's [0]/[1] indexing does (partition()
                    # would keep the tail and change the stored arrays)
                    index[fields[0]] = fields[1].split("[AND]")
        return index

    def run(self, split: str) -> dict:
        cfg = self.cfg
        with open(cfg.mention_text_path % split) as f:
            records = [parse_wd_record(item, cfg.num_candidates_data)
                       for item in json.load(f)]
        with open(cfg.entity2brief_path % split) as f:
            entity2brief = json.load(f)

        stats = dict(image_errors=0, brief_missing=0, no_matching=0)
        briefs, images = [], []
        for rec in records:
            if rec.gold_idx is None:
                stats["no_matching"] += 1
            for name in rec.roster:
                text, found = brief_text(name, entity2brief, cfg.max_entity_attr_char_len)
                stats["brief_missing"] += not found
                briefs.append(text)
                image = self.get_entity_image(name)
                stats["image_errors"] += image == cfg.default_image
                images.append(image)

        sentences = [r.sentence for r in records]
        start_pos, end_pos = self.mpp(sentences,
                                      [r.char_start for r in records],
                                      [r.char_end for r in records])
        miss = cfg.num_candidates_data  # sentinel index for retrieval misses
        out = dict(
            mention_text_raw=np.asarray(sentences),
            mention_image_path=np.asarray(
                [self.get_image_path(r.image_url) for r in records]),
            start_pos=start_pos,
            end_pos=end_pos,
            answer=np.asarray([miss if r.gold_idx is None else r.gold_idx
                               for r in records]),
            entity_image_path=np.asarray(images),
            entity_attr_raw=np.asarray(briefs),
        )
        for k, v in out.items():
            save_field(cfg.preprocess_dir, k, v, split)
        print(f"[prepare:{split}] n={len(records)} {stats}")
        return out

    def get_image_path(self, url: str) -> str:
        """Stored-filename resolution + validity check: md5(name) + the
        raster suffix (svg renamed png: the downloader rasterized those),
        falling back to the default image when the file is missing, corrupt,
        or under min_image_size."""
        cfg = self.cfg
        name = url.rsplit("/", 1)[-1]
        stored = hashlib.md5(name.encode()).hexdigest() + _RASTER_STEM.sub("", name)
        path = os.path.join(cfg.image_dir, stored).replace(".svg", ".png").replace(".SVG", ".png")
        if self.check_images and not self._image_ok(path):
            return cfg.default_image
        return path

    def _image_ok(self, path: str) -> bool:
        from drin_tpu_torch.preprocess.images import pil_image

        Image = pil_image()  # outside the try: a missing Pillow raises, never "bad image"
        try:
            with Image.open(path) as im:
                w, h = im.size
                if w < self.cfg.min_image_size[0] or h < self.cfg.min_image_size[1]:
                    return False
                im.resize((224, 224))  # decodability probe, like the reference
        except Exception:
            return False
        return True

    def get_entity_image(self, name: str) -> str:
        for url in self.entity2image.get(name, ()):
            image = self.get_image_path(url)
            if image != self.cfg.default_image:
                return image
        return self.cfg.default_image


# ---------------------------------------------------------------------------
# WikiMEL


@dataclasses.dataclass
class WMRecord:
    """One parsed WikiMEL mention.  Dropped records (mention surface absent
    from its sentence) parse to ``None``."""

    sentence: str
    char_start: int
    char_end: int
    roster: List[str]  # candidates + gold appended last (NOT padded)
    gold_idx: Optional[int]


def parse_wm_record(info: dict, retrieved: List[str]) -> Optional[WMRecord]:
    span = locate_mention(info["sentence"], info["mentions"])
    if span is None:
        return None
    gold = info["answer"]
    gold_at = retrieved.index(gold) if gold in retrieved else None
    return WMRecord(sentence=info["sentence"], char_start=span[0],
                    char_end=span[1], roster=retrieved + [gold],
                    gold_idx=gold_at)


class WMPrepare:
    """WikiMEL raw -> intermediate."""

    def __init__(self, cfg: Config, mpp: MentionPositionProcessor):
        self.cfg = cfg
        self.mpp = mpp
        self.id2candidate = self._load_candidates(cfg.candidate_path)

    @staticmethod
    def _load_candidates(path: str) -> Dict[str, List[str]]:
        """TSV ``mention_id \\t name \\t name ...`` -> id -> names."""
        index: Dict[str, List[str]] = {}
        with open(path) as f:
            for line in f:
                mention_id, *names = line.strip().split("\t")
                index[mention_id] = names
        return index

    def run(self, split: str) -> dict:
        cfg = self.cfg
        with open(cfg.mention_text_path % split) as f:
            data = json.load(f)
        stats = dict(no_matching=0, mention_not_found=0)
        records = []
        for id_, info in data.items():
            rec = parse_wm_record(info, self.id2candidate[id_])
            if rec is None:
                stats["mention_not_found"] += 1
                continue
            if rec.gold_idx is None:
                stats["no_matching"] += 1
            records.append(rec)

        sentences = [r.sentence for r in records]
        start_pos, end_pos = self.mpp(sentences,
                                      [r.char_start for r in records],
                                      [r.char_end for r in records])
        miss = cfg.num_candidates_data
        out = dict(
            mention_text_raw=np.asarray(sentences),
            entity_name_raw=np.asarray(
                [name for r in records for name in r.roster]),
            start_pos=start_pos,
            end_pos=end_pos,
            answer=np.asarray([miss if r.gold_idx is None else r.gold_idx
                               for r in records]),
        )
        for k, v in out.items():
            save_field(cfg.preprocess_dir, k, v, split)
        print(f"[prepare:{split}] n={len(records)} {stats}")
        return out


def run_prepare(cfg: Config, splits=("valid", "train", "test"), check_images: bool = True):
    os.makedirs(cfg.preprocess_dir, exist_ok=True)
    tok = BertTokenizer(vocab_file=cfg.bert_vocab, do_lower_case=False)
    mpp = MentionPositionProcessor(tok)
    proc = WDPrepare(cfg, mpp, check_images) if cfg.dataset_name == "wikidiverse" else WMPrepare(cfg, mpp)
    for split in splits:
        proc.run(split)
