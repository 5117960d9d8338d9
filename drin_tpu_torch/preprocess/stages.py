# -*- coding: utf-8 -*-
"""Stages 2-4: frozen-encoder feature extraction over real batches (port of
``drin_tpu/preprocess/stages.py``).

Each stage holds its encoder in float32 on one explicit ``device``, runs it
in full float32 whatever the caller's TF32 settings (:func:`full_float32`),
and writes the feature store the datasets read, under the JAX package's file
names, shapes and dtypes:

  * :class:`BertStage`: ``mention-text-feature/-mask_{split}``; WikiDiverse
    ``entity-{attr,name,brief}-feature_{split}``; WikiMEL the global
    ``entity-{tt}-feature.npy`` + ``entity-{tt}-mask.npy`` + ``qid2idx.json``.
    Chunks of ``preprocess_batch_size`` texts, padded to a bucket of
    ``_round_up(L, 128)`` capped at ``max_bert_len``; self-attention takes
    kernel 3 (``ops/cuda/attention.py``) on the card from a bucket of 256 on.
  * :class:`ResnetStage`: ``{mention,entity}-image-feature_*`` (49 regions in
    the NHWC map's order, or the pooled vector) and
    ``*-object-{feature,score}_*`` from a detector (the Faster R-CNN of
    ``detector_checkpoint`` on the stage's device, NMS through its kernel
    on the card) or, with ``import_objects_from``, copied byte for byte
    from another store.
  * :class:`ClipStage`: ``similarity-{miet,eimt}_*``, each unique image and
    text embedded once; a file already there is kept (resumable).

Given ``devices`` (several), a stage spreads every host batch over a
replica of its encoder on each (:class:`RowShardedDispatch`, the
counterpart of the JAX package's ``RowShardedJit``): each device takes
``preprocess_batch_size`` rows of a dispatch.  On CUDA nothing falls
back: a kernel that does not build or launch raises, and no encoder is moved
to the CPU.  Each stage keeps host and encoder seconds in ``clock`` and
prints them at the end of ``run``."""

from __future__ import annotations

import copy
import json
import os
import shutil
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.common.npy_io import NpyWriter, load_field
from drin_tpu_torch.preprocess.images import ImageBatcher, clip_preprocess, resnet_preprocess


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def stage_device(device) -> torch.device:
    """``device`` as a torch device; CUDA asked for without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda was asked for and CUDA is not available "
                           "(pass device=cpu to preprocess on the CPU)")
    return device


def _canonical(device) -> torch.device:
    device = stage_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class RowShardedDispatch:
    """Data-parallel dispatch of a stage's frozen encoder over ``devices`` in
    one process: a replica of the encoder on each distinct device (a device
    named twice takes two shares of rows on one replica), a host batch split
    over the devices in order, a tail that does not divide padded with
    repeats of row 0, and the results concatenated on the host in order and
    cut back.  The ``.npy`` writer sees the rows the one-device stage
    writes."""

    def __init__(self, model: torch.nn.Module, devices: Sequence):
        self.devices = [_canonical(d) for d in devices]
        self.n = len(self.devices)
        home = next(model.parameters()).device
        self.replicas = {}
        for d in self.devices:
            if d not in self.replicas:
                self.replicas[d] = model if d == home else copy.deepcopy(model).to(d)

    def __call__(self, fn: Callable, *arrays: np.ndarray) -> tuple:
        """``fn(model, *tensors) -> tuple of tensors``, every one with the
        batch as its leading dim, over ``arrays`` split row-wise; returns the
        outputs as numpy arrays of all the rows."""
        n = arrays[0].shape[0]
        pad = -n % self.n
        if pad:
            arrays = tuple(np.concatenate([a, np.repeat(a[:1], pad, 0)]) for a in arrays)
        per = (n + pad) // self.n
        parts = []
        for i, d in enumerate(self.devices):
            ins = (torch.from_numpy(np.ascontiguousarray(a[i * per:(i + 1) * per])).to(d)
                   for a in arrays)
            parts.append(fn(self.replicas[d], *ins))
        return tuple(torch.cat([p[j].cpu() for p in parts])[:n].numpy()
                     for j in range(len(parts[0])))


def dispatch_for(model: torch.nn.Module, devices: Optional[Sequence]):
    """A :class:`RowShardedDispatch` over ``devices``, or None for one
    device (or none given)."""
    return RowShardedDispatch(model, devices) if devices is not None and len(devices) > 1 else None


def rows_per_dispatch(cfg: Config, dp) -> int:
    """Host batch rows per encoder dispatch: the per-device batch size times
    the number of devices when data-parallel."""
    return cfg.preprocess_batch_size * (dp.n if dp else 1)


def _encode(stage, fn: Callable, *arrays: np.ndarray) -> tuple:
    """``fn`` over ``arrays`` on the stage's device, or through its dispatch;
    numpy outputs."""
    if stage.dp is not None:
        return stage.dp(fn, *arrays)
    ins = (torch.from_numpy(np.ascontiguousarray(a)).to(stage.device) for a in arrays)
    return tuple(o.cpu().numpy() for o in fn(stage.model, *ins))


@contextmanager
def full_float32():
    """The encoders' convolutions and products in full float32 whatever the
    caller set: cuDNN takes a float32 convolution in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), about three decimal
    digits, where the JAX stages and the store's checks want float32.  Both
    TF32 flags read False inside; the caller's values are back after it.
    On the CPU neither flag is read."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _frozen(model: torch.nn.Module, state_dict, device) -> torch.nn.Module:
    """``model`` (built on the meta device) with ``state_dict``'s tensors, in
    float32 on ``device``, in eval mode."""
    model.load_state_dict(state_dict, assign=True)
    return model.to(device=device, dtype=torch.float32).eval()


class _Clock:
    """Seconds by kind (``wall``: the stage's ``run``; ``host``: the encoder
    chunks' tokenization or image decode; ``encoder``: the encoder's
    dispatch up to the features on the host; ``detector``: the ResNet
    stage's detector calls, up to its boxes on the host), with the number of
    chunks and items that ``host`` and ``encoder`` covered and the images
    the detector saw.  The rest of ``wall`` is the detector's own decode,
    the writes and the bookkeeping."""

    def __init__(self):
        self.seconds = {"wall": 0.0, "host": 0.0, "encoder": 0.0, "detector": 0.0}
        self.chunks = self.items = self.detected = 0

    @contextmanager
    def timed(self, kind: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[kind] += time.perf_counter() - t

    def summary(self, name: str, unit: str) -> str:
        h, e = self.seconds["host"], self.seconds["encoder"]
        rate = self.items / (h + e) if h + e else 0.0
        per_chunk = 1e3 * h / self.chunks if self.chunks else 0.0
        det = (f", detector {self.seconds['detector']:.2f} s over {self.detected} images"
               if self.detected else "")
        return (f"[{name}] {self.items} {unit} in {self.chunks} chunks, {self.seconds['wall']:.2f} "
                f"s: host {h:.2f} s ({per_chunk:.2f} ms per chunk), encoder {e:.2f} s, "
                f"{rate:.1f} {unit}/s{det}")


# ---------------------------------------------------------------------------
# BERT stage


class BertStage:
    def __init__(self, cfg: Config, state_dict=None, bert_cfg=None, device="cuda",
                 devices: Optional[Sequence] = None):
        from drin_tpu_torch.encoders.bert import BertModel
        from drin_tpu_torch.text.wordpiece import BertTokenizer

        self.cfg = cfg
        self.device = stage_device(device)
        if state_dict is None:
            from drin_tpu_torch.encoders.checkpoints import load_bert

            bert_cfg, state_dict = load_bert(cfg.bert_checkpoint, bert_cfg)
        self.bert_cfg = bert_cfg
        with torch.device("meta"):
            model = BertModel(bert_cfg, fused_attention=cfg.bert_fused_attention)
        self.model = _frozen(model, state_dict, self.device)
        self.dp = dispatch_for(self.model, devices)
        self.tokenizer = BertTokenizer(vocab_file=cfg.bert_vocab, do_lower_case=False,
                                       model_max_length=cfg.max_bert_len)
        self.clock = _Clock()

    def bucket(self, ids: np.ndarray, mask: np.ndarray):
        """A chunk's padded ids and mask brought to its bucket: the padded
        length rounded up to 128 and capped at ``max_bert_len``."""
        L = min(_round_up(ids.shape[1], 128), self.cfg.max_bert_len)
        if ids.shape[1] < L:
            pad = L - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=self.tokenizer.pad_id)
            mask = np.pad(mask, ((0, 0), (0, pad)))
        return ids[:, :L], mask[:, :L]

    def _encode_chunks(self, texts: Sequence[str], output: str, max_len: int):
        """Yield per-dispatch (features, mask-or-None) numpy chunks."""
        cfg = self.cfg
        B_ = rows_per_dispatch(cfg, self.dp)

        def encoder(model, ids, mask):
            h, pooled = model(ids, mask)
            return (pooled if output == "pooler_output" else h[:, :max_len]),

        for i in range(0, len(texts), B_):
            with self.clock.timed("host"):
                chunk = [str(t) for t in texts[i : i + B_]]
                enc = self.tokenizer(chunk, padding=True, truncation=True,
                                     max_length=cfg.max_bert_len)
                ids, mask = self.bucket(enc["input_ids"], enc["attention_mask"])
            with self.clock.timed("encoder"), torch.inference_mode(), full_float32():
                (h,) = _encode(self, encoder, ids, mask)
            self.clock.chunks += 1
            self.clock.items += len(chunk)
            if output == "pooler_output":
                yield h, None
            else:
                m = mask[:, :max_len]
                if h.shape[1] < max_len:  # short bucket: pad stored features
                    h = np.pad(h, ((0, 0), (0, max_len - h.shape[1]), (0, 0)))
                    m = np.pad(m, ((0, 0), (0, max_len - m.shape[1])))
                yield h, m

    def encode_texts_npy(self, texts: Sequence[str], output: str, max_len: int,
                         feat_path: str, mask_path: Optional[str] = None) -> None:
        """Batched inference over raw texts streamed to ``.npy`` through
        :class:`NpyWriter`, one chunk at a time: the WikiMEL global entity
        pass is ~109k x 64 tokens x 768 f32, >20 GB, which must never sit in
        host RAM.  ``last_hidden_state`` stores features truncated (or
        padded) to ``max_len`` tokens and their mask at ``mask_path``;
        ``pooler_output`` stores [N, D]."""
        with NpyWriter(feat_path) as fw:
            mw = NpyWriter(mask_path) if mask_path is not None else None
            try:
                for h, m in self._encode_chunks(texts, output, max_len):
                    fw.extend(h)
                    if mw is not None:
                        if m is None:
                            raise ValueError("mask_path needs last_hidden_state output")
                        mw.extend(m)
            finally:
                if mw is not None:
                    mw.close()

    def run(self, splits=("train", "valid", "test")):
        with self.clock.timed("wall"):
            self._run(splits)
        print(self.clock.summary("bert", "texts"), flush=True)

    def _run(self, splits):
        cfg = self.cfg
        d = cfg.preprocess_dir
        if cfg.entity_text_type not in ("attr", "name", "brief"):
            raise ValueError(
                f"entity_text_type={cfg.entity_text_type!r} has no raw text "
                "source in the prepared store; use 'attr', 'name' or 'brief'")
        if cfg.entity_text_type == "brief" and cfg.dataset_name != "wikidiverse":
            # the wikimel store has name/attr sources only (qid2entity /
            # qid2attr joins): refuse instead of encoding name-recipe text
            # under the entity-brief-feature name
            raise ValueError(
                "entity_text_type='brief' needs the wikidiverse store (its "
                "prepare stage joins entity2brief); wikimel has 'attr'/'name'")
        for split in splits:
            texts = load_field(d, "mention_text_raw", split)
            self.encode_texts_npy(
                texts, "last_hidden_state", cfg.max_mention_sentence_len,
                os.path.join(d, f"mention-text-feature_{split}.npy"),
                os.path.join(d, f"mention-text-mask_{split}.npy"))
            if cfg.dataset_name == "wikidiverse":
                # 'brief' encodes the same strings prepare materialized (the
                # wikidiverse entity text IS the brief join) under the
                # entity-brief-feature name the loader expects
                tt = cfg.entity_text_type
                raw_field = "entity_name_raw" if tt == "name" else "entity_attr_raw"
                texts = load_field(d, raw_field, split)
                self.encode_texts_npy(
                    texts, "pooler_output", cfg.max_entity_attr_token_len,
                    os.path.join(d, f"entity-{tt}-feature_{split}.npy"))
        if cfg.dataset_name == "wikimel":
            tt = cfg.entity_text_type
            texts, qid2idx = wikimel_entity_texts(cfg)
            with open(os.path.join(d, "qid2idx.json"), "w") as f:
                json.dump(qid2idx, f)
            self.encode_texts_npy(
                texts, "last_hidden_state", cfg.max_entity_attr_token_len,
                os.path.join(d, f"entity-{tt}-feature.npy"),
                os.path.join(d, f"entity-{tt}-mask.npy"))


def wikimel_entity_texts(cfg: Config):
    """WikiMEL's global entity table in ``qid2attr``'s order: the texts
    ``entity_text_type`` names ("name", or "name. attrs" with the attrs'
    periods turned to ";") and ``{qid: row}``."""
    with open(cfg.qid2entity_path) as f:
        qid2name = json.load(f)
    with open(cfg.qid2attr_path) as f:
        qid2attr = json.load(f)
    items = list(qid2attr.items())
    if cfg.entity_text_type == "name":
        texts = [qid2name[qid] for qid, _ in items]
    else:
        texts = [qid2name[qid] + ". " + str(attr).replace(".", ";") for qid, attr in items]
    return texts, {qid: i for i, (qid, _) in enumerate(items)}


# ---------------------------------------------------------------------------
# ResNet stage


class ResnetStage:
    def __init__(self, cfg: Config, state_dict=None, resnet_cfg=None,
                 detector: Optional[Callable] = None, device="cuda",
                 devices: Optional[Sequence] = None):
        from drin_tpu_torch.encoders.resnet import ResNetModel

        self.cfg = cfg
        self.device = stage_device(device)
        if state_dict is None:
            from drin_tpu_torch.encoders.checkpoints import load_resnet

            resnet_cfg, state_dict = load_resnet(cfg.resnet_checkpoint, resnet_cfg)
        self.resnet_cfg = resnet_cfg
        with torch.device("meta"):
            model = ResNetModel(resnet_cfg)
        self.model = _frozen(model, state_dict, self.device)
        self.dp = dispatch_for(self.model, devices)
        self.batcher = ImageBatcher(cfg.default_image, cfg.min_image_size, cfg.image_decode_workers)
        # the detector (on the stage's device) is never built when the object arrays are imported: that
        # path must not warn about a stub detector it will never run
        if detector is None and not cfg.import_objects_from:
            from drin_tpu_torch.preprocess.detector import make_detector

            detector = make_detector(cfg, device=self.device)
        self.detector = detector
        self.clock = _Clock()

    def _run_images(self, paths, crops, output: str, writer: NpyWriter):
        cfg = self.cfg
        B_ = rows_per_dispatch(cfg, self.dp)

        def encoder(model, x):
            h, pooled = model(x.permute(0, 3, 1, 2))  # NHWC on the host, NCHW here
            # [B, 1, C], or [B, R, C] with the regions row-major over (h, w)
            return (pooled[:, None, :] if output == "pooler_output" else h.contiguous()),

        for i in range(0, len(paths), B_):
            chunk = paths[i : i + B_]
            c = crops[i : i + B_] if crops is not None else None
            with self.clock.timed("host"):
                x = self.batcher.load_batch_chunked(
                    chunk,
                    lambda im: resnet_preprocess(im, cfg.image_input_size,
                                                 cfg.resnet_crop_pct, cfg.resnet_resample),
                    c, chunk=cfg.preprocess_batch_size)
            with self.clock.timed("encoder"), torch.inference_mode(), full_float32():
                (out,) = _encode(self, encoder, x)
            self.clock.chunks += 1
            self.clock.items += len(chunk)
            writer.extend(out)

    def infer(self, split: str, name: str, feature_output: str, object_output: str,
              image_paths: Sequence[str]):
        """Whole-image features, then detector boxes/scores, then per-box
        crop features."""
        cfg = self.cfg
        d = cfg.preprocess_dir
        topk = cfg.object_topk[name]
        with NpyWriter(os.path.join(d, f"{name}-image-feature_{split}.npy")) as w:
            self._run_images(image_paths, None, feature_output, w)

        if cfg.import_objects_from:
            self._import_objects(split, name, topk, len(image_paths))
            return
        boxes, scores = self.detect(image_paths, topk)
        np.save(os.path.join(d, f"{name}-object-score_{split}.npy"), scores)
        flat_paths = np.repeat(np.asarray(image_paths), topk)
        flat_boxes = boxes.reshape(-1, 4)
        # close on error too: an abandoned writer leaks its handle and leaves
        # a placeholder header that np.load rejects (the stage rewrites its
        # outputs on a re-run, so a closed partial file is harmless)
        w = NpyWriter(os.path.join(d, f"{name}-object-feature_{split}.npy"))
        try:
            self._run_images(flat_paths, flat_boxes, object_output, w)
            w.reshape([-1, topk, *w.shape])
        finally:
            w.close()

    def _import_objects(self, split: str, name: str, topk: int, n: int):
        """Adopt ``{name}-object-{feature,score}_{split}.npy`` VERBATIM from
        ``cfg.import_objects_from`` instead of running a detector: a store
        preprocessed with a pretrained Faster R-CNN migrates with zero
        object-feature drift.  Shapes are validated against this run's
        config before the byte-for-byte file copy."""
        cfg = self.cfg
        src_dir = cfg.import_objects_from
        for field in ("feature", "score"):
            fname = f"{name}-object-{field}_{split}.npy"
            src = os.path.join(src_dir, fname)
            if not os.path.exists(src):
                raise FileNotFoundError(
                    f"import_objects_from={src_dir!r} has no {fname} — point "
                    "it at a store whose detector stage already produced the "
                    "object arrays for this dataset/split")
            arr = np.load(src, mmap_mode="r")
            if arr.shape[0] != n:
                raise ValueError(
                    f"{src}: {arr.shape[0]} rows, but this split has {n} "
                    f"{name} images — the imported store was built from "
                    "different raw data (or a different candidate count)")
            if field == "score" and tuple(arr.shape[1:]) != (topk,):
                raise ValueError(
                    f"{src}: per-image shape {tuple(arr.shape[1:])}, expected "
                    f"({topk},) — check {name}_object_topk against the store")
            if field == "feature" and (
                    arr.ndim < 3 or arr.shape[1] != topk
                    or arr.shape[-1] != cfg.resnet_embed_dim):
                raise ValueError(
                    f"{src}: per-image shape {tuple(arr.shape[1:])}, expected "
                    f"({topk}, ..., {cfg.resnet_embed_dim}) — check "
                    f"{name}_object_topk / resnet_embed_dim against the store")
            shutil.copyfile(src, os.path.join(cfg.preprocess_dir, fname))

    def detect(self, image_paths: Sequence[str], topk: int):
        """Top-k boxes/scores padded with default_box/0.  The detector
        receives resized [0, 1] images, not ImageNet-normalized ones, and runs
        in full float32 like the encoders (its convolutions would otherwise
        take cuDNN's TF32 under PyTorch's default flags)."""
        cfg = self.cfg
        B_ = cfg.preprocess_batch_size

        def raw01(im):
            im = im.resize(cfg.image_input_size)
            return np.asarray(im, dtype=np.float32) / 255.0

        all_boxes, all_scores = [], []
        for i in range(0, len(image_paths), B_):
            x = self.batcher.load_batch(image_paths[i : i + B_], raw01)
            with self.clock.timed("detector"), full_float32():
                b, s = self.detector(x, topk)
            self.clock.detected += len(x)
            all_boxes.append(np.asarray(b))
            all_scores.append(np.asarray(s))
        return np.concatenate(all_boxes, 0), np.concatenate(all_scores, 0)

    def run(self, splits=("valid", "train", "test")):
        with self.clock.timed("wall"):
            self._run(splits)
        print(self.clock.summary("resnet", "images"), flush=True)

    def _run(self, splits):
        cfg = self.cfg
        d = cfg.preprocess_dir
        for split in splits:
            if cfg.dataset_name == "wikidiverse":
                paths = load_field(d, "entity_image_path", split)
                self.infer(split, "entity", "pooler_output", "pooler_output", paths)
                paths = load_field(d, "mention_image_path", split)
            else:
                paths = wikimel_mention_images(cfg, split)
            self.infer(split, "mention", "last_hidden_state", "pooler_output", paths)
        if cfg.dataset_name == "wikimel":
            with open(cfg.qid2entity_path) as f:
                qid2name = json.load(f)
            paths = [os.path.join(cfg.entity_image_dir, k) for k in qid2name]
            self.infer("all", "entity", "pooler_output", "pooler_output", paths)


def wikimel_mention_images(cfg: Config, split: str):
    """WikiMEL's mention image paths of ``split``, by mention id, for the
    mentions the prepare stage keeps (the surface occurs in its sentence)."""
    with open(cfg.mention_text_path % split) as f:
        mention_text = json.load(f)
    return [os.path.join(cfg.mention_image_dir, k.split("-")[0])
            for k, v in mention_text.items() if v["mentions"] in v["sentence"]]


# ---------------------------------------------------------------------------
# CLIP stage


def _each_once(embed, items: np.ndarray) -> np.ndarray:
    """``embed(items)`` computed over the distinct items only and spread back.
    An entity is a candidate of many mentions (~100 slots per WikiMEL
    mention over ~109k entities), so this cuts the entity texts and images
    that are tokenized, decoded and encoded several-fold; the JAX stage
    embeds every slot.  Each row is the same function of its item either
    way: only the batches' composition differs."""
    unique, inverse = np.unique(items, return_inverse=True)
    return embed(unique)[inverse.reshape(-1)]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


class ClipStage:
    def __init__(self, cfg: Config, state_dict=None, clip_cfg=None, tokenizer=None,
                 device="cuda", devices: Optional[Sequence] = None):
        """``tokenizer`` defaults to the ``CLIPTokenizer`` of
        ``cfg.clip_vocab`` / ``cfg.clip_merges``."""
        from drin_tpu_torch.encoders.clip import CLIPModel

        self.cfg = cfg
        self.device = stage_device(device)
        if state_dict is None:
            from drin_tpu_torch.encoders.checkpoints import load_clip

            clip_cfg, state_dict = load_clip(cfg.clip_checkpoint, clip_cfg)
        self.clip_cfg = clip_cfg
        with torch.device("meta"):
            model = CLIPModel(clip_cfg)
        self.model = _frozen(model, state_dict, self.device)
        self.dp = dispatch_for(self.model, devices)
        if tokenizer is None:
            from drin_tpu_torch.text.clip_bpe import CLIPTokenizer

            tokenizer = CLIPTokenizer(vocab_file=cfg.clip_vocab, merges_file=cfg.clip_merges)
        self.tokenizer = tokenizer
        self.batcher = ImageBatcher(cfg.default_image, cfg.min_image_size, cfg.image_decode_workers)
        self.clock = _Clock()

    def text_ids(self, texts: Sequence[str]) -> np.ndarray:
        """Token ids [N, 77]: padded to the length cap with the end token,
        over-length texts truncated keeping it ([bos] + tokens[:75] + [eos]),
        so that the argmax pooling reads a real end of text (the reference
        cuts at 77 after tokenizing and loses it)."""
        cap = self.clip_cfg.text.max_position_embeddings
        return self.tokenizer([str(t) for t in texts], padding="max_length",
                              truncation=True, max_length=min(77, cap))["input_ids"]

    def _embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        B_ = rows_per_dispatch(self.cfg, self.dp)
        out = []
        for i in range(0, len(texts), B_):
            with self.clock.timed("host"):
                ids = self.text_ids(texts[i : i + B_])
            with self.clock.timed("encoder"), torch.inference_mode(), full_float32():
                out += _encode(self, lambda m, ids: (_unit(m.get_text_features(ids)),), ids)
            self.clock.chunks += 1
            self.clock.items += len(ids)
        return np.concatenate(out, 0)

    def _embed_images(self, paths: Sequence[str]) -> np.ndarray:
        B_ = rows_per_dispatch(self.cfg, self.dp)
        size = self.clip_cfg.vision.image_size
        out = []
        embed = lambda m, x: (_unit(m.get_image_features(x.permute(0, 3, 1, 2))),)
        for i in range(0, len(paths), B_):
            with self.clock.timed("host"):
                x = self.batcher.load_batch_chunked(paths[i : i + B_],
                                                    lambda im: clip_preprocess(im, size),
                                                    chunk=self.cfg.preprocess_batch_size)
            with self.clock.timed("encoder"), torch.inference_mode(), full_float32():
                out += _encode(self, embed, x)
            self.clock.chunks += 1
            self.clock.items += len(x)
        return np.concatenate(out, 0)

    def _wikimel_sources(self, split: str):
        """WikiMEL: mention images by mention id, entity texts and images by
        qid."""
        cfg = self.cfg
        d = cfg.preprocess_dir
        C_ = cfg.num_candidates_model
        mention_images = wikimel_mention_images(cfg, split)
        qids = load_field(d, "entity_name_raw", split).reshape(-1, C_)
        with open(cfg.qid2entity_path) as f:
            qid2name = json.load(f)
        with open(cfg.qid2attr_path) as f:
            qid2attr = json.load(f)
        entity_texts = np.vectorize(
            lambda q: qid2name[q] + ". " + str(qid2attr[q]).replace(".", ";")
        )(qids)
        entity_images = np.vectorize(lambda q: os.path.join(cfg.entity_image_dir, q))(qids)
        return np.asarray(mention_images), entity_texts, entity_images

    def logit_scale(self) -> float:
        """exp(logit_scale), taken in float32 on the host as the JAX stage
        takes it."""
        return float(np.exp(self.model.logit_scale.detach().cpu().numpy()))

    def run(self, splits=("valid", "train", "test")):
        """Cross-modal similarity matrices [N, C]: the logits are one einsum
        row-wise, and each distinct entity text or image path of a split is
        embedded once (:func:`_each_once`)."""
        with self.clock.timed("wall"):
            self._run(splits)
        print(self.clock.summary("clip", "texts and images"), flush=True)

    def _run(self, splits):
        cfg = self.cfg
        d = cfg.preprocess_dir
        C_ = cfg.num_candidates_model
        scale = self.logit_scale()
        for split in splits:
            if cfg.dataset_name == "wikimel":
                mention_images, entity_texts, entity_images = self._wikimel_sources(split)
            else:
                mention_images = load_field(d, "mention_image_path", split)
                entity_texts = load_field(d, "entity_attr_raw", split).reshape(-1, C_)
                entity_images = load_field(d, "entity_image_path", split).reshape(-1, C_)
            target = os.path.join(d, f"similarity-miet_{split}.npy")
            if not os.path.exists(target):  # resumable, like the reference
                v = self._embed_images(mention_images)  # [N, P]
                t = _each_once(self._embed_texts, entity_texts.reshape(-1))  # [N*C, P]
                t = t.reshape(len(v), C_, -1)
                sims = scale * np.einsum("np,ncp->nc", v, t)
                np.save(target, sims.astype(np.float32))
            target = os.path.join(d, f"similarity-eimt_{split}.npy")
            if not os.path.exists(target):
                mention_texts = load_field(d, "mention_text_raw", split)
                t = self._embed_texts(mention_texts)  # [N, P]
                v = _each_once(self._embed_images, entity_images.reshape(-1))
                v = v.reshape(len(t), C_, -1)
                sims = scale * np.einsum("np,ncp->nc", t, v)
                np.save(target, sims.astype(np.float32))
