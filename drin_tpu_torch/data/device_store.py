# -*- coding: utf-8 -*-
"""Device-resident entity tables (port of ``drin_tpu/data/device_store.py``).

The global WikiMEL entity tables are uploaded once to the device; a request
carries only a [B, C] row-index matrix and the store rebuilds the model's
entity features from it (:meth:`DeviceEntityStore.drin_feats_fn` for DRIN,
:meth:`DeviceEntityStore.baseline_feats_fn` for offline GHMFC).  ``include``
names the tables the model reads (:func:`include_for`): DRIN all three,
GHMFC the text table alone.  Three layouts:

  * float (bf16 or f32): the tables as they are, in the compute dtype;
  * int8 (``quantize=True``): one f32 max-abs scale per entity row (per
    (row, slot) for the pooled text table), dequantized after the gather;
  * fused (``fused_gather=True``, with ``quantize``): the included int8
    tables packed into one [N, m, 128] table with the JAX package's byte
    layout, read through the gather+dequant kernel (``ops/cuda/gather.py``).

Row indices follow the JAX package's indexing semantics in every layout:
negatives wrap once, the rest clamp (``ops.cuda.gather.sanitize_rows``).  A
fused store hands the rows to the kernel as they come (it checks them
itself) and checks them once more only for the tables it indexes in torch.

Row-sharded (``shard_rows=True`` on a mesh): every rank of a model group
holds one block of N / n_model rows (zero-padded to an even split), which is
what makes the token-level tables (``cache_entity_pooling=false``) fit.  A
gather resolves each row to its owner: every rank looks up the rows it owns
and contributes exact zeros for the rest, and one sum over the model group
rebuilds the gather bit for bit (one nonzero term per element).  DRIN's
gather, DRIN's (:meth:`DeviceEntityStore.drin_feats_fn`) and offline
GHMFC's (:meth:`DeviceEntityStore.baseline_feats_fn`, its token-level text
table included), given the caller's candidate split takes the JAX package's
``psum_scatter`` branch: the sum is a reduce-scatter over the candidate
dim, and each rank keeps its block of the candidates for its
candidate-parallel compute.  Without a split the gathered tensors come back
whole on every rank.  On a replicated store a gather with a split indexes
only this rank's block of the candidates, and a fused store hands that
block's rows to the kernel.  Whole-table reads of a row-sharded store
(:meth:`~DeviceEntityStore.float_rows`, :meth:`~DeviceEntityStore.float_table`)
are collective: every rank of the model group makes the same calls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.parallel import collectives
from drin_tpu_torch.ops.cuda.gather import (fused_gather_supported, gather_dequant,
                                            pack_quantized_tables, sanitize_rows)


class DrinRowsBatch(NamedTuple):
    """DRIN batch with the entity side replaced by table row indices."""

    mention_text_feature: np.ndarray
    mention_text_mask: np.ndarray
    mention_start_pos: np.ndarray
    mention_end_pos: np.ndarray
    mention_image_feature: np.ndarray
    mention_object_feature: np.ndarray
    mention_object_score: np.ndarray
    entity_rows: np.ndarray  # [B, C] int32
    miet_similarity: np.ndarray
    mtei_similarity: np.ndarray
    answer: np.ndarray


class BaselineRowsBatch(NamedTuple):
    """Offline baseline batch with the entity side replaced by table row
    indices."""

    mention_text_feature: np.ndarray
    mention_text_mask: np.ndarray
    mention_start_pos: np.ndarray
    mention_end_pos: np.ndarray
    mention_image_feature: np.ndarray
    entity_rows: np.ndarray  # [B, C] int32
    answer: np.ndarray


def include_for(kind: str) -> tuple:
    """The entity tables a model kind reads: DRIN all three, the baselines
    only the text table.  The one baseline over a store is offline GHMFC:
    MELHI runs on WikiDiverse alone, whose batches carry each mention's own
    candidate features, and no WikiDiverse configuration has an entity table
    to hold (``Config.entity_pooling_cached`` is WikiMEL's)."""
    return ("text", "image", "obj") if kind == "drin" else ("text",)


def quantize_entity_rows(x: np.ndarray, per_slot: bool = False):
    """Per-entity max-abs int8 quantization of an [N, ...] table: one f32
    scale per row (``per_slot``: per (row, slot), scale [N, S]).  Returns
    ``(q, scale)`` with ``q * scale ~= x``; zero rows get scale 1."""
    x = np.asarray(x)
    lead = 2 if per_slot else 1
    assert x.ndim > lead, (x.shape, per_slot)
    flat = x.reshape(x.shape[:lead] + (-1,)).astype(np.float32)
    s = np.max(np.abs(flat), axis=-1)
    s = np.where(s == 0, np.float32(1.0), s)
    q = np.clip(np.round(flat / s[..., None] * 127.0), -127, 127).astype(np.int8)
    return q.reshape(x.shape), (s / 127.0).astype(np.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, dt) -> torch.Tensor:
    """int8 rows + scale -> compute-dtype rows: multiply in f32, then cast
    (the scale multiply rounds once)."""
    s = scale.reshape(tuple(scale.shape) + (1,) * (q.ndim - scale.ndim))
    return (q.to(torch.float32) * s).to(dt)


class DeviceEntityStore:
    """Upload the ``include``d global entity tables once to ``device``;
    :meth:`drin_feats_fn` / :meth:`baseline_feats_fn` rebuild the model's
    feature tuple from a rows batch.

    ``shard_rows=True`` (with ``mesh``) keeps this rank's block of rows only
    and gathers collectively over the mesh's model group: every rank of the
    group must run the same gathers.  It composes with ``quantize``, not
    with ``fused_gather``."""

    def __init__(self, cfg: Config, tables: dict, *, device, dtype=None,
                 quantize: bool = False, fused_gather: bool = False,
                 include: tuple = ("text", "image", "obj"), shard_rows: bool = False, mesh=None):
        assert cfg.entity_pooling_cached or shard_rows, (
            "token-level (non-pooled) entity tables need the row-sharded store: shard_rows=True "
            "on a mesh with a model axis (or enable the pooled entity cache)")
        assert {"text"} <= set(include) <= {"text", "image", "obj"}, (
            f"include must keep the text table, got {include}")
        # canonical order: the fused slab's layout and _tables() are stable
        self.include = tuple(n for n in ("text", "image", "obj") if n in include)
        self.device = torch.device(device)
        self.dtype = dt = dtype or getattr(torch, cfg.compute_dtype)
        self.quantized = bool(quantize)
        self.fused = bool(fused_gather)
        self.pooled = cfg.entity_pooling_cached
        self.sharded = bool(shard_rows)
        self.n_rows = n = int(np.asarray(tables["entity_text_feature"]).shape[0])
        self.mesh = mesh
        # this rank's rows [row_lo, row_lo + block) of the table padded to
        # block * n_model rows (the whole table unsharded)
        self.row_lo, self.block = 0, n
        if self.sharded:
            assert mesh is not None and mesh.active, "shard_rows needs this rank's mesh"
            assert not self.fused, ("fused_gather reads a whole packed table: it needs a store "
                                    "that is not row-sharded")
            nm = mesh.shape["model"]
            self.block = -(-n // nm)
            self.row_lo = mesh.model_index * self.block

        def rows_of(x):
            x = np.asarray(x)
            if not self.sharded:
                return x
            part = np.asarray(x[self.row_lo:self.row_lo + self.block])
            pad = self.block - len(part)  # indices never address the padding
            return np.concatenate([part, np.zeros((pad,) + x.shape[1:], x.dtype)]) if pad else part

        def upload(x, cast=True):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if cast and t.is_floating_point():
                t = t.to(dt)
            return t.to(self.device)

        put = lambda x, cast=True: upload(rows_of(x), cast)

        keys = {"text": "entity_text_feature", "image": "entity_image_feature",
                "obj": "entity_object_feature"}
        self.packed = self.packed_scales = None
        self.text = self.image = self.obj = None
        self.text_scale = self.image_scale = self.obj_scale = None
        if self.fused:
            assert quantize, "fused_gather reads the int8 tables: it requires quantize=True"
            # per-slot scales only for the pooled text table's (projected,
            # raw-CLS) slot pair
            qs = [quantize_entity_rows(np.asarray(tables[keys[n]]), per_slot=n == "text")
                  for n in self.include]
            tails = tuple(np.asarray(tables[keys[n]]).shape[1:] for n in self.include)
            chunks = tuple((int(np.prod(t)), int(np.prod(s.shape[1:])))
                           for t, (_, s) in zip(tails, qs))
            assert fused_gather_supported(sum(w for w, _ in chunks), chunks), (
                "fused_gather needs 128-lane-aligned feature slots; got widths "
                f"{[c[0] for c in chunks]}", chunks)
            packed, psc = pack_quantized_tables([q for q, _ in qs], [s for _, s in qs])
            self._chunks, self._tails = chunks, tails
            subs = np.cumsum([0] + [w // 128 for w, _ in chunks])
            self._layout = {name: (int(subs[i]), int(subs[i + 1]), chunks[i][1], tails[i])
                            for i, name in enumerate(self.include)}
            self.packed = put(packed)
            self.packed_scales = put(psc, cast=False)
        elif quantize:
            def put_q(x, per_slot=False):
                # per-row scales: a block quantizes as the whole table does
                q, s = quantize_entity_rows(rows_of(x), per_slot=per_slot)
                return upload(q), upload(s, cast=False)  # scales stay f32

            for name in self.include:
                # per-slot scales for the pooled text table's (projected, CLS) pair
                q, sc = put_q(tables[keys[name]], per_slot=name == "text" and self.pooled)
                setattr(self, name, q)
                setattr(self, f"{name}_scale", sc)
        else:
            # text [N, 2, D] pooled or [N, Le, D], image [N, 1, Dr], obj [N, Te, 1, Dr]
            for name in self.include:
                setattr(self, name, put(tables[keys[name]]))
        self.text_mask = None if self.pooled else put(tables["entity_text_mask"])  # [N, Le]
        self.obj_score = (put(tables["entity_object_score"])  # [N, Te]
                          if "obj" in self.include else None)
        self.nbytes = sum(t.numel() * t.element_size() for t in self._tables())

    def _tables(self):
        if self.fused:
            ts = [self.packed, self.packed_scales, self.obj_score]
        elif self.quantized:
            ts = [self.text, self.text_scale, self.text_mask, self.image, self.image_scale,
                  self.obj, self.obj_scale, self.obj_score]
        else:
            ts = [self.text, self.text_mask, self.image, self.obj, self.obj_score]
        return tuple(t for t in ts if t is not None)  # excluded tables are None

    def gather(self, names, rows: torch.Tensor, split=None) -> list:
        """The tables ``names`` (attribute names: ``text``, ``text_scale``,
        ``text_mask``, ...) at ``rows`` [B, C], each [B, C, ...], or with
        ``split`` (a :class:`~drin_tpu_torch.parallel.mesh.CandidateSplit`
        that divides C) this rank's block of the candidates, [B, C / n, ...].
        Indices follow :func:`sanitize_rows`.  On a row-sharded store each
        rank looks up the rows it owns, zeros elsewhere, and one exact sum
        over the model group completes the tables: one all-reduce of them
        all, or with ``split`` a reduce-scatter over the candidate dim a
        table."""
        shape = tuple(rows.shape)
        flat = sanitize_rows(rows, self.n_rows)
        tables = [getattr(self, name) for name in names]
        if not self.sharded:
            if split is not None:
                lo, hi = split.bounds(shape[1])
                flat, shape = flat.reshape(shape)[:, lo:hi], (shape[0], hi - lo)
            return [t[flat].reshape(shape + tuple(t.shape[1:])) for t in tables]
        local = flat - self.row_lo
        mine = (local >= 0) & (local < self.block)
        local = torch.where(mine, local, torch.zeros_like(local))
        if split is None:
            parts = []
            for t in tables:
                v = t[local]  # a copy: zeroed in place
                v.masked_fill_(~mine.reshape(mine.shape + (1,) * (v.ndim - 1)), 0)
                parts.append(v.reshape(shape + tuple(t.shape[1:])))
            return collectives.sum_exact_(parts, self.mesh.model_group)
        # the caller's split must be this store's model axis
        assert (split.n, split.index) == (self.mesh.shape["model"], self.mesh.model_index), split
        # candidate-major [C, B, ...], so that the reduce-scatter's blocks
        # along dim 0 are the model ranks' blocks of the candidates; a table
        # at a time, so that one table's whole gather is alive at once.  The
        # indices are made contiguous: indexing with a transposed index
        # tensor lays the gather out transposed, and the reduce-scatter
        # would copy all of it into order
        local, mine = local.reshape(shape).t().contiguous(), mine.reshape(shape).t()
        out = []
        for t in tables:
            v = t[local]
            v.masked_fill_(~mine.reshape(mine.shape + (1,) * (v.ndim - 2)), 0)
            got, = collectives.reduce_scatter_exact_([v], split.group, split.order)
            out.append(got.transpose(0, 1).contiguous())
        return out

    def _qview(self, name: str, lo: int, hi: int):
        """Quantized ``(rows, scales)`` of ``table[lo:hi]`` in the per-table
        shapes; on a fused store these are views into the packed table."""
        assert name in self.include, f"unknown table {name!r}"
        if not self.fused:
            return getattr(self, name)[lo:hi], getattr(self, f"{name}_scale")[lo:hi]
        s0, s1, nslots, tail = self._layout[name]
        hi = min(hi, self.packed.shape[0])
        q = self.packed[lo:hi, s0:s1].reshape((hi - lo,) + tuple(tail))
        ss = self.packed_scales[lo:hi, s0:s1:(s1 - s0) // nslots]
        return q, (ss if nslots > 1 else ss[:, 0])

    def float_table(self, name: str, chunk: int = 32768):
        """Float view of ``'text'`` / ``'image'`` / ``'obj'``: a quantized
        store dequantizes in ``chunk``-row pieces into one output tensor.  A
        row-sharded store reads the ``n_rows`` rows collectively
        (:meth:`float_rows`, every rank of the model group must call it) into
        one tensor on the store's device; a consumer that needs no whole
        table on the device reads :meth:`float_rows` in pieces."""
        assert name in self.include, f"unknown table {name!r}"
        if self.sharded:
            return torch.cat([self.float_rows(name, lo, min(lo + chunk, self.n_rows))
                              for lo in range(0, self.n_rows, chunk)])
        if not self.quantized:
            return getattr(self, name)
        n = self.n_rows
        tail = self._layout[name][3] if self.fused else tuple(getattr(self, name).shape[1:])
        out = torch.empty((n,) + tuple(tail), dtype=self.dtype, device=self.device)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            out[lo:hi] = _dequantize(*self._qview(name, lo, hi), self.dtype)
        return out

    def float_rows(self, name: str, lo: int, hi: int, slot=None):
        """Dequantized ``table[lo:hi]`` (optionally one second-axis slot) of
        ``'text'``, ``'image'``, ``'obj'`` or ``'obj_score'``, rows past
        ``n_rows`` left out.  On a row-sharded store every rank of the model
        group must make the same call: each contributes its overlap, and one
        exact sum over the group gives every rank the rows, on the store's
        device."""
        assert name in self.include or (name == "obj_score" and self.obj_score is not None), (
            f"unknown table {name!r}")
        hi = min(hi, self.n_rows)
        if self.sharded:
            return self._sharded_rows(name, lo, hi, slot)
        if name == "obj_score" or not self.quantized:
            q = getattr(self, name)
            return q[lo:hi] if slot is None else q[lo:hi, slot]
        qs, ss = self._qview(name, lo, hi)
        if slot is not None:
            qs = qs[:, slot]
            if ss.ndim > 1:
                ss = ss[:, slot]
        return _dequantize(qs, ss, self.dtype)

    def _sharded_rows(self, name: str, lo: int, hi: int, slot=None) -> torch.Tensor:
        """``float_rows`` of a row-sharded store: this rank's overlap of
        [lo, hi), zeros elsewhere, summed over the model group."""
        table = getattr(self, name)
        a, b = max(lo, self.row_lo), min(hi, self.row_lo + self.block)
        own = table[max(a - self.row_lo, 0):max(b - self.row_lo, 0)]
        if self.quantized and name != "obj_score":
            scale = getattr(self, f"{name}_scale")[max(a - self.row_lo, 0):max(b - self.row_lo, 0)]
            own = _dequantize(own, scale, self.dtype)
        own = own if slot is None else own[:, slot]
        piece = torch.zeros((hi - lo,) + tuple(own.shape[1:]), dtype=self.dtype, device=self.device)
        if a < b:
            piece[a - lo:b - lo] = own
        return collectives.sum_exact_([piece], self.mesh.model_group)[0]

    def drin_feats_fn(self):
        """``feats_fn(feats, split=None) -> feature tuple``: rows-batch
        features (the :class:`DrinRowsBatch` fields minus the answer, as
        tensors on the store's device) -> the 14-tensor DRIN batch.  With
        ``split`` (the caller's :class:`~drin_tpu_torch.parallel.mesh.CandidateSplit`,
        which the batch's C divides) the entity tensors and the two
        similarities are this rank's block of the candidates, for DRIN's
        candidate-parallel forward with the same split."""
        assert {"image", "obj"} <= set(self.include), (
            "DRIN reads the entity image and object tables; this store was built "
            f"with include={self.include} (a baseline layout)")
        dt, n = self.dtype, self.n_rows

        def etm_for(rows):
            return torch.zeros((rows.shape[0],), dtype=torch.int64, device=rows.device)

        if self.fused:
            chunks, tails = self._chunks, self._tails

            def feats_fn(feats, split=None):
                (mtf, mtm, sp, ep, mif, mof, mos, rows, miet, mtei) = feats
                if split is not None:  # this rank's block of the candidates
                    lo, hi = split.bounds(rows.shape[1])
                    rows, miet, mtei = rows[:, lo:hi].contiguous(), miet[:, lo:hi], mtei[:, lo:hi]
                # the kernel checks the raw rows; obj_score is indexed in torch
                tf, imf, of = gather_dequant(self.packed, self.packed_scales, rows, chunks, dt)
                shape = tuple(rows.shape)
                eos = self.obj_score[sanitize_rows(rows, n)].reshape(
                    shape + tuple(self.obj_score.shape[1:]))
                return (mtf, mtm, sp, ep, mif, mof, mos, tf.reshape(shape + tails[0]),
                        etm_for(rows), imf.reshape(shape + tails[1]),
                        of.reshape(shape + tails[2]), eos, miet, mtei)

            return feats_fn

        names = self._names(("text", "image", "obj")) + ["obj_score"]

        def feats_fn(feats, split=None):
            (mtf, mtm, sp, ep, mif, mof, mos, rows, miet, mtei) = feats
            if split is not None:
                lo, hi = split.bounds(rows.shape[1])
                miet, mtei = miet[:, lo:hi], mtei[:, lo:hi]
            got = dict(zip(names, self.gather(names, rows, split)))
            etm = got["text_mask"] if "text_mask" in got else etm_for(rows)
            return (mtf, mtm, sp, ep, mif, mof, mos, self._deq(got, "text"), etm,
                    self._deq(got, "image"), self._deq(got, "obj"), got["obj_score"], miet, mtei)

        return feats_fn

    def _names(self, tables) -> list:
        """The attributes a gather of ``tables`` reads: each table, its
        scales when quantized, and the text mask of a token-level store."""
        out = []
        for name in tables:
            out.append(name)
            if self.quantized:
                out.append(f"{name}_scale")
            if name == "text" and not self.pooled:
                out.append("text_mask")
        return out

    def _deq(self, got: dict, name: str) -> torch.Tensor:
        if not self.quantized:
            return got[name]
        return _dequantize(got[name], got[f"{name}_scale"], self.dtype)

    def baseline_feats_fn(self):
        """``feats_fn(feats, split=None) -> feature tuple``: rows-batch
        features (the :class:`BaselineRowsBatch` fields minus the answer, as
        tensors on the store's device) -> the 8-tensor offline baseline
        batch.  GHMFC's entity tower reads the text table alone, so a
        text-only store fills the entity-image slot with a [B, C, 1] zero
        placeholder; a fused store reads its rows through the gather+dequant
        kernel.  With ``split`` (the caller's
        :class:`~drin_tpu_torch.parallel.mesh.CandidateSplit`, which the
        batch's C divides) the entity tensors are this rank's block of the
        candidates, for GHMFC's candidate-parallel forward with the same
        split."""
        dt = self.dtype
        has_img = "image" in self.include

        def block(rows, split):
            if split is None:
                return rows
            lo, hi = split.bounds(rows.shape[1])
            return rows[:, lo:hi].contiguous()

        def finish(feats, rows, etf, eif, etm=None):
            mtf, mtm, sp, ep, mif = feats[:5]
            B, C = rows.shape  # the block's C under a split
            if eif is None:  # the model never reads this slot
                eif = torch.zeros((B, C, 1), dtype=dt, device=rows.device)
            elif eif.ndim == 4:  # [B, C, 1, Dr] pooler rows -> [B, C, Dr]
                eif = eif.reshape(B, C, -1)
            if etm is None:  # the pooled cache consumed the mask
                etm = torch.zeros((B,), dtype=torch.int64, device=rows.device)
            return (mtf, mtm, sp, ep, mif, etf, etm, eif)

        if self.fused:
            assert self.include in (("text",), ("text", "image")), (
                "a fused baseline store packs the text (and image) tables only: "
                f"an object chunk would be read and thrown away per row (include="
                f"{self.include})")
            chunks, tails = self._chunks, self._tails

            def feats_fn(feats, split=None):
                rows = block(feats[5], split)
                got = gather_dequant(self.packed, self.packed_scales, rows, chunks, dt)
                shape = tuple(rows.shape)
                return finish(feats, rows, got[0].reshape(shape + tails[0]),
                              got[1].reshape(shape + tails[1]) if has_img else None)

            return feats_fn

        names = self._names(("text", "image") if has_img else ("text",))

        def feats_fn(feats, split=None):
            rows = feats[5]
            got = dict(zip(names, self.gather(names, rows, split)))
            return finish(feats, block(rows, split), self._deq(got, "text"),
                          self._deq(got, "image") if has_img else None, got.get("text_mask"))

        return feats_fn


def project_drin_tables(cfg: Config, tables: dict, state_dict, *, device,
                        chunk: int = 16384) -> dict:
    """Serving cache: push the trained DRIN entity-side linears into the
    frozen tables once (``cfg.entity_projected`` consumes the result).
    Exact math, ``linear(gather(T)) == gather(linear(T))``.  Slot 0 of the
    text table gets the projected pooled text, slot 1 keeps the raw CLS (the
    mtet edge reads it).  Projects in float32 on ``device``."""
    assert cfg.entity_pooling_cached, "projection builds on the pooled cache layout"
    assert cfg.entity_final_output_dim == cfg.bert_embed_dim, (
        "projected slot 0 and raw-CLS slot 1 must share a table dim")
    f32 = torch.float32
    g = lambda k: torch.as_tensor(state_dict[k]).to(device=device, dtype=f32)
    tw = g("vertex_encoder.entity_text_encoder.final_layer.weight")
    tb = g("vertex_encoder.entity_text_encoder.final_layer.bias")
    iw = g("vertex_encoder.entity_image_linear.weight")
    ib = g("vertex_encoder.entity_image_linear.bias")
    text = tables["entity_text_feature"]  # [N, 2, D] (pooled, CLS)
    img = tables["entity_image_feature"]  # [N, 1, Dr] or [N, Dr]
    slot = 1 if cfg.entity_final_pooling == "bert default" else 0
    N = text.shape[0]
    t_out = np.empty((N, 2, cfg.bert_embed_dim), np.float32)
    i_out = np.empty((N, cfg.gcn_embed_dim), np.float32)
    with torch.inference_mode():
        for lo in range(0, N, chunk):
            t = torch.as_tensor(np.asarray(text[lo:lo + chunk]), dtype=f32, device=device)
            i = torch.as_tensor(np.asarray(img[lo:lo + chunk]), dtype=f32, device=device)
            if i.ndim == 3:
                i = i.mean(-2)
            t_out[lo:lo + chunk, 0] = (t[:, slot] @ tw.T + tb).cpu().numpy()
            t_out[lo:lo + chunk, 1] = np.asarray(text[lo:lo + chunk, 1])
            i_out[lo:lo + chunk] = (i @ iw.T + ib).cpu().numpy()
    new = dict(tables)
    new["entity_text_feature"] = t_out
    new["entity_image_feature"] = i_out
    return new
