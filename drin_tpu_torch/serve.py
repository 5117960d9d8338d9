# -*- coding: utf-8 -*-
"""Serving (port of ``drin_tpu/serve.py``).

  * :class:`Ranker` scores a request and returns top-k, for every model
    family: DRIN and offline GHMFC (a rows batch, mention features + [B, C]
    candidate row indices, against device-resident entity tables, or the
    full batch), MELHI (the full 8-field baseline batch) and GHMFC with
    online BERT (the nine token-id fields of an ``OnlineBatch``, or raw
    strings through :meth:`Ranker.rank_text`: BERT runs inside the
    request).  Offline GHMFC can also encode the whole entity table once
    (:meth:`Ranker.precompute_entity_reprs`) and then rank by mention
    encoding, row gather and cosine (:meth:`Ranker.rank_rows`).
    :meth:`Ranker.retrieve` is stage-1 retrieval, the cosine top-k of a
    mention vector over the whole entity table (modes ``exact``, ``approx``,
    ``int8``).  :meth:`Ranker.save_bundle` / :meth:`Ranker.from_bundle`
    write and read a self-contained deployable directory.
    :meth:`Ranker.shard_retrieval` row-shards retrieval's table over several
    devices (:class:`ShardedRetrieval`).
  * :class:`BatchingRanker` is the micro-batching front: concurrent callers'
    requests coalesce into one device call.
  * :func:`serve_http` is the stdlib JSON-over-HTTP wrapper: POST /rank,
    /rank_text, /retrieve, GET /health and /stats, with the JAX server's
    status-code rules.
  * :func:`main` is the CLI, ``python -m drin_tpu_torch.serve``.

Over a row-sharded store (``DeviceEntityStore(shard_rows=True)`` on a mesh)
every rank of the store's model group holds a Ranker, and the rank stage's
gathers are collectives: every rank makes the same ``score`` / ``rank``
calls in the same order.  A DRIN ranker computes its candidates in parallel
over the group (C padded to the group's multiple; the module docstring of
``models/drin.py``).  :meth:`Ranker.set_store` reads retrieval's table in
lockstep, so that ``retrieve`` needs no collective; ``save_bundle`` is
collective.  Behind the HTTP front (:func:`serve_http`) the model group's
first rank leads (:meth:`Ranker.lead`: every ``score`` / ``rank`` is
broadcast to the others first) and the others follow
(:meth:`Ranker.follow`), one process a rank.

Everything runs under ``torch.inference_mode()``.  On CUDA the scalar-edge
GCN layer always runs the fused layer kernel, a fused store reads its int8
tables through the gather+dequant kernel and BERT's self-attention runs the
fused attention kernel from 256 tokens on; ``use_pallas`` and
``pallas_block_b`` are not read.  Retrieval's scans are library products
(``torch.matmul``, ``torch._int_mm``), as the JAX package's are XLA's, and
its shortlist is an exact top-k at every table size (the JAX package takes
an approximate one from 4096 rows).
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import sys
import threading
import time
from collections import Counter, deque
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.common.spans import span
from drin_tpu_torch.data.dataset import BaselineBatch, DrinBatch
from drin_tpu_torch.data.device_store import (BaselineRowsBatch, DeviceEntityStore,
                                              DrinRowsBatch, include_for, project_drin_tables)
from drin_tpu_torch.data.online import OnlineBatch, assemble_online_feats
from drin_tpu_torch.data.staging import PinnedStager
from drin_tpu_torch.models import get_model
from drin_tpu_torch.ops.core import cosine_similarity
from drin_tpu_torch.ops.cuda.gather import sanitize_rows
from drin_tpu_torch.parallel import collectives
from drin_tpu_torch.parallel.mesh import pad_candidates_to, padded_candidate_count


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} but CUDA is not available; the port has "
                           "no CPU fallback (pass device=cpu to run on the CPU)")
    return device


# ---------------------------------------------------------------------------
# stage-1 retrieval: plain torch on tensors, on the tensors' device


def quantize_rows(t: torch.Tensor):
    """Per-row max-abs int8 quantization of a [N, D] table.

    Returns ``(q, scale)`` with ``q`` int8 and ``scale`` float32 [N, 1] such
    that ``q * scale ~= t``.  Zero rows get scale 1 so they dequantize to
    zero instead of NaN."""
    s = t.abs().amax(-1, keepdim=True).float()
    s = torch.where(s == 0, 1.0, s)
    q = torch.clamp(torch.round(t.float() / s * 127.0), -127, 127)
    return q.to(torch.int8), s / 127.0


def _shortlist(scores: torch.Tensor, kc: int) -> torch.Tensor:
    """Shortlist indices [B, kc] for the rescore pass: an exact top-kc at
    every table size.  (The JAX package takes an approximate one from 4096
    columns on; an exact shortlist is a superset of what that one
    guarantees.)"""
    return torch.topk(scores, kc, dim=-1).indices


def _rescore_topk(qn, table, cand, k):
    """Gather the shortlist rows and rescore them at the table's precision;
    the returned top-k scores/order are exact over the shortlist."""
    rows = table[cand]                                      # [B, kc, D]
    exact = torch.einsum("bd,bkd->bk", qn.to(table.dtype), rows)
    s2, i2 = torch.topk(exact.float(), k, dim=-1)
    return s2, torch.gather(cand, 1, i2)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    """Rows over their L2 norm, taken in float32 and cast back to ``t``'s
    dtype.  Zero rows (an entity without text) keep norm 1, so they score 0
    instead of NaN, which ``torch.topk`` would rank first."""
    tf = t.float()
    nrm = torch.linalg.vector_norm(tf, dim=-1, keepdim=True)
    return (tf / torch.where(nrm == 0, 1.0, nrm)).to(t.dtype)


def retrieve_rescored(q, table, k: int, kc: int):
    """Scan in the table's dtype + shortlist of ``kc`` + exact rescore.
    ``q`` [B, D] float32, ``table`` the row-normalized [N, D] table."""
    qn = _unit(q)
    scores = qn.to(table.dtype) @ table.T                   # [B, N]
    return _rescore_topk(qn, table, _shortlist(scores, kc), k)


def _normalize_quantize_query(qn):
    """Max-abs int8 quantization of row-normalized queries ``qn`` [B, D];
    returns ``(qq int8, qscale f32 [B, 1])`` with ``qq * qscale ~= qn``."""
    qs = qn.abs().amax(-1, keepdim=True)
    qs = torch.where(qs == 0, 1.0, qs)
    qq = torch.clamp(torch.round(qn / qs * 127.0), -127, 127).to(torch.int8)
    return qq, qs / 127.0


def _int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` [M, K] int8 times ``b`` [N, K] int8 transposed, accumulated in
    int32: [M, N], through ``torch._int_mm``.  On CUDA that takes M > 16 and
    K, N multiples of 8, so ``a`` gets zero rows up to 17 and both get zero
    columns (which add nothing to a dot product) up to a multiple of 8,
    ``b`` zero rows likewise; the padding is sliced off.  A table whose row
    count or width is not a multiple of 8 is copied per call."""
    M, K = a.shape
    N = b.shape[0]
    pk = -K % 8
    a = torch.nn.functional.pad(a, (0, pk, 0, max(0, 17 - M)))
    if pk or N % 8:
        b = torch.nn.functional.pad(b, (0, pk, 0, -N % 8))
    return torch._int_mm(a, b.T)[:M, :N]


def _coarse_int8(qn, qt, scales):
    """int8 coarse scores [B, N] of row-normalized queries ``qn`` against
    the quantized table ``qt``/``scales`` (:func:`quantize_rows`): int32
    accumulation, then ``acc * qscale * scale`` in bfloat16, rounded left to
    right as the JAX package does (the int8 error, ~1e-2 on unit vectors,
    dwarfs bf16 rounding)."""
    qq, qscale = _normalize_quantize_query(qn)
    acc = _int8_product(qq, qt)
    bf = torch.bfloat16
    return acc.to(bf) * qscale.to(bf) * scales[:, 0][None, :].to(bf)


def retrieve_quantized(q, qt, scales, table, k: int, kc: int):
    """int8 coarse scan + shortlist of ``kc`` + exact rescore.  ``qt`` /
    ``scales`` from :func:`quantize_rows` over the row-normalized [N, D]
    retrieval table; ``table`` is that table at full precision.  Final
    scores/order are exact over the shortlist."""
    qn = _unit(q).float()
    coarse = _coarse_int8(qn, qt, scales)
    return _rescore_topk(qn, table, _shortlist(coarse, kc), k)


def _merge_topk(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """Top-k of candidates [B, M] from several shards, ties in ascending
    row order (``torch.topk`` promises no order among ties): sort by row,
    then stably by descending score."""
    by_row = torch.argsort(rows, dim=1, stable=True)
    scores, rows = torch.gather(scores, 1, by_row), torch.gather(rows, 1, by_row)
    order = torch.argsort(scores, dim=1, descending=True, stable=True)[:, :k]
    return torch.gather(scores, 1, order), torch.gather(rows, 1, order)


class ShardedRetrieval:
    """Stage-1 retrieval over a table row-sharded across ``devices`` (default:
    every visible CUDA device; a list may name one device more than once),
    in one process: the counterpart of the JAX package's
    ``ShardedRetrieval``, where a shard is a mesh device.

    Each shard scans its own [N / n, D] rows, shortlists, rescores its own
    full-precision rows and keeps a local top-k; the merge takes the top-k of
    the shards' winners, ties in ascending row order.  Every true top-k row
    is in its own shard's local top-k, so with an exact shortlist the merge
    equals the one-device scan.  The port's shortlist is exact at every
    shard size (as :func:`_shortlist`), so every mode keeps that guarantee;
    ``exact=True`` scans in the table's dtype and takes the local top-k of
    the scan itself, as ``Ranker.retrieve``'s exact mode does.  Rows are
    zero-padded to an even split; padded rows score -inf and never surface.
    ``quantize=True`` builds every shard's int8 cache (:func:`quantize_rows`,
    per row, so a shard quantizes as the whole table does).  ``table`` is
    used as given: callers pass row-normalized rows."""

    def __init__(self, table: torch.Tensor, devices=None, quantize: bool = False):
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [_check_device(d) for d in devices]
        if not self.devices:
            raise RuntimeError("ShardedRetrieval needs devices: no CUDA device is visible "
                               "(pass devices=[...])")
        self.n = len(self.devices)
        self.n_valid = int(table.shape[0])
        self.rows = nl = -(-self.n_valid // self.n)
        self.shards = []
        with torch.inference_mode():
            for r, dev in enumerate(self.devices):
                part = table[r * nl:(r + 1) * nl]
                if part.shape[0] < nl:
                    part = torch.cat([part, part.new_zeros((nl - part.shape[0],)
                                                           + tuple(table.shape[1:]))])
                self.shards.append(part.to(dev).contiguous())
        self.quant = None
        if quantize:
            self.ensure_quant()

    def ensure_quant(self):
        if self.quant is None:
            with torch.inference_mode():
                self.quant = [quantize_rows(t) for t in self.shards]

    def _shard(self, r: int, q: torch.Tensor, k: int, kc: int, quantized: bool, exact: bool):
        t, dev = self.shards[r], self.devices[r]
        base, nl = r * self.rows, self.rows
        q = q.to(dev)
        pad = (base + torch.arange(nl, device=dev)) >= self.n_valid  # [nl]
        kl = min(kc, nl)
        kk = min(k, kl)
        if exact:  # as the one-device exact mode: the query in the table's dtype
            qn = _unit(q.to(t.dtype).float()).to(t.dtype)
            scan = (qn @ t.T).float().masked_fill(pad[None, :], float("-inf"))
            s, i = torch.topk(scan, kk, dim=-1)
            return s, i + base
        qn = _unit(q).float()
        coarse = _coarse_int8(qn, *self.quant[r]) if quantized else qn.to(t.dtype) @ t.T
        cand = _shortlist(coarse.masked_fill(pad[None, :], float("-inf")), kl)  # local rows
        rescored = torch.einsum("bd,bkd->bk", qn.to(t.dtype), t[cand]).float()
        s, i = torch.topk(rescored.masked_fill(pad[cand], float("-inf")), kk, dim=-1)
        return s, torch.gather(cand, 1, i) + base

    def __call__(self, q, k: int, kc: int, quantized: bool = False, exact: bool = False):
        """Top-``k`` (scores float32 [B, k], rows int64 [B, k], on the host)
        of queries ``q`` [B, D], through shortlists of ``kc`` a shard
        (``exact``: the scan's own top-k)."""
        if quantized:
            self.ensure_quant()
        with torch.inference_mode():
            q = torch.as_tensor(np.asarray(q, np.float32))
            wins = [self._shard(r, q, k, kc, quantized, exact) for r in range(self.n)]
            scores = torch.cat([s.cpu() for s, _ in wins], 1)
            rows = torch.cat([i.cpu() for _, i in wins], 1)
            return _merge_topk(scores, rows, min(k, scores.shape[1]))


BUNDLE_STATE = "state.pt"
BUNDLE_READ_ROWS = 32768  # save_bundle's rows a read: the device holds one piece of a table

# the request's faults: the HTTP front answers 400 for these
REQUEST_ERRORS = (KeyError, ValueError, TypeError, AssertionError, IndexError)


class FollowerFault(RuntimeError):
    """A rank of a row-sharded Ranker's model group failed a lockstep call
    (or left the group): the front cannot score any more."""


class Ranker:
    """Mention-candidate ranking service over a port model (DRIN, GHMFC
    offline or with online BERT, MELHI).

    ``params`` is a port state_dict (tensors or numpy arrays); without it
    the weights come from ``<checkpoint_dir>/params.pt`` (``torch.save``
    of a state_dict).  Parameters are cast to ``cfg.compute_dtype`` on
    ``device``.  ``bert_cfg`` overrides the online model's bert-base
    dimensions, or picks its other text tower (``get_model``).
    ``store_mesh`` row-shards the store over that mesh's model
    axis (every rank of its model group builds its Ranker alike; the
    token-level tables then need no pooled cache).  An online model with entity tables keeps them in a store
    for :meth:`retrieve` alone: its requests carry token ids, never rows."""

    def __init__(self, cfg: Config, params: Optional[Mapping] = None,
                 entity_tables: Optional[dict] = None, checkpoint_dir: Optional[str] = None,
                 *, device, quantize_store: bool = False, fused_gather: bool = False,
                 bert_cfg=None, store_mesh=None):
        self.cfg = cfg
        self.device = _check_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        self._bert_cfg = bert_cfg
        if params is None:
            params = self._restore(checkpoint_dir or cfg.checkpoint_dir)
        self.model, self.kind = self._build_model(cfg, params)
        self.store = None
        self._feats_fn = None
        self._stager = PinnedStager(self.device)
        self._entity_reprs = None
        self._tokenizer = None
        # stage-1 retrieval caches, built on first use from the store
        self._retrieval_table = None
        self._retrieval_q = None
        self._retrieval_expand = 4
        self._sharded = None  # shard_retrieval's ShardedRetrieval
        self._sharded_expand = 4
        self._lead = None  # the lock of a leading rank (lead())
        # the raw host tables are kept only for DRIN's
        # precompute_entity_projection; any other kind would pin them for
        # the server's lifetime
        self._tables = entity_tables if self.kind == "drin" else None
        if entity_tables is not None and (cfg.entity_pooling_cached or store_mesh is not None):
            if fused_gather and cfg.model_type not in ("drin", "ghmfc"):
                raise ValueError("fused_gather packs the DRIN or GHMFC table layouts; "
                                 f"model_type={cfg.model_type} uses the standard quantized store")
            # GHMFC reads the text table alone: the image and object tables
            # are never uploaded for it
            self.store = DeviceEntityStore(cfg, entity_tables, device=self.device,
                                           dtype=self.dtype, quantize=quantize_store,
                                           fused_gather=fused_gather,
                                           include=include_for(self.kind),
                                           shard_rows=store_mesh is not None, mesh=store_mesh)
            self._feats_fn = self._feats_fn_for(self.store)
            self._read_sharded_retrieval_table()
        elif quantize_store or fused_gather:
            raise ValueError(
                ("quantize_store" if quantize_store else "fused_gather")
                + "=True needs device entity tables (entity_tables with "
                "entity_pooling_cached); this configuration builds no rank-stage store")

    def _build_model(self, cfg: Config, params: Mapping):
        with torch.device("meta"):  # no init work: every weight is loaded below
            model, kind = get_model(cfg, bert_cfg=self._bert_cfg)
        want = model.state_dict()
        sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
              for k, v in params.items() if k in want}
        model.load_state_dict(sd, assign=True)
        model = model.to(device=self.device, dtype=self.dtype)
        return model.eval().requires_grad_(False), kind

    @staticmethod
    def _restore(checkpoint_dir: str):
        path = os.path.join(os.path.abspath(checkpoint_dir), "params.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no port checkpoint at {path} (a torch.save'd "
                                    "state_dict of the configured port model)")
        return torch.load(path, map_location="cpu", weights_only=True)

    def set_store(self, store: DeviceEntityStore, entity_tables: Optional[dict] = None):
        """Swap in a different store (and the host tables a later
        projection reads; None makes a projection fail loudly).  A
        row-sharded store's retrieval table is read here, collectively:
        every rank of its model group calls ``set_store``."""
        self.store = store
        self._feats_fn = self._feats_fn_for(store)
        self._tables = entity_tables if self.kind == "drin" else None
        self._entity_reprs = None  # encoded from the old tables: rank_rows must refuse
        self._drop_retrieval_caches()
        self._read_sharded_retrieval_table()

    def _drop_retrieval_caches(self):
        self._retrieval_table = None
        self._retrieval_q = None
        self._sharded = None

    def _read_sharded_retrieval_table(self):
        """On a row-sharded store, read retrieval's table now, in lockstep
        with the model group: a lazy read on the first ``retrieve`` would be
        a collective that only the rank with the request reaches."""
        if self.store is not None and self.store.sharded:
            with torch.inference_mode():
                self._retrieval_table = _unit_rows(self._retrieval_source())

    def _feats_fn_for(self, store: DeviceEntityStore):
        """Rows batch -> model batch for DRIN and the offline baselines.  The
        online model's requests carry token ids, never table rows: no
        feats_fn even with a store."""
        if self.kind == "drin":
            return store.drin_feats_fn()
        return store.baseline_feats_fn() if self.kind == "baseline" else None

    def precompute_entity_projection(self):
        """Project the frozen entity tables through the entity-side linears
        once (exact math) and serve with ``entity_projected=True``.
        Idempotent: a projected ranker is left as it is."""
        assert self.cfg.model_type == "drin" and self._tables is not None, (
            "projection is the DRIN fast path and needs entity tables")
        if self.cfg.entity_projected:
            return
        sd = self.model.state_dict()
        proj = project_drin_tables(self.cfg, self._tables, sd, device=self.device)
        self.cfg = self.cfg.replace(entity_projected=True)
        self.model, _ = self._build_model(self.cfg, sd)
        # the rebuilt store keeps the old one's quantization and layout
        old = self.store
        self.store = DeviceEntityStore(self.cfg, proj, device=self.device, dtype=self.dtype,
                                       quantize=old is not None and old.quantized,
                                       fused_gather=old is not None and old.fused,
                                       shard_rows=old is not None and old.sharded,
                                       mesh=old.mesh if old is not None else None)
        self._feats_fn = self.store.drin_feats_fn()
        self._tables = proj
        self._drop_retrieval_caches()  # the retrieval source is now slot 1
        self._read_sharded_retrieval_table()

    def precompute_entity_reprs(self, chunk: int = 8192) -> np.ndarray:
        """Offline GHMFC's serving fast path: its entity tower reads only the
        entity tables, so with the weights frozen the whole table is encoded
        once, ``chunk`` rows at a time (a quantized store dequantizes one
        chunk, never the table), into [N, D] representations.  A request
        then costs a mention encoding, a row gather and a cosine
        (:meth:`rank_rows`).  Returns the representations as float32.  On a
        row-sharded store the rows are read collectively
        (``DeviceEntityStore.float_rows``): every rank of the model group
        must call it, and each ends with every row's representation
        (:meth:`rank_rows` stays a one-device path)."""
        assert self.store is not None, "needs device entity tables"
        assert self.cfg.model_type == "ghmfc", "entity precompute is the GHMFC fast path"
        if self.cfg.online_bert:
            raise NotImplementedError(
                "entity precompute is the offline GHMFC fast path: the online model has "
                "no standalone entity encoder to encode the table with (it reads entity "
                "text per request)")
        encode = self.model.entity_encoder
        with torch.inference_mode():
            # n_rows, not a table's shape: a fused store keeps no per-table copy
            self._entity_reprs = torch.cat([
                encode(self.store.float_rows("text", lo, lo + chunk)[None], None)[0]
                for lo in range(0, self.store.n_rows, chunk)])
            self._drop_retrieval_caches()  # retrieval moves to the model's space
            return self._entity_reprs.float().cpu().numpy()

    def rank_rows(self, mention_feats, rows, k: int = 5):
        """(top-k scores, top-k candidate indices) against the precomputed
        entity representations: ``mention_feats`` are the rows batch's five
        mention fields, ``rows`` [B, C] its table rows (negatives wrap once,
        the rest clamp, as in the store).  Call
        :meth:`precompute_entity_reprs` first."""
        assert self._entity_reprs is not None, "call precompute_entity_reprs() first"
        with torch.inference_mode():
            feats = self._check_batch(self._stager.stage(list(mention_feats) + [rows], self.dtype))
            rows = feats.pop()
            if rows.ndim != 2:
                raise ValueError(f"rows must be [B, C], got {tuple(rows.shape)}")
            if not 0 <= k <= rows.shape[1]:
                raise ValueError(f"k must be in [0, {rows.shape[1]}], got {k}")
            mention = self.model.mention_encoder(*feats)  # [B, D]
            reprs = self._entity_reprs
            entity = reprs[sanitize_rows(rows, reprs.shape[0])].reshape(
                tuple(rows.shape) + (reprs.shape[-1],))
            scores = cosine_similarity(mention[:, None, :].expand_as(entity), entity).float()
            vals, idx = torch.topk(scores, k, dim=-1)
            return vals.cpu().numpy(), idx.cpu().numpy()

    # ------------------------------------------------------------------
    @staticmethod
    def _check_batch(out: list) -> list:
        B = out[0].shape[0] if out[0].ndim else None
        if B is None or any(t.ndim == 0 or t.shape[0] != B for t in out):
            raise ValueError("every feature field needs the same leading batch dim, got "
                             f"{[tuple(t.shape) for t in out]}")
        return out

    def _prepare(self, feats) -> tuple:
        """The request's feature fields on the device, checked: a floating
        field in the compute dtype, any other in its own.  Host arrays go
        through the ranker's :class:`~drin_tpu_torch.data.staging.PinnedStager`
        (on CUDA one pinned arena, filled and sent in chunks, the copies
        asynchronous on the current stream); tensors already on the device
        pass through."""
        feats = tuple(feats)
        n = len(_batch_type(self)._fields) - 1
        if len(feats) != n:
            raise ValueError(f"expected {n} feature fields, got {len(feats)}")
        out = self._check_batch(self._stager.stage(feats, self.dtype))
        if self._feats_fn is not None and self.kind == "drin":
            rows, miet, mtei = out[7], out[8], out[9]
            if rows.ndim != 2 or miet.shape != rows.shape or mtei.shape != rows.shape:
                raise ValueError("entity_rows, miet_similarity and mtei_similarity must "
                                 f"share one [B, C] shape, got {tuple(rows.shape)}, "
                                 f"{tuple(miet.shape)}, {tuple(mtei.shape)}")
        elif self._feats_fn is not None and out[5].ndim != 2:
            raise ValueError(f"entity_rows must be [B, C], got {tuple(out[5].shape)}")
        return tuple(out)

    def _candidate_split(self, feats: tuple):
        """The one decision of a request's candidate split: DRIN or offline
        GHMFC over a store on a mesh whose model axis has several ranks is
        candidate-parallel, with the rows batch padded to the axis's
        multiple of C (row 0 and, for DRIN, zero similarities, masked in the
        model, as the ``Trainer`` pads) and the mesh's split, which both the
        gather and the model take.  Otherwise (one rank on the axis, or a
        request of another C that the axis does not divide) the batch as it
        is and None.  (MELHI and the online model never read a store.)"""
        mesh = self.store.mesh
        split = mesh.candidate_split() if mesh is not None else None
        if split is None:
            return feats, None
        C = feats[_batch_type(self)._fields.index("entity_rows")].shape[1]
        Cp = padded_candidate_count(C, split.n) if C == self.cfg.num_candidates_model else C
        if not split.divides(Cp):
            return feats, None
        return pad_candidates_to(feats, _batch_type(self)._fields[:-1], C, Cp), split

    def _scores(self, feats) -> torch.Tensor:
        with span("drin.serve.prepare"):
            feats = self._prepare(feats)
        split = None
        if self._feats_fn is not None:
            with span("drin.serve.gather"):
                feats, split = self._candidate_split(feats)
                feats = self._feats_fn(feats) if split is None else self._feats_fn(feats, split)
        with span("drin.serve.forward"):
            if split is None:
                return self.model(feats).float()
            return self.model(feats, split=split).float()

    def score(self, feats) -> np.ndarray:
        """Raw candidate scores [B, C] for a feature tuple (the batch fields
        of :func:`rank_feat_fields`, in order)."""
        if self._lead is not None:
            return self._lockstep("score", feats, 0)
        return self._scores_numpy(feats)

    def rank(self, feats, k: int = 5):
        """(top-k scores, top-k candidate indices) per mention."""
        if self._lead is not None:
            return self._lockstep("rank", feats, k)
        return self._rank(feats, k)

    def _rank(self, feats, k: int):
        with torch.inference_mode(), span("drin.serve.rank"):
            s = self._scores(feats)
            if not 0 <= k <= s.shape[-1]:
                raise ValueError(f"k must be in [0, {s.shape[-1]}], got {k}")
            with span("drin.serve.result"):
                vals, idx = torch.topk(s, k, dim=-1)
                return vals.cpu().numpy(), idx.cpu().numpy()

    # -- lockstep over a row-sharded store's model group ---------------
    def _group(self):
        """(model group, the global rank of its first rank) of the store."""
        if self.store is None or not self.store.sharded:
            raise RuntimeError("lead() and follow() serve a Ranker over a row-sharded store")
        mesh = self.store.mesh
        return mesh.model_group, int(mesh.ranks[mesh.data_index, 0])

    def lead(self):
        """Make this rank, the first of the store's model group, the front:
        every later ``score`` / ``rank`` (from any thread, one at a time) is
        broadcast to the group's other ranks, which run it in
        :meth:`follow`.  A follower that fails or leaves the group raises
        :class:`FollowerFault` here.  :meth:`stop_followers` ends them."""
        group, first = self._group()
        if self.store.mesh.rank != first:
            raise RuntimeError(f"rank {self.store.mesh.rank} is not the first rank ({first}) of "
                               "its model group: it follows")
        self._lead = threading.Lock()

    def _send(self, call: str, k: int, arrays):
        """Broadcast a call from the front to the model group: the call, k
        and each array's (dtype, shape) as one pickled object, then the
        arrays.  After the call every rank reports one status
        (:meth:`_statuses`: 0 done, 1 the request's fault, 2 the server's)."""
        import torch.distributed as dist

        group, first = self._group()
        tensors = [t if torch.is_tensor(t) else torch.as_tensor(np.asarray(t)) for t in arrays]
        head = [(call, k, [(t.dtype, tuple(t.shape)) for t in tensors])]
        dist.broadcast_object_list(head, src=first, group=group)
        collectives.broadcast_([t.to(self.device) for t in tensors], first, group)

    def _receive(self):
        """A follower's side of :meth:`_send`: (call, k, tensors)."""
        import torch.distributed as dist

        group, first = self._group()
        head = [None]
        dist.broadcast_object_list(head, src=first, group=group)
        call, k, specs = head[0]
        tensors = [torch.empty(shape, dtype=dt, device=self.device) for dt, shape in specs]
        collectives.broadcast_(tensors, first, group)
        return call, k, tensors

    def _statuses(self, status: int) -> int:
        """The worst status over the model group (every rank calls it)."""
        group, _ = self._group()
        t = torch.tensor([status], dtype=torch.int64, device=self.device)
        if collectives.group_size(group) > 1:
            import torch.distributed as dist

            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return int(t.item())

    def _lockstep(self, call: str, feats, k: int):
        """The front's side of a call: broadcast it, run it with the
        followers, and agree on how it ended.  A fault of the front itself
        or of the group's collectives raises :class:`FollowerFault`: the
        group can no longer run in step."""
        with self._lead:
            try:
                self._send(call, k, feats)
            except ValueError:
                raise  # nothing was sent
            except Exception as e:
                raise FollowerFault(f"broadcasting the request to the model group failed: {e}") from e
            try:
                out = self._scores_numpy(feats) if call == "score" else self._rank(feats, k)
            except REQUEST_ERRORS as e:
                failed = e
            except Exception as e:  # a collective broke, or the front failed mid-call
                raise FollowerFault(f"the lockstep {call} failed: {type(e).__name__}: {e}") from e
            else:
                failed = None
            try:
                worst = self._statuses(1 if failed is not None else 0)
            except Exception as e:
                raise FollowerFault(f"a follower left the model group: {e}") from e
            if worst == 2 or (worst == 1 and failed is None):
                raise FollowerFault(f"a follower failed the lockstep {call}")
            if failed is not None:
                raise failed
            return out

    def _scores_numpy(self, feats) -> np.ndarray:
        with torch.inference_mode(), span("drin.serve.rank"):
            s = self._scores(feats)
            with span("drin.serve.result"):
                return s.cpu().numpy()

    def follow(self):
        """Run the front's calls (:meth:`lead`) on this rank of the model
        group until it stops them.  A call
        that fails here for the request's reason fails on the front too; any
        other failure raises, and the caller must leave the process group
        (exiting does), so that the front sees the group broken and never
        waits on this rank."""
        while True:
            call, k, tensors = self._receive()
            if call == "stop":
                return
            status = 0
            try:
                if call == "score":
                    self._scores_numpy(tensors)
                else:
                    self._rank(tensors, k)
            except REQUEST_ERRORS:
                status = 1
            self._statuses(status)

    def stop_followers(self):
        """End the followers' :meth:`follow` loops (the front's shutdown)."""
        if self._lead is None:
            return
        with self._lead:
            self._send("stop", 0, [])
            self._lead = None

    # ------------------------------------------------------------------
    def rank_text(self, sentences, char_spans, candidate_texts, k: int = 5,
                  mention_images=None, tokenizer=None):
        """Raw-text ranking for the online model: sentences + character
        mention spans + per-mention candidate strings -> (top-k scores,
        candidate indices).  Tokenization and span conversion run on the
        calling thread (:func:`~drin_tpu_torch.data.online.assemble_online_feats`);
        the tokenizer reads ``cfg.bert_vocab`` unless one is passed."""
        return self.rank(self._text_feats(sentences, char_spans, candidate_texts,
                                          mention_images, tokenizer), k)

    def _text_feats(self, sentences, char_spans, candidate_texts, mention_images, tokenizer):
        if not self.cfg.online_bert:
            raise ValueError("rank_text needs the online-BERT model (online_bert=true)")
        return assemble_online_feats(self.cfg, tokenizer or self._ensure_tokenizer(), sentences,
                                     char_spans, candidate_texts, mention_images)

    def _ensure_tokenizer(self):
        if self._tokenizer is None:
            from drin_tpu_torch.text.wordpiece import BertTokenizer

            if not self.cfg.bert_vocab:
                raise RuntimeError("raw-text serving needs cfg.bert_vocab (a WordPiece vocab.txt)")
            self._tokenizer = BertTokenizer(vocab_file=self.cfg.bert_vocab, do_lower_case=False,
                                            model_max_length=self.cfg.max_bert_len)
        return self._tokenizer

    def _retrieval_source(self) -> torch.Tensor:
        """The [N, D] vectors stage-1 retrieval scans, sliced to the store's
        row count: GHMFC's precomputed representations when there are some,
        else the store's pooled text.  After the DRIN projection slot 0
        holds the projected text and queries are raw BERT vectors, so
        retrieval reads slot 1, the raw CLS."""
        if self.store is None:
            # the server was built without tables: its fault, not the
            # request's (the HTTP layer answers 500)
            raise RuntimeError("retrieve() needs device entity tables: this Ranker was built "
                               "without entity_tables/entity_pooling_cached")
        n = self.store.n_rows
        if self._entity_reprs is not None:
            return self._entity_reprs[:n]
        # a row-sharded store reads the n rows collectively (set_store)
        return self.store.float_rows("text", 0, n, slot=1 if self.cfg.entity_projected else 0)

    def _ensure_retrieval_table(self) -> torch.Tensor:
        if self._retrieval_table is None:
            if self.store is not None and self.store.sharded and self._entity_reprs is None:
                raise RuntimeError("a row-sharded store's retrieval table is read by set_store, "
                                   "on every rank of its model group; it was dropped since")
            with torch.inference_mode():
                self._retrieval_table = _unit_rows(self._retrieval_source())
        return self._retrieval_table

    def quantize_retrieval(self, expand: int = 4):
        """Build the int8 retrieval cache (mode ``"int8"``): the
        row-normalized table quantized once per row (:func:`quantize_rows`),
        half the bytes of a bf16 scan.  Each query scans it in int8,
        shortlists ``k * expand`` rows and rescores them against the
        full-precision table.  Dropped by ``set_store`` and the
        ``precompute_*`` fast paths."""
        if expand < 1:
            raise ValueError(f"expand must be >= 1, got {expand}")
        table = self._ensure_retrieval_table()
        with torch.inference_mode():
            quant = quantize_rows(table)
        self._retrieval_expand = int(expand)
        # published last: concurrent callers test this field for the cache
        self._retrieval_q = quant

    def shard_retrieval(self, devices=None, expand: int = 4, quantize: bool = False):
        """Row-shard stage-1 retrieval's table over ``devices`` (default:
        every visible CUDA device on a CUDA ranker, else this ranker's
        device; :class:`ShardedRetrieval`).  :meth:`retrieve` then routes
        every mode through the shards; ``quantize=True`` builds their int8
        caches now.  The one-device caches are released (the shards hold
        their own copies); ``set_store`` and the ``precompute_*`` fast paths
        drop the shards."""
        if expand < 1:
            raise ValueError(f"expand must be >= 1, got {expand}")
        if devices is None and self.device.type != "cuda":
            devices = [self.device]
        sharded = ShardedRetrieval(self._ensure_retrieval_table(), devices=devices,
                                   quantize=quantize)
        self._sharded_expand = int(expand)
        self._retrieval_table = None
        self._retrieval_q = None
        self._sharded = sharded
        return sharded

    def retrieve(self, mention_repr, k: int = 100, mode: Optional[str] = None,
                 expand: Optional[int] = None):
        """Stage-1 retrieval: cosine top-k of ``mention_repr`` [B, D] over the
        whole entity table (:meth:`_retrieval_source`), row-normalized once
        on first use and kept on the device.  ``k`` is clamped to the row
        count in every mode.  Returns (scores float32 [B, k], indices).

        ``mode``: ``"exact"``, a scan in the table's dtype + exact top-k
        (the query is cast to that dtype before it is normalized);
        ``"approx"``, the same scan, a shortlist of ``k * expand`` and an
        exact rescore (the port's shortlist is exact, so this mode returns
        what ``exact`` does up to the rescore's rounding); ``"int8"``, an
        int8 scan of the cache that :meth:`quantize_retrieval` builds (here
        on demand), the shortlist and the rescore; ``None``, ``"int8"`` once
        that cache exists, else ``"exact"``.  ``expand`` overrides the
        shortlist width for this call (default: the cache's, or 4).

        After :meth:`shard_retrieval` every mode runs over the shards
        (``None``: ``"int8"`` when their int8 caches exist), without the
        one-device table."""
        if expand is not None and expand < 1:
            raise ValueError(f"expand must be >= 1, got {expand}")
        k = int(k)
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        if self._sharded is not None:
            return self._retrieve_sharded(self._sharded, mention_repr, k, mode, expand)
        table = self._ensure_retrieval_table()
        q = np.asarray(mention_repr, np.float32)
        if q.ndim != 2 or q.shape[1] != table.shape[1]:
            raise ValueError(f"the query must be [B, {table.shape[1]}], got {q.shape}")
        if mode is None:
            mode = "int8" if self._retrieval_q is not None else "exact"
        if mode not in ("exact", "approx", "int8"):
            raise ValueError(f"unknown retrieval mode {mode!r} (exact | approx | int8)")
        with torch.inference_mode():
            q = torch.from_numpy(q).to(self.device)
            n = table.shape[0]
            if mode == "int8":
                if self._retrieval_q is None:
                    self.quantize_retrieval(expand if expand is not None else 4)
                qt, scales = self._retrieval_q
                exp = expand if expand is not None else self._retrieval_expand
                kc = min(k * exp, n)
                scores, idx = retrieve_quantized(q, qt, scales, table, min(k, kc), kc)
            elif mode == "approx":
                kc = min(k * (expand if expand is not None else 4), n)
                scores, idx = retrieve_rescored(q, table, min(k, kc), kc)
            else:
                qn = _unit(q.to(table.dtype).float()).to(table.dtype)
                scores, idx = torch.topk((qn @ table.T).float(), min(k, n), dim=-1)
            return scores.cpu().numpy(), idx.cpu().numpy()

    def _retrieve_sharded(self, sharded, mention_repr, k, mode, expand):
        q = np.asarray(mention_repr, np.float32)
        width = sharded.shards[0].shape[1]
        if q.ndim != 2 or q.shape[1] != width:
            raise ValueError(f"the query must be [B, {width}], got {q.shape}")
        if mode is None:
            mode = "int8" if sharded.quant is not None else "exact"
        if mode not in ("exact", "approx", "int8"):
            raise ValueError(f"unknown retrieval mode {mode!r} (exact | approx | int8)")
        kq = min(k, sharded.n_valid)
        exp = expand if expand is not None else self._sharded_expand
        kc = kq if mode == "exact" else min(k * exp, sharded.n_valid)
        scores, idx = sharded(q, kq, kc, quantized=mode == "int8", exact=mode == "exact")
        return scores.numpy(), idx.numpy()

    # ------------------------------------------------------------------
    def save_bundle(self, path: str):
        """Write a self-contained deployable directory, reloadable with
        :meth:`from_bundle`: ``config.json`` (the Config as JSON) and
        ``state.pt``, a ``torch.save`` of ``{"params": state_dict,
        "tables": float32 tensors}``.  A quantized store persists its
        dequantized floats, so the bundle loads into any store layout; a
        narrowed store (GHMFC, online: text alone) persists what it holds.
        The tables hold the store's ``n_rows`` rows, read
        ``BUNDLE_READ_ROWS`` rows at a time.  Over a row-sharded store the reads are collective: every rank
        of the store's mesh calls ``save_bundle`` with the same path, the
        mesh's main rank writes, and every rank returns once it has."""
        store = self.store
        sharded = store is not None and store.sharded
        payload = {"params": {k: v.detach().cpu() for k, v in self.model.state_dict().items()}}
        if store is not None:
            names = {"text": "entity_text_feature", "image": "entity_image_feature",
                     "obj": "entity_object_feature"}
            if "obj" in store.include:
                names["obj_score"] = "entity_object_score"
            with torch.inference_mode():
                payload["tables"] = {
                    key: torch.cat([store.float_rows(t, lo, lo + BUNDLE_READ_ROWS).float().cpu()
                                    for lo in range(0, store.n_rows, BUNDLE_READ_ROWS)])
                    for t, key in names.items() if t == "obj_score" or t in store.include}
        if not sharded or store.mesh.main:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(self.cfg), f, indent=1)
            # written beside and renamed: refreshing a bundle in place never
            # leaves a torn file
            tmp = os.path.join(path, BUNDLE_STATE + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(path, BUNDLE_STATE))
        if sharded and collectives.group_size(store.mesh.group) > 1:
            import torch.distributed as dist

            dist.barrier(group=store.mesh.group)

    @classmethod
    def from_bundle(cls, path: str, *, device, quantize_store: bool = False,
                    fused_gather: bool = False, bert_cfg=None, store_mesh=None) -> "Ranker":
        """A Ranker from a :meth:`save_bundle` directory.  ``quantize_store``
        / ``fused_gather`` load the bundled float tables into the int8 or
        fused store; ``bert_cfg`` and ``store_mesh`` as in the constructor."""
        with open(os.path.join(path, "config.json")) as f:
            raw = json.load(f)
        # JSON turns tuples into lists; restore the tuple-typed fields
        cfg = Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()})
        state = torch.load(os.path.join(path, BUNDLE_STATE), map_location="cpu",
                           weights_only=True)
        tables = state.get("tables")
        if tables is not None:
            tables = {k: v.numpy() for k, v in tables.items()}
        return cls(cfg, state["params"], tables, device=device, quantize_store=quantize_store,
                   fused_gather=fused_gather, bert_cfg=bert_cfg, store_mesh=store_mesh)


# ---------------------------------------------------------------------------
# micro-batching front


class _Req(NamedTuple):
    kind: str       # "rank" | "retrieve"
    feats: tuple    # feature fields ("retrieve": the single [B, D] query)
    k: int
    extra: object   # "retrieve": (mode, expand); "rank": unused
    fut: object
    t0: float       # enqueue time (monotonic) for the latency ring


class _DaemonFlushPool:
    """A fixed pool of daemon flush workers.

    Not ``concurrent.futures.ThreadPoolExecutor``: that joins its workers at
    interpreter exit, so one flush stuck in a device call would keep the
    process alive after a bounded ``close()`` returned.  Daemon workers let
    it exit.  The lock orders submit against shutdown: a job never lands
    behind a shutdown sentinel, so ``BatchingRanker._dispatch``'s inline
    flush of a closed pool always fires instead."""

    def __init__(self, n: int):
        import queue

        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self._open = True
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._work, daemon=True) for _ in range(n)]
        for t in self._threads:
            t.start()

    def _work(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            job()

    def submit(self, fn):
        with self._lock:
            if not self._open:
                raise RuntimeError("flush pool is shut down")
            self._jobs.put(fn)

    def shutdown(self, wait: bool = False):
        with self._lock:
            if self._open:
                self._open = False
                for _ in self._threads:
                    self._jobs.put(None)
        if wait:
            for t in self._threads:
                t.join()


class BatchingRanker:
    """Micro-batching front: concurrent ``rank`` / ``retrieve`` /
    ``rank_text`` calls coalesce into one device call.

    A dispatcher thread collects requests for up to ``wait_ms`` (or until
    ``max_batch`` rows), groups them by (kind, k, extra, trailing shapes),
    concatenates each group, pads it to the next bucket size by repeating
    row 0, runs one ``ranker.rank`` or ``ranker.retrieve`` and splits the
    results back.  A group that fails is retried request by request, so a
    malformed request fails only its own caller.  ``pipeline_depth`` flushes
    may be in flight at once.  The ranker stages each call's inputs through
    its one pinned arena, one call at a time (a flush may fill the arena
    while another flush's kernels run), and every flush runs on one stream,
    so on CUDA a flush's copies to the device do not overlap another flush's
    compute."""

    def __init__(self, ranker: Ranker, max_batch: int = 64, wait_ms: float = 2.0,
                 buckets: tuple = (1, 2, 4, 8, 16, 32, 64), pipeline_depth: int = 2):
        import queue

        self.ranker = ranker
        self.cfg = ranker.cfg
        self.max_batch = max_batch
        self.wait_s = wait_ms / 1e3
        self.buckets = tuple(sorted(set(buckets) | {max_batch}))
        self._q: "queue.Queue" = queue.Queue()
        # observability counters, bumped from the flush threads under the lock
        self._batches_run = 0
        self._rows_run = 0
        self._batch_buckets: Counter = Counter()   # (kind, padded bucket) -> calls
        self._latencies: deque = deque(maxlen=2048)  # seconds, enqueue -> result
        self._stats_lock = threading.Lock()
        self._stop = False
        self._close_lock = threading.Lock()  # orders _submit against close()
        self._flush_pool = _DaemonFlushPool(pipeline_depth) if pipeline_depth > 1 else None
        self._inflight = threading.Semaphore(max(pipeline_depth, 1))
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0):
        """Stop the dispatcher; bounded by ~2x ``timeout``.  In-flight
        flushes are not awaited: they resolve their callers' futures when
        the device answers.  A window the dispatcher has taken but not yet
        submitted is flushed inline, so no future is stranded; a request
        that raced past the stop check fails with ``RuntimeError``."""
        import queue

        with self._close_lock:
            self._stop = True
            self._q.put(None)
        self._thread.join(timeout=timeout)
        if self._flush_pool is not None:
            # closes the pool to new submits at once, without waiting on
            # in-flight flushes; a dispatcher blocked in _inflight.acquire()
            # wakes, meets the closed pool and flushes its window inline
            self._flush_pool.shutdown(wait=False)
            if self._thread.is_alive():
                self._thread.join(timeout=timeout)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.fut.done():
                item.fut.set_exception(RuntimeError("BatchingRanker closed"))

    # -- caller side ---------------------------------------------------
    def _submit(self, kind, feats, k, extra):
        import concurrent.futures as cf

        # checked here, on the caller's thread: the dispatcher reads each
        # request's batch size, and a field without one would stop it
        if not feats or any(f.ndim == 0 for f in feats):
            raise ValueError("every feature field needs a leading batch dim, got "
                             f"{[f.shape for f in feats]}")
        fut: "cf.Future" = cf.Future()
        with self._close_lock:
            if self._stop:
                raise RuntimeError("BatchingRanker is closed")
            self._q.put(_Req(kind, feats, int(k), extra, fut, time.monotonic()))
        return fut.result()

    def latency_quantiles(self) -> dict:
        """p50/p95/p99 end-to-end request latency (enqueue -> result) in ms
        over the most recent completed requests (bounded ring)."""
        with self._stats_lock:
            lats = sorted(self._latencies)
        if not lats:
            return {"count": 0}
        q = lambda p: lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3
        return {"count": len(lats), "p50_ms": round(q(0.50), 3),
                "p95_ms": round(q(0.95), 3), "p99_ms": round(q(0.99), 3)}

    def batch_trace(self) -> dict:
        """The device calls so far: ``{"<kind>:<bucket>": count}`` (bucket =
        the padded batch size dispatched; pad waste = sum(bucket * count) -
        rows_run)."""
        with self._stats_lock:
            return {f"{kind}:{bucket}": int(c)
                    for (kind, bucket), c in sorted(self._batch_buckets.items())}

    def rank(self, feats, k: int = 5):
        """Same contract as :meth:`Ranker.rank`; blocks until the coalesced
        device call of this request's flush completes."""
        return self._submit("rank", tuple(np.asarray(x) for x in feats), k, None)

    def retrieve(self, mention_repr, k: int = 100, mode: Optional[str] = None,
                 expand: Optional[int] = None):
        """Same contract as :meth:`Ranker.retrieve`; concurrent queries with
        the same k / mode / expand coalesce into one scan of the table."""
        return self._submit("retrieve", (np.asarray(mention_repr, np.float32),), k,
                            (mode, expand))

    def rank_text(self, sentences, char_spans, candidate_texts, k: int = 5,
                  mention_images=None, tokenizer=None):
        """Tokenize on the calling thread, coalesce the resulting feature
        batches on the device."""
        return self.rank(self.ranker._text_feats(sentences, char_spans, candidate_texts,
                                                 mention_images, tokenizer), k)

    # -- dispatcher side -----------------------------------------------
    def _take_window(self):
        """Block for the first request, then drain for up to wait_ms /
        max_batch rows."""
        import queue

        first = self._q.get()
        if first is None:
            return None
        items = [first]
        rows = first.feats[0].shape[0]
        deadline = time.monotonic() + self.wait_s
        while rows < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                it = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if it is None:
                self._q.put(None)  # re-signal stop after this flush
                break
            items.append(it)
            rows += it.feats[0].shape[0]
        return items

    def _call(self, kind, batch, k, extra):
        if kind == "retrieve":
            mode, expand = extra
            return self.ranker.retrieve(batch[0], k, mode=mode, expand=expand)
        return self.ranker.rank(batch, k)

    def _count(self, kind, bucket, rows):
        with self._stats_lock:
            self._batches_run += 1
            self._rows_run += rows
            self._batch_buckets[(kind, bucket)] += 1

    def _done(self, req, result):
        req.fut.set_result(result)
        with self._stats_lock:
            self._latencies.append(time.monotonic() - req.t0)

    def _flush(self, items):
        # concatenation needs matching field shapes beyond the batch dim:
        # rank_text requests of different length buckets get calls of their own
        groups: dict = {}
        for req in items:
            key = (req.kind, req.k, req.extra, tuple(f.shape[1:] for f in req.feats))
            groups.setdefault(key, []).append(req)
        for (kind, k, extra, _), group in groups.items():
            sizes = [r.feats[0].shape[0] for r in group]
            try:
                n = sum(sizes)
                bucket = next(b for b in self.buckets if b >= n) if n <= self.max_batch else n
                batch = tuple(np.concatenate(col, axis=0) for col in zip(*[r.feats for r in group]))
                if bucket > n:  # pad by repeating row 0; sliced off below
                    batch = tuple(np.concatenate([c, np.repeat(c[:1], bucket - n, axis=0)])
                                  for c in batch)
                scores, idx = self._call(kind, batch, k, extra)
                self._count(kind, bucket, n)
                off = 0
                for req, sz in zip(group, sizes):
                    self._done(req, (scores[off : off + sz], idx[off : off + sz]))
                    off += sz
            except Exception:
                # retry one by one so that each future gets its own outcome;
                # requests the batched call already resolved are skipped, and
                # a future that cannot take its outcome must not strand the
                # window's other groups
                for req in group:
                    if req.fut.done():
                        continue
                    try:
                        out = self._call(kind, req.feats, k, extra)
                        self._count(kind, req.feats[0].shape[0], req.feats[0].shape[0])
                        self._done(req, out)
                    except Exception as e:
                        try:
                            req.fut.set_exception(e)
                        except Exception:
                            pass

    def _dispatch(self):
        while not self._stop:
            items = self._take_window()
            if items is None:
                return
            if self._flush_pool is None:
                self._flush(items)
                continue
            self._inflight.acquire()  # at most pipeline_depth flushes in flight

            def run(items=items):
                try:
                    self._flush(items)
                finally:
                    self._inflight.release()

            try:
                self._flush_pool.submit(run)
            except RuntimeError:
                # the pool was shut down by close() while this window was
                # taken: flush inline so its futures still resolve
                run()


# ---------------------------------------------------------------------------
# minimal HTTP wrapper


def _encode_arrays(arrays: dict) -> str:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return base64.b64encode(buf.getvalue()).decode()


def _decode_arrays(payload: str) -> dict:
    data = np.load(io.BytesIO(base64.b64decode(payload)), allow_pickle=False)
    return {k: data[k] for k in data.files}


def _batch_type(ranker: Ranker):
    if ranker.kind == "online":
        return OnlineBatch
    if ranker.kind == "drin":
        return DrinRowsBatch if ranker.store is not None else DrinBatch
    return BaselineRowsBatch if ranker.store is not None else BaselineBatch


def rank_feat_fields(ranker) -> list:
    """The positional feature-field names a ``/rank`` request carries for
    this ranker, a :class:`Ranker` or a :class:`BatchingRanker` front (its
    batch NamedTuple minus ``answer``)."""
    return list(_batch_type(getattr(ranker, "ranker", ranker))._fields[:-1])


def serve_http(ranker, host: str = "127.0.0.1", port: int = 8787,
               feat_fields: Optional[list] = None):
    """Start a JSON-over-HTTP server on a daemon thread.

    POST /rank      {"features": <b64 npz of the batch feature fields>, "k": 5}
    POST /rank_text {"sentences": [...], "spans": [[start, end], ...],
                     "candidates": [[...], ...], "k": 5}  (online model only;
                     character spans, one candidate list per sentence)
    POST /retrieve  {"query": <b64 npz {"q": [B, D]}>, "k": 100,
                     "mode": "exact" | "approx" | "int8", "expand": 4}
                    (stage-1 retrieval over the whole entity table)
                    -> {"scores": [[...]], "indices": [[...]]} for all three
    GET  /health    -> {"status": "ok", "model": ...}
    GET  /stats     -> deployment facts; behind a :class:`BatchingRanker`
                       also batches_run, rows_run, batch_buckets, latency

    ``ranker`` is a :class:`Ranker` or a :class:`BatchingRanker` (``/rank``,
    ``/rank_text`` and ``/retrieve`` all coalesce there).  A malformed
    request gets 400; a fault of the server (a ``RuntimeError`` such as no
    entity tables or a closed batcher, a device fault) gets 500.  Returns the
    server object, its front as ``server.front`` (call ``.shutdown()`` from
    another thread, then close the front).

    Over a row-sharded store, one process a rank of the store's model group
    (a mesh of one data row) calls ``serve_http``.  The group's first rank
    serves HTTP and leads (:meth:`Ranker.lead`); ``serve_http`` returns its
    server at once.  Every other rank follows (:meth:`Ranker.follow`):
    ``serve_http`` returns None there once the front stops it, and raises
    if its part of a call fails.  ``server.stop()`` shuts the front down and
    ends the followers.  A follower that fails makes the front answer 500,
    set ``server.fault`` and shut down (the CLI then exits non-zero);
    ``server.stopped`` is set once the front has shut down."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    fields = feat_fields
    base = getattr(ranker, "ranker", ranker)
    lockstep = base.store is not None and base.store.sharded and \
        collectives.group_size(base.store.mesh.model_group) > 1
    if lockstep:
        mesh = base.store.mesh
        if mesh.shape["data"] != 1:
            raise ValueError("a row-sharded Ranker serves over one model group: build its "
                             f"store on a mesh of one data row, got {mesh}")
        if mesh.model_index != 0:
            base.follow()
            return None
        base.lead()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok", "model": ranker.cfg.model_type})
            elif self.path == "/stats":
                out = {"model": ranker.cfg.model_type,
                       "dataset": ranker.cfg.dataset_name,
                       "micro_batched": base is not ranker,
                       "entity_rows": base.store.n_rows if base.store is not None else None,
                       "sharded_retrieval": base._sharded is not None,
                       "device": str(base.device)}
                if base is not ranker:
                    out["batches_run"] = ranker._batches_run
                    out["rows_run"] = ranker._rows_run
                    out["batch_buckets"] = ranker.batch_trace()
                    out["latency"] = ranker.latency_quantiles()
                self._reply(200, out)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/rank", "/rank_text", "/retrieve"):
                self._reply(404, {"error": "unknown path"})
                return
            try:
                # parse phase: any failure here is a malformed request, 400
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                k = int(req.get("k", 100 if self.path == "/retrieve" else 5))
                if self.path == "/rank_text":
                    sentences, spans, cands = req["sentences"], req["spans"], req["candidates"]
                    call = lambda: ranker.rank_text(sentences, spans, cands, k)
                elif self.path == "/retrieve":
                    q = _decode_arrays(req["query"])["q"]
                    mode, expand = req.get("mode"), req.get("expand")
                    expand = int(expand) if expand is not None else None
                    call = lambda: ranker.retrieve(q, k, mode=mode, expand=expand)
                else:
                    arrays = _decode_arrays(req["features"])
                    order = fields or sorted(arrays)
                    feats = tuple(arrays[name] for name in order)
                    call = lambda: ranker.rank(feats, k)
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                scores, idx = call()
                self._reply(200, {"scores": scores.tolist(), "indices": idx.tolist()})
            except REQUEST_ERRORS as e:
                # bad shapes, dtypes, modes or spans in a well-formed payload:
                # the request's fault
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except FollowerFault as e:  # the model group is broken: stop serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                server.fault = e
                # closed too: a later client is refused, never left waiting
                threading.Thread(target=server.stop, daemon=True).start()
            except Exception as e:  # serving must not die on a failed request
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    class Server(ThreadingHTTPServer):
        # the listen backlog (socketserver's default is 5): clients that
        # connect at once beyond it are reset before a thread can accept them
        request_queue_size = 128

        def stop(self):
            """Shut the front down and end the followers' loops."""
            self.shutdown()
            self.server_close()
            if lockstep and self.fault is None:
                base.stop_followers()

    server = Server((host, port), Handler)
    server.front = ranker
    server.fault = None
    server.stopped = threading.Event()

    def serve():
        try:
            server.serve_forever()
        finally:
            server.stopped.set()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    return server


def main(argv=None):
    """Deployment CLI: ``python -m drin_tpu_torch.serve`` stands up the HTTP
    service from a bundle (:meth:`Ranker.save_bundle`) or a port checkpoint
    (``<checkpoint_dir>/params.pt``)::

        python -m drin_tpu_torch.serve bundle=/path/to/bundle micro_batch=true \\
            device=cuda port=8787
        python -m drin_tpu_torch.serve model_type=drin dataset_name=wikimel \\
            checkpoint_dir=ckpt preprocess_dir=data/wikimel \\
            quantize_store=true fused_gather=true device=cuda port=8787
        python -m drin_tpu_torch.serve model_type=ghmfc dataset_name=wikimel \\
            checkpoint_dir=ckpt preprocess_dir=data/wikimel \\
            quantize_store=true fused_gather=true device=cuda
        python -m drin_tpu_torch.serve model_type=ghmfc dataset_name=wikimel \\
            online_bert=true bert_vocab=vocab.txt checkpoint_dir=ckpt \\
            preprocess_dir=data/wikimel device=cuda
        python -m drin_tpu_torch.serve model_type=melhi dataset_name=wikidiverse \\
            checkpoint_dir=ckpt device=cuda

    Serving keys: ``host``/``port``; ``device`` (default ``cuda``; raises
    when CUDA is absent); ``bundle`` (takes no Config overrides);
    ``micro_batch=true`` with ``wait_ms`` and ``max_batch`` (the
    :class:`BatchingRanker` front); ``quantize_store``, ``fused_gather``;
    ``project_entities`` (DRIN) and ``precompute_entities`` (offline GHMFC:
    :meth:`Ranker.precompute_entity_reprs`); ``quantize_retrieval=true`` and
    ``retrieve_expand=N`` (the int8 retrieval cache); ``shard_retrieval=true``
    (retrieval's table row-sharded over every visible CUDA device,
    :meth:`Ranker.shard_retrieval`, with ``quantize_retrieval``'s int8
    caches per shard).  ``shard_store=true`` with ``num_processes``,
    ``process_id``, ``coordinator_address`` (and ``dist_backend``; gloo for
    ranks that share a card) row-shards the rank-stage store over that many
    ranks, one command a rank: the first serves HTTP and leads the others
    (:func:`serve_http`)::

        python -m drin_tpu_torch.serve bundle=/path/to/bundle shard_store=true \
            num_processes=2 process_id=$RANK coordinator_address=127.0.0.1:29500 \
            dist_backend=gloo device=cuda port=8787

    Every other key is a Config override.  A WikiMEL server with the pooled entity cache loads
    the entity text table for an online model too: ``/retrieve`` scans it.
    Returns the server object; the ``__main__`` path blocks until
    interrupted."""
    from drin_tpu_torch.common.cli import parse_overrides
    from drin_tpu_torch.common.config import make_config

    overrides = parse_overrides(argv if argv is not None else sys.argv[1:])
    bundle = overrides.pop("bundle", None)
    host = overrides.pop("host", "127.0.0.1")
    port = int(overrides.pop("port", 8787))
    device = _check_device(overrides.pop("device", "cuda"))
    micro = overrides.pop("micro_batch", False)
    wait_ms = float(overrides.pop("wait_ms", 2.0))
    max_batch = int(overrides.pop("max_batch", 64))
    project = overrides.pop("project_entities", False)
    precompute = overrides.pop("precompute_entities", False)
    quant = overrides.pop("quantize_retrieval", False)
    shard = overrides.pop("shard_retrieval", False)
    expand = int(overrides.pop("retrieve_expand", 4))
    quantize_store = bool(overrides.pop("quantize_store", False))
    fused_gather = bool(overrides.pop("fused_gather", False))
    mesh = None
    if overrides.pop("shard_store", False):
        from drin_tpu_torch.parallel import distributed
        from drin_tpu_torch.parallel.mesh import make_mesh

        n, rank = int(overrides.pop("num_processes", 1)), int(overrides.pop("process_id", 0))
        distributed.initialize(coordinator_address=overrides.pop("coordinator_address", ""),
                               num_processes=n, process_id=rank,
                               backend=overrides.pop("dist_backend", None), device=device)
        device = distributed.local_device(device, rank)
        mesh = make_mesh(data=1, model=n) if n > 1 else None
    if bundle is not None:
        if overrides:
            raise SystemExit("bundle mode takes no config overrides, got: "
                             + ", ".join(sorted(overrides)))
        ranker = Ranker.from_bundle(bundle, device=device, quantize_store=quantize_store,
                                    fused_gather=fused_gather, store_mesh=mesh)
    else:
        model_type = overrides.pop("model_type", "drin")
        dataset_name = overrides.pop("dataset_name", "wikidiverse")
        cfg = make_config(model_type, dataset_name, **overrides)
        tables = None
        if cfg.dataset_name == "wikimel" and (cfg.entity_pooling_cached or mesh is not None):
            # an online model never reads the tables in its forward, but
            # /retrieve scans the pooled text table
            from drin_tpu_torch.data.dataset import load_wikimel_entity_tables

            kind = "drin" if cfg.model_type == "drin" else "baseline"
            tables = load_wikimel_entity_tables(cfg, include=include_for(kind))
        ranker = Ranker(cfg, entity_tables=tables, device=device, quantize_store=quantize_store,
                        fused_gather=fused_gather, store_mesh=mesh)
    if project:
        ranker.precompute_entity_projection()
    if precompute:
        ranker.precompute_entity_reprs()
    if shard:
        ranker.shard_retrieval(expand=expand, quantize=bool(quant))
    elif quant:
        ranker.quantize_retrieval(expand=expand)
    front = BatchingRanker(ranker, max_batch=max_batch, wait_ms=wait_ms) if micro else ranker
    if mesh is not None and mesh.model_index != 0:
        print(f"rank {mesh.rank} follows the front of its model group", flush=True)
    server = serve_http(front, host=host, port=port, feat_fields=rank_feat_fields(front))
    if server is None:  # a follower whose front has stopped
        return None
    print(f"serving {ranker.cfg.model_type}/{ranker.cfg.dataset_name} on {device} at "
          f"http://{host}:{server.server_address[1]}" + (" (micro-batched)" if micro else ""),
          flush=True)
    return server


def _serve_until_stopped(server) -> int:
    """Block until the front shuts down (an interrupt stops it and its
    followers); 1 when a follower failed."""
    try:
        server.stopped.wait()
    except KeyboardInterrupt:
        server.stop()
    return 1 if server.fault is not None else 0


if __name__ == "__main__":
    _srv = main()
    sys.exit(0 if _srv is None else _serve_until_stopped(_srv))
