# -*- coding: utf-8 -*-
"""Serving, the rank stage (port of ``drin_tpu/serve.py``).

  * :class:`Ranker` scores a request and returns top-k, for every model
    family: DRIN and offline GHMFC (a rows batch, mention features + [B, C]
    candidate row indices, against device-resident entity tables, or the
    full batch), MELHI (the full 8-field baseline batch) and GHMFC with
    online BERT (the nine token-id fields of an ``OnlineBatch``: BERT runs
    inside the request).  Offline GHMFC can also encode the whole entity
    table once (:meth:`Ranker.precompute_entity_reprs`) and then rank by
    mention encoding, row gather and cosine (:meth:`Ranker.rank_rows`).
  * :func:`serve_http` is the stdlib JSON-over-HTTP wrapper: POST /rank,
    GET /health and /stats, with the JAX server's status-code rules.
  * :func:`main` is the CLI, ``python -m drin_tpu_torch.serve``.

Everything runs under ``torch.inference_mode()``.  On CUDA the scalar-edge
GCN layer always runs the fused layer kernel, a fused store reads its int8
tables through the gather+dequant kernel and BERT's self-attention runs the
fused attention kernel from 256 tokens on; ``use_pallas`` and
``pallas_block_b`` are not read.  Not ported yet (ROADMAP): raw-text serving
(``rank_text``, ``/rank_text``), ``BatchingRanker``, retrieval and bundles.
"""

from __future__ import annotations

import base64
import io
import json
import os
import sys
import threading
from typing import Mapping, Optional

import numpy as np
import torch

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.data.dataset import BaselineBatch, DrinBatch
from drin_tpu_torch.data.device_store import (BaselineRowsBatch, DeviceEntityStore,
                                              DrinRowsBatch, include_for, project_drin_tables)
from drin_tpu_torch.data.online import OnlineBatch
from drin_tpu_torch.models import get_model
from drin_tpu_torch.ops.core import cosine_similarity
from drin_tpu_torch.ops.cuda.gather import sanitize_rows


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} but CUDA is not available; the port has "
                           "no CPU fallback (pass device=cpu to run on the CPU)")
    return device


class Ranker:
    """Mention-candidate ranking service over a port model (DRIN, GHMFC
    offline or with online BERT, MELHI).

    ``params`` is a port state_dict (tensors or numpy arrays); without it
    the weights come from ``<checkpoint_dir>/params.pt`` (``torch.save``
    of a state_dict).  Parameters are cast to ``cfg.compute_dtype`` on
    ``device``.  ``bert_cfg`` overrides the online model's bert-base
    dimensions."""

    def __init__(self, cfg: Config, params: Optional[Mapping] = None,
                 entity_tables: Optional[dict] = None, checkpoint_dir: Optional[str] = None,
                 *, device, quantize_store: bool = False, fused_gather: bool = False,
                 bert_cfg=None):
        self.cfg = cfg
        self.device = _check_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        self._bert_cfg = bert_cfg
        if params is None:
            params = self._restore(checkpoint_dir or cfg.checkpoint_dir)
        self.model, self.kind = self._build_model(cfg, params)
        self.store = None
        self._feats_fn = None
        self._entity_reprs = None
        # the raw host tables are kept only for DRIN's
        # precompute_entity_projection; any other kind would pin them for
        # the server's lifetime
        self._tables = entity_tables if self.kind == "drin" else None
        if entity_tables is not None and cfg.entity_pooling_cached:
            if fused_gather and cfg.model_type not in ("drin", "ghmfc"):
                raise ValueError("fused_gather packs the DRIN or GHMFC table layouts; "
                                 f"model_type={cfg.model_type} uses the standard quantized store")
            # GHMFC reads the text table alone: the image and object tables
            # are never uploaded for it
            self.store = DeviceEntityStore(cfg, entity_tables, device=self.device,
                                           dtype=self.dtype, quantize=quantize_store,
                                           fused_gather=fused_gather,
                                           include=include_for(self.kind))
            self._feats_fn = self._feats_fn_for(self.store)
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
        projection reads; None makes a projection fail loudly)."""
        self.store = store
        self._feats_fn = self._feats_fn_for(store)
        self._tables = entity_tables if self.kind == "drin" else None
        self._entity_reprs = None  # encoded from the old tables: rank_rows must refuse

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
        self.store = DeviceEntityStore(self.cfg, proj, device=self.device, dtype=self.dtype,
                                       quantize=self.store is not None and self.store.quantized,
                                       fused_gather=self.store is not None and self.store.fused)
        self._feats_fn = self.store.drin_feats_fn()
        self._tables = proj

    def precompute_entity_reprs(self, chunk: int = 8192) -> np.ndarray:
        """Offline GHMFC's serving fast path: its entity tower reads only the
        entity tables, so with the weights frozen the whole table is encoded
        once, ``chunk`` rows at a time (a quantized store dequantizes one
        chunk, never the table), into [N, D] representations.  A request
        then costs a mention encoding, a row gather and a cosine
        (:meth:`rank_rows`).  Returns the representations as float32."""
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
            return self._entity_reprs.float().cpu().numpy()

    def rank_rows(self, mention_feats, rows, k: int = 5):
        """(top-k scores, top-k candidate indices) against the precomputed
        entity representations: ``mention_feats`` are the rows batch's five
        mention fields, ``rows`` [B, C] its table rows (negatives wrap once,
        the rest clamp, as in the store).  Call
        :meth:`precompute_entity_reprs` first."""
        assert self._entity_reprs is not None, "call precompute_entity_reprs() first"
        with torch.inference_mode():
            feats = self._check_batch([self._to_device(x) for x in mention_feats] +
                                      [self._to_device(rows)])
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
    def _to_device(self, x) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return t.to(self.device, self.dtype) if t.is_floating_point() else t.to(self.device)

    @staticmethod
    def _check_batch(out: list) -> list:
        B = out[0].shape[0] if out[0].ndim else None
        if B is None or any(t.ndim == 0 or t.shape[0] != B for t in out):
            raise ValueError("every feature field needs the same leading batch dim, got "
                             f"{[tuple(t.shape) for t in out]}")
        return out

    def _prepare(self, feats) -> tuple:
        feats = tuple(feats)
        n = len(_batch_type(self)._fields) - 1
        if len(feats) != n:
            raise ValueError(f"expected {n} feature fields, got {len(feats)}")
        out = self._check_batch([self._to_device(x) for x in feats])
        if self._feats_fn is not None and self.kind == "drin":
            rows, miet, mtei = out[7], out[8], out[9]
            if rows.ndim != 2 or miet.shape != rows.shape or mtei.shape != rows.shape:
                raise ValueError("entity_rows, miet_similarity and mtei_similarity must "
                                 f"share one [B, C] shape, got {tuple(rows.shape)}, "
                                 f"{tuple(miet.shape)}, {tuple(mtei.shape)}")
        elif self._feats_fn is not None and out[5].ndim != 2:
            raise ValueError(f"entity_rows must be [B, C], got {tuple(out[5].shape)}")
        return tuple(out)

    def _scores(self, feats) -> torch.Tensor:
        feats = self._prepare(feats)
        if self._feats_fn is not None:
            feats = self._feats_fn(feats)
        return self.model(feats).float()

    def score(self, feats) -> np.ndarray:
        """Raw candidate scores [B, C] for a feature tuple (the batch fields
        of :func:`rank_feat_fields`, in order)."""
        with torch.inference_mode():
            return self._scores(feats).cpu().numpy()

    def rank(self, feats, k: int = 5):
        """(top-k scores, top-k candidate indices) per mention."""
        with torch.inference_mode():
            s = self._scores(feats)
            if not 0 <= k <= s.shape[-1]:
                raise ValueError(f"k must be in [0, {s.shape[-1]}], got {k}")
            vals, idx = torch.topk(s, k, dim=-1)
            return vals.cpu().numpy(), idx.cpu().numpy()


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


def rank_feat_fields(ranker: Ranker) -> list:
    """The positional feature-field names a ``/rank`` request carries for
    this ranker (its batch NamedTuple minus ``answer``)."""
    return list(_batch_type(ranker)._fields[:-1])


def serve_http(ranker: Ranker, host: str = "127.0.0.1", port: int = 8787,
               feat_fields: Optional[list] = None):
    """Start a JSON-over-HTTP server on a daemon thread.

    POST /rank   {"features": <b64 npz of the batch feature fields>, "k": 5}
                 -> {"scores": [[...]], "indices": [[...]]}
    GET  /health -> {"status": "ok", "model": ...}
    GET  /stats  -> deployment facts

    A malformed request gets 400, a server fault 500.  Returns the server
    object (call ``.shutdown()`` from another thread)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    fields = feat_fields

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
                self._reply(200, {"model": ranker.cfg.model_type,
                                  "dataset": ranker.cfg.dataset_name,
                                  "micro_batched": False,
                                  "entity_rows": (ranker.store.n_rows
                                                  if ranker.store is not None else None),
                                  "sharded_retrieval": False,
                                  "device": str(ranker.device)})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/rank":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                # parse phase: any failure here is a malformed request, 400
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                arrays = _decode_arrays(req["features"])
                order = fields or sorted(arrays)
                feats = tuple(arrays[name] for name in order)
                k = int(req.get("k", 5))
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                scores, idx = ranker.rank(feats, k)
                self._reply(200, {"scores": scores.tolist(), "indices": idx.tolist()})
            except (KeyError, ValueError, TypeError, AssertionError, IndexError) as e:
                # bad shapes/dtypes in a well-formed payload: the request's fault
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # serving must not die on a failed request
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


_NOT_PORTED = ("bundle", "micro_batch", "wait_ms", "max_batch", "quantize_retrieval",
               "shard_retrieval", "retrieve_expand")


def main(argv=None):
    """Deployment CLI: ``python -m drin_tpu_torch.serve`` stands up the HTTP
    ranking service from a port checkpoint (``<checkpoint_dir>/params.pt``)::

        python -m drin_tpu_torch.serve model_type=drin dataset_name=wikimel \\
            checkpoint_dir=ckpt preprocess_dir=data/wikimel \\
            quantize_store=true fused_gather=true device=cuda port=8787
        python -m drin_tpu_torch.serve model_type=ghmfc dataset_name=wikimel \\
            checkpoint_dir=ckpt preprocess_dir=data/wikimel \\
            quantize_store=true fused_gather=true device=cuda
        python -m drin_tpu_torch.serve model_type=ghmfc dataset_name=wikimel \\
            online_bert=true checkpoint_dir=ckpt device=cuda
        python -m drin_tpu_torch.serve model_type=melhi dataset_name=wikidiverse \\
            checkpoint_dir=ckpt device=cuda

    Serving keys: ``host``/``port``, ``device`` (default ``cuda``; raises
    when CUDA is absent), ``quantize_store``, ``fused_gather``,
    ``project_entities`` (DRIN) and ``precompute_entities`` (offline GHMFC:
    :meth:`Ranker.precompute_entity_reprs`); every other key is a Config
    override.  Returns the server object; the ``__main__`` path blocks until
    interrupted."""
    from drin_tpu_torch.common.cli import parse_overrides
    from drin_tpu_torch.common.config import make_config

    overrides = parse_overrides(argv if argv is not None else sys.argv[1:])
    unported = sorted(k for k in overrides if k in _NOT_PORTED)
    if unported:
        raise SystemExit(f"not ported yet: {', '.join(unported)} (ROADMAP: BatchingRanker, "
                         "retrieval, bundles, raw-text serving; ported: DRIN, GHMFC offline "
                         "and with online BERT, and MELHI behind /rank)")
    host = overrides.pop("host", "127.0.0.1")
    port = int(overrides.pop("port", 8787))
    device = _check_device(overrides.pop("device", "cuda"))
    project = overrides.pop("project_entities", False)
    precompute = overrides.pop("precompute_entities", False)
    quantize_store = overrides.pop("quantize_store", False)
    fused_gather = overrides.pop("fused_gather", False)
    model_type = overrides.pop("model_type", "drin")
    dataset_name = overrides.pop("dataset_name", "wikidiverse")
    cfg = make_config(model_type, dataset_name, **overrides)
    tables = None
    # the online model reads entity text from the request, not from tables
    if cfg.dataset_name == "wikimel" and cfg.entity_pooling_cached and not cfg.online_bert:
        from drin_tpu_torch.data.dataset import load_wikimel_entity_tables

        kind = "drin" if cfg.model_type == "drin" else "baseline"
        tables = load_wikimel_entity_tables(cfg, include=include_for(kind))
    ranker = Ranker(cfg, entity_tables=tables, device=device,
                    quantize_store=bool(quantize_store), fused_gather=bool(fused_gather))
    if project:
        ranker.precompute_entity_projection()
    if precompute:
        ranker.precompute_entity_reprs()
    server = serve_http(ranker, host=host, port=port, feat_fields=rank_feat_fields(ranker))
    print(f"serving {cfg.model_type}/{cfg.dataset_name} on {device} at "
          f"http://{host}:{server.server_address[1]}", flush=True)
    return server


if __name__ == "__main__":
    _srv = main()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        _srv.shutdown()
