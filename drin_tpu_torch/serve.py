# -*- coding: utf-8 -*-
"""Serving, the rank stage (port of ``drin_tpu/serve.py``).

  * :class:`Ranker` scores a request and returns top-k.  Two model families
    are ported: DRIN (a rows batch, mention features + [B, C] candidate row
    indices, against device-resident entity tables, or the full 14-field
    batch) and GHMFC with online BERT (the nine token-id fields of an
    ``OnlineBatch``: BERT runs inside the request).
  * :func:`serve_http` is the stdlib JSON-over-HTTP wrapper: POST /rank,
    GET /health and /stats, with the JAX server's status-code rules.
  * :func:`main` is the CLI, ``python -m drin_tpu_torch.serve``.

Everything runs under ``torch.inference_mode()``.  On CUDA the scalar-edge
GCN layer always runs the fused layer kernel, a fused store reads its int8
tables through the gather+dequant kernel and BERT's self-attention runs the
fused attention kernel from 256 tokens on; ``use_pallas`` and
``pallas_block_b`` are not read.  Not ported yet (ROADMAP): raw-text serving
(``rank_text``, ``/rank_text``), ``BatchingRanker``, retrieval, bundles, and
GHMFC over precomputed features with device entity tables
(``baseline_feats_fn``).
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
from drin_tpu_torch.data.device_store import (DeviceEntityStore, DrinRowsBatch, include_for,
                                              project_drin_tables)
from drin_tpu_torch.data.online import OnlineBatch
from drin_tpu_torch.models import get_model


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} but CUDA is not available; the port has "
                           "no CPU fallback (pass device=cpu to run on the CPU)")
    return device


class Ranker:
    """Mention-candidate ranking service over a port model (DRIN, or GHMFC
    with online BERT).

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
        # the raw host tables are kept only for DRIN's
        # precompute_entity_projection; any other kind would pin them for
        # the server's lifetime
        self._tables = entity_tables if self.kind == "drin" else None
        if entity_tables is not None and cfg.entity_pooling_cached:
            if self.kind == "baseline":
                raise NotImplementedError(
                    "GHMFC over precomputed features with device entity tables is not "
                    "ported yet (ROADMAP: baseline_feats_fn); serve it without "
                    "entity_tables, or serve DRIN or online-BERT GHMFC")
            self.store = DeviceEntityStore(cfg, entity_tables, device=self.device,
                                           dtype=self.dtype, quantize=quantize_store,
                                           fused_gather=fused_gather)
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

    def _feats_fn_for(self, store: DeviceEntityStore):
        """Rows batch -> model batch for DRIN.  The online model's requests
        carry token ids, never table rows: no feats_fn even with a store."""
        return store.drin_feats_fn() if self.kind == "drin" else None

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

    # ------------------------------------------------------------------
    def _prepare(self, feats) -> tuple:
        feats = tuple(feats)
        n = len(_batch_type(self)._fields) - 1
        if len(feats) != n:
            raise ValueError(f"expected {n} feature fields, got {len(feats)}")
        out = []
        for x in feats:
            t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            out.append(t.to(self.device, self.dtype) if t.is_floating_point()
                       else t.to(self.device))
        B = out[0].shape[0] if out[0].ndim else None
        if B is None or any(t.ndim == 0 or t.shape[0] != B for t in out):
            raise ValueError("every feature field needs the same leading batch dim, got "
                             f"{[tuple(t.shape) for t in out]}")
        if self._feats_fn is not None:
            rows, miet, mtei = out[7], out[8], out[9]
            if rows.ndim != 2 or miet.shape != rows.shape or mtei.shape != rows.shape:
                raise ValueError("entity_rows, miet_similarity and mtei_similarity must "
                                 f"share one [B, C] shape, got {tuple(rows.shape)}, "
                                 f"{tuple(miet.shape)}, {tuple(mtei.shape)}")
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
    return BaselineBatch


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


_NOT_PORTED = ("bundle", "micro_batch", "wait_ms", "max_batch", "precompute_entities",
               "quantize_retrieval", "shard_retrieval", "retrieve_expand")


def main(argv=None):
    """Deployment CLI: ``python -m drin_tpu_torch.serve`` stands up the HTTP
    ranking service from a port checkpoint (``<checkpoint_dir>/params.pt``)::

        python -m drin_tpu_torch.serve model_type=drin dataset_name=wikimel \\
            checkpoint_dir=ckpt preprocess_dir=data/wikimel \\
            quantize_store=true fused_gather=true device=cuda port=8787
        python -m drin_tpu_torch.serve model_type=ghmfc dataset_name=wikimel \\
            online_bert=true checkpoint_dir=ckpt device=cuda

    Serving keys: ``host``/``port``, ``device`` (default ``cuda``; raises
    when CUDA is absent), ``quantize_store``, ``fused_gather`` and
    ``project_entities``; every other key is a Config override.  Returns
    the server object; the ``__main__`` path blocks until interrupted."""
    from drin_tpu_torch.common.cli import parse_overrides
    from drin_tpu_torch.common.config import make_config

    overrides = parse_overrides(argv if argv is not None else sys.argv[1:])
    unported = sorted(k for k in overrides if k in _NOT_PORTED)
    if unported:
        raise SystemExit(f"not ported yet: {', '.join(unported)} (ROADMAP: BatchingRanker, "
                         "retrieval, bundles, offline-GHMFC entity precompute, raw-text "
                         "serving; ported: DRIN and online-BERT GHMFC behind /rank)")
    host = overrides.pop("host", "127.0.0.1")
    port = int(overrides.pop("port", 8787))
    device = _check_device(overrides.pop("device", "cuda"))
    project = overrides.pop("project_entities", False)
    quantize_store = overrides.pop("quantize_store", False)
    fused_gather = overrides.pop("fused_gather", False)
    model_type = overrides.pop("model_type", "drin")
    dataset_name = overrides.pop("dataset_name", "wikidiverse")
    cfg = make_config(model_type, dataset_name, **overrides)
    tables = None
    # the online model reads entity text from the request, not from tables
    if cfg.dataset_name == "wikimel" and cfg.entity_pooling_cached and not cfg.online_bert:
        from drin_tpu_torch.data.dataset import load_wikimel_entity_tables

        tables = load_wikimel_entity_tables(cfg, include=include_for("drin" if cfg.model_type == "drin" else "baseline"))
    ranker = Ranker(cfg, entity_tables=tables, device=device,
                    quantize_store=bool(quantize_store), fused_gather=bool(fused_gather))
    if project:
        ranker.precompute_entity_projection()
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
