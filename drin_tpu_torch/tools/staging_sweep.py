# -*- coding: utf-8 -*-
"""Time a DRIN rank request's input staging on the card's host, piece by
piece, and the pinned stager end to end at several chunk sizes.

The request is the WikiMEL rank batch at B=64 (``drin-rank-b64``'s ten
fields, float32 and integer host arrays, ~52.5 MB); eight distinct requests
are cycled, so that no request is in the host's caches when it is copied.
Timed, each a median of host-clock calls that end in a synchronise:

  * ``pageable``: ``torch.as_tensor(x).to(device)`` field by field, the
    copies the ranker made before the pinned stager;
  * ``copyto_1thread``: ``np.copyto`` of the fields into a pinned arena at
    their aligned offsets (one thread);
  * ``aten_copy``: the same with ATen's ``copy_`` from ``torch.from_numpy``
    (the intra-op thread pool);
  * ``pinned_dma``: the whole pinned arena to the device, one copy;
  * ``fill_<MB>``: the ATen copies in pieces of that many MB, as the stager
    makes them, with no copy to the device;
  * ``dma_<MB>``: the pinned arena to the device in copies of that many MB;
  * ``stager_<MB>``: ``PinnedStager.stage`` with ``CHUNK_BYTES`` set to that
    many MB; and the same for the online GHMFC request at B=8 (nine fields,
    ~3.8 MB) against its pageable copies.

Run by hand from the repository's root on a machine with a card; no entry
point imports it::

    python -m drin_tpu_torch.tools.staging_sweep

It prints the card's name and power limit, the host's thread counts, each
time in ms with its rate in GB/s, and a last line of JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from drin_tpu_torch.data import staging

REPS = 20
CHUNKS_MB = (2, 4, 8, 16, 32, 64)


def drin_request(rng, B=64, L=128, D=768, R=49, Dr=2048, Tm=4, C=101, N=109557):
    """The ten rank fields of a DRIN rows batch at WikiMEL's widths."""
    lens = rng.integers(6, L + 1, B)
    start = rng.integers(1, 4, B)
    return (rng.standard_normal((B, L, D), dtype=np.float32),
            (np.arange(L)[None] < lens[:, None]).astype(np.int64),
            start.astype(np.int64), (start + 1).astype(np.int64),
            rng.standard_normal((B, R, Dr), dtype=np.float32),
            rng.standard_normal((B, Tm, Dr), dtype=np.float32),
            rng.uniform(0, 1, (B, Tm)).astype(np.float32),
            rng.integers(0, N, (B, C)).astype(np.int32),
            rng.uniform(0, 40, (B, C)).astype(np.float32),
            rng.uniform(0, 40, (B, C)).astype(np.float32))


def online_request(rng, B=8, Lm=128, R=49, Dr=2048, S=12, L=384, E=9, V=30522):
    """The nine rank fields of an online GHMFC zipped batch (bucket 384)."""
    ids = lambda *shape: rng.integers(0, V, shape).astype(np.int64)
    return (ids(B, Lm), np.ones((B, Lm), np.int64), np.ones(B, np.int64), np.full(B, 2),
            rng.standard_normal((B, R, Dr), dtype=np.float32), ids(B, S, L),
            np.ones((B, S, L), np.int64), rng.integers(0, L, (B, S, E)).astype(np.int64),
            np.zeros(B, np.float32))


def timed(fn, requests, reps=REPS) -> float:
    """Median ms of ``fn(request)`` followed by a synchronise, over requests
    cycled (one warm-up call each first)."""
    for req in requests:
        fn(req)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t = time.perf_counter()
        fn(requests[i % len(requests)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}; host cores {os.cpu_count()}, affinity "
          f"{len(os.sched_getaffinity(0))}, intra-op threads {torch.get_num_threads()}")
    rng = np.random.default_rng(0)
    reqs = [drin_request(rng) for _ in range(8)]
    offs, end = [], 0
    for x in reqs[0]:
        off = -(-end // staging.ALIGN) * staging.ALIGN
        offs.append(off)
        end = off + x.nbytes
    arena = torch.empty(end, dtype=torch.uint8, pin_memory=True)
    arena_np = arena.numpy()
    dst = [arena_np[o:o + x.nbytes].view(x.dtype).reshape(x.shape) for o, x in zip(offs, reqs[0])]
    dst_t = [torch.from_numpy(d) for d in dst]
    buf = torch.empty(end, dtype=torch.uint8, device=dev)
    mb = sum(x.nbytes for x in reqs[0]) / 1e6

    def copyto(req):
        for d, x in zip(dst, req):
            np.copyto(d, x)

    def aten(req):
        for d, x in zip(dst_t, req):
            d.copy_(torch.from_numpy(x))

    def fill(req, chunk):
        for d, x in zip(dst_t, req):
            x = torch.from_numpy(x)
            step = -(-x.shape[0] // -(-d.nbytes // chunk))
            for r in range(0, x.shape[0], step):
                d[r:r + step].copy_(x[r:r + step])

    def dma(chunk):
        for lo in range(0, end, chunk):
            buf[lo:lo + chunk].copy_(arena[lo:lo + chunk], non_blocking=True)

    out = {"device": smi, "request_mb": mb, "threads": torch.get_num_threads(),
           "pageable": timed(lambda r: [torch.as_tensor(x).to(dev) for x in r], reqs),
           "copyto_1thread": timed(copyto, reqs), "aten_copy": timed(aten, reqs),
           "pinned_dma": timed(lambda r: buf.copy_(arena, non_blocking=True), reqs)}
    for c in CHUNKS_MB:
        out[f"fill_{c}"] = timed(lambda r: fill(r, c << 20), reqs)
        out[f"dma_{c}"] = timed(lambda r: dma(c << 20), reqs)
    stager = staging.PinnedStager(dev)
    chunk = staging.CHUNK_BYTES
    try:
        for c in CHUNKS_MB:
            staging.CHUNK_BYTES = c << 20
            out[f"stager_{c}"] = timed(lambda r: stager.stage(r, torch.float32), reqs)
    finally:
        staging.CHUNK_BYTES = chunk
    online = [online_request(rng) for _ in range(8)]
    omb = sum(np.asarray(x).nbytes for x in online[0]) / 1e6
    out["online_mb"] = omb
    out["online_pageable"] = timed(lambda r: [torch.as_tensor(x).to(dev) for x in r], online)
    out["online_stager"] = timed(lambda r: stager.stage(r, torch.float32), online)
    for k, ms in out.items():
        if k.startswith(("pageable", "copyto", "aten", "pinned", "fill", "dma", "stager")):
            print(f"{k:>16}: {ms:8.3f} ms, {mb / ms:6.2f} GB/s")
        elif k.startswith("online_") and k != "online_mb":
            print(f"{k:>16}: {ms:8.3f} ms, {omb / ms:6.2f} GB/s")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
