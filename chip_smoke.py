#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch / CUDA port (``drin_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds both CUDA kernels from ``drin_tpu_torch/csrc`` (nvcc, sm_90a), holds
each against its plain PyTorch version on the card, then drives the rank
stage at the full WikiMEL width: a ``Ranker`` over an int8 fused store of
32,768 synthetic entities with seeded random weights, served by
``serve_http``.  It checks the answers against the port's float32 forward on
the CPU, shows through the launch counters that the served path ran both
kernels, and prints times measured with CUDA events.

Without CUDA, or without the repository around it, it exits non-zero and
prints no result.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import urllib.request

N_ENTITIES = 32768
SEED = 0
# kernel 1 vs plain, bf16 outputs: both sum exact bf16 products in f32 but in
# another order, so a value may round to the neighbouring bf16 (2 ulps
# relative = 1.6e-2) and values near 0 get an absolute floor
GCN_BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)
GCN_F32_TOL = dict(atol=1e-4, rtol=1e-4)  # f32 summation order only
# served bf16 scores vs the port's f32 CPU forward on the same int8 tables:
# bf16 keeps 8 mantissa bits and the forward rounds at every layer
SCORE_ATOL = 5e-2


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event-timed calls of ``fn``, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 10) -> float:
    """Median wall time of ``fn`` (which ends in a host copy), in ms."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def outside(got, want, atol, rtol) -> int:
    """How many values of ``got`` lie outside the tolerance around ``want``."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def check_close(name, got, want, atol, rtol) -> float:
    import torch

    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    err = (got.float() - want.float()).abs().max().item()
    bad = outside(got, want, atol, rtol)
    assert not bad, f"{name}: {bad} values outside atol={atol} rtol={rtol}; max abs err {err:.3g}"
    return err


def phase_gather(torch, gather):
    """Kernel 2 against gather_dequant_plain, both on the card, WikiMEL widths."""
    chunks = ((1536, 2), (2048, 1), (2048, 1))
    _, _, m = gather._slot_subrows(chunks)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    table = torch.randint(-127, 128, (N_ENTITIES, m, 128), generator=g, device="cuda",
                          dtype=torch.int8)
    scales = torch.rand((N_ENTITIES, m), generator=g, device="cuda") * 0.05 + 1e-3
    rows = torch.randint(0, N_ENTITIES, (64, 101), generator=g, device="cuda", dtype=torch.int32)
    rows[0, :4] = torch.tensor([-1, -N_ENTITIES, N_ENTITIES, N_ENTITIES + 99], dtype=torch.int32)
    rows[1, :2] = torch.tensor([-5 * N_ENTITIES, 2**31 - 1], dtype=torch.int32)
    err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        got = gather.gather_dequant(table, scales, rows, chunks, dt)
        want = gather.gather_dequant_plain(table, scales, rows, chunks, dt)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.shape == b.shape == (64, 101, a.shape[-1]), (a.shape, b.shape)
            assert torch.equal(a, b), f"gather_dequant {dt}: kernel != plain"
            err = max(err, (a.float() - b.float()).abs().max().item())
    empty = gather.gather_dequant(table, scales, rows[:, :0], chunks, torch.bfloat16)
    assert [tuple(e.shape) for e in empty] == [(64, 0, w) for w, _ in chunks]
    try:
        gather.gather_dequant(table, scales, rows.float(), chunks, torch.bfloat16)
        raise AssertionError("float rows were accepted")
    except TypeError:
        pass
    ms = cuda_ms(lambda: gather.gather_dequant(table, scales, rows, chunks, torch.bfloat16))
    plain_ms = cuda_ms(lambda: gather.gather_dequant_plain(table, scales, rows, chunks,
                                                           torch.bfloat16))
    print(f"[gather_dequant] N={N_ENTITIES} rows=[64,101] m={m}: bit-equal to plain "
          f"(bf16, f32, bad indices, R=0); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    del table, scales
    return err, ms, plain_ms


def _gcn_inputs(torch, B, C, D, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda *s: torch.rand(*s, generator=g, device="cuda")
    w = lambda *s, scale=1.0: ((u(*s) * 2 - 1) * scale * D ** -0.5).to(dt)
    # At the init scale the edge fold, (p.v + s)/D with p = (u.Ku + bu).Kv^T and
    # s = (u.Ku + bu).bv, moves a sigmoid edge by ~0.003, under the bf16
    # tolerance, so a wrong fold would pass.  Ku, bu, Kv and bv are scaled so
    # that p.v/D spreads by ~1 and s/D by ~0.5 at any D.
    fold = 3 ** 0.5 * D ** 0.25
    vertexes = [r(B, D).to(dt), r(B, D).to(dt), r(B, C, D).to(dt), r(B, C, D).to(dt)]
    edges = [u(B, C).to(dt) for _ in range(4)]
    weights = [w(D, D), w(D), (1 + 0.1 * r(D)).to(dt), (0.1 * r(D)).to(dt),
               w(D, D, scale=fold), w(D, scale=fold), w(D, D, scale=fold),
               w(D, scale=1.5 * D / fold)]
    return vertexes, edges, weights


def _fold_faults(torch, weights, D):
    """Dynamic-edge weights (Ku, bu, Kv, bv) under which the plain layer folds
    the edges the way a faulty kernel would: p zeroed, s dropped, and where D
    spans several of the kernel's 64-column tiles, p's tiles rotated and one
    tile's partial of s dropped."""
    wu, bu, wv, bv = weights[4:]
    faults = {"p zeroed": (wu, bu, torch.zeros_like(wv), bv),
              "s dropped": (wu, bu, wv, torch.zeros_like(bv))}
    if D > 64 and D % 64 == 0:
        faults["p tiles rotated"] = (wu, bu, wv.view(D, D // 64, 64).roll(1, 1).reshape(D, D), bv)
        faults["one s partial dropped"] = (wu, bu, wv, torch.cat([torch.zeros_like(bv[:64]),
                                                                   bv[64:]]))
    return faults


def phase_gcn(torch, gcn):
    """Kernel 1 against gcn_layer_plain, both on the card.  For dynamic edges
    the check must also fail each planted fault of the fold."""
    from drin_tpu_torch.nn.layers import get_activation

    cases = [(64, 101, 768, torch.bfloat16, "gelu", "sigmoid", True),   # the main path
             (64, 101, 768, torch.bfloat16, "gelu", "sigmoid", False),
             (8, 101, 768, torch.float32, "gelu", "sigmoid", True),
             (4, 11, 32, torch.bfloat16, "relu", "tanh", True),
             (4, 11, 32, torch.float32, "tanh", "identity", True),
             (4, 11, 32, torch.float32, "sigmoid", "relu", False)]
    main_err = None
    for i, (B, C, D, dt, vact, eact, dyn) in enumerate(cases):
        vertexes, edges, weights = _gcn_inputs(torch, B, C, D, dt, SEED + i)
        kw = dict(vact=vact, eact=eact, dynamic=dyn)
        with torch.inference_mode():
            got_v, got_e = gcn.fused_gcn_layer(vertexes, edges, *weights, **kw)
            want_v, want_e = gcn.gcn_layer_plain(vertexes, edges, *weights, **kw)
        torch.cuda.synchronize()
        tol = GCN_BF16_TOL if dt == torch.bfloat16 else GCN_F32_TOL
        err = max(check_close(f"gcn_layer {n}", a, b, **tol)
                  for n, a, b in zip(("mt", "mi", "et", "ei", "tt", "ti", "it", "ii"),
                                     got_v + got_e, want_v + want_e))
        print(f"[gcn_layer] B={B} C={C} D={D} {str(dt)[6:]} {vact}/{eact} "
              f"{'dynamic' if dyn else 'static'}: max abs err {err:.3g} (tol {tol})")
        if dyn:
            ea = get_activation(eact)
            signal = max((b.float() - ea(e.float())).abs().max().item()
                         for b, e in zip(want_e, edges))
            seen = {}
            for fault, fw in _fold_faults(torch, weights, D).items():
                with torch.inference_mode():
                    _, bad_e = gcn.gcn_layer_plain(vertexes, edges, *weights[:4], *fw, **kw)
                seen[fault] = sum(outside(a, b, **tol) for a, b in zip(bad_e, want_e))
                assert seen[fault], f"gcn_layer: the edge check cannot see a fold with {fault}"
            print(f"[gcn_layer]   the fold moves edges by up to {signal:.3g}; edges a planted "
                  f"fault puts outside tol: {seen}")
        if i == 0:
            main_err = err
            with torch.inference_mode():
                ms = cuda_ms(lambda: gcn.fused_gcn_layer(vertexes, edges, *weights, **kw))
                plain_ms = cuda_ms(lambda: gcn.gcn_layer_plain(vertexes, edges, *weights, **kw))
            print(f"[gcn_layer] B=64 C=101 D=768 bf16 layer call: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
    return main_err, ms, plain_ms


def _tables(np, cfg, n):
    rng = np.random.default_rng(SEED)
    D, Dr, Te = cfg.bert_embed_dim, cfg.resnet_embed_dim, cfg.entity_object_topk
    return {"entity_text_feature": rng.standard_normal((n, 2, D), dtype=np.float32),
            "entity_image_feature": rng.standard_normal((n, 1, Dr), dtype=np.float32),
            "entity_object_feature": rng.standard_normal((n, Te, 1, Dr), dtype=np.float32),
            "entity_object_score": rng.uniform(0, 1, (n, Te)).astype(np.float32)}


def _rows_batch(np, cfg, B, seed):
    rng = np.random.default_rng(seed)
    C, L, D = cfg.num_candidates_model, cfg.max_mention_sentence_len, cfg.bert_embed_dim
    R, Dr, Tm = cfg.resnet_num_region, cfg.resnet_embed_dim, cfg.mention_object_topk
    lens = rng.integers(6, L, size=B)
    start = rng.integers(1, 4, size=B)
    return (rng.standard_normal((B, L, D), dtype=np.float32),
            (np.arange(L)[None] < lens[:, None]).astype(np.int64),
            start.astype(np.int64),
            (start + rng.integers(1, 3, size=B)).astype(np.int64),
            rng.standard_normal((B, R, Dr), dtype=np.float32),
            rng.standard_normal((B, Tm, Dr), dtype=np.float32),
            rng.uniform(0, 1, (B, Tm)).astype(np.float32),
            rng.integers(0, N_ENTITIES, (B, C)).astype(np.int32),
            rng.uniform(0, 40, (B, C)).astype(np.float32),
            rng.uniform(0, 40, (B, C)).astype(np.float32))


def phase_slice(torch, np, gather, gcn):
    """The rank stage through its entry points, at the full WikiMEL width."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.models.drin import DRIN
    from drin_tpu_torch.serve import Ranker, _encode_arrays, rank_feat_fields, serve_http

    cfg = make_config("drin", "wikimel", compute_dtype="bfloat16")
    weights = DRIN(cfg, generator=torch.Generator().manual_seed(SEED)).state_dict()
    tables = _tables(np, cfg, N_ENTITIES)
    t0 = time.perf_counter()
    ranker = Ranker(cfg, weights, tables, device="cuda", quantize_store=True, fused_gather=True)
    torch.cuda.synchronize()
    print(f"[slice] Ranker(quantize_store, fused_gather) on cuda: N={ranker.store.n_rows}, "
          f"resident {ranker.store.nbytes / 2**20:.1f} MiB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    reference = Ranker(cfg.replace(compute_dtype="float32"), weights, tables, device="cpu",
                       quantize_store=True, fused_gather=True)
    fields = rank_feat_fields(ranker)
    batches = {B: _rows_batch(np, cfg, B, SEED + B) for B in (1, 8, 64)}
    server = serve_http(ranker, port=0, feat_fields=fields)
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(feats, k=5):
        body = json.dumps({"features": _encode_arrays(dict(zip(fields, feats))), "k": k})
        req = urllib.request.Request(url + "/rank", data=body.encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200, resp.status
            out = json.loads(resp.read())
        return np.asarray(out["scores"]), np.asarray(out["indices"])

    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        # the main path, counted: /rank at B=1 and B=8, Ranker.rank at B=64
        gather.launches = 0
        gcn.launches = 0
        served = {1: post(batches[1]), 8: post(batches[8]), 64: ranker.rank(batches[64], k=5)}
        torch.cuda.synchronize()
        launches = {"gather_dequant": gather.launches, "gcn_layer": gcn.launches}
        n_fwd = len(served)
        print(f"[slice] launches over {n_fwd} forwards: {launches}")
        assert launches == {"gather_dequant": n_fwd, "gcn_layer": cfg.num_gcn_layers * n_fwd}, \
            launches
        score_err = 0.0
        for B, (s, i) in served.items():
            assert s.shape == i.shape == (B, 5) and np.isfinite(s).all(), (B, s.shape, i.shape)
            full = ranker.score(batches[B])
            want = reference.score(batches[B])
            assert full.shape == want.shape == (B, cfg.num_candidates_model)
            np.testing.assert_allclose(s, np.take_along_axis(full, i, -1), rtol=0, atol=1e-5)
            err = float(np.abs(full - want).max())
            assert err <= SCORE_ATOL, f"B={B}: served vs f32 CPU forward max abs err {err}"
            score_err = max(score_err, err)
            print(f"[slice] B={B}: status 200, top-5 {s.shape}, finite; scores vs the f32 "
                  f"CPU forward: max abs err {err:.4g} (tol {SCORE_ATOL})")
        ms_b1 = host_ms(lambda: post(batches[1]))
        ms_b1_rank = host_ms(lambda: ranker.rank(batches[1], k=5))
        ms_b64 = host_ms(lambda: ranker.rank(batches[64], k=5))
        pairs = 64 * cfg.num_candidates_model / (ms_b64 / 1e3)
        print(f"[slice] /rank B=1: {ms_b1:.3f} ms per request (HTTP, median of 10); "
              f"Ranker.rank B=1: {ms_b1_rank:.3f} ms; Ranker.rank B=64: {ms_b64:.3f} ms, "
              f"{pairs:.0f} pairs/s")
        profile_rank(torch, ranker, batches[64])
    finally:
        server.shutdown()
        server.server_close()
    return launches, score_err


def profile_rank(torch, ranker, feats, reps: int = 5):
    """Where the B=64 rank's time goes: host-side input preparation (numpy ->
    device copy and cast), device time by kernel and the device's idle
    share, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    def prep():
        with torch.inference_mode():
            ranker._prepare(feats)
        torch.cuda.synchronize()

    print(f"[profile] B=64 input preparation (host to device, cast): {host_ms(prep):.3f} ms")
    ranker.rank(feats, k=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            ranker.rank(feats, k=5)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    from torch.autograd import DeviceType

    # device-side events only (kernels, copies): CPU ops also carry the
    # device time of what they launched and would count it twice
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    if not rows:
        print("[profile] device time not measured (the profiler saw no device activity)")
        return
    print(f"[profile] B=64 rank under the profiler: {wall:.3f} ms wall, {busy:.3f} ms device "
          f"busy, idle share {1 - busy / wall:.3f}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"[profile]   {ms:8.4f} ms  x{n:<3d} {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port has no CPU fallback",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    # the plain versions' float32 products run in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from drin_tpu_torch.ops.cuda import _build, gather, gcn_layer as gcn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    for name in ("gather_dequant", "gcn_layer"):
        _build.load(name)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name in ("gather_dequant", "gcn_layer"):
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    g_err, g_ms, g_plain = phase_gather(torch, gather)
    k_err, k_ms, k_plain = phase_gcn(torch, gcn)
    launches, _ = phase_slice(torch, np, gather, gcn)
    assert "jax" not in sys.modules, "the port imported jax"

    print(json.dumps({"kernels": [
        {"name": "gather_dequant", "route": "cuda",
         "source": "drin_tpu_torch/csrc/gather_dequant.cu",
         "replaces": "drin_tpu/ops/pallas/gather.py:127",
         "launches": launches["gather_dequant"], "max_abs_err": g_err,
         "ms": g_ms, "plain_ms": g_plain},
        {"name": "gcn_layer", "route": "cuda",
         "source": "drin_tpu_torch/csrc/gcn_layer.cu",
         "replaces": "drin_tpu/ops/pallas/gcn_layer.py:120",
         "launches": launches["gcn_layer"], "max_abs_err": k_err,
         "ms": k_ms, "plain_ms": k_plain}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
