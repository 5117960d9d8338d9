#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch / CUDA port (``drin_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels from ``drin_tpu_torch/csrc`` (one nvcc per
source, started together, sm_90a), holds each against its plain PyTorch
version on the card, then drives two serving paths through ``Ranker`` and
``serve_http``, each at the full width of its model with seeded random
weights:

  * DRIN's rank stage at the WikiMEL width over an int8 fused store of
    32,768 synthetic entities (the gather+dequant and GCN-layer kernels);
  * GHMFC with online BERT at bert-base width: ``/rank`` requests of token
    ids, 101 candidates zipped into 12 sentences of 512 tokens (the fused
    attention kernel, 12 launches per request).

It checks the answers against the port's float32 forward on the CPU, shows
through the launch counters that each served path ran its kernels, and
prints times measured with CUDA events beside each kernel's bound (the
least time the card could take: bytes over 3.35 TB/s or operations over the
peak rate of their type, whichever is larger).

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
# kernel 3 vs plain, bf16 outputs of size <= max|v|: one bf16 step either way
# (2 ulps relative = 1.6e-2), because the kernel rounds p before the
# normalisation and the plain version after it and both sum in another
# order; outputs near 0 (cancelling v) keep the absolute error of their
# terms, 2^-9 * sum(p |v|) <~ 2e-3 per rounding, floor 1e-2
ATTN_BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)
ATTN_F32_TOL = dict(atol=1e-4, rtol=1e-4)  # f32 summation order and expf only
# served bf16 online scores vs the port's f32 CPU forward: 12 BERT layers and
# the fusion round to bf16 at every step.  With random weights the cosines
# of one mention's candidates spread by only ~5e-3, so the limit is absolute
# and the run also requires it to lie under that spread
ONLINE_SCORE_ATOL = 2e-3
# the kernel's served scores vs the same bf16 model on the card with the plain
# version in the kernel's place: the two attentions differ by one bf16 step,
# which reaches a score of ~0.03 as a few of its bf16 steps (2^-13 each)
ONLINE_SWAP_ATOL = 8e-4
ONLINE_F32_ATOL = 1e-4  # float32 on the card vs float32 on the CPU: summation order
# the card's published peaks (H100 SXM, dense): bytes/s and FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound(nbytes: float, flops: float, dtype: str = "bfloat16"):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    # bytes this run's rows need: each gathered packed row, its scales and
    # its index read once, each output written once; the dequantisation's
    # one multiply per element is far under the byte time
    out = gather.gather_dequant(table, scales, rows, chunks, torch.bfloat16)
    n_rows = rows.numel()
    moved = n_rows * (m * 128 + m * 4 + 4) + nbytes(*out)
    bound_ms, bound_by = bound(moved, sum(o.numel() for o in out))
    print(f"[gather_dequant] N={N_ENTITIES} rows=[64,101] m={m}: bit-equal to plain "
          f"(bf16, f32, bad indices, R=0); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.1f} MB)")
    del table, scales
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
            # x.W_h^T over 2*B*C rows, the fold's two products over 2*B rows;
            # et, ei read and written once, the mention rows, edges and weights once
            flops = 2 * (2 * B * C) * D * D + 2 * 2 * (2 * B) * D * D
            moved = nbytes(*vertexes, *edges, *weights) + nbytes(*got_v, *got_e)
            bound_ms, bound_by = bound(moved, flops)
            print(f"[gcn_layer] B=64 C=101 D=768 bf16 layer call: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB)")
            result = {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return result


def _attn_inputs(torch, np, B, H, L, dt, seed, lens=None):
    """Unit-normal q, k, v as BERT hands them over: [B, H, L, 64] views of
    [B, L, H*64] projections.  At Dh=64 the logits q.k/8 then have unit
    spread (about +-4 over a row of 512 keys), so the softmax is far from
    uniform and a wrong key tile moves the output by O(1).  ``lens`` keeps a
    prefix of each sequence's keys (0 = every key dropped)."""
    rng = np.random.default_rng(seed)
    mk = lambda: torch.from_numpy(rng.standard_normal((B, L, H * 64), dtype=np.float32)).to(
        "cuda", dt).reshape(B, L, H, 64).transpose(1, 2)
    q, k, v = mk(), mk(), mk()
    mask = None
    if lens is not None:
        keep = torch.arange(L, device="cuda")[None] < torch.as_tensor(lens, device="cuda")[:, None]
        mask = torch.zeros((B, L), dtype=dt, device="cuda").masked_fill(~keep, torch.finfo(dt).min)
    return q, k, v, mask


def phase_attention(torch, np, attn):
    """Kernel 3 against attention_plain, both on the card; the check must
    also fail each planted fault of the plain version."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    # the main shape: one B=8 request's entity tower, [8*12, 12, 512, 64] bf16;
    # prefixes from under one key tile to all 512 keys, one sequence all dropped
    main_lens = rng.integers(9, 513, 96)
    main_lens[:6] = [512, 40, 63, 64, 65, 0]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("main", 96, 12, 512, bf16, main_lens),
             ("L=256", 16, 12, 256, bf16, rng.integers(1, 257, 16)),
             ("L=384", 16, 12, 384, bf16, rng.integers(1, 385, 16)),
             ("L=264 ragged", 16, 12, 264, bf16, rng.integers(200, 265, 16)),
             ("no mask", 16, 12, 512, bf16, None),
             ("f32", 4, 12, 512, f32, [512, 300, 17, 0]),
             ("f32 L=264 no mask", 2, 12, 264, f32, None),
             ("B'=1", 1, 12, 512, bf16, [77])]
    result = None
    for i, (name, B, H, L, dt, lens) in enumerate(cases):
        q, k, v, mask = _attn_inputs(torch, np, B, H, L, dt, SEED + i, lens)
        with torch.inference_mode():
            got = attn.fused_attention(q, k, v, mask)
            torch.cuda.synchronize()
            want = attn.attention_plain(q, k, v, mask)
            if i % 2:  # contiguous [B, H, L, 64] inputs take the same kernel
                again = attn.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
                assert torch.equal(again, got), f"attention {name}: strided != contiguous"
        torch.cuda.synchronize()
        tol = ATTN_BF16_TOL if dt == bf16 else ATTN_F32_TOL
        err = check_close(f"attention {name}", got, want, **tol)
        print(f"[attention] {name}: [{B},{H},{L},64] {str(dt)[6:]}: max abs err {err:.3g} "
              f"(tol {tol})")
        if lens is not None and 0 in list(lens):  # every key dropped: the mean of V
            b = list(lens).index(0)
            check_close(f"attention {name} all-masked", got[b].float(),
                        v[b].float().mean(-2, keepdim=True).expand_as(got[b]), **tol)
        if i:
            continue
        # the reach of the check: each fault planted in the plain version must
        # fall outside the tolerance
        logits = (q[1, 0].float() @ k[1, 0].float().T) / 8
        spread = (logits.amax(-1) - logits.amin(-1)).mean().item()
        with torch.inference_mode():
            no_tail = mask.clone()
            no_tail[:, -64:] = 0
            v_rot = v.clone()
            v_rot[:, :, 64:128] = v[:, :, 64:128].roll(1, 2)
            faults = {"mask of the last key tile dropped": attn.attention_plain(q, k, v, no_tail),
                      "scale Dh^-1/2 left out": attn.attention_plain(q * 8, k, v, mask),
                      "V of key tile 1 rotated": attn.attention_plain(q, k, v_rot, mask)}
        seen = {f: outside(bad, want, **tol) for f, bad in faults.items()}
        for f, n in seen.items():
            assert n, f"attention: the check cannot see the plain version with {f}"
        print(f"[attention]   logits std {logits.std().item():.3g}, spread over a row "
              f"{spread:.3g}; values a planted fault puts outside tol: {seen}")
        del faults, no_tail, v_rot, logits
        with torch.inference_mode():
            ms = cuda_ms(lambda: attn.fused_attention(q, k, v, mask))
            plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v, mask))
            lib_mask = mask[:, None, None, :]
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask)
            # PyTorch gives a sequence whose every key is dropped another
            # answer than the mean of V, so the two are compared apart from it
            dropped = torch.as_tensor(main_lens == 0, device="cuda")
            lib_diff = (lib.float() - want.float()).abs().amax((1, 2, 3))
            lib_err, lib_err_dropped = lib_diff[~dropped].max().item(), lib_diff[dropped].max().item()
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask))
        flops = 4 * L * L * 64 * B * H  # the two products
        moved = nbytes(q, k, v, mask, got)
        bound_ms, bound_by = bound(moved, flops)
        print(f"[attention] [96,12,512,64] bf16, masked: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, F.scaled_dot_product_attention {library_ms:.4f} ms (yardstick only; max abs "
              f"diff to plain {lib_err:.3g}, on the sequence with every key dropped "
              f"{lib_err_dropped:.3g}), bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e9:.1f} GFLOP, {moved / 1e6:.1f} MB)")
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": library_ms}
    for bad, why in ((lambda q, k, v, m: (q.half(), k.half(), v.half(), None), "fp16"),
                     (lambda q, k, v, m: (q[..., :32], k[..., :32], v[..., :32], None), "Dh=32"),
                     (lambda q, k, v, m: (q, k, v, m.float()), "mask dtype")):
        q, k, v, mask = _attn_inputs(torch, np, 2, 12, 256, bf16, SEED, [256, 3])
        try:
            attn.fused_attention(*bad(q, k, v, mask))
            raise AssertionError(f"attention: {why} was accepted")
        except ValueError:
            pass
    return result


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
        profile_rank(torch, ranker, batches[64], "B=64")
    finally:
        server.shutdown()
        server.server_close()
    return launches, score_err


def _online_weights(torch, np, model):
    """Seeded random weights for a model built on the meta device: BERT as
    HF initialises it (embeddings and linears N(0, 0.02), LayerNorm 1 / 0,
    biases 0); the layers above it uniform within 1/sqrt(fan_in), their
    LayerNorms 1 / 0, every other vector N(0, 0.02)."""
    rng = np.random.default_rng(SEED)
    sd = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if "LayerNorm" in key or "layernorms" in key:
            w = np.ones(shape, np.float32) if key.endswith("weight") else np.zeros(shape, np.float32)
        elif key.startswith("bert."):
            w = (rng.standard_normal(shape, dtype=np.float32) * 0.02 if len(shape) == 2
                 else np.zeros(shape, np.float32))
        elif len(shape) == 2:
            w = rng.uniform(-1, 1, shape).astype(np.float32) * shape[1] ** -0.5
        else:
            w = rng.standard_normal(shape, dtype=np.float32) * 0.02
        sd[key] = torch.from_numpy(w)
    return sd


def _online_request(np, cfg, B, seed, vocab):
    """A zipped token-id request: per mention a 128-token sentence, 49 image
    regions, and 101 candidate texts of 8 to 40 tokens packed by
    zip_entities into 12 sentences of 512 tokens (9 candidates each)."""
    from drin_tpu_torch.common.config import CLS_TOKEN_ID, SEP_TOKEN_ID
    from drin_tpu_torch.data.online import zip_entities

    rng = np.random.default_rng(seed)
    Lm, C = cfg.max_mention_sentence_len, cfg.num_candidates_model
    ids = rng.integers(1000, vocab, (B, Lm)).astype(np.int64)
    ids[:, 0], ids[:, -1] = CLS_TOKEN_ID, SEP_TOKEN_ID
    begin = rng.integers(1, 20, B).astype(np.int64)
    packed = []
    for _ in range(B):
        texts = [[CLS_TOKEN_ID] + rng.integers(1000, vocab, rng.integers(6, 39)).tolist()
                 + [SEP_TOKEN_ID] for _ in range(C)]
        packed.append(zip_entities(texts, cfg.num_entity_sentence, cfg.max_bert_len, CLS_TOKEN_ID))
    eids, emask, sep = (np.stack(x) for x in zip(*packed))
    return (ids, np.ones((B, Lm), np.int64), begin, begin + rng.integers(1, 4, B),
            rng.standard_normal((B, cfg.resnet_num_region, cfg.resnet_embed_dim), dtype=np.float32),
            eids, emask, sep, np.zeros((B,), np.float32))


def phase_online(torch, np, attn):
    """GHMFC with online BERT through Ranker and serve_http, at bert-base
    width: BERT over B mention sentences and B*12 zipped entity sentences of
    512 tokens inside every request."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.data.online import bucket_trim
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.serve import Ranker, _encode_arrays, rank_feat_fields, serve_http

    cfg = make_config("ghmfc", "wikimel", online_bert=True, finetune_bert=False,
                      compute_dtype="bfloat16")
    assert (cfg.num_candidates_model, cfg.num_entity_sentence, cfg.max_bert_len) == (101, 12, 512)
    with torch.device("meta"):
        skeleton, _ = get_model(cfg)
    bert_cfg = skeleton.bert.cfg
    assert (bert_cfg.hidden_size, bert_cfg.num_hidden_layers, bert_cfg.num_attention_heads,
            bert_cfg.intermediate_size, bert_cfg.vocab_size) == (768, 12, 12, 3072, 28996)
    weights = _online_weights(torch, np, skeleton)
    t0 = time.perf_counter()
    ranker = Ranker(cfg, weights, device="cuda")
    torch.cuda.synchronize()
    # built with no device named and moved to the card: the attention path is
    # picked from where the tensors lie
    assert cfg.bert_fused_attention is None
    assert ranker.model.bert.encoder.layer[0].attention.self.fused is None
    n_params = sum(p.numel() for p in ranker.model.parameters())
    print(f"[online] Ranker(ghmfc, online_bert) on cuda: {n_params / 1e6:.1f} M parameters in "
          f"{cfg.compute_dtype}, built in {time.perf_counter() - t0:.1f} s")
    reference = Ranker(cfg.replace(compute_dtype="float32"), weights, device="cpu")
    fields = rank_feat_fields(ranker)
    assert len(fields) == 9, fields
    requests = {B: _online_request(np, cfg, B, SEED + B, bert_cfg.vocab_size) for B in (1, 8)}
    server = serve_http(ranker, port=0, feat_fields=fields)
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(feats, k=5):
        body = json.dumps({"features": _encode_arrays(dict(zip(fields, feats))), "k": k})
        req = urllib.request.Request(url + "/rank", data=body.encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            assert resp.status == 200, resp.status
            out = json.loads(resp.read())
        return np.asarray(out["scores"]), np.asarray(out["indices"])

    try:
        # the main path, counted: /rank at B=1 and B=8
        attn.launches = 0
        served = {B: post(requests[B]) for B in (1, 8)}
        torch.cuda.synchronize()
        launches = attn.launches
        layers = bert_cfg.num_hidden_layers
        print(f"[online] attention launches over {len(served)} /rank requests: {launches} "
              f"({layers} per entity-tower BERT call, 0 for the 128-token mention tower)")
        assert launches == layers * len(served), launches
        with torch.inference_mode():  # the mention tower alone: under the gate, no launch
            m_ids = torch.from_numpy(requests[8][0]).cuda()
            ranker.model.bert(m_ids, torch.ones_like(m_ids))
        assert attn.launches == launches, "a 128-token BERT call launched the kernel"
        score_err = 0.0
        for B, (s, i) in served.items():
            assert s.shape == i.shape == (B, 5) and np.isfinite(s).all(), (B, s.shape, i.shape)
            assert ((0 <= i) & (i < cfg.num_candidates_model)).all(), i
            full = ranker.score(requests[B])
            t0 = time.perf_counter()
            want = reference.score(requests[B])
            cpu_s = time.perf_counter() - t0
            assert full.shape == want.shape == (B, cfg.num_candidates_model)
            assert np.isfinite(full).all()
            np.testing.assert_allclose(s, np.take_along_axis(full, i, -1), rtol=0, atol=1e-5)
            err = float(np.abs(full - want).max())
            assert err <= ONLINE_SCORE_ATOL, f"B={B}: served vs f32 CPU forward max abs err {err}"
            # with random weights the candidates' cosines lie close together:
            # the limit must sit under their spread or the check sees nothing
            spread = float(want.std(-1).min())
            assert ONLINE_SCORE_ATOL < spread, (ONLINE_SCORE_ATOL, spread)
            score_err = max(score_err, err)
            print(f"[online] B={B}: status 200, top-5 {s.shape}, finite, indices < 101; scores "
                  f"in [{full.min():.4f}, {full.max():.4f}], std over candidates >= {spread:.4g}; "
                  f"vs the f32 CPU forward ({cpu_s:.1f} s): max abs err {err:.4g} "
                  f"(tol {ONLINE_SCORE_ATOL})")
        # the reach of these limits: the same request served with another
        # attention in the kernel's place.  With weights of std 0.02 BERT's
        # attention is a small term beside the residual, so the limit against
        # the f32 forward sees a gross fault (the scale left out) and not a
        # fine one (one key tile's V rotated); the same bf16 model on the
        # card with the plain version swapped in gives a closer yardstick
        # that sees both
        from drin_tpu_torch.encoders import bert as bert_module

        def v_rotated(q, k, v, m):
            v = v.clone()
            v[:, :, 64:128] = v[:, :, 64:128].roll(1, 2)
            return attn.attention_plain(q, k, v, m)

        swaps = {"the plain version": attn.attention_plain,
                 "scale Dh^-1/2 left out": lambda q, k, v, m: attn.attention_plain(q * 8, k, v, m),
                 "V of key tile 1 rotated": v_rotated}
        kernel_scores, want = ranker.score(requests[1]), reference.score(requests[1])
        moved = {}
        for name, swap in swaps.items():
            bert_module.fused_attention = swap
            try:
                got = ranker.score(requests[1])
            finally:
                bert_module.fused_attention = attn.fused_attention
            moved[name] = (float(np.abs(got - want).max()), float(np.abs(got - kernel_scores).max()))
        print("[online] B=1 scores with BERT's attention swapped, max abs diff (to the f32 CPU "
              f"forward, to the kernel's scores): {moved}; limits {ONLINE_SCORE_ATOL}, "
              f"{ONLINE_SWAP_ATOL}")
        to_ref, to_kernel = moved.pop("the plain version")
        assert to_ref <= ONLINE_SCORE_ATOL and to_kernel <= ONLINE_SWAP_ATOL, (to_ref, to_kernel)
        assert moved["scale Dh^-1/2 left out"][0] > ONLINE_SCORE_ATOL, (
            "the limit against the f32 forward cannot see an attention without its scale")
        for name, (_, to_kernel) in moved.items():
            assert to_kernel > ONLINE_SWAP_ATOL, (
                f"the online check cannot see an attention with {name}: {to_kernel}")
        # the length-bucket trim drops columns that are padding in every row:
        # same scores from shorter sentences, still through the kernel
        r1 = requests[1]
        t_ids, t_mask = bucket_trim(r1[5], r1[6], cfg.online_length_buckets)
        assert 256 <= t_ids.shape[-1] < 512, t_ids.shape
        before = attn.launches
        trimmed = ranker.score(r1[:5] + (t_ids, t_mask) + r1[7:])
        assert attn.launches == before + layers
        trim_err = float(np.abs(trimmed - ranker.score(r1)).max())
        assert trim_err <= 2e-2, trim_err  # bf16 sums over 512 or fewer positions
        print(f"[online] B=1 trimmed to L={t_ids.shape[-1]} by bucket_trim: scores move by "
              f"{trim_err:.3g}, {layers} launches")
        ms_http = host_ms(lambda: post(requests[1]))
        ms_b1 = host_ms(lambda: ranker.rank(requests[1], k=5))
        ms_b8 = host_ms(lambda: ranker.rank(requests[8], k=5))
        print(f"[online] /rank B=1: {ms_http:.3f} ms per request (HTTP, median of 10); "
              f"Ranker.rank B=1: {ms_b1:.3f} ms; Ranker.rank B=8: {ms_b8:.3f} ms, "
              f"{8 * cfg.num_candidates_model / (ms_b8 / 1e3):.0f} pairs/s")
        profile_rank(torch, ranker, requests[1], "online B=1", reps=3)
        profile_rank(torch, ranker, requests[8], "online B=8", reps=3)
        # the same model in float32 on the card (the kernel's plain-FMA
        # instantiation) against the CPU: summation order only
        del ranker
        f32 = Ranker(cfg.replace(compute_dtype="float32"), weights, device="cuda")
        before = attn.launches
        f32_err = float(np.abs(f32.score(requests[1]) - reference.score(requests[1])).max())
        assert attn.launches == before + layers
        assert f32_err <= ONLINE_F32_ATOL, f"f32 on the card vs the CPU: max abs err {f32_err}"
        print(f"[online] float32 on the card, B=1: {layers} launches, scores vs the f32 CPU "
              f"forward: max abs err {f32_err:.3g} (tol {ONLINE_F32_ATOL})")
    finally:
        server.shutdown()
        server.server_close()
    return launches, score_err


def profile_rank(torch, ranker, feats, label: str, reps: int = 5):
    """Where a rank's time goes: host-side input preparation (numpy ->
    device copy and cast), device time by kernel and the device's idle
    share, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    def prep():
        with torch.inference_mode():
            ranker._prepare(feats)
        torch.cuda.synchronize()

    print(f"[profile] {label} input preparation (host to device, cast): {host_ms(prep):.3f} ms")
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
    print(f"[profile] {label} rank under the profiler: {wall:.3f} ms wall, {busy:.3f} ms device "
          f"busy, idle share {1 - busy / wall:.3f}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"[profile]   {ms:8.4f} ms  x{n:<3d} {key[:90]}")
    host = sorted(((e.self_cpu_time_total / 1e3 / reps, e.count // reps, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CPU), reverse=True)
    for ms, n, key in host[:6]:
        print(f"[profile]   host {ms:8.4f} ms  x{n:<4d} {key[:80]}")


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

    from drin_tpu_torch.ops.cuda import _build, attention as attn, gather, gcn_layer as gcn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, started together
    for name in _build.KERNELS:
        _build.load(name)
    each = ", ".join(f"{n} {t:.1f} s" for n, t in _build.nvcc_seconds.items())
    print(f"kernels built in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR} (the nvcc "
          f"processes ran together; each one's own time: {each}; one after another they "
          f"would take their sum, {sum(_build.nvcc_seconds.values()):.1f} s, or less)")
    for name in _build.KERNELS:
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    measured = {"gather_dequant": phase_gather(torch, gather), "gcn_layer": phase_gcn(torch, gcn),
                "attention": phase_attention(torch, np, attn)}
    # each served path is driven with its kernels' counts set to 0 just
    # before and read just after
    launches, _ = phase_slice(torch, np, gather, gcn)
    launches["attention"], _ = phase_online(torch, np, attn)
    assert all(launches.values()), f"a kernel of the served paths was never launched: {launches}"
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "drin_tpu"))
    assert not bad, f"the port imported {bad}"

    replaces = {"gather_dequant": "drin_tpu/ops/pallas/gather.py:127",
                "gcn_layer": "drin_tpu/ops/pallas/gcn_layer.py:120",
                "attention": "drin_tpu/ops/pallas/attention.py:180"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"drin_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": launches[name], **measured[name]}
        for name in _build.KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
