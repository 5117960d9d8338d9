#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch / CUDA port (``drin_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``drin_tpu_torch/csrc`` (one nvcc per source,
started together, sm_90a), holds each against its plain PyTorch version on
the card (gather+dequant, the GCN layer, the attention forward, the
attention backward with and without a mask, the vertex update), then drives
four paths at the full width of their models with seeded random weights.
Served, through ``Ranker`` and ``serve_http``:

  * DRIN's rank stage at the WikiMEL width over an int8 fused store of
    32,768 synthetic entities (the gather+dequant and GCN-layer kernels);
  * GHMFC with online BERT at bert-base width: ``/rank`` requests of token
    ids, 101 candidates zipped into 12 sentences of 512 tokens (the fused
    attention kernel, 12 launches per request).

Trained, through ``Trainer`` and ``build_step_fns``:

  * GHMFC with online BERT, fine-tuned: B=8 mentions with 12 zipped
    sentences of 512 tokens each, a bf16 body over float32 masters, every
    BERT layer recomputed in the backward (the attention forward and backward
    kernels, 24 and 12 launches per step);
  * DRIN at B=64, C=101, D=768 over the device-resident entity tables (the
    GCN-layer kernel in the forward, its backward through the plain version).

It checks the answers against the port's float32 forward on the CPU, shows
through the launch counters that each path ran its kernels, and
prints times measured with CUDA events beside each kernel's bound (the
least time the card could take: bytes over 3.35 TB/s or operations over the
peak rate of their type, whichever is larger).

Without CUDA, or without the repository around it, it exits non-zero and
prints no result.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels with their errors, times and launches:
each main path's own count (``launches_by_path``) and their sum.  The
mask-free attention backward and the vertex update are on no model path, as
in the JAX package: their counts are 0 and their kernel phases hold them.
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
# kernels 3b/3c vs attention_backward_plain.  The gradients' size depends on
# the sequence: with every key kept p ~ 1/512 and |dq|, |dk|, |dv| ~ 0.1; with
# a prefix of 9 kept keys p ~ 1/9 and they reach ~10.  So the floor is
# relative: |got - want| <= rtol * |want| + floor * max |want| over the
# sequence (b) the value belongs to.  bf16: both sides round P and dS to bf16
# before the products and sum in f32 in another order; the kernel takes delta
# from its bf16 output o, the plain version from the f32 P, and the kernel's
# exp and 1/l differ from the plain softmax in the last f32 bits, so some dS
# land on the neighbouring bf16; a gradient that is a cancelling sum of large
# terms keeps the absolute error of its terms: floor 1e-2 of the sequence's
# largest value; elsewhere one bf16 step either way (rtol 1.6e-2 = 2 ulps).
# dmask is a sum of H*L terms of dS per key, returned in the mask's type.
# f32: summation order and expf only.
ATTN_BWD_BF16_TOL = dict(floor=1e-2, rtol=1.6e-2)
ATTN_BWD_F32_TOL = dict(floor=1e-5, rtol=1e-4)
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
# first-step gradients of the fine-tuned online model, the kernels against the
# same bf16 model on the card with the plain attention (and autograd through
# it) swapped in: per parameter tensor, |g - g_plain|_2 / |g_plain|_2.  The
# two attentions differ by one bf16 step, forward and backward, in each of
# the 12 layers, and every later bf16 op rounds the difference again; the
# gradients are sums over 8 x 101 hinge terms of mixed sign, so a tensor with
# a small gradient (a bias behind the cosine) keeps up to ~0.1 of it as
# difference, most tensors under 0.04.  A planted fault of the backward
# (delta left out of dS) moves BERT's tensors by several times their norm
TRAIN_GRAD_REL = 0.2
# the online model's eval loss after five train steps on one batch, the main
# path (bf16 body, remat, the kernels) against the float32 model that keeps
# its activations and runs the plain attention: five Adam steps of all of
# BERT carry the bf16 rounding of every step on, so the two trajectories part
# by a few hundredths of a loss that starts at the margin, 0.25; a fifth of
# the margin still tells a run that learns (loss under 0.1) from one that
# does not (loss at the margin)
TRAIN_WITNESS_ATOL = 5e-2
# DRIN's first train-step loss, bf16 on the card against the float32 port on
# the CPU: the bf16 body rounds every activation to 8 bits, the loss is a
# mean of hinges over cosines of size ~0.25
TRAIN_LOSS_RTOL = 2e-2
# DRIN's second train-step loss against the same: it has been through the
# backward, the cast of the gradients into the float32 masters and one Adam
# update; by then the loss is ~0.01, and the two sides drew other dropout
# masks (a generator per device), so the limit is absolute, 1% of the margin
TRAIN_LOSS2_ATOL = 2.5e-3
# DRIN's first-step gradients (dropout off), bf16 on the card against the
# float32 port on the CPU: per parameter tensor, |g - g_cpu|_2 / |g_cpu|_2.
# The bf16 body rounds every activation and every activation gradient to 8
# bits and the loss sums 64 x 100 hinges, some of which lie within a bf16 step
# of the margin and switch on or off.  A layer's W_h gradient dropped in the
# backward of the fused layer moves that tensor by its whole norm (1.0)
TRAIN_DRIN_GRAD_REL = 0.2
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


def excess_rel(got, want, floor, rtol):
    """|got - want| - rtol * |want| in units of floor * (max |want| over the
    slice of the first dimension the value lies in): > 1 is outside."""
    got, want = got.float(), want.float()
    top = want.abs().reshape(want.shape[0], -1).amax(1).clamp_min(1e-30)
    top = top.reshape((-1,) + (1,) * (want.ndim - 1))
    return ((got - want).abs() - rtol * want.abs()) / (floor * top)


def outside_rel(got, want, floor, rtol) -> int:
    return int((excess_rel(got, want, floor, rtol) > 1).sum())


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


def _attn_grads(torch, attn, q, k, v, mask, do):
    """dq, dk, dv (and dmask for a mask that requires grad) of the wrapper,
    through autograd, as a caller gets them."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    if mask is not None:
        leaves.append(mask.detach().requires_grad_(True))
    out = attn.fused_attention(*leaves[:3], leaves[3] if mask is not None else None)
    return list(torch.autograd.grad(out, leaves, do))


def phase_attention_bwd(torch, np, attn):
    """Kernels 3b (masked, with the mask's cotangent) and 3c (no mask)
    against attention_backward_plain, both on the card; the check must also
    fail each planted fault of the plain version."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    main_lens = rng.integers(9, 513, 96)
    main_lens[:6] = [512, 40, 63, 64, 65, 0]  # one sequence with every key dropped
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("main", 96, 12, 512, bf16, main_lens),
             ("main, no mask", 96, 12, 512, bf16, None),
             ("L=256", 16, 12, 256, bf16, rng.integers(1, 257, 16)),
             ("L=384", 16, 12, 384, bf16, rng.integers(1, 385, 16)),
             ("L=264 ragged", 16, 12, 264, bf16, rng.integers(200, 265, 16)),
             ("L=264 ragged, no mask", 4, 12, 264, bf16, None),
             ("f32", 4, 12, 512, f32, [512, 300, 17, 0]),
             ("f32 L=264 no mask", 2, 12, 264, f32, None),
             ("B'=1", 1, 12, 512, bf16, [77])]
    names = ("dq", "dk", "dv", "dmask")
    results = {}
    for i, (name, B, H, L, dt, lens) in enumerate(cases):
        q, k, v, mask = _attn_inputs(torch, np, B, H, L, dt, SEED + i, lens)
        # the gradient as BERT's backward hands it over: a [B, H, L, 64] view of [B, L, H*64]
        do = _attn_inputs(torch, np, B, H, L, dt, SEED + 100 + i)[0]
        before = (attn.bwd_launches, attn.bwd_nomask_launches)
        got = _attn_grads(torch, attn, q, k, v, mask, do)
        torch.cuda.synchronize()
        after = (attn.bwd_launches, attn.bwd_nomask_launches)
        assert after == ((before[0] + 1, before[1]) if mask is not None
                         else (before[0], before[1] + 1)), (name, before, after)
        with torch.no_grad():
            want = [w for w in attn.attention_backward_plain(q, k, v, mask, do) if w is not None]
        if i % 2:  # a contiguous gradient takes the same kernels
            again = _attn_grads(torch, attn, q, k, v, mask, do.contiguous())
            for a, b in zip(again, got):
                assert torch.equal(a, b), f"attention bwd {name}: contiguous dO != strided"
        torch.cuda.synchronize()
        tol = ATTN_BWD_BF16_TOL if dt == bf16 else ATTN_BWD_F32_TOL
        assert len(got) == len(want) == (4 if mask is not None else 3)
        errs = {}
        for n, a, b in zip(names, got, want):
            assert a.shape == b.shape and torch.isfinite(a.float()).all(), (name, n)
            used = excess_rel(a, b, **tol).max().item()  # share of the floor in use
            errs[n] = (float(f"{(a.float() - b.float()).abs().max().item():.4g}"),
                       float(f"{b.float().abs().max().item():.4g}"), float(f"{used:.3g}"),
                       outside_rel(a, b, **tol))
        print(f"[attention_bwd] {name}: [{B},{H},{L},64] {str(dt)[6:]}: (max abs err, max |want|, "
              f"largest share of the floor in use, values outside tol) {errs} (tol {tol})")
        assert not any(e[3] for e in errs.values()), f"attention bwd {name}: outside tol: {errs}"
        err = max(e[0] for e in errs.values())
        if i > 1:
            continue
        # the reach of the check: each fault planted in the plain version must
        # fall outside the tolerance
        with torch.no_grad():
            pdq, pdk, pdv, pdm = attn.attention_backward_plain(q, k, v, mask, do)
            seen = {"scale left out of dq": outside_rel(pdq * 8, want[0], **tol),
                    "scale left out of dk": outside_rel(pdk * 8, want[1], **tol)}
            # delta left out of dS: dS = P * dP, so dq = s * (P * dP) . K
            scale = 0.125
            logits = torch.einsum("bhqd,bhkd->bhqk", q[:8].float(), k[:8].float()) * scale
            if mask is not None:
                logits = logits + mask[:8, None, None, :].float()
            p = torch.softmax(logits, -1)
            ds_bad = (p * torch.einsum("bhqd,bhkd->bhqk", do[:8].float(), v[:8].float())).to(dt).float()
            dq_bad = (torch.einsum("bhqk,bhkd->bhqd", ds_bad, k[:8].float()) * scale).to(dt)
            seen["delta left out of dS"] = outside_rel(dq_bad, want[0][:8], **tol)
            dv_rot = pdv.clone()
            dv_rot[:, :, 64:128] = pdv[:, :, 64:128].roll(1, 2)
            seen["dV of key tile 1 rotated"] = outside_rel(dv_rot, want[2], **tol)
            if mask is not None:
                # summed over the keys of a row instead of the rows of a key:
                # the row sums of dS are 0, so this dmask is 0 everywhere
                seen["dmask summed over the wrong axis"] = outside_rel(torch.zeros_like(pdm),
                                                                       want[3], **tol)
            del logits, p, ds_bad, dq_bad, dv_rot, pdq, pdk, pdv, pdm
        for f_, n in seen.items():
            assert n, f"attention bwd: the check cannot see the plain version with {f_}"
        print(f"[attention_bwd]   values a planted fault puts outside tol: {seen}")
        # time: the two backward launches alone, on the residuals of one forward
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attn.fused_attention(*leaves, mask)
        o, m, l = out.grad_fn.saved_tensors[4:7]
        with torch.no_grad():
            ms = cuda_ms(lambda: attn._launch_backward(q, k, v, mask, o, do, m, l, False))
            plain_ms = cuda_ms(lambda: attn.attention_backward_plain(q, k, v, mask, do), reps=5,
                               warmup=1)
        lib_mask = None if mask is None else mask[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
        lib = torch.autograd.grad(lib_out, leaves, do)
        kept = torch.ones(B, dtype=torch.bool, device="cuda") if lens is None else \
            torch.as_tensor(np.asarray(lens) > 0, device="cuda")
        lib_err = max((a.float() - b.float())[kept].abs().max().item() for a, b in zip(lib, want))
        flops = 10 * L * L * 64 * B * H  # the five products
        moved = nbytes(q, k, v, o, do, m, l, *got[:3]) + (nbytes(mask) if mask is not None else 0)
        bound_ms, bound_by = bound(moved, flops)
        print(f"[attention_bwd] [96,12,512,64] bf16, {'masked' if mask is not None else 'no mask'}: "
              f"kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, autograd through "
              f"F.scaled_dot_product_attention {library_ms:.4f} ms (yardstick only; max abs diff "
              f"to plain on the sequences that keep a key {lib_err:.3g}), bound {bound_ms:.4f} ms "
              f"({bound_by}: {flops / 1e9:.1f} GFLOP, {moved / 1e6:.1f} MB)")
        results["attention_bwd" if mask is not None else "attention_bwd_nomask"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}
        del lib_out, lib, out, leaves, o, m, l
    for bad, why in ((lambda q, k, v: (q.half(), k.half(), v.half()), "fp16"),
                     (lambda q, k, v: (q[..., :32], k[..., :32], v[..., :32]), "Dh=32"),
                     (lambda q, k, v: (q[:, :, :260], k[:, :, :260], v[:, :, :260]), "L % 8")):
        q, k, v, _ = _attn_inputs(torch, np, 2, 12, 264, bf16, SEED)
        try:
            attn.fused_attention(*(t.detach().requires_grad_(True) for t in bad(q, k, v)))
            raise AssertionError(f"attention with a gradient: {why} was accepted")
        except ValueError:
            pass
    return results


def _vertex_inputs(torch, B, C, D, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda *s: torch.rand(*s, generator=g, device="cuda")
    # v, e1, m1, e2, m2, w [out, in], b, ln scale, ln bias
    return [r(B, C, D).to(dt), u(B, C).to(dt), r(B, D).to(dt), u(B, C).to(dt), r(B, D).to(dt),
            ((u(D, D) * 2 - 1) * D ** -0.5).to(dt), ((u(D) * 2 - 1) * D ** -0.5).to(dt),
            (1 + 0.1 * r(D)).to(dt), (0.1 * r(D)).to(dt)]


def phase_vertex_update(torch, vu):
    """Kernel 4 against vertex_update_plain, both on the card; the check
    must also fail the plain version with e2*m2 left out."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(64, 101, 768, bf16, "gelu"),   # the WikiMEL width
             (64, 101, 768, f32, "gelu"),
             (5, 11, 32, bf16, "relu"), (5, 11, 32, f32, "tanh"),
             (5, 11, 32, bf16, "sigmoid"), (3, 33, 48, f32, "gelu")]
    result = None
    for i, (B, C, D, dt, act) in enumerate(cases):
        args = _vertex_inputs(torch, B, C, D, dt, SEED + i)
        with torch.inference_mode():
            got = vu.fused_vertex_update(*args, act=act)
            want = vu.vertex_update_plain(*args, act=act)
            fault = vu.vertex_update_plain(*args[:3], torch.zeros_like(args[3]), *args[4:], act=act)
        torch.cuda.synchronize()
        tol = GCN_BF16_TOL if dt == bf16 else GCN_F32_TOL  # the GCN layer's epilogue and reasons
        err = check_close(f"vertex_update {act}", got, want, **tol)
        seen = outside(fault, want, **tol)
        assert seen, "vertex_update: the check cannot see the plain version with e2*m2 left out"
        print(f"[vertex_update] B={B} C={C} D={D} {str(dt)[6:]} {act}: max abs err {err:.3g} "
              f"(tol {tol}); values outside tol with e2*m2 left out: {seen} of {want.numel()}")
        if i:
            continue
        with torch.inference_mode():
            ms = cuda_ms(lambda: vu.fused_vertex_update(*args, act=act))
            plain_ms = cuda_ms(lambda: vu.vertex_update_plain(*args, act=act))
        flops = 2 * B * C * D * D
        moved = nbytes(*args, got)
        bound_ms, bound_by = bound(moved, flops)
        print(f"[vertex_update] B=64 C=101 D=768 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB)")
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": None}
    args = _vertex_inputs(torch, 4, 11, 32, bf16, SEED)
    for bad, exc, why in ((lambda a: [a[0].half()] + a[1:], ValueError, "fp16"),
                          (lambda a: [a[0][:, :, :31]] + a[1:], ValueError, "shape"),
                          (lambda a: [a[0].requires_grad_(True)] + a[1:], RuntimeError, "grad")):
        try:
            vu.fused_vertex_update(*bad(list(args)))
            raise AssertionError(f"vertex_update: {why} was accepted")
        except exc:
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


def _onehot_answers(np, cfg, B, seed):
    rng = np.random.default_rng(seed)
    Cd = cfg.num_candidates_data
    return np.eye(Cd + 1, dtype=np.float32)[rng.integers(0, Cd, B)][:, :Cd]


def _run_steps(torch, trainer, batch, valid, n_steps):
    """``n_steps`` train steps on one repeated batch: losses and host-clock
    ms per step (each ends in a synchronise)."""
    from drin_tpu_torch.train import metrics as M

    mstate = M.init_state(trainer.cfg.metrics_topk, trainer.device)
    losses, times = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state, loss, mstate = trainer.fns.train_step(trainer.state, batch, valid, mstate)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, times, mstate


def phase_train_online(torch, np, attn):
    """GHMFC with online BERT, fine-tuned, through Trainer / build_step_fns
    at bert-base width: B=8 mentions, 12 zipped sentences of 512 tokens each,
    bf16 body over float32 masters, each BERT layer recomputed in the
    backward (``bert_remat``)."""
    import copy

    from drin_tpu_torch import make_config
    from drin_tpu_torch.encoders import bert as bert_module
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.train import metrics as M
    from drin_tpu_torch.train.trainer import Trainer, step_generator

    B, n_steps = 8, 5
    # learning_rate: at the config's default 1e-3 Adam on all of BERT leaves the
    # loss at the margin, in this run and in the float32 model with the plain
    # attention alike (both are run and printed below), so the counted run
    # takes a fine-tuning rate, at which both fall
    cfg = make_config("ghmfc", "wikimel", online_bert=True, finetune_bert=True, bert_remat=True,
                      compute_dtype="bfloat16", batch_size=B, learning_rate=1e-4)
    assert (cfg.num_candidates_model, cfg.num_entity_sentence, cfg.max_bert_len) == (101, 12, 512)

    def build(cfg):
        with torch.device("meta"):
            model, kind = get_model(cfg)
        assert kind == "online"
        model.load_state_dict(_online_weights(torch, np, model), assign=True)
        return Trainer(cfg, model, device="cuda", log=lambda *a: None)

    t0 = time.perf_counter()
    trainer = build(cfg)
    model, layers = trainer.state.model, trainer.state.model.bert.cfg.num_hidden_layers
    n_params = sum(p.numel() for p in model.parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    print(f"[train_online] Trainer(ghmfc, online_bert, finetune_bert, bert_remat) on cuda: "
          f"{n_params / 1e6:.1f} M float32 master parameters, body in {cfg.compute_dtype}, built "
          f"in {time.perf_counter() - t0:.1f} s")
    request = _online_request(np, cfg, B, SEED + 21, model.bert.cfg.vocab_size)
    batch, valid = trainer._put(request + (_onehot_answers(np, cfg, B, SEED + 22),),
                                np.ones((B,), np.float32))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    # the first step's gradients: the kernels against the plain attention on the card
    def grads(attend):
        model.zero_grad(set_to_none=True)
        bert_module.fused_attention = attend
        try:
            loss, _, _ = trainer.fns.loss_and_metrics(
                batch, valid, M.init_state(cfg.metrics_topk, "cuda"), step_generator(cfg, 0, "cuda"))
            loss.backward()
        finally:
            bert_module.fused_attention = attn.fused_attention
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    class NoDelta(torch.autograd.Function):
        """The plain attention with delta left out of dS in its backward."""

        @staticmethod
        def forward(ctx, q, k, v, mask):
            ctx.save_for_backward(q, k, v, mask)
            return attn.attention_plain(q, k, v, mask)

        @staticmethod
        def backward(ctx, do):
            q, k, v, mask = ctx.saved_tensors
            f = torch.float32
            logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f), k.to(f)) * 0.125
            p = torch.softmax(logits + mask[:, None, None, :].to(f), -1)
            ds = (p * torch.einsum("bhqd,bhkd->bhqk", do.to(f), v.to(f))).to(q.dtype).to(f)
            dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(f)) * 0.125
            dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f)) * 0.125
            dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).to(f), do.to(f))
            return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), None

    attn.launches = attn.bwd_launches = attn.bwd_nomask_launches = 0
    loss_k, g_kernel = grads(attn.fused_attention)
    counted = (attn.launches, attn.bwd_launches, attn.bwd_nomask_launches)
    assert counted == (2 * layers, layers, 0), counted
    loss_p, g_plain = grads(attn.attention_plain)
    _, g_fault = grads(NoDelta.apply)
    assert set(g_kernel) == set(g_plain) and len(g_kernel) > 200
    # every tensor but the key biases: adding a constant to all keys leaves the
    # softmax as it is, so their exact gradient is 0 and both sides hold noise
    names = [n for n in g_plain if not n.endswith("attention.self.key.bias")]
    rel = lambda g: {n: ((g[n] - g_plain[n]).norm() / g_plain[n].norm().clamp_min(1e-30)).item()
                     for n in names}
    rel_k, rel_f = rel(g_kernel), rel(g_fault)
    top = sorted(rel_k, key=rel_k.get, reverse=True)[:4]
    print(f"[train_online] first-step loss {loss_k:.6f} (plain attention swapped in: {loss_p:.6f}); "
          f"gradients vs the plain swap, relative L2 per tensor ({len(names)} tensors, the key "
          f"biases left out), the largest: {[(n, float(f'{rel_k[n]:.3g}')) for n in top]}; with "
          f"delta left out of dS the largest: {max(rel_f.values()):.4g} (limit {TRAIN_GRAD_REL})")
    assert all(torch.isfinite(g).all() for g in g_kernel.values())
    assert rel_k[top[0]] <= TRAIN_GRAD_REL, (top[0], rel_k[top[0]])
    assert max(rel_f.values()) > TRAIN_GRAD_REL, "the gradient check cannot see a faulty backward"
    del g_kernel, g_plain, g_fault
    model.zero_grad(set_to_none=True)

    # the main path, counted: train steps and one eval step.  The train losses
    # carry the fusion's attention dropout (other masks every step); whether
    # the steps learn is read from the deterministic eval loss before and after
    ev_before = float(trainer.fns.eval_step(batch, valid,
                                            M.init_state(cfg.metrics_topk, "cuda"))[0])
    torch.cuda.reset_peak_memory_stats()
    attn.launches = attn.bwd_launches = attn.bwd_nomask_launches = 0
    losses, times, mstate = _run_steps(torch, trainer, batch, valid, n_steps)
    ev_loss, mstate, scores = trainer.fns.eval_step(batch, valid, mstate)
    torch.cuda.synchronize()
    counts = {"attention": attn.launches, "attention_bwd": attn.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train_online] {n_steps} train steps + 1 eval step: forward launches "
          f"{counts['attention']} ({2 * layers} per train step: {layers} per entity-tower BERT "
          f"call and {layers} more when the backward recomputes each layer; {layers} per eval "
          f"step; 0 for the 128-token mention tower), backward launches {counts['attention_bwd']} "
          f"({layers} per train step), without mask {attn.bwd_nomask_launches}")
    assert counts == {"attention": 2 * layers * n_steps + layers,
                      "attention_bwd": layers * n_steps}, counts
    assert attn.bwd_nomask_launches == 0
    assert np.isfinite(losses).all() and np.isfinite(float(ev_loss)), losses
    assert losses[-1] < losses[0], losses
    assert float(ev_loss) < ev_before, \
        f"the loss did not fall on the repeated batch: eval {ev_before} -> {float(ev_loss)}, {losses}"
    assert tuple(scores.shape) == (B, cfg.num_candidates_model) and torch.isfinite(scores).all()
    assert trainer.state.step == n_steps and float(mstate["total"]) == B * (n_steps + 1)
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert any(n.startswith("bert.encoder.layer.0.") for n in moved) and \
        any(n.startswith("mention_encoder.") for n in moved), "parameters did not move"
    assert all(p.dtype == torch.float32 for p in model.parameters())
    step_ms = statistics.median(times[1:])
    print(f"[train_online] train losses {[round(x, 5) for x in losses]}, eval loss {ev_before:.5f} "
          f"before and {float(ev_loss):.5f} after; "
          f"{step_ms:.1f} ms per step (median of {n_steps - 1}, host clock to a synchronise; the "
          f"first {times[0]:.1f} ms), {B * cfg.num_candidates_model / (step_ms / 1e3):.0f} pairs/s, "
          f"peak memory {peak:.2f} GiB; {len(moved)} of {len(before)} tensors moved")
    mstate0 = M.init_state(cfg.metrics_topk, "cuda")
    profile_call(torch, lambda: trainer.fns.train_step(trainer.state, batch, valid, mstate0),
                 "online train step B=8 (remat)", reps=2, top=14)
    # the same step keeping every activation instead of recomputing the layers
    model.bert.remat = False
    torch.cuda.reset_peak_memory_stats()
    attn.launches = attn.bwd_launches = 0
    _, t_keep, _ = _run_steps(torch, trainer, batch, valid, 3)
    assert (attn.launches, attn.bwd_launches) == (3 * layers, 3 * layers)
    print(f"[train_online] bert_remat=False: {statistics.median(t_keep[1:]):.1f} ms per step, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, {layers} forward "
          f"and {layers} backward launches per step")
    model.bert.remat = True

    # the learning rate: the same five steps from the same weights at the
    # config's default 1e-3 and at 1e-4, each by two witnesses that share no
    # attention code, no rounding and no recompute: the main path (bf16 body,
    # bert_remat, the kernels) and the float32 model keeping every activation
    # with the plain attention swapped in and autograd through it
    del trainer, model, before
    torch.cuda.empty_cache()
    main, plain = "bf16, remat, kernels", "f32, no remat, plain attention"
    evals = {(cfg.learning_rate, main): (ev_before, float(ev_loss))}  # the counted run above
    for lr, witness, over, attend in (
            (1e-3, main, {}, attn.fused_attention),
            (1e-3, plain, {"compute_dtype": "float32", "bert_remat": False}, attn.attention_plain),
            (1e-4, plain, {"compute_dtype": "float32", "bert_remat": False}, attn.attention_plain)):
        tr = build(cfg.replace(learning_rate=lr, **over))
        bert_module.fused_attention = attend
        try:
            ev0 = float(tr.fns.eval_step(batch, valid, M.init_state(cfg.metrics_topk, "cuda"))[0])
            ls, _, ms = _run_steps(torch, tr, batch, valid, n_steps)
            ev1 = float(tr.fns.eval_step(batch, valid, ms)[0])
        finally:
            bert_module.fused_attention = attn.fused_attention
        evals[lr, witness] = (ev0, ev1)
        print(f"[train_online] learning_rate={lr:g}, {witness}: train losses "
              f"{[round(x, 5) for x in ls]}, eval loss {ev0:.5f} before and {ev1:.5f} after")
        assert np.isfinite(ls).all() and np.isfinite([ev0, ev1]).all()
        del tr
        torch.cuda.empty_cache()
    for lr in (1e-3, 1e-4):
        gap = abs(evals[lr, main][1] - evals[lr, plain][1])
        print(f"[train_online] learning_rate={lr:g}: eval loss after {n_steps} steps, the two "
              f"witnesses apart by {gap:.4f} (limit {TRAIN_WITNESS_ATOL})")
        assert gap <= TRAIN_WITNESS_ATOL, (lr, evals)
    assert all(evals[1e-4, w][1] < 0.5 * evals[1e-4, w][0] for w in (main, plain)), evals
    model = build(cfg).state.model

    # BERT called without an attention mask under a gradient: the mask-free backward
    bert16 = copy.deepcopy(model.bert).to(torch.bfloat16)
    ids = batch[5][0]  # one mention's 12 zipped sentences
    attn.launches = attn.bwd_launches = attn.bwd_nomask_launches = 0
    hidden, _ = bert16(ids, None)
    hidden.float().square().mean().backward()
    torch.cuda.synchronize()
    nomask = attn.bwd_nomask_launches
    assert (attn.launches, attn.bwd_launches, nomask) == (2 * layers, 0, layers), \
        (attn.launches, attn.bwd_launches, nomask)
    assert all(torch.isfinite(p.grad).all() for p in bert16.encoder.parameters())
    print(f"[train_online] BertModel(ids [12, 512], attention_mask=None) forward + backward in "
          f"bf16: {nomask} mask-free backward launches (a check beside the main paths: no "
          f"model calls BERT without a mask, and the kernels line does not count these)")
    del bert16, hidden, model
    torch.cuda.empty_cache()

    # frozen BERT: no gradient reaches it, Adam holds nothing for it, no backward launch
    frozen = build(cfg.replace(finetune_bert=False))
    fmodel = frozen.state.model
    start = {n: p.detach().clone() for n, p in fmodel.named_parameters()}
    held = {id(p) for g in frozen.state.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in held for n, p in fmodel.named_parameters() if n.startswith("bert."))
    attn.launches = attn.bwd_launches = 0
    f_losses, f_times, _ = _run_steps(torch, frozen, batch, valid, 3)
    assert (attn.launches, attn.bwd_launches) == (3 * layers, 0), (attn.launches, attn.bwd_launches)
    for n, p in fmodel.named_parameters():
        if n.startswith("bert."):
            assert p.grad is None and torch.equal(p, start[n]), f"frozen {n} changed"
    assert any(not torch.equal(p, start[n]) for n, p in fmodel.named_parameters()
               if not n.startswith("bert."))
    assert len(frozen.state.optimizer.state) == sum(
        1 for n, p in fmodel.named_parameters() if not n.startswith("bert.") and p.grad is not None)
    print(f"[train_online] finetune_bert=False: BERT bit-equal after 3 steps, no Adam state for "
          f"it, {layers} forward launches per step and no backward launch; losses "
          f"{[round(x, 5) for x in f_losses]}, {statistics.median(f_times[1:]):.1f} ms per step")
    return counts, {"step_ms": step_ms, "peak_gib": peak}


def phase_train_drin(torch, np, gcn, vu):
    """DRIN train steps through Trainer / build_step_fns at the full WikiMEL
    width: B=64, C=101, D=768, bf16 body over float32 masters, the
    device-resident entity tables gathered inside the step."""
    import copy

    from drin_tpu_torch import make_config
    from drin_tpu_torch.data.device_store import DeviceEntityStore
    from drin_tpu_torch.models.drin import DRIN
    from drin_tpu_torch.train import metrics as M
    from drin_tpu_torch.train.trainer import Trainer

    B, n_steps = 64, 5
    cfg = make_config("drin", "wikimel", compute_dtype="bfloat16", batch_size=B)
    tables = _tables(np, cfg, N_ENTITIES)
    model = DRIN(cfg, generator=torch.Generator().manual_seed(SEED))
    cpu_model = copy.deepcopy(model)
    store = DeviceEntityStore(cfg, tables, device="cuda")
    trainer = Trainer(cfg, model, device="cuda", feats_fn=store.drin_feats_fn(),
                      log=lambda *a: None)
    rows = _rows_batch(np, cfg, B, SEED + 31) + (_onehot_answers(np, cfg, B, SEED + 32),)
    ones = np.ones((B,), np.float32)
    batch, valid = trainer._put(rows, ones)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train_drin] Trainer(drin, wikimel) on cuda: {n_params / 1e6:.2f} M float32 master "
          f"parameters, body in {cfg.compute_dtype}, store of {store.n_rows} entities resident "
          f"({store.nbytes / 2 ** 20:.0f} MiB)")
    # the same model in float32 on the CPU
    cpu_cfg = cfg.replace(compute_dtype="float32")
    cpu = Trainer(cpu_cfg, cpu_model, device="cpu", log=lambda *a: None,
                  feats_fn=DeviceEntityStore(cpu_cfg, tables, device="cpu").drin_feats_fn())
    cbatch, cvalid = cpu._put(rows, ones)

    # the first step's gradients with dropout off: the card (kernel 1 forward,
    # its backward through the plain version, bf16 body, gradients cast into
    # the float32 masters) against the float32 CPU port, tensor by tensor
    def grads(tr, b, v):
        tr.state.model.zero_grad(set_to_none=True)
        loss, _, _ = tr.fns.loss_and_metrics(b, v, M.init_state(cfg.metrics_topk, tr.device))
        loss.backward()
        got = {n: p.grad.float().cpu() for n, p in tr.state.model.named_parameters()
               if p.grad is not None}
        tr.state.model.zero_grad(set_to_none=True)
        return got

    def drop_wh(ctx, *gs):
        """The fused layer's backward with W_h's gradient left out."""
        out = list(layer_backward(ctx, *gs))
        out[1 + 8] = None  # inputs: opts, 4 vertexes, 4 edges, then wh
        return tuple(out)

    g_cpu, g_card = grads(cpu, cbatch, cvalid), grads(trainer, batch, valid)
    layer_backward = gcn._FusedGCNLayer.backward
    gcn._FusedGCNLayer.backward = staticmethod(drop_wh)
    try:
        g_fault = grads(trainer, batch, valid)
    finally:
        gcn._FusedGCNLayer.backward = staticmethod(layer_backward)
    # a tensor the loss does not depend on (the last layer's edge update) has
    # no gradient on the CPU and an all-zero one behind the fused layer
    extra = sorted(set(g_card) - set(g_cpu))
    assert set(g_cpu) <= set(g_card) and len(g_cpu) >= 20, (len(g_card), len(g_cpu))
    assert all(not g_card[n].any() for n in extra), extra
    rel = lambda g: {n: float((g.get(n, torch.zeros_like(w)) - w).norm() / w.norm().clamp_min(1e-30))
                     for n, w in g_cpu.items()}
    rel_c, rel_f = rel(g_card), rel(g_fault)
    top = sorted(rel_c, key=rel_c.get, reverse=True)[:4]
    worst_f = max(rel_f, key=rel_f.get)
    print(f"[train_drin] first-step gradients (dropout off) vs the float32 CPU port, relative L2 "
          f"per tensor ({len(g_cpu)} tensors), the largest: "
          f"{[(n, float(f'{rel_c[n]:.3g}')) for n in top]}; with W_h's gradient dropped in the "
          f"fused layer's backward: {worst_f} {rel_f[worst_f]:.3g} (limit {TRAIN_DRIN_GRAD_REL})")
    assert all(torch.isfinite(g).all() for g in g_card.values())
    assert rel_c[top[0]] <= TRAIN_DRIN_GRAD_REL, (top[0], rel_c[top[0]])
    assert rel_f[worst_f] > TRAIN_DRIN_GRAD_REL and "w_h" in worst_f, \
        f"the gradient check cannot see a faulty backward: {worst_f} {rel_f[worst_f]}"
    del g_cpu, g_card, g_fault

    gcn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times, mstate = _run_steps(torch, trainer, batch, valid, n_steps)
    ev_loss, mstate, scores = trainer.fns.eval_step(batch, valid, mstate)
    torch.cuda.synchronize()
    launches = gcn.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train_drin] {n_steps} train steps + 1 eval step: gcn_layer launches {launches} "
          f"({cfg.num_gcn_layers} per forward; the backward differentiates the plain version)")
    assert launches == cfg.num_gcn_layers * (n_steps + 1), launches
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert tuple(scores.shape) == (B, cfg.num_candidates_model) and torch.isfinite(scores).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # the same steps of the float32 port on the CPU
    cstate, cpu_losses = M.init_state(cfg.metrics_topk), []
    for _ in range(2):
        cpu.state, closs, cstate = cpu.fns.train_step(cpu.state, cbatch, cvalid, cstate)
        cpu_losses.append(float(closs))
    err = abs(losses[0] - cpu_losses[0]) / abs(cpu_losses[0])
    err2 = abs(losses[1] - cpu_losses[1])
    step_ms = statistics.median(times[1:])
    print(f"[train_drin] losses {[round(x, 5) for x in losses]}, eval {float(ev_loss):.5f}; the "
          f"float32 CPU port's first two: {[round(x, 5) for x in cpu_losses]}; first-step loss "
          f"relative error {err:.3g} (tol {TRAIN_LOSS_RTOL}), second-step loss absolute error "
          f"{err2:.3g} (tol {TRAIN_LOSS2_ATOL}); {step_ms:.2f} ms per step (median "
          f"of {n_steps - 1}; the first {times[0]:.1f} ms), "
          f"{B * cfg.num_candidates_model / (step_ms / 1e3):.0f} pairs/s, peak memory {peak:.2f} GiB")
    assert err <= TRAIN_LOSS_RTOL, err
    assert err2 <= TRAIN_LOSS2_ATOL, err2
    mstate0 = M.init_state(cfg.metrics_topk, "cuda")
    profile_call(torch, lambda: trainer.fns.train_step(trainer.state, batch, valid, mstate0),
                 "DRIN train step B=64", reps=3)

    # kernel 4 on the run's own vertices.  No model calls the op, in either
    # package; driven here through its public entry it must give kernel 1's
    # et' (the same x . W_h^T, LayerNorm and gelu) from the same inputs
    bf16 = torch.bfloat16
    with torch.no_grad():
        feats = tuple(x.to(bf16) if x.is_floating_point() else x
                      for x in trainer.feats_fn(batch[:-1]))
        m16 = copy.deepcopy(model).to(bf16)
        vertexes = [v.contiguous() for v in m16.vertex_encoder(*feats[:5], *feats[7:10])]
        mtet, miei = m16.edge_encoder(feats[0], feats[2], feats[3], feats[5], feats[6], feats[7],
                                      feats[10], feats[11])
        edges = [e.contiguous() for e in (mtet, feats[13] / 100.0, feats[12] / 100.0, miei)]
        layer = m16.gcn_layers[0]
        w = (layer.w_h.weight, layer.w_h.bias, layer.layer_norm.weight, layer.layer_norm.bias)
        (_, _, et_k1, _), _ = gcn.fused_gcn_layer(vertexes, edges, *w, dynamic=False)
        vu.launches = 0
        mt, mi, et, _ = vertexes
        et_k4 = vu.fused_vertex_update(et, edges[0], mt, edges[2], mi, *w)
        torch.cuda.synchronize()
    vu_launches = vu.launches
    err4 = check_close("vertex_update vs kernel 1's et'", et_k4, et_k1, **GCN_BF16_TOL)
    print(f"[train_drin] fused_vertex_update on the step's vertices ([{B}, 101, 768] bf16): "
          f"{vu_launches} launch, max abs diff to kernel 1's et' {err4:.3g} (a check beside "
          f"the main paths: no model calls the op, and the kernels line does not count it)")
    assert vu_launches == 1
    return {"gcn_layer": launches}, {"step_ms": step_ms}


def profile_rank(torch, ranker, feats, label: str, reps: int = 5):
    """Where a rank's time goes: host-side input preparation (numpy ->
    device copy and cast), device time by kernel and the device's idle
    share, from torch.profiler."""

    def prep():
        with torch.inference_mode():
            ranker._prepare(feats)
        torch.cuda.synchronize()

    print(f"[profile] {label} input preparation (host to device, cast): {host_ms(prep):.3f} ms")
    profile_call(torch, lambda: ranker.rank(feats, k=5), f"{label} rank", reps)


def profile_call(torch, fn, label: str, reps: int = 5, top: int = 12):
    """Device time by kernel, the device's idle share and the host's largest
    self times over ``reps`` calls of ``fn``, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    # device-side events only (kernels, copies): CPU ops also carry the
    # device time of what they launched and would count it twice
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    if not rows:
        print("[profile] device time not measured (the profiler saw no device activity)")
        return
    print(f"[profile] {label} under the profiler: {wall:.3f} ms wall, {busy:.3f} ms device "
          f"busy, idle share {1 - busy / wall:.3f}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"[profile]   {ms:8.4f} ms  x{n:<5g} {key[:90]}")
    host = sorted(((e.self_cpu_time_total / 1e3 / reps, e.count / reps, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CPU), reverse=True)
    for ms, n, key in host[:6]:
        print(f"[profile]   host {ms:8.4f} ms  x{n:<5g} {key[:80]}")


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

    from drin_tpu_torch.ops.cuda import (_build, attention as attn, gather, gcn_layer as gcn,
                                         vertex_update as vu)

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
                "attention": phase_attention(torch, np, attn),
                "vertex_update": phase_vertex_update(torch, vu)}
    measured.update(phase_attention_bwd(torch, np, attn))
    # each main path is driven with its kernels' counts set to 0 just before
    # and read just after; a kernel of a path that the path never launched fails
    paths = {}
    paths["serve_drin"], _ = phase_slice(torch, np, gather, gcn)
    paths["serve_online"] = {"attention": phase_online(torch, np, attn)[0]}
    paths["train_online"], _ = phase_train_online(torch, np, attn)
    paths["train_drin"], _ = phase_train_drin(torch, np, gcn, vu)
    assert {p: sorted(c) for p, c in paths.items()} == {
        "serve_drin": ["gather_dequant", "gcn_layer"], "serve_online": ["attention"],
        "train_online": ["attention", "attention_bwd"], "train_drin": ["gcn_layer"]}, paths
    for path, counts in paths.items():
        assert all(counts.values()), f"{path} never launched one of its kernels: {counts}"
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "drin_tpu"))
    assert not bad, f"the port imported {bad}"

    # name -> (source, the TPU kernel it replaces).  launches_by_path holds each
    # main path's own count and launches is their sum.  The mask-free backward
    # and the vertex update are on no model path, in this package as in the
    # JAX one (BERT always passes a mask; no model calls the vertex update):
    # their counts are 0 and the kernel phases above are what holds them
    kernels = {
        "gather_dequant": ("gather_dequant.cu", "drin_tpu/ops/pallas/gather.py:127"),
        "gcn_layer": ("gcn_layer.cu", "drin_tpu/ops/pallas/gcn_layer.py:120"),
        "attention": ("attention.cu", "drin_tpu/ops/pallas/attention.py:48"),
        "attention_bwd": ("attention_bwd.cu", "drin_tpu/ops/pallas/attention.py:122"),
        "attention_bwd_nomask": ("attention_bwd.cu", "drin_tpu/ops/pallas/attention.py:134"),
        "vertex_update": ("gcn_layer.cu", "drin_tpu/ops/pallas/gcn.py:58")}
    assert set(kernels) == set(measured)
    by_path = {name: {path: counts.get(name, 0) for path, counts in paths.items()}
               for name in kernels}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"drin_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
         "on_a_main_path": any(by_path[name].values()), **measured[name]}
        for name, (src, tpu) in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
