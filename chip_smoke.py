#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch / CUDA port (``drin_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``drin_tpu_torch/csrc`` (one nvcc per source,
started together, sm_90a), holds each against its plain PyTorch version on
the card (gather+dequant at DRIN's and offline GHMFC's two packed layouts,
the GCN layer with its per-launch device times in bf16 and float32, the
attention forward, the attention backward with and without a mask, the
vertex update in both dtypes, and the port-only NMS kernel on the detector's
RPN and class problems and its edge cases), runs the full-width Faster R-CNN
detector from a seeded torchvision-keyed checkpoint against its CPU forward,
then drives sixteen paths at the full width of their models with seeded
random weights.  Served, through ``Ranker`` and ``serve_http``:

  * DRIN's rank stage at the WikiMEL width over an int8 fused store of
    32,768 synthetic entities (the gather+dequant and GCN-layer kernels),
    in bf16 and with the default compute dtype, float32 (the GCN-layer
    kernel's float32 form: split-precision TF32 on the tensor cores);
  * GHMFC with online BERT at bert-base width: ``/rank`` requests of token
    ids, 101 candidates zipped into 12 sentences of 512 tokens (the fused
    attention kernel, 12 launches per request);
  * offline GHMFC (multimodal fusion) over an int8 fused text-only store of
    32,768 entities (the gather+dequant kernel, one launch per rank), then
    the entity precompute and ``rank_rows``; and once with the 8-layer
    transformer mention layer;
  * MELHI on WikiDiverse (C=11), its thresholds set inside the run's own
    cosines so that both image-gate states occur (no kernel).

Trained, through ``Trainer`` and ``build_step_fns``:

  * GHMFC with online BERT, fine-tuned: B=8 mentions with 12 zipped
    sentences of 512 tokens each, a bf16 body over float32 masters, every
    BERT layer recomputed in the backward (the attention forward and backward
    kernels, 24 and 12 launches per step); then the same in float32, the
    default compute dtype (the kernels' float32 forms, split-precision TF32
    on the tensor cores, 24 and 12 launches per step);
  * the same model trained from raw text through the training entry point
    (``python -m drin_tpu_torch.train``'s ``main``): a seeded bert-base
    checkpoint and vocabulary file, a WikiMEL store of raw strings tokenized
    by the native tokenizer in pools of spawn workers, two fit chunks with
    checkpoints and profiler windows (the attention kernels, 24 and 12
    launches per train step, 12 per eval step);
  * DRIN at B=64, C=101, D=768 over the device-resident entity tables (the
    GCN-layer kernel in the forward, its backward through the plain version),
    with a bf16 body and then in float32, the default compute dtype;
  * offline GHMFC at B=64 over the float text-only store, and MELHI at B=64
    (no kernel).

Preprocessed, through ``python -m drin_tpu_torch.preprocess all``'s ``main``:

  * a seeded WikiMEL raw corpus (64 mentions a split, 1,024 entities, JPEG
    images) into the feature store with seeded bert-base, ResNet-152, CLIP
    ViT-B/32 and Faster R-CNN (ResNet-50 FPN, torchvision's keys) checkpoints
    at WikiMEL's widths (the attention kernel in float32, split-precision TF32
    on the tensor cores, in BERT's buckets of 256-512, 12 launches a chunk;
    the NMS kernel in the detector, two launches a forward of 8 images),
    under PyTorch's default TF32 settings as a user's process has them (the
    stages hold their encoders and the detector to full float32), then DRIN
    evaluated over that store through the training entry point (the
    GCN-layer kernel).

It checks the answers against the port's float32 forward on the CPU, shows
through the launch counters that each path ran its kernels (and that the
paths without one launched none), and
prints times measured with CUDA events beside each kernel's bound (the
least time the card could take: bytes over 3.35 TB/s or operations over the
peak rate of their type, whichever is larger; float32-accurate products by
the tensor cores' route, three TF32 products each, with the bound on the f32
units printed beside it).

Without CUDA, or without the repository around it, it exits non-zero and
prints no result.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels with their errors, times and launches:
each main path's own count (``launches_by_path``) and their sum, and the
GCN layer's dtype on each path.  The mask-free attention backward and the
vertex update are on no model path, as in the JAX package: their counts are
0 and their kernel phases hold them.  The NMS kernel replaces no Pallas
kernel: it is the counterpart of the JAX package's jnp loop
(``drin_tpu/ops/detection.py:29``), which eager PyTorch cannot run as one
program.
"""

from __future__ import annotations

import contextlib
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
# f32: the kernels take every product in split-precision TF32 (lo.hi + hi.lo +
# hi.hi of TF32 halves in f32 accumulators): a few f32 roundings, 2.1e-6 -
# 2.9e-6 by the CPU emulation of tests/test_torch_gcn_layer_f32.py, against
# 1.3e-3 - 1.7e-3 for one TF32 pass (the planted fault)
GCN_F32_TOL = dict(atol=1e-4, rtol=1e-4)
# served bf16 scores vs the port's f32 CPU forward on the same int8 tables:
# bf16 keeps 8 mantissa bits and the forward rounds at every layer
SCORE_ATOL = 5e-2
# kernel 3 vs plain, bf16 outputs of size <= max|v|: one bf16 step either way
# (2 ulps relative = 1.6e-2), because the kernel rounds p before the
# normalisation and the plain version after it and both sum in another
# order; outputs near 0 (cancelling v) keep the absolute error of their
# terms, 2^-9 * sum(p |v|) <~ 2e-3 per rounding, floor 1e-2
ATTN_BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)
# f32: the kernel takes both products in split-precision TF32 (three TF32
# products per product, float32 accumulators: a few f32 roundings, ~1.5e-6 at
# unit-normal inputs by the CPU emulation of tests/test_torch_attention_f32.py)
# and its exponentials with ex2.approx; one TF32 pass (the planted fault)
# moves outputs by ~1e-3
ATTN_F32_TOL = dict(atol=1e-4, rtol=1e-4)
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
# what callers write into an additive mask for a dropped key besides finfo.min:
# a sequence whose keys are all dropped must come out uniform for each (the
# bf16 kernels turn the mask and the stored row max into base 2 and back)
OTHER_DROPS = (-1e9, -1e30)
# the attention rows' times before their redesign for wgmma and TMA (PERF.md
# section 6, NVIDIA H100 80GB HBM3 at 700 W, the same shape and timing method),
# quoted in a printed line beside this run's; the kernels line holds only what
# this run measured, and the bounds (bound_ms, and fma_bound_ms for float32)
# worked out from this run's inputs (tools/attention_sweep.py --old-csrc times
# old and new in one process)
ATTN_EARLIER_MS = {"attention": 0.464, "attention_bwd": 1.453, "attention_bwd_nomask": 1.490,
                   # the f32 forward at BertStage's [64, 12, 512, 64] masked,
                   # plain FMA before its split-TF32 redesign (PERF.md section 6)
                   "attention_f32": 2.952,
                   # the f32 backward, plain FMA before its split-TF32 redesign:
                   # [4, 12, 512, 64] masked and [2, 12, 264, 64] without a mask
                   "attention_bwd_f32": 1.246, "attention_bwd_nomask_f32": 0.332}
# served bf16 online scores vs the port's f32 CPU forward: 12 BERT layers and
# the fusion round to bf16 at every step.  With random weights the cosines
# of one mention's candidates spread by only ~5e-3, so the limit is absolute
# and the run also requires it to lie under that spread
ONLINE_SCORE_ATOL = 2e-3
# the kernel's served scores vs the same bf16 model on the card with the plain
# version in the kernel's place: the two attentions differ by one bf16 step,
# which reaches a score of ~0.03 as a few of its bf16 steps (2^-13 each)
ONLINE_SWAP_ATOL = 8e-4
# the trained online model's scores against the f32 CPU forward (train_text):
# eight steps on the random store move every cosine of the request to about
# -0.505, where one bf16 ulp is 3.9e-3 (an H100 read 3.84e-3, the
# candidates' spread 3.7e-4), so the limit is two ulps there; the online
# limit holds at the weights the run starts from
TRAINED_SCORE_ATOL = 8e-3
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
# the same in float32 (the default compute_dtype): the kernels' split-TF32
# products differ from the plain float32 attention by a few float32 roundings
# (up to 0.2 of ATTN_BWD_F32_TOL's floor, phase_attention_bwd), and the
# gradients carry that through 12 layers and the cancelling hinge sums.  The
# CPU emulation in a 2-layer BERT (tests/test_torch_attention_bwd_f32.py)
# moves a tensor by ~1e-6 through the split and ~1e-3 through one TF32 pass
# of every product.  On an H100 the full model read 2.4e-5 through the
# kernels and 5.5e-4 through one TF32 pass: the first limit, 5e-4, would have
# let that fault pass within 10%, so the limit sits between the two readings
TRAIN_F32_GRAD_REL = 1e-4
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
# the same in float32 (the default compute_dtype) on the card: the forward's
# products (cuBLAS f32, kernel 1's split TF32) and the backward's sum in
# another order than the CPU's, as for offline GHMFC and MELHI in f32
TRAIN_DRIN_F32_GRAD_REL = 1e-3
# DRIN's first-step loss (dropout off) in float32 on the card against the
# float32 CPU port: summation order only
TRAIN_DRIN_F32_LOSS_RTOL = 1e-4
# offline GHMFC served in bf16 against the port's f32 CPU forward of the same
# request over the same int8 rows: the fusion's cross attentions, LayerNorms
# and gelu round to bf16 at every step.  At random weights one mention's
# candidate cosines spread by ~3e-2, so the limit is absolute and the run
# requires it to lie under that spread
GHMFC_SCORE_ATOL = 1e-2
# rank_rows against rank's full forward, both bf16 on the card: the entity
# linear runs over 8,192-row chunks in one and [64*101]-row batches in the
# other, so cuBLAS may round an output element to the neighbouring bf16, and
# the cosine itself is a bf16 value (an ulp of 4.9e-4 at |cos| ~ 0.1): four
# ulps.  A candidate rank_rows puts in its top-k must score, in the full
# forward, no more than this under the full forward's k-th best
RANK_ROWS_ATOL = 2e-3
# MELHI served in bf16 against the port's f32 CPU forward, on the mentions
# whose image gate agrees: 127 and 128 sequential LSTM steps in bf16 carry the
# rounding of each step on in the cell state, which the forget gate keeps at
# ~1% of max |h| at any length; the scores moved by 9e-4 on the H100.  The
# LSTM with its input and forget gates swapped moves them by 2.5e-2
MELHI_SCORE_ATOL = 5e-3
# GHMFC with the 8-layer transformer mention layer in bf16 against f32 on the
# CPU: eight post-LN layers each round their output to bf16
TRANSFORMER_SCORE_ATOL = 1e-2
# a reply of the micro-batched DRIN server (its rows coalesced with other
# requests' and padded to a bucket) against the same request ranked alone on
# the card: cuBLAS may take another algorithm for another row count, and a
# bf16 score then rounds to a neighbouring value (an ulp is 2^-8 = 3.9e-3 at
# 0.5-1): two ulps.  Measured on the H100: 0, bit-equal at every bucket
BATCHED_ATOL = 8e-3
# a retrieved score against the float32 cosine of the query with the returned
# row: the table and the query are normalized into bf16 and the product is
# rounded to bf16 (half an ulp below 1.0 is 2^-9 = 1.95e-3)
RETRIEVE_SCORE_ATOL = 2e-3
# the offline baselines' first-step gradients, per parameter tensor,
# |g - g_cpu|_2 / |g_cpu|_2 against the f32 CPU port.  In float32 on the card
# the two differ by summation order only.  In bf16 some gradients are small
# residues of thousands of cancelling terms: the entity linear's bias is a sum
# over 64 x 101 cosine gradients whose norms differ by a few percent, and
# the cosine's norms are bf16 values; GHMFC's attention q/k projections take
# their gradient through the softmax's derivative, a difference of products.
# bf16 rounding leaves up to ~0.4 of such a tensor's gradient (measured on
# the H100: the entity bias 0.41, the q/k projections 0.21).  A gradient
# dropped in the backward moves its tensors by their whole norm, 1.0
TRAIN_BASELINE_F32_GRAD_REL = 1e-3
TRAIN_BASELINE_BF16_GRAD_REL = 0.5
# the card's published peaks (H100 SXM, dense): bytes/s and FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}


def bound(nbytes: float, flops: float, dtype: str = "bfloat16"):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_bound(nbytes: float, flops: float):
    """(bound_ms, bound_by, fma_ms) of float32-accurate products: the least
    time is the tensor cores' route, three TF32 products per product (split
    precision), against the bytes; fma_ms is the bound of the same work on
    the f32 units outside the tensor cores (67 TFLOP/s), for comparison."""
    return bound(nbytes, 3 * flops, "tf32") + (bound(nbytes, flops, "float32")[0],)


def tf32_round(torch, x):
    """x (float32) rounded to TF32 as cvt.rna does: to nearest on the 13
    low mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


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


def kernel_device_ms(torch, fn, reps: int = 10) -> dict:
    """Device time in ms per call of ``fn``, by kernel name, from torch.profiler.
    A window in which the profiler saw no device activity at all (it happens
    now and then on a repeated profile) is taken again, up to three times;
    an empty result means "not measured", never 0 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        if times:
            return times
    raise RuntimeError("torch.profiler saw no device activity in three windows: device time not measured")


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: the sum over the kernels it
    launches, from torch.profiler (the event-timed ``cuda_ms`` of a single
    call also holds the host's time to reach the launch)."""
    import torch

    return sum(kernel_device_ms(torch, fn, reps).values())


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
    slice of the first dimension the value lies in): > 1 is outside.  A slice
    whose ``want`` is 0 throughout (dq, dk and dmask of a sequence that keeps
    one key: its softmax is constant) has no size of its own and is held to
    the floor of the largest slice."""
    got, want = got.float(), want.float()
    top = want.abs().reshape(want.shape[0], -1).amax(1)
    top = top.masked_fill(top == 0, top.max().item()).clamp_min(1e-30)
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


# kernel 2's packed layouts at the WikiMEL widths (D=768, Dr=2048): DRIN's
# text | image | obj slab (44 of 48 sub-rows), offline GHMFC's text-only slab
# (12 of 16) and its text | image slab (28 of 32)
GATHER_LAYOUTS = {"drin": ((1536, 2), (2048, 1), (2048, 1)), "ghmfc_text": ((1536, 2),),
                  "ghmfc_text_image": ((1536, 2), (2048, 1))}


def phase_gather(torch, gather):
    """Kernel 2 against gather_dequant_plain, both on the card, at each
    packed layout of GATHER_LAYOUTS; the DRIN layout's numbers lead."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = torch.randint(0, N_ENTITIES, (64, 101), generator=g, device="cuda", dtype=torch.int32)
    rows[0, :4] = torch.tensor([-1, -N_ENTITIES, N_ENTITIES, N_ENTITIES + 99], dtype=torch.int32)
    rows[1, :2] = torch.tensor([-5 * N_ENTITIES, 2**31 - 1], dtype=torch.int32)
    results = {}
    for name, chunks in GATHER_LAYOUTS.items():
        _, m_data, m = gather._slot_subrows(chunks)
        table = torch.randint(-127, 128, (N_ENTITIES, m, 128), generator=g, device="cuda",
                              dtype=torch.int8)
        scales = torch.rand((N_ENTITIES, m), generator=g, device="cuda") * 0.05 + 1e-3
        err = 0.0
        for dt in (torch.bfloat16, torch.float32):
            got = gather.gather_dequant(table, scales, rows, chunks, dt)
            want = gather.gather_dequant_plain(table, scales, rows, chunks, dt)
            torch.cuda.synchronize()
            assert len(got) == len(want) == len(chunks)
            for a, b, (w, _) in zip(got, want, chunks):
                assert a.shape == b.shape == (64, 101, w), (name, a.shape, b.shape)
                assert torch.equal(a, b), f"gather_dequant {name} {dt}: kernel != plain"
                err = max(err, (a.float() - b.float()).abs().max().item())
        empty = gather.gather_dequant(table, scales, rows[:, :0], chunks, torch.bfloat16)
        assert [tuple(e.shape) for e in empty] == [(64, 0, w) for w, _ in chunks]
        try:
            gather.gather_dequant(table, scales, rows.float(), chunks, torch.bfloat16)
            raise AssertionError("float rows were accepted")
        except TypeError:
            pass
        call = lambda: gather.gather_dequant(table, scales, rows, chunks, torch.bfloat16)
        ms = cuda_ms(call)
        dev_ms = device_ms(call)
        plain_ms = cuda_ms(lambda: gather.gather_dequant_plain(table, scales, rows, chunks,
                                                               torch.bfloat16))
        # bytes this run's rows need: each gathered row's data sub-rows (the
        # slab's pad sub-rows are never read), their scales and the row's
        # index read once, each output written once; the dequantisation's
        # one multiply per element is far under the byte time
        out = call()
        moved = rows.numel() * (m_data * 128 + m_data * 4 + 4) + nbytes(*out)
        bound_ms, bound_by = bound(moved, sum(o.numel() for o in out))
        print(f"[gather_dequant] {name} chunks={chunks} m={m} ({m_data} data sub-rows), "
              f"N={N_ENTITIES} rows=[64,101]: bit-equal to plain (bf16, f32, bad indices, R=0); "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.1f} MB)")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None, "device_ms": dev_ms}
        del table, scales, out
    return dict(results["drin"], layouts=results)


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


# the launches of kernel 1 (and 4) by the row kernel's mode (csrc/gcn_layer.cu
# RowsMode), bf16 or f32, and the f32 path's weight split
GCN_LAUNCHES = {"<3,": "A1 fold u.Ku", "<4,": "A2 fold a.Kv", "<0,": "B entity rows",
                "<1,": "C mention rows", "<2,": "vertex update"}


def by_launch(times: dict) -> dict:
    out = {}
    for key, ms in times.items():
        if "gcn_rows" in key:
            label = next((v for k, v in GCN_LAUNCHES.items() if k in key.replace(" ", "")), key[:40])
        else:
            label = "W split" if "split_w_f32" in key else key[:40]
        out[label] = round(out.get(label, 0.0) + ms, 5)
    return out


@contextlib.contextmanager
def tf32_products(gcn):
    """The plain versions of kernels 1 and 4 with their weight products in
    one TF32 pass (both operands rounded as cvt.rna does): the float32
    kernels without their split, for the block."""
    import torch

    saved = gcn._product
    gcn._product = lambda a, b: tf32_round(torch, a) @ tf32_round(torch, b)
    try:
        yield
    finally:
        gcn._product = saved


def gcn_dtypes(gcn):
    """A context that records the dtype of every launch of kernel 1 (the
    wrapper's launch helper wrapped, put back after)."""

    @contextlib.contextmanager
    def ctx():
        seen = []
        launch = gcn._launch
        gcn._launch = lambda vertexes, *a, **kw: (seen.append(str(vertexes[2].dtype)[6:]),
                                                  launch(vertexes, *a, **kw))[1]
        try:
            yield seen
        finally:
            gcn._launch = launch

    return ctx()


def _mention_faults(torch, gcn, vertexes, edges, weights, vact):
    """The mention updates as a faulty launch B or C would give them, built on
    the plain version: one tile's message slot dropped, the messages of one
    (b, vertex set) segment given to its neighbour, the update skipped."""
    mt, mi, et, ei = vertexes
    B, C, D = et.shape
    wh, bh, lns, lnb = weights[:4]
    slots = gcn.slot_messages_plain(et, ei, edges)
    bad = slots.clone()
    bad[0, 1, 0] = 0  # set 0, tile 1 (rows 64..127), its first slot
    out = {"one tile's message slot dropped": gcn.sum_slots_plain(bad, B, C)}
    per_set = [gcn.sum_slots_plain(torch.stack([slots[s], torch.zeros_like(slots[s])]), B, C)
               for s in range(2)]
    moved = per_set[0].clone()
    moved[:, 0] += moved[:, 1]  # (b=1, et)'s messages given to b=0
    moved[:, 1] = 0
    out["(b=1, et) segment given to b=0"] = moved + per_set[1]
    faults = {name: gcn._mention_updates(mt, mi, msg[0] / C, msg[1] / C, wh, bh, lns, lnb, 1e-5, vact)
              for name, msg in out.items()}
    faults["mention update skipped"] = [mt, mi]
    return faults


def phase_gcn(torch, gcn):
    """Kernel 1 against gcn_layer_plain, both on the card, in bf16 and in
    float32.  The cases cover the row kernel's tiling: C=101 tiles that cross
    b boundaries, B*C under one tile, B=1, C=1, C=64 and 65.  The check must
    also fail each planted fault of the edge fold and of the message slots
    and mention rows, and in float32 the plain version with its products in
    one TF32 pass.  The main case of each dtype is timed."""
    import torch.nn.functional as F

    from drin_tpu_torch.nn.layers import get_activation

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(64, 101, 768, bf16, "gelu", "sigmoid", True),   # the main path
             (64, 101, 768, bf16, "gelu", "sigmoid", False),
             (4, 11, 128, bf16, "relu", "tanh", True),        # B*C = 44: under one tile
             (1, 101, 768, bf16, "gelu", "sigmoid", True),    # B=1
             (64, 1, 768, bf16, "gelu", "sigmoid", True),     # C=1: 64 segments in a tile
             (3, 1, 128, bf16, "sigmoid", "identity", False),
             (2, 64, 128, bf16, "tanh", "relu", True),        # tiles on the b boundaries
             (5, 65, 128, bf16, "gelu", "sigmoid", True),
             # float32, the default compute dtype's DRIN layer and the same tiling
             (64, 101, 768, f32, "gelu", "sigmoid", True),
             (64, 101, 768, f32, "gelu", "sigmoid", False),
             (8, 101, 768, f32, "gelu", "sigmoid", True),
             (1, 101, 768, f32, "gelu", "sigmoid", True),
             (64, 1, 768, f32, "gelu", "sigmoid", True),
             (5, 65, 768, f32, "gelu", "sigmoid", False),
             (4, 11, 128, f32, "relu", "tanh", True),
             (3, 1, 128, f32, "sigmoid", "identity", False),
             (2, 64, 128, f32, "tanh", "relu", True),
             (5, 65, 128, f32, "tanh", "identity", True)]
    result = {}
    for i, (B, C, D, dt, vact, eact, dyn) in enumerate(cases):
        vertexes, edges, weights = _gcn_inputs(torch, B, C, D, dt, SEED + i)
        kw = dict(vact=vact, eact=eact, dynamic=dyn)
        with torch.inference_mode():
            got_v, got_e = gcn.fused_gcn_layer(vertexes, edges, *weights, **kw)
            again_v, again_e = gcn.fused_gcn_layer(vertexes, edges, *weights, **kw)
            want_v, want_e = gcn.gcn_layer_plain(vertexes, edges, *weights, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got_v + got_e, again_v + again_e):  # no atomics, no order left open
            assert torch.equal(a, b), f"gcn_layer B={B} C={C} D={D} {dt}: two runs differ"
        tol = GCN_BF16_TOL if dt == bf16 else GCN_F32_TOL
        err = max(check_close(f"gcn_layer {n}", a, b, **tol)
                  for n, a, b in zip(("mt", "mi", "et", "ei", "tt", "ti", "it", "ii"),
                                     got_v + got_e, want_v + want_e))
        print(f"[gcn_layer] B={B} C={C} D={D} {str(dt)[6:]} {vact}/{eact} "
              f"{'dynamic' if dyn else 'static'}: max abs err {err:.3g} (tol {tol}); two runs bit-equal")
        if dyn and D > 64:
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
        if (B, C, D, dyn) != (64, 101, 768, True):
            continue
        # the main case of each dtype: the mention faults (and in float32 one
        # TF32 pass) must fail the check; the layer is timed
        with torch.inference_mode():
            faults = _mention_faults(torch, gcn, vertexes, edges, weights, vact)
            if dt == f32:
                with tf32_products(gcn):
                    faults["one TF32 pass"] = sum(gcn.gcn_layer_plain(vertexes, edges, *weights, **kw), [])
        seen = {f: sum(outside(a, b, **tol) for a, b in zip(bad, (want_v + want_e)[:len(bad)]))
                for f, bad in faults.items()}
        for f, n in seen.items():
            assert n, f"gcn_layer {dt}: the check cannot see {f}"
        one_pass = None
        if dt == f32:
            one_pass = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(faults["one TF32 pass"], want_v + want_e))
        print(f"[gcn_layer]   {str(dt)[6:]}: values a planted fault puts outside tol: {seen}"
              + (f"; one TF32 pass moves them by up to {one_pass:.3g}" if one_pass else ""))
        layer = lambda: gcn.fused_gcn_layer(vertexes, edges, *weights, **kw)
        with torch.inference_mode():
            ms = cuda_ms(layer)
            per_launch = by_launch(kernel_device_ms(torch, layer))
            dev_ms = sum(per_launch.values())
            plain_ms = cuda_ms(lambda: gcn.gcn_layer_plain(vertexes, edges, *weights, **kw))
            # the yardstick of the product part alone (the port never calls it):
            # cuBLAS x . W_h^T over the 2BC entity rows and the 2B mention rows
            rows = [vertexes[2].view(-1, D), vertexes[3].view(-1, D), torch.cat(vertexes[:2])]
            product = lambda: [F.linear(x, weights[0]) for x in rows]
            cublas_ms = cuda_ms(product)
            cublas_dev_ms = device_ms(product)
        # x.W_h^T over 2*B*C + 2*B rows, the fold's two products over 2*B rows;
        # et, ei read and written once, the mention rows, edges and weights once
        flops = 2 * (2 * B * C + 2 * B) * D * D + 2 * 2 * (2 * B) * D * D
        moved = nbytes(*vertexes, *edges, *weights) + nbytes(*got_v, *got_e)
        times = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                 "device_ms": dev_ms, "device_ms_by_launch": per_launch,
                 "cublas_product_ms": cublas_ms, "cublas_product_device_ms": cublas_dev_ms}
        if dt == bf16:
            bound_ms, bound_by = bound(moved, flops)
            print(f"[gcn_layer] B=64 C=101 D=768 bf16 layer call: kernel {ms:.4f} ms (device "
                  f"{dev_ms:.4f}: {per_launch}), plain {plain_ms:.4f} ms, cuBLAS product alone "
                  f"{cublas_ms:.4f} ms (device {cublas_dev_ms:.4f}; a yardstick, never called), "
                  f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
                  f"{moved / 1e6:.1f} MB)")
            result.update(times, bound_ms=bound_ms, bound_by=bound_by)
        else:
            bound_ms, bound_by, fma_ms = f32_bound(moved, flops)
            print(f"[gcn_layer] B=64 C=101 D=768 f32 layer call (split TF32): kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f}: {per_launch}), plain {plain_ms:.4f} ms, cuBLAS f32 product "
                  f"alone {cublas_ms:.4f} ms (device {cublas_dev_ms:.4f}; a yardstick, never called); "
                  f"bound {bound_ms:.4f} ms ({bound_by}, the TF32 route: {flops / 1e9:.2f} GFLOP x 3 "
                  f"at 495 TFLOP/s, {moved / 1e6:.1f} MB), FMA bound {fma_ms:.4f} ms; device / bound "
                  f"{dev_ms / bound_ms:.2f}")
            result["f32"] = {"shape": [B, C, D], **times, "bound_ms": bound_ms, "bound_by": bound_by,
                             "fma_bound_ms": fma_ms, "one_tf32_pass_err": one_pass}
    for D, dt in ((96, bf16), (256, bf16), (32, f32), (48, f32)):
        vertexes, edges, weights = _gcn_inputs(torch, 2, 5, D, dt, SEED)
        try:
            gcn.fused_gcn_layer(vertexes, edges, *weights)
            raise AssertionError(f"gcn_layer: D={D} {dt} was accepted")
        except ValueError as e:
            assert "built for D in" in str(e), e
    return result


def _attn_inputs(torch, np, B, H, L, dt, seed, lens=None, drop=None):
    """Unit-normal q, k, v as BERT hands them over: [B, H, L, 64] views of
    [B, L, H*64] projections.  At Dh=64 the logits q.k/8 then have unit
    spread (about +-4 over a row of 512 keys), so the softmax is far from
    uniform and a wrong key tile moves the output by O(1).  ``lens`` keeps a
    prefix of each sequence's keys (0 = every key dropped); the mask holds
    ``drop`` for a dropped key, ``finfo.min`` if None."""
    rng = np.random.default_rng(seed)
    mk = lambda: torch.from_numpy(rng.standard_normal((B, L, H * 64), dtype=np.float32)).to(
        "cuda", dt).reshape(B, L, H, 64).transpose(1, 2)
    q, k, v = mk(), mk(), mk()
    mask = None
    if lens is not None:
        keep = torch.arange(L, device="cuda")[None] < torch.as_tensor(lens, device="cuda")[:, None]
        mask = torch.zeros((B, L), dtype=dt, device="cuda").masked_fill(
            ~keep, torch.finfo(dt).min if drop is None else drop)
    return q, k, v, mask


def phase_attention(torch, np, attn):
    """Kernel 3 against attention_plain, both on the card; the check must
    also fail each planted fault of the plain version."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    # the main shape: one B=8 request's entity tower, [8*12, 12, 512, 64] bf16;
    # prefixes from under one key tile to all 512 keys, one sequence all dropped
    main_lens = rng.integers(9, 513, 96)
    main_lens[:9] = [512, 40, 63, 64, 65, 0, 127, 128, 129]  # around the key tiles' edges
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("main", 96, 12, 512, bf16, main_lens),
             ("L=256", 16, 12, 256, bf16, rng.integers(1, 257, 16)),
             ("L=384", 16, 12, 384, bf16, rng.integers(1, 385, 16)),
             ("L=264 ragged", 16, 12, 264, bf16, rng.integers(200, 265, 16)),
             ("no mask", 16, 12, 512, bf16, None),
             ("f32", 4, 12, 512, f32, [512, 300, 17, 0]),
             ("f32 L=264 no mask", 2, 12, 264, f32, None),
             ("f32 L=264 ragged", 4, 12, 264, f32, [264, 200, 9, 0]),
             ("f32 main", 96, 12, 512, f32, main_lens),  # a default-dtype online train step's
             ("B'=1", 1, 12, 512, bf16, [77]),
             # one block's rows exactly, one tile and eight rows, eight rows short of 512
             ("L=128", 8, 12, 128, bf16, [128, 127, 65, 64, 63, 1, 0, 100]),
             ("L=136 ragged", 8, 12, 136, bf16, [136, 129, 128, 127, 64, 8, 0, 135]),
             ("L=504 ragged", 4, 12, 504, bf16, [504, 500, 129, 0]),
             ("L=8", 2, 12, 8, bf16, [8, 3]),
             ("L=256", 4, 12, 256, bf16, [256, 100, 0, 1])]
    # the f32 kernel (split-precision TF32 on wgmma) at the same edges: a
    # single sequence, one block's rows, one tile and eight rows, eight rows
    # short of 512, a sequence shorter than a tile
    f32_cases = [("f32 B'=1", 1, 12, 512, f32, [77]),
                 ("f32 L=128", 8, 12, 128, f32, [128, 127, 65, 64, 63, 1, 0, 100]),
                 ("f32 L=136 ragged", 8, 12, 136, f32, [136, 129, 128, 127, 64, 8, 0, 135]),
                 ("f32 L=504 ragged", 4, 12, 504, f32, [504, 500, 129, 0]),
                 ("f32 L=8", 2, 12, 8, f32, [8, 3])]
    cases = [c + (None,) for c in cases] + [(f"{c[0]}, dropped keys at {drop:g}",) + c[1:] + (drop,)
                                            for c in cases[-1:] for drop in OTHER_DROPS] + [
        c + (None,) for c in f32_cases]
    result = None
    for i, (name, B, H, L, dt, lens, drop) in enumerate(cases):
        q, k, v, mask = _attn_inputs(torch, np, B, H, L, dt, SEED + i, lens, drop)
        with torch.inference_mode():
            got = attn.fused_attention(q, k, v, mask)
            torch.cuda.synchronize()
            want = attn.attention_plain(q, k, v, mask)
            if i % 2 or dt == f32:  # contiguous [B, H, L, 64] inputs take the same kernel
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
        if name == "f32":
            # the reach of the f32 check: the plain version with each product's
            # operands rounded to TF32, one pass (what the split is there to avoid)
            r = lambda x: tf32_round(torch, x.float())
            with torch.inference_mode():
                logits = torch.einsum("bhqd,bhkd->bhqk", r(q), r(k)) / 8 + mask[:, None, None, :]
                one_pass = torch.einsum("bhqk,bhkd->bhqd", r(torch.softmax(logits, -1)), r(v))
            n_out = outside(one_pass, want, **tol)
            assert n_out, "attention f32: the check cannot see one TF32 pass"
            print(f"[attention]   f32: the plain version with one TF32 pass moves "
                  f"{(one_pass - want).abs().max().item():.3g} and puts {n_out} of {want.numel()} "
                  f"values outside tol; the kernel's max abs err {err:.3g}")
            del logits, one_pass
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
            dev_ms = device_ms(lambda: attn.fused_attention(q, k, v, mask))
            plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v, mask))
            lib_mask = mask[:, None, None, :]
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask)
            # PyTorch gives a sequence whose every key is dropped another
            # answer than the mean of V, so the two are compared apart from it
            dropped = torch.as_tensor(main_lens == 0, device="cuda")
            lib_diff = (lib.float() - want.float()).abs().amax((1, 2, 3))
            lib_err, lib_err_dropped = lib_diff[~dropped].max().item(), lib_diff[dropped].max().item()
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask))
            lib_dev_ms = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask))
        flops = 4 * L * L * 64 * B * H  # the two products
        moved = nbytes(q, k, v, mask, got)
        bound_ms, bound_by = bound(moved, flops)
        print(f"[attention] [96,12,512,64] bf16, masked: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, F.scaled_dot_product_attention {library_ms:.4f} ms (yardstick only; max abs "
              f"diff to plain {lib_err:.3g}, on the sequence with every key dropped "
              f"{lib_err_dropped:.3g}), bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e9:.1f} GFLOP, {moved / 1e6:.1f} MB)")
        print(f"[attention]   device time alone (torch.profiler): kernel {dev_ms:.4f} ms, "
              f"F.scaled_dot_product_attention {lib_dev_ms:.4f} ms; before the redesign the "
              f"kernel took {ATTN_EARLIER_MS['attention']} ms (PERF.md), now {ms:.4f} ms")
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": library_ms, "device_ms": dev_ms,
                  "library_device_ms": lib_dev_ms}
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


def _faulty_attention(torch, attn, fault: str):
    """attention_plain with a planted fault in its backward, which keeps the
    kernels' rounding points otherwise: "delta left out of dS", or "one TF32
    pass" (every product's operands rounded to TF32: the f32 kernels without
    their split)."""
    r = (lambda x: tf32_round(torch, x)) if fault == "one TF32 pass" else (lambda x: x)

    class Faulty(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask):
            ctx.save_for_backward(q, k, v, mask)
            return attn.attention_plain(q, k, v, mask)

        @staticmethod
        def backward(ctx, do):
            q, k, v, mask = ctx.saved_tensors
            f, dt = torch.float32, q.dtype
            q, k, v, do = (x.to(f) for x in (q, k, v, do))
            logits = torch.einsum("bhqd,bhkd->bhqk", r(q), r(k)) * 0.125
            if mask is not None:
                logits = logits + mask[:, None, None, :].to(f)
            p = torch.softmax(logits, -1)
            dp = torch.einsum("bhqd,bhkd->bhqk", r(do), r(v))
            ds = p * dp if fault == "delta left out of dS" else p * (dp - (p * dp).sum(-1, keepdim=True))
            ds = r(ds.to(dt).to(f))
            dq = torch.einsum("bhqk,bhkd->bhqd", ds, r(k)) * 0.125
            dk = torch.einsum("bhqk,bhqd->bhkd", ds, r(q)) * 0.125
            dv = torch.einsum("bhqk,bhqd->bhkd", r(p.to(dt).to(f)), r(do))
            return dq.to(dt), dk.to(dt), dv.to(dt), None

    return Faulty.apply


def _plain_bwd_faults(torch, attn, q, k, v, mask, do):
    """dq and dk of the plain backward with each planted fault of
    ``_faulty_attention``, on the first 8 sequences."""
    out = {}
    for fault in ("one TF32 pass", "delta left out of dS"):
        leaves = [x[:8].detach().requires_grad_(True) for x in (q, k, v)]
        o = _faulty_attention(torch, attn, fault)(*leaves, None if mask is None else mask[:8])
        out[fault] = torch.autograd.grad(o, leaves[:2], do[:8])
    return out


def phase_attention_bwd(torch, np, attn):
    """Kernels 3b (masked, with the mask's cotangent) and 3c (no mask)
    against attention_backward_plain, both on the card; the check must also
    fail each planted fault of the plain version.  The float32 forms are
    timed at [4, 12, 512, 64] masked, [2, 12, 264, 64] without a mask and
    the online train step's [96, 12, 512, 64] masked."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    main_lens = rng.integers(9, 513, 96)
    # around the tiles' edges; one sequence with every key dropped
    main_lens[:9] = [512, 40, 63, 64, 65, 0, 127, 128, 129]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("main", 96, 12, 512, bf16, main_lens),
             ("main, no mask", 96, 12, 512, bf16, None),
             ("L=256", 16, 12, 256, bf16, rng.integers(1, 257, 16)),
             ("L=384", 16, 12, 384, bf16, rng.integers(1, 385, 16)),
             ("L=264 ragged", 16, 12, 264, bf16, rng.integers(200, 265, 16)),
             ("L=264 ragged, no mask", 4, 12, 264, bf16, None),
             ("f32", 4, 12, 512, f32, [512, 300, 17, 0]),
             ("f32 L=264 no mask", 2, 12, 264, f32, None),
             ("f32 L=264 ragged", 4, 12, 264, f32, [264, 200, 9, 0]),
             ("f32 main", 96, 12, 512, f32, main_lens),  # a default-dtype online train step's
             ("B'=1", 1, 12, 512, bf16, [77]),
             # one block's rows exactly, one tile and eight rows, eight rows short of 512
             # (the sequence that keeps one key has a constant softmax: its dq, dk and
             # dmask are exactly 0 and are held to the floor of the batch's largest sequence)
             ("L=128", 8, 12, 128, bf16, [128, 127, 65, 64, 63, 1, 0, 100]),
             ("L=136 ragged", 8, 12, 136, bf16, [136, 129, 128, 127, 64, 8, 0, 135]),
             ("L=136 ragged, no mask", 2, 12, 136, bf16, None),
             ("L=504 ragged", 4, 12, 504, bf16, [504, 500, 129, 0]),
             ("L=8", 2, 12, 8, bf16, [8, 3]),
             ("L=256", 4, 12, 256, bf16, [256, 100, 0, 1])]
    cases = [c + (None,) for c in cases] + [(f"{c[0]}, dropped keys at {drop:g}",) + c[1:] + (drop,)
                                            for c in cases[-1:] for drop in OTHER_DROPS]
    names = ("dq", "dk", "dv", "dmask")
    f32_timed = {"f32": ("attention_bwd", "f32"), "f32 L=264 no mask": ("attention_bwd_nomask", "f32"),
                 "f32 main": ("attention_bwd", "f32_train_step_shape")}
    results, f32_times = {}, {}
    for i, (name, B, H, L, dt, lens, drop) in enumerate(cases):
        q, k, v, mask = _attn_inputs(torch, np, B, H, L, dt, SEED + i, lens, drop)
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
        if i % 2 or dt == f32:  # a contiguous gradient takes the same kernels
            again = _attn_grads(torch, attn, q, k, v, mask, do.contiguous())
            for a, b in zip(again, got):
                assert torch.equal(a, b), f"attention bwd {name}: contiguous dO != strided"
        if not i % 2 or dt == f32:  # and the same inputs give the same bits again: no atomics
            again = _attn_grads(torch, attn, q, k, v, mask, do)
            for a, b in zip(again, got):
                assert torch.equal(a, b), f"attention bwd {name}: two runs differ"
        del again
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
        row = "attention_bwd" if mask is not None else "attention_bwd_nomask"
        if dt == f32:
            # the reach of the f32 check: the plain version with one TF32 pass, or
            # without delta, must fall outside the tolerance
            seen = {f_: outside_rel(a, want[0][:8], **tol) + outside_rel(b, want[1][:8], **tol)
                    for f_, (a, b) in _plain_bwd_faults(torch, attn, q, k, v, mask, do).items()}
            for f_, n in seen.items():
                assert n, f"attention bwd {name}: the check cannot see the plain version with {f_}"
            print(f"[attention_bwd]   dq and dk values a planted fault puts outside tol: {seen}")
        if name in f32_timed:
            t_ = _attn_bwd_times(torch, np, F, attn, q, k, v, mask, do, got, want, lens, err)[0]
            f32_times[f32_timed[name]] = t_
            earlier = ATTN_EARLIER_MS.get(f"{row}_f32") if name != "f32 main" else None
            print(f"[attention_bwd] {name} [{B},{H},{L},64] f32 (split-precision TF32 on wgmma): "
                  f"kernels {t_['ms']:.4f} ms (device {t_['device_ms']:.4f}: {t_['device_ms_by_kernel']}), "
                  f"plain {t_['plain_ms']:.4f} ms, autograd through F.scaled_dot_product_attention f32 {t_['library_ms']:.4f} ms "
                  f"(device {t_['library_device_ms']:.4f}); bound {t_['bound_ms']:.4f} ms "
                  f"({t_['bound_by']}, the TF32 route: three TF32 products per product at 495 "
                  f"TFLOP/s), FMA bound {t_['fma_bound_ms']:.4f} ms; device / bound "
                  f"{t_['device_ms'] / t_['bound_ms']:.2f}"
                  + (f"; plain FMA before the redesign: {earlier} ms (PERF.md)" if earlier else ""))
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
        t_, flops, moved = _attn_bwd_times(torch, np, F, attn, q, k, v, mask, do, got, want,
                                           lens, err)
        print(f"[attention_bwd] [96,12,512,64] bf16, {'masked' if mask is not None else 'no mask'}: "
              f"kernels {t_['ms']:.4f} ms, plain {t_['plain_ms']:.4f} ms, autograd through "
              f"F.scaled_dot_product_attention {t_['library_ms']:.4f} ms (yardstick only; max abs "
              f"diff to plain on the sequences that keep a key {t_['library_max_abs_diff']:.3g}), "
              f"bound {t_['bound_ms']:.4f} ms ({t_['bound_by']}: {flops / 1e9:.1f} GFLOP, "
              f"{moved / 1e6:.1f} MB)")
        print(f"[attention_bwd]   device time alone (torch.profiler): kernels {t_['device_ms']:.4f} "
              f"ms, autograd through F.scaled_dot_product_attention {t_['library_device_ms']:.4f} ms; "
              f"before the redesign the kernels took {ATTN_EARLIER_MS[row]} ms (PERF.md), now "
              f"{t_['ms']:.4f} ms")
        results[row] = t_
    for bad, why in ((lambda q, k, v: (q.half(), k.half(), v.half()), "fp16"),
                     (lambda q, k, v: (q[..., :32], k[..., :32], v[..., :32]), "Dh=32"),
                     (lambda q, k, v: (q[:, :, :260], k[:, :, :260], v[:, :, :260]), "L % 8")):
        q, k, v, _ = _attn_inputs(torch, np, 2, 12, 264, bf16, SEED)
        try:
            attn.fused_attention(*(t.detach().requires_grad_(True) for t in bad(q, k, v)))
            raise AssertionError(f"attention with a gradient: {why} was accepted")
        except ValueError:
            pass
    for (row, key), times in f32_times.items():
        results[row][key] = times
    return results


def _kernel_name(key: str) -> str:
    """A kernel's name without its namespace, return type and parameters, as
    the profiler's key holds it demangled (``void (anonymous
    namespace)::name<..>(..)``; a parameter type may carry the namespace too)."""
    name = key.replace("(anonymous namespace)::", "").split("(")[0]
    return name[len("void "):] if name.startswith("void ") else name


def _attn_bwd_times(torch, np, F, attn, q, k, v, mask, do, got, want, lens, err) -> dict:
    """The two backward launches alone on one forward's residuals, the plain
    backward and autograd through F.scaled_dot_product_attention (a
    yardstick; its largest difference to the plain version over the
    sequences that keep a key), beside the bound: bf16 products at the bf16
    peak, float32 ones by the tensor cores' split-TF32 route (the FMA bound
    beside it).  Returns (times, flops, bytes moved); the last two are for
    the printed line only."""
    B, H, L, _ = q.shape
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = attn.fused_attention(*leaves, mask)
    o, m, l = out.grad_fn.saved_tensors[4:7]
    with torch.no_grad():
        ms = cuda_ms(lambda: attn._launch_backward(q, k, v, mask, o, do, m, l, False))
        per_kernel = kernel_device_ms(torch, lambda: attn._launch_backward(q, k, v, mask, o, do, m, l, False))
        dev_ms = sum(per_kernel.values())
        plain_ms = cuda_ms(lambda: attn.attention_backward_plain(q, k, v, mask, do), reps=5, warmup=1)
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=None if mask is None else mask[:, None, None, :])
    lib_grad = lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True)
    library_ms, lib_dev_ms = cuda_ms(lib_grad), device_ms(lib_grad)
    kept = torch.as_tensor(np.ones(B, bool) if lens is None else np.asarray(lens) > 0, device="cuda")
    lib_err = max((a.float() - b.float())[kept].abs().max().item() for a, b in zip(lib_grad(), want))
    flops = 10 * L * L * 64 * B * H  # the five products
    moved = nbytes(q, k, v, o, do, m, l, *got[:3]) + (nbytes(mask) if mask is not None else 0)
    times = {"shape": [B, H, L, 64], "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
             "device_ms_by_kernel": {_kernel_name(k): round(v, 5) for k, v in per_kernel.items()},
             "plain_ms": plain_ms, "library_ms": library_ms, "library_device_ms": lib_dev_ms,
             "library_max_abs_diff": lib_err}
    if q.dtype == torch.float32:
        times["bound_ms"], times["bound_by"], times["fma_bound_ms"] = f32_bound(moved, flops)
    else:
        times["bound_ms"], times["bound_by"] = bound(moved, flops)
    return times, flops, moved


def _vertex_inputs(torch, B, C, D, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda *s: torch.rand(*s, generator=g, device="cuda")
    # v, e1, m1, e2, m2, w [out, in], b, ln scale, ln bias
    return [r(B, C, D).to(dt), u(B, C).to(dt), r(B, D).to(dt), u(B, C).to(dt), r(B, D).to(dt),
            ((u(D, D) * 2 - 1) * D ** -0.5).to(dt), ((u(D) * 2 - 1) * D ** -0.5).to(dt),
            (1 + 0.1 * r(D)).to(dt), (0.1 * r(D)).to(dt)]


def phase_vertex_update(torch, vu, gcn):
    """Kernel 4 against vertex_update_plain, both on the card, in bf16 and
    float32; the check must also fail the plain version with e2*m2 left out,
    and in float32 at the WikiMEL width the plain version with its product
    in one TF32 pass."""
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(64, 101, 768, bf16, "gelu"),   # the WikiMEL width
             (64, 101, 768, f32, "gelu"),
             (5, 11, 128, bf16, "relu"), (5, 11, 128, f32, "tanh"),
             (5, 11, 128, bf16, "sigmoid"), (3, 33, 128, f32, "sigmoid"),
             (1, 1, 128, bf16, "gelu"), (1, 1, 128, f32, "relu"), (1, 101, 768, bf16, "tanh"),
             (1, 101, 768, f32, "tanh"), (2, 64, 768, bf16, "gelu"), (2, 64, 768, f32, "gelu")]
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
        again = vu.fused_vertex_update(*args, act=act)
        assert torch.equal(got, again), f"vertex_update B={B} C={C} D={D} {dt}: two runs differ"
        one_pass = None
        if i == 1:  # float32 at the WikiMEL width: the kernel without its split
            with torch.inference_mode(), tf32_products(gcn):
                bad = vu.vertex_update_plain(*args, act=act)
            one_pass = (bad - want).abs().max().item()
            assert outside(bad, want, **tol), "vertex_update: the check cannot see one TF32 pass"
        print(f"[vertex_update] B={B} C={C} D={D} {str(dt)[6:]} {act}: max abs err {err:.3g} "
              f"(tol {tol}), two runs bit-equal; values outside tol with e2*m2 left out: {seen} of "
              f"{want.numel()}" + (f"; one TF32 pass moves them by up to {one_pass:.3g}" if one_pass else ""))
        if i > 1:  # cases 0 and 1, bf16 and f32 at the WikiMEL width, are timed
            continue
        call = lambda: vu.fused_vertex_update(*args, act=act)
        with torch.inference_mode():
            ms = cuda_ms(call)
            per_launch = by_launch(kernel_device_ms(torch, call))
            dev_ms = sum(per_launch.values())
            plain_ms = cuda_ms(lambda: vu.vertex_update_plain(*args, act=act))
            rows = args[0].view(-1, D)
            cublas_ms = cuda_ms(lambda: F.linear(rows, args[5]))
            cublas_dev_ms = device_ms(lambda: F.linear(rows, args[5]))
        flops = 2 * B * C * D * D
        moved = nbytes(*args, got)
        times = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                 "device_ms_by_launch": per_launch, "cublas_product_ms": cublas_ms,
                 "cublas_product_device_ms": cublas_dev_ms}
        if dt == bf16:
            bound_ms, bound_by = bound(moved, flops)
            print(f"[vertex_update] B=64 C=101 D=768 bf16: kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                  f"plain {plain_ms:.4f} ms, cuBLAS product alone {cublas_ms:.4f} ms (device "
                  f"{cublas_dev_ms:.4f}; a yardstick, never called), bound {bound_ms:.4f} ms "
                  f"({bound_by}: {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB)")
            result = {**times, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        else:  # the float32 form (split TF32)
            bound_ms, bound_by, fma_ms = f32_bound(moved, flops)
            print(f"[vertex_update] B=64 C=101 D=768 f32 (split TF32): kernel {ms:.4f} ms (device "
                  f"{dev_ms:.4f}: {per_launch}), plain {plain_ms:.4f} ms, cuBLAS f32 product alone {cublas_ms:.4f} "
                  f"ms (device {cublas_dev_ms:.4f}; a yardstick, never called); bound {bound_ms:.4f} "
                  f"ms ({bound_by}, the TF32 route: {flops / 1e9:.2f} GFLOP x 3 at 495 TFLOP/s, "
                  f"{moved / 1e6:.1f} MB), FMA bound {fma_ms:.4f} ms; device / bound "
                  f"{dev_ms / bound_ms:.2f}")
            result["f32"] = {"shape": [B, C, D], **times, "bound_ms": bound_ms, "bound_by": bound_by,
                             "fma_bound_ms": fma_ms, "one_tf32_pass_err": one_pass}
    args = _vertex_inputs(torch, 4, 11, 128, bf16, SEED)
    for bad, exc, why in ((lambda a: [a[0].half()] + a[1:], ValueError, "fp16"),
                          (lambda a: [a[0][:, :, :127]] + a[1:], ValueError, "shape"),
                          (lambda a: [x[..., :64] if x.shape[-1] == 128 else x for x in a],
                           ValueError, "D=64"),
                          (lambda a: [x.float()[..., :32] if x.shape[-1] == 128 else x.float() for x in a],
                           ValueError, "D=32 f32"),
                          (lambda a: [x.float()[..., :48] if x.shape[-1] == 128 else x.float() for x in a],
                           ValueError, "D=48 f32"),
                          (lambda a: [a[0].requires_grad_(True)] + a[1:], RuntimeError, "grad")):
        try:
            vu.fused_vertex_update(*bad(list(args)))
            raise AssertionError(f"vertex_update: {why} was accepted")
        except exc:
            pass
    return result


def post_rank(np, url, fields, feats, k=5, timeout=600):
    """POST /rank with the named feature fields; (top-k scores, indices)."""
    from drin_tpu_torch.serve import _encode_arrays

    body = json.dumps({"features": _encode_arrays(dict(zip(fields, feats))), "k": k})
    req = urllib.request.Request(url + "/rank", data=body.encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200, resp.status
        out = json.loads(resp.read())
    return np.asarray(out["scores"]), np.asarray(out["indices"])


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
    from drin_tpu_torch.serve import Ranker, rank_feat_fields, serve_http

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

    post = lambda feats, k=5: post_rank(np, url, fields, feats, k)

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
        score_err, wants = 0.0, {}
        for B, (s, i) in served.items():
            assert s.shape == i.shape == (B, 5) and np.isfinite(s).all(), (B, s.shape, i.shape)
            full = ranker.score(batches[B])
            want = wants[B] = reference.score(batches[B])
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
    return launches, score_err, {"ranker": ranker, "reference": reference, "weights": weights,
                                 "tables": tables, "batches": batches, "want_scores": wants}


# served float32 DRIN scores (the default compute_dtype) against the port's
# f32 CPU forward of the same request over the same int8 rows: cuBLAS's f32
# products and kernel 1's split-TF32 ones sum in another order than the CPU.
# On an H100 the kernels read 8.3e-7 and the layers' products in one TF32
# pass 7.8e-5: the first limit, 1e-4, would have let that fault pass, so the
# limit sits between the two readings
SCORE_F32_ATOL = 1e-5


@contextlib.contextmanager
def plain_gcn_layers(gcn, tf32: bool = False):
    """DRIN's GCN layers through gcn_layer_plain on the card instead of
    kernel 1 for the block (with ``tf32``, its products in one TF32 pass: the
    float32 kernel without its split)."""
    from drin_tpu_torch.models import drin as drin_model

    saved = drin_model.fused_gcn_layer
    drin_model.fused_gcn_layer = gcn.gcn_layer_plain
    try:
        with tf32_products(gcn) if tf32 else contextlib.nullcontext():
            yield
    finally:
        drin_model.fused_gcn_layer = saved


def phase_serve_drin_f32(torch, np, gather, gcn, drin):
    """DRIN's rank stage with the configuration's default compute dtype,
    float32, over phase_slice's store rows, weights and requests: kernel 1's
    float32 form (split-precision TF32) on every GCN layer.  Scores against
    phase_slice's f32 CPU forward; the same forward with the layers' products
    in one TF32 pass printed beside."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.serve import Ranker, rank_feat_fields, serve_http

    cfg = make_config("drin", "wikimel")
    assert cfg.compute_dtype == "float32", cfg.compute_dtype
    t0 = time.perf_counter()
    ranker = Ranker(cfg, drin["weights"], drin["tables"], device="cuda", quantize_store=True,
                    fused_gather=True)
    torch.cuda.synchronize()
    print(f"[serve_drin_f32] Ranker(make_config('drin', 'wikimel'): compute_dtype {cfg.compute_dtype}, "
          f"quantize_store, fused_gather) on cuda: built in {time.perf_counter() - t0:.1f} s")
    batches, wants = drin["batches"], drin["want_scores"]
    fields = rank_feat_fields(ranker)
    server = serve_http(ranker, port=0, feat_fields=fields)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    post = lambda feats, k=5: post_rank(np, url, fields, feats, k)
    try:
        # the main path, counted: /rank at B=1, Ranker.rank at B=64
        gather.launches = gcn.launches = 0
        with gcn_dtypes(gcn) as seen:
            served = {1: post(batches[1]), 64: ranker.rank(batches[64], k=5)}
            torch.cuda.synchronize()
        launches = {"gather_dequant": gather.launches, "gcn_layer": gcn.launches}
        print(f"[serve_drin_f32] launches over 2 forwards: {launches}, kernel 1 by dtype {seen}")
        assert launches == {"gather_dequant": 2, "gcn_layer": 2 * cfg.num_gcn_layers}, launches
        assert seen == ["float32"] * 2 * cfg.num_gcn_layers, seen
        errs, full64 = {}, None
        for B, (s, i) in served.items():
            assert s.shape == i.shape == (B, 5) and np.isfinite(s).all(), (B, s.shape, i.shape)
            full = ranker.score(batches[B])
            assert full.shape == wants[B].shape == (B, cfg.num_candidates_model)
            np.testing.assert_allclose(s, np.take_along_axis(full, i, -1), rtol=0, atol=1e-6)
            errs[B] = float(np.abs(full - wants[B]).max())
            full64 = full
        with plain_gcn_layers(gcn, tf32=True):
            tf32_err = float(np.abs(ranker.score(batches[64]) - wants[64]).max())
        with plain_gcn_layers(gcn):
            plain_err = float(np.abs(ranker.score(batches[64]) - wants[64]).max())
        print(f"[serve_drin_f32] scores vs the f32 CPU forward, max abs err: B=1 {errs[1]:.3g}, B=64 "
              f"{errs[64]:.3g} (limit {SCORE_F32_ATOL}); the same B=64 forward on the card with the "
              f"plain layer {plain_err:.3g}, with the plain layer's products in one TF32 pass "
              f"{tf32_err:.3g}; spread of one mention's candidates {float(np.ptp(full64, -1).mean()):.3g}")
        assert max(errs.values()) <= SCORE_F32_ATOL, errs
        assert tf32_err > SCORE_F32_ATOL, f"the float32 score check cannot see one TF32 pass: {tf32_err}"
        ms_b1 = host_ms(lambda: post(batches[1]))
        ms_b64 = host_ms(lambda: ranker.rank(batches[64], k=5))
        pairs = 64 * cfg.num_candidates_model / (ms_b64 / 1e3)
        print(f"[serve_drin_f32] /rank B=1: {ms_b1:.3f} ms per request (HTTP, median of 10); "
              f"Ranker.rank B=64: {ms_b64:.3f} ms, {pairs:.0f} pairs/s")
        prof = profile_rank(torch, ranker, batches[64], "float32 B=64")
    finally:
        server.shutdown()
        server.server_close()
    stats = {"rank_b64_ms": ms_b64, "rank_b1_http_ms": ms_b1, "score_err": errs,
             "tf32_fault_err": tf32_err, "plain_layer_err": plain_err}
    if prof is not None:
        layer_ms = sum(ms for k, ms in prof["device_ms_by_kernel"].items()
                       if "gcn_rows" in k or "split_w_f32" in k)
        print(f"[serve_drin_f32] kernel 1 (float32) {layer_ms:.3f} ms of {prof['busy_ms']:.3f} ms device "
              f"busy ({layer_ms / prof['busy_ms']:.3f}); idle share {prof['idle']:.3f}")
        stats.update(busy_ms=prof["busy_ms"], idle=prof["idle"], gcn_layer_device_ms=layer_ms)
    return launches, stats


def _concurrent(fns, timeout=600):
    """Run each callable on a thread of its own, released together by a
    barrier; their results in order (an exception is raised here)."""
    import concurrent.futures as cf
    import threading

    bar = threading.Barrier(len(fns))

    def run(fn):
        bar.wait(timeout=120)
        return fn()

    with cf.ThreadPoolExecutor(len(fns)) as ex:
        return [f.result(timeout=timeout) for f in [ex.submit(run, fn) for fn in fns]]


def _post_json(url, path, obj, timeout=600):
    req = urllib.request.Request(url + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200, resp.status
        return json.loads(resp.read())


def _get_json(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read())


def phase_serve_batched(torch, np, kernels, drin):
    """DRIN's rank stage as a deployment: phase_slice's ranker (the fused
    int8 store of 32,768 entities) saved as a bundle, served by the CLI
    behind the micro-batching front, and 32 HTTP clients of B=1-4 sending
    two requests each at once.  Each reply must lie within the DRIN limit of
    the f32 CPU forward and within BATCHED_ATOL of the same request ranked
    alone; /stats must show fewer device calls than requests."""
    import tempfile

    from drin_tpu_torch import serve as tserve
    from drin_tpu_torch.serve import rank_feat_fields

    src, reference = drin["ranker"], drin["reference"]
    cfg = src.cfg
    with tempfile.TemporaryDirectory() as bundle:
        t0 = time.perf_counter()
        src.save_bundle(bundle)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(bundle, tserve.BUNDLE_STATE))
        t0 = time.perf_counter()
        server = tserve.main([f"bundle={bundle}", "quantize_store=true", "fused_gather=true",
                              "micro_batch=true", "device=cuda", "port=0"])
        load_s = time.perf_counter() - t0
    front = server.front
    ranker = front.ranker
    moved = int((ranker.store.packed != src.store.packed).sum())
    print(f"[serve_batched] bundle of {size / 2**20:.1f} MiB saved in {save_s:.1f} s, served by "
          f"main(bundle=..., quantize_store, fused_gather, micro_batch) in {load_s:.1f} s; int8 "
          f"codes that moved in the dequantize / re-quantize round trip: {moved} of "
          f"{ranker.store.packed.numel()}")
    url = f"http://127.0.0.1:{server.server_address[1]}"
    fields = rank_feat_fields(front)
    clients, rounds = 32, 2
    reqs = [_rows_batch(np, cfg, 1 + i % 4, SEED + 500 + i) for i in range(clients * rounds)]
    warm = [_rows_batch(np, cfg, 1, SEED + 499)] * 2
    wall = {}

    def client(c):
        out = []
        for r in range(rounds):
            feats = reqs[c * rounds + r]
            t = time.perf_counter()
            out.append(post_rank(np, url, fields, feats))
            wall[c * rounds + r] = (time.perf_counter() - t) * 1e3
        return out

    try:
        # the main path, counted: two requests one after the other, then the
        # 32 clients at once; the counts are read after the server and the
        # front have shut down (the flushes launch from the front's threads)
        zero_counts(kernels)
        for feats in warm:
            post_rank(np, url, fields, feats)
        t0 = time.perf_counter()
        replies = [rep for per in _concurrent([lambda c=c: client(c) for c in range(clients)])
                   for rep in per]
        burst_s = time.perf_counter() - t0
        stats = _get_json(url, "/stats")
    finally:
        server.shutdown()
        server.server_close()
        front.close()
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    sent = len(warm) + len(reqs)
    print(f"[serve_batched] {sent} requests ({len(warm)} alone, then {clients} clients x {rounds} "
          f"of B=1-4, {sum(r[0].shape[0] for r in reqs)} rows, in {burst_s:.2f} s): "
          f"batches_run {stats['batches_run']}, rows_run {stats['rows_run']}, batch_buckets "
          f"{stats['batch_buckets']}, the front's latency {stats['latency']}; launches {counts}")
    assert stats["micro_batched"] and stats["rows_run"] == 2 + sum(r[0].shape[0] for r in reqs)
    assert stats["batches_run"] < sent, (stats["batches_run"], sent)
    assert counts["gather_dequant"] == stats["batches_run"], counts
    assert counts["gcn_layer"] == cfg.num_gcn_layers * stats["batches_run"], counts
    assert sum(counts.values()) == counts["gather_dequant"] + counts["gcn_layer"], counts
    lat = sorted(wall.values())
    print(f"[serve_batched] client-side /rank latency over the {len(lat)} concurrent requests: "
          f"p50 {lat[len(lat) // 2]:.2f} ms, p99 {lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.2f} "
          f"ms, max {lat[-1]:.2f} ms")
    # every reply against the f32 CPU forward (rows are scored one by one, so
    # one call over all of them is the same forward) and against the same
    # request ranked alone on the card
    want = reference.score(tuple(np.concatenate(col) for col in zip(*reqs)))
    to_ref = to_alone = 0.0
    off = 0
    for feats, (s, i) in zip(reqs, replies):
        B = feats[0].shape[0]
        assert s.shape == i.shape == (B, 5) and np.isfinite(s).all(), (B, s.shape)
        to_ref = max(to_ref, float(np.abs(s - np.take_along_axis(want[off:off + B], i, -1)).max()))
        off += B
        alone = ranker.score(feats)
        order = -np.sort(-alone, axis=-1)
        to_alone = max(to_alone, float(np.abs(s - order[:, :5]).max()))
        for b in range(B):  # indices agree wherever the gap to the next score is wider
            gaps = order[b, :5] - order[b, 1:6]
            apart = np.concatenate([[True], gaps[:-1] > BATCHED_ATOL]) & (gaps > BATCHED_ATOL)
            mine = np.argsort(-alone[b], kind="stable")[:5]
            assert (i[b][apart] == mine[apart]).all(), (b, i[b], mine, gaps)
    print(f"[serve_batched] replies vs the f32 CPU forward: max abs err {to_ref:.4g} (tol "
          f"{SCORE_ATOL}); vs the same request ranked alone on the card: max abs diff "
          f"{to_alone:.4g} (tol {BATCHED_ATOL})")
    assert to_ref <= SCORE_ATOL and to_alone <= BATCHED_ATOL, (to_ref, to_alone)
    return ({"gather_dequant": counts["gather_dequant"], "gcn_layer": counts["gcn_layer"]},
            {"ranker": ranker, "fields": fields})


def phase_retrieve(torch, np, kernels, served):
    """Stage-1 retrieval over the served DRIN store's text table (32,768 x
    768, dequantized from the fused int8 store, row-normalized in bf16),
    through /retrieve behind the micro-batching front and through
    Ranker.retrieve, in the three modes; no kernel may launch."""
    from drin_tpu_torch.serve import BatchingRanker, _encode_arrays, serve_http

    ranker = served["ranker"]
    source = ranker._retrieval_source().float().cpu().numpy()
    N, D = source.shape
    unit = source / np.linalg.norm(source, axis=-1, keepdims=True)
    rng = np.random.default_rng(SEED + 600)
    own = np.array([3, N // 2 + 5, N - 1])
    q16 = np.concatenate([source[own], rng.standard_normal((13, D), dtype=np.float32)])
    qn = q16 / np.linalg.norm(q16, axis=-1, keepdims=True)
    k = 10
    front = BatchingRanker(ranker)
    server = serve_http(front, port=0, feat_fields=served["fields"])
    url = f"http://127.0.0.1:{server.server_address[1]}"
    got = {}
    try:
        zero_counts(kernels)
        for mode in ("exact", "approx", "int8"):
            for B in (1, 16):
                out = _post_json(url, "/retrieve", {"query": _encode_arrays({"q": q16[:B]}),
                                                    "k": k, "mode": mode})
                got["http", mode, B] = (np.asarray(out["scores"], np.float32),
                                        np.asarray(out["indices"]))
                got["ranker", mode, B] = ranker.retrieve(q16[:B], k=k, mode=mode)
    finally:
        server.shutdown()
        server.server_close()
        front.close()
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    assert not any(counts.values()), f"retrieval launched a kernel: {counts}"
    worst = 0.0
    for (how, mode, B), (s, i) in got.items():
        assert s.shape == i.shape == (B, k) and np.isfinite(s).all() and (i < N).all()
        assert (i[:len(own[:B]), 0] == own[:B]).all(), (how, mode, B, i[:3, 0])
        recompute = np.einsum("bd,bkd->bk", qn[:B], unit[i])
        err = float(np.abs(s - recompute).max())
        assert err <= RETRIEVE_SCORE_ATOL, (how, mode, B, err)
        worst = max(worst, err)
    # recall@k over the 13 random queries, against the exact mode (whose own
    # bf16 scores tie now and then) and against the float32 brute force
    f32_top = np.argsort(-(qn[3:] @ unit.T), axis=-1)[:, :k]
    recall = lambda got_i, want_i: float(np.mean([len(set(a) & set(b)) / k
                                                  for a, b in zip(got_i, want_i)]))
    exact = got["ranker", "exact", 16][1][3:]
    vs_exact = {m: recall(got["ranker", m, 16][1][3:], exact) for m in ("approx", "int8")}
    vs_f32 = {m: recall(got["ranker", m, 16][1][3:], f32_top) for m in ("exact", "approx", "int8")}
    print(f"[retrieve] N={N}, D={D}: /retrieve and Ranker.retrieve at B=1 and B=16, k={k}, in "
          f"the three modes: each table row finds itself first; scores vs the f32 recompute of "
          f"the returned rows: max abs err {worst:.3g} (tol {RETRIEVE_SCORE_ATOL}); recall@{k} "
          f"over 13 random queries against the exact mode {vs_exact}, against the float32 "
          f"brute force {vs_f32}; launches {counts}")
    for mode in ("exact", "approx", "int8"):
        t = {B: host_ms(lambda B=B: ranker.retrieve(q16[:B], k=k, mode=mode)) for B in (1, 16)}
        dev = device_ms(lambda: ranker.retrieve(q16, k=k, mode=mode))
        print(f"[retrieve] {mode}: Ranker.retrieve B=1 {t[1]:.3f} ms, B=16 {t[16]:.3f} ms (host "
              f"clock, median of 10); B=16 device {dev:.4f} ms")
        profile_call(torch, lambda: ranker.retrieve(q16, k=k, mode=mode), f"retrieve {mode} B=16",
                     top=8)
    return {}, {"recall": vs_f32}


def _write_vocab(np, path, n=28996):
    """A WordPiece vocabulary of exactly ``n`` seeded entries with
    bert-base-cased's special ids ([PAD] 0, [UNK] 100, [CLS] 101, [SEP]
    102, [MASK] 103): punctuation, 2,000 "##" pieces and letter words.
    Returns (whole words, pieces)."""
    rng = np.random.default_rng(SEED + 700)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                   "[MASK]"]
    vocab += list(".,;:()'-")
    seen = set(vocab)
    pieces, words = [], []
    while len(vocab) < n:
        w = "".join(rng.choice(letters, rng.integers(2, 4) if len(pieces) < 2000 else
                               rng.integers(3, 11)))
        if len(pieces) < 2000:
            w = "##" + w
        elif rng.random() < 0.3:
            w = w.capitalize()
        if w not in seen:
            seen.add(w)
            vocab.append(w)
            (pieces if w.startswith("##") else words).append(w)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return words, [p[2:] for p in pieces]


def _raw_request(np, B, seed, words, pieces, C=101):
    """B sentences of 20-40 words with the mention's character span, and C
    candidate texts of 30-40 words each (a tenth of the words carry a "##"
    piece): 9 candidates zipped to a sentence land in a bucket of 256 or more
    tokens."""
    rng = np.random.default_rng(seed)

    def text(n):
        ws = [words[j] + (pieces[rng.integers(len(pieces))] if rng.random() < 0.1 else "")
              for j in rng.integers(0, len(words), n)]
        return ws

    sentences, spans, cands = [], [], []
    for _ in range(B):
        ws = text(int(rng.integers(20, 41)))
        m = int(rng.integers(0, len(ws)))
        start = len(" ".join(ws[:m])) + (1 if m else 0)
        sentences.append(" ".join(ws) + ".")
        spans.append((start, start + len(ws[m])))
        cands.append([" ".join(text(int(rng.integers(30, 41)))) for _ in range(C)])
    return sentences, spans, cands


def phase_serve_text(torch, np, attn):
    """GHMFC with online BERT from raw text at bert-base width: /rank_text at
    B=1 over HTTP and Ranker.rank_text at B=8, a vocabulary file of 28,996
    seeded entries, 101 candidate texts per mention zipped into 12 sentences
    of 256 or more tokens (so the entity tower runs the attention kernel)."""
    import tempfile

    from drin_tpu_torch import make_config
    from drin_tpu_torch.data.online import assemble_online_feats
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.serve import Ranker, serve_http

    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, "vocab.txt")
        words, pieces = _write_vocab(np, vocab_path)
        cfg = make_config("ghmfc", "wikimel", online_bert=True, finetune_bert=False,
                          compute_dtype="bfloat16", bert_vocab=vocab_path)
        with torch.device("meta"):
            skeleton, _ = get_model(cfg)
        assert skeleton.bert.cfg.vocab_size == 28996
        weights = _online_weights(torch, np, skeleton)
        ranker = Ranker(cfg, weights, device="cuda")
        reference = Ranker(cfg.replace(compute_dtype="float32"), weights, device="cpu")
        tok = ranker._ensure_tokenizer()  # reads the file while it exists
    assert len(tok.vocab) == 28996 and (tok.cls_id, tok.sep_id) == (101, 102)
    text = {B: _raw_request(np, B, SEED + 800 + B, words, pieces) for B in (1, 8)}
    images = np.random.default_rng(SEED + 801).standard_normal(
        (8, cfg.resnet_num_region, cfg.resnet_embed_dim), dtype=np.float32)
    feats = {1: assemble_online_feats(cfg, tok, *text[1]),
             8: assemble_online_feats(cfg, tok, *text[8], images)}
    for B, f in feats.items():
        unk = int((f[5] == 100).sum())
        assert f[5].shape[-1] >= 256 and f[0].shape[-1] == cfg.max_mention_sentence_len, (
            B, f[0].shape, f[5].shape)
        print(f"[serve_text] B={B}: mention ids {f[0].shape}, entity ids {f[5].shape} (bucket "
              f"{f[5].shape[-1]} of {cfg.max_bert_len}), [UNK] in entity text: {unk}")
    server = serve_http(ranker, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    body = {"sentences": text[1][0], "spans": [list(s) for s in text[1][1]],
            "candidates": text[1][2], "k": 5}
    try:
        # the main path, counted: /rank_text at B=1, Ranker.rank_text at B=8
        attn.launches = 0
        out = _post_json(url, "/rank_text", body)
        served = {1: (np.asarray(out["scores"], np.float32), np.asarray(out["indices"])),
                  8: ranker.rank_text(*text[8], k=5, mention_images=images)}
        torch.cuda.synchronize()
        launches = attn.launches
        layers = skeleton.bert.cfg.num_hidden_layers
        print(f"[serve_text] attention launches over /rank_text B=1 and rank_text B=8: "
              f"{launches} ({layers} per entity-tower BERT call, 0 for the 128-token mention "
              f"tower)")
        assert launches == layers * len(served), launches
        for B, (s, i) in served.items():
            assert s.shape == i.shape == (B, 5) and np.isfinite(s).all() and (i < 101).all()
            ws, wi = ranker.rank(feats[B], k=5)
            assert np.array_equal(s, ws) and np.array_equal(i, wi), (
                f"B={B}: rank_text differs from rank on assemble_online_feats")
        full = ranker.score(feats[1])
        t0 = time.perf_counter()
        want = reference.score(feats[1])
        cpu_s = time.perf_counter() - t0
        err, spread = float(np.abs(full - want).max()), float(want.std(-1).min())
        print(f"[serve_text] scores bit-equal to Ranker.rank on the assembled request at B=1 and "
              f"B=8; B=1 vs the f32 CPU forward ({cpu_s:.1f} s): max abs err {err:.4g} (tol "
              f"{ONLINE_SCORE_ATOL}, under the candidates' spread {spread:.3g})")
        assert err <= ONLINE_SCORE_ATOL < spread, (err, spread)
        tok_ms = {B: host_ms(lambda B=B: assemble_online_feats(cfg, tok, *text[B]), reps=r)
                  for B, r in ((1, 10), (8, 3))}
        ms_http = host_ms(lambda: _post_json(url, "/rank_text", body))
        ms_b8 = host_ms(lambda: ranker.rank_text(*text[8], k=5, mention_images=images), reps=3)
        ms_rank8 = host_ms(lambda: ranker.rank(feats[8], k=5), reps=5)
        print(f"[serve_text] /rank_text B=1: {ms_http:.3f} ms per request (HTTP, median of 10), "
              f"of which tokenization and assembly on the host {tok_ms[1]:.3f} ms; "
              f"Ranker.rank_text B=8: {ms_b8:.3f} ms (tokenization {tok_ms[8]:.3f} ms, "
              f"Ranker.rank on the assembled request {ms_rank8:.3f} ms)")
    finally:
        server.shutdown()
        server.server_close()
    return {"attention": launches}, err


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
    from drin_tpu_torch.serve import Ranker, rank_feat_fields, serve_http

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

    post = lambda feats, k=5: post_rank(np, url, fields, feats, k)

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
    backward (``bert_remat``); at the end the same in float32
    (``_train_online_f32``), whose launches the returned counts include."""
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
    def grads(attend, tr=None):
        tr = tr or trainer
        tr.state.model.zero_grad(set_to_none=True)
        bert_module.fused_attention = attend
        try:
            loss, _, _ = tr.fns.loss_and_metrics(
                batch, valid, M.init_state(cfg.metrics_topk, "cuda"), step_generator(cfg, 0, "cuda"))
            loss.backward()
        finally:
            bert_module.fused_attention = attn.fused_attention
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.clone() for n, p in tr.state.model.named_parameters()
                                      if p.grad is not None}

    def rel_errs(g_plain, *others):
        """Per tensor |g - g_plain|_2 / |g_plain|_2 of each of ``others``, over every
        tensor but the key biases: adding a constant to all keys leaves the
        softmax as it is, so their exact gradient is 0 and both sides hold noise."""
        assert all(set(g) == set(g_plain) for g in others) and len(g_plain) > 200
        names = [n for n in g_plain if not n.endswith("attention.self.key.bias")]
        return [{n: ((g[n] - g_plain[n]).norm() / g_plain[n].norm().clamp_min(1e-30)).item()
                 for n in names} for g in others]

    attn.launches = attn.bwd_launches = attn.bwd_nomask_launches = 0
    loss_k, g_kernel = grads(attn.fused_attention)
    counted = (attn.launches, attn.bwd_launches, attn.bwd_nomask_launches)
    assert counted == (2 * layers, layers, 0), counted
    loss_p, g_plain = grads(attn.attention_plain)
    _, g_fault = grads(_faulty_attention(torch, attn, "delta left out of dS"))
    rel_k, rel_f = rel_errs(g_plain, g_kernel, g_fault)
    names = list(rel_k)
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
    del frozen, fmodel, start, held
    torch.cuda.empty_cache()

    # the default dtype: the same model and batch with compute_dtype float32 (both
    # CLIs' default), every BERT layer through the kernels' float32 forms
    f32_counts, f32_stats = _train_online_f32(torch, np, attn, build, cfg, batch, valid, grads,
                                              rel_errs, layers)
    counts = {name: counts[name] + f32_counts[name] for name in counts}
    return counts, {"step_ms": step_ms, "peak_gib": peak, "f32": f32_stats}


def _launch_dtypes(attn):
    """A context that records the dtype of every forward and backward launch
    of kernel 3 (the wrappers' launch helpers wrapped, put back after)."""

    @contextlib.contextmanager
    def ctx():
        seen = {"fwd": [], "bwd": []}
        fwd, bwd = attn._launch_forward, attn._launch_backward
        attn._launch_forward = lambda q, *a, **kw: (seen["fwd"].append(q.dtype), fwd(q, *a, **kw))[1]
        attn._launch_backward = lambda q, *a, **kw: (seen["bwd"].append(q.dtype), bwd(q, *a, **kw))[1]
        try:
            yield seen
        finally:
            attn._launch_forward, attn._launch_backward = fwd, bwd

    return ctx()


def _train_online_f32(torch, np, attn, build, cfg, batch, valid, grads, rel_errs, layers):
    """GHMFC-online fine-tuning in float32 (the default compute_dtype) with
    bert_remat at B=8, 12 zipped sentences of 512 tokens: kernel 3's float32
    forward and backward on every layer.  The first step's gradients against
    the same float32 model with attention_plain and autograd through it; a
    planted fault of the backward must exceed the limit; the loss falls over
    three steps; the step's time, peak memory and one profiled step."""
    from drin_tpu_torch.train import metrics as M

    n_steps = 3
    f32 = torch.float32
    cfg32 = cfg.replace(compute_dtype="float32")
    t0 = time.perf_counter()
    trainer = build(cfg32)
    print(f"[train_online] float32 body (compute_dtype=float32, bert_remat, B=8): built in "
          f"{time.perf_counter() - t0:.1f} s")
    attn.launches = attn.bwd_launches = attn.bwd_nomask_launches = 0
    with _launch_dtypes(attn) as seen:
        loss_k, g_kernel = grads(attn.fused_attention, trainer)
    counted = (attn.launches, attn.bwd_launches, attn.bwd_nomask_launches)
    assert counted == (2 * layers, layers, 0), counted
    assert set(seen["fwd"]) == set(seen["bwd"]) == {f32}, seen
    loss_p, g_plain = grads(attn.attention_plain, trainer)
    faults = {f: grads(_faulty_attention(torch, attn, f), trainer)[1]
              for f in ("one TF32 pass", "delta left out of dS")}
    rel_k, *rel_f = rel_errs(g_plain, g_kernel, *faults.values())
    top = sorted(rel_k, key=rel_k.get, reverse=True)[:4]
    worst_f = {f: max(r.values()) for f, r in zip(faults, rel_f)}
    print(f"[train_online] float32: first-step loss {loss_k:.7f} (plain attention swapped in: "
          f"{loss_p:.7f}); gradients vs the plain swap, relative L2 per tensor ({len(rel_k)} "
          f"tensors, the key biases left out), the largest: "
          f"{[(n, float(f'{rel_k[n]:.3g}')) for n in top]}, the median "
          f"{statistics.median(rel_k.values()):.3g}; with a planted fault of the backward the "
          f"largest: { {f: float(f'{v:.4g}') for f, v in worst_f.items()} } (limit {TRAIN_F32_GRAD_REL})")
    assert all(torch.isfinite(g).all() for g in g_kernel.values())
    assert rel_k[top[0]] <= TRAIN_F32_GRAD_REL, (top[0], rel_k[top[0]])
    for f, v in worst_f.items():
        assert v > TRAIN_F32_GRAD_REL, f"the float32 gradient check cannot see {f}"
    del g_kernel, g_plain, faults
    trainer.state.model.zero_grad(set_to_none=True)

    ev_before = float(trainer.fns.eval_step(batch, valid, M.init_state(cfg.metrics_topk, "cuda"))[0])
    torch.cuda.reset_peak_memory_stats()
    attn.launches = attn.bwd_launches = attn.bwd_nomask_launches = 0
    with _launch_dtypes(attn) as seen:
        losses, times, mstate = _run_steps(torch, trainer, batch, valid, n_steps)
    torch.cuda.synchronize()
    counts = {"attention": attn.launches, "attention_bwd": attn.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert counts == {"attention": 2 * layers * n_steps, "attention_bwd": layers * n_steps}, counts
    assert attn.bwd_nomask_launches == 0 and set(seen["fwd"]) == set(seen["bwd"]) == {f32}, seen
    ev_after = float(trainer.fns.eval_step(batch, valid, mstate)[0])
    assert np.isfinite(losses).all() and np.isfinite([ev_before, ev_after]).all(), losses
    assert ev_after < ev_before, f"float32: the loss did not fall: eval {ev_before} -> {ev_after}, {losses}"
    step_ms = statistics.median(times[1:])
    print(f"[train_online] float32: {n_steps} train steps, forward launches {counts['attention']} "
          f"and backward launches {counts['attention_bwd']}, all float32 ({2 * layers} and {layers} "
          f"per step); train losses {[round(x, 5) for x in losses]}, eval loss {ev_before:.5f} "
          f"before and {ev_after:.5f} after; {step_ms:.1f} ms per step (median of {n_steps - 1}, "
          f"host clock to a synchronise; the first {times[0]:.1f} ms), peak memory {peak:.2f} GiB")
    mstate0 = M.init_state(cfg.metrics_topk, "cuda")
    prof = profile_call(torch, lambda: trainer.fns.train_step(trainer.state, batch, valid, mstate0),
                        "online train step B=8 (float32, remat)", reps=1, top=10)
    stats = {"step_ms": step_ms, "peak_gib": peak, "first_step_grad_rel_max": rel_k[top[0]],
             "fault_grad_rel_max": worst_f, "losses": losses, "eval_loss": [ev_before, ev_after]}
    if prof is not None:
        bwd_ms = sum(ms for k, ms in prof["device_ms_by_kernel"].items() if "attn_bwd" in k)
        fwd_ms = sum(ms for k, ms in prof["device_ms_by_kernel"].items() if "attn_fwd" in k)
        print(f"[train_online] float32 step: kernel 3's backward {bwd_ms:.2f} ms of {prof['busy_ms']:.2f} "
              f"ms device busy ({bwd_ms / prof['busy_ms']:.3f}), its forward {fwd_ms:.2f} ms "
              f"({fwd_ms / prof['busy_ms']:.3f}); idle share {prof['idle']:.3f}")
        stats.update(busy_ms=prof["busy_ms"], idle=prof["idle"], attention_bwd_device_ms=bwd_ms,
                     attention_bwd_share=bwd_ms / prof["busy_ms"], attention_device_ms=fwd_ms)
    return counts, stats


def _write_text_store(np, d, cfg, tok, words, pieces, splits):
    """A WikiMEL intermediate store of raw strings (the files the prepare
    stage writes for the online path): per split the mention sentences with
    their token spans, C candidate qids per mention, the gold index (100 =
    the answer is not among them) and the 49 image regions of each
    mention; beside it qid2ne / qid2abs over 400 entities whose attribute
    texts fill the 128 characters WikiMEL keeps of "name. attr", so that 9
    candidates zipped to a sentence pass 128 ids and the bucket is 256."""
    from drin_tpu_torch.common import npy_io
    from drin_tpu_torch.preprocess.prepare import MentionPositionProcessor

    rng = np.random.default_rng(SEED + 900)
    n_ent, C = 400, cfg.num_candidates_model

    def text(n):
        return " ".join(words[j] + (pieces[rng.integers(len(pieces))] if rng.random() < 0.1
                                    else "") for j in rng.integers(0, len(words), n))

    qids = [f"Q{i}" for i in range(n_ent)]
    with open(cfg.qid2entity_path, "w") as f:
        json.dump({q: text(int(rng.integers(1, 4))).title() for q in qids}, f)
    with open(cfg.qid2attr_path, "w") as f:
        json.dump({q: text(int(rng.integers(25, 36))) + "." for q in qids}, f)
    for split, n in splits.items():
        sentences, spans, _ = _raw_request(np, n, int(rng.integers(1 << 30)), words, pieces, C=1)
        starts, ends = MentionPositionProcessor(tok)(sentences, [s for s, _ in spans],
                                                     [e for _, e in spans])
        npy_io.save_field(d, "mention_text_raw", np.asarray(sentences), split)
        npy_io.save_field(d, "start_pos", np.asarray(starts, np.int64), split)
        npy_io.save_field(d, "end_pos", np.asarray(ends, np.int64), split)
        npy_io.save_field(d, "entity_name_raw", np.asarray(qids)[rng.integers(0, n_ent, n * C)],
                          split)
        answer = rng.integers(0, cfg.num_candidates_data, n)
        answer[rng.random(n) < 0.1] = cfg.num_candidates_data  # the answer-absent sentinel
        npy_io.save_field(d, "answer", answer.astype(np.int64), split)
        npy_io.save_field(d, "mention_image_feature", rng.standard_normal(
            (n, cfg.resnet_num_region, cfg.resnet_embed_dim), dtype=np.float32), split)


def _trace_summary(path):
    """(device busy ms, wall ms, kernel names) of one torch.profiler Chrome
    trace: busy is the sum of the kernels', copies' and memsets' durations,
    wall the span of every timed event in it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in device) / 1e3
    wall = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    return busy, wall, {e["name"] for e in device if e.get("cat") == "kernel"}


def phase_train_text(torch, np, attn):
    """GHMFC with online BERT trained from raw text through the training
    entry point, ``drin_tpu_torch.train.cli.main``, on the card at bert-base
    width: a 28,996-entry vocabulary file, a seeded bert-base checkpoint as an
    HF-style directory, a WikiMEL store of raw strings (C=101; 32 train, 8
    valid and 8 test mentions with their image regions), ``finetune_bert``,
    ``bert_remat``, a bf16 body, B=8, two fit chunks with checkpoints and
    profiler windows, and the tokenizer pools of four spawn workers."""
    import glob
    import tempfile

    from drin_tpu_torch import make_config
    from drin_tpu_torch.data.online import OnlineMELDataset
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.train import cli
    from drin_tpu_torch.train import metrics as M
    from drin_tpu_torch.train import trainer as trainer_module

    B, splits, workers = 8, {"train": 32, "valid": 8, "test": 8}, 4
    n_train, n_eval = 2 * splits["train"] // B, 2 * (splits["valid"] + splits["test"]) // B
    with tempfile.TemporaryDirectory() as tmp:
        store, bert_dir = os.path.join(tmp, "store"), os.path.join(tmp, "bert-base")
        os.makedirs(store)
        os.makedirs(bert_dir)
        vocab_path = os.path.join(tmp, "vocab.txt")
        words, pieces = _write_vocab(np, vocab_path)
        overrides = dict(
            model_type="ghmfc", dataset_name="wikimel", preprocess_dir=store,
            dataset_root=os.path.join(tmp, "raw"), online_bert=True, finetune_bert=True,
            bert_remat=True, bert_checkpoint=bert_dir, bert_vocab=vocab_path,
            compute_dtype="bfloat16", batch_size=B, learning_rate=1e-4, num_epoch=2,
            test_epoch_interval=1, enable_checkpointing=True,
            checkpoint_dir=os.path.join(tmp, "checkpoints"), keep_checkpoints=1, profiling=True,
            profile_dir=os.path.join(tmp, "profile"), profile_active=2,
            dataloader_workers=workers, qid2entity_path=os.path.join(store, "qid2ne.json"),
            qid2attr_path=os.path.join(store, "qid2abs.json"))
        cfg = make_config(**overrides)
        assert (cfg.num_candidates_model, cfg.num_entity_sentence, cfg.max_bert_len,
                cfg.max_entity_attr_char_len, cfg.mention_final_layer_name) == (
            101, 12, 512, 128, "multimodal")
        t0 = time.perf_counter()
        with torch.device("meta"):
            skeleton, _ = get_model(cfg.replace(bert_checkpoint=""))
        bert = {k[len("bert."):]: v for k, v in _online_weights(torch, np, skeleton).items()
                if k.startswith("bert.")}
        torch.save(bert, os.path.join(bert_dir, "pytorch_model.bin"))
        b = skeleton.bert.cfg
        with open(os.path.join(bert_dir, "config.json"), "w") as f:
            json.dump({"model_type": "bert", "vocab_size": b.vocab_size,
                       "hidden_size": b.hidden_size, "num_hidden_layers": b.num_hidden_layers,
                       "num_attention_heads": b.num_attention_heads,
                       "intermediate_size": b.intermediate_size,
                       "max_position_embeddings": b.max_position_embeddings,
                       "type_vocab_size": b.type_vocab_size, "layer_norm_eps": b.layer_norm_eps},
                      f)
        layers = b.num_hidden_layers
        from drin_tpu_torch.text.wordpiece import BertTokenizer

        tok = BertTokenizer(vocab_file=vocab_path, model_max_length=cfg.max_bert_len)
        assert tok._native is not None, "the native tokenizer was not taken"
        _write_text_store(np, store, cfg, tok, words, pieces, splits)
        print(f"[train_text] vocab.txt {len(tok.vocab)} entries, bert-base checkpoint "
              f"{os.path.getsize(os.path.join(bert_dir, 'pytorch_model.bin')) / 2 ** 20:.0f} MiB "
              f"(HF-style directory), raw-text store {splits}, written in "
              f"{time.perf_counter() - t0:.1f} s")

        # the datasets' tokenization, outside the counted run: the pool's batch
        # against the in-process one, and each path's time per batch of 8
        local = OnlineMELDataset(cfg.replace(dataloader_workers=0), "train", tokenizer=tok)
        pooled = OnlineMELDataset(cfg, "train")
        try:
            idx = np.arange(B)
            want = local.online_batch(idx)
            got = pooled.online_batch(idx)
            for name, x, y in zip(want._fields, got, want):
                assert x.dtype == y.dtype and np.array_equal(x, y), f"pool differs in {name}"
            ent_len, men_len = want.entity_ids.shape[-1], want.mention_ids.shape[-1]
            assert ent_len >= 256 and men_len == cfg.max_mention_sentence_len < 256, (
                ent_len, men_len)
            tok_ms = {"native": host_ms(lambda: local.online_batch(idx), reps=5),
                      f"native, pool of {workers}": host_ms(lambda: pooled.online_batch(idx),
                                                            reps=5)}
            local.tokenizer = BertTokenizer(vocab=tok.vocab, model_max_length=cfg.max_bert_len)
            local.tokenizer._native = None
            python = local.online_batch(idx)
            assert all(np.array_equal(x, y) for x, y in zip(python, want))
            tok_ms["python"] = host_ms(lambda: local.online_batch(idx), reps=3)
        finally:
            pooled.close()
        print(f"[train_text] batch of {B} from raw text: the pool's arrays bit-equal to the "
              f"in-process ones (native and Python); entity ids {want.entity_ids.shape} (bucket "
              f"{ent_len} of {cfg.max_bert_len}), mention ids {want.mention_ids.shape}; "
              f"tokenization and assembly ms per batch (host clock, median): "
              f"{ {k: round(v, 3) for k, v in tok_ms.items()} }")

        # the main path, counted: the training entry point, two fit/test chunks
        seen, spans = {}, []
        real_fit = trainer_module.Trainer.fit
        valid_ds = OnlineMELDataset(cfg.replace(dataloader_workers=0), "valid", tokenizer=tok)
        one = valid_ds.make_batch(np.array([0]))  # the first eval batch's first mention

        def scores_of(trainer):
            batch, valid = trainer._put(one, np.ones((1,), np.float32))
            out = trainer.fns.eval_step(batch, valid, M.init_state(cfg.metrics_topk, "cuda"))[2]
            return out.float().cpu().numpy()

        def fit(self, *args, **kw):
            if not seen:  # before step 1: BERT on the card is the checkpoint file's
                seen["trainer"] = self
                on_card = self.state.model.bert.state_dict()
                seen["bert_equal"] = all(torch.equal(on_card[k].cpu(), v) for k, v in bert.items())
                # the B=1 scores at the weights the run starts from; their 12
                # forward launches are a check beside the main path: not counted
                counted = attn.launches
                seen["scores0"] = scores_of(self)
                attn.launches = counted
                seen["weights0"] = {k: v.detach().cpu().clone()
                                    for k, v in self.state.model.state_dict().items()}
                steps = self.fns.train_step

                def timed(*a):  # CUDA events around each step: no synchronise added
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = steps(*a)
                    end.record()
                    spans.append((start, end))
                    return out

                self.fns = self.fns._replace(train_step=timed)
            t = time.perf_counter()
            out = real_fit(self, *args, **kw)
            seen.setdefault("fit_s", []).append(time.perf_counter() - t)
            return out

        trainer_module.Trainer.fit = fit
        argv = [f"{k}={v}" for k, v in overrides.items()] + ["device=cuda"]
        try:
            attn.launches = attn.bwd_launches = attn.bwd_nomask_launches = 0
            t0 = time.perf_counter()
            trainer = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {"attention": attn.launches, "attention_bwd": attn.bwd_launches}
            nomask = attn.bwd_nomask_launches
        finally:
            trainer_module.Trainer.fit = real_fit
        assert seen["trainer"] is trainer and seen["bert_equal"], \
            "BERT on the card is not the checkpoint's before the first step"
        print(f"[train_text] cli.main({len(argv)} key=value arguments, device=cuda): "
              f"{n_train} train steps and {n_eval} eval steps in {wall:.1f} s; fit chunks "
              f"{[round(s, 1) for s in seen['fit_s']]} s; forward launches "
              f"{counts['attention']} ({2 * layers} per train step, {layers} per eval step), "
              f"backward launches {counts['attention_bwd']} ({layers} per train step), without "
              f"mask {nomask}; BERT on the card bit-equal to the checkpoint file before step 1")
        assert counts == {"attention": 2 * layers * n_train + layers * n_eval,
                          "attention_bwd": layers * n_train} and nomask == 0, (counts, nomask)
        assert trainer.state.step == n_train and trainer.epoch == 2
        step_ms = [s.elapsed_time(e) for s, e in spans]
        per_chunk = n_train // 2
        steady = step_ms[1:per_chunk] + step_ms[per_chunk + 1:]
        print(f"[train_text] ms per train step on the device's timeline (CUDA events around "
              f"each step, no synchronise added): median {statistics.median(steady):.1f} over "
              f"{len(steady)} (each chunk's first left out: "
              f"{[round(step_ms[0], 1), round(step_ms[per_chunk], 1)]}); "
              f"{B * cfg.num_candidates_model / (statistics.median(steady) / 1e3):.0f} pairs/s")

        # the profiler's cycles: each traced two train steps on the card
        cycles = sorted(os.listdir(cfg.profile_dir))
        assert cycles == ["cycle0", "cycle1"], cycles
        for cycle in cycles:
            (trace,) = glob.glob(os.path.join(cfg.profile_dir, cycle, "*.pt.trace.json"))
            busy, span, names = _trace_summary(trace)
            for kernel in ("attn_fwd_bf16", "attn_bwd_dq_bf16", "attn_bwd_dkv_bf16"):
                assert any(kernel in n for n in names), (cycle, kernel)
            print(f"[train_text] {cycle}: {os.path.getsize(trace) / 2 ** 20:.1f} MiB trace of "
                  f"{cfg.profile_active} train steps, {len(names)} kernel names (the attention "
                  f"kernels among them); {span:.1f} ms wall, {busy:.1f} ms device busy, idle "
                  f"share {1 - busy / span:.3f}")

        # the checkpoint: its size, the save's blocking time, a restore bit for bit
        (ckpt,) = os.listdir(cfg.checkpoint_dir)
        assert ckpt == f"step_{n_train}.pt", ckpt
        t0 = time.perf_counter()
        trainer.save(wait=False)
        blocking = time.perf_counter() - t0
        trainer.wait_until_finished()
        total = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(cfg.checkpoint_dir, ckpt))
        with torch.device("meta"):
            fresh, _ = get_model(cfg)
        fresh.to_empty(device="cuda")
        restored = trainer_module.Trainer(cfg, fresh, device="cuda", log=lambda *a: None)
        assert restored.state.step == trainer.state.step and restored.epoch == 2
        for (k, a), b2 in zip(trainer.state.model.state_dict().items(),
                              restored.state.model.state_dict().values()):
            assert torch.equal(a, b2), f"restored {k} differs"
        ours, theirs = trainer.state.optimizer.state_dict(), restored.state.optimizer.state_dict()
        assert ours["state"].keys() == theirs["state"].keys()
        for i, s in ours["state"].items():
            for name, v in s.items():
                assert torch.equal(v.cpu(), theirs["state"][i][name].cpu()), (i, name)
        print(f"[train_text] checkpoint {ckpt}: {size / 2 ** 30:.2f} GiB (float32 masters and "
              f"Adam's two moments); save(wait=False) blocked {blocking:.3f} s (the host copy), "
              f"written in {total:.2f} s in all; a fresh Trainer restored it bit for bit")
        del restored, fresh
        torch.cuda.empty_cache()

        # the first eval batch at B=1 against the float32 forward on the CPU: at
        # the weights the run started from (the online limit), and after the
        # eight steps, which move the cosines to where one bf16 ulp is 3.9e-3
        with torch.device("meta"):
            reference, _ = get_model(cfg.replace(compute_dtype="float32"))
        for when, weights, got, atol in (
                ("before step 1", seen["weights0"], seen["scores0"], ONLINE_SCORE_ATOL),
                ("after training", {k: v.cpu() for k, v in trainer.state.model.state_dict().items()},
                 scores_of(trainer), TRAINED_SCORE_ATOL)):
            reference.load_state_dict(weights, assign=True)
            t0 = time.perf_counter()
            with torch.inference_mode():
                want = reference(tuple(torch.from_numpy(np.ascontiguousarray(x))
                                       for x in one[:-1])).numpy()
            cpu_s = time.perf_counter() - t0
            err, spread = float(np.abs(got - want).max()), float(want.std(-1).min())
            print(f"[train_text] first eval batch at B=1 (bucket {one.entity_ids.shape[-1]}), "
                  f"{when}: scores in [{want.min():.4f}, {want.max():.4f}], vs the f32 CPU "
                  f"forward ({cpu_s:.1f} s) max abs err {err:.4g} (tol {atol}; the candidates' "
                  f"spread {spread:.3g})")
            assert got.shape == (1, cfg.num_candidates_model) and np.isfinite(got).all()
            assert err <= atol, (when, err)
            if when == "before step 1":
                assert atol < spread, (when, spread)
        del trainer, reference
        torch.cuda.empty_cache()
    return counts, {"step_ms": statistics.median(steady), "save_blocking_s": blocking}


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
    init = copy.deepcopy(cpu_model.state_dict())  # the float32 phase starts here too
    loss_cpu, g_cpu = _drin_grads(cpu, cbatch, cvalid)
    _, g_card = _drin_grads(trainer, batch, valid)
    with _drop_wh_grad(gcn):
        _, g_fault = _drin_grads(trainer, batch, valid)
    _check_drin_grads(torch, "train_drin", g_cpu, g_card, g_fault, TRAIN_DRIN_GRAD_REL)
    del g_card, g_fault

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
    shared = {"tables": tables, "rows": rows, "init": init, "g_cpu": g_cpu, "loss_cpu": loss_cpu}
    return {"gcn_layer": launches}, {"step_ms": step_ms}, shared


def _drin_grads(tr, b, v):
    """The deterministic first-step loss (dropout off) and the gradient of
    every parameter tensor, on the host in float32."""
    from drin_tpu_torch.train import metrics as M

    tr.state.model.zero_grad(set_to_none=True)
    loss, _, _ = tr.fns.loss_and_metrics(b, v, M.init_state(tr.cfg.metrics_topk, tr.device))
    loss.backward()
    got = {n: p.grad.float().cpu() for n, p in tr.state.model.named_parameters()
           if p.grad is not None}
    tr.state.model.zero_grad(set_to_none=True)
    return float(loss.detach()), got


@contextlib.contextmanager
def _drop_wh_grad(gcn):
    """The fused layer's backward with W_h's gradient left out, for the block."""
    layer_backward = gcn._FusedGCNLayer.backward

    def drop_wh(ctx, *gs):
        out = list(layer_backward(ctx, *gs))
        out[1 + 8] = None  # inputs: opts, 4 vertexes, 4 edges, then wh
        return tuple(out)

    gcn._FusedGCNLayer.backward = staticmethod(drop_wh)
    try:
        yield
    finally:
        gcn._FusedGCNLayer.backward = staticmethod(layer_backward)


def _check_drin_grads(torch, tag, g_cpu, g_card, g_fault, limit):
    """Relative L2 per tensor of the card's first-step gradients against the
    float32 CPU port's: within ``limit``; with W_h's gradient dropped, W_h's
    tensor outside it.  Returns (largest, the fault's largest)."""
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
    print(f"[{tag}] first-step gradients (dropout off) vs the float32 CPU port, relative L2 "
          f"per tensor ({len(g_cpu)} tensors), the largest: "
          f"{[(n, float(f'{rel_c[n]:.3g}')) for n in top]}, the median "
          f"{statistics.median(rel_c.values()):.3g}; with W_h's gradient dropped in the fused "
          f"layer's backward: {worst_f} {rel_f[worst_f]:.3g} (limit {limit})")
    assert all(torch.isfinite(g).all() for g in g_card.values())
    assert rel_c[top[0]] <= limit, (top[0], rel_c[top[0]])
    assert rel_f[worst_f] > limit and "w_h" in worst_f, \
        f"the gradient check cannot see a faulty backward: {worst_f} {rel_f[worst_f]}"
    return rel_c[top[0]], rel_f[worst_f]


def phase_train_drin_f32(torch, np, gcn, shared):
    """DRIN train steps with the configuration's default compute dtype,
    float32, over phase_train_drin's entity tables, batch and initial
    weights: kernel 1's float32 form in the forward (split-precision TF32),
    its backward through the plain version.  First-step gradients and loss
    against that phase's float32 CPU port; three steps on the repeated
    batch; the step's time, peak memory and one profiled step."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.data.device_store import DeviceEntityStore
    from drin_tpu_torch.models.drin import DRIN
    from drin_tpu_torch.train import metrics as M
    from drin_tpu_torch.train.trainer import Trainer

    B, n_steps = 64, 3
    cfg = make_config("drin", "wikimel", batch_size=B)
    assert cfg.compute_dtype == "float32", cfg.compute_dtype
    model = DRIN(cfg)
    model.load_state_dict(shared["init"])
    store = DeviceEntityStore(cfg, shared["tables"], device="cuda")
    trainer = Trainer(cfg, model, device="cuda", feats_fn=store.drin_feats_fn(), log=lambda *a: None)
    batch, valid = trainer._put(shared["rows"], np.ones((B,), np.float32))
    print(f"[train_drin_f32] Trainer(make_config('drin', 'wikimel'): compute_dtype {cfg.compute_dtype}) "
          f"on cuda, B={B}: store of {store.n_rows} entities resident ({store.nbytes / 2 ** 20:.0f} MiB)")
    gcn.launches = 0
    with gcn_dtypes(gcn) as seen:
        loss, g_card = _drin_grads(trainer, batch, valid)
    assert gcn.launches == cfg.num_gcn_layers and seen == ["float32"] * cfg.num_gcn_layers, seen
    with _drop_wh_grad(gcn):
        _, g_fault = _drin_grads(trainer, batch, valid)
    grad_rel, fault_rel = _check_drin_grads(torch, "train_drin_f32", shared["g_cpu"], g_card, g_fault,
                                            TRAIN_DRIN_F32_GRAD_REL)
    loss_err = abs(loss - shared["loss_cpu"]) / abs(shared["loss_cpu"])
    print(f"[train_drin_f32] first-step loss {loss:.7f} (dropout off), the float32 CPU port's "
          f"{shared['loss_cpu']:.7f}: relative error {loss_err:.3g} (limit {TRAIN_DRIN_F32_LOSS_RTOL})")
    assert loss_err <= TRAIN_DRIN_F32_LOSS_RTOL, loss_err
    del g_card, g_fault

    gcn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with gcn_dtypes(gcn) as seen:
        losses, times, mstate = _run_steps(torch, trainer, batch, valid, n_steps)
        ev_loss, mstate, scores = trainer.fns.eval_step(batch, valid, mstate)
        torch.cuda.synchronize()
    launches = gcn.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(times[1:])
    print(f"[train_drin_f32] {n_steps} train steps + 1 eval step: gcn_layer launches {launches}, "
          f"all float32 ({cfg.num_gcn_layers} per forward); losses {[round(x, 6) for x in losses]}, "
          f"eval {float(ev_loss):.6f}; {step_ms:.2f} ms per step (median of {n_steps - 1}; the first "
          f"{times[0]:.1f} ms), {B * cfg.num_candidates_model / (step_ms / 1e3):.0f} pairs/s, peak "
          f"memory {peak:.2f} GiB")
    assert launches == cfg.num_gcn_layers * (n_steps + 1) and set(seen) == {"float32"}, (launches, seen)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert tuple(scores.shape) == (B, cfg.num_candidates_model) and torch.isfinite(scores).all()
    mstate0 = M.init_state(cfg.metrics_topk, "cuda")
    prof = profile_call(torch, lambda: trainer.fns.train_step(trainer.state, batch, valid, mstate0),
                        "DRIN train step B=64 (float32)", reps=3)
    stats = {"step_ms": step_ms, "peak_gib": peak, "first_step_grad_rel_max": grad_rel,
             "fault_grad_rel_max": fault_rel, "first_loss_rel_err": loss_err, "losses": losses}
    if prof is not None:
        layer_ms = sum(ms for k, ms in prof["device_ms_by_kernel"].items()
                       if "gcn_rows" in k or "split_w_f32" in k)
        print(f"[train_drin_f32] kernel 1's forward {layer_ms:.3f} ms of {prof['busy_ms']:.3f} ms device "
              f"busy ({layer_ms / prof['busy_ms']:.3f}); idle share {prof['idle']:.3f}")
        stats.update(busy_ms=prof["busy_ms"], idle=prof["idle"], gcn_layer_device_ms=layer_ms)
    return {"gcn_layer": launches}, stats


def launch_counts(kernels) -> dict:
    """Every kernel wrapper's launch count; ``kernels`` = (gather, gcn,
    attention, vertex_update, nms) modules."""
    gather, gcn, attn, vu, nms_mod = kernels
    return {"gather_dequant": gather.launches, "gcn_layer": gcn.launches,
            "attention": attn.launches, "attention_bwd": attn.bwd_launches,
            "attention_bwd_nomask": attn.bwd_nomask_launches, "vertex_update": vu.launches,
            "nms": nms_mod.launches}


def zero_counts(kernels) -> None:
    gather, gcn, attn, vu, nms_mod = kernels
    gather.launches = gcn.launches = attn.launches = vu.launches = nms_mod.launches = 0
    attn.bwd_launches = attn.bwd_nomask_launches = 0


def _text_tables(np, cfg, n):
    """The pooled (projected, CLS) text table alone: GHMFC reads no other."""
    rng = np.random.default_rng(SEED + 1)
    return {"entity_text_feature": rng.standard_normal((n, 2, cfg.bert_embed_dim),
                                                       dtype=np.float32)}


def _baseline_rows(np, cfg, B, seed):
    """A BaselineRowsBatch's five mention fields and [B, C] table rows."""
    feats = _rows_batch(np, cfg, B, seed)
    return feats[:5] + (feats[7],)


def _wikidiverse_batch(np, cfg, B, seed):
    """A WikiDiverse baseline batch (answer stripped): 128-token sentences
    of 6 to 127 tokens, the first row with no left context (start = 1), the
    last with no right one (end = its length), 49 image regions, C
    mention-aligned candidate rows with their images."""
    rng = np.random.default_rng(seed)
    C, L, D = cfg.num_candidates_model, cfg.max_mention_sentence_len, cfg.bert_embed_dim
    Dr = cfg.resnet_embed_dim
    lens = rng.integers(6, L, size=B)
    start = rng.integers(1, 4, size=B)
    end = start + rng.integers(1, 3, size=B)
    start[0], end[-1] = 1, lens[-1]
    return (rng.standard_normal((B, L, D), dtype=np.float32),
            (np.arange(L)[None] < lens[:, None]).astype(np.int64),
            start.astype(np.int64), end.astype(np.int64),
            rng.standard_normal((B, cfg.resnet_num_region, Dr), dtype=np.float32),
            rng.standard_normal((B, C, D), dtype=np.float32), np.zeros((B,), np.int64),
            rng.standard_normal((B, C, Dr), dtype=np.float32))


def _split(np, values):
    """A threshold in the widest gap between the middle half of ``values``:
    both sides are taken, and no value lies near the threshold."""
    v = np.sort(np.asarray(values, np.float64))
    lo, hi = len(v) // 4, 3 * len(v) // 4
    i = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float((v[i] + v[i + 1]) / 2), float(v[i + 1] - v[i])


def melhi_thresholds(torch, np, cfg, weights, batch):
    """``cfg`` with thres_tmim and thres_imie set inside the batch's own
    cosines (from the f32 model on the CPU), so that both gate states occur:
    at random weights both cosines sit near 0, under the default 0.3."""
    from drin_tpu_torch.models.melhi import MELHI

    model = MELHI(cfg.replace(compute_dtype="float32"))
    model.load_state_dict(weights)
    with torch.inference_mode():
        t = [torch.from_numpy(batch[i]) for i in (0, 4, 7)]
        sim_tmim, sim_imie, _ = model.similarities(*t)
    (tmim, gap_t), (imie, gap_i) = _split(np, sim_tmim.numpy()), _split(np, sim_imie.amax(-1).numpy())
    print(f"[melhi] thresholds from the batch's own cosines: thres_tmim={tmim:.5f} (gap "
          f"{gap_t:.2g}), thres_imie={imie:.5f} (gap {gap_i:.2g}); defaults 0.3 / 0.3 would "
          f"close every gate (largest cosines {sim_tmim.max():.3f} / {sim_imie.max():.3f})")
    return cfg.replace(thres_tmim=tmim, thres_imie=imie)


def phase_serve_ghmfc(torch, np, kernels):
    """Offline GHMFC (WikiMEL, multimodal-bi fusion) through Ranker and
    serve_http at full width over a fused int8 text-only store: the rank
    stage reads its candidate rows through kernel 2; then the entity
    precompute and rank_rows."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.data.device_store import BaselineRowsBatch
    from drin_tpu_torch.models.ghmfc import GHMFC
    from drin_tpu_torch.serve import Ranker, rank_feat_fields, serve_http

    gather = kernels[0]
    cfg = make_config("ghmfc", "wikimel", compute_dtype="bfloat16")
    assert (cfg.bert_embed_dim, cfg.resnet_embed_dim, cfg.max_mention_sentence_len,
            cfg.resnet_num_region, cfg.num_candidates_model) == (768, 2048, 128, 49, 101)
    assert (cfg.mention_final_layer_name, cfg.mention_multimodal_attention) == ("multimodal", "bi")
    weights = GHMFC(cfg, generator=torch.Generator().manual_seed(SEED)).state_dict()
    tables = _text_tables(np, cfg, N_ENTITIES)
    t0 = time.perf_counter()
    ranker = Ranker(cfg, weights, tables, device="cuda", quantize_store=True, fused_gather=True)
    torch.cuda.synchronize()
    store = ranker.store
    assert store.include == ("text",) and store._chunks == GATHER_LAYOUTS["ghmfc_text"]
    print(f"[serve_ghmfc] Ranker(ghmfc, quantize_store, fused_gather) on cuda: text-only store "
          f"N={store.n_rows}, packed {tuple(store.packed.shape)}, resident "
          f"{store.nbytes / 2**20:.1f} MiB, built in {time.perf_counter() - t0:.1f} s")
    reference = Ranker(cfg.replace(compute_dtype="float32"), weights, tables, device="cpu",
                       quantize_store=True, fused_gather=True)
    fields = rank_feat_fields(ranker)
    assert fields == list(BaselineRowsBatch._fields[:-1]), fields
    batches = {B: _baseline_rows(np, cfg, B, SEED + 40 + B) for B in (1, 64)}
    server = serve_http(ranker, port=0, feat_fields=fields)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        # the main path, counted: /rank at B=1, Ranker.rank at B=64
        zero_counts(kernels)
        served = {1: post_rank(np, url, fields, batches[1]), 64: ranker.rank(batches[64], k=5)}
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        print(f"[serve_ghmfc] launches over {len(served)} ranks: {counts}")
        assert counts["gather_dequant"] == sum(counts.values()) == 2, counts
        score_err = 0.0
        for B, (s, i) in served.items():
            assert s.shape == i.shape == (B, 5) and np.isfinite(s).all(), (B, s.shape)
            full, want = ranker.score(batches[B]), reference.score(batches[B])
            assert full.shape == want.shape == (B, cfg.num_candidates_model)
            np.testing.assert_allclose(s, np.take_along_axis(full, i, -1), rtol=0, atol=1e-5)
            err, spread = float(np.abs(full - want).max()), float(want.std(-1).min())
            assert err <= GHMFC_SCORE_ATOL < spread, (B, err, GHMFC_SCORE_ATOL, spread)
            score_err = max(score_err, err)
            print(f"[serve_ghmfc] B={B}: top-5 {s.shape}, finite; scores vs the f32 CPU forward "
                  f"over the same int8 rows: max abs err {err:.4g} (tol {GHMFC_SCORE_ATOL}, under "
                  f"the candidates' spread {spread:.3g})")
        ms_http = host_ms(lambda: post_rank(np, url, fields, batches[1]))
        ms_b1 = host_ms(lambda: ranker.rank(batches[1], k=5))
        ms_b64 = host_ms(lambda: ranker.rank(batches[64], k=5))
        print(f"[serve_ghmfc] /rank B=1: {ms_http:.3f} ms per request (HTTP, median of 10); "
              f"Ranker.rank B=1: {ms_b1:.3f} ms; Ranker.rank B=64: {ms_b64:.3f} ms, "
              f"{64 * cfg.num_candidates_model / (ms_b64 / 1e3):.0f} pairs/s")
        profile_rank(torch, ranker, batches[64], "offline GHMFC B=64")

        # the entity precompute: the table encoded once, then mention
        # encoding, a row gather and a cosine per request; no kernel 2 launch
        t0 = time.perf_counter()
        reprs = ranker.precompute_entity_reprs()
        pre_s = time.perf_counter() - t0
        assert reprs.shape == (N_ENTITIES, cfg.entity_final_output_dim) and np.isfinite(reprs).all()
        before = gather.launches
        rs, ri = ranker.rank_rows(batches[64][:5], batches[64][5], k=5)
        assert gather.launches == before, "rank_rows gathered through kernel 2"
        full = ranker.score(batches[64])
        picked = np.take_along_axis(full, ri, -1)  # rank_rows' top-5 as the full forward scores them
        rr_err = float(np.abs(rs - picked).max())
        kth = -np.sort(-full, axis=-1)[:, 4:5]  # the full forward's 5th best
        short = float((kth - picked).max())
        same = int((np.sort(ri, -1) == np.sort(ranker.rank(batches[64], k=5)[1], -1)).all(-1).sum())
        ms_rr = host_ms(lambda: ranker.rank_rows(batches[64][:5], batches[64][5], k=5))
        print(f"[serve_ghmfc] precompute_entity_reprs: {N_ENTITIES} rows in {pre_s:.2f} s; "
              f"rank_rows B=64 vs rank's full forward: max abs diff {rr_err:.3g} (tol "
              f"{RANK_ROWS_ATOL}); its top-5 fall at most {short:.3g} under the full forward's 5th "
              f"best, and equal rank's top-5 sets on {same} of 64 mentions (the rest differ by "
              f"ties); rank_rows B=64 {ms_rr:.3f} ms against rank {ms_b64:.3f} ms")
        assert rr_err <= RANK_ROWS_ATOL and short <= RANK_ROWS_ATOL, (rr_err, short)
        profile_call(torch, lambda: ranker.rank_rows(batches[64][:5], batches[64][5], k=5),
                     "offline GHMFC B=64 rank_rows")
    finally:
        server.shutdown()
        server.server_close()
    return {"gather_dequant": counts["gather_dequant"]}, score_err


def phase_transformer(torch, np, kernels):
    """One offline GHMFC forward at full width with the transformer mention
    layer (8 post-LN layers, 8 heads, FFN 512) in bf16 on the card against
    f32 on the CPU; the check must see the padding mask left out."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.models.ghmfc import GHMFC
    from drin_tpu_torch.serve import Ranker

    cfg = make_config("ghmfc", "wikimel", compute_dtype="bfloat16",
                      mention_final_layer_name="transformer")
    assert (cfg.transformer_num_layers, cfg.transformer_num_heads,
            cfg.transformer_ffn_hidden_size) == (8, 8, 512)
    weights = GHMFC(cfg, generator=torch.Generator().manual_seed(SEED)).state_dict()
    ranker = Ranker(cfg, weights, device="cuda")
    reference = Ranker(cfg.replace(compute_dtype="float32"), weights, device="cpu")
    B, C = 64, cfg.num_candidates_model
    rng = np.random.default_rng(SEED + 50)
    feats = _baseline_rows(np, cfg, B, SEED + 51)[:5] + (
        rng.standard_normal((B, C, 2, cfg.bert_embed_dim), dtype=np.float32),
        np.zeros((B,), np.int64), np.zeros((B, C, 1), np.float32))
    zero_counts(kernels)
    got = ranker.score(feats)
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    assert not any(counts.values()), counts
    want = reference.score(feats)
    err, spread = float(np.abs(got - want).max()), float(want.std(-1).min())
    unmasked = list(feats)
    unmasked[1] = np.ones_like(feats[1])
    fault = float(np.abs(ranker.score(unmasked) - want).max())
    print(f"[transformer] GHMFC with the transformer mention layer, B={B}: bf16 scores vs the "
          f"f32 CPU forward: max abs err {err:.4g} (tol {TRANSFORMER_SCORE_ATOL}, under the "
          f"candidates' spread {spread:.3g}); with the padding mask left out: {fault:.4g}")
    assert np.isfinite(got).all() and err <= TRANSFORMER_SCORE_ATOL < spread, (err, spread)
    assert fault > TRANSFORMER_SCORE_ATOL, "the transformer check cannot see the mask left out"
    return {}, err


def phase_serve_melhi(torch, np, kernels):
    """MELHI (WikiDiverse, C=11) through Ranker and serve_http at full width:
    the LSTM over 2B context rows of 128 steps, 2304 wide.  Thresholds are
    set inside the run's own cosines so that both gate states occur; the
    gates of the bf16 card run and the f32 reference are compared apart, and
    the scores are held on the mentions whose gates agree."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.data.dataset import BaselineBatch
    from drin_tpu_torch.models.melhi import MELHI
    from drin_tpu_torch.serve import Ranker, rank_feat_fields, serve_http

    cfg = make_config("melhi", "wikidiverse", compute_dtype="bfloat16")
    assert (cfg.bert_embed_dim, cfg.resnet_embed_dim, cfg.max_mention_sentence_len,
            cfg.num_candidates_model) == (768, 2048, 128, 11)
    weights = MELHI(cfg, generator=torch.Generator().manual_seed(SEED)).state_dict()
    batches = {B: _wikidiverse_batch(np, cfg, B, SEED + 60 + B) for B in (1, 64)}
    cfg = melhi_thresholds(torch, np, cfg, weights, batches[64])
    ranker = Ranker(cfg, weights, device="cuda")
    reference = Ranker(cfg.replace(compute_dtype="float32"), weights, device="cpu")
    fields = rank_feat_fields(ranker)
    assert ranker.store is None and fields == list(BaselineBatch._fields[:-1])
    server = serve_http(ranker, port=0, feat_fields=fields)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        zero_counts(kernels)
        served = {1: post_rank(np, url, fields, batches[1]), 64: ranker.rank(batches[64], k=5)}
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        assert not any(counts.values()), counts
        for B, (s, i) in served.items():
            assert s.shape == i.shape == (B, 5) and np.isfinite(s).all(), (B, s.shape)
            assert ((0 <= i) & (i < cfg.num_candidates_model)).all()
        batch = batches[64]
        with torch.inference_mode():
            card_gate = ranker.model.gates(ranker._prepare(batch)).cpu().numpy()
            ref_gate = reference.model.gates(reference._prepare(batch)).numpy()
        assert ref_gate.any() and not ref_gate.all(), "the f32 run shows only one gate state"
        assert card_gate.any() and not card_gate.all(), "the card run shows only one gate state"
        agree = card_gate == ref_gate
        full, want = ranker.score(batch), reference.score(batch)
        np.testing.assert_allclose(served[64][0], np.take_along_axis(full, served[64][1], -1),
                                   rtol=0, atol=1e-5)
        err = float(np.abs(full - want)[agree].max())
        spread = float(want.std(-1).min())
        # the reach of the limit: the LSTM's input and forget gates swapped,
        # and each context read one step short
        lstm = ranker.model.mention_encoder.mention_lstm
        sd = {k: v.clone() for k, v in lstm.state_dict().items()}
        H = lstm.hidden
        lstm.load_state_dict({k: torch.cat([v[H:2 * H], v[:H], v[2 * H:]]) for k, v in sd.items()})
        swapped = float(np.abs(ranker.score(batch) - want)[agree].max())
        lstm.load_state_dict(sd)
        forward = lstm.forward
        lstm.forward = lambda x, lengths: forward(x, lengths - 1)
        try:
            short = float(np.abs(ranker.score(batch) - want)[agree].max())
        finally:
            del lstm.forward
        print(f"[serve_melhi] B=64: gates open on the card {int(card_gate.sum())}, in the f32 "
              f"reference {int(ref_gate.sum())}, flipped {int((~agree).sum())}; scores on the "
              f"{int(agree.sum())} agreeing mentions vs the f32 CPU forward: max abs err "
              f"{err:.4g} (tol {MELHI_SCORE_ATOL}, candidates' spread >= {spread:.3g}); planted "
              f"faults: i/f gates swapped {swapped:.4g}, last step one short {short:.4g}")
        assert err <= MELHI_SCORE_ATOL, err
        assert swapped > MELHI_SCORE_ATOL and short > MELHI_SCORE_ATOL, (swapped, short)
        # bf16 error of the LSTM alone against f32 on the card, by length
        x = torch.randn(64, 128, lstm.weight_ih_l0.shape[1], device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
        lstm32 = type(lstm)(x.shape[-1], H).cuda()
        lstm32.load_state_dict({k: v.float() for k, v in sd.items()})
        by_len = {}
        with torch.inference_mode():
            for n in (1, 8, 32, 128):
                lens = torch.full((64,), n, device="cuda")
                ref_h = lstm32(x, lens)
                by_len[n] = float((lstm(x.to(lstm.weight_ih_l0.dtype), lens).float()
                                   - ref_h).abs().max() / ref_h.abs().max())
        print(f"[serve_melhi] the LSTM alone, bf16 vs f32 on the card, max |h err| / max |h| by "
              f"length: {by_len}")
        ms_http = host_ms(lambda: post_rank(np, url, fields, batches[1]))
        ms_b1 = host_ms(lambda: ranker.rank(batches[1], k=5))
        ms_b64 = host_ms(lambda: ranker.rank(batches[64], k=5))
        print(f"[serve_melhi] /rank B=1: {ms_http:.3f} ms per request (HTTP, median of 10); "
              f"Ranker.rank B=1: {ms_b1:.3f} ms; Ranker.rank B=64: {ms_b64:.3f} ms, "
              f"{64 * cfg.num_candidates_model / (ms_b64 / 1e3):.0f} pairs/s")
        profile_rank(torch, ranker, batches[64], "MELHI B=64", reps=3)
    finally:
        server.shutdown()
        server.server_close()
    return {}, err


def _train_baseline(torch, np, kernels, tag, cfg, build, rows, feats_fn_for, fault_module):
    """Train steps of an offline baseline through Trainer / build_step_fns
    at B = cfg.batch_size.  First-step gradients (dropout off) per tensor
    against the f32 CPU port: the same model in float32 on the card within
    summation order, the bf16 body within its rounding, and one gradient
    dropped in the backward (the output of ``fault_module``) outside both;
    the first loss within TRAIN_LOSS_RTOL.  Then five steps on the repeated
    batch, whose eval loss must fall."""
    import copy

    from drin_tpu_torch.train import metrics as M
    from drin_tpu_torch.train.trainer import Trainer

    B, n_steps = cfg.batch_size, 5
    model = build(cfg)
    f32 = cfg.replace(compute_dtype="float32")
    copies = [copy.deepcopy(model), copy.deepcopy(model)]
    make = lambda c, m, device: Trainer(c, m, device=device, feats_fn=feats_fn_for(c, device),
                                        log=lambda *a: None)
    trainer, card32, cpu = make(cfg, model, "cuda"), make(f32, copies[0], "cuda"), \
        make(f32, copies[1], "cpu")
    ones = np.ones((B,), np.float32)
    batch, valid = trainer._put(rows, ones)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] Trainer({cfg.model_type}, {cfg.dataset_name}) on cuda: {n_params / 1e6:.2f} M "
          f"float32 master parameters, body in {cfg.compute_dtype}, B={B}")

    def grads(tr):
        b, v = tr._put(rows, ones)
        tr.state.model.zero_grad(set_to_none=True)
        loss, _, _ = tr.fns.loss_and_metrics(b, v, M.init_state(cfg.metrics_topk, tr.device))
        loss.backward()
        got = {n: p.grad.float().cpu() for n, p in tr.state.model.named_parameters()
               if p.grad is not None}
        tr.state.model.zero_grad(set_to_none=True)
        return float(loss.detach()), got

    def drop_grad(module, args, out):  # no gradient flows back through the output
        out.register_hook(torch.zeros_like)

    (l_cpu, g_cpu), (l_32, g_32), (l_card, g_card) = grads(cpu), grads(card32), grads(trainer)
    dropped = trainer.state.model.get_submodule(fault_module).register_forward_hook(drop_grad)
    try:
        _, g_fault = grads(trainer)
    finally:
        dropped.remove()
    del card32, cpu, copies
    assert set(g_card) == set(g_32) == set(g_cpu) and len(g_cpu) >= 4, sorted(g_card)
    rel = lambda g: {n: float((g[n] - w).norm() / w.norm().clamp_min(1e-30))
                     for n, w in g_cpu.items()}
    largest = lambda r: [(n, float(f"{r[n]:.3g}")) for n in sorted(r, key=r.get, reverse=True)[:3]]
    rel_32, rel_c, rel_f = rel(g_32), rel(g_card), rel(g_fault)
    worst_f = max(rel_f, key=rel_f.get)
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"[{tag}] first-step loss {l_card:.6f} (f32 on the card {l_32:.6f}, f32 CPU port "
          f"{l_cpu:.6f}: relative error {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradients "
          f"(dropout off) vs the f32 CPU port, relative L2 per tensor ({len(g_cpu)} tensors), the "
          f"largest: f32 on the card {largest(rel_32)} (limit {TRAIN_BASELINE_F32_GRAD_REL}), "
          f"bf16 {largest(rel_c)} (limit {TRAIN_BASELINE_BF16_GRAD_REL}); with the gradient "
          f"through {fault_module} dropped: {worst_f} {rel_f[worst_f]:.3g}")
    assert all(torch.isfinite(g).all() for g in g_card.values())
    assert max(rel_32.values()) <= TRAIN_BASELINE_F32_GRAD_REL, largest(rel_32)
    assert max(rel_c.values()) <= TRAIN_BASELINE_BF16_GRAD_REL, largest(rel_c)
    assert rel_f[worst_f] > TRAIN_BASELINE_BF16_GRAD_REL, "the check cannot see a dropped gradient"
    assert loss_err <= TRAIN_LOSS_RTOL, loss_err
    del g_cpu, g_32, g_card, g_fault

    ev_before = float(trainer.fns.eval_step(batch, valid, M.init_state(cfg.metrics_topk, "cuda"))[0])
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    losses, times, mstate = _run_steps(torch, trainer, batch, valid, n_steps)
    ev_loss, mstate, scores = trainer.fns.eval_step(batch, valid, mstate)
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert not any(counts.values()), counts
    assert np.isfinite(losses).all() and float(ev_loss) < ev_before, (ev_before, float(ev_loss), losses)
    assert tuple(scores.shape) == (B, cfg.num_candidates_model) and torch.isfinite(scores).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    step_ms = statistics.median(times[1:])
    print(f"[{tag}] {n_steps} train steps + 1 eval step, no kernel launched ({counts}): train "
          f"losses {[round(x, 5) for x in losses]}, eval loss {ev_before:.5f} before and "
          f"{float(ev_loss):.5f} after; {step_ms:.2f} ms per step (median of {n_steps - 1}; the "
          f"first {times[0]:.1f} ms), {B * cfg.num_candidates_model / (step_ms / 1e3):.0f} "
          f"pairs/s, peak memory {peak:.2f} GiB")
    mstate0 = M.init_state(cfg.metrics_topk, "cuda")
    profile_call(torch, lambda: trainer.fns.train_step(trainer.state, batch, valid, mstate0),
                 f"{tag} train step B={B}", reps=3)
    return {}, {"step_ms": step_ms, "peak_gib": peak}


def phase_train_ghmfc(torch, np, kernels):
    """Offline GHMFC trained over the float device store (text only, rows
    gathered inside the step) at B=64, WikiMEL widths."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.data.device_store import DeviceEntityStore, include_for
    from drin_tpu_torch.models.ghmfc import GHMFC

    cfg = make_config("ghmfc", "wikimel", compute_dtype="bfloat16", batch_size=64)
    tables = _text_tables(np, cfg, N_ENTITIES)
    rows = _baseline_rows(np, cfg, 64, SEED + 70) + (_onehot_answers(np, cfg, 64, SEED + 71),)

    def feats_fn_for(c, device):
        store = DeviceEntityStore(c, tables, device=device, include=include_for("baseline"))
        assert store.include == ("text",) and not store.quantized
        return store.baseline_feats_fn()

    build = lambda c: GHMFC(c, generator=torch.Generator().manual_seed(SEED))
    return _train_baseline(torch, np, kernels, "train_ghmfc", cfg, build, rows, feats_fn_for,
                           "entity_encoder.final_layer")


def phase_train_melhi(torch, np, kernels):
    """MELHI trained on the WikiDiverse baseline batch at B=64, full width,
    thresholds inside the batch's cosines so both gate states train."""
    from drin_tpu_torch import make_config
    from drin_tpu_torch.models.melhi import MELHI

    cfg = make_config("melhi", "wikidiverse", compute_dtype="bfloat16", batch_size=64)
    feats = _wikidiverse_batch(np, cfg, 64, SEED + 80)
    build = lambda c: MELHI(c, generator=torch.Generator().manual_seed(SEED))
    cfg = melhi_thresholds(torch, np, cfg, build(cfg).state_dict(), feats)
    rows = feats + (_onehot_answers(np, cfg, 64, SEED + 81),)
    return _train_baseline(torch, np, kernels, "train_melhi", cfg, build, rows,
                           lambda c, device: None, "mention_encoder.mention_lstm")


# --- detection: the NMS kernel (phase_nms) and the detector (phase_detector) -

DET_SIZE = 800  # FRCNNConfig().min_size: the detector's square input
DET_STAGE_BATCH = 64  # the stage's chunk (preprocess_batch_size)
# the detector on the card against the port's f32 CPU forward on the same
# images: max |got - want| / max |want| of the FPN levels (the worst level),
# the RPN logits (the worst level) and the class probabilities (the card's RoI
# head on the CPU's proposals, so both read the same boxes).  f32 on both
# sides with TF32 off; the products sum in another order.  The first run on
# an NVIDIA H100 80GB HBM3 (700 W) read 3.1e-6, 4.7e-6 and 1.0e-5; the
# limits are about ten times that.  cuDNN's TF32 with no full_float32()
# guard (the planted fault) read 1.0e-3, 2.0e-3 and 2.3e-3 on that card
DET_FPN_REL = 3e-5
DET_LOGIT_REL = 5e-5
DET_PROB_REL = 1e-4
# detections matched between two runs: the same label, IoU >= 0.999 and the
# score within 1e-4.  A last-bit difference can move a box across a top-k
# cut or an NMS threshold; such a difference is printed with its margin.  At
# most this share of an image's detections may go unmatched, and each of
# them must sit within DET_MARGIN of a cut or a threshold
DET_UNMATCHED_SHARE = 0.05
DET_MARGIN = 1e-3
# three classes' cls_score biases raised by this much: their softmax
# probability ~0.2 against ~1/91 for the rest, so that the 0.05 score
# threshold keeps detections at random weights
DET_RAISED_CLASSES = (1, 18, 62)
DET_RAISE = 4.0


def _write_detector(torch, d):
    """A seeded torchvision fasterrcnn_resnet50_fpn state dict at
    FRCNNConfig()'s widths, saved in both key layouts: ``detector.pt``
    (torchvision >= 0.13) and ``detector-pre013.pt`` (before).  ResNet-50's
    convolutions He-normal with each bottleneck's last FrozenBN scaled to 0.2
    (50 blocks keep their activations O(1)), the FPN and RPN convolutions
    over their fan-in, small box regressors (boxes near their anchors and
    proposals), and DET_RAISED_CLASSES' biases raised by DET_RAISE.  Returns
    the two paths and the parameter count."""
    import math

    from drin_tpu_torch.encoders.checkpoints import _pre_013_spelling
    from drin_tpu_torch.encoders.frcnn import FasterRCNN, FRCNNConfig

    g = torch.Generator().manual_seed(SEED + 1500)
    normal = lambda t, std: torch.randn(t.shape, generator=g) * std
    with torch.device("meta"):
        keys = FasterRCNN(FRCNNConfig()).state_dict()
    sd = {}
    for k, t in keys.items():
        fan_in = t[0].numel() if t.dim() > 1 else 1
        if k.endswith("bias") and t.dim() == 1 and ("bn" not in k and "downsample.1" not in k):
            sd[k] = torch.zeros(t.shape)
        elif k.startswith("backbone.body") and t.dim() == 4:
            sd[k] = normal(t, math.sqrt(2.0 / fan_in))
        elif k.endswith("running_var"):
            sd[k] = 1 + 0.1 * torch.rand(t.shape, generator=g)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            sd[k] = normal(t, 0.05)
        elif t.dim() == 1:  # FrozenBN scale
            sd[k] = torch.full(t.shape, 0.2 if ".bn3." in k else 1.0)
        elif "bbox_pred" in k:
            sd[k] = normal(t, 0.1 / math.sqrt(fan_in))
        elif k.startswith("backbone.fpn") or "cls_logits" in k or "cls_score" in k:
            sd[k] = normal(t, 1.0 / math.sqrt(fan_in))
        else:  # the RPN head's 3x3, fc6, fc7
            sd[k] = normal(t, math.sqrt(2.0 / fan_in))
    bias = sd["roi_heads.box_predictor.cls_score.bias"]
    bias[list(DET_RAISED_CLASSES)] += DET_RAISE
    new, old = os.path.join(d, "detector.pt"), os.path.join(d, "detector-pre013.pt")
    torch.save(sd, new)
    torch.save({_pre_013_spelling(k): v for k, v in sd.items()}, old)
    assert any(_pre_013_spelling(k) != k for k in sd)
    return new, old, sum(t.numel() for t in sd.values())


def _det_images(np, n, seed, size=224):
    """n seeded [size, size, 3] images in [0, 1]: a 12x12 pattern scaled up,
    plus noise, as the stage hands images to the detector."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = Image.fromarray(rng.integers(0, 255, (12, 12, 3), dtype=np.uint8)).resize((size, size))
        arr = np.clip(np.asarray(base, np.int16) + rng.integers(-20, 21, (size, size, 3)), 0, 255)
        out.append(arr.astype(np.float32) / 255.0)
    return np.stack(out)


def _rpn_problems(torch, images: int, seed: int):
    """The RPN's NMS problems of ``images`` images at 800 px, built as
    FasterRCNN.proposals builds them: per level (200^2, 100^2, 50^2, 25^2,
    13^2 cells x 3 anchors) the top 1000 (507 at P6) of seeded logits by a
    stable sort, decoded with seeded deltas, clipped, degenerate boxes at
    -inf, padded to 1000 with -inf.  Returns boxes [images, 5, 1000, 4] and
    scores [images, 5, 1000] on the card."""
    from drin_tpu_torch.encoders.frcnn import FRCNNConfig, take_along, top_k
    from drin_tpu_torch.ops.detection import clip_boxes, decode_boxes, generate_anchors

    c = FRCNNConfig()
    g = torch.Generator(device="cuda").manual_seed(seed)
    boxes, scores = [], []
    for lvl, cells in enumerate((200, 100, 50, 25, 13)):
        anchors = generate_anchors((cells, cells), 2 ** (lvl + 2), c.anchor_sizes[lvl],
                                   c.aspect_ratios, device="cuda")
        logit = torch.randn((images, anchors.shape[0]), generator=g, device="cuda")
        delta = 0.2 * torch.randn((images, anchors.shape[0], 4), generator=g, device="cuda")
        s, i = top_k(logit, min(c.pre_nms_topk, anchors.shape[0]))
        b = clip_boxes(decode_boxes(take_along(delta, i), anchors[i]), DET_SIZE, DET_SIZE)
        s = torch.where(((b[..., 2] - b[..., 0]) > 1e-3) & ((b[..., 3] - b[..., 1]) > 1e-3), s,
                        float("-inf"))
        pad = c.pre_nms_topk - s.shape[1]
        boxes.append(torch.nn.functional.pad(b, (0, 0, 0, pad)))
        scores.append(torch.nn.functional.pad(s, (0, pad), value=float("-inf")))
    return torch.stack(boxes, 1), torch.stack(scores, 1)


def _class_problems(torch, images: int, seed: int):
    """The class NMS problems of ``images`` images: 4,096 candidates each
    (1,000 proposals x 90 classes cut by score), proposals jittered by class,
    scores in [0.05, 0.3) and a seventh at -inf (under the threshold), boxes
    offset by label * 802 as FasterRCNN.postprocess offsets them.  Returns
    boxes [images, 4096, 4] and scores [images, 4096]."""
    from drin_tpu_torch.ops.detection import clip_boxes

    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 4096
    xy = torch.rand((images, 1000, 2), generator=g, device="cuda") * 700
    wh = 16 + torch.rand((images, 1000, 2), generator=g, device="cuda") * 300
    props = torch.cat([xy, xy + wh], -1)
    pick = torch.randint(0, 1000, (images, n), generator=g, device="cuda")
    labels = torch.randint(1, 91, (images, n), generator=g, device="cuda")
    boxes = torch.gather(props, 1, pick[..., None].expand(-1, -1, 4))
    boxes = clip_boxes(boxes + 4 * torch.randn((images, n, 4), generator=g, device="cuda"),
                       DET_SIZE, DET_SIZE)
    scores = 0.05 + 0.25 * torch.rand((images, n), generator=g, device="cuda")
    scores[torch.rand((images, n), generator=g, device="cuda") < 1 / 7] = float("-inf")
    return boxes + (labels.float() * (DET_SIZE + 2.0))[..., None], scores


def _nms_edge_cases(torch, seed: int):
    """(name, boxes [P, N, 4], scores [P, N], threshold, top_k) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xy = torch.rand((4, 1000, 2), generator=g, device="cuda") * 700
    b = torch.cat([xy, xy + 20 + torch.rand((4, 1000, 2), generator=g, device="cuda") * 200], -1)
    s = torch.randn((4, 1000), generator=g, device="cuda")
    same = b[:, :1].expand(-1, 1000, -1).contiguous()
    # IoU exactly 0.5 between each box and its neighbour: [x, 0, x + 4, 1]
    # against [x, 0, x + 2, 1] (inter 2, union 4)
    x = torch.arange(500, device="cuda", dtype=torch.float32) * 10
    at = torch.stack([torch.stack([x, 0 * x, x + 4, 0 * x + 1], -1),
                      torch.stack([x, 0 * x, x + 2, 0 * x + 1], -1)], 1).reshape(1, 1000, 4)
    at_s = torch.linspace(1, 0, 1000, device="cuda")[None]
    ties = torch.floor(torch.rand((4, 1000), generator=g, device="cuda") * 4) / 4
    return [("no score above -inf", b, torch.full_like(s, float("-inf")), 0.7, 1000),
            ("every box equal", same, s, 0.5, 100),
            ("IoU exactly at the threshold", at, at_s, 0.5, 1000),
            ("equal scores (4 values)", b, ties, 0.7, 1000),
            ("equal scores, class cut", b, ties, 0.5, 100)]


def _nms_iou_evals(torch, keep, boxes, scores, thr, top_k) -> int:
    """The IoUs a greedy pass over these problems cannot skip: each kept box
    against every box after it in the sorted order that is still live when
    it is picked (its score above -inf, removed by no earlier pick).  The
    top_k-th pick tests none: the pass ends there."""
    from drin_tpu_torch.ops.detection import box_iou

    n = scores.shape[-1]
    keep, boxes, scores = keep.reshape(-1, top_k), boxes.reshape(-1, n, 4), scores.reshape(-1, n)
    total = 0
    for p0 in range(0, scores.shape[0], 16):  # [16, top_k, n] at a time
        kp, b, s = keep[p0:p0 + 16], boxes[p0:p0 + 16], scores[p0:p0 + 16]
        order = torch.sort(s, dim=-1, descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(-1, order, torch.arange(n, device=order.device).expand_as(order))
        picked = (kp >= 0)[..., None]
        k = kp.clamp_min(0)
        after = rank[:, None, :] > torch.gather(rank, -1, k)[..., None]
        kb = torch.gather(b, 1, k[..., None].expand(-1, -1, 4))
        hit = (box_iou(kb, b) > thr) & after & picked
        removed = (hit.cumsum(1) - hit.long()) > 0  # by an earlier pick
        tested = after & picked & ~removed & (s > float("-inf"))[:, None, :]
        tested[:, top_k - 1] = False
        total += int(tested.sum())
    return total


def phase_nms(torch, np, nms_mod):
    """The NMS kernel against nms_plain on the same CUDA tensors: the RPN's
    problems (64 images x 5 levels, N = 1000, top_k 1000, P6's 507 padded
    as the detector pads them), the class NMS (N = 4096, top_k 100, boxes
    offset by class) at the stage's 64 images and the detector's forward
    batch of 8, and the edge cases.  The kept indices must be equal.  Two
    planted faults must break that equality: nms_plain with `>=` for `>`
    (a kernel equal to nms_plain where the two differ cannot hold `>=`) and
    the kernel's walk fed a sort that breaks ties toward the higher index
    (what an unstable sort may give).  Times by CUDA events and device time
    beside the bound."""
    from drin_tpu_torch.ops.detection import nms_plain

    cases = []
    b, s = _rpn_problems(torch, DET_STAGE_BATCH, SEED + 1600)
    cases.append(("rpn [64x5, 1000] top 1000", b, s, 0.7, 1000))
    cases.append(("rpn [8x5, 1000] top 1000 (a forward)", b[:8], s[:8], 0.7, 1000))
    b, s = _class_problems(torch, DET_STAGE_BATCH, SEED + 1601)
    cases.append(("class [64, 4096] top 100", b, s, 0.5, 100))
    cases.append(("class [8, 4096] top 100 (a forward)", b[:8], s[:8], 0.5, 100))
    cases += _nms_edge_cases(torch, SEED + 1602)
    lib, fn = nms_mod.entry()
    results, faults = {}, {"ge": 0, "ties reversed": 0}
    for name, boxes, scores, thr, k in cases:
        got = nms_mod.nms_cuda(boxes, scores, thr, k)
        want = nms_plain(boxes, scores, thr, k)
        torch.cuda.synchronize()
        kept = int((want >= 0).sum())
        assert torch.equal(got, want), (
            f"nms kernel != nms_plain on {name}: {int((got != want).sum())} slots differ")
        # the planted faults, through the wrapper's own steps
        # `>=` for `>`: iou > the float32 below thr is iou >= thr in float32
        below = float(np.nextafter(np.float32(thr), np.float32(-np.inf)))
        bad_ge = nms_plain(boxes, scores, below, k)
        bb, ss, _ = nms_mod._problems(boxes, scores)
        asc = torch.sort(ss, dim=-1, stable=True)
        bad_ties = nms_mod._launch(fn, lib, bb, asc.values.flip(-1), asc.indices.flip(-1), thr,
                                   k).reshape(want.shape)
        d_ge, d_ties = int((bad_ge != want).sum()), int((bad_ties != want).sum())
        faults["ge"] += d_ge
        faults["ties reversed"] += d_ties
        print(f"[nms] {name}: kept {kept} of {want.numel()} slots, equal to nms_plain; "
              f"planted `>=`: {d_ge} slots differ, ties reversed: {d_ties}")
        if "threshold" in name:
            assert d_ge, "the check cannot see `>=` for `>`"
        if "equal scores" in name:
            assert d_ties, "the check cannot see an unstable sort"
        results[name] = (boxes, scores, thr, k, want)

    # times at the main path's shapes (a detector forward of 8 images) and at
    # the stage's 64 images; the lead numbers are the forward's RPN call
    times = {}
    for name in ("rpn [8x5, 1000] top 1000 (a forward)", "class [8, 4096] top 100 (a forward)",
                 "rpn [64x5, 1000] top 1000", "class [64, 4096] top 100"):
        boxes, scores, thr, k, want = results[name]
        call = lambda: nms_mod.nms_cuda(boxes, scores, thr, k)
        ms = cuda_ms(call)
        by_kernel = kernel_device_ms(torch, call)
        plain_ms = cuda_ms(lambda: nms_plain(boxes, scores, thr, k), reps=3, warmup=1)
        moved = nbytes(boxes, scores, want)
        flops = 14 * _nms_iou_evals(torch, want, boxes, scores, thr, k)  # ~14 FLOP an IoU
        bound_ms, bound_by = bound(moved, flops, "float32")
        dev = sum(by_kernel.values())
        split = {k_[:40]: round(v, 4) for k_, v in by_kernel.items()}
        print(f"[nms] {name}: kernel {ms:.4f} ms (device {dev:.4f}: {split}), plain {plain_ms:.3f} "
              f"ms; bound {bound_ms:.5f} ms ({bound_by}: {moved / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP); no single PyTorch call computes greedy NMS")
        times[name] = {"ms": ms, "device_ms": dev, "device_ms_by_kernel": by_kernel,
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    lead = times["rpn [8x5, 1000] top 1000 (a forward)"]
    return {"max_abs_err": 0, "ms": lead["ms"], "device_ms": lead["device_ms"],
            "plain_ms": lead["plain_ms"], "bound_ms": lead["bound_ms"],
            "bound_by": lead["bound_by"], "library_ms": None, "shapes": times,
            "planted_faults": faults}


def _det_rel(a, b) -> float:
    """max |a - b| / max |b| over tensors (or lists of them, the worst)."""
    if isinstance(a, (list, tuple)):
        return max(_det_rel(x, y) for x, y in zip(a, b))
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _det_stages(torch, model, x, H, W, proposals=None):
    """The detector's continuous stages and its detections on images ``x``
    [B, 3, 800, 800] in ``model``'s device: FPN levels, RPN logits, the
    proposals, class probabilities (over ``proposals`` when given, else its
    own), and (boxes, scores, labels)."""
    feats = model.features(x)
    logits, deltas = model.rpn.head(feats)
    props = model.proposals(feats, logits, deltas, H, W)
    read = props if proposals is None else proposals.to(x.device)
    probs, box_deltas = model.class_outputs(feats[:4], read)
    dets = model.postprocess(probs, box_deltas, read, H, W)
    return {"feats": feats, "logits": logits, "proposals": props, "probs": probs, "dets": dets}


def _match_detections(torch, card, cpu, label: str, full: int):
    """Detections of one image as matched sets: a card detection matches a
    CPU one of the same label with IoU >= 0.999 and a score within 1e-4.
    Each unmatched one is printed with its decisive margin, the smallest of:
    its score's distance to the other side's last kept score when that side
    kept ``full`` (the top-k cut), its largest IoU with the other side's
    detections of its label less the NMS threshold 0.5, and its score less
    the 0.05 threshold.  Returns (matched, unmatched, the largest margin of
    an unmatched one, detections)."""
    from drin_tpu_torch.ops.detection import box_iou

    sides = []
    for boxes, scores, labels in (card, cpu):
        keep = scores > 0
        sides.append((boxes[keep].double().cpu(), scores[keep].double().cpu(), labels[keep].cpu()))
    (cb, cs, cl), (pb, ps, pl) = sides
    ok = ((cl[:, None] == pl[None, :]) & (box_iou(cb, pb) >= 0.999)
          & ((cs[:, None] - ps[None, :]).abs() <= 1e-4))
    pairs = {}
    for i in range(len(cb)):
        for j in torch.nonzero(ok[i]).flatten().tolist():
            if j not in pairs.values():
                pairs[i] = j
                break
    left = (("card", [i for i in range(len(cb)) if i not in pairs], sides[0], sides[1]),
            ("cpu", [j for j in range(len(pb)) if j not in pairs.values()], sides[1], sides[0]))
    margins = []
    for side, idx, (b, s, lab), (ob, os_, ol) in left:
        for i in idx:
            same = ol == lab[i]
            best_iou = float(box_iou(b[i:i + 1], ob[same]).max()) if same.any() else 0.0
            cut = abs(float(s[i]) - float(os_.min())) if len(os_) == full else float("inf")
            margin = min(cut, abs(best_iou - 0.5), abs(float(s[i]) - 0.05))
            margins.append(margin)
            print(f"[detector] {label}: unmatched {side} detection label {int(lab[i])} score "
                  f"{float(s[i]):.6f} box {[round(v, 3) for v in b[i].tolist()]}: the other "
                  f"side kept {len(os_)} (last score {float(os_.min()) if len(os_) else None}), "
                  f"its best IoU with that label {best_iou:.6f}; margin {margin:.3g}")
    return len(pairs), len(margins), max(margins, default=0.0), max(len(cb), len(pb))


def phase_detector(torch, np, nms_mod):
    """The full-width Faster R-CNN (FRCNNConfig(): ResNet-50, FPN 256, 91
    classes) from a seeded torchvision-keyed checkpoint on the card, in full
    float32, against the port's CPU forward of the same 2 images: FPN levels,
    RPN logits and class probabilities (on the CPU's proposals) within their
    limits; the detections of the card's class stage on the CPU's proposals
    and of its whole forward as matched sets; the card with cuDNN's TF32 and
    no guard must exceed each of the three limits; the checkpoint in the
    pre-0.13 key layout detects the same.  Then ms an image and the peak memory of the
    stage's chunk of 64 images through FRCNNDetector, and one forward under
    the profiler."""
    import tempfile

    from drin_tpu_torch import make_config
    from drin_tpu_torch.encoders.checkpoints import load_detector
    from drin_tpu_torch.encoders.frcnn import FasterRCNN
    from drin_tpu_torch.ops.detection import resize_bilinear
    from drin_tpu_torch.preprocess.detector import FRCNNDetector
    from drin_tpu_torch.preprocess.stages import full_float32

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        new, old, n_params = _write_detector(torch, tmp)
        cfg, sd = load_detector(new)
        _, sd_old = load_detector(old)
    assert (cfg.depths, cfg.fpn_channels, cfg.num_classes, cfg.representation_size,
            cfg.min_size, cfg.pre_nms_topk, cfg.detections_per_img) == (
        (3, 4, 6, 3), 256, 91, 1024, 800, 1000, 100)
    print(f"[detector] seeded torchvision-keyed checkpoint, {n_params / 1e6:.1f} M parameters, "
          f"written in both key layouts and loaded in {time.perf_counter() - t0:.1f} s")

    def build(state_dict, device):
        with torch.device("meta"):
            m = FasterRCNN(cfg)
        m.load_state_dict(state_dict, assign=True)
        return m.to(device=device, dtype=torch.float32).eval()

    x224 = torch.from_numpy(_det_images(np, 2, SEED + 1700)).permute(0, 3, 1, 2)
    x_cpu = resize_bilinear(x224, (DET_SIZE, DET_SIZE))
    card, cpu = build(sd, "cuda"), build(sd, "cpu")
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = _det_stages(torch, cpu, x_cpu, DET_SIZE, DET_SIZE)
        cpu_s = time.perf_counter() - t0
        x = resize_bilinear(x224.cuda(), (DET_SIZE, DET_SIZE))
        with full_float32():
            got = _det_stages(torch, card, x, DET_SIZE, DET_SIZE, proposals=want["proposals"])
            own = card(x)
        with _cudnn_tf32(torch):  # the fault: cuDNN's TF32 and no guard
            tf32_feats = card.features(x)
            tf32_logits, _ = card.rpn.head(tf32_feats)
            tf32_probs, _ = card.class_outputs(tf32_feats[:4], want["proposals"].to(x.device))
    errs = {"fpn": _det_rel(got["feats"], want["feats"]),
            "rpn_logits": _det_rel(got["logits"], want["logits"]),
            "class_probs": _det_rel(got["probs"], want["probs"]),
            "resize": _det_rel(x, x_cpu), "fpn_tf32_fault": _det_rel(tf32_feats, want["feats"]),
            "rpn_logits_tf32_fault": _det_rel(tf32_logits, want["logits"]),
            "class_probs_tf32_fault": _det_rel(tf32_probs, want["probs"])}
    by_level = [float(f"{_det_rel(a, b):.3g}") for a, b in zip(got["feats"], want["feats"])]
    props = want["proposals"]
    same_props = int(torch.isclose(got["proposals"].cpu(), props, rtol=0, atol=1e-3).all(-1).sum())
    print(f"[detector] card vs the f32 CPU forward ({cpu_s:.1f} s on the CPU), 2 images at "
          f"{DET_SIZE}: FPN {errs['fpn']:.3g} (by level {by_level}; limit {DET_FPN_REL}), RPN "
          f"logits {errs['rpn_logits']:.3g} (limit {DET_LOGIT_REL}), class probabilities on the "
          f"CPU's proposals {errs['class_probs']:.3g} (limit {DET_PROB_REL}), the resize "
          f"{errs['resize']:.3g}; cuDNN's TF32 with no guard: FPN {errs['fpn_tf32_fault']:.3g}, "
          f"RPN logits {errs['rpn_logits_tf32_fault']:.3g}, class probabilities "
          f"{errs['class_probs_tf32_fault']:.3g}; "
          f"the card's proposals within 1e-3 px of the CPU's, slot for slot: {same_props} of "
          f"{props.shape[0] * props.shape[1]} ({int((props.abs().sum(-1) > 0).sum())} non-empty)")
    assert errs["fpn"] <= DET_FPN_REL and errs["rpn_logits"] <= DET_LOGIT_REL, errs
    assert errs["class_probs"] <= DET_PROB_REL, errs
    for key, limit in (("fpn", DET_FPN_REL), ("rpn_logits", DET_LOGIT_REL),
                       ("class_probs", DET_PROB_REL)):
        assert errs[f"{key}_tf32_fault"] > limit, f"{key} cannot see TF32 convolutions: {errs}"

    # detections as matched sets: the card's class stage on the CPU's
    # proposals (held to the margin), its whole forward (a proposal that an
    # RPN cut or NMS decides otherwise may cascade: printed), and the pre-0.13
    # key layout's forward on the card against the 0.13 one's (equal)
    card_old = build(sd_old, "cuda")
    with torch.inference_mode(), full_float32():
        old_dets = card_old(x)
    del card_old
    full, found = cfg.detections_per_img, 0
    for i in range(x.shape[0]):
        cpu_dets = [t[i] for t in want["dets"]]
        m, u, worst, n = _match_detections(torch, [t[i] for t in got["dets"]], cpu_dets,
                                           f"image {i}, class stage", full)
        labels = sorted(set(cpu_dets[2][cpu_dets[1] > 0].tolist()))
        print(f"[detector] image {i}: {n} detections (labels {labels}); the card's class stage "
              f"on the CPU's proposals: {m} matched, {u} unmatched (largest margin {worst:.3g}, "
              f"limit {DET_MARGIN}; at most {DET_UNMATCHED_SHARE:.0%} may go unmatched)")
        assert n and u <= DET_UNMATCHED_SHARE * n and worst <= DET_MARGIN, (i, m, u, worst)
        m2, u2, worst2, _ = _match_detections(torch, [t[i] for t in own], cpu_dets,
                                              f"image {i}, whole forward", full)
        print(f"[detector] image {i}: the card's whole forward vs the CPU's: {m2} matched, {u2} "
              f"unmatched (largest detection-level margin {worst2:.3g})")
        assert u2 <= DET_UNMATCHED_SHARE * n, (i, m2, u2)
        m3, u3, _, n3 = _match_detections(torch, [t[i] for t in old_dets], [t[i] for t in own],
                                          f"image {i}, pre-0.13 vs 0.13 keys", full)
        assert u3 == 0 and m3 == n3, f"the pre-0.13 key layout detects otherwise: {m3}/{n3}"
        found += n
    print(f"[detector] the pre-0.13 key layout's detections equal the 0.13 layout's ({found} "
          f"detections over 2 images)")
    del cpu, want, got, own, tf32_feats, tf32_logits, tf32_probs, old_dets, card

    # the stage's chunk of 64 images through FRCNNDetector: ms an image, peak
    det = FRCNNDetector(make_config("drin", "wikimel"), sd, cfg, device="cuda")
    batch = _det_images(np, DET_STAGE_BATCH, SEED + 1701)
    with full_float32():
        det(batch, 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        launches0 = nms_mod.launches
        t0 = time.perf_counter()
        _, scores = det(batch, 3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launched = nms_mod.launches - launches0
        with torch.inference_mode():
            xb = torch.from_numpy(batch[:det.batch]).cuda().permute(0, 3, 1, 2)
            prof = profile_call(torch, lambda: det.detect(xb), "[detector] one forward of "
                                f"{det.batch} images", reps=3, top=10)
    ms_image = 1e3 * wall / DET_STAGE_BATCH
    print(f"[detector] FRCNNDetector on {DET_STAGE_BATCH} images of 224 px ({det.batch} a "
          f"forward): {1e3 * wall:.1f} ms, {ms_image:.2f} ms an image; peak memory "
          f"{peak / 2**30:.2f} GiB over the weights and inputs; {launched} NMS launches; top-3 "
          f"scores > 0 in {int((scores > 0).sum())} of {scores.size} slots")
    assert (scores[:, 0] > 0).all() and launched == 2 * -(-DET_STAGE_BATCH // det.batch)
    del det
    torch.cuda.empty_cache()
    return {"errors": errs, "ms_per_image": ms_image, "peak_gib": peak / 2**30,
            "stage_chunk_ms": 1e3 * wall, "profile": prof, "cpu_s": cpu_s}


# --- the offline preprocessing pipeline (preprocess) -------------------------

PRE_MENTIONS = 64  # per split
PRE_ENTITIES = 1024
PRE_IMAGES = 64  # distinct image files; the mentions and entities link to them
# BertStage's features on the card (kernel 3 from a bucket of 256, float32)
# against the port's f32 CPU forward of the same strings, ResNet-152's region
# features and CLIP's miet rows likewise: max |got - want| / max |want|.
# f32 on both sides with TF32 off; the products sum in another order.  The
# first run on the H100 read 1.3e-6 (BERT, bucket 512 through the kernel),
# 1.5e-6 (bucket 128), 1.8e-6 (ResNet-152) and 2.0e-6 (CLIP); the limits are
# about ten times that.  The planted faults read 0.16 (BERT's mask left out
# of the kernel), 0.99 (the regions scrambled) and 0.18 (CLIP pooled at the
# last position)
PRE_BERT_REL = 1e-5
PRE_RESNET_REL = 2e-5
PRE_CLIP_REL = 2e-5
# every file the JAX stages write for WikiMEL, by shape (N mentions per
# split, E entities; the widths are make_config("drin", "wikimel")'s)
PRE_FILES = {
    "mention-text-raw_{s}.npy": "N", "entity-name-raw_{s}.npy": "N*C",
    "start-pos_{s}.npy": "N", "end-pos_{s}.npy": "N", "answer_{s}.npy": "N",
    "mention-text-feature_{s}.npy": "N,Lm,D", "mention-text-mask_{s}.npy": "N,Lm",
    "mention-image-feature_{s}.npy": "N,R,Dr", "mention-object-score_{s}.npy": "N,Km",
    "mention-object-feature_{s}.npy": "N,Km,1,Dr",
    "similarity-miet_{s}.npy": "N,C", "similarity-eimt_{s}.npy": "N,C",
    "entity-attr-feature.npy": "E,Le,D", "entity-attr-mask.npy": "E,Le",
    "entity-image-feature_all.npy": "E,1,Dr", "entity-object-score_all.npy": "E,Ke",
    "entity-object-feature_all.npy": "E,Ke,1,Dr", "qid2idx.json": "E"}


def _pre_text(rng, words, pieces, n):
    """n words of the vocabulary, a tenth with a "##" piece, a comma after
    about one in twelve and a period after about one in fourteen (the
    entity pass turns an abstract's periods into ";"): ~1.25 ids a word."""
    out = []
    for _ in range(n):
        w = words[rng.integers(len(words))]
        if rng.random() < 0.1:
            w += pieces[rng.integers(len(pieces))]
        r = rng.random()
        out.append(w + ("," if r < 0.08 else "." if r < 0.15 else ""))
    return " ".join(out).rstrip(",.") + "."


def _write_raw_wikimel(np, root, words, pieces):
    """A WikiMEL raw corpus (the reference's raw layout): 64 mentions a split
    (sentences of 30-60 words, the mention one of them), a candidates TSV of
    100 qids a mention (the answer among them for ~90%), qid2ne / qid2abs
    over 1,024 entities, and image files.  The first 256 abstracts run 10-40
    words; the rest 150-350 words like Wikipedia abstracts, in chunks of 64
    that land in BERT buckets of 256, 384 and 512 in turn."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 1100)
    for sub in ("images", "mimg", "eimg"):
        os.makedirs(os.path.join(root, sub))
    # distinct non-square images of 180-640 px: a seeded 12x12 pattern scaled up
    # plus noise; the mention and entity files are links to them
    for k in range(PRE_IMAGES + 1):
        w, h = (int(v) for v in rng.integers(180, 641, 2))
        while w == h:
            h = int(rng.integers(180, 641))
        base = Image.fromarray(rng.integers(0, 255, (12, 12, 3), dtype=np.uint8)).resize((w, h))
        arr = np.clip(np.asarray(base, np.int16) + rng.integers(-20, 21, (h, w, 3)), 0, 255)
        name = "default.jpg" if k == PRE_IMAGES else f"images/img{k}.jpg"
        Image.fromarray(arr.astype(np.uint8)).save(os.path.join(root, name), quality=90)
    qids = [f"Q{i}" for i in range(PRE_ENTITIES)]
    names, abstracts = {}, {}
    long_ranges = ((150, 181), (220, 271), (290, 351))
    for i, q in enumerate(qids):
        names[q] = " ".join(words[j] for j in rng.integers(0, len(words), rng.integers(1, 4))).title()
        lo, hi = (10, 41) if i < 256 else long_ranges[(i - 256) // 64 % 3]
        abstracts[q] = _pre_text(rng, words, pieces, int(rng.integers(lo, hi)))
        if i % 8 != 7:  # every eighth entity image missing: the default stands in
            os.symlink(os.path.join(root, "images", f"img{rng.integers(PRE_IMAGES)}.jpg"),
                       os.path.join(root, "eimg", f"{q}.jpg"))
    with open(os.path.join(root, "qid2ne.json"), "w") as f:
        json.dump(names, f)
    with open(os.path.join(root, "qid2abs.json"), "w") as f:
        json.dump(abstracts, f)
    lines = []
    for split in ("train", "valid", "test"):
        mentions = {}
        for i in range(PRE_MENTIONS):
            mid = f"{split}{i:03d}"
            sentence = _pre_text(rng, words, pieces, int(rng.integers(30, 61)))
            toks = sentence.split()
            surface = toks[rng.integers(len(toks))].rstrip(",.")
            cands = [qids[j] for j in rng.choice(PRE_ENTITIES, 100, replace=False)]
            answer = cands[rng.integers(100)] if rng.random() < 0.9 else qids[
                int(rng.integers(PRE_ENTITIES))]
            mentions[f"{mid}-0"] = {"sentence": sentence, "mentions": surface, "answer": answer}
            lines.append("\t".join([f"{mid}-0"] + cands))
            os.symlink(os.path.join(root, "images", f"img{rng.integers(PRE_IMAGES)}.jpg"),
                       os.path.join(root, "mimg", f"{mid}.jpg"))
        with open(os.path.join(root, f"WIKIMEL_{split}.json"), "w") as f:
            json.dump(mentions, f)
    with open(os.path.join(root, "cands.tsv"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_clip_bpe(np, d, words):
    """A CLIP BPE vocabulary of 49,408 entries and its 48,894 merges: the 256
    byte symbols and their word-end forms, merges that build the corpus's
    words left to right (then seeded letter strings), <|startoftext|> at
    49406 and <|endoftext|> at 49407, the largest id, where CLIP pools."""
    from drin_tpu_torch.text.clip_bpe import bytes_to_unicode

    rng = np.random.default_rng(SEED + 1200)
    b2u = bytes_to_unicode()
    symbols = [b2u[b] for b in range(256)]
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>" for s in symbols])}
    n_merges = 49152 - 256 - 2
    merges = []
    pool = sorted({w.lower() for w in words})
    rng.shuffle(pool)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(merges) < n_merges:
        w = pool.pop() if pool else "".join(rng.choice(letters, rng.integers(3, 12)))
        parts = list(w)
        parts[-1] += "</w>"
        while len(parts) > 1 and len(merges) < n_merges:
            new = parts[0] + parts[1]
            if new not in vocab:
                vocab[new] = len(vocab)
                merges.append(f"{parts[0]} {parts[1]}")
            parts = [new] + parts[2:]
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    assert len(vocab) == 49408 and vocab["<|endoftext|>"] == 49407 == max(vocab.values())
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def _save_hf(torch, d, sd, config):
    os.makedirs(d)
    torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)


def _write_encoders(torch, d):
    """Seeded bert-base, ResNet-152 and CLIP ViT-B/32 as HF-style
    directories.  BERT and CLIP as HF initialises them (linears and
    embeddings N(0, 0.02), LayerNorm 1 / 0, biases 0, logit scale
    log(1 / 0.07)); ResNet-152's convolutions He-normal over their fan-in,
    running statistics near 0 / 1 and each bottleneck's last BatchNorm
    scaled to 0.2, so that 50 residual blocks keep the activations O(1)."""
    import math

    from drin_tpu_torch.encoders.bert import BertConfig, BertModel
    from drin_tpu_torch.encoders.clip import CLIPConfig, CLIPModel
    from drin_tpu_torch.encoders.resnet import ResNetConfig, ResNetModel

    g = torch.Generator().manual_seed(SEED + 1300)
    normal = lambda t, std: torch.randn(t.shape, generator=g) * std
    with torch.device("meta"):
        models = {"bert": BertModel(BertConfig()), "resnet": ResNetModel(ResNetConfig()),
                  "clip": CLIPModel(CLIPConfig())}
    sds = {}
    for name, model in models.items():
        sd = {}
        for k, t in model.state_dict().items():
            norm = any(s in k for s in ("LayerNorm", "layer_norm", "layrnorm", "layernorm"))
            if name == "resnet":
                if k.endswith("convolution.weight"):
                    sd[k] = normal(t, math.sqrt(2.0 / t[0].numel()))
                elif k.endswith("running_var"):
                    sd[k] = 1 + 0.1 * torch.rand(t.shape, generator=g)
                elif k.endswith("running_mean") or k.endswith("bias"):
                    sd[k] = normal(t, 0.05)
                else:  # BatchNorm scale
                    sd[k] = torch.full(t.shape, 0.2 if ".layer.2." in k else 1.0)
            elif norm:
                sd[k] = torch.ones(t.shape) if k.endswith("weight") else torch.zeros(t.shape)
            elif k == "logit_scale":
                sd[k] = torch.tensor(math.log(1 / 0.07))
            elif k.endswith("bias"):
                sd[k] = torch.zeros(t.shape)
            else:
                sd[k] = normal(t, 0.02)
        sds[name] = sd
    b = models["bert"].cfg
    _save_hf(torch, os.path.join(d, "bert-base-cased"), sds["bert"], dict(
        model_type="bert", vocab_size=b.vocab_size, hidden_size=b.hidden_size,
        num_hidden_layers=b.num_hidden_layers, num_attention_heads=b.num_attention_heads,
        intermediate_size=b.intermediate_size, max_position_embeddings=b.max_position_embeddings,
        type_vocab_size=b.type_vocab_size, layer_norm_eps=b.layer_norm_eps))
    r = models["resnet"].cfg
    _save_hf(torch, os.path.join(d, "resnet-152"), sds["resnet"], dict(
        model_type="resnet", embedding_size=r.embedding_size, hidden_sizes=list(r.hidden_sizes),
        depths=list(r.depths), downsample_in_first_stage=False, downsample_in_bottleneck=False))
    t, v = models["clip"].cfg.text, models["clip"].cfg.vision
    _save_hf(torch, os.path.join(d, "clip-vit-base-patch32"), sds["clip"], dict(
        model_type="clip", projection_dim=models["clip"].cfg.projection_dim,
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                         num_hidden_layers=t.num_layers, num_attention_heads=t.num_heads,
                         intermediate_size=t.intermediate_size,
                         max_position_embeddings=t.max_position_embeddings),
        vision_config=dict(hidden_size=v.hidden_size, num_hidden_layers=v.num_layers,
                           num_attention_heads=v.num_heads, intermediate_size=v.intermediate_size,
                           image_size=v.image_size, patch_size=v.patch_size)))
    return {name: sum(x.numel() for x in sd.values()) for name, sd in sds.items()}


def _rel_err(np, got, want) -> float:
    """max |got - want| / max |want|."""
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _shape_of(spec: str, dims: dict) -> tuple:
    """"N,C" or "N*C" -> the tuple of sizes those names have in ``dims``."""
    out = []
    for part in spec.split(","):
        n = 1
        for name in part.split("*"):
            n *= dims[name] if name in dims else int(name)
        out.append(n)
    return tuple(out)


def phase_preprocess(torch, np, attn, gcn, nms_mod):
    """The offline preprocessing pipeline on the card at make_config("drin",
    "wikimel")'s widths, through its entry point: ``python -m
    drin_tpu_torch.preprocess all ... device=cuda`` (``__main__.main``) over
    a seeded WikiMEL raw corpus with seeded bert-base, ResNet-152, CLIP
    ViT-B/32 and Faster R-CNN (``detector_checkpoint``, torchvision keys)
    checkpoints, then ``drin_tpu_torch.train.cli.main`` evaluating DRIN
    (test_only) over the store it wrote.  Kernel 3 runs in float32 in
    BertStage's buckets of 256 and more, the NMS kernel in the detector
    (two launches a forward of 8 images), kernel 1 in the eval."""
    import tempfile

    import PIL
    import torch.nn.functional as F

    from drin_tpu_torch import make_config
    from drin_tpu_torch.encoders import checkpoints
    from drin_tpu_torch.encoders.bert import BertModel
    from drin_tpu_torch.encoders.clip import CLIPModel
    from drin_tpu_torch.encoders.resnet import ResNetModel
    from drin_tpu_torch.preprocess import __main__ as pre_cli
    from drin_tpu_torch.preprocess import images, stages
    from drin_tpu_torch.train import cli

    print(f"[preprocess] image decode: Pillow {PIL.__version__} on the card (real JPEG files)")
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        raw, store, enc = (os.path.join(tmp, s) for s in ("raw", "store", "encoders"))
        os.makedirs(enc)
        t0 = time.perf_counter()
        words, pieces = _write_vocab(np, os.path.join(enc, "vocab.txt"))
        _write_raw_wikimel(np, raw, words, pieces)
        _write_clip_bpe(np, enc, words)
        n_params = _write_encoders(torch, enc)
        det_path, _, n_params["detector"] = _write_detector(torch, enc)
        print(f"[preprocess] raw corpus ({3 * PRE_MENTIONS} mentions, {PRE_ENTITIES} entities, "
              f"{PRE_IMAGES} distinct images + default), vocabularies and checkpoints "
              f"({ {k: f'{v / 1e6:.1f} M' for k, v in n_params.items()} } parameters) written in "
              f"{time.perf_counter() - t0:.1f} s")
        overrides = dict(
            model_type="drin", dataset_name="wikimel", preprocess_dir=store,
            dataset_root=raw, mention_text_path=os.path.join(raw, "WIKIMEL_%s.json"),
            candidate_path=os.path.join(raw, "cands.tsv"),
            qid2entity_path=os.path.join(raw, "qid2ne.json"),
            qid2attr_path=os.path.join(raw, "qid2abs.json"),
            mention_image_dir=os.path.join(raw, "mimg"),
            entity_image_dir=os.path.join(raw, "eimg"),
            default_image=os.path.join(raw, "default.jpg"),
            bert_checkpoint=os.path.join(enc, "bert-base-cased"),
            bert_vocab=os.path.join(enc, "vocab.txt"),
            resnet_checkpoint=os.path.join(enc, "resnet-152"),
            clip_checkpoint=os.path.join(enc, "clip-vit-base-patch32"),
            clip_vocab=os.path.join(enc, "vocab.json"), clip_merges=os.path.join(enc, "merges.txt"),
            detector_checkpoint=det_path, drin_object_detector="faster_rcnn")
        cfg = make_config(**overrides)
        assert (cfg.bert_embed_dim, cfg.resnet_embed_dim, cfg.resnet_num_region,
                cfg.num_candidates_model, cfg.preprocess_batch_size, cfg.max_bert_len,
                cfg.max_entity_attr_token_len, cfg.max_mention_sentence_len) == (
            768, 2048, 49, 101, 64, 512, 64, 128)
        argv = [f"{k}={v}" for k, v in overrides.items()] + ["device=cuda"]

        # the main path, counted: the preprocessing CLI, then the DRIN eval.
        # The CLI runs under PyTorch's defaults (cuDNN TF32 on, matmul TF32
        # off), as a user's process has them, and the smoke's own settings
        # come back after it: the stages hold their encoders to full f32
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        attn.launches = gcn.launches = nms_mod.launches = 0
        t0 = time.perf_counter()
        try:
            ran = pre_cli.main(["all"] + argv)
            torch.cuda.synchronize()
            after = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        pre_wall = time.perf_counter() - t0
        assert after == (True, False), f"the preprocessing CLI left the TF32 flags at {after}"
        counts["attention"], pre_gcn, counts["nms"] = attn.launches, gcn.launches, nms_mod.launches
        eval_dir = os.path.join(tmp, "eval")
        os.makedirs(eval_dir)
        cwd = os.getcwd()
        os.chdir(eval_dir)  # the eval writes test-result.txt into its working directory
        try:
            t0 = time.perf_counter()
            cli.main([f"{k}={v}" for k, v in overrides.items()] + [
                "test_only=true", "output_test_result=true", "compute_dtype=bfloat16",
                "checkpoint_dir=" + os.path.join(eval_dir, "checkpoints"), "device=cuda"])
            torch.cuda.synchronize()
            eval_wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        counts["gcn_layer"] = gcn.launches
        eval_attention = attn.launches - counts["attention"]
        eval_nms = nms_mod.launches - counts["nms"]

        # what the stages launched: 12 forward launches per BERT chunk at a
        # bucket of 256 or more, none at 128 (every mention chunk)
        bert, resnet, clip = ran["bert"], ran["resnet"], ran["clip"]
        layers = bert.bert_cfg.num_hidden_layers

        def buckets(texts):
            out = []
            for i in range(0, len(texts), cfg.preprocess_batch_size):
                enc_ = bert.tokenizer([str(t) for t in texts[i:i + cfg.preprocess_batch_size]],
                                      padding=True, truncation=True, max_length=cfg.max_bert_len)
                out.append(bert.bucket(enc_["input_ids"], enc_["attention_mask"])[0].shape[1])
            return out

        from drin_tpu_torch.common import npy_io

        mention_buckets = [b for s in ("train", "valid", "test")
                           for b in buckets(npy_io.load_field(store, "mention_text_raw", s))]
        entity_texts, _ = stages.wikimel_entity_texts(cfg)
        entity_buckets = buckets(entity_texts)
        kernel_chunks = sum(b >= 256 for b in entity_buckets)
        print(f"[preprocess] BERT buckets: mention pass {mention_buckets}, entity pass "
              f"{entity_buckets}; attention launches {counts['attention']} (= {layers} x "
              f"{kernel_chunks} chunks at 256+), gcn_layer launches in the stages {pre_gcn}, "
              f"in the eval {counts['gcn_layer']}, attention launches in the eval "
              f"{eval_attention}")
        assert set(mention_buckets) == {128} and {128, 256, 384, 512} <= set(entity_buckets)
        assert counts["attention"] == layers * kernel_chunks and pre_gcn == 0, counts
        n_eval = -(-PRE_MENTIONS // cfg.batch_size)
        assert counts["gcn_layer"] == cfg.num_gcn_layers * n_eval and eval_attention == 0
        # the detector: two NMS launches (the RPN's, the classes') a forward
        # of 8 images, over each split's mention images and the entity images
        det = resnet.detector
        chunks = [PRE_MENTIONS] * 3 + [PRE_ENTITIES]
        forwards = sum(-(-min(cfg.preprocess_batch_size, n - i) // det.batch)
                       for n in chunks for i in range(0, n, cfg.preprocess_batch_size))
        print(f"[preprocess] detector: {resnet.clock.detected} images, {forwards} forwards of "
              f"{det.batch}, nms launches {counts['nms']} (= 2 x {forwards}), in the eval "
              f"{eval_nms}; {resnet.clock.seconds['detector']:.2f} s of the ResNet stage")
        assert counts["nms"] == 2 * forwards and eval_nms == 0, (counts, forwards)
        assert resnet.clock.detected == 3 * PRE_MENTIONS + PRE_ENTITIES

        # every file the JAX stages write, with the shapes the config gives
        dims = dict(N=PRE_MENTIONS, C=cfg.num_candidates_model, E=PRE_ENTITIES,
                    Lm=cfg.max_mention_sentence_len, Le=cfg.max_entity_attr_token_len,
                    D=cfg.bert_embed_dim, R=cfg.resnet_num_region, Dr=cfg.resnet_embed_dim,
                    Km=cfg.mention_object_topk, Ke=cfg.entity_object_topk)
        written = set(os.listdir(store))
        for pattern, shape in PRE_FILES.items():
            want = _shape_of(shape, dims)
            for split in (("train", "valid", "test") if "{s}" in pattern else ("",)):
                name = pattern.format(s=split)
                assert name in written, f"{name} was not written"
                path = os.path.join(store, name)
                if name.endswith(".json"):
                    with open(path) as f:
                        got = (len(json.load(f)),)
                else:
                    arr = np.load(path, mmap_mode="r")
                    got = arr.shape
                    if "feature" in name or "similarity" in name or "score" in name:
                        assert arr.dtype == np.float32, (name, arr.dtype)
                assert got == want, (name, got, want)
        print(f"[preprocess] {len(written)} files in the store, each with the shape the config "
              f"gives ({len(PRE_FILES)} kinds)")
        with open(os.path.join(eval_dir, "test-result.txt")) as f:
            rows = [line.split("|")[0].split() for line in f]
        scores = np.asarray(rows, np.float64)
        assert scores.shape == (PRE_MENTIONS, cfg.num_candidates_model), scores.shape
        assert np.isfinite(scores).all()
        print(f"[preprocess] DRIN eval (test_only, bf16) over the written store: "
              f"{scores.shape[0]} mentions x {scores.shape[1]} scores, all finite, in "
              f"[{scores.min():.4f}, {scores.max():.4f}]; {eval_wall:.1f} s")

        # per stage: wall seconds, rate, host (tokenization / decode) and encoder seconds
        for name, stage, unit in (("bert", bert, "texts"), ("resnet", resnet, "images"),
                                  ("clip", clip, "texts and images")):
            c = stage.clock
            print(f"[preprocess] {name}: {c.seconds['wall']:.2f} s wall, "
                  f"{c.items / c.seconds['wall']:.1f} {unit}/s over {c.items} in {c.chunks} "
                  f"chunks; host {c.seconds['host']:.2f} s ({1e3 * c.seconds['host'] / c.chunks:.2f} "
                  f"ms per chunk), encoder {c.seconds['encoder']:.2f} s")
        print(f"[preprocess] preprocess all: {pre_wall:.1f} s wall (checkpoint loading included); "
              f"the ResNet stage's detector {resnet.clock.seconds['detector']:.2f} s over "
              f"{resnet.clock.detected} images")
        # the object scores hold real detections: every image has one above
        # the 0.05 threshold in its first slot
        for name in ("mention-object-score_train.npy", "mention-object-score_valid.npy",
                     "mention-object-score_test.npy", "entity-object-score_all.npy"):
            sc = np.load(os.path.join(store, name))
            print(f"[preprocess] {name}: {sc.shape}, first slot in [{sc[:, 0].min():.4f}, "
                  f"{sc[:, 0].max():.4f}], {int((sc > 0).sum())} of {sc.size} slots detected")
            assert (sc[:, 0] > 0.05).all(), f"{name}: an image without a detection"

        # the three card-against-CPU checks, each with a planted fault
        cpu = {}
        cfg_b, sd = checkpoints.load_bert(cfg.bert_checkpoint)
        with torch.device("meta"):
            m = BertModel(cfg_b)
        cpu["bert"] = stages._frozen(m, sd, "cpu")
        stored = np.load(os.path.join(store, "entity-attr-feature.npy"), mmap_mode="r")
        B_ = cfg.preprocess_batch_size
        errs = {}
        for bucket in (512, 128):
            chunk = entity_buckets.index(bucket)
            rows = [chunk * B_ + j for j in (0, 1, 2)]
            enc_ = bert.tokenizer([entity_texts[r] for r in range(chunk * B_, (chunk + 1) * B_)],
                                  padding=True, truncation=True, max_length=cfg.max_bert_len)
            ids, mask = bert.bucket(enc_["input_ids"], enc_["attention_mask"])
            ids, mask = torch.from_numpy(ids[:3]), torch.from_numpy(mask[:3])
            assert ids.shape[1] == bucket and int(mask.sum(1).min()) < bucket
            with torch.inference_mode():
                want = cpu["bert"](ids, mask)[0][:, :cfg.max_entity_attr_token_len].numpy()
                err = _rel_err(np, np.asarray(stored[rows]), want)
                fault = None
                if bucket >= 256:  # fault: the additive mask left out of the kernel calls
                    bad = bert.model(ids.cuda(), None)[0][:, :cfg.max_entity_attr_token_len]
                    fault = _rel_err(np, bad.cpu().numpy(), want)
            errs[f"bert {bucket}"] = err
            print(f"[preprocess] BertStage rows {rows} (bucket {bucket}, "
                  f"{'kernel 3, f32' if bucket >= 256 else 'no kernel'}) vs the f32 CPU forward: "
                  f"relative err {err:.3g} (limit {PRE_BERT_REL})"
                  + (f"; the mask left out of the kernel: {fault:.3g}" if fault is not None else ""))
            assert err <= PRE_BERT_REL, (bucket, err)
            if fault is not None:
                assert fault > PRE_BERT_REL, f"the check cannot see the mask left out: {fault}"
        del cpu["bert"]

        cfg_r, sd = checkpoints.load_resnet(cfg.resnet_checkpoint)
        with torch.device("meta"):
            m = ResNetModel(cfg_r)
        cpu_resnet = stages._frozen(m, sd, "cpu")
        paths = stages.wikimel_mention_images(cfg, "test")[:2]
        x = np.stack([images.resnet_preprocess(
            images.load_image(p, cfg.default_image, cfg.min_image_size), cfg.image_input_size,
            cfg.resnet_crop_pct, cfg.resnet_resample) for p in paths])
        with torch.inference_mode():
            want = cpu_resnet(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy()
            fmap = resnet.model.feature_map(torch.from_numpy(x).cuda().permute(0, 3, 1, 2))
            bad = fmap.reshape(2, -1, fmap.shape[1]).cpu().numpy()  # NCHW without the permute
            with _cudnn_tf32(torch):  # the fault the stages' guard removes
                tf32 = resnet.model(torch.from_numpy(x).cuda().permute(0, 3, 1, 2))[0].cpu().numpy()
        got = np.load(os.path.join(store, "mention-image-feature_test.npy"), mmap_mode="r")[:2]
        err, fault = _rel_err(np, got, want), _rel_err(np, bad, want)
        tf32_fault = _rel_err(np, tf32, want)
        errs["resnet"], errs["resnet_tf32_fault"] = err, tf32_fault
        print(f"[preprocess] ResNet-152 regions of test mentions 0-1 {want.shape} vs the f32 CPU "
              f"forward: relative err {err:.3g} (limit {PRE_RESNET_REL}); the NCHW map "
              f"flattened without the permute: {fault:.3g}; the same model on the card with "
              f"cuDNN's TF32 on and no guard: {tf32_fault:.3g}")
        assert err <= PRE_RESNET_REL and fault > PRE_RESNET_REL, (err, fault)
        assert tf32_fault > PRE_RESNET_REL, f"the check cannot see TF32 convolutions: {tf32_fault}"
        # ResNet's object features over the detector's boxes: the detector
        # again on the card over the test split's first forward of 8 images
        # (the scores must be the stored ones), then the f32 CPU ResNet over
        # the crops of mentions 0-1 at its boxes
        topk = cfg.mention_object_topk
        paths8 = stages.wikimel_mention_images(cfg, "test")[:det.batch]

        def raw01(im):
            return np.asarray(im.resize(cfg.image_input_size), dtype=np.float32) / 255.0

        with stages.full_float32():
            boxes8, scores8 = det(resnet.batcher.load_batch(paths8, raw01), topk)
        stored = np.load(os.path.join(store, "mention-object-score_test.npy"))[:det.batch]
        score_err = float(np.abs(scores8 - stored).max())
        crops = boxes8[:2].reshape(-1, 4)
        xo = resnet.batcher.load_batch_chunked(
            list(np.repeat(np.asarray(paths8[:2]), topk)),
            lambda im: images.resnet_preprocess(im, cfg.image_input_size, cfg.resnet_crop_pct,
                                                cfg.resnet_resample), crops, chunk=len(crops))
        with torch.inference_mode():
            want = cpu_resnet(torch.from_numpy(xo).permute(0, 3, 1, 2))[1].numpy()
        got = np.load(os.path.join(store, "mention-object-feature_test.npy"))[:2]
        errs["resnet_objects"] = err = _rel_err(np, got.reshape(want.shape), want)
        print(f"[preprocess] ResNet-152 object features of test mentions 0-1 ({len(crops)} crops "
              f"at the detector's boxes, e.g. {[round(v, 2) for v in crops[0].tolist()]}) vs the "
              f"f32 CPU forward: relative err {err:.3g} (limit {PRE_RESNET_REL}); the detector "
              f"run again on the card: scores within {score_err:.3g} of the stored ones")
        assert score_err <= 1e-6 and err <= PRE_RESNET_REL, (score_err, err)
        del cpu_resnet

        cfg_c, sd = checkpoints.load_clip(cfg.clip_checkpoint)
        with torch.device("meta"):
            m = CLIPModel(cfg_c)
        cpu_clip = stages._frozen(m, sd, "cpu")
        mention_images, ent_texts, _ = clip._wikimel_sources("test")
        pix = np.stack([images.clip_preprocess(images.load_image(
            p, cfg.default_image, cfg.min_image_size), cfg_c.vision.image_size)
            for p in mention_images[:2]])
        ids = torch.from_numpy(clip.text_ids(ent_texts[:2].reshape(-1)))
        norm = lambda t: t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        scale = clip.logit_scale()
        with torch.inference_mode():
            v = norm(cpu_clip.get_image_features(torch.from_numpy(pix).permute(0, 3, 1, 2)))
            t = norm(cpu_clip.get_text_features(ids)).reshape(2, cfg.num_candidates_model, -1)
            want = scale * torch.einsum("np,ncp->nc", v, t).numpy()
            card = clip.model
            v_card = norm(card.get_image_features(torch.from_numpy(pix).cuda().permute(0, 3, 1, 2)))
            last = card.text_model.hidden_states(ids.cuda())[:, -1]  # fault: the last position
            t_bad = norm(card.text_projection(last)).reshape(2, cfg.num_candidates_model, -1)
            bad = (scale * torch.einsum("np,ncp->nc", v_card, t_bad)).cpu().numpy()
            with _cudnn_tf32(torch):  # the patch convolution in TF32, no guard
                v_tf32 = norm(card.get_image_features(torch.from_numpy(pix).cuda().permute(0, 3, 1, 2)))
                t_card = norm(card.get_text_features(ids.cuda())).reshape(2, cfg.num_candidates_model, -1)
                tf32 = (scale * torch.einsum("np,ncp->nc", v_tf32, t_card)).cpu().numpy()
        got = np.load(os.path.join(store, "similarity-miet_test.npy"))[:2]
        err, fault = _rel_err(np, got, want), _rel_err(np, bad, want)
        errs["clip"], errs["clip_tf32"] = err, _rel_err(np, tf32, want)
        print(f"[preprocess] CLIP similarity-miet rows of test mentions 0-1 {want.shape} vs the "
              f"f32 CPU forward: relative err {err:.3g} (limit {PRE_CLIP_REL}); pooled at the "
              f"last position instead of argmax(input_ids): {fault:.3g}; the patch convolution in "
              f"cuDNN's TF32, no guard: {errs['clip_tf32']:.3g}")
        assert err <= PRE_CLIP_REL and fault > PRE_CLIP_REL, (err, fault)
        del cpu_clip

        # one dispatch of each encoder under the profiler
        ids512 = torch.randint(1000, 28000, (B_, 512), device="cuda")
        mask512 = torch.ones_like(ids512)
        mask512[1::2, 300:] = 0
        pix224 = torch.randn(B_, 3, 224, 224, device="cuda")
        ids77 = torch.from_numpy(clip.text_ids(ent_texts[0][:B_])).cuda()
        for label, fn in (("BertStage [64, 512]", lambda: bert.model(ids512, mask512)),
                          ("ResnetStage [64, 3, 224, 224]", lambda: resnet.model(pix224)),
                          ("ClipStage text [64, 77]", lambda: clip.model.get_text_features(ids77)),
                          ("ClipStage image [64, 3, 224, 224]",
                           lambda: clip.model.get_image_features(pix224))):
            with torch.inference_mode():
                profile_call(torch, fn, f"[preprocess] {label}, one dispatch", reps=3, top=6)

        # kernel 3's float32 form at BertStage's shape, masked
        lens = np.random.default_rng(SEED + 1400).integers(200, 513, B_)
        lens[0] = 512
        q, k, v, mask = _attn_inputs(torch, np, B_, 12, 512, torch.float32, SEED + 1401, lens)
        with torch.inference_mode():
            got = attn.fused_attention(q, k, v, mask)
            want_t = attn.attention_plain(q, k, v, mask)
            f32_err = check_close("attention f32 [64,12,512,64]", got, want_t, **ATTN_F32_TOL)
            ms = cuda_ms(lambda: attn.fused_attention(q, k, v, mask))
            dev = device_ms(lambda: attn.fused_attention(q, k, v, mask))
            plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v, mask))
            lib_mask = mask[:, None, None, :]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask))
        flops = 4 * 512 * 512 * 64 * B_ * 12
        moved = nbytes(q, k, v, mask, got)
        bound_ms, bound_by, fma_ms = f32_bound(moved, flops)
        print(f"[preprocess] kernel 3, float32 form (split TF32 on wgmma), [64,12,512,64] masked: "
              f"kernel {ms:.4f} ms (device {dev:.4f}), plain {plain_ms:.4f} ms, "
              f"F.scaled_dot_product_attention f32 {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by}: 3 x {flops / 1e9:.1f} GFLOP of TF32 products over "
              f"{PEAK_FLOPS['tf32'] / 1e12:.0f} TFLOP/s, {moved / 1e6:.1f} MB over 3.35 TB/s); "
              f"FMA bound {fma_ms:.4f} ms (over the f32 non-tensor peak "
              f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s); max abs err vs plain {f32_err:.3g}; "
              f"before the redesign the kernel took {ATTN_EARLIER_MS['attention_f32']} ms "
              f"(PERF.md), now {ms:.4f} ms")
        f32 = {"shape": [B_, 12, 512, 64], "max_abs_err": f32_err, "ms": ms, "device_ms": dev,
               "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "fma_bound_ms": fma_ms}
        del q, k, v, mask, got, want_t, ran, bert, resnet, clip, det
        torch.cuda.empty_cache()
    return counts, {"errors": errs, "f32": f32, "preprocess_s": pre_wall, "eval_s": eval_wall}


@contextlib.contextmanager
def _cudnn_tf32(torch):
    """cuDNN's TF32 switched on (PyTorch's default) for the block, the
    caller's setting back after it."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def profile_rank(torch, ranker, feats, label: str, reps: int = 5):
    """Where a rank's time goes: host-side input preparation (numpy ->
    device copy and cast), device time by kernel and the device's idle
    share, from torch.profiler."""

    def prep():
        with torch.inference_mode():
            ranker._prepare(feats)
        torch.cuda.synchronize()

    print(f"[profile] {label} input preparation (host to device, cast): {host_ms(prep):.3f} ms")
    return profile_call(torch, lambda: ranker.rank(feats, k=5), f"{label} rank", reps)


def profile_call(torch, fn, label: str, reps: int = 5, top: int = 12):
    """Device time by kernel, the device's idle share and the host's largest
    self times over ``reps`` calls of ``fn``, from torch.profiler; returns
    them per call (None when the profiler saw no device activity)."""
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
        return None
    print(f"[profile] {label} under the profiler: {wall:.3f} ms wall, {busy:.3f} ms device "
          f"busy, idle share {1 - busy / wall:.3f}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"[profile]   {ms:8.4f} ms  x{n:<5g} {key[:90]}")
    host = sorted(((e.self_cpu_time_total / 1e3 / reps, e.count / reps, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CPU), reverse=True)
    for ms, n, key in host[:6]:
        print(f"[profile]   host {ms:8.4f} ms  x{n:<5g} {key[:80]}")
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "device_ms_by_kernel": {key: ms for key, ms, _ in rows}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port has no CPU fallback",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    # the plain versions' float32 products run in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from drin_tpu_torch.ops.cuda import (_build, attention as attn, gather, gcn_layer as gcn,
                                         nms as nms_mod, vertex_update as vu)

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
                "vertex_update": phase_vertex_update(torch, vu, gcn),
                "nms": phase_nms(torch, np, nms_mod)}
    measured.update(phase_attention_bwd(torch, np, attn))
    detector = phase_detector(torch, np, nms_mod)
    # each main path is driven with its kernels' counts set to 0 just before
    # and read just after; a kernel of a path that the path never launched fails
    mods = (gather, gcn, attn, vu, nms_mod)
    paths, seconds, gcn_by_dtype = {}, {}, {}

    def timed(path, fn, *args):
        t = time.perf_counter()
        with gcn_dtypes(gcn) as seen:  # kernel 1's launches in the whole phase, by dtype
            out = fn(*args)
        gcn_by_dtype[path] = {dt: seen.count(dt) for dt in sorted(set(seen))}
        seconds[path] = round(time.perf_counter() - t, 1)
        return out

    paths["serve_drin"], _, drin = timed("serve_drin", phase_slice, torch, np, gather, gcn)
    # the same rank stage with the default compute dtype, float32: kernel 1's
    # float32 form (the CLIs' default), over the same store rows and weights
    paths["serve_drin_f32"], serve_f32 = timed("serve_drin_f32", phase_serve_drin_f32, torch, np,
                                               gather, gcn, drin)
    # the DRIN store as a deployment: a bundle served behind the micro-batching
    # front, then stage-1 retrieval over its text table (no kernel)
    paths["serve_batched"], served = timed("serve_batched", phase_serve_batched, torch, np,
                                           mods, drin)
    paths["retrieve"], _ = timed("retrieve", phase_retrieve, torch, np, mods, served)
    del drin, served
    paths["serve_online"] = {"attention": timed("serve_online", phase_online, torch, np, attn)[0]}
    paths["serve_text"], _ = timed("serve_text", phase_serve_text, torch, np, attn)
    paths["train_online"], _ = timed("train_online", phase_train_online, torch, np, attn)
    paths["train_text"], _ = timed("train_text", phase_train_text, torch, np, attn)
    paths["train_drin"], _, drin_shared = timed("train_drin", phase_train_drin, torch, np, gcn, vu)
    paths["train_drin_f32"], train_f32 = timed("train_drin_f32", phase_train_drin_f32, torch, np, gcn,
                                               drin_shared)
    del drin_shared
    # the baselines: offline GHMFC reads its rows through kernel 2; MELHI, the
    # transformer mention layer and the float store of training run no kernel
    # (each of those phases fails if any kernel launched in it)
    for path, phase in (("serve_ghmfc", phase_serve_ghmfc),
                        ("serve_ghmfc_transformer", phase_transformer),
                        ("serve_melhi", phase_serve_melhi), ("train_ghmfc", phase_train_ghmfc),
                        ("train_melhi", phase_train_melhi)):
        paths[path], _ = timed(path, phase, torch, np, mods)
    # the offline preprocessing pipeline writes a store and DRIN evaluates it:
    # kernel 3 in float32 in BertStage, the NMS kernel in the ResNet stage's
    # detector, kernel 1 in the eval
    paths["preprocess"], pre = timed("preprocess", phase_preprocess, torch, np, attn, gcn, nms_mod)
    measured["attention"]["f32_bert_stage"] = pre["f32"]
    measured["nms"]["detector"] = {k: detector[k] for k in ("ms_per_image", "peak_gib",
                                                            "stage_chunk_ms", "errors")}
    print(f"seconds by path: {seconds}")
    assert {p: sorted(c) for p, c in paths.items()} == {
        "serve_drin": ["gather_dequant", "gcn_layer"], "serve_drin_f32": ["gather_dequant", "gcn_layer"],
        "serve_online": ["attention"],
        "serve_batched": ["gather_dequant", "gcn_layer"], "retrieve": [],
        "serve_text": ["attention"],
        "train_online": ["attention", "attention_bwd"],
        "train_text": ["attention", "attention_bwd"], "train_drin": ["gcn_layer"],
        "train_drin_f32": ["gcn_layer"],
        "serve_ghmfc": ["gather_dequant"], "serve_ghmfc_transformer": [], "serve_melhi": [],
        "train_ghmfc": [], "train_melhi": [], "preprocess": ["attention", "gcn_layer", "nms"]}, paths
    for path, counts in paths.items():
        assert all(counts.values()), f"{path} never launched one of its kernels: {counts}"
    # kernel 1 by dtype: the default-dtype paths launch only its float32 form,
    # every other path only its bf16 form
    print(f"kernel 1's launches by path and dtype (whole phases): {gcn_by_dtype}")
    for path, by_dt in gcn_by_dtype.items():
        want = "float32" if path.endswith("_f32") else "bfloat16"
        assert set(by_dt) <= {want} and bool(by_dt) == ("gcn_layer" in paths[path]), (path, by_dt)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "drin_tpu"))
    assert not bad, f"the port imported {bad}"

    # name -> (source, the TPU kernel it replaces).  launches_by_path holds each
    # main path's own count and launches is their sum; gather_dequant's
    # "layouts" holds its time at each packed layout (the DRIN one leads).  The mask-free backward
    # and the vertex update are on no model path, in this package as in the
    # JAX one (BERT always passes a mask; no model calls the vertex update):
    # their counts are 0 and the kernel phases above are what holds them
    kernels = {
        "gather_dequant": ("gather_dequant.cu", "drin_tpu/ops/pallas/gather.py:127"),
        "gcn_layer": ("gcn_layer.cu", "drin_tpu/ops/pallas/gcn_layer.py:120"),
        "attention": ("attention.cu", "drin_tpu/ops/pallas/attention.py:48"),
        "attention_bwd": ("attention_bwd.cu", "drin_tpu/ops/pallas/attention.py:122"),
        "attention_bwd_nomask": ("attention_bwd.cu", "drin_tpu/ops/pallas/attention.py:134"),
        "vertex_update": ("gcn_layer.cu", "drin_tpu/ops/pallas/gcn.py:58"),
        # a port-only kernel: the counterpart of a jnp loop, not of a Pallas kernel
        "nms": ("nms.cu", "drin_tpu/ops/detection.py:29")}
    assert set(kernels) == set(measured)
    by_path = {name: {path: counts.get(name, 0) for path, counts in paths.items()}
               for name in kernels}
    measured["gcn_layer"]["dtype_by_path"] = {path: next(iter(by_dt)) for path, by_dt in gcn_by_dtype.items()
                                              if by_dt}
    measured["gcn_layer"]["f32_paths"] = {"serve_drin_f32": serve_f32, "train_drin_f32": train_f32}
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s, the kernels' build included")
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
