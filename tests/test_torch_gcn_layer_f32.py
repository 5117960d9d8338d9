# -*- coding: utf-8 -*-
"""Kernels 1 and 4's float32 forms in split-precision TF32, their numerics on
the CPU.

The card's float32 row kernel (``csrc/gcn_layer.cu``, ``gcn_rows_f32``)
takes every weight product on ``wgmma`` with TF32 operands: each operand x
is split into hi = x rounded to TF32 and lo = (x - hi) rounded to TF32
(``cvt.rna``: to nearest, ties away from zero), and each product is lo.hi +
hi.lo + hi.hi in float32.  The weights are split once per call (Kv
transposed, which the split does not see), the rows in registers.  The CUDA
kernel cannot run here, so this file puts that arithmetic in the place of
the plain versions' products (``gcn_layer._product``, which
``gcn_layer_plain`` and ``vertex_update_plain`` both call) and holds the
result against the JAX package's references in float32 and against the
port's plain versions, at ``chip_smoke.GCN_F32_TOL`` (the tolerance the
card's kernels are held to), with the split's own gap required to be far
smaller; and it shows that one TF32 pass (hi.hi alone) falls outside that
tolerance at D=768, so that the card's check can tell the split from a
plain TF32 product."""

import numpy as np
import pytest
import torch

import chip_smoke
from drin_tpu.ops.pallas.gcn import vertex_update_reference
from drin_tpu.ops.pallas.gcn_layer import gcn_layer_reference
from drin_tpu_torch.ops.cuda import gcn_layer as tgcn
from drin_tpu_torch.ops.cuda import vertex_update as tvu

TOL = chip_smoke.GCN_F32_TOL
# the split's own gap to the float32 plain version: a few float32 roundings
# of outputs of size ~1 (LayerNorm'd rows, sigmoid edges), held far below TOL
SPLIT_GAP = 1e-5


def _split(x):
    hi = chip_smoke.tf32_round(torch, x)
    return hi, chip_smoke.tf32_round(torch, x - hi)


def split_product(a, b):
    """a @ b as the kernel takes it: lo.hi + hi.lo + hi.hi of TF32 halves."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def one_pass_product(a, b):
    """The fault: both operands rounded to TF32 once, hi.hi alone."""
    return _split(a)[0] @ _split(b)[0]


def _layer_inputs(B, C, D, seed):
    """Unit-normal vertices, uniform edges and flax-layout ([in, out])
    weights; the edge fold's weights scaled as ``chip_smoke._gcn_inputs``
    scales them, so that p.v / D spreads by ~1 and the fold moves the edges."""
    rng = np.random.default_rng(seed)
    b = D ** -0.5
    u = lambda *s, scale=1.0: rng.uniform(-b * scale, b * scale, s).astype(np.float32)
    fold = 3 ** 0.5 * D ** 0.25
    vertexes = [rng.standard_normal(s).astype(np.float32) for s in ((B, D), (B, D), (B, C, D), (B, C, D))]
    edges = [rng.uniform(0, 1, (B, C)).astype(np.float32) for _ in range(4)]
    w = (u(D, D), u(D), (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
         (0.1 * rng.standard_normal(D)).astype(np.float32))
    k = (u(D, D, scale=fold), u(D, scale=fold), u(D, D, scale=fold), u(D, scale=1.5 * D / fold))
    return vertexes, edges, w, k


def _torch_layer_args(vertexes, edges, w, k):
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    wh, bh, s, lb = w
    ku, bu, kv, bv = k
    return ([T(x) for x in vertexes], [T(x) for x in edges], T(wh.T), T(bh), T(s), T(lb),
            T(ku.T), T(bu), T(kv.T), T(bv))


def _vertex_inputs(B, C, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    # v, e1, m1, e2, m2, w [in, out] (flax layout), b, ln scale, ln bias
    return [f(B, C, D), u(B, C), f(B, D), u(B, C), f(B, D), (f(D, D) * D ** -0.5).astype(np.float32),
            0.1 * f(D), 1 + 0.1 * f(D), 0.1 * f(D)]


def _torch_vertex_args(args):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in args]
    t[5] = t[5].T.contiguous()  # torch layout: [out, in]
    return t


def _max_err(got, want):
    return max(float(np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32)).max())
               for g, w in zip(got, want))


def _outside(got, want):
    """Values of ``got`` outside TOL around ``want`` (chip_smoke.outside)."""
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    return sum(chip_smoke.outside(t(g), t(w), **TOL) for g, w in zip(got, want))


def _flat(nv, ne):
    return [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in list(nv) + list(ne)]


def test_the_split_keeps_float32():
    """hi and lo are TF32 values (13 low bits clear) and hi + lo keeps x to
    within 2^-22 of its size; the split product of unit-normal operands sits
    a few float32 roundings from the float32 product, one TF32 pass ~1e3 x
    farther."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = _split(x)
    for h in (hi, lo):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -22).all()
    a = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((768, 64)) * 768 ** -0.5).astype(np.float32))
    want = (a.double() @ b.double()).float()
    split_err = (split_product(a, b) - want).abs().max().item()
    one_err = (one_pass_product(a, b) - want).abs().max().item()
    assert split_err < 2e-6 and one_err > 300 * split_err, (split_err, one_err)


LAYER_SHAPES = [(2, 5), (3, 65), (1, 101)]  # B*C under one tile, across tiles and b's, B=1
ACTS = [("gelu", "sigmoid"), ("tanh", "identity")]


@pytest.mark.parametrize("B,C", LAYER_SHAPES, ids=["B%dC%d" % s for s in LAYER_SHAPES])
@pytest.mark.parametrize("acts", ACTS, ids=["-".join(a) for a in ACTS])
@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_split_tf32_layer_matches_reference_and_plain(B, C, acts, dynamic, monkeypatch):
    """The layer with the kernel's split products (D=128) against
    ``gcn_layer_reference`` in float32 and the port's plain version, all
    eight outputs (the edges too where they are folded)."""
    D = 128
    vertexes, edges, w, k = _layer_inputs(B, C, D, seed=B * 1000 + C)
    kw = dict(vact=acts[0], eact=acts[1], dynamic=dynamic)
    args = _torch_layer_args(vertexes, edges, w, k)
    plain = _flat(*tgcn.gcn_layer_plain(*args, **kw))
    want = _flat(*gcn_layer_reference(vertexes, edges, *w, *k, **kw))
    monkeypatch.setattr(tgcn, "_product", split_product)
    got = _flat(*tgcn.gcn_layer_plain(*args, **kw))
    assert all(np.isfinite(g).all() for g in got)
    assert _outside(got, want) == 0, _max_err(got, want)
    assert _outside(got, plain) == 0
    assert _max_err(got, plain) < SPLIT_GAP, _max_err(got, plain)


VERTEX_SHAPES = [(2, 5), (3, 65), (1, 101)]


@pytest.mark.parametrize("B,C", VERTEX_SHAPES, ids=["B%dC%d" % s for s in VERTEX_SHAPES])
@pytest.mark.parametrize("act", ["gelu", "tanh"])
def test_split_tf32_vertex_update_matches_reference_and_plain(B, C, act, monkeypatch):
    """Kernel 4's float32 form: the update with the split product (D=128)
    against ``vertex_update_reference`` in float32 and the plain version."""
    args = _vertex_inputs(B, C, 128, seed=B * 100 + C)
    targs = _torch_vertex_args(args)
    plain = tvu.vertex_update_plain(*targs, act=act).numpy()
    want = np.asarray(vertex_update_reference(*args, act=act))
    monkeypatch.setattr(tgcn, "_product", split_product)
    got = tvu.vertex_update_plain(*targs, act=act).numpy()
    assert got.shape == (B, C, 128) and np.isfinite(got).all()
    assert _outside([got], [want]) == 0, _max_err([got], [want])
    assert _outside([got], [plain]) == 0
    assert _max_err([got], [plain]) < SPLIT_GAP


@pytest.mark.parametrize("kernel", ["gcn_layer", "vertex_update"])
def test_one_tf32_pass_falls_outside_the_card_tolerance(kernel, monkeypatch):
    """At D=768 (the configs' width) the products in one TF32 pass move the
    outputs outside GCN_F32_TOL, and the split keeps them far inside: the
    card's check of the kernel against its plain version can see a kernel
    that lost its split."""
    D = 768
    if kernel == "gcn_layer":
        vertexes, edges, w, k = _layer_inputs(2, 5, D, seed=5)
        args = _torch_layer_args(vertexes, edges, w, k)
        run = lambda: _flat(*tgcn.gcn_layer_plain(*args))
    else:
        args = _torch_vertex_args(_vertex_inputs(2, 5, D, seed=6))
        run = lambda: [tvu.vertex_update_plain(*args).numpy()]
    plain = run()
    monkeypatch.setattr(tgcn, "_product", split_product)
    split = run()
    monkeypatch.setattr(tgcn, "_product", one_pass_product)
    one = run()
    assert _outside(split, plain) == 0 and _max_err(split, plain) < SPLIT_GAP
    assert _outside(one, plain) > 0, _max_err(one, plain)
    assert _max_err(one, plain) > 10 * _max_err(split, plain)
