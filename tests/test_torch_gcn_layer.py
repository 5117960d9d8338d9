# -*- coding: utf-8 -*-
"""The GCN layer: the kernel's plain version against the JAX reference and
the interpret-mode Pallas kernel, and the port's ``GCNLayer`` against
``drin_tpu.models.drin.GCNLayer.apply``.

Tolerances: float32 at rtol 2e-4 (the same math in another association
order).  bfloat16 at atol 2e-2 / rtol 1.6e-2, two bf16 ulps: the JAX
reference rounds the candidate means to bf16 before adding them to the
mention, where the port (like the TPU kernel) keeps the messages in f32,
so a vertex may land one bf16 step away.  The CUDA kernel is compared with
the plain version on the card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.data.synthetic import tiny_config
from drin_tpu.models.drin import GCNLayer as JaxGCNLayer
from drin_tpu.ops.pallas.gcn_layer import fused_gcn_layer as jax_fused, gcn_layer_reference
from drin_tpu_torch.models.convert import drin_state_dict_from_jax
from drin_tpu_torch.models.drin import GCNLayer
from drin_tpu_torch.ops.cuda import gcn_layer as tgcn
from drin_tpu_torch.ops.cuda.gcn_layer import _FusedGCNLayer, fused_gcn_layer, gcn_layer_plain

F32 = dict(rtol=2e-4, atol=1e-6)
BF16 = dict(rtol=1.6e-2, atol=2e-2)


def _inputs(B, C, D, seed):
    rng = np.random.default_rng(seed)
    b = D ** -0.5
    u = lambda *s: rng.uniform(-b, b, s).astype(np.float32)
    vertexes = [rng.standard_normal(s).astype(np.float32) for s in ((B, D), (B, D), (B, C, D), (B, C, D))]
    edges = [rng.uniform(0, 1, (B, C)).astype(np.float32) for _ in range(4)]
    # flax layout: kernels [in, out]
    wh, bh = u(D, D), u(D)
    ln = ((1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
          (0.1 * rng.standard_normal(D)).astype(np.float32))
    ku, bu, kv, bv = u(D, D), u(D), u(D, D), u(D)
    return vertexes, edges, (wh, bh) + ln, (ku, bu, kv, bv)


def _torch_args(vertexes, edges, w, k, dt):
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dt)
    wh, bh, s, lb = w
    ku, bu, kv, bv = k
    # torch layout: weights [out, in]
    return ([T(x) for x in vertexes], [T(x) for x in edges], T(wh.T), T(bh), T(s), T(lb),
            T(ku.T), T(bu), T(kv.T), T(bv))


def _compare(got, want, tol):
    gv, ge = got
    wv, we = want
    for g, w in zip(list(gv) + list(ge), list(wv) + list(we)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


SHAPES = [(4, 11, 32), (2, 101, 128)]
ACTS = [("gelu", "sigmoid"), ("relu", "tanh"), ("tanh", "identity"), ("sigmoid", "relu")]


# every activation pair at the small shape; the default pair at C=101 and in
# bf16, whose rounding does not depend on the activation
REFERENCE_CASES = (
    [("float32", SHAPES[0], acts, dyn) for acts in ACTS for dyn in (True, False)]
    + [("float32", SHAPES[1], ACTS[0], dyn) for dyn in (True, False)]
    + [("bfloat16", shape, ACTS[0], True) for shape in SHAPES])


@pytest.mark.parametrize("dt,shape,acts,dynamic", REFERENCE_CASES,
                         ids=["%s-B%dC%dD%d-%s-%s" % ((dt,) + shape + ("-".join(acts),
                              "dynamic" if dyn else "static"))
                              for dt, shape, acts, dyn in REFERENCE_CASES])
def test_plain_matches_reference(dt, shape, acts, dynamic):
    vertexes, edges, w, k = _inputs(*shape, seed=sum(shape))
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    J = lambda x: jnp.asarray(x, jdt)
    want = gcn_layer_reference([J(x) for x in vertexes], [J(x) for x in edges],
                               *map(J, w), *map(J, k), vact=acts[0], eact=acts[1],
                               dynamic=dynamic)
    got = gcn_layer_plain(*_torch_args(vertexes, edges, w, k, tdt), vact=acts[0],
                          eact=acts[1], dynamic=dynamic)
    for t in got[0] + got[1]:
        assert t.dtype == tdt
    _compare(got, want, F32 if dt == "float32" else BF16)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%dC%dD%d" % s)
@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_plain_matches_interpret_kernel(shape, dynamic):
    vertexes, edges, w, k = _inputs(*shape, seed=7)
    want = jax_fused([jnp.asarray(x) for x in vertexes], [jnp.asarray(x) for x in edges],
                     *map(jnp.asarray, w), *map(jnp.asarray, k), dynamic=dynamic,
                     block_b=2, interpret=True)
    # the wrapper on CPU tensors runs the plain version
    got = fused_gcn_layer(*_torch_args(vertexes, edges, w, k, torch.float32), dynamic=dynamic)
    _compare(got, want, F32)


def _layer_cfg(**kw):
    return tiny_config("wikimel", "drin", preprocess_dir="/tmp/unused-torch-gcn", **kw)


@pytest.mark.parametrize("kw", [
    {},
    {"gcn_edge_enabled": (1, 0, 1, 0)},
    {"gcn_edge_type": "static"},
    {"gcn_edge_feature": "vector"},
    {"gcn_edge_feature": "vector", "gcn_edge_enabled": (0, 1, 1, 1)},
    {"gcn_vertex_activation": "silu", "gcn_edge_activation": "tanh"},  # not a kernel pair
], ids=["default", "ablation", "static", "vector", "vector-ablation", "silu"])
@pytest.mark.parametrize("pad", [0, 3], ids=["C", "C+3"])
def test_gcn_layer_module_matches_flax(kw, pad):
    """Scalar edges, padded or not, go through the kernel wrapper (its plain
    version on CPU, averaging over the real C); vector edges take the
    unfused math.  Both must match the flax layer."""
    cfg = _layer_cfg(**kw)
    B, C, D = 3, cfg.num_candidates_model + pad, cfg.gcn_embed_dim
    vertexes, edges, _, _ = _inputs(B, C, D, seed=11)
    if cfg.gcn_edge_feature == "vector":
        rng = np.random.default_rng(12)
        edges = [rng.uniform(0, 1, (B, C, D)).astype(np.float32) for _ in range(4)]
    jl = JaxGCNLayer(cfg)
    jv, je = [jnp.asarray(x) for x in vertexes], [jnp.asarray(x) for x in edges]
    params = jl.init(jax.random.key(0), jv, je)["params"]
    want = jl.apply({"params": params}, jv, je)
    sd = drin_state_dict_from_jax({"vertex_encoder": {}, "gcn_0": jax.tree.map(np.asarray, params)},
                                  cfg.replace(num_gcn_layers=1))
    layer = GCNLayer(cfg)
    layer.load_state_dict({k[len("gcn_layers.0."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        got = layer([torch.from_numpy(x) for x in vertexes], [torch.from_numpy(x) for x in edges])
    _compare(got, want, F32)


@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_function_gradients_match_jax_grad_of_the_reference(dynamic):
    """The layer's ``autograd.Function`` on the CPU (plain forward, backward
    by autograd through the plain version on the saved inputs) against
    ``jax.grad`` through ``gcn_layer_reference``, which is what the JAX
    package's backward differentiates: all 16 inputs."""
    B, C, D = 3, 7, 16
    vertexes, edges, w, k = _inputs(B, C, D, seed=21)
    rng = np.random.default_rng(22)
    n_out = 8 if dynamic else 4
    cot = [rng.standard_normal(x.shape).astype(np.float32) for x in (vertexes + edges)[:n_out]]

    def loss(vs, es, ws, ks):
        nv, ne = gcn_layer_reference(vs, es, *ws, *ks, dynamic=dynamic)
        outs = list(nv) + (list(ne) if dynamic else [])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot))

    J = lambda xs: [jnp.asarray(x) for x in xs]
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(J(vertexes), J(edges), J(w), J(k))
    gv, ge, (gwh, gbh, gs, glb), (gku, gbu, gkv, gbv) = want
    # back to torch layout: weights [out, in]
    want = list(gv) + list(ge) + [gwh.T, gbh, gs, glb, gku.T, gbu, gkv.T, gbv]

    tv, te, *tw = _torch_args(vertexes, edges, w, k, torch.float32)
    leaves = [t.requires_grad_(True) for t in tv + te + tw]
    if not dynamic:
        leaves[12:] = [None] * 4
    out = _FusedGCNLayer.apply(("gelu", "sigmoid", 1e-5, dynamic, None, None), *leaves)
    assert len(out) == n_out
    live = [t for t in leaves if t is not None]
    got = torch.autograd.grad(out, live, [torch.from_numpy(c) for c in cot], allow_unused=True)
    for i, (g, wnt) in enumerate(zip(got, want)):
        wnt = np.asarray(wnt)
        assert g is not None, i
        np.testing.assert_allclose(g.numpy(), wnt, rtol=2e-4, atol=2e-4 * np.abs(wnt).max(),
                                   err_msg=str(i))
    if not dynamic:  # the edge-update weights of a static layer get zero gradient in JAX
        assert all(not np.asarray(x).any() for x in want[12:])
    # the wrapper on CPU tensors differentiates the plain version directly: the same numbers
    nv, ne = fused_gcn_layer(leaves[:4], leaves[4:8], *leaves[8:], dynamic=dynamic)
    outs = list(nv) + (list(ne) if dynamic else [])
    direct = torch.autograd.grad(outs, live, [torch.from_numpy(c) for c in cot], allow_unused=True)
    for g, d in zip(got, direct):
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=1e-6, atol=1e-7)


# (B, C): C=101 tiles that cross b boundaries, B*C under one tile, B=1, C=1
# (64 segments in a tile), C=64 and 65 around the tile's edge, C over two tiles
SLOT_SHAPES = [(64, 101), (4, 11), (1, 101), (64, 1), (3, 1), (2, 64), (5, 65), (3, 150)]


@pytest.mark.parametrize("B,C", SLOT_SHAPES, ids=["B%dC%d" % s for s in SLOT_SHAPES])
def test_message_slots_hold_every_segment_and_sum_to_the_messages(B, C):
    """Launch B's slot layout: every (tile, b) pair that shares rows has a
    slot below S, and the slots summed as launch C reads them (set 0's tiles
    then set 1's) give the plain version's message sums."""
    T, S = tgcn.message_slots(B, C)
    rows = np.arange(B * C)
    tile = tgcn.ROW_TILE
    assert T == -(-B * C // tile) and rows[-1] // tile == T - 1
    for t in range(T):
        segs = np.unique(rows[t * tile:(t + 1) * tile] // C)
        assert segs[0] == t * tile // C and len(segs) <= S
    rng = np.random.default_rng(B * 1000 + C)
    et, ei = (torch.from_numpy(rng.standard_normal((B, C, 8)).astype(np.float32)) for _ in range(2))
    edges = [torch.from_numpy(rng.uniform(0, 1, (B, C)).astype(np.float32)) for _ in range(4)]
    slots = tgcn.slot_messages_plain(et, ei, edges)
    assert tuple(slots.shape) == (2, T, S, 2, 8)
    msg = tgcn.sum_slots_plain(slots, B, C)
    tt, ti, it, ii = edges
    want = [torch.einsum("bc,bcd->bd", a, et) + torch.einsum("bc,bcd->bd", b, ei)
            for a, b in ((tt, ti), (it, ii))]
    for got, w in zip(msg, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    # a slot that launch C reads is one launch B wrote: dropping any changes the sums
    bad = slots.clone()
    bad[1, T - 1, 0] = 0
    assert not torch.allclose(tgcn.sum_slots_plain(bad, B, C), msg)


WORKSPACE_SHAPES = [(64, 101, 768), (1, 1, 128), (5, 65, 128)]


@pytest.mark.parametrize("B,C,D,dt", [s + (torch.bfloat16,) for s in WORKSPACE_SHAPES]
                         + [s + (torch.float32,) for s in WORKSPACE_SHAPES],
                         ids=["%d-%d-%d" % s for s in WORKSPACE_SHAPES]
                         + ["%d-%d-%d-f32" % s for s in WORKSPACE_SHAPES])
def test_workspace_is_one_allocation_cut_into_aligned_disjoint_views(B, C, D, dt):
    """bf16 and float32 take the same parts in their compute dtype; float32
    adds the split images of W_h, Ku and Kv^T that its first launch writes."""
    parts, total = tgcn.workspace_layout(B, C, D, dt)
    T, S = tgcn.message_slots(B, C)
    shapes = {name: shape for name, _, shape, _ in parts}
    want = {"ar": (2 * B, D), "s_part": (2, B, D // 64), "p": (B, 2, D),
            "msg": (2, T, S, 2, D), "count": (B,)}
    if dt == torch.float32:
        want.update({k: (D // 16, 2, D, 16) for k in ("wh_split", "wu_split", "wv_split")})
    assert shapes == want
    types = {name: t for name, _, _, t in parts}
    assert types["ar"] == types["p"] == dt and types["count"] == torch.int32
    end = 0
    for name, off, shape, t in parts:
        assert off % 256 == 0 and off >= end, name
        end = off + int(np.prod(shape)) * t.itemsize
    assert end <= total < end + 256
    views = tgcn._workspace(B, C, D, "cpu", dt)
    base = views["ar"].untyped_storage().data_ptr()
    for name, off, shape, dt in parts:
        v = views[name]
        assert tuple(v.shape) == shape and v.dtype == dt and v.is_contiguous()
        assert v.untyped_storage().data_ptr() == base and v.data_ptr() - base == off


class _OnCard:
    """A CPU tensor that claims to live on a CUDA device, for the wrapper's
    argument checks (there is no card where these tests run)."""

    def __init__(self, t):
        self._t, self.device, self.is_cuda = t, torch.device("cuda:0"), True

    def __getattr__(self, name):
        return getattr(self._t, name)


def _fake_layer(B, C, D, dt, dynamic=True):
    z = lambda *s: _OnCard(torch.zeros(s, dtype=dt))
    vertexes = [z(B, D), z(B, D), z(B, C, D), z(B, C, D)]
    edges = [z(B, C) for _ in range(4)]
    weights = [z(D, D), z(D), z(D), z(D)] + ([z(D, D), z(D), z(D, D), z(D)] if dynamic else [])
    return vertexes, edges, weights


@pytest.mark.parametrize("case,match", [
    ("fp16", "float32 or bfloat16"), ("D=96", "built for D in"), ("D=256", "built for D in"),
    ("D=24", "built for D in"), ("D=24 f32", "built for D in"), ("shape", "tt must be"),
    ("strided", "contiguous"), ("no wu", "dynamic edges need wu"), ("B=0", "B >= 1")])
def test_cuda_checks_refuse_what_the_kernel_does_not_take(case, match):
    """The kernels are built for D = 128 and 768 in both dtypes; every other
    width, type, shape or layout is refused by name before a launch."""
    dt = {"fp16": torch.float16, "D=24 f32": torch.float32}.get(case, torch.bfloat16)
    D = int(case[2:].split()[0]) if case.startswith("D=") else 128
    vertexes, edges, weights = _fake_layer(0 if case == "B=0" else 2, 5, D, dt)
    if case == "shape":
        edges[0] = _OnCard(torch.zeros(2, 6, dtype=dt))
    elif case == "strided":
        weights[0] = _OnCard(torch.zeros(D, 2 * D, dtype=dt)[:, ::2])
    elif case == "no wu":
        weights[4] = None
    with pytest.raises(ValueError, match=match):
        tgcn._check_cuda(vertexes, edges, weights, True)


@pytest.mark.parametrize("dt,D", [(torch.bfloat16, 768), (torch.bfloat16, 128), (torch.float32, 768),
                                  (torch.float32, 128)])
@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_cuda_checks_take_the_built_widths(dt, D, dynamic):
    """Both dtypes at D = 128 and 768, the widths the row kernel is built for."""
    vertexes, edges, weights = _fake_layer(3, 7, D, dt, dynamic)
    assert tgcn._check_cuda(vertexes, edges, weights, dynamic) == (3, 7, D)
