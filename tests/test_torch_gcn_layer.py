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
from drin_tpu_torch.ops.cuda.gcn_layer import fused_gcn_layer, gcn_layer_plain

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
