# -*- coding: utf-8 -*-
"""Fused DRIN GCN layer (port of ``drin_tpu/ops/pallas/gcn_layer.py``).

Kernel: ``csrc/gcn_layer.cu``, CUDA C++ for ``sm_90a``.  It replaces the
TPU kernel ``fused_gcn_layer`` (``_layer_kernel``, ``gcn_layer.py:51``):
from one read of the old entity vertices it produces et'/ei', the four
folded dynamic scalar edges and the mention messages.  On the H100 the
W_h products (~15 GFLOP per layer at B=64, C=101, D=768) bound it; the TPU
design of a whole [C, D] tile plus W_h resident in fast memory does not fit
227 KB of shared memory, so the kernel runs as launch A, the edge fold's
two small products over all 2B mention rows in 16-row tiles on the tensor
cores, then launch B, per (b, vertex set) a loop over candidate tiles that
forms x, the messages and the edge dots from one read of the rows,
multiplies x by W_h on the tensor cores (W_h stays in L2) and finishes
bias, LayerNorm and the activation in shared memory.  The two [B, D] mention updates are finished here in plain
torch, as the JAX wrapper finishes them in XLA.

Weights are in torch layout (``[out, in]``).  Rounding points follow
``gcn_layer_reference``: x is rounded to the compute dtype before the W_h
product, p before the edge dot, and the messages stay float32.

:func:`fused_gcn_layer` takes :func:`gcn_layer_plain` only for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.  Where an input
requires grad it is a ``torch.autograd.Function`` with the kernel in the
forward.  Its backward is no kernel, as in the JAX package, whose
``_fused_ad_bwd`` (``gcn_layer.py:259-268``) differentiates
``gcn_layer_reference`` with XLA on the saved inputs: here autograd runs
through :func:`gcn_layer_plain` on the saved inputs (a recompute of the
layer in plain torch, then its backward).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from drin_tpu_torch.nn.layers import get_activation

ACT_CODES = {"gelu": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "identity": 4}
# the activations the kernel implements (the JAX gate's lists, drin.py:197-198)
KERNEL_VERTEX_ACTS = ("gelu", "relu", "tanh", "sigmoid")
KERNEL_EDGE_ACTS = ("sigmoid", "tanh", "relu", "identity")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches (CUDA path only), one per layer call


def _norm_act(h, ln_scale, ln_bias, eps, vact):
    """f32 LayerNorm (two-pass variance) + activation, as the JAX kernel."""
    mu = h.mean(-1, keepdim=True)
    var = torch.square(h - mu).mean(-1, keepdim=True)
    ln = (h - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    return get_activation(vact)(ln)


def _update(x, wh, bh, ln_scale, ln_bias, eps, vact):
    """act(LN(x . W_h^T + b_h)) for x in the compute dtype; f32 product."""
    h = x.float() @ wh.float().T + bh.float()
    return _norm_act(h, ln_scale, ln_bias, eps, vact).to(x.dtype)


def _mention_updates(mt, mi, msg_mt, msg_mi, wh, bh, ln_scale, ln_bias, eps, vact):
    dt = mt.dtype
    return [_update((u.float() + m).to(dt), wh, bh, ln_scale, ln_bias, eps, vact)
            for u, m in ((mt, msg_mt), (mi, msg_mi))]


def gcn_layer_plain(vertexes, edges, wh, bh, ln_scale, ln_bias,
                    wu=None, bu=None, wv=None, bv=None,
                    vact: str = "gelu", eact: str = "sigmoid", eps: float = 1e-5,
                    dynamic: bool = True, num_candidates: Optional[int] = None):
    """Plain PyTorch version: (vertexes [mt, mi, et, ei], edges [tt, ti, it,
    ii] as [B, C]) -> (new vertexes, new edges), same rounding points as the
    kernel.  ``num_candidates`` is the count the candidate means divide by
    (default C); padded candidates must come with zeroed edges."""
    mt, mi, et, ei = vertexes
    tt, ti, it, ii = edges
    D = et.shape[2]
    C = et.shape[1] if num_candidates is None else num_candidates
    dt = et.dtype
    f = lambda t: t.float()

    msg_mt = (torch.einsum("bc,bcd->bd", f(tt), f(et))
              + torch.einsum("bc,bcd->bd", f(ti), f(ei))) / C
    msg_mi = (torch.einsum("bc,bcd->bd", f(it), f(et))
              + torch.einsum("bc,bcd->bd", f(ii), f(ei))) / C
    new_mt, new_mi = _mention_updates(mt, mi, msg_mt, msg_mi, wh, bh, ln_scale,
                                      ln_bias, eps, vact)
    col = lambda e: f(e)[..., None]
    x_et = (f(et) + col(tt) * f(mt)[:, None] + col(it) * f(mi)[:, None]).to(dt)
    x_ei = (f(ei) + col(ti) * f(mt)[:, None] + col(ii) * f(mi)[:, None]).to(dt)
    nv = [new_mt, new_mi] + [_update(x, wh, bh, ln_scale, ln_bias, eps, vact)
                             for x in (x_et, x_ei)]
    if not dynamic:
        return nv, [tt, ti, it, ii]
    ea = get_activation(eact)
    ne = []
    for u, pairs in ((mt, (tt, ti)), (mi, (it, ii))):
        a = f(u) @ f(wu).T + f(bu)  # u . Ku + bu
        p = a.to(dt).float() @ f(wv)  # round(a) . Kv^T  (Kv^T == Wv in torch layout)
        s = (a * f(bv)).sum(-1)
        for e, v in zip(pairs, (et, ei)):
            conv = (torch.einsum("bd,bcd->bc", p.to(dt).float(), f(v)) + s[:, None]) / D
            ne.append(ea(conv + f(e)).to(e.dtype))
    return nv, ne


def _check_cuda(vertexes, edges, weights, dynamic):
    mt, mi, et, ei = vertexes
    if et.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_gcn_layer takes float32 or bfloat16, got {et.dtype}")
    B, C, D = et.shape
    want = {"mt": (B, D), "mi": (B, D), "et": (B, C, D), "ei": (B, C, D)}
    named = dict(zip(("mt", "mi", "et", "ei"), vertexes))
    named.update(zip(("tt", "ti", "it", "ii"), edges))
    want.update({k: (B, C) for k in ("tt", "ti", "it", "ii")})
    names = ("wh", "bh", "ln_scale", "ln_bias") + (("wu", "bu", "wv", "bv") if dynamic else ())
    named.update(zip(names, weights))
    want.update(wh=(D, D), bh=(D,), ln_scale=(D,), ln_bias=(D,),
                wu=(D, D), bu=(D,), wv=(D, D), bv=(D,))
    if B < 1 or C < 1:
        raise ValueError(f"fused_gcn_layer needs B >= 1 and C >= 1, got B={B} C={C}")
    if et.dtype == torch.bfloat16 and D % 16:
        raise ValueError(f"the bf16 kernel needs D % 16 == 0, got D={D}")
    for k, t in named.items():
        if t is None:
            raise ValueError(f"dynamic edges need {k}")
        if not t.is_cuda or t.device != et.device:
            raise ValueError(f"{k} must be on {et.device}, got {t.device}")
        if t.dtype != et.dtype:
            raise ValueError(f"{k} must be {et.dtype}, got {t.dtype}")
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k} must be {want[k]}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{k} must be contiguous and 16-byte aligned")
    for k in ("wh", "wu", "wv"):  # tensor-core fragments load from these directly
        if k in names and named[k].data_ptr() % 32:
            raise ValueError(f"{k} must be 32-byte aligned")
    return B, C, D


def _launch(vertexes, edges, wh, bh, ln_scale, ln_bias, wu, bu, wv, bv, vact, eact, eps,
            dynamic):
    """Check the inputs and launch the kernel once."""
    global launches
    if vact not in KERNEL_VERTEX_ACTS or eact not in KERNEL_EDGE_ACTS:
        raise ValueError(f"the kernel implements vertex activations {KERNEL_VERTEX_ACTS} "
                         f"and edge activations {KERNEL_EDGE_ACTS}; got {vact}/{eact}")
    weights = (wh, bh, ln_scale, ln_bias) + ((wu, bu, wv, bv) if dynamic else ())
    B, C, D = _check_cuda(vertexes, edges, weights, dynamic)
    mt, mi, et, ei = vertexes
    dt, dev = et.dtype, et.device
    Bp = -(-B // 16) * 16  # the edge-fold products run in tiles of 16 mentions
    a_ws = torch.empty((2, Bp, D), dtype=dt, device=dev)
    sp_ws = torch.empty((2, Bp, -(-D // 64)), dtype=torch.float32, device=dev)
    p_ws = torch.empty((B, 2, D), dtype=dt, device=dev)
    s_ws = torch.empty((B, 2), dtype=torch.float32, device=dev)
    et_o, ei_o = torch.empty_like(et), torch.empty_like(ei)
    new_edges = [torch.empty_like(e) for e in edges] if dynamic else list(edges)
    msg = torch.empty((B, 2, 2, D), dtype=torch.float32, device=dev)

    from drin_tpu_torch.ops.cuda import _build

    P, I = ctypes.c_void_p, ctypes.c_int
    lib, fn = _build.entry("gcn_layer", "drin_gcn_layer",
                           [I, I, I, I, ctypes.c_float, I, I, I] + [P] * 28)
    ptr = lambda t: t.data_ptr() if t is not None else None
    status = fn(_DTYPE_CODE[dt], B, C, D, float(eps), ACT_CODES[vact], ACT_CODES[eact],
                int(dynamic), *map(ptr, vertexes), *map(ptr, edges),
                *map(ptr, (wh, bh, ln_scale, ln_bias, wu, bu, wv, bv)),
                a_ws.data_ptr(), sp_ws.data_ptr(), p_ws.data_ptr(), s_ws.data_ptr(),
                et_o.data_ptr(), ei_o.data_ptr(),
                *map(ptr, new_edges), msg.data_ptr(), _build.stream_of(et))
    _build.check(status, lib, "gcn_layer launch")
    launches += 1
    # messages: (sum over et + sum over ei) / C, then the two mention updates
    msg_mt = (msg[:, 0, 0] + msg[:, 1, 0]) / C
    msg_mi = (msg[:, 0, 1] + msg[:, 1, 1]) / C
    new_mt, new_mi = _mention_updates(mt, mi, msg_mt, msg_mi, wh, bh, ln_scale,
                                      ln_bias, eps, vact)
    return [new_mt, new_mi, et_o, ei_o], new_edges


class _FusedGCNLayer(torch.autograd.Function):
    """The layer with a gradient: the kernel (on the CPU the plain version)
    in the forward; the backward recomputes the layer with
    :func:`gcn_layer_plain` on the saved inputs and runs autograd through
    it.  Takes the options and the 16 tensors flat (the dynamic-edge weights
    None for static edges); returns the 4 new vertexes and, for dynamic
    edges, the 4 new edges."""

    @staticmethod
    def forward(ctx, opts, *tensors):
        vact, eact, eps, dynamic, num_candidates = opts
        ctx.opts = opts
        ctx.save_for_backward(*tensors)
        vertexes, edges, weights = list(tensors[:4]), list(tensors[4:8]), tensors[8:]
        if tensors[2].is_cuda:
            nv, ne = _launch(vertexes, edges, *weights, vact, eact, eps, dynamic)
        else:
            nv, ne = gcn_layer_plain(vertexes, edges, *weights, vact=vact, eact=eact, eps=eps,
                                     dynamic=dynamic, num_candidates=num_candidates)
        return tuple(nv) + (tuple(ne) if dynamic else ())

    @staticmethod
    def backward(ctx, *grads):
        vact, eact, eps, dynamic, num_candidates = ctx.opts
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
            nv, ne = gcn_layer_plain(leaves[:4], leaves[4:8], *leaves[8:], vact=vact, eact=eact,
                                     eps=eps, dynamic=dynamic, num_candidates=num_candidates)
            outs = list(nv) + (list(ne) if dynamic else [])
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, list(grads), allow_unused=True))
        return (None,) + tuple(next(got) if t is not None and t.requires_grad else None
                               for t in leaves)


def fused_gcn_layer(vertexes, edges, wh, bh, ln_scale, ln_bias,
                    wu=None, bu=None, wv=None, bv=None,
                    vact: str = "gelu", eact: str = "sigmoid", eps: float = 1e-5,
                    dynamic: bool = True, num_candidates: Optional[int] = None):
    """One scalar-edge GCN layer, shared W_h: (vertexes [mt, mi, et, ei],
    edges [tt, ti, it, ii] as [B, C]) -> (new vertexes, new edges).  The
    kernel averages over all C candidates: on CUDA ``num_candidates`` must be
    None or C.  Differentiable in every tensor."""
    if not vertexes[2].is_cuda:
        return gcn_layer_plain(vertexes, edges, wh, bh, ln_scale, ln_bias, wu, bu, wv, bv,
                               vact=vact, eact=eact, eps=eps, dynamic=dynamic,
                               num_candidates=num_candidates)
    C = vertexes[2].shape[1]
    if num_candidates not in (None, C):
        raise ValueError(f"the kernel averages over all {C} candidates; padded candidates "
                         f"(num_candidates={num_candidates}) are not supported on CUDA")
    if not dynamic:
        wu = bu = wv = bv = None
    tensors = (*vertexes, *edges, wh, bh, ln_scale, ln_bias, wu, bu, wv, bv)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        out = _FusedGCNLayer.apply((vact, eact, eps, dynamic, num_candidates), *tensors)
        return list(out[:4]), (list(out[4:]) if dynamic else list(edges))
    return _launch(list(vertexes), list(edges), wh, bh, ln_scale, ln_bias, wu, bu, wv, bv,
                   vact, eact, eps, dynamic)
