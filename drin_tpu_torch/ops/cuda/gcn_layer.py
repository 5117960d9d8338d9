# -*- coding: utf-8 -*-
"""Fused DRIN GCN layer (port of ``drin_tpu/ops/pallas/gcn_layer.py``).

Kernel: ``csrc/gcn_layer.cu``, CUDA C++ for ``sm_90a``.  It replaces the
TPU kernel ``fused_gcn_layer`` (``_layer_kernel``, ``gcn_layer.py:51``):
from one read of the old entity vertices it produces et'/ei', the four
folded dynamic scalar edges, the mention messages and the two mention
updates.  On the H100 the W_h products (~15 GFLOP per layer at B=64, C=101,
D=768) bound it; the TPU design of a whole [C, D] tile plus W_h resident in
fast memory does not fit 227 KB of shared memory.  The layer is four
launches of one row kernel, rows x W^T on ``wgmma`` with W fed by a ring of
K-slices and a row-wise epilogue (LayerNorm finished in registers): A1 and
A2 fold the edges over the 2B mention rows, B updates the 2BC entity rows
in flat tiles of 64 (and writes the edge dots and per-tile message slots
from the same read of the old rows), C sums the slots in a fixed order and
updates the 2B mention rows.  In float32 every product runs on the tensor
cores in split-precision TF32 (each operand split into TF32 hi + lo, the
product taken as lo.hi + hi.lo + hi.hi in float32), and a first launch
splits the weights into the workspace once per call.  Both dtypes take D =
128 or 768 (:data:`BUILT_WIDTHS`).

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
BUILT_WIDTHS = (128, 768)  # the widths the kernels are compiled for, in both dtypes
ROW_TILE = 64  # rows of one block of the row kernel
F32_K = 16  # columns of the float32 kernel's K-slices (its weights' split image)

launches = 0  # kernel launches (CUDA path only), one per layer call


def _norm_act(h, ln_scale, ln_bias, eps, vact):
    """f32 LayerNorm (two-pass variance) + activation, as the JAX kernel."""
    mu = h.mean(-1, keepdim=True)
    var = torch.square(h - mu).mean(-1, keepdim=True)
    ln = (h - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    return get_activation(vact)(ln)


def _product(a, b):
    """``a @ b`` for the plain versions' weight products (both float32).
    A module attribute, so that an emulation of the kernels' TF32 arithmetic
    can take its place (``tests/test_torch_gcn_layer_f32.py``,
    ``chip_smoke.py``)."""
    return a @ b


def _update(x, wh, bh, ln_scale, ln_bias, eps, vact):
    """act(LN(x . W_h^T + b_h)) for x in the compute dtype; f32 product."""
    h = _product(x.float(), wh.float().T) + bh.float()
    return _norm_act(h, ln_scale, ln_bias, eps, vact).to(x.dtype)


def _mention_updates(mt, mi, msg_mt, msg_mi, wh, bh, ln_scale, ln_bias, eps, vact):
    dt = mt.dtype
    return [_update((u.float() + m).to(dt), wh, bh, ln_scale, ln_bias, eps, vact)
            for u, m in ((mt, msg_mt), (mi, msg_mi))]


def message_slots(B: int, C: int):
    """``(T, S)`` of the bf16 kernel's message slots: launch B tiles each
    vertex set's B*C rows by 64 (T tiles, none crossing from et to ei), and a
    tile's rows fall into at most S segments of C rows (one per b)."""
    return -(-B * C // ROW_TILE), min(B, (ROW_TILE - 1) // C + 2)


def slot_messages_plain(et, ei, edges):
    """The message slots as launch B writes them, in plain torch: float32
    [2 sets, T, S, 2 mentions, D]; slot s of tile t of a set holds the sum,
    over the tile's rows of b = floor(64 t / C) + s, of e * v (mention t: tt,
    ti; mention i: it, ii).  Slots past a tile's last segment hold zeros."""
    B, C, D = et.shape
    T, S = message_slots(B, C)
    tt, ti, it, ii = edges
    out = torch.zeros((2, T, S, 2, D), dtype=torch.float32, device=et.device)
    r = torch.arange(B * C, device=et.device)
    tile, slot = r // ROW_TILE, r // C - (r // ROW_TILE * ROW_TILE) // C
    for vs, (v, e_t, e_i) in enumerate(((et, tt, it), (ei, ti, ii))):
        v = v.reshape(B * C, D).float()
        for m, e in enumerate((e_t, e_i)):
            out[vs, :, :, m].index_put_((tile, slot), e.reshape(-1, 1).float() * v, accumulate=True)
    return out


def sum_slots_plain(slots, B: int, C: int):
    """Launch C's reading of the slots: the message sums [2 mentions, B, D]
    of each b, over set 0's tiles then set 1's in order."""
    b = torch.arange(B, device=slots.device)
    msg = torch.zeros((2, B, slots.shape[-1]), dtype=torch.float32, device=slots.device)
    for vs in range(2):
        for tile in range(slots.shape[1]):
            first = tile * ROW_TILE // C
            mine = (b * C // ROW_TILE <= tile) & (tile <= (b * C + C - 1) // ROW_TILE)
            mine &= (b - first) < slots.shape[2]
            got = slots[vs, tile, (b - first).clamp(0, slots.shape[2] - 1)]  # [B, 2, D]
            msg += (got * mine[:, None, None]).transpose(0, 1)
    return msg


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
        a = _product(f(u), f(wu).T) + f(bu)  # u . Ku + bu
        p = _product(a.to(dt).float(), f(wv))  # round(a) . Kv^T  (Kv^T == Wv in torch layout)
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
    if D not in BUILT_WIDTHS:
        raise ValueError(f"the kernel is built for D in {BUILT_WIDTHS}, got D={D}")
    if B * C >= 2 ** 31 // ROW_TILE:
        raise ValueError(f"fused_gcn_layer takes B * C < {2 ** 31 // ROW_TILE}, got {B * C}")
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
    return B, C, D


def workspace_layout(B: int, C: int, D: int, dtype=torch.bfloat16):
    """The layer's scratch as ``(name, byte offset, shape, dtype)``, each
    part 256-byte aligned, and the total bytes: round(a) of the fold [2B, D]
    in the compute dtype (then launch C's x rows), its partial sums of s
    [2, B, D / 64], p [B, 2, D], the message slots [2, T, S, 2, D]
    (:func:`message_slots`) and launch B's count of finished tiles per b
    [B]; in float32 also the split images of W_h, Ku and Kv^T that the first
    launch writes, [D / 16, 2, D, 16] each (K-slice, TF32 hi | lo, output,
    the slice's columns)."""
    T, S = message_slots(B, C)
    split = (D // F32_K, 2, D, F32_K)
    spec = [("ar", (2 * B, D), dtype), ("s_part", (2, B, D // 64), torch.float32),
            ("p", (B, 2, D), dtype), ("msg", (2, T, S, 2, D), torch.float32),
            ("count", (B,), torch.int32)]
    if dtype == torch.float32:
        spec += [(name, split, torch.float32) for name in ("wh_split", "wu_split", "wv_split")]
    parts, off = [], 0
    for name, shape, dt in spec:
        parts.append((name, off, shape, dt))
        n = dt.itemsize
        for s in shape:
            n *= s
        off += -(-n // 256) * 256
    return parts, off


def _workspace(B, C, D, device, dtype=torch.bfloat16):
    """One allocation, cut into the views of :func:`workspace_layout`."""
    parts, total = workspace_layout(B, C, D, dtype)
    raw = torch.empty(total, dtype=torch.uint8, device=device)
    views = {}
    for name, off, shape, dt in parts:
        n = dt.itemsize
        for s in shape:
            n *= s
        views[name] = raw[off:off + n].view(dt).view(shape)
    return views


def _launch(vertexes, edges, wh, bh, ln_scale, ln_bias, wu, bu, wv, bv, vact, eact, eps,
            dynamic):
    """Check the inputs and launch the kernel once (its four launches and a
    memset; float32 first splits the weights)."""
    global launches
    if vact not in KERNEL_VERTEX_ACTS or eact not in KERNEL_EDGE_ACTS:
        raise ValueError(f"the kernel implements vertex activations {KERNEL_VERTEX_ACTS} "
                         f"and edge activations {KERNEL_EDGE_ACTS}; got {vact}/{eact}")
    weights = (wh, bh, ln_scale, ln_bias) + ((wu, bu, wv, bv) if dynamic else ())
    B, C, D = _check_cuda(vertexes, edges, weights, dynamic)
    et = vertexes[2]
    new_edges = [torch.empty_like(e) for e in edges] if dynamic else list(edges)
    new_vertexes = [torch.empty_like(v) for v in vertexes]

    from drin_tpu_torch.ops.cuda import _build

    P, I = ctypes.c_void_p, ctypes.c_int
    ptr = lambda t: t.data_ptr() if t is not None else None
    ins = (*map(ptr, vertexes), *map(ptr, edges),
           *map(ptr, (wh, bh, ln_scale, ln_bias, wu, bu, wv, bv)))
    opts = (B, C, D, float(eps), ACT_CODES[vact], ACT_CODES[eact], int(dynamic))
    ws = _workspace(B, C, D, et.device, et.dtype)
    scratch = [ws[k].data_ptr() for k in ("ar", "s_part", "p", "msg", "count")]
    f32 = et.dtype == torch.float32
    split = [ws[k].data_ptr() for k in ("wh_split", "wu_split", "wv_split")] if f32 else []
    name = "drin_gcn_layer_f32" if f32 else "drin_gcn_layer_bf16"
    lib, fn = _build.entry("gcn_layer", name, [I, I, I, ctypes.c_float, I, I, I] + [P] * 21 + [I]
                           + [P] * (len(split) + 9))
    status = fn(*opts, *ins, *scratch, ws["msg"].shape[2], *split, *map(ptr, new_vertexes),
                *map(ptr, new_edges), _build.stream_of(et))
    _build.check(status, lib, "gcn_layer launch")
    launches += 1
    return new_vertexes, new_edges


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
