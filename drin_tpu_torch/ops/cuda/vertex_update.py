# -*- coding: utf-8 -*-
"""Fused entity-vertex update (port of ``drin_tpu/ops/pallas/gcn.py``).

Kernel: ``gcn_rows_bf16`` (f32: ``vertex_update_kernel``) in ``csrc/gcn_layer.cu``, CUDA C++ for
``sm_90a``.  It replaces the TPU kernel ``fused_vertex_update``
(``gcn.py:58``): ``y = act(LN((v + e1*m1 + e2*m2) . W + b))`` for the
[B, C, D] entity vertices in one pass, the scalar-edge broadcasts, the
product, LayerNorm and the activation without a round trip through device
memory.  On the H100 the product bounds it (7.6 GFLOP over ~21 MB at B=64,
C=101, D=768).  The TPU design holds one sample's whole [C, D] block and W in
fast memory; W alone (1.18 MB of bf16) does not fit 227 KB of shared memory,
so the bf16 kernel is the GCN-layer kernel's row piece over the B*C rows in
flat tiles of 64: x formed in the K-slice's prologue, the product on
``wgmma`` with W fed by a TMA ring, bias, LayerNorm and the activation
finished in registers.  The bf16 path takes D = 128 or 768; the f32 form is
plain FMA loops.

The weight is in torch layout (``[out, in]``), as the GCN-layer kernel's.
x is formed in float32 and rounded once to the compute dtype before the
product; gelu is the exact erf form (the TPU kernel's polynomial differs by
less than 1.5e-7).  No model calls this op, in either package; it is
forward-only, as in the JAX package (no ``custom_vjp`` there).

:func:`fused_vertex_update` takes :func:`vertex_update_plain` only for
tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from drin_tpu_torch.ops.cuda.gcn_layer import (ACT_CODES, BF16_WIDTHS, KERNEL_VERTEX_ACTS,
                                               ROW_TILE, _DTYPE_CODE, _norm_act)

launches = 0  # kernel launches (CUDA path only), one per call


def vertex_update_plain(v, e1, m1, e2, m2, w, b, scale, bias, act: str = "gelu",
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: v [B, C, D];
    e1, e2 [B, C]; m1, m2 [B, D]; w [D, D] as [out, in]; b, scale, bias [D]
    -> [B, C, D] in ``v.dtype``."""
    f = lambda t: t.float()
    x = (f(v) + f(e1)[..., None] * f(m1)[:, None, :]
         + f(e2)[..., None] * f(m2)[:, None, :]).to(v.dtype)
    h = x.float() @ f(w).T + f(b)
    return _norm_act(h, scale, bias, eps, act).to(v.dtype)


def _check_cuda(named: dict, act: str):
    v = named["v"]
    if v.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_vertex_update takes float32 or bfloat16, got {v.dtype}")
    if v.ndim != 3:
        raise ValueError(f"v must be [B, C, D], got {tuple(v.shape)}")
    if act not in KERNEL_VERTEX_ACTS:
        raise ValueError(f"the kernel implements activations {KERNEL_VERTEX_ACTS}; got {act}")
    B, C, D = v.shape
    if B < 1 or C < 1 or B > 65535:
        raise ValueError(f"fused_vertex_update needs 1 <= B <= 65535 and C >= 1, got B={B} C={C}")
    if v.dtype == torch.bfloat16 and D not in BF16_WIDTHS:
        raise ValueError(f"the bf16 kernel is built for D in {BF16_WIDTHS}, got D={D}")
    if B * C >= 2 ** 31 // ROW_TILE:
        raise ValueError(f"fused_vertex_update takes B * C < {2 ** 31 // ROW_TILE}, got {B * C}")
    want = dict(v=(B, C, D), e1=(B, C), e2=(B, C), m1=(B, D), m2=(B, D), w=(D, D), b=(D,),
                scale=(D,), bias=(D,))
    for k, t in named.items():
        if not t.is_cuda or t.device != v.device:
            raise ValueError(f"{k} must be on {v.device}, got {t.device}")
        if t.dtype != v.dtype:
            raise ValueError(f"{k} must be {v.dtype}, got {t.dtype}")
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k} must be {want[k]}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{k} must be contiguous and 16-byte aligned")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError("fused_vertex_update is forward-only, as in the JAX package: "
                               f"{k} requires grad; run under torch.no_grad()")
    return B, C, D


def fused_vertex_update(v, e1, m1, e2, m2, w, b, scale, bias, act: str = "gelu",
                        eps: float = 1e-5) -> torch.Tensor:
    """``act(LN((v + e1*m1 + e2*m2) . w^T + b))``: v [B, C, D]; e1, e2 [B, C];
    m1, m2 [B, D]; w [D, D] as [out, in]; b, scale, bias [D] -> [B, C, D]."""
    global launches
    if not v.is_cuda:
        return vertex_update_plain(v, e1, m1, e2, m2, w, b, scale, bias, act, eps)
    named = dict(v=v, e1=e1, m1=m1, e2=e2, m2=m2, w=w, b=b, scale=scale, bias=bias)
    B, C, D = _check_cuda(named, act)
    out = torch.empty_like(v)

    from drin_tpu_torch.ops.cuda import _build

    P, I = ctypes.c_void_p, ctypes.c_int
    lib, fn = _build.entry("gcn_layer", "drin_vertex_update",
                           [I, I, I, I, ctypes.c_float, I] + [P] * 11)
    status = fn(_DTYPE_CODE[v.dtype], B, C, D, float(eps), ACT_CODES[act],
                *(t.data_ptr() for t in named.values()), out.data_ptr(), _build.stream_of(v))
    _build.check(status, lib, "vertex_update launch")
    launches += 1
    return out
