# -*- coding: utf-8 -*-
"""Fused softmax attention, forward and backward (port of
``drin_tpu/ops/pallas/attention.py``).

Kernels: ``csrc/attention.cu`` (forward) and ``csrc/attention_bwd.cu``
(backward), CUDA C++ for ``sm_90a``.  They replace the TPU kernel
``fused_attention``: its forward body ``_attn_kernel`` (``attention.py:48``)
and its two backward bodies ``_attn_bwd_kernel`` / ``_attn_bwd_kernel_nomask``
(``:122`` / ``:134``): ``softmax(q.k^T * Dh^-1/2 + mask) . v`` and its
gradients with the [L, L] logits kept out of device memory in both
directions.  On the H100 the work at the online model's shape
([96, 12, 512, 64] bf16: 77 GFLOP and 302 MB forward, 193 GFLOP and ~0.6 GB
backward) sits where the tensor cores' and the memory's limits meet.  The TPU
design, all of K and V of one (b, h) plus [L, L] f32 tiles in fast memory and
an exact row softmax, does not fit 227 KB of shared memory, so the kernels
stream: one block per (b, h, 64 rows), the other operand through shared
memory in tiles of 64 rows (cp.async, double-buffered), every product on the
tensor cores (``mma.sync`` bf16, f32 accumulators).  The forward keeps a
running row max and sum and, when a gradient will be asked for, stores them
(``m``, ``l``, [B, H, L] f32 each).  The backward recomputes
``P = exp(S - m) / l`` from them in two launches without atomics: one owns dQ
per query tile (and stores ``delta = rowsum(dO * o)``), one owns dK, dV and
the mask cotangent per key tile.  float32 runs plain-FMA kernels of the same
form.

Rounding points follow ``_attn_kernel``: logits and softmax in float32, p
rounded to ``v.dtype`` before the second product, float32 accumulation,
output in ``q.dtype``.  One difference: the streaming kernel rounds p before
the normalisation (``exp(logit - running max)``), the plain version after
it; both keep 8 bits of p, so the results differ by output rounding only.
In the backward the bf16 kernels round P and dS to bf16 before their
products (``_attn_bwd_math`` keeps them float32), the float32 kernels round
nothing; :func:`attention_backward_plain` has the same rounding points.

The mask is additive, [B, L], 0 for a kept key and ``finfo.min`` for a
dropped one.  It keeps its magnitude: a row whose keys are all dropped gets
a uniform softmax, as in the JAX package.  That is why ``m`` and ``l`` stay
apart: one log-sum-exp would round ``m + log l`` back to ``m`` for such a
row.

:func:`fused_attention` takes the plain versions only for tensors on the
CPU; on a CUDA tensor it launches the kernels or raises.  It is a
``torch.autograd.Function`` where an input requires grad; under
``torch.no_grad()`` / ``torch.inference_mode()`` the forward launches alone
and stores no ``m`` / ``l``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 64
KERNEL_MAX_LEN = 512

launches = 0  # forward launches (CUDA path only), one per call
bwd_launches = 0  # backward with a mask: one per call (its two kernels count as one)
bwd_nomask_launches = 0  # backward without a mask


def attention_plain(q, k, v, additive_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: q, k, v
    [B, H, L, Dh], additive mask [B, L] or None -> [B, H, L, Dh]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if additive_mask is not None:
        logits = logits + additive_mask[:, None, None, :].float()
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)


def _check_cuda(q, k, v, additive_mask):
    """Refuse what the kernel does not take; returns (B, H, L, Dh)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_attention takes float32 or bfloat16 on CUDA, got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"q must be [B, H, L, Dh], got {tuple(q.shape)}")
    B, H, L, Dh = q.shape
    if Dh != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel is written for Dh={KERNEL_HEAD_DIM}, got Dh={Dh}")
    if not 1 <= L <= KERNEL_MAX_LEN or L % 8:
        raise ValueError(f"the kernel takes L a multiple of 8 up to {KERNEL_MAX_LEN}, got L={L}")
    if B < 1 or H < 1:
        raise ValueError(f"fused_attention needs B >= 1 and H >= 1, got B={B} H={H}")
    named = {"q": q, "k": k, "v": v}
    if additive_mask is not None:
        named["additive_mask"] = additive_mask
    row = 16 // q.element_size()  # elements in 16 bytes
    for name, t in named.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
        if name == "additive_mask":
            if tuple(t.shape) != (B, L) or t.stride(1) != 1:
                raise ValueError(f"additive_mask must be [{B}, {L}] with a contiguous last "
                                 f"dimension, got {tuple(t.shape)} strides {t.stride()}")
            continue
        if tuple(t.shape) != (B, H, L, Dh):
            raise ValueError(f"{name} must be {(B, H, L, Dh)}, got {tuple(t.shape)}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % row for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous last dimension and 16-byte aligned "
                             f"rows (strides {t.stride()}); call .contiguous() first")
    return B, H, L, Dh


def attention_backward_plain(q, k, v, additive_mask, do):
    """Plain PyTorch backward with the kernels' rounding points, written out
    step by step: q, k, v, do [B, H, L, Dh], additive mask [B, L] or None ->
    ``(dq, dk, dv, dmask)``; dmask ([B, L], the mask's dtype) is None without
    a mask.  P and dS are rounded to ``v.dtype`` before their products
    (nothing is rounded in float32), sums are float32."""
    dt, f = v.dtype, torch.float32
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.to(f), k.to(f), v.to(f), do.to(f)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if additive_mask is not None:
        logits = logits + additive_mask[:, None, None, :].to(f)
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).to(f), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    ds_r = ds.to(dt).to(f)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_r, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_r, qf) * scale
    dmask = None
    if additive_mask is not None:  # the mask broadcasts over heads and query rows
        dmask = ds.sum(dim=(1, 2)).to(additive_mask.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dmask


def _launch_forward(q, k, v, additive_mask, B, H, L, Dh, residuals: bool):
    """One forward launch; returns ``(out [B, L, H, Dh], m, l)`` with ``m``,
    ``l`` [B, H, L] float32 when ``residuals`` else None."""
    global launches
    out = torch.empty((B, L, H, Dh), dtype=q.dtype, device=q.device)
    m = l = None
    if residuals:
        m = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)

    from drin_tpu_torch.ops.cuda import _build

    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib, fn = _build.entry("attention", "drin_attention_fwd",
                           [I] * 5 + [P] * 7 + [S] * 10 + [P])
    status = fn(_DTYPE_CODE[q.dtype], B, H, L, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                additive_mask.data_ptr() if additive_mask is not None else None,
                out.data_ptr(), m.data_ptr() if residuals else None,
                l.data_ptr() if residuals else None,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                additive_mask.stride(0) if additive_mask is not None else 0,
                _build.stream_of(q))
    _build.check(status, lib, "attention launch")
    launches += 1
    return out, m, l


def _kernel_rows(t):
    """``t`` as the kernels read it: a contiguous last dimension and 16-byte
    aligned rows (a copy only where the gradient arrives otherwise)."""
    row = 16 // t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % row for s in t.stride()[:3]):
        return t.contiguous()
    return t


def _launch_backward(q, k, v, additive_mask, o, do, m, l, need_dmask: bool):
    """The two backward kernels; returns dq, dk, dv as [B, L, H, Dh] buffers
    and dmask [B, H, L] float32 (or None)."""
    global bwd_launches, bwd_nomask_launches
    B, H, L, Dh = q.shape
    do = _kernel_rows(do)
    dq, dk, dv = (torch.empty((B, L, H, Dh), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    dmask = (torch.empty((B, H, L), dtype=torch.float32, device=q.device)
             if additive_mask is not None and need_dmask else None)

    from drin_tpu_torch.ops.cuda import _build

    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strides = (S * 15)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                       *do.stride()[:3])
    head = (_DTYPE_CODE[q.dtype], B, H, L, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr())
    if additive_mask is not None:
        lib, fn = _build.entry("attention_bwd", "drin_attention_bwd",
                               [I] * 5 + [P] * 13 + [ctypes.POINTER(S), S, P])
        status = fn(*head, additive_mask.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(),
                    l.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    dmask.data_ptr() if dmask is not None else None, delta.data_ptr(), strides,
                    additive_mask.stride(0), _build.stream_of(q))
    else:
        lib, fn = _build.entry("attention_bwd", "drin_attention_bwd_nomask",
                               [I] * 5 + [P] * 11 + [ctypes.POINTER(S), P])
        status = fn(*head, o.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), strides,
                    _build.stream_of(q))
    _build.check(status, lib, "attention backward launch")
    if additive_mask is not None:
        bwd_launches += 1
    else:
        bwd_nomask_launches += 1
    return dq, dk, dv, dmask


class _FusedAttention(torch.autograd.Function):
    """Attention with a gradient.  CUDA: the forward kernel stores ``m`` and
    ``l``, the backward kernels read them with q, k, v, the mask and the
    output.  CPU: the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, additive_mask):
        ctx.has_mask = additive_mask is not None
        if not q.is_cuda:
            ctx.save_for_backward(q, k, v, additive_mask)
            return attention_plain(q, k, v, additive_mask)
        B, H, L, Dh = _check_cuda(q, k, v, additive_mask)
        out, m, l = _launch_forward(q, k, v, additive_mask, B, H, L, Dh, residuals=True)
        out = out.permute(0, 2, 1, 3)
        ctx.save_for_backward(q, k, v, additive_mask, out, m, l)
        return out

    @staticmethod
    def backward(ctx, do):
        need_dmask = ctx.has_mask and ctx.needs_input_grad[3]
        saved = ctx.saved_tensors  # read once: under activation checkpointing a second read raises
        if len(saved) == 4:  # CPU
            q, k, v, mask = saved
            dq, dk, dv, dmask = attention_backward_plain(q, k, v, mask, do)
            return dq, dk, dv, dmask if need_dmask else None
        q, k, v, mask, out, m, l = saved
        dq, dk, dv, dmask = _launch_backward(q, k, v, mask, out, do, m, l, need_dmask)
        if dmask is not None:  # summed over heads here, as the JAX wrapper does
            dmask = dmask.sum(dim=1).to(mask.dtype)
        # views of [B, L, H, Dh] buffers: the projections' backward reads them
        # as [B, L, H * Dh] without a copy
        return dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3), dmask


def fused_attention(q, k, v, additive_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention: q, k, v [B, H, L, Dh] (any strides over B, H and
    L; views made by ``reshape(B, L, H, Dh).transpose(1, 2)`` are read in
    place), additive mask [B, L] or None -> [B, H, L, Dh].  On CUDA the
    result is a view of a [B, L, H, Dh] buffer, so the caller's
    ``transpose(1, 2).reshape(B, L, H * Dh)`` copies nothing.  Differentiable
    in q, k, v and the mask."""
    tensors = (q, k, v) + (() if additive_mask is None else (additive_mask,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedAttention.apply(q, k, v, additive_mask)
    if not q.is_cuda:
        return attention_plain(q, k, v, additive_mask)
    B, H, L, Dh = _check_cuda(q, k, v, additive_mask)
    out, _, _ = _launch_forward(q, k, v, additive_mask, B, H, L, Dh, residuals=False)
    return out.permute(0, 2, 1, 3)
