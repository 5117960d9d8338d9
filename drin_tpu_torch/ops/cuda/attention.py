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
backward) sits where three limits meet: the tensor cores' rate, the memory's,
and the special-function units' (302 M exponentials a pass).  The TPU design,
all of K and V of one (b, h) plus [L, L] f32 tiles in fast memory and an
exact row softmax, does not fit 227 KB of shared memory, so the kernels
stream, and the bf16 ones are built from Hopper's own pieces: every product
is ``wgmma`` (f32 accumulators) whose B operand the tensor cores read from
128-byte-swizzled tiles in shared memory, K-major or MN-major as the product
needs, so nothing is transposed there; the tiles arrive by TMA
(``cp.async.bulk.tensor`` through 4-D tensor maps made from the tensors' own
strides, rows past L as zeros) into a ring of stages guarded by mbarriers and
fed by one elected thread; P and dS go from one product's accumulators into
the next one's A operand in registers; the softmax is taken in base 2 (one
FFMA, one FADD, one ``ex2`` per logit).  The forward holds 128 query rows a
block (two warpgroups), a running row max and sum, and, when a gradient will
be asked for, stores them (``m``, ``l``, [B, H, L] f32 each, natural units).
The backward recomputes ``P = exp(S - m) / l`` from them (in base 2 again,
the exponent cut off at 0, so that a row of equal logits gives 1 / L for any
finite mask value whatever the conversion rounds) in two launches
without atomics, so its results repeat bit for bit: one owns dQ per 128 query
rows (and stores each query's ``m``, ``1 / l`` and ``delta = rowsum(dO * o)``
in tiles of 64 for the second), one owns dK, dV and the mask cotangent per 64
keys.  The float32 forward has the same streaming form on ``wgmma`` in
split-precision TF32: each operand is split into a TF32 high part and a
TF32 remainder, and each product is taken as lo.hi + hi.lo + hi.hi in f32
accumulators (lo.lo, 2^-22 of a product, dropped), which holds float32
accuracy at the tensor cores' TF32 rate; V is transposed into V^T tiles as
it is split, since ``wgmma`` reads TF32 only K-major, and the softmax is
taken in natural units.  The float32 backward has the bf16 backward's
two-launch form with all five products on ``wgmma`` in the same split
precision: each streamed tile is split once by the block that reads it, and
the three products that sum over a tile's rows (dQ over keys, dK and dV over
queries) read transposed split copies (K^T, Q^T, dO^T) written while the
tensor cores take the first two; it recomputes the softmax in natural units
from the forward's ``m`` and ``l``.
``drin_tpu_torch/tools/attention_sweep.py`` builds other tile sizes, ring
depths and block shapes with ``-D`` and times them side by side; the winner
is compiled in, there is no runtime switch.

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

from drin_tpu_torch.ops.cuda import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_I] * 5 + [_P] * 7 + [_S] * 10 + [_P]
_BWD_ARGS = [_I] * 5 + [_P] * 13 + [ctypes.POINTER(_S), _S, _P]
_BWD_NOMASK_ARGS = [_I] * 5 + [_P] * 11 + [ctypes.POINTER(_S), _P]
KERNEL_HEAD_DIM = 64
KERNEL_MAX_LEN = 512

STATS_TILE = 64  # queries per tile of the backward's (m, 1 / l, delta) workspace

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


def _strides(t):
    """Element strides of B, H and L of ``t`` [B, H, L, Dh] as the kernels get
    them.  The forward kernels and the bf16 backward make a TMA tensor map
    from them: dimensions ``(Dh, L, H, B)``, innermost first, and these
    strides in bytes, each a multiple of 16 and below 2**40.  PyTorch leaves
    the stride of a dimension of size 1 arbitrary (0 after ``expand``); no
    address depends on it, but a tensor map checks it, so it is replaced by
    the packed one."""
    B, H, L, Dh = t.shape
    sb, sh, sl, _ = t.stride()
    if H == 1:
        sh = sl * L
    if B == 1:
        sb = max(sh * H, sl * L)
    return sb, sh, sl


_MAP_STRIDE_LIMIT = 2 ** 40  # bytes: what a tensor map's stride field holds


def _check_cuda(q, k, v, additive_mask):
    """Refuse what the kernel does not take; returns (B, H, L, Dh).  On every
    call's path, so it reads each tensor's attributes once."""
    dt = q.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"fused_attention takes float32 or bfloat16 on CUDA, got {dt}")
    if q.ndim != 4:
        raise ValueError(f"q must be [B, H, L, Dh], got {tuple(q.shape)}")
    shape = tuple(q.shape)
    B, H, L, Dh = shape
    if Dh != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel is written for Dh={KERNEL_HEAD_DIM}, got Dh={Dh}")
    if not 1 <= L <= KERNEL_MAX_LEN or L % 8:
        raise ValueError(f"the kernel takes L a multiple of 8 up to {KERNEL_MAX_LEN}, got L={L}")
    if B < 1 or H < 1:
        raise ValueError(f"fused_attention needs B >= 1 and H >= 1, got B={B} H={H}")
    device = q.device
    es = q.element_size()
    row = 16 // es  # elements in 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be on {device}, got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        sb, sh, sl, sd = t.stride()
        if sd != 1 or t.data_ptr() % 16 or sb % row or sh % row or sl % row:
            raise ValueError(f"{name} needs a contiguous last dimension and 16-byte aligned "
                             f"rows (strides {t.stride()}); call .contiguous() first")
        # the forward kernels read through tensor maps: a dimension that is walked needs
        # a stride the map can hold (an expanded tensor's 0 is not one)
        if not (0 < sl * es < _MAP_STRIDE_LIMIT
                and (H == 1 or 0 < sh * es < _MAP_STRIDE_LIMIT)
                and (B == 1 or 0 < sb * es < _MAP_STRIDE_LIMIT)):
            raise ValueError(f"{name}: strides {t.stride()} are outside what a tensor map "
                             f"takes (positive, below 2**40 bytes); call .contiguous() first")
    if additive_mask is not None:
        t = additive_mask
        if not t.is_cuda or t.device != device:
            raise ValueError(f"additive_mask must be on {device}, got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"additive_mask must be {dt}, got {t.dtype}")
        if tuple(t.shape) != (B, L) or t.stride(1) != 1:
            raise ValueError(f"additive_mask must be [{B}, {L}] with a contiguous last "
                             f"dimension, got {tuple(t.shape)} strides {t.stride()}")
    return shape


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
    lib, fn = _build.entry("attention", "drin_attention_fwd", _FWD_ARGS)
    status = fn(_DTYPE_CODE[q.dtype], B, H, L, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                additive_mask.data_ptr() if additive_mask is not None else None,
                out.data_ptr(), m.data_ptr() if residuals else None,
                l.data_ptr() if residuals else None,
                *_strides(q), *_strides(k), *_strides(v),
                additive_mask.stride(0) if additive_mask is not None else 0,
                _build.stream_of(q))
    _build.check(status, lib, "attention launch")
    launches += 1
    return out, m, l


def _kernel_rows(t):
    """``t`` as the kernels read it: a contiguous last dimension and 16-byte
    aligned rows (a copy only where the gradient arrives otherwise)."""
    row = 16 // t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16 or any(s % row for s in t.stride()[:3])
            or any(not 0 < s * t.element_size() < _MAP_STRIDE_LIMIT for s in _strides(t))):
        return t.contiguous()
    return t


def _launch_backward(q, k, v, additive_mask, o, do, m, l, need_dmask: bool):
    """The two backward kernels; returns dq, dk, dv as [B, L, H, Dh] buffers
    and dmask [B, H, L] float32 (or None)."""
    global bwd_launches, bwd_nomask_launches
    B, H, L, Dh = q.shape
    do = _kernel_rows(do)
    dq, dk, dv = (torch.empty((B, L, H, Dh), dtype=q.dtype, device=q.device) for _ in range(3))
    # workspace of the two launches: each query's m, 1 / l and delta in padded
    # tiles of 64 queries
    delta = torch.empty((B, H, -(-L // STATS_TILE), 3, STATS_TILE), dtype=torch.float32,
                        device=q.device)
    dmask = (torch.empty((B, H, L), dtype=torch.float32, device=q.device)
             if additive_mask is not None and need_dmask else None)
    strides = (_S * 15)(*_strides(q), *_strides(k), *_strides(v), *_strides(o), *_strides(do))
    head = (_DTYPE_CODE[q.dtype], B, H, L, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr())
    if additive_mask is not None:
        lib, fn = _build.entry("attention_bwd", "drin_attention_bwd", _BWD_ARGS)
        status = fn(*head, additive_mask.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(),
                    l.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    dmask.data_ptr() if dmask is not None else None, delta.data_ptr(), strides,
                    additive_mask.stride(0), _build.stream_of(q))
    else:
        lib, fn = _build.entry("attention_bwd", "drin_attention_bwd_nomask", _BWD_NOMASK_ARGS)
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
    """Softmax attention: q, k, v [B, H, L, Dh] (any positive strides over
    B, H and L; views made by ``reshape(B, L, H, Dh).transpose(1, 2)`` are
    read in place), additive mask [B, L] or None -> [B, H, L, Dh].  On CUDA
    both forward kernels, bfloat16 and float32, read through TMA tensor maps,
    so a stride of 0 over a dimension of size above 1 (an ``expand``ed
    tensor) is refused in either type: call ``.contiguous()`` first.  On CUDA the
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
