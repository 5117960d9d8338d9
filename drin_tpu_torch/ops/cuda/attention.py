# -*- coding: utf-8 -*-
"""Fused softmax attention, forward (port of
``drin_tpu/ops/pallas/attention.py``).

Kernel: ``csrc/attention.cu``, CUDA C++ for ``sm_90a``.  It replaces the TPU
kernel ``fused_attention`` (forward body ``_attn_kernel``,
``attention.py:48``): ``softmax(q.k^T * Dh^-1/2 + mask) . v`` with the
[L, L] logits kept out of device memory.  On the H100 the work at the online
model's shape ([96, 12, 512, 64] bf16: 77 GFLOP, 302 MB) sits where the
tensor cores' and the memory's limits meet (0.078 and 0.090 ms).  The TPU
design, all of K and V of one (b, h) plus a [block_q, L] f32 logits tile in
fast memory and an exact row softmax, does not fit 227 KB of shared memory,
so the kernel streams: one block per (b, h, 64 query rows), K and V through
shared memory in tiles of 64 keys (cp.async, double-buffered), both products
on the tensor cores (``mma.sync`` bf16, f32 accumulators), running row max
and sum in registers, one division at the end.  float32 runs a plain-FMA
kernel of the same form.

Rounding points follow ``_attn_kernel``: logits and softmax in float32, p
rounded to ``v.dtype`` before the second product, float32 accumulation,
output in ``q.dtype``.  One difference: the streaming kernel rounds p before
the normalisation (``exp(logit - running max)``), the plain version after
it; both keep 8 bits of p, so the results differ by output rounding only.

The mask is additive, [B, L], 0 for a kept key and ``finfo.min`` for a
dropped one.  It keeps its magnitude: a row whose keys are all dropped gets
a uniform softmax, as in the JAX package.

:func:`fused_attention` takes :func:`attention_plain` only for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.  It is
forward-only: the backward kernels come with the training port.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 64
KERNEL_MAX_LEN = 512

launches = 0  # kernel launches (CUDA path only), one per call


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
    grad = torch.is_grad_enabled()
    row = 16 // q.element_size()  # elements in 16 bytes
    for name, t in named.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
        if grad and t.requires_grad:
            raise RuntimeError("fused_attention is forward-only on CUDA (no backward kernel "
                               f"yet): {name} requires grad; run under torch.no_grad() or "
                               "torch.inference_mode()")
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


def fused_attention(q, k, v, additive_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention: q, k, v [B, H, L, Dh] (any strides over B, H and
    L; views made by ``reshape(B, L, H, Dh).transpose(1, 2)`` are read in
    place), additive mask [B, L] or None -> [B, H, L, Dh].  On CUDA the
    result is a view of a [B, L, H, Dh] buffer, so the caller's
    ``transpose(1, 2).reshape(B, L, H * Dh)`` copies nothing."""
    global launches
    if not q.is_cuda:
        return attention_plain(q, k, v, additive_mask)
    B, H, L, Dh = _check_cuda(q, k, v, additive_mask)
    out = torch.empty((B, L, H, Dh), dtype=q.dtype, device=q.device)

    from drin_tpu_torch.ops.cuda import _build

    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib, fn = _build.entry("attention", "drin_attention_fwd",
                           [I] * 5 + [P] * 5 + [S] * 10 + [P])
    status = fn(_DTYPE_CODE[q.dtype], B, H, L, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                additive_mask.data_ptr() if additive_mask is not None else None,
                out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                additive_mask.stride(0) if additive_mask is not None else 0,
                _build.stream_of(q))
    _build.check(status, lib, "attention launch")
    launches += 1
    return out.permute(0, 2, 1, 3)
