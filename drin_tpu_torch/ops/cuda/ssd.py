# -*- coding: utf-8 -*-
"""Mamba-2's chunked SSD scan, forward (the state-space layers of
``encoders/granite_hybrid.py``).

Kernel: ``csrc/ssd_scan.cu``, CUDA C++ for ``sm_90a``.  It replaces no
Pallas kernel (the JAX package has no state-space layer); the source says
what bounds it and how it is built.  For each sequence, head ``h`` and token
``t``, with one group (B and C shared by the heads)::

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t
    y_t = S_t . C_t + D_h * x_t

taken in chunks of ``chunk`` tokens: the products inside a chunk in their
quadratic form, the state carried from chunk to chunk.

:func:`ssd_plain` is the same function in plain PyTorch with the kernel's
rounding points (the weighted scores, the carried state and the weighted B
rounded to ``x.dtype`` before their products; sums, decays and the state
float32).  :func:`ssd_scan` takes it only for tensors on the CPU; on a CUDA
tensor it launches the kernel (bf16 x, B, C; float32 dt, A, D; P = 64,
N = 128, chunk 256) or raises.  Forward only: the tower runs under
``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes

import torch

from drin_tpu_torch.common.spans import span
from drin_tpu_torch.ops.cuda import _build

KERNEL_HEAD_DIM = 64
KERNEL_STATE = 128
KERNEL_CHUNK = 256

launches = 0  # kernel launches (CUDA path only), one a call
chunks = 0  # (sequence, head, chunk) triples the kernel scanned

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _S, _S, _P, _S, _S, _P, _S, _S, _P, _S, _S, _P, _P, _P, _I, _I, _I, _P]


def ssd_plain(x, dt, A, B, C, D, chunk: int = KERNEL_CHUNK) -> torch.Tensor:
    """x [N, L, H, P], dt [N, L, H] (after the softplus), A [H], B and C
    [N, L, S], D [H] -> y [N, L, H, P] in ``x.dtype``; the chunked form with
    the kernel's rounding points."""
    Nb, L, H, P = x.shape
    rnd = lambda t: t.to(x.dtype).float()  # noqa: E731  (a no-op in float32)
    xf, Bf, Cf, dtf = x.float(), B.float(), C.float(), dt.float()
    Af, Df = A.float(), D.float()
    y = torch.empty((Nb, L, H, P), dtype=torch.float32, device=x.device)
    state = torch.zeros((Nb, H, P, B.shape[-1]), dtype=torch.float32, device=x.device)
    for t0 in range(0, L, chunk):
        sl = slice(t0, min(t0 + chunk, L))
        xc, Bc, Cc, dc = xf[:, sl], Bf[:, sl], Cf[:, sl], dtf[:, sl]
        Q = xc.shape[1]
        cum = torch.cumsum(dc * Af, dim=1)  # [N, Q, H]
        carried = torch.einsum("nqs,nhps->nqhp", Cc, rnd(state)) * torch.exp(cum)[..., None]
        scores = torch.einsum("nts,nus->ntu", Cc, Bc)  # [N, Q, Q]
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # [N, t, s, H]
        decay = torch.where(causal[None, :, :, None], torch.exp(seg), torch.zeros_like(seg))
        w = rnd(scores[..., None] * (decay * dc[:, None, :, :]))  # [N, t, s, H]
        inside = torch.einsum("ntsh,nshp->nthp", w, xc)
        y[:, sl] = carried + inside + Df[:, None] * xc
        end = cum[:, -1:, :]  # [N, 1, H]
        Bw = rnd(Bc[:, :, None, :] * (torch.exp(end - cum) * dc)[..., None])  # [N, Q, H, S]
        state = state * torch.exp(end[:, 0])[..., None, None] + \
            torch.einsum("nqhp,nqhs->nhps", xc, Bw)
    return y.to(x.dtype)


def _check_cuda(x, dt, A, B, C, D, chunk):
    """Refuse what the kernel does not take; returns (N, L, H)."""
    if chunk != KERNEL_CHUNK:
        raise ValueError(f"the scan kernel takes chunks of {KERNEL_CHUNK}, got {chunk}")
    if x.ndim != 4 or x.shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"x must be [N, L, H, {KERNEL_HEAD_DIM}], got {tuple(x.shape)}")
    N, L, H, P = x.shape
    for name, t, dtype, shape in (("x", x, torch.bfloat16, (N, L, H, P)),
                                  ("B", B, torch.bfloat16, (N, L, KERNEL_STATE)),
                                  ("C", C, torch.bfloat16, (N, L, KERNEL_STATE)),
                                  ("dt", dt, torch.float32, (N, L, H)),
                                  ("A", A, torch.float32, (H,)), ("D", D, torch.float32, (H,))):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"the scan kernel takes {name} in {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError(f"x needs its heads' channels contiguous, strides {x.stride()}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
            raise ValueError(f"{name} needs a contiguous last dimension and 16-byte aligned "
                             f"rows (strides {t.stride()})")
    if dt.stride(2) != 1 or not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("dt needs a contiguous last dimension, A and D contiguous")
    return N, L, H


def ssd_scan(x, dt, A, B, C, D, chunk: int = KERNEL_CHUNK) -> torch.Tensor:
    """The scan of :func:`ssd_plain`: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    global launches, chunks
    with span("drin.granite.ssd"):
        if not x.is_cuda:
            return ssd_plain(x, dt, A, B, C, D, chunk)
        N, L, H = _check_cuda(x, dt, A, B, C, D, chunk)
        y = torch.empty((N, L, H, KERNEL_HEAD_DIM), dtype=x.dtype, device=x.device)
        lib, fn = _build.entry("ssd_scan", "drin_ssd_fwd_bf16", _ARGS)
        status = fn(x.data_ptr(), x.stride(0), x.stride(1), B.data_ptr(), B.stride(0),
                    B.stride(1), C.data_ptr(), C.stride(0), C.stride(1), dt.data_ptr(),
                    dt.stride(0), dt.stride(1), A.data_ptr(), D.data_ptr(), y.data_ptr(),
                    N, L, H, _build.stream_of(x))
        _build.check(status, lib, "ssd scan launch")
        launches += 1
        chunks += N * H * -(-L // KERNEL_CHUNK)
        return y
