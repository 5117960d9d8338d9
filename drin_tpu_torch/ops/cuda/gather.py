# -*- coding: utf-8 -*-
"""Fused entity-row gather + int8 dequantization (port of
``drin_tpu/ops/pallas/gather.py``).

Kernel: ``csrc/gather_dequant.cu``, CUDA C++ for ``sm_90a``.  It replaces
the TPU kernel ``gather_dequant`` (``_kernel``, ``gather.py:78``).  What
bounds it on the H100 is bytes: at B=64, C=101 and the WikiMEL widths it
reads about 36 MB of int8 and writes about 73 MB of bf16.  A persistent grid
streams each requested row's data sub-rows and scales into a ring in shared
memory with bulk copies, dequantizes them there and writes each chunk's row
contiguously in the output type; the slab's pad sub-rows are never read and
nothing intermediate is written.  The kernel checks the row indices itself
(int32 or int64, as they come), so one call is one launch into one output
buffer (:func:`out_plan`).

The packed table keeps the JAX package's byte layout (``[N, m, 128]`` int8,
``m`` padded to a multiple of 8, per-sub-row f32 scales ``[N, m]``), so a
table packed by either package is valid in the other.  The layout helpers
(:func:`fused_gather_supported`, :func:`_slot_subrows`,
:func:`pack_quantized_tables`) are numpy.

:func:`gather_dequant` takes :func:`gather_dequant_plain` only for tensors
on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

LANES = 128
MAX_CHUNKS = 4
_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches (CUDA path only)


def _slot_subrows(chunks):
    """Per-chunk (sub_lo, sub_hi) ranges and the padded slab height m."""
    spans, lo = [], 0
    for width, _ in chunks:
        n = width // LANES
        spans.append((lo, lo + n))
        lo += n
    m = -(-lo // 8) * 8  # the JAX layout pads the slab to a multiple of 8
    return tuple(spans), lo, m


def fused_gather_supported(d_packed: int, chunks) -> bool:
    """True when every dequant slot is a whole number of 128-lane sub-rows."""
    if d_packed % LANES:
        return False
    for width, nslots in chunks:
        if width % nslots or (width // nslots) % LANES:
            return False
    return sum(w for w, _ in chunks) == d_packed


def pack_quantized_tables(qtables, scales) -> tuple[np.ndarray, np.ndarray]:
    """Lay per-table int8 rows (flattened past axis 0) into one packed
    [N, m, 128] table + [N, m] per-sub-row scales.  ``scales[t]`` is [N] or
    [N, S] (per slot); every sub-row of a slot carries its slot's scale, pad
    sub-rows hold zeros with scale 1."""
    n = qtables[0].shape[0]
    qs = [np.asarray(q).reshape(n, -1) for q in qtables]
    ss = [np.asarray(s).reshape(n, -1).astype(np.float32) for s in scales]
    chunks = tuple((q.shape[1], s.shape[1]) for q, s in zip(qs, ss))
    assert fused_gather_supported(sum(w for w, _ in chunks), chunks), (
        "fused_gather needs 128-lane-aligned feature slots; got chunk "
        f"layout {chunks}")
    spans, _, m = _slot_subrows(chunks)
    packed = np.zeros((n, m, LANES), np.int8)
    psc = np.ones((n, m), np.float32)
    for q, s, (lo, hi) in zip(qs, ss, spans):
        packed[:, lo:hi] = q.reshape(n, hi - lo, LANES)
        psc[:, lo:hi] = np.repeat(s, (hi - lo) // s.shape[1], axis=1)
    return packed, psc


def sanitize_rows(rows: torch.Tensor, n: int) -> torch.Tensor:
    """Flat int64 row indices with the JAX package's indexing semantics:
    negatives wrap once, the rest clamp into [0, n).  Non-integer indices
    raise ``TypeError``.  Rows reach serving straight from requests, so no
    index may leave the table."""
    if rows.dtype not in _INT_DTYPES:
        raise TypeError(f"gather rows must be integer, got {rows.dtype}")
    flat = rows.reshape(-1).to(torch.int64)
    return torch.clamp(torch.where(flat < 0, flat + n, flat), 0, n - 1)


def _check(table, scales, chunks):
    chunks = tuple((int(w), int(s)) for w, s in chunks)
    spans, m_data, m = _slot_subrows(chunks)
    N = table.shape[0]
    if table.dtype != torch.int8 or tuple(table.shape) not in ((N, m, LANES), (N, m * LANES)):
        raise ValueError(f"table must be int8 [N, {m}, 128], got {table.dtype} {tuple(table.shape)}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (N, m):
        raise ValueError(f"scales must be float32 [{N}, {m}], got {scales.dtype} {tuple(scales.shape)}")
    if not fused_gather_supported(m_data * LANES, chunks):
        raise ValueError(f"unsupported chunk layout {chunks}")
    return chunks, spans, m


def gather_dequant_plain(table, scales, rows, chunks, out_dtype):
    """Plain PyTorch version: ``(q[rows].float() * scale).to(out_dtype)``
    per chunk, same index semantics as :func:`gather_dequant`."""
    chunks, spans, m = _check(table, scales, chunks)
    N = table.shape[0]
    shape = tuple(rows.shape)
    flat = sanitize_rows(rows.to(table.device), N)
    q = table.reshape(N, m, LANES)[flat]  # [R, m, 128]
    s = scales[flat]
    return tuple((q[:, lo:hi].to(torch.float32) * s[:, lo:hi, None]).to(out_dtype)
                 .reshape(shape + (w,))
                 for (lo, hi), (w, _) in zip(spans, chunks))


def out_plan(R: int, chunks):
    """The one output buffer of a call: ``(numel, views)``, ``views[k] =
    (offset, width)`` in elements, chunk k's ``[R, width]`` block at
    ``offset``.  The blocks follow one another in chunk order, so chunk k
    starts at ``R * 128 * lo_k`` (its first sub-row): a multiple of 128
    elements, 256 bytes in bf16 and 512 in float32."""
    views, offset = [], 0
    for width, _ in chunks:
        views.append((offset, width))
        offset += R * width
    return offset, tuple(views)


def out_views(buf, shape, chunks) -> tuple:
    """Chunk k's output ``shape + (width_k,)``, a contiguous view of the
    buffer ``buf`` that :func:`out_plan` sized for ``R = prod(shape)`` rows."""
    R = int(np.prod(shape, dtype=np.int64))
    return tuple(buf[o:o + R * w].view(tuple(shape) + (w,)) for o, w in out_plan(R, chunks)[1])


@functools.lru_cache(maxsize=None)
def _layout_args(chunks) -> tuple:
    """The kernel's layout arguments for ``chunks``, built once a layout:
    ``(m, n_chunks, lo0, hi0, ..., lo3, hi3)``."""
    spans, _, m = _slot_subrows(chunks)
    spans = tuple(spans) + ((0, 0),) * (MAX_CHUNKS - len(spans))
    return (m, len(chunks)) + tuple(x for span in spans for x in span)


def gather_dequant(table, scales, rows, chunks, out_dtype):
    """Gather ``rows`` (any shape) out of the packed int8 ``table`` and
    dequantize: returns one ``rows.shape + (width,)`` tensor per chunk,
    bit-equal to :func:`gather_dequant_plain`.  Negative indices wrap once,
    the rest clamp; R=0 gives empty outputs; non-integer rows raise
    ``TypeError``.  On the card the kernel checks the indices itself: int32
    and int64 rows go in as they are (other integer types as int64), and the
    outputs are views of one buffer."""
    global launches
    if not table.is_cuda:
        return gather_dequant_plain(table, scales, rows, chunks, out_dtype)
    chunks = _check(table, scales, chunks)[0]
    if rows.dtype not in _INT_DTYPES:
        raise TypeError(f"gather rows must be integer, got {rows.dtype}")
    if not (scales.is_cuda and scales.device == table.device):
        raise ValueError("scales must be on the table's CUDA device")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if len(chunks) > MAX_CHUNKS:
        raise ValueError(f"at most {MAX_CHUNKS} chunks, got {len(chunks)}")
    if not (table.is_contiguous() and scales.is_contiguous()):
        raise ValueError("table and scales must be contiguous")
    if table.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("table and scales must be 16-byte aligned (the kernel's bulk copies)")
    shape = tuple(rows.shape)
    flat = rows.to(table.device).reshape(-1)
    if flat.dtype not in (torch.int32, torch.int64):
        flat = flat.to(torch.int64)
    flat = flat.contiguous()
    R = flat.numel()
    if R > 2**31 - 1:
        raise ValueError(f"gather_dequant takes at most 2**31 - 1 rows a call, got {R}")
    buf = torch.empty(out_plan(R, chunks)[0], dtype=out_dtype, device=table.device)
    if R:
        from drin_tpu_torch.ops.cuda import _build

        if buf.data_ptr() % 16:
            raise ValueError("the output buffer must be 16-byte aligned")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib, fn = _build.entry("gather_dequant", "drin_gather_dequant",
                               [P, P, P, I, ctypes.c_longlong, I]
                               + [I] * (3 + 2 * MAX_CHUNKS) + [P, P])
        status = fn(table.data_ptr(), scales.data_ptr(), flat.data_ptr(),
                    int(flat.dtype == torch.int64), table.shape[0], R, _DTYPE_CODE[out_dtype],
                    *_layout_args(chunks), buf.data_ptr(), _build.stream_of(table))
        _build.check(status, lib, "gather_dequant launch")
        launches += 1
    return out_views(buf, shape, chunks)
