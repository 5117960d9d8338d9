# -*- coding: utf-8 -*-
"""Input staging: a request's host arrays copied to the device through one
pinned arena.

:class:`PinnedStager` lays every field of a call out in one byte arena
(offsets aligned to :data:`ALIGN`), fills it chunk by chunk with ATen's CPU
``copy_`` (the intra-op thread pool; a floating field cast to the compute
dtype in the same pass, as ``.to(device, dtype)`` casts it on the host) and
issues each filled chunk's copy to the device at once, asynchronously on
the current stream, so that the device copies chunk i while the host fills
chunk i + 1.  Every call gets a fresh device buffer from the caching
allocator and returns its fields as typed views of it, so two calls never
share device memory; the arena is reused, and the next call waits for the
previous call's copies (one CUDA event) before it writes the arena again.
Every byte of every call is copied: nothing is cached between calls.

On CUDA the arena is pinned (page-locked) host memory, which the card reads
by DMA at the link's rate, where a pageable copy goes through the CUDA
runtime's own bounce buffer.  On the CPU the same packing runs with an ordinary
arena, so that the CPU tests hold it; the copies are then plain copies.

Tensors already on the target device, or on another device than the host,
are not staged: they go through ``.to(device, dtype)``, as before.

Counters (module-level, in the style of ``ops/cuda/*.launches``): ``calls``
staged, ``bytes`` copied through the arena (the fields' bytes, padding
left out), ``passthrough`` fields not staged, ``waits`` calls that found the
previous call's copies still in flight, ``grows`` arena allocations.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# A field's offset in the arena and on the device: a multiple of the widest
# element (8 bytes) and of the 256-byte alignment the caching allocator
# gives a fresh tensor, so that every view starts where a kernel expects it.
ALIGN = 256
# The largest piece of a field the host fills before it sends what it has
# filled.  Measured on an H100's host (8 cores; tools/staging_sweep.py,
# PERF.md §6) for a 53-MB DRIN request: each ATen copy costs ~70 us
# beyond its bytes, a copy to the device almost nothing, so the pieces are
# large.  Staged and synchronised, 16 MB (two pieces a 25-MB field) took
# 1.63-1.90 ms, against 1.85-2.0 at 4 and 8 MB, 1.68-2.03 at 32 and 2.04-2.50
# at 64 (nothing sent before both large fields are filled); inside the rank
# call, where the last copy overlaps the forward's launches, 16, 32 and 64 MB
# gave the same call time.
CHUNK_BYTES = 16 << 20

calls = 0
bytes = 0  # shadows the builtin, which this module does not use
passthrough = 0
waits = 0
grows = 0
_counters = threading.Lock()  # one stager per Ranker, several Rankers a process


def _host_tensor(x) -> torch.Tensor:
    """A host array or list as a CPU tensor, for reading."""
    a = np.asarray(x)
    if not a.flags.writeable or any(s < 0 for s in a.strides):
        # torch warns on a read-only array and takes no negative strides: a
        # writable copy (one more host copy, for such inputs alone)
        a = np.array(a, order="C")
    return torch.from_numpy(a)


def _at(flat: torch.Tensor, aliases: dict, dtype: torch.dtype, off: int, shape) -> torch.Tensor:
    """The contiguous ``shape`` tensor of ``dtype`` at byte ``off`` of the
    byte buffer ``flat``: one ``as_strided`` of the buffer's alias in that
    dtype (made once a call in ``aliases``), where slicing and two views
    would be four ops a field."""
    typed = aliases.get(dtype)
    if typed is None:
        typed = aliases[dtype] = flat.view(dtype)
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= max(d, 1)
    return torch.as_strided(typed, shape, strides[::-1], off // dtype.itemsize)


class PinnedStager:
    """Stages feature fields to ``device`` (see the module docstring).  One
    call at a time: concurrent callers take turns on the arena."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._arena = torch.empty(0, dtype=torch.uint8)
        self._copied = None  # the CUDA event after the last call's copies
        self._lock = threading.Lock()

    def stage(self, fields, dtype: torch.dtype) -> list:
        """Each field on the device: a floating field in ``dtype``, any other
        in its own dtype, as ``t.to(device, dtype)`` / ``t.to(device)``."""
        global calls, bytes, passthrough, waits, grows

        out = [None] * len(fields)
        plan, end, n_pass = [], 0, 0
        for i, x in enumerate(fields):
            if torch.is_tensor(x) and (x.device.type != "cpu" or self.device.type == "cpu"):
                out[i] = x.to(self.device, dtype) if x.is_floating_point() else x.to(self.device)
                n_pass += 1
                continue
            src = x if torch.is_tensor(x) else _host_tensor(x)
            want = dtype if src.is_floating_point() else src.dtype
            off = -(-end // ALIGN) * ALIGN
            end = off + src.numel() * want.itemsize
            plan.append((i, src, want, off))
        size = -(-end // ALIGN) * ALIGN  # whole elements of every dtype, for the aliases
        with self._lock:
            waited = self._wait()
            grew = self._reserve(size)
            if plan:
                buf = torch.empty(size, dtype=torch.uint8, device=self.device)
                self._fill_and_send(plan, buf, end)
                aliases = {}
                for i, src, want, off in plan:
                    out[i] = _at(buf, aliases, want, off, src.shape)
        with _counters:
            calls += 1
            bytes += sum(src.numel() * want.itemsize for _, src, want, _ in plan)
            passthrough += n_pass
            waits += waited
            grows += grew
        return out

    def _wait(self) -> bool:
        """Wait for the previous call's copies out of the arena; whether
        they were still in flight."""
        ev, self._copied = self._copied, None
        if ev is None or ev.query():
            return False
        ev.synchronize()
        return True

    def _reserve(self, n: int) -> bool:
        """Grow the arena to hold ``n`` bytes (at least doubling it), never
        shrinking it; whether it grew."""
        if n <= self._arena.numel():
            return False
        size = max(n, 2 * self._arena.numel())
        with torch.inference_mode(False):  # writable in and out of inference mode
            self._arena = torch.empty(size, dtype=torch.uint8, pin_memory=self._pin)
        return True

    def _fill_and_send(self, plan: list, buf: torch.Tensor, end: int) -> None:
        """Fill the arena field by field, a field larger than CHUNK_BYTES in
        even pieces of whole rows, and send what is filled to ``buf``
        whenever it reaches half of CHUNK_BYTES (small fields go together)."""
        arena, aliases, sent = self._arena, {}, 0
        for _, src, want, off in plan:
            nbytes = src.numel() * want.itemsize
            dst = _at(arena, aliases, want, off, src.shape)
            pieces = -(-nbytes // CHUNK_BYTES)
            if pieces <= 1:
                parts = [(dst, src, off + nbytes)]
            else:
                rows = src.shape[0]
                step = -(-rows // pieces)
                parts = [(dst[r:r + step], src[r:r + step], off + min(r + step, rows) * (nbytes // rows))
                         for r in range(0, rows, step)]
            for d, s, filled in parts:
                d.copy_(s)
                if 2 * (filled - sent) >= CHUNK_BYTES:
                    buf[sent:filled].copy_(arena[sent:filled], non_blocking=True)
                    sent = filled
        if sent < end:
            buf[sent:end].copy_(arena[sent:end], non_blocking=True)
        if self._pin:
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(buf.device))
