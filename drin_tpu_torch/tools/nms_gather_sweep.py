# -*- coding: utf-8 -*-
"""Time the NMS kernel and the gather+dequant kernel (kernel 2) on the card,
build against build and old sources against new, in one process.

Run by hand from the repository's root on a machine with an H100 and
``nvcc``; no entry point imports it::

    python -m drin_tpu_torch.tools.nms_gather_sweep --old-csrc old/drin_tpu_torch/csrc \\
        --nms-variants ";CLUSTER_MAX=1" --gather-variants ";BULK_MIN_BYTES=0;BULK_MIN_BYTES=1000000"

Each ``--nms-variants`` entry is one build of ``csrc/nms.cu`` with
``-DDRIN_NMS_<KEY>=<value>`` for every pair (``CLUSTER_MAX``: the most
blocks a problem, 1 for none); each ``--gather-variants`` entry one build
of ``csrc/gather_dequant.cu`` with ``-DDRIN_GATHER_<KEY>=<value>``
(``BULK_MIN_BYTES``: the output bytes of a row from which it is written
back with bulk shared->global copies instead of 16-byte vector stores; 0
for bulk copies at every slab, 1000000 for vector stores).  An empty entry
is the shipped build.  ``--old-csrc`` names
another commit's ``csrc`` (unpacked beside), built as it is and called
through the C interface it had before its kernels took this form: NMS with
its bitmask scratch (``drin_nms(boxes, sorted_scores, order, mask, out,
...)``), the gather with int32 rows checked by ``sanitize_rows`` first and
one output a chunk, as that wrapper did.

Shapes are ``chip_smoke.py``'s: NMS at the detector's RPN call ([8 x 5,
1000] top 1000, and the stage's 64 images) and class call ([8, 4096] top
100, and 64 images); the gather at rows [64, 101] of 32,768 at DRIN's,
offline GHMFC's text-only and text + image slabs, in bf16 and float32.  Every build is first held against the plain version (indices
equal, outputs bit-equal), then timed: CUDA events around the call (median
of 20, with the host's time to reach the launches), device time by kernel
from torch.profiler, and NMS's rise in device memory.  Builds are timed in
two rounds, the second in reverse order (old, new, new, old).

``--nms-phases`` builds ``csrc/nms.cu`` once more with
``-DDRIN_NMS_PROFILE=1`` and prints, for one call at the detector forward's
RPN and class shapes, the cycles thread 0 of each problem's first block
spends between the kernel's barriers, summed over its chunks: staging (and
the first chunk's triangle), the chunk's first barrier (where the other
warps' and blocks' column passes end), the walk, and warp 0's own share of
the column pass and of the next chunk's triangle.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from drin_tpu_torch.ops.cuda import _build, gather, nms

ROOT = Path(__file__).resolve().parents[2]


def _defines(prefix: str, entry: str) -> tuple:
    return tuple(f"DRIN_{prefix}_{pair.strip()}" for pair in entry.split(",") if pair.strip())


def _old_nms(lib):
    """NMS through the bitmask source's C interface: a [P, n, ceil(n / 64)]
    int64 scratch, written by one launch and walked by another."""
    fn = lib.drin_nms
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.restype, fn.argtypes = ctypes.c_int, [P, P, P, P, P, I, I, I, ctypes.c_float, P]

    def call(boxes, scores, thr, top_k):
        b, s, lead = nms._problems(boxes, scores)
        srt, order = torch.sort(s, dim=-1, descending=True, stable=True)
        Pn, n = srt.shape
        out = torch.empty((Pn, top_k), dtype=torch.int64, device=b.device)
        mask = torch.empty((Pn, n, -(-n // 64)), dtype=torch.int64, device=b.device)
        status = fn(b.data_ptr(), srt.data_ptr(), order.data_ptr(), mask.data_ptr(), out.data_ptr(),
                    Pn, n, top_k, float(thr), _build.stream_of(b))
        _build.check(status, lib, "old nms launch")
        return out.reshape(*lead, top_k)

    return call


def _old_gather(lib):
    """The gather through the int32-rows source's C interface: rows checked
    by ``sanitize_rows`` and cast to int32 first, one output a chunk."""
    fn = lib.drin_gather_dequant
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.restype, fn.argtypes = ctypes.c_int, [P, P, P, I, I, I, I] + [I, I, P] * gather.MAX_CHUNKS + [P]

    def call(table, scales, rows, chunks, out_dtype):
        chunks, spans, m = gather._check(table, scales, chunks)
        shape = tuple(rows.shape)
        flat = gather.sanitize_rows(rows, table.shape[0]).to(torch.int32)
        R = flat.numel()
        outs = [torch.empty((R, w), dtype=out_dtype, device=table.device) for w, _ in chunks]
        pad = [(0, 0, None)] * (gather.MAX_CHUNKS - len(chunks))
        spec = [(lo, hi, o.data_ptr()) for (lo, hi), o in zip(spans, outs)] + pad
        status = fn(table.data_ptr(), scales.data_ptr(), flat.data_ptr(), R, m,
                    gather._DTYPE_CODE[out_dtype], len(chunks), *[x for s in spec for x in s],
                    _build.stream_of(table))
        _build.check(status, lib, "old gather_dequant launch")
        return tuple(o.reshape(shape + (w,)) for o, (w, _) in zip(outs, chunks))

    return call


def _short(times: dict) -> str:
    each = {k.replace("(anonymous namespace)::", "").split("(")[0][:40]: round(v, 4)
            for k, v in sorted(times.items(), key=lambda kv: -kv[1])}
    return f"device {sum(times.values()):.4f} ms {each}"


def _mem_rise_mb(call) -> float:
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**20


PHASES = ("staging", "first barrier", "walk", "column pass and next triangle (warp 0)")


def _nms_phases(cases) -> None:
    """One call at each forward shape through a profiling build: cycles by
    phase, averaged over the problems of each RPN level and over the class
    problems."""
    import numpy as np

    path = _build.build_variants([("nms", ("DRIN_NMS_PROFILE=1",), _build.CSRC)])[0]
    lib = ctypes.CDLL(str(path))
    read = lib.drin_nms_phase_cycles
    read.restype, read.argtypes = ctypes.c_int, [ctypes.c_void_p]
    _build._libs["nms"] = lib
    cycles = np.zeros((64, len(PHASES)), np.uint64)
    for cname in ("rpn [8x5, 1000] top 1000", "class [8, 4096] top 100"):
        boxes, scores, thr, k = cases[cname]
        nms.nms_cuda(boxes, scores, thr, k)
        torch.cuda.synchronize()
        _build.check(read(cycles.ctypes.data), lib, "phase cycles")  # read and zero
        nms.nms_cuda(boxes, scores, thr, k)
        torch.cuda.synchronize()
        _build.check(read(cycles.ctypes.data), lib, "phase cycles")
        P = scores.reshape(-1, scores.shape[-1]).shape[0]
        groups = {f"level {lv}": list(range(lv, P, 5)) for lv in range(5)} if cname.startswith("rpn") \
            else {"all": list(range(P))}
        for g, idx in groups.items():
            mean = cycles[idx].astype(np.float64).mean(0)
            each = ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, mean))
            print(f"nms phases | {cname} {g}: total {mean.sum():.0f} cycles ({each})")
    _build._libs.pop("nms")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", default=None, help="another commit's csrc directory, built as it is")
    ap.add_argument("--nms-variants", default="", help="';'-separated builds, each 'KEY=value,...'")
    ap.add_argument("--gather-variants", default="", help="';'-separated builds, each 'KEY=value,...'")
    ap.add_argument("--skip", default="", help="'nms' or 'gather' to time the other alone")
    ap.add_argument("--nms-phases", action="store_true",
                    help="cycles by phase of the shipped NMS kernel, from a -DDRIN_NMS_PROFILE=1 build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nms_gather_sweep needs the card: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    kinds = [k for k in ("nms", "gather") if k not in args.skip.split(",")]
    builds = []  # (kind, label, library name, defines, csrc)
    for kind in kinds:
        name, prefix = ("nms", "NMS") if kind == "nms" else ("gather_dequant", "GATHER")
        for e in getattr(args, f"{kind}_variants").split(";"):
            builds.append((kind, e.strip() or "as shipped", name, _defines(prefix, e), _build.CSRC))
        if args.old_csrc:
            builds.append((kind, f"old: {args.old_csrc}", name, (), Path(args.old_csrc).resolve()))
    paths = _build.build_variants([b[2:] for b in builds])
    libs = [ctypes.CDLL(str(p)) for p in paths]
    for (kind, label, *_), path in zip(builds, paths):
        regs = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{kind} {label}: built {path.name}; ptxas: {' | '.join(regs[:6])}")

    cases = {}
    if "nms" in kinds:
        from drin_tpu_torch.ops.detection import nms_plain

        b, s = cs._rpn_problems(torch, cs.DET_STAGE_BATCH, cs.SEED + 1600)
        cases["rpn [8x5, 1000] top 1000"] = (b[:8], s[:8], 0.7, 1000)
        cases["rpn [64x5, 1000] top 1000"] = (b, s, 0.7, 1000)
        b, s = cs._class_problems(torch, cs.DET_STAGE_BATCH, cs.SEED + 1601)
        cases["class [8, 4096] top 100"] = (b[:8], s[:8], 0.5, 100)
        cases["class [64, 4096] top 100"] = (b, s, 0.5, 100)
        want_nms = {k: nms_plain(*v) for k, v in cases.items()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = torch.randint(0, cs.N_ENTITIES, (64, 101), generator=g, device="cuda", dtype=torch.int32)
    tables = {}
    if "gather" in kinds:
        for lname, chunks in cs.GATHER_LAYOUTS.items():
            _, _, m = gather._slot_subrows(chunks)
            t = torch.randint(-127, 128, (cs.N_ENTITIES, m, 128), generator=g, device="cuda",
                              dtype=torch.int8)
            sc = torch.rand((cs.N_ENTITIES, m), generator=g, device="cuda") * 0.05 + 1e-3
            tables[lname] = (t, sc, chunks)

    if args.nms_phases and "nms" in kinds:
        _nms_phases(cases)
    order = list(range(len(builds)))
    for rnd, seq in enumerate((order, order[::-1])):
        print(f"--- round {rnd + 1}")
        for i in seq:
            kind, label, name = builds[i][:3]
            lib = libs[i]
            _build._libs[name] = lib
            old = label.startswith("old:")
            if kind == "nms":
                call_nms = _old_nms(lib) if old else nms.nms_cuda
                for cname, (boxes, scores, thr, k) in cases.items():
                    call = lambda: call_nms(boxes, scores, thr, k)
                    assert torch.equal(call(), want_nms[cname]), f"{label}: nms != nms_plain at {cname}"
                    print(f"nms {label} | {cname}: {cs.cuda_ms(call):.4f} ms, "
                          f"{_short(cs.kernel_device_ms(torch, call))}, memory rise "
                          f"{_mem_rise_mb(call):.2f} MB")
            else:
                call_g = _old_gather(lib) if old else gather.gather_dequant
                for lname, (t, sc, chunks) in tables.items():
                    for dt in (torch.bfloat16, torch.float32):
                        want = gather.gather_dequant_plain(t, sc, rows, chunks, dt)
                        got = call_g(t, sc, rows, chunks, dt)
                        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                            f"{label}: gather != plain at {lname} {dt}"
                        call = lambda: call_g(t, sc, rows, chunks, dt)
                        print(f"gather {label} | {lname} {str(dt)[6:]}: {cs.cuda_ms(call):.4f} ms, "
                              f"{_short(cs.kernel_device_ms(torch, call))}")


if __name__ == "__main__":
    main()
