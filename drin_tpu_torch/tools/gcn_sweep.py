# -*- coding: utf-8 -*-
"""Time the GCN-layer kernel (kernel 1) and the vertex update (kernel 4) on
the card, in bf16 or (``--f32``) float32, variant against variant and old
sources against new.

Run by hand on a machine with an H100 and ``nvcc``; no entry point imports
it::

    python -m drin_tpu_torch.tools.gcn_sweep --variants ";STAGES=3;PROJ_COLS=256" \\
        --old-csrc old/drin_tpu_torch/csrc
    python -m drin_tpu_torch.tools.gcn_sweep --f32 --old-csrc old/drin_tpu_torch/csrc

Each ``--variants`` entry is one build of ``csrc/gcn_layer.cu`` with
``-DDRIN_GCN_<KEY>=<value>`` for every pair: ``STAGES``, the most K-slices
in the TMA ring (as many as fit in shared memory, up to this), and
``PROJ_COLS``, the output columns of one block of the edge fold's launches
A1 and A2 (128 or 256).  An empty entry is the configuration compiled into
the shipped source.  ``--old-csrc`` names another commit's ``csrc`` (unpacked
beside), built as it is and called through that commit's C interface, in
the same process: in bf16 ``drin_gcn_layer_bf16`` where it has it (else the
older ``drin_gcn_layer``, the mention updates finished in torch as its
wrapper did); in float32 ``drin_gcn_layer_f32`` and ``drin_vertex_update``
as the plain-FMA kernels took them (no split images; the mention updates in
torch), where the source predates the split-TF32 row kernel.

Every build is first held against the plain versions at the main shape
(B=64, C=101, D=768, dynamic edges), then timed there: the layer call and
the vertex update with CUDA events (median of 20; this holds the host's time
to reach the launches), their device time by kernel from torch.profiler,
and each row-kernel instantiation's registers, spills and shared memory
from the build's ``-Xptxas -v`` log (``gcn_rows_bf16`` / ``gcn_rows_f32``:
mode 3/4 = launches A1/A2, 0 = B, 1 = C, 2 = the vertex update).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import torch

from drin_tpu_torch.ops.cuda import _build, gcn_layer as gcn, vertex_update as vu


def _ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _kernel_times(fn, reps: int = 10) -> dict:
    """Device ms per call of ``fn`` by kernel (names shortened), torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1][:32]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def _device(fn) -> str:
    times = _kernel_times(fn)
    each = ", ".join(f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1]))
    return f"device {sum(times.values()):.4f} ms ({each})"


def _inputs(B, C, D, seed, dt=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda *s: torch.rand(*s, generator=g, device="cuda")
    w = lambda *s: ((u(*s) * 2 - 1) * D ** -0.5).to(dt)
    vertexes = [r(B, D).to(dt), r(B, D).to(dt), r(B, C, D).to(dt), r(B, C, D).to(dt)]
    edges = [u(B, C).to(dt) for _ in range(4)]
    weights = [w(D, D), w(D), (1 + 0.1 * r(D)).to(dt), (0.1 * r(D)).to(dt),
               w(D, D), w(D), w(D, D), w(D)]
    return vertexes, edges, weights


def _old_layer(lib, f32: bool):
    """The layer through an older source's C interface: in bf16 the first
    row-kernel form's ``drin_gcn_layer`` (launches A and B with a dtype code),
    in float32 the plain-FMA ``drin_gcn_layer_f32``; the two mention updates
    finished in torch, as those wrappers did."""
    P, I = ctypes.c_void_p, ctypes.c_int
    if f32:
        fn = lib.drin_gcn_layer_f32
        fn.restype, fn.argtypes = ctypes.c_int, [I, I, I, ctypes.c_float, I, I, I] + [P] * 28
    else:
        fn = lib.drin_gcn_layer
        fn.restype, fn.argtypes = ctypes.c_int, [I, I, I, I, ctypes.c_float, I, I, I] + [P] * 28

    def layer(vertexes, edges, *weights):
        mt, mi, et, ei = vertexes
        B, C, D = et.shape
        dev, dt = et.device, et.dtype
        Bp = -(-B // 16) * 16
        ws = [torch.empty((2, Bp, D), dtype=dt, device=dev),
              torch.empty((2, Bp, -(-D // 64)), dtype=torch.float32, device=dev),
              torch.empty((B, 2, D), dtype=dt, device=dev),
              torch.empty((B, 2), dtype=torch.float32, device=dev)]
        et_o, ei_o = torch.empty_like(et), torch.empty_like(ei)
        new_edges = [torch.empty_like(e) for e in edges]
        msg = torch.empty((B, 2, 2, D), dtype=torch.float32, device=dev)
        status = fn(*(() if f32 else (1,)), B, C, D, 1e-5, 0, 3, 1, *(t.data_ptr() for t in vertexes + edges),
                    *(t.data_ptr() for t in weights), *(t.data_ptr() for t in ws), et_o.data_ptr(),
                    ei_o.data_ptr(), *(t.data_ptr() for t in new_edges), msg.data_ptr(),
                    _build.stream_of(et))
        _build.check(status, lib, "old gcn_layer launch")
        new_mt, new_mi = gcn._mention_updates(mt, mi, (msg[:, 0, 0] + msg[:, 1, 0]) / C,
                                              (msg[:, 0, 1] + msg[:, 1, 1]) / C, *weights[:4],
                                              1e-5, "gelu")
        return [new_mt, new_mi, et_o, ei_o], new_edges

    return layer


def _old_vertex_update(lib):
    """The float32 vertex update through the plain-FMA source's C interface
    (``drin_vertex_update`` without the split image)."""
    fn = lib.drin_vertex_update
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.restype, fn.argtypes = ctypes.c_int, [I, I, I, I, ctypes.c_float, I] + [P] * 11

    def update(*args):
        v = args[0]
        B, C, D = v.shape
        out = torch.empty_like(v)
        status = fn(0, B, C, D, 1e-5, 0, *(t.data_ptr() for t in args), out.data_ptr(), _build.stream_of(v))
        _build.check(status, lib, "old vertex_update launch")
        return out

    return update


def _report(path: Path, f32: bool) -> str:
    """Registers, spills, shared memory and serialised wgmma per kernel of
    the row kernel (and of the plain-FMA kernels of older sources)."""
    lines = path.with_suffix(".log").read_text().splitlines()
    out = []
    lib = ctypes.CDLL(str(path))
    smem = "drin_gcn_rows_f32_smem" if f32 else "drin_gcn_rows_smem"
    per_sm = "drin_gcn_rows_f32_blocks_per_sm" if f32 else "drin_gcn_rows_blocks_per_sm"
    if hasattr(lib, smem):  # dynamic shared memory: ptxas reports only the static
        out.append("dynamic shared memory: " + ", ".join(
            f"{cols} columns {getattr(lib, smem)(cols)} B" for cols in (768, 128, 256)
            if getattr(lib, smem)(cols) > 0)
            + f"; blocks per SM at 768 columns {getattr(lib, per_sm)(768)}")
    kinds = ("gcn_rows_f32", "split_w_f32", "entity_update", "vertex_update", "proj_a", "proj_p") if f32 \
        else ("gcn_rows_bf16",)
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m or not any(k in m.group(1) for k in kinds):
            continue
        name = m.group(1)
        short = re.search(r"(gcn_rows_(?:bf16|f32)ILi\d+ELi\d+ELb\d|split_w_f32|entity_update_kernelI\w{1,20}"
                          r"|vertex_update_kernelI\w{1,20}|proj_a_kernelI\w{1,16}|proj_p_kernelI\w{1,16})", name)
        spill = next((s.strip() for s in lines[i + 1:i + 4] if "spill" in s), "")
        used = next((s.split("Used ")[1].strip() for s in lines[i + 1:i + 5] if "Used" in s), "?")
        serial = any(name in s and ("C7514" in s or "C7510" in s) for s in lines)
        out.append(f"{short.group(1) if short else name[:40]}: {used}; {spill}"
                   + ("; wgmma serialized" if serial else ""))
    return "\n    ".join(out)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _defines(entry: str) -> tuple:
    return tuple(f"DRIN_GCN_{pair.strip()}" for pair in entry.split(",") if pair.strip())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="", help="';'-separated builds, each 'KEY=value,...'")
    ap.add_argument("--old-csrc", default=None, help="another commit's csrc directory, built as it is")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--candidates", type=int, default=101)
    ap.add_argument("--f32", action="store_true",
                    help="the float32 forms (split-precision TF32) instead of bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gcn_sweep needs the card: no CUDA device")
    print(f"card: {_card()}")
    entries = args.variants.split(";")
    builds = [("gcn_layer", _defines(e), _build.CSRC) for e in entries]
    labels = [e.strip() or "as shipped" for e in entries]
    if args.old_csrc:
        builds.append(("gcn_layer", (), Path(args.old_csrc).resolve()))
        labels.append(f"old: {args.old_csrc}")
    paths = _build.build_variants(builds)
    B, C, D = args.batch, args.candidates, 768
    dt = torch.float32 if args.f32 else torch.bfloat16
    vertexes, edges, weights = _inputs(B, C, D, seed=3, dt=dt)
    vargs = [vertexes[2], edges[0], vertexes[0], edges[2], vertexes[1], *weights[:4]]
    with torch.inference_mode():
        want = gcn.gcn_layer_plain(vertexes, edges, *weights)
        want_vu = vu.vertex_update_plain(*vargs)
        rows = [vertexes[2].view(-1, D), vertexes[3].view(-1, D), torch.cat(vertexes[:2])]
        product = lambda: [torch.nn.functional.linear(x, weights[0]) for x in rows]
        print(f"B={B} C={C} D={D} {str(dt)[6:]}, dynamic edges; cuBLAS x.W_h^T alone (a yardstick): "
              f"{_ms(product):.4f} ms, {_device(product)}")
    for label, path in zip(labels, paths):
        lib = ctypes.CDLL(str(path))
        _build._libs["gcn_layer"] = lib
        # a source before the split-TF32 row kernel has no drin_gcn_rows_f32_smem; in bf16 one
        # before the row kernel's four launches has no drin_gcn_layer_bf16
        old = label.startswith("old:") and not hasattr(lib, "drin_gcn_rows_f32_smem" if args.f32
                                                        else "drin_gcn_layer_bf16")
        layer = _old_layer(lib, args.f32) if old else gcn.fused_gcn_layer
        update = _old_vertex_update(lib) if old and args.f32 else vu.fused_vertex_update
        with torch.inference_mode():
            got_v, got_e = layer(vertexes, edges, *weights)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got_v + got_e, want[0] + want[1]))
            err_vu = (update(*vargs).float() - want_vu.float()).abs().max().item()
            call = lambda: layer(vertexes, edges, *weights)
            ms, dev = _ms(call), _device(call)
            call_vu = lambda: update(*vargs)
            ms_vu, dev_vu = _ms(call_vu), _device(call_vu)
        print(f"{label}\n  layer: {ms:.4f} ms, {dev} | max err vs plain {err:.3g}"
              f"\n  vertex update: {ms_vu:.4f} ms, {dev_vu} | max err vs plain {err_vu:.3g}"
              f"\n    {_report(path, args.f32)}")


if __name__ == "__main__":
    main()
