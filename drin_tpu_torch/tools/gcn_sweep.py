# -*- coding: utf-8 -*-
"""Time the bf16 GCN-layer kernel (kernel 1) and the vertex update (kernel 4)
on the card, variant against variant and old sources against new.

Run by hand on a machine with an H100 and ``nvcc``; no entry point imports
it::

    python -m drin_tpu_torch.tools.gcn_sweep --variants ";STAGES=3;PROJ_COLS=256" \\
        --old-csrc old/drin_tpu_torch/csrc

Each ``--variants`` entry is one build of ``csrc/gcn_layer.cu`` with
``-DDRIN_GCN_<KEY>=<value>`` for every pair: ``STAGES``, the most K-slices
in the TMA ring (as many as fit in shared memory, up to this), and
``PROJ_COLS``, the output columns of one block of the edge fold's launches
A1 and A2 (128 or 256).  An empty entry is the configuration compiled into
the shipped source.  ``--old-csrc`` names another commit's ``csrc`` (unpacked
beside), built as it is and called through that commit's C interface
(``drin_gcn_layer``, the mention updates finished in torch as its wrapper
did), in the same process.

Every build is first held against the plain versions at the main shape
(B=64, C=101, D=768, dynamic edges), then timed there: the layer call and
the vertex update with CUDA events (median of 20; this holds the host's time
to reach the launches), their device time by kernel from torch.profiler,
and each ``gcn_rows_bf16`` instantiation's registers, spills and shared
memory from the build's ``-Xptxas -v`` log.
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


def _inputs(B, C, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda *s: torch.rand(*s, generator=g, device="cuda")
    w = lambda *s: ((u(*s) * 2 - 1) * D ** -0.5).bfloat16()
    vertexes = [r(B, D).bfloat16(), r(B, D).bfloat16(), r(B, C, D).bfloat16(), r(B, C, D).bfloat16()]
    edges = [u(B, C).bfloat16() for _ in range(4)]
    weights = [w(D, D), w(D), (1 + 0.1 * r(D)).bfloat16(), (0.1 * r(D)).bfloat16(),
               w(D, D), w(D), w(D, D), w(D)]
    return vertexes, edges, weights


def _old_layer(lib):
    """The layer through an older source's C interface (``drin_gcn_layer``:
    launches A and B, the two mention updates finished in torch)."""
    fn = lib.drin_gcn_layer
    P, I = ctypes.c_void_p, ctypes.c_int
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
        status = fn(1, B, C, D, 1e-5, 0, 3, 1, *(t.data_ptr() for t in vertexes + edges),
                    *(t.data_ptr() for t in weights), *(t.data_ptr() for t in ws), et_o.data_ptr(),
                    ei_o.data_ptr(), *(t.data_ptr() for t in new_edges), msg.data_ptr(),
                    _build.stream_of(et))
        _build.check(status, lib, "old gcn_layer launch")
        new_mt, new_mi = gcn._mention_updates(mt, mi, (msg[:, 0, 0] + msg[:, 1, 0]) / C,
                                              (msg[:, 0, 1] + msg[:, 1, 1]) / C, *weights[:4],
                                              1e-5, "gelu")
        return [new_mt, new_mi, et_o, ei_o], new_edges

    return layer


def _report(path: Path) -> str:
    """Registers, spills, shared memory and serialised wgmma per bf16 kernel."""
    lines = path.with_suffix(".log").read_text().splitlines()
    out = []
    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "drin_gcn_rows_smem"):  # dynamic shared memory: ptxas reports only the static
        out.append("dynamic shared memory: " + ", ".join(
            f"{cols} columns {lib.drin_gcn_rows_smem(cols)} B" for cols in (768, 128, 256)
            if lib.drin_gcn_rows_smem(cols) > 0)
            + f"; blocks per SM at 768 columns {lib.drin_gcn_rows_blocks_per_sm(768)}")
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m or not any(k in m.group(1) for k in ("gcn_rows_bf16", "entity_update", "vertex_update",
                                                       "proj_a", "proj_p")):
            continue
        name = m.group(1)
        short = re.search(r"(gcn_rows_bf16ILi\d+ELi\d+|entity_update_kernelI\w{1,20}|vertex_update_kernelI\w{1,20}"
                          r"|proj_a_kernelI\w{1,16}|proj_p_kernelI\w{1,16})", name)
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
    vertexes, edges, weights = _inputs(B, C, D, seed=3)
    vargs = [vertexes[2], edges[0], vertexes[0], edges[2], vertexes[1], *weights[:4]]
    with torch.inference_mode():
        want = gcn.gcn_layer_plain(vertexes, edges, *weights)
        want_vu = vu.vertex_update_plain(*vargs)
        rows = [vertexes[2].view(-1, D), vertexes[3].view(-1, D), torch.cat(vertexes[:2])]
        product = lambda: [torch.nn.functional.linear(x, weights[0]) for x in rows]
        print(f"B={B} C={C} D={D} bf16, dynamic edges; cuBLAS x.W_h^T alone (a yardstick): "
              f"{_ms(product):.4f} ms, {_device(product)}")
    for label, path in zip(labels, paths):
        lib = ctypes.CDLL(str(path))
        _build._libs["gcn_layer"] = lib
        layer = _old_layer(lib) if label.startswith("old:") else gcn.fused_gcn_layer
        with torch.inference_mode():
            got_v, got_e = layer(vertexes, edges, *weights)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got_v + got_e, want[0] + want[1]))
            err_vu = (vu.fused_vertex_update(*vargs).float() - want_vu.float()).abs().max().item()
            call = lambda: layer(vertexes, edges, *weights)
            ms, dev = _ms(call), _device(call)
            call_vu = lambda: vu.fused_vertex_update(*vargs)
            ms_vu, dev_vu = _ms(call_vu), _device(call_vu)
        print(f"{label}\n  layer: {ms:.4f} ms, {dev} | max err vs plain {err:.3g}"
              f"\n  vertex update: {ms_vu:.4f} ms, {dev_vu} | max err vs plain {err_vu:.3g}"
              f"\n    {_report(path)}")


if __name__ == "__main__":
    main()
