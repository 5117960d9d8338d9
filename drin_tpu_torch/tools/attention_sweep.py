# -*- coding: utf-8 -*-
"""Sweep the tile configurations of the fused attention kernels on the card.

Run by hand on a machine with an H100 and ``nvcc``; no entry point imports
it::

    python -m drin_tpu_torch.tools.attention_sweep \\
        --fwd ";STAGES=3;WG=4,BLOCKS=1;WG=1,BLOCKS=4" \\
        --bwd ";DQ_WG=1,DQ_BLOCKS=3;DQ_STAGES=4;DKV_WG=2,DKV_BLOCKS=1" \\
        --f32 ";STAGES=2;WG=1" --old-csrc old/csrc

Each ``--fwd`` entry is one build of ``csrc/attention.cu`` with
``-DDRIN_ATTN_FWD_<KEY>=<value>`` for every pair: the ring's depth
(``STAGES``), the warpgroups per block (``WG``, 64 query rows each) and the
blocks per SM the register budget is cut for (``BLOCKS``).  Each ``--bwd``
entry is one build of ``csrc/attention_bwd.cu`` with
``-DDRIN_ATTN_<KEY>=<value>``: ``DQ_WG``, ``DQ_STAGES`` and ``DQ_BLOCKS`` for
the dq kernel, the same with ``DKV_`` for the dkv kernel.  Each ``--f32``
entry is one build of ``csrc/attention.cu`` with
``-DDRIN_ATTN_F32_<KEY>=<value>`` for the float32 forward (split-precision
TF32): its ring of raw (K, V) tiles (``STAGES``, 2 or 3) and its warpgroups
per block (``WG``, 1 to 3).  ``--f32-bwd`` times the float32 backward (it has
no knobs: an empty entry, and ``--old-csrc`` for another commit's) at the
online train step's [96, 12, 512, 64] and at [4, 12, 512, 64], masked,
beside autograd through F.scaled_dot_product_attention's float32 path.
Tiles are 64 keys
(or queries) throughout: the 128-key forms and the backward with its own rows
held as register fragments were measured slower on the card and left the
sources (PERF.md has their readings).  An empty entry is the configuration compiled
into the shipped sources.  ``--old-csrc`` names a second source directory
(another commit's ``csrc``, unpacked beside), built as it is and timed in the
same process.

Every build is first held against the plain version (masked, ragged L,
one sequence with every key dropped), then timed at the online model's shape
[96, 12, 512, 64] bf16 next to ``F.scaled_dot_product_attention``: with CUDA
events around single calls (median of 20; this holds the host's time to
reach the launch) and with torch.profiler (the kernels' own time), plus the
host's time per call, the blocks that share an SM and the registers from the
build's log.  The forward is also timed at L = 128 .. 512 next to BERT's
written-out product (``matmul``, ``softmax``, ``matmul``), which shows from
which length on the kernel is the faster of the two.  The float32 forward
is timed the same way at BertStage's [64, 12, L, 64] (masked, float32) for
each of ``--lens``, beside F.scaled_dot_product_attention's float32 path and
the written-out float32 product.  The shipped kernel has the winner compiled in;
there is no runtime switch.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from drin_tpu_torch.ops.cuda import _build, attention as attn


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


def _inputs(B, H, L, seed, lens=None, dtype=torch.bfloat16):
    """q, k, v as BERT hands them over (views of [B, L, H * 64]), a prefix mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: torch.randn((B, L, H * 64), generator=g, device="cuda").to(dtype).reshape(
        B, L, H, 64).transpose(1, 2)
    q, k, v, do = mk(), mk(), mk(), mk()
    if lens is None:
        lens = torch.randint(9, L + 1, (B,), generator=g, device="cuda")
        lens[0] = 0
    keep = torch.arange(L, device="cuda")[None] < torch.as_tensor(lens, device="cuda")[:, None]
    mask = torch.zeros((B, L), dtype=dtype, device="cuda").masked_fill(
        ~keep, torch.finfo(dtype).min)
    return q, k, v, do, mask


def _defines(entry: str, prefix: str) -> tuple:
    return tuple(f"{prefix}{pair.strip()}" for pair in entry.split(",") if pair.strip())


def _use(name: str, path: Path) -> None:
    """Make the wrappers launch the library at ``path`` for ``csrc/<name>.cu``."""
    _build._libs[name] = ctypes.CDLL(str(path))


def _report(path: Path, kind: str = "bf16") -> str:
    """Blocks per SM, and registers and spills of the ``kind`` kernels
    (``bf16`` or ``f32``) from the build's ``.log``."""
    lines = path.with_suffix(".log").read_text().splitlines()
    out = []
    lib = ctypes.CDLL(str(path))
    per_sm = "drin_attention_fwd_f32_blocks_per_sm" if kind == "f32" else "drin_attention_fwd_blocks_per_sm"
    if hasattr(lib, per_sm):
        out.append(f"blocks/SM {getattr(lib, per_sm)()}")
    if kind == "bf16" and hasattr(lib, "drin_attention_bwd_blocks_per_sm"):
        out.append("blocks/SM dq, dkv " + ", ".join(str(lib.drin_attention_bwd_blocks_per_sm(i)) for i in (0, 1)))
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kind in line:
            kernel = line.split("attn_")[1].split("E")[0][:14]
            spill = next((s.strip() for s in lines[i:i + 4] if "spill" in s), "")
            used = next((s.split("Used ")[1].split(",")[0] for s in lines[i:i + 5] if "Used" in s), "?")
            out.append(f"{kernel}: {used}, {spill.split(',', 1)[-1].strip()}")
    if any("C7512" in s or "C7510" in s for s in lines):
        out.append("wgmma serialized (see the .log)")
    return "; ".join(out)


def _kernel_times(fn, reps: int = 5) -> dict:
    """Device time in ms per kernel name (shortened) over ``reps`` calls of
    ``fn``, from torch.profiler: without the host's time to reach a launch,
    which an event-timed single call also holds."""
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
            name = e.key.split("(")[0].split("::")[-1].split("<")[0][-24:]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def _device(fn) -> str:
    times = _kernel_times(fn)
    each = ", ".join(f"{k} {v:.4f}" for k, v in times.items()) if len(times) > 1 else ""
    return f"device {sum(times.values()):.4f} ms" + (f" ({each})" if each else "")


def _host_us(fn, n: int = 300) -> float:
    """Host time of one call in microseconds: ``n`` calls back to back at a
    shape whose device time is far below it."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def _max_err(got, want) -> float:
    return max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))


def sweep_forward(variants, lens, batch):
    print("== forward: softmax(q.k^T / 8 + mask).v, bf16")
    shapes = [(batch, 12, 512)] + [(16, 12, L) for L in lens]
    data = {s: _inputs(*s, seed=7) for s in shapes}
    check = _inputs(3, 2, 264, seed=9, lens=[264, 130, 0])
    sdpa = {s: _ms(lambda d=d: F.scaled_dot_product_attention(d[0], d[1], d[2], attn_mask=d[4][:, None, None, :]))
            for s, d in data.items()}
    d = data[shapes[0]]
    print("F.scaled_dot_product_attention " + _device(
        lambda: F.scaled_dot_product_attention(d[0], d[1], d[2], attn_mask=d[4][:, None, None, :])))

    def written_out(q, k, v, mask):
        logits = torch.matmul(q, k.transpose(-1, -2)) / 8 + mask[:, None, None, :]
        return torch.matmul(torch.softmax(logits, dim=-1), v)

    plain = {s: _ms(lambda d=d: written_out(d[0], d[1], d[2], d[4])) for s, d in data.items()}
    print("shape [B, 12, L, 64]: " + ", ".join(f"{s[0]}x{s[2]}" for s in shapes))
    print("F.scaled_dot_product_attention ms: " + ", ".join(f"{sdpa[s]:.4f}" for s in shapes))
    print("written-out product ms:            " + ", ".join(f"{plain[s]:.4f}" for s in shapes))
    for label, path in variants:
        _use("attention", path)
        with torch.inference_mode():
            q, k, v, _, mask = check
            err = _max_err([attn.fused_attention(q, k, v, mask)], [attn.attention_plain(q, k, v, mask)])
            ms = {s: _ms(lambda d=d: attn.fused_attention(d[0], d[1], d[2], d[4])) for s, d in data.items()}
            d = data[shapes[0]]
            dev = _device(lambda: attn.fused_attention(d[0], d[1], d[2], d[4]))
            host = _host_us(lambda: attn.fused_attention(q, k, v, mask))
        faster_from = next((s[2] for s in shapes[1:] if ms[s] <= plain[s]), None)
        print(f"{label:40s} ms: " + ", ".join(f"{ms[s]:.4f}" for s in shapes)
              + f" | {dev} at {shapes[0][0]}x{shapes[0][2]}, host {host:.1f} us a call | max err {err:.3g} | faster than the written-out product from L={faster_from}"
              + f" | {_report(path)}")


def sweep_f32(variants, lens):
    print("== forward, float32: softmax(q.k^T / 8 + mask).v (the split-precision TF32 kernel)")
    f32 = torch.float32
    shapes = [(64, 12, L) for L in sorted(lens, reverse=True)]  # BertStage's chunks of 64
    data = {s: _inputs(*s, seed=7, dtype=f32) for s in shapes}
    check = _inputs(3, 2, 264, seed=9, lens=[264, 130, 0], dtype=f32)
    sdpa = {s: _ms(lambda d=d: F.scaled_dot_product_attention(d[0], d[1], d[2], attn_mask=d[4][:, None, None, :]))
            for s, d in data.items()}

    def written_out(q, k, v, mask):
        logits = torch.matmul(q, k.transpose(-1, -2)) / 8 + mask[:, None, None, :]
        return torch.matmul(torch.softmax(logits, dim=-1), v)

    plain = {s: _ms(lambda d=d: written_out(d[0], d[1], d[2], d[4])) for s, d in data.items()}
    print("shape [B, 12, L, 64]: " + ", ".join(f"{s[0]}x{s[2]}" for s in shapes))
    print("F.scaled_dot_product_attention f32 ms: " + ", ".join(f"{sdpa[s]:.4f}" for s in shapes))
    print("written-out f32 product ms:            " + ", ".join(f"{plain[s]:.4f}" for s in shapes))
    for label, path in variants:
        _use("attention", path)
        with torch.inference_mode():
            q, k, v, _, mask = check
            err = _max_err([attn.fused_attention(q, k, v, mask)], [attn.attention_plain(q, k, v, mask)])
            ms = {s: _ms(lambda d=d: attn.fused_attention(d[0], d[1], d[2], d[4])) for s, d in data.items()}
            d = data[shapes[0]]
            dev = _device(lambda: attn.fused_attention(d[0], d[1], d[2], d[4]))
        print(f"{label:40s} ms: " + ", ".join(f"{ms[s]:.4f}" for s in shapes)
              + f" | {dev} at {shapes[0][0]}x{shapes[0][2]} | max err {err:.3g} | {_report(path, 'f32')}")


def sweep_backward(variants, batch):
    print("== backward: dq, dk, dv (and the two launches without a mask), bf16")
    q, k, v, do, mask = _inputs(batch, 12, 512, seed=7)
    cq, ck, cv, cdo, cmask = _inputs(3, 2, 264, seed=9, lens=[264, 130, 0])
    want = attn.attention_backward_plain(cq, ck, cv, cmask, cdo)[:3]
    for m in (mask, None):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=None if m is None else m[:, None, None, :])
        lib = _ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
        print(f"autograd through F.scaled_dot_product_attention, {'masked' if m is not None else 'no mask'}: "
              f"{lib:.4f} ms")
        del out, leaves
    for label, path in variants:
        _use("attention_bwd", path)
        leaves = [t.detach().requires_grad_(True) for t in (cq, ck, cv)]
        got = torch.autograd.grad(attn.fused_attention(*leaves, cmask), leaves, cdo)
        rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                  for a, b in zip(got, want))
        times = []
        for m in (mask, None):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attn.fused_attention(*leaves, m)
            o, mm, ll = out.grad_fn.saved_tensors[4:7]
            with torch.no_grad():
                times.append(_ms(lambda: attn._launch_backward(q, k, v, m, o, do, mm, ll, False)))
                if m is not None:
                    split = _device(lambda: attn._launch_backward(q, k, v, m, o, do, mm, ll, False))
            del out, leaves, o, mm, ll
        print(f"{label:40s} masked {times[0]:.4f} ms, no mask {times[1]:.4f} ms | max err / max |want| "
              f"{rel:.3g} | {split} | {_report(path)}")


def sweep_f32_backward(variants, batch):
    print("== backward, float32: dq, dk, dv, dmask (the split-precision TF32 kernels)")
    f32 = torch.float32
    shapes = [(batch, 12, 512), (4, 12, 512)]  # the online train step's, and the smoke's case
    data = {s: _inputs(*s, seed=7, dtype=f32) for s in shapes}
    cq, ck, cv, cdo, cmask = _inputs(3, 2, 264, seed=9, lens=[264, 130, 0], dtype=f32)
    want = attn.attention_backward_plain(cq, ck, cv, cmask, cdo)
    sdpa = {}
    for s, (q, k, v, do, mask) in data.items():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask[:, None, None, :])
        sdpa[s] = _device(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    print("shape [B, 12, 512, 64] masked: " + ", ".join(f"{s[0]}x{s[2]}" for s in shapes))
    print("autograd through F.scaled_dot_product_attention f32: " + "; ".join(sdpa[s] for s in shapes))
    for label, path in variants:
        _use("attention_bwd", path)
        leaves = [t.detach().requires_grad_(True) for t in (cq, ck, cv, cmask)]
        got = torch.autograd.grad(attn.fused_attention(*leaves), leaves, cdo)
        rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))
        times = []
        for s, (q, k, v, do, mask) in data.items():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attn.fused_attention(*leaves, mask)
            o, mm, ll = out.grad_fn.saved_tensors[4:7]
            with torch.no_grad():
                call = lambda: attn._launch_backward(q, k, v, mask, o, do, mm, ll, True)
                times.append(f"{_ms(call, reps=10, warmup=2):.4f} ms ({_device(call)})")
            del out, leaves, o, mm, ll
        print(f"{label:40s} {'; '.join(times)} | max err / max |want| {rel:.3g}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fwd", default="", help="';'-separated forward builds, each 'KEY=value,...'")
    ap.add_argument("--bwd", default="", help="';'-separated backward builds")
    ap.add_argument("--f32", default="", help="';'-separated float32 forward builds")
    ap.add_argument("--f32-bwd", default="", help="';'-separated float32 backward builds (the "
                                                  "shipped one, with --old-csrc another commit's)")
    ap.add_argument("--old-csrc", default=None, help="a second csrc directory, built as it is")
    ap.add_argument("--lens", default="128,256,384,512")
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--skip", default="", help="'fwd', 'bwd', 'f32' and/or 'f32-bwd', comma-"
                                               "separated: leave those sweeps out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep needs the card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    sweeps = {"fwd": ("attention", "DRIN_ATTN_FWD_", args.fwd),
              "bwd": ("attention_bwd", "DRIN_ATTN_", args.bwd),
              "f32": ("attention", "DRIN_ATTN_F32_", args.f32),
              "f32-bwd": ("attention_bwd", "DRIN_ATTN_", args.f32_bwd)}
    skip = {x.strip() for x in args.skip.split(",") if x.strip()}
    builds, labels = {}, {}
    for key, (name, prefix, entries) in sweeps.items():
        if key in skip:
            continue
        builds[key] = [(name, _defines(e, prefix), _build.CSRC) for e in entries.split(";")]
        labels[key] = [e.strip() or "as shipped" for e in entries.split(";")]
        if args.old_csrc:
            builds[key].append((name, (), Path(args.old_csrc).resolve()))
            labels[key].append(f"old: {args.old_csrc}")
    paths = iter(_build.build_variants([b for key in builds for b in builds[key]]))
    named = {key: [(label, next(paths)) for label in labels[key]] for key in builds}
    lens = [int(x) for x in args.lens.split(",")]
    if "fwd" in named:
        sweep_forward(named["fwd"], lens, args.batch)
    if "bwd" in named:
        sweep_backward(named["bwd"], args.batch)
    if "f32" in named:
        sweep_f32(named["f32"], lens)
    if "f32-bwd" in named:
        sweep_f32_backward(named["f32-bwd"], args.batch)


if __name__ == "__main__":
    main()
