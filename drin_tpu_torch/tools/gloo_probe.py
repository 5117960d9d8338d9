# -*- coding: utf-8 -*-
"""Probe which collectives gloo takes on CUDA tensors, and time two of them.

Two ranks on one card over gloo (which stages CUDA tensors through the
host) try ``reduce_scatter_tensor``, ``reduce``, ``all_reduce`` (a sum,
and the maximum that ``collectives.any_over`` takes of a uint8 tensor),
``broadcast`` and ``all_gather_into_tensor`` on a small tensor in float32,
uint8 and bfloat16, and ``collectives.any_over`` on a bool tensor.  Then a 256 MB uint8 input goes through
``all_reduce``, ``reduce_scatter_tensor`` and the port's
``collectives.reduce_scatter_exact_`` (``reduce`` calls): for each, the host
clock between synchronises and the device memory the call allocates beyond
its input and output (the peak within it above what was allocated before:
a staging copy on the device shows there).  Run by hand from the
repository's root on a machine with a card; no entry point imports it::

    python -m drin_tpu_torch.tools.gloo_probe

It prints the card's name and power limit, then each rank's results as
JSON (``ok`` with the first rows, or ``refused`` with the error).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

CALLS = ("reduce_scatter_tensor", "reduce", "all_reduce", "all_reduce_max", "broadcast",
         "all_gather_into_tensor")
BIG_BYTES = 256 << 20


def _call(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "reduce_scatter_tensor":
        out = x.new_empty((x.shape[0] // 2,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x)
        return out
    if name == "all_gather_into_tensor":
        out = x.new_empty((x.shape[0] * 2,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out
    if name == "reduce":
        dist.reduce(x, dst=0)
    elif name == "all_reduce":
        dist.all_reduce(x)
    elif name == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
    else:
        dist.broadcast(x, 0)
    return x


def worker(rank: int, port: int, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    res = {}
    try:
        for dt in (torch.float32, torch.uint8, torch.bfloat16):
            for name in CALLS:
                x = (torch.arange(24, device=dev).reshape(8, 3) % 7 + rank).to(dt)
                try:
                    torch.cuda.synchronize()
                    y = _call(name, x)
                    torch.cuda.synchronize()
                    res[f"{name}/{dt}"] = ["ok", y.float().cpu().tolist()[:2]]
                except RuntimeError as e:
                    res[f"{name}/{dt}"] = ["refused", f"{type(e).__name__}: {str(e)[:200]}"]
                dist.barrier()
        from drin_tpu_torch.parallel import collectives

        flag = torch.tensor([rank == 0, rank == 1, False], device=dev)
        try:
            res["any_over/torch.bool"] = ["ok", collectives.any_over(flag, None).cpu().tolist()]
        except RuntimeError as e:
            res["any_over/torch.bool"] = ["refused", f"{type(e).__name__}: {str(e)[:200]}"]
        scatter = lambda x: collectives.reduce_scatter_exact_([x], None)[0]
        for name in ("all_reduce", "reduce_scatter_tensor", "reduce_scatter_exact_"):
            big = torch.zeros(BIG_BYTES, dtype=torch.uint8, device=dev)
            fn = scatter if name == "reduce_scatter_exact_" else (lambda x: _call(name, x))
            dist.barrier()
            torch.cuda.synchronize()
            # reduce_scatter_exact_'s result is a view of its input: no output buffer
            out_bytes = BIG_BYTES // 2 if name == "reduce_scatter_tensor" else 0
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            fn(big)
            torch.cuda.synchronize()
            res[f"seconds/{name}/{BIG_BYTES >> 20} MB"] = time.perf_counter() - t
            res[f"extra_device_MB/{name}/{BIG_BYTES >> 20} MB"] = (
                torch.cuda.max_memory_allocated() - before - out_bytes) / 2 ** 20
            del big
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen([sys.executable, "-c", "import sys; from drin_tpu_torch.tools "
                                   "import gloo_probe as g; g.worker(int(sys.argv[1]), "
                                   "int(sys.argv[2]), sys.argv[3])", str(r), str(port), out])
                 for r in range(2)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(codes):
            print(f"gloo_probe: ranks exited {codes}", file=sys.stderr)
            return 1
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                print(f"rank {r}: {json.dumps(json.load(f))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
