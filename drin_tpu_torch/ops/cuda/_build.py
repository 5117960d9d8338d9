# -*- coding: utf-8 -*-
"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The build runs
at the first CUDA use of a kernel, never at import: importing the op modules
needs no ``nvcc``.  Libraries land in ``<repo>/build/drin_tpu_torch/``, named
by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads what is there.  ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills) is kept beside each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "drin_tpu_torch"
KERNELS = ("gather_dequant", "gcn_layer", "attention", "attention_bwd", "nms",
           "ssd_scan", "linear_f32")  # csrc/<name>.cu
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
nvcc_seconds: dict = {}  # name -> wall time of its nvcc process in this interpreter
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path(name: str, defines: tuple = (), csrc: Path = CSRC) -> Path:
    """Where the library for ``<csrc>/<name>.cu`` is (or will be) built;
    ``defines`` are ``-D`` macros (``"NAME=value"``) of a variant build."""
    h = hashlib.sha256(" ".join(FLAGS + tuple(defines)).encode())
    for src in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, out: Path, defines: tuple = (), csrc: Path = CSRC) -> None:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
                           str(csrc / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    nvcc_seconds[name] = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_variants(variants) -> list:
    """Compile ``(name, defines, csrc)`` triples whose libraries are missing:
    one ``nvcc`` process per source, all started together; returns the
    library paths.  Each process's own time lands in ``nvcc_seconds``.  The
    sweep tool's builds (other tile sizes by ``-D``, another source
    directory) come here directly; the entry points go through
    :func:`build_all`."""
    variants = [(name, tuple(defines), Path(csrc)) for name, defines, csrc in variants]
    outs = [library_path(*v) for v in variants]
    todo = {out: v for out, v in zip(outs, variants) if not out.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(len(todo)) as pool:
            jobs = [pool.submit(_compile, name, out, defines, csrc)
                    for out, (name, defines, csrc) in todo.items()]
        failed = [str(job.exception()) for job in jobs if job.exception()]
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def build_all(names=KERNELS) -> list:
    """Compile ``csrc/<name>.cu`` for every name whose library is missing."""
    return build_variants([(name, (), CSRC) for name in names])


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources exists."""
    return build_all((name,))[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes: list):
    """``(library, C function)`` with ``argtypes`` declared and an int
    (``cudaError_t``) result."""
    lib = _libs.get(name) or load(name)  # on every launch's path: no lock once loaded
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib, fn


def check(status: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        fn = lib.drin_cuda_error_string
        fn.restype, fn.argtypes = ctypes.c_char_p, [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {status} ({fn(status).decode()})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # no Stream object built
    if raw is not None and t.device.index is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream
