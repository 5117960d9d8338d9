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
KERNELS = ("gather_dequant", "gcn_layer", "attention")  # csrc/<name>.cu
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


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, out: Path) -> None:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    nvcc_seconds[name] = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(names=KERNELS) -> list:
    """Compile ``csrc/<name>.cu`` for every name whose library is missing:
    one ``nvcc`` process per source, all started together.  Each process's
    own time lands in ``nvcc_seconds``."""
    outs = [library_path(name) for name in names]
    missing = [(name, out) for name, out in zip(names, outs) if not out.exists()]
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(len(missing)) as pool:
            jobs = [pool.submit(_compile, name, out) for name, out in missing]
        failed = [str(job.exception()) for job in jobs if job.exception()]
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


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
    lib = load(name)
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
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
