# -*- coding: utf-8 -*-
"""The native (C++) host runtime: the port's copy of ``drin_tpu/native``,
loaded with ``ctypes``.

  * ``src/wordpiece.cpp``: the WordPiece tokenizer, a BasicTokenizer pass
    driven by a BMP classification table built in Python from
    ``unicodedata``, fused with the greedy longest-match WordPiece.
  * ``src/gather.cpp``: the threaded feature-table row gather behind
    :func:`gather_rows` (``create_datasets``' table reads).
  * ``src/tsan_stress.cpp``: a ThreadSanitizer stress harness over both,
    which the tests build into ``build/`` and run.

The sources are the JAX package's, byte for byte.  The library is built
from the first two with the host's C++ compiler (``c++``, or ``$CXX``) at
first use, never at import, into ``<repo>/build/drin_tpu_torch/`` under a
name keyed by a hash of the sources and flags; the compiler writes a file of
its own and renames it into place, so processes that build at once never
load half a library.  A failed build, load or gather call raises with the
compiler's output or the call's status: nothing falls back to Python or
numpy because native code failed.  Per text, the Python path still takes
what the native pass cannot express (astral code points, characters the
cleaner removes, lone surrogates), and per gather numpy still takes small,
non-integer and out-of-range rows: that is the semantics, the same result
either way.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "wordpiece.cpp"
GATHER_SRC = SRC.parent / "gather.cpp"
TSAN_SRC = SRC.parent / "tsan_stress.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "drin_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {  # symbol -> (argtypes, restype)
    # src, dst, row indices, n rows, row bytes, n threads
    "drin_gather_rows": ([ctypes.c_void_p, ctypes.c_void_p, _P32, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int32], ctypes.c_int32),
    "drin_wp_build": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32], ctypes.c_void_p),
    "drin_wp_free": ([ctypes.c_void_p], None),
    # vocab handle, concatenated utf-8 words, word byte offsets [n+1], n words,
    # unk id, out ids, out capacity, out per-word cumulative ends
    "drin_wp_tokenize": ([ctypes.c_void_p, ctypes.c_char_p, _P64, ctypes.c_int64, ctypes.c_int32,
                          _P32, ctypes.c_int64, _P64], ctypes.c_int64),
    # vocab handle, BMP flags [65536], concatenated utf-8 texts, text byte
    # offsets [n+1], n texts, unk id, out ids, out capacity, per-text ends
    "drin_bert_encode_batch": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, _P64,
                                ctypes.c_int64, ctypes.c_int32, _P32, ctypes.c_int64, _P64],
                               ctypes.c_int64),
}


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX or put c++ on PATH): the native "
                       "library is built from drin_tpu_torch/native/src at first use")


def _key(flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(src: Path = SRC) -> Path:
    """Where the library of the tokenizer source ``src`` and the gather is
    (or will be) built."""
    return BUILD_DIR / f"libdrin_native-{_key(FLAGS, (src, GATHER_SRC))}.so"


def _compile(flags, out: Path, sources, what: str) -> Path:
    """Compile ``sources`` with ``flags`` into ``out`` unless it exists; the
    compiler writes a file of its own, renamed into place."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {what} failed: {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build(src: Path = SRC) -> Path:
    """Compile the tokenizer source ``src`` with the gather into one library
    unless a library of the same sources exists; raises with the compiler's
    output when the build fails."""
    return _compile(FLAGS, library_path(src), (src, GATHER_SRC), "the native tokenizer")


TSAN_FLAGS = ("-O1", "-g", "-std=c++17", "-fsanitize=thread", "-pthread")


def build_tsan_stress() -> Path:
    """The ThreadSanitizer stress binary of ``src/tsan_stress.cpp`` over the
    gather and the tokenizer (``drin_tpu/native/Makefile``'s
    ``tsan_stress``), built into ``build/``; raises with the compiler's
    output where it cannot be built."""
    sources = (GATHER_SRC, SRC, TSAN_SRC)
    out = BUILD_DIR / f"tsan_stress-{_key(TSAN_FLAGS, sources)}"
    return _compile(TSAN_FLAGS, out, sources, "the ThreadSanitizer stress binary")


def load() -> ctypes.CDLL:
    """The loaded library, built on first call, with every entry point's
    ``argtypes`` and ``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def vocab_buffer(vocab: dict) -> Optional[bytes]:
    """'\\n'-joined tokens in id order for ``drin_wp_build``, or None when the
    vocab cannot be expressed so: ids not exactly 0..n-1, or a token holding
    a newline (it would split into two native entries and shift every later
    id).  Such a vocab takes the Python path."""
    n = len(vocab)
    by_id = [None] * n
    for tok, i in vocab.items():
        if not (0 <= i < n) or by_id[i] is not None or "\n" in tok:
            return None
        by_id[i] = tok
    return "\n".join(by_id).encode("utf-8")


@functools.lru_cache(maxsize=1)
def bmp_flags() -> bytes:
    """BMP classification table for the native BasicTokenizer pass, built
    once per process from the Python tokenizer's own predicates (flags:
    1 whitespace, 4 punctuation, 8 CJK, 16 removed by the cleaner)."""
    from drin_tpu_torch.text.wordpiece import (_is_chinese_char, _is_control,
                                               _is_punctuation, _is_whitespace)

    flags = bytearray(0x10000)
    for cp in range(0x10000):
        ch = chr(cp)
        f = 0
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            f = 16
        elif _is_whitespace(ch):
            f = 1
        elif _is_chinese_char(cp):
            f = 8
        elif _is_punctuation(ch):
            f = 4
        flags[cp] = f
    return bytes(flags)


def _offsets(blobs) -> np.ndarray:
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return offsets


class _Vocab:
    """A native vocab handle, freed when the object is collected."""

    def __init__(self, buffer: bytes, unk_id: int, max_chars: int = 100):
        self._lib = load()
        self._handle = self._lib.drin_wp_build(buffer, len(buffer), max_chars)
        if not self._handle:
            raise MemoryError("the native tokenizer could not allocate its vocab")
        self._unk = int(unk_id)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.drin_wp_free(self._handle)


class WordPieceNative(_Vocab):
    """Greedy longest-match WordPiece over pre-split words, in one foreign
    call (which releases the interpreter lock)."""

    def tokenize_ids(self, words) -> list:
        """Vocab ids of the concatenation of WordPiece(word) over ``words``."""
        if not words:
            return []
        enc = [w.encode("utf-8") for w in words]
        offsets = _offsets(enc)
        cap = int(max(offsets[-1], len(enc))) + 8  # ids never outnumber input bytes
        out = np.empty(cap, np.int32)
        ends = np.empty(len(enc), np.int64)
        total = self._lib.drin_wp_tokenize(
            self._handle, b"".join(enc), offsets.ctypes.data_as(_P64), len(enc), self._unk,
            out.ctypes.data_as(_P32), cap, ends.ctypes.data_as(_P64))
        if total < 0:
            raise RuntimeError("native wordpiece output overflow (capacity)")
        return out[:total].tolist()


class BertEncodeNative(_Vocab):
    """BasicTokenizer + WordPiece from raw text to vocab ids, for many texts
    in one foreign call (bert-base-cased semantics: no lowercasing)."""

    def __init__(self, buffer: bytes, unk_id: int, max_chars: int = 100):
        super().__init__(buffer, unk_id, max_chars)
        self._flags = bmp_flags()

    def encode_ids_batch(self, texts) -> list:
        """Per text its id list, or None where the native pass cannot
        express the text (astral code points, characters the cleaner
        removes, lone surrogates): the caller encodes just those in
        Python."""
        n = len(texts)
        if n == 0:
            return []
        blobs, skip = [], [False] * n
        for i, t in enumerate(texts):
            try:
                b = t.encode("utf-8")
            except UnicodeEncodeError:  # lone surrogates
                b, skip[i] = b"", True
            if b and max(b) >= 0xF0:  # a 4-byte sequence: outside the BMP table
                b, skip[i] = b"", True
            blobs.append(b)
        offsets = _offsets(blobs)
        cap = int(offsets[-1]) + 8
        out = np.empty(cap, np.int32)
        ends = np.empty(n, np.int64)
        total = self._lib.drin_bert_encode_batch(
            self._handle, self._flags, b"".join(blobs), offsets.ctypes.data_as(_P64), n,
            self._unk, out.ctypes.data_as(_P32), cap, ends.ctypes.data_as(_P64))
        if total < 0:
            raise RuntimeError("native tokenizer output overflow (capacity)")
        res, prev = [], 0
        for i in range(n):
            if skip[i] or ends[i] < 0:
                res.append(None)
            else:
                res.append(out[prev:int(ends[i])].tolist())
                prev = int(ends[i])
        return res


def gather_rows(table: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``table[rows]`` for ``rows`` of any shape: ``rows.shape +
    table.shape[1:]``, contiguous.  Rows of 256 bytes or more, gathered 64 or
    more at a time from a C-contiguous ndarray (an mmap'd store included) by
    in-range integer indices, take the threaded native copy; the rest is
    numpy indexing, which gives the same rows and raises or wraps as numpy
    does (negative, out-of-range, boolean or float indices).  A native call
    that fails raises."""
    rows = np.asarray(rows)
    flat = rows.reshape(-1)
    row_nbytes = int(np.prod(table.shape[1:])) * table.dtype.itemsize
    native = (isinstance(table, np.ndarray) and np.issubdtype(flat.dtype, np.integer)
              and table.flags["C_CONTIGUOUS"] and row_nbytes >= 256 and flat.size >= 64
              and int(flat.min()) >= 0 and int(flat.max()) < table.shape[0]
              and int(flat.max()) <= np.iinfo(np.int32).max)
    if not native:
        return np.ascontiguousarray(table[rows])
    idx = np.ascontiguousarray(flat, dtype=np.int32)
    out = np.empty((idx.size,) + table.shape[1:], dtype=table.dtype)
    status = load().drin_gather_rows(table.ctypes.data_as(ctypes.c_void_p),
                                     out.ctypes.data_as(ctypes.c_void_p),
                                     idx.ctypes.data_as(_P32), idx.size, row_nbytes,
                                     min(8, os.cpu_count() or 1))
    if status != 0:
        raise RuntimeError(f"the native row gather failed (status {status})")
    return out.reshape(rows.shape + table.shape[1:])
