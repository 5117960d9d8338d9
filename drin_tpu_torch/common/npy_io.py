# -*- coding: utf-8 -*-
"""The feature store's ``.npy`` arrays (the port's copy of
``drin_tpu/common/npy_io.py``): reading and writing one array by name, and
the streaming writer the preprocessing stages write feature arrays through.

Feature arrays can exceed 100 GB, so :class:`NpyWriter` streams items to
disk and back-patches the numpy v1.0 header on close.  Its files are byte
for byte those of the JAX package's writer for the same items."""

from __future__ import annotations

import io
import os
import struct
from typing import Optional, Sequence

import numpy as np

# Fixed-size header region reserved at the start of the file; numpy v1.0
# headers are padded to a multiple of 64, and 128 bytes fits any shape tuple
# the stages produce.
_HEADER_SPACE = 128


def _build_header(dtype: np.dtype, shape: tuple) -> bytes:
    """Serialize a numpy v1.0 header padded to exactly ``_HEADER_SPACE``."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": np.lib.format.dtype_to_descr(dtype), "fortran_order": False, "shape": shape}
    )
    header = buf.getvalue()
    if len(header) > _HEADER_SPACE:
        raise ValueError(f"header too large for reserved space: {len(header)}")
    if len(header) == _HEADER_SPACE:
        return header
    # a numpy that pads to less than 128 bytes: extend the pad AND back-patch
    # the v1.0 HEADER_LEN field (uint16 LE at offset 8), so the reader's data
    # offset (10 + HEADER_LEN) still lands at _HEADER_SPACE instead of loading
    # the pad bytes as data
    header = header[:-1] + b" " * (_HEADER_SPACE - len(header)) + b"\n"
    return header[:8] + struct.pack("<H", _HEADER_SPACE - 10) + header[10:]


class NpyWriter:
    """Append items one at a time to a .npy file without holding the array
    in RAM.  ``close()`` MUST be called (or use as a context manager),
    otherwise the file is unreadable.

    Supports ``append`` (one item), ``extend`` (iterable of items), and
    ``reshape`` with a single ``-1`` dimension.
    """

    def __init__(self, output_fpath: str):
        self.output_fpath = output_fpath
        os.makedirs(os.path.dirname(os.path.abspath(output_fpath)), exist_ok=True)
        self._file = open(output_fpath, "wb")
        self._file.write(b"\n" * _HEADER_SPACE)  # placeholder, patched on close
        self.item_shape: Optional[tuple] = None
        self.item_dtype: Optional[np.dtype] = None
        self.n_items = 0

    def append(self, item: np.ndarray) -> None:
        item = np.asarray(item)
        if not np.issubdtype(item.dtype, np.number):
            raise TypeError(f"only numeric arrays supported, got {item.dtype}")
        if self.item_dtype is None:
            self.item_shape = item.shape
            self.item_dtype = item.dtype
        else:
            if item.shape != self.item_shape:
                raise ValueError(f"item shape {item.shape} != previous {self.item_shape}")
            if item.dtype != self.item_dtype:
                raise ValueError(f"item dtype {item.dtype} != previous {self.item_dtype}")
        self._file.write(item.tobytes(order="C"))
        self.n_items += 1

    def extend(self, items: Sequence[np.ndarray]) -> None:
        for item in items:
            self.append(item)

    @property
    def shape(self) -> tuple:
        return self.item_shape  # type: ignore[return-value]

    def reshape(self, shape: Sequence[int]) -> "NpyWriter":
        """Reinterpret the written data under a new leading shape; one -1 dim
        is inferred."""
        shape = list(shape)
        if shape.count(-1) > 1:
            raise ValueError(f"at most one -1 dim allowed: {shape}")
        total = int(np.prod(self.item_shape)) * self.n_items  # type: ignore[arg-type]
        if -1 in shape:
            known = -int(np.prod(shape))  # prod includes the -1 factor
            if known == 0 or total % known:
                raise ValueError(f"cannot infer -1 in {shape} for {total} elements")
            shape[shape.index(-1)] = total // known
        if int(np.prod(shape)) != total:
            raise ValueError(f"shape {shape} does not match {total} elements")
        self.item_shape = tuple(shape[1:])
        self.n_items = shape[0]
        return self

    def close(self) -> None:
        if self._file.closed:
            return
        if self.item_dtype is None:
            # empty writer: emit a (0,) f32 array so the file stays loadable
            self.item_dtype, self.item_shape = np.dtype(np.float32), ()
        self._file.seek(0)
        self._file.write(_build_header(self.item_dtype, (self.n_items, *self.item_shape)))
        self._file.close()

    def __enter__(self) -> "NpyWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_field(preprocess_dir: str, field: str, split: Optional[str] = None,
               mmap: Optional[str] = None):
    """Load one feature-store array by the ``{field}_{split}.npy`` naming
    contract (underscores in the field name become dashes)."""
    name = field.replace("_", "-") + (f"_{split}" if split else "") + ".npy"
    return np.load(os.path.join(preprocess_dir, name), mmap_mode=mmap)


def save_field(preprocess_dir: str, field: str, value, split: Optional[str] = None) -> str:
    """Write one array under the same naming contract; returns its path."""
    os.makedirs(preprocess_dir, exist_ok=True)
    name = field.replace("_", "-") + (f"_{split}" if split else "") + ".npy"
    path = os.path.join(preprocess_dir, name)
    np.save(path, np.asarray(value))
    return path
