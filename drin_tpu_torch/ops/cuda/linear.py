# -*- coding: utf-8 -*-
"""Float32 linear with a fused epilogue: BERT's four products a layer.

Kernel: ``csrc/linear_f32.cu``, CUDA C++ for ``sm_90a``.  It replaces no
Pallas kernel (the JAX package leaves these products to XLA); the source
says what bounds it and how it is built.  For float32 ``x [..., K]`` and one
weight ``W [N, K]``, or several of one size stacked by rows (the query, key
and value of a layer in one product)::

    y = epilogue(x . W^T + b)       epilogue: none | exact-erf gelu | + residual

every product on the tensor cores in split-precision TF32: each operand
split into a TF32 high part and a TF32 remainder, the product taken as
lo.hi + hi.lo + hi.hi in float32 (lo.lo, 2^-22 of a product, dropped), the
tensor cores' sums moved into a second float32 sum every 128 columns of K,
which holds float32 accuracy.  W's split image is written by a small launch
and kept in a :class:`SplitImage` while the weights are unchanged; x is
split in registers.  Several weights give their outputs stacked on a new
first dimension, each contiguous, as the separate products would lay them.

:func:`linear_plain` is the same function in plain PyTorch (``F.linear``
per weight, then the epilogue).  :func:`linear` takes it only for tensors on
the CPU; on a float32 CUDA tensor it launches the kernel or raises.  Where
an input requires grad it is a ``torch.autograd.Function``: the kernel in
the forward (gelu then applied by torch, so that its input is kept) and
plain float32 products in the backward; the JAX package has no kernel here,
so there is no backward kernel to port.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Optional, Sequence

import torch
from torch.nn import functional as F

from drin_tpu_torch.ops.cuda import _build

KERNEL_COLS = 128  # N, and each stacked weight's rows: a multiple of the tile's columns
KERNEL_DEPTH = 32  # K: a multiple of a stage's columns
EPI_BIAS, EPI_GELU, EPI_RESIDUAL = 0, 1, 2
# a 64-column tile's share of a 128-column tile's rate on the H100 (80 against
# 113 TFLOP/s at M = 36,864: it reads W's image for half the products)
NARROW_RATE = 0.7

launches = 0  # product launches (CUDA path only), one a call
splits = 0  # W images built (CUDA path only)

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IMAGE_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P, _P]
_LINEAR_ARGS = [_P, _S, _I, _I, _I, _P, _P, _P, _S, _P, _S, _I, _S, _I, _I, _I, _P]
_plans: dict = {}  # (M, N, device, cols) -> (tile width, blocks)


def linear_plain(x, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 gelu: bool = False, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` with each weight and bias (several: stacked on a new first
    dimension), then the exact-erf gelu or ``residual + y``."""
    ys = [F.linear(x, w, b) for w, b in zip(weights, biases)]
    y = ys[0] if len(ys) == 1 else torch.stack(ys)
    if gelu:
        y = F.gelu(y, approximate="none")
    if residual is not None:
        y = residual + y
    return y


class SplitImage:
    """W's split image for the kernel and the biases side by side, kept while
    the weights and biases it was built from are the same tensors, at the
    same storage and ``_version``: an in-place update (an optimizer step, a
    ``load_state_dict``) or other tensors handed in (``functional_call``)
    build a new one.  A copy of a module starts empty.

    One module's forward may run in several threads at once (the HTTP
    front's, a micro-batcher's flushes in flight): the kept state is one
    tuple, read and replaced whole, and a lock lets one thread build while
    the others wait for its image."""

    __slots__ = ("state", "lock")

    def __init__(self):
        self.state = None  # (key, weak references, image, bias)
        self.lock = threading.Lock()

    def __reduce__(self):  # copies and pickles start empty
        return SplitImage, ()

    @staticmethod
    def _key(tensors) -> tuple:
        # an inference tensor keeps no version (it changes only inside inference mode)
        return tuple((id(t), t.data_ptr(), -1 if t.is_inference() else t._version) for t in tensors)

    @staticmethod
    def _fresh(state, key) -> bool:
        # the same ids of tensors still alive: the same tensors
        return state is not None and state[0] == key and all(r() is not None for r in state[1])

    def get(self, weights, biases, build):
        """(image, bias): the kept ones, or ``build(weights, biases)``'s."""
        global splits
        tensors = (*weights, *biases)
        key, state = self._key(tensors), self.state
        if not self._fresh(state, key):
            with self.lock:
                state = self.state
                if not self._fresh(state, key):
                    self.state = state = None  # free the old image before the new one is made
                    img, bias = build(weights, biases)
                    state = self.state = (key, tuple(map(weakref.ref, tensors)), img, bias)
                    splits += 1
        return state[2], state[3]


def tile_cols(M: int, N: int, sms: int) -> int:
    """Columns of the kernel's 128-row block tile: 128, or 64 where the
    128-column tiles would leave SMs idle for longer than the narrower
    tiles' lower rate costs (rounds of tiles over the SMs, each 64-column
    round NARROW_RATE as fast a column): the mention pass's 1,024 rows at
    N = 768 take 64, every other BERT product 128."""
    rounds = lambda cols: -(-(-(-M // 128) * (N // cols)) // sms)  # noqa: E731
    return 64 if rounds(64) * 64 / NARROW_RATE < rounds(128) * 128 else 128


def _check_weights(weights, biases, device):
    """Refuse weights the kernel does not take; returns (N, K).  Run when an
    image is built: a kept image's tensors were checked then."""
    if not 1 <= len(weights) <= 3 or len(biases) != len(weights):
        raise ValueError(f"one to three weights, each with its bias; got {len(weights)} and "
                         f"{len(biases)}")
    for name, ts, dims in (("weight", weights, 2), ("bias", biases, 1)):
        for t in ts:
            if not t.is_cuda or t.device != device:
                raise ValueError(f"{name} must be on {device}, got {t.device}")
            if t.dtype != torch.float32 or t.ndim != dims or not t.is_contiguous():
                raise ValueError(f"each {name} must be a contiguous float32 tensor of {dims} "
                                 f"dimensions, got {t.dtype} {tuple(t.shape)}")
    if len(biases) == 1 and biases[0].data_ptr() % 8:  # read as float2 (several: a new cat)
        raise ValueError("the bias must start 8-byte aligned")
    K = weights[0].shape[1]
    if K < KERNEL_DEPTH or K % KERNEL_DEPTH:
        raise ValueError(f"the linear kernel takes K a multiple of {KERNEL_DEPTH}, got K={K}")
    for w, b in zip(weights, biases):
        if w.shape != weights[0].shape or b.shape[0] != w.shape[0]:
            raise ValueError(f"the weights must share one shape, each bias its rows: weight "
                             f"{tuple(w.shape)}, bias {tuple(b.shape)}, the first "
                             f"{tuple(weights[0].shape)}")
    if weights[0].shape[0] % KERNEL_COLS:
        raise ValueError(f"the linear kernel takes N a multiple of {KERNEL_COLS} (each stacked "
                         f"weight's), got {weights[0].shape[0]}")
    return weights[0].shape[0] * len(weights), K


def _check_input(x, K, N, n, residual, gelu) -> int:
    """Refuse an input the kernel does not take; returns M."""
    if x.dtype != torch.float32:
        raise ValueError(f"the linear kernel takes float32, got {x.dtype}")
    if x.shape[-1] != K:
        raise ValueError(f"x [..., {x.shape[-1]}] does not fit the weights' K={K}")
    if x.stride(-1) != 1 or x.data_ptr() % 16:
        raise ValueError(f"x needs contiguous rows and a 16-byte aligned start (strides "
                         f"{x.stride()}); call .contiguous() first")
    if x.ndim != 2 and not x.is_contiguous():
        raise ValueError(f"x of {x.ndim} dimensions must be contiguous (strides {x.stride()})")
    if x.ndim == 2 and (x.stride(0) < K or x.stride(0) % 4):
        raise ValueError(f"x's rows must lie a multiple of 16 bytes apart (strides {x.stride()})")
    M = x.numel() // K
    if M < 1:
        raise ValueError("x has no rows")
    if gelu and residual is not None:
        raise ValueError("the epilogue takes gelu or a residual, not both")
    if residual is not None:
        if n != 1:
            raise ValueError("a residual takes one weight")
        if not residual.is_cuda or residual.device != x.device or residual.dtype != torch.float32:
            raise ValueError(f"residual must be float32 on {x.device}")
        if tuple(residual.shape) != tuple(x.shape[:-1]) + (N,) or not residual.is_contiguous():
            raise ValueError(f"residual must be a contiguous {list(x.shape[:-1]) + [N]}, got "
                             f"{tuple(residual.shape)}")
        if residual.data_ptr() % 8:  # read as float2
            raise ValueError("the residual must start 8-byte aligned")
    return M


def _image(weights, biases):
    """W's split image (and the biases side by side) on the weights' device."""
    _check_weights(weights, biases, weights[0].device)
    w = list(weights) + [None] * (3 - len(weights))
    rows = [t.shape[0] if t is not None else 0 for t in w]
    K = weights[0].shape[1]
    img = torch.empty(2 * sum(rows) * K, dtype=torch.float32, device=weights[0].device)
    lib, fn = _build.entry("linear_f32", "drin_linear_image_f32", _IMAGE_ARGS)
    status = fn(*(t.data_ptr() if t is not None else None for t in w), *rows, K, img.data_ptr(),
                _build.stream_of(weights[0]))
    _build.check(status, lib, "linear image launch")
    bias = biases[0] if len(biases) == 1 else torch.cat(list(biases))
    return img, bias


def _prepare(x, weights, biases, residual, gelu, image):
    """(image, bias, M, N, K) of a launch: x and the residual checked, then
    the kept image, or a new one built from the checked weights."""
    if x.get_device() != weights[0].get_device():
        raise ValueError(f"x must be on {weights[0].device}, got {x.device}")
    K = weights[0].shape[-1]
    N = weights[0].shape[0] * len(weights)
    M = _check_input(x, K, N, len(weights), residual, gelu)
    img, bias = (image or SplitImage()).get(weights, biases, _image)
    return img, bias, M, N, K


def _launch(x, img, bias, M, N, K, n, epi, residual=None, lib_fn=None, cols=None) -> torch.Tensor:
    """One launch of the product over ``n`` stacked weights; ``lib_fn``
    another build's (library, entry), ``cols`` a tile width other than
    :func:`tile_cols`'s."""
    global launches
    seg = N // n
    lead = tuple(x.shape[:-1])
    y = torch.empty((n, *lead, seg) if n > 1 else (*lead, N), dtype=torch.float32, device=x.device)
    dev = x.get_device()
    plan = _plans.get((M, N, dev, cols))
    if plan is None:  # (tile width, persistent blocks), once a shape
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        width = cols or tile_cols(M, N, sms)
        plan = _plans[M, N, dev, cols] = (width, min(sms, -(-M // 128) * (N // width)))
    lib, fn = lib_fn or _build.entry("linear_f32", "drin_linear_f32", _LINEAR_ARGS)
    status = fn(x.data_ptr(), x.stride(0) if x.ndim == 2 else K, M, N, K, img.data_ptr(),
                bias.data_ptr(), residual.data_ptr() if residual is not None else None, N,
                y.data_ptr(), seg, seg, M * seg, epi, *plan, _build.stream_of(x))
    _build.check(status, lib, "linear launch")
    launches += 1
    return y


class _Linear(torch.autograd.Function):
    """The kernel forward (bias, or bias and residual; gelu by torch on its
    output, which is kept), plain float32 products backward."""

    @staticmethod
    def forward(ctx, x, residual, gelu, image, n, *wb):
        weights, biases = wb[:n], wb[n:]
        img, bias, M, N, K = _prepare(x, weights, biases, residual, gelu, image)
        z = _launch(x, img, bias, M, N, K, n, EPI_RESIDUAL if residual is not None else EPI_BIAS,
                    residual)
        ctx.gelu, ctx.n, ctx.has_res = gelu, n, residual is not None
        ctx.save_for_backward(x, z if gelu else None, *weights)
        return F.gelu(z, approximate="none") if gelu else z

    @staticmethod
    def backward(ctx, dy):
        x, z, *weights = ctx.saved_tensors
        g = torch.ops.aten.gelu_backward(dy, z, approximate="none") if ctx.gelu else dy
        K, n = x.shape[-1], ctx.n
        x2 = x.reshape(-1, K)
        parts = g.reshape(n, -1, g.shape[-1]).unbind(0) if n > 1 else (g.reshape(-1, g.shape[-1]),)
        need = ctx.needs_input_grad
        dx = None
        if need[0]:
            dx = sum(p @ w for p, w in zip(parts, weights)).reshape(x.shape)
        dws = [p.t() @ x2 if need[5 + i] else None for i, p in enumerate(parts)]
        dbs = [p.sum(0) if need[5 + n + i] else None for i, p in enumerate(parts)]
        dres = dy if ctx.has_res and need[1] else None
        return (dx, dres, None, None, None, *dws, *dbs)


def linear(x, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor], *,
           gelu: bool = False, residual: Optional[torch.Tensor] = None,
           image: Optional[SplitImage] = None) -> torch.Tensor:
    """``epilogue(x . W^T + b)`` for x [..., K] and one to three weights of
    one shape [N_i, K] with biases [N_i]: one weight gives [..., N_i],
    several [n, ..., N_i] (each output contiguous).  The epilogue is gelu
    (exact erf), ``residual + y`` (one weight; residual [..., N_i]) or none.
    CPU tensors: :func:`linear_plain`.  CUDA: float32 only, K a multiple of
    32, N_i of 128, x's rows contiguous; W's split image is kept in
    ``image`` (a fresh one a call without it).  Differentiable in x, the
    residual, the weights and the biases."""
    if not x.is_cuda:
        return linear_plain(x, weights, biases, gelu, residual)
    n = len(weights)
    if torch.is_grad_enabled() and (x.requires_grad or (residual is not None and residual.requires_grad)
                                    or any(t.requires_grad for t in (*weights, *biases))):
        return _Linear.apply(x, residual, gelu, image, n, *weights, *biases)
    img, bias, M, N, K = _prepare(x, weights, biases, residual, gelu, image)
    epi = EPI_GELU if gelu else EPI_RESIDUAL if residual is not None else EPI_BIAS
    return _launch(x, img, bias, M, N, K, n, epi, residual)
