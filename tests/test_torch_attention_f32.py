# -*- coding: utf-8 -*-
"""Kernel 3's float32 forward in split-precision TF32, its numerics on the
CPU.

The card's float32 forward (``csrc/attention.cu``, ``attn_fwd_f32``) runs
both products on ``wgmma`` with TF32 operands: each operand x is split into
hi = x rounded to TF32 and lo = (x - hi) rounded to TF32 (``cvt.rna``: to
nearest, ties away from zero), and each product is lo.hi + hi.lo + hi.hi in
float32; the softmax is taken in natural units and the sum divided out at
the end.  The CUDA kernel cannot run here, so this file emulates that
arithmetic with plain tensor code (it is on no path of the package) and
holds it against the kernel's plain version and the JAX package's Pallas
kernel (interpret mode) and reference, at the port's float32 tolerance
(rtol 2e-4 / atol 1e-5), with the measured gap required to be far smaller;
and it shows that one TF32 pass (hi.hi alone) falls outside the tolerance
``chip_smoke.py`` holds the card's kernel to, so that check can tell the
split from a plain TF32 product."""

import numpy as np
import pytest
import torch

import chip_smoke
from drin_tpu.ops.pallas.attention import attention_reference, fused_attention as jax_fused
from drin_tpu_torch.ops.cuda import attention as tattn

F32 = dict(rtol=2e-4, atol=1e-5)
# the split's own gap to the float32 plain version: a few float32 roundings
# of outputs of size ~1 (1.0e-6 - 1.5e-6 measured at these shapes and at the
# card's [4, 12, 512, 64]), held with headroom but far below F32
SPLIT_GAP = 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does (the rounding of
    the fault ``chip_smoke.py`` plants): to nearest on the 13 low mantissa
    bits, ties away from zero."""
    return chip_smoke.tf32_round(torch, x)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(a, b, passes: int):
    """a @ b as the kernel takes it on the tensor cores: three TF32 products
    summed in float32, or one (the fault)."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulated(q, k, v, mask, passes: int = 3):
    """The kernel's forward: logits in natural units, p = exp(logit - row
    max) unnormalized in (0, 1], o = p . v divided by the row sum at the end."""
    logits = _product(q, k.transpose(-1, -2), passes) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask[:, None, None, :]
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return _product(p, v, passes) / p.sum(-1, keepdim=True)


def _inputs(B, H, L, seed, lens):
    """Unit-normal q, k, v [B, H, L, 64] as ``chip_smoke.py`` makes them, a
    prefix mask (0 = every key dropped) at finfo.min."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, 64)).astype(np.float32) for _ in range(3))
    mask = np.where(np.arange(L)[None] < np.asarray(lens)[:, None], 0.0,
                    np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, mask


def test_tf32_rounding_and_the_split():
    """hi and lo are TF32 values (13 low bits clear), hi is x rounded to
    nearest with ties away from zero, and hi + lo keeps x to within 2^-22."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 step at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                      np.float32(3.0e-30), np.float32(-7.5e20)], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0e-30, -7.5e20])
    np.testing.assert_array_equal(_tf32(x)[:4].numpy(), want[:4].numpy())
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    for t in (r, r * 1e-20, r * 1e20, x):
        hi, lo = _split(t)
        assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
        assert ((hi - t).abs() <= t.abs() * 2.0 ** -11).all()
        assert ((hi.double() + lo.double() - t.double()).abs() <= t.abs().double() * 2.0 ** -22).all()


@pytest.mark.parametrize("B,H,L,lens,block_q", [
    (2, 2, 128, [128, 50], 64),      # two key tiles, one of them ragged by the mask
    (3, 2, 136, [136, 0, 9], 64),    # L past a tile edge, a sequence with every key dropped
    (2, 1, 8, [8, 3], 8)],           # a sequence shorter than one tile
    ids=["L128", "L136-ragged", "L8"])
def test_split_tf32_attention_matches_plain_and_jax(B, H, L, lens, block_q):
    q, k, v, mask = _inputs(B, H, L, 10 + L, lens)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    got = _emulated(tq, tk, tv, tm).numpy()
    plain = tattn.attention_plain(tq, tk, tv, tm).numpy()
    np.testing.assert_allclose(got, plain, **F32)
    np.testing.assert_allclose(got, np.asarray(jax_fused(q, k, v, mask, block_q, True)), **F32)
    np.testing.assert_allclose(got, np.asarray(attention_reference(q, k, v, mask)), **F32)
    assert np.abs(got - plain).max() <= SPLIT_GAP
    for b, n in enumerate(lens):
        if n == 0:  # every key dropped: the mean of V
            np.testing.assert_allclose(got[b], np.broadcast_to(v[b].mean(-2, keepdims=True),
                                                               v[b].shape), **F32)


def test_one_tf32_pass_falls_outside_the_card_tolerance():
    """The fault ``chip_smoke.py`` plants at its float32 case: the operands
    rounded to TF32, one pass.  It moves outputs by ~1e-3 and lies outside
    ``ATTN_F32_TOL``, which the three-pass split stays inside."""
    q, k, v, mask = map(torch.from_numpy, _inputs(2, 4, 256, 3, [256, 100]))
    want = tattn.attention_plain(q, k, v, mask)
    tol = chip_smoke.ATTN_F32_TOL
    assert chip_smoke.outside(_emulated(q, k, v, mask, passes=3), want, **tol) == 0
    bad = chip_smoke.outside(_emulated(q, k, v, mask, passes=1), want, **tol)
    assert bad > want.numel() // 100, bad
