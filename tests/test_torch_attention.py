# -*- coding: utf-8 -*-
"""Fused attention: the kernel's plain version against the JAX package's
Pallas kernel (interpret mode) and its XLA reference.

Tolerances: float32 at rtol 2e-4 / atol 1e-5 (the same math in another
summation order).  bfloat16 at rtol 2e-2 / atol 2e-2, the JAX package's own
bf16 bound for this kernel: both sides round p and the output to bf16 (8
bits).  The CUDA kernel is compared with the plain version on the card
(chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.ops.pallas.attention import attention_reference, fused_attention as jax_fused
from drin_tpu_torch.ops.cuda import attention as tattn

F32 = dict(rtol=2e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(shape, seed, masked):
    B, H, L, Dh = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        lens = rng.integers(1, L + 1, B)
        lens[0] = L // 3
        mask = np.where(np.arange(L)[None] < lens[:, None], 0.0,
                        np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masked"])
@pytest.mark.parametrize("shape,block_q", [((2, 2, 32, 16), 128),  # one query block
                                           ((1, 3, 40, 8), 16),    # L not a multiple of block_q
                                           ((3, 2, 24, 64), 8)],
                         ids=["L32", "L40-ragged", "L24-Dh64"])
def test_plain_matches_pallas_interpret_and_reference(shape, block_q, masked):
    q, k, v, mask = _inputs(shape, 0, masked)
    tm = None if mask is None else torch.from_numpy(mask)
    got = tattn.attention_plain(*map(torch.from_numpy, (q, k, v)), tm).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(jax_fused(q, k, v, mask, block_q, True)), **F32)
    np.testing.assert_allclose(got, np.asarray(attention_reference(q, k, v, mask)), **F32)


def test_plain_bf16_matches_pallas_interpret():
    q, k, v, mask = _inputs((2, 2, 64, 32), 1, True)
    jq, jk, jv, jm = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, mask))
    tq, tk, tv, tm = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, mask))
    # both masks hold finfo(bf16).min: float32's min rounds to -inf in bf16
    jm = jnp.where(jm < 0, jnp.finfo(jnp.bfloat16).min, 0).astype(jnp.bfloat16)
    tm = torch.where(tm < 0, torch.finfo(torch.bfloat16).min, 0.0).to(torch.bfloat16)
    got = tattn.attention_plain(tq, tk, tv, tm)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_fused(jq, jk, jv, jm, 128, True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_fully_masked_row_is_uniform_like_the_jax_kernel():
    """The mask keeps its magnitude (finfo.min, not -inf): a sequence whose
    keys are all dropped averages V, in both packages."""
    q, k, v, _ = _inputs((2, 2, 16, 8), 2, False)
    mask = np.zeros((2, 16), np.float32)
    mask[1] = np.finfo(np.float32).min
    got = tattn.attention_plain(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_fused(q, k, v, mask, 128, True)), **F32)
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(-2, keepdims=True), v[1].shape),
                               **F32)


def test_cpu_wrapper_returns_the_plain_result_and_counts_no_launch():
    q, k, v, mask = map(torch.from_numpy, _inputs((2, 2, 32, 16), 3, True))
    tattn.launches = 0
    got = tattn.fused_attention(q, k, v, mask)
    assert torch.equal(got, tattn.attention_plain(q, k, v, mask))
    # strided views (BERT's reshape + transpose) need no copy either
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(tattn.fused_attention(qt, k, v, mask), got)
    assert tattn.launches == 0


class _OnCard:
    """A CPU tensor that claims to live on a CUDA device, for the wrapper's
    argument checks (there is no card where these tests run)."""

    def __init__(self, t, device="cuda:0"):
        self._t, self.device, self.is_cuda = t, torch.device(device), True

    def __getattr__(self, name):
        return getattr(self._t, name)


def _on_card(*shape, dtype=torch.bfloat16, requires_grad=False):
    return _OnCard(torch.zeros(*shape, dtype=dtype, requires_grad=requires_grad))


@pytest.mark.parametrize("case,match", [
    ("fp16", "float32 or bfloat16"), ("dh32", "Dh=64"), ("L520", "multiple of 8 up to 512"),
    ("L20", "multiple of 8"), ("mask_dtype", "must be torch.bfloat16"),
    ("mask_shape", "additive_mask must be"), ("device", "must be on"),
    ("k_shape", "k must be"), ("misaligned", "16-byte aligned"), ("grad", None)])
def test_cuda_checks_refuse_what_the_kernel_does_not_take(case, match):
    shape = {"dh32": (2, 2, 256, 32), "L520": (1, 1, 520, 64), "L20": (1, 1, 20, 64)}.get(
        case, (2, 2, 256, 64))
    dt = torch.float16 if case == "fp16" else torch.bfloat16
    q, k, v = (_on_card(*shape, dtype=dt) for _ in range(3))
    mask = _on_card(shape[0], shape[2], dtype=dt)
    if case == "mask_dtype":
        mask = _on_card(2, 256, dtype=torch.float32)
    elif case == "mask_shape":
        mask = _on_card(2, 128)
    elif case == "device":
        v = _OnCard(v._t, "cuda:1")
    elif case == "k_shape":
        k = _on_card(2, 2, 128, 64)
    elif case == "misaligned":
        q = _OnCard(torch.zeros(2, 2, 256, 68, dtype=dt)[..., 4:])
    elif case == "grad":
        q = _on_card(*shape, dtype=dt, requires_grad=True)
    if match is None:  # an input that requires grad is taken: the backward is a kernel too
        with torch.enable_grad():
            assert tattn._check_cuda(q, k, v, mask) == shape
        return
    with torch.enable_grad(), pytest.raises(ValueError, match=match):
        tattn._check_cuda(q, k, v, mask)


def test_cuda_checks_accept_the_main_path_views():
    B, H, L, hd = 2, 12, 384, 64
    x = torch.zeros(B, L, H * hd, dtype=torch.bfloat16)
    q, k, v = (_OnCard(x.reshape(B, L, H, hd).transpose(1, 2)) for _ in range(3))
    mask = _OnCard(torch.zeros(B, 1, 1, L, dtype=torch.bfloat16)[:, 0, 0, :])
    assert tattn._check_cuda(q, k, v, mask) == (B, H, L, hd)
    assert tattn._check_cuda(q, k, v, None) == (B, H, L, hd)
    with torch.no_grad():  # frozen weights under no_grad pass the grad check
        q = _OnCard(torch.zeros(B, H, L, hd, dtype=torch.bfloat16, requires_grad=True))
        assert tattn._check_cuda(q, k, v, None) == (B, H, L, hd)


def test_cuda_tensor_without_a_card_raises(monkeypatch):
    """On a tensor that says it is on CUDA the wrapper goes for the kernel
    (here it fails allocating the output on the missing card, or else
    building without nvcc): an error, never the plain version."""
    from drin_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(tattn, "attention_plain", None)  # calling it would be a TypeError
    q, k, v = (_on_card(1, 1, 256, 64) for _ in range(3))
    tattn.launches = 0
    with torch.no_grad(), pytest.raises((RuntimeError, AssertionError), match="CUDA|nvcc"):
        tattn.fused_attention(q, k, v, None)
    assert tattn.launches == 0
