# -*- coding: utf-8 -*-
"""Mamba-2's chunked SSD scan (``ops/cuda/ssd.py``): the plain version
against the sequential recurrence and against the benchmark reference's
quadratic form, at lengths around the chunk's edges and on a right-padded
batch; its bf16 rounding points; and the wrapper's checks of what the
kernel takes.  The CUDA kernel is held against the plain version on the card
(``chip_smoke.py``, ``phase_ssd``).

Tolerances: float32 at 1e-5 relative to the output's largest magnitude (the
same mathematics in another order of sums); the bf16 rounding points at
2**-6 of it (the weighted scores, the carried state and the weighted B keep
8 bits)."""

import pytest
import torch

from drin_tpu_torch.ops.cuda import ssd
from portbench import harness

CHUNK = 8
LENGTHS = [1, CHUNK - 1, CHUNK, CHUNK + 1, 7 * CHUNK // 2]


def _inputs(N, L, H=3, P=4, S=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, L, H, P, generator=g)
    B, C = torch.randn(N, L, S, generator=g), torch.randn(N, L, S, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(N, L, H, generator=g) - 2.0)
    A = -(1 + 15 * torch.rand(H, generator=g))
    D = torch.randn(H, generator=g)
    return x, dt, A, B, C, D


def _sequential(x, dt, A, B, C, D):
    """S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T; y_t = S_t C_t + D x_t, in float64."""
    x, dt, A, B, C, D = (t.double() for t in (x, dt, A, B, C, D))
    N, L, H, P = x.shape
    S = torch.zeros(N, H, P, B.shape[-1], dtype=torch.float64)
    y = torch.empty_like(x)
    for t in range(L):
        S = torch.exp(dt[:, t] * A)[..., None, None] * S + \
            (dt[:, t, :, None, None] * x[:, t, :, :, None]) * B[:, t, None, None, :]
        y[:, t] = torch.einsum("nhps,ns->nhp", S, C[:, t]) + D[:, None] * x[:, t]
    return y


def _close(got, want, rel):
    scale = want.abs().max().item()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("L", LENGTHS)
def test_plain_equals_the_recurrence_and_the_quadratic_form(L):
    x, dt, A, B, C, D = _inputs(2, L, seed=L)
    got = ssd.ssd_plain(x, dt, A, B, C, D, chunk=CHUNK)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, _sequential(x, dt, A, B, C, D), 1e-5)
    quadratic = harness.load_file_module("reference", "granite_hybrid").ssd_quadratic
    _close(got, quadratic(x, dt, A, B, C, D), 1e-5)
    # the chunk is a way of computing, not a part of the function
    _close(got, ssd.ssd_plain(x, dt, A, B, C, D, chunk=3), 1e-5)


def test_a_right_padded_batch_leaves_the_real_tokens_alone():
    lens = [3 * CHUNK + 2, CHUNK - 1, 1]
    x, dt, A, B, C, D = _inputs(3, max(lens), seed=7)
    for n, real in enumerate(lens):  # whatever the padding holds
        for t in (x, dt, B, C):
            t[n, real:] = 1e3
    got = ssd.ssd_plain(x, dt, A, B, C, D, chunk=CHUNK)
    for n, real in enumerate(lens):
        alone = ssd.ssd_plain(*(t[n:n + 1, :real] for t in (x, dt)), A,
                              *(t[n:n + 1, :real] for t in (B, C)), D, chunk=CHUNK)
        _close(got[n:n + 1, :real], alone, 1e-6)


def test_bf16_rounding_points():
    """bf16 inputs: the result comes back in bf16, within a few of its steps
    of the float32 scan of the same (rounded) inputs, and with exactly the
    rounding points said (each one moved to float32 moves the result)."""
    x, dt, A, B, C, D = _inputs(2, 3 * CHUNK + 3, seed=3)
    xb, Bb, Cb = x.bfloat16(), B.bfloat16(), C.bfloat16()
    got = ssd.ssd_plain(xb, dt, A, Bb, Cb, D, chunk=CHUNK)
    exact = ssd.ssd_plain(xb.float(), dt, A, Bb.float(), Cb.float(), D, chunk=CHUNK)
    assert got.dtype == torch.bfloat16
    _close(got, exact, 2.0 ** -6)
    assert not torch.equal(got.float(), exact.bfloat16().float())


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    x, dt, A, B, C, D = _inputs(2, 2 * CHUNK, seed=5)
    ssd.launches = ssd.chunks = 0
    assert torch.equal(ssd.ssd_scan(x, dt, A, B, C, D, CHUNK),
                       ssd.ssd_plain(x, dt, A, B, C, D, CHUNK))
    assert ssd.launches == ssd.chunks == 0


class _OnCard:
    """A CPU tensor that claims to live on a CUDA device, for the wrapper's
    argument checks (there is no card where these tests run)."""

    def __init__(self, t, device="cuda:0"):
        self._t, self.device, self.is_cuda = t, torch.device(device), True

    def __getattr__(self, name):
        return getattr(self._t, name)


def _card_inputs(N=2, L=300, H=4, case=None):
    """The kernel's arguments as the tower hands them over: x, B and C bf16
    views into one conv output, dt, A and D float32."""
    S = ssd.KERNEL_STATE
    buf = torch.zeros(N, L, H * 64 + 2 * S, dtype=torch.bfloat16)
    x, B, C = buf[..., :H * 64].view(N, L, H, 64), buf[..., H * 64:H * 64 + S], buf[..., -S:]
    dt, A, D = torch.zeros(N, L, H), torch.zeros(H), torch.zeros(H)
    if case == "x_dtype":
        x = x.float()
    elif case == "head_dim":
        x = torch.zeros(N, L, 2 * H, 32, dtype=torch.bfloat16)
    elif case == "state":
        B = torch.zeros(N, L, 64, dtype=torch.bfloat16)
    elif case == "dt_dtype":
        dt = dt.bfloat16()
    elif case == "misaligned":
        C = torch.zeros(N, L, S + 4, dtype=torch.bfloat16)[..., 4:]
    elif case == "device":
        return [_OnCard(x)] + [_OnCard(t, "cuda:1") if i == 2 else _OnCard(t)
                               for i, t in enumerate((dt, A, B, C, D))]
    return [_OnCard(t) for t in (x, dt, A, B, C, D)]


@pytest.mark.parametrize("case,match", [
    ("x_dtype", "x in torch.bfloat16"), ("head_dim", r"\[N, L, H, 64\]"),
    ("state", "B must be"), ("dt_dtype", "dt in torch.float32"),
    ("misaligned", "16-byte aligned"), ("device", "must be on"), ("chunk", "chunks of 256")])
def test_cuda_checks_refuse_what_the_kernel_does_not_take(case, match):
    args = _card_inputs(case=case)
    with pytest.raises(ValueError, match=match):
        ssd._check_cuda(*args, 128 if case == "chunk" else ssd.KERNEL_CHUNK)


def test_cuda_checks_accept_the_towers_views():
    assert ssd._check_cuda(*_card_inputs(), ssd.KERNEL_CHUNK) == (2, 300, 4)


def test_cuda_tensor_without_a_card_raises(monkeypatch, tmp_path):
    """On tensors that say they are on CUDA the wrapper goes for the kernel
    (here it fails allocating the output on the missing card, or else
    building without nvcc): an error, never the plain version."""
    from drin_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(ssd, "ssd_plain", None)  # calling it would be a TypeError
    ssd.launches = 0
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|nvcc"):
        ssd.ssd_scan(*_card_inputs())
    assert ssd.launches == 0
    assert "ssd_scan" in _build.KERNELS
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("ssd_scan")
