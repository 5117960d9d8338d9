# -*- coding: utf-8 -*-
"""The fused entity-vertex update: the kernel's plain version against the JAX
package's Pallas kernel (interpret mode) and its XLA reference.

Tolerances: float32 at rtol 2e-4 / atol 1e-5 (the same math in another
summation order; the Pallas kernel's gelu uses a polynomial erf, off by less
than 1.5e-7).  bfloat16 at rtol 1.6e-2 / atol 2e-2, two bf16 ulps: the JAX
side forms x in bf16 arithmetic, the port in float32 rounded once, as its
kernel does.  The CUDA kernel is compared with the plain version on the card
(chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.ops.pallas.gcn import fused_vertex_update as jax_fused, vertex_update_reference
from drin_tpu_torch.ops.cuda import vertex_update as tvu

F32 = dict(rtol=2e-4, atol=1e-5)
BF16 = dict(rtol=1.6e-2, atol=2e-2)


def _inputs(B, C, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    # v, e1, m1, e2, m2, w [in, out] (flax layout), b, ln scale, ln bias
    return [f(B, C, D), u(B, C), f(B, D), u(B, C), f(B, D),
            (f(D, D) * D ** -0.5).astype(np.float32), 0.1 * f(D), 1 + 0.1 * f(D), 0.1 * f(D)]


def _torch_args(args, dt=torch.float32):
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dt) for x in args]
    t[5] = t[5].T.contiguous()  # torch layout: [out, in]
    return t


@pytest.mark.parametrize("act", ["gelu", "relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", [(3, 11, 32), (2, 101, 128)], ids=lambda s: "B%dC%dD%d" % s)
def test_plain_matches_pallas_interpret_and_reference(shape, act):
    args = _inputs(*shape, seed=sum(shape))
    got = tvu.vertex_update_plain(*_torch_args(args), act=act).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(jax_fused(*args, act=act, interpret=True)), **F32)
    np.testing.assert_allclose(got, np.asarray(vertex_update_reference(*args, act=act)), **F32)


def test_plain_bf16_matches_reference():
    args = _inputs(3, 11, 32, seed=1)
    got = tvu.vertex_update_plain(*_torch_args(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = vertex_update_reference(*(jnp.asarray(x, jnp.bfloat16) for x in args))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    args = _torch_args(_inputs(2, 5, 16, seed=2))
    tvu.launches = 0
    assert torch.equal(tvu.fused_vertex_update(*args), tvu.vertex_update_plain(*args))
    assert tvu.launches == 0


class _OnCard:
    """A CPU tensor that claims to live on a CUDA device, for the wrapper's
    argument checks (there is no card where these tests run)."""

    def __init__(self, t):
        self._t, self.device, self.is_cuda = t, torch.device("cuda:0"), True

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("case,err,match", [
    ("fp16", ValueError, "float32 or bfloat16"), ("act", ValueError, "implements activations"),
    ("shape", ValueError, "e1 must be"),
    pytest.param("D%16", ValueError, "built for D in", id="D%16-ValueError-D % 16"),
    ("width", ValueError, "built for D in"), ("strided", ValueError, "contiguous"),
    ("grad", RuntimeError, "forward-only")])
def test_cuda_checks_refuse_what_the_kernel_does_not_take(case, err, match):
    """The bf16 kernel is built for D = 128 and 768: 24 (not a multiple of
    16) and 96 (a multiple of 16 and 32) are refused by name."""
    dt = torch.float16 if case == "fp16" else torch.bfloat16
    B, C, D = 2, 5, {"D%16": 24, "width": 96}.get(case, 128)
    names = ("v", "e1", "m1", "e2", "m2", "w", "b", "scale", "bias")
    shapes = ((B, C, D), (B, C), (B, D), (B, C), (B, D), (D, D), (D,), (D,), (D,))
    t = {n: torch.zeros(s, dtype=dt) for n, s in zip(names, shapes)}
    if case == "shape":
        t["e1"] = torch.zeros(B, C + 1, dtype=dt)
    elif case == "strided":
        t["w"] = torch.zeros(D, 2 * D, dtype=dt)[:, ::2]
    elif case == "grad":
        t["w"].requires_grad_(True)
    named = {n: _OnCard(x) for n, x in t.items()}
    with torch.enable_grad(), pytest.raises(err, match=match):
        tvu._check_cuda(named, "silu" if case == "act" else "gelu")
    if case == "grad":  # under no_grad a weight that requires grad is fine
        with torch.no_grad():
            assert tvu._check_cuda(named, "gelu") == (B, C, D)


def test_cuda_checks_take_any_width_in_float32():
    """The f32 kernel (plain FMA loops) takes any D; only bf16 is tied to the
    widths the wgmma kernel is built for."""
    B, C, D = 2, 5, 24
    names = ("v", "e1", "m1", "e2", "m2", "w", "b", "scale", "bias")
    shapes = ((B, C, D), (B, C), (B, D), (B, C), (B, D), (D, D), (D,), (D,), (D,))
    named = {n: _OnCard(torch.zeros(s)) for n, s in zip(names, shapes)}
    assert tvu._check_cuda(named, "gelu") == (B, C, D)
    named = {n: _OnCard(torch.zeros(s, dtype=torch.bfloat16)) for n, s in zip(names, shapes)}
    with pytest.raises(ValueError, match="built for D in"):
        tvu._check_cuda(named, "gelu")
