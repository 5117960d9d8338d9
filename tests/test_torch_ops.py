# -*- coding: utf-8 -*-
"""The port's core ops against ``drin_tpu.ops.core`` (float32, rtol 2e-4:
the same math in another association order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.ops import core as jcore
from drin_tpu_torch.ops import core as tcore

RTOL, ATOL = 2e-4, 1e-6


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_cosine_similarity_with_clamp():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    y = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[0, 0] = 0.0  # zero vector: the clamp keeps it finite (0)
    y[1, 2] = 1e-6  # tiny norms: the product is clamped, not each norm
    got = tcore.cosine_similarity(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, jcore.cosine_similarity(jnp.asarray(x), jnp.asarray(y)))
    assert got[0, 0] == 0.0


def test_span_mean_empty_and_out_of_window_spans():
    rng = np.random.default_rng(1)
    seq = rng.standard_normal((5, 8, 6)).astype(np.float32)
    begin = np.array([1, 3, 5, 9, 0], np.int64)
    end = np.array([4, 3, 2, 12, 8], np.int64)  # normal, empty, reversed, past window, full
    got = tcore.span_mean(torch.from_numpy(seq), torch.from_numpy(begin), torch.from_numpy(end))
    _close(got, jcore.span_mean(jnp.asarray(seq), jnp.asarray(begin), jnp.asarray(end)))
    assert torch.all(got[1:4] == 0)


@pytest.mark.parametrize("fn", ["token_span_mean", "token_span_max"])
def test_token_span_pooling(fn):
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 4, 7, 5)).astype(np.float32)
    ntok = np.array([[7, 3, 2, 0], [5, 1, 6, 4]], np.int64)  # includes empty spans
    got = getattr(tcore, fn)(torch.from_numpy(feats), torch.from_numpy(ntok))
    _close(got, getattr(jcore, fn)(jnp.asarray(feats), jnp.asarray(ntok)))
    assert torch.all(got[0, 2:] == 0)  # empty spans pool to 0


def test_object_pair_similarity():
    rng = np.random.default_rng(3)
    mo = rng.standard_normal((2, 3, 8)).astype(np.float32)
    ms = rng.uniform(0, 1, (2, 3)).astype(np.float32)
    eo = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    es = rng.uniform(0, 1, (2, 4, 2)).astype(np.float32)
    eo[1, 1, 0] = 0.0  # zero object: norm clamp at 1e-8
    es[0, 2] = 0.0  # zero scores: eps=1e-9 in the denominator
    got = tcore.object_pair_similarity(*map(torch.from_numpy, (mo, ms, eo, es)))
    _close(got, jcore.object_pair_similarity(*map(jnp.asarray, (mo, ms, eo, es))))
    assert torch.isfinite(got).all()


def test_activations_and_pools_match_flax():
    from drin_tpu.nn import layers as jl
    from drin_tpu_torch.nn import layers as tl

    x = np.linspace(-4, 4, 41, dtype=np.float32)
    for name in ("gelu", "relu", "sigmoid", "tanh", "silu", "elu", "identity"):
        _close(tl.get_activation(name)(torch.from_numpy(x)), jl.get_activation(name)(jnp.asarray(x)))
    assert tl.LayerNorm(4).eps == 1e-5
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = tl.Linear(6, 3, g1), tl.Linear(6, 3, g2)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert a.weight.abs().max() <= 6 ** -0.5
