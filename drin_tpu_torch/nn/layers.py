# -*- coding: utf-8 -*-
"""Encoder-layer library, the DRIN subset (port of ``drin_tpu/nn/layers.py``).

Initialization follows torch defaults (Linear: U(-1/sqrt(fan_in), ..) for
weight and bias), drawn from an explicit ``torch.Generator`` when one is
given so a seed fixes the weights.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from drin_tpu_torch.ops.core import span_mean


class Linear(nn.Linear):
    """``nn.Linear`` whose torch-default init can draw from a generator."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        if generator is not None:
            bound = 1.0 / math.sqrt(in_features)
            with torch.no_grad():
                nn.init.uniform_(self.weight, -bound, bound, generator=generator)
                nn.init.uniform_(self.bias, -bound, bound, generator=generator)


def LayerNorm(dim: int) -> nn.LayerNorm:
    """torch LayerNorm with its own eps, 1e-5 (the JAX module pins it)."""
    return nn.LayerNorm(dim, eps=1e-5)


def get_activation(name: str) -> Callable:
    """Activation by name; gelu is the exact erf form."""
    table = {
        "gelu": functools.partial(F.gelu, approximate="none"),
        "relu": F.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "silu": F.silu,
        "elu": F.elu,
        "identity": lambda x: x,
    }
    return table[name]


class MaxPool(nn.Module):
    """max over an axis."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, seq, *args):
        return torch.amax(seq, dim=self.dim)


class Avg(nn.Module):
    """Span-average of token features between per-sample begin:end."""

    def forward(self, seq, begin, end, *args):
        return span_mean(seq, begin, end)


class AvgLinear(nn.Module):
    """Span-average followed by a projection (parameters under ``linear``)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Linear(in_features, out_features, generator)

    def forward(self, seq, begin, end, *args):
        return self.linear(span_mean(seq, begin, end))
