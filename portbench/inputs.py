"""Weights and data made from the seed, on the device, in a few large calls."""

from __future__ import annotations

import numpy as np
import torch


def make_weights(shapes: dict, gen: torch.Generator, device) -> dict:
    """A state dict for ``shapes`` (name -> (shape, init), the reference's
    ``param_shapes``): one uniform and one normal draw for all tensors,
    sliced and scaled; ``("uniform", bound)``, ``("normal", std)``,
    ``("const", value)``."""
    numel = {k: int(np.prod(s)) for k, (s, _) in shapes.items()}
    kinds = {k: init[0] for k, (_, init) in shapes.items()}
    n_u = sum(numel[k] for k in shapes if kinds[k] == "uniform")
    n_n = sum(numel[k] for k in shapes if kinds[k] == "normal")
    u = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    z = torch.randn(n_n, generator=gen, device=device)
    out, iu, iz = {}, 0, 0
    for k, (shape, init) in shapes.items():
        n = numel[k]
        if init[0] == "uniform":
            out[k] = (u[iu:iu + n] * init[1]).reshape(shape)
            iu += n
        elif init[0] == "normal":
            out[k] = (z[iz:iz + n] * init[1]).reshape(shape)
            iz += n
        else:
            out[k] = torch.full(shape, float(init[1]), device=device)
    return out


def normal(gen, device, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def uniform(gen, device, lo, hi, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def integers(gen, device, lo, hi, *shape) -> torch.Tensor:
    """int64 in [lo, hi)."""
    return torch.randint(lo, hi, shape, generator=gen, device=device)


def host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as the host array a caller hands over."""
    return t.cpu().numpy()
