"""Shared neural-net primitives — the counterpart of ``repro.models.layers``.

This slice needs only the Glorot initializer of the paper's dense layers;
the norms, attention and MLP blocks come with the model-zoo slice.
"""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """Glorot/Xavier-uniform init (the paper uses Glorot, ref. [41]),
    drawn from ``generator`` on its device."""
    lim = scale * math.sqrt(6.0 / (d_in + d_out))
    w = torch.empty((d_in, d_out), dtype=dtype, device=generator.device)
    return w.uniform_(-lim, lim, generator=generator)
