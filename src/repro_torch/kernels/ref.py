"""Plain PyTorch versions of the port's kernels — the counterpart of
``repro.kernels.ref``.

They are the correctness references: the CPU runs them in place of the
kernels, and ``chip_smoke.py`` holds each kernel against them on the
card. Only the oracles of ported kernels live here; the attention, norm
and scan oracles come with their kernels.
"""
from __future__ import annotations

import torch


def sqdist_ref(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """||x - r||^2 in f32. x, r: any same-shape tensors."""
    d = x.float() - r.float()
    return torch.sum(d * d)


def sqdist_rows_ref(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Row-wise ||X[i] - r||^2 in f32: X (m, P), r (P,) -> (m,)."""
    d = X.float() - r.float()[None]
    return torch.sum(d * d, dim=1)
