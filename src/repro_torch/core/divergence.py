"""Model divergence and local conditions (paper Eq. 2 and Section 3) — the
counterpart of ``repro.core.divergence``.

A *model configuration* is a tree whose leaves carry a leading learner
axis ``m``, or, on the flat layout, one ``(m, P)`` plane. The divergence
of a configuration is
    delta(f) = 1/m sum_i || f_i - mean(f) ||^2
and the local condition of learner i w.r.t. reference model r is
    || f_i - r ||^2 <= Delta.

``per_learner_sq_distance_flat`` is the protocol's monitoring pass: one
``(m, P) x (P,)`` reduction through ``repro_torch.kernels.ops``, which
launches the ``sqdist_rows`` kernel for a CUDA plane and runs the plain
version for a CPU plane (the reference picks by backend instead).
"""
from __future__ import annotations

import torch

from repro_torch.core.flatten import tree_leaves, tree_map
from repro_torch.kernels import ops as kops


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype for reductions over a leaf: at least float32."""
    return torch.promote_types(dt, torch.float32)


def tree_mean(stacked):
    """Mean over the leading learner axis of every leaf (accumulated in
    ``_acc_dtype``, returned in the leaf dtype)."""
    return tree_map(
        lambda x: torch.mean(x, dim=0, dtype=_acc_dtype(x.dtype)).to(x.dtype),
        stacked)


def tree_weighted_mean(stacked, weights: torch.Tensor):
    """Weighted mean over the learner axis (Algorithm 2). weights: (m,).
    An all-zero weight vector yields the zero model instead of 0/0."""
    wsum = torch.sum(weights)
    denom = torch.where(wsum > 0, wsum, torch.ones_like(wsum))

    def wmean(x):
        acc = _acc_dtype(x.dtype)
        w = weights.reshape((-1,) + (1,) * (x.dim() - 1)).to(acc)
        return (torch.sum(x.to(acc) * w, dim=0) / denom.to(acc)).to(x.dtype)

    return tree_map(wmean, stacked)


def sq_distance(a, b, use_kernel: bool = False) -> torch.Tensor:
    """|| a - b ||^2 summed over every leaf of two same-structure trees;
    ``use_kernel`` routes each leaf through ``ops.sqdist``."""
    pairs = zip(tree_leaves(a), tree_leaves(b))
    if use_kernel:
        return sum(kops.sqdist(x.reshape(-1), y.reshape(-1))
                   for x, y in pairs)
    return sum(torch.sum(torch.square(x.float() - y.float()))
               for x, y in pairs)


def per_learner_sq_distance_flat(X: torch.Tensor,
                                 r: torch.Tensor) -> torch.Tensor:
    """(m,) f32 squared distances over the flat fleet plane: ``X`` is the
    (m, P) configuration, ``r`` the (P,) reference row, or (g, P) rows of
    g equal clusters, each row against its own cluster's."""
    return kops.sqdist_rows(X, r)


def per_learner_sq_distance(stacked, ref) -> torch.Tensor:
    """(m,) squared distances || f_i - r ||^2; leaves of ``stacked`` carry a
    leading m axis, ``ref`` is a single model."""
    def leaf(x, r):
        d = x.float() - r.float()[None]
        return torch.sum(d.reshape(d.shape[0], -1) ** 2, dim=1)
    return sum(tree_leaves(tree_map(leaf, stacked, ref)))


def divergence(stacked) -> torch.Tensor:
    """delta(f) = 1/m sum_i || f_i - mean(f) ||^2  (paper Eq. 2)."""
    return torch.mean(per_learner_sq_distance(stacked, tree_mean(stacked)))
