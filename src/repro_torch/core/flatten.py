"""The flat fleet plane — the counterpart of ``repro.core.flatten``.

A fleet of m models is ONE contiguous ``(m, P)`` tensor. A
``FleetAdapter`` holds the static map between a model's parameter tree
and the plane's columns, and hands out per-leaf ``(m, *shape)`` views
into the plane, so the training step, the optimizer and the sync stages
all work on the same storage:

    adapter = fleet_adapter(model)          # model: one parameter tree
    X = adapter.ravel(stacked)              # (m, P) plane (a copy)
    params = adapter.unravel(X)             # (m, ...) views into X
    r = adapter.ravel_model(model)          # (P,) row

Column order is ``jax.tree`` leaf order, so planes are exchangeable with
the reference byte for byte: dict keys sorted (each layer's ``b`` before
its ``w``), lists in order, and an empty dict (a pool/flatten/dropout
layer) contributes nothing. Conv weights stay HWIO in the plane. The
plane dtype is the promotion of the leaf dtypes with float32; non-float
leaves are rejected.

This module also carries the small tree walk (``tree_leaves``,
``tree_unflatten``, ``tree_map``) that stands in for ``jax.tree`` in the
port. Departure from the reference: ``unravel`` returns views that alias
the plane when a leaf has the plane's dtype (the reference builds new
arrays), which is what lets the port keep parameters and optimizer
moments in plane storage.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

_LEAF = object()


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree`` order: dict keys sorted, lists/tuples in
    order, ``None`` and empty containers contribute nothing."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    if tree is None:
        return []
    return [tree]


def tree_structure(tree):
    """The tree with every leaf replaced by a marker (its "treedef")."""
    if isinstance(tree, dict):
        return {k: tree_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_structure(v) for v in tree)
    if tree is None:
        return None
    return _LEAF


def tree_unflatten(structure, leaves):
    """Inverse of ``tree_leaves`` for a ``tree_structure``."""
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            built = {k: build(s[k]) for k in sorted(s)}
            return {k: built[k] for k in s}
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        if s is None:
            return None
        return next(it)

    out = build(structure)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of same-structure trees."""
    structure = tree_structure(tree)
    cols = [tree_leaves(tree)] + [tree_leaves(t) for t in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(structure, [fn(*xs) for xs in zip(*cols)])


class FleetAdapter(NamedTuple):
    """Static ravel/unravel maps for one model structure. ``shapes`` are
    the per-leaf model shapes (no learner axis), ``offsets`` the column
    starts of each leaf's slab in the plane, ``P`` the model size."""
    structure: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    P: int
    plane_dtype: torch.dtype

    # ---- fleet (m, ...) <-> (m, P) ----------------------------------
    def ravel(self, stacked) -> torch.Tensor:
        """Stacked (m, ...) tree -> a new (m, P) plane."""
        leaves = tree_leaves(stacked)
        return torch.cat([x.reshape(x.shape[0], -1).to(self.plane_dtype)
                          for x in leaves], dim=1)

    def unravel(self, X: torch.Tensor):
        """(m, P) plane -> stacked (m, ...) tree: views into ``X`` where a
        leaf has the plane dtype, narrowed copies otherwise."""
        m = X.shape[0]
        return tree_unflatten(self.structure, [
            X[:, o:o + s].view((m,) + shp).to(dt)
            for o, s, shp, dt in zip(self.offsets, self.sizes, self.shapes,
                                     self.dtypes)])

    # ---- single model (...) <-> (P,) --------------------------------
    def ravel_model(self, model) -> torch.Tensor:
        return torch.cat([x.reshape(-1).to(self.plane_dtype)
                          for x in tree_leaves(model)])

    def unravel_model(self, x: torch.Tensor):
        return tree_unflatten(self.structure, [
            x[o:o + s].view(shp).to(dt)
            for o, s, shp, dt in zip(self.offsets, self.sizes, self.shapes,
                                     self.dtypes)])


def fleet_adapter(model) -> FleetAdapter:
    """The adapter for one model's parameter tree (leaves without a
    learner axis)."""
    leaves = tree_leaves(model)
    if not leaves:
        raise ValueError("cannot build a FleetAdapter for an empty tree")
    shapes = tuple(tuple(x.shape) for x in leaves)
    dtypes = tuple(x.dtype for x in leaves)
    for shp, dt in zip(shapes, dtypes):
        if not dt.is_floating_point:
            raise TypeError(
                f"the flat fleet-plane carries floating-point parameters "
                f"only; got a leaf with dtype {dt} (shape {shp})")
    plane = torch.float32
    for dt in dtypes:
        plane = torch.promote_types(plane, dt)
    sizes = tuple(int(math.prod(shp)) for shp in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    return FleetAdapter(
        structure=tree_structure(model), shapes=shapes, dtypes=dtypes,
        offsets=tuple(offsets), sizes=sizes, P=off, plane_dtype=plane)
