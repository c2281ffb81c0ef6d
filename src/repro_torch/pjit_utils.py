"""Sharding-constraint hooks usable from model code without a mesh —
the counterpart of ``repro.pjit_utils``.

Model code would call ``constrain(x, ("data", None, "model"))`` with
*logical* axis names. Without an active mesh (``mesh_context``) both
hooks are the identity, so the same model runs unchanged on one device.
Under one, a ``DTensor`` is redistributed to the placements the rules
give its logical names (``launch.sharding.to_placements``), and a plain
tensor comes back as it was: it lives on one rank and has no layout to
change. The port's models keep their single-card identities
(``models/layers.py``) and call neither hook yet.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from repro_torch.launch.sharding import (
    PartitionSpec, axis_size, to_placements,
)

_state = threading.local()


def _active():
    return getattr(_state, "ctx", None)


@contextmanager
def mesh_context(mesh, rules: dict | None = None):
    """Activate ``mesh`` for ``constrain`` calls. ``rules`` maps logical
    names to (tuples of) mesh axes, e.g. ``{"batch": ("pod", "data"),
    "embed": "data", "heads": "model"}``; a name missing from them is
    unsharded."""
    prev = _active()
    _state.ctx = (mesh, rules or {})
    try:
        yield
    finally:
        _state.ctx = prev


def logical_to_spec(names, rules, mesh=None, dims=None) -> PartitionSpec:
    """Map logical names to mesh axes; with ``dims`` given, drop an axis
    that does not divide its dim (25 heads over a 16-way axis). A mesh
    axis serves the first dim that can use it, so ``("expert", None,
    "tp")`` falls back to tp when the experts cannot take it."""
    parts, used = [], set()
    for i, n in enumerate(names):
        axis = rules.get(n) if n is not None else None
        if axis is not None and mesh is not None and dims is not None:
            if dims[i] % axis_size(mesh, axis) != 0:
                axis = None
        if axis is not None:
            members = set(axis) if isinstance(axis, tuple) else {axis}
            if members & used:
                axis = None
            else:
                used |= members
        parts.append(axis)
    return PartitionSpec(*parts)


def constrain(x, names):
    """Lay ``x`` out by its logical ``names`` under the active mesh: a
    ``DTensor`` is redistributed, a plain tensor returned as it is; the
    identity without a mesh."""
    ctx = _active()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = logical_to_spec(names, rules, mesh, x.shape)
    return x.redistribute(mesh, to_placements(spec, mesh))


def gather_weight(x, names):
    """The weight gather before a product: ``constrain`` where the rules
    set ``_gather_weights`` (default True). Training and prefill gather
    the (small) weights to keep the (large) activations in place; decode
    (a handful of tokens) leaves the weights sharded."""
    ctx = _active()
    if ctx is None:
        return x
    _, rules = ctx
    if not rules.get("_gather_weights", True):
        return x
    return constrain(x, names)
