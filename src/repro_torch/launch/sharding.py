"""Sharding rules: parameter, cache and batch specs for the production
mesh — the counterpart of ``repro.launch.sharding``.

The rules are the reference's, rule for rule:

* 2-D weights ``(d_in, d_out)``: FSDP over ``data`` on d_in, tensor
  parallel over ``model`` on d_out (reversed for the row-parallel output
  projections ``w_o`` / ``w_down`` / ``w_out``);
* MoE expert tables ``(E, d, f)``: (d, f) over (data, model) with the
  experts replicated, or, where E divides the tp axis, the experts over
  tp and FSDP on d (expert parallel);
* the embedding ``(V, d)``: vocab over ``model``, d over ``data``;
* the batch: ``("pod", "data")`` (single pod ``"data"``) on the leading
  dim; the learners' leading ``m`` axis over ``pod``.

Every rule is guarded: an axis is kept only where it divides the dim,
and a mesh axis serves one dim at most (the first that can use it).

A spec is the port's own ``PartitionSpec``: a tuple with one entry a
dim, each a mesh axis, a tuple of axes or None, trailing Nones dropped.
``to_placements(spec, mesh)`` turns one into the ``DTensor``
placements of a ``DeviceMesh`` (``Shard(d)`` on each mesh dim a tensor
dim uses, ``Replicate()`` elsewhere), and ``local_shape(shape, spec,
mesh)`` gives one rank's shard.

Spec trees follow the argument trees: dicts (in their own key order),
lists, tuples and NamedTuples, a spec where the argument has a tensor.
The names a rule reads are the dict keys on a leaf's path, as the
reference reads its ``DictKey``s.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

from repro_torch.launch.mesh import axis_sizes


class PartitionSpec(tuple):
    """One entry a dim: a mesh axis, a tuple of axes, or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

_COL = ("fsdp", "tp")        # (d_in, d_out) column-parallel
_ROW = ("tp", "fsdp")        # (d_in, d_out) row-parallel
_CORE_SPECS = {
    # attention / generic projections
    "w_q": _COL, "w_k": _COL, "w_v": _COL, "w_o": _ROW,
    "w_dq": _COL, "w_uq": _COL, "w_dkv": _COL, "w_krope": _COL,
    "w_uk": _COL, "w_uv": _COL,
    # ffn
    "w_gate": _COL, "w_up": _COL, "w_down": _ROW,
    # ssm
    "w_xz": _COL, "w_bc": _COL, "w_dt": _COL, "w_out": _ROW,
    "conv_w": (None, "tp"),
    # router
    "router": ("fsdp", None),
    # embeddings / head
    "embed": ("tp", "fsdp"),
    "lm_head": ("fsdp", "tp"),
    # cnn/mlp
    "w": _COL, "kernel": (None, None, "fsdp", "tp"),
    # 1-D / small leaves
    "scale": (None,), "bias": (None,), "b": (None,),
    "b_q": (None,), "b_k": (None,), "b_v": (None,),
    "dt_bias": (None,), "A_log": (None,), "D": (None,), "pos": (None,),
}
# MoE expert tables: a leading E axis in front of the 2-D core; experts
# replicated in ID space, (d, f) sharded
_MOE_CORE = {
    "w_gate": (None,) + _COL, "w_up": (None,) + _COL,
    "w_down": (None,) + _ROW,
}
# expert parallel (E divisible by the tp axis): experts over tp, FSDP on d
_MOE_CORE_EP = {
    "w_gate": ("tp", "fsdp", None), "w_up": ("tp", "fsdp", None),
    "w_down": ("tp", None, "fsdp"),
}
# KV / state caches by leaf name (the leading L axis padded)
_CACHE_SPECS = {
    "k": ("batch", "seq", "tp", None),       # (B, S, Hkv, hd)
    "v": ("batch", "seq", "tp", None),
    "ckv": ("batch", "seq", None),           # MLA latent (B, S, r)
    "krope": ("batch", "seq", None),
    "ssm": ("batch", "tp", None, None),      # (B, H, P, N)
    "conv": ("batch", None, "tp"),           # (B, K-1, C)
    "pos": (None,),
}


def map_named(fn: Callable, tree, names: Tuple[str, ...] = ()):
    """``tree`` with every leaf (a ``PartitionSpec``, or anything with a
    ``shape``) replaced by ``fn(names, leaf)``, ``names`` the dict keys on its
    path; dicts, lists, tuples and NamedTuples keep their form, None
    stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_named(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_named(fn, v, names + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, PartitionSpec) or hasattr(tree, "shape"):
        return fn(names, tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_named(fn, v, names) for v in tree)
    return tree


def _resolve(logical: Optional[str], axes_map: dict) -> Any:
    return None if logical is None else axes_map.get(logical)


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis``: one mesh axis, a tuple of them, or None."""
    sizes = axis_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _guarded_spec(dims, logical, mesh, axes_map: dict) -> PartitionSpec:
    """A spec with the axes that do not divide their dim, and the mesh
    axes an earlier dim already uses, dropped."""
    parts, used = [], set()
    for size, name in zip(dims, logical):
        axis = _resolve(name, axes_map)
        members = (set(axis) if isinstance(axis, tuple)
                   else {axis} if axis is not None else set())
        if (axis is not None and size % axis_size(mesh, axis) == 0
                and not (members & used)):
            parts.append(axis)
            used |= members
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def default_axes_map(multi_pod: bool = False) -> dict:
    """Logical -> mesh axes for the baseline layout."""
    return {
        "fsdp": "data",
        "tp": "model",
        "batch": ("pod", "data") if multi_pod else "data",
        "seq": "model",
        "learner": "pod",
    }


def _core_logical(core, ndim: int) -> list:
    ncore = min(len(core), ndim)
    return [None] * (ndim - ncore) + list(core[-ncore:] if ncore else [])


def param_spec_tree(params, mesh, axes_map: dict,
                    learner_axis: bool = False):
    """The spec tree of a parameter tree (tensors or shape structs);
    with ``learner_axis`` every leaf carries a leading m axis, over
    ``axes_map["learner"]``."""
    tp_size = axis_size(mesh, _resolve("tp", axes_map))

    def spec(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        if "moe" in names and "shared" not in names and name in _MOE_CORE:
            core = (_MOE_CORE_EP[name] if shape[-3] % tp_size == 0
                    else _MOE_CORE[name])
        else:
            core = _CORE_SPECS.get(name) or (None,) * len(shape)
        logical = _core_logical(core, len(shape))
        if learner_axis and len(shape) - min(len(core), len(shape)) >= 1:
            logical[0] = "learner"
        return _guarded_spec(shape, logical, mesh, axes_map)

    return map_named(spec, params)


def cache_spec_tree(cache, mesh, axes_map: dict):
    """The spec tree of a stacked (L-leading) decode cache."""
    def spec(names, leaf):
        shape = tuple(leaf.shape)
        core = _CACHE_SPECS.get(names[-1] if names else "",
                                (None,) * len(shape))
        return _guarded_spec(shape, _core_logical(core, len(shape)), mesh,
                             axes_map)

    return map_named(spec, cache)


def batch_spec_tree(batch, mesh, axes_map: dict, learner_axis: bool = False):
    """A batch's specs: the leading dim(s) over the (learner,) batch
    axes."""
    def spec(_names, leaf):
        nd = len(leaf.shape)
        logical = ["batch"] + [None] * (nd - 1)
        if learner_axis:
            logical = ["learner"] + logical[:nd - 1]
        return _guarded_spec(tuple(leaf.shape), tuple(logical[:nd]), mesh,
                             axes_map)

    return map_named(spec, batch)


def replicated(tree, mesh=None):
    return map_named(lambda _n, _l: PartitionSpec(), tree)


def activation_rules(axes_map: dict) -> dict:
    """Rules for ``repro_torch.pjit_utils.mesh_context``: the logical
    names of the ``constrain`` and ``gather_weight`` hooks."""
    return {
        "batch": axes_map["batch"],
        "heads": axes_map["tp"],
        "kv_heads": axes_map["tp"],
        "ffn": axes_map["tp"],
        # expert parallelism: the expert-ID axis over tp where it divides
        "expert": axes_map["tp"],
        "vocab": axes_map["tp"],
        "embed": axes_map["fsdp"],
        # the weight gather's target: the tp dim stays sharded
        "tp": axes_map["tp"],
    }


def _dim_axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def local_shape(shape, spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """One rank's shard of a ``shape`` tensor laid out by ``spec``."""
    shape = tuple(shape)
    out = list(shape)
    for d, part in enumerate(spec):
        n = axis_size(mesh, part)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {shape} does not divide over "
                             f"{part} ({n} ranks)")
        out[d] = shape[d] // n
    return tuple(out)


def to_placements(spec: PartitionSpec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``'s dims:
    ``Shard(d)`` on every mesh dim that tensor dim d uses (a tuple of
    axes shards d on each of them, in order), ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        for axis in _dim_axes(part):
            out[names.index(axis)] = Shard(d)
    return tuple(out)
