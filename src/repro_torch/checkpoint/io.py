"""Checkpointing: a run's parameters, optimizer state and protocol state
<-> npz — the counterpart of ``repro.checkpoint.io``, in the same file
format, so each package loads the other's checkpoints.

Flat-key encoding: each leaf is stored under its tree path, the path's
segments joined by ``|``: ``k:<key>`` for a dict key, ``i:<index>`` for
a list index and ``a:.<field>`` for a NamedTuple field (jax's
``GetAttrKey``), as ``jax.tree_util.tree_flatten_with_path`` names
them; structure is rebuilt on load from the key strings, with no
pickling.

The port keeps a run on planes; the files hold the reference's trees:

* ``.params.npz`` — the stacked (m, ...) parameter leaves;
* ``.opt.npz`` — ``a:.step`` as the (m,) int32 per-learner counts and
  the moments ``a:.mu`` / ``a:.nu`` as stacked trees (the port's moments
  are (m, P) planes);
* ``.sync.npz`` — ``ref`` as a model tree (the port's (P,) row), ``v``
  and ``step`` as int32, ``rng`` as the raw uint32 key (the port's int64
  ``key``), and ``extra`` as the trigger's int32 arrays; a hierarchical
  state is ``intra`` (leading (g,) axis on every leaf) and ``inter``.

Every write is atomic: the file is written under a temporary name in the
destination directory and moved into place with ``os.replace``, so a
process dying mid-save leaves the previous complete checkpoint.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core.flatten import fleet_adapter, tree_leaves, tree_map
from repro_torch.core.sync.hierarchy import HierSyncState
from repro_torch.core.sync.registry import SyncState
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import OptState

SEP = "|"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix=()) -> Dict[str, np.ndarray]:
    """Leaves under their jax tree-path keys, in jax's leaf order."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(f"k:{k}", tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f"a:.{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(f"i:{i}", x) for i, x in enumerate(tree)]
    else:
        leaf = tree.detach().cpu() if torch.is_tensor(tree) else tree
        return {SEP.join(prefix): np.asarray(leaf)}
    flat = {}
    for seg, sub in items:
        flat.update(_flatten_with_paths(sub, prefix + (seg,)))
    return flat


def _atomic_write(path: str, write_fn) -> None:
    """Run ``write_fn(tmp_path)`` against a sibling temp file, then
    ``os.replace`` it over ``path``; the temp file is removed if the
    write fails."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _atomic_text(path: str, text: str) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            f.write(text)
    _atomic_write(path, write)


def save_pytree(path: str, tree) -> None:
    """One tree of tensors / arrays -> one npz, under its path keys."""
    flat = _flatten_with_paths(tree)

    def write(tmp):
        # an open file keeps np.savez from appending ".npz" to the name
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
    _atomic_write(path, write)


def _set_nested(root, keys, value):
    node = root
    for i, (_, k) in enumerate(keys[:-1]):
        nxt_is_idx = keys[i + 1][0] == "i"
        if isinstance(node, dict):
            node = node.setdefault(k, [] if nxt_is_idx else {})
        else:
            while len(node) <= k:
                node.append([] if nxt_is_idx else {})
            node = node[k]
    last = keys[-1][1]
    if isinstance(node, dict):
        node[last] = value
    else:
        while len(node) <= last:
            node.append(None)
        node[last] = value


def load_pytree(path: str):
    """An npz written by either package -> nested dicts / lists of numpy
    arrays (a NamedTuple field comes back as the dict key ``.field``)."""
    data = np.load(path)
    items = []
    for key in data.files:
        parts = []
        for seg in key.split(SEP):
            tag, val = seg[0], seg[2:]
            parts.append(("i", int(val)) if tag == "i" else ("k", val))
        items.append((parts, data[key]))
    if not items:
        return {}
    root: Any = [] if items[0][0][0][0] == "i" else {}
    for parts, val in items:
        _set_nested(root, parts, val)
    return root


def _rows_tree(adapter, rows: torch.Tensor):
    """A (P,) row -> a model tree; (n, P) rows -> a stacked tree."""
    if rows.dim() == 1:
        return adapter.unravel_model(rows)
    return adapter.unravel(rows)


def _sync_dict(state: SyncState, adapter) -> dict:
    batch = tuple(np.shape(state.v))           # (g,) at a hierarchy's intra
    d = {"ref": _rows_tree(adapter, state.ref),
         "v": np.asarray(state.v, np.int32),
         "rng": state.key.cpu().numpy().astype(np.uint32),
         "step": np.full(batch, state.step, np.int32)}
    if state.extra:
        d["extra"] = {k: np.asarray(v) for k, v in state.extra.items()}
    return d


def save_protocol_state(path: str, params, opt_state, sync_state,
                        protocol=None, counters=None) -> None:
    """Persist a run: ``params`` the engine's stacked (m, ...) tree
    (``DecentralizedLearner.params``), ``opt_state`` its ``OptState``,
    ``sync_state`` its ``SyncState`` or ``HierSyncState``. ``protocol``
    (a ``ProtocolConfig`` or ``ProtocolSpec``) also writes
    ``<path>.spec.json``, the serialized spec, with a ``tiers`` block for
    a hierarchical config; ``counters`` (``counters_state()``) writes
    ``<path>.counters.json``."""
    adapter = fleet_adapter(tree_map(lambda x: x[0], params))
    m = tree_leaves(params)[0].shape[0]
    save_pytree(path + ".params.npz", params)
    # a scalar count (a fleet-wide one) holds for every learner
    steps = np.broadcast_to(
        np.asarray(torch.as_tensor(opt_state.step).cpu(), np.int32), (m,))
    save_pytree(path + ".opt.npz", OptState(
        step=steps,
        mu=None if opt_state.mu is None else adapter.unravel(opt_state.mu),
        nu=None if opt_state.nu is None else adapter.unravel(opt_state.nu)))
    if isinstance(sync_state, HierSyncState):
        save_pytree(path + ".sync.npz", {
            "intra": _sync_dict(sync_state.intra, adapter),
            "inter": _sync_dict(sync_state.inter, adapter)})
    else:
        save_pytree(path + ".sync.npz", _sync_dict(sync_state, adapter))
    if protocol is not None:
        tiers = getattr(protocol, "tiers", None)
        if tiers is None:
            blob = resolve_spec(protocol).to_json()
        else:
            blob = json.dumps({
                "spec": resolve_spec(protocol).to_dict(),
                "tiers": {
                    "num_clusters": tiers.num_clusters,
                    "link_class": tiers.link_class,
                    "inter": resolve_spec(tiers.inter).to_dict(),
                },
            }, indent=1, sort_keys=True)
        _atomic_text(path + ".spec.json", blob)
    if counters is not None:
        _atomic_text(path + ".counters.json",
                     json.dumps(counters, indent=1, sort_keys=True))


def _ravel(adapter, tree, device) -> torch.Tensor:
    """A stacked tree -> (n, P) rows; a model tree -> a (P,) row."""
    tree = params_from_numpy(tree, device)
    if tree_leaves(tree)[0].dim() > len(adapter.shapes[0]):
        return adapter.ravel(tree)
    return adapter.ravel_model(tree)


def _sync_state(d: dict, adapter, device) -> SyncState:
    v, step = np.asarray(d["v"]), np.asarray(d["step"])
    return SyncState(
        ref=_ravel(adapter, d["ref"], device),
        v=int(v) if v.ndim == 0 else v.astype(np.int64),
        step=int(step.reshape(-1)[0]),
        key=torch.from_numpy(np.asarray(d["rng"]).astype(np.int64)),
        extra={k: np.asarray(a) for k, a in d.get("extra", {}).items()})


def load_protocol_state(path: str, device="cuda"):
    """``(params, opt_state, sync_state)`` of a checkpoint written by
    either package, in the port's form on ``device``: the stacked
    parameter tree of tensors (``DecentralizedLearner.restore_state``
    copies it into the plane), an ``OptState`` over (m, P) planes, and a
    ``SyncState`` (reference row, host counters and key) or a
    ``HierSyncState``. The fleet's layout comes from the parameter
    tree."""
    dev = resolve_device(device)
    params = params_from_numpy(load_pytree(path + ".params.npz"), dev)
    adapter = fleet_adapter(tree_map(lambda x: x[0], params))
    opt = load_pytree(path + ".opt.npz")
    steps = np.asarray(opt[".step"], np.int32).reshape(-1)
    opt_state = OptState(
        step=torch.from_numpy(steps.copy()).to(dev),
        mu=_ravel(adapter, opt[".mu"], dev) if ".mu" in opt else None,
        nu=_ravel(adapter, opt[".nu"], dev) if ".nu" in opt else None)
    sync = load_pytree(path + ".sync.npz")
    if "intra" in sync:
        state = HierSyncState(intra=_sync_state(sync["intra"], adapter, dev),
                              inter=_sync_state(sync["inter"], adapter, dev))
    else:
        state = _sync_state(sync, adapter, dev)
    return params, opt_state, state


def _read_sidecar(path: str):
    spec_path = path + ".spec.json"
    if not os.path.exists(spec_path):
        return None
    with open(spec_path) as f:
        return json.load(f)


def load_protocol_spec(path: str):
    """The flat (or intra-tier) ``ProtocolSpec`` saved next to a
    checkpoint, or None for a checkpoint written without one."""
    d = _read_sidecar(path)
    if d is None:
        return None
    return ProtocolSpec.from_dict(d.get("spec", d))


def load_protocol_tiers(path: str):
    """The hierarchy block of a checkpoint's spec sidecar —
    ``{"num_clusters", "link_class", "inter": <inter ProtocolSpec>}`` —
    or None for a flat checkpoint."""
    d = _read_sidecar(path)
    if d is None or "tiers" not in d:
        return None
    tiers = dict(d["tiers"])
    tiers["inter"] = ProtocolSpec.from_dict(tiers["inter"])
    return tiers


def load_counters(path: str):
    """The counter snapshot saved next to a checkpoint, or None; feed it
    to ``DecentralizedLearner.restore_counters``."""
    counters_path = path + ".counters.json"
    if not os.path.exists(counters_path):
        return None
    with open(counters_path) as f:
        return json.load(f)
