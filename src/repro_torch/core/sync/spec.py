"""ProtocolSpec: a synchronization protocol as a composition of registered
stages — the counterpart of ``repro.core.sync.spec``.

    spec = ProtocolSpec(trigger="divergence", cohort="balanced",
                        aggregate="mean", commit="balancing",
                        params={"b": 2, "delta": 0.5})

A spec names one stage per slot (``registry.py``), carries the stages'
static parameters, validates the composition at construction with the
reference's errors, ``compile()``s into the round function the engine
runs: ``(X, state, weights) -> StageResult``, and serializes to the
reference's JSON (``to_dict``/``to_json``, ``from_dict``/``from_json``:
the same text for the same spec, as a checkpoint's sidecar needs).

Departures from the reference: the round runs eagerly, and its control
flow is host Python: the gate ``t % b == 0`` is decided on the host (the
round counter is a host integer), and a conditional trigger's
``nhot > 0`` is read back from the device once per checked round. The
plane is the only arithmetic: ``layout`` defaults to ``"flat"``, and
``"tree"`` (the reference's default) runs on the same ``(m, P)`` plane —
the reference holds its tree layout to its flat one (comm exact,
parameters within rtol 2e-4, ``tests/test_flatten.py``), so a tree spec
here gives the flat results; ``"sharded"`` raises
``NotImplementedError`` (its ``shard_devices`` parameter is known, so
the reference's specs load).
"""
from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.sync import registry, stages  # noqa: F401
from repro_torch.core.sync.registry import (
    CommRecord, StageCtx, StageResult, SyncOut, get_protocol,
)

# parameters every spec understands regardless of its stages
GLOBAL_PARAMS: Dict[str, Any] = {"weighted": False, "bytes_per_param": 4,
                                 "layout": "flat", "shard_devices": 0}

# the reference's layouts; "tree" and "flat" both run on the plane
LAYOUTS = ("tree", "flat", "sharded")
NOT_PORTED_LAYOUTS = {
    "sharded": "ROADMAP Queue A 19 (core/shard.py, the row-sharded plane)",
}

# the ProtocolConfig fields that overlay onto a preset's params
_CONFIG_PARAM_FIELDS = ("b", "delta", "fedavg_c", "augmentation",
                        "weighted", "bytes_per_param", "layout",
                        "shard_devices")


def _canonical(v):
    """Numpy scalar -> plain Python number; everything else untouched."""
    import numbers
    if isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    return v


@dataclass(frozen=True)
class ProtocolSpec:
    """One protocol = four named stages + their static parameters
    (canonicalized to a sorted tuple of items, so specs hash)."""
    trigger: str
    cohort: str = "all_reachable"
    aggregate: str = "mean"
    commit: str = "average"
    params: Any = ()
    name: str = ""

    def __post_init__(self):
        raw = self.params
        items = raw.items() if isinstance(raw, dict) else (
            tuple(kv) for kv in raw)
        items = tuple(sorted((k, _canonical(v)) for k, v in items))
        for k, v in items:
            if not isinstance(v, (bool, int, float, str, type(None))):
                raise ValueError(
                    f"spec param {k!r} must be a plain Python scalar "
                    f"(bool/int/float/str), got {type(v).__name__}: {v!r}")
        object.__setattr__(self, "params", items)
        self._validate()

    # ---- stage access ------------------------------------------------
    def stage_records(self):
        return (registry.get_trigger(self.trigger),
                registry.get_cohort(self.cohort),
                registry.get_aggregate(self.aggregate),
                registry.get_commit(self.commit))

    @property
    def known_params(self) -> Dict[str, Any]:
        merged = dict(GLOBAL_PARAMS)
        for rec in self.stage_records():
            merged.update(rec.params)
        return merged

    def resolved_params(self) -> Dict[str, Any]:
        p = self.known_params
        p.update(dict(self.params))
        return p

    def param(self, name: str):
        return self.resolved_params()[name]

    def with_params(self, **overrides) -> "ProtocolSpec":
        merged = dict(self.params)
        merged.update(overrides)
        return dataclasses.replace(self, params=merged)

    @property
    def bytes_per_param(self) -> int:
        return self.param("bytes_per_param")

    # ---- capabilities (the engine wires these, not kind strings) -----
    @property
    def uses_overlay(self) -> bool:
        """The cohort needs the peer adjacency (gossip)."""
        return registry.get_cohort(self.cohort).uses_overlay

    @property
    def uses_coordinator(self) -> bool:
        """The cohort runs star traffic to a coordinator hub."""
        return registry.get_cohort(self.cohort).uses_coordinator

    @property
    def extra_state(self) -> Tuple[str, ...]:
        """Names of the extra carried-state arrays the trigger threads
        through ``SyncState.extra``."""
        trig = registry.get_trigger(self.trigger)
        return tuple(sorted(trig.init_extra(self.resolved_params(), 1)))

    def init_extra(self, m: int) -> Dict[str, Any]:
        """Initial extra carried state for an m-learner fleet."""
        trig = registry.get_trigger(self.trigger)
        return trig.init_extra(self.resolved_params(), m)

    # ---- construction-time validation --------------------------------
    def _validate(self) -> None:
        trig, coh, agg, com = self.stage_records()   # KeyError on unknowns
        label = self.name or (
            f"{self.trigger}/{self.cohort}/{self.aggregate}/{self.commit}")
        if (coh.needs_condition or com.needs_condition) and not \
                trig.condition:
            needer = coh.name if coh.needs_condition else com.name
            raise ValueError(
                f"spec {label!r}: stage {needer!r} needs a conditional "
                f"trigger (one that marks hot learners, e.g. divergence "
                f"or staleness), but trigger {trig.name!r} is "
                f"unconditional")
        for rec, slot in ((agg, "aggregate"), (com, "commit")):
            missing = rec.needs - coh.provides
            if missing:
                raise ValueError(
                    f"spec {label!r}: {slot} stage {rec.name!r} needs "
                    f"{sorted(missing)} which cohort {coh.name!r} does "
                    f"not provide (provides: {sorted(coh.provides)})")
        known = self.known_params
        unknown = [k for k, _ in self.params if k not in known]
        if unknown:
            raise ValueError(
                f"spec {label!r}: params {unknown} are not consumed by "
                f"any of its stages (known: {sorted(known)})")
        resolved = self.resolved_params()
        if not (isinstance(resolved["bytes_per_param"], int)
                and resolved["bytes_per_param"] >= 1):
            raise ValueError(
                f"bytes_per_param must be an int >= 1, got "
                f"{resolved['bytes_per_param']!r}")
        if resolved["layout"] not in LAYOUTS:
            raise ValueError(
                f"layout must be one of {LAYOUTS}, got "
                f"{resolved['layout']!r}")
        if not (isinstance(resolved["shard_devices"], int)
                and not isinstance(resolved["shard_devices"], bool)
                and resolved["shard_devices"] >= 0):
            raise ValueError(
                f"shard_devices must be an int >= 0 (0 = all visible "
                f"devices), got {resolved['shard_devices']!r}")
        for rec in (trig, coh, agg, com):
            if rec.validate is not None:
                rec.validate(resolved)
        if resolved["layout"] in NOT_PORTED_LAYOUTS:
            raise NotImplementedError(
                f"layout {resolved['layout']!r} is not ported yet: "
                f"{NOT_PORTED_LAYOUTS[resolved['layout']]}")

    # ---- serialization -----------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trigger": self.trigger,
            "cohort": self.cohort,
            "aggregate": self.aggregate,
            "commit": self.commit,
            "params": dict(self.params),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProtocolSpec":
        allowed = {"name", "trigger", "cohort", "aggregate", "commit",
                   "params"}
        unknown = set(d) - allowed
        if unknown:
            raise ValueError(
                f"unknown ProtocolSpec keys {sorted(unknown)}; "
                f"schema: {sorted(allowed)}")
        if "trigger" not in d:
            raise ValueError("a ProtocolSpec dict needs at least 'trigger'")
        kw = dict(d)
        # JSON has no tuples; params may round-trip as a dict (canonical)
        kw["params"] = dict(kw.get("params", {}))
        return cls(**kw)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ProtocolSpec":
        return cls.from_dict(json.loads(s))

    # ---- compilation -------------------------------------------------
    def compile(self):
        """The round function ``(X, state, weights=None) ->
        StageResult``. Cached per spec."""
        return _compiled_round(self)


def _zeros_i32(m: int) -> np.ndarray:
    return np.zeros((m,), np.int32)


@functools.lru_cache(maxsize=None)
def _compiled_round(spec: ProtocolSpec):
    """Wire the spec's four stages into one round, the reference's
    skeleton with host control flow:

        if trigger.gate(ctx):                      # t % b == 0
            [hot, nhot[, aux] = trigger.condition(ctx)   # conditional
             if nhot > 0:]                               # triggers only
                cohort(key) -> aggregate ->
                extra = trigger.commit_extra(ctx, cohort mask) -> commit
        else: identity + zero accounting, the key unchanged,
              extra = trigger.skip_extra(ctx)

    ``active`` is the round's (m,) availability mask (None: the ideal
    network), ``adjacency`` the (m, m) peer overlay of a spec that
    ``uses_overlay``, ``dists`` and ``leaf_sizes`` as ``StageCtx``'s."""
    trig, coh, agg, com = spec.stage_records()
    p = spec.resolved_params()
    fire = trigger_fire(trig)

    def round_fn(X, state, weights=None, active: Optional[np.ndarray] = None,
                 adjacency: Optional[np.ndarray] = None, dists=None,
                 leaf_sizes=None) -> StageResult:
        m = X.shape[0]
        t = state.step + 1
        reach = np.ones((m,), bool) if active is None else active
        ctx = StageCtx(params=p, flat=X, ref_flat=state.ref, state=state,
                       weights=weights, m=m, t=t, reach=reach,
                       active=active, adjacency=adjacency, dists=dists,
                       leaf_sizes=leaf_sizes, memo={})
        checked, runs, ctx, hot, nhot = fire(ctx)
        if runs:
            cout = coh.fn(ctx, hot, nhot, state.key)
            mean = agg.fn(ctx, cout)
            # the trigger's commit-time state reads the uncommitted plane,
            # as the reference's does: before the commit writes it
            extra = trig.commit_extra(ctx, cout.mask)
            out = com.fn(ctx, cout, mean, hot, nhot)
        else:   # a round whose pipeline does not run keeps the key
            out = SyncOut(X, state.ref, state.v, state.key,
                          CommRecord.zero(), _zeros_i32(m), _zeros_i32(m))
            extra = trig.skip_extra(ctx)
        new_state = state._replace(ref=out.ref, v=out.v, step=t,
                                   key=out.key, extra=extra)
        return StageResult(out.params, new_state, out.rec, out.xfers,
                           out.link_msgs, checked)

    return round_fn


def trigger_fire(trig):
    """The trigger half of a round, ``ctx -> (checked, runs, ctx, hot,
    nhot)``: whether the gate fired, whether the pipeline runs, the
    context with the condition's extras in ``cond_aux``, and the hot
    learners. An unconditional trigger runs the pipeline whenever its
    gate fires, with every reachable learner hot and ``nhot`` None."""
    def fire(ctx):
        if not trig.gate(ctx):
            return False, False, ctx, None, None
        if trig.condition is None:
            return True, True, ctx, ctx.reach, None
        cond = trig.condition(ctx)
        if len(cond) > 2:        # condition extras -> downstream stages
            ctx = ctx._replace(cond_aux=cond[2])
        return True, cond[1] > 0, ctx, cond[0], cond[1]
    return fire


@functools.lru_cache(maxsize=None)
def _resolve_config(proto) -> ProtocolSpec:
    preset = get_protocol(proto.kind)
    known = preset.known_params
    # params a preset pins explicitly win over the config overlay
    pinned = dict(preset.params)
    # the port's config has no ``shard_devices`` (ROADMAP Queue A 19): it
    # overlays the reference's default 0, so both packages write one JSON
    overrides = {f: getattr(proto, f, 0) for f in _CONFIG_PARAM_FIELDS
                 if f in known and f not in pinned}
    return preset.with_params(**overrides)


def resolve_spec(proto) -> ProtocolSpec:
    """A ``ProtocolSpec`` passes through; a ``ProtocolConfig`` resolves to
    its preset with the config's parameter fields overlaid (only the
    fields the preset's stages consume)."""
    if isinstance(proto, ProtocolSpec):
        return proto
    if hasattr(proto, "kind"):
        from repro_torch.core.sync import kernel  # noqa: F401  (presets)
        return _resolve_config(proto)
    raise TypeError(
        f"expected a ProtocolSpec or a ProtocolConfig, got {proto!r}")
