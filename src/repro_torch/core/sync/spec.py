"""ProtocolSpec: a synchronization protocol as a composition of registered
stages — the counterpart of ``repro.core.sync.spec``.

    spec = ProtocolSpec(trigger="divergence", cohort="balanced",
                        aggregate="mean", commit="balancing",
                        params={"b": 2, "delta": 0.5})

A spec names one stage per slot (``registry.py``), carries the stages'
static parameters, validates the composition at construction with the
reference's errors, and ``compile()``s into the round function the
engine runs: ``(X, state, weights) -> StageResult``.

Departures from the reference: the round runs eagerly, and its control
flow is host Python: the gate ``t % b == 0`` is decided on the host (the
round counter is a host integer), and a conditional trigger's
``nhot > 0`` is read back from the device once per checked round. The
plane is the only layout: ``layout`` defaults to ``"flat"``, and
``"tree"``/``"sharded"`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from repro_torch.core.sync import registry, stages  # noqa: F401
from repro_torch.core.sync.registry import (
    CommRecord, StageCtx, StageResult, SyncOut, get_protocol,
)

# parameters every spec understands regardless of its stages
GLOBAL_PARAMS: Dict[str, Any] = {"weighted": False, "bytes_per_param": 4,
                                 "layout": "flat"}

# the reference's layouts; only "flat" is ported
LAYOUTS = ("tree", "flat", "sharded")
NOT_PORTED_LAYOUTS = {
    "tree": "ROADMAP Queue A 9d (the port keeps the fleet in one (m, P) "
            "plane; the per-leaf tree arithmetic is not ported)",
    "sharded": "ROADMAP Queue A 19 (core/shard.py, the row-sharded plane)",
}

# the ProtocolConfig fields that overlay onto a preset's params
_CONFIG_PARAM_FIELDS = ("b", "delta", "fedavg_c", "augmentation",
                        "weighted", "bytes_per_param", "layout")


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
        for rec in (trig, coh, agg, com):
            if rec.validate is not None:
                rec.validate(resolved)
        if resolved["layout"] in NOT_PORTED_LAYOUTS:
            raise NotImplementedError(
                f"layout {resolved['layout']!r} is not ported yet: "
                f"{NOT_PORTED_LAYOUTS[resolved['layout']]}")

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
            [hot, nhot, aux = trigger.condition(ctx)   # conditional
             if nhot > 0:]                             # triggers only
                cohort -> aggregate -> commit
        else: identity + zero accounting
    """
    trig, coh, agg, com = spec.stage_records()
    p = spec.resolved_params()

    def round_fn(X, state, weights=None) -> StageResult:
        m = X.shape[0]
        t = state.step + 1
        ctx = StageCtx(params=p, flat=X, ref_flat=state.ref, state=state,
                       weights=weights, m=m, t=t,
                       reach=np.ones((m,), bool))
        out = SyncOut(X, state.ref, state.v, CommRecord.zero(),
                      _zeros_i32(m), _zeros_i32(m))
        if trig.gate(ctx):
            if trig.condition is None:
                cout = coh.fn(ctx, ctx.reach, None)
                out = com.fn(ctx, cout, agg.fn(ctx, cout), ctx.reach, None)
            else:
                hot, nhot, aux = trig.condition(ctx)
                if nhot > 0:
                    ctx = ctx._replace(cond_aux=aux)
                    cout = coh.fn(ctx, hot, nhot)
                    out = com.fn(ctx, cout, agg.fn(ctx, cout), hot, nhot)
        new_state = state._replace(ref=out.ref, v=out.v, step=t)
        return StageResult(out.params, new_state, out.rec, out.xfers,
                           out.link_msgs)

    return round_fn


@functools.lru_cache(maxsize=None)
def _resolve_config(proto) -> ProtocolSpec:
    preset = get_protocol(proto.kind)
    known = preset.known_params
    # params a preset pins explicitly win over the config overlay
    pinned = dict(preset.params)
    overrides = {f: getattr(proto, f) for f in _CONFIG_PARAM_FIELDS
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
