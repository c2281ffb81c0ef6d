"""Named stage registries — the counterpart of
``repro.core.sync.registry``.

A synchronization protocol Π = (φ, σ) is a ``ProtocolSpec``
(``repro_torch.core.sync.spec``) naming one stage per slot:

    trigger  -> cohort  -> aggregate -> commit
    (fire?)     (who)      (what)       (apply + account)

Each slot has a registry filled through the ``@register_*`` decorators
(the built-in stages are in ``stages.py``); ``PROTOCOLS`` holds complete
specs under a protocol name (``kernel.py``).

Stage contracts, on the flat fleet plane:

* **trigger** — ``gate(ctx) -> bool`` every round (``False`` for a
  never-firing trigger); an optional ``condition(ctx) -> (hot, nhot,
  aux)`` marks the learners that want to sync, and the pipeline runs only
  when ``nhot > 0``.
* **cohort** — ``fn(ctx, hot, nhot) -> CohortOut``: WHO participates.
* **aggregate** — ``fn(ctx, cohort_out) -> (P,) row``: WHAT they agree on.
* **commit** — ``fn(ctx, cohort_out, aggregate, hot, nhot) -> SyncOut``:
  APPLY the agreement to the plane and ACCOUNT for it.

Departures from the reference: the round's control values — the gate,
the masks, ``nhot``, the violation counter ``v``, the ``CommRecord`` and
the per-link counts — are host values (Python ints and bools, numpy
arrays); only the plane, the reference row and the distances live on the
device. ``SyncState`` carries no PRNG key and no extra state, and stages
declare no ``StageContract`` and no overlay/coordinator capabilities:
the key comes with fedavg/random (ROADMAP A10), extra state with the
staleness trigger, and the rest with the slices that need them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch


class SyncState(NamedTuple):
    ref: torch.Tensor    # reference model r, the (P,) plane row
    v: int               # violation counter
    step: int            # round counter t


class CommRecord(NamedTuple):
    model_up: int        # models sent learner -> coordinator
    model_down: int      # models sent coordinator -> learner
    messages: int        # small control messages (violations, polls)
    syncs: int           # 1 if any averaging happened this round
    full_syncs: int      # 1 if ALL (reachable) learners were averaged

    @staticmethod
    def zero():
        return CommRecord(0, 0, 0, 0, 0)


class StageResult(NamedTuple):
    """One staged round's output: the committed plane, the carried sync
    state, the comm record, and the per-link counts (model transfers and
    control messages) the bytes ledger prices."""
    params: torch.Tensor     # the (m, P) plane
    state: SyncState
    rec: CommRecord
    xfers: np.ndarray        # (m,) int32 models crossing each learner's link
    link_msgs: np.ndarray    # (m,) int32 control messages per learner link


class StageCtx(NamedTuple):
    """One round's inputs, shared by every stage. ``cond_aux`` carries what
    a conditional trigger computed beyond (hot, nhot) — the divergence
    trigger's (m,) distances, reused as the balancing priority."""
    params: Dict[str, Any]               # the spec's resolved params
    flat: torch.Tensor                   # (m, P) plane
    ref_flat: torch.Tensor               # (P,) reference row
    state: SyncState
    weights: Optional[torch.Tensor]      # Algorithm-2 B^i weights or None
    m: int
    t: int                               # this round's index (step + 1)
    reach: np.ndarray                    # (m,) bool, all True (ideal net)
    cond_aux: Any = None


class CohortOut(NamedTuple):
    """A cohort's output. ``v``/``full`` are None unless the cohort manages
    the violation counter (the balancing cohort); ``ideal`` marks the
    ideal-network full-participation path."""
    mask: np.ndarray                     # (m,) bool participants
    v: Optional[int] = None
    full: Optional[bool] = None
    ideal: bool = False


class SyncOut(NamedTuple):
    """A commit's output."""
    params: torch.Tensor
    ref: torch.Tensor
    v: int
    rec: CommRecord
    xfers: np.ndarray
    link_msgs: np.ndarray


def carried_v(ctx: StageCtx, cout: CohortOut) -> int:
    """The violation counter a commit stage should carry forward."""
    return ctx.state.v if cout.v is None else cout.v


class TriggerStage(NamedTuple):
    name: str
    gate: Callable                    # ctx -> bool
    condition: Optional[Callable]     # ctx -> (hot, nhot, aux); None = always
    params: Dict[str, Any]
    validate: Optional[Callable]


class CohortStage(NamedTuple):
    name: str
    fn: Callable                      # (ctx, hot, nhot) -> CohortOut
    provides: frozenset               # labels downstream stages may need
    needs_condition: bool             # requires a conditional trigger
    params: Dict[str, Any]
    validate: Optional[Callable]


class AggregateStage(NamedTuple):
    name: str
    fn: Callable                      # (ctx, cohort_out) -> (P,) row
    needs: frozenset
    params: Dict[str, Any]
    validate: Optional[Callable]


class CommitStage(NamedTuple):
    name: str
    fn: Callable                      # (ctx, cout, agg, hot, nhot) -> SyncOut
    needs: frozenset
    needs_condition: bool
    params: Dict[str, Any]
    validate: Optional[Callable]


TRIGGERS: Dict[str, TriggerStage] = {}
COHORTS: Dict[str, CohortStage] = {}
AGGREGATES: Dict[str, AggregateStage] = {}
COMMITS: Dict[str, CommitStage] = {}


def _enter(registry: Dict[str, Any], slot: str, name: str, record) -> None:
    if name in registry:
        raise ValueError(
            f"{slot} stage {name!r} is already registered — stage names "
            f"must be unique per slot (known: {sorted(registry)})")
    registry[name] = record


def register_trigger(name: str, *, condition: Optional[Callable] = None,
                     params: Optional[Dict[str, Any]] = None,
                     validate: Optional[Callable] = None):
    """Register the decorated function as trigger ``name``'s gate."""
    def deco(gate: Callable) -> Callable:
        _enter(TRIGGERS, "trigger", name, TriggerStage(
            name=name, gate=gate, condition=condition,
            params=dict(params or {}), validate=validate))
        return gate
    return deco


def register_cohort(name: str, *, provides=(), needs_condition: bool = False,
                    params: Optional[Dict[str, Any]] = None,
                    validate: Optional[Callable] = None):
    def deco(fn: Callable) -> Callable:
        _enter(COHORTS, "cohort", name, CohortStage(
            name=name, fn=fn, provides=frozenset(provides),
            needs_condition=needs_condition, params=dict(params or {}),
            validate=validate))
        return fn
    return deco


def register_aggregate(name: str, *, needs=(),
                       params: Optional[Dict[str, Any]] = None,
                       validate: Optional[Callable] = None):
    def deco(fn: Callable) -> Callable:
        _enter(AGGREGATES, "aggregate", name, AggregateStage(
            name=name, fn=fn, needs=frozenset(needs),
            params=dict(params or {}), validate=validate))
        return fn
    return deco


def register_commit(name: str, *, needs=(), needs_condition: bool = False,
                    params: Optional[Dict[str, Any]] = None,
                    validate: Optional[Callable] = None):
    def deco(fn: Callable) -> Callable:
        _enter(COMMITS, "commit", name, CommitStage(
            name=name, fn=fn, needs=frozenset(needs),
            needs_condition=needs_condition, params=dict(params or {}),
            validate=validate))
        return fn
    return deco


def _get(registry: Dict[str, Any], slot: str, name: str):
    if name not in registry:
        raise KeyError(
            f"unknown {slot} stage {name!r}; known: {sorted(registry)}")
    return registry[name]


def get_trigger(name: str) -> TriggerStage:
    return _get(TRIGGERS, "trigger", name)


def get_cohort(name: str) -> CohortStage:
    return _get(COHORTS, "cohort", name)


def get_aggregate(name: str) -> AggregateStage:
    return _get(AGGREGATES, "aggregate", name)


def get_commit(name: str) -> CommitStage:
    return _get(COMMITS, "commit", name)


PROTOCOLS: Dict[str, Any] = {}   # name -> ProtocolSpec


def register_protocol(name: str, spec) -> None:
    """Make ``spec`` available as preset ``name`` — and thereby as a valid
    ``ProtocolConfig(kind=name)``."""
    if name in PROTOCOLS:
        raise ValueError(
            f"protocol {name!r} is already registered "
            f"(known: {sorted(PROTOCOLS)})")
    PROTOCOLS[name] = spec


# kinds the reference registers that later slices of the port bring
NOT_PORTED = {
    "fedavg": "ROADMAP Queue A 10 (fedavg needs the reference's threefry "
              "stream, repro_torch/prng.py)",
    "gossip": "ROADMAP Queue A 13 (gossip needs the network topology)",
    "stale": "ROADMAP Queue A 14 (core/sync/staleness.py)",
    "aircomp": "ROADMAP Queue A 16 (core/sync/async_sync.py)",
    "async_periodic": "ROADMAP Queue A 16 (core/sync/async_sync.py)",
    "async_dynamic": "ROADMAP Queue A 16 (core/sync/async_sync.py)",
    "robust_periodic": "ROADMAP Queue A 17 (core/sync/robust.py)",
    "robust_dynamic": "ROADMAP Queue A 17 (core/sync/robust.py)",
}


def get_protocol(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"protocol {name!r} is not ported yet: {NOT_PORTED[name]}")
    if name not in PROTOCOLS:
        raise KeyError(
            f"unknown protocol {name!r}; known: {sorted(PROTOCOLS)}")
    return PROTOCOLS[name]
