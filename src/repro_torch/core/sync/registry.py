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
  never-firing trigger); an optional ``condition(ctx) -> (hot, nhot[,
  aux])`` marks the learners that want to sync, and the pipeline runs
  only when ``nhot > 0``. A trigger owns its extra carried state
  (``SyncState.extra``): ``init_extra(params, m)``, ``commit_extra(ctx,
  mask)`` after a sync (``mask`` is the committed cohort) and
  ``skip_extra(ctx)`` in any round without one (after a condition that
  marked nobody, ``ctx.cond_aux`` holds its extras).
* **cohort** — ``fn(ctx, hot, nhot, key) -> CohortOut``: WHO
  participates; a cohort that draws (FedAvg's fraction, the balancing
  augmentation) splits the round's PRNG key and carries the rest
  forward in ``CohortOut.key``. It declares ``uses_overlay`` (it needs
  the peer adjacency) and ``uses_coordinator`` (star traffic to a hub).
* **aggregate** — ``fn(ctx, cohort_out) -> (P,) row``: WHAT they agree on;
  an aggregate a hierarchy may run also registers its ``batched`` form,
  one call for every cluster of the intra tier.
* **commit** — ``fn(ctx, cohort_out, aggregate, hot, nhot) -> SyncOut``:
  APPLY the agreement to the plane and ACCOUNT for it.

Departures from the reference: the round's control values — the gate,
the masks (availability, cohort, adjacency), ``nhot``, the violation
counter ``v``, the PRNG key, the extra carried state, the
``CommRecord`` and the per-link counts — are host values (Python ints
and bools, numpy arrays, the key a CPU tensor of ``repro_torch.prng``);
only the plane, the reference row and the distances live on the device.
Stages declare no ``StageContract`` (the contract checker is ROADMAP
Queue A 20).
"""
from __future__ import annotations

from types import MappingProxyType
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


# ``prng.key(0)`` on the host: the key ``init_state(ref)`` starts from
_KEY0 = torch.zeros((2,), dtype=torch.int64)
# the carried state of a trigger that declares none (read-only: shared)
_NO_EXTRA = MappingProxyType({})


class SyncState(NamedTuple):
    ref: torch.Tensor    # reference model r, the (P,) plane row
    v: int               # violation counter
    step: int            # round counter t
    key: torch.Tensor = _KEY0   # (2,) host PRNG key for the cohort draws
    extra: Any = _NO_EXTRA   # trigger-declared carried state: name ->
    #   (m,) host array (the staleness counters); empty for the others


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
    state, the comm record, the per-link counts (model transfers and
    control messages) the bytes ledger prices, and whether the trigger's
    gate fired (a conditional trigger then ran its condition)."""
    params: torch.Tensor     # the (m, P) plane
    state: SyncState
    rec: CommRecord
    xfers: np.ndarray        # (m,) int32 models crossing each learner's link
    link_msgs: np.ndarray    # (m,) int32 control messages per learner link
    checked: bool = False    # the gate fired this round


class StageCtx(NamedTuple):
    """One round's inputs, shared by every stage. ``cond_aux`` carries what
    a conditional trigger computed beyond (hot, nhot) — the divergence
    trigger's (m,) distances, reused as the balancing priority.
    ``active`` is the round's availability mask (None on an ideal
    network, which keeps the pre-network expressions) and ``reach`` the
    same mask with None read as all True. ``dists`` returns the host (m,)
    f32 distances of this plane's rows to its reference (None: one
    ``sqdist_rows`` pass, ``stages.host_dists``); a hierarchy hands each
    cluster a slice of one grouped pass. ``leaf_sizes`` are the model's
    leaf sizes in plane order (the tree layout's per-leaf noise).
    ``memo`` is a dict made fresh for each round (and each cluster), where
    stages keep what several of them read on the round's uncommitted
    plane — the robust stages' row distances and finiteness — so it is
    computed once (the reference leaves that to XLA's CSE)."""
    params: Dict[str, Any]               # the spec's resolved params
    flat: torch.Tensor                   # (m, P) plane
    ref_flat: torch.Tensor               # (P,) reference row
    state: SyncState
    weights: Optional[torch.Tensor]      # Algorithm-2 B^i weights or None
    m: int
    t: int                               # this round's index (step + 1)
    reach: np.ndarray                    # (m,) bool; all True if ideal
    cond_aux: Any = None
    active: Optional[np.ndarray] = None  # (m,) reachability, None = ideal
    adjacency: Optional[np.ndarray] = None   # (m, m) peer overlay or None
    dists: Optional[Callable[[], np.ndarray]] = None
    leaf_sizes: Optional[Tuple[int, ...]] = None
    memo: Optional[Dict[str, Any]] = None    # one round's shared results


class CohortOut(NamedTuple):
    """A cohort's output. ``key`` is the PRNG key carried forward;
    ``v``/``full`` are None unless the cohort manages the violation
    counter (the balancing cohort); ``ideal`` marks the ideal-network
    full-participation path; ``aux`` holds what downstream stages read
    (the fraction cohort's subset size ``k``, the neighborhood's active
    overlay ``A`` and mixing matrix ``W``)."""
    mask: np.ndarray                     # (m,) bool participants
    key: torch.Tensor
    v: Optional[int] = None
    full: Optional[bool] = None
    ideal: bool = False
    aux: Optional[Dict[str, Any]] = None


class SyncOut(NamedTuple):
    """A commit's output."""
    params: torch.Tensor
    ref: torch.Tensor
    v: int
    key: torch.Tensor
    rec: CommRecord
    xfers: np.ndarray
    link_msgs: np.ndarray


def carried_v(ctx: StageCtx, cout: CohortOut) -> int:
    """The violation counter a commit stage should carry forward."""
    return ctx.state.v if cout.v is None else cout.v


def _default_init_extra(params, m):
    return {}


def _default_commit_extra(ctx, mask):
    return ctx.state.extra


def _default_skip_extra(ctx):
    return ctx.state.extra


class TriggerStage(NamedTuple):
    name: str
    gate: Callable                    # ctx -> bool
    condition: Optional[Callable]     # ctx -> (hot, nhot[, aux]); None = always
    init_extra: Callable              # (params, m) -> dict of host arrays
    commit_extra: Callable            # (ctx, mask) -> dict
    skip_extra: Callable              # ctx -> dict
    params: Dict[str, Any]
    validate: Optional[Callable]


class CohortStage(NamedTuple):
    name: str
    fn: Callable                      # (ctx, hot, nhot, key) -> CohortOut
    provides: frozenset               # labels downstream stages may need
    uses_overlay: bool                # needs the peer adjacency matrix
    uses_coordinator: bool            # star traffic to a hub
    needs_condition: bool             # requires a conditional trigger
    params: Dict[str, Any]
    validate: Optional[Callable]


class AggregateStage(NamedTuple):
    name: str
    fn: Callable                      # (ctx, cohort_out) -> (P,) row
    needs: frozenset
    params: Dict[str, Any]
    validate: Optional[Callable]
    batched: Optional[Callable]       # the same over a cluster batch:
    #   ctx.flat (g, k, P), masks and weights (g, k) -> (g, P) rows


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
                     init_extra: Optional[Callable] = None,
                     commit_extra: Optional[Callable] = None,
                     skip_extra: Optional[Callable] = None,
                     params: Optional[Dict[str, Any]] = None,
                     validate: Optional[Callable] = None):
    """Register the decorated function as trigger ``name``'s gate."""
    def deco(gate: Callable) -> Callable:
        _enter(TRIGGERS, "trigger", name, TriggerStage(
            name=name, gate=gate, condition=condition,
            init_extra=init_extra or _default_init_extra,
            commit_extra=commit_extra or _default_commit_extra,
            skip_extra=skip_extra or _default_skip_extra,
            params=dict(params or {}), validate=validate))
        return gate
    return deco


def register_cohort(name: str, *, provides=(), uses_overlay: bool = False,
                    uses_coordinator: bool = True,
                    needs_condition: bool = False,
                    params: Optional[Dict[str, Any]] = None,
                    validate: Optional[Callable] = None):
    def deco(fn: Callable) -> Callable:
        _enter(COHORTS, "cohort", name, CohortStage(
            name=name, fn=fn, provides=frozenset(provides),
            uses_overlay=uses_overlay, uses_coordinator=uses_coordinator,
            needs_condition=needs_condition, params=dict(params or {}),
            validate=validate))
        return fn
    return deco


def register_aggregate(name: str, *, needs=(),
                       params: Optional[Dict[str, Any]] = None,
                       validate: Optional[Callable] = None,
                       batched: Optional[Callable] = None):
    def deco(fn: Callable) -> Callable:
        _enter(AGGREGATES, "aggregate", name, AggregateStage(
            name=name, fn=fn, needs=frozenset(needs),
            params=dict(params or {}), validate=validate, batched=batched))
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


def get_protocol(name: str):
    if name not in PROTOCOLS:
        raise KeyError(
            f"unknown protocol {name!r}; known: {sorted(PROTOCOLS)}")
    return PROTOCOLS[name]
