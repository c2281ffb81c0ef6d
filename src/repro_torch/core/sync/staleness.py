"""Bounded-staleness synchronization — the counterpart of
``repro.core.sync.staleness``: one registered trigger and a spec,
composed with the existing cohort/aggregate/commit stages.

Each learner carries a staleness counter s_i — completed rounds since it
last took part in a sync — in ``SyncState.extra["staleness"]``, a host
int32 array: every round ages every learner by one, a sync commit resets
exactly the committed cohort, and only reachable learners can raise the
alarm. The condition marks ``hot = reach & (s + 1 >= tau)``, so the sync
machinery runs the moment any reachable learner has gone ``tau`` rounds
unsynchronized; a learner dark past its deadline triggers it the round
it reappears.

``BOUNDED_STALENESS`` composes the trigger with the all-reachable cohort
and is registered as preset ``"stale"``. The trigger composes with the
other cohort families too: ``cohort="fraction", commit="subset"`` is
staleness-triggered FedAvg, ``cohort="balanced", commit="balancing"``
runs the balancing augmentation off staleness instead of divergence
(its ``max_distance`` priority then costs one ``sqdist_rows`` pass).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sync.registry import (
    StageContract, StageCtx, register_protocol, register_trigger,
)
from repro_torch.core.sync.spec import ProtocolSpec
from repro_torch.core.sync.stages import _validate_b, cadence_fire


def _counters(ctx: StageCtx) -> np.ndarray:
    if "staleness" not in ctx.state.extra:
        raise ValueError(
            "the staleness trigger carries per-learner counters in "
            "SyncState.extra['staleness'] — build the state with "
            "init_state(ref, seed, spec=spec, m=m) (the engine does this)")
    return ctx.state.extra["staleness"]


def _staleness_condition(ctx: StageCtx):
    hot = ctx.reach & (_counters(ctx) + 1 >= ctx.params["tau"])
    return hot, int(hot.sum())


def _staleness_init(params, m: int):
    return {"staleness": np.zeros((m,), np.int32)}


def _staleness_commit(ctx: StageCtx, mask: np.ndarray):
    # the committed cohort resets; everyone else, dark learners included,
    # keeps aging
    age = _counters(ctx) + 1
    return {"staleness": np.where(mask, np.int32(0), age).astype(np.int32)}


def _staleness_skip(ctx: StageCtx):
    return {"staleness": _counters(ctx) + 1}


def _validate(params):
    _validate_b(params)
    tau = params["tau"]
    if not (isinstance(tau, int) and tau >= 1):
        raise ValueError(f"staleness bound tau must be an int >= 1, "
                         f"got {tau!r}")


@register_trigger("staleness", condition=_staleness_condition,
                  init_extra=_staleness_init,
                  commit_extra=_staleness_commit,
                  skip_extra=_staleness_skip,
                  params={"b": 1, "tau": 5}, validate=_validate,
                  contract=StageContract(
                      summary="conditional gate on the per-learner "
                              "rounds-since-sync counters",
                      extra_state=(("staleness", "int32"),)))
def trigger_staleness(ctx: StageCtx) -> bool:
    """Gate: check every ``b`` rounds (b = 1: every round); the condition
    fires when any reachable learner's rounds-since-last-sync reach
    ``tau``."""
    return cadence_fire(ctx.params["b"], ctx.t)


# b = 1 is pinned: pinned preset params win over the ProtocolConfig
# overlay (whose b default is 10), so kind="stale" behaves as this spec;
# tau and b are tuned through BOUNDED_STALENESS.with_params(...)
BOUNDED_STALENESS = ProtocolSpec(
    name="stale", trigger="staleness", cohort="all_reachable",
    aggregate="mean", commit="average", params={"b": 1})

register_protocol("stale", BOUNDED_STALENESS)
