"""Event-driven asynchronous synchronization and over-the-air aggregation
— the counterpart of ``repro.core.sync.async_sync``.

* **Event-driven triggers** ``"events"`` / ``"events_divergence"``: the
  cadence, staleness and divergence conditions on a per-learner LOCAL
  clock with messages in flight. Each learner carries, in
  ``SyncState.extra`` (host int32 arrays):

  - ``lclock`` (m,): its idle-round phase within its cadence period (it
    advances only while the learner is idle);
  - ``inflight`` (m,): rounds until its launched exchange lands;
  - ``ring`` (m, max_delay): the bounded-delay arrival buffer
    (``repro_torch.network.events``);
  - ``age`` (m,): rounds since the learner last synced.

  A learner whose alarm holds (local tick, staleness deadline or
  divergence violation) LAUNCHES an exchange that flies
  ``k = ceil(round_trip / budget) - 1`` whole rounds and joins a sync at
  its arrival round. ``k = 0`` reduces every composition exactly to its
  synchronous original. An arrival at an unreachable learner is
  dropped; the learner goes idle and re-launches at its next alarm.

* **``"aircomp"`` aggregate**: the cohort mean over an analog
  multiple-access channel, plus Gaussian receiver noise ``snr_db`` below
  the aggregate's RMS, attenuated by the cohort size. The draw is pure
  in ``(air_seed, t)`` and is made where the plane lives: once over the
  plane row on the flat layout, once per leaf on the tree layout (which
  runs on the same plane; ``StageCtx.leaf_sizes`` gives the leaves).

* **``"aircomp"`` commit**: ONE shared-medium exchange in the paper's
  c(f) (``model_up = model_down = 1`` a sync), while the per-link ledger
  bills each member's analog frame (1 transfer per member link), so the
  ledger's sum is deliberately not c(f).

``asyncify`` rewrites a synchronous spec onto the timeline (the engine's
``async_net=`` hook); ``"aircomp"``, ``"async_periodic"`` and
``"async_dynamic"`` are registered presets.

Departures from the reference: the timeline is host numpy, like the
rest of the port's carried state. The divergence monitoring pass on a
round without a sync runs only when some learner could launch (a tick
on an idle learner with a slow link): the reference computes it on every
skip round, and its result is all False otherwise, so the launches, and
with them every output, are the same; ``sqdist_rows`` runs once per
round whose gate fires.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.sync.registry import (
    CohortOut, CommRecord, StageCtx, SyncOut, carried_v, register_aggregate,
    register_commit, register_protocol, register_trigger,
)
from repro_torch.core.sync.spec import ProtocolSpec
from repro_torch.core.sync.stages import (
    _select_commit, _validate_b, aggregate_mean_batched,
    aggregate_mean_stage, host_dists, zeros_i32,
)
from repro_torch.network import events

_EXTRA_KEYS = ("age", "inflight", "lclock", "ring")


# ---------------------------------------------------------------------------
# the shared timeline: extra-state keys and the per-round transition
# ---------------------------------------------------------------------------

def _timeline(ctx: StageCtx) -> dict:
    """This round's decoded timeline: who is due (their exchange lands at
    round t), who is idle (free to launch), and whose local cadence
    ticks."""
    extra = ctx.state.extra
    missing = [k for k in _EXTRA_KEYS if k not in extra]
    if missing:
        raise ValueError(
            f"the event-driven triggers carry {list(_EXTRA_KEYS)} in "
            f"SyncState.extra (missing: {missing}) — build the state with "
            f"init_state(ref, seed, spec=spec, m=m) (the engine does this "
            f"automatically)")
    p = ctx.params
    k = events.flight_rounds(p["link_classes"], ctx.m, p["payload_bytes"],
                             p["budget"])
    return {"ring": extra["ring"], "inflight": extra["inflight"],
            "lclock": extra["lclock"], "age": extra["age"], "k": k,
            "due": events.due_mask(extra["ring"], ctx.t),
            "idle": extra["inflight"] == 0,
            # the LOCAL cadence: flight rounds and the arrival round do
            # not advance the phase
            "tick": ((extra["lclock"] + 1) % p["b"]) == 0}


def _advance(ctx: StageCtx, tl: dict, launch, mask) -> dict:
    """One timeline transition: consume arrivals, schedule launches,
    advance idle local clocks, age everyone (``mask``, the committed
    cohort, resets its ages; None on rounds without a sync)."""
    advance = tl["idle"] & ~tl["due"]
    age = tl["age"] + 1
    if mask is not None:
        age = np.where(mask, 0, age)
    return {
        "age": age.astype(np.int32),
        "inflight": np.where(launch, tl["k"],
                             np.maximum(tl["inflight"] - 1, 0))
        .astype(np.int32),
        "lclock": np.where(advance, (tl["lclock"] + 1) % ctx.params["b"],
                           tl["lclock"]).astype(np.int32),
        "ring": events.ring_step(tl["ring"], ctx.t, launch, tl["k"])}


def _events_init(params, m: int) -> dict:
    return {"age": np.zeros((m,), np.int32),
            "inflight": np.zeros((m,), np.int32),
            "lclock": np.zeros((m,), np.int32),
            "ring": events.empty_ring(m, params["max_delay"])}


def _validate_delay(params) -> None:
    budget = params["budget"]
    if not (isinstance(budget, (int, float)) and budget > 0):
        raise ValueError(f"round budget must be > 0 seconds, got {budget!r}")
    depth = params["max_delay"]
    if not (isinstance(depth, int) and depth >= 1):
        raise ValueError(f"max_delay must be an int >= 1, got {depth!r}")
    payload = params["payload_bytes"]
    if not (isinstance(payload, int) and payload >= 0):
        raise ValueError(
            f"payload_bytes must be an int >= 0, got {payload!r}")
    kmax = events.max_flight_rounds(params["link_classes"], payload,
                                    float(budget))
    if kmax >= depth:
        raise ValueError(
            f"slowest link class flies {kmax} rounds but the arrival ring "
            f"only holds max_delay={depth} — raise max_delay above {kmax}, "
            f"raise the round budget, or shrink the payload")


def _fire(ctx: StageCtx, tl: dict, alarm) -> np.ndarray:
    """Who joins a sync this round, reachable or not: arrivals, and alarms
    on zero-flight links (the synchronous limit)."""
    return (tl["due"] & ctx.reach) | (alarm & (tl["k"] == 0))


# ---------------------------------------------------------------------------
# trigger "events": cadence / staleness alarms on the local clock
# ---------------------------------------------------------------------------

def _events_alarm(ctx: StageCtx, tl: dict) -> np.ndarray:
    """Who wants to launch: the cadence base is unmasked (the schedule
    does not depend on reachability); the staleness base is the
    reach-masked deadline on the carried ages."""
    alarm = tl["tick"] & tl["idle"] & ~tl["due"]
    if ctx.params["base"] == "staleness":
        alarm &= ctx.reach & (tl["age"] + 1 >= ctx.params["tau"])
    return alarm


def _events_condition(ctx: StageCtx):
    tl = _timeline(ctx)
    fire = _fire(ctx, tl, _events_alarm(ctx, tl))
    # nhot counts UNMASKED fires, so the pipeline runs whenever the
    # synchronous original's would (the fedavg draws follow the runs)
    return fire & ctx.reach, int(fire.sum())


def _events_commit(ctx: StageCtx, mask) -> dict:
    tl = _timeline(ctx)
    return _advance(ctx, tl, _events_alarm(ctx, tl) & (tl["k"] > 0), mask)


def _events_skip(ctx: StageCtx) -> dict:
    # launch-only rounds land here: the ring still records them
    tl = _timeline(ctx)
    return _advance(ctx, tl, _events_alarm(ctx, tl) & (tl["k"] > 0), None)


def _validate_events(params) -> None:
    _validate_b(params)
    _validate_delay(params)
    if params["base"] not in ("cadence", "staleness"):
        raise ValueError(
            f"events base must be cadence|staleness, got {params['base']!r}")
    tau = params["tau"]
    if not (isinstance(tau, int) and tau >= 1):
        raise ValueError(f"staleness bound tau must be an int >= 1, "
                         f"got {tau!r}")


def _events_gate(ctx: StageCtx) -> bool:
    """Any local tick on an idle learner, or any arrival this round."""
    tl = _timeline(ctx)
    return bool(np.any(tl["tick"] & tl["idle"]) or np.any(tl["due"]))


register_trigger(
    "events", condition=_events_condition, init_extra=_events_init,
    commit_extra=_events_commit, skip_extra=_events_skip,
    params={"base": "cadence", "b": 1, "tau": 5, "budget": 1.0,
            "max_delay": 8, "link_classes": "", "payload_bytes": 0},
    validate=_validate_events)(_events_gate)


# ---------------------------------------------------------------------------
# trigger "events_divergence": sigma_Delta's condition on the local clock
# ---------------------------------------------------------------------------

def _events_div_alarm(ctx: StageCtx, tl: dict, dists) -> np.ndarray:
    violated = (dists > np.float32(ctx.params["delta"])) & ctx.reach
    return violated & tl["tick"] & tl["idle"] & ~tl["due"]


def _events_div_condition(ctx: StageCtx):
    tl = _timeline(ctx)
    dists = host_dists(ctx)
    alarm = _events_div_alarm(ctx, tl, dists)
    # fire is reach-masked already; its count feeds the balanced cohort's
    # violation counter, a learner counted the round it PARTICIPATES
    fire = _fire(ctx, tl, alarm)
    return fire, int(fire.sum()), {"dists": dists,
                                   "launch": alarm & (tl["k"] > 0)}


def _events_div_launch(ctx: StageCtx, tl: dict) -> np.ndarray:
    """The launch set: the condition's when it ran, else the monitoring
    pass, which runs only if some learner could launch."""
    if isinstance(ctx.cond_aux, dict) and "launch" in ctx.cond_aux:
        return ctx.cond_aux["launch"]
    could = tl["tick"] & tl["idle"] & ~tl["due"] & ctx.reach & (tl["k"] > 0)
    if not could.any():
        return could
    return _events_div_alarm(ctx, tl, host_dists(ctx)) & (tl["k"] > 0)


def _events_div_commit(ctx: StageCtx, mask) -> dict:
    tl = _timeline(ctx)
    return _advance(ctx, tl, _events_div_launch(ctx, tl), mask)


def _events_div_skip(ctx: StageCtx) -> dict:
    tl = _timeline(ctx)
    return _advance(ctx, tl, _events_div_launch(ctx, tl), None)


def _validate_events_div(params) -> None:
    _validate_b(params)
    _validate_delay(params)
    if not params["delta"] > 0:
        raise ValueError(
            f"divergence threshold delta must be > 0, got {params['delta']!r}")


register_trigger(
    "events_divergence", condition=_events_div_condition,
    init_extra=_events_init, commit_extra=_events_div_commit,
    skip_extra=_events_div_skip,
    params={"b": 1, "delta": 0.5, "budget": 1.0, "max_delay": 8,
            "link_classes": "", "payload_bytes": 0},
    validate=_validate_events_div)(_events_gate)


# ---------------------------------------------------------------------------
# aggregate + commit "aircomp": over-the-air analog superposition
# ---------------------------------------------------------------------------

def _validate_air(params) -> None:
    snr = params["snr_db"]
    if not isinstance(snr, (int, float)):
        raise ValueError(f"snr_db must be a number, got {snr!r}")
    if not isinstance(params["air_seed"], int):
        raise ValueError(f"air_seed must be an int, "
                         f"got {params['air_seed']!r}")


def _air_noise(ctx: StageCtx, mean: torch.Tensor,
               n: torch.Tensor) -> torch.Tensor:
    """``mean + (rms * scale / n) * eps`` in f32 over each noise segment
    of the row(s) ``mean`` (P,) or (g, P): the whole row on the flat
    layout, each leaf on the tree layout. ``n`` broadcasts against the
    rows' leading axes. The segment's eps is
    ``normal(fold_in(fold_in(key(air_seed ^ 0xA17C0), t), i), size)``,
    drawn on the plane's device; every row of a batch gets the same
    draw, as the reference's vmap does."""
    dev = mean.device
    if ctx.params["layout"] == "tree":
        if ctx.leaf_sizes is None:
            raise ValueError("aircomp on the tree layout draws per leaf: "
                             "the round needs leaf_sizes")
        sizes = ctx.leaf_sizes
    else:
        sizes = (mean.shape[-1],)
    scale = torch.tensor(10.0 ** (-float(ctx.params["snr_db"]) / 20.0),
                         dtype=torch.float32, device=dev)
    key = prng.fold_in(prng.key(ctx.params["air_seed"] ^ 0xA17C0,
                                device=dev), ctx.t, device=dev)
    out, at = [], 0
    for i, size in enumerate(sizes):
        x = mean[..., at:at + size].float()
        rms = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True)
                         + torch.tensor(1e-12, dtype=torch.float32,
                                        device=dev))
        eps = prng.normal(prng.fold_in(key, i, device=dev), (size,),
                          device=dev)
        out.append((x + (rms * scale / n) * eps).to(mean.dtype))
        at += size
    return torch.cat(out, dim=-1)


def _cohort_size(cout: CohortOut, m: int, like: torch.Tensor):
    """The cohort size n as f32, shaped to broadcast over the rows."""
    n = (np.full(np.shape(cout.mask)[:-1] + (1,), m, np.float32)
         if cout.ideal
         else np.maximum(cout.mask.sum(axis=-1, keepdims=True), 1)
         .astype(np.float32))
    return torch.from_numpy(n).to(like.device)


def aggregate_aircomp_batched(ctx: StageCtx, cout: CohortOut):
    """``aggregate_aircomp`` for every cluster of a hierarchy's intra
    tier: (g, k, P) -> (g, P)."""
    mean = aggregate_mean_batched(ctx, cout)
    return _air_noise(ctx, mean, _cohort_size(cout, ctx.m, mean))


@register_aggregate("aircomp", params={"snr_db": 20.0, "air_seed": 0},
                    validate=_validate_air,
                    batched=aggregate_aircomp_batched)
def aggregate_aircomp(ctx: StageCtx, cout: CohortOut) -> torch.Tensor:
    """The cohort mean as the analog channel computes it: the superposed
    waveform is the sum, and the receiver adds Gaussian noise at
    ``snr_db`` below the aggregate's RMS; n aligned transmissions add
    amplitudes, so the post-averaging noise std shrinks as 1/n."""
    mean = aggregate_mean_stage(ctx, cout)
    return _air_noise(ctx, mean, _cohort_size(cout, ctx.m, mean)[0])


@register_commit("aircomp", needs=("full-cohort",))
def commit_aircomp(ctx: StageCtx, cout: CohortOut, mean, hot,
                   nhot) -> SyncOut:
    """The analog channel's pricing: the simultaneous uplink plus the
    broadcast downlink are ONE exchange in c(f), while the ledger bills
    every member's radio one analog frame of airtime."""
    m = ctx.m
    newcfg = _select_commit(ctx.flat, cout.mask, mean)
    if cout.ideal:
        return SyncOut(newcfg, mean, carried_v(ctx, cout), cout.key,
                       CommRecord(1, 1, 0, 1, 1), np.ones((m,), np.int32),
                       zeros_i32(m))
    moved = int(cout.mask.sum() > 0)
    return SyncOut(newcfg, mean if moved else ctx.ref_flat,
                   carried_v(ctx, cout), cout.key,
                   CommRecord(moved, moved, 0, moved, moved),
                   cout.mask.astype(np.int32), zeros_i32(m))


# ---------------------------------------------------------------------------
# asyncify: any synchronous spec -> its event-driven counterpart
# ---------------------------------------------------------------------------

_ASYNC_TRIGGER = {
    "cadence": "events",
    "staleness": "events",
    "divergence": "events_divergence",
    "events": "events",
    "events_divergence": "events_divergence",
}


def asyncify(spec: ProtocolSpec, async_net, network=None,
             model_bytes=None) -> ProtocolSpec:
    """Rewrite ``spec`` onto the event-driven timeline: the trigger is
    re-based on the local clock with the ``AsyncConfig``'s delay regime
    (flight times from the ``network``'s link classes and the payload),
    and with ``async_net.aircomp`` the mean/average pair becomes the
    over-the-air stages. ``"never"`` passes through untouched."""
    params = dict(spec.params)
    new_trigger = spec.trigger
    if spec.trigger != "never":
        if spec.trigger not in _ASYNC_TRIGGER:
            raise ValueError(
                f"don't know the event-driven counterpart of trigger "
                f"{spec.trigger!r} — register it (or extend "
                f"async_sync._ASYNC_TRIGGER)")
        new_trigger = _ASYNC_TRIGGER[spec.trigger]
        if spec.trigger in ("cadence", "staleness"):
            params["base"] = spec.trigger
        payload = async_net.payload_bytes
        if payload is None:
            payload = int(model_bytes) if model_bytes else 0
        params.update(
            budget=float(async_net.round_budget),
            max_delay=int(async_net.max_delay),
            link_classes=(",".join(network.link_classes)
                          if network is not None else ""),
            payload_bytes=int(payload))
    aggregate, commit = spec.aggregate, spec.commit
    if async_net.aircomp:
        if not (spec.aggregate == "mean" and spec.commit == "average"):
            raise ValueError(
                f"aircomp models the coordinator mean/average exchange "
                f"over the analog channel — aggregate={spec.aggregate!r}, "
                f"commit={spec.commit!r} has no over-the-air counterpart")
        aggregate, commit = "aircomp", "aircomp"
        params.update(snr_db=float(async_net.snr_db),
                      air_seed=int(async_net.air_seed))
    return ProtocolSpec(
        name=f"async_{spec.name or spec.trigger}", trigger=new_trigger,
        cohort=spec.cohort, aggregate=aggregate, commit=commit,
        params=params)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

# a cadence-synced fleet over the analog channel
AIRCOMP = ProtocolSpec(
    name="aircomp", trigger="cadence", cohort="all_reachable",
    aggregate="aircomp", commit="aircomp")
register_protocol("aircomp", AIRCOMP)

# sigma_b on the event timeline over an lte/edge fleet: edge exchanges fly
# 1 round at the default 1 s budget, lte ones land synchronously
ASYNC_PERIODIC = ProtocolSpec(
    name="async_periodic", trigger="events", cohort="all_reachable",
    aggregate="mean", commit="average",
    params={"link_classes": "lte,edge", "payload_bytes": 100_000})
register_protocol("async_periodic", ASYNC_PERIODIC)

# sigma_Delta on the event timeline: violations on slow links fly before
# they join the balancing augmentation
ASYNC_DYNAMIC = ProtocolSpec(
    name="async_dynamic", trigger="events_divergence", cohort="balanced",
    aggregate="mean", commit="balancing",
    params={"link_classes": "lte,edge", "payload_bytes": 100_000})
register_protocol("async_dynamic", ASYNC_DYNAMIC)
