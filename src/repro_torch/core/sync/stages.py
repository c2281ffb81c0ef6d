"""Stage library on the flat fleet plane — the counterpart of
``repro.core.sync.stages``.

A round of any operator factors into

* **trigger**   — should the sync machinery run at all? (cadence
                  ``t % b``, sigma_Delta's divergence condition, or the
                  bounded-staleness counters of ``staleness.py``)
* **cohort**    — WHO participates: everyone reachable, a random
                  C-fraction, the balancing augmentation's growing set,
                  or a neighborhood mixing matrix — all availability-masked
* **aggregate** — WHAT they agree on: the (weighted) cohort mean, or one
                  Metropolis–Hastings mixing step
* **commit**    — APPLY and ACCOUNT: cohort rows adopt the aggregate,
                  reference / violation-counter updates, ``CommRecord``,
                  per-link transfer and message counts

Only the plane forms are ported. On the plane the per-learner distances
are one ``sqdist_rows`` pass, the mean one ``w @ X`` matvec (or a row
mean), gossip's mixing step one ``W @ X`` product, and the balancing
augmentation keeps an incremental running sum, so each augmentation
step costs O(P). Every stage has the reference's two branches: the
ideal network (``ctx.active is None``), whose expressions are those of
the pre-network engine, bit for bit, and the availability-masked one.

Departures from the reference: commits write the ``(m, P)`` plane in
place (the reference builds a new one); masks, counters and the
augmentation priority are host values, so the augmentation loop reads
one f32 distance back from the device per step, and its argmax runs on
the host (ties go to the lowest index, as ``jnp.argmax``). The draws —
FedAvg's cohort (``prng.permutation``, or under availability a rank of
``prng.uniform`` draws) and the random augmentation's priority
(``prng.uniform``) — come from the round's host key, the reference's
threefry stream bit for bit. Gossip's active overlay and f32 mixing
matrix are built on the host (m × m) and the product ``W @ X`` runs
where the plane lives.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import shard
from repro_torch.core.divergence import per_learner_sq_distance_flat
from repro_torch.core.sync.registry import (
    CohortOut, CommRecord, StageContract, StageCtx, SyncOut, carried_v,
    register_aggregate, register_cohort, register_commit, register_trigger,
)
from repro_torch.device import host_to_device


def zeros_i32(m: int) -> np.ndarray:
    return np.zeros((m,), np.int32)


def _on(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host bool mask as a 0/1 vector in the plane's dtype and device
    (sent without a host sync)."""
    return host_to_device(mask, like.device).to(like.dtype)


# ---------------------------------------------------------------------------
# plane arithmetic
# ---------------------------------------------------------------------------

def flat_weighted_mean(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Masked/weighted mean over the plane's rows: ``w @ X / sum(w)`` —
    one matvec (on a row-sharded plane, ``shard.row_sum``). An all-zero
    weight vector yields the zero row."""
    w = w.to(X.dtype)
    wsum = torch.sum(w)
    denom = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return shard.row_sum(X, w) / denom


def flat_aggregate_mean(X: torch.Tensor, mask: np.ndarray,
                        weights=None) -> torch.Tensor:
    """The (optionally B^i-weighted) mean of the masked rows."""
    w = _on(mask, X)
    if weights is not None:
        w = w * weights.to(X.dtype)
    return flat_weighted_mean(X, w)


def batched_aggregate_mean(X: torch.Tensor, mask: np.ndarray,
                           weights=None) -> torch.Tensor:
    """``flat_aggregate_mean`` for every cluster at once: X (g, k, P),
    mask and weights (g, k) -> (g, P), one batched matvec. A cluster
    with no weight gets the zero row."""
    w = _on(mask, X)
    if weights is not None:
        w = w * weights.to(X.dtype)
    wsum = torch.sum(w, dim=1, keepdim=True)
    denom = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return torch.bmm(w[:, None, :], X)[:, 0] / denom


def host_dists(ctx: StageCtx) -> np.ndarray:
    """The (m,) f32 distances ``||f_i - r||^2`` of the round's plane on
    the host: the context's own (a cluster's slice of one grouped pass),
    or one ``sqdist_rows`` pass and one fetch (on a row-sharded plane,
    each rank's pass over its rows, gathered)."""
    if ctx.dists is not None:
        return ctx.dists()
    return shard.gather_rows(
        per_learner_sq_distance_flat(ctx.flat, ctx.ref_flat)).cpu().numpy()


def _safe_dist(s: torch.Tensor, ws: torch.Tensor,
               ref: torch.Tensor) -> np.float32:
    """``||s / ws - r||^2`` (the zero row for ws = 0), read back to the
    host as f32 for the safe-zone test."""
    denom = torch.where(ws > 0, ws, torch.ones_like(ws))
    d = s / denom - ref
    return np.float32(torch.sum(d * d).item())


def cadence_fire(b: int, t: int) -> bool:
    """The schedule half of every trigger: fire when ``t % b == 0``."""
    return t % b == 0


def cohort_all(m: int, active) -> np.ndarray:
    """sigma_b's cohort: every reachable learner."""
    return np.ones((m,), bool) if active is None else active


def cohort_fraction_ideal(sub: torch.Tensor, m: int, k: int) -> np.ndarray:
    """FedAvg's cohort on an ideal network: the first k entries of a
    random permutation of the fleet, drawn from the host key ``sub``."""
    mask = np.zeros((m,), bool)
    mask[prng.permutation(sub, m, device="cpu")[:k].numpy()] = True
    return mask


def cohort_fraction_masked(sub: torch.Tensor, m: int, k: int,
                           active: np.ndarray) -> np.ndarray:
    """FedAvg's cohort under availability: rank the reachable learners by
    a fresh uniform draw and take the top min(k, |active|). The ranks are
    ``argsort(argsort(where(active, r, -inf)))`` with stable sorts, as
    ``jnp.argsort``'s, so the ties among the -inf rows rank by index."""
    r = prng.uniform(sub, (m,), device="cpu").numpy()
    keyed = np.where(active, r, np.float32(-np.inf))
    ranks = np.argsort(np.argsort(keyed, kind="stable"), kind="stable")
    return (ranks >= m - min(k, int(active.sum()))) & active


def cohort_neighborhood(m: int, active, adjacency: np.ndarray):
    """Gossip's cohort: the availability-masked peer overlay ``A`` and its
    Metropolis–Hastings mixing matrix, in f32,
        W_ij = 1 / (1 + max(deg_i, deg_j))   for active edges i~j
        W_ii = 1 - sum_j W_ij,
    doubly stochastic for a symmetric overlay, so the fleet mean is
    kept. An unreachable or isolated learner has W row e_i and keeps its
    model. Returns host ``(A, W)``."""
    act = cohort_all(m, active)
    A = (np.asarray(adjacency, bool) & act[None, :] & act[:, None]
         & ~np.eye(m, dtype=bool))
    deg = A.sum(axis=1).astype(np.float32)
    W = np.where(A, np.float32(1.0) / (np.float32(1.0)
                                       + np.maximum(deg[:, None],
                                                    deg[None, :])),
                 np.float32(0.0))
    W = W + np.diag(np.float32(1.0) - W.sum(axis=1, dtype=np.float32))
    return A, W


def cohort_balanced_flat(delta: float, augmentation: str, X: torch.Tensor,
                         ref: torch.Tensor, violated: np.ndarray,
                         sub: torch.Tensor, weights, reach: np.ndarray,
                         dists: np.ndarray) -> np.ndarray:
    """The balancing augmentation (Algorithm 1): grow the violator set B,
    highest priority first, until the partial average re-enters the safe
    zone ``||mean_B - r||^2 <= Delta`` or B covers every reachable
    learner. The running sum ``(sum_B, wsum_B)`` adds one row per step.
    The priority is ``dists``, the (m,) host distances the trigger
    already computed (``max_distance``), or a uniform draw from the host
    key ``sub`` (``random``). Returns the mask B; the aggregate stage
    computes the mean (the reference also returns it, then discards
    it). On a row-sharded plane the sums are ``shard.row_sum`` and the
    added row comes from its owner."""
    m = reach.shape[0]
    if augmentation == "all":   # jump straight to full sync
        return reach.copy()
    prio = (prng.uniform(sub, (m,), device="cpu").numpy()
            if augmentation == "random" else dists)
    w = (weights.to(X.dtype) if weights is not None
         else torch.ones((m,), dtype=X.dtype, device=X.device))
    w0 = _on(violated, X) * w
    s = shard.row_sum(X, w0)
    ws = torch.sum(w0)
    d = _safe_dist(s, ws, ref)
    mask = violated.copy()
    delta32 = np.float32(delta)
    while (reach & ~mask).any() and d > delta32:
        cand = np.where(mask | ~reach, np.float32(-np.inf), prio)
        nxt = int(np.argmax(cand))
        mask[nxt] = True
        s = s + w[nxt] * shard.plane_row(X, nxt)
        ws = ws + w[nxt]
        d = _safe_dist(s, ws, ref)
    return mask


def _select_commit(X: torch.Tensor, mask: np.ndarray,
                   mean: torch.Tensor) -> torch.Tensor:
    """Cohort rows adopt the aggregate, in place (this rank's rows of a
    row-sharded plane)."""
    return shard.select_rows(X, mask, mean)


def xfers_cohort(mask: np.ndarray) -> np.ndarray:
    """Coordinator-link transfer counts: each cohort member's link carries
    its model up and the aggregate back down (2 per member)."""
    return mask.astype(np.int32) * 2


def xfers_neighborhood(A: np.ndarray) -> np.ndarray:
    """Gossip transfer counts: every exchanged model occupies the links of
    both endpoints, so ``sum(xfers) == 2 * (model_up + model_down)``."""
    return (2 * A.sum(axis=1)).astype(np.int32)


# ===========================================================================
# registered stages
# ===========================================================================

def _validate_b(params):
    b = params["b"]
    if not (isinstance(b, int) and b >= 1):
        raise ValueError(f"cadence period b must be an int >= 1, got {b!r}")


def _validate_delta(params):
    _validate_b(params)
    if not params["delta"] > 0:
        raise ValueError(
            f"divergence threshold delta must be > 0, got {params['delta']!r}")


def _validate_fraction(params):
    if not 0.0 < params["fedavg_c"] <= 1.0:
        raise ValueError(
            f"fedavg_c must be in (0, 1], got {params['fedavg_c']!r}")


def _validate_balanced(params):
    if params["augmentation"] not in ("max_distance", "random", "all"):
        raise ValueError(
            f"augmentation must be max_distance|random|all, "
            f"got {params['augmentation']!r}")
    if not params["delta"] > 0:
        raise ValueError(
            f"balanced cohort needs delta > 0, got {params['delta']!r}")


# ---- triggers -------------------------------------------------------------

@register_trigger("never", contract=StageContract(
    summary="never fires; no state, no condition"))
def trigger_never(ctx: StageCtx) -> bool:
    """nosync's trigger: never fires."""
    return False


@register_trigger("cadence", params={"b": 1}, validate=_validate_b,
                  contract=StageContract(
                      summary="gate t % b == 0; stateless"))
def trigger_cadence(ctx: StageCtx) -> bool:
    """sigma_b's trigger: fire every ``b`` rounds, unconditionally."""
    return cadence_fire(ctx.params["b"], ctx.t)


def _divergence_condition(ctx: StageCtx):
    """Which reachable learners violate ``||f_i - r||^2 > Delta``; the f32
    compare runs on the host copy of the kernel's distances, which also
    serve as the balancing priority."""
    dists = host_dists(ctx)
    violated = (dists > np.float32(ctx.params["delta"])) & ctx.reach
    return violated, int(violated.sum()), {"dists": dists}


@register_trigger("divergence", condition=_divergence_condition,
                  params={"b": 1, "delta": 0.5}, validate=_validate_delta,
                  contract=StageContract(
                      summary="conditional gate; threads the (m,) f32 "
                              "monitoring distances to downstream stages",
                      cond_aux=("dists",)))
def trigger_divergence(ctx: StageCtx) -> bool:
    """sigma_Delta's trigger: check every ``b`` rounds (the gate); the
    condition marks learners with ``||f_i - r||^2 > Delta``."""
    return cadence_fire(ctx.params["b"], ctx.t)


# ---- cohorts --------------------------------------------------------------

@register_cohort("all_reachable", provides=("full-cohort",),
                 contract=StageContract(
                     summary="(m,) bool mask = reachability; no counter"))
def cohort_all_stage(ctx: StageCtx, hot, nhot, key) -> CohortOut:
    """sigma_b's cohort: every reachable learner; on the ideal network the
    whole fleet (``ideal=True`` keeps the pre-network expressions)."""
    return CohortOut(mask=cohort_all(ctx.m, ctx.active), key=key,
                     ideal=ctx.active is None)


@register_cohort("fraction", provides=("subset",),
                 params={"fedavg_c": 0.3}, validate=_validate_fraction,
                 contract=StageContract(
                     summary="(m,) bool random C-fraction; subset size k "
                             "in aux", aux=("k",)))
def cohort_fraction_stage(ctx: StageCtx, hot, nhot, key) -> CohortOut:
    """FedAvg's cohort: a random k-subset, ``k = max(1, round(C * m))``
    (Python's round, half to even, as the reference's), drawn from the
    reachable learners under availability masks."""
    k = max(1, int(round(ctx.params["fedavg_c"] * ctx.m)))
    key, sub = prng.split(key, device="cpu")
    if ctx.active is None:
        mask = cohort_fraction_ideal(sub, ctx.m, k)
    else:
        mask = cohort_fraction_masked(sub, ctx.m, k, ctx.active)
    return CohortOut(mask=mask, key=key, aux={"k": k})


@register_cohort("balanced", provides=("balance",), needs_condition=True,
                 params={"delta": 0.5, "augmentation": "max_distance"},
                 validate=_validate_balanced,
                 contract=StageContract(
                     summary="balancing augmentation; owns the violation "
                             "counter and the full-sync flag",
                     manages_v=True))
def cohort_balanced_stage(ctx: StageCtx, hot, nhot, key) -> CohortOut:
    """sigma_Delta's cohort: coordinator balancing. Owns the violation
    counter: the hot count accumulates into ``v``, ``v >= m`` forces a
    sync of every reachable learner, and any sync covering every
    reachable learner resets it. It splits the key on every sync, whatever
    the augmentation, as the reference does."""
    key, sub = prng.split(key, device="cpu")
    v_new = ctx.state.v + nhot
    force_full = v_new >= ctx.m
    base = ctx.reach if force_full else hot
    v_reset = 0 if force_full else v_new
    dists = (ctx.cond_aux or {}).get("dists")
    if dists is None and ctx.params["augmentation"] == "max_distance":
        # a trigger without distances (staleness): one monitoring pass
        dists = host_dists(ctx)
    mask = cohort_balanced_flat(
        ctx.params["delta"], ctx.params["augmentation"], ctx.flat,
        ctx.ref_flat, base, sub, ctx.weights, ctx.reach, dists)
    full = bool(np.all(mask == ctx.reach))
    return CohortOut(mask=mask, key=key, v=0 if full else v_reset,
                     full=full)


@register_cohort("neighborhood", provides=("mixing",), uses_overlay=True,
                 uses_coordinator=False,
                 contract=StageContract(
                     summary="peer overlay cohort: (m, m) bool active "
                             "adjacency A + f32 mixing matrix W in aux",
                     aux=("A", "W")))
def cohort_neighborhood_stage(ctx: StageCtx, hot, nhot, key) -> CohortOut:
    """Gossip's cohort: the availability-masked peer overlay and its
    Metropolis–Hastings mixing matrix. No coordinator."""
    if ctx.adjacency is None:
        raise ValueError(
            "gossip needs an adjacency matrix — configure a NetworkConfig "
            "topology (the engine passes it through)")
    A, W = cohort_neighborhood(ctx.m, ctx.active, ctx.adjacency)
    return CohortOut(mask=cohort_all(ctx.m, ctx.active), key=key,
                     aux={"A": A, "W": W})


# ---- aggregates -----------------------------------------------------------

def aggregate_mean_batched(ctx: StageCtx, cout: CohortOut) -> torch.Tensor:
    """The mean stage for every cluster of a hierarchy's intra tier:
    ``ctx.flat`` (g, k, P), ``cout.mask`` (g, k) -> (g, P)."""
    if cout.ideal and ctx.weights is None:
        return torch.mean(ctx.flat, dim=1)
    return batched_aggregate_mean(ctx.flat, cout.mask, ctx.weights)


@register_aggregate("mean", batched=aggregate_mean_batched,
                    contract=StageContract(
                        summary="masked (weighted) cohort mean, a plane "
                                "row", out="model"))
def aggregate_mean_stage(ctx: StageCtx, cout: CohortOut) -> torch.Tensor:
    """The cohort's (weighted) mean: a plain row mean for the unweighted
    full fleet, else one masked matvec."""
    if cout.ideal and ctx.weights is None:
        return shard.row_mean(ctx.flat)
    return flat_aggregate_mean(ctx.flat, cout.mask, ctx.weights)


@register_aggregate("mix", needs=("mixing",), contract=StageContract(
    summary="one M-H mixing step: per-learner output, not a single model",
    out="fleet"))
def aggregate_mix_stage(ctx: StageCtx, cout: CohortOut) -> torch.Tensor:
    """One Metropolis–Hastings mixing step over the neighborhood: one
    ``W @ X`` product on the plane, a new (m, P) plane (on a row-sharded
    plane, this rank's rows of it, from the gathered plane)."""
    W = torch.from_numpy(cout.aux["W"]).to(device=ctx.flat.device,
                                           dtype=ctx.flat.dtype)
    return shard.mix(W, ctx.flat)


# ---- commits --------------------------------------------------------------

@register_commit("average", needs=("full-cohort",), contract=StageContract(
    summary="cohort adopts the mean; ref moves when anyone averaged"))
def commit_average(ctx: StageCtx, cout: CohortOut, mean, hot,
                   nhot) -> SyncOut:
    """sigma_b's commit: every cohort member adopts the aggregate. On the
    ideal network that is every learner, each link carrying 2 models;
    under availability the reference moves only when somebody was
    averaged, and the sync covers every reachable learner."""
    m = ctx.m
    if cout.ideal:
        rec = CommRecord(model_up=m, model_down=m, messages=0, syncs=1,
                         full_syncs=1)
        return SyncOut(_select_commit(ctx.flat, cout.mask, mean), mean,
                       carried_v(ctx, cout), cout.key, rec,
                       np.full((m,), 2, np.int32), zeros_i32(m))
    nsync = int(cout.mask.sum())
    rec = CommRecord(model_up=nsync, model_down=nsync, messages=0,
                     syncs=int(nsync > 0), full_syncs=int(nsync > 0))
    return SyncOut(_select_commit(ctx.flat, cout.mask, mean),
                   mean if nsync > 0 else ctx.ref_flat,
                   carried_v(ctx, cout), cout.key, rec,
                   xfers_cohort(cout.mask), zeros_i32(m))


@register_commit("subset", needs=("subset",), contract=StageContract(
    summary="subset adopts the mean; full when it covered every reachable "
            "learner"))
def commit_subset(ctx: StageCtx, cout: CohortOut, mean, hot,
                  nhot) -> SyncOut:
    """FedAvg's commit: the subset adopts the aggregate and the reference
    moves to it; a sync is full when the subset covered every reachable
    learner (on the ideal network: when k is the whole fleet)."""
    m = ctx.m
    newcfg = _select_commit(ctx.flat, cout.mask, mean)
    if ctx.active is None:
        k = cout.aux["k"]
        rec = CommRecord(model_up=k, model_down=k, messages=0, syncs=1,
                         full_syncs=int(k == m))
        return SyncOut(newcfg, mean, carried_v(ctx, cout), cout.key, rec,
                       xfers_cohort(cout.mask), zeros_i32(m))
    nsel = int(cout.mask.sum())
    rec = CommRecord(
        model_up=nsel, model_down=nsel, messages=0, syncs=int(nsel > 0),
        full_syncs=int(nsel > 0 and nsel == int(ctx.active.sum())))
    return SyncOut(newcfg, mean if nsel > 0 else ctx.ref_flat,
                   carried_v(ctx, cout), cout.key, rec,
                   xfers_cohort(cout.mask), zeros_i32(m))


@register_commit("balancing", needs=("balance",), needs_condition=True,
                 contract=StageContract(
                     summary="balanced cohort adopts the partial average; "
                             "per-link chatter on the sending links"))
def commit_balancing(ctx: StageCtx, cout: CohortOut, mean, hot,
                     nhot) -> SyncOut:
    """sigma_Delta's commit: the balanced cohort adopts the partial
    average, the reference moves only on a full sync (Algorithm 1), and
    the chatter is billed to the links that sent it: a violation notice
    on each violator's link, a poll on each polled member's link."""
    mask, full = cout.mask, cout.full
    newcfg = _select_commit(ctx.flat, mask, mean)
    new_ref = mean if full else ctx.ref_flat
    nsync = int(mask.sum())
    polls = nsync - nhot
    link_msgs = hot.astype(np.int32) + (mask & ~hot).astype(np.int32)
    rec = CommRecord(model_up=nsync, model_down=nsync,
                     messages=nhot + polls, syncs=1, full_syncs=int(full))
    return SyncOut(newcfg, new_ref, carried_v(ctx, cout), cout.key, rec,
                   xfers_cohort(mask), link_msgs)


@register_commit("mix", needs=("mixing",), contract=StageContract(
    summary="every learner adopts its mixing row; transfers occupy both "
            "endpoints' links; the reference never moves"))
def commit_mix(ctx: StageCtx, cout: CohortOut, mixed, hot, nhot) -> SyncOut:
    """Gossip's commit: every learner adopts its mixing-row combination;
    transfers occupy both endpoints' links; the reference never moves
    (there is no coordinator to hold one)."""
    A = cout.aux["A"]
    edges = int(A.sum())                       # directed count = 2E
    up = edges // 2
    na = int(cout.mask.sum())
    rec = CommRecord(
        model_up=up, model_down=edges - up, messages=0,
        syncs=int(edges > 0),
        # "all reachable averaged": the active subgraph is complete
        full_syncs=int(edges > 0 and edges == na * (na - 1)))
    return SyncOut(mixed, ctx.ref_flat, carried_v(ctx, cout), cout.key,
                   rec, xfers_neighborhood(A), zeros_i32(ctx.m))
