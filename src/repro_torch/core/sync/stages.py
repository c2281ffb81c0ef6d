"""Stage library on the flat fleet plane — the counterpart of
``repro.core.sync.stages``.

A round of any operator factors into

* **trigger**   — should the sync machinery run at all? (cadence
                  ``t % b``, or sigma_Delta's divergence condition)
* **cohort**    — WHO participates: everyone, or the balancing
                  augmentation's growing set
* **aggregate** — WHAT they agree on: the (weighted) cohort mean
* **commit**    — APPLY and ACCOUNT: cohort rows adopt the mean,
                  reference / violation-counter updates, ``CommRecord``,
                  per-link transfer and message counts

Only the plane forms are ported, and only the stages of the nosync,
periodic, continuous and dynamic presets. On the plane the per-learner
distances are one ``sqdist_rows`` pass, the mean one ``w @ X`` matvec
(or a row mean), and the balancing augmentation keeps an incremental
running sum, so each augmentation step costs O(P).

Departures from the reference: commits write the ``(m, P)`` plane in
place (the reference builds a new one); masks, counters and the
augmentation priority are host values, so the augmentation loop reads
one f32 distance back from the device per step, and its argmax runs on
the host (ties go to the lowest index, as ``jnp.argmax``).
``augmentation="random"`` raises ``NotImplementedError``: it needs the
reference's threefry stream (ROADMAP Queue A 10).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.divergence import per_learner_sq_distance_flat
from repro_torch.core.sync.registry import (
    CohortOut, CommRecord, StageCtx, SyncOut, carried_v, register_aggregate,
    register_cohort, register_commit, register_trigger,
)


def zeros_i32(m: int) -> np.ndarray:
    return np.zeros((m,), np.int32)


def _on(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host bool mask as a 0/1 vector in the plane's dtype and device."""
    return torch.from_numpy(mask).to(device=like.device, dtype=like.dtype)


# ---------------------------------------------------------------------------
# plane arithmetic
# ---------------------------------------------------------------------------

def flat_weighted_mean(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Masked/weighted mean over the plane's rows: ``w @ X / sum(w)`` —
    one matvec. An all-zero weight vector yields the zero row."""
    w = w.to(X.dtype)
    wsum = torch.sum(w)
    denom = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return (w @ X) / denom


def flat_aggregate_mean(X: torch.Tensor, mask: np.ndarray,
                        weights=None) -> torch.Tensor:
    """The (optionally B^i-weighted) mean of the masked rows."""
    w = _on(mask, X)
    if weights is not None:
        w = w * weights.to(X.dtype)
    return flat_weighted_mean(X, w)


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


def cohort_balanced_flat(delta: float, augmentation: str, X: torch.Tensor,
                         ref: torch.Tensor, violated: np.ndarray, weights,
                         reach: np.ndarray, dists: np.ndarray) -> np.ndarray:
    """The balancing augmentation (Algorithm 1): grow the violator set B,
    highest distance first, until the partial average re-enters the safe
    zone ``||mean_B - r||^2 <= Delta`` or B covers every reachable
    learner. The running sum ``(sum_B, wsum_B)`` adds one row per step.
    ``dists`` are the (m,) host distances the trigger already computed
    (the priority). Returns the mask B; the aggregate stage computes the
    mean (the reference also returns it, then discards it)."""
    m = X.shape[0]
    if augmentation == "all":   # jump straight to full sync
        return reach.copy()
    w = (weights.to(X.dtype) if weights is not None
         else torch.ones((m,), dtype=X.dtype, device=X.device))
    w0 = _on(violated, X) * w
    s = w0 @ X
    ws = torch.sum(w0)
    d = _safe_dist(s, ws, ref)
    mask = violated.copy()
    delta32 = np.float32(delta)
    while (reach & ~mask).any() and d > delta32:
        cand = np.where(mask | ~reach, np.float32(-np.inf), dists)
        nxt = int(np.argmax(cand))
        mask[nxt] = True
        s = s + w[nxt] * X[nxt]
        ws = ws + w[nxt]
        d = _safe_dist(s, ws, ref)
    return mask


def _select_commit(X: torch.Tensor, mask: np.ndarray,
                   mean: torch.Tensor) -> torch.Tensor:
    """Cohort rows adopt the aggregate, in place."""
    if mask.all():
        X.copy_(mean.expand_as(X))
    else:
        idx = torch.from_numpy(np.flatnonzero(mask)).to(X.device)
        X[idx] = mean
    return X


def xfers_cohort(mask: np.ndarray) -> np.ndarray:
    """Coordinator-link transfer counts: each cohort member's link carries
    its model up and the aggregate back down (2 per member)."""
    return mask.astype(np.int32) * 2


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


def _validate_balanced(params):
    if params["augmentation"] not in ("max_distance", "random", "all"):
        raise ValueError(
            f"augmentation must be max_distance|random|all, "
            f"got {params['augmentation']!r}")
    if not params["delta"] > 0:
        raise ValueError(
            f"balanced cohort needs delta > 0, got {params['delta']!r}")
    if params["augmentation"] == "random":
        raise NotImplementedError(
            "augmentation='random' is not ported yet: it needs the "
            "reference's threefry stream (ROADMAP Queue A 10)")


# ---- triggers -------------------------------------------------------------

@register_trigger("never")
def trigger_never(ctx: StageCtx) -> bool:
    """nosync's trigger: never fires."""
    return False


@register_trigger("cadence", params={"b": 1}, validate=_validate_b)
def trigger_cadence(ctx: StageCtx) -> bool:
    """sigma_b's trigger: fire every ``b`` rounds, unconditionally."""
    return cadence_fire(ctx.params["b"], ctx.t)


def _divergence_condition(ctx: StageCtx):
    """Which reachable learners violate ``||f_i - r||^2 > Delta``; the f32
    compare runs on the host copy of the kernel's distances, which also
    serve as the balancing priority."""
    dists = per_learner_sq_distance_flat(ctx.flat, ctx.ref_flat)
    dists = dists.cpu().numpy()
    violated = (dists > np.float32(ctx.params["delta"])) & ctx.reach
    return violated, int(violated.sum()), {"dists": dists}


@register_trigger("divergence", condition=_divergence_condition,
                  params={"b": 1, "delta": 0.5}, validate=_validate_delta)
def trigger_divergence(ctx: StageCtx) -> bool:
    """sigma_Delta's trigger: check every ``b`` rounds (the gate); the
    condition marks learners with ``||f_i - r||^2 > Delta``."""
    return cadence_fire(ctx.params["b"], ctx.t)


# ---- cohorts --------------------------------------------------------------

@register_cohort("all_reachable", provides=("full-cohort",))
def cohort_all_stage(ctx: StageCtx, hot, nhot) -> CohortOut:
    """sigma_b's cohort: the whole fleet (the network is ideal)."""
    return CohortOut(mask=ctx.reach, ideal=True)


@register_cohort("balanced", provides=("balance",), needs_condition=True,
                 params={"delta": 0.5, "augmentation": "max_distance"},
                 validate=_validate_balanced)
def cohort_balanced_stage(ctx: StageCtx, hot, nhot) -> CohortOut:
    """sigma_Delta's cohort: coordinator balancing. Owns the violation
    counter: the hot count accumulates into ``v``, ``v >= m`` forces a
    sync of every reachable learner, and any sync covering every
    reachable learner resets it."""
    v_new = ctx.state.v + nhot
    force_full = v_new >= ctx.m
    base = ctx.reach if force_full else hot
    v_reset = 0 if force_full else v_new
    mask = cohort_balanced_flat(
        ctx.params["delta"], ctx.params["augmentation"], ctx.flat,
        ctx.ref_flat, base, ctx.weights, ctx.reach, ctx.cond_aux["dists"])
    full = bool(np.all(mask == ctx.reach))
    return CohortOut(mask=mask, v=0 if full else v_reset, full=full)


# ---- aggregates -----------------------------------------------------------

@register_aggregate("mean")
def aggregate_mean_stage(ctx: StageCtx, cout: CohortOut) -> torch.Tensor:
    """The cohort's (weighted) mean: a plain row mean for the unweighted
    full fleet, else one masked matvec."""
    if cout.ideal and ctx.weights is None:
        return torch.mean(ctx.flat, dim=0)
    return flat_aggregate_mean(ctx.flat, cout.mask, ctx.weights)


# ---- commits --------------------------------------------------------------

@register_commit("average", needs=("full-cohort",))
def commit_average(ctx: StageCtx, cout: CohortOut, mean, hot,
                   nhot) -> SyncOut:
    """sigma_b's commit: every learner adopts the aggregate and the
    reference moves to it; each learner's link carries 2 models."""
    m = ctx.m
    rec = CommRecord(model_up=m, model_down=m, messages=0, syncs=1,
                     full_syncs=1)
    return SyncOut(_select_commit(ctx.flat, cout.mask, mean), mean,
                   carried_v(ctx, cout), rec, np.full((m,), 2, np.int32),
                   zeros_i32(m))


@register_commit("balancing", needs=("balance",), needs_condition=True)
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
    return SyncOut(newcfg, new_ref, carried_v(ctx, cout), rec,
                   xfers_cohort(mask), link_msgs)
