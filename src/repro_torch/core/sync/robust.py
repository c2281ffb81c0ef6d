"""Byzantine-robust synchronization: registered defenses for faulty fleets
— the counterpart of ``repro.core.sync.robust``.

The fault plane (``repro_torch.network.faults``) makes learners crash and
rejoin cold, ship NaN/Inf payloads, or sign-flip/scale their parameters.
Against that, plain ``mean`` is defenseless: one non-finite row poisons
the committed configuration and the reference model for good. The
defenses are registered stages:

* **robust aggregates** — coordinate-wise ``trimmed_mean`` (drop the
  ``floor(trim_frac * n)`` smallest and largest finite values per
  coordinate, mean the rest) and ``median``. A NaN/Inf entry is left
  out of its coordinate's order statistics. Both ignore Algorithm-2
  weights by design (an adversary would claim the largest B^i).
* **the ``quarantine`` commit** — flags suspect cohort rows (any
  non-finite row, or one whose squared distance to the reference exceeds
  ``quarantine_mult`` x the cohort's finite median distance), withholds
  the aggregate from them and warm-starts them from the reference model.
  Its ``CommRecord`` and per-link counts are ``average``'s.
* **robust triggers** — ``robust_cadence`` / ``robust_divergence``: the
  cadence/divergence triggers plus per-learner health counters in
  ``SyncState.extra`` (host int32): ``health`` counts consecutive
  quarantined commits (reset by the first clean one), ``recovered``
  flags this round's recoveries. ``robust_divergence`` also counts a
  reachable row with a non-finite distance as a violation.

Presets: ``robust_periodic`` (robust_cadence -> all_reachable ->
trimmed_mean -> quarantine) and ``robust_dynamic`` (the same behind the
divergence condition). ``hardened(spec)`` rewrites a cadence/divergence
mean/average spec onto its robust counterpart.

On the port's plane: the row distances are one ``sqdist_rows`` pass
(``host_dists``), made once per checked round — ``robust_divergence``'s
condition makes it and the quarantine reuses it; under
``robust_cadence`` the commit makes it, one launch per sync — and kept,
with the rows' finiteness, in the round's ``StageCtx.memo``. A row whose
distance is finite is finite (any NaN/Inf entry makes the sum NaN/Inf),
so only the rows with a non-finite distance are read again, to tell a
non-finite row from a finite one whose square overflowed. The median and
the outlier test run on the host on those f32 distances, in
``np.float32`` as the reference's f32 expressions round. The aggregates
sort each coordinate with ``torch.sort`` after pushing invalid entries
to +inf, and the trimmed mean sums the kept order statistics in one
fixed order, row 0 to row m - 1, one elementwise add per row (no
atomics), so the card and the CPU give the same bits; against the
reference's XLA sum they agree to reassociation tolerance. ``k = floor(
trim_frac * n)`` is computed in f32 with n cast to f32, as the
reference's is: at ``trim_frac = 0.29`` and n = 100 the f32 product
rounds to 29.0, where an f64 one floors to 28.

The stages have the reference's errors and parameters; they declare no
``StageContract`` (ROADMAP Queue A 20).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sync.registry import (
    CohortOut, CommRecord, StageCtx, SyncOut, carried_v, register_aggregate,
    register_commit, register_protocol, register_trigger,
)
from repro_torch.core.sync.spec import ProtocolSpec
from repro_torch.core.sync.stages import (
    _divergence_condition, _select_commit, _validate_b, _validate_delta,
    cadence_fire, host_dists, xfers_cohort, zeros_i32,
)

# absolute slack on the outlier threshold so a perfectly-converged
# cohort (median distance exactly zero) does not flag honest rows over
# float dust
_SUSPECT_EPS = np.float32(1e-12)


# ---------------------------------------------------------------------------
# suspect-row detection (shared by the quarantine commit and the robust
# triggers' health counters through the round's memo)
# ---------------------------------------------------------------------------

def _memo(ctx: StageCtx) -> dict:
    return {} if ctx.memo is None else ctx.memo


def _row_dists(ctx: StageCtx) -> np.ndarray:
    """(m,) host f32 squared distances to the reference: the divergence
    condition's, else one ``sqdist_rows`` pass kept for the round."""
    aux = ctx.cond_aux if isinstance(ctx.cond_aux, dict) else {}
    if "dists" in aux:
        return aux["dists"]
    memo = _memo(ctx)
    if "dists" not in memo:
        memo["dists"] = host_dists(ctx)
    return memo["dists"]


def _finite_rows(ctx: StageCtx) -> np.ndarray:
    """(m,) bool — rows whose every parameter is finite. A finite
    distance implies a finite row; the rows with a non-finite distance
    are checked on the plane."""
    memo = _memo(ctx)
    if "finite" not in memo:
        finite = np.isfinite(_row_dists(ctx))
        rows = np.flatnonzero(~finite)
        if rows.size:
            idx = torch.from_numpy(rows).to(ctx.flat.device)
            finite[rows] = torch.isfinite(ctx.flat[idx]).all(dim=1) \
                .cpu().numpy()
        memo["finite"] = finite
    return memo["finite"]


def _masked_median(x: np.ndarray, valid: np.ndarray) -> np.float32:
    """Median of ``x[valid]`` in f32 (0 when nothing is valid): the
    midpoint of the two central order statistics."""
    order = np.sort(np.where(valid, x, np.float32(np.inf)))
    n = int(valid.sum())
    if n == 0:
        return np.float32(0.0)
    lo, hi = order[max((n - 1) // 2, 0)], order[n // 2]
    return np.float32(np.float32(0.5) * (lo + hi))


def _suspect_rows(ctx: StageCtx, mask: np.ndarray) -> np.ndarray:
    """(m,) bool — cohort rows the quarantine flags: non-finite, or a
    distance outlier beyond ``quarantine_mult`` x the cohort's finite
    median (f32 arithmetic). The median stays robust while suspect rows
    are a minority of the cohort."""
    finite = _finite_rows(ctx)
    d = _row_dists(ctx)
    med = _masked_median(d, mask & finite)
    far = d > np.float32(ctx.params["quarantine_mult"]) * med + _SUSPECT_EPS
    return mask & (~finite | far)


# ---------------------------------------------------------------------------
# robust triggers: cadence/divergence + per-learner health counters
# ---------------------------------------------------------------------------

def _health(ctx: StageCtx):
    if "health" not in ctx.state.extra:
        raise ValueError(
            "the robust triggers carry per-learner health counters in "
            "SyncState.extra['health'/'recovered'] — build the state with "
            "init_state(ref, seed, spec=spec, m=m) (the engine does this "
            "automatically)")
    return ctx.state.extra["health"], ctx.state.extra["recovered"]


def _health_init(params, m: int):
    return {"health": np.zeros((m,), np.int32),
            "recovered": np.zeros((m,), np.int32)}


def _health_commit(ctx: StageCtx, mask):
    # health: consecutive quarantined commits — suspect rows increment, a
    # clean commit resets to zero (the recovery), learners outside the
    # cohort keep theirs. recovered: THIS round's recoveries
    h, _ = _health(ctx)
    bad = _suspect_rows(ctx, mask)
    cleared = mask & ~bad
    rec = (cleared & (h > 0)).astype(np.int32)
    h = np.where(bad, h + 1, np.where(cleared, 0, h)).astype(np.int32)
    return {"health": h, "recovered": rec}


def _health_skip(ctx: StageCtx):
    h, _ = _health(ctx)
    return {"health": h, "recovered": np.zeros_like(h)}


def _robust_divergence_condition(ctx: StageCtx):
    # sigma_Delta's condition with a finite guard: a NaN distance compares
    # False against delta, so a reachable row with a non-finite distance
    # is a violation — corruption forces the sync that quarantines it
    violated, _, aux = _divergence_condition(ctx)
    violated = violated | (~np.isfinite(aux["dists"]) & ctx.reach)
    return violated, int(violated.sum()), aux


def _validate_mult(params):
    mult = params["quarantine_mult"]
    if not mult > 1.0:
        raise ValueError(
            f"quarantine_mult must be > 1 (a multiple of the cohort's "
            f"median squared distance), got {mult!r}")


def _validate_robust_cadence(params):
    _validate_b(params)
    _validate_mult(params)


def _validate_robust_divergence(params):
    _validate_delta(params)
    _validate_mult(params)


@register_trigger("robust_cadence", init_extra=_health_init,
                  commit_extra=_health_commit, skip_extra=_health_skip,
                  params={"b": 1, "quarantine_mult": 16.0},
                  validate=_validate_robust_cadence)
def trigger_robust_cadence(ctx: StageCtx) -> bool:
    """sigma_b's schedule with the quarantine health counters — the
    robust counterpart of ``cadence``."""
    return cadence_fire(ctx.params["b"], ctx.t)


@register_trigger("robust_divergence",
                  condition=_robust_divergence_condition,
                  init_extra=_health_init, commit_extra=_health_commit,
                  skip_extra=_health_skip,
                  params={"b": 1, "delta": 0.5, "quarantine_mult": 16.0},
                  validate=_validate_robust_divergence)
def trigger_robust_divergence(ctx: StageCtx) -> bool:
    """sigma_Delta's condition with the quarantine health counters — the
    robust counterpart of ``divergence``: an adversarial or cold row is
    far from the reference and a corrupted one has a non-finite
    distance, so either pulls the fleet into a robust sync."""
    return cadence_fire(ctx.params["b"], ctx.t)


# ---------------------------------------------------------------------------
# robust aggregates: coordinate-wise trimmed mean and median
# ---------------------------------------------------------------------------

def _sorted_valid(X: torch.Tensor, mask: np.ndarray):
    """Per-coordinate ascending sort over the learner axis (the one
    before the last) of the masked FINITE entries, invalid entries pushed
    to the end as +inf, and the count of valid entries per coordinate
    (int64). ``X`` (..., m, P), ``mask`` (..., m)."""
    rows = torch.from_numpy(np.asarray(mask, bool)).to(X.device)
    valid = rows[..., None] & torch.isfinite(X)
    order = torch.sort(torch.where(valid, X, torch.full_like(X, np.inf)),
                       dim=-2).values
    return order, valid.sum(dim=-2)


def flat_trimmed_mean(X: torch.Tensor, mask: np.ndarray,
                      trim_frac: float) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the plane's masked rows: per
    coordinate drop the ``floor(trim_frac * n)`` smallest and largest
    finite values and mean the rest; an all-invalid coordinate yields 0.
    ``X`` (m, P) with ``mask`` (m,) -> (P,), or a batch of planes (g, k,
    P) with masks (g, k) -> (g, P). The kept values are summed row 0 to
    row m - 1, one add per row, the same order on every device."""
    order, n = _sorted_valid(X, mask)
    dt = X.dtype
    k = torch.floor(torch.tensor(trim_frac, dtype=dt, device=X.device)
                    * n.to(dt)).to(torch.int64)
    idx = torch.arange(X.shape[-2], device=X.device)[:, None]
    keep = (idx >= k[..., None, :]) & (idx < (n - k)[..., None, :])
    order.masked_fill_(~keep, 0.0)
    total = torch.zeros_like(order[..., 0, :])
    for i in range(X.shape[-2]):
        total = total + order[..., i, :]
    cnt = torch.clamp(n - 2 * k, min=1).to(dt)
    return torch.where(n > 0, total / cnt, torch.zeros_like(total))


def flat_median(X: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Coordinate-wise median over the plane's masked finite entries (the
    midpoint of the two central order statistics for even counts; 0 for
    an all-invalid coordinate). Shapes as ``flat_trimmed_mean``."""
    order, n = _sorted_valid(X, mask)
    lo = torch.gather(order, -2, torch.clamp((n - 1) // 2, min=0)
                      [..., None, :])[..., 0, :]
    hi = torch.gather(order, -2, (n // 2)[..., None, :])[..., 0, :]
    out = 0.5 * (lo + hi)
    return torch.where(n > 0, out, torch.zeros_like(out))


def _validate_trim(params):
    tf = params["trim_frac"]
    if not 0.0 <= tf < 0.5:
        raise ValueError(
            f"trim_frac must be in [0, 0.5) — trimming half the cohort "
            f"from each side leaves nothing — got {tf!r}")


def _cohort_mask(cout: CohortOut) -> np.ndarray:
    """The aggregate's rows: the whole fleet on the ideal path."""
    return np.ones(np.shape(cout.mask), bool) if cout.ideal else cout.mask


def aggregate_trimmed_mean(ctx: StageCtx, cout: CohortOut) -> torch.Tensor:
    """Coordinate-wise trimmed mean of the cohort: robust to
    ``floor(trim_frac * n)`` arbitrary (even non-finite) values per
    coordinate; unweighted by design. It also serves a hierarchy's
    intra tier as the batched form, on (g, k, P) with (g, k) masks."""
    return flat_trimmed_mean(ctx.flat, _cohort_mask(cout),
                             ctx.params["trim_frac"])


def aggregate_median(ctx: StageCtx, cout: CohortOut) -> torch.Tensor:
    """Coordinate-wise median of the cohort — the maximal trim, robust
    up to (but not at) 50% arbitrary values per coordinate; the batched
    form too."""
    return flat_median(ctx.flat, _cohort_mask(cout))


register_aggregate("trimmed_mean", params={"trim_frac": 0.2},
                   validate=_validate_trim,
                   batched=aggregate_trimmed_mean)(aggregate_trimmed_mean)
register_aggregate("median", batched=aggregate_median)(aggregate_median)


# ---------------------------------------------------------------------------
# the quarantine commit
# ---------------------------------------------------------------------------

def _quarantine_select(ctx: StageCtx, bad: np.ndarray) -> None:
    """Suspect rows are warm-started from the reference model, in place,
    after the cohort adopted the aggregate."""
    if bad.any():
        idx = torch.from_numpy(np.flatnonzero(bad)).to(ctx.flat.device)
        ctx.flat[idx] = ctx.ref_flat


@register_commit("quarantine", needs=("full-cohort",),
                 params={"quarantine_mult": 16.0}, validate=_validate_mult)
def commit_quarantine(ctx: StageCtx, cout: CohortOut, mean, hot,
                      nhot) -> SyncOut:
    """``average`` with a quarantine: suspect cohort rows (non-finite or
    distance outliers, found on the uncommitted plane) do not adopt the
    aggregate — they are warm-started from the reference model, which
    resets adversarial rows every sync and gives a cold-restarted
    learner a live model to rejoin from. The ``CommRecord`` and per-link
    counts are ``average``'s: a quarantined member still shipped its
    model up and got one pushed back down."""
    m = ctx.m
    if cout.ideal:
        bad = _suspect_rows(ctx, np.ones((m,), bool))
        newcfg = _select_commit(ctx.flat, cout.mask, mean)
        _quarantine_select(ctx, bad)
        rec = CommRecord(model_up=m, model_down=m, messages=0, syncs=1,
                         full_syncs=1)
        return SyncOut(newcfg, mean, carried_v(ctx, cout), cout.key, rec,
                       np.full((m,), 2, np.int32), zeros_i32(m))
    mask = cout.mask
    bad = _suspect_rows(ctx, mask)
    nsync = int(mask.sum())
    newcfg = _select_commit(ctx.flat, mask, mean)
    _quarantine_select(ctx, bad)
    rec = CommRecord(model_up=nsync, model_down=nsync, messages=0,
                     syncs=int(nsync > 0), full_syncs=int(nsync > 0))
    return SyncOut(newcfg, mean if nsync > 0 else ctx.ref_flat,
                   carried_v(ctx, cout), cout.key, rec, xfers_cohort(mask),
                   zeros_i32(m))


# ---------------------------------------------------------------------------
# hardened(spec): the robust rewriter, mirroring asyncify
# ---------------------------------------------------------------------------

_ROBUST_TRIGGER = {
    "cadence": "robust_cadence",
    "divergence": "robust_divergence",
    "robust_cadence": "robust_cadence",        # idempotent
    "robust_divergence": "robust_divergence",
}

_ROBUST_AGGREGATE = {
    "mean": "trimmed_mean",
    "trimmed_mean": "trimmed_mean",
    "median": "median",
}

_ROBUST_COMMIT = {"average": "quarantine", "quarantine": "quarantine"}


def hardened(spec: ProtocolSpec, *, aggregate=None, trim_frac=None,
             quarantine_mult=None) -> ProtocolSpec:
    """Rewrite ``spec`` onto its Byzantine-robust counterpart: the
    trigger gains the health counters, ``mean`` becomes the robust
    ``aggregate`` (default ``trimmed_mean``), ``average`` becomes
    ``quarantine``. Parameters are kept; ``trim_frac`` /
    ``quarantine_mult`` override the robust knobs. Raises for
    compositions with no robust counterpart (staleness/events triggers,
    mix/aircomp aggregates, balancing/subset/mix commits)."""
    if spec.trigger not in _ROBUST_TRIGGER:
        raise ValueError(
            f"don't know the robust counterpart of trigger "
            f"{spec.trigger!r} (hardened rewrites: "
            f"{sorted(set(_ROBUST_TRIGGER))})")
    agg = aggregate if aggregate is not None else \
        _ROBUST_AGGREGATE.get(spec.aggregate)
    if agg not in ("trimmed_mean", "median"):
        raise ValueError(
            f"don't know the robust counterpart of aggregate "
            f"{spec.aggregate!r} (hardened rewrites "
            f"{sorted(_ROBUST_AGGREGATE)}; aggregate= accepts "
            f"'trimmed_mean' or 'median', got {aggregate!r})")
    if spec.commit not in _ROBUST_COMMIT:
        raise ValueError(
            f"don't know the robust counterpart of commit "
            f"{spec.commit!r} (hardened rewrites "
            f"{sorted(_ROBUST_COMMIT)}) — for the balancing pipeline "
            f"use the 'robust_dynamic' preset instead")
    params = dict(spec.params)
    if trim_frac is not None:
        params["trim_frac"] = trim_frac
    if quarantine_mult is not None:
        params["quarantine_mult"] = quarantine_mult
    return ProtocolSpec(
        name=f"robust_{spec.name or spec.trigger}",
        trigger=_ROBUST_TRIGGER[spec.trigger], cohort=spec.cohort,
        aggregate=agg, commit=_ROBUST_COMMIT[spec.commit], params=params)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

ROBUST_PERIODIC = ProtocolSpec(
    name="robust_periodic", trigger="robust_cadence",
    cohort="all_reachable", aggregate="trimmed_mean", commit="quarantine")

ROBUST_DYNAMIC = ProtocolSpec(
    name="robust_dynamic", trigger="robust_divergence",
    cohort="all_reachable", aggregate="trimmed_mean", commit="quarantine")

register_protocol("robust_periodic", ROBUST_PERIODIC)
register_protocol("robust_dynamic", ROBUST_DYNAMIC)
