"""Two-tier star-of-stars coordination on top of the staged rounds — the
counterpart of ``repro.core.sync.hierarchy``.

The fleet of m learners is g contiguous equal clusters (cluster c owns
learners ``c*k .. (c+1)*k-1``, k = m/g). Every round:

1. **intra tier** — the flat protocol runs in every cluster, each with
   its own reference model, violation counter, PRNG key and extra
   carried state, seeing only its members' availability;
2. **edge aggregators** — each cluster's availability-masked (weighted)
   mean after the intra step; a cluster is reachable upstream iff any
   member is;
3. **inter tier** — ``HierarchyConfig.inter`` runs the same staged round
   over the g aggregator models, with its own state;
4. **commit down** — clusters whose aggregator synchronized push the
   inter-tier adjustment (new minus old aggregate) to their reachable
   members.

Accounting is exact per tier: member links count intra transfers,
down-pushes and intra control messages; the g aggregator uplinks count
the inter tier's (priced by the engine at ``inter.bytes_per_param``).

The reference vmaps the intra tier over clusters. Here the ``(m, P)``
plane is viewed as ``(g, k, P)`` and one intra round runs every cluster:
the per-cluster state is batched (references ``(g, P)``, counters
``(g,)``, keys ``(g, 2)``, extra state ``(g, k, ...)``); the distances
of all clusters are ONE grouped ``sqdist_rows`` launch and ONE ``(m,)``
fetch, made the first time a cluster's stage asks for them; each
cluster's host decisions (gate, condition, cohort) then run in turn on
its slice; the aggregate of every cluster that syncs is one batched
matvec (the aggregate stage's ``batched`` form); the commits write the
clusters' rows of the plane in place. The aggregator means are one more
batched matvec, the inter round runs on the ``(g, P)`` aggregator
plane, and the down-push is a masked add.

Departures from the reference: ``HierSyncState.intra`` carries ``v``
as a host ``(g,)`` int64 array and ``step`` as one int (the clusters
step together; the reference carries ``(g,)`` int32), and ``HierResult``
says whether the intra tier's gate fired (``checked``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.divergence import per_learner_sq_distance_flat
from repro_torch.core.sync.kernel import apply_staged
from repro_torch.core.sync.registry import (
    CohortOut, CommRecord, StageCtx, SyncOut, SyncState,
)
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec, \
    trigger_fire
from repro_torch.core.sync.stages import batched_aggregate_mean, zeros_i32


class HierSyncState(NamedTuple):
    intra: SyncState   # ref (g, P), v (g,), key (g, 2), extra (g, k, ...)
    inter: SyncState   # over the g aggregator models


class HierResult(NamedTuple):
    params: torch.Tensor       # the committed (m, P) plane
    state: HierSyncState
    rec: CommRecord            # merged scalar record (the ledger is exact)
    member_xfers: np.ndarray   # (m,) models over member links
    member_msgs: np.ndarray    # (m,) control messages over member links
    agg_xfers: np.ndarray      # (g,) models over aggregator uplinks
    agg_msgs: np.ndarray       # (g,) control messages over the uplinks
    checked: bool = False      # the intra tier's gate fired


def validate_hierarchy(tiers, m: int) -> int:
    """Cluster size k, or a clear error when the fleet doesn't partition."""
    g = tiers.num_clusters
    if m % g != 0:
        raise ValueError(
            f"hierarchy needs equal clusters: m={m} learners do not "
            f"partition into num_clusters={g} (m % g == {m % g}). "
            f"Pick g dividing m.")
    return m // g


def init_hier_state(base_row: torch.Tensor, tiers, seed: int = 0,
                    m: Optional[int] = None,
                    intra_spec: Optional[ProtocolSpec] = None,
                    inter_spec: Optional[ProtocolSpec] = None
                    ) -> HierSyncState:
    """Per-cluster intra states (every cluster starts from the shared
    init row) and one inter-tier state over the aggregators. The intra
    keys are ``split(key(seed ^ 0x417E7), g)``, the inter key
    ``key(seed ^ 0x1A7E2)``, as the reference's. A spec that carries
    extra state gets one instance per cluster at the intra tier (leading
    (g,) axis) and one over the g aggregators at the inter tier; ``m`` is
    required whenever the intra spec carries any."""
    g = tiers.num_clusters
    intra_extra = {}
    if intra_spec is not None and intra_spec.extra_state:
        if m is None:
            raise ValueError(
                "init_hier_state needs the fleet size m to build the "
                f"intra spec's extra state {intra_spec.extra_state}")
        k = validate_hierarchy(tiers, m)
        intra_extra = {n: np.broadcast_to(x[None], (g,) + x.shape).copy()
                       for n, x in intra_spec.init_extra(k).items()}
    inter_extra = ({} if inter_spec is None or not inter_spec.extra_state
                   else inter_spec.init_extra(g))
    intra = SyncState(
        ref=base_row[None].repeat(g, 1), v=np.zeros((g,), np.int64), step=0,
        key=prng.split(prng.key(seed ^ 0x417E7, device="cpu"), g,
                       device="cpu"),
        extra=intra_extra)
    inter = SyncState(ref=base_row.clone(), v=0, step=0,
                      key=prng.key(seed ^ 0x1A7E2, device="cpu"),
                      extra=inter_extra)
    return HierSyncState(intra=intra, inter=inter)


class _GroupedDists:
    """Every row's distance to its cluster's reference: one grouped
    ``sqdist_rows`` pass and one fetch, made at the first request of the
    round; a cluster reads its slice. A cluster's rows are read before
    its own commit, and no other cluster writes them."""

    def __init__(self, X: torch.Tensor, R: torch.Tensor, k: int):
        self.X, self.R, self.k, self.host = X, R, k, None

    def rows(self, c: int) -> np.ndarray:
        if self.host is None:
            self.host = per_learner_sq_distance_flat(self.X, self.R) \
                .cpu().numpy()
        return self.host[c * self.k:(c + 1) * self.k]


def _intra_round(spec: ProtocolSpec, X: torch.Tensor, st: SyncState,
                 w_gk, act_gk, leaf_sizes):
    """One intra-tier round for all g clusters of the (m, P) plane ``X``,
    which the commits update in place. Returns (new state, summed
    CommRecord, (g, k) transfers, (g, k) messages, gate fired)."""
    trig, coh, agg, com = spec.stage_records()
    p = spec.resolved_params()
    fire = trigger_fire(trig)
    g, P = st.ref.shape
    k = X.shape[0] // g
    Xgk = X.view(g, k, P)
    t = st.step + 1
    dists = _GroupedDists(X, st.ref, k)
    plans = []
    for c in range(g):
        act = None if act_gk is None else act_gk[c]
        state = SyncState(ref=st.ref[c], v=int(st.v[c]), step=st.step,
                          key=st.key[c],
                          extra={n: a[c] for n, a in st.extra.items()})
        ctx = StageCtx(
            params=p, flat=Xgk[c], ref_flat=st.ref[c], state=state,
            weights=None if w_gk is None else w_gk[c], m=k, t=t,
            reach=np.ones((k,), bool) if act is None else act, active=act,
            dists=lambda c=c: dists.rows(c), leaf_sizes=leaf_sizes,
            memo={})
        checked, runs, ctx, hot, nhot = fire(ctx)
        cout = coh.fn(ctx, hot, nhot, state.key) if runs else None
        plans.append((checked, ctx, hot, nhot, cout))

    syncing = [plan for plan in plans if plan[4] is not None]
    if syncing:
        if agg.batched is None:
            raise ValueError(
                f"aggregate {agg.name!r} has no batched form: it cannot "
                f"run a hierarchy's intra tier")
        masks = np.zeros((g, k), bool)
        for c, plan in enumerate(plans):
            if plan[4] is not None:
                masks[c] = plan[4].mask
        bctx = syncing[0][1]._replace(flat=Xgk, weights=w_gk)
        means = agg.batched(bctx, CohortOut(mask=masks, key=None,
                                            ideal=syncing[0][4].ideal))

    refs, keys, vs, extras, recs, xfers, msgs = [], [], [], [], [], [], []
    for c, (checked, ctx, hot, nhot, cout) in enumerate(plans):
        if cout is not None:
            # the commit-time state reads the uncommitted rows
            extras.append(trig.commit_extra(ctx, cout.mask))
            out = com.fn(ctx, cout, means[c], hot, nhot)
            if out.params is not ctx.flat:
                ctx.flat.copy_(out.params)
        else:
            out = SyncOut(ctx.flat, ctx.ref_flat, ctx.state.v, ctx.state.key,
                          CommRecord.zero(), zeros_i32(k), zeros_i32(k))
            extras.append(trig.skip_extra(ctx))
        refs.append(out.ref)
        keys.append(out.key)
        vs.append(out.v)
        recs.append(out.rec)
        xfers.append(out.xfers)
        msgs.append(out.link_msgs)
    extra = ({n: np.stack([e[n] for e in extras]) for n in extras[0]}
             if extras[0] else st.extra)
    state = SyncState(ref=torch.stack(refs), v=np.asarray(vs, np.int64),
                      step=t, key=torch.stack(keys), extra=extra)
    rec = CommRecord(*(int(sum(r[i] for r in recs))
                       for i in range(len(CommRecord._fields))))
    return (state, rec, np.stack(xfers), np.stack(msgs),
            any(plan[0] for plan in plans))


def apply_hierarchical(cfg, tiers, X: torch.Tensor, hstate: HierSyncState,
                       weights=None, active: Optional[np.ndarray] = None,
                       leaf_sizes=None) -> HierResult:
    """One hierarchical round on the (m, P) plane ``X`` (updated in
    place): intra tier → aggregators → inter tier → commit down.
    ``active`` is the flat (m,) reachability mask."""
    m, P = X.shape
    g = tiers.num_clusters
    k = m // g
    spec = resolve_spec(cfg)
    if not spec.param("weighted"):
        # Algorithm-2 weights enter (the aggregator means and the inter
        # tier's cluster weights) only when the intra config asks for them
        weights = None
    w_gk = None if weights is None else weights.reshape(g, k)
    act_gk = None if active is None else active.reshape(g, k)

    # --- 1. intra tier: every cluster in one batched round
    intra_state, intra_rec, xf, lm, intra_checked = _intra_round(
        spec, X, hstate.intra, w_gk, act_gk, leaf_sizes)

    # --- 2. edge aggregators: masked cluster means, one batched matvec
    member_mask = act_gk if act_gk is not None else np.ones((g, k), bool)
    agg = batched_aggregate_mean(X.view(g, k, P), member_mask, w_gk)
    cluster_w = None if w_gk is None else torch.sum(w_gk, dim=1)
    agg_active = None if act_gk is None else member_mask.any(axis=1)

    # --- 3. inter tier over the g aggregators. Under Algorithm 2 each
    # aggregator carries its cluster's sampling mass, so the intra tier's
    # weighting turns the inter tier weighted, whatever it says
    inter_cfg = tiers.inter
    if cluster_w is not None and not inter_cfg.weighted:
        inter_cfg = dataclasses.replace(inter_cfg, weighted=True)
    inter = apply_staged(inter_cfg, agg.clone(), hstate.inter, cluster_w,
                         active=agg_active, leaf_sizes=leaf_sizes)

    # --- 4. commit down: the inter-tier adjustment, added to the
    # reachable members of every cluster whose aggregator synchronized
    down_mask = (inter.xfers > 0)[:, None] & member_mask
    n_down = int(down_mask.sum())
    if n_down == m:
        X.view(g, k, P).add_((inter.params - agg)[:, None])
    elif n_down:
        rows = np.flatnonzero(down_mask.reshape(m))
        delta = inter.params - agg
        idx = torch.from_numpy(rows).to(X.device)
        X[idx] += delta[torch.from_numpy(rows // k).to(X.device)]

    rec = CommRecord(
        model_up=intra_rec.model_up + inter.rec.model_up,
        model_down=intra_rec.model_down + inter.rec.model_down + n_down,
        messages=intra_rec.messages + inter.rec.messages,
        syncs=int(intra_rec.syncs + inter.rec.syncs > 0),
        # "full" at the fleet level: the inter tier averaged every
        # reachable aggregator
        full_syncs=inter.rec.full_syncs)
    return HierResult(
        params=X, state=HierSyncState(intra=intra_state, inter=inter.state),
        rec=rec,
        member_xfers=(xf + down_mask.astype(np.int32)).reshape(m),
        member_msgs=lm.reshape(m), agg_xfers=inter.xfers,
        agg_msgs=inter.link_msgs,
        checked=intra_checked)
