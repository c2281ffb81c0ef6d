"""The decentralized learning simulator: m learners, one protocol — the
counterpart of ``repro.core.protocol``.

Faithful to the paper's setting (Section 2): in each round t every learner
i observes a sample E_t^i of size B, takes one local step of the learning
algorithm phi, and the synchronization operator sigma runs
(``repro_torch.core.sync``).

The fleet lives in one ``(m, P)`` parameter plane
(``repro_torch.core.flatten``), and so do the gradients and every
optimizer moment. A round is:

  1. the local step: ``torch.func.vmap(torch.func.grad_and_value(loss))``
     over the learner axis, on per-leaf views of the plane (the
     counterpart of the reference's vmapped ``value_and_grad``); the
     gradients are written into the ``(m, P)`` gradient plane;
  2. the optimizer, elementwise over the whole plane, in place;
  3. the staged sync round on the plane, in place.

Communication is counted exactly: the round's ``CommRecord`` and per-link
transfer/message counts are host integers, and the bytes ledger prices
them host-side in int64. ``run_chunk`` runs n rounds and then fetches the
chunk's losses from the device in one transfer.

With a ``NetworkConfig`` the rounds run inside the simulated network
(``repro_torch.network``): the chunk's availability masks are drawn on
the host in one batched call (only when the config is not at full
availability — otherwise no mask exists and every stage takes its
pre-network branch, bit for bit), the stages become availability-aware,
a mobile overlay is re-derived per redraw window, and the link-cost
model turns each round's transfers into simulated seconds (``net_time``,
f32) and per-link bytes (priced at ``NetworkConfig.msg_bytes``). An
overlay-using spec (gossip) without a network peers over ``star(m)``.
``network=None`` is the ideal always-on star.

The seed gives the reference's keys: ``split(key(seed), 3)`` of
``repro_torch.prng`` (jax's threefry stream, bit for bit) yields the
init-noise key of ``init_heterogeneity``, and the sync state's key is
``key(seed)``, as in the reference. ``SerialLearner`` is the paper's
serial baseline: one model trained on all the data.

With ``async_net`` (an ``AsyncConfig``) the protocol is rewritten onto
the event-driven timeline (``core.sync.async_sync.asyncify``): local
clocks, exchanges in flight through a bounded arrival ring, and with
``aircomp`` the over-the-air mean. With ``ProtocolConfig.tiers`` (a
``HierarchyConfig``) a round is the two-tier star-of-stars
(``core.sync.hierarchy``): the configured (possibly asyncified) protocol
inside every cluster, ``tiers.inter`` among the edge aggregators, the
ledger grown by g aggregator uplinks priced at
``tiers.inter.bytes_per_param``, and the network time the two tiers
back to back. ``counters_state``/``restore_counters`` and
``restore_state`` resume a run from a checkpoint
(``repro_torch.checkpoint.io``).

With ``faults`` (a ``FaultConfig``) the round runs the fault plane
(``repro_torch.network.faults``), in the reference's order: a chunk's
masks are drawn on the host before its first round, then each round
zeroes the rows of learners rejoining from a crash (the parameter and
optimizer planes, and the learner-indexed carried sync state unless a
hierarchy carries it per cluster), takes the local step, puts back the
crashed learners' rows (their losses become 0), perturbs the corrupted
and Byzantine rows, and composes crashes and bursts into the
availability mask. ``track_divergence`` adds the fleet's divergence
after every round (one ``sqdist_rows`` pass against the mean row), and
``telemetry`` (a ``TelemetryConfig``) streams a round record per round
(``repro_torch.telemetry``) from the values the chunk already holds:
the per-round loss sums and divergences cross to the host in the
chunk's one transfer, and while a recorder is attached the cumulative
loss and network time are sequential float64 sums of the per-round
series, so the stream's last ``cum_*`` equals the counters bit for bit.
The first fold whose loss counters go non-finite emits one
``nonfinite_loss`` event through ``telemetry.sink.get_logger()``.

With ``layout="sharded"`` the engine is one rank of a fleet split over
the ranks of a ``torch.distributed`` process group
(``repro_torch.core.shard``): it holds ``m_local`` = m/n learners' rows
of every plane and takes their rows of each chunk's batches; the round's
host decisions, the counters and the ledger are every rank's alike;
the chunk's losses are gathered with its one transfer; ``fleet_plane``
and ``fleet_state`` gather the whole fleet, and ``is_writer`` (rank 0)
writes the telemetry stream. One rank is the flat run bit for bit.

Departures from the reference: ``init_fn`` takes a ``torch.Generator``
seeded with ``seed`` (the reference hands it the first of the three
keys), so a parity test passes the reference's initial model in;
``init_heterogeneity``'s noise is ``prng.normal``, within its stated
tolerance of jax's; masks, overlays, the carried timeline, the fault
schedule and network times are host values, so ``num_active`` /
``net_time`` / ``num_inflight`` / ``max_age`` / ``divergence`` /
``num_faulty`` / ``num_quarantined`` / ``num_recovered`` are host
arrays, and ``ProtocolMetrics`` adds ``checked``, whether the
(intra-tier) gate fired each round; the
reference's callers restore a run by assigning ``params``,
``opt_state`` and ``sync_state``, the port's call ``restore_state``;
and the entry points run on ``device="cuda"`` unless the caller asks
for the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import prng
from repro_torch.config import (
    AsyncConfig, FaultConfig, NetworkConfig, TelemetryConfig, TrainConfig,
)
from repro_torch.core import shard
from repro_torch.core.flatten import fleet_adapter, tree_leaves, tree_map
from repro_torch.core.sync.async_sync import asyncify
from repro_torch.core.sync.hierarchy import (
    HierSyncState, apply_hierarchical, init_hier_state, validate_hierarchy,
)
from repro_torch.core.sync.kernel import apply_staged, init_state
from repro_torch.core.sync.registry import CommRecord
from repro_torch.core.sync.spec import resolve_spec
from repro_torch.device import resolve_device
from repro_torch.network import availability as net_availability
from repro_torch.network import cost as net_cost
from repro_torch.network import faults as net_faults
from repro_torch.network import topology as net_topology
from repro_torch.optim.optimizers import OptState, make_optimizer
from repro_torch.telemetry import sink
from repro_torch.telemetry.trace import step_annotation


class ProtocolMetrics(NamedTuple):
    """One call's per-round metrics; ``run_chunk`` stacks a leading round
    axis on every field."""
    loss_per_learner: torch.Tensor   # (m,) this-round loss, on the device
    comm: CommRecord                 # host ints / (n,) int64 arrays
    link_xfers: np.ndarray           # (m,) int32 models per learner link
    link_counts: np.ndarray          # (L, 2) int32 [transfers, messages]:
    #   L = m learner links, plus the g aggregator uplinks of a hierarchy
    num_active: Any                  # int / (n,) int64 reachable learners
    net_time: Any                    # np.float32 / (n,) simulated seconds
    num_inflight: Any = 0            # learners whose exchange is in flight
    #   after the round (0 without an async timeline)
    max_age: Any = 0                 # the oldest rounds-since-sync counter
    #   the trigger carries (0 for stateless triggers)
    checked: Any = False             # the (intra-tier) trigger's gate fired
    divergence: Any = 0.0            # the fleet's divergence after the
    #   round (0 unless track_divergence)
    num_faulty: Any = 0              # learners under any injected fault
    #   (0 without faults)
    num_quarantined: Any = 0         # learners currently quarantined
    #   (health > 0; 0 for non-robust triggers)
    num_recovered: Any = 0           # learners recovering this round


def _check_split(fleet, spec, async_net, faults, tiers, m: int) -> None:
    """The planes a fleet split over several ranks cannot run yet raise
    here, naming their ROADMAP item; nothing runs quietly on one rank."""
    if fleet.n_devices == 1:
        return
    if async_net is not None or faults is not None or \
            spec.aggregate == "aircomp" or spec.trigger.startswith("events"):
        raise NotImplementedError(
            "layout='sharded' over more than one rank does not run the "
            "event-driven timeline, aircomp or the fault plane yet — "
            "ROADMAP Queue A 26")
    if tiers is not None:
        validate_hierarchy(tiers, m, fleet.n_devices)


class DecentralizedLearner:
    """m local learners + a synchronization protocol Pi = (phi, sigma).

    ``loss_fn(params, batch)`` is one learner's loss; ``init_fn(generator)``
    returns the initial parameter tree, which every learner starts from
    (the paper's homogeneous init), or, with ``init_heterogeneity`` = ε >
    0, that tree plus per-learner Gaussian noise at ε times each leaf's
    standard deviation (Fig. 6.2). ``protocol`` is a ``ProtocolConfig``
    or a ``ProtocolSpec``; ``network`` a ``NetworkConfig`` or None (the
    ideal always-on network); ``faults`` a ``FaultConfig`` or None (no
    fault code runs); ``telemetry`` a ``TelemetryConfig`` or None."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        init_fn: Callable[[torch.Generator], Any],
        m: int,
        protocol,
        train: TrainConfig = TrainConfig(),
        seed: int = 0,
        init_heterogeneity: float = 0.0,
        sample_weights: Optional[torch.Tensor] = None,
        network: Optional[NetworkConfig] = None,
        async_net: Optional[AsyncConfig] = None,
        track_divergence: bool = False,
        telemetry: Optional[TelemetryConfig] = None,
        faults: Optional[FaultConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.faults = faults
        self.track_divergence = track_divergence
        self._nonfinite_reported = False
        self.m = m
        self.protocol = protocol
        self.spec = resolve_spec(protocol)
        # the row-sharded plane: this rank holds learners fleet.rows of
        # every learner-indexed plane; None for the flat layouts
        self.fleet = None
        if self.spec.param("layout") == "sharded":
            self.fleet = shard.fleet_sharding(
                m, self.spec.param("shard_devices"))
            _check_split(self.fleet, self.spec, async_net, faults,
                         getattr(protocol, "tiers", None), m)
        self.train = train
        self.loss_fn = loss_fn
        self.opt = make_optimizer(train)
        # the reference's k_init, k_noise, k_state; init_fn draws from a
        # torch.Generator instead of k_init, and k_state goes unused there
        _, k_noise, _ = prng.split(prng.key(seed, device="cpu"), 3,
                                   device="cpu")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        base = tree_map(lambda x: x.to(self.device), init_fn(gen))
        self.adapter = fleet_adapter(base)
        row = self.adapter.ravel_model(base)
        if init_heterogeneity > 0.0:                 # the (m, P) plane
            self.X = self._heterogeneous_plane(base, m, k_noise,
                                               init_heterogeneity)
            if self.fleet is not None:
                self.X = self.X[self.fleet.rows].clone()
        else:
            self.X = row[None].repeat(self.m_local, 1)
        self.G = torch.empty_like(self.X)            # the gradient plane
        self.opt_state = self.opt.init(self.X)
        self.sample_weights = (None if sample_weights is None
                               else sample_weights.to(self.device))
        self.model_size = self.adapter.P
        self.model_bytes = self.model_size * self.spec.bytes_per_param
        self._grad_and_loss = torch.func.vmap(
            torch.func.grad_and_value(loss_fn))

        # the event-driven timeline: rewrite the protocol onto local
        # clocks before any state is built (the rewritten spec carries the
        # timeline in SyncState.extra); under a hierarchy the intra tier
        # runs it and tiers.inter stays synchronous
        self.async_net = async_net
        if async_net is not None:
            self.spec = asyncify(self.spec, async_net, network,
                                 self.model_bytes)

        # the two-tier hierarchy: per-cluster intra state and the inter
        # tier's; the aggregator uplinks get their own ledger rows, priced
        # at tiers.inter.bytes_per_param
        self.tiers = getattr(protocol, "tiers", None)
        if self.tiers is not None:
            validate_hierarchy(self.tiers, m, 1 if self.fleet is None
                               else self.fleet.n_devices)
            self.sync_state = init_hier_state(
                row, self.tiers, seed, m=m, intra_spec=self.spec,
                inter_spec=resolve_spec(self.tiers.inter))
            self.inter_model_bytes = (
                self.model_size * self.tiers.inter.bytes_per_param)
            self.num_links = m + self.tiers.num_clusters
        else:
            self.sync_state = init_state(row, seed, spec=self.spec, m=m)
            self.inter_model_bytes = 0
            self.num_links = m

        # network environment: link profile and peer overlay, a static
        # one built once, a mobile one per redraw window
        self.network = network
        self._link_bw = self._link_lat = None
        self._agg_bw = self._agg_lat = None
        self._static_adj = None
        self._mobile = False
        if network is not None:
            self._link_bw, self._link_lat = net_cost.link_profile(network, m)
            self._mobile = net_topology.is_mobile(network)
            if not self._mobile:
                self._static_adj = net_topology.adjacency(network, m)
            if self.tiers is not None:
                self._agg_bw, self._agg_lat = net_cost.uniform_profile(
                    self.tiers.link_class, self.tiers.num_clusters)
        elif self.spec.uses_overlay:
            self._static_adj = net_topology.star(m)
        self._window_adj = (None, None)        # (window, adjacency)

        # cumulative counters (host-side Python ints / floats / numpy)
        self.cumulative_loss = 0.0
        self.cumulative_loss_per_learner = np.zeros((m,), np.float32)
        self.comm_totals = {k: 0 for k in CommRecord._fields}
        self.rounds = 0
        self.network_time = 0.0                    # simulated seconds
        self.active_rounds_total = 0               # sum of per-round |active|
        self.link_xfer_totals = np.zeros((m,), np.int64)
        # the bytes ledger: learner links, then aggregator uplinks
        self.link_bytes_totals = np.zeros((self.num_links,), np.int64)
        self.msg_bytes = network.msg_bytes if network is not None else 64
        self.link_payload_bytes = np.full((m,), self.model_bytes, np.int64)
        if self.tiers is not None:
            self.link_payload_bytes = np.concatenate([
                self.link_payload_bytes,
                np.full((self.tiers.num_clusters,), self.inter_model_bytes,
                        np.int64)])

        # the telemetry plane: one record per round, from the values the
        # chunk already holds and its one transfer
        self.telemetry = telemetry
        self.recorder = None
        self._profiler = None
        if telemetry is not None and not self.is_writer:
            # one stream for the fleet: the other ranks keep their
            # records in the ring only
            telemetry = dataclasses.replace(telemetry, path=None)
        if telemetry is not None:
            from repro_torch.telemetry.recorder import RoundRecorder
            from repro_torch.telemetry.trace import ChunkProfiler
            self._profiler = ChunkProfiler()
            self.recorder = RoundRecorder(
                telemetry, m=m, num_links=self.num_links,
                model_size=self.model_size, model_bytes=self.model_bytes,
                msg_bytes=self.msg_bytes,
                link_payload_bytes=self.link_payload_bytes,
                link_classes=self.link_class_names(),
                spec=self.spec.to_dict(), tiers=self._tiers_meta())

    @property
    def m_local(self) -> int:
        """The learners this process holds: m, or a rank's rows."""
        return self.m if self.fleet is None else self.fleet.rows_per_device

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (the telemetry
        stream, checkpoints): rank 0 of a sharded fleet, else always."""
        return self.fleet is None or self.fleet.rank == 0

    @property
    def params(self):
        """The fleet as a stacked (m, ...) tree of views into the plane
        (a rank's (m/n, ...) rows of a sharded fleet)."""
        return self.adapter.unravel(self.X)

    def fleet_plane(self) -> torch.Tensor:
        """The whole (m, P) plane; on a sharded fleet every rank's rows
        gathered (every rank must call it)."""
        with shard.use_fleet(self.fleet):
            return shard.gather_plane(self.X)

    def fleet_state(self):
        """``(params, opt_state)`` of the whole fleet — the stacked (m,
        ...) tree and the optimizer over (m, P) planes and (m,) step
        counts — gathered on a sharded fleet (every rank must call it):
        what ``checkpoint.io.save_protocol_state`` writes."""
        with shard.use_fleet(self.fleet):
            opt = OptState(*(None if x is None else shard.gather_plane(x)
                             for x in self.opt_state))
            return self.adapter.unravel(shard.gather_plane(self.X)), opt

    @property
    def round_index(self) -> int:
        """Rounds this engine's sync state has run: the next round's mask
        and overlay index."""
        if self.tiers is not None:
            return self.sync_state.inter.step
        return self.sync_state.step

    def restore_state(self, params, opt_state, sync_state) -> None:
        """Put a loaded run back (``repro_torch.checkpoint.io``'s
        ``load_protocol_state``, or another engine's state): ``params`` a
        stacked (m, ...) tree, copied into the plane; ``opt_state`` an
        ``OptState`` over (m, P) planes; ``sync_state`` a ``SyncState``
        or, under a hierarchy, a ``HierSyncState``. A sharded fleet takes
        its rows of each. The counters are restored apart, by
        ``restore_counters``."""
        if isinstance(sync_state, HierSyncState) != (self.tiers is not None):
            raise ValueError(
                f"a {type(sync_state).__name__} does not fit an engine "
                f"{'with' if self.tiers is not None else 'without'} tiers")
        X = self.adapter.ravel(params)
        if self.fleet is not None:
            X = X[self.fleet.rows]
            opt_state = shard.put_fleet(self.fleet, opt_state)
        self.X.copy_(X)
        dev = self.device
        self.opt_state = OptState(*(
            x if x is None else x.to(dev).clone() for x in opt_state))
        if self.tiers is not None:
            self.sync_state = HierSyncState(
                intra=shard.put_sync_state(self.fleet, sync_state.intra, dev),
                inter=shard.put_sync_state(self.fleet, sync_state.inter, dev))
        else:
            self.sync_state = shard.put_sync_state(self.fleet, sync_state,
                                                   dev)

    def _heterogeneous_plane(self, base, m: int, k_noise, eps: float):
        """The reference's heterogeneous init: learner i's leaf ``li`` (in
        ``jax.tree.flatten`` order, which ``tree_leaves`` follows) gets
        ``normal(fold_in(split(k_noise, m)[i], li)) * eps * (std + 1e-12)``
        with the leaf's population std. The noise is drawn on the
        learners' device, for all m keys at once."""
        keys = prng.split(k_noise, m, device=self.device)
        leaves = []
        for li, x in enumerate(tree_leaves(base)):
            scale = eps * (torch.std(x, correction=0) + 1e-12)
            z = prng.normal(prng.fold_in(keys, li, device=self.device),
                            x.shape, device=self.device)
            leaves.append(x[None] + z.to(x.dtype) * scale)
        return self.adapter.ravel(leaves)

    # ------------------------------------------------------------------
    def _adjacency(self, t: int):
        """The peer overlay of round ``t``: the static one, or the mobile
        one of ``t``'s redraw window (built once per window)."""
        if not self._mobile:
            return self._static_adj
        window = t // self.network.redraw_every
        if self._window_adj[0] != window:
            self._window_adj = (window,
                                net_topology.adjacency(self.network,
                                                       self.m, t))
        return self._window_adj[1]

    def _round(self, batch, active=None, faults=None):
        """One round on the plane; returns (losses (m,) on the device, the
        round's ``CommRecord``, its (L, 2) per-link counts, whether the
        gate fired). The layers are named ranges for ``torch.profiler``
        (microseconds each when none is active); the fault plane's row
        work outside the step is ``round.faults``.
        ``active`` is the round's availability mask (None: all
        reachable), already composed with the fault plane; ``faults`` is
        (the chunk's ``FaultSchedule``, the round's row in it) or None."""
        t = self.round_index
        batch = {k: v.to(self.device) for k, v in batch.items()}
        m = self.m_local
        crashed = None
        if faults is not None:
            sched, i = faults
            crashed = sched.crashed[i] if sched.crashed[i].any() else None
            if sched.restart[i].any():
                with record_function("round.faults"):
                    self._lose_state(sched.restart[i])
        with record_function("round.local_step"):
            grads, losses = self._grad_and_loss(self.params, batch)
            torch.cat([g.reshape(m, -1).to(self.X.dtype)
                       for g in tree_leaves(grads)], dim=1, out=self.G)
        with record_function("round.optimizer"):
            if crashed is not None:     # a crashed learner does not train
                idx, saved = net_faults.keep_rows(
                    crashed, self.X, self.opt_state.step, self.opt_state.mu,
                    self.opt_state.nu)
            self.X, self.opt_state = self.opt.update(self.X, self.G,
                                                     self.opt_state)
            if crashed is not None:
                net_faults.freeze_state(idx, saved, self.X,
                                        self.opt_state.step,
                                        self.opt_state.mu, self.opt_state.nu)
                losses = losses.masked_fill(
                    torch.from_numpy(crashed).to(losses.device), 0.0)
        if faults is not None:
            # corrupted and Byzantine rows are perturbed in the plane: the
            # garbage is what the fleet syncs against
            with record_function("round.faults"):
                net_faults.perturb_params(self.faults, self.X, t,
                                          sched.byzantine, sched.corrupt[i])
        with record_function("round.sync"):
            if self.tiers is None:
                res = apply_staged(self.spec, self.X, self.sync_state,
                                   self.sample_weights, active=active,
                                   adjacency=self._adjacency(t),
                                   leaf_sizes=self.adapter.sizes)
                counts = np.stack([res.xfers, res.link_msgs], axis=-1)
                checked = res.checked
            else:
                # the intra tier runs this engine's (possibly asyncified)
                # spec, the inter tier tiers.inter
                res = apply_hierarchical(
                    self.spec, self.tiers, self.X, self.sync_state,
                    self.sample_weights, active,
                    leaf_sizes=self.adapter.sizes)
                counts = np.stack([
                    np.concatenate([res.member_xfers, res.agg_xfers]),
                    np.concatenate([res.member_msgs, res.agg_msgs])], axis=-1)
                checked = res.checked
        self.X, self.sync_state = res.params, res.state
        return losses, res.rec, counts, checked

    def _lose_state(self, rows: np.ndarray) -> None:
        """The restart's state loss: zero the rejoining learners' rows of
        the parameter and optimizer planes, their optimizer step counts,
        and every learner-indexed array the sync state carries (a
        hierarchy's intra state is per cluster, so it is left alone, as
        the reference does)."""
        net_faults.lose_state((self.X, self.opt_state.step,
                               self.opt_state.mu, self.opt_state.nu),
                              rows, self.m)
        if self.tiers is None:
            self.sync_state = self.sync_state._replace(
                extra=net_faults.lose_state(dict(self.sync_state.extra),
                                            rows, self.m))

    def _carried(self):
        """(learners in flight, oldest age, quarantined, recovering) from
        the trigger-carried state after a round: the async timeline's
        ``inflight``, the ``age`` or ``staleness`` counters and the robust
        triggers' ``health``/``recovered``, 0 where the trigger carries
        none."""
        extra = (self.sync_state.extra if self.tiers is None
                 else self.sync_state.intra.extra)
        inflight = (int(np.count_nonzero(extra["inflight"]))
                    if "inflight" in extra else 0)
        age = next((extra[k] for k in ("age", "staleness") if k in extra),
                   None)
        quarantined = (int(np.count_nonzero(extra["health"] > 0))
                       if "health" in extra else 0)
        recovered = (int(np.sum(extra["recovered"]))
                     if "recovered" in extra else 0)
        return (inflight, 0 if age is None else int(np.max(age)),
                quarantined, recovered)

    def _run(self, batches, n: int) -> ProtocolMetrics:
        """n rounds, then ONE device-to-host transfer of the losses (and
        divergences). The chunk's availability and fault masks are drawn
        before its first round, one batched call each. With a recorder
        attached the chunk is observed: timed when profiling, named in a
        ``torch.profiler`` trace when asked, then filed as records."""
        if self.recorder is None:
            return self._chunk(batches, n)
        cfg = self.telemetry
        compiled = self._profiler.begin(n) if cfg.profile else None
        base = self.counters_snapshot()
        t0 = time.perf_counter()
        ctx = (step_annotation("repro_round", self.rounds) if cfg.profiler
               else contextlib.nullcontext())
        with ctx:
            metrics, per = self._chunk(batches, n, observe=True)
        wall = time.perf_counter() - t0 if cfg.profile else None
        if cfg.profile:
            self._profiler.observe(n, wall)
        self.recorder.observe(
            per, base, self._state_extra(), n, wall_s=wall,
            compiled=compiled,
            recompiles=self._profiler.recompiles if cfg.profile else None)
        return metrics

    def _chunk(self, batches, n: int, observe: bool = False):
        """The n rounds and the counters' fold; with ``observe`` also the
        per-round series the recorder files (the reference's fold keys,
        present where the reference's are)."""
        t0 = self.round_index
        masks = None
        if self.network is not None and not self.network.full_availability:
            masks = net_availability.sample_rounds(self.network, self.m,
                                                   range(t0, t0 + n))
        sched = None
        if self.faults is not None:
            sched = net_faults.sample_rounds(self.faults, self.m,
                                             range(t0, t0 + n))
            if net_faults.darkens(self.faults):
                # crashed and bursting learners leave the availability
                # mask; the composition only removes learners
                down = sched.down()
                masks = ~down if masks is None else masks & ~down
        if self.fleet is not None:      # this rank's learners' batches
            batches = shard.put_fleet(self.fleet, batches, axis=1)
        losses = torch.empty((n, self.m_local), dtype=torch.float32,
                             device=self.device)
        divs = (torch.empty((n,), dtype=torch.float32, device=self.device)
                if self.track_divergence else None)
        comm = np.zeros((n, len(CommRecord._fields)), np.int64)
        counts = np.zeros((n, self.num_links, 2), np.int32)
        carried = np.zeros((n, 4), np.int64)
        checked = np.zeros((n,), bool)
        with shard.use_fleet(self.fleet):
            for i in range(n):
                losses[i], comm[i], counts[i], checked[i] = self._round(
                    {k: v[i] for k, v in batches.items()},
                    None if masks is None else masks[i],
                    None if sched is None else (sched, i))
                carried[i] = self._carried()
                if divs is not None:
                    divs[i] = self._divergence()
            if self.fleet is not None and self.fleet.n_devices > 1:
                losses = shard.all_gather(self.fleet, losses, dim=1)
        num_active = (np.full((n,), self.m, np.int64) if masks is None
                      else masks.sum(axis=1, dtype=np.int64))
        m = self.m
        if self.network is not None:
            net_time = net_cost.round_network_time(
                counts[..., :m, 0], counts[..., :m, 1], self.model_bytes,
                self._link_bw, self._link_lat)
            if self.tiers is not None:
                # the two tiers back to back: members with their
                # aggregator, then the aggregators with the top coordinator
                net_time = net_time + net_cost.round_network_time(
                    counts[..., m:, 0], counts[..., m:, 1],
                    self.inter_model_bytes, self._agg_bw, self._agg_lat)
        else:
            net_time = np.zeros((n,), np.float32)
        parts = [losses.sum().reshape(1), losses.sum(dim=0)]
        if observe:
            parts.append(losses.sum(dim=1))
        if divs is not None:
            parts.append(divs)
        host = torch.cat(parts).cpu().numpy()      # the one transfer
        round_loss = host[1 + m:1 + m + n] if observe else None
        divergence = (host[-n:] if divs is not None
                      else np.zeros((n,), np.float32))
        self.rounds += n
        if observe:
            # the sequential float64 sums of the per-round series: the
            # recorder's cum_* arithmetic, so the last record equals the
            # counters bit for bit
            self.cumulative_loss += float(
                np.cumsum(round_loss.astype(np.float64))[-1])
            self.network_time += float(
                np.cumsum(np.asarray(net_time, np.float64))[-1])
        else:
            self.cumulative_loss += float(host[0])
            # the chunk's network time is its f32 sum, as the reference
            # folds it
            self.network_time += float(np.cumsum(net_time,
                                                 dtype=np.float32)[-1])
        self.cumulative_loss_per_learner += host[1:1 + m]
        self._report_nonfinite()
        for k, total in zip(CommRecord._fields, comm.sum(axis=0)):
            self.comm_totals[k] += int(total)
        self.active_rounds_total += int(num_active.sum())
        self.link_xfer_totals += counts[..., :m, 0].sum(axis=0,
                                                       dtype=np.int64)
        self.link_bytes_totals += self.price_link_counts(
            counts.sum(axis=0, dtype=np.int64))
        num_faulty = (sched.num_faulty() if sched is not None
                      else np.zeros((n,), np.int32))
        metrics = ProtocolMetrics(
            loss_per_learner=losses,
            comm=CommRecord(*(comm[:, j] for j in range(comm.shape[1]))),
            link_xfers=counts[..., :m, 0], link_counts=counts,
            num_active=num_active, net_time=net_time,
            num_inflight=carried[:, 0], max_age=carried[:, 1],
            checked=checked, divergence=divergence, num_faulty=num_faulty,
            num_quarantined=carried[:, 2], num_recovered=carried[:, 3])
        if not observe:
            return metrics
        per = {"loss": round_loss, "divergence": divergence,
               "num_active": num_active, "net_time": net_time,
               "comm": {k: comm[:, j]
                        for j, k in enumerate(CommRecord._fields)},
               "link_counts": counts}
        extra_state = self.spec.extra_state
        if extra_state:
            # the carried-state series, only for triggers that carry state
            # — records of stateless runs keep the reference's keys
            per["num_inflight"], per["max_age"] = carried[:, 0], carried[:, 1]
        if sched is not None:
            per["num_faulty"] = num_faulty
        if "health" in extra_state:
            per["num_quarantined"] = carried[:, 2]
            per["num_recovered"] = carried[:, 3]
        return metrics, per

    def _divergence(self) -> torch.Tensor:
        """delta(f) = 1/m sum_i ||f_i - mean(f)||^2 on the plane: one
        ``sqdist_rows`` pass against the mean row, on the device (a
        sharded fleet's mean and distances gathered)."""
        return torch.mean(shard.row_dists_device(
            self.X, shard.row_mean(self.X)))

    def _report_nonfinite(self) -> None:
        """One-shot: the first fold where a loss counter goes non-finite
        names the offending learners, then stays quiet."""
        if self._nonfinite_reported:
            return
        bad = ~np.isfinite(self.cumulative_loss_per_learner)
        if bad.any() or not np.isfinite(self.cumulative_loss):
            self._nonfinite_reported = True
            sink.get_logger().event(
                "nonfinite_loss", round=self.rounds,
                learners=[int(i) for i in np.flatnonzero(bad)])

    def _state_extra(self):
        """The trigger-carried state (host arrays) for a chunk record."""
        if self.tiers is not None:
            return {"intra": dict(self.sync_state.intra.extra),
                    "inter": dict(self.sync_state.inter.extra)}
        return dict(self.sync_state.extra)

    def _tiers_meta(self):
        if self.tiers is None:
            return None
        return {"num_clusters": self.tiers.num_clusters,
                "link_class": self.tiers.link_class,
                "inter": resolve_spec(self.tiers.inter).to_dict()}

    def step(self, batches) -> ProtocolMetrics:
        """One round. ``batches``: dict with leading (m, B, ...) leaves."""
        metrics = self._run({k: v[None] for k, v in batches.items()}, 1)
        return ProtocolMetrics(
            metrics.loss_per_learner[0],
            CommRecord(*(int(c[0]) for c in metrics.comm)),
            metrics.link_xfers[0], metrics.link_counts[0],
            int(metrics.num_active[0]), metrics.net_time[0],
            int(metrics.num_inflight[0]), int(metrics.max_age[0]),
            bool(metrics.checked[0]), metrics.divergence[0],
            int(metrics.num_faulty[0]), int(metrics.num_quarantined[0]),
            int(metrics.num_recovered[0]))

    def run_chunk(self, batches) -> ProtocolMetrics:
        """n rounds. ``batches``: dict with leading (n, m, B, ...) leaves —
        round t of the chunk is ``batches[t]``. Returns stacked
        ``ProtocolMetrics``: ``loss_per_learner`` is (n, m), every
        ``CommRecord`` field, ``num_active``, ``net_time`` and the other
        per-round series (n,)."""
        return self._run(batches, int(next(iter(batches.values())).shape[0]))

    # ------------------------------------------------------------------
    def price_link_counts(self, counts: np.ndarray) -> np.ndarray:
        """(..., L, 2) int64 [transfers, messages] -> (..., L) int64 bytes:
        each link's payload size times its transfers, plus the control
        messages it sent."""
        return (counts[..., 0] * self.link_payload_bytes
                + counts[..., 1] * self.msg_bytes)

    def comm_bytes_of(self, totals, msg_bytes: Optional[int] = None) -> int:
        """Bytes for a comm-counter dict (paper's c(f) accounting);
        ``msg_bytes`` defaults to the configured
        ``NetworkConfig.msg_bytes`` (64 on an ideal network)."""
        if msg_bytes is None:
            msg_bytes = self.msg_bytes
        return ((totals["model_up"] + totals["model_down"]) * self.model_bytes
                + totals["messages"] * msg_bytes)

    def comm_bytes(self, msg_bytes: Optional[int] = None) -> int:
        """Cumulative communication in bytes (paper's c(f) accounting).
        Under a hierarchy the tiers move different payload sizes, so the
        total is the bytes ledger's sum (``msg_bytes`` is ignored)."""
        if self.tiers is not None:
            return int(self.link_bytes_totals.sum())
        return self.comm_bytes_of(self.comm_totals, msg_bytes)

    def per_link_bytes(self) -> np.ndarray:
        """The bytes ledger: (L,) cumulative int64 bytes each link carried
        — model payloads at its tier's payload size plus the control
        messages it sent. Rows ``0..m-1`` are the learner links; under a
        hierarchy rows ``m..m+g-1`` are the aggregator uplinks. For the
        coordinator protocols ``sum(per_link_bytes()) == comm_bytes()``;
        under gossip every transfer occupies both endpoints' links, so the
        sum is ``2 * comm_bytes()``; under aircomp each member's link
        carries one analog frame a sync, so it is not c(f)."""
        return self.link_bytes_totals.copy()

    def counters_snapshot(self) -> dict:
        """The cumulative counters the telemetry plane bases its per-round
        ``cum_*`` series on — taken BEFORE a chunk is accumulated."""
        return {"rounds": self.rounds,
                "cumulative_loss": self.cumulative_loss,
                "network_time": self.network_time,
                "syncs": self.comm_totals["syncs"],
                "cum_bytes": self.comm_bytes(),
                "link_bytes_totals": self.link_bytes_totals.copy()}

    def counters_state(self) -> dict:
        """JSON-ready snapshot of every cumulative counter, for a
        checkpoint's ``.counters.json`` (the reference's keys)."""
        return {
            "rounds": int(self.rounds),
            "cumulative_loss": float(self.cumulative_loss),
            "cumulative_loss_per_learner": [
                float(x) for x in self.cumulative_loss_per_learner],
            "comm_totals": {k: int(v) for k, v in self.comm_totals.items()},
            "network_time": float(self.network_time),
            "active_rounds_total": int(self.active_rounds_total),
            "link_xfer_totals": [int(x) for x in self.link_xfer_totals],
            "link_bytes_totals": [int(x) for x in self.link_bytes_totals],
        }

    def restore_counters(self, d: dict) -> None:
        """Restore counters saved by :meth:`counters_state`, with the
        reference's errors for a snapshot of another fleet. With a
        recorder attached, the stream's meta record is written again with
        ``resumed_rounds``."""
        if len(d["cumulative_loss_per_learner"]) != self.m:
            raise ValueError(
                f"counters were saved for m="
                f"{len(d['cumulative_loss_per_learner'])} learners, "
                f"this engine has m={self.m}")
        if len(d["link_bytes_totals"]) != self.num_links:
            raise ValueError(
                f"counters were saved for {len(d['link_bytes_totals'])} "
                f"links, this engine has {self.num_links} (did the "
                f"hierarchy change?)")
        unknown = sorted(set(d["comm_totals"]) - set(self.comm_totals))
        if unknown:
            raise ValueError(f"unknown comm counters in checkpoint: "
                             f"{unknown}")
        self.rounds = int(d["rounds"])
        self.cumulative_loss = float(d["cumulative_loss"])
        self.cumulative_loss_per_learner = np.asarray(
            d["cumulative_loss_per_learner"], np.float32)
        self.comm_totals = {k: int(v) for k, v in d["comm_totals"].items()}
        self.network_time = float(d["network_time"])
        self.active_rounds_total = int(d["active_rounds_total"])
        self.link_xfer_totals = np.asarray(d["link_xfer_totals"], np.int64)
        self.link_bytes_totals = np.asarray(
            d["link_bytes_totals"], np.int64)
        if self.recorder is not None:
            # the stream says where it picks up
            self.recorder.resume(self.rounds)

    def mean_active(self) -> float:
        """Average fraction of the fleet reachable per executed round."""
        if self.rounds == 0:
            return 1.0
        return self.active_rounds_total / (self.rounds * self.m)

    def link_class_names(self):
        """(L,) link-class names matching the ledger's rows: learner links
        round-robin over ``NetworkConfig.link_classes`` (``"ideal"``
        without a network), then a hierarchy's aggregator uplinks."""
        if self.network is None:
            names = ("ideal",) * self.m
        else:
            lc = self.network.link_classes
            names = tuple(lc[i % len(lc)] for i in range(self.m))
        if self.tiers is not None:
            names += (self.tiers.link_class,) * self.tiers.num_clusters
        return names

    def mean_model(self):
        """The fleet's mean model as a parameter tree (every rank of a
        sharded fleet must call it)."""
        with shard.use_fleet(self.fleet):
            return self.adapter.unravel_model(shard.row_mean(self.X))

    def learner_model(self, i: int):
        """Learner i's model as a parameter tree (a copy; every rank of a
        sharded fleet must call it)."""
        with shard.use_fleet(self.fleet):
            return self.adapter.unravel_model(
                shard.plane_row(self.X, i).clone())


class SerialLearner:
    """The paper's serial baseline: one model, all the data. ``step``
    takes one batch ``(B, ...)``; ``run_chunk`` takes n rounds of batches
    ``(n, B, ...)``, fetches their losses in one transfer and returns the
    (n,) losses. ``cumulative_loss`` sums the per-round losses in float64,
    as the reference does. The model is a ``(P,)`` row that the
    optimizer updates in place; ``params`` views it as a tree."""

    def __init__(self, loss_fn, init_fn, train: TrainConfig = TrainConfig(),
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.opt = make_optimizer(train)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        base = tree_map(lambda x: x.to(self.device), init_fn(gen))
        self.adapter = fleet_adapter(base)
        self.x = self.adapter.ravel_model(base)
        self.g = torch.empty_like(self.x)
        self.opt_state = self.opt.init(self.x)
        self.cumulative_loss = 0.0
        self._grad_and_loss = torch.func.grad_and_value(loss_fn)

    @property
    def params(self):
        return self.adapter.unravel_model(self.x)

    def _round(self, batch) -> torch.Tensor:
        batch = {k: v.to(self.device) for k, v in batch.items()}
        grads, loss = self._grad_and_loss(self.params, batch)
        torch.cat([g.reshape(-1).to(self.x.dtype)
                   for g in tree_leaves(grads)], out=self.g)
        self.x, self.opt_state = self.opt.update(self.x, self.g,
                                                 self.opt_state)
        return loss

    def step(self, batch) -> torch.Tensor:
        loss = self._round(batch)
        self.cumulative_loss += float(loss)
        return loss

    def run_chunk(self, batches) -> torch.Tensor:
        n = int(next(iter(batches.values())).shape[0])
        losses = torch.stack([self._round({k: v[i] for k, v in
                                           batches.items()})
                              for i in range(n)])
        self.cumulative_loss += float(
            losses.cpu().numpy().astype(np.float64).sum())
        return losses
