"""High-level protocol training loop — the counterpart of
``repro.train.loop``.

Runs a ``DecentralizedLearner`` against a data source for T rounds, in
chunks of ``chunk_size`` rounds through ``run_chunk``, and records the
per-round cumulative loss and communication (the quantities the paper
plots) every ``record_every`` rounds, reconstructed from each chunk's
stacked metrics. With ``drift=True`` and a source that can drift
(``maybe_drift``), the source is offered a drift before every round, in
the reference's order, and ``Trajectory.drift_rounds`` records the
rounds where one happened. ``run_drift_segments`` runs known drift
rounds instead, as the drift figures do. With ``network=`` the learners
run inside the simulated network, and ``Trajectory.network_time``
records the cumulative simulated seconds; ``async_net=`` runs the
event-driven timeline; a protocol with ``tiers`` runs the two-tier
hierarchy, whose byte curve is the per-round ledger priced per tier.
``faults=`` injects the fault plane and ``telemetry=`` attaches the
telemetry plane (one record per round, no change to the numerics).

Departure: ``device`` defaults to ``"cuda"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.config import (
    AsyncConfig, FaultConfig, NetworkConfig, TelemetryConfig, TrainConfig,
)
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.core.sync.registry import CommRecord
from repro_torch.data.pipeline import LearnerStreams

DEFAULT_CHUNK = 64


@dataclass
class Trajectory:
    rounds: List[int] = field(default_factory=list)
    cumulative_loss: List[float] = field(default_factory=list)
    cumulative_bytes: List[int] = field(default_factory=list)
    syncs: List[int] = field(default_factory=list)
    network_time: List[float] = field(default_factory=list)
    drift_rounds: List[int] = field(default_factory=list)

    def as_dict(self):
        return {"rounds": self.rounds,
                "cumulative_loss": self.cumulative_loss,
                "cumulative_bytes": self.cumulative_bytes,
                "syncs": self.syncs,
                "network_time": self.network_time,
                "drift_rounds": self.drift_rounds}


def run_drift_segments(dl, streams, source, rounds: int, drift_rounds=()):
    """Run ``rounds`` rounds as chunks cut at KNOWN drift rounds, calling
    ``source.force_drift()`` at each cut. Returns the per-round
    cumulative ``(sync_curve, loss_curve)`` arrays the drift figures
    plot, from each chunk's stacked metrics.

    ``drift_rounds`` must lie strictly inside (0, rounds): a drift at
    round 0 is just another initial concept, and one at or after the
    last round cannot be seen."""
    bounds = sorted(set(int(d) for d in drift_rounds))
    if bounds and (bounds[0] <= 0 or bounds[-1] >= rounds):
        raise ValueError(
            f"drift_rounds must lie strictly inside (0, {rounds}): {bounds}")
    sync_curve, loss_curve = [], []
    for start, end in zip([0] + bounds, bounds + [rounds]):
        if start in bounds:
            source.force_drift()
        metrics = dl.run_chunk(streams.next_chunk(end - start))
        s0 = sync_curve[-1] if sync_curve else 0
        l0 = loss_curve[-1] if loss_curve else 0.0
        sync_curve.extend(
            (s0 + np.cumsum(np.asarray(metrics.comm.syncs, np.int64)))
            .tolist())
        loss_curve.extend((l0 + np.cumsum(
            metrics.loss_per_learner.cpu().numpy().astype(np.float64)
            .sum(axis=1))).tolist())
    return np.asarray(sync_curve), np.asarray(loss_curve)


def run_protocol_training(
    loss_fn: Callable,
    init_fn: Callable,
    source,
    m: int,
    rounds: int,
    protocol,   # ProtocolConfig sugar or a ProtocolSpec composition
    train: TrainConfig = TrainConfig(),
    batch: int = 10,
    seed: int = 0,
    record_every: int = 10,
    drift: bool = False,
    batch_sizes=None,
    init_heterogeneity: float = 0.0,
    chunk_size: int = DEFAULT_CHUNK,
    network: Optional[NetworkConfig] = None,
    async_net: Optional[AsyncConfig] = None,
    telemetry: Optional[TelemetryConfig] = None,
    faults: Optional[FaultConfig] = None,
    device="cuda",
) -> tuple:
    """Returns (learner, trajectory). The data source must live on the
    learner's device; ``network`` runs the fleet inside the simulated
    network environment, ``async_net`` on its event-driven timeline,
    ``faults`` under the fault plane; ``telemetry`` streams a record per
    round."""
    streams = LearnerStreams(source, m, batch=batch, seed=seed,
                             batch_sizes=batch_sizes)
    dl = DecentralizedLearner(
        loss_fn, init_fn, m, protocol, train, seed=seed,
        init_heterogeneity=init_heterogeneity,
        sample_weights=streams.weights, network=network,
        async_net=async_net, telemetry=telemetry, faults=faults,
        device=device)
    if streams.device != dl.device:
        raise ValueError(
            f"the data source is on {streams.device}, the learners on "
            f"{dl.device}")
    traj = Trajectory()
    chunk = max(1, min(chunk_size, rounds))
    t = 0
    drifting = drift and hasattr(source, "maybe_drift")
    while t < rounds:
        n = min(chunk, rounds - t)

        def on_round(i, t=t):
            if source.maybe_drift():
                traj.drift_rounds.append(t + i)

        base_loss = dl.cumulative_loss
        base_totals = dict(dl.comm_totals)
        base_net_time = dl.network_time
        base_ledger = int(dl.link_bytes_totals.sum())
        metrics = dl.run_chunk(streams.next_chunk(
            n, on_round=on_round if drifting else None))
        loss_cum = base_loss + np.cumsum(
            metrics.loss_per_learner.sum(dim=1).cpu().numpy()
            .astype(np.float64))
        comm_cum = {k: base_totals[k] + np.cumsum(
            np.asarray(getattr(metrics.comm, k), np.int64))
            for k in CommRecord._fields}
        # under a hierarchy the tiers move different payload sizes: the
        # byte curve is the per-round ledger, priced per link
        ledger_cum = base_ledger + np.cumsum(dl.price_link_counts(
            np.asarray(metrics.link_counts, np.int64)).sum(axis=1))
        net_cum = base_net_time + np.cumsum(
            np.asarray(metrics.net_time, np.float64))
        for i in range(n):
            g = t + i
            if (g + 1) % record_every == 0 or g == rounds - 1:
                traj.rounds.append(g + 1)
                traj.cumulative_loss.append(float(loss_cum[i]))
                traj.cumulative_bytes.append(
                    int(ledger_cum[i]) if dl.tiers is not None
                    else dl.comm_bytes_of(
                        {k: int(v[i]) for k, v in comm_cum.items()}))
                traj.syncs.append(int(comm_cum["syncs"][i]))
                traj.network_time.append(float(net_cum[i]))
        t += n
    return dl, traj
