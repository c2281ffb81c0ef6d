"""High-level protocol training loop — the counterpart of
``repro.train.loop``.

Runs a ``DecentralizedLearner`` against a data source for T rounds, in
chunks of ``chunk_size`` rounds through ``run_chunk``, and records the
per-round cumulative loss and communication (the quantities the paper
plots) every ``record_every`` rounds, reconstructed from each chunk's
stacked metrics.

Departures: no concept drift (``drift=False`` is the only mode until the
drifting sources are ported), no network/async/fault/telemetry configs,
so ``Trajectory`` has no drift rounds and no simulated network time; and
``device`` defaults to ``"cuda"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np

from repro_torch.config import TrainConfig
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

    def as_dict(self):
        return {"rounds": self.rounds,
                "cumulative_loss": self.cumulative_loss,
                "cumulative_bytes": self.cumulative_bytes,
                "syncs": self.syncs}


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
    batch_sizes=None,
    chunk_size: int = DEFAULT_CHUNK,
    device="cuda",
) -> tuple:
    """Returns (learner, trajectory). The data source must live on the
    learner's device."""
    streams = LearnerStreams(source, m, batch=batch, seed=seed,
                             batch_sizes=batch_sizes)
    dl = DecentralizedLearner(
        loss_fn, init_fn, m, protocol, train, seed=seed,
        sample_weights=streams.weights, device=device)
    if streams.device != dl.device:
        raise ValueError(
            f"the data source is on {streams.device}, the learners on "
            f"{dl.device}")
    traj = Trajectory()
    chunk = max(1, min(chunk_size, rounds))
    t = 0
    while t < rounds:
        n = min(chunk, rounds - t)
        base_loss = dl.cumulative_loss
        base_totals = dict(dl.comm_totals)
        metrics = dl.run_chunk(streams.next_chunk(n))
        loss_cum = base_loss + np.cumsum(
            metrics.loss_per_learner.sum(dim=1).cpu().numpy()
            .astype(np.float64))
        comm_cum = {k: base_totals[k] + np.cumsum(
            np.asarray(getattr(metrics.comm, k), np.int64))
            for k in CommRecord._fields}
        for i in range(n):
            g = t + i
            if (g + 1) % record_every == 0 or g == rounds - 1:
                traj.rounds.append(g + 1)
                traj.cumulative_loss.append(float(loss_cum[i]))
                traj.cumulative_bytes.append(dl.comm_bytes_of(
                    {k: int(v[i]) for k, v in comm_cum.items()}))
                traj.syncs.append(int(comm_cum["syncs"][i]))
        t += n
    return dl, traj
