"""The decentralized learning simulator: m learners, one protocol — the
counterpart of ``repro.core.protocol`` on an ideal network.

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

Departures from the reference: no network, async, fault, hierarchy or
telemetry config (later slices); no ``init_heterogeneity`` (it draws from
jax's RNG) and no ``SerialLearner`` (ROADMAP Queue A); ``init_fn`` takes a
``torch.Generator``; ``ProtocolMetrics`` carries only what an ideal
network produces; and the entry point runs on ``device="cuda"`` unless
the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.config import TrainConfig
from repro_torch.core.flatten import fleet_adapter, tree_leaves, tree_map
from repro_torch.core.sync.kernel import apply_staged, init_state
from repro_torch.core.sync.registry import CommRecord
from repro_torch.core.sync.spec import resolve_spec
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import make_optimizer


class ProtocolMetrics(NamedTuple):
    """One call's per-round metrics; ``run_chunk`` stacks a leading round
    axis on every field."""
    loss_per_learner: torch.Tensor   # (m,) this-round loss, on the device
    comm: CommRecord                 # host ints / (n,) int64 arrays
    link_xfers: np.ndarray           # (m,) int32 models per learner link
    link_counts: np.ndarray          # (m, 2) int32 [transfers, messages]


class DecentralizedLearner:
    """m local learners + a synchronization protocol Pi = (phi, sigma).

    ``loss_fn(params, batch)`` is one learner's loss; ``init_fn(generator)``
    returns the initial parameter tree, which every learner starts from
    (the paper's homogeneous init). ``protocol`` is a ``ProtocolConfig``
    or a ``ProtocolSpec``."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        init_fn: Callable[[torch.Generator], Any],
        m: int,
        protocol,
        train: TrainConfig = TrainConfig(),
        seed: int = 0,
        sample_weights: Optional[torch.Tensor] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.m = m
        self.protocol = protocol
        self.spec = resolve_spec(protocol)
        self.train = train
        self.loss_fn = loss_fn
        self.opt = make_optimizer(train)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        base = tree_map(lambda x: x.to(self.device), init_fn(gen))
        self.adapter = fleet_adapter(base)
        row = self.adapter.ravel_model(base)
        self.X = row[None].repeat(m, 1)              # the (m, P) plane
        self.G = torch.empty_like(self.X)            # the gradient plane
        self.opt_state = self.opt.init(self.X)
        self.sync_state = init_state(row)
        self.sample_weights = (None if sample_weights is None
                               else sample_weights.to(self.device))
        self.model_size = self.adapter.P
        self.model_bytes = self.model_size * self.spec.bytes_per_param
        self._grad_and_loss = torch.func.vmap(
            torch.func.grad_and_value(loss_fn))

        # cumulative counters (host-side Python ints / floats / numpy)
        self.cumulative_loss = 0.0
        self.cumulative_loss_per_learner = np.zeros((m,), np.float32)
        self.comm_totals = {k: 0 for k in CommRecord._fields}
        self.rounds = 0
        self.link_xfer_totals = np.zeros((m,), np.int64)
        self.link_bytes_totals = np.zeros((m,), np.int64)
        self.msg_bytes = 64
        self.link_payload_bytes = np.full((m,), self.model_bytes, np.int64)

    @property
    def params(self):
        """The fleet as a stacked (m, ...) tree of views into the plane."""
        return self.adapter.unravel(self.X)

    # ------------------------------------------------------------------
    def _round(self, batch):
        """One round on the plane; returns (losses (m,) on the device,
        StageResult). The three layers are named ranges for
        ``torch.profiler`` (microseconds each when none is active)."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        with record_function("round.local_step"):
            grads, losses = self._grad_and_loss(self.params, batch)
            torch.cat([g.reshape(self.m, -1).to(self.X.dtype)
                       for g in tree_leaves(grads)], dim=1, out=self.G)
        with record_function("round.optimizer"):
            self.X, self.opt_state = self.opt.update(self.X, self.G,
                                                     self.opt_state)
        with record_function("round.sync"):
            res = apply_staged(self.spec, self.X, self.sync_state,
                               self.sample_weights)
        self.X, self.sync_state = res.params, res.state
        return losses, res

    def _run(self, batches, n: int) -> ProtocolMetrics:
        """n rounds, then ONE device-to-host transfer of the losses."""
        losses = torch.empty((n, self.m), dtype=torch.float32,
                             device=self.device)
        comm = np.zeros((n, len(CommRecord._fields)), np.int64)
        counts = np.zeros((n, self.m, 2), np.int32)
        for i in range(n):
            li, res = self._round({k: v[i] for k, v in batches.items()})
            losses[i] = li
            comm[i] = res.rec
            counts[i, :, 0] = res.xfers
            counts[i, :, 1] = res.link_msgs
        host = torch.cat([losses.sum().reshape(1), losses.sum(dim=0)]).cpu()
        host = host.numpy()
        self.rounds += n
        self.cumulative_loss += float(host[0])
        self.cumulative_loss_per_learner += host[1:]
        for k, total in zip(CommRecord._fields, comm.sum(axis=0)):
            self.comm_totals[k] += int(total)
        self.link_xfer_totals += counts[..., 0].sum(axis=0, dtype=np.int64)
        self.link_bytes_totals += self.price_link_counts(
            counts.sum(axis=0, dtype=np.int64))
        return ProtocolMetrics(
            loss_per_learner=losses,
            comm=CommRecord(*(comm[:, j] for j in range(comm.shape[1]))),
            link_xfers=counts[..., 0], link_counts=counts)

    def step(self, batches) -> ProtocolMetrics:
        """One round. ``batches``: dict with leading (m, B, ...) leaves."""
        metrics = self._run({k: v[None] for k, v in batches.items()}, 1)
        return ProtocolMetrics(
            metrics.loss_per_learner[0],
            CommRecord(*(int(c[0]) for c in metrics.comm)),
            metrics.link_xfers[0], metrics.link_counts[0])

    def run_chunk(self, batches) -> ProtocolMetrics:
        """n rounds. ``batches``: dict with leading (n, m, B, ...) leaves —
        round t of the chunk is ``batches[t]``. Returns stacked
        ``ProtocolMetrics``: ``loss_per_learner`` is (n, m), every
        ``CommRecord`` field (n,)."""
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
        ``msg_bytes`` defaults to 64 (an ideal network)."""
        if msg_bytes is None:
            msg_bytes = self.msg_bytes
        return ((totals["model_up"] + totals["model_down"]) * self.model_bytes
                + totals["messages"] * msg_bytes)

    def comm_bytes(self, msg_bytes: Optional[int] = None) -> int:
        """Cumulative communication in bytes (paper's c(f) accounting)."""
        return self.comm_bytes_of(self.comm_totals, msg_bytes)

    def per_link_bytes(self) -> np.ndarray:
        """The bytes ledger: (m,) cumulative int64 bytes each learner link
        carried — model payloads plus the control messages it sent;
        ``sum(per_link_bytes()) == comm_bytes()``."""
        return self.link_bytes_totals.copy()

    def mean_model(self):
        """The fleet's mean model as a parameter tree."""
        return self.adapter.unravel_model(torch.mean(self.X, dim=0))

    def learner_model(self, i: int):
        """Learner i's model as a parameter tree (a copy)."""
        return self.adapter.unravel_model(self.X[i].clone())
