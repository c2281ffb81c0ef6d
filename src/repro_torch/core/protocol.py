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

Departures from the reference: no async, fault, hierarchy or telemetry
config (later slices); ``init_fn`` takes a ``torch.Generator`` seeded
with ``seed`` (the reference hands it the first of the three keys), so a
parity test passes the reference's initial model in;
``init_heterogeneity``'s noise is ``prng.normal``, within its stated
tolerance of jax's; masks, overlays and network times are host values,
so ``ProtocolMetrics`` carries no divergence, in-flight, age or fault
series, and ``num_active`` / ``net_time`` as host arrays; and the entry
points run on ``device="cuda"`` unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import prng
from repro_torch.config import NetworkConfig, TrainConfig
from repro_torch.core.flatten import fleet_adapter, tree_leaves, tree_map
from repro_torch.core.sync.kernel import apply_staged, init_state
from repro_torch.core.sync.registry import CommRecord
from repro_torch.core.sync.spec import resolve_spec
from repro_torch.device import resolve_device
from repro_torch.network import availability as net_availability
from repro_torch.network import cost as net_cost
from repro_torch.network import topology as net_topology
from repro_torch.optim.optimizers import make_optimizer


class ProtocolMetrics(NamedTuple):
    """One call's per-round metrics; ``run_chunk`` stacks a leading round
    axis on every field."""
    loss_per_learner: torch.Tensor   # (m,) this-round loss, on the device
    comm: CommRecord                 # host ints / (n,) int64 arrays
    link_xfers: np.ndarray           # (m,) int32 models per learner link
    link_counts: np.ndarray          # (m, 2) int32 [transfers, messages]
    num_active: Any                  # int / (n,) int64 reachable learners
    net_time: Any                    # np.float32 / (n,) simulated seconds


class DecentralizedLearner:
    """m local learners + a synchronization protocol Pi = (phi, sigma).

    ``loss_fn(params, batch)`` is one learner's loss; ``init_fn(generator)``
    returns the initial parameter tree, which every learner starts from
    (the paper's homogeneous init), or, with ``init_heterogeneity`` = ε >
    0, that tree plus per-learner Gaussian noise at ε times each leaf's
    standard deviation (Fig. 6.2). ``protocol`` is a ``ProtocolConfig``
    or a ``ProtocolSpec``; ``network`` a ``NetworkConfig`` or None (the
    ideal always-on network)."""

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
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.m = m
        self.protocol = protocol
        self.spec = resolve_spec(protocol)
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
        else:
            self.X = row[None].repeat(m, 1)
        self.G = torch.empty_like(self.X)            # the gradient plane
        self.opt_state = self.opt.init(self.X)
        self.sync_state = init_state(row, seed, spec=self.spec, m=m)
        self.sample_weights = (None if sample_weights is None
                               else sample_weights.to(self.device))
        self.model_size = self.adapter.P
        self.model_bytes = self.model_size * self.spec.bytes_per_param
        self._grad_and_loss = torch.func.vmap(
            torch.func.grad_and_value(loss_fn))

        # network environment: link profile and peer overlay, a static
        # one built once, a mobile one per redraw window
        self.network = network
        self._link_bw = self._link_lat = None
        self._static_adj = None
        self._mobile = False
        if network is not None:
            self._link_bw, self._link_lat = net_cost.link_profile(network, m)
            self._mobile = net_topology.is_mobile(network)
            if not self._mobile:
                self._static_adj = net_topology.adjacency(network, m)
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
        self.link_bytes_totals = np.zeros((m,), np.int64)
        self.msg_bytes = network.msg_bytes if network is not None else 64
        self.link_payload_bytes = np.full((m,), self.model_bytes, np.int64)

    @property
    def params(self):
        """The fleet as a stacked (m, ...) tree of views into the plane."""
        return self.adapter.unravel(self.X)

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

    def _round(self, batch, active=None):
        """One round on the plane; returns (losses (m,) on the device,
        StageResult). The three layers are named ranges for
        ``torch.profiler`` (microseconds each when none is active).
        ``active`` is the round's availability mask (None: all
        reachable)."""
        t = self.sync_state.step                     # this round's index
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
                               self.sample_weights, active=active,
                               adjacency=self._adjacency(t))
        self.X, self.sync_state = res.params, res.state
        return losses, res

    def _run(self, batches, n: int) -> ProtocolMetrics:
        """n rounds, then ONE device-to-host transfer of the losses. The
        chunk's availability masks are drawn before its first round, in
        one call."""
        t0 = self.sync_state.step
        masks = None
        if self.network is not None and not self.network.full_availability:
            masks = net_availability.sample_rounds(self.network, self.m,
                                                   range(t0, t0 + n))
        losses = torch.empty((n, self.m), dtype=torch.float32,
                             device=self.device)
        comm = np.zeros((n, len(CommRecord._fields)), np.int64)
        counts = np.zeros((n, self.m, 2), np.int32)
        for i in range(n):
            li, res = self._round({k: v[i] for k, v in batches.items()},
                                  None if masks is None else masks[i])
            losses[i] = li
            comm[i] = res.rec
            counts[i, :, 0] = res.xfers
            counts[i, :, 1] = res.link_msgs
        num_active = (np.full((n,), self.m, np.int64) if masks is None
                      else masks.sum(axis=1, dtype=np.int64))
        if self.network is not None:
            net_time = net_cost.round_network_time(
                counts[..., 0], counts[..., 1], self.model_bytes,
                self._link_bw, self._link_lat)
        else:
            net_time = np.zeros((n,), np.float32)
        host = torch.cat([losses.sum().reshape(1), losses.sum(dim=0)]).cpu()
        host = host.numpy()
        self.rounds += n
        self.cumulative_loss += float(host[0])
        self.cumulative_loss_per_learner += host[1:]
        for k, total in zip(CommRecord._fields, comm.sum(axis=0)):
            self.comm_totals[k] += int(total)
        # the chunk's network time is its f32 sum, as the reference folds it
        self.network_time += float(np.cumsum(net_time, dtype=np.float32)[-1])
        self.active_rounds_total += int(num_active.sum())
        self.link_xfer_totals += counts[..., 0].sum(axis=0, dtype=np.int64)
        self.link_bytes_totals += self.price_link_counts(
            counts.sum(axis=0, dtype=np.int64))
        return ProtocolMetrics(
            loss_per_learner=losses,
            comm=CommRecord(*(comm[:, j] for j in range(comm.shape[1]))),
            link_xfers=counts[..., 0], link_counts=counts,
            num_active=num_active, net_time=net_time)

    def step(self, batches) -> ProtocolMetrics:
        """One round. ``batches``: dict with leading (m, B, ...) leaves."""
        metrics = self._run({k: v[None] for k, v in batches.items()}, 1)
        return ProtocolMetrics(
            metrics.loss_per_learner[0],
            CommRecord(*(int(c[0]) for c in metrics.comm)),
            metrics.link_xfers[0], metrics.link_counts[0],
            int(metrics.num_active[0]), metrics.net_time[0])

    def run_chunk(self, batches) -> ProtocolMetrics:
        """n rounds. ``batches``: dict with leading (n, m, B, ...) leaves —
        round t of the chunk is ``batches[t]``. Returns stacked
        ``ProtocolMetrics``: ``loss_per_learner`` is (n, m), every
        ``CommRecord`` field, ``num_active`` and ``net_time`` (n,)."""
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
        """Cumulative communication in bytes (paper's c(f) accounting)."""
        return self.comm_bytes_of(self.comm_totals, msg_bytes)

    def per_link_bytes(self) -> np.ndarray:
        """The bytes ledger: (m,) cumulative int64 bytes each learner link
        carried — model payloads plus the control messages it sent. For
        the coordinator protocols ``sum(per_link_bytes()) ==
        comm_bytes()``; under gossip every transfer occupies both
        endpoints' links, so the sum is ``2 * comm_bytes()``."""
        return self.link_bytes_totals.copy()

    def mean_active(self) -> float:
        """Average fraction of the fleet reachable per executed round."""
        if self.rounds == 0:
            return 1.0
        return self.active_rounds_total / (self.rounds * self.m)

    def link_class_names(self):
        """(m,) link-class names matching the ledger's rows, round-robin
        over ``NetworkConfig.link_classes`` (``"ideal"`` without a
        network)."""
        if self.network is None:
            return ("ideal",) * self.m
        lc = self.network.link_classes
        return tuple(lc[i % len(lc)] for i in range(self.m))

    def mean_model(self):
        """The fleet's mean model as a parameter tree."""
        return self.adapter.unravel_model(torch.mean(self.X, dim=0))

    def learner_model(self, i: int):
        """Learner i's model as a parameter tree (a copy)."""
        return self.adapter.unravel_model(self.X[i].clone())


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
