"""SPMD dynamic averaging — the counterpart of ``repro.core.distributed``,
a thin shim over the staged sync engine.

``make_dynamic_train_step`` returns ``step(state, batch) -> (state,
metrics)``: every learner takes one local step (the engine's own
``torch.func.vmap(torch.func.grad_and_value(loss))`` over the learner
axis, then the optimizer on the ``(m, P)`` plane), and the staged round
of the config's preset decides the sync, with the full-fleet cohort
forced (``augmentation="all"``, the ``B = [m]`` branch of Algorithm 1)
— divergence trigger, mean aggregate, balancing commit.
``make_periodic_train_step`` is the sigma_b baseline in the same
layout. The metrics keep the reference's keys: ``loss``,
``loss_per_learner``, ``synced`` (this step's 0/1) and, for the
dynamic step, ``max_sq_dist`` (on check steps, else 0).

The reference's ``spmd_axis_name`` (the mesh axis carrying the learner
dim) has no PyTorch meaning. Its place is taken by ``fleet``, an
optional ``shard.FleetSharding``: under it the learners split over the
fleet's ranks as in ``layout="sharded"`` (``repro_torch.core.shard``) —
each rank's ``state`` holds its learners' rows and ``batch`` is the
whole (m, B, ...) batch, of which each rank takes its rows; the
distances and the mean cross ranks, and the metrics are the fleet's on
every rank.

Departures from the reference: ``DynamicTrainState.params`` is a stacked
tree of views into the state's ``(m, P)`` plane (a rank's rows under a
fleet), which ``plane`` holds; ``ref`` is the reference model's ``(P,)``
row; ``step``, ``syncs`` and ``checks`` are host ints. The check step's
``max_sq_dist`` comes from the same ``sqdist_rows`` pass that the
trigger reads (one launch, not the reference's two expressions).
``init_dynamic_state`` takes a ``torch.Generator`` where the reference
takes a key, as ``DecentralizedLearner`` does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.config import ProtocolConfig, TrainConfig
from repro_torch.core import shard
from repro_torch.core.flatten import fleet_adapter, tree_leaves, tree_map
from repro_torch.core.sync.kernel import SyncState
from repro_torch.core.sync.spec import resolve_spec
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import make_optimizer


class DynamicTrainState(NamedTuple):
    params: Any          # stacked (rows, ...) tree: views into ``plane``
    opt_state: Any       # OptState over the (rows, P) plane
    ref: torch.Tensor    # reference model r, the (P,) row
    step: int            # steps taken
    syncs: int           # executed averaging rounds
    checks: int          # condition evaluations
    plane: torch.Tensor  # the (rows, P) parameter plane


def init_dynamic_state(init_fn: Callable, gen: torch.Generator, m: int,
                       train: TrainConfig,
                       fleet: Optional[shard.FleetSharding] = None,
                       device="cuda") -> DynamicTrainState:
    """Every learner from ``init_fn(gen)``'s model, on ``device`` (the
    card unless the caller asks for the CPU); a fleet's rank holds its
    ``m / n`` rows."""
    device = resolve_device(device)
    base = tree_map(lambda x: x.to(device), init_fn(gen))
    adapter = fleet_adapter(base)
    row = adapter.ravel_model(base)
    rows = m if fleet is None else fleet.rows_per_device
    X = row[None].repeat(rows, 1)
    opt_state = make_optimizer(train).init(X)
    return DynamicTrainState(adapter.unravel(X), opt_state, row.clone(), 0,
                             0, 0, X)


def _spmd_spec(proto: ProtocolConfig):
    """The staged spec this shim delegates to: the config's preset with
    the full-fleet cohort forced (where the cohort consumes an
    augmentation strategy) on the tree layout (the plane here)."""
    spec = resolve_spec(proto).with_params(layout="tree")
    if "augmentation" in spec.known_params:
        spec = spec.with_params(augmentation="all")
    return spec


def _local_update(loss_fn, train, fleet):
    """The engine's local step on the state's plane: per-learner
    gradients by ``vmap(grad_and_value)``, the optimizer in place.
    Returns (plane, opt_state, (rows,) losses)."""
    opt = make_optimizer(train)
    grad_and_loss = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def update(state: DynamicTrainState, batch):
        if fleet is not None:
            batch = shard.put_fleet(fleet, batch)
        X = state.plane
        grads, losses = grad_and_loss(state.params, batch)
        G = torch.cat([g.reshape(X.shape[0], -1).to(X.dtype)
                       for g in tree_leaves(grads)], dim=1)
        X, opt_state = opt.update(X, G, state.opt_state)
        return X, opt_state, losses

    return update


def _sync_input(spec, state: DynamicTrainState, m: int) -> SyncState:
    """The staged round's carry, built per step: with ``augmentation=
    "all"`` every fired sync is full, so the violation counter is 0 in
    and 0 out and the cohort draws no randomness."""
    return SyncState(ref=state.ref, v=0, step=state.step,
                     key=prng.key(0, device="cpu"), extra=spec.init_extra(m))


def make_dynamic_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    proto: ProtocolConfig,
    train: TrainConfig,
    m: int,
    fleet: Optional[shard.FleetSharding] = None,
):
    """``step(state, batch) -> (state, metrics)``; ``batch`` leaves have
    a leading (m, per_learner_batch, ...) shape."""
    spec = _spmd_spec(proto)
    round_fn = spec.compile()
    update = _local_update(loss_fn, train, fleet)
    adapter = None

    def step(state: DynamicTrainState, batch):
        nonlocal adapter
        if adapter is None:
            adapter = fleet_adapter(tree_map(lambda x: x[0], state.params))
        X, opt_state, losses = update(state, batch)
        t = state.step + 1
        do_check = t % proto.b == 0
        maxdist = torch.zeros((), dtype=torch.float32, device=X.device)
        with shard.use_fleet(fleet):
            dists = None
            if do_check:
                # the diagnostic max and the trigger read one pass against
                # the pre-sync reference
                d = shard.row_dists_device(X, state.ref)
                maxdist = torch.max(d)
                dists = lambda: d.cpu().numpy()   # noqa: E731
            res = round_fn(X, _sync_input(spec, state, m), None,
                           dists=dists)
            losses = shard.gather_rows(losses)
        new_state = DynamicTrainState(
            adapter.unravel(res.params), opt_state, res.state.ref, t,
            state.syncs + res.rec.syncs, state.checks + int(do_check),
            res.params)
        metrics = {"loss": torch.mean(losses), "loss_per_learner": losses,
                   "synced": res.rec.syncs, "max_sq_dist": maxdist}
        return new_state, metrics

    return step


def make_periodic_train_step(loss_fn, proto: ProtocolConfig,
                             train: TrainConfig, m: int,
                             fleet: Optional[shard.FleetSharding] = None):
    """sigma_b baseline in the same layout: the ``periodic`` preset of the
    same staged round; the state keeps its initial reference model
    (periodic makes no decision from it), as the reference's does."""
    spec = _spmd_spec(
        ProtocolConfig(kind="periodic", b=proto.b,
                       bytes_per_param=proto.bytes_per_param))
    round_fn = spec.compile()
    update = _local_update(loss_fn, train, fleet)
    adapter = None

    def step(state: DynamicTrainState, batch):
        nonlocal adapter
        if adapter is None:
            adapter = fleet_adapter(tree_map(lambda x: x[0], state.params))
        X, opt_state, losses = update(state, batch)
        with shard.use_fleet(fleet):
            res = round_fn(X, _sync_input(spec, state, m), None)
            losses = shard.gather_rows(losses)
        new_state = DynamicTrainState(
            adapter.unravel(res.params), opt_state, state.ref,
            state.step + 1, state.syncs + res.rec.syncs, state.checks,
            res.params)
        return new_state, {"loss": torch.mean(losses),
                           "synced": res.rec.syncs}

    return step
