"""The MoE fleet in the port against the JAX package on the CPU: the
learners' ``torch.func.vmap`` over ``lm_loss`` of mixtral-8x22b-smoke
(8 experts, top 2, banded attention) and deepseek-v2-236b-smoke (MLA,
16 experts, top 6, 2 shared).

* ``vmap(grad_and_value(lm_loss))`` over M learners against each
  learner's own unbatched call: the losses bit for bit, the gradients
  within ``VMAP_TOL`` of each leaf's largest entry. The routing's one-hot
  and its bucket scatter are written with ops that vmap batches
  (``models/moe.py``); ``F.one_hot`` and an in-place ``scatter_`` into
  an unbatched tensor raised under vmap.
* ``make_dynamic_train_step`` and ``make_periodic_train_step`` with
  ``lm_loss`` for 20 sgd steps (``MOE_TRAIN``; adam's fleets are in
  ``tests/test_torch_moe_train.py``)
  on the reference's weights (``convert``)
  against the reference's jitted steps, through
  ``tests/test_torch_lm_train.py``'s ``check_fleet``: ``synced``,
  ``syncs`` and ``checks`` exact, the losses and the plane within
  ``STEP_LOSS_TOL`` / ``PLANE_*_TOL``, Δ between the reference's checked
  distances (``0 < syncs < checks``, none within ``DELTA_MARGIN``·Δ of
  Δ); the dynamic fleets with rematerialized layers too.
* The launchers' MoE runs are in ``tests/test_torch_moe_launch.py``,
  ``tests/test_torch_moe_launch_periodic.py`` (mixtral-8x22b) and
  ``tests/test_torch_moe_launch_deepseek.py`` (deepseek-v2-236b).

This file runs mixtral-8x22b-smoke; ``tests/test_torch_moe_fleet_deepseek.py``
runs the same tests on deepseek-v2-236b-smoke (its ``setup``), a file
each so that the test runner's ``--dist loadfile`` spreads them over two
workers.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.model import lm_loss  # noqa: E402
from test_torch_lm_train import check_fleet, make_setup  # noqa: E402

MOE_ARCHS = ("mixtral-8x22b", "deepseek-v2-236b")
# this file's arch; deepseek-v2-236b's fleets run the same tests in
# tests/test_torch_moe_fleet_deepseek.py
FLEET_ARCHS = MOE_ARCHS[:1]
# the fleets train with the reference's production program's optimizer,
# sgd, under which the port stays within 2.2e-5 of the reference
# (mixtral; deepseek 2.2e-7) on jax 0.9.0 and torch 2.13. Under adam at
# lr 1e-3 the reference drifts from itself with its weights nudged by one
# ulp past STEP_LOSS_TOL: tests/test_torch_moe_train.py holds the adam
# fleets to that drift
MOE_TRAIN = dict(optimizer="sgd", learning_rate=0.1)
# (b, Δ) of the dynamic fleet: Δ between the reference's checked
# distances at b = 2 (with no sync: mixtral 2.98, 5.72, ...; deepseek
# 3.70, 6.41, ...), so the run syncs at every other check
DYNAMIC = {"mixtral-8x22b": (2, 4.5), "deepseek-v2-236b": (2, 5.0)}
PERIODIC_B = 3
# a learner under vmap against its own call: the batched products may sum
# in other orders (0 seen on torch 2.13 on the CPU)
VMAP_TOL = 1e-5


@pytest.fixture(scope="module", params=FLEET_ARCHS)
def setup(request):
    return make_setup(request.param)


def test_vmap_matches_each_learner(setup):
    """One fleet step's gradients (the engine's
    ``vmap(grad_and_value(lm_loss))``) against each learner's own call."""
    _, params_np, fleet, _, arch = setup
    cfg = get_arch(arch, smoke=True)
    params = params_from_numpy(params_np, device="cpu")
    batch = {k: torch.from_numpy(v.copy()) for k, v in fleet[0].items()}
    M = batch["tokens"].shape[0]
    scales = [1.0 + 0.01 * i for i in range(M)]
    stacked = tree_map(lambda x: torch.stack([x * s for s in scales]),
                       params)

    def loss_fn(p, b):
        return lm_loss(cfg, p, b)
    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss_fn))(
        stacked, batch)
    for i in range(M):
        one_g, one_l = torch.func.grad_and_value(loss_fn)(
            tree_map(lambda x: x[i], stacked),
            {k: v[i] for k, v in batch.items()})
        assert float(losses[i]) == float(one_l), i
        for g, w in zip(tree_leaves(grads), tree_leaves(one_g)):
            assert float((g[i] - w).abs().max()) <= \
                VMAP_TOL * float(w.abs().max()), i


@pytest.mark.parametrize("kind", ["dynamic", "periodic"])
def test_moe_fleet_steps_match_reference(kind, setup):
    arch = setup[-1]
    if kind == "dynamic":
        check_fleet(kind, *DYNAMIC[arch], setup, train=MOE_TRAIN)
    else:
        check_fleet(kind, PERIODIC_B, 1.0, setup, train=MOE_TRAIN)


def test_moe_fleet_with_remat_matches_reference(setup):
    """The dynamic fleet with ``lm_loss(remat=True)`` on both sides."""
    check_fleet("dynamic", *DYNAMIC[setup[-1]], setup, remat=True,
                train=MOE_TRAIN)
