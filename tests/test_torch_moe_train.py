"""MoE LM training in the port against the JAX package on the CPU, past
the sgd fleets of ``tests/test_torch_moe_fleet.py``, on mixtral-8x22b-smoke
and deepseek-v2-236b-smoke with the reference's weights (``convert``):

* the dynamic fleet under adam (lr 1e-3, 20 steps): ``synced``,
  ``syncs`` and ``checks`` exact, the plane within ``PLANE_*_TOL``, and
  the losses as close to the reference's as the reference's run is to
  itself with every weight nudged by one ulp (``ulp_drift``). Adam moves
  a weight whose gradient sits at f32's noise level by up to lr a step,
  and the routing's near-ties turn such moves into loss: the reference's
  own one-ulp drift reaches 7.1e-4 relative by step 19 at deepseek's
  (port 2.5e-4) and 3.4e-4 at mixtral's (port 2.2e-6), on jax 0.9.0 and
  torch 2.13, past ``STEP_LOSS_TOL``, which the sgd fleets keep;
* the σ_1 step of the reference's production program
  (``TrainConfig(optimizer="sgd", remat=True)``, whose ``remat`` the loss
  reads, as ``chip_smoke.py``'s MoE cells do) by ``make_train_step``
  against the reference's, 20 steps of the fleet's batches taken whole.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.flatten import fleet_adapter  # noqa: E402
from repro_torch.models.model import lm_loss  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from test_torch_lm_train import (  # noqa: E402
    FLEET_TRAIN, STEP_LOSS_TOL, STEPS, _torch_batch, close_planes,
    make_setup, port_fleet, ref_fleet)
from test_torch_moe_fleet import DYNAMIC, MOE_ARCHS, MOE_TRAIN  # noqa: E402


@pytest.fixture(scope="module", params=MOE_ARCHS)
def setup(request):
    return make_setup(request.param)


def ulp_drift(want, nudged):
    """The largest relative gap of two runs' losses."""
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(nudged) - want) / np.abs(want)))


def test_moe_fleet_under_adam_within_reference_drift(setup):
    jcfg, params_np, fleet, single, arch = setup
    b, delta = DYNAMIC[arch]
    jproto = JProtocolConfig(kind="dynamic", b=b, delta=delta)
    want = ref_fleet("dynamic", jproto, setup, train=FLEET_TRAIN)
    up = jax.tree.map(
        lambda x: np.nextafter(x, np.float32(np.inf)).astype(x.dtype),
        params_np)
    nudged = ref_fleet("dynamic", jproto, (jcfg, up, fleet, single, arch),
                       train=FLEET_TRAIN)
    got = port_fleet("dynamic", ProtocolConfig(kind="dynamic", b=b,
                                               delta=delta),
                     setup, train=FLEET_TRAIN)
    assert got["synced"] == want["synced"]
    assert (got["syncs"], got["checks"]) == (want["syncs"], want["checks"])
    assert 0 < want["syncs"] < want["checks"], want["synced"]
    bound = max(STEP_LOSS_TOL["rtol"], ulp_drift(want["loss"],
                                                 nudged["loss"]))
    assert ulp_drift(want["loss"], got["loss"]) <= bound
    close_planes(got["plane"], want["plane"])


def test_moe_train_step_production_program_matches_reference(setup):
    jcfg, params_np, _, single, arch = setup
    cfg = get_arch(arch, smoke=True)
    production = dict(MOE_TRAIN, remat=True)
    jtrain, train = JTrainConfig(**production), TrainConfig(**production)
    jinit_state, jstep = jmake_train_step(
        lambda p, b: jlm_loss(jcfg, p, b, remat=jtrain.remat), jtrain)
    jstate = jinit_state(jax.tree.map(jnp.asarray, params_np))
    jstep = jax.jit(jstep)
    init_state, step = make_train_step(
        lambda p, b: lm_loss(cfg, p, b, remat=train.remat), train,
        device="cpu")
    state = init_state(params_from_numpy(params_np, device="cpu"))
    want_loss, got_loss = [], []
    for b in single:
        jstate, jm = jstep(jstate, b)
        state, m = step(state, _torch_batch(b))
        want_loss.append(float(jm["loss"]))
        got_loss.append(float(m["loss"]))
    np.testing.assert_allclose(got_loss, want_loss, **STEP_LOSS_TOL)
    assert int(state.step) == int(jstate.step) == STEPS
    want = np.asarray(jfleet_adapter(jstate.params).ravel_model(
        jstate.params))
    got = fleet_adapter(state.params).ravel_model(state.params).numpy()
    close_planes(got, want)
