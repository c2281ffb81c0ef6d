"""The single-model step (``repro_torch.train.step``) against the JAX
package's (``repro.train.step``) on the CPU, and the paper's
Proposition 3.

* ``make_train_step`` with sgd and adam, ``micro_batch`` 1 and 4, three
  steps from the reference's initial model on the reference's batches,
  on the smoke mnist_cnn (14×14 SyntheticMNIST) and the drift MLP: the
  losses and the parameters after each step within rtol 1e-5 / atol
  1e-6, and the step count exact.
* ``micro_batch`` 4 against 1 in the port: the mean of four slices' mean
  gradients is the batch's mean gradient, to f32 rounding (the same
  tolerance).
* The step's gradient, by ``torch.autograd.grad`` on detached leaves, is
  ``torch.func.grad``'s bit for bit, under a caller's ``no_grad`` too,
  with zeros for a leaf the loss does not reach.
* The twin of tests/test_protocol_theory.py::test_proposition3_exact
  (m = 4, B = 8, η = 0.05): one round of m learners under continuous
  averaging (σ_1, lr ηB: the paper's φ^mSGD steps by η times the summed
  gradient) equals one ``make_train_step`` step with batch mB and lr
  (η/m)·mB, within rtol 1e-4 / atol 1e-6, and both equal the reference's
  own averaged and serial models within the same tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.divergence import tree_mean as jtree_mean  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.data.synthetic import SyntheticMNIST as JMNIST  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.models.cnn import cnn_loss  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
PROP3_TOL = dict(rtol=1e-4, atol=1e-6)
B, STEPS = 16, 3
OPTS = {"sgd": dict(optimizer="sgd", learning_rate=0.1),
        "adam": dict(optimizer="adam", learning_rate=1e-3)}


def _source(arch):
    if arch == "mnist_cnn":
        return JMNIST(seed=0, image_size=14)
    return JGraphical(seed=0, drift_prob=0.0)


def _setup(arch):
    """The reference's initial model and STEPS batches of B, as numpy."""
    cfg = jget_arch(arch, smoke=True)
    init = jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(2)))
    src = _source(arch)
    batches = [jax.tree.map(np.asarray, src.sample(
        jax.random.fold_in(jax.random.PRNGKey(1), t), B))
        for t in range(STEPS)]
    return cfg, init, batches


def _port_steps(arch, opt, micro, init, batches):
    cfg = get_arch(arch, smoke=True)
    init_state, step = make_train_step(
        lambda p, b: cnn_loss(cfg, p, b),
        TrainConfig(**OPTS[opt], micro_batch=micro), device="cpu")
    state = init_state(params_from_numpy(init, device="cpu"))
    losses, params = [], []
    for b in batches:
        state, out = step(state, {k: torch.from_numpy(v.copy())
                                  for k, v in b.items()})
        losses.append(float(out["loss"]))
        params.append([x.numpy().copy() for x in tree_leaves(state.params)])
    return state, losses, params


def _ref_steps(arch, opt, micro, init, batches):
    cfg = jget_arch(arch, smoke=True)
    init_state, step = jmake_train_step(
        lambda p, b: jcnn_loss(cfg, p, b),
        JTrainConfig(**OPTS[opt], micro_batch=micro))
    step = jax.jit(step)
    state = init_state(jax.tree.map(jnp.asarray, init))
    losses, params = [], []
    for b in batches:
        state, out = step(state, b)
        losses.append(float(out["loss"]))
        params.append([np.asarray(x) for x in jax.tree.leaves(state.params)])
    return state, losses, params


@pytest.fixture(scope="module", params=["mnist_cnn", "drift_mlp"])
def setup(request):
    return (request.param, *_setup(request.param)[1:])


@pytest.mark.parametrize("micro", [1, 4])
@pytest.mark.parametrize("opt", list(OPTS))
def test_train_step_matches_reference(setup, opt, micro):
    arch, init, batches = setup
    state, losses, params = _port_steps(arch, opt, micro, init, batches)
    jstate, jlosses, jparams = _ref_steps(arch, opt, micro, init, batches)
    np.testing.assert_allclose(losses, jlosses, **TOL)
    for got, want in zip(params, jparams):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
    assert isinstance(state, TrainState)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    assert int(state.step) == int(jstate.step) == STEPS


@pytest.mark.parametrize("opt", list(OPTS))
def test_micro_batch_4_is_micro_batch_1(setup, opt):
    arch, init, batches = setup
    _, l1, p1 = _port_steps(arch, opt, 1, init, batches)
    _, l4, p4 = _port_steps(arch, opt, 4, init, batches)
    np.testing.assert_allclose(l4, l1, **TOL)
    for a, b in zip(p4, p1):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, **TOL)


def test_step_leaves_the_state_passed_in_alone(setup):
    arch, init, batches = setup
    cfg = get_arch(arch, smoke=True)
    init_state, step = make_train_step(
        lambda p, b: cnn_loss(cfg, p, b), TrainConfig(**OPTS["adam"]),
        device="cpu")
    s0 = init_state(params_from_numpy(init, device="cpu"))
    before = [x.clone() for x in tree_leaves(s0)]
    batch = {k: torch.from_numpy(v.copy()) for k, v in batches[0].items()}
    s1, _ = step(s0, batch)
    for x, y in zip(tree_leaves(s0), before):
        assert torch.equal(x, y)
    s1b, _ = step(s0, batch)     # the same step again: the same state
    for x, y in zip(tree_leaves(s1), tree_leaves(s1b)):
        assert torch.equal(x, y)


def test_proposition3_exact():
    """σ_1 over m learners with batch B and lr η equals one serial step
    with batch mB and lr η/m (the paper's φ^mSGD: f − η Σ of per-sample
    gradients, so the mean-loss lr is ηB)."""
    m, Bp, eta = 4, 8, 0.05
    jcfg = jget_arch("mnist_cnn", smoke=True)
    jloss = lambda p, b: jcnn_loss(jcfg, p, b)      # noqa: E731
    src = JMNIST(seed=0, image_size=14)
    key = jax.random.PRNGKey(1)
    jbatches = [src.sample(jax.random.fold_in(key, i), Bp) for i in range(m)]
    params0 = jinit(jcfg, jax.random.PRNGKey(2))

    # the reference's own result (tests/test_protocol_theory.py:29)
    def local_step(p, b):
        g = jax.grad(jloss)(p, b)
        return jax.tree.map(lambda x, gg: x - eta * Bp * gg, p, g)

    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[local_step(params0, b) for b in jbatches])
    javeraged = [np.asarray(x) for x in jax.tree.leaves(jtree_mean(stacked))]
    big = jax.tree.map(lambda *xs: jnp.concatenate(xs), *jbatches)
    g = jax.grad(jloss)(params0, big)
    jserial = [np.asarray(x) for x in jax.tree.leaves(jax.tree.map(
        lambda x, gg: x - (eta / m) * (m * Bp) * gg, params0, g))]
    for a, b in zip(javeraged, jserial):
        np.testing.assert_allclose(a, b, **PROP3_TOL)

    # the port: one σ_1 round of the fleet, one serial step
    cfg = get_arch("mnist_cnn", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)      # noqa: E731
    init = jax.tree.map(np.asarray, params0)
    fleet = DecentralizedLearner(
        loss_fn, lambda gen: params_from_numpy(init, device="cpu"), m,
        ProtocolConfig(kind="continuous", b=1),
        TrainConfig(optimizer="sgd", learning_rate=eta * Bp), device="cpu")
    fleet.step({k: torch.from_numpy(np.stack([np.asarray(b[k])
                                              for b in jbatches]))
                for k in jbatches[0]})
    assert fleet.comm_totals["syncs"] == 1
    assert torch.equal(fleet.X[0], fleet.X[-1])
    averaged = [x.numpy() for x in tree_leaves(fleet.learner_model(0))]
    init_state, step = make_train_step(
        loss_fn, TrainConfig(optimizer="sgd",
                             learning_rate=(eta / m) * (m * Bp)),
        device="cpu")
    state, _ = step(init_state(params_from_numpy(init, device="cpu")),
                    {k: torch.from_numpy(np.asarray(v))
                     for k, v in big.items()})
    serial = [x.numpy() for x in tree_leaves(state.params)]
    for a, s, ja, js in zip(averaged, serial, javeraged, jserial):
        np.testing.assert_allclose(a, s, **PROP3_TOL)
        np.testing.assert_allclose(a, ja, **PROP3_TOL)
        np.testing.assert_allclose(s, js, **PROP3_TOL)


def test_step_gradient_is_torch_func_grads_and_zero_where_unused(setup):
    """The step's gradient (``torch.autograd.grad`` on detached leaves,
    without ``create_graph``) is ``torch.func.grad``'s, bit for bit, also
    when the caller runs under ``torch.no_grad()``; a leaf the loss does
    not reach gets zeros, as under ``torch.func.grad``, so sgd leaves it
    as it was."""
    arch, init, batches = setup
    cfg = get_arch(arch, smoke=True)
    lr = OPTS["sgd"]["learning_rate"]

    def loss_fn(p, b):
        return cnn_loss(cfg, p["model"], b)
    init_state, step = make_train_step(loss_fn, TrainConfig(**OPTS["sgd"]),
                                       device="cpu")
    params = {"model": params_from_numpy(init, device="cpu"),
              "unused": torch.ones(5)}
    s0 = init_state(params)
    batch = {k: torch.from_numpy(v.copy()) for k, v in batches[0].items()}
    want = torch.func.grad(loss_fn)(s0.params, batch)
    with torch.no_grad():
        s1, _ = step(s0, batch)
    for x, g, y in zip(tree_leaves(s0.params), tree_leaves(want),
                       tree_leaves(s1.params)):
        assert torch.equal(y, x - lr * g)
    assert torch.equal(s1.params["unused"], torch.ones(5))
