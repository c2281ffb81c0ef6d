"""Per-learner optimizer step counts (ROADMAP C3) against the JAX
package, on the CPU.

The reference stacks one optimizer state per learner
(``jax.vmap(opt.init)``), so a crashed learner's step count freezes with
its rows and a restarted learner's starts again at 0; adam's bias
correction then differs per learner. The port's ``OptState.step`` is an
(m,) int32 tensor and adam corrects each row by its own count:

* adam, momentum and rmsprop from unequal per-row counts against the
  reference's vmapped optimizers on numpy fleets (rtol 1e-6 / atol 1e-7,
  the single-step test's tolerance); rows with equal counts give the
  bits of a fleet-wide count;
* adam dynamic under examples/faulty_fleet.py's crash schedule against
  the reference's live flat run: comm counters, ledger, per-round fault
  and active counts and the step counts exact; parameters and losses
  within the fault tests' 1e-5, save the output layer's bias after a
  cold restart (below);
* each package resuming the other's checkpoint taken mid-run, when the
  learners' counts differ, and 8 more rounds matching.

A cold restart zeroes a learner's model: both logits are 0, and the
output bias's gradient is the mean of ``softmax - onehot`` over a batch
with as many of each label, 0 in exact arithmetic. PyTorch sums it to
0.0, XLA to a residual of ±7.45e-9; adam's first step maps a gradient g
to ``lr * g / (|g| + eps)``, so the residual, near eps = 1e-8, moves
those two entries by 0.43 lr in the reference and not at all in the
port. Those entries are held within lr (no adam step exceeds it), the
losses after the restart within 2 lr (a loss moves at most twice as far
as the output bias); every other entry stays within 1e-5 (2.6e-6
here).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint.io as jio  # noqa: E402
from repro.config import FaultConfig as JFaultConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim.optimizers import OptState as JOptState  # noqa: E402
import repro_torch.checkpoint.io as io  # noqa: E402
from repro_torch.config import (  # noqa: E402
    FaultConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.models.cnn import cnn_loss  # noqa: E402
from repro_torch.network import faults  # noqa: E402
from repro_torch.optim.optimizers import OptState, make_optimizer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# examples/faulty_fleet.py:47
CRASHES = dict(fault_seed=11, byzantine_frac=0.2, byzantine_mode="sign_flip",
               crash_prob=0.15, crash_every=16, outage_min=2, outage_max=4)
ADAM = dict(optimizer="adam", learning_rate=1e-3)
DYN = dict(kind="dynamic", b=2, delta=0.05, layout="flat")
M = 8


@pytest.mark.parametrize("opt", ["adam", "momentum", "rmsprop", "sgd"])
def test_unequal_steps_match_the_reference_vmapped_optimizer(opt):
    rng = np.random.default_rng(3)
    m, P = 6, 129
    X0 = rng.standard_normal((m, P), dtype=np.float32)
    mu = rng.standard_normal((m, P), dtype=np.float32) * 0.1
    nu = np.abs(rng.standard_normal((m, P), dtype=np.float32)) * 0.01
    G = rng.standard_normal((m, P), dtype=np.float32)
    steps = np.array([0, 1, 2, 7, 7, 300], np.int32)
    kw = dict(optimizer=opt, learning_rate=0.05, momentum=0.8,
              weight_decay=1e-3)
    jopt = jmake_optimizer(JTrainConfig(**kw))
    jstate = jax.vmap(jopt.init)(jnp.asarray(X0))
    jstate = jstate._replace(
        step=jnp.asarray(steps),
        **{k: jnp.asarray(v) for k, v in (("mu", mu), ("nu", nu))
           if getattr(jstate, k) is not None})
    jX, jnew = jax.vmap(jopt.update)(jnp.asarray(X0), jnp.asarray(G),
                                     jstate)
    topt = make_optimizer(TrainConfig(**kw))
    state = topt.init(torch.from_numpy(X0.copy()))
    assert state.step.dtype == torch.int32 and state.step.shape == (m,)
    state = state._replace(
        step=torch.from_numpy(steps.copy()),
        **{k: torch.from_numpy(v.copy()) for k, v in (("mu", mu),
                                                        ("nu", nu))
           if getattr(state, k) is not None})
    X, new = topt.update(torch.from_numpy(X0.copy()),
                         torch.from_numpy(G.copy()), state)
    np.testing.assert_array_equal(new.step.numpy(), np.asarray(jnew.step))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-6,
                               atol=1e-7)


def test_equal_steps_give_the_fleet_wide_bits():
    """A row's bias correction is its own count's, computed as a lone
    scalar power: equal counts give the bits of one count for the
    fleet (the port's arithmetic before the counts were per learner)."""
    rng = np.random.default_rng(4)
    X0 = rng.standard_normal((16, 33), dtype=np.float32)
    G = rng.standard_normal((16, 33), dtype=np.float32)
    opt = make_optimizer(TrainConfig(**ADAM))
    for t in (0, 1, 9, 123, 4999):
        state = opt.init(torch.from_numpy(X0.copy()))
        state = state._replace(step=torch.full((16,), t, dtype=torch.int32))
        X, _ = opt.update(torch.from_numpy(X0.copy()),
                          torch.from_numpy(G.copy()), state)
        # the fleet-wide formula: one f32 scalar power per call
        f32 = dict(dtype=torch.float32)
        tf = torch.tensor(float(t + 1), **f32)
        bc1 = 1 - torch.tensor(0.9, **f32) ** tf
        bc2 = 1 - torch.tensor(0.999, **f32) ** tf
        g = torch.from_numpy(G)
        mu, nu = 0.1 * g, 0.001 * torch.square(g)
        want = torch.from_numpy(X0.copy()).sub_(
            1e-3 * (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8))
        assert torch.equal(X, want), t


def _batches(rounds):
    streams = JStreams(JGraphical(seed=0, drift_prob=0.0), M, batch=10,
                       seed=0)
    return jax.tree.map(np.asarray, streams.next_chunk(rounds))


def _init():
    cfg = jget_arch("drift_mlp", smoke=True)
    return jax.tree.map(np.asarray, jinit(cfg, jax.random.split(
        jax.random.PRNGKey(0), 3)[0]))


def _port(faults_kw=CRASHES):
    cfg = get_arch("drift_mlp", smoke=True)
    init = _init()
    return DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: params_from_numpy(init, device="cpu"), M,
        ProtocolConfig(**DYN), TrainConfig(**ADAM),
        faults=FaultConfig(**faults_kw), device="cpu")


def _ref(faults_kw=CRASHES):
    cfg = jget_arch("drift_mlp", smoke=True)
    return JLearner(lambda p, b: jcnn_loss(cfg, p, b),
                    lambda k: jinit(cfg, k), M, JProtocolConfig(**DYN),
                    JTrainConfig(**ADAM), faults=JFaultConfig(**faults_kw))


def _chunk(batches, a, b):
    return {k: torch.from_numpy(v[a:b].copy()) for k, v in batches.items()}


def _output_bias(dl) -> np.ndarray:
    """The plane's columns of the output layer's bias."""
    marks = dl.adapter.unravel_model(
        torch.arange(dl.model_size, dtype=torch.float32))
    return marks["layers"][-1]["b"].numpy().astype(np.int64)


def _assert_same_run(dl, ref, metrics=None, rm=None, restarted=False):
    assert dl.comm_totals == {k: int(v) for k, v in ref.comm_totals.items()}
    np.testing.assert_array_equal(dl.per_link_bytes(), ref.per_link_bytes())
    np.testing.assert_array_equal(dl.opt_state.step.numpy(),
                                  np.asarray(ref.opt_state.step))
    want = np.asarray(jfleet_adapter(ref.params).ravel(ref.params))
    got = dl.X.numpy()
    if restarted:       # the cold restart's output bias (module docstring)
        bias = _output_bias(dl)
        np.testing.assert_allclose(got[:, bias], want[:, bias], rtol=0,
                                   atol=ADAM["learning_rate"])
        keep = np.setdiff1d(np.arange(got.shape[1]), bias)
        got, want = got[:, keep], want[:, keep]
    np.testing.assert_allclose(got, want, **TOL)
    if metrics is not None:
        for field in ("num_faulty", "num_active"):
            got = np.concatenate([getattr(x, field) for x in metrics])
            np.testing.assert_array_equal(got, np.asarray(getattr(rm, field)))
        np.testing.assert_array_equal(
            np.concatenate([x.link_counts for x in metrics]),
            np.asarray(rm.link_counts))
        # a loss moves at most twice as far as the output bias: each
        # logit's gradient, softmax - onehot, is within [-1, 1]
        tol = (dict(rtol=0, atol=2 * ADAM["learning_rate"]) if restarted
               else TOL)
        np.testing.assert_allclose(
            np.concatenate([x.loss_per_learner.numpy() for x in metrics]),
            np.asarray(rm.loss_per_learner), **tol)


def test_adam_dynamic_under_crashes_matches_the_reference():
    batches = _batches(32)
    ref, dl = _ref(), _port()
    # rounds 1-24: learner 0 crashes at 12 and restarts at 16
    rm = ref.run_chunk(jax.tree.map(lambda x: x[:24], batches))
    metrics = [dl.run_chunk(_chunk(batches, 0, 24))]
    assert len(set(dl.opt_state.step.numpy().tolist())) > 1
    _assert_same_run(dl, ref, metrics, rm)
    # rounds 25-32: learner 5 restarts cold at 25, learner 1 at 28
    rm = ref.run_chunk(jax.tree.map(lambda x: x[24:], batches))
    metrics = [dl.run_chunk(_chunk(batches, 24, 32))]
    steps = dl.opt_state.step.numpy()
    cfg = FaultConfig(**CRASHES)
    crashed = faults.crash_rounds(cfg, M, range(32))
    restarted = faults.restart_rounds(cfg, M, range(32))
    assert crashed.any() and restarted.any()
    assert len(set(steps.tolist())) > 1        # the counts really differ
    # a learner's count is the rounds it trained since its last restart
    last = np.where(restarted.any(axis=0),
                    31 - np.argmax(restarted[::-1], axis=0), 0)
    want = [int(sum(not crashed[t, i] for t in range(last[i], 32)))
            for i in range(M)]
    assert steps.tolist() == want
    assert dl.comm_totals["syncs"] > 0
    _assert_same_run(dl, ref, metrics, rm, restarted=True)


def test_each_package_resumes_the_others_unequal_steps(tmp_path):
    batches = _batches(24)
    ref, dl = _ref(), _port()
    ref.run_chunk(jax.tree.map(lambda x: x[:16], batches))
    dl.run_chunk(_chunk(batches, 0, 16))
    assert len(set(dl.opt_state.step.numpy().tolist())) > 1
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    io.save_protocol_state(a, dl.params, dl.opt_state, dl.sync_state,
                           protocol=ProtocolConfig(**DYN),
                           counters=dl.counters_state())
    jio.save_protocol_state(b, ref.params, ref.opt_state, ref.sync_state,
                            protocol=JProtocolConfig(**DYN),
                            counters=ref.counters_state())
    np.testing.assert_array_equal(np.load(a + ".opt.npz")["a:.step"],
                                  np.load(b + ".opt.npz")["a:.step"])
    # the port continues the reference's checkpoint
    cont = _port()
    cont.restore_state(*io.load_protocol_state(b, device="cpu"))
    cont.restore_counters(io.load_counters(b))
    # the reference continues the port's, as its callers do: by assigning
    jcont = _ref()
    params, opt, state = jio.load_protocol_state(a)
    jcont.params, jcont.sync_state = params, state
    jcont.opt_state = JOptState(step=jnp.asarray(opt[".step"]),
                                mu=opt[".mu"], nu=opt[".nu"])
    jcont.restore_counters(jio.load_counters(a))
    rest = jax.tree.map(lambda x: x[16:], batches)
    ref.run_chunk(rest)
    dl.run_chunk(_chunk(batches, 16, 24))
    cont.run_chunk(_chunk(batches, 16, 24))
    jcont.run_chunk(rest)
    _assert_same_run(cont, ref)
    _assert_same_run(dl, jcont)
    _assert_same_run(dl, ref)
