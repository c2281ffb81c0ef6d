"""The slice as a whole: the port's ``DecentralizedLearner`` on the flat
plane against the reference's, run live on the reference's own inputs.

The cases are the ideal-network golden cases of tests/golden_pr2_capture.py
(drift MLP, m = 6, 40 rounds, sgd lr 0.05) plus continuous averaging, all
with ``layout="flat"``, and one dynamic run of the reduced MNIST CNN. The
port starts from the reference's initial model (``learner_model(0)``
before the first chunk) and trains on the reference's batches
(``LearnerStreams.next_chunk``), carried across as numpy.

Exact: ``comm_totals``, ``link_xfer_totals``, ``per_link_bytes()`` and
``comm_bytes()`` — first checking that no distance the port compared with
Delta lies within 1e-4·Delta of it, so a mismatch cannot be a float tie.
Within rtol 1e-5: ``cumulative_loss``; within atol 1e-5: the final
parameters (f32 sums in another order over 40 rounds).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream  # noqa: E402
from repro.data.synthetic import SyntheticMNIST as JSyntheticMNIST  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.core.sync import stages  # noqa: E402
from repro_torch.data.synthetic import SyntheticMNIST  # noqa: E402
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.train.loop import run_protocol_training  # noqa: E402

WEIGHTS = [5, 10, 15, 10, 5, 15]

# name -> (protocol kwargs, model, smoke, m, rounds, weighted, data seed).
# continuous_ideal is not a golden case and draws its batches with seed 1:
# with seed 0 a hidden pre-activation at round 3 lies 1.7e-8 from the
# ReLU kink, the two packages' f32 sums put it on opposite sides, and the
# one-sample gradient difference (8e-5, growing to 4e-4 by round 40) then
# measures that float tie, not the protocol.
CASES = {
    "periodic_ideal": (dict(kind="periodic", b=3), "drift_mlp", True, 6, 40,
                       False, 0),
    "dynamic_ideal": (dict(kind="dynamic", b=2, delta=0.5), "drift_mlp",
                      True, 6, 40, False, 0),
    "dynamic_weighted_ideal": (dict(kind="dynamic", b=2, delta=0.5,
                                    weighted=True), "drift_mlp", True, 6, 40,
                               True, 0),
    "nosync_ideal": (dict(kind="nosync"), "drift_mlp", True, 6, 40, False,
                     0),
    "continuous_ideal": (dict(kind="continuous", b=1), "drift_mlp", True, 6,
                         40, False, 1),
    "mnist_cnn_smoke_dynamic": (dict(kind="dynamic", b=2, delta=0.01),
                                "mnist_cnn", True, 4, 12, False, 0),
}


def _run_reference(kw, name, smoke, m, rounds, weighted, seed):
    cfg = jget_arch(name, smoke=smoke)
    if name == "drift_mlp":
        src = GraphicalModelStream(seed=0, drift_prob=0.0)
    else:
        src = JSyntheticMNIST(seed=0, image_size=cfg.input_shape[0])
    streams = JStreams(src, m, batch=10, seed=seed,
                       batch_sizes=WEIGHTS if weighted else None)
    dl = JLearner(lambda p, b: jcnn_loss(cfg, p, b),
                  lambda k: jinit(cfg, k), m,
                  JProtocolConfig(layout="flat", **kw),
                  JTrainConfig(optimizer="sgd", learning_rate=0.05),
                  sample_weights=streams.weights)
    init = jax.tree.map(np.asarray, dl.learner_model(0))
    batches = jax.tree.map(np.asarray, streams.next_chunk(rounds))
    dl.run_chunk(batches)
    return dl, init, batches


@pytest.mark.parametrize("case", list(CASES))
def test_slice_matches_reference(case, monkeypatch):
    kw, name, smoke, m, rounds, weighted, seed = CASES[case]
    ref, init, batches = _run_reference(kw, name, smoke, m, rounds, weighted,
                                        seed)

    seen = []
    trig = stages.per_learner_sq_distance_flat
    safe = stages._safe_dist
    monkeypatch.setattr(stages, "per_learner_sq_distance_flat",
                        lambda *a: seen.extend(trig(*a).tolist()) or trig(*a))
    monkeypatch.setattr(stages, "_safe_dist",
                        lambda *a: seen.append(safe(*a)) or safe(*a))

    cfg = get_arch(name, smoke=smoke)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: params_from_numpy(init, device="cpu"), m,
        ProtocolConfig(**kw),
        TrainConfig(optimizer="sgd", learning_rate=0.05),
        sample_weights=(torch.tensor(WEIGHTS, dtype=torch.float32)
                        if weighted else None),
        device="cpu")
    dl.run_chunk({k: torch.from_numpy(v.copy()) for k, v in batches.items()})

    delta = kw.get("delta")
    if delta is not None:
        assert seen, "a dynamic run checked no distance"
        assert all(abs(d - delta) > 1e-4 * delta for d in seen)
    assert dl.comm_totals == {k: int(v) for k, v in ref.comm_totals.items()}
    np.testing.assert_array_equal(dl.link_xfer_totals, ref.link_xfer_totals)
    np.testing.assert_array_equal(dl.per_link_bytes(), ref.per_link_bytes())
    assert dl.comm_bytes() == ref.comm_bytes()
    assert int(dl.per_link_bytes().sum()) == dl.comm_bytes()
    np.testing.assert_allclose(dl.cumulative_loss, ref.cumulative_loss,
                               rtol=1e-5)
    want = np.asarray(jfleet_adapter(ref.params).ravel(ref.params))
    np.testing.assert_allclose(dl.X.numpy(), want, rtol=0, atol=1e-5)
    assert dl.rounds == rounds
    # each case syncs as its protocol should
    syncs, b = dl.comm_totals["syncs"], kw.get("b")
    if kw["kind"] == "dynamic":
        assert 0 < syncs < rounds // b
    else:
        assert syncs == {"nosync": 0, "periodic": rounds // (b or 1),
                         "continuous": rounds}[kw["kind"]]


def test_step_loop_equals_run_chunk():
    """n calls of ``step`` make the decisions of one ``run_chunk`` over the
    same batches, with the same per-round metrics."""
    _, init, batches = _run_reference(*CASES["dynamic_ideal"])
    cfg = get_arch("drift_mlp")
    out = []
    for chunked in (True, False):
        dl = DecentralizedLearner(
            lambda p, b: cnn_loss(cfg, p, b),
            lambda g: params_from_numpy(init, device="cpu"), 6,
            ProtocolConfig(kind="dynamic", b=2, delta=0.5),
            TrainConfig(optimizer="sgd", learning_rate=0.05), device="cpu")
        tb = {k: torch.from_numpy(v.copy()) for k, v in batches.items()}
        if chunked:
            syncs = list(dl.run_chunk(tb).comm.syncs)
        else:
            syncs = [dl.step({k: v[i] for k, v in tb.items()}).comm.syncs
                     for i in range(40)]
        out.append((dl, syncs))
    (a, sa), (b, sb) = out
    assert sa == sb and sum(sa) > 0
    assert a.comm_totals == b.comm_totals
    np.testing.assert_array_equal(a.per_link_bytes(), b.per_link_bytes())
    assert torch.equal(a.X, b.X)
    np.testing.assert_allclose(a.cumulative_loss, b.cumulative_loss,
                               rtol=1e-6)


def test_synthetic_mnist_templates_equal_reference_bitwise():
    for seed, size in ((0, 28), (3, 14)):
        got = SyntheticMNIST(seed=seed, image_size=size, device="cpu")
        want = JSyntheticMNIST(seed=seed, image_size=size)
        assert got.templates.dtype == want.templates.dtype
        np.testing.assert_array_equal(got.templates, want.templates)


def test_synthetic_mnist_samples_follow_the_templates():
    """Without noise, a sample is its class template rolled by at most 2
    pixels along each axis."""
    src = SyntheticMNIST(seed=0, image_size=14, noise=0.0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    b = src.sample(gen, 64, lead=(2,))
    assert b["x"].shape == (2, 64, 14, 14, 1) and b["y"].shape == (2, 64)
    temps = src.templates
    for x, y in zip(b["x"].reshape(-1, 14, 14).numpy(),
                    b["y"].reshape(-1).numpy()):
        rolls = [np.roll(temps[y], (i, j), axis=(0, 1)).astype(np.float32)
                 for i in range(-2, 3) for j in range(-2, 3)]
        assert any(np.array_equal(x, r) for r in rolls)


def test_run_protocol_training_end_to_end_on_cpu():
    """The entry point a user calls, on the CPU at a small size: dynamic
    averaging communicates less than periodic, the ledger sums to the
    scalar bill, and the trajectory ends at the learner's counters."""
    cfg = get_arch("mnist_cnn", smoke=True)
    src = SyntheticMNIST(seed=0, image_size=14, device="cpu")
    out = {}
    for kind, kw in (("periodic", dict(b=5)),
                     ("dynamic", dict(b=5, delta=0.7))):
        dl, traj = run_protocol_training(
            lambda p, b: cnn_loss(cfg, p, b),
            lambda g: init_cnn_params(cfg, g), src, m=4, rounds=30,
            protocol=ProtocolConfig(kind=kind, **kw),
            train=TrainConfig(learning_rate=0.1), batch=8, chunk_size=12,
            record_every=10, device="cpu")
        assert traj.rounds == [10, 20, 30]
        assert traj.cumulative_bytes[-1] == dl.comm_bytes()
        assert traj.syncs[-1] == dl.comm_totals["syncs"]
        np.testing.assert_allclose(traj.cumulative_loss[-1],
                                   dl.cumulative_loss, rtol=1e-6)
        assert int(dl.per_link_bytes().sum()) == dl.comm_bytes()
        acc = cnn_accuracy(cfg, dl.mean_model(),
                           src.sample(torch.Generator().manual_seed(9), 64))
        assert 0.0 <= float(acc) <= 1.0
        out[kind] = dl.comm_bytes()
    assert out["periodic"] == 6 * 2 * 4 * dl.model_bytes
    assert out["dynamic"] < out["periodic"]


def test_learner_model_is_a_copy_and_mean_model_averages():
    cfg = get_arch("drift_mlp")
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: init_cnn_params(cfg, g), 3,
        ProtocolConfig(kind="nosync"), device="cpu")
    one = dl.learner_model(1)
    dl.X.add_(1.0)
    assert not torch.equal(one["layers"][1]["w"],
                           dl.learner_model(1)["layers"][1]["w"])
    dl.X[0].add_(3.0)
    mean = dl.mean_model()
    np.testing.assert_allclose(
        mean["layers"][1]["b"].numpy(),
        dl.params["layers"][1]["b"].mean(dim=0).numpy(), rtol=1e-6)
