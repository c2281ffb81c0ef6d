"""The paper's remaining experiments in the port, against the reference:
FedAvg, the random balancing augmentation, heterogeneous initialization,
the serial baseline and concept drift.

As in tests/test_torch_protocol.py, the port starts from the reference's
initial model and trains on the reference's batches, carried across as
numpy, with the same seed: the cohort draws then come from the same
threefry stream (``repro_torch.prng``). Exact: ``comm_totals``,
``link_xfer_totals``, ``per_link_bytes()``, ``comm_bytes()``, the sync
state's key after the run, ``drift_rounds`` and the drifting sources'
concepts. Within rtol 1e-5: cumulative losses; within atol 1e-5: the
final parameters (f32 sums in another order). Heterogeneous initial
planes are held to ``prng.NORMAL_TOL`` times ε·std.
"""
import json
import os
import pathlib
import subprocess
import sys

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
from repro.core.protocol import SerialLearner as JSerial  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.train.loop import run_drift_segments as jrun_drift_segments  # noqa: E402
from repro.train.loop import run_protocol_training as jrun_training  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner, SerialLearner  # noqa: E402
from repro_torch.core.sync import stages  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.pipeline import LearnerStreams  # noqa: E402
from repro_torch.models.cnn import cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    run_drift_segments, run_protocol_training,
)

GOLDEN = pathlib.Path(__file__).with_name("golden_pr2_engine.json")
WEIGHTS = [5, 10, 15, 10, 5, 15]
SGD = dict(optimizer="sgd", learning_rate=0.05)

# name -> (protocol kwargs, model, m, rounds, weighted, learner seed)
CASES = {
    # tests/golden_pr2_capture.py's fedavg_ideal, on the flat plane
    "fedavg_ideal": (dict(kind="fedavg", b=2, fedavg_c=0.5), "drift_mlp",
                     6, 40, False, 0),
    "fedavg_c0.3": (dict(kind="fedavg", b=2, fedavg_c=0.3), "drift_mlp", 6,
                    40, False, 0),
    "fedavg_c1.0": (dict(kind="fedavg", b=3, fedavg_c=1.0), "drift_mlp", 6,
                    40, False, 0),
    # k = round(2.5) = 2: Python's round, half to even
    "fedavg_half_even": (dict(kind="fedavg", b=2, fedavg_c=0.5),
                         "drift_mlp", 5, 40, False, 0),
    "fedavg_weighted_seed3": (dict(kind="fedavg", b=2, fedavg_c=0.5,
                                   weighted=True), "drift_mlp", 6, 40, True,
                              3),
    "dynamic_random": (dict(kind="dynamic", b=2, delta=0.5,
                            augmentation="random"), "drift_mlp", 6, 40,
                       False, 0),
    "dynamic_random_seed5": (dict(kind="dynamic", b=1, delta=0.3,
                                  augmentation="random"), "drift_mlp", 6,
                             40, False, 5),
    "mnist_cnn_smoke_random": (dict(kind="dynamic", b=2, delta=0.01,
                                    augmentation="random"), "mnist_cnn", 4,
                               12, False, 0),
}


def _loss(name, torch_side=True):
    if torch_side:
        cfg = get_arch(name, smoke=True)
        return lambda p, b: cnn_loss(cfg, p, b)
    cfg = jget_arch(name, smoke=True)
    return lambda p, b: jcnn_loss(cfg, p, b)


def _source(name):
    if name == "drift_mlp":
        return jsyn.GraphicalModelStream(seed=0, drift_prob=0.0)
    return jsyn.SyntheticMNIST(
        seed=0, image_size=jget_arch(name, smoke=True).input_shape[0])


def _run_reference(kw, name, m, rounds, weighted, seed, eps=0.0):
    """The reference's flat run; returns it with its homogeneous base
    model, its initial plane and its batches, as numpy."""
    jcfg = jget_arch(name, smoke=True)
    streams = JStreams(_source(name), m, batch=10, seed=0,
                       batch_sizes=WEIGHTS[:m] if weighted else None)
    dl = JLearner(_loss(name, False), lambda k: jinit(jcfg, k), m,
                  JProtocolConfig(layout="flat", **kw), JTrainConfig(**SGD),
                  seed=seed, init_heterogeneity=eps,
                  sample_weights=streams.weights)
    k_init = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
    base = jax.tree.map(np.asarray, jinit(jcfg, k_init))
    plane0 = np.asarray(jfleet_adapter(dl.params).ravel(dl.params))
    batches = jax.tree.map(np.asarray, streams.next_chunk(rounds))
    dl.run_chunk(batches)
    return dl, base, plane0, batches


def _port(kw, name, m, weighted, seed, base, eps=0.0):
    return DecentralizedLearner(
        _loss(name), lambda g: params_from_numpy(base, device="cpu"), m,
        ProtocolConfig(**kw), TrainConfig(**SGD), seed=seed,
        init_heterogeneity=eps,
        sample_weights=(torch.tensor(WEIGHTS[:m], dtype=torch.float32)
                        if weighted else None),
        device="cpu")


def _tensors(batches):
    return {k: torch.from_numpy(v.copy()) for k, v in batches.items()}


def _watch_distances(monkeypatch):
    """Record every distance the port compares with Delta."""
    seen = []
    trig = stages.per_learner_sq_distance_flat
    safe = stages._safe_dist
    monkeypatch.setattr(stages, "per_learner_sq_distance_flat",
                        lambda *a: seen.extend(trig(*a).tolist()) or trig(*a))
    monkeypatch.setattr(stages, "_safe_dist",
                        lambda *a: seen.append(safe(*a)) or safe(*a))
    return seen


def _assert_same_run(dl, ref, seen=(), delta=None):
    if delta is not None:
        assert seen, "a dynamic run checked no distance"
        assert all(abs(d - delta) > 1e-4 * delta for d in seen)
    assert dl.comm_totals == {k: int(v) for k, v in ref.comm_totals.items()}
    np.testing.assert_array_equal(dl.link_xfer_totals, ref.link_xfer_totals)
    np.testing.assert_array_equal(dl.per_link_bytes(), ref.per_link_bytes())
    assert dl.comm_bytes() == ref.comm_bytes()
    assert int(dl.per_link_bytes().sum()) == dl.comm_bytes()
    np.testing.assert_array_equal(dl.sync_state.key.numpy(),
                                  np.asarray(ref.sync_state.rng))
    np.testing.assert_allclose(dl.cumulative_loss, ref.cumulative_loss,
                               rtol=1e-5)
    want = np.asarray(jfleet_adapter(ref.params).ravel(ref.params))
    np.testing.assert_allclose(dl.X.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# FedAvg and the random augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_protocol_matches_reference(case, monkeypatch):
    kw, name, m, rounds, weighted, seed = CASES[case]
    ref, base, plane0, batches = _run_reference(kw, name, m, rounds,
                                                weighted, seed)
    seen = _watch_distances(monkeypatch)
    dl = _port(kw, name, m, weighted, seed, base)
    np.testing.assert_array_equal(dl.X.numpy(), plane0)
    dl.run_chunk(_tensors(batches))
    _assert_same_run(dl, ref, seen, kw.get("delta"))
    syncs = dl.comm_totals["syncs"]
    if kw["kind"] == "fedavg":
        k = max(1, int(round(kw["fedavg_c"] * m)))
        assert syncs == rounds // kw["b"]
        assert dl.comm_totals["model_up"] == syncs * k
        assert dl.comm_totals["full_syncs"] == (syncs if k == m else 0)
    else:
        assert 0 < syncs < rounds // kw["b"]


def test_fedavg_golden_case():
    """``fedavg_ideal`` of tests/golden_pr2_engine.json. Its comm totals
    are exact. Its per-link totals and loss were captured under jax
    0.4.37 (``_meta``), whose threefry was not yet partitionable; the live
    reference reproduces them with ``jax.threefry_partitionable(False)``,
    and under this container's default (on) it draws other cohorts, which
    the port matches (test above)."""
    golden = json.loads(GOLDEN.read_text())["fedavg_ideal"]
    kw, name, m, rounds, weighted, seed = CASES["fedavg_ideal"]
    ref, base, _, batches = _run_reference(kw, name, m, rounds, weighted,
                                           seed)
    dl = _port(kw, name, m, weighted, seed, base)
    dl.run_chunk(_tensors(batches))
    assert dl.comm_totals == golden["comm_totals"]
    assert dl.comm_bytes() == dl.comm_bytes_of(golden["comm_totals"])
    with jax.threefry_partitionable(False):
        old, _, _, _ = _run_reference(kw, name, m, rounds, weighted, seed)
    assert old.link_xfer_totals.tolist() == golden["link_xfer_totals"]
    np.testing.assert_allclose(old.cumulative_loss,
                               float(golden["cumulative_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(dl.link_xfer_totals, ref.link_xfer_totals)
    assert int(dl.link_xfer_totals.sum()) == sum(golden["link_xfer_totals"])


def test_fedavg_cohorts_are_the_reference_permutations():
    """Round by round, the subset is the first k of ``permutation(sub,
    m)`` for the key the reference carries."""
    m, k = 10, 3
    dl = DecentralizedLearner(
        _loss("drift_mlp"), lambda g: init_cnn_params(
            get_arch("drift_mlp"), g), m,
        ProtocolConfig(kind="fedavg", b=1, fedavg_c=0.3), device="cpu")
    key = jax.random.PRNGKey(0)
    for _ in range(5):
        key, sub = jax.random.split(key)
        want = np.zeros(m, bool)
        want[np.asarray(jax.random.permutation(sub, m))[:k]] = True
        before = dl.link_xfer_totals.copy()
        dl.step({"x": torch.zeros((m, 2, 50)),
                 "y": torch.zeros((m, 2), dtype=torch.int64)})
        np.testing.assert_array_equal((dl.link_xfer_totals - before) > 0,
                                      want)
    np.testing.assert_array_equal(dl.sync_state.key.numpy(),
                                  np.asarray(key))


# ---------------------------------------------------------------------------
# heterogeneous initialization (Fig. 6.2)
# ---------------------------------------------------------------------------

def test_leaf_order_is_the_reference_flatten_order():
    for name in ("mnist_cnn", "deepdrive_cnn", "drift_mlp"):
        jp = jinit(jget_arch(name, smoke=True), jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("eps", [1.0, 10.0])
def test_init_heterogeneity_matches_reference(eps, monkeypatch):
    kw = dict(kind="dynamic", b=2, delta=0.5)
    ref, base, plane0, batches = _run_reference(kw, "drift_mlp", 6, 30,
                                                False, 4, eps=eps)
    seen = _watch_distances(monkeypatch)
    dl = _port(kw, "drift_mlp", 6, False, 4, base, eps=eps)
    got = dl.X.numpy()
    o = 0
    for leaf in tree_leaves(params_from_numpy(base, device="cpu")):
        x = leaf.numpy().reshape(-1)
        n = x.size
        scale = eps * (float(np.std(x)) + 1e-12)
        want = plane0[:, o:o + n]
        z = np.abs(want - x) / scale
        err = np.abs(got[:, o:o + n] - want)
        bound = (scale * prng.NORMAL_TOL * np.maximum(1.0, z)
                 + 4 * np.finfo(np.float32).eps * np.abs(want))
        assert (err <= bound).all(), float((err / bound).max())
        assert z.std() > 0.5            # the learners really differ
        o += n
    assert o == got.shape[1]
    # the sync state's reference row is the homogeneous base model
    np.testing.assert_array_equal(dl.sync_state.ref.numpy(),
                                  dl.adapter.ravel_model(params_from_numpy(
                                      base, device="cpu")).numpy())
    dl.run_chunk(_tensors(batches))
    # the initial planes differ in the last bits, so the parameters agree
    # to the initial difference carried through 30 rounds
    assert dl.comm_totals == {k: int(v) for k, v in ref.comm_totals.items()}
    assert all(abs(d - 0.5) > 1e-4 * 0.5 for d in seen)
    np.testing.assert_array_equal(dl.per_link_bytes(), ref.per_link_bytes())
    np.testing.assert_array_equal(dl.sync_state.key.numpy(),
                                  np.asarray(ref.sync_state.rng))
    assert dl.comm_totals["syncs"] > 0


def test_heterogeneous_init_draws_per_learner_keys_in_one_batch():
    """The batched draw over all m keys equals a direct draw for one
    learner: learner 2's leaf 1 is the base leaf plus
    ``normal(fold_in(split(k_noise, m)[2], 1)) * eps * (std + 1e-12)``."""
    cfg = get_arch("drift_mlp")
    init = lambda g: init_cnn_params(cfg, g)  # noqa: E731
    dl = DecentralizedLearner(_loss("drift_mlp"), init, 3,
                              ProtocolConfig(kind="nosync"), seed=9,
                              init_heterogeneity=2.0, device="cpu")
    base = init(torch.Generator().manual_seed(9))
    k_noise = prng.split(prng.key(9, device="cpu"), 3, device="cpu")[1]
    key2 = prng.split(k_noise, 3, device="cpu")[2]
    x = tree_leaves(base)[1]
    z = prng.normal(prng.fold_in(key2, 1, device="cpu"), x.shape,
                    device="cpu")
    want = x + z * (2.0 * (x.std(correction=0) + 1e-12))
    got = dl.adapter.unravel(dl.X)
    torch.testing.assert_close(tree_leaves(got)[1][2], want, rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# the serial baseline
# ---------------------------------------------------------------------------

def _serial_inputs(rounds=30, seed=2):
    jcfg = jget_arch("drift_mlp")
    init = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(seed)))
    streams = JStreams(jsyn.GraphicalModelStream(seed=0, drift_prob=0.0), 1,
                       batch=10, seed=1)
    batches = {k: np.asarray(v)[:, 0]
               for k, v in streams.next_chunk(rounds).items()}
    return jcfg, init, batches


def test_serial_learner_matches_reference():
    jcfg, init, batches = _serial_inputs()
    ref = JSerial(lambda p, b: jcnn_loss(jcfg, p, b),
                  lambda k: jinit(jcfg, k), JTrainConfig(**SGD), seed=2)
    want_losses = np.asarray(ref.run_chunk(batches))
    cfg = get_arch("drift_mlp")
    dl = SerialLearner(lambda p, b: cnn_loss(cfg, p, b),
                       lambda g: params_from_numpy(init, device="cpu"),
                       TrainConfig(**SGD), device="cpu")
    losses = dl.run_chunk(_tensors(batches))
    assert tuple(losses.shape) == (30,)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-5)
    np.testing.assert_allclose(dl.cumulative_loss, ref.cumulative_loss,
                               rtol=1e-5)
    for a, b in zip(tree_leaves(dl.params), jax.tree.leaves(ref.params),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_serial_step_loop_equals_run_chunk():
    _, init, batches = _serial_inputs(rounds=12)
    cfg = get_arch("drift_mlp")
    out = []
    for chunked in (True, False):
        dl = SerialLearner(lambda p, b: cnn_loss(cfg, p, b),
                           lambda g: params_from_numpy(init, device="cpu"),
                           TrainConfig(optimizer="momentum",
                                       learning_rate=0.05), device="cpu")
        tb = _tensors(batches)
        if chunked:
            losses = dl.run_chunk(tb)
        else:
            losses = torch.stack([dl.step({k: v[i] for k, v in tb.items()})
                                  for i in range(12)])
        out.append((dl, losses))
    (a, la), (b, lb) = out
    assert torch.equal(la, lb)
    assert torch.equal(a.x, b.x)
    assert a.cumulative_loss == pytest.approx(b.cumulative_loss, rel=1e-12)


# ---------------------------------------------------------------------------
# the drifting sources and the drift loop
# ---------------------------------------------------------------------------

def test_graphical_model_concepts_equal_reference_bitwise():
    want = jsyn.GraphicalModelStream(seed=3, drift_prob=0.3)
    got = synthetic.GraphicalModelStream(seed=3, drift_prob=0.3,
                                         device="cpu")

    def same():
        for a, b in ((got.W, want.W), (got.w, want.w)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    same()
    got.force_drift(), want.force_drift()
    same()
    decisions = [(got.maybe_drift(), want.maybe_drift()) for _ in range(40)]
    assert all(a == b for a, b in decisions)
    assert 0 < sum(a for a, _ in decisions) < 40
    assert got.drift_count == want.drift_count
    same()


def test_deepdrive_concepts_equal_reference_and_frames_are_roads():
    want = jsyn.DeepDriveStream(seed=4)
    got = synthetic.DeepDriveStream(seed=4, device="cpu")
    assert got.curvature_scale == want.curvature_scale == 1.0
    for _ in range(3):
        got.force_drift(), want.force_drift()
        assert got.curvature_scale == want.curvature_scale != 1.0
    small = synthetic.DeepDriveStream(seed=0, height=20, width=40,
                                      device="cpu")
    b = small.sample(torch.Generator().manual_seed(0), 6, lead=(2, 3))
    assert b["x"].shape == (2, 3, 6, 20, 40, 3) and b["y"].shape == (2, 3, 6)
    assert b["x"].dtype == b["y"].dtype == torch.float32
    # the channels are one road frame scaled 1 : 0.8 : 0.6
    torch.testing.assert_close(b["x"][..., 1], 0.8 * b["x"][..., 0])
    torch.testing.assert_close(b["x"][..., 2], 0.6 * b["x"][..., 0])
    # the road is brightest near its centre in the nearest row
    assert float(b["x"][..., -1, :, 0].max()) > 0.8


def test_graphical_model_samples_are_labelled_by_the_concept():
    src = synthetic.GraphicalModelStream(seed=0, device="cpu")
    b = src.sample(torch.Generator().manual_seed(0), 2000)
    assert b["x"].shape == (2000, 50) and b["y"].dtype == torch.int64
    # y = [w . h > 0] with x = W h + 0.1 noise: least squares recovers h
    h = torch.linalg.lstsq(src.W, b["x"].T).solution.T
    agree = ((h @ src.w > 0).long() == b["y"]).float().mean()
    assert float(agree) > 0.95


def test_next_chunk_on_round_runs_before_each_round():
    src = synthetic.GraphicalModelStream(seed=0, device="cpu")
    streams = LearnerStreams(src, 3, batch=4, seed=0)
    calls = []
    chunk = streams.next_chunk(5, on_round=calls.append)
    assert calls == [0, 1, 2, 3, 4]
    assert chunk["x"].shape == (5, 3, 4, 50)
    weighted = LearnerStreams(src, 3, batch=4, seed=0, batch_sizes=[2, 4, 3])
    c = weighted.next_chunk(2, on_round=lambda i: None)
    assert c["x"].shape == (2, 3, 4, 50)
    torch.testing.assert_close(c["x"][:, 0, 2:], c["x"][:, 0, :2])


def test_drift_rounds_match_reference():
    """``run_protocol_training(drift=True)`` offers a drift before every
    round in the reference's order: the same drift rounds, and the same
    final concept."""
    jcfg, cfg = jget_arch("drift_mlp"), get_arch("drift_mlp")
    want_src = jsyn.GraphicalModelStream(seed=1, drift_prob=0.05)
    _, want = jrun_training(
        lambda p, b: jcnn_loss(jcfg, p, b), lambda k: jinit(jcfg, k),
        want_src, m=2, rounds=90, protocol=JProtocolConfig(kind="periodic",
                                                           b=5),
        batch=4, drift=True, chunk_size=40, record_every=30)
    src = synthetic.GraphicalModelStream(seed=1, drift_prob=0.05,
                                         device="cpu")
    dl, traj = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        src, m=2, rounds=90, protocol=ProtocolConfig(kind="periodic", b=5),
        batch=4, drift=True, chunk_size=40, record_every=30, device="cpu")
    assert traj.drift_rounds == want.drift_rounds
    assert len(traj.drift_rounds) >= 2
    assert src.drift_count == want_src.drift_count == len(traj.drift_rounds)
    np.testing.assert_array_equal(src.W.numpy(), np.asarray(want_src.W))
    assert traj.rounds == want.rounds == [30, 60, 90]
    assert traj.syncs == want.syncs
    assert traj.as_dict()["drift_rounds"] == traj.drift_rounds
    assert np.isfinite(dl.cumulative_loss)
    # drift=False never asks the source
    src2 = synthetic.GraphicalModelStream(seed=1, drift_prob=1.0,
                                          device="cpu")
    _, traj2 = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        src2, m=2, rounds=10, protocol=ProtocolConfig(kind="nosync"),
        batch=4, device="cpu")
    assert traj2.drift_rounds == [] and src2.drift_count == 0


class _Recorder:
    """The reference's streams, keeping each chunk as numpy."""

    def __init__(self, streams):
        self.streams, self.chunks = streams, []

    def next_chunk(self, n, on_round=None):
        chunk = self.streams.next_chunk(n, on_round)
        self.chunks.append(jax.tree.map(np.asarray, chunk))
        return chunk


class _Replay:
    """Hands the port the recorded chunks in order."""

    def __init__(self, chunks):
        self.chunks = list(chunks)

    def next_chunk(self, n, on_round=None):
        chunk = self.chunks.pop(0)
        assert chunk["y"].shape[0] == n
        return _tensors(chunk)


def test_run_drift_segments_matches_reference():
    kw, rounds, drifts = dict(kind="dynamic", b=2, delta=0.3), 45, {15, 30}
    jcfg, cfg = jget_arch("drift_mlp"), get_arch("drift_mlp")
    want_src = jsyn.GraphicalModelStream(seed=1, drift_prob=0.0)
    rec = _Recorder(JStreams(want_src, 4, batch=10, seed=0))
    ref = JLearner(lambda p, b: jcnn_loss(jcfg, p, b),
                   lambda k: jinit(jcfg, k), 4,
                   JProtocolConfig(layout="flat", **kw), JTrainConfig(**SGD))
    init = jax.tree.map(np.asarray, ref.learner_model(0))
    want_sync, want_loss = jrun_drift_segments(ref, rec, want_src, rounds,
                                               drifts)
    assert [c["y"].shape[0] for c in rec.chunks] == [15, 15, 15]

    src = synthetic.GraphicalModelStream(seed=1, drift_prob=0.0,
                                         device="cpu")
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: params_from_numpy(init, device="cpu"), 4,
        ProtocolConfig(**kw), TrainConfig(**SGD), device="cpu")
    sync, loss = run_drift_segments(dl, _Replay(rec.chunks), src, rounds,
                                    drifts)
    assert sync.dtype == want_sync.dtype and sync.shape == (rounds,)
    np.testing.assert_array_equal(sync, want_sync)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert src.drift_count == 2
    np.testing.assert_array_equal(src.W.numpy(), np.asarray(want_src.W))
    _assert_same_run(dl, ref)


@pytest.mark.parametrize("bad", [[0], [30], [31], [-1, 10]])
def test_run_drift_segments_rejects_drifts_outside_the_run(bad):
    cfg = get_arch("drift_mlp")
    src = synthetic.GraphicalModelStream(seed=1, device="cpu")
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        2, ProtocolConfig(kind="nosync"), device="cpu")
    with pytest.raises(ValueError, match=r"strictly inside \(0, 30\)"):
        run_drift_segments(dl, LearnerStreams(src, 2), src, 30, bad)
    assert dl.rounds == 0 and src.drift_count == 0


@pytest.mark.slow
def test_torch_quickstart_runs_on_the_cpu():
    """examples/torch_quickstart.py at a reduced size: dynamic averaging
    communicates less than periodic."""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "examples" / "torch_quickstart.py"),
         "--device", "cpu", "--m", "4", "--rounds", "60"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    comm = {}
    for line in out.stdout.splitlines():
        if "comm=" in line:
            name = line.split()[0]
            comm[name] = float(line.split("comm=")[1].split("MB")[0])
    assert set(comm) == {"periodic", "dynamic"}
    assert comm["dynamic"] < comm["periodic"]
