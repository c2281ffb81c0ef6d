"""The fault plane, robust sync, the event-driven timeline and aircomp on
a fleet split over ranks (``layout="sharded"``, ROADMAP A26), against
the JAX package's flat runs on the CPU.

The fixture is tests/test_torch_shard.py's: the smoke drift MLP, m = 8,
B = 10, from the reference's initial model and batches (32 rounds). Each
world (2 and 4 ranks, spawned by ``shard.launch`` over gloo, workers in
tests/torch_shard_worker.py) runs every case in one launch:

1. ``FaultConfig()`` against ``faults=None`` (the twin of
   tests/test_faults.py::test_inert_faultconfig_sharded_bitwise):
   periodic, dynamic, robust_periodic and robust_dynamic in
   ``NetworkConfig(link_classes=("wired",), act_prob=0.8, seed=3)``,
   bit for bit.
2. dynamic and robust_dynamic under examples/faulty_fleet.py's schedule
   (``FAULTS``), robust_periodic under tests/test_faults.py's ``HEAVY``:
   comm, the ledger and every round's ``num_faulty``, ``num_active``,
   quarantine, recovery, in-flight and link counts exact; the finite
   entries of the plane and the losses within the reference's shard
   tolerance (tests/test_shard.py:79, rtol 2e-4 / atol 1e-6: the cohort
   means add the ranks' partial sums in rank order); NaN and Inf one
   class (a poisoned row's next step depends on each framework's
   autodiff).
3. benchmarks/async_bench.py's presets (periodic and dynamic in its three
   delay regimes over lte/edge links) and its aircomp run: comm, ledger
   and every round's in-flight and link counts exact, ``network_time``
   within rtol 1e-6, planes within the shard tolerance.
4. (world 2) adam under crashes: every learner's optimizer step count
   and the integers exact against the reference; the plane within the
   shard tolerance of the port's own flat run (the port's flat adam run
   against the reference after a cold restart is
   tests/test_torch_optim_steps.py's, within lr on the output bias).
5. A split async dynamic run under crashes, streamed, checkpointed by
   rank 0 after 16 rounds and continued 8: the flat engine resumes the
   checkpoint and its 8 rounds are the flat run's continuation, and the
   reference's resume is the reference's own continuation (integers
   exact, planes within the shard tolerance); the split run's own 8
   rounds keep the flat run's integers, and its stream's round records
   are the flat run's (integers exact, floats within the shard
   tolerance). Its plane is not held to the shard tolerance: learner 0
   restarts cold at round 15, and a zeroed model's pre-activations sit
   on the ReLU kink, where the rank-ordered mean's last-bit difference
   moves an entry by 3.8e-6 within three rounds (the reassociation trap
   that README's split-fleet contract describes).

Every rank holds the same counters, series and plane.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import torch_shard_worker as worker  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.config import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.config import FaultConfig as JFaultConfig  # noqa: E402
from repro.config import NetworkConfig as JNetworkConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.optim.optimizers import OptState as JOptState  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.config import FaultConfig, TelemetryConfig  # noqa: E402
from repro_torch.core import shard  # noqa: E402
from repro_torch.network import faults  # noqa: E402

TOL = dict(rtol=2e-4, atol=1e-6)
M, ROUNDS = 8, 32
CHUNKS = [16, 16]
# examples/faulty_fleet.py:47: 20% sign-flippers, 2-4 round crashes
FAULTS = dict(fault_seed=11, byzantine_frac=0.2, byzantine_mode="sign_flip",
              crash_prob=0.15, crash_every=16, outage_min=2, outage_max=4)
# tests/test_faults.py:112: crashes, NaN/Inf corruption, adversaries, bursts
HEAVY = dict(fault_seed=7, crash_prob=0.3, byzantine_frac=0.25,
             corrupt_prob=0.05, straggler_prob=0.3)
# tests/test_faults.py:221's network and its BASE_SPECS
INERT_NET = dict(link_classes=("wired",), act_prob=0.8, seed=3)
INERT = {
    "periodic": dict(kind="periodic", b=2),
    "dynamic": dict(kind="dynamic", b=1, delta=0.05),
    "robust_periodic": dict(kind="robust_periodic", b=2),
    "robust_dynamic": dict(kind="robust_dynamic", b=1, delta=0.05),
}
DYN = dict(kind="dynamic", b=2, delta=0.5)
FAULT_RUNS = {
    "dynamic": (DYN, FAULTS),
    "robust_dynamic": (dict(kind="robust_dynamic", b=2, delta=0.5), FAULTS),
    "robust_periodic": (dict(kind="robust_periodic", b=3), HEAVY),
}
# benchmarks/async_bench.py:46-63 and its aircomp run (:144)
LTE_EDGE = dict(link_classes=("lte", "edge"))
PAYLOAD = 100_000
ASYNC_RUNS = {
    f"{regime}_{name}": (proto, dict(round_budget=budget,
                                     payload_bytes=PAYLOAD))
    for regime, budget in (("sync", 60.0), ("mild", 1.0), ("harsh", 0.25))
    for name, proto in (("periodic", dict(kind="periodic", b=2)),
                        ("dynamic", DYN))}
ASYNC_RUNS["aircomp"] = (dict(kind="periodic", b=2),
                         dict(round_budget=60.0, aircomp=True, snr_db=20.0))
ADAM = dict(optimizer="adam", learning_rate=1e-3)
ADAM_PROTO = dict(kind="dynamic", b=2, delta=0.05)
CKPT = dict(proto=DYN, net=LTE_EDGE, faults=FAULTS,
            async_=dict(round_budget=1.0, payload_bytes=PAYLOAD),
            at=16, more=8)
# the reference's ProtocolMetrics series (``checked`` is the port's own)
REF_SERIES = ("num_faulty", "num_active", "num_quarantined",
              "num_recovered", "num_inflight", "max_age", "link_counts")


def _split(proto):
    return dict(proto, layout="sharded")


@pytest.fixture(scope="module")
def data():
    cfg = jget_arch("drift_mlp", smoke=True)
    init = jax.tree.map(np.asarray, jinit(
        cfg, jax.random.split(jax.random.PRNGKey(0), 3)[0]))
    streams = JStreams(JGraphical(seed=0, drift_prob=0.0), M, batch=10,
                       seed=0)
    return init, jax.tree.map(np.asarray, streams.next_chunk(ROUNDS))


def _cases(world):
    cases = {}
    for name, proto in INERT.items():
        cases[f"inert_{name}"] = {"kind": "inert", "proto": _split(proto),
                                  "net": INERT_NET, "chunks": [8]}
    for name, (proto, fk) in FAULT_RUNS.items():
        cases[f"faults_{name}"] = {"kind": "planes", "proto": _split(proto),
                                   "net": None, "faults": fk,
                                   "chunks": CHUNKS}
    for name, (proto, ak) in ASYNC_RUNS.items():
        cases[f"async_{name}"] = {"kind": "planes", "proto": _split(proto),
                                  "net": LTE_EDGE, "async": ak,
                                  "chunks": CHUNKS}
    if world == 2:
        cases["adam"] = {"kind": "planes", "proto": _split(ADAM_PROTO),
                         "net": None, "faults": FAULTS, "train": ADAM,
                         "chunks": CHUNKS}
    cases["checkpoint"] = {
        "kind": "checkpoint", "proto": _split(CKPT["proto"]),
        "net": CKPT["net"], "faults": CKPT["faults"],
        "async": CKPT["async_"], "at": CKPT["at"], "more": CKPT["more"]}
    return cases


_RESULTS = {}


def results(world, data, tmp_path_factory):
    """One launch per world (every case of it in that launch), cached for
    the module: ``([rank results], workdir)``."""
    if world not in _RESULTS:
        work = str(tmp_path_factory.mktemp(f"planes{world}"))
        got = shard.launch(worker.run_cases, world, _cases(world), data[0],
                           data[1], work, device="cpu")
        _RESULTS[world] = (got, work)
    return _RESULTS[world]


def _ref_learner(proto, net=None, faults_kw=None, async_kw=None,
                 train=worker.SGD):
    cfg = jget_arch("drift_mlp", smoke=True)
    return JLearner(
        lambda p, b: jcnn_loss(cfg, p, b), lambda k: jinit(cfg, k), M,
        JProtocolConfig(**dict(proto, layout="flat")), JTrainConfig(**train),
        network=None if net is None else JNetworkConfig(**net),
        async_net=None if async_kw is None else JAsyncConfig(**async_kw),
        faults=None if faults_kw is None else JFaultConfig(**faults_kw))


def _ref_summary(dl, rm):
    out = {"comm": {k: int(v) for k, v in dl.comm_totals.items()},
           "ledger": np.asarray(dl.per_link_bytes()),
           "xfers": np.asarray(dl.link_xfer_totals),
           "network_time": dl.network_time,
           "plane": np.asarray(jfleet_adapter(dl.params).ravel(dl.params)),
           "losses": np.asarray(rm.loss_per_learner),
           "steps": np.asarray(dl.opt_state.step)}
    out.update({f: np.asarray(getattr(rm, f)) for f in REF_SERIES})
    return out


@pytest.fixture(scope="module")
def reference(data):
    """The reference's flat runs of the fault, async and adam cases."""
    _, batches = data
    runs = {f"faults_{n}": dict(proto=p, faults_kw=fk)
            for n, (p, fk) in FAULT_RUNS.items()}
    runs.update({f"async_{n}": dict(proto=p, net=LTE_EDGE, async_kw=ak)
                 for n, (p, ak) in ASYNC_RUNS.items()})
    runs["adam"] = dict(proto=ADAM_PROTO, faults_kw=FAULTS, train=ADAM)
    out = {}
    for name, kw in runs.items():
        dl = _ref_learner(**kw)
        out[name] = _ref_summary(dl, dl.run_chunk(batches))
    return out


def assert_close_where_finite(got, want, **tol):
    """The same entries finite, and those within the tolerance: NaN and
    ±Inf are one class."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], **(tol or TOL))


def _assert_integers(got, want, fields=REF_SERIES):
    assert got["comm"] == want["comm"]
    np.testing.assert_array_equal(got["ledger"], want["ledger"])
    np.testing.assert_array_equal(got["xfers"], want["xfers"])
    for f in fields:
        np.testing.assert_array_equal(got[f], want[f], f)


def _assert_bitwise(a, b):
    """Equal to the bit; NaN equals NaN (a poisoned run's losses)."""
    assert a["comm"] == b["comm"]
    for k in ("network_time", "cum_loss", "ledger", "xfers",
              "loss_per_learner", "plane", "steps", *worker.SERIES):
        np.testing.assert_array_equal(a[k], b[k], k)


# ---------------------------------------------------------------------------
# 1. FaultConfig() is faults=None, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(INERT))
def test_inert_faultconfig_sharded_bitwise(world, name, data,
                                           tmp_path_factory):
    got, _ = results(world, data, tmp_path_factory)
    for rank in got:
        res = rank[f"inert_{name}"]
        _assert_bitwise(res["inert"], res["none"])
        assert res["none"]["num_active"].min() < M    # the mask bites


# ---------------------------------------------------------------------------
# 2. the fault plane and robust sync
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(FAULT_RUNS))
def test_split_faults_match_reference_flat(world, name, data,
                                           tmp_path_factory, reference):
    got, _ = results(world, data, tmp_path_factory)
    want = reference[f"faults_{name}"]
    assert want["num_faulty"].sum() > 0 and want["comm"]["syncs"] > 0
    for rank in got:
        res = rank[f"faults_{name}"]
        _assert_integers(res, want)
        assert_close_where_finite(res["plane"], want["plane"])
        assert_close_where_finite(res["losses"], want["losses"])
    if name.startswith("robust"):
        assert want["num_quarantined"].sum() > 0
    if FAULT_RUNS[name][1] is HEAVY:      # the corruption reaches the plane
        assert not np.isfinite(want["losses"]).all()


# ---------------------------------------------------------------------------
# 3. the event-driven timeline and aircomp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ASYNC_RUNS))
def test_split_async_matches_reference_flat(world, name, data,
                                            tmp_path_factory, reference):
    got, _ = results(world, data, tmp_path_factory)
    want = reference[f"async_{name}"]
    assert want["comm"]["syncs"] > 0
    if name.startswith("harsh"):
        assert want["num_inflight"].sum() > 0
    for rank in got:
        res = rank[f"async_{name}"]
        _assert_integers(res, want)
        np.testing.assert_allclose(res["network_time"],
                                   want["network_time"], rtol=1e-6)
        np.testing.assert_allclose(res["plane"], want["plane"], **TOL)
        np.testing.assert_allclose(res["losses"], want["losses"], **TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_split_planes_every_rank_alike(world, data, tmp_path_factory):
    """Every rank of a split run holds the same counters, series, step
    counts and plane (the host state is replicated, the mean's partial
    sums added in rank order on every rank, aircomp's noise drawn alike
    on every rank)."""
    got, _ = results(world, data, tmp_path_factory)
    for name, res in got[0].items():
        for rank in got[1:]:
            if name.startswith("inert"):
                for label in ("none", "inert"):
                    _assert_bitwise(rank[name][label], res[label])
            else:
                _assert_bitwise(rank[name], res)


# ---------------------------------------------------------------------------
# 4. adam under crashes: the per-learner step counts
# ---------------------------------------------------------------------------

def test_split_adam_under_crashes_keeps_step_counts(data, tmp_path_factory,
                                                    reference, tmp_path):
    got, _ = results(2, data, tmp_path_factory)
    want = reference["adam"]
    cfg = FaultConfig(**FAULTS)
    crashed = faults.crash_rounds(cfg, M, range(ROUNDS))
    restarted = faults.restart_rounds(cfg, M, range(ROUNDS))
    assert crashed.any() and restarted.any()
    last = np.where(restarted.any(axis=0),
                    ROUNDS - 1 - np.argmax(restarted[::-1], axis=0), 0)
    steps = [int(sum(not crashed[t, i] for t in range(last[i], ROUNDS)))
             for i in range(M)]
    assert len(set(steps)) > 1
    init, batches = data
    case = _cases(2)["adam"]
    flat = worker.run_cases(
        {"adam": dict(case, proto=dict(ADAM_PROTO, layout="flat"))},
        init, batches, str(tmp_path))["adam"]
    for rank in got:
        res = rank["adam"]
        assert res["steps"].tolist() == steps == want["steps"].tolist()
        _assert_integers(res, want, ("num_faulty", "num_active",
                                     "link_counts"))
        _assert_integers(res, flat, worker.SERIES)
        np.testing.assert_allclose(res["plane"], flat["plane"], **TOL)


# ---------------------------------------------------------------------------
# 5. checkpoint and stream of a split faulty async run
# ---------------------------------------------------------------------------

def _ckpt_case(layout):
    return {"proto": dict(CKPT["proto"], layout=layout), "net": CKPT["net"],
            "faults": CKPT["faults"], "async": CKPT["async_"]}


@pytest.fixture(scope="module")
def flat_ckpt_run(data, tmp_path_factory):
    """The port's flat run of the checkpoint case, uninterrupted and
    streamed: its summary after 16 + 8 rounds and its stream."""
    init, batches = data
    at, more = CKPT["at"], CKPT["more"]
    path = str(tmp_path_factory.mktemp("flat_ckpt") / "flat.jsonl")
    dl = worker.planes_learner(_ckpt_case("flat"), init,
                               telemetry=TelemetryConfig(path=path,
                                                         per_link=True))
    dl.run_chunk(worker.chunk(batches, 0, at))
    metrics = dl.run_chunk(worker.chunk(batches, at, at + more))
    dl.recorder.close()
    return {**worker.summary(dl), **worker.series([metrics]),
            "steps": dl.opt_state.step.numpy()}, path


@pytest.mark.parametrize("world", [2, 4])
def test_split_checkpoint_resumes_on_the_flat_engine(world, data,
                                                     tmp_path_factory,
                                                     flat_ckpt_run):
    got, work = results(world, data, tmp_path_factory)
    init, batches = data
    ckpt = os.path.join(work, "checkpoint_ckpt")
    at, more = CKPT["at"], CKPT["more"]
    want, _ = flat_ckpt_run
    assert want["num_inflight"].sum() > 0 and want["num_faulty"].sum() > 0
    # the split run's own continuation keeps the flat run's integers
    for rank in got:
        _assert_integers(rank["checkpoint"], want, worker.SERIES)
    # the port's flat engine resumes the split checkpoint
    dl = worker.planes_learner(_ckpt_case("flat"), init)
    dl.restore_state(*io.load_protocol_state(ckpt, device="cpu"))
    dl.restore_counters(io.load_counters(ckpt))
    metrics = dl.run_chunk(worker.chunk(batches, at, at + more))
    flat = {**worker.summary(dl), **worker.series([metrics]),
            "steps": dl.opt_state.step.numpy()}
    assert dl.rounds == at + more
    _assert_integers(flat, want, worker.SERIES)
    np.testing.assert_array_equal(flat["steps"], want["steps"])
    np.testing.assert_allclose(flat["network_time"], want["network_time"],
                               rtol=1e-6)
    np.testing.assert_allclose(flat["plane"], want["plane"], **TOL)

    # the reference resumes it as its callers do, by assigning, and
    # continues as its own uninterrupted run does
    def ref():
        return _ref_learner(CKPT["proto"], CKPT["net"], CKPT["faults"],
                            CKPT["async_"])
    done = ref()
    done.run_chunk(jax.tree.map(lambda x: x[:at], batches))
    dm = done.run_chunk(jax.tree.map(lambda x: x[at:at + more], batches))
    resumed = ref()
    params, opt, state = jio.load_protocol_state(ckpt)
    resumed.params, resumed.sync_state = params, state
    resumed.opt_state = JOptState(step=opt[".step"], mu=opt.get(".mu"),
                                  nu=opt.get(".nu"))
    resumed.restore_counters(jio.load_counters(ckpt))
    rm = resumed.run_chunk(jax.tree.map(lambda x: x[at:at + more], batches))
    a, b = _ref_summary(resumed, rm), _ref_summary(done, dm)
    _assert_integers(a, b)
    _assert_integers(a, flat, ("num_faulty", "num_active", "num_inflight",
                               "max_age", "link_counts"))
    np.testing.assert_allclose(a["plane"], b["plane"], **TOL)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("world", [2, 4])
def test_split_faulty_async_stream_matches_flat(world, data,
                                                tmp_path_factory,
                                                flat_ckpt_run):
    """Rank 0's stream of the split run is the flat run's: the same
    records and keys, integers exact, floats within the shard
    tolerance."""
    _, work = results(world, data, tmp_path_factory)
    _, path = flat_ckpt_run
    flat = [r for r in _records(path) if r["kind"] == "round"]
    split = [r for r in _records(os.path.join(work, "checkpoint.jsonl"))
             if r["kind"] == "round"]
    assert len(flat) == len(split) == CKPT["at"] + CKPT["more"]
    assert {"num_faulty", "inflight", "max_age"} <= set(split[0])
    for a, b in zip(flat, split):
        assert sorted(a) == sorted(b)
        for k, va in a.items():
            if isinstance(va, float):
                np.testing.assert_allclose(b[k], va, **TOL)
            else:
                assert va == b[k], (k, va, b[k])
