"""The row-sharded fleet plane, ``layout="sharded"``, against the JAX
package on the CPU (tests/test_shard.py's cases).

The plane's rows split over the ranks of a ``torch.distributed`` process
group (``repro_torch.core.shard``). At world 1 (no process group, in this
process) the sharded run is the port's flat run bit for bit: counters,
ledger, network time, losses and parameters. At world 2 and 4 (ranks
spawned by ``shard.launch``, gloo on the CPU, all cases of a world in
one launch) each preset under the ring at 60% availability, the
hierarchy with g = 4, the telemetry stream and a resume from a
checkpoint hold the reference's flat run: comm counters, the per-link
ledger and the link transfers exact, network time to rtol 1e-6 and the
parameters to the reference's own rtol 2e-4 / atol 1e-6
(tests/test_shard.py:79): the cohort means and the augmentation's sums
add the ranks' partial sums in rank order, which reassociates the f32
sums. Every rank holds identical counters and the same plane, and a
repeated run is bit for bit. The plane helpers that cross ranks give the
arithmetic they document bit for bit: a row sum is the ranks' partial
matvecs added in rank order. ``make_dynamic_train_step`` /
``make_periodic_train_step`` hold the reference's over 10 steps of the
drift MLP at m = 4, at world 1 and 2: ``synced`` exact, ``max_sq_dist``,
losses and parameters to rtol 1e-5 / atol 1e-6.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import torch_shard_worker as worker  # noqa: E402
from repro.config import HierarchyConfig as JHierarchyConfig  # noqa: E402
from repro.config import NetworkConfig as JNetworkConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core import distributed as jdistributed  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro_torch.config import ProtocolConfig  # noqa: E402
from repro_torch.core import shard  # noqa: E402
from repro_torch.core.sync.spec import (  # noqa: E402
    LAYOUTS, PLANE_LAYOUTS, ProtocolSpec, resolve_spec,
)

PRESETS = {
    "nosync": dict(kind="nosync"),
    "periodic": dict(kind="periodic", b=3),
    "continuous": dict(kind="continuous", b=1),
    "fedavg": dict(kind="fedavg", b=2, fedavg_c=0.5),
    "dynamic": dict(kind="dynamic", b=2, delta=0.5),
    "gossip": dict(kind="gossip", b=2),
    "stale": dict(kind="stale"),
}
TIERS = {"num_clusters": 4, "inter": dict(kind="periodic", b=6)}
DYN = dict(kind="dynamic", b=2, delta=0.5)
RUNS = dict(PRESETS, hierarchy=DYN)
TOL = dict(rtol=2e-4, atol=1e-6)
COLLECTIVES = dict(kind="collectives", m=8, P=37, seed=5, rows=[5, 1, 6])
STEP_DELTA = 0.02


def _tiers(name):
    return TIERS if name == "hierarchy" else None


@pytest.fixture(scope="module")
def data():
    cfg = jget_arch("drift_mlp", smoke=True)
    init = jax.tree.map(np.asarray, jinit(
        cfg, jax.random.split(jax.random.PRNGKey(0), 3)[0]))
    streams = JStreams(JGraphical(seed=0, drift_prob=0.0), 8, batch=10,
                       seed=0)
    batches = jax.tree.map(np.asarray, streams.next_chunk(30))
    small = JStreams(JGraphical(seed=1, drift_prob=0.0), 4, batch=10,
                     seed=1)
    step_batches = jax.tree.map(np.asarray, small.next_chunk(10))
    step_init = jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(0)))
    return init, batches, step_init, step_batches


def _cases(layout, data, world):
    init, batches, step_init, step_batches = data
    sh = dict(layout=layout)
    cases = {n: {"kind": "run", "proto": dict(kw, **sh),
                 "tiers": _tiers(n)} for n, kw in RUNS.items()}
    cases["repeat"] = {"kind": "repeat", "proto": dict(DYN, **sh)}
    cases["telemetry"] = {"kind": "telemetry", "proto": dict(DYN, **sh)}
    cases["resume"] = {"kind": "resume", "proto": dict(DYN, **sh)}
    cases["train_step"] = {"kind": "train_step", "delta": STEP_DELTA,
                           "init": step_init, "batches": step_batches}
    if world > 1:
        cases["errors"] = {"kind": "errors"}
        cases["collectives"] = COLLECTIVES
    if world == 4:
        cases["subset"] = {"kind": "subset",
                           "proto": dict(DYN, layout="sharded",
                                         shard_devices=2)}
    return cases


_RESULTS = {}


def results(key, data, tmp_path_factory):
    """One launch per world size (every case of it in that launch),
    cached for the module: ``[rank results]``."""
    if key not in _RESULTS:
        layout, world = key
        work = str(tmp_path_factory.mktemp(f"{layout}{world}"))
        cases = _cases(layout, data, world)
        if world == 1:
            got = [worker.run_cases(cases, data[0], data[1], work)]
        else:
            got = shard.launch(worker.run_cases, world, cases, data[0],
                               data[1], work, device="cpu")
        _RESULTS[key] = (got, work)
    return _RESULTS[key]


@pytest.fixture(scope="module")
def reference(data):
    """The reference's flat runs of every case in RUNS."""
    init, batches, _, _ = data
    cfg = jget_arch("drift_mlp", smoke=True)
    out = {}
    for name, kw in RUNS.items():
        tiers = None if _tiers(name) is None else JHierarchyConfig(
            num_clusters=4, inter=JProtocolConfig(kind="periodic", b=6))
        dl = JLearner(lambda p, b: jcnn_loss(cfg, p, b),
                      lambda k: jinit(cfg, k), 8,
                      JProtocolConfig(layout="flat", tiers=tiers, **kw),
                      JTrainConfig(**worker.SGD),
                      network=JNetworkConfig(**worker.NET))
        dl.run_chunk(batches)
        out[name] = {
            "comm": {k: int(v) for k, v in dl.comm_totals.items()},
            "ledger": np.asarray(dl.per_link_bytes()),
            "xfers": np.asarray(dl.link_xfer_totals),
            "network_time": dl.network_time,
            "plane": np.asarray(jfleet_adapter(dl.params).ravel(dl.params))}
    return out


def _assert_comm_exact(a, b):
    assert a["comm"] == b["comm"]
    np.testing.assert_array_equal(a["ledger"], b["ledger"])
    np.testing.assert_array_equal(a["xfers"], b["xfers"])


def _assert_bitwise(a, b):
    _assert_comm_exact(a, b)
    assert a["network_time"] == b["network_time"]
    assert a["cum_loss"] == b["cum_loss"]
    np.testing.assert_array_equal(a["loss_per_learner"],
                                  b["loss_per_learner"])
    np.testing.assert_array_equal(a["plane"], b["plane"])


# ---------------------------------------------------------------------------
# registration, validation, the fleet
# ---------------------------------------------------------------------------

def test_sharded_is_a_registered_layout():
    assert "sharded" in LAYOUTS
    assert "sharded" in PLANE_LAYOUTS and "tree" not in PLANE_LAYOUTS
    spec = resolve_spec(ProtocolConfig(kind="dynamic", layout="sharded",
                                       shard_devices=1))
    assert spec.param("layout") == "sharded"
    assert spec.param("shard_devices") == 1
    assert ProtocolSpec.from_json(spec.to_json()) == spec
    # the JSON both packages write for the same config
    jspec = JProtocolConfig(kind="dynamic", layout="sharded",
                            shard_devices=1)
    from repro.core.sync.spec import resolve_spec as jresolve
    assert json.loads(spec.to_json()) == json.loads(jresolve(jspec).to_json())


@pytest.mark.parametrize("bad", [-1, 1.5, "2"])
def test_spec_rejects_bad_shard_devices(bad):
    with pytest.raises(ValueError) as want:
        JProtocolConfig(kind="dynamic", layout="sharded", shard_devices=bad)
    with pytest.raises(ValueError) as got:
        ProtocolConfig(kind="dynamic", layout="sharded", shard_devices=bad)
    assert str(got.value) == str(want.value)
    assert "shard_devices" in str(got.value)


def test_fleet_sharding_validates_divisibility():
    """Without a process group the fleet is one rank, as the reference's
    mesh on one device."""
    with pytest.raises(ValueError, match="device"):
        shard.fleet_sharding(8, 2)          # more than visible
    fs = shard.fleet_sharding(8, 0)
    assert (fs.n_devices, fs.rows_per_device, fs.rows) == (1, 8, slice(0, 8))
    assert fs.group is None


def test_use_fleet_is_the_active_fleet_context():
    x = torch.ones((4, 3))
    fs = shard.fleet_sharding(4, 1)
    assert shard.current_fleet() is None
    with shard.use_fleet(fs):
        assert shard.current_fleet() is fs
        # a fleet of one rank: every plane helper is the flat expression
        assert shard.gather_plane(x) is x
        assert shard.fleet_m(x) == 4
        with shard.use_fleet(None):
            assert shard.current_fleet() is None
    assert shard.current_fleet() is None


# ---------------------------------------------------------------------------
# world 1: the flat run bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RUNS))
def test_world1_sharded_is_flat_bit_for_bit(name, data, tmp_path_factory):
    flat, _ = results(("flat", 1), data, tmp_path_factory)
    one, _ = results(("sharded", 1), data, tmp_path_factory)
    _assert_bitwise(flat[0][name], one[0][name])


def test_world1_flat_holds_the_reference(data, tmp_path_factory, reference):
    flat, _ = results(("flat", 1), data, tmp_path_factory)
    for name in RUNS:
        _assert_comm_exact(flat[0][name], reference[name])
        np.testing.assert_allclose(flat[0][name]["plane"],
                                   reference[name]["plane"], **TOL)


# ---------------------------------------------------------------------------
# world 2 and 4: the reference's flat run, every rank alike, repeatable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_split_fleet_matches_reference_flat(world, name, data,
                                            tmp_path_factory, reference):
    got, _ = results(("sharded", world), data, tmp_path_factory)
    want = reference[name]
    for rank in got:
        _assert_comm_exact(rank[name], want)
        np.testing.assert_allclose(rank[name]["network_time"],
                                   want["network_time"], rtol=1e-6)
        np.testing.assert_allclose(rank[name]["plane"], want["plane"], **TOL)
    # every rank holds the same counters, losses and plane
    for rank in got[1:]:
        _assert_bitwise(rank[name], got[0][name])


def _collective_want(op, world, r):
    """What ``op`` documents on rank ``r`` of ``world``, computed here on
    the whole plane, and the bytes the rank receives for it (the same
    draws as the worker's)."""
    c = COLLECTIVES
    m, P = c["m"], c["P"]
    gen = torch.Generator().manual_seed(c["seed"])
    X = torch.randn((m, P), generator=gen)
    w = torch.rand((m,), generator=gen)
    W = torch.rand((m, m), generator=gen)
    ref = torch.randn((P,), generator=gen)
    k = m // world
    blocks = [slice(i * k, (i + 1) * k) for i in range(world)]
    row = P * 4
    if op in ("row_sum", "row_mean"):
        ww = w if op == "row_sum" else torch.ones((m,))
        total = ww[blocks[0]] @ X[blocks[0]]
        for blk in blocks[1:]:
            total = total + ww[blk] @ X[blk]
        want = total if op == "row_sum" else total / m
        return want, {"all_gather": (world - 1) * row}
    if op == "row_dists":
        from repro_torch.core.divergence import per_learner_sq_distance_flat
        return (torch.cat([per_learner_sq_distance_flat(X[blk], ref)
                           for blk in blocks]),
                {"all_gather": (world - 1) * k * 4})
    if op == "plane_rows":
        # a broadcast from each row's owner: every row but this rank's own
        others = sum(1 for i in c["rows"] if i // k != r)
        return X[c["rows"]], {"broadcast": others * row}
    if op == "mix":
        return W[blocks[r]] @ X, {"all_gather": (world - 1) * k * row}
    return X, {"all_gather": (world - 1) * k * row}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", ["row_sum", "row_mean", "row_dists",
                                "plane_rows", "mix", "gather_plane"])
def test_split_plane_helpers_are_their_documented_arithmetic(
        world, op, data, tmp_path_factory):
    """Each helper that crosses ranks, on each rank, is bit for bit the
    arithmetic its docstring states (a row sum: the ranks' partial
    matvecs added in rank order; the distances: each rank's block
    gathered in rank order), and counts the bytes it received."""
    got, _ = results(("sharded", world), data, tmp_path_factory)
    for r, rank in enumerate(got):
        want, nbytes = _collective_want(op, world, r)
        res = rank["collectives"][op]
        np.testing.assert_array_equal(res["value"], want.numpy())
        assert res["bytes"] == nbytes


@pytest.mark.parametrize("world", [2, 4])
def test_split_fleet_repeats_bit_for_bit(world, data, tmp_path_factory):
    got, _ = results(("sharded", world), data, tmp_path_factory)
    for rank in got:
        first, second = rank["repeat"]
        _assert_bitwise(first, second)
        _assert_bitwise(first, rank["dynamic"])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("world", [2, 4])
def test_split_telemetry_stream_matches_flat(world, data, tmp_path_factory):
    """Rank 0 writes one stream, interchangeable with the flat run's:
    integers exact, floats to f32 resolution."""
    _, fwork = results(("flat", 1), data, tmp_path_factory)
    got, swork = results(("sharded", world), data, tmp_path_factory)
    frecs = _records(os.path.join(fwork, "telemetry.jsonl"))
    srecs = _records(os.path.join(swork, "telemetry.jsonl"))
    fr = [r for r in frecs if r["kind"] == "round"]
    sr = [r for r in srecs if r["kind"] == "round"]
    assert len(fr) == len(sr) == 30
    for a, b in zip(fr, sr):
        for k, va in a.items():
            if isinstance(va, float):
                np.testing.assert_allclose(va, b[k], rtol=1e-5, atol=1e-7)
            else:
                assert va == b[k], (k, va, b[k])
    fmeta = [r for r in frecs if r["kind"] == "meta"][0]
    smeta = [r for r in srecs if r["kind"] == "meta"][0]
    assert fmeta["spec"]["params"]["layout"] == "flat"
    assert smeta["spec"]["params"]["layout"] == "sharded"
    assert sr[-1]["cum_syncs"] == got[0]["telemetry"]["comm"]["syncs"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_resume_continuity_under_sharded_carry(world, data,
                                               tmp_path_factory):
    """Checkpoint after 15 rounds (rank 0 writes the gathered plane, a
    flat run's files), restore into fresh engines (each rank its rows),
    15 more rounds: one contiguous stream, and the uninterrupted run's
    state bit for bit."""
    got, work = results(("sharded", world), data, tmp_path_factory)
    recs = _records(os.path.join(work, "resume.jsonl"))
    rounds = [r["round"] for r in recs if r["kind"] == "round"]
    assert rounds == list(range(1, 31))
    assert [r for r in recs if r["kind"] == "meta"][-1]["resumed_rounds"] \
        == 15
    last = [r for r in recs if r["kind"] == "round"][-1]
    for rank in got:
        assert last["cum_syncs"] == rank["resume"]["comm"]["syncs"]
        _assert_comm_exact(rank["resume"], rank["telemetry"])
        np.testing.assert_array_equal(rank["resume"]["plane"],
                                      rank["telemetry"]["plane"])
    # the checkpoint is a flat run's: the reference reads it
    from repro.checkpoint import io as jio
    params, opt, state = jio.load_protocol_state(
        os.path.join(work, "resume_ckpt"))
    assert jax.tree.leaves(params)[0].shape[0] == 8
    assert np.asarray(opt[".step"]).tolist() == [15] * 8


@pytest.mark.parametrize("world", [2, 4])
def test_split_fleet_refusals(world, data, tmp_path_factory):
    got, _ = results(("sharded", world), data, tmp_path_factory)
    for rank in got:
        err = rank["errors"]
        assert err["indivisible"].startswith("ValueError") and \
            "m % n_devices" in err["indivisible"]
        assert err["too_many"].startswith("ValueError") and \
            "device(s) are visible" in err["too_many"]
        # a crash schedule on the split fleet runs since A26 (the
        # parity is tests/test_torch_shard_planes.py's)
        assert err["faults"] == "no error"
        assert err["clusters"].startswith("ValueError") and \
            "n_devices to divide num_clusters" in err["clusters"]


def test_shard_devices_subset_matches_full_fleet(data, tmp_path_factory,
                                                 reference):
    """``shard_devices=2`` of 4 ranks: ranks 0 and 1 run the fleet, ranks
    2 and 3 are outside it and raise; the run is the reference's."""
    got, _ = results(("sharded", 4), data, tmp_path_factory)
    for rank in got[:2]:
        _assert_comm_exact(rank["subset"], reference["dynamic"])
        np.testing.assert_allclose(rank["subset"]["plane"],
                                   reference["dynamic"]["plane"], **TOL)
    for rank in got[2:]:
        assert rank["subset"].startswith("ValueError") and \
            "outside the fleet" in rank["subset"]


# ---------------------------------------------------------------------------
# the SPMD step factories
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_steps(data):
    _, _, step_init, step_batches = data
    cfg = jget_arch("drift_mlp", smoke=True)
    loss_fn = lambda p, b: jcnn_loss(cfg, p, b)   # noqa: E731
    train = JTrainConfig(optimizer="sgd", learning_rate=0.3)
    out = {}
    for kind, make in (("dynamic", jdistributed.make_dynamic_train_step),
                       ("periodic", jdistributed.make_periodic_train_step)):
        proto = JProtocolConfig(kind=kind, b=2, delta=STEP_DELTA)
        state = jdistributed.init_dynamic_state(
            lambda k: jinit(cfg, k), jax.random.PRNGKey(0), 4, train)
        step = jax.jit(make(loss_fn, proto, train, 4))
        synced, maxd, loss = [], [], []
        for t in range(10):
            state, metrics = step(state, jax.tree.map(lambda x: x[t],
                                                      step_batches))
            synced.append(int(metrics["synced"]))
            maxd.append(float(metrics.get("max_sq_dist", 0.0)))
            loss.append(float(metrics["loss"]))
        out[kind] = {"synced": synced, "max_sq_dist": maxd, "loss": loss,
                     "plane": np.asarray(jfleet_adapter(state.params)
                                         .ravel(state.params)),
                     "syncs": int(state.syncs), "checks": int(state.checks)}
    return out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("kind", ["dynamic", "periodic"])
def test_train_step_factories_match_reference(world, kind, data,
                                              tmp_path_factory,
                                              reference_steps):
    got, _ = results(("sharded", world), data, tmp_path_factory)
    want = reference_steps[kind]
    assert 0 < want["syncs"] < 10 or kind == "periodic"
    for rank in got:
        res = rank["train_step"][kind]
        assert res["synced"] == want["synced"]
        assert (res["syncs"], res["checks"]) == (want["syncs"],
                                                 want["checks"])
        np.testing.assert_allclose(res["max_sq_dist"], want["max_sq_dist"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["plane"], want["plane"], rtol=1e-5,
                                   atol=1e-6)
