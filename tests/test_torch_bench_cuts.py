"""Each benchmark twin's first cut row (``CUT[0]``, through the twin's
``cut``; both of ``scan_driver``'s) against the reference benchmark's
own helpers, on the
CPU, on the reference's batches (``ReplaySource``) from the reference's
initial model (``convert.params_from_numpy``): comm counters, bytes,
ledger and sync curves exact, losses within rtol 1e-4 (the port sums a
chunk's f32 losses in another order than XLA), simulated network time
within rtol 1e-6 (a chunk's f32 sum, ROADMAP's departures).

Every live case records the port's row distances (each ``sqdist_rows``
result) and checks that none lies within 1e-4 of Delta of a threshold,
so that the two packages' float differences cannot flip a decision.
``shard_bench``'s case runs its sharded half on 2 CPU ranks in one
spawn. ``kernel_bench``'s cut (its row builder) is held to the
reference's plain versions in ``tests/test_torch_bench_twins.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import torch_run  # noqa: E402
from benchmarks.torch_common import ReplaySource  # noqa: E402
from repro.config import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.config import FaultConfig as JFaultConfig  # noqa: E402
from repro.config import HierarchyConfig as JHierarchyConfig  # noqa: E402
from repro.config import NetworkConfig as JNetworkConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.core.sync import init_state as jinit_state  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.data.synthetic import SyntheticMNIST as JMNIST  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

LOSS_TOL = dict(rtol=1e-4)
NET_TIME_TOL = dict(rtol=1e-6)
DELTA_MARGIN = 1e-4
TWINS = {mod.NAME: mod for mod in torch_run.ALL}


def _ref(name):
    return importlib.import_module(f"benchmarks.{name}")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(arch, smoke=True):
    """The reference's initial model of seed 0: the first of
    ``split(PRNGKey(0), 3)``, as numpy."""
    cfg = jget_arch(arch, smoke=smoke)
    return _np(jinit(cfg, jax.random.split(jax.random.PRNGKey(0), 3)[0]))


def _init_fn(init):
    return lambda g: params_from_numpy(init, device="cpu")


def _loss(arch):
    cfg = jget_arch(arch, smoke=True)
    return lambda p, b: jcnn_loss(cfg, p, b)


def _jinit_fn(arch):
    cfg = jget_arch(arch, smoke=True)
    return lambda k: jinit(cfg, k)


@pytest.fixture
def distances(monkeypatch):
    """Every row-distance vector the port computes on the CPU."""
    seen = []
    plain = ops.sqdist_rows

    def record(X, r):
        out = plain(X, r)
        seen.append(out.detach().numpy().copy())
        return out

    monkeypatch.setattr(ops, "sqdist_rows", record)
    return seen


def _off_thresholds(seen, *deltas):
    d = np.concatenate([x.ravel() for x in seen])
    assert d.size
    for delta in deltas:
        assert np.min(np.abs(d - delta)) >= DELTA_MARGIN * delta, delta


def _same(dl, jdl, network_time=False):
    assert dl.comm_totals == {k: int(v) for k, v in jdl.comm_totals.items()}
    assert dl.comm_bytes() == jdl.comm_bytes()
    np.testing.assert_array_equal(dl.per_link_bytes(),
                                  np.asarray(jdl.per_link_bytes()))
    np.testing.assert_allclose(dl.cumulative_loss, jdl.cumulative_loss,
                               **LOSS_TOL)
    if network_time:
        np.testing.assert_allclose(dl.network_time, jdl.network_time,
                                   **NET_TIME_TOL)


def test_dynamic_amortized_cut(distances):
    twin = TWINS["dynamic_amortized"]
    (kw, m, rounds, _), = twin.CUT
    streams = JStreams(JMNIST(seed=0, image_size=14), m, batch=10, seed=0)
    chunks = [_np(streams.next_chunk(rounds // 2 + 1)),
              _np(streams.next_chunk(rounds - rounds // 2 - 1))]
    jdl = JLearner(_loss("mnist_cnn"), _jinit_fn("mnist_cnn"), m,
                   JProtocolConfig(**kw),
                   JTrainConfig(optimizer="sgd", learning_rate=0.1))
    jdl.run_chunk(chunks[0])
    half = int(jdl.comm_totals["syncs"])
    jdl.run_chunk(chunks[1])
    src = ReplaySource(chunks)
    dl, got = twin.cut(twin.CUT[0], "cpu", src,
                       _init_fn(_init("mnist_cnn")))
    assert src.remaining == 0 and got["half_syncs"] == half
    _same(dl, jdl)
    assert 0 < half < jdl.comm_totals["syncs"]
    _off_thresholds(distances, kw["delta"])


def test_scan_driver_cut(distances):
    """Both drivers of the twin against the reference's chunked driver,
    which its own benchmark holds to its per-round loop."""
    twin, ref = TWINS["scan_driver"], _ref("scan_driver")
    assert [c[3]["driver"] for c in twin.CUT] == ["loop", "scan"]
    kw, m, rounds, _ = twin.CUT[0]
    assert all(c[:3] == (kw, m, rounds) for c in twin.CUT)
    jdl = JLearner(_loss("mnist_cnn"), _jinit_fn("mnist_cnn"), m,
                   JProtocolConfig(**kw),
                   JTrainConfig(optimizer="sgd", learning_rate=0.1))
    ref._scan_rounds(ref._streams(), jdl, rounds)
    batches = _np(ref._streams().next_chunk(rounds))
    for case in twin.CUT:
        dl, _ = twin.cut(case, "cpu", ReplaySource([batches]),
                         _init_fn(_init("mnist_cnn")))
        _same(dl, jdl)
    assert 0 < jdl.comm_totals["syncs"]
    _off_thresholds(distances, kw["delta"])


def test_fig_network_regimes_cut(distances):
    twin, ref = TWINS["fig_network_regimes"], _ref("fig_network_regimes")
    for case in twin.CUT[:1]:
        kw, m, rounds, extra = case
        topo = extra["topology"]
        net = JNetworkConfig(topology=topo, act_prob=extra["act_prob"],
                             geo_radius=0.6,
                             redraw_every=20 if topo == "geometric" else 0,
                             link_classes=("wifi", "lte"))
        jdl = ref._run(JProtocolConfig(**kw), net, rounds)
        batches = _np(JStreams(JGraphical(seed=1, drift_prob=0.0), m,
                               batch=10, seed=0).next_chunk(rounds))
        dl, got = twin.cut(case, "cpu", ReplaySource([batches]),
                           _init_fn(_init("drift_mlp")))
        _same(dl, jdl, network_time=True)
        assert got["mean_active"] == jdl.mean_active()
        assert 0 < jdl.comm_totals["syncs"]
        if kw["kind"] == "dynamic":
            _off_thresholds(distances, kw["delta"])


def test_fig_hierarchy_cut(distances):
    twin, ref = TWINS["fig_hierarchy"], _ref("fig_hierarchy")
    for case in twin.CUT[:1]:
        kw, m, rounds, extra = case
        g, d_inter = extra["clusters"], extra["inter_delta"]
        tiers = None if not g else JHierarchyConfig(
            num_clusters=g,
            inter=JProtocolConfig(kind="dynamic", b=kw["b"], delta=d_inter))
        drifts = sorted(extra["drift_rounds"])
        jdl, jloss = ref._run_one(JProtocolConfig(**kw, tiers=tiers), rounds,
                                  set(drifts))
        jsrc = JGraphical(seed=1, drift_prob=0.0)
        streams = JStreams(jsrc, m, batch=10, seed=0)
        chunks = []
        for start, end in zip([0] + drifts, drifts + [rounds]):
            if start:
                jsrc.force_drift()
            chunks.append(_np(streams.next_chunk(end - start)))
        src = ReplaySource(chunks)
        dl, got = twin.cut(case, "cpu", src, _init_fn(_init("drift_mlp")))
        assert src.remaining == 0
        _same(dl, jdl)
        want = ref._row("cut", jdl, jloss, g, d_inter)
        for key in ("comm_bytes", "coordinator_uplink_bytes",
                    "member_link_bytes", "ledger_balanced", "syncs"):
            assert got["row"][key] == want[key], key
        np.testing.assert_allclose(got["loss"], jloss, **LOSS_TOL)
        assert 0 < want["syncs"]
        _off_thresholds(distances, *{kw["delta"], d_inter} - {None})


def test_async_bench_cut(distances, tmp_path):
    twin, ref = TWINS["async_bench"], _ref("async_bench")
    for i, case in enumerate(twin.CUT[:1]):
        kw, m, rounds, extra = case
        net = (JAsyncConfig(round_budget=60.0, aircomp=True, snr_db=20.0)
               if extra.get("aircomp") else
               JAsyncConfig(round_budget=extra["budget"],
                            payload_bytes=ref.PAYLOAD))
        jdl = ref._train(kw, rounds, str(tmp_path / f"{i}.jsonl"), net)
        batches = _np(JStreams(JGraphical(seed=0, drift_prob=0.0), m,
                               batch=10, seed=0).next_chunk(rounds))
        dl, got = twin.cut(case, "cpu", ReplaySource([batches]),
                           _init_fn(_init("drift_mlp")))
        _same(dl, jdl, network_time=True)
        assert 0 < jdl.comm_totals["syncs"]
        if kw["kind"] == "dynamic":
            _off_thresholds(distances, kw["delta"])


def test_robust_bench_cut(distances):
    twin, ref = TWINS["robust_bench"], _ref("robust_bench")
    init = _np(ref._init(jax.random.split(jax.random.PRNGKey(0), 3)[0]))
    np.testing.assert_allclose(twin.cut_init()["w"], init["w"], rtol=0,
                               atol=1e-6)
    for case in twin.CUT[:1]:
        kw, m, rounds, extra = case
        faults = JFaultConfig(fault_seed=11, byzantine_frac=extra["adv_frac"],
                              byzantine_mode="sign_flip")
        jdl, metrics = ref._train(dict(ref.DEFENSES)[kw["defense"]], rounds,
                                  faults)
        xs, ys = _np(ref._batches(rounds))
        mine = twin.default_source("cpu").sample(None, twin.SAMPLES,
                                                 lead=(rounds, m))
        # the twin's own draws are the reference's, to prng.NORMAL_TOL
        np.testing.assert_allclose(mine["x"].numpy(), xs, rtol=0, atol=1e-5)
        np.testing.assert_allclose(mine["y"].numpy(), ys, rtol=0, atol=1e-5)
        dl, got = twin.cut(case, "cpu", ReplaySource([{"x": xs, "y": ys}]),
                           _init_fn(init))
        _same(dl, jdl)
        np.testing.assert_allclose(
            got["honest_tail_loss"],
            ref._honest_tail_loss(metrics, faults, rounds), **LOSS_TOL)
        want_q = (int(np.asarray(metrics.num_quarantined).sum())
                  if kw["defense"] != "mean" else None)
        assert got["quarantined_total"] == want_q
        _off_thresholds(distances, ref._DYN["delta"])


def test_sync_bench_cut(distances):
    twin, ref = TWINS["sync_bench"], _ref("sync_bench")
    (kw, m, _, extra), = twin.CUT
    stacked, base, v = ref._fleet(m)
    res = ref._round_fn(extra["layout"], kw["delta"])(stacked,
                                                      jinit_state(base, 0))
    # the reference's direction, leaf by leaf, in the plane's order
    leaves = jax.tree.leaves(base)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    u = np.concatenate([np.asarray(jax.random.normal(k, x.shape,
                                                     jnp.float32)).ravel()
                        for k, x in zip(keys, leaves)])
    dl, got = twin.cut(twin.CUT[0], "cpu", ReplaySource([{"u": u[None]}]),
                       _init_fn(_np(base)))
    assert dl is None
    assert got["rec"] == {k: int(getattr(res.rec, k))
                          for k in res.rec._fields}
    assert got["xfers"] == [int(x) for x in np.asarray(res.xfers)]
    assert got["cohort"] == m // 2 and got["violators"] == v
    want = np.concatenate([np.asarray(x).reshape(m, -1)
                           for x in jax.tree.leaves(res.params)], axis=1)
    np.testing.assert_allclose(got["params"].numpy(), want, rtol=1e-4,
                               atol=1e-5)
    _off_thresholds(distances, kw["delta"])


def test_shard_bench_cut(distances):
    twin = TWINS["shard_bench"]
    (kw, m, rounds, extra), = twin.CUT
    assert extra["world"] == 2
    batches = _np(JStreams(JGraphical(seed=0, drift_prob=0.0), m, batch=10,
                           seed=0).next_chunk(rounds))
    jdl = JLearner(_loss("drift_mlp"), _jinit_fn("drift_mlp"), m,
                   JProtocolConfig(**kw, layout="flat"),
                   JTrainConfig(optimizer="sgd", learning_rate=0.05))
    jdl.run_chunk(batches)
    dl, got = twin.cut(twin.CUT[0], "cpu", ReplaySource([batches]),
                       _init_fn(_init("drift_mlp")))
    _same(dl, jdl)
    want = {k: int(v) for k, v in jdl.comm_totals.items()}
    assert got["sharded_comm"] == want
    assert got["sharded_xfers"] == [int(x) for x in
                                    np.asarray(jdl.link_xfer_totals)]
    assert got["ranks_agree"] and got["counters_equal"]
    assert 0 < want["syncs"]
    _off_thresholds(distances, kw["delta"])
