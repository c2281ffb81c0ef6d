"""The port's event-driven timeline and over-the-air aggregation against
the reference's, on the CPU.

The cases of tests/test_async.py (its telemetry cases wait for the
telemetry slice): the delay math and the arrival ring
(``repro_torch.network.events`` against ``repro.network.events``),
``asyncify``'s rewrites (the same spec JSON), the zero-delay reduction —
every preset on both layouts with an ``AsyncConfig`` whose budget covers
every round trip equals its synchronous run in the port bit for bit
(plane, comm, ledger, network time), and its synchronous run in the
reference within this file's tolerances — messages in flight, the quiet
timeline, the exact ledger under delays, aircomp's pricing and noise;
then the presets of benchmarks/async_bench.py (m = 8, lte/edge links)
and async under a hierarchy against the reference's live runs: comm,
ledger, every round's link counts and in-flight count exact,
``network_time`` within rtol 1e-6, parameters within atol / rtol 1e-5.
aircomp's noise is ``prng.normal`` (within ``prng.NORMAL_TOL`` of
jax's) times ``rms * 10^(-snr/20) / n``, with the rms a mean over the
row summed in another order than XLA's: both move the parameters by
less than 1e-9 here, inside the same atol.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.config import HierarchyConfig as JHierarchyConfig  # noqa: E402
from repro.config import NetworkConfig as JNetworkConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.core.sync import PROTOCOLS as JPROTOCOLS  # noqa: E402
from repro.core.sync.async_sync import asyncify as jasyncify  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.network import events as jevents  # noqa: E402
from repro_torch.config import (  # noqa: E402
    AsyncConfig, HierarchyConfig, NetworkConfig, ProtocolConfig, TrainConfig,
    get_arch,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.core.sync import PROTOCOLS  # noqa: E402
from repro_torch.core.sync import stages  # noqa: E402
from repro_torch.core.sync.async_sync import asyncify  # noqa: E402
from repro_torch.models.cnn import cnn_loss  # noqa: E402
from repro_torch.network import events  # noqa: E402

SGD = dict(optimizer="sgd", learning_rate=0.05)
TOL = dict(rtol=1e-5, atol=1e-5)
LTE_EDGE = dict(link_classes=("lte", "edge"))


# ---------------------------------------------------------------------------
# delay math and the arrival ring
# ---------------------------------------------------------------------------

def test_flight_rounds_from_link_classes():
    for csv, payload, budget in [("lte,edge", 100_000, 1.0),
                                 ("lte,edge", 100_000, 60.0),
                                 ("wifi,lte", 4_799_528, 1.0),
                                 ("", 100_000, 1.0)]:
        want = jevents.class_flight_rounds(csv, payload, budget)
        assert events.class_flight_rounds(csv, payload, budget) == want
        assert events.max_flight_rounds(csv, payload, budget) == \
            jevents.max_flight_rounds(csv, payload, budget)
        k = events.flight_rounds(csv, 5, payload, budget)
        np.testing.assert_array_equal(
            k, np.asarray(jevents.flight_rounds(csv, 5, payload, budget)))
        assert k.dtype == np.int32
    assert events.class_flight_rounds("lte,edge", 100_000, 1.0) == {
        "lte": 0, "edge": 1}
    # mnist_cnn's payload: lte flies 2 rounds at a 1 s budget, wifi 0
    assert events.class_flight_rounds("wifi,lte", 4_799_528, 1.0) == {
        "wifi": 0, "lte": 2}
    with pytest.raises(ValueError, match="warp-drive"):
        events.class_flight_rounds("warp-drive", 0, 1.0)


def test_round_trip_time_matches_reference():
    for name in ("wired", "wifi", "lte", "edge"):
        assert events.round_trip_time(name, 100_000) == \
            jevents.round_trip_time(name, 100_000)


def test_arrival_ring_mechanics_match_reference():
    ring, jring = events.empty_ring(3, 4), jevents.empty_ring(3, 4)
    k = np.asarray([2, 0, 1], np.int32)
    for t, launch in [(5, [True, False, True]), (6, [False] * 3),
                      (7, [False, True, False]), (9, [True, True, True])]:
        ring = events.ring_step(ring, t, np.asarray(launch), k)
        jring = jevents.ring_step(jring, t, jnp.asarray(launch),
                                  jnp.asarray(k))
        np.testing.assert_array_equal(ring, np.asarray(jring))
        for u in range(t, t + 4):
            np.testing.assert_array_equal(
                events.due_mask(ring, u), np.asarray(jevents.due_mask(
                    jring, u)))
    assert ring.dtype == np.int32


def test_ring_too_shallow_is_rejected():
    with pytest.raises(ValueError, match="max_delay") as got:
        PROTOCOLS["async_periodic"].with_params(payload_bytes=100_000_000)
    with pytest.raises(ValueError) as want:
        JPROTOCOLS["async_periodic"].with_params(payload_bytes=100_000_000)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# asyncify
# ---------------------------------------------------------------------------

REWRITES = [   # (preset, params, AsyncConfig kwargs)
    ("periodic", dict(b=3), {}),
    ("dynamic", dict(delta=0.2), dict(payload_bytes=64)),
    ("stale", dict(tau=3), {}),
    ("nosync", {}, {}),
    ("fedavg", dict(b=2), dict(round_budget=0.5, max_delay=4)),
    ("periodic", {}, dict(aircomp=True, snr_db=10, air_seed=3)),
]


@pytest.mark.parametrize("preset,params,kw", REWRITES)
def test_asyncify_writes_the_reference_spec(preset, params, kw):
    net, jnet = NetworkConfig(**LTE_EDGE), JNetworkConfig(**LTE_EDGE)
    got = asyncify(PROTOCOLS[preset].with_params(**params), AsyncConfig(**kw),
                   net, model_bytes=100_000)
    want = jasyncify(JPROTOCOLS[preset].with_params(**params),
                     JAsyncConfig(**kw), jnet, model_bytes=100_000)
    assert got.to_json() == want.to_json()
    assert got.extra_state == want.extra_state


def test_asyncify_aircomp_needs_mean_average():
    with pytest.raises(ValueError, match="over-the-air"):
        asyncify(PROTOCOLS["gossip"], AsyncConfig(aircomp=True),
                 NetworkConfig(), model_bytes=8)


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------

def _batches(m, rounds, seed=0):
    streams = JStreams(JGraphical(seed=seed, drift_prob=0.0), m, batch=10,
                       seed=seed)
    return jax.tree.map(np.asarray, streams.next_chunk(rounds))


def _init():
    cfg = jget_arch("drift_mlp", smoke=True)
    return jax.tree.map(np.asarray, jinit(cfg, jax.random.split(
        jax.random.PRNGKey(0), 3)[0]))


def port_run(proto, m, batches, net=None, async_net=None, init=None):
    cfg = get_arch("drift_mlp", smoke=True)
    init = _init() if init is None else init
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: params_from_numpy(init, device="cpu"), m, proto,
        TrainConfig(**SGD), network=None if net is None else
        NetworkConfig(**net), async_net=async_net, device="cpu")
    metrics = dl.run_chunk({k: torch.from_numpy(v.copy())
                            for k, v in batches.items()})
    return dl, metrics


def ref_run(proto, m, batches, net=None, async_net=None):
    cfg = jget_arch("drift_mlp", smoke=True)
    dl = JLearner(lambda p, b: jcnn_loss(cfg, p, b), lambda k: jinit(cfg, k),
                  m, proto, JTrainConfig(**SGD),
                  network=None if net is None else JNetworkConfig(**net),
                  async_net=async_net)
    return dl, dl.run_chunk(batches)


def fingerprint(dl):
    return (dict(dl.comm_totals), dl.per_link_bytes().tolist(),
            dl.network_time, dl.X.numpy().tobytes())


def assert_matches_reference(dl, metrics, ref, ref_metrics, timeline=True):
    """Comm, ledger, link counts exact; with ``timeline`` (the reference
    ran the same timeline) every round's in-flight count and oldest age
    too; network time within rtol 1e-6, parameters within TOL."""
    assert dl.comm_totals == {k: int(v) for k, v in ref.comm_totals.items()}
    np.testing.assert_array_equal(dl.link_xfer_totals, ref.link_xfer_totals)
    np.testing.assert_array_equal(dl.per_link_bytes(), ref.per_link_bytes())
    np.testing.assert_array_equal(metrics.link_counts,
                                  np.asarray(ref_metrics.link_counts))
    if timeline:
        np.testing.assert_array_equal(metrics.num_inflight,
                                      np.asarray(ref_metrics.num_inflight))
        np.testing.assert_array_equal(metrics.max_age,
                                      np.asarray(ref_metrics.max_age))
    np.testing.assert_allclose(metrics.net_time,
                               np.asarray(ref_metrics.net_time), rtol=1e-6)
    np.testing.assert_allclose(dl.network_time, ref.network_time, rtol=1e-6)
    want = np.asarray(jfleet_adapter(ref.params).ravel(ref.params))
    np.testing.assert_allclose(dl.X.numpy(), want, **TOL)


BASE_SPECS = {
    "periodic": dict(kind="periodic", b=2),
    "continuous": dict(kind="continuous", b=1),
    "fedavg": dict(kind="fedavg", b=2),
    "gossip": dict(kind="gossip", b=2),
    "dynamic": dict(kind="dynamic", b=1, delta=0.05),
    "nosync": dict(kind="nosync"),
    "stale": dict(kind="stale"),
}
LOSSY = dict(link_classes=("wired", "wifi"), act_prob=0.8, seed=3)
ZERO_DELAY = dict(round_budget=60.0)


@pytest.mark.parametrize("name", list(BASE_SPECS))
def test_zero_delay_matrix_bitwise(name):
    """A budget covering every round trip changes nothing: in the port
    the async run is its synchronous run bit for bit on both layouts;
    the flat one matches the reference's synchronous run."""
    m, batches = 4, _batches(4, 8)
    for layout in ("tree", "flat"):
        proto = ProtocolConfig(layout=layout, **BASE_SPECS[name])
        sync, sm = port_run(proto, m, batches, LOSSY)
        asy, am = port_run(proto, m, batches, LOSSY,
                           AsyncConfig(**ZERO_DELAY))
        assert fingerprint(asy) == fingerprint(sync), layout
        np.testing.assert_array_equal(am.link_counts, sm.link_counts)
    ref, rm = ref_run(JProtocolConfig(layout="flat", **BASE_SPECS[name]), m,
                      batches, LOSSY)
    assert_matches_reference(asy, am, ref, rm, timeline=False)


@pytest.mark.parametrize("seed,act,straggler", [(0, 0.3, 0.5), (11, 0.6, 0.0),
                                                (977, 0.9, 0.25)])
def test_zero_delay_random_availability(seed, act, straggler):
    net = dict(link_classes=("wired", "wifi"), act_prob=act,
               straggler_frac=straggler, seed=seed)
    batches = _batches(3, 6, seed)
    for name in ("fedavg", "dynamic", "stale"):
        proto = ProtocolConfig(**BASE_SPECS[name])
        sync, _ = port_run(proto, 3, batches, net)
        asy, _ = port_run(proto, 3, batches, net, AsyncConfig(**ZERO_DELAY))
        assert fingerprint(asy) == fingerprint(sync), name


def test_inflight_alternates_on_edge_links():
    """async_periodic at the 1 s budget: the edge exchanges fly one
    round, so both edge links are in flight after odd rounds."""
    batches = _batches(4, 6)
    dl, metrics = port_run(PROTOCOLS["async_periodic"], 4, batches)
    assert metrics.num_inflight.tolist() == [2, 0, 2, 0, 2, 0]
    assert metrics.max_age.tolist() == [0] * 6
    assert dl.comm_totals["syncs"] == 6
    assert sorted(dl.sync_state.extra) == ["age", "inflight", "lclock",
                                           "ring"]
    assert all(v.dtype == np.int32 for v in dl.sync_state.extra.values())
    ref, rm = ref_run(JPROTOCOLS["async_periodic"], 4, batches)
    assert_matches_reference(dl, metrics, ref, rm)


def test_quiet_timeline_ages_grow(monkeypatch):
    """Nothing crosses Delta: ages grow one a round, nothing flies, and
    the monitoring pass runs only on the rounds whose gate fires."""
    calls = []
    dists = stages.per_learner_sq_distance_flat
    monkeypatch.setattr(stages, "per_learner_sq_distance_flat",
                        lambda *a: calls.append(1) or dists(*a))
    dl, metrics = port_run(
        PROTOCOLS["async_dynamic"].with_params(delta=1e9, b=2), 4,
        _batches(4, 5))
    assert metrics.max_age.tolist() == [1, 2, 3, 4, 5]
    assert metrics.num_inflight.tolist() == [0] * 5
    assert dl.comm_totals["syncs"] == 0
    assert metrics.checked.tolist() == [False, True, False, True, False]
    assert len(calls) == 2


def test_nonzero_delay_ledger_stays_exact():
    net = dict(LTE_EDGE)
    dl, metrics = port_run(ProtocolConfig(kind="periodic", b=2), 4,
                           _batches(4, 10), net,
                           AsyncConfig(round_budget=1.0,
                                       payload_bytes=100_000))
    xfers = metrics.link_counts[..., 0].astype(np.int64)
    msgs = metrics.link_counts[..., 1].astype(np.int64)
    want = (xfers * dl.model_bytes).sum(axis=0)
    got = dl.per_link_bytes() - msgs.sum(axis=0) * 64
    assert got.tolist() == want.tolist()
    assert metrics.num_inflight.max() > 0


def test_aircomp_prices_one_shared_medium_exchange():
    dl, _ = port_run(PROTOCOLS["aircomp"], 4, _batches(4, 5))
    assert dl.comm_totals == {"model_up": 5, "model_down": 5, "messages": 0,
                              "syncs": 5, "full_syncs": 5}
    assert dl.comm_bytes() == 5 * 2 * dl.model_bytes
    assert dl.link_xfer_totals.tolist() == [5, 5, 5, 5]
    assert int(dl.per_link_bytes().sum()) == 4 * 5 * dl.model_bytes


def test_aircomp_noise_is_pure_and_vanishes_with_snr():
    batches = _batches(4, 8)

    def run(spec):
        return port_run(spec, 4, batches)[0]

    a, b = run(PROTOCOLS["aircomp"]), run(PROTOCOLS["aircomp"])
    assert torch.equal(a.X, b.X)                       # pure in (seed, t)
    assert not torch.equal(
        run(PROTOCOLS["aircomp"].with_params(air_seed=7)).X, a.X)
    clean = run(ProtocolConfig(kind="periodic", b=1))
    quiet = run(PROTOCOLS["aircomp"].with_params(snr_db=200.0))
    loud = run(PROTOCOLS["aircomp"].with_params(snr_db=0.0))

    def dist(x, y):
        return float(((x.X - y.X) ** 2).sum())

    assert dist(quiet, clean) <= 1e-8
    assert dist(loud, clean) > dist(quiet, clean)


# the presets of benchmarks/async_bench.py: m = 8 on lte/edge links
BENCH = {   # name -> (protocol kwargs, AsyncConfig kwargs)
    "async_periodic_mild": (dict(kind="periodic", b=2),
                            dict(round_budget=1.0, payload_bytes=100_000)),
    "async_dynamic_harsh": (dict(kind="dynamic", b=2, delta=0.5),
                            dict(round_budget=0.25, payload_bytes=100_000)),
    "async_dynamic_preset": ("async_dynamic", None),
    "aircomp_snr20": (dict(kind="periodic", b=2),
                      dict(round_budget=60.0, aircomp=True, snr_db=20.0)),
    "aircomp_tree_lossy": (dict(kind="periodic", b=2, layout="tree"),
                           dict(round_budget=60.0, aircomp=True,
                                snr_db=0.0)),
}


@pytest.mark.parametrize("case", list(BENCH))
def test_bench_presets_match_reference(case, monkeypatch):
    proto_kw, an = BENCH[case]
    net = LTE_EDGE if "lossy" not in case else dict(LTE_EDGE, act_prob=0.7)
    batches = _batches(8, 48)
    seen = []
    dists = stages.per_learner_sq_distance_flat
    monkeypatch.setattr(stages, "per_learner_sq_distance_flat",
                        lambda *a: seen.extend(dists(*a).tolist())
                        or dists(*a))
    if isinstance(proto_kw, str):
        tproto, jproto = PROTOCOLS[proto_kw], JPROTOCOLS[proto_kw]
        tan = jan = None
    else:
        kw = {"layout": "flat", **proto_kw}
        tproto, jproto = ProtocolConfig(**kw), JProtocolConfig(**kw)
        tan, jan = AsyncConfig(**an), JAsyncConfig(**an)
    ref, rm = ref_run(jproto, 8, batches, net, jan)
    dl, metrics = port_run(tproto, 8, batches, net, tan)
    delta = dl.spec.resolved_params().get("delta")
    if delta is not None:
        assert seen and all(abs(d - delta) > 1e-4 * delta for d in seen)
    assert_matches_reference(dl, metrics, ref, rm)
    assert dl.comm_totals["syncs"] > 0


def test_async_under_a_hierarchy_matches_reference():
    """The intra tier runs the asyncified spec, the inter tier stays
    synchronous; the per-cluster timelines are the batched extra state."""
    def proto(P, H):
        return P(kind="dynamic", b=2, delta=0.3, layout="flat",
                 tiers=H(num_clusters=2, inter=P(kind="periodic", b=4,
                                                 layout="flat")))
    net = dict(link_classes=("wifi", "lte"))
    an = dict(payload_bytes=10_000_000, max_delay=8)
    batches = _batches(6, 24)
    ref, rm = ref_run(proto(JProtocolConfig, JHierarchyConfig), 6, batches,
                      net, JAsyncConfig(**an))
    dl, metrics = port_run(proto(ProtocolConfig, HierarchyConfig), 6,
                           batches, net, AsyncConfig(**an))
    assert dl.spec.trigger == "events_divergence"
    assert dl.sync_state.intra.extra["ring"].shape == (2, 3, 8)
    assert dl.sync_state.inter.extra == {}
    assert_matches_reference(dl, metrics, ref, rm)
    assert metrics.num_inflight.max() > 0
