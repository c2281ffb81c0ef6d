"""The port's two-tier hierarchy against the reference's, on the CPU.

Operator level: the cases of tests/test_sync_kernel.py's hierarchy
section (config validation, continuous == flat, an inter-tier nosync,
Algorithm-2 weights flowing up, mean invariance, unreachable members and
a dark cluster), each run through both packages'
``apply_hierarchical`` on the same stacked models (drawn with numpy):
every per-link count and the CommRecord exact, parameters within atol /
rtol 1e-5, plus the reference test's own claim. Engine level: the
reference's hierarchy sweep settings (benchmarks/fig_hierarchy.py:
drift MLP, m = 12, g in {3, 4}, intra dynamic b = 2 Delta = 0.3, inter
Delta in {0.3, 0.6}), inside a ring at 60% availability, on the tree
layout, weighted, with bounded staleness as the intra tier, and the
ledger cases (a scanned two-tier run, the ideal network, a quantized
backhaul), against the reference's live runs: ``comm_totals``,
``link_xfer_totals``, the (m + g)-row ledger and every round's link
counts exact, ``network_time`` within rtol 1e-6, parameters within atol
/ rtol 1e-5, after checking that no distance the port compared with a
Delta lies within 1e-4 * Delta of it. The grouped plain ``sqdist_rows``
is held to the reference's ``jax.vmap(ops.sqdist_rows)`` (Pallas in
interpret mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import HierarchyConfig as JHierarchyConfig  # noqa: E402
from repro.config import NetworkConfig as JNetworkConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.divergence import tree_mean as jtree_mean  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.core.sync import hierarchy as jhier  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro_torch.config import (  # noqa: E402
    HierarchyConfig, NetworkConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.flatten import fleet_adapter  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.core.sync import hierarchy, stages  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.cnn import cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.train.loop import run_protocol_training  # noqa: E402

SGD = dict(optimizer="sgd", learning_rate=0.05)
RING = dict(act_prob=0.6, topology="ring", link_classes=("wifi", "lte"))
TOL = dict(rtol=1e-5, atol=1e-5)


def _tiers(pkg, g, inter, link_class="wired"):
    P, H = ((JProtocolConfig, JHierarchyConfig) if pkg == "ref"
            else (ProtocolConfig, HierarchyConfig))
    return H(num_clusters=g, inter=P(layout="flat", **inter),
             link_class=link_class)


def _proto(pkg, intra, g, inter, layout="flat", link_class="wired"):
    P = JProtocolConfig if pkg == "ref" else ProtocolConfig
    return P(layout=layout, tiers=_tiers(pkg, g, inter, link_class), **intra)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

BAD_TIERS = {
    "one cluster": lambda P, H: H(num_clusters=1, inter=P(kind="periodic")),
    "gossip inter": lambda P, H: H(num_clusters=4, inter=P(kind="gossip")),
    "nested": lambda P, H: H(num_clusters=4, inter=P(
        kind="periodic", tiers=H(num_clusters=2, inter=P(kind="periodic")))),
    "unknown uplink": lambda P, H: H(num_clusters=4,
                                     inter=P(kind="periodic"),
                                     link_class="quantum-entanglement"),
    "gossip intra": lambda P, H: P(kind="gossip", tiers=H(
        num_clusters=2, inter=P(kind="periodic"))),
}


@pytest.mark.parametrize("case", list(BAD_TIERS))
def test_hierarchy_config_validation_matches_reference(case):
    build = BAD_TIERS[case]
    with pytest.raises((ValueError, KeyError)) as want:
        build(JProtocolConfig, JHierarchyConfig)
    with pytest.raises(want.type) as got:
        build(ProtocolConfig, HierarchyConfig)
    assert str(got.value) == str(want.value)


def test_fleet_that_does_not_partition_fails_at_construction():
    cfg = get_arch("drift_mlp", smoke=True)
    with pytest.raises(ValueError, match="m % g == 1"):
        DecentralizedLearner(
            lambda p, b: cnn_loss(cfg, p, b),
            lambda g: init_cnn_params(cfg, g), 7,
            _proto("port", dict(kind="dynamic", b=2), 3,
                   dict(kind="periodic", b=5)),
            device="cpu")


# ---------------------------------------------------------------------------
# the operator: one round through both packages
# ---------------------------------------------------------------------------

def _stacked(m, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w0": rng.standard_normal((m, 4, 3), dtype=np.float32) * scale,
            "w1": rng.standard_normal((m, 7), dtype=np.float32) * scale}


def _one_round(intra, inter, g, stacked, active=None, weights=None):
    """Both packages' apply_hierarchical on the same fleet; returns the
    two results and the port's input plane."""
    jstk = jax.tree.map(jnp.asarray, stacked)
    jcfg = _proto("ref", intra, g, inter)
    want = jax.jit(jhier.apply_hierarchical, static_argnums=(0, 1))(
        jcfg, jcfg.tiers, jstk,
        jhier.init_hier_state(jtree_mean(jstk), jcfg.tiers, 0),
        weights=None if weights is None else jnp.asarray(weights),
        active=None if active is None else jnp.asarray(active))
    tstk = params_from_numpy(stacked, device="cpu")
    adapter = fleet_adapter({k: v[0] for k, v in tstk.items()})
    X = adapter.ravel(tstk)
    cfg = _proto("port", intra, g, inter)
    got = hierarchy.apply_hierarchical(
        cfg, cfg.tiers, X.clone(),
        hierarchy.init_hier_state(X.mean(dim=0), cfg.tiers, 0),
        weights=(None if weights is None
                 else torch.tensor(weights, dtype=torch.float32)),
        active=None if active is None else np.asarray(active))
    for a, b in [(got.member_xfers, want.member_xfers),
                 (got.member_msgs, want.member_msgs),
                 (got.agg_xfers, want.agg_xfers),
                 (got.agg_msgs, want.agg_msgs)]:
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.rec == tuple(int(x) for x in want.rec)
    plane = np.asarray(jfleet_adapter(want.params).ravel(want.params))
    np.testing.assert_allclose(got.params.numpy(), plane, **TOL)
    return got, want, X


PERIODIC1 = dict(kind="periodic", b=1)


def test_hierarchical_continuous_equals_flat_continuous():
    """Periodic b = 1 at both tiers on an ideal network is the global
    mean everywhere; member links carry 2 intra transfers and 1
    down-push, uplinks 2."""
    stacked = _stacked(8, 1, scale=2.0)
    got, _, X = _one_round(PERIODIC1, PERIODIC1, 4, stacked)
    np.testing.assert_allclose(got.params.numpy(),
                               X.mean(dim=0).expand_as(X).numpy(), **TOL)
    assert (got.member_xfers == 3).all() and (got.agg_xfers == 2).all()
    assert got.rec.full_syncs == 1


def test_hierarchy_inter_nosync_keeps_clusters_independent():
    stacked = _stacked(6, 2)
    got, _, X = _one_round(PERIODIC1, dict(kind="nosync"), 2, stacked)
    for c in range(2):
        rows = slice(3 * c, 3 * c + 3)
        np.testing.assert_allclose(
            got.params[rows].numpy(),
            X[rows].mean(dim=0).expand(3, -1).numpy(), **TOL)
    assert (got.agg_xfers == 0).all() and (got.member_xfers == 2).all()


def test_weighted_hierarchy_reaches_weighted_global_mean():
    """Algorithm-2 mass flows up: the inter tier weights aggregators by
    their cluster's total B^i, whatever ``tiers.inter.weighted`` says."""
    stacked = _stacked(6, 9)
    w = [1.0, 1.0, 1.0, 3.0, 3.0, 3.0]
    got, _, X = _one_round(dict(PERIODIC1, weighted=True), PERIODIC1, 2,
                           stacked, weights=w)
    want = torch.tensor(w) @ X / sum(w)
    np.testing.assert_allclose(got.params.numpy(),
                               want.expand_as(X).numpy(), **TOL)


def test_hierarchy_mean_invariance_full_participation():
    dyn = dict(kind="dynamic", b=1, delta=1e-6)
    got, _, X = _one_round(dyn, dyn, 2, _stacked(8, 3, scale=3.0))
    np.testing.assert_allclose(got.params.mean(dim=0).numpy(),
                               X.mean(dim=0).numpy(), rtol=1e-4, atol=1e-5)


def test_hierarchy_inactive_members_untouched():
    active = [True, False, True, True, True, True, False, True]
    got, _, X = _one_round(PERIODIC1, PERIODIC1, 2, _stacked(8, 4, 2.0),
                           active=active)
    dark = ~np.asarray(active)
    assert torch.equal(got.params[torch.from_numpy(dark)],
                       X[torch.from_numpy(dark)])
    assert (got.member_xfers[dark] == 0).all()
    assert (got.member_msgs[dark] == 0).all()


def test_hierarchy_dark_cluster_is_unreachable_upstream():
    got, _, _ = _one_round(PERIODIC1, PERIODIC1, 3, _stacked(6, 5),
                           active=[True, True, False, False, True, True])
    assert got.agg_xfers[1] == 0
    assert got.agg_xfers[0] > 0 and got.agg_xfers[2] > 0
    assert torch.isfinite(got.params).all()


def test_grouped_sqdist_rows_matches_vmapped_pallas():
    """The hierarchy's one grouped pass: every row against its cluster's
    reference, as the reference's ``jax.vmap(ops.sqdist_rows)`` over the
    clusters computes it (Pallas in interpret mode, small blocks)."""
    rng = np.random.default_rng(7)
    for g, k, n in [(3, 4, 515), (10, 2, 1_003), (1, 5, 256)]:
        X = rng.standard_normal((g * k, n), dtype=np.float32)
        R = rng.standard_normal((g, n), dtype=np.float32)
        want = jax.vmap(lambda x, r: jops.sqdist_rows(
            x, r, block_m=4, block=256))(jnp.asarray(X.reshape(g, k, n)),
                                         jnp.asarray(R))
        got = ops.sqdist_rows(torch.from_numpy(X), torch.from_numpy(R))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).reshape(-1),
                                   rtol=1e-5, atol=1e-6)
        one = ops.sqdist_rows(torch.from_numpy(X), torch.from_numpy(R[0]))
        assert torch.equal(
            ops.sqdist_rows(torch.from_numpy(X), torch.from_numpy(R[:1])),
            one)


# ---------------------------------------------------------------------------
# the engine against the reference's live runs
# ---------------------------------------------------------------------------

def _watch_distances(monkeypatch):
    """Record every distance the port compares with a Delta: the grouped
    and flat monitoring passes and the augmentation's safe-zone tests."""
    seen = []
    flat = stages.per_learner_sq_distance_flat
    grouped = hierarchy.per_learner_sq_distance_flat
    safe = stages._safe_dist
    monkeypatch.setattr(stages, "per_learner_sq_distance_flat",
                        lambda *a: seen.extend(flat(*a).tolist())
                        or flat(*a))
    monkeypatch.setattr(hierarchy, "per_learner_sq_distance_flat",
                        lambda *a: seen.extend(grouped(*a).tolist())
                        or grouped(*a))
    monkeypatch.setattr(stages, "_safe_dist",
                        lambda *a: seen.append(safe(*a)) or safe(*a))
    return seen


def run_live(jproto, tproto, m, rounds=40, net=None, weights=None,
             chunks=None):
    """The reference's live run and the port's from its initial model and
    batches (drift MLP, sgd lr 0.05, the sweep's stream seed 1)."""
    cfg = jget_arch("drift_mlp", smoke=True)
    streams = JStreams(JGraphical(seed=1, drift_prob=0.0), m, batch=10,
                       seed=0, batch_sizes=weights)
    ref = JLearner(lambda p, b: jcnn_loss(cfg, p, b),
                   lambda k: jinit(cfg, k), m, jproto, JTrainConfig(**SGD),
                   sample_weights=streams.weights,
                   network=None if net is None else JNetworkConfig(**net))
    init = jax.tree.map(np.asarray, ref.learner_model(0))
    batches = jax.tree.map(np.asarray, streams.next_chunk(rounds))
    ref_metrics = ref.run_chunk(batches)
    tcfg = get_arch("drift_mlp", smoke=True)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(tcfg, p, b),
        lambda g: params_from_numpy(init, device="cpu"), m, tproto,
        TrainConfig(**SGD),
        sample_weights=(None if weights is None
                        else torch.tensor(weights, dtype=torch.float32)),
        network=None if net is None else NetworkConfig(**net), device="cpu")
    cuts = [0] + list(chunks or [rounds])
    metrics = [dl.run_chunk({k: torch.from_numpy(v[a:b].copy())
                             for k, v in batches.items()})
               for a, b in zip(cuts, cuts[1:])]
    return ref, ref_metrics, dl, metrics


def assert_same_run(ref, ref_metrics, dl, metrics):
    assert dl.comm_totals == {k: int(v) for k, v in ref.comm_totals.items()}
    np.testing.assert_array_equal(dl.link_xfer_totals, ref.link_xfer_totals)
    np.testing.assert_array_equal(dl.per_link_bytes(), ref.per_link_bytes())
    assert dl.comm_bytes() == ref.comm_bytes()
    assert dl.link_class_names() == ref.link_class_names()
    counts = np.concatenate([m.link_counts for m in metrics])
    np.testing.assert_array_equal(counts,
                                  np.asarray(ref_metrics.link_counts))
    np.testing.assert_array_equal(
        np.concatenate([m.num_inflight for m in metrics]),
        np.asarray(ref_metrics.num_inflight))
    np.testing.assert_allclose(
        np.concatenate([m.net_time for m in metrics]),
        np.asarray(ref_metrics.net_time), rtol=1e-6)
    np.testing.assert_allclose(dl.network_time, ref.network_time, rtol=1e-6)
    np.testing.assert_allclose(dl.cumulative_loss, ref.cumulative_loss,
                               rtol=1e-5)
    want = np.asarray(jfleet_adapter(ref.params).ravel(ref.params))
    np.testing.assert_allclose(dl.X.numpy(), want, **TOL)


def _deltas_clear(seen, *deltas):
    assert seen
    for d in seen:
        assert all(abs(d - D) > 1e-4 * D for D in deltas), d


DYN = dict(kind="dynamic", b=2, delta=0.3)
SWEEP = {   # name -> (g, inter delta, network, layout, weights)
    "g3_inter0.3": (3, 0.3, None, "flat", None),
    "g4_inter0.6": (4, 0.6, None, "flat", None),
    "g3_inter0.6_ring": (3, 0.6, RING, "flat", None),
    "g4_inter0.3_ring_tree": (4, 0.3, RING, "tree", None),
    "g3_inter0.3_weighted": (3, 0.3, RING, "flat",
                             [5, 10, 15, 10, 5, 15] * 2),
}


@pytest.mark.parametrize("case", list(SWEEP))
def test_sweep_run_matches_reference(case, monkeypatch):
    g, inter_delta, net, layout, weights = SWEEP[case]
    intra = dict(DYN, weighted=weights is not None)
    inter = dict(kind="dynamic", b=2, delta=inter_delta)
    seen = _watch_distances(monkeypatch)
    ref, rm, dl, metrics = run_live(
        _proto("ref", intra, g, inter, layout),
        _proto("port", intra, g, inter, layout), 12, net=net,
        weights=weights, chunks=[16, 40])
    _deltas_clear(seen, 0.3, inter_delta)
    assert_same_run(ref, rm, dl, metrics)
    assert dl.per_link_bytes().shape == (12 + g,)
    assert int(dl.per_link_bytes().sum()) == dl.comm_bytes()
    assert dl.comm_totals["syncs"] > 0 and dl.per_link_bytes()[12:].sum() > 0
    assert dl.sync_state.intra.ref.shape == (g, dl.model_size)


LEDGER = {   # the engine cases of tests/test_sync_kernel.py
    "two_tier_dynamic_scanned": (
        6, DYN, dict(kind="dynamic", b=4, delta=0.6), 3,
        dict(act_prob=0.8, link_classes=("wifi", "lte")), 40),
    "ideal_network": (6, dict(kind="periodic", b=3),
                      dict(kind="periodic", b=6), 2, None, 24),
    "quantized_backhaul": (4, dict(kind="periodic", b=2),
                           dict(kind="periodic", b=2, bytes_per_param=1), 2,
                           None, 8),
    "stale_intra": (6, dict(kind="stale", b=1), dict(kind="periodic", b=4),
                    2, None, 16),
}


@pytest.mark.parametrize("case", list(LEDGER))
def test_ledger_cases_match_reference(case, monkeypatch):
    m, intra, inter, g, net, rounds = LEDGER[case]
    seen = _watch_distances(monkeypatch)
    ref, rm, dl, metrics = run_live(_proto("ref", intra, g, inter),
                                    _proto("port", intra, g, inter), m,
                                    rounds=rounds, net=net)
    if "delta" in intra:
        _deltas_clear(seen, intra["delta"], inter["delta"])
    assert_same_run(ref, rm, dl, metrics)
    # the ledger balances: per-link sums are the global byte total
    assert int(dl.per_link_bytes().sum()) == dl.comm_bytes()
    assert dl.num_links == m + g
    if case == "quantized_backhaul":
        assert dl.inter_model_bytes * 4 == dl.model_bytes
        agg = dl.per_link_bytes()[m:]
        assert agg.sum() == metrics[0].link_counts[:, m:, 0].sum() \
            * dl.inter_model_bytes > 0
    if case == "stale_intra":
        # per-cluster staleness counters ride the batched intra state
        assert dl.sync_state.intra.extra["staleness"].shape == (2, 3)


def test_ledger_survives_billion_byte_payloads():
    """Pricing is host int64: a payload past int32 never wraps."""
    cfg = get_arch("drift_mlp", smoke=True)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        4, ProtocolConfig(kind="periodic", b=1,
                          bytes_per_param=200_000_000),
        TrainConfig(**SGD), device="cpu")
    src_batches = JStreams(JGraphical(seed=0, drift_prob=0.0), 4, batch=10,
                           seed=0).next_chunk(2)
    dl.run_chunk({k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in src_batches.items()})
    assert dl.model_bytes > 2**31
    assert (dl.per_link_bytes() == 4 * dl.model_bytes).all()
    assert int(dl.per_link_bytes().sum()) == dl.comm_bytes()


def test_training_loop_prices_the_trajectory_per_tier():
    """run_protocol_training under a hierarchy: the byte curve is the
    ledger's, and its last point is comm_bytes()."""
    from repro_torch.data.synthetic import GraphicalModelStream
    cfg = get_arch("drift_mlp", smoke=True)
    proto = _proto("port", dict(kind="periodic", b=2), 2,
                   dict(kind="periodic", b=4, bytes_per_param=1))
    dl, traj = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b), lambda g: init_cnn_params(cfg, g),
        GraphicalModelStream(seed=0, drift_prob=0.0, device="cpu"), m=4,
        rounds=12, protocol=proto, train=TrainConfig(**SGD), chunk_size=5,
        record_every=4, network=NetworkConfig(link_classes=("lte",)),
        device="cpu")
    assert traj.rounds == [4, 8, 12]
    assert traj.cumulative_bytes[-1] == dl.comm_bytes() \
        == int(dl.per_link_bytes().sum())
    assert traj.cumulative_bytes[-1] != dl.comm_bytes_of(dl.comm_totals)
    assert traj.network_time[-1] == pytest.approx(dl.network_time)
