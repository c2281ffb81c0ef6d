"""The port's network environment against the reference's, module by
module, on the CPU.

Bit for bit: ``NetworkConfig`` (fields, defaults, errors), the
availability masks (dropout, stragglers, outages) over more than 200
(seed, t) pairs each, all five adjacencies (the mobile geometric one
across redraw windows, against the reference's jitted builder, which
is how its scanned round evaluates it), the squared distances behind
the geometric edge test in both of the reference's roundings, the link
profiles and per-round network times, the masked FedAvg cohort and
gossip's active overlay. Gossip's f32 mixing matrix within 1e-7 (its
diagonal is one minus a row sum, summed in another order).

Then one availability-masked sync round of every preset on the plane
against the reference's ``apply_staged`` with ``layout="flat"``: the
plane and reference to atol 1e-6, the violation counter, the key, the
staleness counters, the ``CommRecord`` and the per-link counts exactly,
including an all-dark and a single-reachable fleet. Last, a ``slow``
smoke run of examples/torch_network_regimes.py on the CPU.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.core import flatten as jflatten  # noqa: E402
from repro.core.sync import kernel as jkernel  # noqa: E402
from repro.core.sync import stages as jstages  # noqa: E402
from repro.core.sync.registry import SyncState as JSyncState  # noqa: E402
from repro.core.sync.spec import ProtocolSpec as JProtocolSpec  # noqa: E402
from repro.network import availability as javail  # noqa: E402
from repro.network import cost as jcost  # noqa: E402
from repro.network import topology as jtopo  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.sync import kernel, stages  # noqa: E402
from repro_torch.core.sync.registry import SyncState  # noqa: E402
from repro_torch.core.sync.spec import ProtocolSpec  # noqa: E402
from repro_torch.network import availability, cost, topology  # noqa: E402

AVAIL = {
    "dropout": dict(act_prob=0.6),
    "stragglers": dict(act_prob=0.9, straggler_frac=0.25,
                       straggler_act_prob=0.3),
    "outages": dict(outage_every=10, outage_length=3, outage_frac=0.5),
    "all_three": dict(act_prob=0.8, straggler_frac=0.3, outage_every=7,
                      outage_length=2),
}


def test_config_fields_and_constants_match_reference():
    for name in ("TOPO_STAR", "TOPO_RING", "TOPO_TORUS", "TOPO_ERDOS_RENYI",
                 "TOPO_GEOMETRIC", "TOPOLOGIES", "LINK_CLASS_NAMES"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    import dataclasses
    want = [(f.name, f.default) for f in
            dataclasses.fields(jconfig.NetworkConfig)]
    got = [(f.name, f.default) for f in
           dataclasses.fields(tconfig.NetworkConfig)]
    assert got == want
    for kw in ({}, dict(act_prob=0.5), dict(straggler_frac=0.1),
               dict(outage_every=4)):
        assert (tconfig.NetworkConfig(**kw).full_availability
                == jconfig.NetworkConfig(**kw).full_availability)


BAD_NETWORKS = [
    dict(topology="mesh"), dict(er_p=1.5), dict(geo_radius=0.0),
    dict(redraw_every=-1), dict(topology="ring", redraw_every=3),
    dict(act_prob=0.0), dict(act_prob=1.2), dict(straggler_frac=-0.1),
    dict(straggler_act_prob=0.0), dict(outage_every=-2),
    dict(outage_length=0), dict(outage_every=3, outage_length=4),
    dict(outage_frac=2.0), dict(link_classes=()),
    dict(link_classes=("wifi", "5g")),
]


@pytest.mark.parametrize("kw", BAD_NETWORKS,
                         ids=[str(sorted(k.items())) for k in BAD_NETWORKS])
def test_network_validation_matches_reference(kw):
    with pytest.raises((ValueError, KeyError)) as want:
        jconfig.NetworkConfig(**kw)
    with pytest.raises(want.type) as got:
        tconfig.NetworkConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", list(AVAIL))
def test_availability_masks_are_the_reference_bit_for_bit(case):
    """Four seeds × 60 rounds = 240 (seed, t) pairs per failure mode (at
    m = 100, and at m = 6 for one seed), each seed's drawn as one batch."""
    ts = np.arange(60)
    for seed, m in ((0, 100), (1, 6), (7, 100), (2024, 100)):
        jnet = jconfig.NetworkConfig(seed=seed, **AVAIL[case])
        tnet = tconfig.NetworkConfig(seed=seed, **AVAIL[case])
        want = np.asarray(jax.jit(jax.vmap(
            lambda t: javail.sample(jnet, m, t)))(jnp.asarray(ts)))
        got = availability.sample_rounds(tnet, m, ts)
        assert got.dtype == bool and got.shape == (60, m)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            availability.straggler_mask(tnet, m),
            np.asarray(javail.straggler_mask(jnet, m)))
        # one round alone, as the reference's eager call gives it
        np.testing.assert_array_equal(availability.sample(tnet, m, 13),
                                      np.asarray(javail.sample(jnet, m, 13)))


def test_masks_vary_and_outages_darken_their_windows():
    net = tconfig.NetworkConfig(outage_every=10, outage_length=3,
                                outage_frac=0.5)
    masks = availability.sample_rounds(net, 20, range(30))
    for t in range(30):
        dark = int((~masks[t]).sum())
        assert dark == (10 if t % 10 < 3 else 0)
    drop = availability.sample_rounds(tconfig.NetworkConfig(act_prob=0.5),
                                      100, range(5))
    assert 30 < drop.sum(axis=1).min() and drop.sum(axis=1).max() < 70
    assert len({m.tobytes() for m in drop}) == 5


@pytest.mark.parametrize("topo", list(tconfig.TOPOLOGIES))
def test_static_adjacencies_are_the_reference_bit_for_bit(topo):
    for seed in (0, 5, 31):
        for m in (2, 6, 12, 97, 100):
            jnet = jconfig.NetworkConfig(topology=topo, seed=seed,
                                         er_p=0.3, geo_radius=0.3)
            tnet = tconfig.NetworkConfig(topology=topo, seed=seed,
                                         er_p=0.3, geo_radius=0.3)
            got = topology.adjacency(tnet, m)
            np.testing.assert_array_equal(
                got, np.asarray(jtopo.adjacency(jnet, m)))
            assert got.dtype == bool and (got == got.T).all()
            assert not got.diagonal().any()
    assert topology._torus_sides(100) == jtopo._torus_sides(100) == (10, 10)
    assert topology._torus_sides(97) == (1, 97)


def test_mobile_geometric_adjacency_across_redraw_windows():
    """Against the reference's builder under jit with a traced round, as
    its scanned round evaluates it."""
    jadj = jax.jit(jtopo.adjacency, static_argnums=(0, 1))
    for seed in (0, 3, 11, 4096):
        for radius, every in ((0.6, 20), (0.25, 7)):
            jnet = jconfig.NetworkConfig(topology="geometric", seed=seed,
                                         geo_radius=radius,
                                         redraw_every=every)
            tnet = tconfig.NetworkConfig(topology="geometric", seed=seed,
                                         geo_radius=radius,
                                         redraw_every=every)
            seen = set()
            for t in (0, every - 1, every, 3 * every + 2, 10 * every):
                got = topology.adjacency(tnet, 100, t)
                np.testing.assert_array_equal(
                    got, np.asarray(jadj(jnet, 100, jnp.int32(t))))
                seen.add(got.tobytes())
            assert len(seen) == 4       # t = every - 1 shares window 0
    assert topology.is_mobile(tnet) and not topology.is_mobile(
        tconfig.NetworkConfig(topology="geometric"))


def test_geometric_distances_round_as_the_reference_does():
    """The reference's ``sum(square(p_i - p_j))`` op by op (eager) is
    ``f32(dx·dx) + f32(dy·dy)``; fused by XLA (jit) it is one multiply-add.
    Every one of the 250,000 squared distances of 500 positions matches
    its form bit for bit, and the two forms differ for many pairs."""
    def d2(p):
        return jnp.sum(jnp.square(p[:, None] - p[None]), axis=-1)

    pos = prng.uniform(prng.key(9, device="cpu"), (500, 2),
                       device="cpu").numpy()
    eager = np.asarray(d2(jnp.asarray(pos)))
    fused = np.asarray(jax.jit(d2)(jnp.asarray(pos)))
    np.testing.assert_array_equal(topology.sq_dists(pos), eager)
    np.testing.assert_array_equal(topology.sq_dists(pos, fused=True), fused)
    assert (eager != fused).sum() > 10_000


@pytest.mark.parametrize("classes", [("wired",), ("wifi", "lte"),
                                     ("edge", "wired", "lte", "wifi")])
def test_link_profile_and_network_time_are_exact(classes):
    jnet = jconfig.NetworkConfig(link_classes=classes)
    tnet = tconfig.NetworkConfig(link_classes=classes)
    jbw, jlat = jcost.link_profile(jnet, 9)
    bw, lat = cost.link_profile(tnet, 9)
    np.testing.assert_array_equal(bw, np.asarray(jbw))
    np.testing.assert_array_equal(lat, np.asarray(jlat))
    assert bw.dtype == lat.dtype == np.float32
    rng = np.random.default_rng(len(classes))
    xfers = rng.integers(0, 5, (30, 9)).astype(np.int32)
    xfers[rng.random((30, 9)) < 0.5] = 0
    msgs = (rng.random((30, 9)) < 0.3).astype(np.int32)
    xfers[0], msgs[0] = 0, 0                     # a silent round: exactly 0
    for model_bytes in (4, 4 * 1_199_882, 123_457):
        got = cost.round_network_time(xfers, msgs, model_bytes, bw, lat)
        assert got.dtype == np.float32 and got[0] == 0.0
        for i in range(30):
            want = jcost.round_network_time(
                jnp.asarray(xfers[i]), jnp.asarray(msgs[i]), model_bytes,
                jbw, jlat)
            assert got[i] == np.float32(want)
    for c in classes:
        ub, ul = cost.uniform_profile(c, 3)
        jb, jl = jcost.uniform_profile(c, 3)
        np.testing.assert_array_equal(ub, np.asarray(jb))
        np.testing.assert_array_equal(ul, np.asarray(jl))
    with pytest.raises(KeyError, match="unknown link class"):
        cost.uniform_profile("5g", 2)
    assert set(cost.LINK_CLASSES) == set(jcost.LINK_CLASSES)
    assert all(tuple(cost.LINK_CLASSES[k]) == tuple(jcost.LINK_CLASSES[k])
               for k in cost.LINK_CLASSES)


def test_fold_in_with_many_values_is_many_fold_ins():
    k = prng.key(77, device="cpu")
    data = [0, 1, 19, 2 ** 31 + 3, 2 ** 32 - 1]
    got = prng.fold_in(k, data, device="cpu").numpy()
    want = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(77),
                                                   d)) for d in data])
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("m,k", [(6, 3), (10, 3), (100, 30), (7, 7)])
def test_masked_fraction_cohort_is_the_reference(m, k):
    """Ranks with stable sorts: ties among the -inf (dark) rows rank by
    index, as ``jnp.argsort``'s."""
    rng = np.random.default_rng(m + k)
    for trial in range(12):
        active = rng.random(m) < (0.6 if trial % 4 else 0.15)
        if trial == 0:
            active[:] = False
        if trial == 1:
            active[:] = True
        sub = jax.random.fold_in(jax.random.PRNGKey(3), trial)
        want = np.asarray(jstages.cohort_fraction_masked(
            sub, m, k, jnp.asarray(active)))
        got = stages.cohort_fraction_masked(
            torch.from_numpy(np.asarray(sub).astype(np.int64)), m, k, active)
        np.testing.assert_array_equal(got, want)
        assert got.sum() == min(k, active.sum()) and not (got & ~active).any()


@pytest.mark.parametrize("topo", ["ring", "star", "geometric", "torus"])
def test_neighborhood_overlay_and_mixing_matrix(topo):
    m = 12
    adj = topology.adjacency(tconfig.NetworkConfig(topology=topo,
                                                   geo_radius=0.4), m)
    rng = np.random.default_rng(1)
    for active in (None, rng.random(m) < 0.7, np.zeros(m, bool)):
        jA, jW = jstages.cohort_neighborhood(
            m, None if active is None else jnp.asarray(active),
            jnp.asarray(adj))
        A, W = stages.cohort_neighborhood(m, active, adj)
        np.testing.assert_array_equal(A, np.asarray(jA))
        assert W.dtype == np.float32
        np.testing.assert_allclose(W, np.asarray(jW), rtol=0, atol=1e-7)
        np.testing.assert_allclose(W.sum(axis=0), 1.0, atol=1e-6)
        np.testing.assert_array_equal(stages.xfers_neighborhood(A),
                                      np.asarray(jstages.xfers_neighborhood(
                                          jA)))


# ---------------------------------------------------------------------------
# one masked round of each preset against the reference's apply_staged
# ---------------------------------------------------------------------------

M = 6
SHAPES = ((4, 3), (7,))          # a two-leaf model, P = 19
OFFSETS = [3.0, 2.5, -0.5, -0.8, -1.5, 0.2]
SOME = np.array([True, False, True, True, False, True])
NONE = np.zeros(M, bool)
ONE = np.eye(M, dtype=bool)[2]
STALE_AGES = np.array([0, 4, 1, 4, 2, 0], np.int32)


def _stale(cohort, commit, **params):
    """The staleness trigger composed with another cohort family."""
    return dict(spec=dict(cohort=cohort, commit=commit, params=params))


# name -> (protocol kwargs or spec, active, step0, v0, adjacency topology)
ROUNDS = {
    "periodic_some": (dict(kind="periodic", b=1), SOME, 0, 0, None),
    "periodic_dark": (dict(kind="periodic", b=1), NONE, 0, 0, None),
    "fedavg_some": (dict(kind="fedavg", b=1, fedavg_c=0.5), SOME, 0, 0,
                    None),
    "fedavg_one": (dict(kind="fedavg", b=1, fedavg_c=0.5), ONE, 0, 0, None),
    "fedavg_dark": (dict(kind="fedavg", b=1, fedavg_c=0.5), NONE, 0, 0,
                    None),
    "dynamic_some": (dict(kind="dynamic", b=1, delta=1.0), SOME, 0, 0,
                     None),
    "dynamic_forced": (dict(kind="dynamic", b=1, delta=1.0), SOME, 0, M - 1,
                       None),
    "dynamic_random": (dict(kind="dynamic", b=1, delta=1.0,
                            augmentation="random"), SOME, 0, 0, None),
    "gossip_ring_some": (dict(kind="gossip", b=1), SOME, 0, 0, "ring"),
    "gossip_complete_all": (dict(kind="gossip", b=1),
                            np.ones(M, bool), 0, 0, "complete"),
    "gossip_star_one": (dict(kind="gossip", b=1), ONE, 0, 0, "star"),
    "stale_some": (dict(kind="stale"), SOME, 0, 0, None),
    "stale_fraction": (_stale("fraction", "subset", b=1, tau=5,
                              fedavg_c=0.5), SOME, 0, 0, None),
    "stale_balanced": (_stale("balanced", "balancing", b=1, tau=5,
                              delta=1.0), SOME, 0, 0, None),
}


def _plane():
    rng = np.random.default_rng(0)
    P = sum(int(np.prod(s)) for s in SHAPES)
    u = rng.standard_normal(P).astype(np.float32)
    u /= np.linalg.norm(u)
    ref = rng.standard_normal(P).astype(np.float32)
    X = np.stack([ref + s * u + 0.05 * rng.standard_normal(P)
                  .astype(np.float32) for s in OFFSETS]).astype(np.float32)
    return X, ref


def _tree(X, lead=True):
    out, o = {}, 0
    for i, shp in enumerate(SHAPES):
        n = int(np.prod(shp))
        block = X[..., o:o + n]
        out[f"w{i}"] = jnp.asarray(
            block.reshape((X.shape[0],) + shp if lead else shp))
        o += n
    return out


def _protocols(kw):
    """(reference, port) protocols: configs, or staleness specs."""
    if "spec" in kw:
        s = kw["spec"]
        return (JProtocolSpec(trigger="staleness", cohort=s["cohort"],
                              commit=s["commit"],
                              params={**s["params"], "layout": "flat"}),
                ProtocolSpec(trigger="staleness", cohort=s["cohort"],
                             commit=s["commit"], params=s["params"]))
    return (jconfig.ProtocolConfig(layout="flat", **kw),
            tconfig.ProtocolConfig(**kw))


@pytest.mark.parametrize("case", list(ROUNDS))
def test_masked_round_matches_reference(case):
    kw, active, step0, v0, topo = ROUNDS[case]
    jproto, tproto = _protocols(kw)
    X, ref = _plane()
    adj = None if topo is None else getattr(topology, topo)(M)
    jspec = jkernel.resolve_spec(jproto)
    extra = ({"staleness": jnp.asarray(STALE_AGES)}
             if jspec.extra_state else {})
    jstate = JSyncState(ref=_tree(ref, lead=False), v=jnp.int32(v0),
                        rng=jax.random.PRNGKey(0), step=jnp.int32(step0),
                        extra=extra)
    want = jkernel.apply_staged(
        jproto, _tree(X), jstate, active=jnp.asarray(active),
        adjacency=None if adj is None else jnp.asarray(adj))
    adapter = jflatten.fleet_adapter(_tree(X))

    state = SyncState(ref=torch.from_numpy(ref.copy()), v=v0, step=step0,
                      extra=({"staleness": STALE_AGES.copy()}
                             if extra else {}))
    got = kernel.apply_staged(tproto, torch.from_numpy(X.copy()), state,
                              active=active.copy(), adjacency=adj)
    np.testing.assert_allclose(got.params.numpy(),
                               np.asarray(adapter.ravel(want.params)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got.state.ref.numpy(),
        np.asarray(adapter.ravel_model(want.state.ref)), rtol=0, atol=1e-6)
    assert got.state.v == int(want.state.v)
    np.testing.assert_array_equal(got.state.key.numpy(),
                                  np.asarray(want.state.rng))
    assert sorted(got.state.extra) == sorted(want.state.extra)
    for k in got.state.extra:
        np.testing.assert_array_equal(got.state.extra[k],
                                      np.asarray(want.state.extra[k]))
    assert tuple(got.rec) == tuple(int(x) for x in want.rec)
    np.testing.assert_array_equal(got.xfers, np.asarray(want.xfers))
    np.testing.assert_array_equal(got.link_msgs, np.asarray(want.link_msgs))
    assert got.link_msgs.sum() == got.rec.messages
    if not active.any():
        # nobody reachable: nothing moves and nothing is billed
        assert got.rec == (0, 0, 0, 0, 0)
        np.testing.assert_array_equal(got.params.numpy(), X)


@pytest.mark.slow
def test_torch_network_regimes_runs_on_the_cpu():
    """examples/torch_network_regimes.py at ``--quick`` size: its own
    check passes (the ideal row is the no-network baseline bit for bit,
    every loss finite, dynamic bytes within 1.5x the baseline)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "examples" / "torch_network_regimes.py"),
         "--device", "cpu", "--quick"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src"),
                       "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "PASS" and len(lines) == 1 + 1 + 3 * 3 * 2
