"""The port's fault-injection plane against the reference's, on the CPU.

``FaultConfig`` validates with the reference's errors; every mask
(crash, restart, straggler burst, corruption, the Byzantine subset, the
composition with availability and the fault count) equals
``repro.network.faults`` bit for bit over a grid of seeds x rounds x
fleet sizes; the row operations (``perturb_params``, ``lose_state``, the
crash freeze) do what the reference's do on numpy fleets; a default
``FaultConfig()`` is ``faults=None`` bit for bit. Then the engine under
the reference's ``HEAVY`` schedule (tests/test_faults.py:112: crashes,
corruption, adversaries and bursts), the crash-only schedule of
``examples/faulty_fleet.py`` under async and ``stale``, and a crashed
learner freezing and restarting cold, against the reference's live flat
runs: comm counters, ledger, and every round's ``num_faulty`` and
``num_active`` exact; parameters and losses finite exactly where the
reference's are, and the finite ones within atol / rtol 1e-5 — the runs
differ from the reference's only in the order f32 sums are taken (XLA's
against PyTorch's), which moves the parameters by less than 1e-6 here.
A non-finite entry may be NaN in one package and Inf in the other: a
poisoned row's local step carries NaN and Inf through each framework's
autodiff its own way.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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
from repro.network import faults as jfaults  # noqa: E402
from repro_torch.config import (  # noqa: E402
    AsyncConfig, FaultConfig, NetworkConfig, ProtocolConfig, TrainConfig,
    get_arch,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.models.cnn import cnn_loss  # noqa: E402
from repro_torch.network import faults  # noqa: E402
from repro_torch.telemetry.sink import get_logger  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SGD = dict(optimizer="sgd", learning_rate=0.05)
TOL = dict(rtol=1e-5, atol=1e-5)
HEAVY = dict(fault_seed=7, crash_prob=0.3, byzantine_frac=0.25,
             corrupt_prob=0.05, straggler_prob=0.3)
# examples/faulty_fleet.py:47
CRASHES = dict(fault_seed=11, byzantine_frac=0.2, byzantine_mode="sign_flip",
               crash_prob=0.15, crash_every=16, outage_min=2, outage_max=4)


# ---------------------------------------------------------------------------
# FaultConfig
# ---------------------------------------------------------------------------

BAD = [dict(crash_prob=1.5), dict(corrupt_prob=-0.1),
       dict(straggler_frac=2.0), dict(byzantine_frac=1.0),
       dict(byzantine_mode="gaslight"), dict(crash_every=0),
       dict(straggler_every=0), dict(outage_min=5, outage_max=2),
       dict(outage_min=0), dict(outage_max=20, crash_every=16)]


@pytest.mark.parametrize("kw", BAD, ids=[str(sorted(k.items())) for k in BAD])
def test_fault_config_validation_matches_reference(kw):
    with pytest.raises((ValueError, KeyError)) as want:
        JFaultConfig(**kw)
    with pytest.raises(want.type) as got:
        FaultConfig(**kw)
    assert str(got.value) == str(want.value)


def test_configs_match_reference_field_for_field():
    from dataclasses import fields

    from repro.config import TelemetryConfig as JTelemetryConfig
    from repro_torch.config import FAULT_BYZANTINE_MODES, TelemetryConfig
    import repro.config as jconfig
    assert [(f.name, f.default) for f in fields(FaultConfig)] == \
        [(f.name, f.default) for f in fields(JFaultConfig)]
    assert FAULT_BYZANTINE_MODES == jconfig.FAULT_BYZANTINE_MODES
    # the one rename: jax_profiler -> profiler
    want = [(("profiler" if f.name == "jax_profiler" else f.name), f.default)
            for f in fields(JTelemetryConfig)]
    assert [(f.name, f.default) for f in fields(TelemetryConfig)] == want
    with pytest.raises(ValueError) as got:
        TelemetryConfig(ring=0)
    with pytest.raises(ValueError) as ref:
        JTelemetryConfig(ring=0)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# masks, bit for bit
# ---------------------------------------------------------------------------

GRID = dict(crash_prob=0.4, crash_every=8, outage_min=1, outage_max=4,
            corrupt_prob=0.3, byzantine_frac=0.25, straggler_prob=0.5,
            straggler_frac=0.5, straggler_every=5)


def _reference_masks(jcfg, m, avail, ts):
    """The reference's masks of the rounds ``ts``, one vmap."""
    def one(t):
        return (jfaults.crash_mask(jcfg, m, t),
                jfaults.restart_mask(jcfg, m, t),
                jfaults.straggler_burst_mask(jcfg, m, t),
                jfaults.corrupt_mask(jcfg, m, t),
                jfaults.compose_active(jcfg, jnp.asarray(avail), m, t),
                jfaults.compose_active(jcfg, None, m, t),
                jfaults.num_faulty(jcfg, m, t))
    return [np.asarray(x) for x in jax.vmap(one)(
        jnp.asarray(ts, jnp.int32))]


@pytest.mark.parametrize("seed,fleets", [(0, (1, 12)), (11, (5,)),
                                         (2 ** 16 - 1, (12,))])
def test_masks_match_reference_bit_for_bit(seed, fleets):
    ts = np.arange(0, 35)
    for m in fleets:
        jcfg, cfg = JFaultConfig(fault_seed=seed, **GRID), \
            FaultConfig(fault_seed=seed, **GRID)
        sched = faults.sample_rounds(cfg, m, ts)
        avail = np.arange(m) % 3 != 1
        crash, restart, burst, corrupt, composed, down, nfaulty = \
            _reference_masks(jcfg, m, avail, ts)
        np.testing.assert_array_equal(sched.crashed, crash)
        np.testing.assert_array_equal(sched.restart, restart)
        np.testing.assert_array_equal(sched.burst, burst)
        np.testing.assert_array_equal(sched.corrupt, corrupt)
        np.testing.assert_array_equal(avail & ~sched.down(), composed)
        np.testing.assert_array_equal(sched.num_faulty(), nfaulty)
        np.testing.assert_array_equal(
            sched.byzantine, np.asarray(jfaults.byzantine_mask(jcfg, m)))
        # the one-round forms, at a few rounds, out of order
        for t in (17, 0, 8, 33):
            np.testing.assert_array_equal(faults.crash_mask(cfg, m, t),
                                          crash[t])
            np.testing.assert_array_equal(faults.restart_mask(cfg, m, t),
                                          restart[t])
            np.testing.assert_array_equal(
                faults.straggler_burst_mask(cfg, m, t), burst[t])
            np.testing.assert_array_equal(faults.corrupt_mask(cfg, m, t),
                                          corrupt[t])
            np.testing.assert_array_equal(
                faults.compose_active(cfg, avail, m, t), composed[t])
            np.testing.assert_array_equal(
                faults.compose_active(cfg, None, m, t), down[t])
            assert faults.num_faulty(cfg, m, t) == nfaulty[t]


def test_off_faults_draw_nothing_and_pass_availability_through():
    cfg = FaultConfig(byzantine_frac=0.25)
    assert not faults.sample_rounds(cfg, 8, range(5)).down().any()
    assert faults.compose_active(cfg, None, 8, 3) is None
    avail = np.arange(8) > 2
    assert faults.compose_active(cfg, avail, 8, 3) is avail
    assert faults.byzantine_mask(FaultConfig(), 8).sum() == 0
    assert faults.byzantine_mask(cfg, 8).sum() == 2


# ---------------------------------------------------------------------------
# row operations on numpy fleets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,t", [
    (dict(fault_seed=3, byzantine_frac=0.25), 0),
    (dict(fault_seed=3, byzantine_frac=0.25, byzantine_mode="scale",
          byzantine_scale=0.3), 0),
    (dict(fault_seed=0, corrupt_prob=0.5), 4),
    (dict(fault_seed=0, corrupt_prob=0.5, byzantine_frac=0.4,
          byzantine_mode="scale"), 5)])
def test_perturb_params_matches_reference(kw, t):
    m = 8
    X = np.random.default_rng(1).normal(size=(m, 6)).astype(np.float32)
    want = np.asarray(jfaults.perturb_params(
        JFaultConfig(**kw), {"w": jnp.asarray(X)}, m, t)["w"])
    got = torch.from_numpy(X.copy())
    cfg = FaultConfig(**kw)
    sched = faults.sample_rounds(cfg, m, [t])
    faults.perturb_params(cfg, got, t, sched.byzantine, sched.corrupt[0])
    np.testing.assert_array_equal(got.numpy(), want)   # NaN == NaN here
    untouched = ~(sched.byzantine | sched.corrupt[0])
    assert np.array_equal(got.numpy()[untouched].view(np.int32),
                          X[untouched].view(np.int32))


def test_lose_state_and_freeze_state_match_reference():
    m = 5
    rows = np.array([0, 1, 0, 0, 1], bool)
    rng = np.random.default_rng(2)
    extra = {"ring": rng.integers(0, 9, (m, 3)).astype(np.int32),
             "age": rng.integers(0, 9, (m,)).astype(np.int32),
             "scalar": np.int32(4)}
    want = jax.tree.map(np.asarray, jfaults.lose_state(
        jax.tree.map(jnp.asarray, extra), jnp.asarray(rows), m))
    got = faults.lose_state(extra, rows, m)
    for k in extra:
        np.testing.assert_array_equal(got[k], want[k])
    assert extra["age"].any()                 # the input is not written
    X = torch.from_numpy(rng.normal(size=(m, 4)).astype(np.float32))
    Xn = X.numpy().copy()
    faults.lose_state((X, None), rows, m)
    np.testing.assert_array_equal(X.numpy(), np.where(rows[:, None], 0, Xn))
    # the freeze: crashed rows get their old values back
    new = torch.from_numpy(rng.normal(size=(m, 4)).astype(np.float32))
    idx, saved = faults.keep_rows(rows, X)
    X.copy_(new)
    faults.freeze_state(idx, saved, X)
    want = np.asarray(jfaults.freeze_state(
        {"w": jnp.asarray(new.numpy())}, {"w": jnp.asarray(
            np.where(rows[:, None], 0, Xn))}, jnp.asarray(rows), m)["w"])
    np.testing.assert_array_equal(X.numpy(), want)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _batches(m, rounds, seed=0):
    streams = JStreams(JGraphical(seed=seed, drift_prob=0.0), m, batch=10,
                       seed=seed)
    return jax.tree.map(np.asarray, streams.next_chunk(rounds))


def _init():
    cfg = jget_arch("drift_mlp", smoke=True)
    return jax.tree.map(np.asarray, jinit(cfg, jax.random.split(
        jax.random.PRNGKey(0), 3)[0]))


def port_run(proto, m, batches, faults_kw=None, net=None, async_net=None,
             chunks=1, **kw):
    cfg = get_arch("drift_mlp", smoke=True)
    init = _init()
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: params_from_numpy(init, device="cpu"), m, proto,
        TrainConfig(**SGD),
        network=None if net is None else NetworkConfig(**net),
        async_net=async_net,
        faults=None if faults_kw is None else FaultConfig(**faults_kw),
        device="cpu", **kw)
    n = next(iter(batches.values())).shape[0]
    step = n // chunks
    metrics = [dl.run_chunk({k: torch.from_numpy(v[i:i + step].copy())
                             for k, v in batches.items()})
               for i in range(0, n, step)]
    return dl, metrics


def ref_run(proto, m, batches, faults_kw=None, net=None, async_net=None):
    cfg = jget_arch("drift_mlp", smoke=True)
    dl = JLearner(lambda p, b: jcnn_loss(cfg, p, b), lambda k: jinit(cfg, k),
                  m, proto, JTrainConfig(**SGD),
                  network=None if net is None else JNetworkConfig(**net),
                  async_net=async_net,
                  faults=None if faults_kw is None else
                  JFaultConfig(**faults_kw))
    return dl, dl.run_chunk(batches)


def _cat(metrics, field):
    return np.concatenate([np.asarray(getattr(x, field)) for x in metrics])


def assert_close_where_finite(got, want):
    """The same entries finite, and those within TOL. NaN and ±Inf count
    as one class: what a local step makes of a poisoned row (NaN or Inf
    in each entry) depends on how each framework's autodiff carries
    non-finite values through the model."""
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], **TOL)


def assert_matches_reference(dl, metrics, ref, rm):
    assert dl.comm_totals == {k: int(v) for k, v in ref.comm_totals.items()}
    np.testing.assert_array_equal(dl.per_link_bytes(), ref.per_link_bytes())
    for field in ("num_faulty", "num_active", "num_quarantined",
                  "num_recovered", "num_inflight", "max_age"):
        np.testing.assert_array_equal(_cat(metrics, field),
                                      np.asarray(getattr(rm, field)), field)
    np.testing.assert_array_equal(
        np.concatenate([x.link_counts for x in metrics]),
        np.asarray(rm.link_counts))
    np.testing.assert_allclose(dl.network_time, ref.network_time, rtol=1e-6)
    want = np.asarray(jfleet_adapter(ref.params).ravel(ref.params))
    assert_close_where_finite(dl.X.numpy(), want)
    assert_close_where_finite(
        np.concatenate([x.loss_per_learner.numpy() for x in metrics]),
        np.asarray(rm.loss_per_learner))


def _fingerprint(dl):
    return (dict(dl.comm_totals), dl.per_link_bytes().tolist(),
            dl.network_time, dl.cumulative_loss, dl.X.numpy().tobytes())


PRESETS = {
    "periodic": dict(kind="periodic", b=2),
    "dynamic": dict(kind="dynamic", b=1, delta=0.05),
    "fedavg": dict(kind="fedavg", b=2),
    "gossip": dict(kind="gossip", b=2),
    "stale": dict(kind="stale"),
    "robust_periodic": dict(kind="robust_periodic", b=2),
    "robust_dynamic": dict(kind="robust_dynamic", b=1, delta=0.05),
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_inert_fault_config_is_faults_none_bit_for_bit(name):
    """On a lossy network for every preset; on the ideal one (no mask:
    the inert plane must keep ``None``) for the divergence-triggered
    ones."""
    batches = _batches(4, 8)
    nets = [dict(link_classes=("wired", "wifi"), act_prob=0.8, seed=3)]
    if "dynamic" in name:
        nets.append(None)
    for net in nets:
        none, _ = port_run(ProtocolConfig(**PRESETS[name]), 4, batches,
                           net=net)
        inert, _ = port_run(ProtocolConfig(**PRESETS[name]), 4, batches,
                            faults_kw={}, net=net)
        assert _fingerprint(inert) == _fingerprint(none)


@pytest.mark.parametrize("name", ["dynamic", "periodic"])
def test_heavy_faults_match_reference(name):
    """Under HEAVY the plain mean is poisoned (NaN rows), and the port is
    poisoned exactly where the reference is."""
    m, batches = 8, _batches(8, 24)
    kw = {"layout": "flat", **PRESETS[name]}
    ref, rm = ref_run(JProtocolConfig(**kw), m, batches, HEAVY)
    dl, metrics = port_run(ProtocolConfig(**kw), m, batches, HEAVY,
                           chunks=2)
    assert_matches_reference(dl, metrics, ref, rm)
    assert _cat(metrics, "num_faulty").sum() > 0


def test_crash_freezes_training_and_restarts_cold():
    """A crashed learner observes zero loss and keeps its row; the
    restart round zeroes its rows before the local step (nosync: every
    row is its learner's own history)."""
    m = 4
    kw = dict(fault_seed=1, crash_prob=0.9, crash_every=8, outage_min=2,
              outage_max=4)
    batches = _batches(m, 10)
    dl, metrics = port_run(ProtocolConfig(kind="nosync"), m, batches, kw,
                           chunks=10)
    cfg = FaultConfig(**kw)
    losses = np.stack([x.loss_per_learner.numpy()[0] for x in metrics])
    crashed = faults.crash_rounds(cfg, m, range(10))
    assert crashed.any() and faults.restart_rounds(cfg, m, range(10)).any()
    assert (losses[crashed] == 0.0).all() and (losses[~crashed] > 0).all()
    ref, rm = ref_run(JProtocolConfig(kind="nosync"), m, batches, kw)
    assert_matches_reference(dl, metrics, ref, rm)


@pytest.mark.parametrize("case", ["async", "stale"])
def test_timeline_and_staleness_under_crashes_match_reference(case):
    """A restart zeroes the learner's carried rows — the arrival ring,
    in-flight count, local clock and age, or the staleness counter —
    exactly where the reference zeroes them."""
    m, batches = 8, _batches(8, 32)
    net = dict(link_classes=("lte", "edge"))
    if case == "async":
        kw = dict(kind="periodic", b=2, layout="flat")
        an, jan = (AsyncConfig(round_budget=1.0, payload_bytes=100_000),
                   JAsyncConfig(round_budget=1.0, payload_bytes=100_000))
    else:
        kw, an, jan = dict(kind="stale", layout="flat"), None, None
    ref, rm = ref_run(JProtocolConfig(**kw), m, batches, CRASHES, net, jan)
    dl, metrics = port_run(ProtocolConfig(**kw), m, batches, CRASHES, net,
                           an, chunks=2)
    assert_matches_reference(dl, metrics, ref, rm)
    assert faults.restart_rounds(FaultConfig(**CRASHES), m, range(32)).any()


def test_nonfinite_loss_event_fires_once_with_learners():
    events = []
    log = get_logger()
    handler = log.add_handler(events.append)
    try:
        batches = _batches(4, 16)
        dl, _ = port_run(ProtocolConfig(**PRESETS["dynamic"]), 4, batches,
                         dict(fault_seed=7, corrupt_prob=0.3), chunks=2)
        hits = [e for e in events if e["kind"] == "nonfinite_loss"]
        assert len(hits) == 1 and hits[0]["learners"]
        bad = ~np.isfinite(dl.cumulative_loss_per_learner)
        assert set(hits[0]["learners"]) <= set(np.flatnonzero(bad))
        dl.run_chunk({k: torch.from_numpy(v[:4].copy())
                      for k, v in batches.items()})
        assert len([e for e in events
                    if e["kind"] == "nonfinite_loss"]) == 1
        events.clear()
        port_run(ProtocolConfig(**PRESETS["dynamic"]), 4, batches)
        assert not [e for e in events if e["kind"] == "nonfinite_loss"]
    finally:
        log.remove_handler(handler)


def test_adam_under_crashes_raises_not_implemented():
    """Adam under crash faults no longer raises (ROADMAP C3, repaired):
    the optimizer carries one step count per learner, which a crash
    freezes; the parity with the reference's live run is in
    tests/test_torch_optim_steps.py."""
    dl = DecentralizedLearner(
        lambda p, b: torch.sum(p["w"] * b["x"]),
        lambda g: {"w": torch.zeros(3)}, 4,
        ProtocolConfig(kind="periodic"), TrainConfig(optimizer="adam"),
        faults=FaultConfig(crash_prob=0.9, crash_every=4, outage_min=2,
                           outage_max=2), device="cpu")
    dl.run_chunk({"x": torch.ones((4, 4, 3))})
    assert dl.opt_state.step.dtype == torch.int32
    assert dl.opt_state.step.shape == (4,)
    assert (dl.opt_state.step < 4).any()    # some learner crashed


def test_torch_faulty_fleet_example_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_faulty_fleet.py"),
         "--device", "cpu", "--smoke"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "torch_faulty_fleet_done" in r.stdout
    assert "quarantined_last=" in r.stdout
