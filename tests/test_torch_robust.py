"""The port's Byzantine-robust stages against the reference's, on the CPU.

The coordinate-wise aggregates (``flat_trimmed_mean``, ``flat_median``)
on planes holding NaN and ±Inf under masks, against
``repro.core.sync.robust``: the trimmed mean within atol 1e-6 / rtol
1e-5 — the reference sums the kept order statistics with XLA's
reduction, the port row by row in a fixed order, the two agree "to
reassociation tolerance" as the reference's own docstring says — and the
median exactly (a sort and one f32 midpoint on both sides). ``floor(
trim_frac * n)`` at its f32 boundary (trim_frac 0.29, 100 valid rows:
29, where f64 gives 28). The quarantine commit and health counters at
the stage level, ``robust_divergence`` firing on a NaN row, ``hardened``
and the validation errors (the same messages), the presets resolving
from ``ProtocolConfig``. Then the engine: ``robust_periodic``,
``robust_dynamic`` and the median pipeline of benchmarks/robust_bench.py
(and ``robust_dynamic`` on the tree layout) under the reference's
``HEAVY`` faults, and
a robust intra tier under a hierarchy, against the reference's live
runs: comm, ledger, per-round fault / quarantine / recovery counts and
the health state exact, parameters finite exactly where the reference's
are and the finite ones within atol / rtol 1e-5 (NaN against Inf in a
poisoned row is each framework's autodiff, see tests/test_torch_faults.py).
A checkpoint
carrying the health state round-trips each way and both continue 8
rounds alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint.io as jio  # noqa: E402
from repro.config import FaultConfig as JFaultConfig  # noqa: E402
from repro.config import HierarchyConfig as JHierarchyConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.core.sync import PROTOCOLS as JPROTOCOLS  # noqa: E402
from repro.core.sync import apply_staged as japply_staged  # noqa: E402
from repro.core.sync import init_state as jinit_state  # noqa: E402
from repro.core.sync.robust import flat_median as jflat_median  # noqa: E402
from repro.core.sync.robust import flat_trimmed_mean as jflat_trimmed_mean  # noqa: E402
from repro.core.sync.robust import hardened as jhardened  # noqa: E402
from repro.core.sync.spec import ProtocolSpec as JProtocolSpec  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.optim.optimizers import OptState as JOptState  # noqa: E402
import repro_torch.checkpoint.io as io  # noqa: E402
from repro_torch.config import (  # noqa: E402
    FaultConfig, HierarchyConfig, ProtocolConfig, TrainConfig, get_arch,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.core.sync import PROTOCOLS, apply_staged, hardened  # noqa: E402
from repro_torch.core.sync.kernel import init_state  # noqa: E402
from repro_torch.core.sync.robust import (  # noqa: E402
    flat_median, flat_trimmed_mean,
)
from repro_torch.core.sync.spec import ProtocolSpec  # noqa: E402
from repro_torch.models.cnn import cnn_loss  # noqa: E402

SGD = dict(optimizer="sgd", learning_rate=0.05)
TOL = dict(rtol=1e-5, atol=1e-5)
AGG_TOL = dict(rtol=1e-5, atol=1e-6)
HEAVY = dict(fault_seed=7, crash_prob=0.3, byzantine_frac=0.25,
             corrupt_prob=0.05, straggler_prob=0.3)
MEDIAN = dict(name="robust_median", trigger="robust_divergence",
              cohort="all_reachable", aggregate="median",
              commit="quarantine")


# ---------------------------------------------------------------------------
# the aggregates
# ---------------------------------------------------------------------------

def _plane(m, P, seed=0):
    X = np.random.default_rng(seed).normal(size=(m, P)).astype(np.float32)
    X[2, :] = np.nan                    # a corrupted row
    X[4, :] = np.inf
    X[5, 1] = -np.inf
    X[6, ::2] = np.nan                  # half a row
    X[:, 3] = np.nan                    # an all-invalid coordinate
    return X


MASKS = {"all": lambda m: np.ones(m, bool),
         "some": lambda m: np.arange(m) % 4 != 1,
         "one": lambda m: np.arange(m) == 0}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("trim_frac", [0.0, 0.1, 0.2, 0.45])
def test_trimmed_mean_matches_reference(trim_frac, mask):
    X = _plane(17, 40)
    msk = MASKS[mask](17)
    want = np.asarray(jflat_trimmed_mean(jnp.asarray(X), jnp.asarray(msk),
                                         trim_frac))
    got = flat_trimmed_mean(torch.from_numpy(X), msk, trim_frac).numpy()
    np.testing.assert_allclose(got, want, **AGG_TOL)
    assert np.isfinite(got).all() and got[3] == 0.0


@pytest.mark.parametrize("mask", list(MASKS))
def test_median_matches_reference_exactly(mask):
    for m in (16, 17):                  # even and odd counts
        X = _plane(m, 40, seed=m)
        msk = MASKS[mask](m)
        want = np.asarray(jflat_median(jnp.asarray(X), jnp.asarray(msk)))
        got = flat_median(torch.from_numpy(X), msk).numpy()
        np.testing.assert_array_equal(got, want)


def test_trim_count_is_floored_in_f32_at_the_boundary():
    """trim_frac 0.29 over 100 valid rows: the f32 product is 29.0 (the
    reference's k), the f64 one 28.999999999999996 (k = 28)."""
    X = np.random.default_rng(3).normal(size=(100, 64)).astype(np.float32)
    mask = np.ones(100, bool)
    want = np.asarray(jflat_trimmed_mean(jnp.asarray(X), jnp.asarray(mask),
                                         0.29))
    got = flat_trimmed_mean(torch.from_numpy(X), mask, 0.29).numpy()
    np.testing.assert_allclose(got, want, **AGG_TOL)
    srt = np.sort(X.astype(np.float64), axis=0)
    k29, k28 = srt[29:71].mean(axis=0), srt[28:72].mean(axis=0)
    np.testing.assert_allclose(got, k29, **AGG_TOL)
    assert np.abs(got - k28).max() > 1e-4      # the f64 floor would differ


def test_batched_forms_equal_each_cluster():
    X = _plane(12, 30)
    masks = np.stack([MASKS["all"](4), MASKS["some"](4), MASKS["one"](4)])
    Xg = torch.from_numpy(X).view(3, 4, 30)
    tm = flat_trimmed_mean(Xg, masks, 0.25)
    med = flat_median(Xg, masks)
    for c in range(3):
        assert torch.equal(tm[c], flat_trimmed_mean(Xg[c], masks[c], 0.25))
        assert torch.equal(med[c], flat_median(Xg[c], masks[c]))


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

def _stage_fleet(m=6, d=4, bad_rows=(), byz_rows=()):
    X = np.ones((m, d), np.float32) + np.float32(0.01)
    for r in bad_rows:
        X[r] = np.nan
    for r in byz_rows:
        X[r] = -5.0
    return np.ones((d,), np.float32), X


def _both_rounds(name, params, X, ref, rounds=1, then=None):
    """The stage round in both packages from the same plane; ``then``
    maps the first result's reference row to the next plane."""
    spec = PROTOCOLS[name].with_params(**params)
    jspec = JPROTOCOLS[name].with_params(layout="flat", **params)
    m = X.shape[0]
    st = init_state(torch.from_numpy(ref), 0, spec=spec, m=m)
    jst = jinit_state({"w": jnp.asarray(ref)}, 0, spec=jspec, m=m)
    out = []
    for i in range(rounds):
        res = apply_staged(spec, torch.from_numpy(X.copy()), st)
        jres = japply_staged(jspec, {"w": jnp.asarray(X)}, jst)
        out.append((res, jres))
        st, jst = res.state, jres.state
        if then is not None:
            X = then(res.state.ref.numpy())
    return out


def _assert_same_stage(res, jres):
    assert res.rec == tuple(int(x) for x in jres.rec)
    np.testing.assert_array_equal(res.xfers, np.asarray(jres.xfers))
    for k in ("health", "recovered"):
        np.testing.assert_array_equal(res.state.extra[k],
                                      np.asarray(jres.state.extra[k]))
    np.testing.assert_allclose(res.params.numpy(),
                               np.asarray(jres.params["w"]), **AGG_TOL)


def test_quarantine_heals_and_health_counts():
    ref, X = _stage_fleet(bad_rows=(1,), byz_rows=(4,))
    (a, ja), (b, jb) = _both_rounds(
        "robust_periodic", dict(b=1), X, ref, rounds=2,
        then=lambda r: np.broadcast_to(r, (6, 4)) + np.float32(0.01))
    for res, jres in ((a, ja), (b, jb)):
        _assert_same_stage(res, jres)
    w = a.params.numpy()
    assert np.isfinite(w).all()
    assert (w[1] == ref).all() and (w[4] == ref).all()
    assert a.state.extra["health"].tolist() == [0, 1, 0, 0, 1, 0]
    assert b.state.extra["health"].tolist() == [0] * 6
    assert b.state.extra["recovered"].tolist() == [0, 1, 0, 0, 1, 0]


def test_skip_rounds_keep_health_and_clear_recovered():
    ref, X = _stage_fleet(bad_rows=(2,))
    (res, jres), = _both_rounds("robust_periodic", dict(b=4), X, ref)
    assert res.rec.syncs == 0
    _assert_same_stage(res, jres)


def test_robust_divergence_fires_on_nan_row():
    ref, X = _stage_fleet(bad_rows=(2,))
    (res, jres), = _both_rounds("robust_dynamic", dict(b=1, delta=1e9), X,
                                ref)
    assert res.rec.syncs == 1 and np.isfinite(res.params.numpy()).all()
    _assert_same_stage(res, jres)
    _, honest = _stage_fleet()
    (res, jres), = _both_rounds("robust_dynamic", dict(b=1, delta=1e9),
                                honest, ref)
    assert res.rec.syncs == 0
    _assert_same_stage(res, jres)


def test_suspects_use_one_distance_pass_per_round(monkeypatch):
    """The condition's distances feed the quarantine and the health
    counters (robust_divergence); robust_cadence makes one pass in the
    commit."""
    from repro_torch.core.sync import stages
    calls = []
    dists = stages.per_learner_sq_distance_flat
    monkeypatch.setattr(stages, "per_learner_sq_distance_flat",
                        lambda *a: calls.append(1) or dists(*a))
    ref, X = _stage_fleet(bad_rows=(2,), byz_rows=(3,))
    for name, params in (("robust_dynamic", dict(b=1, delta=1e-6)),
                         ("robust_periodic", dict(b=1))):
        calls.clear()
        spec = PROTOCOLS[name].with_params(**params)
        res = apply_staged(spec, torch.from_numpy(X.copy()),
                           init_state(torch.from_numpy(ref), 0, spec=spec,
                                      m=6))
        assert res.rec.syncs == 1 and len(calls) == 1, name


# ---------------------------------------------------------------------------
# hardened, validation, configs
# ---------------------------------------------------------------------------

def test_hardened_rewrites_like_the_reference():
    cases = [(lambda P: P["periodic"].with_params(b=3), {}),
             (lambda P: P["robust_periodic"], {}),
             (lambda P: P["periodic"], dict(aggregate="median",
                                            quarantine_mult=9.0)),
             (lambda P: P["periodic"], dict(trim_frac=0.3)),
             (lambda P: P["continuous"], {})]
    for make, kw in cases:
        got = hardened(make(PROTOCOLS), **kw)
        want = jhardened(make(JPROTOCOLS), **kw)
        assert got.to_json() == want.to_json()
    assert hardened(hardened(PROTOCOLS["periodic"])).trigger == \
        "robust_cadence"


@pytest.mark.parametrize("spec,kw", [
    ("dynamic", {}), ("stale", {}), ("periodic", dict(aggregate="mean")),
    ("gossip", {}), ("fedavg", {})])
def test_hardened_rejects_like_the_reference(spec, kw):
    with pytest.raises(ValueError) as want:
        jhardened(JPROTOCOLS[spec], **kw)
    with pytest.raises(ValueError) as got:
        hardened(PROTOCOLS[spec], **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,params", [
    ("robust_periodic", dict(trim_frac=0.5)),
    ("robust_periodic", dict(quarantine_mult=1.0)),
    ("robust_dynamic", dict(delta=-1.0)),
    ("robust_periodic", dict(b=0))])
def test_robust_validation_matches_reference(name, params):
    with pytest.raises(ValueError) as want:
        JPROTOCOLS[name].with_params(**params)
    with pytest.raises(ValueError) as got:
        PROTOCOLS[name].with_params(**params)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["robust_periodic", "robust_dynamic"])
def test_robust_kinds_resolve_from_protocol_config(kind):
    spec = ProtocolConfig(kind=kind, b=3, delta=0.2)._spec()
    want = JProtocolConfig(kind=kind, b=3, delta=0.2,
                           layout="flat")._spec()
    assert spec.to_json() == want.to_json()
    assert spec.extra_state == ("health", "recovered")


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


def _engine(proto, m, faults_kw=None):
    cfg = get_arch("drift_mlp", smoke=True)
    init = _init()
    return DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: params_from_numpy(init, device="cpu"), m, proto,
        TrainConfig(**SGD),
        faults=None if faults_kw is None else FaultConfig(**faults_kw),
        device="cpu")


def _jengine(proto, m, faults_kw=None):
    cfg = jget_arch("drift_mlp", smoke=True)
    return JLearner(lambda p, b: jcnn_loss(cfg, p, b),
                    lambda k: jinit(cfg, k), m, proto, JTrainConfig(**SGD),
                    faults=None if faults_kw is None else
                    JFaultConfig(**faults_kw))


def _chunk(batches, lo, hi):
    return {k: torch.from_numpy(v[lo:hi].copy()) for k, v in batches.items()}


def _extra(state):
    return state.extra if not hasattr(state, "intra") else state.intra.extra


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
                  "num_recovered"):
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(getattr(x, field)) for x in metrics]),
            np.asarray(getattr(rm, field)), field)
    for k in ("health", "recovered"):
        np.testing.assert_array_equal(_extra(dl.sync_state)[k],
                                      np.asarray(_extra(ref.sync_state)[k]))
    want = np.asarray(jfleet_adapter(ref.params).ravel(ref.params))
    assert_close_where_finite(dl.X.numpy(), want)


PIPELINES = {
    "robust_periodic": lambda P, S: P["robust_periodic"].with_params(b=2),
    "robust_dynamic": lambda P, S: P["robust_dynamic"].with_params(
        b=1, delta=0.05),
    "median": lambda P, S: S(**MEDIAN).with_params(b=1, delta=0.05),
}


@pytest.mark.parametrize("name,layout", [
    ("robust_periodic", "flat"), ("robust_dynamic", "flat"),
    ("median", "flat"), ("robust_dynamic", "tree")])
def test_robust_pipelines_under_heavy_faults_match_reference(name, layout):
    m, batches = 8, _batches(8, 24)
    spec = PIPELINES[name](PROTOCOLS, ProtocolSpec).with_params(
        layout=layout)
    jspec = PIPELINES[name](JPROTOCOLS, JProtocolSpec).with_params(
        layout="flat")
    ref = _jengine(jspec, m, HEAVY)
    rm = ref.run_chunk(batches)
    dl = _engine(spec, m, HEAVY)
    metrics = [dl.run_chunk(_chunk(batches, i, i + 12)) for i in (0, 12)]
    assert_matches_reference(dl, metrics, ref, rm)
    assert np.concatenate([x.num_quarantined for x in metrics]).max() > 0
    assert np.isfinite(dl.sync_state.ref.numpy()).all()


def test_robust_intra_tier_matches_reference():
    """robust_periodic inside 2 clusters under a hierarchy, HEAVY's
    crashes, adversaries and bursts: the health counters are carried per
    cluster, (g, k). (No corruption here: the edge aggregator is a plain
    mean, so a NaN row reaches every member through the inter tier, and
    whether a poisoned entry reads NaN or Inf then depends on the order
    of a sum.)"""
    def proto(P, H):
        return P(kind="robust_periodic", b=2, layout="flat",
                 tiers=H(num_clusters=2,
                         inter=P(kind="periodic", b=4, layout="flat")))
    m, batches = 8, _batches(8, 16)
    kw = dict(HEAVY, corrupt_prob=0.0)
    ref = _jengine(proto(JProtocolConfig, JHierarchyConfig), m, kw)
    rm = ref.run_chunk(batches)
    dl = _engine(proto(ProtocolConfig, HierarchyConfig), m, kw)
    metrics = [dl.run_chunk(_chunk(batches, 0, 16))]
    assert dl.sync_state.intra.extra["health"].shape == (2, 4)
    assert_matches_reference(dl, metrics, ref, rm)
    assert np.isfinite(dl.X.numpy()).all()
    assert np.concatenate([x.num_faulty for x in metrics]).min() > 0


def test_checkpoint_with_health_state_round_trips_each_way(tmp_path):
    """A robust_periodic run under HEAVY's corruption, adversaries and
    bursts, saved after 8 rounds by each package and continued 8 rounds
    by the other: the same integers and health state as the saver's own
    continuation. (No crashes: the reference's per-learner optimizer step
    counts then differ, and the port keeps one for the fleet.)"""
    m, batches = 6, _batches(6, 16)
    proto = dict(kind="robust_periodic", b=2, layout="flat")
    kw = dict(HEAVY, crash_prob=0.0)
    port = _engine(ProtocolConfig(**proto), m, kw)
    port.run_chunk(_chunk(batches, 0, 8))
    ref = _jengine(JProtocolConfig(**proto), m, kw)
    ref.run_chunk(jax.tree.map(lambda x: x[:8], batches))
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    io.save_protocol_state(a, port.params, port.opt_state, port.sync_state,
                           protocol=ProtocolConfig(**proto),
                           counters=port.counters_state())
    jio.save_protocol_state(b, ref.params, ref.opt_state, ref.sync_state,
                            protocol=JProtocolConfig(**proto),
                            counters=ref.counters_state())
    assert sorted(io.load_protocol_state(b, device="cpu")[2].extra) == [
        "health", "recovered"]
    # the reference continues the port's checkpoint, the port the
    # reference's; each owner continues its own
    jcont = _jengine(JProtocolConfig(**proto), m, kw)
    params, opt, state = jio.load_protocol_state(a)
    jcont.params, jcont.sync_state = params, state
    jcont.opt_state = JOptState(step=opt[".step"])
    jcont.restore_counters(jio.load_counters(a))
    cont = _engine(ProtocolConfig(**proto), m, kw)
    cont.restore_state(*io.load_protocol_state(b, device="cpu"))
    cont.restore_counters(io.load_counters(b))
    rest = jax.tree.map(lambda x: x[8:], batches)
    jm = jcont.run_chunk(rest)
    tm = cont.run_chunk(_chunk(batches, 8, 16))
    pm = port.run_chunk(_chunk(batches, 8, 16))
    ref.run_chunk(rest)
    assert_matches_reference(port, [pm], jcont, jm)
    assert_matches_reference(cont, [tm], ref, jm)
    assert cont.comm_totals == port.comm_totals
