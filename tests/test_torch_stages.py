"""One flat sync round of the port against the reference's
``apply_staged`` with ``layout="flat"``.

Planes are built so each case drives one branch of the round: the
cadence gate firing or not, the balancing augmentation (max_distance,
random and all), a forced full sync at ``v >= m``, a tie in the
augmentation priority (the lowest index must win), Algorithm 2's
weights, a checked round with no violator, and FedAvg's random subset
(C = 0.3, 0.5 and the whole fleet). The committed plane and reference
match to atol 1e-6 (f32 means summed in another order); the violation
counter, the PRNG key, the ``CommRecord``, the per-link transfers and
messages exactly. Every
case also checks that no distance the round compares with Delta lies
within 1e-4·Delta of it, so an exact mismatch cannot be a float tie.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import flatten as jflatten  # noqa: E402
from repro.core.sync import kernel as jkernel  # noqa: E402
from repro.core.sync.registry import SyncState as JSyncState  # noqa: E402
from repro_torch.config import ProtocolConfig  # noqa: E402
from repro_torch.core.sync import kernel, stages  # noqa: E402
from repro_torch.core import divergence as tdiv  # noqa: E402
from repro_torch.core.sync.registry import SyncState  # noqa: E402

# ``repro.core`` re-exports the function ``divergence`` under the module's
# name, so the module itself comes from the import system
jdiv = importlib.import_module("repro.core.divergence")

M = 6
SHAPES = ((4, 3), (7,))          # a two-leaf model, P = 19
MAXD = [3.0, 2.5, -0.5, -0.8, -1.5, 0.2]
TIE = [3.0, 2.5, -0.6, -0.6, -1.5, 0.2]     # rows 2 and 3 identical
SMALL = [0.3, -0.2, 0.1, 0.5, -0.4, 0.2]

# name -> (protocol kwargs, row offsets s_i along one direction, v0, step0,
#          weights)
CASES = {
    "periodic_fires": (dict(kind="periodic", b=3), MAXD, 0, 2, None),
    "periodic_waits": (dict(kind="periodic", b=3), MAXD, 0, 0, None),
    "periodic_weighted": (dict(kind="periodic", b=1, weighted=True), MAXD,
                          0, 0, [1, 2, 3, 1, 2, 3]),
    "continuous": (dict(kind="continuous", b=1), MAXD, 0, 5, None),
    "nosync": (dict(kind="nosync"), MAXD, 0, 0, None),
    "dynamic_max_distance": (dict(kind="dynamic", b=2, delta=1.0), MAXD, 0,
                             1, None),
    "dynamic_all": (dict(kind="dynamic", b=2, delta=1.0,
                         augmentation="all"), MAXD, 0, 1, None),
    "dynamic_forced_full": (dict(kind="dynamic", b=2, delta=1.0), MAXD,
                            M - 1, 1, None),
    "dynamic_tie": (dict(kind="dynamic", b=1, delta=1.0), TIE, 2, 0, None),
    "dynamic_weighted": (dict(kind="dynamic", b=1, delta=1.0,
                              weighted=True), MAXD, 1, 0,
                         [1, 2, 3, 1, 2, 3]),
    "dynamic_unweighted_ignores_weights": (
        dict(kind="dynamic", b=1, delta=1.0), MAXD, 1, 0, [1, 2, 3, 1, 2, 3]),
    "dynamic_quiet": (dict(kind="dynamic", b=1, delta=1.0), SMALL, 3, 0,
                      None),
    "fedavg_fires": (dict(kind="fedavg", b=3, fedavg_c=0.5), MAXD, 0, 2,
                     None),
    "fedavg_waits": (dict(kind="fedavg", b=3, fedavg_c=0.5), MAXD, 0, 0,
                     None),
    "fedavg_weighted": (dict(kind="fedavg", b=1, fedavg_c=0.3,
                             weighted=True), MAXD, 0, 0, [1, 2, 3, 1, 2, 3]),
    "fedavg_whole_fleet": (dict(kind="fedavg", b=1, fedavg_c=1.0), MAXD, 0,
                           0, None),
    "dynamic_random": (dict(kind="dynamic", b=2, delta=1.0,
                            augmentation="random"), MAXD, 0, 1, None),
    "dynamic_random_quiet": (dict(kind="dynamic", b=1, delta=1.0,
                                  augmentation="random"), SMALL, 0, 0, None),
}


def _fleet(offsets, seed=0):
    """Rows r + s_i * u + small noise around a random reference r; rows
    with equal s_i get equal noise (an exact priority tie)."""
    rng = np.random.default_rng(seed)
    P = sum(int(np.prod(s)) for s in SHAPES)
    u = rng.standard_normal(P).astype(np.float32)
    u /= np.linalg.norm(u)
    ref = rng.standard_normal(P).astype(np.float32)
    noise = {s: 0.05 * rng.standard_normal(P).astype(np.float32)
             for s in sorted(set(offsets))}
    X = np.stack([ref + s * u + noise[s] for s in offsets]).astype(np.float32)
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


@pytest.mark.parametrize("case", list(CASES))
def test_flat_round_matches_reference(case, monkeypatch):
    kw, offsets, v0, step0, weights = CASES[case]
    X, ref = _fleet(offsets)
    jstacked, jref = _tree(X), _tree(ref, lead=False)
    jstate = JSyncState(ref=jref, v=jnp.int32(v0),
                        rng=jax.random.PRNGKey(0), step=jnp.int32(step0))
    jw = None if weights is None else jnp.asarray(weights, jnp.float32)
    want = jkernel.apply_staged(JProtocolConfig(layout="flat", **kw),
                                jstacked, jstate, jw)
    adapter = jflatten.fleet_adapter(jstacked)
    want_X = np.asarray(adapter.ravel(want.params))
    want_ref = np.asarray(adapter.ravel_model(want.state.ref))

    # record every distance the port's round compares with Delta
    seen = []
    trig = stages.per_learner_sq_distance_flat
    safe = stages._safe_dist
    monkeypatch.setattr(stages, "per_learner_sq_distance_flat",
                        lambda *a: seen.extend(trig(*a).tolist()) or trig(*a))
    monkeypatch.setattr(stages, "_safe_dist",
                        lambda *a: seen.append(safe(*a)) or safe(*a))

    tX = torch.from_numpy(X.copy())
    state = SyncState(ref=torch.from_numpy(ref.copy()), v=v0, step=step0)
    tw = None if weights is None else torch.tensor(weights,
                                                   dtype=torch.float32)
    got = kernel.apply_staged(ProtocolConfig(**kw), tX, state, tw)

    delta = kw.get("delta")
    if delta is not None:
        assert all(abs(d - delta) > 1e-4 * delta for d in seen), seen
    np.testing.assert_allclose(got.params.numpy(), want_X, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.state.ref.numpy(), want_ref, rtol=0,
                               atol=1e-6)
    assert got.state.v == int(want.state.v)
    assert got.state.step == int(want.state.step) == step0 + 1
    np.testing.assert_array_equal(got.state.key.numpy(),
                                  np.asarray(want.state.rng))
    assert tuple(got.rec) == tuple(int(x) for x in want.rec)
    np.testing.assert_array_equal(got.xfers, np.asarray(want.xfers))
    np.testing.assert_array_equal(got.link_msgs, np.asarray(want.link_msgs))
    assert got.link_msgs.sum() == got.rec.messages


def test_cases_cover_the_branches():
    """The fixture drives what the module docstring promises."""
    def run(case):
        kw, offsets, v0, step0, weights = CASES[case]
        X, ref = _fleet(offsets)
        tw = None if weights is None else torch.tensor(weights,
                                                       dtype=torch.float32)
        return kernel.apply_staged(
            ProtocolConfig(**kw), torch.from_numpy(X),
            SyncState(torch.from_numpy(ref), v0, step0), tw)

    assert run("periodic_waits").rec.syncs == 0
    aug = run("dynamic_max_distance")
    assert aug.rec.model_up == 4 and aug.rec.messages == 4     # 3 hot + 1 poll
    assert not aug.rec.full_syncs and aug.state.v == 3
    assert list(run("dynamic_tie").xfers) == [2, 2, 2, 0, 2, 0]
    forced = run("dynamic_forced_full")
    assert forced.rec.full_syncs == 1 and forced.state.v == 0
    assert run("dynamic_all").rec.model_up == M
    assert run("dynamic_quiet").rec == (0, 0, 0, 0, 0)
    fed = run("fedavg_fires")
    assert fed.rec == (3, 3, 0, 1, 0) and sorted(fed.xfers) == [0] * 3 + [2] * 3
    assert run("fedavg_whole_fleet").rec == (M, M, 0, 1, 1)
    key0 = torch.zeros((2,), dtype=torch.int64)
    # the key moves only when a cohort draws
    assert torch.equal(run("fedavg_waits").state.key, key0)
    assert torch.equal(run("dynamic_random_quiet").state.key, key0)
    assert not torch.equal(fed.state.key, key0)
    assert not torch.equal(run("dynamic_max_distance").state.key, key0)
    assert run("dynamic_random").rec.syncs == 1


# every kwargs set raises the same error type and message in both
# packages (the port needs layout="flat" only where the reference would
# otherwise resolve its default "tree" layout)
BAD_CONFIGS = [
    dict(kind="periodic", b=0),
    dict(kind="dynamic", b=-2),
    dict(kind="periodic", fedavg_c=0.0),
    dict(kind="dynamic", fedavg_c=1.5),
    dict(kind="dynamic", delta=0.0),
    dict(kind="dynamic", delta=-1.0),
    dict(kind="dynamic", augmentation="bogus"),
    dict(kind="periodic", b=2.5),
    dict(kind="dynamic", bytes_per_param=0),
    dict(kind="periodic", layout="bogus"),
    dict(kind="bogus"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=[str(sorted(k.items())) for k in BAD_CONFIGS])
def test_config_validation_matches_reference(kw):
    with pytest.raises((ValueError, KeyError)) as want:
        JProtocolConfig(**{"layout": "flat", **kw})
    with pytest.raises(want.type) as got:
        ProtocolConfig(**kw)
    # an unknown kind lists the known kinds, which differ by design
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


@pytest.mark.parametrize("kw,what", [
    (dict(kind="aircomp", layout="sharded"), "Queue A 19"),
    (dict(kind="async_dynamic", layout="sharded"), "Queue A 19"),
    (dict(kind="robust_dynamic", layout="sharded"), "Queue A 19"),
    (dict(kind="robust_periodic", layout="sharded"), "Queue A 19"),
    (dict(kind="dynamic", layout="sharded"), "Queue A 19"),
])
def test_unported_options_raise_not_implemented(kw, what):
    JProtocolConfig(**kw)        # valid in the reference
    with pytest.raises(NotImplementedError, match=what):
        ProtocolConfig(**kw)


def test_default_layout_is_flat():
    spec = ProtocolConfig(kind="dynamic")._spec()
    assert spec.param("layout") == "flat"
    assert spec.trigger == "divergence"


# ---------------------------------------------------------------------------
# core/divergence.py
# ---------------------------------------------------------------------------

def _divergence_inputs(seed=4, m=5):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, 3, 4), dtype=np.float32)
    b = rng.standard_normal((m, 7), dtype=np.float32)
    r = {"a": rng.standard_normal((3, 4), dtype=np.float32),
         "b": rng.standard_normal((7,), dtype=np.float32)}
    jtree = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    ttree = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    jr = {k: jnp.asarray(v) for k, v in r.items()}
    tr = {k: torch.from_numpy(v) for k, v in r.items()}
    return jtree, ttree, jr, tr


@pytest.mark.parametrize("weights", [None, [1, 0, 2, 3, 0], [0, 0, 0, 0, 0]])
def test_tree_means_match_reference(weights):
    """The (weighted) learner mean, incl. the all-zero-weight guard (the
    zero model, not 0/0)."""
    jtree, ttree, _, _ = _divergence_inputs()
    if weights is None:
        want, got = jdiv.tree_mean(jtree), tdiv.tree_mean(ttree)
    else:
        want = jdiv.tree_weighted_mean(jtree, jnp.asarray(weights, jnp.float32))
        got = tdiv.tree_weighted_mean(ttree, torch.tensor(weights,
                                                          dtype=torch.float32))
    for k in ("a", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    if weights is not None and not any(weights):
        assert all(not got[k].any() for k in got)


def test_tree_mean_accumulates_bf16_in_f32():
    """A bf16 leaf is averaged in f32 and narrowed back; both packages round
    the f32 mean to bf16, so they agree within one bf16 ulp (2**-8
    relative) where the f32 means differ in their last bits."""
    x = np.random.default_rng(6).standard_normal((7, 33), dtype=np.float32)
    want = jdiv.tree_mean({"w": jnp.asarray(x, jnp.bfloat16)})["w"]
    got = tdiv.tree_mean({"w": torch.from_numpy(x).to(torch.bfloat16)})["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -8)


def test_distances_and_divergence_match_reference():
    jtree, ttree, jr, tr = _divergence_inputs()
    one_j = {k: v[1] for k, v in jtree.items()}
    one_t = {k: v[1] for k, v in ttree.items()}
    for use_kernel in (False, True):
        np.testing.assert_allclose(
            float(tdiv.sq_distance(one_t, tr, use_kernel=use_kernel)),
            float(jdiv.sq_distance(one_j, jr, use_kernel=use_kernel)),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tdiv.per_learner_sq_distance(ttree, tr).numpy(),
        np.asarray(jdiv.per_learner_sq_distance(jtree, jr)), rtol=1e-5,
        atol=1e-6)
    adapter = jflatten.fleet_adapter(jtree)
    X, r = adapter.ravel(jtree), adapter.ravel_model(jr)
    np.testing.assert_allclose(
        tdiv.per_learner_sq_distance_flat(torch.from_numpy(np.array(X)),
                                          torch.from_numpy(np.array(r)))
        .numpy(),
        np.asarray(jdiv.per_learner_sq_distance_flat(X, r)), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(float(tdiv.divergence(ttree)),
                               float(jdiv.divergence(jtree)), rtol=1e-5,
                               atol=1e-6)
