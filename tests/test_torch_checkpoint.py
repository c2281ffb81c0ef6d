"""The port's checkpoints against the reference's, on the CPU.

Both packages write the same files: for a flat dynamic run (adam, so the
optimizer moments are saved), bounded staleness (extra carried state), a
hierarchical run and an async run, the three npz files hold the same
keys, dtypes and shapes, and the spec sidecar is the same text. Each
package loads the other's checkpoint and continues: 8 more rounds after
the restore match the uninterrupted run of the other package (comm,
ledger and counters exact, parameters within atol / rtol 1e-5). Also:
the crash-mid-save cases of tests/test_faults.py (a dying ``np.savez``
or sidecar write leaves the previous checkpoint, and no temp file), an
old checkpoint with no spec and no extra state, the hierarchical
sidecar's ``tiers`` block, ``counters_state``'s keys and
``restore_counters``' errors, and the spec's JSON round trip.
"""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import repro.checkpoint.io as jio  # noqa: E402
from repro.config import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.config import HierarchyConfig as JHierarchyConfig  # noqa: E402
from repro.config import NetworkConfig as JNetworkConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.core.sync.spec import ProtocolSpec as JProtocolSpec  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.optim.optimizers import OptState as JOptState  # noqa: E402
import repro_torch.checkpoint.io as io  # noqa: E402
from repro_torch.config import (  # noqa: E402
    AsyncConfig, HierarchyConfig, NetworkConfig, ProtocolConfig, TrainConfig,
    get_arch,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.core.sync import PROTOCOLS  # noqa: E402
from repro_torch.core.sync.kernel import init_state  # noqa: E402
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec  # noqa: E402
from repro_torch.models.cnn import cnn_loss  # noqa: E402

M = 6
RING = dict(act_prob=0.6, topology="ring", link_classes=("wifi", "lte"))
TOL = dict(rtol=1e-5, atol=1e-5)


def _hier(P, H):
    return P(kind="dynamic", b=2, delta=0.3, layout="flat",
             tiers=H(num_clusters=3, link_class="lte",
                     inter=P(kind="dynamic", b=2, delta=0.6,
                             layout="flat")))


# name -> (protocol(P, H), train kwargs, network, AsyncConfig kwargs)
CASES = {
    "flat_dynamic": (lambda P, H: P(kind="dynamic", b=2, delta=0.3,
                                    layout="flat"),
                     dict(optimizer="adam", learning_rate=0.01), None, None),
    "stale": (lambda P, H: P(kind="stale", layout="flat"),
              dict(optimizer="momentum", learning_rate=0.05), RING, None),
    "hierarchical": (_hier, dict(optimizer="sgd", learning_rate=0.05), RING,
                     None),
    "async": (lambda P, H: P(kind="dynamic", b=2, delta=0.3, layout="flat"),
              dict(optimizer="sgd", learning_rate=0.05),
              dict(link_classes=("wifi", "lte")),
              dict(payload_bytes=10_000_000, max_delay=8)),
}


def _engines(case):
    """A fresh reference engine, a port engine from its initial model,
    and 16 rounds of batches."""
    proto, train, net, an = CASES[case]
    cfg = jget_arch("drift_mlp", smoke=True)
    streams = JStreams(JGraphical(seed=0, drift_prob=0.0), M, batch=10,
                       seed=0)
    ref = JLearner(lambda p, b: jcnn_loss(cfg, p, b), lambda k: jinit(cfg, k),
                   M, proto(JProtocolConfig, JHierarchyConfig),
                   JTrainConfig(**train),
                   network=None if net is None else JNetworkConfig(**net),
                   async_net=None if an is None else JAsyncConfig(**an))
    init = jax.tree.map(np.asarray, ref.learner_model(0))
    tcfg = get_arch("drift_mlp", smoke=True)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(tcfg, p, b),
        lambda g: params_from_numpy(init, device="cpu"), M,
        proto(ProtocolConfig, HierarchyConfig), TrainConfig(**train),
        network=None if net is None else NetworkConfig(**net),
        async_net=None if an is None else AsyncConfig(**an), device="cpu")
    batches = jax.tree.map(np.asarray, streams.next_chunk(16))
    return ref, dl, batches


def _half(batches, second, port):
    part = {k: v[8:] if second else v[:8] for k, v in batches.items()}
    if port:
        return {k: torch.from_numpy(v.copy()) for k, v in part.items()}
    return part


@functools.lru_cache(maxsize=None)
def _saved(case, tmp):
    """Both packages' checkpoints after 8 rounds, and both runs continued
    uninterrupted to round 16."""
    ref, dl, batches = _engines(case)
    ref.run_chunk(_half(batches, False, False))
    dl.run_chunk(_half(batches, False, True))
    paths = {"ref": os.path.join(tmp, case + "_ref"),
             "port": os.path.join(tmp, case + "_port")}
    jio.save_protocol_state(paths["ref"], ref.params, ref.opt_state,
                            ref.sync_state, protocol=ref.protocol,
                            counters=ref.counters_state())
    io.save_protocol_state(paths["port"], dl.params, dl.opt_state,
                           dl.sync_state, protocol=dl.protocol,
                           counters=dl.counters_state())
    ref.run_chunk(_half(batches, True, False))
    dl.run_chunk(_half(batches, True, True))
    return paths, ref, dl, batches


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.mark.parametrize("case", list(CASES))
def test_same_files_as_the_reference(case, ckpt_dir):
    paths, _, _, _ = _saved(case, ckpt_dir)
    for part in ("params", "opt", "sync"):
        want = np.load(f"{paths['ref']}.{part}.npz")
        got = np.load(f"{paths['port']}.{part}.npz")
        assert sorted(got.files) == sorted(want.files), part
        for key in want.files:
            assert (got[key].dtype, got[key].shape) == \
                (want[key].dtype, want[key].shape), key
    with open(paths["ref"] + ".spec.json") as a, \
            open(paths["port"] + ".spec.json") as b:
        assert a.read() == b.read()
    with open(paths["ref"] + ".counters.json") as a, \
            open(paths["port"] + ".counters.json") as b:
        want, got = json.load(a), json.load(b)
    assert sorted(got) == sorted(want)
    for key in ("rounds", "comm_totals", "active_rounds_total",
                "link_xfer_totals", "link_bytes_totals"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("case", list(CASES))
def test_each_package_continues_the_others_run(case, ckpt_dir):
    paths, ref_done, port_done, batches = _saved(case, ckpt_dir)
    ref, dl, _ = _engines(case)

    # the port resumes the reference's checkpoint
    dl.restore_state(*io.load_protocol_state(paths["ref"], device="cpu"))
    dl.restore_counters(io.load_counters(paths["ref"]))
    assert io.load_protocol_spec(paths["ref"]) == resolve_spec(dl.protocol)
    dl.run_chunk(_half(batches, True, True))

    # the reference resumes the port's, as its callers do: by assigning
    params, opt, state = jio.load_protocol_state(paths["port"])
    ref.params, ref.sync_state = params, state
    ref.opt_state = JOptState(step=opt[".step"], mu=opt.get(".mu"),
                              nu=opt.get(".nu"))
    ref.restore_counters(jio.load_counters(paths["port"]))
    ref.run_chunk(_half(batches, True, False))

    for resumed, done in ((dl, ref_done), (ref, port_done), (dl, port_done)):
        assert resumed.comm_totals == done.comm_totals
        np.testing.assert_array_equal(resumed.per_link_bytes(),
                                      done.per_link_bytes())
        np.testing.assert_array_equal(resumed.link_xfer_totals,
                                      done.link_xfer_totals)
        assert resumed.rounds == done.rounds == 16
        np.testing.assert_allclose(resumed.network_time, done.network_time,
                                   rtol=1e-6)
    want = np.asarray(jfleet_adapter(ref_done.params).ravel(ref_done.params))
    np.testing.assert_allclose(dl.X.numpy(), want, **TOL)
    got = np.asarray(jfleet_adapter(ref.params).ravel(ref.params))
    np.testing.assert_allclose(got, want, **TOL)
    # the port's resume of its own checkpoint is the uninterrupted run
    own = _engines(case)[1]
    own.restore_state(*io.load_protocol_state(paths["port"], device="cpu"))
    own.restore_counters(io.load_counters(paths["port"]))
    own.run_chunk(_half(batches, True, True))
    assert torch.equal(own.X, port_done.X)
    assert own.counters_state() == port_done.counters_state()


def test_hierarchical_sidecar_keeps_tiers(ckpt_dir):
    paths, _, dl, _ = _saved("hierarchical", ckpt_dir)
    for path in paths.values():
        assert io.load_protocol_spec(path) == ProtocolSpec.from_dict(
            dl.spec.to_dict())
        tiers = io.load_protocol_tiers(path)
        assert tiers["num_clusters"] == 3 and tiers["link_class"] == "lte"
        assert tiers["inter"].to_dict() == \
            dl.tiers.inter._spec().to_dict()
    assert io.load_protocol_tiers(_saved("stale", ckpt_dir)[0]["port"]) \
        is None


def test_old_checkpoint_without_spec_or_extra_loads(tmp_path):
    """A checkpoint written without a spec sidecar and with no extra
    state, by either package, loads with empty extras and no spec."""
    rng = np.random.default_rng(0)
    stacked = {"w0": rng.standard_normal((4, 3, 2), dtype=np.float32),
               "w1": rng.standard_normal((4, 5), dtype=np.float32)}
    mean = {k: v.mean(axis=0) for k, v in stacked.items()}
    from repro.core import operators as jops
    jio.save_protocol_state(str(tmp_path / "ref"), stacked,
                            JOptState(step=np.zeros((4,), np.int32)),
                            jops.init_state(mean))
    tstacked = params_from_numpy(stacked, device="cpu")
    row = torch.cat([torch.from_numpy(mean[k]).reshape(-1)
                     for k in sorted(mean)])
    from repro_torch.optim.optimizers import OptState
    io.save_protocol_state(str(tmp_path / "port"), tstacked, OptState(0),
                           init_state(row))
    for name in ("ref", "port"):
        _, opt, state = io.load_protocol_state(str(tmp_path / name),
                                               device="cpu")
        assert state.extra == {} and state.v == 0 and state.step == 0
        assert (opt.step == 0).all() and opt.mu is None
        assert torch.equal(state.ref, row)
        assert io.load_protocol_spec(str(tmp_path / name)) is None
        assert io.load_counters(str(tmp_path / name)) is None
        _, _, jstate = jio.load_protocol_state(str(tmp_path / name))
        assert jstate.extra == {}


def _checkpointable():
    _, dl, batches = _engines("stale")
    dl.run_chunk(_half(batches, False, True))
    return dl, batches


def _digest(params):
    return b"".join(np.asarray(v).tobytes() for v in
                    jax.tree.leaves(params))


def test_checkpoint_crash_mid_save_keeps_previous(tmp_path, monkeypatch):
    dl, batches = _checkpointable()
    base = str(tmp_path / "ckpt")
    io.save_protocol_state(base, dl.params, dl.opt_state, dl.sync_state,
                           protocol=dl.spec, counters={"rounds": 8})
    want = _digest(jio.load_protocol_state(base)[0])
    real_savez = np.savez

    def dying_savez(f, **kw):
        f.write(b"this is not an npz")             # partial garbage...
        raise RuntimeError("simulated crash mid-write")

    monkeypatch.setattr(np, "savez", dying_savez)
    dl.run_chunk(_half(batches, True, True))       # newer state to save
    with pytest.raises(RuntimeError, match="simulated crash"):
        io.save_protocol_state(base, dl.params, dl.opt_state, dl.sync_state)
    monkeypatch.setattr(np, "savez", real_savez)
    # the previous complete checkpoint loads in both packages; no litter
    assert _digest(jio.load_protocol_state(base)[0]) == want
    assert _digest(io.load_protocol_state(base, device="cpu")[0]) == want
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_checkpoint_crash_mid_sidecar_keeps_previous(tmp_path, monkeypatch):
    dl, _ = _checkpointable()
    base = str(tmp_path / "ckpt")
    io.save_protocol_state(base, dl.params, dl.opt_state, dl.sync_state,
                           counters={"rounds": 4})

    def dying_text(path, text):
        raise RuntimeError("simulated crash before sidecar write")

    monkeypatch.setattr(io, "_atomic_text", dying_text)
    with pytest.raises(RuntimeError):
        io.save_protocol_state(base, dl.params, dl.opt_state, dl.sync_state,
                               counters={"rounds": 9})
    monkeypatch.undo()
    assert io.load_counters(base) == {"rounds": 4}
    assert jio.load_counters(base) == {"rounds": 4}


def test_counters_state_has_the_reference_keys(ckpt_dir):
    _, ref, dl, _ = _saved("hierarchical", ckpt_dir)
    want, got = ref.counters_state(), dl.counters_state()
    assert sorted(got) == sorted(want)
    assert got["comm_totals"] == want["comm_totals"]
    assert got["link_bytes_totals"] == want["link_bytes_totals"]
    assert len(got["link_bytes_totals"]) == M + 3
    json.dumps(got)


@pytest.mark.parametrize("bad", ["learners", "links", "counter"])
def test_restore_counters_raises_the_reference_errors(bad, ckpt_dir):
    _, ref, dl, _ = _saved("hierarchical", ckpt_dir)
    good = ref.counters_state()
    snap = {
        "learners": {**good, "cumulative_loss_per_learner": [0.0] * (M + 1)},
        "links": {**good, "link_bytes_totals": [0] * M},
        "counter": {**good, "comm_totals": {**good["comm_totals"],
                                            "bogus": 1}},
    }[bad]
    with pytest.raises(ValueError) as want:
        ref.restore_counters(snap)
    with pytest.raises(ValueError) as got:
        dl.restore_counters(snap)
    assert str(got.value) == str(want.value)


def test_restore_state_rejects_the_other_kind_of_state(ckpt_dir):
    paths, _, _, _ = _saved("hierarchical", ckpt_dir)
    _, flat, _ = _engines("flat_dynamic")
    with pytest.raises(ValueError, match="HierSyncState"):
        flat.restore_state(*io.load_protocol_state(paths["port"],
                                                   device="cpu"))


SPECS = [
    PROTOCOLS["stale"].with_params(tau=3),
    PROTOCOLS["async_dynamic"],
    ProtocolConfig(kind="fedavg", b=3, fedavg_c=0.5, layout="tree")._spec(),
    ProtocolSpec(trigger="staleness", cohort="balanced", commit="balancing",
                 params={"tau": 2, "delta": 0.25}, name="stale_balanced"),
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_spec_json_round_trips_as_the_reference_writes_it(spec):
    text = spec.to_json()
    assert text == JProtocolSpec.from_json(text).to_json()
    assert ProtocolSpec.from_json(text) == spec
    assert ProtocolSpec.from_dict(json.loads(text)) == spec
    with pytest.raises(ValueError, match="unknown ProtocolSpec keys"):
        ProtocolSpec.from_dict({**spec.to_dict(), "bogus": 1})
    with pytest.raises(ValueError, match="needs at least 'trigger'"):
        ProtocolSpec.from_dict({"cohort": "balanced"})
