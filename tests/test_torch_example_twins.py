"""The seven example twins (``examples/torch_{async_fleet,concept_drift,
custom_protocol,fedavg_comparison,hierarchical_fleet,serve_demo,
unreliable_fleet}.py``) on the CPU:

* each twin's ``main`` at ``--device cpu --smoke`` runs to its
  ``torch_<name>_done`` line;
* each twin's helper at its smoke settings against the reference
  example's (its ``run_one`` / ``run`` where it has one, else the same
  calls through the reference's package), on the reference's batches
  (``ReplaySource``) from the reference's initial model: syncs and the
  comm counters, comm bytes and the per-link ledger exact, the sync
  windows, byte quartiles, member / uplink sums, in-flight counts and
  age histograms exact, network time within rtol 1e-6 and losses within
  rtol 1e-4 (``tests/test_torch_bench_cuts.py``'s tolerances); the serve
  demo's prompts and greedy tokens exact on the reference's weights, its
  samples' count. No distance of a dynamic run lies within 1e-4 of Delta
  of its threshold.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from benchmarks.torch_common import ReplaySource  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.data.synthetic import SyntheticMNIST as JMNIST  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.models.model import init_lm_params as jinit_lm  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.telemetry import get_logger as jget_logger  # noqa: E402
from repro.train.loop import run_drift_segments as jrun_drift  # noqa: E402
from repro.train.loop import run_protocol_training as jrun  # noqa: E402
from repro_torch.config import ProtocolConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.sync import ProtocolSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.telemetry import get_logger  # noqa: E402
from repro_torch.telemetry.observatory import load_run, summarize  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("async_fleet", "concept_drift", "custom_protocol",
         "fedavg_comparison", "hierarchical_fleet", "serve_demo",
         "unreliable_fleet")
LOSS_TOL = dict(rtol=1e-4)
NET_TIME_TOL = dict(rtol=1e-6)
DELTA_MARGIN = 1e-4


def _load(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init_fn(arch, smoke=True):
    """The reference's initial model of seed 0 (the first of
    ``split(PRNGKey(0), 3)``) as the port's ``init_fn``."""
    cfg = jget_arch(arch, smoke=smoke)
    init = _np(jinit(cfg, jax.random.split(jax.random.PRNGKey(0), 3)[0]))
    return lambda g: params_from_numpy(init, device="cpu")


def _jfns(arch, smoke=True):
    cfg = jget_arch(arch, smoke=smoke)
    return (lambda p, b: jcnn_loss(cfg, p, b)), (lambda k: jinit(cfg, k))


@pytest.fixture
def distances(monkeypatch):
    seen = []
    plain = ops.sqdist_rows

    def record(X, r):
        out = plain(X, r)
        seen.append(out.detach().numpy().copy())
        return out

    monkeypatch.setattr(ops, "sqdist_rows", record)
    return seen


def _off(seen, delta):
    d = np.concatenate([x.ravel() for x in seen])
    assert d.size and np.min(np.abs(d - delta)) >= DELTA_MARGIN * delta


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


def _mnist_chunk(m, rounds):
    return _np(JStreams(JMNIST(seed=0, image_size=14), m, batch=10,
                        seed=0).next_chunk(rounds))


@pytest.mark.parametrize("name", NAMES)
def test_twin_runs_at_smoke_size(name, capsys):
    _load(f"torch_{name}").main(["--device", "cpu", "--smoke"])
    assert f"torch_{name}_done" in capsys.readouterr().out


def test_async_fleet_is_the_references(tmp_path, distances):
    twin, ref = _load("torch_async_fleet"), _load("async_fleet")
    rounds, (name, proto) = 32, twin.PROTOCOLS[1]
    jproto = JProtocolConfig(kind="dynamic", b=2, delta=0.5)
    assert proto == ProtocolConfig(kind="dynamic", b=2, delta=0.5)
    jdl = ref.run_one(name, jproto, rounds, str(tmp_path / "ref.jsonl"),
                      jget_logger())
    batches = _np(JStreams(JGraphical(seed=0, drift_prob=0.0), twin.M,
                           batch=10, seed=0).next_chunk(rounds))
    dl = twin.run_one(name, proto, rounds, str(tmp_path / "port.jsonl"),
                      get_logger(), "cpu", ReplaySource([batches]),
                      _init_fn("drift_mlp"))
    _same(dl, jdl, network_time=True)
    got, want = (summarize(load_run(str(tmp_path / f)))
                 for f in ("port.jsonl", "ref.jsonl"))
    for key in ("cum_syncs", "cum_bytes", "inflight_last", "max_age_last",
                "state_ages"):
        assert got.get(key) == want.get(key), key
    assert 0 < jdl.comm_totals["syncs"]
    _off(distances, 0.5)


def test_concept_drift_is_the_references(distances):
    twin = _load("torch_concept_drift")
    rounds, drifts = twin.SMOKE
    _, proto = twin.PROTOCOLS[1]
    loss, init = _jfns("drift_mlp", smoke=False)
    jsrc = JGraphical(seed=1, drift_prob=0.0)
    jdl = JLearner(loss, init, twin.M,
                   JProtocolConfig(kind="dynamic", b=2, delta=0.5),
                   JTrainConfig(optimizer="sgd", learning_rate=0.1))
    jhist, _ = jrun_drift(jdl, JStreams(jsrc, twin.M, batch=10, seed=0),
                          jsrc, rounds, drifts)
    src, chunks = JGraphical(seed=1, drift_prob=0.0), []
    streams = JStreams(src, twin.M, batch=10, seed=0)
    for start, end in zip((0,) + drifts, drifts + (rounds,)):
        if start:
            src.force_drift()
        chunks.append(_np(streams.next_chunk(end - start)))
    dl, hist = twin.run(proto, rounds, drifts, "cpu", ReplaySource(chunks),
                        _init_fn("drift_mlp", smoke=False))
    _same(dl, jdl)
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(jhist))
    assert twin.windows(hist, rounds, drifts) == twin.windows(
        np.asarray(jhist), rounds, drifts)
    assert 0 < int(jhist[-1])
    _off(distances, 0.5)


def test_custom_protocol_is_the_references():
    twin, ref = _load("torch_custom_protocol"), _load("custom_protocol")
    rounds = twin.SMOKE[1]                  # the JSON reruns' rounds
    jspec = ref.PROTOCOLS["stale_fedavg"]
    spec = twin.PROTOCOLS["stale_fedavg"]
    assert ProtocolSpec.from_json(jspec.to_json()) == spec
    assert ProtocolSpec.from_json(spec.to_json()) == spec
    jdl = ref.run("stale_fedavg", jspec, rounds=rounds)
    dl = twin.run("stale_fedavg", spec, rounds, "cpu",
                  ReplaySource([_mnist_chunk(twin.M, rounds)]),
                  _init_fn("mnist_cnn"))
    _same(dl, jdl, network_time=True)
    assert 0 < jdl.comm_totals["syncs"]


def test_fedavg_comparison_is_the_references():
    twin = _load("torch_fedavg_comparison")
    rounds = twin.SMOKE_ROUNDS
    loss, init = _jfns("mnist_cnn")
    jdl, jtraj = jrun(loss, init, JMNIST(seed=0, image_size=14), m=twin.M,
                      rounds=rounds,
                      protocol=JProtocolConfig(kind="fedavg", b=10,
                                               fedavg_c=0.3),
                      train=JTrainConfig(optimizer="sgd", learning_rate=0.1),
                      batch=10, seed=0, record_every=10)
    dl, traj = twin.run(twin.PROTOCOLS[0][1], rounds, "cpu",
                        ReplaySource([_mnist_chunk(twin.M, rounds)]),
                        _init_fn("mnist_cnn"))
    _same(dl, jdl)
    assert twin.quartiles(traj) == twin.quartiles(jtraj)


def test_hierarchical_fleet_is_the_references(distances):
    twin, ref = _load("torch_hierarchical_fleet"), _load("hierarchical_fleet")
    rounds = twin.SMOKE_ROUNDS
    loss, init = _jfns("mnist_cnn")
    jdl, _ = jrun(loss, init, JMNIST(seed=0, image_size=14), m=twin.M,
                  rounds=rounds, protocol=ref.TWO_TIER,
                  train=JTrainConfig(optimizer="sgd", learning_rate=0.1),
                  batch=10, seed=0, network=ref.FLEET)
    dl, member, uplink = twin.run(
        twin.TWO_TIER, rounds, "cpu",
        ReplaySource([_mnist_chunk(twin.M, rounds)]), _init_fn("mnist_cnn"))
    _same(dl, jdl, network_time=True)
    ledger = np.asarray(jdl.per_link_bytes())
    assert (member, uplink) == (int(ledger[:twin.M].sum()),
                                int(ledger[twin.M:].sum()))
    assert uplink > 0
    _off(distances, 0.5)


def test_unreliable_fleet_is_the_references():
    """Gossip over the mobile overlay, the example's own protocol (its
    dynamic and periodic runs are the network tests' cases)."""
    twin, ref = _load("torch_unreliable_fleet"), _load("unreliable_fleet")
    rounds = twin.SMOKE_ROUNDS
    loss, init = _jfns("mnist_cnn")
    _, proto = twin.PROTOCOLS[2]
    assert proto == ProtocolConfig(kind="gossip", b=10)
    jdl, _ = jrun(loss, init, JMNIST(seed=0, image_size=14), m=twin.M,
                  rounds=rounds, protocol=JProtocolConfig(kind="gossip", b=10),
                  train=JTrainConfig(optimizer="sgd", learning_rate=0.1),
                  batch=10, seed=0, network=ref.FLEET)
    dl = twin.run(proto, rounds, "cpu",
                  ReplaySource([_mnist_chunk(twin.M, rounds)]),
                  _init_fn("mnist_cnn"))
    _same(dl, jdl, network_time=True)
    assert dl.mean_active() == jdl.mean_active()
    assert 0 < jdl.comm_totals["syncs"]


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b"])
def test_serve_demo_is_the_references(arch):
    twin = _load("torch_serve_demo")
    gen = twin.SMOKE_GEN
    jcfg = jget_arch(arch, smoke=True)
    jparams = jinit_lm(jcfg, jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1),
                                 (twin.BATCH, twin.PROMPT), 0,
                                 jcfg.vocab_size)
    eng = JServeEngine(jcfg, jparams, max_seq=twin.PROMPT + gen + 1,
                       batch=twin.BATCH)
    want = eng.generate(gen, first_logits=eng.feed(prompts))
    got = twin.demo(arch, gen, "cpu",
                    params=params_from_numpy(_np(jparams), device="cpu"))
    np.testing.assert_array_equal(got["prompts"].numpy(),
                                  np.asarray(prompts))
    np.testing.assert_array_equal(got["greedy"].numpy(), np.asarray(want))
    assert got["sampled"].shape == (twin.BATCH, gen)
    assert got["prefill_gap"] < 1e-4
