"""The port's telemetry plane against the reference's, on the CPU.

The record schema is the reference's (``SCHEMA_VERSION = 1``, the same
kinds and keys): the same inputs give the same record dicts, and the
same errors on a bad one. The same run streamed by both packages —
plain dynamic with ``per_link``, ``robust_dynamic`` under the
reference's ``HEAVY`` faults (tests/test_faults.py:112) with divergence
tracking and profiling, a hierarchy, and async periodic (the twin of
tests/test_async.py:332) — gives the same kinds in the same order and
the same keys in every record; every integer (rounds, messages, cohort,
syncs, bytes, per-link bytes, active / in-flight / age / fault /
quarantine counts, the chunk-end carried state) is exact, and every
float (loss, divergence, network time and their cumulative sums)
agrees to rtol 1e-5 (the f32 losses and parameters differ from the
reference's in the order sums are taken; profile wall-clocks are not
compared). The stream's last ``cum_*`` equals the live counters bit for
bit. Each package's observatory and CLI read the other's stream; a
resumed run appends to its stream with ``resumed_rounds``; the one-shot
``nonfinite_loss`` event lands in a stream once; the fault card
rebuilds from the stream; ``costs`` is not ported (ROADMAP Queue A 20).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.config import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.config import FaultConfig as JFaultConfig  # noqa: E402
from repro.config import HierarchyConfig as JHierarchyConfig  # noqa: E402
from repro.config import NetworkConfig as JNetworkConfig  # noqa: E402
from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TelemetryConfig as JTelemetryConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.protocol import DecentralizedLearner as JLearner  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.models.cnn import cnn_loss as jcnn_loss  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro.telemetry import observatory as jobs  # noqa: E402
from repro.telemetry import record as jrecord  # noqa: E402
from repro_torch.config import (  # noqa: E402
    AsyncConfig, FaultConfig, HierarchyConfig, NetworkConfig, ProtocolConfig,
    TelemetryConfig, TrainConfig, get_arch,
)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.models.cnn import cnn_loss  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    ChunkProfiler, get_logger, jsonl_handler, profiler_trace, timed,
)
from repro_torch.telemetry import observatory as obs  # noqa: E402
from repro_torch.telemetry import record  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SGD = dict(optimizer="sgd", learning_rate=0.05)
RTOL = 1e-5
HEAVY = dict(fault_seed=7, crash_prob=0.3, byzantine_frac=0.25,
             corrupt_prob=0.05, straggler_prob=0.3)
# chunk-record fields measured on the host clock: present alike, not equal
CLOCK_FIELDS = ("wall_s",)


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------

def test_records_are_the_reference_records():
    kw = dict(round=3, loss=1.5, cum_loss=4.25, divergence=0.0, messages=2,
              cohort=4, sync=1, full_sync=0, cum_syncs=2, num_active=5,
              net_time=0.01, cum_net_time=0.03, round_bytes=640,
              cum_bytes=1280, link_bytes=(1, 2), inflight=1, max_age=2,
              num_faulty=1, num_quarantined=0, num_recovered=1)
    assert record.RoundRecord(**kw).to_dict() == \
        jrecord.RoundRecord(**kw).to_dict()
    assert record.SCHEMA_VERSION == jrecord.SCHEMA_VERSION == 1
    meta = dict(m=2, model_size=10, model_bytes=40, msg_bytes=64,
                num_links=2, link_classes=("wired", "wifi"),
                spec={"name": "x"}, tiers=None, resumed_rounds=4)
    assert record.meta_record(**meta) == jrecord.meta_record(**meta)
    chunk = dict(chunk=1, rounds_end=8, n=8, link_bytes_cum=[3, 4],
                 stale_age={"age": [1, 2]}, wall_s=0.5, compiled=True,
                 recompiles=1)
    assert record.chunk_record(**chunk) == jrecord.chunk_record(**chunk)
    for bad in (dict(record.RoundRecord(**kw).to_dict(), v=2),
                dict(record.RoundRecord(**kw).to_dict(), cohort=1.5),
                {"kind": "nope"}, {"kind": "chunk", "v": 1}):
        with pytest.raises(ValueError) as want:
            jrecord.validate_record(bad, line=7)
        with pytest.raises(ValueError) as got:
            record.validate_record(bad, line=7)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the same run, streamed by both packages
# ---------------------------------------------------------------------------

def _batches(m, rounds, seed=0):
    streams = JStreams(JGraphical(seed=seed, drift_prob=0.0), m, batch=10,
                       seed=seed)
    return jax.tree.map(np.asarray, streams.next_chunk(rounds))


def _init():
    cfg = jget_arch("drift_mlp", smoke=True)
    return jax.tree.map(np.asarray, jinit(cfg, jax.random.split(
        jax.random.PRNGKey(0), 3)[0]))


def _hier(P, H):
    return P(kind="dynamic", b=2, delta=0.3, layout="flat",
             tiers=H(num_clusters=2, inter=P(kind="periodic", b=4,
                                             layout="flat")))


LTE_EDGE = dict(link_classes=("lte", "edge"))
CASES = {   # name -> (m, rounds, chunk, engine kwargs for each package)
    "dynamic": (6, 12, 6, lambda J: dict(
        proto=(JProtocolConfig if J else ProtocolConfig)(
            kind="dynamic", b=1, delta=0.05, layout="flat"),
        telemetry=dict(per_link=True))),
    "robust_heavy": (8, 16, 8, lambda J: dict(
        proto=(JProtocolConfig if J else ProtocolConfig)(
            kind="robust_dynamic", b=1, delta=0.05, layout="flat"),
        faults=(JFaultConfig if J else FaultConfig)(**HEAVY),
        track_divergence=True, telemetry=dict(profile=True))),
    "hierarchy": (6, 12, 12, lambda J: dict(
        proto=_hier(JProtocolConfig, JHierarchyConfig) if J
        else _hier(ProtocolConfig, HierarchyConfig),
        telemetry=dict(per_link=True))),
    "async": (4, 12, 12, lambda J: dict(
        proto=(JProtocolConfig if J else ProtocolConfig)(
            kind="periodic", b=1, layout="flat"),
        network=(JNetworkConfig if J else NetworkConfig)(**LTE_EDGE),
        async_net=(JAsyncConfig if J else AsyncConfig)(
            round_budget=1.0, payload_bytes=100_000),
        telemetry=dict(per_link=True))),
}


def _stream(case, path, port: bool, batches=None, telemetry=None):
    m, rounds, chunk, make = CASES[case]
    kw = make(not port)
    tele = dict(kw.pop("telemetry"), **(telemetry or {}))
    proto = kw.pop("proto")
    batches = _batches(m, rounds) if batches is None else batches
    if port:
        cfg = get_arch("drift_mlp", smoke=True)
        init = _init()
        dl = DecentralizedLearner(
            lambda p, b: cnn_loss(cfg, p, b),
            lambda g: params_from_numpy(init, device="cpu"), m, proto,
            TrainConfig(**SGD), telemetry=TelemetryConfig(path=path, **tele),
            device="cpu", **kw)
        for i in range(0, rounds, chunk):
            dl.run_chunk({k: torch.from_numpy(v[i:i + chunk].copy())
                          for k, v in batches.items()})
    else:
        cfg = jget_arch("drift_mlp", smoke=True)
        dl = JLearner(lambda p, b: jcnn_loss(cfg, p, b),
                      lambda k: jinit(cfg, k), m, proto,
                      JTrainConfig(**SGD),
                      telemetry=JTelemetryConfig(path=path, **tele), **kw)
        for i in range(0, rounds, chunk):
            dl.run_chunk(jax.tree.map(lambda x: x[i:i + chunk], batches))
    dl.recorder.close()
    return dl


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _same_value(got, want, where):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            if k not in CLOCK_FIELDS:
                _same_value(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same_value(a, b, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), where
        if math.isfinite(want) or math.isfinite(got):
            assert got == pytest.approx(want, rel=RTOL, abs=1e-6), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("streams")
    out = {}
    for case in CASES:
        paths = (str(d / f"{case}.port.jsonl"), str(d / f"{case}.ref.jsonl"))
        out[case] = (paths, _stream(case, paths[0], True),
                     _stream(case, paths[1], False))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_both_packages_stream_the_same_records(case, streams):
    (port_path, ref_path), _, _ = streams[case]
    got, want = _records(port_path), _records(ref_path)
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for i, (a, b) in enumerate(zip(got, want)):
        if b["kind"] == "meta":
            b = dict(b, spec=dict(b["spec"], params=dict(b["spec"]["params"],
                                                         layout="flat")))
        _same_value(a, b, f"{case} record {i} ({b['kind']})")


@pytest.mark.parametrize("case", list(CASES))
def test_last_cumulative_record_is_the_live_counters(case, streams):
    (port_path, _), dl, _ = streams[case]
    last = [r for r in _records(port_path) if r["kind"] == "round"][-1]
    assert last["round"] == dl.rounds
    same = lambda a, b: a == b or (math.isnan(a) and math.isnan(b))  # noqa
    assert same(last["cum_loss"], dl.cumulative_loss)      # bit for bit
    assert same(last["cum_net_time"], dl.network_time)
    assert last["cum_syncs"] == dl.comm_totals["syncs"]
    assert last["cum_bytes"] == dl.comm_bytes()
    chunk = [r for r in _records(port_path) if r["kind"] == "chunk"][-1]
    assert chunk["link_bytes_cum"] == dl.per_link_bytes().tolist()


def test_each_observatory_reads_the_others_stream(streams):
    for case in CASES:
        (port_path, ref_path), _, _ = streams[case]
        for load, summarize in ((obs.load_run, obs.summarize),
                                (jobs.load_run, jobs.summarize)):
            _same_value(summarize(load(port_path)),
                        jobs.summarize(jobs.load_run(ref_path)), case)
        assert obs.prom_text(obs.load_run(ref_path)).splitlines()[:3] == \
            jobs.prom_text(jobs.load_run(ref_path)).splitlines()[:3]


def test_each_cli_reads_the_others_stream(streams):
    (port_path, ref_path), _, _ = streams["robust_heavy"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    cards = {}
    for pkg, path in (("repro_torch", ref_path), ("repro", port_path)):
        out = subprocess.run(
            [sys.executable, "-m", f"{pkg}.telemetry", "summarize", path],
            capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        cards[pkg] = json.loads(out.stdout)
    _same_value(cards["repro"], cards["repro_torch"], "cli")
    assert cards["repro"]["faults"]["faulty_rounds"] > 0


def test_per_link_bytes_sum_to_the_round_bytes(streams):
    (port_path, _), _, _ = streams["dynamic"]
    rounds = [r for r in _records(port_path) if r["kind"] == "round"]
    assert all(sum(r["link_bytes"]) == r["round_bytes"] for r in rounds)
    assert any(r["round_bytes"] for r in rounds)


def test_fault_card_rebuilds_from_the_stream(streams):
    (port_path, ref_path), dl, ref = streams["robust_heavy"]
    card = obs.summarize(obs.load_run(port_path))["faults"]
    assert card["faulty_rounds"] > 0 and card["max_faulty"] >= 1
    assert card["faulty"] and card["quarantine"]
    rounds = obs.load_run(port_path).rounds
    assert [r["divergence"] for r in rounds] and all(
        r["divergence"] > 0 or not math.isfinite(r["divergence"])
        for r in rounds)
    _same_value(card, jobs.summarize(jobs.load_run(ref_path))["faults"],
                "card")


def test_telemetry_sees_inflight_and_ages(streams):
    """The twin of tests/test_async.py::test_telemetry_sees_inflight_and_
    ages: the edge exchanges fly one round."""
    (port_path, _), dl, _ = streams["async"]
    run = obs.load_run(port_path)
    assert [r["inflight"] for r in run.rounds] == [2, 0] * 6
    assert all(r["max_age"] == 0 for r in run.rounds)
    snap = run.chunks[-1]["stale_age"]
    assert sorted(snap) == ["age", "inflight", "lclock", "ring"]
    card = obs.summarize(run)
    assert sorted(card["state_ages"]) == ["age", "inflight", "lclock"]
    assert card["state_ages"]["inflight"]["max"] == 0
    assert card["inflight_last"] == 0 and card["max_age_last"] == 0
    assert card["inflight"][0][1] == 2
    assert dl.comm_totals["syncs"] == run.rounds[-1]["cum_syncs"]


def test_identical_runs_stream_identical_bytes(tmp_path, streams):
    (port_path, _), _, _ = streams["robust_heavy"]
    again = str(tmp_path / "again.jsonl")
    _stream("robust_heavy", again, True, telemetry=dict(profile=False))
    first = str(tmp_path / "first.jsonl")
    _stream("robust_heavy", first, True, telemetry=dict(profile=False))
    with open(first, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_resumed_run_appends_with_resumed_rounds(tmp_path):
    """8 rounds, counters saved; a fresh engine appends to the stream,
    restores the counters (a meta record with ``resumed_rounds``) and
    runs 8 more: one continuous stream both observatories read."""
    path = str(tmp_path / "run.jsonl")
    batches = _batches(6, 16)
    cfg = get_arch("drift_mlp", smoke=True)
    init = _init()

    def engine(append):
        return DecentralizedLearner(
            lambda p, b: cnn_loss(cfg, p, b),
            lambda g: params_from_numpy(init, device="cpu"), 6,
            ProtocolConfig(kind="dynamic", b=1, delta=0.05),
            TrainConfig(**SGD),
            telemetry=TelemetryConfig(path=path, append=append),
            device="cpu")

    def chunk(lo):
        return {k: torch.from_numpy(v[lo:lo + 8].copy())
                for k, v in batches.items()}

    first = engine(False)
    first.run_chunk(chunk(0))
    first.recorder.close()
    second = engine(True)
    second.restore_state(first.params, first.opt_state, first.sync_state)
    second.restore_counters(first.counters_state())
    second.run_chunk(chunk(8))
    second.recorder.close()
    for load in (obs.load_run, jobs.load_run):
        run = load(path)
        assert [r["round"] for r in run.rounds] == list(range(1, 17))
        assert [m["resumed_rounds"] for m in run.metas] == [0, 0, 8]
        assert run.resumed
    assert run.rounds[-1]["cum_loss"] == second.cumulative_loss


def test_nonfinite_loss_event_lands_in_the_stream_once(tmp_path):
    from repro_torch.telemetry.sink import TelemetrySink
    path = str(tmp_path / "events.jsonl")
    sink = TelemetrySink(path)
    handler = get_logger().add_handler(jsonl_handler(sink))
    try:
        cfg = get_arch("drift_mlp", smoke=True)
        dl = DecentralizedLearner(
            lambda p, b: cnn_loss(cfg, p, b),
            lambda g: params_from_numpy(_init(), device="cpu"), 4,
            ProtocolConfig(kind="dynamic", b=1, delta=0.05),
            TrainConfig(**SGD),
            faults=FaultConfig(fault_seed=7, corrupt_prob=0.3),
            device="cpu")
        batches = _batches(4, 16)
        for lo in (0, 8):
            dl.run_chunk({k: torch.from_numpy(v[lo:lo + 8].copy())
                          for k, v in batches.items()})
    finally:
        get_logger().remove_handler(handler)
        sink.close()
    events = [r for r in _records(path) if r["kind"] == "event"]
    assert [e["event"] for e in events] == ["nonfinite_loss"]
    assert events[0]["learners"] and events[0]["round"] == 8


def test_costs_is_not_ported_and_tools_run_on_the_cpu(tmp_path):
    from repro_torch.telemetry.__main__ import main
    with pytest.raises(NotImplementedError, match="Queue A 20"):
        main(["costs", str(tmp_path / "x.jsonl")])
    with profiler_trace(str(tmp_path / "trace")):
        out, seconds = timed(lambda: torch.ones(4).sum())
    assert float(out) == 4.0 and seconds >= 0.0
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    prof = ChunkProfiler()
    assert prof.begin(8) and not prof.begin(8)
    prof.observe(8, 2.0)
    prof.observe(8, 0.5)
    assert prof.summary() == {"recompiles": 1, "chunk_lengths": {"8": {
        "calls": 2, "compile_s": 2.0, "best_exec_s": 0.5, "total_s": 2.5}}}
