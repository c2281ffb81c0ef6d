"""The port's analysis tools (``repro_torch.analysis``, ``telemetry.costs``)
against the JAX package's, on the CPU.

Two halves, as tests/test_static_analysis.py: the port itself passes
every analyzer clean (``python -m repro_torch.analysis --check-all``),
and the reference's deliberately broken stages and sources, rebuilt in
the port's terms, each draw the finding kind the reference's draw. The
reference's ``callback-in-scan`` is the port's ``host-sync`` (a round
that waits for the device), and its jaxpr-only rules (weak types,
dynamic shapes, HLO text) have no port. Then: the audit's host-sync
count equals the documented budget on every preset and on an engine's
chunk; ``kernel_bound`` gives PERF.md §6's bounds; ``round_costs``'
gate/skip/sync shares hold the reference's within 0.15 (the reference
counts its gate's ``t % b``, counters and masks as device arithmetic,
12 FLOPs a round on a cadence gate; the port's are host values, which no
dispatch mode sees — the async presets, whose timeline is all such
arithmetic, are left out); and ``python -m repro_torch.telemetry costs``
reads a stream that either package wrote, with the reference's keys.
"""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro_torch.core.sync  # noqa: E402,F401 — fill the registries
import repro_torch.core.sync.registry as reg  # noqa: E402
from repro_torch.analysis import audit, contracts, lint, roofline  # noqa: E402
from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402
from repro_torch.core.sync.registry import (  # noqa: E402
    CohortOut, CommRecord, StageContract, SyncOut, register_aggregate,
    register_commit, register_trigger,
)
from repro_torch.core.sync.spec import ProtocolSpec  # noqa: E402
from repro_torch.core.sync.stages import cohort_all  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REGISTRIES = ("TRIGGERS", "COHORTS", "AGGREGATES", "COMMITS", "PROTOCOLS")
PRESETS = sorted(reg.PROTOCOLS)


@pytest.fixture
def registry_sandbox():
    """Registrations are global: snapshot the stage registries and the
    presets, and restore them after the test."""
    saved = {n: dict(getattr(reg, n)) for n in _REGISTRIES}
    try:
        yield reg
    finally:
        for n, d in saved.items():
            live = getattr(reg, n)
            live.clear()
            live.update(d)


# ---------------------------------------------------------------------------
# the port itself is clean
# ---------------------------------------------------------------------------

def test_every_registered_stage_declares_a_contract():
    assert contracts.check_registry() == []


def test_contract_matrix_clean_all_presets_all_layouts():
    findings = contracts.check_preset_matrix()
    assert findings == [], [f.render() for f in findings]


def test_audit_clean_all_presets():
    findings = audit.audit_presets()
    assert findings == [], [f.render() for f in findings]


def test_lint_clean_port():
    paths = [os.path.join(ROOT, "src", "repro_torch"),
             os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "examples", f)
        for f in sorted(os.listdir(os.path.join(ROOT, "examples")))
        if f.startswith("torch_")]
    findings = lint.lint_paths(paths)
    assert findings == [], [f.render() for f in findings]


def test_cli_check_all_exits_zero():
    out = io.StringIO()
    with redirect_stdout(out):
        assert analysis_main(["--check-all"]) == 0
    assert out.getvalue().startswith("OK: contracts + audit + lint clean")


@pytest.mark.parametrize("name", PRESETS)
def test_layout_equivalence_every_preset(name):
    """tree, flat and one rank of sharded: one signature; flat and
    sharded the same values, bit for bit."""
    spec = reg.get_protocol(name)
    for weighted in (False, True):
        assert contracts.check_layout_equivalence(spec,
                                                  weighted=weighted) == []


def test_host_reading_stages_are_the_documented_ones():
    assert contracts.host_reading_stages() == [
        "aggregate:aircomp", "trigger:divergence",
        "trigger:events_divergence", "trigger:robust_cadence",
        "trigger:robust_divergence"]


# ---------------------------------------------------------------------------
# broken fixtures: each rule catches the bug built for it
# ---------------------------------------------------------------------------

def test_wrong_dtype_aggregate_is_caught(registry_sandbox):
    """An aggregate that returns its mean in float64 breaks its
    out='model' contract, and the round's carried reference with it."""
    @register_aggregate("fx_f64_mean", contract=StageContract(
        summary="broken: promotes to f64", out="model"))
    def bad_agg(ctx, cout):
        return torch.mean(ctx.flat.double(), dim=0)

    spec = ProtocolSpec(trigger="cadence", cohort="all_reachable",
                        aggregate="fx_f64_mean", commit="average",
                        name="fx-f64")
    findings = contracts.check_spec(spec)
    assert "aggregate-out" in {f.rule for f in findings}, \
        [f.render() for f in findings]
    assert any(f.rule in ("round-params", "round-ref", "trace-error")
               for f in contracts.check_round(spec))


def test_undeclared_counter_owner_is_caught(registry_sandbox):
    @reg.register_cohort("fx_rogue_v", provides=("full-cohort",),
                         contract=StageContract(summary="broken: rogue v"))
    def rogue(ctx, hot, nhot, key):
        return CohortOut(mask=cohort_all(ctx.m, ctx.active), key=key, v=0,
                         full=False)

    spec = ProtocolSpec(trigger="cadence", cohort="fx_rogue_v",
                        name="fx-rogue")
    assert "counter-owner" in {f.rule for f in contracts.check_spec(spec)}


def test_int32_ledger_accumulator_is_caught(registry_sandbox):
    """A trigger carrying an int32 per-learner byte counter that grows by
    a data-dependent amount with no reset: the silent-wrap bug the int64
    host ledger exists to avoid."""
    @register_trigger(
        "fx_bytes", params={"b": 1},
        init_extra=lambda p, m: {"bytes": np.zeros((m,), np.int32)},
        commit_extra=lambda ctx, mask: {
            "bytes": (ctx.state.extra["bytes"]
                      + mask.astype(np.int32) * 1000).astype(np.int32)},
        skip_extra=lambda ctx: dict(ctx.state.extra),
        contract=StageContract(summary="broken: int32 byte ledger",
                               extra_state=(("bytes", "int32"),)))
    def gate(ctx):
        return ctx.t % ctx.params["b"] == 0

    spec = ProtocolSpec(trigger="fx_bytes", name="fx-bytes")
    findings = audit.audit_spec(spec)
    assert any(f.rule == "int32-accumulator" for f in findings), \
        [f.render() for f in findings]
    # the contract checker accepts it: wrapping is a property of the run
    assert contracts.check_spec(spec) == []


def test_host_sync_in_a_round_is_caught(registry_sandbox):
    """The port's callback-in-scan: a gate that reads the plane on the
    host waits for the device every round, beyond the budget."""
    @register_trigger("fx_chatty", params={"b": 1},
                      contract=StageContract(summary="broken: host read"))
    def gate(ctx):
        return float(ctx.flat.sum()) > -1e30 and ctx.t % ctx.params["b"] == 0

    spec = ProtocolSpec(trigger="fx_chatty", name="fx-chatty")
    findings = audit.audit_spec(spec)
    assert any(f.rule == "host-sync" for f in findings), \
        [f.render() for f in findings]


def test_missing_contract_is_caught(registry_sandbox):
    @register_commit("fx_bare", needs=("full-cohort",))
    def bare_commit(ctx, cout, mean, hot, nhot):
        return SyncOut(ctx.flat, ctx.ref_flat, ctx.state.v, cout.key,
                       CommRecord.zero(), np.zeros((ctx.m,), np.int32),
                       np.zeros((ctx.m,), np.int32))

    findings = contracts.check_registry()
    assert any(f.rule == "missing-contract" and "fx_bare" in f.where
               for f in findings)


def test_extra_state_declaration_mismatch_is_caught(registry_sandbox):
    @register_trigger(
        "fx_wrong_decl", params={"b": 1},
        init_extra=lambda p, m: {"age": np.zeros((m,), np.int32)},
        contract=StageContract(summary="broken: declares float32",
                               extra_state=(("age", "float32"),)))
    def gate(ctx):
        return ctx.t % ctx.params["b"] == 0

    findings = contracts.check_registry()
    assert any(f.rule == "extra-state" and "fx_wrong_decl" in f.where
               for f in findings)


# ---------------------------------------------------------------------------
# auditor unit rules
# ---------------------------------------------------------------------------

def test_audit_flags_data_dependent_int32_carry():
    rng = np.random.default_rng(0)
    acc, series = np.zeros((3,), np.int32), []
    for _ in range(4):
        acc = (acc + rng.integers(2, 50, 3)).astype(np.int32)
        series.append({"acc": acc.copy()})
    assert any(f.rule == "int32-accumulator"
               for f in audit.audit_carry(series))


def test_audit_exempts_clock_and_reset_counters():
    """The engine's idioms stay clean: a +1 clock, a counter that resets,
    an int64 ledger."""
    series = []
    clock, ages = np.zeros((3,), np.int32), np.zeros((3,), np.int32)
    ledger = np.zeros((3,), np.int64)
    for t in range(6):
        clock = clock + 1
        ages = np.where(np.arange(3) == t % 3, 0, ages + 1).astype(np.int32)
        ledger = ledger + 1000
        series.append({"clock": clock.copy(), "ages": ages.copy(),
                       "ledger": ledger.copy()})
    assert audit.audit_carry(series) == []


def test_audit_flags_float64_leak():
    with audit.HostSyncMode("cpu") as mode:
        torch.ones(3).double() * 2
    assert mode.leaks
    assert any(f.rule == "float64-leak"
               for f in audit._sync_findings("fx", mode, budget=0))


# ---------------------------------------------------------------------------
# the host-sync budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS)
def test_host_sync_count_is_the_documented_budget(name):
    findings, counts = audit._audit_spec(reg.get_protocol(name), None,
                                         rounds=4, device="cpu")
    assert findings == []
    assert counts["syncs"] == counts["budget"], counts


def test_learner_chunk_host_syncs_are_the_budget():
    """One engine chunk of dynamic: 1 for the chunk, 1 per checked round,
    1 per safe-zone test."""
    from repro_torch.config import ProtocolConfig, TrainConfig, get_arch
    from repro_torch.core.protocol import DecentralizedLearner
    from repro_torch.data.pipeline import LearnerStreams
    from repro_torch.data.synthetic import GraphicalModelStream
    from repro_torch.models.cnn import cnn_loss, init_cnn_params
    cfg = get_arch("drift_mlp", smoke=True)
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: init_cnn_params(cfg, g), 6,
        ProtocolConfig(kind="dynamic", b=2, delta=0.05),
        TrainConfig(optimizer="sgd", learning_rate=0.1), device="cpu")
    streams = LearnerStreams(GraphicalModelStream(seed=0, drift_prob=0.0,
                                                  device="cpu"), 6,
                             batch=10, seed=0)
    got = audit.audit_learner(dl, streams.next_chunk(12))
    assert got["findings"] == []
    assert got["checked"] == 6 and got["synced"] > 0
    assert got["syncs"] == got["budget"] == \
        1 + got["checked"] + got["safe_zone_tests"]


# ---------------------------------------------------------------------------
# lint rules on source fixtures
# ---------------------------------------------------------------------------

def test_lint_bare_assert_and_version_probe():
    src = "import torch\nassert True\nv = torch.__version__\n"
    rules = {f.rule for f in lint.lint_source(src, "pkg/module.py")}
    assert rules == {"bare-assert", "torch-version"}
    assert not any(f.rule == "torch-version" for f in lint.lint_source(
        src, "repro_torch/device.py"))


@pytest.mark.parametrize("bad", [
    "import time\n", "import random\n", "from datetime import date\n",
    "import numpy as np\nx = np.random.rand(3)\n",
    "import torch\ng = torch.Generator()\n",
    "def f(g):\n    g.manual_seed(1)\n",
    "from repro_torch import prng\nk = prng.split(0)\n",
    "X = 1\ndef f():\n    global X\n"])
def test_lint_network_purity(bad):
    findings = lint.lint_source(bad, "src/repro_torch/network/mod.py")
    assert any(f.rule == "network-impure" for f in findings), bad
    assert not any(f.rule == "network-impure" for f in lint.lint_source(
        bad, "src/repro_torch/core/mod.py"))


def test_lint_register_without_contract():
    src = ("from repro_torch.core.sync.registry import register_commit\n"
           "@register_commit('x')\ndef f(*a):\n    pass\n")
    assert any(f.rule == "contract-required"
               for f in lint.lint_source(src, "m.py"))


@pytest.mark.parametrize("src", ["import jax\n", "from jax import numpy\n",
                                 "import repro.config\n",
                                 "from repro.core import shard\n"])
def test_lint_port_isolation(src):
    """The isolation test's rule as a lint finding: no jax, no repro."""
    assert [f.rule for f in lint.lint_source(
        src, "src/repro_torch/core/mod.py")] == ["port-isolation"]
    assert lint.lint_source("import repro_torch.core\nfrom . import x\n",
                            "src/repro_torch/core/mod.py") == []


def test_lint_print_is_for_the_clis():
    src = "print('hi')\n"
    assert [f.rule for f in lint.lint_source(src, "repro_torch/x.py")] == [
        "print-outside-cli"]
    for cli in ("repro_torch/analysis/__main__.py", "chip_smoke.py",
                "examples/torch_quickstart.py"):
        assert lint.lint_source(src, cli) == []


def test_lint_syntax_error_is_a_finding_not_a_crash():
    findings = lint.lint_source("def (:\n", "broken.py")
    assert [f.rule for f in findings] == ["syntax-error"]


def test_cli_lint_nonzero_on_fixture(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("assert 1\n")
    out = io.StringIO()
    with redirect_stdout(out):
        assert analysis_main(["--lint", str(bad)]) == 1
    assert "bare-assert" in out.getvalue()


def test_cli_no_args_prints_help():
    out = io.StringIO()
    with redirect_stdout(out):
        assert analysis_main([]) == 2
    assert "--check-all" in out.getvalue()


def test_cli_subprocess_check_all():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check-all"],
        cwd=ROOT, env={**os.environ,
                       "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK:" in r.stdout


# ---------------------------------------------------------------------------
# roofline: the kernels' bounds and one observed call
# ---------------------------------------------------------------------------

P_MNIST = 1_199_882


@pytest.mark.parametrize("name,shape,dtype,want", [
    ("sqdist_rows", (100, P_MNIST), torch.float32, 0.1447),
    ("sqdist_rows", (100, P_MNIST, 10), torch.float32, 0.1576),
    ("sqdist_rows", (100, 348_219), torch.float32, 0.0420),
    ("rmsnorm", (4, 2048, 4096), torch.bfloat16, 0.0401),
    ("flash_attention", (4, 2048, 2048, 32, 8, 128), torch.bfloat16, 0.1390),
    ("swa_attention", (1, 16384, 32, 8, 128, 8192), torch.bfloat16, 1.6677),
    ("ssd_scan", (320, 2048, 64, 128, 64, 80), torch.float32, 0.1066),
])
def test_kernel_bound_matches_perf_md(name, shape, dtype, want):
    """PERF.md §6's bound column, to 3 significant figures."""
    got = roofline.kernel_bound(name, shape, dtype)["bound_ms"]
    assert float(f"{got:.3g}") == float(f"{want:.3g}"), got


def test_analyze_places_a_call_on_the_roofline():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    rep = roofline.analyze("mm", lambda: (a @ b).relu())
    assert rep.flops_per_chip == 2 * 64 * 32 * 16
    # a and b read, the product written, then read and written by relu
    assert rep.bytes_per_chip == (64 * 32 + 32 * 16 + 3 * 64 * 16) * 4
    assert rep.bottleneck in ("compute", "memory", "collective")
    assert rep.collective_s == 0.0
    assert "mm" in roofline.format_table([rep])
    with roofline.WorkMode() as work:
        (a @ b).relu()
    assert work.flops == 2 * 64 * 32 * 16 + 64 * 16


def test_model_flops_for_follows_the_6nd_rule():
    from types import SimpleNamespace
    from repro_torch.config import get_arch
    cfg = get_arch("mnist_cnn")
    shape = SimpleNamespace(global_batch=10, seq_len=1)
    assert roofline.model_flops_for(cfg, shape, "train") == \
        6.0 * cfg.param_count() * 10


# ---------------------------------------------------------------------------
# telemetry costs against the reference's
# ---------------------------------------------------------------------------

COST_PRESETS = [n for n in PRESETS if not n.startswith("async")]


@pytest.mark.parametrize("name", COST_PRESETS)
def test_round_cost_shares_hold_the_reference(name):
    import repro.core.sync  # noqa: F401
    from repro.core.sync.registry import get_protocol as jget
    from repro.telemetry.costs import round_costs as jround_costs
    from repro_torch.telemetry.costs import round_costs

    def shares(c):
        total = c.gate_flops + c.skip_flops + c.sync_flops
        return np.array([c.gate_flops, c.skip_flops, c.sync_flops]) / \
            (total or 1.0)

    want = jround_costs(jget(name).with_params(layout="flat"), m=8)
    got = round_costs(reg.get_protocol(name), m=8)
    if name == "nosync":        # no part of a round runs
        assert got.sync_flops == want.sync_flops == 0
        return
    np.testing.assert_allclose(shares(got), shares(want), rtol=0, atol=0.15)
    assert got.sync_flops > 0


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_costs_cli_reads_either_packages_stream(writer, tmp_path):
    path = str(tmp_path / f"{writer}.jsonl")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    pkg = "repro_torch" if writer == "port" else "repro"
    rec = [sys.executable, "-m", f"{pkg}.telemetry", "record", "--out", path,
           "--rounds", "12", "--m", "4", "--chunk", "6"]
    if writer == "port":
        rec += ["--device", "cpu"]
    subprocess.run(rec, cwd=ROOT, env=env, check=True, capture_output=True,
                   timeout=300)
    outs = {}
    for reader in ("repro_torch", "repro"):
        r = subprocess.run([sys.executable, "-m", f"{reader}.telemetry",
                            "costs", path], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        outs[reader] = json.loads(r.stdout)
    assert sorted(outs["repro_torch"]) == sorted(outs["repro"])
    for key in ("spec", "rounds", "fires", "fire_rate"):
        assert outs["repro_torch"][key] == outs["repro"][key], key
    assert sorted(outs["repro_torch"]["per_round"]) == \
        sorted(outs["repro"]["per_round"])
