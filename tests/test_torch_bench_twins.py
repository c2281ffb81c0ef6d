"""The port's benchmark twins of the reference's other benchmarks
(``benchmarks/torch_*.py`` beside ``benchmarks/*.py``) and
``benchmarks/torch_run.py --protocol``, on the CPU.

* ``torch_run.ALL`` is the reference's ``run.ALL``, name for name,
  paper reference for paper reference and in order, ``roofline_table``
  last (it tabulates the port's dry-run records); ``FIGURES`` are the
  eight figure twins among them.
* Each twin has the reference module's ``NAME`` and ``PAPER_REF``, and a
  ``CUT`` of one or two cases.
* Each twin's ``check`` gives the reference's verdict on the same rows:
  rows built to pass each claim and rows built to fail it.
* A spec JSON written by the reference's ``ProtocolSpec.to_json`` runs
  through ``run_protocol_spec`` on the reference's batches from the
  reference's initial model: ``syncs``, ``full_syncs``, ``model_up``,
  ``messages`` and ``comm_bytes`` equal the reference's
  ``run_protocol_spec``, losses within rtol 1e-4; ``--telemetry``
  without ``--protocol`` is an error, as in the reference.
* ``kernel_bench``'s row builder runs on the CPU at a cut shape through
  the plain versions, against ``repro/kernels/ref.py``; its shared-memory
  constants are the CUDA sources'.

The cut rows against the reference's helpers are in
``tests/test_torch_bench_cuts.py``; ``chip_smoke.py``'s ``twins``
phase runs the quick grids on the card.
"""
import importlib
import json
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from benchmarks import run as jrun  # noqa: E402
from benchmarks import torch_common, torch_kernel_bench, torch_run  # noqa: E402
from benchmarks.torch_common import ReplaySource  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.sync import PROTOCOLS as JPROTOCOLS  # noqa: E402
from repro.core.sync.spec import ProtocolSpec as JSpec  # noqa: E402
from repro.data.pipeline import LearnerStreams as JStreams  # noqa: E402
from repro.data.synthetic import GraphicalModelStream as JGraphical  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.cnn import init_cnn_params as jinit  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
LOSS_TOL = dict(rtol=1e-4)
TWINS = {mod.NAME: mod for mod in torch_run.ALL
         if mod not in torch_run.FIGURES}
NEW = ("scan_driver", "dynamic_amortized", "fig_network_regimes",
       "fig_hierarchy", "sync_bench", "shard_bench", "async_bench",
       "robust_bench", "kernel_bench")


def _ref(name):
    return importlib.import_module(f"benchmarks.{name}")


def test_registry_is_the_references():
    want = [m.NAME for m in jrun.ALL]
    assert [m.NAME for m in torch_run.ALL] == want
    assert [m.PAPER_REF for m in torch_run.ALL] == [
        m.PAPER_REF for m in jrun.ALL]
    assert want[-1] == "roofline_table"
    assert [m.NAME for m in torch_run.FIGURES] == [
        n for n in want if n not in NEW + ("roofline_table",)]
    assert list(TWINS) == [n for n in want if n in NEW + ("roofline_table",)]
    for mod in torch_run.ALL:
        assert mod.__name__ == f"benchmarks.torch_{mod.NAME}"


@pytest.mark.parametrize("name", NEW)
def test_twin_names_the_reference_benchmark(name):
    twin, ref = TWINS[name], _ref(name)
    assert (twin.NAME, twin.PAPER_REF) == (ref.NAME, ref.PAPER_REF)
    assert 1 <= len(twin.CUT) <= 2
    assert all(len(case) == 4 for case in twin.CUT)


# ---------------------------------------------------------------------------
# the claims: the same verdicts on the same rows
# ---------------------------------------------------------------------------

def _regime(preset, regime, **kw):
    return dict(dict(preset=preset, regime=regime, stream_exact=True,
                     zero_delay_exact=True if regime == "sync" else None,
                     inflight_mean=0.5 if regime != "sync" else 0.0,
                     frontier_points=48), **kw)


def _rows(name, passing):
    """Rows built to pass (``passing``) or to fail the benchmark's
    claim."""
    if name == "dynamic_amortized":
        rates = [0.9, 0.6, 0.3, 0.2, 0.15 if passing else 0.6]
        return [{"delta": d, "sync_rate": r}
                for d, r in zip((0.1, 0.3, 0.7, 1.5, 3.0), rates)]
    if name == "scan_driver":
        return [{"warm_speedup": 6.0 if passing else 2.0,
                 "comm_totals_equal": True, "params_close": True,
                 "loss_rel_err": 1e-8}]
    if name == "fig_network_regimes":
        row = dict(protocol="dynamic", cumulative_loss=10.0,
                   comm_bytes=100, syncs=2)
        return [dict(row, topology="none", act_prob=1.0),
                dict(row, topology="star", act_prob=1.0,
                     cumulative_loss=10.0 if passing else 10.001),
                dict(row, topology="ring", act_prob=0.7, comm_bytes=120),
                dict(row, protocol="gossip", topology="ring",
                     act_prob=0.7, comm_bytes=900)]
    if name == "fig_hierarchy":
        return [{"clusters": 0, "coordinator_uplink_bytes": 1000,
                 "cumulative_loss": 100.0, "ledger_balanced": True},
                {"clusters": 3, "coordinator_uplink_bytes":
                 500 if passing else 1500, "cumulative_loss": 105.0,
                 "ledger_balanced": True}]
    if name == "async_bench":
        rows = [_regime(p, r) for p in ("periodic", "dynamic")
                for r in ("sync", "mild", "harsh")]
        rows.append({"regime": "aircomp", "syncs_equal": True,
                     "bytes_ratio": 8.0 if passing else 7.0})
        return rows
    if name == "robust_bench":
        vs = {("mean", 0.0): 1.0, ("trimmed_mean", 0.0): 1.001,
              ("median", 0.0): 1.001, ("mean", 0.2): 50.0,
              ("trimmed_mean", 0.2): 1.05,
              ("median", 0.2): 1.03 if passing else 1.2}
        return [{"defense": d, "adv_frac": f, "vs_fault_free": v}
                for (d, f), v in vs.items()] + [
                    {"defense": "trimmed_mean", "adv_frac": None,
                     "fault_off_bitwise": True}]
    if name == "sync_bench":
        return [{"m": 200, "layout": "tree", "round_ms": 2000.0},
                {"m": 200, "layout": "flat", "round_ms": 950.0,
                 "speedup": 3.0 if passing else 1.0,
                 "counters_equal": True, "params_close": True,
                 "per_iter_ms": 0.3},
                {"m": 8, "layout": "telemetry", "stream_exact": True}]
    if name == "shard_bench":
        return [{"layout": "meta", "scaling_expected": False},
                {"layout": "flat", "m": 200},
                {"layout": "sharded", "m": 200, "counters_equal": True},
                {"layout": "sharded", "m": 2000, "counters_equal": passing}]
    return [{"kernel": "sqdist", "abs_err_vs_oracle": 0.0},
            {"kernel": "rmsnorm", "max_err_vs_oracle": 0.01 if passing
             else 0.2}]


@pytest.mark.parametrize("passing", [True, False])
@pytest.mark.parametrize("name", NEW)
def test_check_gives_the_reference_verdict(name, passing):
    rows = _rows(name, passing)
    want = _ref(name).check([dict(r) for r in rows])
    assert want == ("PASS" if passing else "MIXED")
    assert TWINS[name].check([dict(r) for r in rows]) == want


# ---------------------------------------------------------------------------
# --protocol
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


SPECS = {
    "dynamic": JPROTOCOLS["dynamic"].with_params(b=2, delta=0.5),
    # a composition no preset names: the robust trigger with the plain
    # mean, as a user's spec file would hold
    "composed": JSpec(name="robust_trigger_mean",
                      trigger="robust_divergence", cohort="all_reachable",
                      aggregate="mean", commit="quarantine").with_params(
                          b=4, delta=0.3),
}


@pytest.mark.parametrize("spec", list(SPECS))
def test_protocol_spec_runs_like_the_reference(spec, tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(SPECS[spec].to_json())
    want = jrun.run_protocol_spec(str(path))
    rounds, m = want["rounds"], want["m"]
    streams = JStreams(JGraphical(seed=0, drift_prob=0.0), m, batch=10,
                       seed=0)
    chunks = [_np(streams.next_chunk(min(64, rounds - t)))
              for t in range(0, rounds, 64)]
    cfg = jget_arch("drift_mlp", smoke=True)
    init = _np(jinit(cfg, jax.random.split(jax.random.PRNGKey(0), 3)[0]))
    src = ReplaySource(chunks)
    got = torch_run.run_protocol_spec(
        str(path), device="cpu", source=src,
        init_fn=lambda g: params_from_numpy(init, device="cpu"))
    assert src.remaining == 0
    assert got["spec"] == want["spec"] == json.loads(path.read_text())
    for key in ("m", "rounds", "syncs", "full_syncs", "model_up",
                "messages", "comm_bytes"):
        assert got[key] == want[key], key
    assert got["bytes_curve"] == [int(x) for x in want["bytes_curve"]]
    np.testing.assert_allclose(got["cumulative_loss"],
                               want["cumulative_loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["loss_curve"], want["loss_curve"],
                               **LOSS_TOL)
    assert 0 < got["syncs"]


def test_telemetry_needs_protocol(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["torch_run", "--telemetry", "x.jsonl"])
    with pytest.raises(SystemExit) as e:
        torch_run.main()
    assert e.value.code == 2
    assert "--telemetry requires --protocol" in capsys.readouterr().err


def test_protocol_flag_streams_telemetry(tmp_path, monkeypatch, capsys):
    """``--protocol spec.json --telemetry out.jsonl --device cpu``: the
    row printed, saved under experiments/bench_torch/, the stream's
    totals the row's."""
    from repro_torch.telemetry.observatory import load_run, summarize
    spec, out = tmp_path / "spec.json", tmp_path / "run.jsonl"
    spec.write_text(SPECS["dynamic"].to_json())
    monkeypatch.setattr(torch_common, "OUT_DIR", str(tmp_path / "rows"))
    monkeypatch.setattr("sys.argv", [
        "torch_run", "--protocol", str(spec), "--telemetry", str(out),
        "--device", "cpu"])
    torch_run.main()
    text = capsys.readouterr().out
    saved = json.loads((tmp_path / "rows"
                        / "protocol_spec_dynamic.json").read_text())[0]
    assert f"  syncs={saved['syncs']}" in text
    card = summarize(load_run(str(out)))
    assert (card["cum_syncs"], card["cum_bytes"]) == (saved["syncs"],
                                                      saved["comm_bytes"])


# ---------------------------------------------------------------------------
# kernel_bench
# ---------------------------------------------------------------------------

def test_kernel_bench_rows_match_the_reference_plain_versions():
    shapes = torch_kernel_bench.CUT[0][0]
    out = torch_kernel_bench.outputs(shapes, "cpu")
    bf16 = dict(rtol=2 ** -7, atol=1e-5)
    f32 = dict(rtol=1e-5, atol=1e-6)

    def j(t):
        return jax.numpy.asarray(t.float().numpy(), dtype=(
            jax.numpy.bfloat16 if t.dtype == torch.bfloat16 else None))

    def close(got, want, tol):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)

    (x, r), got, _ = out["sqdist"]
    close(got, jref.sqdist_ref(j(x), j(r)), f32)
    (X, r), got, _ = out["sqdist_rows"]
    close(got, jax.vmap(lambda a: jref.sqdist_ref(a, j(r)))(j(X)), f32)
    args, got, _ = out["flash_attention"]
    close(got, jref.flash_attention_ref(*map(j, args)), bf16)
    args, got, _ = out["ssd_scan"]
    close(got, jref.ssd_scan_ref(*map(j, args))[0], f32)
    args, got, _ = out["rmsnorm"]
    close(got, jref.rmsnorm_ref(*map(j, args)), bf16)

    rows = torch_kernel_bench.rows_at(shapes, "cpu")
    assert [r["kernel"] for r in rows] == list(torch_kernel_bench.KERNELS)
    assert torch_kernel_bench.check(rows) == "PASS"
    for r in rows:
        assert r["ref_us"] > 0 and r["hbm_bytes_one_pass"] > 0
        # device numbers only from the card
        assert not {"kernel_ms", "bound_ms", "launches",
                    "smem_block_bytes"} & set(r)
    assert rows[1]["hbm_bytes_one_pass"] == (5 * 4099 + 4099) * 4


def _const(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_kernel_bench_shared_memory_follows_the_launchers():
    kb = torch_kernel_bench
    assert (kb.ATTN_BQ, kb.ATTN_BK, kb.ATTN_STAGES) == (
        _const("attention_sm90.cu", "kBQ"), _const("attention_sm90.cu", "BK"),
        _const("attention_sm90.cu", "kStages"))
    assert (kb.SSD_MAX_P, kb.SSD_MAX_N, kb.SSD_BOX_ROW) == (
        _const("ssd_scan.cu", "kMaxP"), _const("ssd_scan.cu", "kMaxN"),
        _const("ssd_scan.cu", "kBoxRow"))
    smem = kb.smem_block_bytes("flash_attention", (1, 512, 64))
    # Q tile 16 KB, two stages of K and V 8 KB each, barriers, alignment
    assert smem == {"attention_kernel_sm90": 16384 + 2 * 16384 + 72 + 1024}
    ssd = kb.smem_block_bytes("ssd_scan", (8, 256, 64, 16))
    assert ssd == {"ssd_scan_cbt_kernel": 128 * 36 * 4,
                   "ssd_scan_state_kernel": 32768 + 4800 * 4 + 1024,
                   "ssd_scan_out_kernel": 98304 + 512 + 1024}
    assert max(ssd.values()) <= 227 * 1024      # a block's opt-in limit
    for name in ("sqdist", "sqdist_rows", "rmsnorm"):
        assert kb.smem_block_bytes(name, None) is None
