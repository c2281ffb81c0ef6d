"""The launcher's dry run (``repro_torch.launch.dryrun``), the kernels'
meta calls and the MoE repair of ``model_flops_for``, on the CPU:

* ``ModelConfig.active_param_count`` and ``analysis.roofline
  .model_flops_for`` equal to the reference's for the ten configs of
  ``ASSIGNED_ARCHS`` in all five modes and every input shape (before the
  repair the port counted every expert of mixtral-8x22b and
  deepseek-v2-236b: 3.59x and 11.2x);
* every ``ops`` entry and every autograd backward on ``meta`` tensors:
  empty outputs of the kernel's shapes, ``LAUNCHES`` and
  ``ROWS_LAUNCHES`` untouched, no library loaded, each call in the
  active tally with its work; a bf16 backward counted;
* the dynamic step's host decision, which ``meta`` cannot give, is the
  dry run's (``SyncOnMeta``): a checked step that syncs;
* the calibration: the extrapolation from 1 and 2 layers (and 3 for a
  training program, whose bytes grow as L^2) equals the full-depth meta
  count at 4 smoke layers, in every mode;
* the argument bytes a chip equal the reference's shard shapes
  (``NamedSharding.shard_shape`` on ``compat.abstract_mesh``) on both
  production meshes; the fleet state as the port holds it
  (``launch/specs.py``, "Departures": an f32 plane and reference row,
  bf16 weights as copies, host ints);
* the records carry the reference's keys; ``benchmarks/
  torch_roofline_table.py`` and the reference's ``roofline_table`` format
  each other's records and word ``check`` alike; ``python -m
  repro_torch.launch.dryrun --all --mesh both`` writes a record for every
  pair here, with no card and no library.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from benchmarks import roofline_table as jtable  # noqa: E402
from benchmarks import torch_roofline_table as table  # noqa: E402
from repro import compat  # noqa: E402
from repro.analysis import roofline as jrl  # noqa: E402
from repro.config import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.config import INPUT_SHAPES, ShapeConfig, get_arch  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.device import shapes_only  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

MODES = ("train", "train_dynamic", "train_periodic", "prefill", "decode")


def test_model_flops_are_the_references():
    for arch in ASSIGNED_ARCHS:
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        assert cfg.active_param_count() == jcfg.active_param_count(), arch
        assert cfg.param_count() == jcfg.param_count(), arch
        for mode in MODES:
            for s in INPUT_SHAPES:
                assert rl.model_flops_for(cfg, INPUT_SHAPES[s], mode) == \
                    jrl.model_flops_for(jcfg, JSHAPES[s], mode), (arch, mode)
    assert get_arch("mixtral-8x22b").active_param_count() == 39_161_462_784
    assert get_arch("deepseek-v2-236b").active_param_count() == \
        21_376_491_520


# ---------------------------------------------------------- meta calls

def _m(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_calls_launch_nothing(dtype):
    ops.reset_launches()
    before = dict(ops.LAUNCHES)
    loaded = dict(_build._LOADED)
    with _build.tally() as t:
        assert ops.sqdist_rows(_m(4, 100, dtype=dtype),
                               _m(100, dtype=dtype)).shape == (4,)
        assert ops.sqdist_rows(_m(4, 100, dtype=dtype),
                               _m(2, 100, dtype=dtype)).shape == (4,)
        assert ops.sqdist(_m(100, dtype=dtype),
                          _m(100, dtype=dtype)).shape == ()
        assert ops.rmsnorm(_m(3, 64, dtype=dtype),
                           _m(64, dtype=dtype)).shape == (3, 64)
        assert ops.flash_attention(*(_m(2, 16, 64, dtype=dtype),) * 3) \
            .shape == (2, 16, 64)
        q, kv = _m(2, 16, 8, 64, dtype=dtype), _m(2, 16, 2, 64, dtype=dtype)
        assert ops.flash_attention_gqa(q, kv, kv).shape == (2, 16, 8, 64)
        assert ops.swa_attention(q, kv, kv, window=8).shape == (2, 16, 8, 64)
        y, h = ops.ssd_scan(_m(4, 20, 8, dtype=dtype), _m(4, 20, dtype=dtype),
                            _m(4), _m(2, 20, 16, dtype=dtype),
                            _m(2, 20, 16, dtype=dtype), chunk=8)
        assert (y.shape, h.shape, h.dtype) == ((4, 20, 8), (4, 8, 16),
                                               torch.float32)
        # the gradients, through the autograd Functions and their
        # backward kernels, bf16 too
        x, s = _m(3, 64, dtype=dtype, grad=True), _m(64, dtype=dtype,
                                                     grad=True)
        ops.rmsnorm(x, s).sum().backward()
        assert x.grad.shape == x.shape and s.grad.shape == s.shape
        qg = _m(2, 16, 8, 64, dtype=dtype, grad=True)
        kg = _m(2, 16, 2, 64, dtype=dtype, grad=True)
        ops.flash_attention_gqa(qg, kg, kg).sum().backward()
        assert qg.grad.shape == qg.shape and kg.grad.shape == kg.shape
        ops.swa_attention(qg, kg, kg, window=8).sum().backward()
        xs = _m(4, 24, 8, dtype=dtype, grad=True)
        yg, _ = ops.ssd_scan(xs, _m(4, 24, dtype=dtype), _m(4),
                             _m(2, 24, 16, dtype=dtype),
                             _m(2, 24, 16, dtype=dtype), chunk=8)
        yg.sum().backward()
        assert xs.grad.shape == xs.shape
        # the learners' vmap folds into one call
        torch.func.vmap(torch.func.grad(
            lambda x_: ops.rmsnorm(x_, _m(64, dtype=dtype)).sum()))(
            _m(5, 3, 64, dtype=dtype))
    assert ops.LAUNCHES == before and not ops.ROWS_LAUNCHES
    assert _build._LOADED == loaded == {}
    assert all(c.meta for c in t.calls)
    assert t.launches() == {
        "sqdist_rows": 2, "sqdist": 1, "rmsnorm": 3, "flash_attention": 3,
        "swa_attention": 2, "ssd_scan": 2, "rmsnorm_bwd": 2,
        "attention_bwd": 2, "ssd_scan_bwd": 1}
    for c in t.calls:
        nbytes, n_ops, _ = rl.kernel_work(c.work, c.shape, c.dtype)
        assert nbytes > 0 and n_ops > 0, c


def test_meta_calls_check_shapes():
    with pytest.raises(ValueError):
        ops.flash_attention_gqa(_m(2, 16, 8, 64), _m(2, 16, 3, 64),
                                _m(2, 16, 3, 64))
    with pytest.raises(ValueError):
        ops.rmsnorm(_m(3, 64), _m(32))


def test_the_dry_run_takes_the_dynamic_steps_host_decision():
    """The dynamic step reads the distances on the host, which ``meta``
    cannot give: the step itself raises there, and only the dry run's
    ``SyncOnMeta`` decides, a checked step that syncs after one
    ``sqdist_rows`` over (m, P)."""
    cfg = dataclasses.replace(get_arch("llama3-8b", smoke=True),
                              num_layers=1)
    prog = specs.build_program(cfg, ShapeConfig("s", 32, 4, "train"),
                               make_production_mesh(), "train_dynamic")
    with pytest.raises(NotImplementedError), shapes_only():
        prog.fn(*prog.args)
    with shapes_only(), dryrun.SyncOnMeta(), _build.tally() as t:
        assert torch.equal(torch.ones(2).cpu(), torch.ones(2))
        state, metrics = prog.fn(*prog.args)
    P = prog.args[0].plane.shape[1]
    assert [c.shape for c in t.calls if c.family == "sqdist_rows"] == [
        (2, P, 1)]
    assert int(metrics["synced"]) == 1 and state.syncs == 1
    assert state.step == prog.args[0].step + 1


# -------------------------------------------------------- calibration

@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b",
                                  "hymba-1.5b"])
def test_extrapolation_equals_the_full_count(arch):
    cfg = dataclasses.replace(get_arch(arch, smoke=True), num_layers=4)
    mesh = make_production_mesh()
    for mode, shape in (("train", ShapeConfig("s", 32, 4, "train")),
                        ("train_dynamic", ShapeConfig("s", 32, 4, "train")),
                        ("train_periodic", ShapeConfig("s", 32, 4, "train")),
                        ("prefill", ShapeConfig("s", 32, 2, "prefill")),
                        ("decode", ShapeConfig("s", 32, 2, "decode"))):
        _, got = dryrun.count_program(cfg, shape, mesh, mode)
        _, want = dryrun.count_program(cfg, shape, mesh, mode,
                                       calibrate=False)
        want["kernels"] = {f: {k: v for k, v in row.items()}
                           for f, row in want["kernels"].items()}
        assert got == want, (arch, mode)


# --------------------------------------------------- argument bytes

def _ref_bytes(args, shardings, itemsize=None) -> int:
    """One chip's bytes of the reference's arguments by their shard
    shapes (each leaf at ``itemsize`` bytes where given)."""
    total = 0
    for a, s in zip(args, shardings):
        leaves = jax.tree.leaves(a)
        shards = jax.tree.leaves(
            s, is_leaf=lambda x: isinstance(x, NamedSharding))
        for leaf, sh in zip(leaves, shards):
            total += math.prod(sh.shard_shape(leaf.shape)) * (
                itemsize or np.dtype(leaf.dtype).itemsize)
    return total


def _fleet_ref_bytes(jp) -> int:
    """The port's fleet state in the reference's shards: the plane and
    the reference row in f32 (the plane's dtype), the stacked weights
    again where they are bf16 copies (an f32 weight is a view of the
    plane), the optimizer steps and the batch; no bytes for the host
    ints (the reference's step, syncs and checks, int32 scalars)."""
    (js, jb), (jss, jbs) = jp.args, jp.in_shardings
    copies = jax.tree.leaves(js.params)[0].dtype != np.float32
    return (_ref_bytes((js.params, js.ref), (jss.params, jss.ref), 4)
            + (_ref_bytes((js.params,), (jss.params,)) if copies else 0)
            + _ref_bytes((js.opt_state, jb), (jss.opt_state, jbs)))


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_argument_bytes_are_the_references_shards(kind):
    jmesh = compat.abstract_mesh(*(((2, 16, 16), ("pod", "data", "model"))
                                   if kind == "multi"
                                   else ((16, 16), ("data", "model"))))
    mesh = make_production_mesh(multi_pod=kind == "multi")
    for arch in ASSIGNED_ARCHS:
        cases = [(s, "auto") for s in dryrun.pairs_for(arch)] + [
            ("train_4k", "train_dynamic"), ("train_4k", "train_periodic")]
        for sname, mode in cases:
            jp = jspecs.build_program(jget_arch(arch), JSHAPES[sname], jmesh,
                                      mode)
            tp = specs.build_program(get_arch(arch), INPUT_SHAPES[sname],
                                     mesh, mode)
            want = (_fleet_ref_bytes(jp) if mode.startswith("train_")
                    else _ref_bytes(jp.args, jp.in_shardings))
            assert dryrun.argument_bytes(tp, mesh) == want, (arch, sname,
                                                             mode)


# ----------------------------------------------------------- records

def test_records_and_both_tables(tmp_path):
    rec = dryrun.run_one("llama3-8b", "decode_32k", "single", verbose=False)
    ref_keys = {"arch", "shape", "mesh", "mode", "num_devices",
                "compile_s", "ok", "calibrated", "roofline"}
    assert ref_keys <= set(rec)
    report_keys = [f.name for f in dataclasses.fields(jrl.RooflineReport)]
    assert list(rec["roofline"]) == report_keys
    assert rec["per_chip_rule"] == "even_split" and "waits_on" not in rec
    assert rec["kernels"]["rmsnorm"]["launches"] == 65
    # a reference record, as its run_one writes one
    jrep = jrl.RooflineReport(
        "llama3-8b:decode_32k:decode@single", 256, 1.0e9, 2.0e9, 3.0e6,
        1e-6, 2e-6, 3e-7, "memory", 4.0e9, 0.5, {"by_kind": {}},
        {"argument_bytes": 10 ** 9, "temp_bytes": 2 * 10 ** 9})
    jrec = {"arch": "llama3-8b", "shape": "decode_32k", "mesh": "single",
            "mode": "decode", "num_devices": 256, "compile_s": 1.0,
            "ok": True, "calibrated": True, "roofline": jrep.as_dict()}
    for fmt in (table.format_markdown, jtable.format_markdown):
        out = fmt([rec, jrec, {"arch": "x", "shape": "y", "mesh": "single",
                               "mode": "train", "ok": False,
                               "error": "boom"}])
        assert out.count("llama3-8b | decode_32k | single | decode") == 2
        assert "FAILED: boom" in out
    for path, r in (("a.json", rec), ("b.json", jrec)):
        (tmp_path / path).write_text(json.dumps(r, default=str))
    rows = table.run(dryrun_dir=str(tmp_path))
    assert table.check(rows) == jtable.check(rows) == "2/2 compiled"
    empty = table.run(dryrun_dir=str(tmp_path / "none"))
    assert table.check(empty) == jtable.check(empty) == "NO-DATA"


def test_the_cli_writes_every_pair(tmp_path):
    loaded = dict(_build._LOADED)
    dryrun.main(["--all", "--mesh", "both", "--out-dir", str(tmp_path)])
    pairs = [(a, s) for a in ASSIGNED_ARCHS for s in dryrun.pairs_for(a)]
    recs = table.load_records(str(tmp_path))
    assert len(recs) == 2 * len(pairs)
    assert all(r["ok"] for r in recs)
    assert {(r["arch"], r["shape"]) for r in recs} == set(pairs)
    # every program runs on the card, bf16 training too: none waits
    assert not any("waits_on" in r for r in recs)
    assert table.check(table.run(dryrun_dir=str(tmp_path))) == \
        f"{2 * len(pairs)}/{2 * len(pairs)} compiled"
    assert _build._LOADED == loaded == {}
