"""Dry run: count every (arch x shape x mesh) program without running it
at size — the counterpart of ``repro.launch.dryrun``.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k \\
        --mesh multi --mode train_dynamic

The reference compiles each program for 512 forced host devices and
reads XLA's cost and memory analyses. The port has no compiler to ask:
it runs the program once on ``meta`` tensors (``launch.specs``), which
hold shapes and no values, under ``analysis.roofline.observers()``
(products by ``FlopCounterMode``, bytes by ``WorkMode``) and a
``kernels._build.tally``, whose meta calls give each kernel's work by
``kernel_work`` and launch nothing. Nothing needs a card, and no kernel
library is loaded.

Calibration, as the reference's: the program is counted at 1 and 2
layers and extrapolated, total(L) = count(1) + (L - 1) (count(2) -
count(1)), for the products, the bytes outside the kernels, and each
kernel family's launches, bytes and operations. A training step's
bytes also grow as L^2: each layer's select of the stacked weights
writes a zeroed (L, ...) gradient, and autograd adds the L of them
(ROADMAP, "Fleet LM step"). So a training program is counted at 3
layers too, and the second difference adds (L - 1)(L - 2) / 2 (count(3)
- 2 count(2) + count(1)), 0 where the cost is linear in L.

Per chip (``num_devices`` = the mesh's size):

* compute and memory are the global count / ``num_devices``
  (``"per_chip_rule": "even_split"``);
* the argument bytes are exact: each argument's shard by
  ``sharding.local_shape`` of its spec (a raveled row by its leaves'),
  a view of another argument counting none of its own;
* the collective bytes are ring bytes, (n - 1) / n of the tensor for an
  all-gather or a reduce-scatter over n ranks and 2 (n - 1) / n for an
  all-reduce, for each collective the placements imply:
  - every product weight (2-D, a router, an expert table) is gathered
    over the fsdp axis before each forward pass that uses it (not in
    decode, whose weights stay sharded), twice a training step under
    remat (the recompute);
  - a product whose contraction dim stays sharded all-reduces its
    output over those axes (tokens a chip x its output shard; an expert
    table x the experts a token takes), in each forward pass and once
    more in a training step's backward; the embedding's lookup
    all-reduces over its vocab axes;
  - a training step reduce-scatters each weight's gradient over the
    fsdp axis and all-reduces it over the batch axes its spec does not
    use;
  - a fleet step's sync (dynamic and periodic, counted once a step, as
    the reference's HLO lists a ``cond``'s collectives) all-reduces each
    weight over the learner axis; the dynamic step's check all-reduces
    the m distances' partial sums over the other axes.

For ``train_dynamic`` the counted step is a checked step that syncs:
one ``sqdist_rows`` over (m, P), then the mean; the host's decision,
which needs the distances' values, is taken as "sync" (``SyncOnMeta``;
``"host_decision"`` in the record).

The rates are the H100's (``PEAKS["H100"]``) at the arithmetic the
program runs: the products on the bf16 tensor cores for a bf16 program,
on the CUDA cores' f32 rate for an f32 one (TF32 off), each kernel at
its own (``kernel_work``): a bf16 training program's backward kernels
at bf16 sizes, the attention backward at the bf16 tensor cores' rate,
as the card runs them.

Records keep the reference's keys (``arch, shape, mesh, mode,
num_devices, compile_s, ok, calibrated, roofline{...}``) and add the
port's (``per_chip_rule``, ``rates``, ``kernels``, ``host_decision``).
They go to ``experiments/torch_dryrun/`` by default.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis import roofline as rl
from repro_torch.config import INPUT_SHAPES, get_arch
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.device import shapes_only
from repro_torch.kernels import _build
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh, mesh_size
from repro_torch.launch.specs import Raveled, build_program
from repro_torch.telemetry import console_handler, get_logger

# the reference's: long_500k needs a sub-quadratic decode
LONG_CONTEXT_ARCHS = (
    "mamba2-2.7b", "hymba-1.5b", "mixtral-8x22b", "llama3-8b-swa")
OUT_DIR = os.path.join("experiments", "torch_dryrun")
TRAIN_MODES = ("train", "train_dynamic", "train_periodic")
_PRODUCT_NAMES = frozenset({
    "w_q", "w_k", "w_v", "w_o", "w_dq", "w_uq", "w_dkv", "w_krope", "w_uk",
    "w_uv", "w_gate", "w_up", "w_down", "w_xz", "w_bc", "w_dt", "w_out",
    "router", "lm_head"})


def pairs_for(arch: str):
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
            continue
        yield shape


# ---------------------------------------------------------------------------
# counting on meta
# ---------------------------------------------------------------------------

def kernel_totals(calls) -> Dict[str, dict]:
    """Launches, bytes and operations by kernel family of a tally's
    calls, with the operations' rate (a ``Peaks`` attribute)."""
    out: Dict[str, dict] = {}
    for c in calls:
        nbytes, ops, rate = rl.kernel_work(c.work, c.shape, c.dtype)
        row = out.setdefault(c.family, {"launches": 0, "bytes": 0,
                                        "ops": 0, "rate": rate})
        row["launches"] += 1
        row["bytes"] += nbytes
        row["ops"] += ops
    return out


class SyncOnMeta(TorchFunctionMode):
    """The host's decision on values ``meta`` does not hold: the dynamic
    step's distances, read on the host by ``Tensor.cpu``, come back as
    +inf, every learner past Delta, so the counted step is a checked
    step that syncs. Any other call passes through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.cpu and args[0].is_meta:
            return torch.full(args[0].shape, math.inf, dtype=args[0].dtype)
        return func(*args, **(kwargs or {}))


def count(prog) -> dict:
    """One call of ``prog`` on its ``meta`` arguments (``SyncOnMeta``):
    the products' FLOPs, the bytes outside the kernels, and the kernels'
    work by family."""
    counter, work = rl.observers()
    with shapes_only(), SyncOnMeta(), _build.tally() as tally, counter, \
            work:
        prog.fn(*prog.args)
    return {"flops": float(counter.get_total_flops()),
            "bytes": float(work.bytes),
            "kernels": kernel_totals(tally.calls)}


def extrapolate(c1: dict, c2: dict, L: int, c3: dict = None) -> dict:
    """total(L) = c1 + (L - 1) (c2 - c1), term by term; with the count
    at 3 layers also + (L - 1)(L - 2) / 2 (c3 - 2 c2 + c1)."""
    def ext(a, b, c=None):
        out = a + (L - 1) * max(b - a, 0)
        if c is not None:
            out += (L - 1) * (L - 2) // 2 * (c - 2 * b + a)
        return out

    counts = [c for c in (c1, c2, c3) if c is not None]
    kernels = {}
    for fam in set().union(*(c["kernels"] for c in counts)):
        rows = [c["kernels"].get(fam, {}) for c in counts]
        kernels[fam] = {key: ext(*(r.get(key, 0) for r in rows))
                        for key in ("launches", "bytes", "ops")}
        kernels[fam]["rate"] = next(r for r in rows if r)["rate"]
    return {key: ext(*(c[key] for c in counts))
            for key in ("flops", "bytes")} | {"kernels": kernels}


# ---------------------------------------------------------------------------
# per chip: arguments and collectives
# ---------------------------------------------------------------------------

def _local_bytes(shape, spec, itemsize: int, mesh) -> int:
    return math.prod(shd.local_shape(shape, spec, mesh)) * itemsize


def _tensors(tree) -> list:
    out = []
    shd.map_named(lambda _n, t: out.append(t), tree)
    return [t for t in out if isinstance(t, torch.Tensor)]


def argument_bytes(prog, mesh) -> int:
    """The bytes of one chip's shards of the program's arguments; a view
    of another argument (the fleet's params in their plane) holds none
    of its own."""
    held = {id(t) for t in _tensors(prog.args)}

    def walk(arg, spec):
        if spec is None:
            return 0
        if isinstance(arg, torch.Tensor) and id(arg._base) in held:
            return 0
        if isinstance(spec, Raveled):
            item = arg.element_size()
            return sum(_local_bytes(s, p, item, mesh)
                       for s, p in zip(spec.shapes, spec.specs))
        if isinstance(spec, shd.PartitionSpec):
            if not isinstance(arg, torch.Tensor):
                return 0                 # a host int
            return _local_bytes(arg.shape, spec, arg.element_size(), mesh)
        if isinstance(spec, dict):
            return sum(walk(arg[k], spec[k]) for k in spec)
        return sum(walk(a, s) for a, s in zip(arg, spec))

    return sum(walk(a, s) for a, s in zip(prog.args, prog.in_shardings))


def _ring(kind: str, nbytes: float, n: int) -> float:
    """One chip's ring bytes of a collective over n ranks of an
    ``nbytes`` tensor."""
    if n <= 1:
        return 0.0
    return nbytes * (n - 1) / n * (2 if kind == "all-reduce" else 1)


def _axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def collective_bytes(cfg, shape, mesh, mode: str, remat: bool,
                     m: int = 1) -> Dict[str, float]:
    """One chip's ring bytes a step by kind, by the rules of the module
    docstring, from the parameter specs of ``mode``'s layout."""
    from repro_torch.launch.specs import params_struct
    multi = "pod" in shd.axis_sizes(mesh)
    axes = shd.default_axes_map(multi)
    fleet = mode in ("train_dynamic", "train_periodic")
    if fleet:
        axes = dict(axes, batch="data") if multi else dict(axes,
                                                            learner=None)
    p_struct = params_struct(cfg)
    p_spec = shd.param_spec_tree(p_struct, mesh, axes)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    fsdp = axes["fsdp"]
    batch_axes = _axes(axes["batch"])
    nbatch = shd.axis_size(mesh, axes["batch"])
    tokens = shape.global_batch * (1 if mode == "decode" else shape.seq_len)
    tokens_chip = tokens / (m if fleet else 1) / nbatch
    # forward passes that gather the weights (decode gathers none), and
    # passes whose products all-reduce their outputs (a training step's
    # backward once more)
    gathers = 0 if mode == "decode" else (2 if mode in TRAIN_MODES and remat
                                          else 1)
    outputs = max(gathers, 1) + (1 if mode in TRAIN_MODES else 0)
    k_tok = cfg.moe.num_experts_per_tok if cfg.is_moe else 1
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0}

    def visit(names, leaf, spec):
        name = names[-1] if names else ""
        parts = list(spec) + [None] * (leaf.dim() - len(spec))
        local = _local_bytes(leaf.shape, spec, item, mesh)
        if name == "embed":
            d_local = leaf.shape[-1] // shd.axis_size(mesh, parts[-1])
            out["all-reduce"] += outputs * _ring(
                "all-reduce", tokens_chip * d_local * item,
                shd.axis_size(mesh, parts[-2]))
        expert = ("moe" in names and "shared" not in names
                  and name in ("w_gate", "w_up", "w_down"))
        if name in _PRODUCT_NAMES and leaf.dim() >= 2:
            uses = math.prod(leaf.shape[:-3 if expert else -2])   # layers
            n_f = (shd.axis_size(mesh, fsdp)
                   if any(fsdp in _axes(p) for p in parts) else 1)
            per_use = local / max(uses, 1)
            out["all-gather"] += gathers * uses * _ring(
                "all-gather", per_use * n_f, n_f)
            gathered = {fsdp} if gathers and n_f > 1 else set()
            contract = [a for a in _axes(parts[-2]) if a not in gathered]
            out_axes = [a for a in _axes(parts[-1]) if a not in gathered]
            d_out = leaf.shape[-1] // math.prod(
                shd.axis_size(mesh, a) for a in out_axes)
            out["all-reduce"] += outputs * uses * _ring(
                "all-reduce",
                tokens_chip * (k_tok if expert else 1) * d_out * item,
                math.prod(shd.axis_size(mesh, a) for a in contract))
        if mode in TRAIN_MODES and leaf.is_floating_point():
            used = {a for p in parts for a in _axes(p)}
            n_f = shd.axis_size(mesh, fsdp) if fsdp in used else 1
            out["reduce-scatter"] += _ring("reduce-scatter", local * n_f,
                                           n_f)
            rest = [a for a in batch_axes if a not in used]
            out["all-reduce"] += _ring(
                "all-reduce", local,
                math.prod(shd.axis_size(mesh, a) for a in rest))
            if fleet:
                out["all-reduce"] += _ring(
                    "all-reduce", local,
                    shd.axis_size(mesh, axes["learner"]))

    specs = {}
    shd.map_named(lambda n, s: specs.setdefault(n, s), p_spec)
    shd.map_named(lambda n, leaf: visit(n, leaf, specs[n]), p_struct)
    if mode == "train_dynamic":
        n_rest = mesh_size(mesh) // shd.axis_size(mesh, axes["learner"])
        out["all-reduce"] += _ring("all-reduce", 4 * m, n_rest)
    return out


# ---------------------------------------------------------------------------
# one program
# ---------------------------------------------------------------------------

def roofline_of(cfg, shape, mesh, mode: str, prog, counted: dict,
                card: rl.Peaks = rl.H100) -> dict:
    """The record's ``roofline`` from a (calibrated) count."""
    n = mesh_size(mesh)
    f32 = getattr(torch, cfg.dtype) == torch.float32
    product_rate = card.f32 if f32 else card.bf16
    kern = counted["kernels"]
    k_ops = sum(k["ops"] for k in kern.values())
    k_bytes = sum(k["bytes"] for k in kern.values())
    flops = (counted["flops"] + k_ops) / n
    nbytes = (counted["bytes"] + k_bytes) / n
    compute_s = (counted["flops"] / product_rate
                 + sum(k["ops"] / getattr(card, k["rate"])
                       for k in kern.values())) / n
    train = prog.recipe[4]
    coll = collective_bytes(cfg, shape, mesh, mode, train.remat,
                            prog.meta.get("m", 1))
    wire = sum(coll.values())
    terms = {"compute": compute_s, "memory": nbytes / card.hbm,
             "collective": wire / card.link}
    model_flops = rl.model_flops_for(cfg, shape, mode)
    return {"name": f"{prog.name}", "num_devices": n,
            "flops_per_chip": flops, "bytes_per_chip": nbytes,
            "wire_bytes_per_chip": wire,
            "compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"],
            "bottleneck": max(terms, key=terms.get),
            "model_flops": model_flops,
            "useful_fraction": (model_flops / (flops * n)
                                if model_flops and flops else None),
            "collectives": {"by_kind": coll},
            "memory_stats": {"argument_bytes": argument_bytes(prog, mesh)}}


def count_program(cfg, shape, mesh, mode: str = "auto", train=None,
                  proto=None, calibrate: bool = True) -> tuple:
    """(the full-depth program, its count): at 1 and 2 layers (and 3
    for a training program), extrapolated, or at full depth with
    ``calibrate`` False."""
    prog = build_program(cfg, shape, mesh, mode, train, proto)
    mode = prog.meta["mode"]
    if not calibrate:
        return prog, count(prog)
    depths = (1, 2, 3) if mode in TRAIN_MODES else (1, 2)
    counts = [count(build_program(dataclasses.replace(cfg, num_layers=L),
                                  shape, mesh, mode, train, proto))
              for L in depths]
    return prog, extrapolate(*counts[:2], cfg.num_layers, *counts[2:])


def run_one(arch: str, shape_name: str, mesh_kind: str, mode: str = "auto",
            verbose: bool = True, calibrate: bool = True) -> dict:
    """Count one (arch, shape, mesh) program on ``meta`` and place it on
    the H100's roofline: the reference's record and the port's keys."""
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.perf_counter()
    prog, counted = count_program(cfg, shape, mesh, mode,
                                  calibrate=calibrate)
    seconds = time.perf_counter() - t0
    mode = prog.meta["mode"]
    report = roofline_of(cfg, shape, mesh, mode, prog, counted)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mode": mode, "num_devices": report["num_devices"],
           "compile_s": round(seconds, 2), "ok": True,
           "calibrated": calibrate, "roofline": report,
           "per_chip_rule": "even_split",
           "rates": {"products": ("f32 CUDA cores (TF32 off)"
                                  if cfg.dtype == "float32"
                                  else "bf16 tensor cores"),
                     "card": "H100"},
           "kernels": counted["kernels"],
           "products_flops": counted["flops"],
           "bytes_outside_kernels": counted["bytes"]}
    if mode == "train_dynamic":
        rec["host_decision"] = ("sync: the counted step is a checked step "
                                "that syncs (the distances have no value "
                                "on meta)")
    if verbose:
        # structured events: the CLI attaches the text formatter
        get_logger().event(
            "dryrun_roofline", program=prog.name, mesh=mesh_kind,
            chips=report["num_devices"], count_s=seconds,
            compute_s=report["compute_s"], memory_s=report["memory_s"],
            collective_s=report["collective_s"],
            bottleneck=report["bottleneck"],
            argument_bytes=report["memory_stats"]["argument_bytes"])
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--mode", default="auto")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    log = get_logger()
    handler = log.add_handler(console_handler())
    try:
        _run_jobs(args, log)
    finally:
        log.remove_handler(handler)


def _run_jobs(args, log) -> None:
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        if args.mode.startswith("train"):
            jobs = [(a, "train_4k") for a in ASSIGNED_ARCHS]
        else:
            jobs = [(a, s) for a in ASSIGNED_ARCHS for s in pairs_for(a)]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        jobs = [(args.arch, args.shape)]

    failures = []
    for arch, shape in jobs:
        for mk in meshes:
            tag = f"{arch}_{shape}_{mk}_{args.mode}".replace("/", "-")
            path = os.path.join(args.out_dir, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                log.event("dryrun_skip", record=tag)
                continue
            try:
                rec = run_one(arch, shape, mk, args.mode)
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "mode": args.mode, "ok": False, "error": repr(e)}
                failures.append(tag)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
    if failures:
        log.event("dryrun_failures", records=failures)
        raise SystemExit(1)
    log.event("dryrun_complete", pairs=len(jobs), meshes=len(meshes))


if __name__ == "__main__":
    main()
