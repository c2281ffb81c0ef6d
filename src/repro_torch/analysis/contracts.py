"""Contract checking for the protocol-spec API — the counterpart of
``repro.analysis.contracts``.

Every registered stage (``repro_torch.core.sync.registry``) declares a
``StageContract``; this module VERIFIES those declarations instead of
trusting them, by running each stage and each compiled round over a
mixed-dtype model template (an f32 and a bf16 leaf, m = 4 learners) and
checking what comes back. The whole preset × layout × weighted ×
availability matrix, plus the two-tier hierarchy for every coordinator
preset, proves for each combination:

* **trigger** — the gate is a bool; a conditional trigger's hot mask is
  (m,) bool and its count an int; the condition's auxiliaries match the
  declared ``cond_aux`` keys; the trigger-owned extra state keeps its
  declared names and dtypes through ``init_extra`` / ``commit_extra`` /
  ``skip_extra``;
* **cohort** — the mask is (m,) bool, the key stays a (2,) int64 host
  tensor, the violation counter is owned exactly by stages declaring
  ``manages_v`` (an int ``v`` and a bool ``full``), ``aux`` keys match;
* **aggregate** — the output matches its declared kind: ``"model"`` a
  (P,) plane row, ``"fleet"`` the (m, P) plane, in the plane's dtype;
* **commit + round** — the committed plane and reference keep their
  shapes, dtypes and device; ``v`` and ``step`` are ints, the
  ``CommRecord`` fields ints, ``xfers`` / ``link_msgs`` (m,) int32;
* **layout equivalence** — the tree, flat and sharded (one rank) rounds
  give the same ``StageResult`` signature from the same inputs, and the
  flat and sharded rounds the same values, bit for bit (the tree layout
  runs the plane too, but draws aircomp's noise per leaf).

The port's control values are host values (Python ints and bools, numpy
masks, a CPU key), so the promises are stated for them; the
reference's weak-type checks have no counterpart in eager PyTorch.

Where it can, a stage runs on ``meta`` tensors (shapes and dtypes only,
no arithmetic). A stage that reads a device value on the host, or makes
a tensor on the plane's device through ``resolve_device``, cannot: then
the whole spec runs on a tiny CPU plane. ``host_reading_stages()`` names
the first such stage of each preset: the ``divergence``,
``robust_divergence`` and ``events_divergence`` triggers (the condition
fetches the distances), ``robust_cadence`` (its health counters read the
row distances) and the ``aircomp`` aggregate (its noise key is made on
the plane's device). The presets behind them hold more such stages (the
balancing cohort reads each safe-zone distance, the quarantine commit
the row distances); every other preset runs on ``meta`` alone.

``check_all()`` is the CI entry point (``python -m repro_torch.analysis
--contracts``): registry coverage + the full preset matrix.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis.report import Finding
from repro_torch.core.flatten import fleet_adapter, tree_leaves, tree_map
from repro_torch.core.sync import registry, stages
from repro_torch.core.sync.registry import (
    AGGREGATES, COHORTS, COMMITS, PROTOCOLS, TRIGGERS, StageCtx, SyncState,
)
from repro_torch.core.sync.spec import GLOBAL_PARAMS, LAYOUTS, ProtocolSpec

__all__ = [
    "DEFAULT_M", "mixed_template", "abstract_state", "check_registry",
    "check_spec", "check_round", "check_layout_equivalence",
    "check_hierarchy", "check_preset_matrix", "check_all",
    "host_reading_stages", "meter_round",
]

DEFAULT_M = 4            # fleet size of the template
DEFAULT_CLUSTERS = 2     # hierarchy width (must divide DEFAULT_M)


def mixed_template(m: int = DEFAULT_M, device="meta"):
    """A mixed-dtype (f32 + bf16) stacked model template on ``device``
    (``"meta"``: shapes and dtypes only). The plane promotes to f32; a
    stage that computes in another dtype (a mean accumulated in bf16 or
    f64) changes its output's dtype here and fails the check."""
    return {"w": torch.empty((m, 3, 2), dtype=torch.float32, device=device),
            "b": torch.empty((m, 2), dtype=torch.bfloat16, device=device)}


def _num_learners(template) -> int:
    return tree_leaves(template)[0].shape[0]


def _valued(template, device="cpu"):
    """The template with values on ``device``: rows drawn from a fixed
    generator, distinct enough that every condition fires."""
    gen = torch.Generator().manual_seed(0)
    return tree_map(lambda x: torch.randn(x.shape, generator=gen)
                    .to(device=device, dtype=x.dtype), template)


def _planes(template):
    """(adapter, (m, P) plane, (P,) reference row) of a template; the
    reference is the first learner's row, so the rows differ from it."""
    adapter = fleet_adapter(tree_map(lambda x: x[0], template))
    X = adapter.ravel(template)
    return adapter, X, X[0].clone()


def abstract_state(spec: ProtocolSpec, template, ref=None) -> SyncState:
    """The ``SyncState`` that ``init_state(ref, seed, spec=, m=)`` builds
    for a template fleet, extra state included."""
    m = _num_learners(template)
    if ref is None:
        ref = _planes(template)[2]
    return SyncState(ref=ref, v=0, step=0, key=prng.key(0, device="cpu"),
                     extra=spec.init_extra(m))


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def _sig(x):
    """(shape, dtype) of one tensor or array; ("py", type) otherwise."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, np.ndarray):
        return (tuple(x.shape), x.dtype.name)
    if isinstance(x, (bool, np.bool_)):
        return ("py", "bool")
    if isinstance(x, (int, np.integer)):
        return ("py", "int")
    return ("py", type(x).__name__)


def _sig_tree(t):
    if isinstance(t, dict):
        return {k: _sig_tree(v) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t).__name__, tuple(_sig_tree(v) for v in t)
    if isinstance(t, (list, tuple)):
        return tuple(_sig_tree(v) for v in t)
    return _sig(t)


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(
        x, (bool, np.bool_))


def _is_bool(x) -> bool:
    return isinstance(x, (bool, np.bool_))


def _is_vec(x, n, dtype) -> bool:
    return (isinstance(x, np.ndarray) and x.shape == (n,)
            and x.dtype == np.dtype(dtype))


def _is_key(x) -> bool:
    return (isinstance(x, torch.Tensor) and tuple(x.shape) == (2,)
            and x.dtype == torch.int64 and x.device.type == "cpu")


def _fmt(e: Exception) -> str:
    msg = f"{type(e).__name__}: {e}"
    return msg if len(msg) <= 300 else msg[:297] + "..."


# ---------------------------------------------------------------------------
# the stage harness: every slot once, as the compiled round wires them
# ---------------------------------------------------------------------------

def _inputs(spec, template, weighted, with_active, device):
    tmpl = template if device == "meta" else _valued(template, device)
    adapter, X, ref = _planes(tmpl)
    m = X.shape[0]
    w = (torch.linspace(1.0, 2.0, m, device=X.device) if weighted
         else None)
    act = (np.arange(m) % 3 != 2) if with_active else None
    adj = ~np.eye(m, dtype=bool)
    return adapter, X, ref, w, act, adj


def _trace_slots(spec: ProtocolSpec, template, *, weighted: bool,
                 with_active: bool, device: str,
                 meter=None) -> Dict[str, Any]:
    """Run every slot of ``spec`` once on ``template``'s plane, wired as
    ``spec.compile()`` wires them, at a round whose gate fires; return
    each slot's output (commit last: it writes the plane). ``meter(part)``
    gives a context manager around each part of the round: ``"gate"``
    (the gate), ``"sync"`` (what a checked round adds: the condition,
    cohort, aggregate, the commit-time extra state and the commit — the
    reference's sync branch) and ``"skip"`` (the skip round's extra
    state)."""
    meter = meter or (lambda part: contextlib.nullcontext())
    trig, coh, agg, com = spec.stage_records()
    p = spec.resolved_params()
    adapter, X, ref, w, act, adj = _inputs(spec, template, weighted,
                                           with_active, device)
    m = X.shape[0]
    b = p.get("b", 1)
    state = abstract_state(spec, template, ref)._replace(step=b - 1)
    ctx = StageCtx(params=p, flat=X, ref_flat=ref, state=state, weights=w,
                   m=m, t=b, reach=stages.cohort_all(m, act), active=act,
                   adjacency=adj, leaf_sizes=adapter.sizes, memo={})
    out = {"plane": (tuple(X.shape), X.dtype, X.device),
           "ref": (tuple(ref.shape), ref.dtype, ref.device),
           "init_extra": state.extra, "key": state.key}
    hot, nhot = ctx.reach, None
    with meter("gate"):
        out["gate"] = trig.gate(ctx)
    with meter("sync"):
        if trig.condition is not None:
            cond = trig.condition(ctx)
            hot, nhot = cond[0], cond[1]
            out["hot"], out["nhot"] = hot, nhot
            if len(cond) > 2:
                out["cond_aux"] = cond[2]
                ctx = ctx._replace(cond_aux=cond[2])
    with meter("skip"):
        out["skip_extra"] = trig.skip_extra(ctx)
    with meter("sync"):
        cout = coh.fn(ctx, hot, nhot if nhot is not None else 0, state.key)
        out["cohort"] = cout
        out["aggregate"] = agg.fn(ctx, cout)
        out["commit_extra"] = trig.commit_extra(ctx, cout.mask)
        out["commit"] = com.fn(ctx, cout, out["aggregate"], hot,
                               nhot if nhot is not None else 0)
    return out


def _run_somewhere(fn, *args, **kw):
    """``fn(..., device="meta")``, or on the CPU when a stage cannot run
    on ``meta`` (it reads a value on the host, or makes a tensor on the
    plane's device through ``resolve_device``); returns (result,
    device). A failure on the CPU too is the stage's own."""
    try:
        return fn(*args, device="meta", **kw), "meta"
    except Exception:  # noqa: BLE001 — retried with values on the CPU
        return fn(*args, device="cpu", **kw), "cpu"


def meter_round(spec: ProtocolSpec, template, measure) -> Dict[str, float]:
    """One fired round of ``spec``'s slots on ``template``, wired as
    ``spec.compile()`` wires them (on ``meta`` tensors where the stages
    allow, else a tiny CPU plane), with each part of the round — the
    gate, a quiet round's skip, a fired round's sync — under
    ``measure()``, a context manager whose value has ``.flops``.
    Returns ``{part: summed flops}``."""

    def run(device):
        parts = {"gate": 0.0, "skip": 0.0, "sync": 0.0}

        @contextlib.contextmanager
        def meter(part):
            with measure() as mode:
                yield
            parts[part] += mode.flops

        _trace_slots(spec, template, weighted=False, with_active=False,
                     device=device, meter=meter)
        return parts

    return _run_somewhere(run)[0]


def _variant_label(spec: ProtocolSpec, *, weighted: bool,
                   with_active: bool) -> str:
    name = spec.name or (f"{spec.trigger}/{spec.cohort}/"
                         f"{spec.aggregate}/{spec.commit}")
    tags = [spec.param("layout")]
    if weighted:
        tags.append("weighted")
    if not with_active:
        tags.append("ideal")
    return f"{name}[{','.join(tags)}]"


def _extra_findings(bad, trig, init, others) -> None:
    declared = dict(trig.contract.extra_state) if trig.contract else {}
    init_sig = _sig_tree(dict(init))
    if sorted(init_sig) != sorted(declared):
        bad("extra-state", f"trigger:{trig.name}",
            f"init_extra keys {sorted(init_sig)} != declared "
            f"{sorted(declared)}")
    else:
        for k, dt in declared.items():
            if init_sig[k][1] != np.dtype(dt).name:
                bad("extra-state", f"trigger:{trig.name}",
                    f"extra {k!r} is {init_sig[k][1]}, declared {dt}")
    for path, got in others:
        if _sig_tree(dict(got)) != init_sig:
            bad("extra-state", f"trigger:{trig.name}",
                f"{path} signature {_sig_tree(dict(got))} != init_extra "
                f"{init_sig} — the carried dict must keep its shapes and "
                f"dtypes across sync and skip rounds")


def check_spec(spec: ProtocolSpec, template=None, *, weighted: bool = False,
               with_active: bool = True) -> List[Finding]:
    """Verify every slot of one spec against its stages' declared
    contracts. Empty list = clean."""
    template = mixed_template() if template is None else template
    m = _num_learners(template)
    trig, coh, agg, com = spec.stage_records()
    label = _variant_label(spec, weighted=weighted, with_active=with_active)
    out: List[Finding] = []

    def bad(rule, slot, msg):
        out.append(Finding("contracts", rule, f"{label}/{slot}", msg))

    try:
        tr, _ = _run_somewhere(_trace_slots, spec, template,
                               weighted=weighted, with_active=with_active)
    except Exception as e:  # noqa: BLE001 — any failure is a finding
        return [Finding("contracts", "trace-error", label, _fmt(e))]
    plane_shape, plane_dt, plane_dev = tr["plane"]
    P = plane_shape[1]

    # ---- trigger ------------------------------------------------------
    if not _is_bool(tr["gate"]):
        bad("gate-shape", f"trigger:{trig.name}",
            f"gate must be a bool, got {_sig(tr['gate'])}")
    if trig.condition is not None:
        if not _is_vec(tr["hot"], m, bool):
            bad("hot-mask", f"trigger:{trig.name}",
                f"condition hot mask must be ({m},) bool, "
                f"got {_sig(tr['hot'])}")
        if not _is_int(tr["nhot"]):
            bad("hot-count", f"trigger:{trig.name}",
                f"condition count must be an int, got {_sig(tr['nhot'])}")
        declared_aux = tuple(sorted(trig.contract.cond_aux)) \
            if trig.contract else ()
        got_aux = tr.get("cond_aux")
        got_keys = tuple(sorted(got_aux)) if isinstance(got_aux, dict) \
            else ()
        if got_keys != declared_aux:
            bad("cond-aux", f"trigger:{trig.name}",
                f"condition aux keys {list(got_keys)} != declared "
                f"{list(declared_aux)}")
        for k in got_keys:
            v = got_aux[k]
            if getattr(v, "shape", (None,))[:1] != (m,):
                bad("cond-aux", f"trigger:{trig.name}",
                    f"condition aux {k!r} must be an (m, ...) array, "
                    f"got {_sig(v)}")
    _extra_findings(bad, trig, tr["init_extra"],
                    (("commit_extra", tr["commit_extra"]),
                     ("skip_extra", tr["skip_extra"])))

    # ---- cohort -------------------------------------------------------
    cout = tr["cohort"]
    if not _is_vec(cout.mask, m, bool):
        bad("cohort-mask", f"cohort:{coh.name}",
            f"mask must be ({m},) bool, got {_sig(cout.mask)}")
    if not _is_key(cout.key):
        bad("rng-dtype", f"cohort:{coh.name}",
            f"carried key {_sig(cout.key)} is not a (2,) int64 host key")
    if coh.contract is not None and coh.contract.manages_v:
        if not _is_int(cout.v):
            bad("counter-dtype", f"cohort:{coh.name}",
                f"declares manages_v: v must be an int, got {_sig(cout.v)}")
        if not _is_bool(cout.full):
            bad("counter-dtype", f"cohort:{coh.name}",
                f"declares manages_v: full must be a bool, "
                f"got {_sig(cout.full)}")
    elif cout.v is not None or cout.full is not None:
        bad("counter-owner", f"cohort:{coh.name}",
            "returns v/full without declaring manages_v")
    declared_aux = tuple(sorted(coh.contract.aux)) if coh.contract else ()
    got_keys = tuple(sorted(cout.aux)) if isinstance(cout.aux, dict) else ()
    if got_keys != declared_aux:
        bad("cohort-aux", f"cohort:{coh.name}",
            f"aux keys {list(got_keys)} != declared {list(declared_aux)}")

    # ---- aggregate ----------------------------------------------------
    kind = agg.contract.out if agg.contract else "model"
    want = (P,) if kind == "model" else (m, P)
    got = tr["aggregate"]
    if not (isinstance(got, torch.Tensor) and tuple(got.shape) == want
            and got.dtype == plane_dt):
        bad("aggregate-out", f"aggregate:{agg.name}",
            f"declared out={kind!r}: output {_sig(got)} != expected "
            f"{(want, str(plane_dt).replace('torch.', ''))}")

    # ---- commit -------------------------------------------------------
    sout = tr["commit"]
    if not (isinstance(sout.params, torch.Tensor)
            and tuple(sout.params.shape) == plane_shape
            and sout.params.dtype == plane_dt
            and sout.params.device == plane_dev):
        bad("commit-params", f"commit:{com.name}",
            f"committed plane {_sig(sout.params)} != input "
            f"{(plane_shape, str(plane_dt))} — shapes and dtypes must be "
            f"kept")
    ref_shape, ref_dt, _ = tr["ref"]
    if not (isinstance(sout.ref, torch.Tensor)
            and tuple(sout.ref.shape) == ref_shape
            and sout.ref.dtype == ref_dt):
        bad("commit-ref", f"commit:{com.name}",
            f"committed reference {_sig(sout.ref)} != input "
            f"{(ref_shape, str(ref_dt))}")
    if not _is_int(sout.v):
        bad("counter-dtype", f"commit:{com.name}",
            f"carried v must be an int, got {_sig(sout.v)}")
    if not _is_key(sout.key):
        bad("rng-dtype", f"commit:{com.name}",
            f"carried key {_sig(sout.key)} is not a (2,) int64 host key")
    for fname, fval in sout.rec._asdict().items():
        if not _is_int(fval):
            bad("ledger-dtype", f"commit:{com.name}",
                f"CommRecord.{fname} must be an int, got {_sig(fval)}")
    for fname in ("xfers", "link_msgs"):
        if not _is_vec(getattr(sout, fname), m, np.int32):
            bad("ledger-dtype", f"commit:{com.name}",
                f"{fname} must be ({m},) int32, "
                f"got {_sig(getattr(sout, fname))}")
    return out


# ---------------------------------------------------------------------------
# full-round checks (through spec.compile, what the engine runs)
# ---------------------------------------------------------------------------

def _run_round(spec: ProtocolSpec, template, *, weighted: bool,
               with_active: bool, device: str):
    adapter, X, ref, w, act, adj = _inputs(spec, template, weighted,
                                           with_active, device)
    b = spec.resolved_params().get("b", 1)
    state = abstract_state(spec, template, ref)._replace(step=b - 1)
    fn = spec.compile()
    res = fn(X, state, w if spec.param("weighted") else None, active=act,
             adjacency=adj, leaf_sizes=adapter.sizes)
    return res, state, (tuple(X.shape), X.dtype), (tuple(ref.shape),
                                                   ref.dtype)


def check_round(spec: ProtocolSpec, template=None, *,
                weighted: bool = False,
                with_active: bool = True) -> List[Finding]:
    """The round-boundary invariants of one compiled spec: the
    ``StageResult`` that the next round starts from keeps the input
    signatures exactly."""
    template = mixed_template() if template is None else template
    m = _num_learners(template)
    label = _variant_label(spec, weighted=weighted, with_active=with_active)
    out: List[Finding] = []

    def bad(rule, msg):
        out.append(Finding("contracts", rule, f"{label}/round", msg))

    try:
        (res, state0, (xs, xdt), (rs, rdt)), _ = _run_somewhere(
            _run_round, spec, template, weighted=weighted,
            with_active=with_active)
    except Exception as e:  # noqa: BLE001
        return [Finding("contracts", "trace-error", f"{label}/round",
                        _fmt(e))]
    if not (tuple(res.params.shape) == xs and res.params.dtype == xdt):
        bad("round-params",
            f"committed plane {_sig(res.params)} != input "
            f"{(xs, str(xdt))}")
    if not (tuple(res.state.ref.shape) == rs and res.state.ref.dtype == rdt):
        bad("round-ref",
            f"carried reference {_sig(res.state.ref)} != input "
            f"{(rs, str(rdt))}")
    for fname in ("v", "step"):
        if not _is_int(getattr(res.state, fname)):
            bad("round-counters",
                f"state.{fname} must be an int, "
                f"got {_sig(getattr(res.state, fname))}")
    if not _is_key(res.state.key):
        bad("rng-dtype", f"carried key {_sig(res.state.key)} is not a (2,) "
                         f"int64 host key")
    if _sig_tree(dict(res.state.extra)) != _sig_tree(dict(state0.extra)):
        bad("round-extra",
            f"carried extra state {_sig_tree(dict(res.state.extra))} != "
            f"initial {_sig_tree(dict(state0.extra))}")
    for fname, fval in res.rec._asdict().items():
        if not _is_int(fval):
            bad("ledger-dtype",
                f"CommRecord.{fname} must be an int, got {_sig(fval)}")
    for fname in ("xfers", "link_msgs"):
        if not _is_vec(getattr(res, fname), m, np.int32):
            bad("ledger-dtype",
                f"{fname} must be ({m},) int32, "
                f"got {_sig(getattr(res, fname))}")
    return out


def check_layout_equivalence(spec: ProtocolSpec, template=None, *,
                             layouts: Sequence[str] = LAYOUTS,
                             weighted: bool = False,
                             with_active: bool = True) -> List[Finding]:
    """The layouts are interchangeable: each layout's compiled round maps
    the same inputs (a CPU plane) to the same ``StageResult`` signature
    and the same values, bit for bit. ``"sharded"`` runs as one rank
    (no process group); ``tests/test_torch_shard.py`` holds it across
    ranks."""
    template = mixed_template() if template is None else template
    out: List[Finding] = []
    results = {}
    for layout in layouts:
        s = spec.with_params(layout=layout)
        label = _variant_label(s, weighted=weighted, with_active=with_active)
        try:
            res = _run_round(s, template, weighted=weighted,
                             with_active=with_active, device="cpu")[0]
        except Exception as e:  # noqa: BLE001
            out.append(Finding("contracts", "trace-error",
                               f"{label}/round", _fmt(e)))
            continue
        results[layout] = res
    if len(results) < 2:
        return out
    base_layout = next(iter(results))
    base = results[base_layout]
    name = spec.name or spec.trigger
    for layout, res in results.items():
        if layout != base_layout and _sig_tree(res) != _sig_tree(base):
            out.append(Finding(
                "contracts", "layout-equivalence",
                f"{name}[{base_layout} vs {layout}]",
                f"StageResult signatures differ between layouts: "
                f"{_sig_tree(base)} vs {_sig_tree(res)}"))
    flat, shd = results.get("flat"), results.get("sharded")
    if flat is not None and shd is not None and not (
            torch.equal(flat.params, shd.params)
            and torch.equal(flat.state.ref, shd.state.ref)
            and flat.rec == shd.rec
            and np.array_equal(flat.xfers, shd.xfers)
            and np.array_equal(flat.link_msgs, shd.link_msgs)):
        out.append(Finding(
            "contracts", "layout-equivalence", f"{name}[flat vs sharded]",
            "one rank's sharded round is not the flat round bit for bit"))
    return out


def check_hierarchy(spec: ProtocolSpec, template=None, *,
                    num_clusters: int = DEFAULT_CLUSTERS) -> List[Finding]:
    """The two-tier hierarchy for one intra-tier spec: the committed
    plane keeps its signature, and the member / aggregator ledger
    vectors are int32 of the right lengths."""
    from repro_torch.config import HierarchyConfig, ProtocolConfig
    from repro_torch.core.sync.hierarchy import (
        apply_hierarchical, init_hier_state,
    )
    from repro_torch.core.sync.spec import resolve_spec

    template = mixed_template() if template is None else template
    m = _num_learners(template)
    g = num_clusters
    name = spec.name or spec.trigger
    label = f"{name}[{spec.param('layout')},hier:{g}]"
    out: List[Finding] = []

    def bad(rule, msg):
        out.append(Finding("contracts", rule, label, msg))

    tiers = HierarchyConfig(num_clusters=g,
                            inter=ProtocolConfig(kind="periodic"))

    def run(device):
        adapter, X, ref, _, act, _ = _inputs(spec, template, False, True,
                                             device)
        hs = init_hier_state(ref, tiers, 0, m=m, intra_spec=spec,
                             inter_spec=resolve_spec(tiers.inter))
        res = apply_hierarchical(spec, tiers, X, hs, None, active=act,
                                 leaf_sizes=adapter.sizes)
        return res, (tuple(X.shape), X.dtype)

    try:
        (res, (xs, xdt)), _ = _run_somewhere(run)
    except Exception as e:  # noqa: BLE001
        return [Finding("contracts", "trace-error", label, _fmt(e))]
    if not (tuple(res.params.shape) == xs and res.params.dtype == xdt):
        bad("round-params",
            f"hierarchical round output {_sig(res.params)} != input "
            f"{(xs, str(xdt))}")
    for fname, n in (("member_xfers", m), ("member_msgs", m),
                     ("agg_xfers", g), ("agg_msgs", g)):
        if not _is_vec(getattr(res, fname), n, np.int32):
            bad("ledger-dtype",
                f"{fname} must be ({n},) int32, "
                f"got {_sig(getattr(res, fname))}")
    for fname, fval in res.rec._asdict().items():
        if not _is_int(fval):
            bad("ledger-dtype",
                f"CommRecord.{fname} must be an int, got {_sig(fval)}")
    return out


# ---------------------------------------------------------------------------
# registry coverage + the full matrix
# ---------------------------------------------------------------------------

def check_registry() -> List[Finding]:
    """Every registered stage must DECLARE a contract; a trigger's
    declared extra state must match its ``init_extra`` output."""
    out: List[Finding] = []
    for slot, reg in (("trigger", TRIGGERS), ("cohort", COHORTS),
                      ("aggregate", AGGREGATES), ("commit", COMMITS)):
        for name, rec in sorted(reg.items()):
            if rec.contract is None:
                out.append(Finding(
                    "contracts", "missing-contract", f"{slot}:{name}",
                    "registered without a StageContract — declare the "
                    "stage's promises at registration"))
    for name, rec in sorted(TRIGGERS.items()):
        if rec.contract is None:
            continue
        params = dict(GLOBAL_PARAMS)
        params.update(rec.params)
        try:
            extra = rec.init_extra(params, DEFAULT_M)
        except Exception as e:  # noqa: BLE001
            out.append(Finding("contracts", "trace-error",
                               f"trigger:{name}/init_extra", _fmt(e)))
            continue

        def bad(rule, where, msg):
            out.append(Finding("contracts", rule, where, msg))
        _extra_findings(bad, rec, extra, ())
    return out


def check_preset_matrix(template=None,
                        presets: Optional[Sequence[str]] = None
                        ) -> List[Finding]:
    """Every registered preset × layout × {weighted, unweighted} ×
    {masked, ideal}, plus layout equivalence per preset and the two-tier
    hierarchy for every coordinator preset."""
    template = mixed_template() if template is None else template
    out: List[Finding] = []
    names = sorted(PROTOCOLS) if presets is None else list(presets)
    for name in names:
        preset = registry.get_protocol(name)
        for layout in LAYOUTS:
            s = preset.with_params(layout=layout)
            for weighted in (False, True):
                for with_active in (True, False):
                    out += check_spec(s, template, weighted=weighted,
                                      with_active=with_active)
                    out += check_round(s, template, weighted=weighted,
                                       with_active=with_active)
        for weighted in (False, True):
            out += check_layout_equivalence(preset, template,
                                            weighted=weighted)
        if preset.uses_coordinator:
            for layout in LAYOUTS:
                out += check_hierarchy(preset.with_params(layout=layout),
                                       template)
    return out


def check_all(template=None) -> List[Finding]:
    """The CI gate: registry coverage + the full preset matrix."""
    return check_registry() + check_preset_matrix(template)


def host_reading_stages(template=None) -> List[str]:
    """The registered stages that cannot run on ``meta`` tensors because
    they read a device value on the host, found by running each preset's
    slots on ``meta`` one at a time."""
    template = mixed_template() if template is None else template
    found = set()
    for name in sorted(PROTOCOLS):
        spec = registry.get_protocol(name)
        for weighted in (False, True):
            for with_active in (True, False):
                try:
                    _trace_slots(spec, template, weighted=weighted,
                                 with_active=with_active, device="meta")
                except Exception as e:  # noqa: BLE001
                    found.add(_failing_stage(spec, e))
    return sorted(found)


def _failing_stage(spec: ProtocolSpec, e: Exception) -> str:
    """The slot:stage whose code raised ``e`` (the innermost frame in a
    module that registers stages)."""
    import traceback
    names = {}
    for slot, rec in zip(("trigger", "cohort", "aggregate", "commit"),
                         spec.stage_records()):
        fns = [getattr(rec, a, None) for a in
               ("gate", "condition", "commit_extra", "skip_extra", "fn")]
        for fn in fns:
            code = getattr(fn, "__code__", None)
            if code is not None:
                names[code] = f"{slot}:{rec.name}"
    stage = None
    for frame, _ in traceback.walk_tb(e.__traceback__):
        if frame.f_code in names:
            stage = names[frame.f_code]
    return stage or f"spec:{spec.name}"
