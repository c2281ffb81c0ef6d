"""The round auditor: watch a spec's rounds run for forbidden patterns —
the counterpart of ``repro.analysis.audit``.

``repro_torch.analysis.contracts`` proves the SIGNATURES of the protocol
machinery; this module inspects the PROGRAM as it runs. A
``TorchDispatchMode`` sees every operator a chunk of rounds dispatches,
and the auditor flags:

* **float64-leak** / **complex-leak** — a tensor of that dtype made on
  the plane's device inside a round: the fleet is an f32 program on the
  device. The port's deliberate float64 sums (the cumulative loss, the
  network time) are host numpy values, not device tensors.
* **host-sync** — the host waiting for the device: each
  ``aten._local_scalar_dense`` (``.item()``, ``float(t)``) and each
  device-to-host copy, counted against the budget the port documents
  (PERF.md §3, the learner row): 1 per chunk (the losses' one transfer),
  + 1 per round that fetches the row distances (a checked round of a
  trigger whose condition reads them, or else a sync whose cohort or
  commit does), + 1 per safe-zone test of the balancing augmentation
  (one before its first step and one after each). More than the budget
  is a finding. On the CPU a device-to-host copy is not an operator
  (``.cpu()`` of a CPU tensor returns it), so there the auditor counts
  the calls of ``Tensor.cpu``; on the card it counts the copies.
* **int32-accumulator** — a narrow-int array carried across rounds in
  ``SyncState.extra`` that grows by more than one a round with no reset
  (no element ever falls), i.e. one that can wrap silently. The
  engine's own counters pass: the staleness ages and health counters
  grow by one and reset; the 64-bit ledgers are exempt by width.

The reference's **callback-in-scan** is this port's **host-sync**: the
port's rounds are eager host Python, and what costs a round trip is a
wait for the device. Its **weak-type-carry** and **dynamic-shape** rules
have no meaning in eager PyTorch — a tensor has one dtype and one
concrete shape, and nothing is retraced — so they are not checked. Its
HLO-text backend (``audit_hlo``) has no counterpart: there is no HLO.

``audit_spec`` runs a spec's compiled round on a small CPU plane (the
CI gate's entry point, ``audit_presets``); ``audit_learner`` runs one
chunk of a real engine, on whichever device it lives (the card's check
in ``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.report import Finding
from repro_torch.core.sync import stages

__all__ = ["HostSyncMode", "audit_carry", "audit_spec", "audit_learner",
           "audit_presets", "host_sync_budget"]

_BAD_DTYPES = {torch.float64: "float64-leak",
               torch.complex128: "complex-leak"}


class HostSyncMode(TorchDispatchMode):
    """Counts the host's waits for ``device`` and records tensors of a
    64-bit float or complex dtype made on it. ``syncs`` is the total,
    ``by_kind`` splits it into ``item`` and ``copy``."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.by_kind = {"item": 0, "copy": 0}
        self.leaks: List[str] = []

    @property
    def syncs(self) -> int:
        return self.by_kind["item"] + self.by_kind["copy"]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket).split(".")[-1]
        if name == "_local_scalar_dense":
            self.by_kind["item"] += 1
        elif self.device.type != "cpu" and name in ("_to_copy", "copy_"):
            src = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            dst = out if isinstance(out, torch.Tensor) else None
            if (dst is not None and dst.device.type == "cpu"
                    and any(t.device.type == self.device.type for t in src)):
                self.by_kind["copy"] += 1
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.dtype in _BAD_DTYPES
                    and t.device.type == self.device.type):
                self.leaks.append(f"{name}:{str(t.dtype)[6:]}:"
                                  f"{tuple(t.shape)}")
        return out


@contextlib.contextmanager
def _watch(device):
    """The dispatch mode, the CPU's ``Tensor.cpu`` count and a count of
    the augmentation's safe-zone tests, for one block."""
    mode = HostSyncMode(device)
    tests = {"safe_zone": 0}
    cpu, safe = torch.Tensor.cpu, stages._safe_dist

    def counted_cpu(self, *a, **kw):
        mode.by_kind["copy"] += 1
        return cpu(self, *a, **kw)

    def counted_safe(*a, **kw):
        tests["safe_zone"] += 1
        return safe(*a, **kw)

    stages._safe_dist = counted_safe
    if mode.device.type == "cpu":
        torch.Tensor.cpu = counted_cpu
    try:
        with mode:
            yield mode, tests
    finally:
        torch.Tensor.cpu = cpu
        stages._safe_dist = safe


def _reads_on_check(spec) -> bool:
    """The trigger's condition fetches the row distances."""
    trig = spec.stage_records()[0]
    return trig.contract is not None and "dists" in trig.contract.cond_aux


def _reads_on_sync(spec) -> bool:
    """A sync fetches the distances when the trigger did not: the
    balancing cohort's max-distance priority, the quarantine's outlier
    test, the robust triggers' health counters."""
    if _reads_on_check(spec):
        return False
    trig, coh, _, com = spec.stage_records()
    return ((coh.name == "balanced"
             and spec.param("augmentation") == "max_distance")
            or com.name == "quarantine" or "health" in spec.extra_state)


def host_sync_budget(spec, *, chunks: int, checked, synced,
                     safe_zone_tests: int) -> int:
    """The documented budget of host syncs for a run of ``spec``:
    ``checked`` / ``synced`` are per-round bools (the gate fired, a sync
    ran)."""
    checked, synced = np.asarray(checked, bool), np.asarray(synced, bool)
    budget = chunks + safe_zone_tests
    if _reads_on_check(spec):
        budget += int(checked.sum())
    elif _reads_on_sync(spec):
        budget += int(synced.sum())
    return budget


def audit_carry(series: Sequence[Dict[str, Any]],
                where: str = "carry") -> List[Finding]:
    """The int32-accumulator rule over the carried extra state of
    consecutive rounds (``series[i]`` the dict after round i)."""
    findings: List[Finding] = []
    if len(series) < 2:
        return findings
    for name in series[0]:
        vals = [np.asarray(s[name]) for s in series]
        dt = vals[0].dtype
        if not (np.issubdtype(dt, np.integer) and dt.itemsize < 8):
            continue
        steps = np.stack([b.astype(np.int64) - a.astype(np.int64)
                          for a, b in zip(vals, vals[1:])])
        if (steps > 1).any() and not (steps < 0).any():
            findings.append(Finding(
                "audit", "int32-accumulator", f"{where}/extra[{name}]",
                f"{dt.name} carried array grows by up to "
                f"{int(steps.max())} a round with no reset — it can wrap "
                f"silently; accumulate in int64 on the host (the bytes-"
                f"ledger pattern) or reset it"))
    return findings


def _sync_findings(where, mode, budget) -> List[Finding]:
    out = []
    for leak in sorted(set(mode.leaks)):
        op, dt, shape = leak.split(":")
        out.append(Finding(
            "audit", _BAD_DTYPES[getattr(torch, dt)], f"{where}/{op}",
            f"{op} makes a {dt} tensor {shape} on the plane's device — the "
            f"fleet is an f32 program on the device"))
    if mode.syncs > budget:
        out.append(Finding(
            "audit", "host-sync", where,
            f"{mode.syncs} host syncs ({mode.by_kind['item']} item, "
            f"{mode.by_kind['copy']} copies) against a budget of {budget}: "
            f"the host waits for the device more than the port documents"))
    return out


def audit_spec(spec, template=None, *, rounds: int = 4,
               device="cpu") -> List[Finding]:
    """Run ``rounds`` compiled rounds of ``spec`` on the contracts
    module's template plane (availability-masked, so every stage path
    runs), under the auditor."""
    return _audit_spec(spec, template, rounds=rounds, device=device)[0]


def _audit_spec(spec, template, *, rounds, device):
    from repro_torch.analysis.contracts import (
        _inputs, _variant_label, abstract_state, mixed_template,
    )
    template = mixed_template() if template is None else template
    label = _variant_label(spec, weighted=False, with_active=True)
    fn = spec.compile()
    try:
        adapter, X, ref, _, act, adj = _inputs(spec, template, False, True,
                                               device)
        state = abstract_state(spec, template, ref)
        series, checked, synced = [], [], []
        with _watch(X.device) as (mode, tests):
            for _ in range(rounds):
                res = fn(X, state, None, active=act, adjacency=adj,
                         leaf_sizes=adapter.sizes)
                X, state = res.params, res.state
                series.append(dict(state.extra))
                checked.append(res.checked)
                synced.append(res.rec.syncs > 0)
    except Exception as e:  # noqa: BLE001 — any failure is a finding
        msg = f"{type(e).__name__}: {e}"
        return [Finding("audit", "trace-error", label,
                        msg if len(msg) <= 300 else msg[:297] + "...")], None
    budget = host_sync_budget(spec, chunks=0, checked=checked,
                              synced=synced,
                              safe_zone_tests=tests["safe_zone"])
    counts = {"syncs": mode.syncs, **mode.by_kind, "budget": budget,
              "safe_zone_tests": tests["safe_zone"],
              "checked": int(np.sum(checked)), "synced": int(np.sum(synced))}
    return (_sync_findings(label, mode, budget)
            + audit_carry(series, label)), counts


def audit_learner(dl, batches) -> Dict[str, Any]:
    """One chunk of the engine ``dl`` (``batches`` its (n, m, B, ...)
    leaves) under the auditor: ``{"findings", "syncs", "item", "copy",
    "budget", ...}``, the budget from this chunk's checked and synced
    rounds and its safe-zone tests."""
    with _watch(dl.device) as (mode, tests):
        metrics = dl.run_chunk(batches)
    budget = host_sync_budget(dl.spec, chunks=1, checked=metrics.checked,
                              synced=np.asarray(metrics.comm.syncs) > 0,
                              safe_zone_tests=tests["safe_zone"])
    label = f"learner[{dl.spec.name or dl.spec.trigger}]"
    return {"findings": _sync_findings(label, mode, budget),
            "syncs": mode.syncs, **mode.by_kind, "budget": budget,
            "safe_zone_tests": tests["safe_zone"],
            "checked": int(np.sum(metrics.checked)),
            "synced": int(np.sum(np.asarray(metrics.comm.syncs) > 0)),
            "metrics": metrics}


def audit_presets(template=None,
                  presets: Optional[Sequence[str]] = None) -> List[Finding]:
    """Audit every registered preset's rounds, on every layout (one
    rank for ``"sharded"``)."""
    from repro_torch.core.sync.registry import PROTOCOLS, get_protocol
    from repro_torch.core.sync.spec import LAYOUTS
    findings: List[Finding] = []
    names = sorted(PROTOCOLS) if presets is None else list(presets)
    for name in names:
        preset = get_protocol(name)
        for layout in LAYOUTS:
            findings += audit_spec(preset.with_params(layout=layout),
                                   template)
    return findings
