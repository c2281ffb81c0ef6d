"""The observatory: analyze a telemetry stream from the file alone — the
counterpart of ``repro.telemetry.observatory``; it reads the streams of
both packages (one schema).

Everything here consumes ONLY the JSONL a recorded run wrote — the meta
record carries the run's static facts (fleet size, payload sizes, link
classes, the serialized spec), the round records carry the exact
per-round cumulative series — so the paper's headline axes reconstruct
without touching the engine:

* ``frontier``  — the comm-vs-loss frontier (cumulative bytes vs.
  cumulative loss per round; the paper's Fig. 5 axis),
* ``summarize`` — the run card: totals, sync efficiency (bytes per unit
  of round-loss improvement), divergence-vs-Δ trajectory, per-link-class
  byte histogram, recompile/wall accounting,
* ``prom_text`` — Prometheus text exposition of the counters/gauges,
* ``tail_records`` — the newest k records (optionally following a live
  file, which works because the sink flushes per chunk).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.telemetry.record import (
    KIND_CHUNK, KIND_EVENT, KIND_META, KIND_ROUND, validate_record,
)

__all__ = ["Run", "load_run", "iter_records", "frontier", "age_histogram",
           "summarize", "prom_text", "tail_records"]


@dataclass
class Run:
    """One parsed + schema-validated telemetry stream."""
    meta: Dict[str, Any]
    rounds: List[Dict[str, Any]] = field(default_factory=list)
    chunks: List[Dict[str, Any]] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)
    metas: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def resumed(self) -> bool:
        return any(m.get("resumed_rounds", 0) > 0 for m in self.metas)


def iter_records(path: str) -> Iterator[Dict[str, Any]]:
    """Yield one validated record per JSONL line (line numbers in every
    error message)."""
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"line {i}: not valid JSON ({e})") from None
            yield validate_record(d, line=i)


def load_run(path: str) -> Run:
    """Parse + validate a whole stream. Raises ``ValueError`` on the
    first schema violation, a missing meta record, or out-of-order
    rounds."""
    run: Optional[Run] = None
    for rec in iter_records(path):
        kind = rec["kind"]
        if kind == KIND_META:
            if run is None:
                run = Run(meta=rec, metas=[rec])
            else:
                run.metas.append(rec)   # checkpoint resume
            continue
        if run is None:
            raise ValueError(
                f"stream {path!r} does not start with a meta record")
        if kind == KIND_ROUND:
            if run.rounds and rec["round"] != run.rounds[-1]["round"] + 1:
                raise ValueError(
                    f"round records out of order: {rec['round']} after "
                    f"{run.rounds[-1]['round']}")
            run.rounds.append(rec)
        elif kind == KIND_CHUNK:
            run.chunks.append(rec)
        elif kind == KIND_EVENT:
            run.events.append(rec)
    if run is None:
        raise ValueError(f"stream {path!r} holds no records")
    return run


# ---------------------------------------------------------------------------
# analyses
# ---------------------------------------------------------------------------

def frontier(run: Run) -> List[List[float]]:
    """The comm-vs-loss frontier: ``[round, cum_bytes, cum_loss]`` per
    recorded round — cumulative bytes bought cumulative loss progress."""
    return [[r["round"], r["cum_bytes"], r["cum_loss"]]
            for r in run.rounds]


def _downsample(rows: List[List[float]], k: int) -> List[List[float]]:
    if len(rows) <= k:
        return rows
    stride = max(1, len(rows) // k)
    out = rows[::stride]
    if out[-1] is not rows[-1]:
        out.append(rows[-1])
    return out


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def sync_efficiency(run: Run) -> Optional[Dict[str, float]]:
    """Bytes per unit of round-loss improvement: the mean per-round loss
    of the first vs. last decile of rounds, against the bytes spent
    between them. None when the run is too short (< 20 rounds) or did
    not improve."""
    rounds = run.rounds
    if len(rounds) < 20:
        return None
    k = max(1, len(rounds) // 10)
    head = [r["loss"] for r in rounds[:k]]
    tail = [r["loss"] for r in rounds[-k:]]
    drop = _mean(head) - _mean(tail)
    spent = rounds[-1]["cum_bytes"] - rounds[k - 1]["cum_bytes"]
    if drop <= 0.0:
        return {"loss_drop": drop, "bytes_spent": spent,
                "bytes_per_unit_loss": float("inf")}
    return {"loss_drop": drop, "bytes_spent": spent,
            "bytes_per_unit_loss": spent / drop}


def link_class_bytes(run: Run) -> Dict[str, int]:
    """Cumulative bytes per link CLASS (wired/wifi/lte/edge/ideal): the
    last chunk record's per-link ledger joined with the meta record's
    link-class names."""
    if not run.chunks:
        return {}
    classes = run.meta["link_classes"]
    cum = run.chunks[-1]["link_bytes_cum"]
    out: Dict[str, int] = {}
    for name, b in zip(classes, cum):
        out[name] = out.get(name, 0) + int(b)
    return out


def _flat_int_lists(node: Any, prefix: str = "") -> Dict[str, List[int]]:
    """Walk a ``stale_age`` snapshot (nested dicts of lists), yielding the
    1-D integer vectors keyed by dotted path. Deeper nestings — e.g. the
    async timeline's (m, depth) delay ring — are bookkeeping, not
    per-learner counters, and are skipped."""
    out: Dict[str, List[int]] = {}
    if isinstance(node, dict):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            out.update(_flat_int_lists(v, key))
        return out
    if (isinstance(node, list) and node
            and all(isinstance(x, (int, float)) and not isinstance(x, bool)
                    for x in node)):
        out[prefix] = [int(x) for x in node]
    return out


def age_histogram(run: Run) -> Dict[str, Any]:
    """Per-counter value histogram of the chunk-end trigger-state
    snapshot (the last chunk record's ``stale_age``): for each carried
    per-learner vector — staleness ages, in-flight countdowns, local
    clocks — the value→count map plus min/max/mean. Empty dict when the
    run's protocol carries no trigger state."""
    if not run.chunks:
        return {}
    snap = run.chunks[-1].get("stale_age")
    if snap is None:
        return {}
    out: Dict[str, Any] = {}
    for key, vals in sorted(_flat_int_lists(snap).items()):
        hist: Dict[str, int] = {}
        for v in vals:
            hist[str(v)] = hist.get(str(v), 0) + 1
        out[key] = {
            "min": min(vals), "max": max(vals), "mean": _mean(vals),
            "hist": hist,
        }
    return out


def summarize(run: Run, points: int = 50) -> Dict[str, Any]:
    """The run card — JSON-ready, built from the stream alone."""
    meta, rounds = run.meta, run.rounds
    spec = meta.get("spec") or {}
    out: Dict[str, Any] = {
        "m": meta["m"],
        "spec": spec.get("name"),
        "delta": (spec.get("params") or {}).get("delta"),
        "model_bytes": meta["model_bytes"],
        "hierarchical": meta.get("tiers") is not None,
        "resumed": run.resumed,
        "rounds": rounds[-1]["round"] if rounds else 0,
        "chunks": len(run.chunks),
    }
    if not rounds:
        return out
    last = rounds[-1]
    out.update({
        "cum_loss": last["cum_loss"],
        "mean_round_loss": _mean([r["loss"] for r in rounds]),
        "cum_bytes": last["cum_bytes"],
        "cum_syncs": last["cum_syncs"],
        "sync_rate": last["cum_syncs"] / last["round"],
        "full_syncs": sum(r["full_sync"] for r in rounds),
        "messages": sum(r["messages"] for r in rounds),
        "mean_active": _mean([r["num_active"] for r in rounds]),
        "net_time_s": last["cum_net_time"],
        "bytes_per_round": last["cum_bytes"] / last["round"],
        "sync_efficiency": sync_efficiency(run),
        "frontier": _downsample(frontier(run), points),
        "divergence": _downsample(
            [[r["round"], r["divergence"]] for r in rounds], points),
        "link_class_bytes": link_class_bytes(run),
    })
    if meta.get("tiers") is not None:
        out["uplink_bytes"] = sum(
            r.get("uplink_bytes") or 0 for r in rounds)
    ages = age_histogram(run)
    if ages:
        out["state_ages"] = ages
    if any(r.get("inflight") is not None for r in rounds):
        out["inflight"] = _downsample(
            [[r["round"], r.get("inflight") or 0, r.get("max_age") or 0]
             for r in rounds], points)
        out["inflight_last"] = last.get("inflight") or 0
        out["max_age_last"] = last.get("max_age") or 0
    # fault card: present only when the stream was written under a
    # FaultConfig and/or a robust (health-carrying) protocol
    has_faults = any(r.get("num_faulty") is not None for r in rounds)
    has_health = any(r.get("num_quarantined") is not None for r in rounds)
    if has_faults or has_health:
        card: Dict[str, Any] = {}
        if has_faults:
            card["faulty_rounds"] = sum(
                1 for r in rounds if r.get("num_faulty"))
            card["max_faulty"] = max(
                r.get("num_faulty") or 0 for r in rounds)
            card["faulty"] = _downsample(
                [[r["round"], r.get("num_faulty") or 0] for r in rounds],
                points)
        if has_health:
            card["total_recovered"] = sum(
                r.get("num_recovered") or 0 for r in rounds)
            card["quarantined_last"] = last.get("num_quarantined") or 0
            card["quarantine"] = _downsample(
                [[r["round"], r.get("num_quarantined") or 0,
                  r.get("num_recovered") or 0] for r in rounds], points)
        out["faults"] = card
    walls = [c["wall_s"] for c in run.chunks if "wall_s" in c]
    if walls:
        out["profile"] = {
            "wall_s": sum(walls),
            "recompiles": max(
                (c.get("recompiles", 0) for c in run.chunks), default=0),
            "chunks_timed": len(walls),
        }
    return out


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_line(lines, name, value, help_=None, typ=None, labels=None):
    if help_:
        lines.append(f"# HELP {name} {help_}")
    if typ:
        lines.append(f"# TYPE {name} {typ}")
    label_s = ""
    if labels:
        inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
        label_s = "{" + inner + "}"
    lines.append(f"{name}{label_s} {value}")


def prom_text(run: Run) -> str:
    """Prometheus text-format exposition of the stream's counters and
    last-round gauges (scrape-ready; also a stable machine interface for
    dashboards that don't speak the JSONL). The metric names are the
    reference's, so a dashboard reads both packages alike."""
    lines: List[str] = []
    rounds = run.rounds
    last = rounds[-1] if rounds else None
    _prom_line(lines, "repro_rounds_total",
               last["round"] if last else 0,
               help_="Executed protocol rounds", typ="counter")
    if last is not None:
        _prom_line(lines, "repro_comm_bytes_total", last["cum_bytes"],
                   help_="Cumulative communication bytes (c(f) accounting)",
                   typ="counter")
        _prom_line(lines, "repro_syncs_total", last["cum_syncs"],
                   help_="Rounds in which averaging happened",
                   typ="counter")
        _prom_line(lines, "repro_messages_total",
                   sum(r["messages"] for r in rounds),
                   help_="Control messages (violations + polls)",
                   typ="counter")
        _prom_line(lines, "repro_net_time_seconds_total",
                   last["cum_net_time"],
                   help_="Simulated network seconds", typ="counter")
        first = True
        for cls, b in sorted(link_class_bytes(run).items()):
            _prom_line(
                lines, "repro_link_class_bytes_total", b,
                help_="Cumulative bytes per link class" if first else None,
                typ="counter" if first else None,
                labels={"link_class": cls})
            first = False
        _prom_line(lines, "repro_round_loss", last["loss"],
                   help_="Fleet loss of the last recorded round",
                   typ="gauge")
        _prom_line(lines, "repro_cumulative_loss", last["cum_loss"],
                   help_="Cumulative fleet loss", typ="gauge")
        _prom_line(lines, "repro_divergence", last["divergence"],
                   help_="Fleet divergence of the last recorded round",
                   typ="gauge")
        _prom_line(lines, "repro_num_active", last["num_active"],
                   help_="Reachable learners in the last recorded round",
                   typ="gauge")
    return "\n".join(lines) + "\n"


def tail_records(path: str, k: int = 10) -> List[Dict[str, Any]]:
    """The newest ``k`` records of a stream (validated)."""
    recs = list(iter_records(path))
    return recs[-k:]
