"""The telemetry plane's versioned record schema — the counterpart of
``repro.telemetry.record``, the same kinds, keys and ``SCHEMA_VERSION``,
so each package reads the other's streams.

A telemetry stream is a sequence of JSON objects (one per JSONL line),
each tagged with a ``kind``:

* ``meta``  — once per stream (plus once per resume): the run's static
  facts — fleet size, model/payload sizes, per-link classes, the
  serialized ``ProtocolSpec`` and tier block. Everything the observatory
  CLI needs to analyze the stream *from the file alone*.
* ``round`` — one per executed round (``RoundRecord``): this round's
  loss / divergence / trigger accounting / cohort size / reachability /
  simulated network time / bytes, plus the exact cumulative counters
  after the round. Cumulative integer fields are exact (int64 host
  arithmetic); cumulative floats use the same float64 running sums the
  engine's host counters accumulate, so the last record of a run equals
  ``DecentralizedLearner``'s counters bitwise.
* ``chunk`` — one per executed chunk: chunk-granularity facts that do
  not exist per round — the cumulative per-link bytes ledger, the
  trigger-carried state in ``SyncState.extra`` (a chunk-end snapshot),
  and, when profiling is enabled, the chunk's wall-clock and whether it
  was the first call of its length (``compiled``).
* ``event`` — free-form structured events from the
  ``repro_torch.telemetry.sink.TelemetryLogger`` (launcher progress, spans).

``SCHEMA_VERSION`` is embedded in every record as ``v``;
``validate_record``/``RoundRecord.from_dict`` REJECT a mismatched
version (a stream written by a future schema must fail loudly, not parse
into garbage).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple

SCHEMA_VERSION = 1

KIND_META = "meta"
KIND_ROUND = "round"
KIND_CHUNK = "chunk"
KIND_EVENT = "event"

KINDS = (KIND_META, KIND_ROUND, KIND_CHUNK, KIND_EVENT)


def _require_version(d: Dict[str, Any], where: str) -> None:
    v = d.get("v")
    if v != SCHEMA_VERSION:
        raise ValueError(
            f"telemetry schema version mismatch in {where} record: "
            f"got v={v!r}, this reader speaks v={SCHEMA_VERSION}")


def _as_int(d: Dict[str, Any], key: str) -> int:
    val = d[key]
    if isinstance(val, bool) or not isinstance(val, int):
        raise ValueError(
            f"round record field {key!r} must be an integer, got {val!r}")
    return val


def _as_float(d: Dict[str, Any], key: str) -> float:
    val = d[key]
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        raise ValueError(
            f"round record field {key!r} must be a number, got {val!r}")
    return float(val)


@dataclass(frozen=True)
class RoundRecord:
    """One executed round of the protocol, host-side.

    Per-round fields are THIS round's values; ``cum_*`` fields are the
    exact cumulative counters after it. ``messages`` is the round's
    control-message count (violation notices + poll requests — the
    trigger-fire signal); ``cohort`` the models sent up (the synchronized
    cohort's size); ``round_bytes``/``cum_bytes`` use the engine's c(f)
    accounting (the per-link ledger sum under a hierarchy). ``link_bytes``
    is the optional per-link byte vector for this round
    (``TelemetryConfig.per_link``); ``uplink_bytes`` the aggregator-uplink
    share under a hierarchy. ``inflight``/``max_age`` are written only by
    state-carrying protocols (async timeline / bounded staleness): the
    number of learners with a message still in flight after the round and
    the oldest rounds-since-sync counter. ``num_faulty`` is written only
    under a ``FaultConfig`` (learners under any injected fault this
    round); ``num_quarantined``/``num_recovered`` only by robust
    protocols carrying health counters (learners currently quarantined /
    recovering this round)."""
    round: int              # 1-based global round index
    loss: float             # fleet loss this round (sum over learners)
    cum_loss: float
    divergence: float       # 0.0 unless the engine tracks divergence
    messages: int           # control messages this round (trigger fires)
    cohort: int             # models sent up this round (cohort size)
    sync: int               # 1 if any averaging happened
    full_sync: int          # 1 if the whole reachable fleet averaged
    cum_syncs: int
    num_active: int         # reachable learners this round
    net_time: float         # simulated network seconds this round
    cum_net_time: float
    round_bytes: int        # bytes moved this round (c(f) accounting)
    cum_bytes: int
    v: int = SCHEMA_VERSION
    link_bytes: Optional[Tuple[int, ...]] = None   # (L,) this round
    uplink_bytes: Optional[int] = None             # hierarchy uplink share
    inflight: Optional[int] = None                 # learners in flight
    max_age: Optional[int] = None                  # oldest sync-age counter
    num_faulty: Optional[int] = None               # learners under a fault
    num_quarantined: Optional[int] = None          # quarantined learners
    num_recovered: Optional[int] = None            # recoveries this round

    _INT_FIELDS = ("round", "messages", "cohort", "sync", "full_sync",
                   "cum_syncs", "num_active", "round_bytes", "cum_bytes")
    _FLOAT_FIELDS = ("loss", "cum_loss", "divergence", "net_time",
                     "cum_net_time")

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict (``kind`` tag included, None fields omitted)."""
        d: Dict[str, Any] = {"kind": KIND_ROUND, "v": self.v}
        for f in self._INT_FIELDS:
            d[f] = int(getattr(self, f))
        for f in self._FLOAT_FIELDS:
            d[f] = float(getattr(self, f))
        if self.link_bytes is not None:
            d["link_bytes"] = [int(x) for x in self.link_bytes]
        if self.uplink_bytes is not None:
            d["uplink_bytes"] = int(self.uplink_bytes)
        if self.inflight is not None:
            d["inflight"] = int(self.inflight)
        if self.max_age is not None:
            d["max_age"] = int(self.max_age)
        for f in ("num_faulty", "num_quarantined", "num_recovered"):
            val = getattr(self, f)
            if val is not None:
                d[f] = int(val)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoundRecord":
        """Parse + validate one round record; raises ``ValueError`` on a
        schema-version mismatch, a wrong ``kind``, missing fields, or
        mistyped values."""
        if d.get("kind") != KIND_ROUND:
            raise ValueError(
                f"not a round record: kind={d.get('kind')!r}")
        _require_version(d, KIND_ROUND)
        missing = [f for f in cls._INT_FIELDS + cls._FLOAT_FIELDS
                   if f not in d]
        if missing:
            raise ValueError(f"round record missing fields: {missing}")
        kw: Dict[str, Any] = {f: _as_int(d, f) for f in cls._INT_FIELDS}
        kw.update({f: _as_float(d, f) for f in cls._FLOAT_FIELDS})
        if d.get("link_bytes") is not None:
            kw["link_bytes"] = tuple(int(x) for x in d["link_bytes"])
        if d.get("uplink_bytes") is not None:
            kw["uplink_bytes"] = int(d["uplink_bytes"])
        if d.get("inflight") is not None:
            kw["inflight"] = _as_int(d, "inflight")
        if d.get("max_age") is not None:
            kw["max_age"] = _as_int(d, "max_age")
        for f in ("num_faulty", "num_quarantined", "num_recovered"):
            if d.get(f) is not None:
                kw[f] = _as_int(d, f)
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known - {"kind"})
        if unknown:
            raise ValueError(f"round record has unknown fields: {unknown}")
        return cls(**kw)


def meta_record(*, m: int, model_size: int, model_bytes: int,
                msg_bytes: int, num_links: int,
                link_classes: Tuple[str, ...],
                spec: Optional[Dict[str, Any]] = None,
                tiers: Optional[Dict[str, Any]] = None,
                resumed_rounds: int = 0) -> Dict[str, Any]:
    """The stream's static facts — written once at recorder construction
    (and again on a checkpoint resume, with ``resumed_rounds`` set, so a
    resumed stream is self-describing about where it picks up)."""
    if len(link_classes) != num_links:
        raise ValueError(
            f"link_classes must name all {num_links} links, "
            f"got {len(link_classes)}")
    return {
        "kind": KIND_META, "v": SCHEMA_VERSION,
        "m": int(m), "model_size": int(model_size),
        "model_bytes": int(model_bytes), "msg_bytes": int(msg_bytes),
        "num_links": int(num_links), "link_classes": list(link_classes),
        "spec": spec, "tiers": tiers,
        "resumed_rounds": int(resumed_rounds),
    }


def chunk_record(*, chunk: int, rounds_end: int, n: int,
                 link_bytes_cum, stale_age=None,
                 wall_s: Optional[float] = None,
                 compiled: Optional[bool] = None,
                 recompiles: Optional[int] = None) -> Dict[str, Any]:
    """One executed chunk: the cumulative per-link ledger at chunk
    end, the chunk-end staleness-age snapshot (``SyncState.extra``), and
    the profiling span when enabled."""
    d: Dict[str, Any] = {
        "kind": KIND_CHUNK, "v": SCHEMA_VERSION,
        "chunk": int(chunk), "rounds_end": int(rounds_end), "n": int(n),
        "link_bytes_cum": [int(x) for x in link_bytes_cum],
    }
    if stale_age is not None:
        d["stale_age"] = stale_age
    if wall_s is not None:
        d["wall_s"] = float(wall_s)
    if compiled is not None:
        d["compiled"] = bool(compiled)
    if recompiles is not None:
        d["recompiles"] = int(recompiles)
    return d


def validate_record(d: Dict[str, Any], line: int = 0) -> Dict[str, Any]:
    """Validate one parsed JSONL object of any kind; round records come
    back as their dict form (round-tripped through ``RoundRecord`` so the
    field types are enforced). Raises ``ValueError`` with the line number
    on any schema violation."""
    where = f"line {line}" if line else "record"
    kind = d.get("kind")
    if kind not in KINDS:
        raise ValueError(f"{where}: unknown record kind {kind!r}; "
                         f"known: {KINDS}")
    if kind == KIND_ROUND:
        try:
            return RoundRecord.from_dict(d).to_dict()
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from None
    _require_version(d, f"{where} ({kind})")
    if kind == KIND_CHUNK:
        for f in ("chunk", "rounds_end", "n", "link_bytes_cum"):
            if f not in d:
                raise ValueError(f"{where}: chunk record missing {f!r}")
    if kind == KIND_META:
        for f in ("m", "model_bytes", "msg_bytes", "num_links",
                  "link_classes"):
            if f not in d:
                raise ValueError(f"{where}: meta record missing {f!r}")
    return d
