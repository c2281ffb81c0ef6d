"""Telemetry sinks + the structured event logger — the counterpart of
``repro.telemetry.sink``.

``TelemetrySink`` is the record stream's output: every record lands in a
bounded in-memory ring (``collections.deque(maxlen=ring)``) and — when a
path is configured — is appended to a JSONL file, one JSON object per
line, flushed per chunk so ``python -m repro_torch.telemetry tail --follow``
sees a live run.

``TelemetryLogger`` is the event side: LIBRARY code emits structured
events (``log.event("train_step", step=3, loss=0.12)``) and stays silent
unless a handler is attached; CLI entry points attach a
``console_handler`` (text formatting) or ``jsonl_handler`` (a sink).
This is the inversion the repo's lint rule enforces: no bare ``print``
in library code — events carry the data, handlers own the formatting.
"""
from __future__ import annotations

import collections
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "TelemetrySink", "TelemetryLogger", "get_logger", "console_handler",
    "jsonl_handler",
]

Handler = Callable[[Dict[str, Any]], None]


class TelemetrySink:
    """Bounded in-memory ring + optional JSONL file stream."""

    def __init__(self, path: Optional[str] = None, ring: int = 1024,
                 append: bool = False):
        if ring < 1:
            raise ValueError(f"ring must hold >= 1 record, got {ring!r}")
        self.path = path
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._file = None
        if path:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._file = open(path, "a" if append else "w",
                              encoding="utf-8")

    def write(self, rec: Dict[str, Any]) -> None:
        self._ring.append(rec)
        if self._file is not None:
            self._file.write(json.dumps(rec, sort_keys=True) + "\n")

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    @property
    def records(self) -> List[Dict[str, Any]]:
        """The ring's current contents, oldest first."""
        return list(self._ring)

    def tail(self, k: Optional[int] = None) -> List[Dict[str, Any]]:
        recs = list(self._ring)
        return recs if k is None else recs[-k:]

    def __enter__(self) -> "TelemetrySink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TelemetryLogger:
    """Structured events with pluggable handlers. With no handlers
    attached, ``event`` is a no-op — library code can emit
    unconditionally; only configured entry points produce output."""

    def __init__(self):
        self._handlers: List[Handler] = []

    def add_handler(self, handler: Handler) -> Handler:
        self._handlers.append(handler)
        return handler

    def remove_handler(self, handler: Handler) -> None:
        self._handlers = [h for h in self._handlers if h is not handler]

    @property
    def enabled(self) -> bool:
        return bool(self._handlers)

    def event(self, kind: str, **fields: Any) -> None:
        if not self._handlers:
            return
        rec = {"kind": kind, **fields}
        for h in list(self._handlers):
            h(rec)


_DEFAULT_LOGGER = TelemetryLogger()


def get_logger() -> TelemetryLogger:
    """The process-wide default event logger (handler-less — silent —
    until an entry point attaches a handler)."""
    return _DEFAULT_LOGGER


def _fmt_value(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4f}" if 1e-4 <= abs(v) < 1e6 or v == 0.0 else f"{v:.3e}"
    return str(v)


def console_handler(stream=None) -> Handler:
    """Text formatting for a CLI: one ``kind key=value ...`` line per
    event, flushed immediately (launcher progress must stream)."""
    out = stream if stream is not None else sys.stdout

    def handler(rec: Dict[str, Any]) -> None:
        kind = rec.get("kind", "event")
        body = " ".join(f"{k}={_fmt_value(v)}" for k, v in rec.items()
                        if k != "kind")
        out.write(f"{kind} {body}".rstrip() + "\n")
        if hasattr(out, "flush"):
            out.flush()

    return handler


def jsonl_handler(sink: TelemetrySink) -> Handler:
    """Route events into a record sink (they land as ``kind: event``-style
    objects alongside the round/chunk records)."""
    from repro_torch.telemetry.record import KIND_EVENT, SCHEMA_VERSION

    def handler(rec: Dict[str, Any]) -> None:
        body = {k: v for k, v in rec.items() if k != "kind"}
        sink.write({"kind": KIND_EVENT, "v": SCHEMA_VERSION,
                    "event": rec.get("kind", "event"), **body})

    return handler
