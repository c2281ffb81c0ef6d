"""Host-side tracing & profiling hooks (telemetry layer 2) — the
counterpart of ``repro.telemetry.trace``.

Wall-clock here always means ``time.perf_counter`` around a call whose
device work has finished: ``timed`` calls ``torch.cuda.synchronize``
after the call when the card is in use, since a CUDA launch returns
before its kernel runs.

``ChunkProfiler`` keeps, per chunk length, the first call's wall-clock
apart from the later ones. The port compiles no program per length, but
the first call of a length still pays one-time costs on the card (cuDNN
picking its convolution plans, the first use of a kernel loading and
building it), so ``compile_s`` is that first call and ``best_exec_s``
the best later one; ``recompiles`` counts the lengths seen.

``profiler_trace`` wraps a run in ``torch.profiler.profile`` and writes
a Chrome trace (``trace.json``) into its directory; ``step_annotation``
names a region of that trace with ``torch.profiler.record_function``
(the engine names each chunk when ``TelemetryConfig.profiler`` is set;
a no-op unless a trace is active).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.telemetry.sink import TelemetryLogger, get_logger

__all__ = ["timed", "span", "profiler_trace", "step_annotation",
           "ChunkProfiler"]


def _sync_card() -> None:
    """Wait for the card's queued work, if the card is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, **kw):
    """``(result, seconds)`` of one call, waiting for the card so the
    wall-clock covers execution, not the launches."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync_card()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def span(name: str, logger: Optional[TelemetryLogger] = None, **fields):
    """Time a host-side region and emit it as a ``span`` event (silent
    unless the logger has handlers). The body is responsible for waiting
    on device work it wants included — wrap it in ``timed``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        (logger or get_logger()).event(
            "span", name=name,
            seconds=time.perf_counter() - t0, **fields)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace (CPU, and CUDA when a card is visible)
    over the with-body, written to ``<log_dir>/trace.json`` when
    ``log_dir`` is set; a no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def step_annotation(name: str, step: int):
    """A ``record_function`` range named ``<name>#<step>`` (a no-op
    unless a trace is active)."""
    return torch.profiler.record_function(f"{name}#{step}")


class ChunkProfiler:
    """First-call-vs-later accounting per chunk length.

    ``begin(n)`` returns True at the first sighting of length ``n`` (one
    ``recompiles`` count: on the card its call also pays cuDNN's plan
    selection and the kernels' first-use load or build);
    ``observe(n, wall_s)`` files the measurement. ``summary()`` is
    JSON-ready: per-length counts, the first call's wall-clock
    (``compile_s``) and the best later one."""

    def __init__(self):
        self.recompiles = 0
        self._stats: Dict[int, Dict[str, Any]] = {}

    def begin(self, n: int) -> bool:
        first = n not in self._stats
        if first:
            self.recompiles += 1
            self._stats[n] = {"calls": 0, "compile_s": None,
                              "best_exec_s": None, "total_s": 0.0}
        return first

    def observe(self, n: int, wall_s: float) -> None:
        if n not in self._stats:      # begin() not called — count it now
            self.begin(n)
        st = self._stats[n]
        st["calls"] += 1
        st["total_s"] += wall_s
        if st["compile_s"] is None:
            st["compile_s"] = wall_s
        else:
            best = st["best_exec_s"]
            st["best_exec_s"] = (wall_s if best is None
                                 else min(best, wall_s))

    def summary(self) -> Dict[str, Any]:
        return {
            "recompiles": self.recompiles,
            "chunk_lengths": {str(n): dict(st)
                              for n, st in sorted(self._stats.items())},
        }
