"""repro_torch.telemetry — the fleet telemetry plane, the counterpart of
``repro.telemetry``.

1. **Round records** (``record``/``sink``/``recorder``): a versioned,
   schema'd record per executed round, built on the host from what each
   chunk already fetches, streamed to JSONL and a bounded in-memory ring.
   Attach it with ``TelemetryConfig`` through
   ``DecentralizedLearner(telemetry=...)`` or
   ``run_protocol_training(telemetry=...)``. The schema is the
   reference's: each package reads the other's streams.
2. **Tracing & profiling** (``trace``): wall-clock spans that wait for
   the card, per-chunk-length first-call accounting, and the optional
   ``torch.profiler`` trace and chunk annotations. The reference's static
   per-stage cost attribution (``costs``) reads jaxpr FLOPs and waits for
   ROADMAP Queue A 20.
3. **Observatory** (``observatory``, ``python -m repro_torch.telemetry``):
   summarize/tail a recorded stream from the file alone.
"""
from repro_torch.telemetry.record import (  # noqa: F401
    SCHEMA_VERSION, RoundRecord, chunk_record, meta_record,
    validate_record,
)
from repro_torch.telemetry.recorder import RoundRecorder  # noqa: F401
from repro_torch.telemetry.sink import (  # noqa: F401
    TelemetryLogger, TelemetrySink, console_handler, get_logger,
    jsonl_handler,
)
from repro_torch.telemetry.trace import (  # noqa: F401
    ChunkProfiler, profiler_trace, span, step_annotation, timed,
)

__all__ = [
    "SCHEMA_VERSION", "RoundRecord", "chunk_record", "meta_record",
    "validate_record", "RoundRecorder", "TelemetrySink", "TelemetryLogger",
    "get_logger", "console_handler", "jsonl_handler", "timed", "span",
    "profiler_trace", "step_annotation", "ChunkProfiler",
]
