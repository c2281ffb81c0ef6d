"""The staged sync kernel on the flat fleet plane — the counterpart of
``repro.core.sync``: protocols as compositions of registered trigger,
cohort, aggregate and commit stages, with the nosync/periodic/continuous/
fedavg/dynamic/gossip presets, bounded staleness (``stale``), the
event-driven timeline and over-the-air aggregation (``async_sync``), the
Byzantine-robust stages, presets and ``hardened`` rewriter (``robust``),
and the two-tier hierarchy (``hierarchy``)."""
from repro_torch.core.sync import kernel, registry, spec, stages  # noqa: F401
from repro_torch.core.sync import staleness  # noqa: F401  (registers "stale")
from repro_torch.core.sync import async_sync  # noqa: F401  (async presets)
from repro_torch.core.sync import robust  # noqa: F401  (robust presets)
from repro_torch.core.sync.kernel import (  # noqa: F401
    PROTOCOLS, CommRecord, StageResult, SyncState, apply_staged, init_state,
    register_protocol,
)
from repro_torch.core.sync.robust import hardened  # noqa: F401
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec  # noqa: F401
