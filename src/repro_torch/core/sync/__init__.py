"""The staged sync kernel on the flat fleet plane — the counterpart of
``repro.core.sync``: protocols as compositions of registered trigger,
cohort, aggregate and commit stages, with the nosync/periodic/continuous/
fedavg/dynamic/gossip presets and bounded staleness (``stale``)."""
from repro_torch.core.sync import kernel, registry, spec, stages  # noqa: F401
from repro_torch.core.sync import staleness  # noqa: F401  (registers "stale")
from repro_torch.core.sync.kernel import (  # noqa: F401
    PROTOCOLS, CommRecord, StageResult, SyncState, apply_staged, init_state,
    register_protocol,
)
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec  # noqa: F401
