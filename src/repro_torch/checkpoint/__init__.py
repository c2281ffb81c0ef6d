from repro_torch.checkpoint.io import (  # noqa: F401
    load_counters, load_protocol_spec, load_protocol_state,
    load_protocol_tiers, load_pytree, save_protocol_state, save_pytree,
)
