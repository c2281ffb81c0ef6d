"""Serving — the counterpart of ``repro.serve``."""
from repro_torch.serve.engine import (  # noqa: F401
    ServeEngine, make_decode_step, make_prefill,
)
