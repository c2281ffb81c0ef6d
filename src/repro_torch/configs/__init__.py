"""The paper's model configurations — the counterpart of ``repro.configs``
(this slice ports the paper's own models only)."""
from repro_torch.configs import paper_models  # noqa: F401  (registers)
