"""Model configurations — the counterpart of ``repro.configs`` (the
paper's own models and the dense llama3-8b family so far); importing
this package registers them."""
from repro_torch.configs import (  # noqa: F401  (registers)
    llama3_8b,
    llama3_8b_swa,
    paper_models,
)
