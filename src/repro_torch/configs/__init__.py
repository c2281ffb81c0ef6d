"""Model configurations — the counterpart of ``repro.configs`` (the
paper's own models, the dense llama3-8b family and mamba2-2.7b so far);
importing this package registers them."""
from repro_torch.configs import (  # noqa: F401  (registers)
    llama3_8b,
    llama3_8b_swa,
    mamba2_2_7b,
    paper_models,
)
