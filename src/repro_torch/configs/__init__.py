"""Model configurations — the counterpart of ``repro.configs`` (the
paper's own models and the serving zoo: the dense llama3-8b(-swa),
llama3-405b, minitron-4b and qwen1.5-110b, the mixture-of-experts
mixtral-8x22b and deepseek-v2-236b, mamba2-2.7b, the hybrid hymba-1.5b,
the vision backbone internvl2-76b and the audio backbone musicgen-large);
importing this package registers them."""
from repro_torch.configs import (  # noqa: F401  (registers)
    deepseek_v2_236b,
    hymba_1_5b,
    internvl2_76b,
    llama3_405b,
    llama3_8b,
    llama3_8b_swa,
    mamba2_2_7b,
    minitron_4b,
    mixtral_8x22b,
    musicgen_large,
    paper_models,
    qwen1_5_110b,
)

# the configs the launcher's dry run covers (``--all``), in the
# reference's order
ASSIGNED_ARCHS = (
    "internvl2-76b",
    "minitron-4b",
    "musicgen-large",
    "mixtral-8x22b",
    "qwen1.5-110b",
    "mamba2-2.7b",
    "llama3-405b",
    "llama3-8b",
    "hymba-1.5b",
    "deepseek-v2-236b",
)
