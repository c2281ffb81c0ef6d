"""The models — the counterpart of ``repro.models``: the paper's CNN/MLP
families and the decoder LMs (dense GQA, MoE, MLA, Mamba2, the Hymba
hybrid, and the vision and audio backbones)."""
