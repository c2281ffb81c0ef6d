"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + Llama3-70B-style language backbone
[arXiv:2404.16821].

Backbone only: the InternViT-6B vision tower + MLP projector is the allowed
stub; a caller passes projected patch embeddings (B, S_img,
d_model) which are prepended to the text-token embeddings.

The counterpart of ``repro.configs.internvl2_76b``, field for field."""
from repro_torch.config import MODALITY_VISION, ModelConfig, register_arch

NUM_PATCHES = 256   # stub vision prefix length per sample


def full():
    return ModelConfig(
        name="internvl2-76b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256, head_dim=128, modality=MODALITY_VISION,
        rope_theta=500_000.0, dtype="bfloat16",
        source="arXiv:2404.16821",
    )


def smoke():
    return ModelConfig(
        name="internvl2-76b-smoke", family="vlm",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32, modality=MODALITY_VISION,
        source="arXiv:2404.16821",
    )


register_arch("internvl2-76b", full, smoke)
