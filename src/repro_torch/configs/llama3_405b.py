"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783].

The counterpart of ``repro.configs.llama3_405b``, field for field."""
from repro_torch.config import ModelConfig, register_arch


def full():
    return ModelConfig(
        name="llama3-405b", family="dense",
        num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
        d_ff=53248, vocab_size=128256, head_dim=128,
        rope_theta=500_000.0, dtype="bfloat16",
        source="arXiv:2407.21783",
    )


def smoke():
    return ModelConfig(
        name="llama3-405b-smoke", family="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        rope_theta=500_000.0,
        source="arXiv:2407.21783",
    )


register_arch("llama3-405b", full, smoke)
