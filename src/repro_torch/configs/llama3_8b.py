"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, rope theta 500,000, bf16 [arXiv:2407.21783] — the
counterpart of ``repro.configs.llama3_8b``, field for field."""
from repro_torch.config import ModelConfig, register_arch


def full():
    return ModelConfig(
        name="llama3-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=128256, head_dim=128,
        rope_theta=500_000.0, dtype="bfloat16",
        source="arXiv:2407.21783",
    )


def smoke():
    return ModelConfig(
        name="llama3-8b-smoke", family="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        rope_theta=500_000.0,
        source="arXiv:2407.21783",
    )


register_arch("llama3-8b", full, smoke)
