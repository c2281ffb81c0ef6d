"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

The counterpart of ``repro.configs.mixtral_8x22b``, field for field."""
from repro_torch.config import (
    ATTN_SLIDING, ModelConfig, MoEConfig, register_arch,
)


def full():
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768, head_dim=128,
        attn_type=ATTN_SLIDING, sliding_window=4096,
        moe=MoEConfig(num_experts=8, num_experts_per_tok=2),
        rope_theta=1_000_000.0, dtype="bfloat16",
        source="arXiv:2401.04088",
    )


def smoke():
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        attn_type=ATTN_SLIDING, sliding_window=16,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2,
                      capacity_factor=8.0),
        source="arXiv:2401.04088",
    )


register_arch("mixtral-8x22b", full, smoke)
