"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(per expert)
vocab=102400, MLA kv_lora=512, MoE 2 shared + 160 routed top-6
[arXiv:2405.04434].

The counterpart of ``repro.configs.deepseek_v2_236b``, field for field."""
from repro_torch.config import (
    MLAConfig, ModelConfig, MoEConfig, register_arch,
)


def full():
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        d_ff=1536, vocab_size=102400, head_dim=128,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64),
        moe=MoEConfig(num_experts=160, num_experts_per_tok=6,
                      num_shared_experts=2, expert_d_ff=1536),
        dtype="bfloat16", source="arXiv:2405.04434",
    )


def smoke():
    return ModelConfig(
        name="deepseek-v2-236b-smoke", family="moe",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=8,
        d_ff=128, vocab_size=512, head_dim=32,
        mla=MLAConfig(kv_lora_rank=64, q_lora_rank=48, rope_head_dim=16),
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2,
                      num_shared_experts=1, expert_d_ff=128,
                      capacity_factor=8.0),
        source="arXiv:2405.04434",
    )


register_arch("deepseek-v2-236b", full, smoke)
