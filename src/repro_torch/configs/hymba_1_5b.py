"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads
[arXiv:2411.13676]. Sliding-window attention in the attention branch (the
Hymba recipe uses SWA in all but 3 layers); the SSM branch gives global
context, so long_500k decode is bounded-state.

The counterpart of ``repro.configs.hymba_1_5b``, field for field."""
from repro_torch.config import (
    ModelConfig, SSMConfig, register_arch, BLOCK_HYBRID, ATTN_SLIDING,
)


def full():
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        d_ff=5504, vocab_size=32001, head_dim=64,
        block_type=BLOCK_HYBRID, attn_type=ATTN_SLIDING, sliding_window=1024,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      chunk_size=64, ngroups=1),
        dtype="bfloat16", source="arXiv:2411.13676",
    )


def smoke():
    return ModelConfig(
        name="hymba-1.5b-smoke", family="hybrid",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        block_type=BLOCK_HYBRID, attn_type=ATTN_SLIDING, sliding_window=16,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      chunk_size=16, ngroups=1),
        source="arXiv:2411.13676",
    )


register_arch("hymba-1.5b", full, smoke)
