"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free, no FFN)
vocab=50280, ssm_state=128, head_dim 64, chunk 64, one group, bf16 —
SSD, state-space duality [arXiv:2405.21060]. The counterpart of
``repro.configs.mamba2_2_7b``, field for field."""
from repro_torch.config import BLOCK_SSM, ModelConfig, SSMConfig, register_arch


def full():
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280, block_type=BLOCK_SSM,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=64, ngroups=1),
        dtype="bfloat16", source="arXiv:2405.21060",
    )


def smoke():
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm",
        num_layers=2, d_model=256, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=512, block_type=BLOCK_SSM,
        ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=64,
                      chunk_size=16, ngroups=1),
        source="arXiv:2405.21060",
    )


register_arch("mamba2-2.7b", full, smoke)
