"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-0.5B scaled per assignment].

The counterpart of ``repro.configs.qwen1_5_110b``, field for field."""
from repro_torch.config import ModelConfig, register_arch


def full():
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=49152, vocab_size=152064, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0, dtype="bfloat16",
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def smoke():
    return ModelConfig(
        name="qwen1.5-110b-smoke", family="dense",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32, qkv_bias=True,
        source="hf:Qwen/Qwen1.5-0.5B",
    )


register_arch("qwen1.5-110b", full, smoke)
