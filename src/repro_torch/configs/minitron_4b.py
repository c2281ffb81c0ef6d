"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron [arXiv:2407.14679].

The counterpart of ``repro.configs.minitron_4b``, field for field."""
from repro_torch.config import ModelConfig, register_arch


def full():
    return ModelConfig(
        name="minitron-4b", family="dense",
        num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=9216, vocab_size=256000, head_dim=128,
        dtype="bfloat16", source="arXiv:2407.14679",
    )


def smoke():
    return ModelConfig(
        name="minitron-4b-smoke", family="dense",
        num_layers=2, d_model=192, num_heads=6, num_kv_heads=2,
        d_ff=384, vocab_size=512, head_dim=32,
        source="arXiv:2407.14679",
    )


register_arch("minitron-4b", full, smoke)
