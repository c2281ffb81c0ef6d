"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec tokenizer / mel frontend is the allowed stub;
a caller passes 4 parallel codebook token streams (delay-pattern
interleaving is a data-layout concern outside the backbone).

The counterpart of ``repro.configs.musicgen_large``, field for field."""
from repro_torch.config import MODALITY_AUDIO, ModelConfig, register_arch


def full():
    return ModelConfig(
        name="musicgen-large", family="audio",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=2048, head_dim=64, modality=MODALITY_AUDIO,
        dtype="bfloat16", source="arXiv:2306.05284",
    )


def smoke():
    return ModelConfig(
        name="musicgen-large-smoke", family="audio",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=8,
        d_ff=512, vocab_size=256, head_dim=32, modality=MODALITY_AUDIO,
        source="arXiv:2306.05284",
    )


register_arch("musicgen-large", full, smoke)
