"""llama3-8b-swa: the llama3-8b backbone with sliding-window attention
(window 8192; the smoke form's window is 16) — the counterpart of
``repro.configs.llama3_8b_swa``. [arXiv:2407.21783 + Mistral-style SWA]"""
import dataclasses

from repro_torch.config import ATTN_SLIDING, register_arch
from repro_torch.configs import llama3_8b


def full():
    return dataclasses.replace(
        llama3_8b.full(), name="llama3-8b-swa",
        attn_type=ATTN_SLIDING, sliding_window=8192)


def smoke():
    return dataclasses.replace(
        llama3_8b.smoke(), name="llama3-8b-swa-smoke",
        attn_type=ATTN_SLIDING, sliding_window=16)


register_arch("llama3-8b-swa", full, smoke)
