"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and resolve it here. A
CUDA device that is not there raises: the port never runs on the CPU
unless the caller asks for it with ``device="cpu"``, as the tests do.

On the card, float32 convolutions and matrix products are pinned to full
float32 (cuDNN would run convolutions in TF32 by default), so the card
computes what the CPU tests hold the port to.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was asked for but no CUDA device is "
                f"visible; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    return dev
