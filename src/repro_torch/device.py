"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and resolve it here. A
CUDA device that is not there raises: the port never runs on the CPU
unless the caller asks for it with ``device="cpu"``, as the tests do.

On the card, float32 convolutions and matrix products are pinned to full
float32 (cuDNN would run convolutions in TF32 by default), so the card
computes what the CPU tests hold the port to, and cuDNN is held to
deterministic algorithms: for the deep-driving CNN it would otherwise
pick weight-gradient kernels that add with float atomics, and a run's
sync decisions, which compare distances with Delta, would change from
run to run.
"""
from __future__ import annotations

import numpy as np
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
        torch.backends.cudnn.deterministic = True
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    return dev


def versions() -> dict:
    """The toolchain a run used: torch's version and the CUDA it was
    built for (None for a CPU build)."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda}


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: the array itself on the
    CPU; on a card, a pinned copy sent asynchronously (the caching host
    allocator keeps the pinned buffer until the copy has run); elsewhere
    (``meta``) a plain copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
