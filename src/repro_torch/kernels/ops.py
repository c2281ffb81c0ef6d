"""Public kernel entry points — the counterpart of ``repro.kernels.ops``.

Dispatch is by the device of the tensors: a CUDA tensor launches the
hand-written kernel (``repro_torch.kernels.sqdist``), a CPU tensor runs
the plain version (``repro_torch.kernels.ref``). There is no fallback: a
kernel that fails to build or launch raises.

``LAUNCHES`` counts kernel launches by entry point, so a run can show
that its main path went through the kernels; ``reset_launches`` zeroes
it. Plain-version calls are not counted.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import sqdist as _sqdist

LAUNCHES = {"sqdist_rows": 0, "sqdist": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sqdist_rows(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Batched local condition over the flat fleet plane:
    ``(m, P) x (P,) -> (m,)`` row-wise squared distances in f32."""
    if X.device.type == "cpu" and r.device.type == "cpu":
        return ref.sqdist_rows_ref(X, r)
    out = _sqdist.sqdist_rows(X, r)
    LAUNCHES["sqdist_rows"] += 1
    return out


def sqdist(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``||x - r||^2`` over flattened same-shape inputs, in f32."""
    if x.device.type == "cpu" and r.device.type == "cpu":
        return ref.sqdist_ref(x, r)
    out = _sqdist.sqdist(x, r)
    LAUNCHES["sqdist"] += 1
    return out
