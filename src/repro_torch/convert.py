"""Carry weights between the reference and the port.

The reference's parameter tree, as ``jax.tree.map(np.asarray, params)``
gives it (for the paper's models ``{"layers": [{"b": ..., "w": ...},
{}, ...]}``; for the LM ``{"embed", "blocks": {...}, "final_norm",
"lm_head"}`` with L-leading block leaves, and likewise its KV cache or
its SSM and conv states),
becomes the port's tree of tensors with the same structure
and the same bytes, and back. Leaves keep their layout (conv weights
HWIO), so ``fleet_adapter(tree).ravel_model(tree)`` is the plane row the
reference's ``FleetAdapter.ravel_model`` gives. No jax is needed: the
walk is ``repro_torch.core.flatten``'s (dict keys sorted, lists in
order).

bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) are carried by their
bits; ``params_to_numpy`` returns them widened to float32 (exactly),
since the port imports no ``ml_dtypes``.

``key_from_numpy`` carries a raw threefry key (``np.asarray`` of a
``jax.random.PRNGKey``: ``uint32``, shape ``(..., 2)``) into the port's
key layout (``repro_torch.prng``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flatten import tree_map
from repro_torch.device import resolve_device


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def params_from_numpy(tree, device="cuda"):
    """The reference's numpy parameter tree (or any numpy tree: an LM's
    KV cache with its int32 ring-buffer tags too) -> the port's tensor
    tree on ``device``, the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def params_to_numpy(tree):
    """The port's tensor tree -> a numpy tree of the same structure."""
    return tree_map(_to_numpy, tree)


def key_from_numpy(key, device="cuda") -> torch.Tensor:
    """A raw ``uint32`` threefry key (or batch of keys, ``(..., 2)``) ->
    the port's int64 key tensor with the same two words, on ``device``."""
    key = np.asarray(key)
    if key.dtype != np.uint32 or key.shape[-1:] != (2,):
        raise ValueError(f"a raw key is uint32 with 2 words in its last "
                         f"axis, got {key.dtype} {key.shape}")
    return torch.from_numpy(key.astype(np.int64)).to(resolve_device(device))
