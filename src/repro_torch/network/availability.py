"""Per-round learner availability masks, pure in ``(seed, t)`` — the
counterpart of ``repro.network.availability``.

``sample(net, m, t)`` is the (m,) bool active mask of round ``t``;
``sample_rounds(net, m, ts)`` gives the masks of several rounds at once,
as an ``(n, m)`` array, from one batched threefry call (a chunk's masks
are drawn together, not round by round). Both are host numpy arrays,
control values like the port's cohort draws, and equal the reference's
bit for bit: the keys are ``prng.key(seed ^ 0xAC71)`` folded with ``t``
(dropout), ``prng.key(seed ^ 0x57AA)`` (the straggler subset) and
``prng.key(seed ^ 0x0F0F)`` folded with the outage window.

Three stacking failure modes (all off by default):

* i.i.d. dropout   — each learner answers w.p. ``act_prob``
* stragglers       — a fixed ``straggler_frac`` subset (chosen once from
  ``seed``) answers with its own lower ``straggler_act_prob``
* scheduled outage — every ``outage_every`` rounds a fresh random
  ``outage_frac`` of the fleet goes dark for ``outage_length`` rounds

Availability means reachability: an unavailable learner keeps taking
local steps but cannot communicate that round.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch import prng
from repro_torch.config import NetworkConfig


def _draw_subset(key, m: int, n: int) -> np.ndarray:
    """(m,) bool: the first n entries of ``permutation(key, m)``."""
    mask = np.zeros((m,), bool)
    mask[prng.permutation(key, m, device="cpu")[:n].numpy()] = True
    return mask


def straggler_mask(net: NetworkConfig, m: int) -> np.ndarray:
    """(m,) bool — the fixed subset of learners that straggle."""
    n_strag = int(round(net.straggler_frac * m))
    if n_strag == 0:
        return np.zeros((m,), bool)
    return _draw_subset(prng.key(net.seed ^ 0x57AA, device="cpu"), m,
                        n_strag)


def sample_rounds(net: NetworkConfig, m: int,
                  ts: Sequence[int]) -> np.ndarray:
    """(n, m) bool active masks for the rounds ``ts``."""
    ts = np.asarray(ts, np.int64)
    keys = prng.fold_in(prng.key(net.seed ^ 0xAC71, device="cpu"), ts,
                        device="cpu")
    p = np.where(straggler_mask(net, m), np.float32(net.straggler_act_prob),
                 np.float32(net.act_prob))
    active = prng.uniform(keys, (m,), device="cpu").numpy() < p
    if net.outage_every > 0:
        okey = prng.key(net.seed ^ 0x0F0F, device="cpu")
        n_down = int(round(net.outage_frac * m))
        down = {}
        for i, t in enumerate(ts.tolist()):
            if t % net.outage_every >= net.outage_length:
                continue
            w = t // net.outage_every
            if w not in down:
                down[w] = _draw_subset(prng.fold_in(okey, w, device="cpu"),
                                       m, n_down)
            active[i] &= ~down[w]
    return active


def sample(net: NetworkConfig, m: int, t: int) -> np.ndarray:
    """(m,) bool active mask for round ``t``."""
    return sample_rounds(net, m, [t])[0]
