"""Communication topologies as (m, m) adjacency matrices — the
counterpart of ``repro.network.topology``.

Every builder returns a symmetric host numpy bool matrix with a zero
diagonal, equal to the reference's bit for bit. The coordinator
protocols (periodic/fedavg/dynamic) read only the availability mask;
the adjacency is the peer overlay of the coordinator-free ``gossip``.

``geometric`` supports mobility: with ``NetworkConfig.redraw_every = k``
the node positions are re-drawn every k rounds, so the adjacency of
round ``t`` is a pure function of ``(seed, t)``.

The geometric edge test ``dx² + dy² < radius²`` is an f32 compare, and
the reference rounds its sum in two ways: where it is built once (a
static overlay, op by op) as ``f32(f32(dx·dx) + f32(dy·dy))``, and where
the scanned round builds it (a mobile overlay, one fused XLA program)
as the multiply-add ``fma(dy, dy, f32(dx·dx))``, rounded once. The two
differ in the last bit for about one pair in six, which flips an edge
that lies within an ulp of the radius. ``random_geometric(fused=...)``
computes either; ``adjacency`` picks the one the reference engine uses.
Positions are multiples of 2⁻²³ in [0, 1), so dx and dy are exact f32
values, their squares are exact in f64, and the f64 sum of
``dy·dy`` and ``f32(dx·dx)`` is exact too: rounding it to f32 is the
multiply-add.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch import prng
from repro_torch.config import (
    NetworkConfig, TOPO_ERDOS_RENYI, TOPO_GEOMETRIC, TOPO_RING, TOPO_STAR,
    TOPO_TORUS,
)


def _no_self(adj: np.ndarray) -> np.ndarray:
    return adj & ~np.eye(adj.shape[0], dtype=bool)


def star(m: int, hub: int = 0) -> np.ndarray:
    """Hub-and-spokes: every learner peers with ``hub`` only."""
    adj = np.zeros((m, m), bool)
    adj[hub, :] = True
    adj[:, hub] = True
    return _no_self(adj)


def ring(m: int) -> np.ndarray:
    """i ~ i±1 (mod m)."""
    i = np.arange(m)
    adj = np.zeros((m, m), bool)
    adj[i, (i + 1) % m] = True
    adj[i, (i - 1) % m] = True
    return _no_self(adj)


def complete(m: int) -> np.ndarray:
    return _no_self(np.ones((m, m), bool))


def _torus_sides(m: int) -> tuple:
    a = max(1, int(math.isqrt(m)))
    while m % a:
        a -= 1
    return a, m // a


def torus(m: int) -> np.ndarray:
    """2-d torus on the most-square a×b factorization of m (a ring when m
    is prime)."""
    a, b = _torus_sides(m)
    idx = np.arange(m).reshape(a, b)
    adj = np.zeros((m, m), bool)
    for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
        nbr = np.roll(idx, shift, axis)
        adj[idx.reshape(-1), nbr.reshape(-1)] = True
    return _no_self(adj | adj.T)


def erdos_renyi(key, m: int, p: float) -> np.ndarray:
    """Each of the m(m-1)/2 undirected edges present i.i.d. w.p. ``p``."""
    u = prng.uniform(key, (m, m), device="cpu").numpy()
    upper = np.triu(u < np.float32(p), k=1)
    return _no_self(upper | upper.T)


def sq_dists(pos: np.ndarray, fused: bool = False) -> np.ndarray:
    """(m, m) f32 squared distances between the (m, 2) f32 positions,
    ``dx·dx + dy·dy`` op by op, or with ``fused`` as the multiply-add
    ``fma(dy, dy, f32(dx·dx))`` (exact in f64 for positions on the 2⁻²³
    grid; see the module docstring)."""
    dx = pos[:, None, 0] - pos[None, :, 0]
    dy = pos[:, None, 1] - pos[None, :, 1]
    if fused:
        return ((dx * dx).astype(np.float64)
                + dy.astype(np.float64) ** 2).astype(np.float32)
    return dx * dx + dy * dy


def random_geometric(key, m: int, radius: float,
                     fused: bool = False) -> np.ndarray:
    """Nodes uniform in [0,1]^2, edge iff the squared distance, in f32,
    is below ``radius²`` (rounded to f32)."""
    pos = prng.uniform(key, (m, 2), device="cpu").numpy()
    return _no_self(sq_dists(pos, fused) < np.float32(radius * radius))


def adjacency(net: NetworkConfig, m: int,
              t: Optional[int] = None) -> np.ndarray:
    """The (m, m) adjacency of ``net`` at round ``t``. Static topologies
    ignore ``t``; a mobile ``geometric`` overlay (``redraw_every > 0``)
    re-draws its positions every ``redraw_every`` rounds and rounds its
    distances as the reference's scanned round does."""
    key = prng.key(net.seed ^ 0x70B0, device="cpu")
    if net.topology == TOPO_STAR:
        return star(m)
    if net.topology == TOPO_RING:
        return ring(m)
    if net.topology == TOPO_TORUS:
        return torus(m)
    if net.topology == TOPO_ERDOS_RENYI:
        return erdos_renyi(key, m, net.er_p)
    if net.topology != TOPO_GEOMETRIC:
        raise KeyError(
            f"unknown topology {net.topology!r} — NetworkConfig validates "
            f"membership, so this overlay builder is out of sync with "
            f"repro_torch.config.TOPOLOGIES")
    mobile = net.redraw_every > 0 and t is not None
    if mobile:
        key = prng.fold_in(key, t // net.redraw_every, device="cpu")
    return random_geometric(key, m, net.geo_radius, fused=mobile)


def is_mobile(net: NetworkConfig) -> bool:
    """True when the adjacency changes over rounds."""
    return net.topology == TOPO_GEOMETRIC and net.redraw_every > 0
