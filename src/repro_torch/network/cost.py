"""Link-cost model: bandwidth/latency classes → simulated wall-clock — the
counterpart of ``repro.network.cost``.

Units: bandwidth in bytes/second, latency in seconds. Each learner owns
one link, its class taken round-robin over the learner index from
``NetworkConfig.link_classes``. Within a round every participating link
transfers concurrently, so the round's network time is the slowest
link's ``transfers_i * (latency_i + model_bytes / bandwidth_i)``, plus
one control-plane round trip over the slowest link that sent a message.

The profiles are host f32 numpy arrays and ``round_network_time`` runs
on the host in f32, operation for operation as the reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.config import LINK_CLASS_NAMES, NetworkConfig


class LinkClass(NamedTuple):
    bandwidth: float     # bytes / second
    latency: float       # seconds (one-way)


LINK_CLASSES = {
    "wired": LinkClass(bandwidth=125e6, latency=0.001),   # 1 Gb/s LAN
    "wifi":  LinkClass(bandwidth=25e6,  latency=0.005),
    "lte":   LinkClass(bandwidth=5e6,   latency=0.05),
    "edge":  LinkClass(bandwidth=125e3, latency=0.2),     # 2G fallback
}

# configs validate names against repro_torch.config.LINK_CLASS_NAMES;
# keep the two registries in lockstep
if set(LINK_CLASSES) != set(LINK_CLASS_NAMES):
    raise RuntimeError(
        f"link-class registries out of lockstep: cost model prices "
        f"{sorted(LINK_CLASSES)}, configs validate against "
        f"{sorted(LINK_CLASS_NAMES)}")


def link_profile(net: NetworkConfig,
                 m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-learner ``(bandwidth, latency)`` float32 arrays."""
    unknown = [c for c in net.link_classes if c not in LINK_CLASSES]
    if unknown:
        raise KeyError(
            f"unknown link class(es) {unknown}; known: {sorted(LINK_CLASSES)}")
    classes = [LINK_CLASSES[net.link_classes[i % len(net.link_classes)]]
               for i in range(m)]
    return (np.asarray([c.bandwidth for c in classes], np.float32),
            np.asarray([c.latency for c in classes], np.float32))


def uniform_profile(link_class: str,
                    n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bandwidth, latency) arrays for ``n`` links of one class (a
    hierarchy's aggregator uplinks)."""
    if link_class not in LINK_CLASSES:
        raise KeyError(
            f"unknown link class {link_class!r}; known: {sorted(LINK_CLASSES)}")
    c = LINK_CLASSES[link_class]
    return (np.full((n,), c.bandwidth, np.float32),
            np.full((n,), c.latency, np.float32))


def round_network_time(xfers, link_msgs, model_bytes: int, bw,
                       lat) -> np.ndarray:
    """Simulated f32 seconds one round spends on the network.

    ``xfers``/``link_msgs``: ``(..., m)`` int counts of models crossing
    each link and control messages each link sent; ``bw``/``lat``:
    ``link_profile`` arrays. Leading axes are rounds, so a chunk's
    per-round times come from one call. A round with no transfers and no
    messages contributes exactly 0."""
    xfers = np.asarray(xfers)
    per_link = xfers.astype(np.float32) * (lat + np.float32(model_bytes)
                                           / bw)
    t_models = np.max(per_link, axis=-1, initial=np.float32(0.0))
    slowest_msg = np.max(np.where(np.asarray(link_msgs) > 0, lat,
                                  np.float32(0.0)),
                         axis=-1, initial=np.float32(0.0))
    return t_models + np.float32(2.0) * slowest_msg
