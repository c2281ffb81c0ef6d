"""Discrete-event network timeline primitives — the counterpart of
``repro.network.events``.

The round-synchronous engine treats every sync as instantaneous. This
module turns each sync into a message in flight: a per-learner flight
time from the ``repro_torch.network.cost`` link classes, quantized
against a per-round time budget into ``k = ceil(round_trip / budget) - 1``
extra rounds in the air (an exchange that fits inside one budget lands
the round it was launched: the synchronous engine), and a bounded-delay
arrival ring carried in ``SyncState.extra`` that schedules the arrival.

Flight times are resolved from the protocol's scalar params (the
comma-joined link-class string follows the engine's round-robin link
profile); the ring is index arithmetic on the carried ``(m, depth)``
buffer. Departure from the reference: every value here is a host numpy
int32 array, as the port's other carried state is; ``flight_rounds`` is
cached per (classes, m, payload, budget) and returned read-only. The
event-driven triggers that use these are in
``repro_torch.core.sync.async_sync``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np

from repro_torch.network.cost import LINK_CLASSES


def parse_link_classes(csv: str) -> Tuple[str, ...]:
    """Parse the comma-joined link-class protocol param. ``""`` means an
    ideal network: every exchange lands inside the round it was
    launched."""
    if not csv:
        return ()
    names = tuple(s.strip() for s in csv.split(",") if s.strip())
    unknown = sorted(set(names) - set(LINK_CLASSES))
    if unknown:
        raise ValueError(
            f"unknown link class(es) {unknown} in {csv!r} — known: "
            f"{sorted(LINK_CLASSES)}")
    return names


def round_trip_time(name: str, payload_bytes: int) -> float:
    """Seconds for one sync exchange on a class link: the model up and
    the aggregate back down, ``2 * (latency + payload / bandwidth)``."""
    lc = LINK_CLASSES[name]
    return 2.0 * (lc.latency + float(payload_bytes) / lc.bandwidth)


def class_flight_rounds(csv: str, payload_bytes: int,
                        budget: float) -> Dict[str, int]:
    """Whole rounds each class's exchange spends in flight,
    ``k = max(0, ceil(round_trip / budget) - 1)``."""
    return {
        name: max(0, math.ceil(round_trip_time(name, payload_bytes)
                               / budget) - 1)
        for name in parse_link_classes(csv)
    }


def max_flight_rounds(csv: str, payload_bytes: int, budget: float) -> int:
    """The largest per-class flight time (bounds the ring depth)."""
    return max(class_flight_rounds(csv, payload_bytes, budget).values(),
               default=0)


@functools.lru_cache(maxsize=None)
def flight_rounds(csv: str, m: int, payload_bytes: int,
                  budget: float) -> np.ndarray:
    """(m,) int32 per-learner flight rounds, round-robin over the named
    classes — the learner-to-class map of ``cost.link_profile`` and the
    ledger's rows. Read-only (it is cached)."""
    names = parse_link_classes(csv)
    if not names:
        k = np.zeros((m,), np.int32)
    else:
        per_class = class_flight_rounds(csv, payload_bytes, budget)
        k = np.asarray([per_class[names[i % len(names)]]
                        for i in range(m)], np.int32)
    k.setflags(write=False)
    return k


def empty_ring(m: int, depth: int) -> np.ndarray:
    """(m, depth) int32 arrival buffer: slot ``t % depth`` of row i holds
    1 iff learner i's in-flight exchange lands at round t."""
    return np.zeros((m, depth), np.int32)


def due_mask(ring: np.ndarray, t: int) -> np.ndarray:
    """(m,) bool — whose exchange lands this round."""
    return ring[:, t % ring.shape[1]] > 0


def ring_step(ring: np.ndarray, t: int, launch: np.ndarray,
              k: np.ndarray) -> np.ndarray:
    """One timeline transition on a new buffer: consume round-t arrivals
    (clear the current slot) and schedule this round's launches ``k``
    rounds out. A learner launches only while idle and validation pins
    ``k < depth``, so a scheduled slot never collides with a pending
    one."""
    m, depth = ring.shape
    out = ring.copy()
    out[:, t % depth] = 0
    np.add.at(out, (np.arange(m), (t + np.asarray(k)) % depth),
              np.asarray(launch).astype(np.int32))
    return out
