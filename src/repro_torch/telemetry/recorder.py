"""Materializing round records from the engine's chunk fold — the
counterpart of ``repro.telemetry.recorder``.

``DecentralizedLearner`` hands over, once per chunk, the per-round host
series it already holds or fetches in the chunk's one device-to-host
transfer (losses and divergences; comm counts, link counts, masks and
network times are host values in the port), together with a snapshot
of the cumulative counters taken BEFORE the chunk was folded in.
``observe`` then rebuilds the per-round cumulative series as ``base +
cumsum`` — int64 for the byte/sync/message counters (exact) and float64
running sums for loss / net-time (the engine switches its own
accumulation to the same sequential float64 sums while a recorder is
attached, so the stream's last ``cum_*`` equals the live counters
bitwise). Everything here is numpy on the host.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.telemetry.record import (
    RoundRecord, chunk_record, meta_record,
)
from repro_torch.telemetry.sink import TelemetrySink

__all__ = ["RoundRecorder"]


def _ages(extra: Any) -> Any:
    """JSON-ready snapshot of trigger-carried state (e.g. staleness
    counters): arrays become lists, empty containers become None."""
    if extra is None:
        return None
    if isinstance(extra, dict):
        out = {k: _ages(v) for k, v in extra.items()}
        out = {k: v for k, v in out.items() if v is not None}
        return out or None
    arr = np.asarray(extra)
    if arr.size == 0:
        return None
    return arr.tolist()


class RoundRecorder:
    """Streams one ``meta`` record, then per chunk: n ``RoundRecord``s
    plus one ``chunk`` record, into a :class:`TelemetrySink`.

    ``link_payload_bytes`` / ``msg_bytes`` / ``tiers_m`` mirror the
    engine's pricing exactly: per-round link bytes are
    ``counts[..., 0] * payload + counts[..., 1] * msg_bytes`` in int64,
    and ``round_bytes`` uses the engine's c(f) accounting — the ledger
    row sum under a hierarchy, the scalar transfer formula flat."""

    def __init__(self, cfg, *, m: int, num_links: int, model_size: int,
                 model_bytes: int, msg_bytes: int,
                 link_payload_bytes: np.ndarray,
                 link_classes: Tuple[str, ...],
                 spec: Optional[Dict[str, Any]] = None,
                 tiers: Optional[Dict[str, Any]] = None,
                 resumed_rounds: int = 0):
        self.cfg = cfg
        self.m = m
        self.num_links = num_links
        self.model_bytes = int(model_bytes)
        self.msg_bytes = int(msg_bytes)
        self.link_payload_bytes = np.asarray(link_payload_bytes, np.int64)
        self.hierarchical = tiers is not None
        self._chunks = 0
        self.sink = TelemetrySink(cfg.path, ring=cfg.ring, append=cfg.append)
        self._meta_kw = dict(
            m=m, model_size=int(model_size), model_bytes=int(model_bytes),
            msg_bytes=int(msg_bytes), num_links=num_links,
            link_classes=tuple(link_classes), spec=spec, tiers=tiers)
        self.sink.write(meta_record(
            resumed_rounds=int(resumed_rounds), **self._meta_kw))
        self.sink.flush()

    # ------------------------------------------------------------------
    def resume(self, rounds: int) -> None:
        """Re-emit the meta record tagged with the restored round count —
        called when checkpointed counters are restored into the engine, so
        a resumed stream is self-describing about where it picks up."""
        self.sink.write(meta_record(resumed_rounds=int(rounds),
                                    **self._meta_kw))
        self.sink.flush()

    # ------------------------------------------------------------------
    def price(self, counts: np.ndarray) -> np.ndarray:
        """(..., L, 2) int64 [transfers, messages] -> (..., L) int64
        bytes — the engine's ledger pricing, verbatim."""
        c = counts.astype(np.int64)
        return (c[..., 0] * self.link_payload_bytes
                + c[..., 1] * self.msg_bytes)

    # ------------------------------------------------------------------
    def observe(self, per: Dict[str, Any], base: Dict[str, Any],
                extra: Any, n: int, wall_s: Optional[float] = None,
                compiled: Optional[bool] = None,
                recompiles: Optional[int] = None) -> None:
        """File one executed chunk.

        ``per``: the fold's per-round branch, host-side — ``loss`` (n,),
        ``divergence`` (n,), ``num_active`` (n,), ``net_time`` (n,),
        ``comm`` (dict of (n,)), ``link_counts`` (n, L, 2).
        ``base``: the cumulative counters BEFORE this chunk
        (``DecentralizedLearner.counters_snapshot()``). ``extra``: the
        chunk-end trigger-carried state snapshot (staleness ages)."""
        comm = per["comm"]
        messages = np.asarray(comm["messages"], np.int64)
        cohort = np.asarray(comm["model_up"], np.int64)
        syncs = np.asarray(comm["syncs"], np.int64)
        full_syncs = np.asarray(comm["full_syncs"], np.int64)
        model_down = np.asarray(comm["model_down"], np.int64)
        loss = np.asarray(per["loss"], np.float64)
        div = np.asarray(per["divergence"], np.float64)
        num_active = np.asarray(per["num_active"], np.int64)
        net_time = np.asarray(per["net_time"], np.float64)
        link_bytes = self.price(np.asarray(per["link_counts"]))   # (n, L)
        # state-carrying protocols only (async timeline / staleness):
        # per-round in-flight count and oldest sync-age counter
        inflight = (np.asarray(per["num_inflight"], np.int64)
                    if "num_inflight" in per else None)
        max_age = (np.asarray(per["max_age"], np.int64)
                   if "max_age" in per else None)
        # fault plane / robust protocols only: per-round fault and
        # quarantine counts (key membership mirrors the engine's static
        # gating, so fault-free streams carry no extra fields)
        faulty = (np.asarray(per["num_faulty"], np.int64)
                  if "num_faulty" in per else None)
        quar = (np.asarray(per["num_quarantined"], np.int64)
                if "num_quarantined" in per else None)
        rec = (np.asarray(per["num_recovered"], np.int64)
               if "num_recovered" in per else None)

        if self.hierarchical:
            round_bytes = link_bytes.sum(axis=1)
        else:
            round_bytes = ((cohort + model_down) * self.model_bytes
                           + messages * self.msg_bytes)

        # cumulative series: base + sequential running sums. float64
        # np.cumsum IS the sequential sum, so element [t] equals t+1
        # iterations of ``total += x`` — the arithmetic the engine's
        # counters use while a recorder is attached.
        cum_loss = float(base["cumulative_loss"]) + np.cumsum(loss)
        cum_net = float(base["network_time"]) + np.cumsum(net_time)
        cum_syncs = int(base["syncs"]) + np.cumsum(syncs)
        cum_bytes = int(base["cum_bytes"]) + np.cumsum(round_bytes)
        link_cum = (np.asarray(base["link_bytes_totals"], np.int64)
                    + np.cumsum(link_bytes, axis=0))
        base_round = int(base["rounds"])

        per_link = bool(getattr(self.cfg, "per_link", False))
        for t in range(n):
            lb = None
            uplink = None
            if per_link:
                lb = tuple(int(x) for x in link_bytes[t])
            if self.hierarchical:
                uplink = int(link_bytes[t, self.m:].sum())
            self.sink.write(RoundRecord(
                round=base_round + t + 1,
                loss=float(loss[t]), cum_loss=float(cum_loss[t]),
                divergence=float(div[t]),
                messages=int(messages[t]), cohort=int(cohort[t]),
                sync=int(syncs[t]), full_sync=int(full_syncs[t]),
                cum_syncs=int(cum_syncs[t]),
                num_active=int(num_active[t]),
                net_time=float(net_time[t]),
                cum_net_time=float(cum_net[t]),
                round_bytes=int(round_bytes[t]),
                cum_bytes=int(cum_bytes[t]),
                link_bytes=lb, uplink_bytes=uplink,
                inflight=None if inflight is None else int(inflight[t]),
                max_age=None if max_age is None else int(max_age[t]),
                num_faulty=None if faulty is None else int(faulty[t]),
                num_quarantined=None if quar is None else int(quar[t]),
                num_recovered=None if rec is None else int(rec[t]),
            ).to_dict())

        self._chunks += 1
        self.sink.write(chunk_record(
            chunk=self._chunks, rounds_end=base_round + n, n=n,
            link_bytes_cum=link_cum[-1], stale_age=_ages(extra),
            wall_s=wall_s, compiled=compiled, recompiles=recompiles))
        self.sink.flush()

    # ------------------------------------------------------------------
    def flush(self) -> None:
        self.sink.flush()

    def close(self) -> None:
        self.sink.close()

    def __enter__(self) -> "RoundRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
