"""The preset table: the paper's sigmas as ``ProtocolSpec`` compositions —
the counterpart of ``repro.core.sync.kernel``.

  * ``nosync``      — trigger=never (identity)
  * ``periodic``    — sigma_b: cadence -> all-reachable -> mean -> average
  * ``continuous``  — sigma_b with b=1, same composition
  * ``fedavg``      — cadence -> random C-fraction -> mean -> subset
                      commit (McMahan et al.)
  * ``dynamic``     — sigma_Delta: divergence -> balancing augmentation ->
                      mean -> balancing commit (Algorithm 1 / Algorithm 2)
  * ``gossip``      — cadence -> neighborhood -> M–H mix -> mix
                      (coordinator-free, over the network topology)
  * ``stale``       — bounded staleness (``staleness.py``)
  * ``aircomp``, ``async_periodic``, ``async_dynamic`` — the event-driven
                      timeline and over-the-air aggregation
                      (``async_sync.py``)
  * ``robust_periodic``, ``robust_dynamic`` — Byzantine-robust sync:
                      trimmed mean and quarantine (``robust.py``)

``apply_staged`` runs one round on the ``(m, P)`` plane (coordinator
commits in place) and returns the full ``StageResult``; its
``link_msgs`` sum to ``CommRecord.messages``. ``active`` is the round's
(m,) availability mask (None: the ideal always-on network, the
pre-network expressions bit for bit) and ``adjacency`` the (m, m) peer
overlay a ``uses_overlay`` spec (gossip) needs.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.sync import stages  # noqa: F401  (registers stages)
from repro_torch.core.sync.registry import (  # noqa: F401
    PROTOCOLS, CommRecord, StageResult, SyncState, register_protocol,
)
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec


def init_state(ref_row: torch.Tensor, seed: int = 0, spec=None,
               m=None) -> SyncState:
    """Fresh carried state around the (P,) reference row, with the host
    key ``prng.key(seed)`` (the reference's ``PRNGKey(seed)``). ``spec``
    and ``m`` build the spec's extra carried state (the staleness
    counters); the other presets carry none."""
    extra = {}
    if spec is not None and spec.extra_state:
        if m is None:
            raise ValueError(
                f"spec {spec.name or spec.trigger!r} carries extra state "
                f"{spec.extra_state} — init_state needs the fleet size m")
        extra = spec.init_extra(m)
    return SyncState(ref=ref_row.clone(), v=0, step=0,
                     key=prng.key(seed, device="cpu"), extra=extra)


register_protocol("nosync", ProtocolSpec(name="nosync", trigger="never"))
register_protocol("periodic", ProtocolSpec(name="periodic",
                                           trigger="cadence"))
register_protocol("continuous", ProtocolSpec(name="continuous",
                                             trigger="cadence"))
register_protocol("fedavg", ProtocolSpec(name="fedavg", trigger="cadence",
                                         cohort="fraction",
                                         commit="subset"))
register_protocol("dynamic", ProtocolSpec(name="dynamic",
                                          trigger="divergence",
                                          cohort="balanced",
                                          commit="balancing"))
register_protocol("gossip", ProtocolSpec(name="gossip", trigger="cadence",
                                         cohort="neighborhood",
                                         aggregate="mix", commit="mix"))


def apply_staged(proto, X: torch.Tensor, state: SyncState,
                 weights=None, active=None, adjacency=None,
                 leaf_sizes=None) -> StageResult:
    """Run one round of the configured protocol (a ``ProtocolConfig`` or a
    ``ProtocolSpec``) on the (m, P) plane ``X``, which coordinator
    commits update in place. ``weights`` (the B^i) are dropped unless the
    spec says ``weighted``; ``leaf_sizes`` (the model's leaves in plane
    order) feed the tree layout's per-leaf aircomp noise."""
    spec = resolve_spec(proto)
    if not spec.param("weighted"):
        weights = None
    return spec.compile()(X, state, weights, active=active,
                          adjacency=adjacency, leaf_sizes=leaf_sizes)


from repro_torch.core.sync import staleness  # noqa: E402,F401  ("stale")
from repro_torch.core.sync import async_sync  # noqa: E402,F401  (presets)
from repro_torch.core.sync import robust  # noqa: E402,F401  (robust presets)
