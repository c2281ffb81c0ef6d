"""The preset table: the paper's sigmas as ``ProtocolSpec`` compositions —
the counterpart of ``repro.core.sync.kernel``.

  * ``nosync``      — trigger=never (identity)
  * ``periodic``    — sigma_b: cadence -> all-reachable -> mean -> average
  * ``continuous``  — sigma_b with b=1, same composition
  * ``fedavg``      — cadence -> random C-fraction -> mean -> subset
                      commit (McMahan et al.)
  * ``dynamic``     — sigma_Delta: divergence -> balancing augmentation ->
                      mean -> balancing commit (Algorithm 1 / Algorithm 2)

``gossip`` is not ported yet; asking for it raises
``NotImplementedError`` naming its ROADMAP item. ``apply_staged``
runs one round on the ``(m, P)`` plane (in place) and returns the full
``StageResult``; its ``link_msgs`` sum to ``CommRecord.messages``.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.sync import stages  # noqa: F401  (registers stages)
from repro_torch.core.sync.registry import (  # noqa: F401
    PROTOCOLS, CommRecord, StageResult, SyncState, register_protocol,
)
from repro_torch.core.sync.spec import ProtocolSpec, resolve_spec


def init_state(ref_row: torch.Tensor, seed: int = 0) -> SyncState:
    """Fresh carried state around the (P,) reference row, with the host
    key ``prng.key(seed)`` (the reference's ``PRNGKey(seed)``)."""
    return SyncState(ref=ref_row.clone(), v=0, step=0,
                     key=prng.key(seed, device="cpu"))


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


def apply_staged(proto, X: torch.Tensor, state: SyncState,
                 weights=None) -> StageResult:
    """Run one round of the configured protocol (a ``ProtocolConfig`` or a
    ``ProtocolSpec``) on the (m, P) plane ``X``, which commits update in
    place. ``weights`` (the B^i) are dropped unless the spec says
    ``weighted``."""
    spec = resolve_spec(proto)
    if not spec.param("weighted"):
        weights = None
    return spec.compile()(X, state, weights)
