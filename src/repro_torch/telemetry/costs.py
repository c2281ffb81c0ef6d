"""Per-stage cost attribution: a round's FLOPs × observed fires — the
counterpart of ``repro.telemetry.costs``.

The reference splits the jaxpr of one traced round at its sync
``lax.cond``. The port's round is host Python, so ``round_costs`` runs
one round of a ``ProtocolSpec`` on the contracts module's template (on
``meta`` tensors where the stages allow, else a tiny CPU plane) with
every slot metered (``contracts.meter_round``), and counts the first-order FLOPs of each part
(``repro_torch.analysis.roofline.WorkMode``'s rule: products by
``FlopCounterMode``'s formulas, reductions and other arithmetic one per
element, views and copies free):

* ``gate_flops`` — the trigger's gate, paid every round;
* ``skip_flops`` — a quiet round's carried state;
* ``sync_flops`` — the fired round's condition, cohort, aggregate and
  commit (the reference's sync branch).

``attribute`` joins these with a recorded run's observed fires
(``cum_syncs`` of the telemetry stream): estimated total = rounds ·
gate + (rounds − fires) · skip + fires · sync, the reference's
arithmetic. The shares differ from the reference's where the two
programs differ: the reference's jaxpr counts the gate's ``t % b`` and
its counters, masks and ledger as device arithmetic (12 FLOPs a round
on the gate of the cadence triggers, 8 on ``stale``'s skip); the port's
are host ints and numpy, which no dispatch mode sees, so those parts
count 0 here. The port counts its host PRNG draws (FedAvg's cohort), the
reference its own on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

__all__ = ["RoundCosts", "round_costs", "attribute"]


@dataclass(frozen=True)
class RoundCosts:
    """Per-round FLOP estimate of one ``ProtocolSpec``, split into the
    gate, a quiet round's skip and a fired round's sync."""
    spec: str
    gate_flops: float     # paid every round
    skip_flops: float     # a quiet round
    sync_flops: float     # a fired round

    def as_dict(self) -> Dict[str, Any]:
        return {"spec": self.spec, "gate_flops": self.gate_flops,
                "skip_flops": self.skip_flops,
                "sync_flops": self.sync_flops}


def round_costs(spec, template=None, m: int = 8) -> RoundCosts:
    """Meter one round of ``spec`` on ``template`` (a stacked model
    template, default the contracts module's mixed template of ``m``
    learners — pass a real architecture's for absolute numbers; the
    gate/skip/sync SHARES are what attribution uses)."""
    from repro_torch.analysis import contracts
    from repro_torch.analysis.roofline import WorkMode
    from repro_torch.core.sync.spec import resolve_spec
    spec = resolve_spec(spec)
    if template is None:
        template = contracts.mixed_template(m)
    if spec.trigger == "never":       # nosync: no part of a round runs
        return RoundCosts(spec.name, gate_flops=0.0, skip_flops=0.0,
                          sync_flops=0.0)

    parts = contracts.meter_round(spec, template, WorkMode)
    return RoundCosts(spec.name, gate_flops=parts["gate"],
                      skip_flops=parts["skip"], sync_flops=parts["sync"])


def attribute(costs: RoundCosts, rounds: int, fires: int,
              wall_s: Optional[float] = None) -> Dict[str, Any]:
    """Join per-round costs with a run's observed trigger fires: the
    estimated FLOP total and its gate/skip/sync split."""
    if rounds < 0 or fires < 0 or fires > rounds:
        raise ValueError(
            f"need 0 <= fires <= rounds, got fires={fires} "
            f"rounds={rounds}")
    gate = rounds * costs.gate_flops
    skip = (rounds - fires) * costs.skip_flops
    sync = fires * costs.sync_flops
    total = gate + skip + sync
    out = {
        "spec": costs.spec, "rounds": rounds, "fires": fires,
        "fire_rate": fires / rounds if rounds else 0.0,
        "gate_flops": gate, "skip_flops": skip, "sync_flops": sync,
        "est_total_flops": total,
        "sync_share": sync / total if total else 0.0,
        "per_round": costs.as_dict(),
    }
    if wall_s is not None:
        out["wall_s"] = wall_s
        if wall_s > 0:
            out["est_flops_per_s"] = total / wall_s
    return out
