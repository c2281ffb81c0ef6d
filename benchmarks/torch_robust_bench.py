"""Byzantine-robust aggregation under injected faults — the twin of
``benchmarks/robust_bench.py`` on ``repro_torch``.

Sweeps the adversary fraction of a sign-flipping fleet (0, 0.1, 0.2 of
m = 10) across three aggregation defenses — plain ``mean`` (the dynamic
preset), the ``trimmed_mean`` pipeline (``robust_dynamic``) and the
``median`` pipeline (the same robust trigger and quarantine commit,
maximal trim) — on one synthetic linear regression (8 weights, 48
samples a learner a round, label noise 0.15, drawn by
``repro_torch.prng`` from seed 0), each at b = 1 and Delta = 0.05, and
scores each run by the mean per-round loss of the honest learners over
the last quarter of training; 64 rounds quick, 240 full.

Three claims ride in ``check``:

* at 20% sign-flippers the robust pipelines land within 10% of the
  fault-free loss;
* the same adversaries drag plain ``mean`` past 2x the fault-free loss;
* ``faults=None`` and an inert ``FaultConfig()`` are identical bit for
  bit through the robust pipeline (comm, ledger, simulated time and the
  parameter bytes): both are the port's own runs.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from benchmarks.torch_common import save_rows
from repro_torch import prng
from repro_torch.config import FaultConfig, TrainConfig
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.core.sync import PROTOCOLS, ProtocolSpec
from repro_torch.device import resolve_device
from repro_torch.network import faults as nf

NAME = "robust_bench"
PAPER_REF = ("ISSUE 10 tentpole (fault-injection plane + "
             "Byzantine-robust aggregation)")

M = 10
DIM = 8
SAMPLES = 48

# one divergence-triggered composition per defense, all at b = 1 so the
# gate is checked every round, and a Delta low enough that the fleet
# resynchronizes while it converges
_DYN = dict(b=1, delta=0.05)
DEFENSES = (
    ("mean", PROTOCOLS["dynamic"].with_params(**_DYN)),
    ("trimmed_mean", PROTOCOLS["robust_dynamic"].with_params(**_DYN)),
    ("median", ProtocolSpec(
        name="robust_median", trigger="robust_divergence",
        cohort="all_reachable", aggregate="median",
        commit="quarantine").with_params(**_DYN)),
)
FRACS = (0.0, 0.1, 0.2)

ARCH = None
# the cut rows that tests/test_torch_bench_cuts.py and chip_smoke.py's
# twins phase run through cut(): ({"defense"}, m, rounds,
# {"adv_frac"})
CUT = ((dict(defense="trimmed_mean"), M, 16, dict(adv_frac=0.2)),
       (dict(defense="mean"), M, 16, dict(adv_frac=0.2)))


class RegressionSource:
    """The fleet's regression batches ``{"x": (n, m, 48, 8), "y": (n, m,
    48)}``, drawn by ``repro_torch.prng`` from ``seed`` on the CPU: y =
    0.5 * sum(x) + 0.15 * noise, which puts the loss floor near 2e-2.
    ``sample`` ignores its generator: a run draws its rounds at once."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.seed, self.device = seed, resolve_device(device)

    def sample(self, generator, batch: int, lead: tuple = ()):
        kx, ke = prng.split(prng.key(self.seed, device="cpu"), 2,
                            device="cpu")
        xs = prng.normal(kx, (*lead, batch, DIM), device="cpu")
        ys = (torch.sum(xs, dim=-1) * 0.5
              + 0.15 * prng.normal(ke, (*lead, batch), device="cpu"))
        return {"x": xs.to(self.device), "y": ys.to(self.device)}

    def force_drift(self):
        pass


def default_source(device="cuda"):
    return RegressionSource(0, device)


def _loss(p, batch):
    return torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)


def _init(generator):
    """The reference's initial weights: a normal draw from the first of
    ``split(key(0), 3)``, times 0.1 (the generator names the device)."""
    k_init = prng.split(prng.key(0, device="cpu"), 3, device="cpu")[0]
    return {"w": prng.normal(k_init, (DIM,), device=generator.device) * 0.1}


def cut_init():
    """The cut rows' initial model, as numpy."""
    return {"w": _init(torch.Generator())["w"].numpy()}


def _faults(frac):
    return (FaultConfig(fault_seed=11, byzantine_frac=frac,
                        byzantine_mode="sign_flip") if frac > 0 else None)


def _digest(dl) -> str:
    return hashlib.sha256(dl.X.cpu().numpy().tobytes()).hexdigest()


def _train(spec, rounds: int, faults=None, device="cuda", source=None,
           init_fn=None):
    src = default_source(device) if source is None else source
    dl = DecentralizedLearner(
        _loss, init_fn or _init, M, spec,
        train=TrainConfig(optimizer="sgd", learning_rate=0.05), seed=0,
        faults=faults, device=device)
    metrics = dl.run_chunk(src.sample(None, SAMPLES, lead=(rounds, M)))
    return dl, metrics


def _honest_tail_loss(metrics, faults, rounds: int) -> float:
    """Mean per-round loss of the honest learners over the last quarter
    of training (adversaries train on flipped models by design)."""
    losses = metrics.loss_per_learner.cpu().numpy()        # (rounds, m)
    honest = (~nf.byzantine_mask(faults, M) if faults
              else np.ones((M,), bool))
    return float(np.mean(losses[-(rounds // 4):, honest]))


def _quarantined(dname, metrics):
    return (int(np.asarray(metrics.num_quarantined).sum())
            if dname != "mean" else None)


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(learner, {"honest_tail_loss",
    "quarantined_total"})``."""
    kw, m, rounds, extra = case
    if m != M:
        raise ValueError(f"the bench's fleet is m = {M}, not {m}")
    spec = dict(DEFENSES)[kw["defense"]]
    faults = _faults(extra["adv_frac"])
    dl, metrics = _train(spec, rounds, faults, device, source, init_fn)
    return dl, {"honest_tail_loss": _honest_tail_loss(metrics, faults,
                                                      rounds),
                "quarantined_total": _quarantined(kw["defense"], metrics)}


def run(quick: bool = True, device="cuda"):
    rounds = 64 if quick else 240
    rows = []
    fault_free = None
    for frac in FRACS:
        faults = _faults(frac)
        for dname, spec in DEFENSES:
            dl, metrics = _train(spec, rounds, faults, device)
            loss = _honest_tail_loss(metrics, faults, rounds)
            if frac == 0.0 and dname == "mean":
                fault_free = loss
            rows.append({
                "defense": dname, "adv_frac": frac,
                "n_adv": int(round(frac * M)), "m": M, "rounds": rounds,
                "honest_tail_loss": round(loss, 6),
                "vs_fault_free": round(loss / fault_free, 3),
                "syncs": int(dl.comm_totals["syncs"]),
                "quarantined_total": _quarantined(dname, metrics),
            })
    rows.append(_fault_off_bitwise(rounds, device))
    save_rows(NAME, rows)
    return rows


def _fault_off_bitwise(rounds: int, device) -> dict:
    """faults=None against an inert FaultConfig() through the robust
    pipeline: every counter and every parameter byte must agree."""
    def fp(faults):
        dl, _ = _train(DEFENSES[1][1], rounds, faults, device)
        return (dict(dl.comm_totals),
                np.asarray(dl.link_bytes_totals).tolist(),
                float(dl.network_time), _digest(dl))
    return {"defense": "trimmed_mean", "adv_frac": None, "m": M,
            "rounds": rounds,
            "fault_off_bitwise": fp(None) == fp(FaultConfig())}


def check(rows) -> str:
    at = {(r["defense"], r["adv_frac"]): r for r in rows
          if r["adv_frac"] is not None}
    bitwise = next(r for r in rows if r["adv_frac"] is None)
    ok = (
        # 20% sign-flippers: the robust pipelines stay within 10% of
        # the fault-free loss...
        at[("trimmed_mean", 0.2)]["vs_fault_free"] <= 1.10
        and at[("median", 0.2)]["vs_fault_free"] <= 1.10
        # ...while the plain mean is dragged past 2x
        and at[("mean", 0.2)]["vs_fault_free"] >= 2.0
        # honest fleet: the defenses cost (essentially) nothing
        and at[("trimmed_mean", 0.0)]["vs_fault_free"] <= 1.10
        # the fault plane is a bitwise no-op when off
        and bitwise["fault_off_bitwise"])
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    rows = run()
    for r in rows:
        print(r)
    print(check(rows))
