"""The fault-injection plane, pure in ``(fault_seed, t)`` — the
counterpart of ``repro.network.faults``.

Every mask is a pure function of the ``FaultConfig`` seed and the round
counter, derived by folding ``t`` (or the episode window ``t // window``)
into a key of ``repro_torch.prng``, jax's threefry stream bit for bit, so
any round's schedule can be drawn on its own, out of order. Four fault
kinds (see ``FaultConfig``):

* **crash episodes** — ``crash_mask``: within each ``crash_every``-round
  window a learner crashes with probability ``crash_prob`` at a sampled
  offset for a sampled duration. A crashed learner is forced out of the
  availability mask (``compose_active``) and its local step is discarded
  (the engine restores its rows). ``restart_mask`` marks the rejoin round
  (crashed last round, up this round), where the engine zeroes its rows
  of the parameter plane, the optimizer planes and the learner-indexed
  sync state (``lose_state``): it comes back COLD.
* **payload corruption** — ``corrupt_mask`` + ``perturb_params``: a
  corrupted learner's row goes NaN (odd rounds) or Inf (even rounds).
* **Byzantine adversaries** — ``byzantine_mask`` (a fixed subset drawn
  once from the seed) + ``perturb_params``: sign-flipped or scaled rows,
  every round.
* **straggler bursts** — ``straggler_burst_mask``: whole windows where a
  random fraction of the fleet goes dark, AND-composed with the
  availability mask (no state loss).

The masks are host numpy arrays, like the port's availability masks.
``sample_rounds`` draws a chunk's masks before its first round in one
batched call per fault kind (each distinct episode window once);
``crash_mask``, ``restart_mask``, ``straggler_burst_mask``,
``corrupt_mask`` and ``num_faulty`` give one round's, as the reference's
functions do. The row operations work on the ``(m, P)`` plane in place
and select rows (index writes), never compute on the untouched ones, so
those stay bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.config import FaultConfig

# per-fault-kind key-derivation constants (xor'd into the seed so the
# streams never collide with each other or with availability's
# 0xAC71/0x57AA/0x0F0F and aircomp's 0xA17C0)
_KEY_CRASH = 0xC4A5
_KEY_CRASH_AT = 0xC4A7
_KEY_CRASH_LEN = 0xC4A9
_KEY_CORRUPT = 0xC0DE
_KEY_BYZ = 0xB42A
_KEY_BURST = 0x5B57
_KEY_BURST_WHO = 0x5B59


def _win_keys(seed: int, const: int, windows: np.ndarray) -> torch.Tensor:
    """``fold_in(key(seed ^ const), w)`` for every window ``w``: (n, 2)."""
    return prng.fold_in(prng.key(seed ^ const, device="cpu"),
                        np.asarray(windows, np.int64), device="cpu")


def _below(u: torch.Tensor, p: float) -> np.ndarray:
    """``u < p`` with p rounded to f32, as jax compares a weakly typed
    Python float against f32 draws."""
    return u.numpy() < np.float32(p)


def _windowed(ts: np.ndarray, every: int):
    """(distinct windows, each round's index into them)."""
    return np.unique(ts // every, return_inverse=True)


# ---------------------------------------------------------------------------
# crash/restart episodes
# ---------------------------------------------------------------------------

def crash_rounds(cfg: FaultConfig, m: int, ts: Sequence[int]) -> np.ndarray:
    """(n, m) bool — learners mid-outage at the rounds ``ts``. Learner i
    crashes in window ``w = t // crash_every`` iff its window draw is
    below ``crash_prob``, starting at a uniform offset for a uniform
    ``outage_min..outage_max`` duration, cut at the window's edge."""
    ts = np.asarray(ts, np.int64).reshape(-1)
    if cfg.crash_prob <= 0.0:
        return np.zeros((ts.size, m), bool)
    windows, at = _windowed(ts, cfg.crash_every)
    crashing = _below(prng.uniform(
        _win_keys(cfg.fault_seed, _KEY_CRASH, windows), (m,),
        device="cpu"), cfg.crash_prob)
    start = prng.randint(_win_keys(cfg.fault_seed, _KEY_CRASH_AT, windows),
                         (m,), 0, cfg.crash_every, device="cpu").numpy()
    dur = prng.randint(_win_keys(cfg.fault_seed, _KEY_CRASH_LEN, windows),
                       (m,), cfg.outage_min, cfg.outage_max + 1,
                       device="cpu").numpy()
    phase = (ts % cfg.crash_every)[:, None]
    start, dur = start[at], dur[at]
    return crashing[at] & (phase >= start) & (phase < start + dur)


def restart_rounds(cfg: FaultConfig, m: int,
                   ts: Sequence[int]) -> np.ndarray:
    """(n, m) bool — learners rejoining at the rounds ``ts``: crashed
    during round ``t - 1``, up again at ``t`` (never at t = 0)."""
    ts = np.asarray(ts, np.int64).reshape(-1)
    if cfg.crash_prob <= 0.0:
        return np.zeros((ts.size, m), bool)
    both = crash_rounds(cfg, m, np.concatenate([np.maximum(ts - 1, 0), ts]))
    prev, now = both[:ts.size], both[ts.size:]
    return prev & ~now & (ts > 0)[:, None]


def crash_mask(cfg: FaultConfig, m: int, t: int) -> np.ndarray:
    """(m,) bool — learners mid-outage (crashed, stateless) at round t."""
    return crash_rounds(cfg, m, [t])[0]


def restart_mask(cfg: FaultConfig, m: int, t: int) -> np.ndarray:
    """(m,) bool — learners rejoining (cold) at round t."""
    return restart_rounds(cfg, m, [t])[0]


# ---------------------------------------------------------------------------
# straggler bursts
# ---------------------------------------------------------------------------

def burst_rounds(cfg: FaultConfig, m: int, ts: Sequence[int]) -> np.ndarray:
    """(n, m) bool — learners dark in a burst window. In window
    ``w = t // straggler_every`` a burst fires with probability
    ``straggler_prob``; during it each learner straggles with probability
    ``straggler_frac`` (drawn per window)."""
    ts = np.asarray(ts, np.int64).reshape(-1)
    if cfg.straggler_prob <= 0.0 or cfg.straggler_frac <= 0.0:
        return np.zeros((ts.size, m), bool)
    windows, at = _windowed(ts, cfg.straggler_every)
    burst = _below(prng.uniform(
        _win_keys(cfg.fault_seed, _KEY_BURST, windows), (), device="cpu"),
        cfg.straggler_prob)
    who = _below(prng.uniform(
        _win_keys(cfg.fault_seed, _KEY_BURST_WHO, windows), (m,),
        device="cpu"), cfg.straggler_frac)
    return burst[at][:, None] & who[at]


def straggler_burst_mask(cfg: FaultConfig, m: int, t: int) -> np.ndarray:
    """(m,) bool — learners dark for round t's burst window."""
    return burst_rounds(cfg, m, [t])[0]


def darkens(cfg: FaultConfig) -> bool:
    """Crashes or bursts can take learners out of the active mask."""
    return cfg.crash_prob > 0.0 or (cfg.straggler_prob > 0.0
                                    and cfg.straggler_frac > 0.0)


def compose_active(cfg: FaultConfig, active, m: int, t: int):
    """AND the fault plane into round t's availability mask: crashed and
    bursting learners are unreachable. The composition only removes
    learners. With crashes and bursts off the mask passes through
    untouched (``None`` stays ``None``), so an inert config keeps the
    engine on the ideal-network expressions."""
    if not darkens(cfg):
        return active
    down = crash_mask(cfg, m, t) | straggler_burst_mask(cfg, m, t)
    return ~down if active is None else active & ~down


# ---------------------------------------------------------------------------
# payload corruption + Byzantine adversaries
# ---------------------------------------------------------------------------

def corrupt_rounds(cfg: FaultConfig, m: int,
                   ts: Sequence[int]) -> np.ndarray:
    """(n, m) bool — learners whose parameters go non-finite at ``ts``."""
    ts = np.asarray(ts, np.int64).reshape(-1)
    if cfg.corrupt_prob <= 0.0:
        return np.zeros((ts.size, m), bool)
    keys = _win_keys(cfg.fault_seed, _KEY_CORRUPT, ts)
    return _below(prng.uniform(keys, (m,), device="cpu"), cfg.corrupt_prob)


def corrupt_mask(cfg: FaultConfig, m: int, t: int) -> np.ndarray:
    """(m,) bool — learners whose parameters go non-finite at round t."""
    return corrupt_rounds(cfg, m, [t])[0]


def byzantine_mask(cfg: FaultConfig, m: int) -> np.ndarray:
    """(m,) bool — the FIXED adversary subset, drawn once from the seed:
    the first ``round(byzantine_frac * m)`` of a permutation."""
    n_adv = int(round(cfg.byzantine_frac * m))
    mask = np.zeros((m,), bool)
    if n_adv == 0:
        return mask
    perm = prng.permutation(prng.key(cfg.fault_seed ^ _KEY_BYZ,
                                     device="cpu"), m, device="cpu")
    mask[perm[:n_adv].numpy()] = True
    return mask


# ---------------------------------------------------------------------------
# a chunk's schedule, drawn at once
# ---------------------------------------------------------------------------

class FaultSchedule(NamedTuple):
    """A chunk's fault masks, (n, m) bool each (``byzantine`` (m,))."""
    crashed: np.ndarray
    restart: np.ndarray
    burst: np.ndarray
    corrupt: np.ndarray
    byzantine: np.ndarray

    def down(self) -> np.ndarray:
        """(n, m) — learners the fault plane takes off the network."""
        return self.crashed | self.burst

    def num_faulty(self) -> np.ndarray:
        """(n,) int32 — learners under any fault each round."""
        return (self.crashed | self.restart | self.burst | self.corrupt
                | self.byzantine[None]).sum(axis=1).astype(np.int32)


def sample_rounds(cfg: FaultConfig, m: int,
                  ts: Sequence[int]) -> FaultSchedule:
    """The masks of the rounds ``ts``, one batched draw per fault kind."""
    ts = np.asarray(ts, np.int64).reshape(-1)
    return FaultSchedule(
        crashed=crash_rounds(cfg, m, ts), restart=restart_rounds(cfg, m, ts),
        burst=burst_rounds(cfg, m, ts), corrupt=corrupt_rounds(cfg, m, ts),
        byzantine=byzantine_mask(cfg, m))


def num_faulty(cfg: FaultConfig, m: int, t: int) -> int:
    """Learners under ANY fault at round t (crashed, restarting,
    bursting, corrupted, or Byzantine)."""
    return int(sample_rounds(cfg, m, [t]).num_faulty()[0])


# ---------------------------------------------------------------------------
# row operations on the plane
# ---------------------------------------------------------------------------

def _rows(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.flatnonzero(mask)).to(like.device)


def perturb_params(cfg: FaultConfig, X: torch.Tensor, t: int,
                   byzantine: np.ndarray, corrupt: np.ndarray) -> None:
    """Corrupt and Byzantine-perturb the (m, P) plane in place at round
    t: adversary rows negated (``sign_flip``) or multiplied by
    ``byzantine_scale`` rounded to the plane's dtype (one multiply in
    that dtype, as the reference's), then corrupted rows overwritten
    with NaN (odd t) or Inf (even t). Other rows are not written."""
    if byzantine.any():
        idx = _rows(byzantine, X)
        if cfg.byzantine_mode == "sign_flip":
            X[idx] = -X[idx]
        else:
            scale = torch.tensor(cfg.byzantine_scale, dtype=X.dtype,
                                 device=X.device)
            X[idx] = scale * X[idx]
    if corrupt.any():
        X[_rows(corrupt, X)] = float("nan") if t % 2 == 1 else float("inf")


def keep_rows(rows: np.ndarray, *planes):
    """Copies of the marked rows of each plane (None passes through):
    what ``freeze_state`` puts back after the local step."""
    idx = None
    saved = []
    for x in planes:
        if x is None:
            saved.append(None)
            continue
        if idx is None:
            idx = _rows(rows, x)
        saved.append(x[idx].clone())
    return idx, saved


def freeze_state(idx: torch.Tensor, saved, *planes) -> None:
    """Discard the update of the crashed rows: each plane gets back the
    rows ``keep_rows`` copied before the step (a crashed learner does
    not train)."""
    for x, old in zip(planes, saved):
        if x is not None:
            x[idx] = old


def lose_state(tree, rows: np.ndarray, m: int):
    """Zero the learner rows of every learner-indexed leaf (leading dim
    ``m``): the restart state loss. Tensors (the parameter and optimizer
    planes) are zeroed in place; host arrays (the carried sync state)
    come back as new arrays; leaves without a leading fleet axis, and
    other values, pass through. Dicts and tuples are walked."""
    if isinstance(tree, dict):
        return {k: lose_state(v, rows, m) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(lose_state(v, rows, m) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.dim() >= 1 and tree.shape[0] == m:
            tree[_rows(rows, tree)] = 0
        return tree
    if isinstance(tree, np.ndarray) and tree.ndim >= 1 and \
            tree.shape[0] == m:
        out = tree.copy()
        out[rows] = 0
        return out
    return tree
