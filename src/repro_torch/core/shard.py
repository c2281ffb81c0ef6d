"""The row-sharded fleet plane: ``layout="sharded"`` across
``torch.distributed`` processes — the counterpart of
``repro.core.shard``.

The reference splits the ``(m, P)`` plane's learner axis over a device
mesh and lets GSPMD place the collectives. Here each process (a *rank*
of the fleet's process group) holds a contiguous block of
``m / n_devices`` learner rows — its rows of the parameter, gradient and
optimizer planes and its learners' batches — and runs the local step on
them. The round's host decisions (the trigger vote, the cohort, the
commit's accounting, the PRNG draws) are replicated: every rank makes
them from the same host values, so the comm counters and the int64
per-link ledger are identical on every rank. Only these cross ranks:

* **the trigger's distances** — ``sqdist_rows`` on the local block, then
  an ``all_gather`` of the ``(m/n,)`` distances (``gather_rows``);
* **row sums** — the cohort mean and the balancing augmentation's
  running sum: each rank sums its weighted rows in row order, an
  ``all_gather`` brings the ``(n, P)`` partials, and every rank adds
  them in rank order (``row_sum``): bit-identical on every rank and from
  run to run. No float ``all_reduce``, whose order the backend picks;
* **rows of other learners** — the augmentation's next row
  (``plane_row``, a broadcast from its owner), and the whole plane for
  the stages that read every learner's row: gossip's ``W @ X``
  (``mix``) and the robust aggregates' per-coordinate sort
  (``gather_plane``);
* **the losses**, gathered once per chunk.

``COLLECTIVE_BYTES`` counts the bytes each rank receives, by
collective.

The stages read the active fleet through ``use_fleet`` /
``current_fleet``, as the reference's do; with no fleet active, or a
fleet of one rank, every helper here is the flat expression itself, so
a world-1 sharded run is the flat run bit for bit. The reference's
``constrain_fleet`` and ``constrain_rows`` (GSPMD sharding constraints)
have no PyTorch meaning and are left out: a rank's planes ARE its rows.

**The contract of a split fleet.** Over n > 1 ranks:

* the ranks agree: every rank holds the same counters, ledger, host
  state and plane;
* a repeated run is the same bit for bit;
* every integer that no float decides is the flat run's: a cadence
  trigger's comm and ledger, fedavg's cohorts, the fault schedule's
  per-round counts and a cadence trigger's in-flight timeline;
* the plane is within 1% of the flat plane's norm (``chip_smoke.py``'s
  ``SHARD_GROSS_REL``), NaN and ±Inf counted as one class;
* a distance trigger's decisions (the Δ trigger's cohorts, the
  quarantine, ``events_divergence``'s launches) may differ from the
  flat run's: a rank's local step is a smaller cuDNN call, and cuDNN
  picks a convolution's algorithm by the call's shape. For mnist_cnn on
  an H100 the second convolution's forward runs as an FFT convolution
  over 100 learners and as an implicit GEMM over 50 or 25; each is
  within 6e-7 of float64 (relative to its largest entry), but the
  learners' gradients from the two differ by up to 2.1e-4, in that
  convolution's bias gradient. The mean, too, adds the ranks' partial
  sums in rank order, not in one matvec. Training grows such a
  difference (at tests/test_shard.py's fixture a 6e-8 parameter
  difference moves a learner's gradient by 0.053 at a ReLU kink, on the
  CPU) until a distance falls on the other side of Δ;
* one rank is the flat run bit for bit.

On the CPU, where a smaller call gives the same gradient bits, a split
fleet also meets the reference's shard tolerance (tests/test_shard.py:79:
integers exact, parameters within rtol 2e-4 / atol 1e-6), which
tests/test_torch_shard.py and tests/test_torch_shard_planes.py hold on
the reference's fixture. ``tests/test_torch_cuda.py::
test_gradient_depends_on_the_call_size`` measures the card's call-size
dependence at mnist_cnn's width, with the kernels each call size runs.

``fleet_sharding(m, devices)`` builds the fleet over the initialized
process group (``0``: every rank; ``k``: the first k, through
``dist.new_group``), with the reference's errors; with no process group
the fleet is one rank. ``put_fleet`` / ``put_replicated`` /
``put_sync_state`` place a full (m, ...) state onto a rank. The carried
``SyncState.extra`` arrays are host control state (staleness ages,
health counters, O(m) integers) that every rank's replicated vote
reads, so they stay whole on every rank.

``launch(fn, world, *args)`` runs ``fn(*args)`` on ``world`` spawned
ranks (``init_method="file://"`` in a fresh temporary directory): gloo
on the CPU, NCCL on the card for one rank, and gloo over CUDA tensors
for several ranks sharing one card (NCCL refuses two ranks on one GPU).
Gloo moves CUDA tensors through the host here. A rank that raises fails
the launch.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import threading
from collections import Counter
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.divergence import per_learner_sq_distance_flat
from repro_torch.device import host_to_device, resolve_device

class FleetSharding(NamedTuple):
    """One fleet's row partition: the process group (None for a fleet of
    one rank), the learner count, the number of ranks and this process's
    index among them."""
    group: Any
    m: int
    n_devices: int
    rank: int = 0

    @property
    def rows_per_device(self) -> int:
        return self.m // self.n_devices

    @property
    def lo(self) -> int:
        return self.rank * self.rows_per_device

    @property
    def hi(self) -> int:
        return self.lo + self.rows_per_device

    @property
    def rows(self) -> slice:
        """This rank's learner rows of the (m, ...) fleet."""
        return slice(self.lo, self.hi)


def fleet_sharding(m: int, devices: int = 0) -> FleetSharding:
    """The fleet over the first ``devices`` ranks of the initialized
    process group (``0`` = all of them; one rank when no group is
    initialized). ``m`` must divide evenly: learner rows never straddle
    ranks. Every rank of the group must call this (``dist.new_group``
    is collective); a rank outside the first ``devices`` raises."""
    grouped = dist.is_available() and dist.is_initialized()
    avail = dist.get_world_size() if grouped else 1
    n = avail if devices in (0, None) else int(devices)
    if n < 1 or n > avail:
        raise ValueError(
            f"shard_devices={devices} but {avail} device(s) are "
            f"visible — pass 0 (all) or 1..{avail}")
    if m % n != 0:
        raise ValueError(
            f"layout='sharded' needs m % n_devices == 0 so every device "
            f"owns the same number of learner rows; got m={m}, "
            f"n_devices={n} (remainder {m % n}). Pad the fleet or set "
            f"shard_devices to a divisor of m.")
    if not grouped:
        return FleetSharding(group=None, m=m, n_devices=1, rank=0)
    group = (dist.group.WORLD if n == avail
             else dist.new_group(list(range(n))))
    rank = dist.get_rank()
    if rank >= n:
        raise ValueError(
            f"rank {rank} is outside the fleet's {n} ranks "
            f"(shard_devices={devices})")
    return FleetSharding(group=group, m=m, n_devices=n, rank=rank)


# ---------------------------------------------------------------------------
# the active-fleet context (the stages read it)
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


def current_fleet() -> Optional[FleetSharding]:
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_fleet(fleet: Optional[FleetSharding]):
    """Make ``fleet`` the one the stages see; ``None`` shields a block
    (a hierarchy's per-cluster rounds, which run on whole local
    clusters) from an enclosing fleet."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append(fleet)
    try:
        yield fleet
    finally:
        stack.pop()


def _split() -> Optional[FleetSharding]:
    """The active fleet when it spans more than one rank, else None."""
    fleet = current_fleet()
    return fleet if fleet is not None and fleet.n_devices > 1 else None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# the bytes this rank received, by collective (every rank's counts of a
# replicated round are equal); the tensor collectives only — the host
# objects of a hierarchy's gather are not counted
COLLECTIVE_BYTES: Counter = Counter()


def _global_rank(fleet: FleetSharding, i: int) -> int:
    return i if fleet.group is dist.group.WORLD else \
        dist.get_global_rank(fleet.group, i)


def _wire(fleet: FleetSharding, t: torch.Tensor) -> torch.Tensor:
    """The tensor as the backend moves it: gloo takes CUDA tensors
    through the host."""
    if t.is_cuda and dist.get_backend(fleet.group) == "gloo":
        return t.cpu()
    return t.contiguous()


def all_gather(fleet: FleetSharding, t: torch.Tensor,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in rank order."""
    x = _wire(fleet, t)
    parts = [torch.empty_like(x) for _ in range(fleet.n_devices)]
    dist.all_gather(parts, x, group=fleet.group)
    COLLECTIVE_BYTES["all_gather"] += (fleet.n_devices - 1) * _nbytes(x)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast(fleet: FleetSharding, t: torch.Tensor, owner: int):
    """Rank ``owner``'s ``t`` on every rank (``t`` is the receive buffer
    elsewhere)."""
    x = _wire(fleet, t)
    dist.broadcast(x, src=_global_rank(fleet, owner), group=fleet.group)
    if owner != fleet.rank:
        COLLECTIVE_BYTES["broadcast"] += _nbytes(x)
    return x.to(t.device)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# plane operations: the flat expression without a split fleet
# ---------------------------------------------------------------------------

def fleet_m(X: torch.Tensor) -> int:
    """The fleet size of a plane: its rows, or the split fleet's m."""
    fleet = _split()
    return X.shape[0] if fleet is None else fleet.m


def local(x):
    """This rank's rows of an (m, ...) host array or tensor."""
    fleet = _split()
    return x if fleet is None else x[fleet.rows]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """A per-learner (m/n, ...) tensor of this rank's rows -> the
    fleet's (m, ...), every rank's rows in rank order."""
    fleet = _split()
    return t if fleet is None else all_gather(fleet, t)


def row_dists_device(X: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(m,) f32 distances ``||f_i - r||^2`` on the device: one
    ``sqdist_rows`` pass on the local block, gathered."""
    return gather_rows(per_learner_sq_distance_flat(X, ref))


def row_sum(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w @ X`` for the (m,) weights ``w``: flat, one matvec; split, each
    rank's matvec over its rows, the (n, P) partials gathered and added
    in rank order."""
    fleet = _split()
    if fleet is None:
        return w @ X
    parts = all_gather(fleet, (w[fleet.rows] @ X)[None])
    total = parts[0]
    for i in range(1, parts.shape[0]):
        total = total + parts[i]
    return total


def row_mean(X: torch.Tensor) -> torch.Tensor:
    """The plain mean of the fleet's rows."""
    fleet = _split()
    if fleet is None:
        return torch.mean(X, dim=0)
    ones = torch.ones((fleet.m,), dtype=X.dtype, device=X.device)
    return row_sum(X, ones) / fleet.m


def plane_row(X: torch.Tensor, i: int) -> torch.Tensor:
    """Learner ``i``'s (P,) row; split, a broadcast from its owner."""
    fleet = _split()
    if fleet is None:
        return X[i]
    owner, r = divmod(int(i), fleet.rows_per_device)
    buf = (X[r].clone() if owner == fleet.rank
           else torch.empty_like(X[0]))
    return broadcast(fleet, buf, owner)


def plane_rows(X: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """The learners ``rows``' rows, (len(rows), P)."""
    if _split() is None:
        return X[torch.from_numpy(np.asarray(rows)).to(X.device)]
    return torch.stack([plane_row(X, int(i)) for i in rows])


def gather_plane(X: torch.Tensor) -> torch.Tensor:
    """The whole (m, P) plane (split: an ``all_gather`` of the blocks)."""
    fleet = _split()
    return X if fleet is None else all_gather(fleet, X)


def mix(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Gossip's ``W @ X``: each rank's rows of the product, from the
    whole plane."""
    fleet = _split()
    if fleet is None:
        return W @ X
    return W[fleet.rows] @ gather_plane(X)


def select_rows(X: torch.Tensor, mask: np.ndarray,
                row: torch.Tensor) -> torch.Tensor:
    """The learners in the (m,) host ``mask`` adopt ``row``, in place on
    this rank's rows."""
    mask = local(mask)
    if mask.all():
        X.copy_(row.expand_as(X))
    elif mask.any():
        X[host_to_device(np.flatnonzero(mask), X.device)] = row
    return X


# ---------------------------------------------------------------------------
# placement: a full (m, ...) state onto this rank
# ---------------------------------------------------------------------------

def put_fleet(fleet: FleetSharding, tree, axis: int = 0):
    """This rank's rows of every learner-stacked leaf (dimension ``axis``
    the fleet size) of a dict / tuple / NamedTuple tree; other leaves
    pass through whole."""
    if isinstance(tree, dict):
        return {k: put_fleet(fleet, v, axis) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [put_fleet(fleet, v, axis) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    if isinstance(tree, list):
        return [put_fleet(fleet, v, axis) for v in tree]
    shape = getattr(tree, "shape", ())
    if len(shape) > axis and shape[axis] == fleet.m:
        idx = (slice(None),) * axis + (fleet.rows,)
        return tree[idx]
    return tree


def put_replicated(fleet: FleetSharding, tree, device):
    """Every tensor leaf of a dict / tuple tree whole on this rank, on
    ``device``: the reference rows."""
    if isinstance(tree, dict):
        return {k: put_replicated(fleet, v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [put_replicated(fleet, v, device) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return tree.to(device) if torch.is_tensor(tree) else tree


def put_sync_state(fleet: FleetSharding, state, device):
    """A ``SyncState`` on this rank: the reference row(s) whole on
    ``device``; ``v``, the host key, ``step`` and the carried extra
    arrays, host values every rank's vote reads, whole."""
    return state._replace(ref=put_replicated(fleet, state.ref, device))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def default_backend(world: int, device: str) -> str:
    """NCCL for one rank on the card; gloo otherwise (the CPU, or
    several ranks sharing one card)."""
    return "nccl" if device == "cuda" and world == 1 else "gloo"


def _rank_main(rank: int, fn, world: int, init_file: str, backend: str,
               device: str, args, out_dir: str) -> None:
    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // world)))
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn: Callable, world: int, *args, device="cuda",
           backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one process group
    and return their results in rank order. ``fn`` and ``args`` must
    pickle (``fn`` a module-level function); ``device`` names where the
    ranks compute (``"cuda"``, the default: all on card 0, which must be
    there; ``"cpu"``). A rank that raises fails the launch; nothing is
    retried on another backend."""
    import torch.multiprocessing as mp

    device = resolve_device(device).type
    backend = backend or default_backend(world, device)
    work = tempfile.mkdtemp(prefix="repro_torch_launch_")
    try:
        mp.start_processes(
            _rank_main, nprocs=world, join=True, start_method="spawn",
            args=(fn, world, os.path.join(work, "init"), backend, device,
                  args, work))
        results = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)
