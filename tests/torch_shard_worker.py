"""Rank workers for tests/test_torch_shard.py (not collected: the name
does not start with ``test_``). They import torch, numpy and the port
only — never jax — because ``repro_torch.core.shard.launch`` spawns
each rank as a fresh interpreter that imports this module.

Every case builds the port's engine on tests/test_shard.py's fixture
(the smoke drift MLP, m = 8, B = 10, sgd lr 0.05, the ring at 60%
availability over wifi and lte links) from the reference's initial
parameters and batches, which the test hands over as numpy arrays, and
returns host values: the counters, the ledger and the whole gathered
plane.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import io
from repro_torch.config import (
    FaultConfig, HierarchyConfig, NetworkConfig, ProtocolConfig,
    TelemetryConfig, TrainConfig, get_arch,
)
from repro_torch.convert import params_from_numpy
from repro_torch.core import distributed, shard
from repro_torch.core.protocol import DecentralizedLearner
from repro_torch.models.cnn import cnn_loss

SGD = dict(optimizer="sgd", learning_rate=0.05)
NET = dict(act_prob=0.6, topology="ring", link_classes=("wifi", "lte"))


def _loss():
    cfg = get_arch("drift_mlp", smoke=True)
    return lambda p, b: cnn_loss(cfg, p, b)


def learner(proto, m, init, tiers=None, telemetry=None, **kw):
    """The fixture's engine for ``proto`` (ProtocolConfig kwargs) and
    ``tiers`` (``{"num_clusters": g, "inter": kwargs}``)."""
    hier = None if tiers is None else HierarchyConfig(
        num_clusters=tiers["num_clusters"],
        inter=ProtocolConfig(**tiers["inter"]))
    return DecentralizedLearner(
        _loss(), lambda g: params_from_numpy(init, device="cpu"), m,
        ProtocolConfig(**proto, tiers=hier), TrainConfig(**SGD),
        network=NetworkConfig(**NET), telemetry=telemetry, device="cpu",
        **kw)


def chunk(batches, a, b):
    return {k: torch.from_numpy(np.array(v[a:b]))
            for k, v in batches.items()}


def summary(dl):
    """What the tests compare: counters, ledger, simulated time, losses
    and the whole (m, P) plane (gathered; every rank calls this)."""
    return {"comm": dict(dl.comm_totals),
            "ledger": dl.per_link_bytes(),
            "xfers": dl.link_xfer_totals.copy(),
            "network_time": dl.network_time,
            "mean_active": dl.mean_active(),
            "cum_loss": dl.cumulative_loss,
            "loss_per_learner": dl.cumulative_loss_per_learner.copy(),
            "plane": dl.fleet_plane().numpy().copy()}


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def _run(case, init, batches, workdir, name):
    dl = learner(case["proto"], case.get("m", 8), init, case.get("tiers"))
    dl.run_chunk(chunk(batches, 0, case.get("rounds", 30)))
    return summary(dl)


def _repeat(case, init, batches, workdir, name):
    """The same run twice in one process: bit for bit."""
    return [_run(case, init, batches, workdir, name) for _ in range(2)]


def _telemetry(case, init, batches, workdir, name):
    path = os.path.join(workdir, f"{name}.jsonl")
    dl = learner(case["proto"], 8, init,
                 telemetry=TelemetryConfig(path=path, per_link=True))
    dl.run_chunk(chunk(batches, 0, 30))
    dl.recorder.close()
    return summary(dl)


def _resume(case, init, batches, workdir, name):
    """15 rounds streamed and checkpointed (rank 0 writes the gathered
    plane), restored into a fresh engine (each rank takes its rows), 15
    more rounds appended to the stream."""
    path = os.path.join(workdir, f"{name}.jsonl")
    ckpt = os.path.join(workdir, f"{name}_ckpt")
    tel = TelemetryConfig(path=path, per_link=True)
    dl = learner(case["proto"], 8, init, telemetry=tel)
    dl.run_chunk(chunk(batches, 0, 15))
    dl.recorder.close()
    params, opt = dl.fleet_state()
    if dl.is_writer:
        io.save_protocol_state(ckpt, params, opt, dl.sync_state,
                               protocol=ProtocolConfig(**case["proto"]),
                               counters=dl.counters_state())
    _barrier()
    dl2 = learner(case["proto"], 8, init,
                  telemetry=dataclasses.replace(tel, append=True))
    dl2.restore_state(*io.load_protocol_state(ckpt, device="cpu"))
    dl2.restore_counters(io.load_counters(ckpt))
    dl2.run_chunk(chunk(batches, 15, 30))
    dl2.recorder.close()
    return summary(dl2)


def _subset(case, init, batches, workdir, name):
    """``shard_devices`` below the world: the first ranks run the fleet,
    a rank outside it raises."""
    try:
        return _run(case, init, batches, workdir, name)
    except ValueError as e:
        return f"ValueError: {e}"


def _errors(case, init, batches, workdir, name):
    """What a split fleet refuses, as ``{what: error text}``."""
    n = dist.get_world_size()
    out = {}

    def catch(what, fn):
        try:
            fn()
            out[what] = "no error"
        except (ValueError, NotImplementedError) as e:
            out[what] = f"{type(e).__name__}: {e}"

    dyn = dict(kind="dynamic", b=2, delta=0.5, layout="sharded")
    catch("indivisible", lambda: learner(dyn, n + 1, init))
    catch("too_many", lambda: shard.fleet_sharding(8, n + 1))
    catch("faults", lambda: learner(dyn, 8, init,
                                    faults=FaultConfig(crash_prob=0.1)))
    g = n + 1
    catch("clusters", lambda: learner(
        dyn, n * g, init,
        tiers={"num_clusters": g, "inter": dict(kind="periodic", b=6)}))
    return out


def _train_step(case, init, batches, workdir, name):
    """``make_dynamic_train_step`` / ``make_periodic_train_step``: 10
    steps at m = 4, from the reference's initial model."""
    m = 4
    fleet = shard.fleet_sharding(m) if dist.is_initialized() else None
    train = TrainConfig(optimizer="sgd", learning_rate=0.3)
    out = {}
    for kind, make in (("dynamic", distributed.make_dynamic_train_step),
                       ("periodic", distributed.make_periodic_train_step)):
        proto = ProtocolConfig(kind=kind, b=2, delta=case["delta"])
        state = distributed.init_dynamic_state(
            lambda g: params_from_numpy(init, device="cpu"), None, m, train,
            fleet=fleet, device="cpu")
        step = make(_loss(), proto, train, m, fleet=fleet)
        synced, maxd, loss = [], [], []
        for t in range(10):
            batch = {k: torch.from_numpy(np.array(v[t]))
                     for k, v in batches.items()}
            state, metrics = step(state, batch)
            synced.append(int(metrics["synced"]))
            maxd.append(float(metrics.get("max_sq_dist", 0.0)))
            loss.append(float(metrics["loss"]))
        with shard.use_fleet(fleet):
            plane = shard.gather_plane(state.plane).numpy().copy()
        out[kind] = {"synced": synced, "max_sq_dist": maxd, "loss": loss,
                     "plane": plane, "syncs": state.syncs,
                     "checks": state.checks}
    return out


def _collectives(case, init, batches, workdir, name):
    """The plane helpers on this rank's rows of a seeded (m, P) plane:
    each result with the bytes its collectives received."""
    m, P = case["m"], case["P"]
    gen = torch.Generator().manual_seed(case["seed"])
    X = torch.randn((m, P), generator=gen)
    w = torch.rand((m,), generator=gen)
    W = torch.rand((m, m), generator=gen)
    ref = torch.randn((P,), generator=gen)
    fleet = shard.fleet_sharding(m)
    Xl = X[fleet.rows].clone()
    ops = {"row_sum": lambda: shard.row_sum(Xl, w),
           "row_mean": lambda: shard.row_mean(Xl),
           "row_dists": lambda: shard.row_dists_device(Xl, ref),
           "plane_rows": lambda: shard.plane_rows(Xl, case["rows"]),
           "mix": lambda: shard.mix(W, Xl),
           "gather_plane": lambda: shard.gather_plane(Xl)}
    out = {}
    with shard.use_fleet(fleet):
        for op, fn in ops.items():
            shard.COLLECTIVE_BYTES.clear()
            out[op] = {"value": fn().numpy().copy(),
                       "bytes": dict(shard.COLLECTIVE_BYTES)}
    return out


CASES = {"run": _run, "repeat": _repeat, "telemetry": _telemetry,
         "resume": _resume, "subset": _subset, "errors": _errors,
         "train_step": _train_step, "collectives": _collectives}


def run_cases(cases, init, batches, workdir):
    """Every case in order, on this rank; ``{name: result}``. A case may
    carry its own ``init`` / ``batches`` (the m = 4 train steps)."""
    torch.manual_seed(0)
    return {name: CASES[case["kind"]](case, case.get("init", init),
                                      case.get("batches", batches),
                                      workdir, name)
            for name, case in cases.items()}
