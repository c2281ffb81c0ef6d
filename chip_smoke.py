"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc``, holds each kernel against its plain
PyTorch version on the card, trains the paper's MNIST CNN at full width
(m = 100 learners, B = 10) under periodic and dynamic averaging through
``run_protocol_training``, checks that the dynamic run went through the
``sqdist_rows`` kernel once per checked round, and checks that a small
dynamic run on the card makes exactly the sync decisions of the same run
on the CPU (the path the tests hold against the JAX reference). The
scalar ``sqdist`` kernel (behind ``divergence.sq_distance(use_kernel=True)``)
is not on the training path, as in the reference: it is checked and
timed, and its main-path count is 0.

Each phase prints one JSON line. The last three lines are the kernel
table, the card's name and power limit as ``nvidia-smi`` reports them,
and ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
those lines; without a CUDA device the script exits non-zero at once. It
imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is visible "
             "(torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.config import ProtocolConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.protocol import DecentralizedLearner  # noqa: E402
from repro_torch.data.synthetic import SyntheticMNIST  # noqa: E402
from repro_torch.kernels import _build, ops, ref, sqdist  # noqa: E402
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn_params  # noqa: E402
from repro_torch.train.loop import run_protocol_training  # noqa: E402

P_MNIST = 1_199_882          # mnist_cnn's weights (Table 1)
M, B, ROUNDS, CHUNK, PERIOD, DELTA = 100, 10, 60, 20, 10, 0.7
TOL = dict(rtol=1e-5, atol=1e-6)

# published peaks (NVIDIA data sheets, dense): device-memory bytes/s and
# f32 flop/s outside the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def peaks(name: str):
    for key in sorted(PEAKS, key=len, reverse=True):
        if all(part in name for part in key.split()):
            return PEAKS[key]
    raise ValueError(f"no published peaks for {name!r}")


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = {"phase": "env", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": _build.nvcc_path(),
           "ninja": shutil.which("ninja")}
    emit(rec)
    return rec


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = _build.build_all()
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "built": {n: r["seconds"] for n, r in built.items()},
           "ptxas": [line.strip() for r in built.values()
                     for line in r["log"].splitlines()
                     if "registers" in line or "spill" in line]}
    for name in _build.SOURCES:
        _build.library(name)
    emit(rec)
    return rec


def phase_kernels(gen) -> dict:
    """Each kernel against its plain version on the card, at rtol 1e-5 /
    atol 1e-6, and bitwise equal across two launches."""
    checks = []
    worst = {k: {"abs": 0.0, "rel": 0.0} for k in ("sqdist_rows", "sqdist")}

    def check(name, kernel, plain, args, label):
        a, b = kernel(*args), kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = float((a - want).abs().max())
        rel = float(((a - want).abs() / want.abs().clamp_min(1e-30)).max())
        worst[name]["abs"] = max(worst[name]["abs"], err)
        worst[name]["rel"] = max(worst[name]["rel"], rel)
        repeat = bool(torch.equal(a, b))
        ok = repeat and bool(torch.allclose(a, want, **TOL))
        checks.append({"kernel": name, "inputs": label,
                       "dtype": str(args[0].dtype).split(".")[1],
                       "max_abs_err": err, "max_rel_err": rel,
                       "bitwise_repeat": repeat, "ok": ok})
        if not ok:
            emit({"phase": "kernels", "failed": checks[-1]})
            raise SystemExit(f"kernel {name} disagrees: {checks[-1]}")

    # sqdist flattens its inputs: (1, P_MNIST) is one whole mnist_cnn model
    for m, n in [(1, 1), (17, 515), (1, P_MNIST), (7, P_MNIST),
                 (100, P_MNIST)]:
        for dt in (torch.float32, torch.bfloat16):
            X = torch.randn((m, n), generator=gen, device="cuda").to(dt)
            r = torch.randn((n,), generator=gen, device="cuda").to(dt)
            R = r.expand(m, n).contiguous()
            check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref,
                  (X, r), [m, n])
            check("sqdist", sqdist.sqdist, ref.sqdist_ref, (X, R), [m, n])
            del X, R

    mem_rate, f32_rate = peaks(torch.cuda.get_device_name(0))
    X = torch.randn((M, P_MNIST), generator=gen, device="cuda")
    r = torch.randn((P_MNIST,), generator=gen, device="cuda")
    x0 = X[0]
    # the timed inputs themselves, checked as the shapes above
    check("sqdist_rows", sqdist.sqdist_rows, ref.sqdist_rows_ref, (X, r),
          "timed X (100, P)")
    check("sqdist", sqdist.sqdist, ref.sqdist_ref, (x0, r),
          "timed x0 = X[0] (P,)")
    timed = {
        "sqdist_rows": (M, lambda: sqdist.sqdist_rows(X, r),
                        lambda: ref.sqdist_rows_ref(X, r),
                        lambda: torch.linalg.vector_norm(X - r, dim=1)
                        .square()),
        "sqdist": (1, lambda: sqdist.sqdist(x0, r),
                   lambda: ref.sqdist_ref(x0, r),
                   lambda: torch.linalg.vector_norm(x0 - r).square()),
    }
    table = {}
    for name, (m, kernel, plain, library) in timed.items():
        nbytes = (m * P_MNIST + P_MNIST) * 4 + 4 * m
        nops = 3 * m * P_MNIST
        t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / f32_rate * 1e3
        table[name] = {
            "shape": [m, P_MNIST], "dtype": "float32",
            "max_abs_err": worst[name]["abs"],
            "max_rel_err": worst[name]["rel"], "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": nops}
    emit({"phase": "kernels", "checks": len(checks),
          "all_ok": all(c["ok"] for c in checks), "timed": table,
          "peaks": {"bytes_per_s": mem_rate, "f32_flops": f32_rate}})
    return table


def phase_train() -> dict:
    """The main path: full-width mnist_cnn, m = 100, through
    run_protocol_training, periodic then dynamic."""
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init_fn = lambda g: init_cnn_params(cfg, g)          # noqa: E731
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    test = src.sample(torch.Generator(device="cuda").manual_seed(10_000), 512)
    train = TrainConfig(optimizer="sgd", learning_rate=0.1)
    protos = {"periodic": ProtocolConfig(kind="periodic", b=PERIOD),
              "dynamic": ProtocolConfig(kind="dynamic", b=PERIOD,
                                        delta=DELTA)}
    # warm-up outside the counted window: cuDNN picks its algorithms
    run_protocol_training(loss_fn, init_fn, src, m=M, rounds=2,
                          protocol=protos["dynamic"], train=train, batch=B,
                          device="cuda")
    torch.cuda.synchronize()

    runs, launches = {}, {}
    ops.reset_launches()
    for name, proto in protos.items():
        before = dict(ops.LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dl, traj = run_protocol_training(
            loss_fn, init_fn, src, m=M, rounds=ROUNDS, protocol=proto,
            train=train, batch=B, chunk_size=CHUNK, record_every=CHUNK,
            device="cuda")
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        acc = float(cnn_accuracy(cfg, dl.mean_model(), test))
        runs[name] = {
            "weights": dl.model_size, "rounds": dl.rounds,
            "syncs": dl.comm_totals["syncs"],
            "full_syncs": dl.comm_totals["full_syncs"],
            "comm_bytes": dl.comm_bytes(),
            "ledger_bytes": int(dl.per_link_bytes().sum()),
            "cumulative_loss": dl.cumulative_loss,
            "accuracy_512": acc,
            "ms_per_round": start.elapsed_time(end) / ROUNDS,
            "wall_s": wall, "launches": launches[name],
            "plane_device": str(dl.X.device),
            "trajectory_syncs": traj.syncs}
        if dl.model_size != P_MNIST:
            raise SystemExit(f"mnist_cnn has {dl.model_size} weights, "
                             f"not {P_MNIST}")
        if not (math.isfinite(dl.cumulative_loss)
                and np.isfinite(dl.cumulative_loss_per_learner).all()):
            raise SystemExit(f"{name}: non-finite loss")
        if runs[name]["ledger_bytes"] != dl.comm_bytes():
            raise SystemExit(f"{name}: ledger {runs[name]['ledger_bytes']} "
                             f"!= comm_bytes {dl.comm_bytes()}")
        if not dl.X.is_cuda:
            raise SystemExit(f"{name}: the parameter plane is on {dl.X.device}")
        del dl
    total = dict(ops.LAUNCHES)
    emit({"phase": "train", "m": M, "batch": B, "runs": runs})

    checked = ROUNDS // PERIOD
    if launches["periodic"]["sqdist_rows"] != 0:
        raise SystemExit(f"periodic launched sqdist_rows: {launches}")
    if launches["dynamic"]["sqdist_rows"] != checked:
        raise SystemExit(f"dynamic launched sqdist_rows "
                         f"{launches['dynamic']['sqdist_rows']} times, not "
                         f"once per checked round ({checked})")
    if runs["dynamic"]["syncs"] < 1:
        raise SystemExit(f"the dynamic run never synced, so the balancing "
                         f"path did not run: {runs['dynamic']}")
    if runs["dynamic"]["comm_bytes"] >= runs["periodic"]["comm_bytes"]:
        raise SystemExit("dynamic averaging communicated no less than "
                         "periodic")
    return total


def phase_agree() -> dict:
    """The same small dynamic run on the card and on the CPU, from the same
    initial model and batches: identical sync decisions and byte counts,
    losses and parameters to f32-reassociation tolerance."""
    cfg = get_arch("mnist_cnn", smoke=True)
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    init = params_to_numpy(init_cnn_params(cfg, torch.Generator()
                                           .manual_seed(3)))
    src = SyntheticMNIST(seed=0, image_size=14, device="cpu")
    batches = src.sample(torch.Generator().manual_seed(4), 10, lead=(12, 4))
    out = {}
    for dev in ("cpu", "cuda"):
        dl = DecentralizedLearner(
            loss_fn, lambda g: params_from_numpy(init, g.device), 4,
            ProtocolConfig(kind="dynamic", b=2, delta=0.01),
            TrainConfig(optimizer="sgd", learning_rate=0.05), device=dev)
        dl.run_chunk({k: v.to(dev) for k, v in batches.items()})
        out[dev] = dl
    cpu, gpu = out["cpu"], out["cuda"]
    err = float((gpu.X.cpu() - cpu.X).abs().max())
    rec = {"phase": "agree", "comm_totals": gpu.comm_totals,
           "cpu_comm_totals": cpu.comm_totals,
           "loss": gpu.cumulative_loss, "cpu_loss": cpu.cumulative_loss,
           "param_max_abs_err": err}
    emit(rec)
    if (gpu.comm_totals != cpu.comm_totals
            or not np.array_equal(gpu.per_link_bytes(), cpu.per_link_bytes())
            or gpu.comm_totals["syncs"] < 1):
        raise SystemExit("the card's sync decisions differ from the CPU's")
    if not (math.isclose(gpu.cumulative_loss, cpu.cumulative_loss,
                         rel_tol=1e-5) and err <= 1e-5):
        raise SystemExit("the card's losses or parameters differ from the "
                         "CPU's beyond f32 reassociation")
    return rec


def main() -> None:
    env = phase_env()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    table = phase_kernels(gen)
    phase_agree()
    launches = phase_train()
    source = "src/repro_torch/kernels/csrc/sqdist.cu"
    kernels = [
        {"name": "sqdist_rows", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/sqdist.py:81",
         "launches": launches["sqdist_rows"], **table["sqdist_rows"]},
        {"name": "sqdist", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/sqdist.py:41",
         "launches": launches["sqdist"], **table["sqdist"]},
    ]
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
