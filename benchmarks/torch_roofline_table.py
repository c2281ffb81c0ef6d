"""Roofline table: the port's dry-run records
(``experiments/torch_dryrun/*.json``, ``python -m
repro_torch.launch.dryrun``) as the per-(arch x shape x mesh) three-term
table — the twin of ``benchmarks/roofline_table.py`` — with the
protocol kernels' per-block roofline on the card: each
``csrc/sqdist.cu`` block's shared memory and the register tile its
threads hold a step, as the source sets them, and the device-memory
bytes of one pass at the reference's protocol scale.

``format_markdown`` and ``run`` read either package's records (the same
keys); ``check`` words its verdict as the reference's (``"{done}/{n}
compiled"``, or ``NO-DATA`` without records)."""
from __future__ import annotations

import glob
import json
import os

NAME = "roofline_table"
PAPER_REF = "deliverable (g)"

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "experiments",
                          "torch_dryrun")

# the monitoring kernels at protocol scale: the paper's 1.2M-weight CNN,
# m = 200 learners (the scale-out sweeps' fleet size)
_P, _M = 1_199_882, 200
# csrc/sqdist.cu: kThreads threads a block, each kUnroll columns of x and
# of r a step in registers; shared memory: kThreads / 32 warp sums and
# the last-block flag
SQDIST_THREADS, SQDIST_UNROLL = 256, 4
_SMEM = 4 * (SQDIST_THREADS // 32) + 4
_TILE = SQDIST_THREADS * SQDIST_UNROLL

# one block's working set a step and one pass's device-memory bytes:
# sqdist reads x and r; sqdist_rows reads the (m, P) plane ONCE for all m
# learners and r once (its later reads hit the L2), where m sqdist calls
# would read r m times
KERNEL_ROOFLINES = [
    {"kernel": "sqdist",
     "tile": f"{SQDIST_THREADS} threads x {SQDIST_UNROLL} columns (x, r)",
     "smem_block_bytes": _SMEM, "register_tile_bytes": 2 * _TILE * 4,
     "hbm_bytes_one_pass": 2 * _P * 4,
     "note": f"per learner; x{_M} launches for the fleet"},
    {"kernel": "sqdist_rows",
     "tile": f"{SQDIST_THREADS} threads x {SQDIST_UNROLL} columns (x, r)",
     "smem_block_bytes": _SMEM, "register_tile_bytes": 2 * _TILE * 4,
     "hbm_bytes_one_pass": (_M * _P + _P) * 4,
     "note": f"whole fleet (m={_M}) in one launch; reference read once"},
]


def load_records(dryrun_dir: str = DRYRUN_DIR):
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def format_markdown(recs) -> str:
    lines = [
        "| arch | shape | mesh | mode | compute_s | memory_s | coll_s | "
        "bottleneck | useful | arg GB/chip | temp GB/chip |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if not r.get("ok"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('mode')}"
                f" | FAILED: {r.get('error', '?')[:60]} | | | | | | |")
            continue
        rl = r["roofline"]
        mem = rl.get("memory_stats", {})
        uf = rl.get("useful_fraction")
        lines.append(
            "| {a} | {s} | {m} | {mo} | {c:.3e} | {me:.3e} | {co:.3e} | "
            "{b} | {u} | {ag:.2f} | {tg:.2f} |".format(
                a=r["arch"], s=r["shape"], m=r["mesh"], mo=r["mode"],
                c=rl["compute_s"], me=rl["memory_s"], co=rl["collective_s"],
                b=rl["bottleneck"],
                u=f"{uf:.3f}" if uf else "-",
                ag=mem.get("argument_bytes", 0) / 1e9,
                tg=mem.get("temp_bytes", 0) / 1e9))
    lines.append("")
    lines.append("| kernel | tile | shared bytes/block | register tile "
                 "bytes/block | HBM bytes/pass | note |")
    lines.append("|---|---|---|---|---|---|")
    for r in KERNEL_ROOFLINES:
        lines.append(
            f"| {r['kernel']} | {r['tile']} | {r['smem_block_bytes']} | "
            f"{r['register_tile_bytes']} | {r['hbm_bytes_one_pass']} | "
            f"{r['note']} |")
    return "\n".join(lines)


def run(quick: bool = True, device: str = "cuda", dryrun_dir=None):
    """The table's rows: one a record, then the kernels' (``device`` is
    the registry's argument; the table reads files only)."""
    rows = []
    for r in load_records(dryrun_dir or DRYRUN_DIR):
        if not r.get("ok"):
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "mesh": r["mesh"], "ok": False})
            continue
        rl = r["roofline"]
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "mode": r["mode"], "ok": True,
            "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
            "collective_s": rl["collective_s"],
            "bottleneck": rl["bottleneck"],
            "useful_fraction": rl.get("useful_fraction"),
        })
    rows.extend(dict(r) for r in KERNEL_ROOFLINES)
    return rows


def check(rows) -> str:
    dry = [r for r in rows if "kernel" not in r]
    done = [r for r in rows if r.get("ok")]
    return f"{len(done)}/{len(dry)} compiled" if dry else "NO-DATA"


# no cut case: the table reads records and draws nothing
CUT = ()


if __name__ == "__main__":
    print(format_markdown(load_records()))
