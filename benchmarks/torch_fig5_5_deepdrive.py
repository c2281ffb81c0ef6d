"""Fig. 5.5 / A.4: the deep-driving case study (in-fleet learning) — the
twin of ``benchmarks/fig5_5_deepdrive.py`` on ``repro_torch``.

The paper trains PilotNet (Bojarski et al.) on human-driving frames and
evaluates trained models in a driving simulator with a custom loss

    L_dd = lambda (t_max - t)/t_max + mu c/c_max + (1-mu-lambda) t_line/t

(t = time on road, c = sideline-crossing frequency, t_line = time on
line). As in the reference, a procedural driving stream stands in for
the simulator: a model "drives" an episode where the car leaves the road
when its steering error exceeds a threshold for three consecutive
frames, and touches the sideline when the error exceeds a smaller one.
lambda=0.8, mu=0.15 as in the paper.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks.torch_common import save_rows
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch
from repro_torch.data.synthetic import DeepDriveStream
from repro_torch.models.cnn import cnn_apply, cnn_loss, init_cnn_params
from repro_torch.train.loop import run_protocol_training

NAME = "fig5_5_deepdrive"
PAPER_REF = "Figure 5.5, Appendix A.4"

LAM, MU = 0.8, 0.15
OFF_ROAD_ERR = 0.6       # sustained error -> crash / off-road
SIDELINE_ERR = 0.3       # momentary error -> sideline touch
EPISODE = 300

PROTOS = [
    ("periodic_b10", ProtocolConfig(kind="periodic", b=10)),
    ("periodic_b40", ProtocolConfig(kind="periodic", b=40)),
    ("dynamic_d0.1", ProtocolConfig(kind="dynamic", b=10, delta=0.1)),
    ("dynamic_d0.3", ProtocolConfig(kind="dynamic", b=10, delta=0.3)),
    ("nosync", ProtocolConfig(kind="nosync")),
]


def drive_episode(cfg, params, seed: int = 0, device="cuda"):
    """Returns (t_on_road, crossings, t_line) for one simulated episode."""
    src = DeepDriveStream(seed=seed, height=cfg.input_shape[0],
                          width=cfg.input_shape[1], device=device)
    gen = torch.Generator(device=src.device).manual_seed(seed)
    errs = []
    with torch.no_grad():
        for _ in range(EPISODE // 50):
            b = src.sample(gen, 50)
            pred = cnn_apply(cfg, params, b["x"])[:, 0]
            errs.append(torch.abs(pred - b["y"]).cpu().numpy())
    err = np.concatenate(errs)
    off = err > OFF_ROAD_ERR
    # crash at the first window of 3 consecutive off-road frames
    t = len(err)
    for i in range(len(err) - 2):
        if off[i] and off[i + 1] and off[i + 2]:
            t = i
            break
    line = err[:t] > SIDELINE_ERR
    return t, int(np.sum(np.diff(line.astype(int)) == 1)), int(np.sum(line))


def custom_loss(t, c, t_line, t_max, c_max):
    cf = (c / max(t, 1)) / max(c_max, 1e-9)
    return (LAM * (t_max - t) / t_max + MU * cf
            + (1 - MU - LAM) * t_line / max(t, 1))


ARCH = "deepdrive_cnn"
# the cut rows that tests/test_torch_figures.py and chip_smoke.py's
# twins phase run through cut(): (protocol keywords, m, rounds, {})
CUT = ((dict(kind="dynamic", b=10, delta=0.1), 3, 20, {}),
       (dict(kind="periodic", b=10), 3, 20, {}))


def default_source(device="cuda"):
    cfg = get_arch(ARCH, smoke=True)
    return DeepDriveStream(seed=3, height=cfg.input_shape[0],
                           width=cfg.input_shape[1], device=device)


def cut(case, device="cuda", source=None, init_fn=None):
    """One case of ``CUT``: ``(learner, {})``."""
    proto, m, rounds, kw = case
    return train(ProtocolConfig(**proto), m, rounds, device=device,
                 source=source, init_fn=init_fn, **kw), {}


def train(proto, m, rounds, device="cuda", source=None, init_fn=None):
    """One protocol's fleet on the smoke PilotNet: the learner."""
    cfg = get_arch(ARCH, smoke=True)
    src = default_source(device) if source is None else source
    dl, _ = run_protocol_training(
        lambda p, b: cnn_loss(cfg, p, b),
        init_fn or (lambda g: init_cnn_params(cfg, g)), src, m=m,
        rounds=rounds, protocol=proto,
        train=TrainConfig(optimizer="sgd", learning_rate=0.05), batch=10,
        seed=0, device=device)
    return dl


def run(quick: bool = True, device="cuda"):
    cfg = get_arch(ARCH, smoke=True)
    m = 5
    rounds = 80 if quick else 400
    results = []
    for name, proto in PROTOS:
        dl = train(proto, m, rounds, device)
        t, c, t_line = drive_episode(cfg, dl.mean_model(), seed=77,
                                     device=device)
        results.append((name, dl, t, c, t_line))
    t_max = max(r[2] for r in results)
    c_max = max(r[3] / max(r[2], 1) for r in results)
    rows = []
    for name, dl, t, c, t_line in results:
        rows.append({
            "protocol": name,
            "custom_loss_Ldd": round(custom_loss(t, c, t_line, t_max,
                                                 c_max), 4),
            "time_on_road": t, "crossings": c,
            "comm_bytes": dl.comm_bytes(),
        })
    save_rows(NAME, rows)
    return rows


def check(rows) -> str:
    """Some dynamic protocol matches the best periodic's driving loss with
    less communication (Fig. 5.5 claim)."""
    per = [r for r in rows if r["protocol"].startswith("periodic")]
    dyn = [r for r in rows if r["protocol"].startswith("dynamic")]
    best_per = min(per, key=lambda r: r["custom_loss_Ldd"])
    ok = any(d["custom_loss_Ldd"] <= best_per["custom_loss_Ldd"] + 0.1 and
             d["comm_bytes"] < best_per["comm_bytes"] for d in dyn)
    return "PASS" if ok else "MIXED"


if __name__ == "__main__":
    for r in run():
        print(r)
