"""Peak device memory of an LM gradient and of a σ_1 training step with
and without rematerialized layers (``lm_loss(..., remat=True)``), on the
card.

    python3 benchmarks/torch_remat_memory.py

llama3-8b at full width and 2 and 4 of its 32 layers, f32, B = 1,
S = 4,096 (``chip_smoke.py``'s σ_1 batch): one gradient by
``torch.func.grad`` (what the fleet's step takes, vmapped) and one by
``loss.backward()``, each with ``remat`` off and on, its peak above the
weights; then one σ_1 step (``make_train_step``, sgd, which takes its
gradient by ``torch.autograd.grad``) with ``remat`` off and on. Then
mixtral-8x22b's σ_1 step at 2 layers with the production program
(sgd, ``remat=True``) and without remat, which tells what
``chip_smoke.py``'s ``LM_MOE_LAYERS`` can hold: each peak, or the
out-of-memory error and the peak before it. One JSON line a case; the
last line is the card's name and power limit as ``nvidia-smi`` reports
them. Needs a CUDA device; it imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.config import TrainConfig, get_arch  # noqa: E402
from repro_torch.core.flatten import tree_map  # noqa: E402
from repro_torch.models.model import init_lm_params, lm_loss  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402


def _peak(fn) -> dict:
    """``fn()``'s peak allocated device memory, and above the start."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    try:
        fn()
        torch.cuda.synchronize()
        out = {}
    except torch.OutOfMemoryError as e:
        out = {"out_of_memory": str(e).split(". ")[0]}
    peak = torch.cuda.max_memory_allocated()
    return {**out, "peak_gb": peak / 1e9, "above_start_gb":
            (peak - start) / 1e9}


def _step(cfg, remat: bool):
    """One σ_1 step of ``cfg`` (sgd at chip_smoke's LM_MOE_LR), peaked."""
    train = TrainConfig(optimizer="sgd", learning_rate=cs.LM_MOE_LR,
                        remat=remat)
    init_state, step = make_train_step(
        lambda p, b: lm_loss(cfg, p, b, remat=train.remat), train,
        device="cuda")
    state = init_state(init_lm_params(cfg, seed=0, device="cuda"))
    batch = cs._lm_batch(cfg, 1, cs.LM_TRAIN_S, 3)
    rec = _peak(lambda: step(state, batch))
    del state
    torch.cuda.empty_cache()
    return rec


def gradients(layers: int) -> list:
    cfg = dataclasses.replace(get_arch("llama3-8b"), num_layers=layers)
    params = init_lm_params(cfg, seed=0, device="cuda")
    batch = cs._lm_batch(cfg, 1, cs.LM_TRAIN_S, 3)
    out = []
    for how in ("torch.func.grad", "loss.backward()"):
        for remat in (False, True):
            def run():
                if how == "torch.func.grad":
                    torch.func.grad(lambda p: lm_loss(cfg, p, batch,
                                                      remat=remat))(params)
                else:
                    leaves = tree_map(
                        lambda v: v.detach().requires_grad_(), params)
                    lm_loss(cfg, leaves, batch, remat=remat).backward()
            out.append({"arch": cfg.name, "layers": layers,
                        "seq": cs.LM_TRAIN_S, "gradient_by": how,
                        "remat": remat, **_peak(run)})
    del params
    torch.cuda.empty_cache()
    for remat in (False, True):
        out.append({"arch": cfg.name, "layers": layers, "seq": cs.LM_TRAIN_S,
                    "gradient_by": "make_train_step (sgd)", "remat": remat,
                    **_step(cfg, remat)})
    return out


def moe_step(arch: str, layers: int, remat: bool) -> dict:
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    return {"arch": cfg.name, "layers": layers, "weights": cfg.param_count(),
            "step": "make_train_step, sgd", "remat": remat,
            **_step(cfg, remat)}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_remat_memory.py needs a CUDA device")
    for layers in (2, 4):
        for rec in gradients(layers):
            print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    for remat in (True, False):
        print(json.dumps(moe_step("mixtral-8x22b", 2, remat)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
