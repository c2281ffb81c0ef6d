"""The LM σ_1 cells of ``chip_smoke.py`` in one process under the
caching allocator that ``PYTORCH_CUDA_ALLOC_CONF`` sets, on the card:
llama3-8b at 2 layers, then deepseek-v2-236b and mixtral-8x22b at
``LM_MOE_LAYERS`` (``_lm_train_cell``, the production program for the
MoE cells), without ``chip_smoke.py``'s ``_expandable_segments``.

    python3 benchmarks/torch_lm_allocator.py
    PYTORCH_CUDA_ALLOC_CONF=max_split_size_mb:1024 \\
        python3 benchmarks/torch_lm_allocator.py
    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True \\
        python3 benchmarks/torch_lm_allocator.py

One JSON line a cell: its ms a step after the first, peak memory and
losses, or the out-of-memory error; then the allocator's retries and the
card's name and power limit as ``nvidia-smi`` reports them. Needs a CUDA
device; it imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_lm_allocator.py needs a CUDA device")
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    moe = TrainConfig(optimizer="sgd", learning_rate=cs.LM_MOE_LR,
                      remat=True)
    cells = [("llama3-8b", cs.LM_TRAIN_LAYERS, None, cs.LM_TRAIN_S)] + [
        (arch, layers, moe, cs.LM_MOE_CHECK_S)
        for arch, layers in cs.LM_MOE_LAYERS.items()]
    for arch, layers, train, check_s in cells:
        try:
            rec = cs._lm_train_cell(arch, layers, train, check_s=check_s)
            out = {k: rec[k] for k in ("layers", "losses",
                                       "ms_per_step_after_warmup",
                                       "peak_memory_gb")}
        except torch.OutOfMemoryError as e:
            out = {"layers": layers, "out_of_memory": str(e)[:400]}
        print(json.dumps({"alloc_conf": conf, "arch": arch, **out}),
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"alloc_conf": conf, "alloc_retries":
                      torch.cuda.memory_stats().get("num_alloc_retries")}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
