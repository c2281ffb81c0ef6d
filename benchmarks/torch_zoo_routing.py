"""The serving zoo's engine prompt logits against its prefill's, at full
width, with the experts each path routes every token to.

    python3 benchmarks/torch_zoo_routing.py [config ...]

For each zoo config (all eight by default), at the depth ``chip_smoke.py``
serves it (``ZOO_LAYERS``) and with the same weights and tokens as its
``zoo_serve`` phase, in bf16 and then in f32: a prefill at B = 4,
S = 2,048, then a batch-4 ``ServeEngine`` fed the first 16 tokens. Each
line gives the engine's logits at the last prompt position against the
prefill's (max |diff| over max |logit|, argmax agreement) and, for a
mixture-of-experts config, how many of the (position, layer, row)
routings pick another set of experts in decode than in the prefill:
``moe_route`` is wrapped to record each call's experts. The last line is
the card's name and power limit as ``nvidia-smi`` reports them. Needs a
CUDA device; it imports nothing of JAX.
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
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import init_lm_params, lm_apply  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

B, S, PROMPT = cs.SERVE_B, cs.SERVE_S, cs.ZOO_PROMPT


def gap_and_swaps(name: str, dtype) -> dict:
    cfg = dataclasses.replace(get_arch(name), num_layers=cs.ZOO_LAYERS[name])
    routes = []
    route = moe.moe_route

    def recorded(cfg_, params, xt):
        r = route(cfg_, params, xt)
        routes.append(r["gate_idx"])
        return r

    moe.moe_route = recorded
    try:
        params = init_lm_params(cfg, seed=0, dtype=dtype, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(3)
        text, _ = cs._zoo_inputs(cfg, B, S, g, "cuda")
        logits, _ = lm_apply(cfg, params, text)
        at_prompt = logits[:, PROMPT - 1].float()
        del logits
        prefill = [r.reshape(B, S, -1)[:, :PROMPT] for r in routes]
        routes.clear()
        eng = ServeEngine(cfg, params, max_seq=PROMPT + 1, batch=B,
                          dtype=dtype, device="cuda")
        first = eng.feed(text[:, :PROMPT])
    finally:
        moe.moe_route = route
    rows = B * (4 if cfg.modality == "audio" else 1)
    gap = cs._prompt_gap(first.reshape(rows, -1), at_prompt.reshape(rows, -1))
    rec = {"arch": name, "dtype": str(dtype).split(".")[1],
           "layers": cfg.num_layers, "rel": gap["rel"],
           "max_abs_diff": gap["max_abs_diff"],
           "argmax_agree": gap["argmax_agree"]}
    if prefill:
        L = cfg.num_layers
        swaps = 0
        for t in range(PROMPT):          # decode calls: step t, layer l
            for layer in range(L):
                d = torch.sort(routes[t * L + layer].reshape(B, -1)).values
                p = torch.sort(prefill[layer][:, t]).values
                swaps += int((d != p).any(-1).sum())
        rec["routings"] = PROMPT * L * B
        rec["routings_swapped"] = swaps
    del params, eng, first
    torch.cuda.empty_cache()
    return rec


def main(names) -> None:
    for name in names or cs.ZOO:
        for dtype in (torch.bfloat16, torch.float32):
            print(json.dumps(gap_and_swaps(name, dtype)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
