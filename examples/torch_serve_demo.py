"""Serving demo in the PyTorch port: batched prefill and decode against KV
and SSM-state caches.

The twin of ``examples/serve_demo.py``. A small llama-family model, a
Mamba2 model and a mixture of experts with a sliding-window ring buffer
take a batch of prompts through ``ServeEngine`` (``feed``, then greedy
and temperature-sampled continuations); each prompt also goes through
``make_prefill``'s one forward, whose last logits the engine's must
match. On the card the prefill runs the hand-written kernels (rmsnorm,
flash attention, the SSD scan), the engine's steps rmsnorm. The prompts
are ``jax.random.randint``'s (``repro_torch.prng``, bit for bit); the
weights are the port's own draw.

    PYTHONPATH=src python examples/torch_serve_demo.py            # the card
    PYTHONPATH=src python examples/torch_serve_demo.py --device cpu --smoke
"""
import argparse
import time

import torch

from repro_torch import prng
from repro_torch.config import get_arch
from repro_torch.models.model import init_lm_params
from repro_torch.serve.engine import ServeEngine, make_prefill

ARCHS = ("llama3-8b",        # GQA KV cache
         "mamba2-2.7b",      # O(1) SSM state: the long_500k decode path
         "mixtral-8x22b")    # MoE + sliding-window ring buffer
BATCH, PROMPT = 4, 16
FULL_GEN, SMOKE_GEN = 32, 8


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def demo(arch: str, gen_tokens: int, device="cuda", params=None,
         batch: int = BATCH, prompt_len: int = PROMPT) -> dict:
    """One arch's demo at its smoke size: prints it and returns the
    prompts, the greedy and sampled continuations and the engine's gap
    to the prefill (``params`` default to the port's draw of seed 0)."""
    cfg = get_arch(arch, smoke=True)
    if params is None:
        params = init_lm_params(cfg, 0, device=device)
    max_seq = prompt_len + gen_tokens + 1
    eng = ServeEngine(cfg, params, max_seq=max_seq, batch=batch,
                      device=device)
    prompts = prng.randint(prng.key(1, device), (batch, prompt_len), 0,
                           cfg.vocab_size, device)
    t0 = time.perf_counter()
    logits = eng.feed(prompts)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    greedy = eng.generate(gen_tokens, first_logits=logits)
    _sync(device)
    t_decode = time.perf_counter() - t0
    print(f"{arch:18s} prefill {batch}x{prompt_len} in {t_prefill:.2f}s; "
          f"decoded {batch}x{gen_tokens} in {t_decode:.2f}s "
          f"({batch*gen_tokens/t_decode:.0f} tok/s)")
    print(f"  first continuation: {greedy[0].tolist()}")

    # the one-forward prefill against the engine's token-by-token feed
    full = make_prefill(cfg)(params, prompts)[:, -1]
    gap = float((full - logits).abs().max() / full.abs().max())
    print(f"  prefill vs feed:    max |diff| / max |logit| = {gap:.2e}")

    # temperature sampling from a fresh engine
    eng2 = ServeEngine(cfg, params, max_seq=max_seq, batch=batch,
                       device=device)
    logits = eng2.feed(prompts)
    sampled = eng2.generate(
        gen_tokens, generator=torch.Generator(device=device).manual_seed(7),
        temperature=0.8, first_logits=logits)
    print(f"  sampled (T=0.8):    {sampled[0].tolist()}")
    return {"prompts": prompts, "greedy": greedy, "sampled": sampled,
            "prefill_gap": gap}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fewer generated tokens (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    gen = SMOKE_GEN if args.smoke else FULL_GEN
    for arch in ARCHS:
        demo(arch, gen, args.device)
    print("torch_serve_demo_done")


if __name__ == "__main__":
    main()
