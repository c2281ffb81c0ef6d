"""Serving: prefill + batched decode against KV / SSM-state caches — the
counterpart of ``repro.serve.engine``.

``make_prefill`` is the full forward (logits for every position);
``make_decode_step`` one new token for a batch of requests. The
``ServeEngine`` is the minimal batched-request loop: ``feed`` a prompt
through decode, then ``generate`` greedily or by temperature sampling.

An attention model decodes against its KV cache; a Mamba2 model carries
O(1) state per layer (the SSM and conv states), so its step costs the
same at any position and ``max_seq`` does not bound it.

Departures from the reference: PyTorch runs eagerly, so there is no
``jit`` (each decode step launches its operations from Python); the
cache is updated in place; the engine's cache lives on ``device``, the
card unless the caller asks for the CPU. Greedy decoding is exact argmax
(ties to the lowest index, as ``jnp.argmax``). Temperature sampling
draws from an explicit ``torch.Generator``; its draws cannot equal
``jax.random.categorical``'s until the port has the reference's
threefry stream (``prng.py``, ROADMAP Queue A 10).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import init_lm_cache, lm_apply, lm_decode_step


def make_prefill(cfg: ModelConfig):
    """Prefill = full forward (logits for every position)."""

    def prefill(params, tokens):
        logits, _ = lm_apply(cfg, params, tokens)
        return logits

    return prefill


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, token, pos):
        return lm_decode_step(cfg, params, token, cache, pos)

    return serve_step


class ServeEngine:
    """Minimal batched serving loop (greedy / temperature sampling)."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int, batch: int,
                 dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self.device = resolve_device(device)
        self.cache = init_lm_cache(cfg, batch, max_seq, dtype, self.device)
        self.pos = 0
        self._step = make_decode_step(cfg)

    def feed(self, tokens) -> torch.Tensor:
        """Feed prompt tokens (B, S_prompt) through decode, one position
        at a time; returns the logits (B, V) after the last one."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits = None
        for t in range(tokens.shape[1]):
            logits, self.cache = self._step(self.params, self.cache,
                                            tokens[:, t], self.pos)
            self.pos += 1
        return logits

    def generate(self, num_tokens: int, generator: torch.Generator = None,
                 temperature: float = 0.0,
                 first_logits: torch.Tensor = None) -> torch.Tensor:
        """Generate ``num_tokens`` per request from ``first_logits`` (what
        ``feed`` returned) -> (B, num_tokens) token ids."""
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        out = []
        logits = first_logits
        for _ in range(num_tokens):
            if logits is None:
                raise ValueError("call feed() first")
            if temperature > 0.0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            out.append(nxt)
            logits, self.cache = self._step(self.params, self.cache, nxt,
                                            self.pos)
            self.pos += 1
        return torch.stack(out, dim=1)
