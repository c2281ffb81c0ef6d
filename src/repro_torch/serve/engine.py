"""Serving: prefill + batched decode against KV / SSM-state caches — the
counterpart of ``repro.serve.engine``.

``make_prefill`` is the full forward (logits for every position);
``make_decode_step`` one new token for a batch of requests. The
``ServeEngine`` is the minimal batched-request loop: ``feed`` a prompt
through decode, then ``generate`` greedily or by temperature sampling.

An attention model decodes against its KV cache (MLA: its latent and
rotary-key cache); a Mamba2 model carries O(1) state per layer (the SSM
and conv states), so its step costs the same at any position and
``max_seq`` does not bound it; a hybrid model carries both. An audio
model (MusicGen) feeds and generates a token per codebook each step:
prompts (B, S, K), steps on (B, K) tokens, logits (B, K, V), generated
tokens (B, n, K). As in the reference, the engine takes tokens only: a
vision prefix goes through ``make_prefill``'s forward, not the engine.

Departures from the reference: PyTorch runs eagerly, so there is no
``jit`` (each decode step launches its operations from Python); the
cache is updated in place; the engine's cache lives on ``device``, the
card unless the caller asks for the CPU. Greedy decoding is exact argmax
(ties to the lowest index, as ``jnp.argmax``). Temperature sampling
draws from an explicit ``torch.Generator``; its draws do not equal
``jax.random.categorical``'s (``repro_torch.prng`` has the reference's
threefry stream but no ``categorical``).
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
        """Feed prompt tokens (B, S_prompt) (audio: (B, S_prompt, K))
        through decode, one position at a time; returns the logits (B, V)
        (audio: (B, K, V)) after the last one."""
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
        ``feed`` returned) -> (B, num_tokens) token ids (audio:
        (B, num_tokens, K)); greedy picks are the argmax over the last
        axis."""
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        out = []
        logits = first_logits
        for _ in range(num_tokens):
            if logits is None:
                raise ValueError("call feed() first")
            if temperature > 0.0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(
                    probs.reshape(-1, probs.shape[-1]), 1,
                    generator=generator).reshape(probs.shape[:-1])
            else:
                nxt = torch.argmax(logits, dim=-1)
            out.append(nxt)
            logits, self.cache = self._step(self.params, self.cache, nxt,
                                            self.pos)
            self.pos += 1
        return torch.stack(out, dim=1)
