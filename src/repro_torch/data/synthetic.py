"""Synthetic data sources on the device — the counterpart of
``repro.data.synthetic``.

* ``SyntheticMNIST`` — an MNIST-like 10-class image task: class templates
  (smooth random patterns) + per-sample noise and random shifts.
* ``GraphicalModelStream`` — the paper's concept-drift source (App. A.3):
  binary labels from a random linear-Gaussian graphical model over R^50;
  a drift resamples the model, at random with probability p per round
  (``maybe_drift``) or on demand (``force_drift``).
* ``DeepDriveStream`` — front-camera-like frames (procedural road curves)
  and steering targets for the deep-driving case study; a drift changes
  the curvature statistics.

Every concept — the class templates, the graphical model's ``W`` and
``w``, the road's ``curvature_scale`` — and every drift decision comes
from ``np.random.RandomState(seed)`` exactly as in the reference, so they
are equal bit for bit. The per-sample draws come from a
``torch.Generator`` on the device (``sample(generator, batch, lead=...)``
draws ``(*lead, batch, ...)`` at once) and do not match the reference's
``jax.random`` draws; parity tests feed the reference's own batches
instead.

``TokenStream`` — the bigram Markov chain of LM training: its logits are
``np.random.RandomState(seed).randn(V, V) * temp`` in f32, bit for bit,
and ``force_drift`` draws the next ones. Its tokens come from
``repro_torch.prng`` with the reference's keys and its ``categorical``
(``argmax(gumbel + logits)``, gumbel = ``-log(-log(u))``), so they are
the reference's tokens where PyTorch's ``log`` gives XLA's bits
(``tests/test_torch_lm_train.py`` reports any draw that differs). The
chain holds V^2 logits on the host and the device: 537 MB in f64 on the
host at fleet-llm-100m's V = 8,192, and 131.6 GB at llama3-8b's 128,256,
which no host holds (the reference's fault too, ROADMAP); a launcher at
that vocabulary draws uniform tokens instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device


class SyntheticMNIST:
    """10-class images from class templates + noise + translation."""

    def __init__(self, seed: int = 0, num_classes: int = 10,
                 image_size: int = 28, noise: float = 0.35, device="cuda"):
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.image_size = image_size
        self.noise = noise
        rng = np.random.RandomState(seed)
        # smooth class templates: random low-frequency patterns
        freqs = rng.randn(num_classes, 4, 4)
        t = np.linspace(0, 2 * np.pi, image_size)
        basis = np.stack([np.sin((i + 1) * t / 2) for i in range(4)])  # (4,S)
        self.templates = np.einsum("cij,ih,jw->chw", freqs, basis, basis)
        self.templates /= np.abs(self.templates).max(axis=(1, 2), keepdims=True)
        self._templates_dev = torch.as_tensor(
            self.templates, dtype=torch.float32, device=self.device)

    def sample(self, generator: torch.Generator, batch: int,
               lead: tuple = ()):
        """A batch ``{"x": (*lead, B, H, W, 1) f32, "y": (*lead, B)
        int64}`` drawn from ``generator`` (on this source's device): each
        image is its class template rolled by a shift in [-2, 2] along
        both axes, plus Gaussian noise."""
        shape = (*lead, batch)
        n = int(np.prod(shape))
        S = self.image_size
        dev = self.device
        labels = torch.randint(0, self.num_classes, (n,), generator=generator,
                               device=dev)
        shift = torch.randint(-2, 3, (n, 2), generator=generator, device=dev)
        ar = torch.arange(S, device=dev)
        # roll by s: out[h, w] = template[(h - s0) % S, (w - s1) % S]
        rows = (ar[None, :] - shift[:, :1]) % S                      # (n, S)
        cols = (ar[None, :] - shift[:, 1:]) % S
        temps = self._templates_dev[labels[:, None, None], rows[:, :, None],
                                    cols[:, None, :]]
        noise = torch.randn((n, S, S), generator=generator, device=dev)
        imgs = temps + self.noise * noise
        return {"x": imgs.reshape(*shape, S, S, 1),
                "y": labels.reshape(shape)}


class GraphicalModelStream:
    """Random linear-Gaussian graphical model over R^d, binary labels.

    A concept is (W, w): latent h ~ N(0, I_k), x = W h + noise,
    y = [w . h > 0]. ``maybe_drift`` resamples the concept with
    probability ``drift_prob``."""

    def __init__(self, seed: int = 0, d: int = 50, k: int = 10,
                 drift_prob: float = 0.001, device="cuda"):
        self.device = resolve_device(device)
        self.d, self.k = d, k
        self.drift_prob = drift_prob
        self._rng = np.random.RandomState(seed)
        self._resample()
        self.drift_count = 0

    def _resample(self):
        W = self._rng.randn(self.d, self.k) / np.sqrt(self.k)
        w = self._rng.randn(self.k)
        self.W = torch.as_tensor(W.astype(np.float32), device=self.device)
        self.w = torch.as_tensor(w.astype(np.float32), device=self.device)

    def maybe_drift(self) -> bool:
        if self._rng.rand() < self.drift_prob:
            self._resample()
            self.drift_count += 1
            return True
        return False

    def force_drift(self):
        self._resample()
        self.drift_count += 1

    def sample(self, generator: torch.Generator, batch: int,
               lead: tuple = ()):
        """``{"x": (*lead, B, d) f32, "y": (*lead, B) int64}``."""
        shape = (*lead, batch)
        h = torch.randn((*shape, self.k), generator=generator,
                        device=self.device)
        noise = torch.randn((*shape, self.d), generator=generator,
                            device=self.device)
        x = h @ self.W.T + 0.1 * noise
        return {"x": x, "y": (h @ self.w > 0).long()}


class DeepDriveStream:
    """Procedural road frames -> steering angle (deep-driving case study).

    A road is a quadratic curve rendered as bright pixels on a dark
    background from a forward-looking viewpoint; the target steering
    angle steers against the curvature ahead and the offset. A drift
    draws a new ``curvature_scale`` (a new country's roads)."""

    def __init__(self, seed: int = 0, height: int = 68, width: int = 320,
                 curvature_scale: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        self.h, self.w = height, width
        self._rng = np.random.RandomState(seed)
        self.curvature_scale = curvature_scale

    def force_drift(self):
        self.curvature_scale = float(self._rng.uniform(0.5, 2.0))

    def sample(self, generator: torch.Generator, batch: int,
               lead: tuple = ()):
        """``{"x": (*lead, B, H, W, 3) f32, "y": (*lead, B) f32}``."""
        shape = (*lead, batch)
        n = int(np.prod(shape))
        dev = self.device
        curv = self.curvature_scale * torch.randn(
            (n,), generator=generator, device=dev) * 0.3
        offset = 0.2 * torch.randn((n,), generator=generator, device=dev)
        ys = torch.linspace(1.0, 0.0, self.h, device=dev)     # depth rows
        xs = torch.linspace(-1.0, 1.0, self.w, device=dev)
        center = offset[:, None] + curv[:, None] * (1.0 - ys) ** 2  # (n, H)
        halfw = 0.08 + 0.5 * ys                 # the road widens nearby
        img = torch.exp(-torch.square(
            (xs[None, None, :] - center[:, :, None]) / halfw[None, :, None]))
        img += 0.05 * torch.randn(img.shape, generator=generator, device=dev)
        rgb = torch.stack([img, img * 0.8, img * 0.6], dim=-1)
        steering = -2.0 * curv - 0.5 * offset
        return {"x": rgb.reshape(*shape, self.h, self.w, 3),
                "y": steering.reshape(shape)}


class TokenStream:
    """Bigram Markov token stream for LM training; a drift resamples the
    chain. ``sample(key, batch, seq_len)`` takes a ``prng`` key (the
    reference's ``jax.random`` key, bit for bit) and returns ``{"tokens":
    (B, S), "labels": (B, S)}`` int64 on this stream's device: chain b
    starts at a uniform token, ``labels`` are the chain's next S tokens
    and ``tokens`` the chain's first S (``tokens[:, 1:] ==
    labels[:, :-1]``)."""

    def __init__(self, seed: int = 0, vocab: int = 512, temp: float = 1.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.vocab = vocab
        self._rng = np.random.RandomState(seed)
        self.temp = temp
        self._resample()

    def _resample(self):
        logits = self._rng.randn(self.vocab, self.vocab) * self.temp
        self.logits = torch.as_tensor(logits.astype(np.float32),
                                      device=self.device)

    def force_drift(self):
        self._resample()

    def concept(self) -> torch.Tensor:
        return self.logits

    def sample_from(self, concept: torch.Tensor, key, batch: int,
                    seq_len: int) -> dict:
        """The reference's ``vmap(chain)`` over ``split(key, batch)``: the
        B chains run together, one position at a time. Every position's
        gumbel noise is drawn at once, ``(B, S, V)`` f32, from the keys
        ``split(k, seq_len)`` that the reference's ``scan`` walks."""
        dev, V = self.device, self.vocab
        keys = prng.split(key, batch, dev)                    # (B, 2)
        pair = prng.split(keys, 2, dev)                       # (B, 2, 2)
        first = prng.randint(pair[:, 0], (), 0, V, dev).long()  # (B,)
        steps = prng.split(pair[:, 1], seq_len, dev)          # (B, S, 2)
        tiny = float(np.finfo(np.float32).tiny)
        u = prng.uniform(steps, (V,), tiny, 1.0, dev)         # (B, S, V)
        gumbel = -torch.log(-torch.log(u))
        del u
        tok, out = first, []
        for t in range(seq_len):
            tok = torch.argmax(gumbel[:, t] + concept[tok], dim=-1)
            out.append(tok)
        labels = torch.stack(out, dim=1)
        tokens = torch.cat([first[:, None], labels[:, :-1]], dim=1)
        return {"tokens": tokens, "labels": labels}

    def sample(self, key, batch: int, seq_len: int) -> dict:
        return self.sample_from(self.concept(), key, batch, seq_len)
