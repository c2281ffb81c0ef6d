"""Threefry2x32 counter-based random numbers, equal bit for bit to
``jax.random`` with ``jax_threefry_partitionable`` on (the default since
jax 0.5) and 64-bit types off (jax's default).

A key is an integer tensor of shape ``(2,)``, or ``(..., 2)`` for a batch
of keys, holding the two 32-bit words of jax's raw ``uint32`` key.
Functions given a batch of keys return one result per key, with the
batch shape leading. Every function takes the ``device`` it computes and
returns on, the card unless the caller asks for the CPU; keys may come
from either.

The cipher runs in ``int64`` lanes masked to 32 bits, so the same code
runs on the CPU and on the card (PyTorch has little ``uint32``
arithmetic on CUDA). Counters are the flat index of each output element
as (hi, lo) words, as jax's ``iota_2x32_shape`` gives them, and 32 bits
of output are the XOR of the cipher's two output words.

Exactness: ``key``, ``split``, ``fold_in``, ``random_bits``, ``uniform``,
``randint``, ``bernoulli`` and ``permutation`` are bit for bit.
``normal`` is ``sqrt(2) * erfinv(u)`` with XLA's single-precision
``ErfInv`` polynomial copied here; its ``log1p`` and ``sqrt`` are
PyTorch's, and XLA fuses the polynomial's steps into multiply-adds, so
about 5% of the values differ from jax's in the last bit or two (at most
2.4e-7 in 600,000 draws on the CPU); ``normal`` is held to
``NORMAL_TOL``, absolute per unit of ``max(1, |z|)``, not to the bit.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

# |normal - jax.random.normal| <= NORMAL_TOL * max(1, |z|), elementwise
NORMAL_TOL = 1e-6

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block cipher of jax's
    ``_threefry2x32_lowering``: key words ``(k1, k2)``, counter words
    ``(x1, x2)``, all int64 tensors of values below 2**32 that broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _key_words(key, device, ndim: int):
    """A key (or batch of keys) on ``device`` as two int64 word tensors
    shaped ``(*batch, 1, ..., 1)`` (``ndim`` ones), to broadcast against counters of rank
    ``ndim``."""
    key = torch.as_tensor(key).to(device=device, dtype=torch.int64)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has 2 words in its last axis, got shape "
                         f"{tuple(key.shape)}")
    lead = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(lead), key[..., 1].reshape(lead)


def _blocks(key, shape: Tuple[int, ...], device):
    """Both cipher words for counters 0..n-1 laid out in ``shape``."""
    n = math.prod(shape)
    if n >= 2 ** 63:
        raise NotImplementedError("more than 2**63 counters")
    k1, k2 = _key_words(key, device, len(shape))
    lo = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return threefry2x32(k1, k2, lo >> 32, lo & _M32)


def key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: jax narrows the seed to 32 bits when
    64-bit types are off, so the key is ``(0, seed mod 2**32)``."""
    seed = int(np.int64(seed))          # OverflowError beyond 64 bits
    return torch.tensor([0, seed & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def split(key, num: int = 2, device="cuda") -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(*batch, num, 2)`` keys."""
    b1, b2 = _blocks(key, (int(num),), resolve_device(device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data, device="cuda") -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the cipher of the counter pair
    ``threefry_seed(uint32(data)) = (0, data)``. ``data`` is an int, or a
    sequence of ints that broadcasts against the key batch (one key
    folded with n values gives n keys, as n calls would)."""
    dev = resolve_device(device)
    k1, k2 = _key_words(key, dev, 0)
    d = torch.as_tensor(np.asarray(data, np.int64), device=dev) & _M32
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key, shape: Shape, device="cuda") -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``), as int64
    values in [0, 2**32)."""
    b1, b2 = _blocks(key, _shape(shape), resolve_device(device))
    return b1 ^ b2


def uniform(key, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, device="cuda") -> torch.Tensor:
    """f32 uniforms in [minval, maxval) (``jax.random.uniform``): 23
    random mantissa bits under the exponent of 1.0, minus 1, scaled,
    then clamped below at ``minval``."""
    dev = resolve_device(device)
    bits = random_bits(key, shape, dev)
    one_two = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(
        torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=dev)
    hi = torch.tensor(maxval, dtype=torch.float32, device=dev)
    floats = one_two - torch.tensor(1.0, dtype=torch.float32, device=dev)
    # XLA fuses ``floats * (hi - lo) + lo`` into one multiply-add rounded
    # once. When hi - lo (in f32) is a power of two, as for [0, 1) and
    # the normals' [nextafter(-1, 0), 1), the f32 product is exact and
    # the add rounds once: the same bits, in f32. Otherwise the product
    # of two f32 values is exact in f64
    span = np.float32(maxval) - np.float32(minval)
    if span > 0 and np.frexp(span)[0] == 0.5:
        scaled = floats * (hi - lo) + lo
    else:
        scaled = (floats.double() * (hi - lo).double()
                  + lo.double()).float()
    return torch.maximum(lo, scaled)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for a, b below 2**32, without int64 overflow."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def randint(key, shape: Shape, minval: int, maxval: int,
            device="cuda") -> torch.Tensor:
    """int32 integers in [minval, maxval) (``jax.random.randint``): two
    32-bit draws combined modulo the span, jax's slightly biased
    double-width remainder, with its clipping of the bounds to int32."""
    dev = resolve_device(device)
    i32_min, i32_max = -2 ** 31, 2 ** 31 - 1
    lo = min(max(int(minval), i32_min), i32_max)
    hi = min(max(int(maxval), i32_min), i32_max)
    span = (hi - lo) & _M32
    if hi <= lo:
        span = 1
    elif int(maxval) > i32_max:
        span = (span + 1) & _M32

    def rem(x, n):
        return x if n == 0 else x % n       # XLA: x mod 0 is x

    k = split(key, 2, dev)
    higher = random_bits(k[..., 0, :], shape, dev)
    lower = random_bits(k[..., 1, :], shape, dev)
    mult = rem((rem(2 ** 16, span) ** 2) & _M32, span)
    off = rem((_mul32(rem(higher, span), mult) + rem(lower, span)) & _M32,
              span)
    out = (lo + off + 2 ** 31) % 2 ** 32 - 2 ** 31   # int32 wraparound
    return out.to(torch.int32)


def bernoulli(key, p: float = 0.5, shape: Shape = (),
              device="cuda") -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p``."""
    dev = resolve_device(device)
    return uniform(key, shape, device=dev) < torch.tensor(
        p, dtype=torch.float32, device=dev)


def permutation(key, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for one key: ``arange(n)``
    shuffled by ``ceil(3 ln n / ln(2**32 - 1))`` rounds of a stable sort
    on fresh 32-bit keys (one round for n <= 1625), each round's keys from
    a split of the key. Returns int64 indices."""
    dev = resolve_device(device)
    key = torch.as_tensor(key)
    if key.shape != (2,):
        raise ValueError(f"permutation takes one (2,) key, got shape "
                         f"{tuple(key.shape)}")
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        key, sub = split(key, 2, dev)
        order = torch.sort(random_bits(sub, (n,), dev), stable=True).indices
        x = x[order]
    return x


# XLA's ErfInv for f32 (Giles' approximation): one polynomial in
# w - 2.5 for w = -log1p(-x^2) < 5, another in sqrt(w) - 3 beyond
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``ErfInv``, operation for operation."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = torch.where(small, cs, cl) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape: Shape = (), device="cuda") -> torch.Tensor:
    """Standard f32 normals (``jax.random.normal``): ``sqrt(2) *
    erfinv(u)`` for ``u`` uniform in ``[nextafter(-1, 0), 1)``; within
    ``NORMAL_TOL`` of jax's (see the module docstring)."""
    dev = resolve_device(device)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, dev)
    return torch.tensor(np.sqrt(2), dtype=torch.float32,
                        device=dev) * erfinv_f32(u)
