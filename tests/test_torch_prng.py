"""``repro_torch.prng`` against ``jax.random`` (threefry2x32,
``jax_threefry_partitionable`` on, 64-bit types off), on the CPU.

Bit for bit: ``key``, ``split``, ``fold_in``, ``random_bits``,
``uniform``, ``randint``, ``bernoulli`` and ``permutation``, over several
seeds and shapes, for one key and for a batch of keys (against
``jax.vmap``). ``normal`` within ``prng.NORMAL_TOL`` per unit of
``max(1, |z|)``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.convert import key_from_numpy  # noqa: E402

SEEDS = [0, 1, 7, 123456, 3 ^ 0x5EED]
SHAPES = [(1,), (5,), (3, 7), (2, 3, 4)]


def _pair(seed):
    return jax.random.PRNGKey(seed), prng.key(seed, device="cpu")


def _eq(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, -1, 2 ** 31 - 1, 2 ** 31, -2 ** 31,
                                  2 ** 32 + 5, -2 ** 40, 2 ** 63 - 1,
                                  0 ^ 0x5EED, 12 ^ 0x5EED])
def test_key_matches_prngkey(seed):
    _eq(jax.random.PRNGKey(seed), prng.key(seed, device="cpu"))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in(seed):
    jk, tk = _pair(seed)
    for n in (1, 2, 3, 100):
        _eq(jax.random.split(jk, n), prng.split(tk, n, device="cpu"))
    for data in (0, 1, 5, 2 ** 31 + 3, 2 ** 32 - 1):
        _eq(jax.random.fold_in(jk, data), prng.fold_in(tk, data,
                                                         device="cpu"))
    # a chain: split, then fold in, then split again
    a = jax.random.split(jax.random.fold_in(jax.random.split(jk)[1], 9), 4)
    b = prng.split(prng.fold_in(prng.split(tk, device="cpu")[1], 9,
                                device="cpu"), 4, device="cpu")
    _eq(a, b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    jk, tk = _pair(seed)
    _eq(jax.random.bits(jk, shape), prng.random_bits(tk, shape,
                                                      device="cpu"))
    _eq(jax.random.uniform(jk, shape), prng.uniform(tk, shape, device="cpu"))
    _eq(jax.random.uniform(jk, shape, minval=-2.5, maxval=3.0),
        prng.uniform(tk, shape, -2.5, 3.0, device="cpu"))
    for p in (0.05, 0.5):
        _eq(jax.random.bernoulli(jk, p, shape),
            prng.bernoulli(tk, p, shape, device="cpu"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 10), (-2, 3), (0, 100),
                                   (5, 5), (-2 ** 31, 2 ** 31 - 1),
                                   (0, 2 ** 31 - 1), (-7, 2 ** 20 + 3)])
def test_randint(seed, lo, hi):
    jk, tk = _pair(seed)
    for shape in ((64,), (4, 9)):
        got = prng.randint(tk, shape, lo, hi, device="cpu")
        assert got.dtype == torch.int32
        _eq(jax.random.randint(jk, shape, lo, hi), got)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 30, 100, 1625, 1626, 2000])
def test_permutation(seed, n):
    """One sort round up to n = 1625, two from 1626 (2000 included)."""
    jk, tk = _pair(seed)
    got = prng.permutation(tk, n, device="cpu")
    _eq(jax.random.permutation(jk, n), got)
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_its_tolerance(seed):
    jk, tk = _pair(seed)
    want = np.asarray(jax.random.normal(jk, (50_000,)))
    got = prng.normal(tk, (50_000,), device="cpu").numpy()
    assert got.dtype == np.float32
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= prng.NORMAL_TOL
    # most values are bit-equal; the rest differ in the last bits
    assert (got == want).mean() > 0.9


def test_erfinv_matches_xla_at_the_edges():
    x = np.array([-1.0, -0.9999999, -0.5, 0.0, 1e-30, 0.3, 0.99, 1.0],
                 np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erfinv_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=prng.NORMAL_TOL,
                               atol=0)


def test_batched_keys_match_vmap():
    """A (m, 2) batch of keys gives one result per key, as jax.vmap."""
    jkeys = jax.random.split(jax.random.PRNGKey(5), 6)
    tkeys = key_from_numpy(np.asarray(jkeys), device="cpu")
    _eq(jax.vmap(lambda k: jax.random.fold_in(k, 3))(jkeys),
        prng.fold_in(tkeys, 3, device="cpu"))
    _eq(jax.vmap(lambda k: jax.random.split(k, 4))(jkeys),
        prng.split(tkeys, 4, device="cpu"))
    _eq(jax.vmap(lambda k: jax.random.bits(k, (3, 5)))(jkeys),
        prng.random_bits(tkeys, (3, 5), device="cpu"))
    _eq(jax.vmap(lambda k: jax.random.uniform(k, (7,)))(jkeys),
        prng.uniform(tkeys, (7,), device="cpu"))
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (4, 9)))(jkeys))
    got = prng.normal(tkeys, (4, 9), device="cpu").numpy()
    assert got.shape == want.shape == (6, 4, 9)
    assert (np.abs(got - want) / np.maximum(1, np.abs(want))).max() <= \
        prng.NORMAL_TOL


def test_key_from_numpy_round_trips_the_reference_key():
    jk = jax.random.fold_in(jax.random.PRNGKey(3), 4)
    tk = key_from_numpy(np.asarray(jk), device="cpu")
    assert tk.dtype == torch.int64 and tuple(tk.shape) == (2,)
    _eq(jax.random.split(jk, 3), prng.split(tk, 3, device="cpu"))
    with pytest.raises(ValueError, match="uint32"):
        key_from_numpy(np.zeros((2,), np.float32), device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the CPU-only path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prng.key(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prng.uniform(prng.key(0, device="cpu"), (3,))
