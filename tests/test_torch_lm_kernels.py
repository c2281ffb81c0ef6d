"""The port's RMS-norm and attention entry points against the reference's
Pallas kernels.

On the CPU ``repro_torch.kernels.ops`` runs the plain versions; these are
held against the reference's Pallas kernels in interpret mode (small
blocks, so the grid, the ragged tails and the padding all run, as
tests/test_kernels.py runs them) and against the reference oracles in
``repro.kernels.ref``. Inputs are drawn once with numpy and handed to
both packages. Tolerances:

* f32: both sides keep statistics and accumulators in f32 but sum in
  other orders (the Pallas kernels blockwise, with an online softmax; the
  plain versions in one pass): rmsnorm rtol 1e-5 / atol 1e-6, attention
  rtol 1e-4 / atol 1e-5.
* bf16: the same f32 arithmetic rounded once to bf16 at the end, so two
  sides may land one bf16 step apart: rtol 2^-7 / atol 1e-5.

(``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.swa_attention import swa_attention as jswa  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention, ops, ref, rmsnorm, swa_attention,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NORM_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
            "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}
ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
            "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}


def _pair(shape, dtype, rng):
    """One numpy draw as a JAX array and a torch tensor of ``dtype``;
    both frameworks round f32 -> bf16 to nearest even."""
    a = rng.standard_normal(shape, dtype=np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 128), (130, 32), (1, 8),
                                   (2, 3, 256)])
def test_rmsnorm_matches_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(shape, dtype, rng)
    js, ts = _pair(shape[-1:], dtype, rng)
    got = ops.rmsnorm(tx, ts, eps=1e-5)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    pallas = jops.rmsnorm(jx, js, eps=1e-5, block_rows=32)
    np.testing.assert_allclose(_np(got), _np(pallas), **NORM_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jref.rmsnorm_ref(jx, js)),
                               **NORM_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Sq,Sk,window", [
    (64, 64, 0), (40, 40, 0), (24, 40, 0), (1, 40, 0), (40, 40, 16),
    (24, 40, 8)])
def test_flash_attention_matches_reference(Sq, Sk, window, dtype):
    """Causal, with the diagonal right-aligned when Sq < Sk."""
    rng = np.random.default_rng(1000 * Sq + Sk + window)
    jq, tq = _pair((2, Sq, 32), dtype, rng)
    jk, tk = _pair((2, Sk, 32), dtype, rng)
    jv, tv = _pair((2, Sk, 32), dtype, rng)
    got = ops.flash_attention(tq, tk, tv, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    pallas = jops.flash_attention(jq, jk, jv, window=window, block_q=16,
                                  block_k=16)
    oracle = jref.flash_attention_ref(jq, jk, jv, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), **ATTN_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **ATTN_TOL[dtype])


@pytest.mark.parametrize("Sq,Sk,window", [(40, 40, 0), (24, 40, 0),
                                          (24, 40, 12)])
def test_noncausal_ragged_keys_match_the_oracle(Sq, Sk, window):
    """ROADMAP C1: with causal=False and a ragged Sk the Pallas kernel lets
    its zero-padded keys into the softmax; the port masks them, so it is
    held against the oracle, which the Pallas output misses."""
    rng = np.random.default_rng(Sq + Sk)
    jq, tq = _pair((2, Sq, 32), "float32", rng)
    jk, tk = _pair((2, Sk, 32), "float32", rng)
    jv, tv = _pair((2, Sk, 32), "float32", rng)
    got = ops.flash_attention(tq, tk, tv, causal=False, window=window)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=False,
                                      window=window)
    np.testing.assert_allclose(_np(got), _np(oracle), **ATTN_TOL["float32"])
    if window == 0:
        pallas = jops.flash_attention(jq, jk, jv, causal=False, block_q=16,
                                      block_k=32)
        assert np.abs(_np(pallas) - _np(oracle)).max() > 1e-2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Sq,Sk,window", [(48, 48, 0), (16, 48, 0),
                                          (48, 48, 16)])
def test_flash_attention_gqa_matches_reference(Sq, Sk, window, dtype):
    rng = np.random.default_rng(Sq + 7 * window)
    B, H, Hkv, d = 2, 8, 2, 32
    jq, tq = _pair((B, Sq, H, d), dtype, rng)
    jk, tk = _pair((B, Sk, Hkv, d), dtype, rng)
    jv, tv = _pair((B, Sk, Hkv, d), dtype, rng)
    got = ops.flash_attention_gqa(tq, tk, tv, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    pallas = jops.flash_attention_gqa(jq, jk, jv, window=window, block_q=16,
                                      block_k=16)
    np.testing.assert_allclose(_np(got), _np(pallas), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,w", [(64, 16), (32, 16), (32, 32)])
def test_swa_attention_matches_reference(S, w, dtype):
    """(B, S, d) against the banded Pallas kernel and the oracle with the
    window."""
    rng = np.random.default_rng(S + w)
    jq, tq = _pair((2, S, 32), dtype, rng)
    jk, tk = _pair((2, S, 32), dtype, rng)
    jv, tv = _pair((2, S, 32), dtype, rng)
    got = ops.swa_attention(tq, tk, tv, window=w)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(jswa(jq, jk, jv, window=w)),
                               **ATTN_TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _np(jref.flash_attention_ref(jq, jk, jv, window=w)),
        **ATTN_TOL[dtype])


@pytest.mark.parametrize("S,w", [(64, 16), (32, 16)])
def test_swa_attention_gqa_matches_flash_with_window(S, w):
    """The GQA layout the model's banded path hands it, against the
    reference's GQA flash kernel with the same window."""
    rng = np.random.default_rng(S * w)
    B, H, Hkv, d = 1, 4, 2, 32
    jq, tq = _pair((B, S, H, d), "float32", rng)
    jk, tk = _pair((B, S, Hkv, d), "float32", rng)
    jv, tv = _pair((B, S, Hkv, d), "float32", rng)
    got = ops.swa_attention(tq, tk, tv, window=w)
    pallas = jops.flash_attention_gqa(jq, jk, jv, window=w, block_q=16,
                                      block_k=16)
    np.testing.assert_allclose(_np(got), _np(pallas), **ATTN_TOL["float32"])
    torch.testing.assert_close(
        got, ops.flash_attention_gqa(tq, tk, tv, window=w), rtol=0, atol=0)


@pytest.mark.parametrize("S,w", [(40, 16), (8, 16), (32, 0)])
def test_swa_attention_rejects_what_the_reference_rejects(S, w):
    t = torch.zeros((1, S, 32))
    with pytest.raises(ValueError, match="multiple of the window"):
        ops.swa_attention(t, t, t, window=w)


def test_cpu_tensors_run_the_plain_versions_uncounted():
    rng = np.random.default_rng(0)
    _, x = _pair((3, 64), "float32", rng)
    _, s = _pair((64,), "float32", rng)
    _, q = _pair((1, 32, 4, 32), "float32", rng)
    _, k = _pair((1, 32, 2, 32), "float32", rng)
    ops.reset_launches()
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    assert torch.equal(ops.flash_attention_gqa(q, k, k),
                       ref.flash_attention_gqa_ref(q, k, k))
    assert torch.equal(ops.swa_attention(q, k, k, window=16),
                       ref.swa_attention_ref(q, k, k, window=16))
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    assert {"rmsnorm", "flash_attention", "swa_attention"} <= set(
        ops.LAUNCHES)


def test_kernels_need_a_card():
    """Without a card the CUDA wrappers refuse CPU tensors and the
    libraries refuse to load: nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the CPU-only path")
    from repro_torch.kernels import _build
    for name in ("rmsnorm", "attention"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.library(name)
    x, t = torch.zeros((2, 64)), torch.zeros((1, 32, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm.rmsnorm(x, torch.ones(64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_gqa(t, t, t)
    with pytest.raises(ValueError, match="CUDA"):
        swa_attention.swa_attention(t, t, t, window=16)
