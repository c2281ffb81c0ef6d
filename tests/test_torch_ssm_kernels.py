"""The port's SSD scan entry point against the reference's Pallas kernel.

On the CPU ``repro_torch.kernels.ops.ssd_scan`` pads S to a chunk
multiple and runs the plain version, the sequential recurrence
``ref.ssd_scan_ref``. It is held against the reference's
``repro.kernels.ops.ssd_scan`` (the chunked Pallas kernel in interpret
mode, as tests/test_kernels.py runs it), against the reference oracle
``repro.kernels.ref.ssd_scan_ref``, and in the model's layout against
``repro.models.mamba._ssd_chunked`` (the jnp SSD the JAX model calls).
Inputs are drawn once with numpy and handed to both packages.

Tolerances are the JAX package's own for this kernel
(tests/test_kernels.py:181-182): rtol and atol 1e-3 in f32, 5e-2 in
bf16 (the chunked and the sequential forms sum and exponentiate in other
orders; in bf16 y is rounded once at the end). Padding is exact.

(``tests/test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the card.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd  # noqa: E402
from repro.models.mamba import _ssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _softplus(v):
    return np.log1p(np.exp(v)).astype(np.float32)


def _inputs(BH, S, P, N, seed, strong=False):
    """numpy draws of x, dt, a, b, c as in tests/test_kernels.py: dt =
    softplus(normal), a = -exp(normal); ``strong`` puts dt * |a| in the
    hundreds, so the decays underflow and exp(cum_i - cum_j) above the
    diagonal would overflow."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P), dtype=np.float32)
    dt = _softplus(rng.standard_normal((BH, S), dtype=np.float32))
    a = -np.exp(rng.standard_normal(BH, dtype=np.float32))
    if strong:
        dt, a = dt * 30 + 5, a * 20
    b = rng.standard_normal((BH, S, N), dtype=np.float32)
    c = rng.standard_normal((BH, S, N), dtype=np.float32)
    return x, dt, a, b, c


def _both(arrays, dtype):
    """(jax arrays, torch tensors): x, dt, b, c in ``dtype``, a in f32."""
    jdt, tdt = DTYPES[dtype]
    x, dt, a, b, c = arrays
    j = [jnp.asarray(v, jdt) for v in (x, dt)] + [jnp.asarray(a)] + [
        jnp.asarray(v, jdt) for v in (b, c)]
    t = [torch.from_numpy(v).to(tdt) for v in (x, dt)] + [
        torch.from_numpy(a)] + [torch.from_numpy(v).to(tdt) for v in (b, c)]
    return j, t


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (100, 32), (8, 8)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_scan_matches_reference(S, chunk, dtype):
    """The sweep of tests/test_kernels.py:167-168, ragged S included."""
    j, t = _both(_inputs(3, S, 8, 4, seed=S + chunk), dtype)
    y, h = ops.ssd_scan(*t, chunk=chunk)
    assert y.shape == (3, S, 8) and y.dtype == t[0].dtype
    assert h.shape == (3, 8, 4) and h.dtype == torch.float32
    yp, hp = jops.ssd_scan(*j, chunk=chunk)
    yr, hr = jref.ssd_scan_ref(*j)
    for want_y, want_h in ((yp, hp), (yr, hr)):
        np.testing.assert_allclose(_np(y), _np(want_y), **TOL[dtype])
        np.testing.assert_allclose(_np(h), _np(want_h), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("BH,S,P,N", [(2, 40, 64, 32), (5, 1, 4, 4),
                                      (4, 64, 16, 128)])
def test_ssd_scan_ref_matches_reference_oracle(BH, S, P, N, dtype):
    """The plain version against the reference's oracle: both are the
    sequential recurrence in f32, in the same order of operations."""
    j, t = _both(_inputs(BH, S, P, N, seed=BH * S + N), dtype)
    y, h = ref.ssd_scan_ref(*t)
    yr, hr = jref.ssd_scan_ref(*j)
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yr), **TOL[dtype])
    np.testing.assert_allclose(_np(h), _np(hr), **TOL[dtype])


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_strong_decay_stays_finite_and_matches(chunk):
    """dt * |a| in the hundreds: the Pallas kernel selects 0 above the
    diagonal after its exp; the port's plain version never forms it."""
    j, t = _both(_inputs(3, 64, 8, 4, seed=chunk, strong=True), "float32")
    y, h = ops.ssd_scan(*t, chunk=chunk)
    yp, hp = jops.ssd_scan(*j, chunk=chunk)
    assert np.isfinite(_np(y)).all() and np.isfinite(_np(h)).all()
    np.testing.assert_allclose(_np(y), _np(yp), **TOL["float32"])
    np.testing.assert_allclose(_np(h), _np(hp), **TOL["float32"])


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_scan_matches_model_mamba_forward(G):
    """As tests/test_kernels.py:188: the port's entry point in the kernel's
    layout against the JAX model's ``_ssd_chunked``; here B and C stay per
    group (H / G heads per row) where that test repeats them."""
    Bb, S, H, P, N = 2, 64, 4, 8, 16
    rng = np.random.default_rng(5 + G)
    xh = rng.standard_normal((Bb, S, H, P), dtype=np.float32)
    dt = _softplus(rng.standard_normal((Bb, S, H), dtype=np.float32))
    A = -np.exp(rng.standard_normal(H, dtype=np.float32))
    B_ = rng.standard_normal((Bb, S, G, N), dtype=np.float32)
    C_ = rng.standard_normal((Bb, S, G, N), dtype=np.float32)
    y_model, h_model = _ssd_chunked(*(jnp.asarray(v) for v in
                                      (xh, dt, A, B_, C_)), chunk=16)
    t = {k: torch.from_numpy(v) for k, v in
         dict(xh=xh, dt=dt, A=A, B=B_, C=C_).items()}
    y, h = ops.ssd_scan(
        t["xh"].permute(0, 2, 1, 3).reshape(Bb * H, S, P),
        t["dt"].permute(0, 2, 1).reshape(Bb * H, S),
        t["A"].repeat(Bb),
        t["B"].permute(0, 2, 1, 3).reshape(Bb * G, S, N),
        t["C"].permute(0, 2, 1, 3).reshape(Bb * G, S, N),
        chunk=16)
    y = y.reshape(Bb, H, S, P).permute(0, 2, 1, 3)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_model),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(h.reshape(Bb, H, P, N).numpy(),
                               np.asarray(h_model), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("S,chunk", [(37, 16), (100, 64), (5, 8)])
def test_padding_to_a_chunk_multiple_is_exact(S, chunk):
    """dt = 0 on the padded steps: exp(0) h + 0 leaves the state's bits
    as they were, and y is sliced back to S."""
    _, t = _both(_inputs(2, S, 8, 4, seed=S), "float32")
    y, h = ops.ssd_scan(*t, chunk=chunk)
    y0, h0 = ref.ssd_scan_ref(*t)
    assert y.shape == y0.shape
    assert torch.equal(y, y0) and torch.equal(h, h0)


def test_kernel_refuses_a_ragged_sequence_as_the_reference_does():
    """The kernel itself needs S % chunk == 0 and raises the reference's
    ValueError (ssd_scan.py:81-84); the shape checks come before the
    device check, so they run here."""
    j, t = _both(_inputs(2, 40, 8, 4, seed=0), "float32")
    with pytest.raises(ValueError, match="chunk multiple") as want:
        jssd(*j, chunk=16)
    with pytest.raises(ValueError, match="chunk multiple") as got:
        ssd_scan.ssd_scan(*t, chunk=16)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan.ssd_scan(*t, chunk=8)
    x, dt, a, b, c = t          # 2 heads cannot share 3 rows of b and c
    with pytest.raises(ValueError, match="R heads per row"):
        ssd_scan.ssd_scan(x, dt, a, b.repeat(2, 1, 1)[:3],
                          c.repeat(2, 1, 1)[:3], chunk=8)
