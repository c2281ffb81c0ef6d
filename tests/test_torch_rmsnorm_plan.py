"""The RMS-norm kernel's plan and arithmetic
(``src/repro_torch/kernels/csrc/rmsnorm.cu``), on the CPU.

``rmsnorm.plan(D, dtype)`` picks the kernel's form (one block a row with
2 or 4 16-byte vectors a thread, a block that reads the row twice past
that); the tests hold its invariants and that the source compiles every
form it can pick. A plain model then repeats the
kernel's index arithmetic and summation order for a row that starts at
any element offset: the scalar head up to the row's first 16-byte
boundary, the whole 16-byte vectors each thread keeps, the scalar tail;
each thread's partial sum of squares in its order, the warp butterfly
(xor 16, 8, 4, 2, 1), the block form's sum of the warp sums by warp 0;
then ``1 / sqrt(ss / D + eps)`` and ``x * r * scale``. The partition must
cover every element once, and the model must agree with the JAX
package's Pallas kernel (interpret mode) under the card checks'
tolerances: f32 rtol 1e-5 / atol 1e-6, bf16 rtol 2^-7 / atol 1e-5.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.config import norm_widths  # noqa: E402
from repro_torch.kernels import _build, rmsnorm  # noqa: E402

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _per_vector(dtype):
    return 16 // torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_every_width(dtype):
    """Every D up to MAX_D gets a form whose threads cover the row's whole
    vectors in as few warps as can: the block form with 2 and then 4
    vectors a thread, then the stream form."""
    V = _per_vector(dtype)
    Ds = sorted(set(range(1, 1200)) | set(range(1200, rmsnorm.MAX_D + 1, 97))
                | {rmsnorm.MAX_D} | set(norm_widths()))
    for D in Ds:
        form, vectors, threads = rmsnorm.plan(D, dtype)
        n = D // V
        if form == "block":
            assert vectors in rmsnorm.BLOCK_VECTORS
            assert threads % 32 == 0 and 32 <= threads <= 1024
            assert n <= threads * vectors < max(n, 1) + 32 * vectors
            assert vectors == 2 or n > 1024 * 2
        else:
            assert form == "stream" and (vectors, threads) == (1, 1024)
            assert n > 1024 * rmsnorm.BLOCK_VECTORS[-1]


def test_plan_at_the_zoo_widths():
    """bf16 at every width a full-size config norms: one block a row, 2
    vectors a thread; a row of up to 64 vectors takes one warp."""
    assert set(norm_widths()) >= {1600, 2048, 2560, 3072, 3200, 4096, 5120,
                                  6144, 8192, 16384}
    for d in norm_widths():
        assert rmsnorm.plan(d, torch.bfloat16) == (
            "block", 2, 32 * -(-(d // 8) // 64))
    assert rmsnorm.plan(7, torch.bfloat16) == ("block", 2, 32)
    assert rmsnorm.plan(256, torch.bfloat16) == ("block", 2, 32)
    assert rmsnorm.plan(512, torch.bfloat16) == ("block", 2, 32)
    assert rmsnorm.plan(rmsnorm.MAX_D, torch.float32).form == "stream"


def test_source_compiles_every_form_the_plan_picks():
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    launched = set(re.findall(r"launch<T, (\d+), (\d+)>", src))
    for form, vectors in (("block", 2), ("block", 4), ("stream", 1)):
        assert (str(vectors), str(rmsnorm.FORMS[form])) in launched
    assert "repro_rmsnorm" in _build.SIGNATURES["rmsnorm"]
    # the forward takes the rows of a scale group since the grouped scale
    assert len(_build.SIGNATURES["rmsnorm"]["repro_rmsnorm"][1]) == 12
    assert _build.SOURCES["rmsnorm"] == ("rmsnorm.cu", "rmsnorm_bwd.cu")
    assert 'extern "C" int repro_rmsnorm_bwd(' in (
        _build.CSRC / "rmsnorm_bwd.cu").read_text()


def _butterfly(v):
    """(rows, 32) lanes -> each lane's sum after xor 16, 8, 4, 2, 1."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, lane ^ o]).astype(np.float32)
    return v


def kernel_model(x, scale, eps, offset):
    """x (rows, D) and scale (D,) in f32 or bf16, each row starting
    ``offset`` elements past a 16-byte boundary (scale at the boundary) ->
    (y in x's dtype, how often each element was read)."""
    rows, D = x.shape
    V = _per_vector(x.dtype)
    form, NV, n = rmsnorm.plan(D, x.dtype)
    xf = x.float().numpy()
    sf = scale.float().numpy()
    mis = offset % V
    h = min(D, V - mis if mis else 0)
    nb = (D - h) // V
    tail = h + nb * V
    nt = D - tail
    reads = np.zeros(D, dtype=np.int64)
    ss = np.zeros((rows, n), dtype=np.float32)
    for t in range(n):
        js = (range(t, nb, n) if form == "stream"
              else [t + i * n for i in range(NV) if t + i * n < nb])
        for j in js:
            for e in range(V):
                c = h + j * V + e
                reads[c] += 1
                ss[:, t] = (ss[:, t] + xf[:, c] * xf[:, c]).astype(
                    np.float32)
        for c in ([t] if t < h else []) + ([tail + t] if t < nt else []):
            reads[c] += 1
            ss[:, t] = (ss[:, t] + xf[:, c] * xf[:, c]).astype(np.float32)
    warps = _butterfly(ss.reshape(rows * (n // 32), 32))[:, 0].reshape(
        rows, n // 32)
    lanes = np.zeros((rows, 32), dtype=np.float32)
    lanes[:, :n // 32] = warps
    total = _butterfly(lanes)[:, 0]
    r = (np.float32(1.0) / np.sqrt(
        total / np.float32(D) + np.float32(eps))).astype(np.float32)
    y = (xf * r[:, None]).astype(np.float32) * sf[None, :]
    return torch.from_numpy(y.astype(np.float32)).to(x.dtype), reads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,offset", [(7, 0), (7, 3), (200, 1), (513, 0),
                                      (1601, 0), (1601, 5), (4100, 2),
                                      (8200, 1), (17000, 1)])
def test_model_of_the_kernel_matches_the_reference(D, offset, dtype):
    rng = np.random.default_rng(D + offset)
    xa = rng.standard_normal((3, D), dtype=np.float32)
    sa = rng.standard_normal((D,), dtype=np.float32)
    x, s = torch.from_numpy(xa).to(dtype), torch.from_numpy(sa).to(dtype)
    got, reads = kernel_model(x, s, 1e-5, offset)
    assert (reads == 1).all(), "an element read twice or never"
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = jops.rmsnorm(jnp.asarray(xa).astype(jdt),
                        jnp.asarray(sa).astype(jdt), eps=1e-5, block_rows=8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])
