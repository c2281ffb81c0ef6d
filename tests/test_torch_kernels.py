"""The port's squared-distance kernels against the reference's Pallas
kernels.

On the CPU the port's entry points (``repro_torch.kernels.ops``) run
their plain versions; these are held against the reference's Pallas
kernels run in interpret mode (as tests/test_kernels.py runs them, with
small blocks so the grid, the ragged tail and the ``block_m`` fallback
all run) and against the reference oracle ``ref.sqdist_ref``. Both sides
accumulate in f32 in different orders: rtol 1e-5, atol 1e-6.
(``tests/test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the card.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref, sqdist  # noqa: E402

SHAPES = [(1, 1), (3, 7), (8, 256), (5, 1000), (17, 515), (3, 18_749)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(m, n, dtype, seed=0):
    """The same (m, n) plane and (n,) row for both packages, drawn with
    numpy; both frameworks round f32 -> bf16 to nearest even, which the
    bitwise check below confirms."""
    rng = np.random.default_rng(seed + 1000 * m + n)
    X = rng.standard_normal((m, n), dtype=np.float32)
    r = rng.standard_normal((n,), dtype=np.float32)
    jdt, tdt = DTYPES[dtype]
    jX, jr = jnp.asarray(X, jdt), jnp.asarray(r, jdt)
    tX, tr = torch.from_numpy(X).to(tdt), torch.from_numpy(r).to(tdt)
    np.testing.assert_array_equal(np.asarray(jX.astype(jnp.float32)),
                                  tX.float().numpy())
    return jX, jr, tX, tr


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n", SHAPES)
def test_sqdist_rows_matches_reference(m, n, dtype):
    jX, jr, tX, tr = _inputs(m, n, dtype)
    got = ops.sqdist_rows(tX, tr)
    assert got.shape == (m,) and got.dtype == torch.float32
    pallas = np.asarray(jops.sqdist_rows(jX, jr, block_m=4, block=256))
    oracle = np.asarray(jax.vmap(lambda x: jref.sqdist_ref(x, jr))(jX))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n", SHAPES)
def test_sqdist_matches_reference(m, n, dtype):
    """The scalar entry over flattened (m, n) inputs."""
    jX, jr, tX, _ = _inputs(m, n, dtype)
    jR = jnp.broadcast_to(jr, jX.shape)
    tR = torch.from_numpy(np.array(jR.astype(jnp.float32))).to(tX.dtype)
    got = ops.sqdist(tX, tR)
    assert got.shape == () and got.dtype == torch.float32
    pallas = float(jops.sqdist(jX, jR, block=256))
    oracle = float(jref.sqdist_ref(jX, jR))
    np.testing.assert_allclose(float(got), pallas, **TOL)
    np.testing.assert_allclose(float(got), oracle, **TOL)


def test_cpu_tensors_run_the_plain_version_uncounted():
    _, _, tX, tr = _inputs(5, 1000, "float32")
    ops.reset_launches()
    got = ops.sqdist_rows(tX, tr)
    one = ops.sqdist(tX[2], tr)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    assert {"sqdist_rows", "sqdist"} <= set(ops.LAUNCHES)
    assert torch.equal(got, ref.sqdist_rows_ref(tX, tr))
    assert torch.equal(one, ref.sqdist_ref(tX[2], tr))


def test_kernel_needs_a_card():
    """Without a card, asking for the kernel raises, and so does handing
    the CUDA wrapper a CPU tensor: nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the CPU-only path")
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.library("sqdist")
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.build_all()
    _, _, tX, tr = _inputs(3, 7, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        sqdist.sqdist_rows(tX, tr)


@pytest.mark.parametrize("m,P", [(1, 1), (1, 1_199_882), (7, 515),
                                 (100, 1_199_882), (200, 1_199_882),
                                 (70_000, 3)])
def test_num_splits_covers_the_row(m, P):
    """Pass 1's column splits: every column in exactly one split, no empty
    split, within the grid limit, and enough blocks to fill the card
    whenever the row is long enough to share out."""
    S = sqdist.num_splits(m, P, sms=132)
    seg = -(-P // S)
    S = -(-P // seg)
    assert 1 <= S <= 65535
    assert (S - 1) * seg < P <= S * seg
    assert seg <= sqdist._MAX_SEG or S == 65535
    if m * -(-P // sqdist._MIN_SEG) >= 4 * 132 * 8:
        assert m * S >= 132 * 8


def test_library_name_tracks_the_source():
    """The built library's name hashes the source and flags, so an edited
    kernel is rebuilt rather than a stale one loaded."""
    path = _build.library_path("sqdist")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("sqdist-") and path.suffix == ".so"
    assert path == _build.library_path("sqdist")
