"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip where no CUDA device is visible. This file
imports no jax, so it runs on a machine with the card and without jax:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports jax.) Both sides accumulate
in f32 in different orders: rtol 1e-5, atol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import ops, ref, sqdist  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(m, n, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000 * m + n)
    X = torch.randn((m, n), generator=gen, device="cuda").to(DTYPES[dtype])
    r = torch.randn((n,), generator=gen, device="cuda").to(DTYPES[dtype])
    return X, r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n", [(1, 1), (3, 7), (17, 515), (7, 1_199_882),
                                 (100, 1_199_882)])
def test_kernel_matches_plain_and_repeats_bitwise(m, n, dtype):
    _need_card()
    X, r = _inputs(m, n, dtype)
    a, b = sqdist.sqdist_rows(X, r), sqdist.sqdist_rows(X, r)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ref.sqdist_rows_ref(X, r), **TOL)
    R = r.expand_as(X).contiguous()
    torch.testing.assert_close(sqdist.sqdist(X, R), ref.sqdist_ref(X, R),
                               **TOL)


@pytest.mark.cuda
def test_ops_counts_kernel_launches_only():
    _need_card()
    X, r = _inputs(5, 1000, "float32")
    ops.reset_launches()
    ops.sqdist_rows(X, r)
    ops.sqdist(X[0], r)
    ops.sqdist_rows(X.cpu(), r.cpu())
    assert ops.LAUNCHES == {"sqdist_rows": 1, "sqdist": 1}


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    X = torch.randn(4, 10, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        sqdist.sqdist_rows(X[:, ::2], torch.randn(5, device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sqdist.sqdist_rows(X.half(), torch.randn(10, device="cuda").half())
    with pytest.raises(ValueError, match=r"\(m, P\)"):
        sqdist.sqdist_rows(X, torch.randn(9, device="cuda"))
    with pytest.raises(ValueError, match="one CUDA device"):
        sqdist.sqdist_rows(X, torch.randn(10))
