"""The arithmetic of the tensor-core ``ssd_scan`` program
(``src/repro_torch/kernels/csrc/ssd_scan.cu``), modelled in plain PyTorch
on the CPU and held against the JAX package.

The model repeats the kernel's three passes: C B^T once per (group row,
chunk), shared by the row's R heads; the ordered walk over the chunks
that records the state entering each chunk, then decays the state and
adds (x dt decay)^T B; and the chunk-parallel outputs
y = (C B^T o L)(x dt) + exp(cum) (C h_in^T), with L selected to 0 above
the diagonal before the exp. Every product is split TF32 as the kernel
runs it: hi = v rounded to TF32 to nearest, ties away from zero (on the
f32 bits of a finite value, ``(bits + 0x1000) & ~0x1fff``, what
``cvt.rna.tf32.f32`` gives), lo = v - hi handed over unrounded, which the
tensor cores read as its top 19 bits (truncated, ``bits & ~0x1fff``), and
a b = a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32. The products of
TF32 values are exact in f32, so only the order of the f32 sums differs
from the card. It lives here and not in the package:
``repro_torch.kernels.ref`` keeps the sequential recurrence as the one
plain version.

Tolerances: the JAX package's own for this kernel, ``SSM_TOL``
(tests/test_kernels.py:181-182; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the card to the same), and for the
mamba2-2.7b smoke config's logits ``chip_smoke.py``'s ``AGREE_TOL``. One
case shows why the products are split: the same passes with every operand
rounded once to TF32 break ``SSM_TOL``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import _build, ssd_scan  # noqa: E402
from repro_torch.models import mamba, model  # noqa: E402

SSM_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
AGREE_TOL = dict(rtol=1e-4, atol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(v):
    return v.contiguous().view(torch.int32)


def tf32_rna(v):
    """v rounded to TF32, to nearest with ties away from zero."""
    return ((_bits(v) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(v):
    """v as the tensor cores read an unrounded TF32 operand."""
    return (_bits(v) & ~0x1FFF).view(torch.float32)


def product(a, b, *, split=True):
    """a @ b as the kernel's mma computes it: split TF32 (three products,
    the small ones first), or with ``split=False`` one TF32 product."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if not split:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def pass_model(x, dt, a, b, c, *, chunk, split=True):
    """x (BH, S, P), dt (BH, S), a (BH,), b, c (BH / R, S, N), S a chunk
    multiple -> (y (BH, S, P) in x's dtype, h (BH, P, N) f32, and the
    states entering each chunk (BH, S / chunk, P, N)), by the kernel's
    three passes."""
    BH, S, P = x.shape
    rows, _, N = b.shape
    R, nc, Q = BH // rows, S // chunk, chunk
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    bq = bf.reshape(rows, nc, Q, N)
    cq = cf.reshape(rows, nc, Q, N)
    # pass 1: C B^T per (group row, chunk)
    cbt = product(cq, bq.transpose(-1, -2), split=split)     # (rows, nc, Q, Q)
    # cum = cumsum(dt a) inside each chunk
    dq = dtf.reshape(BH, nc, Q)
    cum = torch.cumsum(dq * a.float()[:, None, None], dim=-1)
    last = cum[..., -1]                                       # (BH, nc)
    decay = torch.exp(last[..., None] - cum)                  # (BH, nc, Q)
    xq = xf.reshape(BH, nc, Q, P)
    head_rows = torch.arange(BH) // R
    # pass 2: the ordered state walk
    h = torch.zeros((BH, P, N))
    entering = []
    for k in range(nc):
        entering.append(h)
        w = xq[:, k] * dq[:, k, :, None] * decay[:, k, :, None]   # (BH, Q, P)
        h = torch.exp(last[:, k])[:, None, None] * h + product(
            w.transpose(-1, -2), bq[head_rows, k], split=split)
    states = torch.stack(entering, dim=1)                     # (BH, nc, P, N)
    # pass 3: the outputs, chunk by chunk in parallel
    i = torch.arange(Q)
    keep = i[None, :] <= i[:, None]                           # j <= i
    seg = torch.where(keep, cum[..., :, None] - cum[..., None, :], 0.0)
    M = torch.where(keep, cbt[head_rows] * torch.exp(seg), 0.0)
    xdt = xq * dq[..., None]
    yd = product(M, xdt, split=split)
    yo = product(cq[head_rows], states.transpose(-1, -2), split=split)
    y = yd + torch.exp(cum)[..., None] * yo
    return y.reshape(BH, S, P).to(x.dtype), h, states


def padded_model(x, dt, a, b, c, *, chunk, split=True):
    """``ops.ssd_scan``'s padding around the pass model."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    y, h, _ = pass_model(x, dt, a, b, c, chunk=chunk, split=split)
    return y[:, :S], h


def _softplus(v):
    return np.log1p(np.exp(v)).astype(np.float32)


def _inputs(BH, S, P, N, seed, R=1, strong=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P), dtype=np.float32)
    dt = _softplus(rng.standard_normal((BH, S), dtype=np.float32))
    a = -np.exp(rng.standard_normal(BH, dtype=np.float32))
    if strong:      # dt |a| in the hundreds: decays underflow, and exp
        dt, a = dt * 30 + 5, a * 20     # above the diagonal would overflow
    b = rng.standard_normal((BH // R, S, N), dtype=np.float32)
    c = rng.standard_normal((BH // R, S, N), dtype=np.float32)
    return x, dt, a, b, c


def _both(arrays, dtype, R):
    """(jax arrays with b, c repeated per head, torch tensors per group)."""
    jdt, tdt = DTYPES[dtype]
    x, dt, a, b, c = arrays
    j = [jnp.asarray(x, jdt), jnp.asarray(dt, jdt), jnp.asarray(a),
         jnp.asarray(np.repeat(b, R, 0), jdt),
         jnp.asarray(np.repeat(c, R, 0), jdt)]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt).to(tdt),
         torch.from_numpy(a), torch.from_numpy(b).to(tdt),
         torch.from_numpy(c).to(tdt)]
    return j, t


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("BH,S,P,N,chunk,R,strong,pallas", [
    (3, 64, 8, 4, 16, 1, False, True),       # tests/test_kernels.py:167
    (3, 100, 8, 4, 32, 1, False, True),      # ragged S
    (3, 8, 8, 4, 8, 1, False, True),
    (3, 37, 8, 4, 8, 1, False, False),       # ragged, chunk 8
    (3, 130, 8, 4, 64, 1, False, False),     # ragged, chunk 64
    (4, 96, 16, 32, 32, 2, False, False),    # two heads per row
    (8, 64, 16, 32, 16, 8, False, False),    # eight heads per row
    (3, 64, 8, 4, 32, 1, True, True),        # strong decay
    (4, 64, 16, 32, 8, 2, True, False),      # strong decay, grouped
])
def test_passes_match_the_reference(BH, S, P, N, chunk, R, strong, pallas,
                                    dtype):
    j, t = _both(_inputs(BH, S, P, N, BH * S + N + chunk, R, strong),
                 dtype, R)
    y, h = padded_model(*t, chunk=chunk)
    assert y.shape == (BH, S, P) and y.dtype == t[0].dtype
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    wants = [jref.ssd_scan_ref(*j)]
    if pallas:
        wants.append(jops.ssd_scan(*j, chunk=chunk))
    for want_y, want_h in wants:
        np.testing.assert_allclose(_np(y), _np(want_y), **SSM_TOL[dtype])
        np.testing.assert_allclose(_np(h), _np(want_h), **SSM_TOL[dtype])


def test_entering_states_are_the_recurrences_states():
    """The state walk's scratch holds, for chunk k, the sequential
    recurrence's state after the k * chunk steps before it."""
    x, dt, a, b, c = _inputs(2, 48, 8, 16, 3)
    _, t = _both((x, dt, a, b, c), "float32", 1)
    _, _, states = pass_model(*t, chunk=16)
    assert not states[:, 0].any()
    for k in (1, 2):
        _, h = jref.ssd_scan_ref(*(jnp.asarray(v[:, :16 * k]) for v in
                                   (x, dt)), jnp.asarray(a),
                                 *(jnp.asarray(v[:, :16 * k]) for v in (b, c)))
        np.testing.assert_allclose(states[:, k].numpy(), _np(h),
                                   rtol=1e-5, atol=1e-5)


def test_mamba_smoke_forward_matches_the_reference(monkeypatch):
    """The mamba2-2.7b smoke config's logits, the port's SSD replaced by
    the pass model, against the JAX package's, within AGREE_TOL."""
    import jax
    jcfg = jget_arch("mamba2-2.7b", smoke=True)
    jparams = jmodel.init_lm_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_arch("mamba2-2.7b", smoke=True)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    calls = []

    def ssd(x, dt, a, b, c, *, chunk):
        calls.append(chunk)
        return padded_model(x, dt, a, b, c, chunk=chunk)
    monkeypatch.setattr(mamba.ops, "ssd_scan", ssd)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 40),
                                              dtype=np.int32)
    got, _ = model.lm_apply(cfg, tparams, torch.from_numpy(toks))
    want, _ = jmodel.lm_apply(jcfg, jparams, jnp.asarray(toks))
    assert calls == [cfg.ssm.chunk_size] * cfg.num_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **AGREE_TOL)


def _misses(got, want, tol):
    return int((np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want))
               .sum())


@pytest.mark.parametrize("BH,S,P,N,chunk", [(3, 64, 8, 4, 16),
                                            (2, 128, 64, 128, 64)])
def test_one_tf32_product_breaks_the_tolerance(BH, S, P, N, chunk):
    """Why every product is split: with each operand rounded once to TF32
    the passes miss the kernel checks' own f32 ``SSM_TOL`` against the
    sequential f32 recurrence, at the tests' small widths and at the
    serving shape's (P = 64, N = 128, chunk 64); split, they hold it."""
    j, t = _both(_inputs(BH, S, P, N, 5), "float32", 1)
    want = _np(jref.ssd_scan_ref(*j)[0])
    once, _ = padded_model(*t, chunk=chunk, split=False)
    split, _ = padded_model(*t, chunk=chunk)
    assert _misses(_np(once), want, SSM_TOL["float32"]) > 0
    assert _misses(_np(split), want, SSM_TOL["float32"]) == 0


def test_model_has_the_kernels_chunks_and_entry():
    """The chunks modelled here are the ones the wrapper and the source
    take, and the source runs the split-TF32 products on the tensor
    cores with the rounding modelled here."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    assert ssd_scan.CHUNKS == (8, 16, 32, 64)
    for q in ssd_scan.CHUNKS:
        assert f"case {q}:" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in src
    assert "0x1000u) & 0xffffe000u" in src
    assert 'extern "C" int repro_ssd_scan(' in src
    assert "repro_ssd_scan" in _build.SIGNATURES["ssd_scan"]
