"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip where no CUDA device is visible. This file
imports no jax, so it runs on a machine with the card and without jax:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports jax.) For the squared
distances both sides accumulate in f32 in different orders: rtol 1e-5,
atol 1e-6 (odd P included: every odd row then starts 4 bytes off an
8-byte boundary); the LM kernels' tolerances stand above their tests.
``repro_torch.prng`` on the card equals it on the CPU bit for bit,
``normal`` within ``prng.NORMAL_TOL``. On planes holding NaN, ±Inf and
zeroed rows, ``sqdist_rows`` gives NaN and +Inf where its plain version
does (compared with ``equal_nan``); the robust aggregates give the CPU's
bits on the card, and one quarantine round the CPU's integers.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.nn.functional as F  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention, ops, ref, rmsnorm, sqdist, ssd_scan, swa_attention,
)
from repro_torch.kernels._timing import profile_calls  # noqa: E402

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
                                 (100, 1_199_882), (5, 348_219),
                                 (100, 348_219)])
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
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "sqdist_rows": 1, "sqdist": 1}


def _cuda_launches(fn):
    """CUDA launches per call of ``fn`` and the names of the kernels that
    ran, in the order they first ran."""
    prof = profile_calls(fn, 3)
    return prof["cuda_launches_per_call"], list(prof["kernels_us"])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1, 1_199_882), (100, 1_199_882)])
def test_sqdist_is_one_launch_per_call(m, n):
    """The ticket folds the partials' sum into the one kernel: one CUDA
    launch per call, and sqdist's result is a 0-d tensor made without an
    indexing op."""
    _need_card()
    X, r = _inputs(m, n, "float32")
    R = r.expand_as(X).contiguous()
    per_call, names = _cuda_launches(lambda: sqdist.sqdist_rows(X, r))
    assert per_call == 1 and all("sqdist_kernel" in k for k in names)
    per_call, names = _cuda_launches(lambda: sqdist.sqdist(X, R))
    assert per_call == 1 and all("sqdist_kernel" in k for k in names)
    one = sqdist.sqdist(X, R)
    assert one.shape == () and one.dtype == torch.float32
    torch.testing.assert_close(one, ref.sqdist_ref(X, R), **TOL)


@pytest.mark.cuda
def test_sqdist_tickets_reset_across_calls_and_streams():
    """Each call leaves its row counters at 0: many calls of changing
    shapes, on the default stream and on a side stream, all give the bits
    of the first call of the same shape."""
    _need_card()
    X, r = _inputs(7, 300_001, "float32")
    want = sqdist.sqdist_rows(X, r)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for i in range(6):
        with torch.cuda.stream(side if i % 2 else torch.cuda.current_stream()):
            assert torch.equal(sqdist.sqdist_rows(X, r), want)
            sqdist.sqdist_rows(X[:3], r)
    torch.cuda.synchronize()
    assert torch.equal(sqdist.sqdist_rows(X, r), want)


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


def _grouped(g, k, n, dtype="float32", seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed + 7 * g + n)
    X = torch.randn((g * k, n), generator=gen, device="cuda")
    R = torch.randn((g, n), generator=gen, device="cuda")
    return X.to(DTYPES[dtype]), R.to(DTYPES[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1, 1), (17, 515), (10, 348_219),
                                 (100, 1_199_882)])
def test_grouped_sqdist_with_one_group_is_the_ungrouped_call(m, n):
    """g = 1 only offsets the reference by 0: the bits of today's call."""
    _need_card()
    for dtype in DTYPES:
        X, r = _inputs(m, n, dtype)
        assert torch.equal(sqdist.sqdist_rows(X, r[None]),
                           sqdist.sqdist_rows(X, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g,k,n", [(2, 3, 7), (2, 50, 1_199_882),
                                   (10, 10, 1_199_882), (10, 1, 348_219),
                                   (10, 3, 515)])
def test_grouped_sqdist_matches_plain_and_repeats_bitwise(g, k, n, dtype):
    """Every row against its cluster's reference, odd P included, in one
    launch; repeated calls give the same bits."""
    _need_card()
    X, R = _grouped(g, k, n, dtype)
    a, b = sqdist.sqdist_rows(X, R), sqdist.sqdist_rows(X, R)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and a.shape == (g * k,)
    torch.testing.assert_close(a, ref.sqdist_rows_ref(X, R), **TOL)
    for c in range(g):    # the same bits as that cluster's own call
        rows = slice(c * k, (c + 1) * k)
        torch.testing.assert_close(
            a[rows], sqdist.sqdist_rows(X[rows].contiguous(), R[c]), **TOL)


@pytest.mark.cuda
def test_grouped_sqdist_is_one_launch_per_call_and_counted():
    _need_card()
    X, R = _grouped(10, 10, 1_199_882)
    per_call, names = _cuda_launches(lambda: sqdist.sqdist_rows(X, R))
    assert per_call == 1 and all("sqdist_kernel" in k for k in names)
    ops.reset_launches()
    ops.sqdist_rows(X, R)
    ops.sqdist_rows(X.cpu(), R.cpu())
    assert ops.LAUNCHES["sqdist_rows"] == 1
    with pytest.raises(ValueError, match="g dividing m"):
        sqdist.sqdist_rows(X[:99], R)


@pytest.mark.cuda
def test_hierarchical_round_on_the_card_equals_the_cpu():
    """One masked two-tier dynamic round at m = 100, g = 10 on the card and
    on the CPU: the same records, per-link counts, counters and keys, one
    grouped launch for the intra tier and one for the inter tier."""
    _need_card()
    import numpy as np
    from repro_torch.config import (
        HierarchyConfig, NetworkConfig, ProtocolConfig,
    )
    from repro_torch.core.sync import hierarchy
    from repro_torch.device import resolve_device
    from repro_torch.network import availability

    resolve_device("cuda")
    m, g, P = 100, 10, 20_011
    gen = torch.Generator().manual_seed(3)
    base = torch.randn((P,), generator=gen)
    scale = torch.linspace(0.0, 0.4, m)[:, None]
    X = base + scale * torch.randn((m, P), generator=gen) / P ** 0.5
    active = availability.sample(NetworkConfig(act_prob=0.6), m, 5)
    proto = ProtocolConfig(kind="dynamic", b=1, delta=0.05, tiers=(
        HierarchyConfig(num_clusters=g, inter=ProtocolConfig(
            kind="dynamic", b=1, delta=0.02))))
    out = {}
    for dev in ("cpu", "cuda"):
        state = hierarchy.init_hier_state(base.to(dev), proto.tiers, 0)
        ops.reset_launches()
        out[dev] = hierarchy.apply_hierarchical(
            proto, proto.tiers, X.clone().to(dev), state,
            active=active.copy())
    cpu, card = out["cpu"], out["cuda"]
    assert ops.LAUNCHES["sqdist_rows"] == 2
    assert card.rec == cpu.rec and card.rec.syncs == 1
    for a, b in [(card.member_xfers, cpu.member_xfers),
                 (card.member_msgs, cpu.member_msgs),
                 (card.agg_xfers, cpu.agg_xfers),
                 (card.state.intra.v, cpu.state.intra.v)]:
        assert (np.asarray(a) == np.asarray(b)).all()
    assert torch.equal(card.state.intra.key, cpu.state.intra.key)
    torch.testing.assert_close(card.params.cpu(), cpu.params, **TOL)


# ---------------------------------------------------------------------------
# rmsnorm and attention (the decoder LM's kernels). Both sides keep f32
# statistics and accumulators and differ only in summation order: f32
# rmsnorm rtol 1e-5 / atol 1e-6, f32 attention rtol 1e-4 / atol 1e-5;
# bf16 outputs may land one bf16 step apart: rtol 2^-7 / atol 1e-5.
# ---------------------------------------------------------------------------

LM_TOL = {("norm", "float32"): dict(rtol=1e-5, atol=1e-6),
          ("attn", "float32"): dict(rtol=1e-4, atol=1e-5),
          ("norm", "bfloat16"): dict(rtol=2 ** -7, atol=1e-5),
          ("attn", "bfloat16"): dict(rtol=2 ** -7, atol=1e-5)}


def _randn(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(DTYPES[dtype])


def _same_twice(fn, *args, **kw):
    a, b = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 8), (130, 32), (3, 5, 256),
                                   (4, 4096), (2, 7, 14_000)])
def test_rmsnorm_kernel_matches_plain(shape, dtype):
    _need_card()
    x = _randn(shape, dtype, sum(shape))
    s = _randn(shape[-1:], dtype, 1)
    got = _same_twice(rmsnorm.rmsnorm, x, s, 1e-5)
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, s, 1e-5),
                               **LM_TOL["norm", dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window", [
    (2, 64, 64, 1, 1, 32, True, 0), (2, 100, 100, 4, 2, 64, True, 0),
    (1, 24, 130, 8, 2, 128, True, 0), (1, 1, 77, 8, 8, 128, True, 0),
    (2, 96, 96, 4, 1, 128, True, 24), (1, 40, 70, 2, 2, 32, False, 0),
    (1, 70, 70, 2, 1, 64, False, 16), (4, 256, 256, 32, 8, 128, True, 0)])
def test_attention_kernel_matches_plain(B, Sq, Sk, H, Hkv, d, causal, window,
                                        dtype):
    """GQA, ragged Sq < Sk, the window, and the non-causal ragged case
    (ROADMAP C1), all against the plain version."""
    _need_card()
    seed = B + Sq + Sk + H + d + window
    q = _randn((B, Sq, H, d), dtype, seed)
    k = _randn((B, Sk, Hkv, d), dtype, seed + 1)
    v = _randn((B, Sk, Hkv, d), dtype, seed + 2)
    got = _same_twice(flash_attention.flash_attention_gqa, q, k, v,
                      causal=causal, window=window)
    want = ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **LM_TOL["attn", dtype])
    if H == 1:
        flat = flash_attention.flash_attention(
            q[:, :, 0], k[:, :, 0], v[:, :, 0], causal=causal, window=window)
        assert torch.equal(flat, got[:, :, 0])


# the edges of the bf16 tensor-core program (128-row query tiles of two
# 64-row halves, 64-key tiles, TMA zero-fill past Sq and Sk, a 1-D grid):
# ragged Sq and Sk, Sq = 1, Sk = 129, a window of one key tile, head dims
# 32 and 64, and more (batch, head) pairs than the card has SMs
EDGES = [(2, 100, 200, 4, 2, 128, True, 0), (1, 300, 300, 8, 2, 128, True, 0),
         (3, 1, 300, 8, 2, 128, True, 0), (2, 1, 77, 4, 4, 64, False, 0),
         (1, 129, 129, 4, 2, 128, True, 0), (2, 40, 129, 4, 1, 64, False, 0),
         (1, 256, 256, 4, 2, 128, True, 64), (2, 200, 200, 4, 2, 32, True, 0),
         (2, 200, 200, 4, 2, 64, True, 48), (5, 130, 130, 32, 8, 64, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window", EDGES)
def test_attention_program_edges_match_plain(B, Sq, Sk, H, Hkv, d, causal,
                                             window, dtype):
    """bf16 through the wgmma program, f32 through the CUDA-core one, each
    against the plain version and bitwise repeatable."""
    _need_card()
    assert flash_attention.program(DTYPES[dtype]) == {
        "bfloat16": "sm90_wgmma_tma", "float32": "cuda_core_f32"}[dtype]
    seed = 7 * B + Sq + 3 * Sk + H + d + window
    q = _randn((B, Sq, H, d), dtype, seed)
    k = _randn((B, Sk, Hkv, d), dtype, seed + 1)
    v = _randn((B, Sk, Hkv, d), dtype, seed + 2)
    got = _same_twice(flash_attention.flash_attention_gqa, q, k, v,
                      causal=causal, window=window)
    want = ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **LM_TOL["attn", dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,Hkv,w", [(2, 64, 1, 1, 16), (1, 256, 4, 2, 64),
                                         (1, 1024, 8, 2, 256)])
def test_swa_kernel_matches_plain_and_flash_with_window(B, S, H, Hkv, w,
                                                        dtype):
    _need_card()
    q = _randn((B, S, H, 128), dtype, S)
    k = _randn((B, S, Hkv, 128), dtype, S + 1)
    v = _randn((B, S, Hkv, 128), dtype, S + 2)
    got = _same_twice(swa_attention.swa_attention, q, k, v, window=w)
    torch.testing.assert_close(got, ref.swa_attention_ref(q, k, v, window=w),
                               **LM_TOL["attn", dtype])
    assert torch.equal(got, flash_attention.flash_attention_gqa(
        q, k, v, causal=True, window=w))


@pytest.mark.cuda
def test_lm_kernels_count_launches_and_reject_what_they_do_not_take():
    _need_card()
    x = _randn((4, 64), "float32", 0)
    q = _randn((1, 32, 4, 32), "float32", 1)
    kv = _randn((1, 32, 2, 32), "float32", 2)
    ops.reset_launches()
    ops.rmsnorm(x, x[0])
    ops.flash_attention_gqa(q, kv, kv)
    ops.flash_attention(q[:, :, 0].contiguous(), kv[:, :, 0].contiguous(),
                        kv[:, :, 0].contiguous())
    ops.swa_attention(q, kv, kv, window=16)
    ops.rmsnorm(x.cpu(), x[0].cpu())
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0), "rmsnorm": 1,
                            "flash_attention": 2, "swa_attention": 1}
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rmsnorm.rmsnorm(x.half(), x[0].half())
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm.rmsnorm(x[:, ::2], x[0, ::2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q[:, :, 0], kv[:, :, 0], kv[:, :, 0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_attention_gqa(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head dims"):
        flash_attention.flash_attention_gqa(q[..., :16].bfloat16(),
                                            kv[..., :16].bfloat16(),
                                            kv[..., :16].bfloat16())
    with pytest.raises(ValueError, match="head dims"):
        flash_attention.flash_attention_gqa(q[..., :16].contiguous(),
                                            kv[..., :16].contiguous(),
                                            kv[..., :16].contiguous())
    with pytest.raises(ValueError, match="multiple of"):
        flash_attention.flash_attention_gqa(q[:, :, :3].contiguous(), kv, kv)
    with pytest.raises(ValueError, match="multiple of the window"):
        swa_attention.swa_attention(q, kv, kv, window=24)


# ---------------------------------------------------------------------------
# ssd_scan (Mamba2's chunked SSD) against the sequential plain version, at
# the JAX package's own tolerances for this kernel
# (tests/test_kernels.py:181-182): the chunked and sequential forms sum and
# exponentiate in other orders; in bf16 y is rounded once at the end.
# ---------------------------------------------------------------------------

SSD_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _ssd_inputs(BH, S, P, N, dtype, seed, R=1, strong=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, dt, a = rn(BH, S, P), F.softplus(rn(BH, S)), -torch.exp(rn(BH))
    if strong:
        dt, a = dt * 30 + 5, a * 20
    b, c = rn(BH // R, S, N), rn(BH // R, S, N)
    t = DTYPES[dtype]
    return x.to(t), dt.to(t), a, b.to(t), c.to(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("BH,S,P,N,chunk,R,strong", [
    (3, 64, 8, 4, 16, 1, False), (3, 100, 8, 4, 32, 1, False),
    (3, 8, 8, 4, 8, 1, False), (3, 37, 8, 4, 8, 1, False),
    (4, 200, 64, 128, 64, 1, False), (6, 77, 64, 32, 16, 1, False),
    (16, 96, 64, 128, 64, 8, False), (5, 128, 64, 128, 64, 1, True),
    (4, 100, 64, 128, 32, 2, True), (3, 64, 37, 20, 16, 1, False),
    (2, 64, 5, 3, 8, 1, False), (160, 256, 64, 128, 64, 80, False)])
def test_ssd_scan_kernel_matches_plain(BH, S, P, N, chunk, R, strong, dtype):
    """Ragged S through ops.ssd_scan (padded), chunks 8 to 64, grouped B
    and C (R heads per row, up to mamba2-2.7b's 80), strong decay, odd P
    and N (zero-padded tiles); bitwise repeatable."""
    _need_card()
    x, dt, a, b, c = _ssd_inputs(BH, S, P, N, dtype, BH + S + N, R, strong)
    y, h = ops.ssd_scan(x, dt, a, b, c, chunk=chunk)
    y2, h2 = ops.ssd_scan(x, dt, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    yr, hr = ref.ssd_scan_ref(x, dt, a, b.repeat_interleave(R, 0),
                              c.repeat_interleave(R, 0))
    assert y.dtype == x.dtype and h.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y.float(), yr.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(h, hr, **SSD_TOL[dtype])


@pytest.mark.cuda
def test_ssd_scan_counts_launches_and_rejects_what_it_does_not_take():
    _need_card()
    x, dt, a, b, c = _ssd_inputs(2, 32, 8, 4, "float32", 0)
    ops.reset_launches()
    ops.ssd_scan(x, dt, a, b, c, chunk=16)
    ops.ssd_scan(x, dt, a, b, c, chunk=8)
    ops.ssd_scan(x.cpu(), dt.cpu(), a.cpu(), b.cpu(), c.cpu(), chunk=16)
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0), "ssd_scan": 2}
    # one counted call is the program's three CUDA launches
    per_call, names = _cuda_launches(
        lambda: ssd_scan.ssd_scan(x, dt, a, b, c, chunk=16))
    assert per_call == 3
    assert [n.split("::")[-1].split("<")[0] for n in names[:3]] == [
        "ssd_scan_cbt_kernel", "ssd_scan_state_kernel", "ssd_scan_out_kernel"]
    with pytest.raises(ValueError, match="chunk multiple"):
        ssd_scan.ssd_scan(x, dt, a, b, c, chunk=64)
    with pytest.raises(ValueError, match="chunks"):
        ssd_scan.ssd_scan(x, dt, a, b, c, chunk=4)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_scan(x, dt, a.double(), b, c, chunk=8)
    with pytest.raises(TypeError, match="alike"):
        ssd_scan.ssd_scan(x, dt.bfloat16(), a, b, c, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                          dt, a, b, c, chunk=8)
    with pytest.raises(ValueError, match="P <= 64"):
        big = torch.zeros(2, 32, 65, device="cuda")
        ssd_scan.ssd_scan(big, dt, a, b, c, chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 17, 2 ** 31 + 5])
def test_prng_on_the_card_equals_the_cpu(seed):
    _need_card()
    k = prng.key(seed, device="cpu")
    keys = prng.split(k, 50, device="cpu")
    for fn in (lambda d: prng.split(keys, 5, device=d),
               lambda d: prng.fold_in(keys, 7, device=d),
               lambda d: prng.random_bits(k, (33, 1001), device=d),
               lambda d: prng.uniform(keys, (257,), device=d),
               lambda d: prng.uniform(k, (4097,), -3.0, 0.5, device=d),
               lambda d: prng.randint(k, (999,), -5, 12, device=d),
               lambda d: prng.bernoulli(k, 0.3, (999,), device=d),
               lambda d: prng.permutation(keys[1], 100, device=d),
               lambda d: prng.permutation(keys[2], 2000, device=d)):
        got, want = fn("cuda"), fn("cpu")
        assert got.is_cuda and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want)
    z_card = prng.normal(keys, (5000,), device="cuda").cpu()
    z = prng.normal(keys, (5000,), device="cpu")
    err = (z_card - z).abs() / z.abs().clamp_min(1.0)
    assert float(err.max()) <= prng.NORMAL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dynamic", "stale"])
def test_masked_round_on_the_card_equals_the_cpu(kind):
    """One availability-masked sync round at m = 100 on the card and on
    the CPU: the same comm record, per-link counts, counter and key."""
    _need_card()
    import numpy as np
    from repro_torch.config import NetworkConfig, ProtocolConfig
    from repro_torch.core.sync import kernel
    from repro_torch.core.sync.registry import SyncState
    from repro_torch.device import resolve_device
    from repro_torch.network import availability

    resolve_device("cuda")
    m, P = 100, 20_011
    gen = torch.Generator().manual_seed(11)
    ref = torch.randn((P,), generator=gen)
    scale = torch.linspace(0.0, 0.4, m)[:, None]
    X = ref + scale * torch.randn((m, P), generator=gen) / P ** 0.5
    active = availability.sample(NetworkConfig(act_prob=0.6), m, 3)
    proto = ProtocolConfig(kind=kind, b=1, delta=0.05)
    extra = ({"staleness": np.arange(m, dtype=np.int32) % 7}
             if kind == "stale" else {})
    out = {}
    for dev in ("cpu", "cuda"):
        state = SyncState(ref=ref.to(dev), v=0, step=0, extra=dict(extra))
        out[dev] = kernel.apply_staged(proto, X.clone().to(dev), state,
                                       active=active.copy())
    cpu, card = out["cpu"], out["cuda"]
    assert card.params.is_cuda and card.rec.syncs == 1
    assert card.rec == cpu.rec and card.state.v == cpu.state.v
    assert (card.xfers == cpu.xfers).all()
    assert (card.link_msgs == cpu.link_msgs).all()
    assert torch.equal(card.state.key, cpu.state.key)
    for k in cpu.state.extra:
        assert (card.state.extra[k] == cpu.state.extra[k]).all()
    torch.testing.assert_close(card.params.cpu(), cpu.params, **TOL)


@pytest.mark.cuda
def test_gossip_mixing_on_the_card_is_f32_close_to_the_cpu():
    """Gossip's ``W @ X`` on the card (cuBLAS SGEMM, TF32 off) at
    mnist_cnn's width, against the CPU's product."""
    _need_card()
    import numpy as np
    from repro_torch.config import NetworkConfig
    from repro_torch.core.sync import stages
    from repro_torch.core.sync.registry import CohortOut, StageCtx
    from repro_torch.device import resolve_device
    from repro_torch.network import availability, topology

    resolve_device("cuda")
    m, P = 100, 1_199_882
    net = NetworkConfig(topology="geometric", geo_radius=0.6, act_prob=0.7)
    active = availability.sample(net, m, 0)
    A, W = stages.cohort_neighborhood(m, active, topology.adjacency(net, m))
    X = torch.randn((m, P), generator=torch.Generator().manual_seed(2))
    cout = CohortOut(mask=active, key=prng.key(0, device="cpu"),
                     aux={"A": A, "W": W})
    mixed = {}
    for dev in ("cpu", "cuda"):
        ctx = StageCtx(params={}, flat=X.to(dev), ref_flat=None, state=None,
                       weights=None, m=m, t=1, reach=active, active=active)
        mixed[dev] = stages.aggregate_mix_stage(ctx, cout)
    assert mixed["cuda"].is_cuda and A.any()
    torch.testing.assert_close(mixed["cuda"].cpu(), mixed["cpu"], **TOL)
    # a dark learner's row is e_i: its model passes through bit for bit
    dark = int(np.flatnonzero(~active)[0])
    assert torch.equal(mixed["cuda"][dark].cpu(), X[dark])


def _poisoned(m, n, seed=0):
    """An (m, n) f32 plane on the card with a NaN row, an Inf row, a
    -Inf row and a zero row (a cold restart), beside random rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((m, n), generator=gen, device="cuda")
    X[1], X[2], X[3], X[4] = float("nan"), float("inf"), -float("inf"), 0.0
    X[5, n // 2] = float("nan")               # one poisoned entry
    r = torch.randn((n,), generator=gen, device="cuda")
    return X, r


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(8, 515), (100, 20_011), (100, 1_199_882)])
def test_sqdist_rows_on_non_finite_rows_matches_plain(m, n):
    """A NaN row gives NaN and an Inf row +Inf, in the kernel as in the
    plain version; finite rows within TOL, and the zero row's distance is
    ||r||^2."""
    _need_card()
    X, r = _poisoned(m, n)
    got = sqdist.sqdist_rows(X, r)
    want = ref.sqdist_rows_ref(X, r)
    torch.testing.assert_close(got, want, equal_nan=True, **TOL)
    assert torch.isnan(got[[1, 5]]).all()
    assert torch.isposinf(got[[2, 3]]).all()
    assert torch.isfinite(got[[0, 4]]).all()
    again = sqdist.sqdist_rows(X, r)             # bitwise repeat
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(again))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(17, 515), (100, 20_011)])
def test_robust_aggregates_on_the_card_equal_the_cpu_bitwise(m, n):
    """The trimmed mean sums its kept order statistics in one fixed
    order, one add per row, and the median is a sort and one midpoint:
    the card gives the CPU's bits."""
    _need_card()
    import numpy as np
    from repro_torch.core.sync.robust import flat_median, flat_trimmed_mean
    X, _ = _poisoned(m, n, seed=3)
    mask = np.arange(m) % 5 != 2
    for trim in (0.0, 0.2, 0.29):
        card = flat_trimmed_mean(X, mask, trim)
        cpu = flat_trimmed_mean(X.cpu(), mask, trim)
        assert card.is_cuda and torch.equal(card.cpu(), cpu), trim
    assert torch.equal(flat_median(X, mask).cpu(),
                       flat_median(X.cpu(), mask))
    Xg = X[:m - m % 4].view(4, -1, n)
    masks = np.stack([mask[:Xg.shape[1]]] * 4)
    assert torch.equal(flat_trimmed_mean(Xg, masks, 0.2).cpu(),
                       flat_trimmed_mean(Xg.cpu(), masks, 0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["robust_periodic", "robust_dynamic"])
def test_quarantine_round_on_the_card_equals_the_cpu(kind):
    """One robust round at m = 100 on a poisoned plane, on the card and
    on the CPU: the same record, suspects, health counters, and the
    plane's finite entries within TOL."""
    _need_card()
    import numpy as np
    from repro_torch.config import ProtocolConfig
    from repro_torch.core.sync import kernel
    from repro_torch.device import resolve_device

    resolve_device("cuda")
    m, P = 100, 20_011
    X, r = _poisoned(m, P, seed=5)
    honest = torch.isfinite(X).all(dim=1)
    honest[4] = False                         # the cold row stays zero
    X[honest] = r + 0.01 * X[honest]          # a fleet near its reference
    X[6:10] = -X[6:10]                        # sign-flipped adversaries
    spec = ProtocolConfig(kind=kind, b=1, delta=0.05)._spec()
    out = {}
    for dev in ("cpu", "cuda"):
        state = kernel.init_state(r.to(dev), 0, spec=spec, m=m)
        out[dev] = kernel.apply_staged(spec, X.clone().to(dev), state)
    cpu, card = out["cpu"], out["cuda"]
    assert card.params.is_cuda and card.rec == cpu.rec
    assert card.rec.syncs == 1
    for k in ("health", "recovered"):
        assert (card.state.extra[k] == cpu.state.extra[k]).all()
    assert np.flatnonzero(cpu.state.extra["health"]).tolist() == list(
        range(1, 10))
    torch.testing.assert_close(card.params.cpu(), cpu.params, **TOL)
    assert torch.isfinite(card.params).all()


# ---------------------------------------------------------------------------
# the sharded plane, per-learner optimizer steps and the audit on the card
# ---------------------------------------------------------------------------

def _mnist_engine(layout, optimizer="sgd", lr=0.1, m=8, faults=None,
                  device="cuda"):
    from repro_torch.config import (
        FaultConfig, ProtocolConfig, TrainConfig, get_arch,
    )
    from repro_torch.core.protocol import DecentralizedLearner
    from repro_torch.data.pipeline import LearnerStreams
    from repro_torch.data.synthetic import GraphicalModelStream
    from repro_torch.models.cnn import cnn_loss, init_cnn_params
    cfg = get_arch("drift_mlp", smoke=True)
    init = init_cnn_params(cfg, torch.Generator().manual_seed(3))
    dl = DecentralizedLearner(
        lambda p, b: cnn_loss(cfg, p, b),
        lambda g: {"layers": [{k: v.to(device) for k, v in layer.items()}
                              for layer in init["layers"]]}, m,
        ProtocolConfig(kind="dynamic", b=2, delta=0.05, layout=layout),
        TrainConfig(optimizer=optimizer, learning_rate=lr),
        faults=None if faults is None else FaultConfig(**faults),
        device=device)
    src = GraphicalModelStream(seed=0, drift_prob=0.0, device="cpu")
    batches = LearnerStreams(src, m, batch=10, seed=0).next_chunk(24)
    return dl, {k: v.to(device) for k, v in batches.items()}


@pytest.mark.cuda
def test_world1_sharded_is_the_flat_run_on_the_card():
    _need_card()
    flat, batches = _mnist_engine("flat")
    shd, _ = _mnist_engine("sharded")
    flat.run_chunk(batches)
    shd.run_chunk(batches)
    assert flat.comm_totals == shd.comm_totals and \
        flat.comm_totals["syncs"] > 0
    assert (flat.per_link_bytes() == shd.per_link_bytes()).all()
    assert torch.equal(flat.X, shd.X)
    assert torch.equal(shd.fleet_plane(), flat.X)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [25, 50])
def test_sqdist_rows_at_the_per_rank_shapes(m, dtype):
    """One rank's rows of mnist_cnn's fleet sharded over 4 and 2 ranks."""
    _need_card()
    X, r = _inputs(m, 1_199_882, dtype)
    a, b = sqdist.sqdist_rows(X, r), sqdist.sqdist_rows(X, r)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ref.sqdist_rows_ref(X, r), **TOL)


@pytest.mark.cuda
def test_per_row_adam_on_the_card_equals_the_cpu():
    """Unequal per-learner step counts under crashes: the card's counts
    are the CPU's, the planes within the fault tests' 1e-5."""
    _need_card()
    kw = dict(fault_seed=11, crash_prob=0.15, crash_every=16,
              outage_min=2, outage_max=4)
    runs = {}
    for dev in ("cpu", "cuda"):
        dl, batches = _mnist_engine("flat", "adam", 1e-3, faults=kw,
                                    device=dev)
        dl.run_chunk(batches)
        runs[dev] = dl
    cpu, gpu = runs["cpu"], runs["cuda"]
    assert gpu.opt_state.step.is_cuda
    assert torch.equal(gpu.opt_state.step.cpu(), cpu.opt_state.step)
    assert gpu.comm_totals == cpu.comm_totals
    # the output bias after a cold restart: its gradient is a sum that is
    # 0 in exact arithmetic, and adam's g / (|g| + eps) maps the card's
    # and the CPU's residuals up to lr apart (tests/test_torch_optim_steps)
    marks = cpu.adapter.unravel_model(torch.arange(cpu.model_size))
    bias = marks["layers"][-1]["b"].long()
    keep = torch.ones(cpu.model_size, dtype=torch.bool)
    keep[bias] = False
    torch.testing.assert_close(gpu.X.cpu()[:, keep], cpu.X[:, keep],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gpu.X.cpu()[:, bias], cpu.X[:, bias],
                               rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_audit_sync_count_under_sync_debug_mode():
    """One dynamic chunk: the dispatch mode's host syncs and the warnings
    of ``set_sync_debug_mode`` both equal the documented budget."""
    import warnings
    from repro_torch.analysis import audit
    _need_card()
    dl, batches = _mnist_engine("flat")
    dl.run_chunk({k: v[:12] for k, v in batches.items()})   # warm-up
    torch.cuda.set_sync_debug_mode("warn")   # (setting it warns too)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = audit.audit_learner(dl, {k: v[12:] for k, v in
                                           batches.items()})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    warned = [w for w in caught if "synchroniz" in str(w.message).lower()]
    assert got["findings"] == []
    assert got["checked"] == 6
    assert got["syncs"] == got["budget"] == len(warned)
