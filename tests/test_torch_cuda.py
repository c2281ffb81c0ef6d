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
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.nn.functional as F  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.config import norm_widths  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, flash_attention, ops, ref, rmsnorm, sqdist, ssd_scan,
    swa_attention,
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
def test_wrappers_launch_on_the_current_stream():
    """``_build.current_stream`` is torch's current stream, a side stream
    inside ``torch.cuda.stream``; rmsnorm and f32 attention launched there
    give the default stream's bits."""
    _need_card()
    dev = torch.cuda.current_device()
    assert _build.current_stream(dev) == torch.cuda.current_stream().cuda_stream
    x = _randn((64, 1600), "bfloat16", 5)
    q = _randn((1, 130, 4, 64), "float32", 6)
    kv = q[:, :, :2].contiguous()
    want = (rmsnorm.rmsnorm(x, x[0]),
            flash_attention.flash_attention_gqa(q, kv, kv))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert _build.current_stream(dev) == side.cuda_stream
        got = (rmsnorm.rmsnorm(x, x[0]),
               flash_attention.flash_attention_gqa(q, kv, kv))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# the edges of rmsnorm's forms (rmsnorm.plan): D not a multiple of 8 (a
# scalar tail, and a head on the rows that start off 16 bytes), views
# `offset` elements into their buffers (every row and the scale off 16
# bytes), rows shorter than a vector and of one warp, MAX_D (the stream
# form in f32); then decode's 1-4 rows at every width a full-size config
# norms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,offset", [
    ((5, 1601), 0), ((3, 4100), 0), ((2, 3, 1601), 1), ((4, 4096), 1),
    ((3, 16384), 3), ((9, 200), 1), ((4, 7), 1), ((2, rmsnorm.MAX_D), 0),
    ((2, rmsnorm.MAX_D), 1)])
def test_rmsnorm_edges_match_plain(shape, offset, dtype):
    _need_card()
    n = math.prod(shape)
    x = _randn((n + offset,), dtype, n)[offset:].view(shape)
    s = _randn((shape[-1] + offset,), dtype, 2)[offset:]
    if offset:
        assert x.data_ptr() % 16 and s.data_ptr() % 16
    got = _same_twice(rmsnorm.rmsnorm, x, s, 1e-5)
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, s, 1e-5),
                               **LM_TOL["norm", dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", norm_widths())
def test_rmsnorm_at_decode_rows_matches_plain(d, dtype):
    """A decode step's (B, 1, d), B = 1..4: a few blocks."""
    _need_card()
    for rows in (1, 2, 3, 4):
        x = _randn((rows, 1, d), dtype, d + rows)
        s = _randn((d,), dtype, 3)
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
        "bfloat16": "sm90_wgmma_tma", "float32": "sm90_mma_tf32x3"}[dtype]
    seed = 7 * B + Sq + 3 * Sk + H + d + window
    q = _randn((B, Sq, H, d), dtype, seed)
    k = _randn((B, Sk, Hkv, d), dtype, seed + 1)
    v = _randn((B, Sk, Hkv, d), dtype, seed + 2)
    got = _same_twice(flash_attention.flash_attention_gqa, q, k, v,
                      causal=causal, window=window)
    want = ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **LM_TOL["attn", dtype])


# the serving zoo's attention layouts (small S): hymba's head dim 64 over
# a 5:1 group, musicgen's group 1 at 64, llama3-405b's group 16, and MLA's
# query/key width above its value width: (192, 128) in both programs,
# deepseek-v2's smoke (48, 32) in f32 only
ZOO_ATTN = [(2, 150, 150, 25, 5, 64, 64, True, 0),
            (2, 130, 130, 10, 5, 64, 64, True, 48),
            (2, 100, 100, 8, 8, 64, 64, True, 0),
            (1, 140, 140, 32, 2, 128, 128, True, 0),
            (2, 200, 200, 4, 4, 192, 128, True, 0),
            (1, 1, 90, 3, 3, 192, 128, True, 0),
            (1, 40, 70, 2, 2, 192, 128, False, 0),
            (3, 129, 129, 8, 8, 192, 128, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,dv,causal,window", ZOO_ATTN + [
    (2, 70, 70, 4, 4, 48, 32, True, 0)])
def test_attention_at_the_zoo_layouts_matches_plain(B, Sq, Sk, H, Hkv, d,
                                                    dv, causal, window,
                                                    dtype):
    """Each layout against the plain version, bitwise repeatable; a width
    pair a program is not compiled for raises (bf16 at (48, 32))."""
    _need_card()
    seed = 5 * B + Sq + Sk + H + d + dv + window
    q = _randn((B, Sq, H, d), dtype, seed)
    k = _randn((B, Sk, Hkv, d), dtype, seed + 1)
    v = _randn((B, Sk, Hkv, dv), dtype, seed + 2)
    if (d, dv) not in flash_attention.WIDTHS[DTYPES[dtype]]:
        with pytest.raises(ValueError, match="head dims"):
            flash_attention.flash_attention_gqa(q, k, v)
        return
    got = _same_twice(flash_attention.flash_attention_gqa, q, k, v,
                      causal=causal, window=window)
    assert got.shape == (B, Sq, H, dv)
    want = ref.flash_attention_gqa_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **LM_TOL["attn", dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv", sorted(flash_attention.WIDTHS[torch.float32]))
def test_f32_program_at_every_width_pair(d, dv, causal):
    """The split-TF32 program at each (query/key, value) width pair it is
    compiled for, ragged tiles past one query tile (128 rows, 192 at head
    dim 128)."""
    _need_card()
    assert flash_attention.program(torch.float32) == "sm90_mma_tf32x3"
    q = _randn((2, 200, 4, d), "float32", d + dv)
    k = _randn((2, 230, 2, d), "float32", d + dv + 1)
    v = _randn((2, 230, 2, dv), "float32", d + dv + 2)
    got = _same_twice(flash_attention.flash_attention_gqa, q, k, v,
                      causal=causal)
    want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, **LM_TOL["attn", "float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_takes_more_heads_than_a_2d_grid(dtype):
    """B * H = 70,000, above the 65,535 of a grid's second axis: both
    programs run one grid axis."""
    _need_card()
    q = _randn((1, 4, 70_000, 32), dtype, 1)
    k = _randn((1, 4, 1, 32), dtype, 2)
    v = _randn((1, 4, 1, 32), dtype, 3)
    got = _same_twice(flash_attention.flash_attention_gqa, q, k, v)
    torch.testing.assert_close(got, ref.flash_attention_gqa_ref(q, k, v),
                               **LM_TOL["attn", dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swa_at_hymbas_layout(dtype):
    """The banded path at hymba's head dim 64 and 25 / 5 heads, S = 2w."""
    _need_card()
    q = _randn((1, 256, 25, 64), dtype, 1)
    k = _randn((1, 256, 5, 64), dtype, 2)
    v = _randn((1, 256, 5, 64), dtype, 3)
    got = _same_twice(swa_attention.swa_attention, q, k, v, window=128)
    torch.testing.assert_close(got, ref.swa_attention_ref(q, k, v,
                                                          window=128),
                               **LM_TOL["attn", dtype])


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
    # a contiguous view one float into its buffer: cp.async reads 16 bytes
    off = _randn((q.numel() + 1,), "float32", 4)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention.flash_attention_gqa(off, kv, kv)
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
    (2, 64, 5, 3, 8, 1, False), (160, 256, 64, 128, 64, 80, False),
    (100, 256, 64, 16, 64, 50, False), (16, 48, 64, 16, 16, 8, False)])
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


# the split fleet's gross bound on the card (chip_smoke.py's
# SHARD_GROSS_REL; README, "the split fleet's contract")
SHARD_GROSS_REL = 1e-2


def _upstream(dl, batch, i=0):
    """Learner i's own float64 forward of mnist_cnn (log-softmax in
    float64 too), NCHW/OIHW: the input x, conv1's and conv2's weights and
    outputs after ReLU, and the loss's gradients at conv1's and conv2's
    pre-activations, g1 = dL/dz1 and g2 = dL/dz2."""
    layers = [{k: v[i].double() for k, v in p.items()}
              for p in dl.params["layers"]]
    x = batch["x"][i].double().permute(0, 3, 1, 2)
    w1, w2 = (layers[j]["w"].permute(3, 2, 0, 1) for j in (0, 1))
    z1 = (F.conv2d(x, w1) + layers[0]["b"][:, None, None]).requires_grad_()
    a1 = F.relu(z1)
    z2 = F.conv2d(a1, w2) + layers[1]["b"][:, None, None]
    z2.retain_grad()
    a = F.max_pool2d(F.relu(z2), 2, 2).permute(0, 2, 3, 1)
    a = F.relu(a.reshape(a.shape[0], -1) @ layers[5]["w"] + layers[5]["b"])
    out = a @ layers[7]["w"] + layers[7]["b"]
    loss = -torch.mean(torch.gather(torch.log_softmax(out, -1), -1,
                                    batch["y"][i].long()[:, None]))
    loss.backward()
    return (x, w1, w2, a1.detach(), z1.grad, z2.grad)


def _conv_op_errors(dl, batch, kernels) -> dict:
    """mnist_cnn's two convolutions one op at a time, on learner 0's own
    float64 activations and its own upstream gradients (``_upstream``):
    each f32 op's largest distance from float64, over the largest float64
    entry (``rel_err``) and, entry by entry, over the float64 sum of the
    magnitudes of the terms the entry sums (``rel_to_terms``: the same op
    on |inputs|), and the device kernels the f32 op runs. The forward of
    the second convolution grouped over 100 and 25 learners (vmap, those
    learners' float64 inputs) and alone; its input and weight gradients,
    the first convolution's weight gradient and the two bias gradients
    (sums of g over the batch and positions) alone."""
    from torch.nn.grad import conv2d_input, conv2d_weight
    x, w1, w2, a1, g1, g2 = _upstream(dl, batch)
    convs = [p for p in dl.params["layers"] if p and p["w"].dim() == 5]
    w2s = convs[1]["w"].double().permute(0, 4, 3, 1, 2)
    w1s = convs[0]["w"].double().permute(0, 4, 3, 1, 2)
    xs = batch["x"].double().permute(0, 1, 4, 2, 3)      # (m, B, C, H, W)
    a1s = torch.relu(torch.func.vmap(F.conv2d)(xs, w1s)
                     + convs[0]["b"].double()[:, None, :, None, None])
    grouped = torch.func.vmap(F.conv2d)
    ops = {
        "conv2_forward_100": (grouped, a1s, w2s),
        "conv2_forward_25": (grouped, a1s[:25], w2s[:25]),
        "conv2_forward_alone": (F.conv2d, a1, w2),
        "conv2_input_grad_alone": (
            lambda w, g: conv2d_input(a1.shape, w, g), w2, g2),
        "conv2_weight_grad_alone": (
            lambda a, g: conv2d_weight(a, w2.shape, g), a1, g2),
        "conv2_bias_grad_alone": (lambda g: g.sum(dim=(0, 2, 3)), g2),
        "conv1_weight_grad_alone": (
            lambda a, g: conv2d_weight(a, w1.shape, g), x, g1),
        "conv1_bias_grad_alone": (lambda g: g.sum(dim=(0, 2, 3)), g1)}
    out = {}
    for name, (fn, *args) in ops.items():
        want = fn(*args)
        terms = fn(*(a.abs() for a in args))
        f32 = [a.float() for a in args]
        got = fn(*f32)
        err = (got.double() - want).abs()
        out[name] = {"rel_err": float(err.max() / want.abs().max()),
                     "rel_to_terms": float(
                         (err / terms.clamp_min(1e-300)).max()),
                     "kernels": kernels(lambda: fn(*f32))}
    return out


ARBITER_ROWS = 25            # learners whose gradient the CPU recomputes
# C5: an f32 gradient of a learner whose f32 forward keeps every ReLU and
# max-pool decision of the float64 forward sits within this of float64:
# ~3 eps times the largest sum of term magnitudes an entry reduces (~6,
# conv1's bias); tests/test_torch_grad_precision.py's F32_ABS on the CPU
CARD_F32_ABS = 2e-6


def _decisions(cfg, params, x):
    """mnist_cnn's forward over (m, B, 28, 28, 1) inputs, vmapped over the
    learners as the local step runs it (grouped convolutions): each
    learner's ReLU signs after conv1, conv2 and the first dense layer and
    its max-pool picks, flattened per learner."""
    def fwd(p, xb):
        layers = p["layers"]
        h = xb.permute(0, 3, 1, 2)
        z1 = F.conv2d(h, layers[0]["w"].permute(3, 2, 0, 1)) + \
            layers[0]["b"][:, None, None]
        z2 = F.conv2d(F.relu(z1), layers[1]["w"].permute(3, 2, 0, 1)) + \
            layers[1]["b"][:, None, None]
        pooled, pick = F.max_pool2d(F.relu(z2), 2, 2, return_indices=True)
        a = pooled.permute(0, 2, 3, 1).reshape(xb.shape[0], -1)
        z3 = a @ layers[5]["w"] + layers[5]["b"]
        return torch.cat([(z1 > 0).reshape(-1), (z2 > 0).reshape(-1),
                          (z3 > 0).reshape(-1)]), pick.reshape(-1)
    return torch.func.vmap(fwd)(params, x)


def _float64_references(dl, batch, grads, shapes, bounds) -> dict:
    """Which float64 gradient is right, and where f32 leaves it. Learners
    0..24's gradients taken wholly in float64 (the log-softmax too, where
    ``cnn_loss`` takes it in f32) on the CPU, one learner a call, are the
    arbiter; beside them, per parameter tensor, the largest distance of:
    the same on the card (one learner a call, ungrouped convolutions);
    the card's vmapped float64 call of that loss over 25 learners; the
    probe's own float64 yardstick (``grads(25, float64)``: the vmapped
    call of ``cnn_loss``, f32 log-softmax); the f32 100-learner call
    (cuDNN); the f32 call without cuDNN. Then, per learner, the f32
    100-learner call's largest distance from the arbiter and how many
    ReLU and max-pool decisions its f32 forward (vmapped over 100, as the
    step runs it) takes otherwise than the float64 forward. Also each
    tensor's largest |gradient|, the largest |logit| and sum |dL/dz1| of
    conv1's bias."""
    from repro_torch.config import get_arch
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.models.cnn import cnn_apply
    cfg = get_arch("mnist_cnn")

    def loss64(p, b):
        lp = torch.log_softmax(cnn_apply(cfg, p, b["x"]), dim=-1)
        return -torch.mean(torch.gather(lp, -1, b["y"].long()[:, None]))

    def flat(g):
        return torch.cat([x.reshape(-1) for x in tree_leaves(g)])

    def one(i, device):
        p = tree_map(lambda v: v[i].double().to(device), dl.params)
        b = {"x": batch["x"][i].double().to(device),
             "y": batch["y"][i].to(device)}
        return flat(torch.func.grad(loss64)(p, b)).double().cpu()

    k = ARBITER_ROWS
    cpu = torch.stack([one(i, "cpu") for i in range(k)])
    cands = {"card_f64_alone": torch.stack([one(i, "cuda")
                                            for i in range(k)])}
    p25 = tree_map(lambda v: v[:k].double(), dl.params)
    b25 = {"x": batch["x"][:k].double(), "y": batch["y"][:k]}
    g25 = torch.func.vmap(torch.func.grad(loss64))(p25, b25)
    cands["card_f64_vmap_25"] = torch.cat(
        [x.reshape(k, -1) for x in tree_leaves(g25)], dim=1).double().cpu()
    cands["card_f64_cnn_loss_vmap_25"] = grads(25, torch.float64)[:k].cpu()
    f32 = grads(100)[:k].double().cpu()
    cands["card_f32_100"] = f32
    torch.backends.cudnn.enabled = False
    try:
        cands["card_f32_100_without_cudnn"] = grads(100)[:k].double().cpu()
    finally:
        torch.backends.cudnn.enabled = True
    names = ["x".join(map(str, s)) for s in shapes]
    spans = list(zip(names, bounds[:-1], bounds[1:]))
    out = {"largest_grad": {n: float(cpu[:, a:b].abs().max())
                            for n, a, b in spans}}
    for label, g in cands.items():
        d = (g - cpu).abs()
        out[label] = {n: float(d[:, a:b].max()) for n, a, b in spans}
    # per learner: the f32 call's distance, and the decisions it flips
    s32, p32 = _decisions(cfg, dl.params, batch["x"])
    s64, p64 = _decisions(cfg, tree_map(lambda v: v.double(), dl.params),
                          batch["x"].double())
    flips = ((s32 != s64).sum(dim=1) + (p32 != p64).sum(dim=1))[:k]
    err = (f32 - cpu).abs().max(dim=1).values
    out["per_learner"] = [{"learner": i, "f32_err": float(err[i]),
                           "flipped_decisions": int(flips[i])}
                          for i in range(k)]
    keep = flips.cpu() == 0
    out["f32_err_where_no_decision_flips"] = float(err[keep].max())
    out["f32_err_where_a_decision_flips"] = (
        float(err[~keep].max()) if bool((~keep).any()) else None)
    logits, g1_terms = [], []
    for i in range(k):
        g1 = _upstream(dl, batch, i)[4]
        g1_terms.append(float(g1.abs().sum(dim=(0, 2, 3)).max()))
        p = tree_map(lambda v: v[i].double(), dl.params)
        logits.append(float(cnn_apply(cfg, p, batch["x"][i].double())
                            .abs().max()))
    out["largest_logit"] = max(logits)
    out["conv1_bias_terms"] = max(g1_terms)
    return out


@pytest.mark.cuda
def test_gradient_depends_on_the_call_size(record_property):
    """The mechanism behind the split fleet's contract on the card: the
    same 25 learners' gradients of mnist_cnn at full width (P =
    1,199,882, B = 10, f32, TF32 off, learners apart by a heterogeneous
    init of ε = 1), computed inside vmapped calls of 100, 50 and 25
    learners (the local step of S1, S2 and S4), are each within the
    contract's bound of the 100-learner call's. Reported (the junit
    properties and stdout), so that the cause stands measured: the
    largest difference from the 100-learner call; each call's largest
    distance from the same gradients in float64, overall and per
    parameter tensor; the device kernels each call size runs (names
    from ``torch.profiler``); the same distance for one learner's
    gradient taken alone (no vmap, an ungrouped convolution), with cuDNN
    free to pick non-deterministic algorithms, without cuDNN, and at a
    homogeneous model; and each convolution op on its own
    (``_conv_op_errors``).

    C5 (closed): the probe's float64 yardstick (``grads(25, float64)``)
    runs ``cnn_loss``, whose log-softmax is f32; the arbiter
    (``_float64_references``) takes learners 0..24 wholly in float64 on
    the CPU. Asserted: every learner whose f32 forward keeps each ReLU
    and max-pool decision of the float64 forward is within
    ``CARD_F32_ABS`` of the arbiter; a learner over it must have one
    decision flipped (the gradient jumps there; the reference's f32 does
    the same on the CPU, tests/test_torch_grad_precision.py)."""
    import numpy as np
    from repro_torch.config import ProtocolConfig, get_arch
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.core.protocol import DecentralizedLearner
    from repro_torch.data.pipeline import LearnerStreams
    from repro_torch.data.synthetic import SyntheticMNIST
    from repro_torch.models.cnn import cnn_loss, init_cnn_params
    _need_card()
    cfg = get_arch("mnist_cnn")
    loss_fn = lambda p, b: cnn_loss(cfg, p, b)          # noqa: E731
    dl = DecentralizedLearner(
        loss_fn, lambda g: init_cnn_params(cfg, g), 100,
        ProtocolConfig(kind="nosync"), init_heterogeneity=1.0,
        device="cuda")
    assert dl.model_size == 1_199_882
    src = SyntheticMNIST(seed=0, image_size=28, device="cuda")
    batch = {k: v[0] for k, v in
             LearnerStreams(src, 100, batch=10, seed=0).next_chunk(1).items()}
    shapes = [tuple(x.shape[1:]) for x in tree_leaves(dl.params)]
    bounds = np.cumsum([0] + [int(np.prod(s)) for s in shapes])

    def cast(t, dtype):
        return t.to(dtype) if t.is_floating_point() else t

    def grads(rows, dtype=torch.float32):
        params = tree_map(lambda x: x[:rows].to(dtype), dl.params)
        g, _ = dl._grad_and_loss(params, {k: cast(v[:rows], dtype)
                                          for k, v in batch.items()})
        return torch.cat([x.reshape(rows, -1) for x in tree_leaves(g)],
                         dim=1)[:25]

    def alone(i):
        """Learner i's gradient from an unbatched call (f32)."""
        params = tree_map(lambda x: x[i], dl.params)
        g, _ = torch.func.grad_and_value(loss_fn)(
            params, {k: v[i] for k, v in batch.items()})
        return torch.cat([x.reshape(-1) for x in tree_leaves(g)])

    def kernels(fn):
        return sorted(profile_calls(fn, calls=1)["kernels_us"])

    exact = grads(25, torch.float64)

    def off(g):
        return float((g.double() - exact).abs().max())

    def by_tensor(g):
        d = (g.double() - exact).abs()
        return {"x".join(map(str, s)): float(d[:, a:b].max())
                for s, a, b in zip(shapes, bounds[:-1], bounds[1:])}

    whole = grads(100)
    report = {"f32_vs_f64": {100: off(whole)}, "vs_100": {},
              "f32_vs_f64_by_tensor": {100: by_tensor(whole)},
              "kernels": {100: kernels(lambda: grads(100))}}
    for rows in (50, 25):
        part = grads(rows)
        assert torch.isfinite(part).all()
        rel = torch.linalg.vector_norm(part - whole, dim=1) / \
            torch.linalg.vector_norm(whole, dim=1)
        assert float(rel.max()) <= SHARD_GROSS_REL
        report["vs_100"][rows] = float((part - whole).abs().max())
        report["f32_vs_f64"][rows] = off(part)
        report["f32_vs_f64_by_tensor"][rows] = by_tensor(part)
        report["kernels"][rows] = kernels(lambda: grads(rows))
    again = grads(100)
    assert torch.equal(again, whole)          # one call size repeats
    single = torch.stack([alone(i) for i in range(25)])
    report["one_learner_alone"] = {"f32_vs_f64": off(single),
                                   "kernels": kernels(lambda: alone(0))}
    torch.backends.cudnn.deterministic = False
    try:
        free = grads(100)
        report["cudnn_nondeterministic"] = {
            "f32_vs_f64": off(free), "kernels": kernels(lambda: grads(100))}
    finally:
        torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.enabled = False
    try:
        report["f32_vs_f64_without_cudnn"] = {
            rows: off(grads(rows)) for rows in (100, 25)}
    finally:
        torch.backends.cudnn.enabled = True
    report["ops"] = _conv_op_errors(dl, batch, kernels)
    # the composed gradient's conv1 bias (learner 0, the 100-learner
    # call and alone) over the magnitudes of the terms it sums
    g1 = _upstream(dl, batch)[4]
    g1_exact, g1_terms = g1.sum(dim=(0, 2, 3)), g1.abs().sum(dim=(0, 2, 3))
    k = shapes.index((32,))                       # conv1's bias
    bias = slice(int(bounds[k]), int(bounds[k + 1]))
    for label, g in (("100", whole[0]), ("alone", single[0])):
        err = (g[bias].double() - g1_exact).abs()
        report.setdefault("conv1_bias_rel_to_terms", {})[label] = float(
            (err / g1_terms).max())
    refs = report["float64_references"] = _float64_references(
        dl, batch, grads, shapes, bounds)
    # C5: every learner's f32 gradient is float64's to f32 rounding
    # unless its f32 forward takes a ReLU or max-pool decision otherwise
    for row in refs["per_learner"]:
        assert row["flipped_decisions"] > 0 or \
            row["f32_err"] <= CARD_F32_ABS, row
    dl.X.copy_(dl.X[0].expand_as(dl.X))
    report["homogeneous_f32_vs_f64"] = float(
        (grads(100).double() - grads(25, torch.float64)).abs().max())
    record_property("gradient_call_size", report)
    print(f"gradient call-size dependence at (100, 1199882): {report}")


# the backward kernels (attention_bwd.cu, rmsnorm_bwd.cu) against the
# autograd gradient of their plain versions: f32 on both sides, summed in
# other orders, each gradient within GRAD_REL of its largest entry
GRAD_REL = 1e-5


def _grad_gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window", [
    (2, 100, 100, 4, 4, 64, True, 0), (1, 130, 130, 8, 2, 128, True, 0),
    (2, 70, 90, 4, 1, 32, False, 0), (1, 200, 200, 8, 2, 64, True, 48),
    (1, 64, 200, 4, 1, 128, True, 0),
    # fleet-llm-100m's four learners folded; a ragged Sk at d = 128 with
    # a window, past two 96-key blocks
    (16, 128, 128, 12, 4, 128, True, 0), (1, 150, 230, 8, 2, 128, True, 64)])
def test_attention_bwd_matches_plain_autograd(B, Sq, Sk, H, Hkv, d, causal,
                                              window):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(Sq + Sk + d)
    q = torch.randn((B, Sq, H, d), generator=gen, device="cuda")
    k = torch.randn((B, Sk, Hkv, d), generator=gen, device="cuda")
    v = torch.randn((B, Sk, Hkv, d), generator=gen, device="cuda")
    do = torch.randn((B, Sq, H, d), generator=gen, device="cuda")
    o, lse = flash_attention.attention(q, k, v, causal=causal, window=window,
                                       scale=None, with_lse=True)
    torch.testing.assert_close(
        lse, ref.attention_lse_ref(q, k, causal=causal, window=window),
        rtol=1e-5, atol=1e-5)
    kw = dict(causal=causal, window=window, scale=None)
    got = flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention.attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_gqa_bwd_ref(q, k, v, do, **kw)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert _grad_gap(a, w) <= GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D,g,offset", [
    (64, 768, 1, 0), (64, 768, 4, 0), (512, 4096, 1, 0), (512, 4096, 4, 0),
    (33, 1601, 1, 1), (12, 200, 3, 3)])
def test_rmsnorm_bwd_matches_plain_autograd(rows, D, g, offset):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(rows + D + g)
    # offset > 0: rows that start off their 16-byte boundaries
    x = torch.randn((rows * D + offset,), generator=gen,
                    device="cuda")[offset:].view(rows, D)
    scale = torch.randn((g, D) if g > 1 else (D,), generator=gen,
                        device="cuda")
    dy = torch.randn((rows, D), generator=gen, device="cuda")
    got = rmsnorm.rmsnorm_bwd(x, scale, dy, 1e-5)
    again = rmsnorm.rmsnorm_bwd(x, scale, dy, 1e-5)
    want = ref.rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.shape == w.shape
        assert torch.equal(a, b)
        assert _grad_gap(a, w) <= GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,rows,D", [(4, 6, 768), (3, 5, 1601),
                                      (2, 4, 4096)])
def test_grouped_rmsnorm_is_m_single_scale_calls(m, rows, D, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(m * rows + D)
    x = torch.randn((m, rows, D), generator=gen,
                    device="cuda").to(DTYPES[dtype])
    scale = torch.randn((m, D), generator=gen, device="cuda").to(
        DTYPES[dtype])
    got = rmsnorm.rmsnorm(x, scale, 1e-5)
    for i in range(m):
        assert torch.equal(got[i], rmsnorm.rmsnorm(x[i], scale[i], 1e-5))


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad():
    """The distance kernels and a norm past the backward's widest row
    raise under a gradient; bf16 attention, swa_attention, ssd_scan and
    rmsnorm have a backward (``test_bf16_backward_through_ops``)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    D = rmsnorm.MAX_BWD_D + 1
    cases = {
        "rmsnorm past MAX_BWD_D": (lambda x: ops.rmsnorm(
            x, torch.ones(D, device="cuda")), randn(2, D)),
        "sqdist_rows": (lambda x: ops.sqdist_rows(x, x[0].detach()),
                        randn(3, 40)),
    }
    for name, (fn, arg) in cases.items():
        with pytest.raises(NotImplementedError):
            torch.func.grad(lambda t: fn(t).float().sum())(arg)
        with pytest.raises(NotImplementedError):
            fn(arg.clone().requires_grad_()).float().sum().backward()
        # without a gradient the kernel runs as before
        fn(arg)


# a bf16 gradient through the kernels against the plain versions' bf16
# gradient on the card: both within a few bf16 steps of the f32 gradient
# (the kernel rounds P and dS to bf16, both round the gradient once)
BF16_GRAD_REL = 2.0 ** -6


@pytest.mark.cuda
def test_bf16_backward_through_ops():
    """bf16 attention, its banded route, a direct ssd_scan (the f32
    kernel upcast) and rmsnorm under ``loss.backward()``: one forward and
    one backward launch each, the gradients in the inputs' dtypes within
    BF16_GRAD_REL of the plain versions'."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = randn(1, 64, 4, 64), randn(1, 64, 2, 64), randn(1, 64, 2, 64)
    x, dt = randn(4, 64, 16), randn(4, 64).abs()
    a, b, c = -randn(4, dtype=torch.float32).abs(), randn(2, 64, 8), randn(
        2, 64, 8)
    cases = {
        "flash_attention": (lambda q, k, v: ops.flash_attention_gqa(
            q, k, v), (q, k, v), "attention_bwd"),
        "swa_attention": (lambda q, k, v: ops.swa_attention(
            q, k, v, window=32), (q, k, v), "attention_bwd"),
        "ssd_scan": (lambda x, dt, a, b, c: ops.ssd_scan(
            x, dt, a, b, c, chunk=16)[0], (x, dt, a, b, c), "ssd_scan_bwd"),
        "rmsnorm": (lambda x, s: ops.rmsnorm(x, s),
                    (randn(3, 64), 1 + 0.1 * randn(64)), "rmsnorm_bwd"),
    }
    for name, (fn, args, bwd) in cases.items():
        leaves = [t.clone().requires_grad_() for t in args]
        ops.reset_launches()
        fn(*leaves).float().square().sum().backward()
        assert (ops.LAUNCHES[name], ops.LAUNCHES[bwd]) == (1, 1), name
        plain = [t.clone().requires_grad_() for t in args]
        on_cpu, ops._on_cpu = ops._on_cpu, lambda *t: True
        try:
            fn(*plain).float().square().sum().backward()
        finally:
            ops._on_cpu = on_cpu
        for got, want in zip(leaves, plain):
            assert got.grad.dtype == got.dtype, name
            assert _grad_gap(got.grad.float(), want.grad.float()) <= \
                BF16_GRAD_REL, name


@pytest.mark.cuda
def test_backward_through_ops_matches_plain():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((2, 96, 8, 64), generator=gen, device="cuda")
    k = torch.randn((2, 96, 2, 64), generator=gen, device="cuda")
    v = torch.randn((2, 96, 2, 64), generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    out = ops.flash_attention_gqa(*leaves)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert (ops.LAUNCHES["flash_attention"],
            ops.LAUNCHES["attention_bwd"]) == (1, 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_gqa_ref(*plain).square().sum().backward()
    for got, want in zip(leaves, plain):
        assert float(got.grad.abs().max()) > 0
        assert _grad_gap(got.grad, want.grad) <= GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,d,dv,causal", [
    (1, 256, 256, 4, 192, 128, True), (2, 70, 100, 2, 192, 128, False),
    (2, 128, 128, 8, 48, 32, True), (1, 60, 130, 4, 48, 32, False)])
def test_mla_backward_through_ops_matches_plain(B, Sq, Sk, H, d, dv, causal):
    """MLA's widths under a gradient: one forward and one backward
    launch, the gradients within GRAD_REL of the plain version's."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(Sq + d)
    q = torch.randn((B, Sq, H, d), generator=gen, device="cuda")
    k = torch.randn((B, Sk, H, d), generator=gen, device="cuda")
    v = torch.randn((B, Sk, H, dv), generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    ops.flash_attention_gqa(*leaves, causal=causal).square().sum().backward()
    assert (ops.LAUNCHES["flash_attention"],
            ops.LAUNCHES["attention_bwd"]) == (1, 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_gqa_ref(*plain, causal=causal).square().sum() \
        .backward()
    for got, want in zip(leaves, plain):
        assert _grad_gap(got.grad, want.grad) <= GRAD_REL


# ssd_scan_bwd against the autograd gradient of the sequential plain
# version, both f32, summed in other orders: GRAD_REL of each gradient's
# largest entry
@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,P,N,chunk,R,dh,strong", [
    (3, 64, 8, 4, 16, 1, False, False), (4, 96, 64, 128, 32, 2, True, False),
    (8, 256, 64, 128, 8, 4, True, False), (6, 128, 32, 64, 16, 1, False, False),
    (16, 256, 64, 128, 64, 16, False, False),
    (10, 256, 64, 16, 64, 10, True, False), (3, 72, 37, 20, 8, 3, True, True),
    (4, 128, 64, 128, 64, 1, False, True),
    # the tiling's edges: N 100 (slabs of 64 and 36) with P 40, N 72 with
    # P 24 and R > 1 at chunk 8, N 8, the walk's blocks of two warps
    (6, 256, 40, 100, 16, 2, True, False), (8, 128, 24, 72, 8, 4, False, False),
    (2, 64, 64, 8, 32, 1, True, False), (64, 512, 64, 128, 64, 16, False, True)])
def test_ssd_scan_bwd_matches_plain(BH, S, P, N, chunk, R, dh, strong):
    """Chunks 8 to 64, R = 1 and R > 1 (b and c summed over a row's
    heads), P and N up to the kernel's 64 and 128 and odd, past a column
    slab or a row tile, with and without the final state's gradient,
    strong decay (dt |a| about 15 a step); finite and bitwise
    repeatable."""
    _need_card()
    x, dt, a, b, c = _ssd_inputs(BH, S, P, N, "float32", BH + S + N, R)
    if strong:
        dt, a = dt * 4 + 1, a * 4
    gen = torch.Generator(device="cuda").manual_seed(S)
    dy = torch.randn((BH, S, P), generator=gen, device="cuda")
    dhv = torch.randn((BH, P, N), generator=gen, device="cuda") if dh \
        else None
    _, _, states = ssd_scan.ssd_scan(x, dt, a, b, c, chunk=chunk,
                                     keep_states=True)
    got = ssd_scan.ssd_scan_bwd(x, dt, a, b, c, states, dy, dhv, chunk=chunk)
    again = ssd_scan.ssd_scan_bwd(x, dt, a, b, c, states, dy, dhv,
                                  chunk=chunk)
    want = ref.ssd_scan_bwd_ref(x, dt, a, b, c, dy, dhv)
    torch.cuda.synchronize()
    for g, g2, w in zip(got, again, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert torch.equal(g, g2)
        assert _grad_gap(g, w) <= GRAD_REL


@pytest.mark.cuda
def test_ssd_scan_bwd_bits_do_not_depend_on_the_walk_split():
    """64 heads, 16 a row, take the walk's blocks of two warps; each
    row's 16 heads alone take blocks of one: the same bits."""
    _need_card()
    BH, S, P, N, Q, R = 64, 512, 64, 128, 64, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {ssd_scan.bwd_plan(n, P, N, Q, sms) for n in (BH, R)}
    assert len({p.walk_warps for p in plans}) == 2
    x, dt, a, b, c = _ssd_inputs(BH, S, P, N, "float32", 5, R)
    dy = torch.randn((BH, S, P), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(6))
    _, _, st = ssd_scan.ssd_scan(x, dt, a, b, c, chunk=Q, keep_states=True)
    whole = ssd_scan.ssd_scan_bwd(x, dt, a, b, c, st, dy, None, chunk=Q)
    for i in range(BH // R):
        hs, rs = slice(i * R, (i + 1) * R), slice(i, i + 1)
        one = ssd_scan.ssd_scan_bwd(
            *(t[hs].contiguous() for t in (x, dt, a)),
            *(t[rs].contiguous() for t in (b, c)), st[hs].contiguous(),
            dy[hs].contiguous(), None, chunk=Q)
        for w, o in zip(whole, one):
            assert torch.equal(w[rs] if w.shape[0] == BH // R else w[hs], o)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3])
def test_ssd_scan_vmap_grad_is_one_launch_of_per_learner_calls(m):
    """The learners' vmap folds into BH and b, c's rows: one forward and
    one backward launch for m learners, bit for bit the per-learner
    calls."""
    _need_card()
    ins = [torch.stack(t) for t in zip(*(
        _ssd_inputs(8, 128, 64, 128, "float32", i, 4) for i in range(m)))]
    dy = torch.randn((m, 8, 128, 64), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(m))

    def loss(x, dt, a, b, c, dy):
        return (ssd_scan.SSDScanFn.apply(x, dt, a, b, c, 32)[0] * dy).sum()
    ops.reset_launches()
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *ins, dy)
    assert (ops.LAUNCHES["ssd_scan"], ops.LAUNCHES["ssd_scan_bwd"]) == (1, 1)
    for i in range(m):
        xi = [t[i] for t in ins]
        _, _, st = ssd_scan.ssd_scan(*xi, chunk=32, keep_states=True)
        one = ssd_scan.ssd_scan_bwd(*xi, st, dy[i], None, chunk=32)
        for g, w in zip(got, one):
            assert torch.equal(g[i], w)


@pytest.mark.cuda
def test_ssd_scan_backward_through_ops_matches_plain():
    """A padded S (300, chunk 64) under a gradient through ops.ssd_scan,
    with both outputs read: one launch of each kernel."""
    _need_card()
    ins = _ssd_inputs(4, 300, 64, 128, "float32", 7, 2)
    leaves = [t.clone().requires_grad_() for t in ins]
    gen = torch.Generator(device="cuda").manual_seed(8)
    dy = torch.randn((4, 300, 64), generator=gen, device="cuda")
    dh = torch.randn((4, 64, 128), generator=gen, device="cuda")
    ops.reset_launches()
    y, h = ops.ssd_scan(*leaves, chunk=64)
    torch.autograd.backward((y, h), (dy, dh))
    assert (ops.LAUNCHES["ssd_scan"], ops.LAUNCHES["ssd_scan_bwd"]) == (1, 1)
    want = ref.ssd_scan_bwd_ref(*ins, dy, dh)
    for t, w in zip(leaves, want):
        assert _grad_gap(t.grad, w) <= GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,d,w", [(1, 512, 25, 5, 64, 128),
                                           (2, 256, 4, 4, 32, 64),
                                           (1, 192, 1, 1, 128, 64)])
def test_swa_attention_backward_through_ops_matches_plain(B, S, H, Hkv, d,
                                                          w):
    """The banded route under a gradient: one forward launch counted as
    swa_attention, one attention_bwd, the gradient within GRAD_REL of the
    plain banded attention's; H = 1 in the (B, S, d) layout."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(S + H)
    shapes = [(B, S, H, d), (B, S, Hkv, d), (B, S, Hkv, d)]
    ins = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    if H == 1:
        ins = [t[:, :, 0].contiguous() for t in ins]
    leaves = [t.clone().requires_grad_() for t in ins]
    ops.reset_launches()
    out = ops.swa_attention(*leaves, window=w)
    out.square().sum().backward()
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {
        "swa_attention": 1, "attention_bwd": 1}
    plain = [t.clone().requires_grad_() for t in ins]
    ref.swa_attention_ref(*plain, window=w).square().sum().backward()
    for got, want in zip(leaves, plain):
        assert _grad_gap(got.grad, want.grad) <= GRAD_REL
