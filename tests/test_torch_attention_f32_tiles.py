"""The arithmetic of the f32 split-TF32 attention program
(``src/repro_torch/kernels/csrc/attention.cu``), modelled in plain
PyTorch on the CPU and held against the JAX package.

The model repeats the kernel's loop: query tiles of 16-row warps (12
warps at head dim 128, 8 otherwise), each walking the 32-key tiles of the
query tile's key range; every product (Q K^T and P V) in split TF32 with
the rounding emulated on the f32 bits: hi = v rounded to TF32 (to nearest, ties away from zero, as
the kernel's two integer operations do), lo = v - hi read by the tensor
cores as TF32 (truncated), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi; the
scores in log2 units (times scale * log2(e) in f32) with exp2; the
running max, the rescale and the denominator in f32. The model also
checks the kernel's two shortcuts on every tile and warp: a warp the
kernel skips keeps no key of the tile, and a tile the kernel does not
mask keeps every key of the warp's rows. It lives here and not in the
package: ``repro_torch.kernels.ref`` keeps the exact f32 plain version
as the one plain version.

Tolerance: the card checks' f32 attention tolerance (``chip_smoke.py``'s
``LM_TOL``, ``tests/test_torch_cuda.py``), rtol 1e-4 / atol 1e-5. One case
shows why every product is split: the same loop with one TF32 product
misses it.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, flash_attention  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BK, WARP_ROWS = 32, 16
WARPS = {128: 12}         # warps a block by query/key width; 8 otherwise
LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _bits(v):
    return v.contiguous().view(torch.int32)


def tf32_rna(v):
    """v rounded to TF32, to nearest with ties away from zero."""
    return ((_bits(v) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(v):
    """v as the tensor cores read an unrounded TF32 operand."""
    return (_bits(v) & ~0x1FFF).view(torch.float32)


def product(a, b, *, split=True):
    """a @ b as the kernel's mma.sync computes it: split TF32 (three
    products, the small ones first), or with ``split=False`` one TF32
    product of the rounded operands."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if not split:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _warp_checks(keep, k0, pos0s, Sk, causal, window):
    """The kernel's per-warp shortcuts on one tile: ``keep`` (rows, BK)
    over the query tile's rows, ``pos0s`` the position of each warp's
    first row."""
    for w, pos0 in enumerate(pos0s):
        kw = keep[WARP_ROWS * w:WARP_ROWS * (w + 1)]
        skip = ((causal and k0 > pos0 + WARP_ROWS - 1)
                or (window > 0 and k0 + BK - 1 <= pos0 - window))
        edge = (k0 + BK > Sk or (causal and k0 + BK - 1 > pos0)
                or (window > 0 and k0 <= pos0 + WARP_ROWS - 1 - window))
        if skip:
            assert not bool(kw.any()), "a skipped tile keeps a key"
        elif not edge:
            assert bool(kw.all()), "an unmasked tile drops a key"


def tile_model(q, k, v, *, causal, window, scale=None, split=True):
    """q (B, Sq, H, d), k (B, Sk, Hkv, d), v (B, Sk, Hkv, dv) f32 ->
    (B, Sq, H, dv) f32, computed as the kernel's tile loop computes it."""
    B, Sq, H, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    BQ = WARP_ROWS * WARPS.get(d, 8)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qf = q.permute(0, 2, 1, 3)                                 # (B, H, Sq, d)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    out = torch.zeros((B, H, Sq, dv), dtype=torch.float32)
    q_off = Sk - Sq
    for q0 in range(0, Sq, BQ):
        q_last = min(q0 + BQ, Sq) - 1
        k_hi = min(Sk, q_off + q_last + 1) if causal else Sk
        k_lo = max(0, q_off + q0 - window + 1) if window > 0 else 0
        t_lo = k_lo // BK
        n_t = (k_hi + BK - 1) // BK - t_lo if k_hi > k_lo else 0
        n = min(Sq, q0 + BQ) - q0
        qt = torch.zeros((B, H, BQ, d))
        qt[:, :, :n] = qf[:, :, q0:q0 + n]             # rows >= Sq read zeros
        qpos = torch.arange(q0, q0 + BQ) + q_off
        pos0s = [q_off + q0 + WARP_ROWS * w for w in range(BQ // WARP_ROWS)]
        m = torch.full((B, H, BQ), NEG_INF)
        lsum = torch.zeros((B, H, BQ))
        o = torch.zeros((B, H, BQ, dv))
        for t in range(t_lo, t_lo + n_t):
            k0 = t * BK
            nk = min(Sk, k0 + BK) - k0
            kt = torch.zeros((B, H, BK, d))
            vt = torch.zeros((B, H, BK, dv))
            kt[:, :, :nk], vt[:, :, :nk] = (kf[:, :, k0:k0 + nk],
                                            vf[:, :, k0:k0 + nk])
            kpos = torch.arange(k0, k0 + BK)
            keep = (kpos[None, :] < Sk).expand(BQ, BK)
            if causal:
                keep = keep & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                keep = keep & (kpos[None, :] > qpos[:, None] - window)
            _warp_checks(keep, k0, pos0s, Sk, causal, window)
            s = torch.where(keep, product(qt, kt.transpose(-1, -2),
                                          split=split) * sl2, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(keep, torch.exp2(s - m_new[..., None]), 0.0)
            lsum = lsum * alpha + p.sum(-1)
            o = o * alpha[..., None] + product(p, vt, split=split)
            m = m_new
        res = o / lsum.clamp_min(1e-30)[..., None]
        out[:, :, q0:q0 + n] = res[:, :, :n]
    return out.permute(0, 2, 1, 3)


def _inputs(B, Sq, Sk, H, Hkv, d, seed, dv=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Sq, H, d), (B, Sk, Hkv, d), (B, Sk, Hkv, dv or d))]
    return [torch.from_numpy(a) for a in arrs], [jnp.asarray(a) for a in arrs]


def _oracle(jq, jk, jv, *, causal, window):
    """``repro.kernels.ref.flash_attention_ref`` per (batch, head), query
    head h reading kv head h // (H // Hkv)."""
    B, Sq, H, d = jq.shape
    Sk, Hkv, dv = jk.shape[1], jk.shape[2], jv.shape[3]
    G = H // Hkv
    qg = jq.transpose(0, 2, 1, 3).reshape(B * H, Sq, d)
    kg = jnp.repeat(jk.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk, d)
    vg = jnp.repeat(jv.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk,
                                                                 dv)
    out = jref.flash_attention_ref(qg, kg, vg, causal=causal, window=window)
    return np.asarray(out).reshape(B, H, Sq, dv).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window,pallas", [
    (1, 100, 200, 4, 2, 64, True, 0, True),     # GQA, causal, ragged Sq < Sk
    (2, 160, 160, 4, 1, 32, True, 24, True),    # window 24
    (1, 256, 256, 4, 2, 128, True, 64, False),  # window of two key tiles
    (1, 70, 150, 4, 2, 32, False, 0, False),    # non-causal ragged Sk (C1)
    (1, 200, 200, 4, 1, 128, True, 0, True),    # d 128, Sq past one tile
    (1, 1, 77, 8, 8, 128, True, 0, False),      # one query row (decode)
])
def test_tile_loop_matches_the_reference(B, Sq, Sk, H, Hkv, d, causal,
                                         window, pallas):
    (q, k, v), (jq, jk, jv) = _inputs(B, Sq, Sk, H, Hkv, d,
                                      Sq + Sk + d + window)
    got = tile_model(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(
        got, _oracle(jq, jk, jv, causal=causal, window=window), **F32_TOL)
    if pallas:
        # the GQA front end over the Pallas kernel, in interpret mode
        out = jops.flash_attention_gqa(jq, jk, jv, causal=causal,
                                       window=window, block_q=64, block_k=64)
        np.testing.assert_allclose(got, np.asarray(out), **F32_TOL)


@pytest.mark.parametrize("B,S,H,d,dv,causal", [
    (2, 70, 4, 48, 32, True),       # deepseek-v2's smoke widths
    (1, 150, 2, 192, 128, True),    # its full widths, past one query tile
    (1, 70, 2, 192, 128, False),
])
def test_mla_widths_tile_loop_matches_the_reference(B, S, H, d, dv, causal):
    """MLA's query/key width above its value width: the same loop with K
    tiles of d and V tiles of dv columns, the scale 1 / sqrt(d), against
    the JAX package's plain attention (its Pallas front end takes one
    width)."""
    (q, k, v), (jq, jk, jv) = _inputs(B, S, S, H, H, d, S + H + d, dv=dv)
    got = tile_model(q, k, v, causal=causal, window=0)
    assert got.shape == (B, S, H, dv)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(jq, jk, jv, causal=causal, window=0),
                               **F32_TOL)


def test_one_tf32_product_breaks_the_tolerance():
    """Why every product is split: with each operand rounded once to TF32
    the same loop misses the f32 tolerance at (1, 512, 4, 128) causal;
    split, it holds."""
    (q, k, v), (jq, jk, jv) = _inputs(1, 512, 512, 4, 4, 128, 7)
    want = _oracle(jq, jk, jv, causal=True, window=0)
    tol = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
    once = tile_model(q, k, v, causal=True, window=0, split=False).numpy()
    split = tile_model(q, k, v, causal=True, window=0).numpy()
    assert int((np.abs(once - want) > tol).sum()) > 0
    assert int((np.abs(split - want) > tol).sum()) == 0


def test_model_has_the_kernels_geometry():
    """The tiles and the rounding modelled here are the ones the kernel
    source declares, and it runs the products on the tensor cores."""
    src = (_build.CSRC / "attention.cu").read_text()

    def const(pattern):
        return int(re.search(pattern, src).group(1))
    rule = re.search(r"constexpr int kWarps = DK == (\d+) \? (\d+) : (\d+);",
                     src)
    assert WARPS == {int(rule.group(1)): int(rule.group(2))}
    assert int(rule.group(3)) == 8
    assert "static constexpr int kBQ = 16 * kWarps;" in src
    assert const(r"constexpr int kBK = (\d+);") == BK
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "0x1000u) & 0xffffe000u" in src
    assert "exp2f" in src and "1.4426950408889634f" in src
    for dk, dv in flash_attention.WIDTHS[torch.float32]:
        assert f"REPRO_ATTENTION_CASE({dk}, {dv})" in src


def test_f32_program_takes_any_number_of_heads():
    """The f32 program's grid is one-dimensional: the wrapper keeps no cap
    on (batch, head) pairs, and the program is the split-TF32 one."""
    assert flash_attention.program(torch.float32) == "sm90_mma_tf32x3"
    assert not hasattr(flash_attention, "_MAX_BH")
    src = (_build.CSRC / "attention.cu").read_text()
    assert "blockIdx.y" not in src and "gridDim.y" not in src
