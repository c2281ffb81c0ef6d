"""The two backward kernels' arithmetic, modelled in plain PyTorch on the
CPU and held against ``jax.grad`` of the JAX package's jnp attention and
RMS norm, and the autograd / vmap plumbing around them.

* ``attention_bwd`` (``csrc/attention_bwd.cu``), its split-TF32 program:
  delta = rowsum(do o); the dk/dv pass, blocks of 16 P keys (P warp
  pairs of 16: six where their tiles fit a block's shared memory, else
  four, as at MLA's (192, 128), ``_plan``) of one query head, each walking the
  32-row query tiles of the range the kernel bounds, the query heads'
  partials then summed over each kv head's group in head order; the dq
  pass, blocks of 16 P query rows walking the 32-key tiles of the
  forward's range.
  Every product (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q;
  S, dP and dQ += dS K) in split TF32 with the rounding emulated on the
  f32 bits (hi = v rounded to TF32, to nearest with ties away from zero,
  lo = v - hi read by the tensor cores as TF32, a b = a_lo b_hi + a_hi
  b_lo + a_hi b_hi); S and dP as a pair's two warps sum them, each over
  half of its width (S over the query/key width d, dP over the value
  width dv: 96 / 64 at (192, 128), 24 / 16 at (48, 32)), half 0's plus
  half 1's; each tile's dV, dK and dQ product
  added to the running sums in f32; p = exp2(fma(s, scale log2(e), -lse
  log2(e))) with the masks, lse the forward's log-sum-exp (+inf in log2
  units for a row that keeps nothing). On every tile the model checks
  the kernel's per-pair shortcuts (16 rows it skips keep no pair, a tile
  it does not mask keeps every pair) and counts the pairs each pass
  visits: every kept (query, key, head) triple once. Cases: ragged S
  (100, 130), GQA groups 1 and 4, head dims 32, 64 and 128, a window,
  non-causal with Sk != Sq, a right-aligned diagonal; and MLA's width
  pairs (192, 128) and (48, 32), causal and ragged non-causal, groups 1
  and 2 (``MLA_CASES``). Tolerance: dq, dk
  and dv within ``GRAD_TOL`` of the largest entry of each (f32 on both
  sides, summed in other orders); one case shows that one TF32 product
  a product misses it.
* ``rmsnorm_bwd`` (``csrc/rmsnorm_bwd.cu``): ``rmsnorm.bwd_plan``'s
  partition (chunks of rows within a group; in f32 threads of 4 columns,
  in bf16 a thread's scalar head column, its 16-byte vectors and its
  scalar tail column, ``_thread_columns``), each
  thread's column sums in order with f32 multiply-adds, the
  warps' xor butterflies and the warp sums in warp order, the chunk's
  dscale partial and each group's partials summed in chunk order,
  against ``jax.grad`` of the reference's jnp norm with a scale per
  group: D 768, 1,601 (no multiple of 4) and 4,096; 1 and 4 groups.
  The model does not claim the kernel's last bits (nvcc contracts its
  multiply-adds its own way); it holds the partition and the orders.
* The plumbing: ``AttentionFn`` and ``RMSNormFn`` called directly with
  their launch functions replaced by stand-ins (the plain versions) that
  assert they receive plain, unwrapped tensors and count their calls:
  ``vmap(grad_and_value)`` over m = 3 learners equals the plain versions'
  result, with one forward and one backward call per op whatever m,
  and ``loss.backward()`` equals ``torch.func.grad``.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

GRAD_TOL = 1e-5
BT, WARP = 32, 16    # streamed rows a tile, a warp pair's rows
SMEM = 232448        # shared-memory bytes a block may opt in to
LOG2E = 1.4426950408889634


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ attention

def _jax_gqa(q, k, v, causal, window):
    """The reference's jnp attention on the GQA layout (its ops' fold)."""
    B, Sq, H, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, d).transpose(0, 2, 3, 1, 4)
    qg = qg.reshape(B * H, Sq, d)
    kg = jnp.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk, d)
    vg = jnp.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, Sk,
                                                                dv)
    o = jref.flash_attention_ref(qg, kg, vg, causal=causal, window=window)
    return o.reshape(B, Hkv, G, Sq, dv).transpose(0, 3, 1, 2, 4).reshape(
        B, Sq, H, dv)


def _kept(qpos, kpos, Sk, causal, window):
    """The forward's mask at positions qpos, kpos (broadcast)."""
    keep = (kpos < Sk) & (qpos >= qpos.min())
    if causal:
        keep = keep & (kpos <= qpos)
    if window > 0:
        keep = keep & (kpos > qpos - window)
    return keep


def _bits(v):
    return v.contiguous().view(torch.int32)


def tf32_rna(v):
    """v rounded to TF32, to nearest with ties away from zero."""
    return ((_bits(v) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(v):
    """v as the tensor cores read an unrounded TF32 operand."""
    return (_bits(v) & ~0x1FFF).view(torch.float32)


def product(a, b, split=True):
    """a @ b as mma.sync computes it: split TF32, the small terms first,
    or with ``split=False`` one TF32 product of the rounded operands."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if not split:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _fma_f32(a, b, c):
    """fmaf(a, b, c) on f32 tensors: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _rows(x, r0, n, n_rows, fill=0.0):
    """Rows [r0, r0 + n) of x (..., rows, *) on dim 2, ``fill`` past
    n_rows."""
    out = torch.full((*x.shape[:2], n, *x.shape[3:]), fill)
    hi = min(r0 + n, n_rows)
    if hi > r0:
        out[:, :, :hi - r0] = x[:, :, r0:hi]
    return out


def _warps(keep, n_real, starts, skip, edge, rows=WARP):
    """The kernel's per-warp shortcuts on one tile: ``keep`` (rows, cols)
    over the block's warps of ``rows`` rows (16; 64 for a warpgroup of
    the bf16 program), whose flags ``skip`` and ``edge`` come from their
    first row ``starts``; rows from ``n_real`` on lie past the tensor.
    Returns the rows the kernel computes."""
    active = torch.zeros(keep.shape[0], dtype=torch.bool)
    for w, r in enumerate(starts):
        kw = keep[rows * w:rows * (w + 1)]
        if skip(r):
            assert not bool(kw[:max(0, n_real - rows * w)].any()), \
                "a skipped warp keeps a pair"
            continue
        if not edge(r):
            assert bool(kw.all()), "an unmasked tile drops a pair"
        active[rows * w:rows * (w + 1)] = True
    return active


def _plan(d, dv):
    """The kernel's Plan<d, dv>: (warp pairs a block, its shared-memory
    bytes), 6 pairs where their tiles fit, else 4."""
    def nbytes(pairs):
        return 4 * (16 * pairs * (d + dv + 8) + 2 * (BT * (d + dv + 8) + 2 * BT)
                    + 2 * pairs * 2 * BT * 16)
    pairs = 6 if nbytes(6) <= SMEM else 4
    return pairs, nbytes(pairs)


def attention_bwd_model(q, k, v, o, lse, do, causal, window, *,
                        split=True):
    """The kernel's passes on f32 tensors q (B, Sq, H, d), k (B, Sk, Hkv,
    d), v (B, Sk, Hkv, dv), o and do (B, Sq, H, dv): (dq, dk, dv) and the
    visits of each pass, (B, H, Sq, Sk) counts of the pairs it computed
    that the mask keeps."""
    B, Sq, H, d = q.shape
    Sk, Hkv, dw = k.shape[1], k.shape[2], v.shape[3]
    BR = WARP * _plan(d, dw)[0]
    G, off = H // Hkv, Sk - Sq
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, of, dof = (x.permute(0, 2, 1, 3) for x in (q, o, do))  # (B, H, S, d)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    delta = (dof * of).sum(-1)                                 # (B, H, Sq)
    lse2 = torch.where(torch.isinf(lse), torch.tensor(math.inf),
                       lse * torch.tensor(LOG2E, dtype=torch.float32))
    seen_kv = torch.zeros((B, H, Sq, Sk), dtype=torch.int32)
    seen_q = torch.zeros_like(seen_kv)
    prod = lambda a, b: product(a, b, split=split)  # noqa: E731

    def pair(a, b):
        """a @ b^T over their width as a warp pair sums it: each warp over
        its half, then half 0's sum plus half 1's."""
        h = a.shape[-1] // 2
        return (prod(a[..., :h], b[..., :h].transpose(-1, -2))
                + prod(a[..., h:], b[..., h:].transpose(-1, -2)))

    # dk, dv: blocks of BR keys of one query head
    part_k = torch.zeros((B, H, Sk, d))
    part_v = torch.zeros((B, H, Sk, dw))
    for k0 in range(0, Sk, BR):
        i_lo = max(0, k0 - off) if causal else 0
        i_hi = min(Sq, k0 + BR - 1 + window - off) if window > 0 else Sq
        t_lo = i_lo // BT
        n_t = -(-i_hi // BT) - t_lo if i_hi > i_lo else 0
        nk = min(BR, Sk - k0)
        kpos = torch.arange(k0, k0 + BR)[:, None]
        kt, vt = _rows(kf, k0, BR, Sk), _rows(vf, k0, BR, Sk)
        acc_k = torch.zeros((B, H, BR, d))
        acc_v = torch.zeros((B, H, BR, dw))
        for t in range(t_lo, t_lo + n_t):
            q0 = t * BT
            qt, dot = _rows(qf, q0, BT, Sq), _rows(dof, q0, BT, Sq)
            l2 = _rows(lse2[..., None], q0, BT, Sq, math.inf)[..., 0]
            dl = _rows(delta[..., None], q0, BT, Sq)[..., 0]
            lo, hi = q0 + off, q0 + off + BT - 1
            keep = _kept(torch.arange(lo, hi + 1)[None, :], kpos, Sk, causal,
                         window)
            active = _warps(
                keep, nk, range(k0, k0 + BR, WARP),
                lambda r: r >= Sk or (causal and r > hi) or (
                    window > 0 and r + WARP - 1 <= lo - window),
                lambda r: r + WARP - 1 >= Sk or (
                    causal and r + WARP - 1 > lo) or (
                    window > 0 and r <= hi - window))
            on = keep & active[:, None]
            st, dpt = pair(kt, qt), pair(vt, dot)
            p = torch.exp2(_fma_f32(st, sl2, -l2[..., None, :]))
            p = torch.where(on, p, torch.zeros(()))
            ds = p * (dpt - dl[..., None, :])
            acc_v = acc_v + prod(p, dot)
            acc_k = acc_k + prod(ds, qt)
            nq = min(BT, Sq - q0)
            seen_kv[:, :, q0:q0 + nq, k0:k0 + nk] += on[:nk, :nq].T.int()
        part_k[:, :, k0:k0 + nk] = acc_k[:, :, :nk]
        part_v[:, :, k0:k0 + nk] = acc_v[:, :, :nk]
    # the fourth launch (G > 1): each group's partials summed in head order
    dk, dv = part_k[:, ::G].clone(), part_v[:, ::G].clone()
    for hh in range(1, G):
        dk = dk + part_k[:, hh::G]
        dv = dv + part_v[:, hh::G]
    dk = dk * scale

    # dq: blocks of BR query rows walking BT-key tiles
    dq = torch.zeros((B, H, Sq, d))
    for q0 in range(0, Sq, BR):
        q_last = min(q0 + BR, Sq) - 1
        k_hi = min(Sk, off + q_last + 1) if causal else Sk
        k_lo = max(0, off + q0 - window + 1) if window > 0 else 0
        t_lo = k_lo // BT
        n_t = -(-k_hi // BT) - t_lo if k_hi > k_lo else 0
        nq = min(BR, Sq - q0)
        qt, dot = _rows(qf, q0, BR, Sq), _rows(dof, q0, BR, Sq)
        l2 = _rows(lse2[..., None], q0, BR, Sq, math.inf)
        dl = _rows(delta[..., None], q0, BR, Sq)
        qpos = torch.arange(q0, q0 + BR)[:, None] + off
        acc = torch.zeros((B, H, BR, d))
        for t in range(t_lo, t_lo + n_t):
            k0 = t * BT
            kt, vt = _rows(kf, k0, BT, Sk), _rows(vf, k0, BT, Sk)
            keep = _kept(qpos, torch.arange(k0, k0 + BT)[None, :], Sk,
                         causal, window)
            active = _warps(
                keep, nq, range(q0, q0 + BR, WARP),
                lambda r: r >= Sq or (causal and k0 > r + off + WARP - 1) or (
                    window > 0 and k0 + BT - 1 <= r + off - window),
                lambda r: k0 + BT > Sk or (causal and k0 + BT - 1 > r + off)
                or (window > 0 and k0 <= r + off + WARP - 1 - window))
            on = keep & active[:, None]
            s, dp = pair(qt, kt), pair(dot, vt)
            p = torch.where(on, torch.exp2(_fma_f32(s, sl2, -l2)),
                            torch.zeros(()))
            acc = acc + prod(p * (dp - dl), kt)
            nk = min(BT, Sk - k0)
            seen_q[:, :, q0:q0 + nq, k0:k0 + nk] += on[:nq, :nk].int()
        dq[:, :, q0:q0 + nq] = acc[:, :, :nq] * scale
    grads = (dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3),
             dv.permute(0, 2, 1, 3))
    return grads, (seen_kv, seen_q)


ATTN_CASES = [  # B, Sq, Sk, H, Hkv, d, causal, window
    (2, 100, 100, 4, 4, 64, True, 0),      # ragged S, group 1
    (1, 130, 130, 8, 2, 128, True, 0),     # ragged past one block, group 4
    (1, 150, 150, 4, 1, 64, True, 40),     # a window, group 4
    (2, 70, 100, 2, 2, 32, False, 0),      # non-causal, Sk != Sq
    (1, 90, 200, 4, 1, 128, True, 0),      # right-aligned diagonal
]


MLA_CASES = [  # B, Sq, Sk, H, Hkv, d, dv, causal, window
    (1, 100, 100, 2, 2, 192, 128, True, 0),    # deepseek-v2's widths
    (2, 70, 100, 2, 2, 192, 128, False, 0),    # ragged non-causal
    (2, 110, 110, 4, 4, 48, 32, True, 0),      # the smoke config's
    (1, 60, 130, 4, 2, 48, 32, False, 0),      # group 2, Sk != Sq
]


def _attn_case(case, **kw):
    """The model's gradients at ``case`` (an ATTN_CASES or MLA_CASES
    row), its visits, and the JAX package's gradients."""
    if len(case) == 8:
        case = case[:6] + (case[5],) + case[6:]
    B, Sq, Sk, H, Hkv, d, dv, causal, window = case
    rng = np.random.default_rng(sum(case[:7]))
    q, k, v, do = (_rand(rng, B, Sq, H, d), _rand(rng, B, Sk, Hkv, d),
                   _rand(rng, B, Sk, Hkv, dv), _rand(rng, B, Sq, H, dv))
    o, vjp = jax.vjp(lambda *a: _jax_gqa(*a, causal, window), q, k, v)
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = ref.attention_lse_ref(tq, tk, causal=causal, window=window)
    got, seen = attention_bwd_model(tq, tk, tv, torch.from_numpy(np.array(o)),
                                    lse, tdo, causal, window, **kw)
    return got, seen, want


def _gaps(got, want):
    return [float(np.abs(g.numpy() - w).max()) / float(np.abs(w).max())
            for g, w in zip(got, want)]


def _check_attn_case(case):
    B, Sq, Sk, H = case[:4]
    causal, window = case[-2:]
    got, seen, want = _attn_case(case)
    kept = _kept(torch.arange(Sq)[:, None] + Sk - Sq,
                 torch.arange(Sk)[None, :], Sk, causal, window)
    for visits in seen:       # every kept triple once, in each pass
        assert torch.equal(visits, kept.int().expand(B, H, Sq, Sk))
    assert max(_gaps(got, want)) <= GRAD_TOL


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bwd_model_matches_jax_grad(case):
    _check_attn_case(case)


@pytest.mark.parametrize("case", MLA_CASES)
def test_attention_bwd_model_matches_jax_grad_at_mla_widths(case):
    """MLA's wider queries and keys: each warp of a pair takes half of
    each width, and a block of the (192, 128) program holds 64 rows."""
    _check_attn_case(case)


def test_attention_bwd_model_has_the_kernels_geometry():
    """The blocks, tiles and rounding modelled here are the ones the
    kernel source declares, for every width pair it is compiled for; its
    products run on the tensor cores and no float sum goes through an
    atomic."""
    src = (_build.CSRC / "attention_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             src).group(1))
    assert const("kBT") == BT and const("kMaxPairs") == 6
    assert const("kMaxSmem") == SMEM and const("kStages") == 2
    assert "constexpr int kSwap = 2 * kBT * 16;" in src
    assert "16 * pairs * (ldq + ldv) + kStages * (kBT * (ldq + ldv) + 2 * kBT)" \
        in src and "2 * pairs * kSwap" in src
    # 4 pairs where 6 do not fit, unless a build defines another count
    assert "#define REPRO_BWD_NARROW_PAIRS 4\n" in src
    assert "constexpr int kNarrowPairs = REPRO_BWD_NARROW_PAIRS;" in src
    assert ("plan_bytes(LDQ, LDV, kMaxPairs) <= kMaxSmem ? kMaxPairs : "
            "kNarrowPairs;") in src
    assert "static constexpr int kBR = 16 * kPairs;" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "0x1000u) & 0xffffe000u" in src
    assert "exp2f(fmaf(" in src and "1.4426950408889634f" in src
    assert "atomicAdd" not in src and "atom." not in src
    assert fa.BWD_WIDTHS[torch.float32] == fa.WIDTHS[torch.float32]
    for d, dv in fa.BWD_WIDTHS[torch.float32]:
        assert f"REPRO_ATTENTION_BWD_CASE({d}, {dv})" in src
    # the budget the source's comment gives
    assert _plan(128, 128) == (6, 218624) and _plan(192, 128) == (4, 201216)
    assert _plan(48, 32)[0] == 6 and _plan(32, 32)[0] == 6


def test_attention_bwd_one_tf32_product_misses():
    """Why every product is split: one TF32 product a product misses
    GRAD_TOL by more than an order of magnitude."""
    got, _, want = _attn_case(ATTN_CASES[1], split=False)
    assert max(_gaps(got, want)) > 10 * GRAD_TOL


# -------------------------------------------------------------- rmsnorm

def _fma(a, b, c):
    """f32 fused multiply-add, rounded once (via f64, exact products)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(v):
    """The xor butterfly over a warp's 32 lanes (the last axis)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v


def _thread_columns(D, threads, dtype, h=0):
    """Each thread's columns of a row in the order it sums them, (threads,
    L), and which are real: f32 columns t, t + threads, ...; bf16 (a row
    whose first h values lie before its first 16-byte boundary) the
    head's column t, then the columns of vectors t, t + threads, ...
    (8 each), then the tail's column t."""
    t = torch.arange(threads)[:, None]
    if dtype != torch.bfloat16:
        idx = t + threads * torch.arange(-(-D // threads))
        return idx.clamp(max=D - 1), idx < D
    nb = (D - h) // 8
    tail = h + 8 * nb
    nv = -(-(D // 8) // threads)
    j = t + threads * torch.arange(nv)                   # (threads, nv)
    body = (h + 8 * j[..., None] + torch.arange(8)).reshape(threads, -1)
    body_on = (j < nb)[..., None].expand(threads, nv, 8).reshape(threads, -1)
    idx = torch.cat([t, body, tail + t], 1)
    on = torch.cat([t < h, body_on, t < D - tail], 1)
    return idx.clamp(max=D - 1), on


def rmsnorm_bwd_model(x, scale, dy, eps, dtype=torch.float32):
    """dx and dscale (g, D) as the kernel partitions and orders them for
    rows of ``dtype`` (the values given in f32): a row's columns split
    among the threads by ``_thread_columns``, a bf16 row at its own offset
    from a 16-byte boundary (x's first row on one)."""
    rows, D = x.shape
    g = scale.shape[0]
    R = rows // g
    threads, chunk, chunks = rn.bwd_plan(rows, D, g, dtype)
    heads = {}                       # a row's head -> its threads' columns
    eps32 = torch.tensor(eps, dtype=torch.float32)
    dx = torch.empty_like(x)
    partial = torch.zeros((g * chunks, D))
    for c in range(g * chunks):
        gi, ci = divmod(c, chunks)
        s = scale[gi]
        for r in range(gi * R + ci * chunk, gi * R + min(R, (ci + 1) * chunk)):
            mis = r * D % 8
            h = min(D, 8 - mis if mis else 0) if dtype == torch.bfloat16 \
                else 0
            if h not in heads:
                heads[h] = _thread_columns(D, threads, dtype, h)
            idx, valid = heads[h]
            xv, gv, sv = x[r][idx], dy[r][idx], s[idx]
            a = torch.zeros(threads)
            b = torch.zeros(threads)
            for j in range(idx.shape[1]):
                on = valid[:, j]
                a = torch.where(on, _fma(gv[:, j] * sv[:, j], xv[:, j], a), a)
                b = torch.where(on, _fma(xv[:, j], xv[:, j], b), b)
            wa = _butterfly(a.view(-1, 32))[:, 0]
            wb = _butterfly(b.view(-1, 32))[:, 0]
            sa = torch.zeros(())
            sb = torch.zeros(())
            for w in range(threads // 32):
                sa = sa + wa[w]
                sb = sb + wb[w]
            rr = 1.0 / torch.sqrt(sb / D + eps32)
            coef = sa * (rr * rr * rr) / D
            dx[r] = dy[r] * s * rr - x[r] * coef
            partial[c] = _fma(dy[r], x[r] * rr, partial[c])
    dscale = torch.zeros((g, D))
    for gi in range(g):
        for k in range(chunks):
            dscale[gi] = dscale[gi] + partial[gi * chunks + k]
    return dx, dscale


@pytest.mark.parametrize("rows,D,g", [(64, 768, 1), (64, 768, 4),
                                      (40, 1601, 1), (24, 4096, 4)])
def test_rmsnorm_bwd_model_matches_jax_grad(rows, D, g):
    rng = np.random.default_rng(rows + D + g)
    x, dy = _rand(rng, rows, D), _rand(rng, rows, D)
    scale = 1.0 + 0.1 * _rand(rng, g, D)

    def f(x, scale):
        y = jax.vmap(lambda xs, s: jref.rmsnorm_ref(xs, s))(
            x.reshape(g, rows // g, D), scale)
        return y.reshape(rows, D)

    _, vjp = jax.vjp(f, x, scale)
    want_dx, want_ds = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    dx, ds = rmsnorm_bwd_model(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(dy), 1e-5)
    for got, want in ((dx, want_dx), (ds, want_ds)):
        assert float(np.abs(got.numpy() - want).max()) <= \
            GRAD_TOL * float(np.abs(want).max())


def test_bwd_plan_partitions_the_rows():
    for rows, D, g in [(1, 7, 1), (4096, 4096, 1), (4096, 4096, 4),
                       (2048, 768, 4), (300, 100, 3), (8, 16_384, 8),
                       (4096, 4100, 1)]:
        for dtype in (torch.float32, torch.bfloat16):
            threads, chunk, chunks = rn.bwd_plan(rows, D, g, dtype)
            assert threads % 32 == 0 and 32 <= threads <= rn.BWD_THREADS
            R = rows // g
            assert 1 <= chunk <= R and \
                (chunks - 1) * chunk < R <= chunks * chunk
            assert g * chunks <= rn.BWD_BLOCKS * 2
            if dtype == torch.bfloat16:
                # every whole 16-byte vector a thread's, at most 4 a
                # thread, and each column of a row one thread's once,
                # whatever its offset from a 16-byte boundary
                assert D // 8 <= max(rn.BWD_VECTORS) * threads
                for h in range(min(D, 8)):
                    idx, on = _thread_columns(D, threads, dtype, h)
                    assert sorted(idx[on].tolist()) == list(range(D))


# ------------------------------------------------------------- plumbing

class StandIns:
    """Plain-version launch functions that refuse wrapped tensors."""

    def __init__(self, monkeypatch):
        self.calls = {"attn": 0, "attn_bwd": 0, "norm": 0, "norm_bwd": 0}
        for mod, name, fn in (
                (fa, "launch_forward", self.attn),
                (fa, "launch_backward", self.attn_bwd),
                (rn, "launch_forward", self.norm),
                (rn, "launch_backward", self.norm_bwd)):
            monkeypatch.setattr(mod, name, fn)

    @staticmethod
    def _plain(*tensors):
        from torch._C._functorch import is_functorch_wrapped_tensor
        for t in tensors:
            assert not is_functorch_wrapped_tensor(t), "a wrapped tensor"
            t.data_ptr()            # a plain tensor has its storage

    def attn(self, q, k, v, causal, window, scale):
        self._plain(q, k, v)
        self.calls["attn"] += 1
        o = ref.flash_attention_gqa_ref(q, k, v, causal=causal,
                                        window=window, scale=scale)
        return o, ref.attention_lse_ref(q, k, causal=causal, window=window,
                                        scale=scale)

    def attn_bwd(self, q, k, v, o, lse, do, causal, window, scale):
        self._plain(q, k, v, o, lse, do)
        self.calls["attn_bwd"] += 1
        return ref.flash_attention_gqa_bwd_ref(q, k, v, do, causal=causal,
                                               window=window, scale=scale)

    def norm(self, x, scale, eps):
        self._plain(x, scale)
        self.calls["norm"] += 1
        return ref.rmsnorm_ref(x, scale, eps)

    def norm_bwd(self, x, scale, dy, eps):
        self._plain(x, scale, dy)
        self.calls["norm_bwd"] += 1
        D = x.shape[-1]
        dx, ds = ref.rmsnorm_bwd_ref(x.reshape(-1, D), scale,
                                     dy.reshape(-1, D), eps)
        return dx.reshape(x.shape), ds


def _block(p, x, norm, attn):
    """A norm then grouped causal attention over x (B, S, 4 * 16)."""
    y = norm(x, p["scale"])
    B, S, _ = y.shape
    q = (y @ p["wq"]).reshape(B, S, 4, 16)
    k = (y @ p["wk"]).reshape(B, S, 2, 16)
    v = (y @ p["wv"]).reshape(B, S, 2, 16)
    return attn(q, k, v).square().mean()


def _kernel_loss(p, x):
    return _block(p, x, lambda x, s: rn.RMSNormFn.apply(x, s, 1e-5),
                  lambda q, k, v: fa.AttentionFn.apply(q, k, v, True, 0,
                                                       None)[0])


def _plain_loss(p, x):
    return _block(p, x, lambda x, s: ref.rmsnorm_ref(x, s, 1e-5),
                  lambda q, k, v: ref.flash_attention_gqa_ref(q, k, v))


def _params(rng, m=None):
    lead = () if m is None else (m,)
    return {"scale": torch.from_numpy(1 + 0.1 * _rand(rng, *lead, 64)),
            "wq": torch.from_numpy(0.2 * _rand(rng, *lead, 64, 64)),
            "wk": torch.from_numpy(0.2 * _rand(rng, *lead, 64, 32)),
            "wv": torch.from_numpy(0.2 * _rand(rng, *lead, 64, 32))}


@pytest.mark.parametrize("m", [1, 3])
def test_vmap_grad_one_call_per_op_whatever_m(m, monkeypatch):
    stand = StandIns(monkeypatch)
    rng = np.random.default_rng(m)
    p = _params(rng, m)
    x = torch.from_numpy(_rand(rng, m, 2, 24, 64))
    fleet = torch.func.vmap(torch.func.grad_and_value(_kernel_loss))
    grads, losses = fleet(p, x)
    assert stand.calls == {"attn": 1, "attn_bwd": 1, "norm": 1,
                           "norm_bwd": 1}
    want_g, want_l = torch.func.vmap(torch.func.grad_and_value(
        _plain_loss))(p, x)
    torch.testing.assert_close(losses, want_l, rtol=1e-6, atol=1e-7)
    for k in want_g:
        torch.testing.assert_close(grads[k], want_g[k], rtol=1e-5,
                                   atol=1e-7)


def test_backward_equals_func_grad(monkeypatch):
    stand = StandIns(monkeypatch)
    rng = np.random.default_rng(9)
    p = _params(rng)
    x = torch.from_numpy(_rand(rng, 2, 24, 64))
    want = torch.func.grad(_kernel_loss)(p, x)
    tracked = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss = _kernel_loss(tracked, x)
    assert loss.grad_fn is not None
    loss.backward()
    assert stand.calls == {"attn": 2, "attn_bwd": 2, "norm": 2,
                           "norm_bwd": 2}
    for k in p:
        torch.testing.assert_close(tracked[k].grad, want[k], rtol=1e-6,
                                   atol=1e-8)
        assert float(tracked[k].grad.abs().sum()) > 0
    plain = torch.func.grad(_plain_loss)(p, x)
    for k in p:
        torch.testing.assert_close(want[k], plain[k], rtol=1e-5, atol=1e-7)


def test_no_second_derivative(monkeypatch):
    StandIns(monkeypatch)
    rng = np.random.default_rng(4)
    p = _params(rng)
    x = torch.from_numpy(_rand(rng, 2, 24, 64))
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.func.grad(lambda p: torch.func.grad(_kernel_loss)(
            p, x)["scale"].sum())(p)
