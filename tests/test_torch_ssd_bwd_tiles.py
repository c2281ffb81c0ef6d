"""The arithmetic of the tensor-core ``ssd_scan_bwd`` program
(``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``), modelled in plain
PyTorch on the CPU, block by block and tile by tile, and held against
the JAX package.

The model repeats the kernel's launches in their order and partition:

* C B^T once per (row of b and c, chunk), on the lower 16 x 8 tiles, the
  sum over N in slabs of 64 each from zero and added in f32; the R heads
  of a row read the row's copy.
* The reverse walk, split as ``ssd_scan.bwd_plan`` splits it: blocks of
  W warps over 16 rows of the state each and column tiles of NB, every
  (row, column) of G in exactly one block and no padded column at
  N = 16. Per chunk the block records G_c, then adds the chunk's
  (e^cum dY)^T C, a product summed from zero, to G after the decay
  multiply (one f32 rounding, the kernel's fmaf).
* The chunk pass with the kernel's warp items (two row tiles r and
  Q/16 - 1 - r by one or two column tiles), each output tile computed by
  one warp: dY U^T on the lower tiles; L selected to -inf above the
  diagonal before the exp; M2 and M1^T stored in one Q x Q tile with M1's
  diagonal beside; T's row prefix and column suffix sums; the columns of
  N in slabs (dc, G_c over H_c with <G_c, H_c>, G_c B^T summed over the
  slabs in f32, db); du, dx, W and x . du; d da, ddt and the chunk's share
  of da. The causal products read M through the kernel's addressing and
  its selects on the k-steps that cross the diagonal; every kept (i, j)
  pair is checked to be fed to the tensor cores exactly once, and no
  k-step the kernel reads without a select to hold a value the mask
  drops.
* db and dc summed over a row's R heads in head order, da over the
  chunks in chunk order.

Every product is split TF32 as the kernel runs it: hi = v rounded to
TF32 to nearest, ties away from zero (on the f32 bits, ``(bits + 0x1000)
& ~0x1fff``, what ``cvt.rna.tf32.f32`` gives), lo = v - hi handed over
unrounded, which the tensor cores read as its top 19 bits (truncated), and
a b = a_lo b_hi + a_hi b_lo + a_hi b_hi; each product runs over at most 64
K values from zero, and sums of products are taken in f32. cum is summed
in float64. Held against ``jax.vjp`` of ``repro.kernels.ref.ssd_scan_ref``
with both cotangents within ``GRAD_TOL`` of each gradient's largest entry
(``tests/test_torch_ssd_bwd.py``'s tolerance and shapes); one case shows
that one TF32 product per product misses it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

GRAD_TOL = 1e-5
WARPS = 8           # the chunk pass's warps a block
SLAB_K = 64         # the longest K a product sums from zero


def _bits(v):
    return v.contiguous().view(torch.int32)


def tf32_rna(v):
    """v rounded to TF32, to nearest with ties away from zero."""
    return ((_bits(v) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(v):
    """v as the tensor cores read an unrounded TF32 operand."""
    return (_bits(v) & ~0x1FFF).view(torch.float32)


def product(a, b, split=True):
    """a @ b as mma.sync computes it over one tile (K <= 64), from zero:
    split TF32, the small terms first, or one TF32 product."""
    assert a.shape[-1] <= SLAB_K
    ah, bh = tf32_rna(a), tf32_rna(b)
    if not split:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def slab_product(a, b, split=True):
    """a @ b over a K longer than one tile: each slab of 64 from zero,
    the slabs' products added in f32 in order."""
    out = None
    for k0 in range(0, a.shape[-1], SLAB_K):
        p = product(a[..., k0:k0 + SLAB_K], b[..., k0:k0 + SLAB_K, :], split)
        out = p if out is None else out + p
    return out


def items(MT, NT8):
    """The kernel's ``Items<MT, NT8>``: each busy warp's (row tiles,
    column tiles) of a 16 MT x 8 NT8 output."""
    tiles = MT * NT8
    per = tiles // WARPS if tiles >= WARPS else 1
    WM = 2 if per >= 2 and MT >= 2 else 1
    WN = per // WM
    NG = NT8 // WN
    busy = (MT // 2 if WM == 2 else MT) * NG
    out = []
    for w in range(busy):
        q = w // NG
        out.append(([q] + ([MT - 1 - q] if WM == 2 else []),
                    [(w % NG) * WN + j for j in range(WN)]))
    return out


def check_items(MT, NT8, keep=lambda m, n: True):
    """Every kept output tile is one warp's, and only one's."""
    seen = {}
    for w, (ms, ns) in enumerate(items(MT, NT8)):
        for m in ms:
            for n in ns:
                if keep(m, n):
                    assert (m, n) not in seen, (MT, NT8, m, n)
                    seen[(m, n)] = w
    assert set(seen) == {(m, n) for m in range(MT) for n in range(NT8)
                         if keep(m, n)}


# kind 0: M2 (i, j) as A, rows i, K = j <= i (dc's M2 B)
# kind 1: M1 (i, j) as A(j, i), rows j, K = i >= j (du's M1^T dY)
# kind 2: M2 (i, j) as A(j, i), rows j, K = i >= j (db's M2^T C)
def k_steps(kind, m, Q):
    return range(0, min(2 * m + 2, Q // 8)) if kind == 0 else \
        range(2 * m, Q // 8)


def causal_operand(kind, Mt, D1, Q):
    """The A operand the kernel feeds to the tensor cores for a causal
    product, (..., QM, Q), read from the shared M tile ``Mt`` (M2 on and
    below the diagonal, M1^T above) and M1's diagonal ``D1`` through the
    kernel's addressing and its selects on the k-steps that cross the
    diagonal (zero where no k-step of the row tile is read). Checks that
    every kept pair is read exactly once and that no read without a
    select holds a value the mask drops."""
    QM = Mt.shape[-1]
    A = torch.zeros(Mt.shape[:-1] + (Q,), dtype=Mt.dtype)
    visits = np.zeros((QM, Q), np.int64)
    for m in range(QM // 16):
        for kk in k_steps(kind, m, Q):
            diag = kk >= 2 * m if kind == 0 else kk <= 2 * m + 1
            for r in range(16 * m, 16 * m + 16):
                for k in range(8 * kk, 8 * kk + 8):
                    if kind == 0:
                        kept, v = k <= r, Mt[..., r, k]
                    elif kind == 1:
                        kept = k >= r
                        v = D1[..., r] if k == r else Mt[..., r, k]
                    else:
                        kept, v = k >= r, Mt[..., k, r]
                    assert diag or kept, (kind, m, kk, r, k)
                    if diag and not kept:
                        continue
                    if kind == 1 and k == r:
                        assert diag
                    A[..., r, k] = v
                    visits[r, k] += 1
    r, k = np.arange(QM)[:, None], np.arange(Q)[None, :]
    want = (k <= r) if kind == 0 else (k >= r)
    assert (visits == want).all(), kind
    return A


def tile_model(x, dt, a, b, c, states, dy, dh, chunk, *, split=True,
               sms=132):
    """The kernel's launches in plain PyTorch -> (dx, ddt, da, db, dc)."""
    BH, S, P = x.shape
    rows, N = b.shape[0], b.shape[-1]
    R, Q = BH // rows, chunk
    nc, QM = S // Q, max(Q, 16)
    MT = QM // 16
    plan = ssd.bwd_plan(BH, P, N, Q, sms)
    f32 = torch.float32

    def mm(u, v):
        return product(u, v, split)

    def mmk(u, v):
        return slab_product(u, v, split)

    # ---- 1. C B^T once per (row, chunk), lower tiles (all that is read)
    bq, cq = b.reshape(rows, nc, Q, N), c.reshape(rows, nc, Q, N)
    cbt_rows = mmk(cq, bq.transpose(-1, -2))            # (rows, nc, Q, Q)
    cbt = cbt_rows[torch.arange(BH) // R]               # the row's copy

    # cum in float64 from the forward's f32 dt a
    dtq = dt.reshape(BH, nc, Q)
    cum = torch.cumsum((dtq * a[:, None, None]).double(), -1)
    ec = torch.exp(cum.to(f32))
    last = ec[..., -1]
    cb = c.repeat_interleave(R, 0).reshape(BH, nc, Q, N)
    dyq = dy.reshape(BH, nc, Q, P)

    # ---- 2. the reverse walk, block by block
    NB, W = plan.walk_cols, plan.walk_warps
    # the chunk's product in KP partial sums over consecutive k-steps
    NT, KS = NB // 8, Q // 8
    KP = KS if KS < 8 // NT else (1 if NT >= 8 else 8 // NT)
    G = dh.clone() if dh is not None else x.new_zeros((BH, P, N))
    gst = torch.full((BH, nc, P, N), float("nan"))
    cover = np.zeros((BH, P, N), np.int64)
    for h in range(BH):
        for n0 in range(0, N, NB):
            for pb in range(0, P, 16 * W):
                for w in range(W):
                    p0 = pb + 16 * w
                    if p0 >= P:
                        continue
                    ps, ns = slice(p0, min(p0 + 16, P)), slice(n0, n0 + NB)
                    cover[h, ps, ns] += 1
                    g = G[h, ps, ns].clone()
                    for k in reversed(range(nc)):
                        gst[h, k, ps, ns] = g
                        ey = (ec[h, k, :, None] * dyq[h, k, :, ps]).T
                        tile = None
                        for q in range(KP):
                            ks = slice(8 * q * KS // KP, 8 * (q + 1) * KS // KP)
                            part = mm(ey[:, ks], cb[h, k, ks, ns])
                            tile = part if tile is None else tile + part
                        g = (g.double() * last[h, k].double()
                             + tile.double()).to(f32)
    assert (cover == 1).all()

    # ---- 3. every chunk
    xq = x.reshape(BH, nc, Q, P)
    pad = QM - Q
    dyp = torch.nn.functional.pad(dyq, (0, 0, 0, pad))   # (BH, nc, QM, P)
    U = torch.nn.functional.pad(xq * dtq[..., None], (0, 0, 0, pad))
    cump = torch.nn.functional.pad(cum, (0, pad))
    # dY U^T on the lower tiles, each computed by one warp
    check_items(MT, 2 * MT, keep=lambda m, n: n <= 2 * m + 1)
    dut = torch.zeros((BH, nc, QM, QM))
    for ms, ns in items(MT, 2 * MT):
        for m in ms:
            for n in ns:
                if n <= 2 * m + 1:
                    rs, cs = slice(16 * m, 16 * m + 16), slice(8 * n, 8 * n + 8)
                    dut[..., rs, cs] = mm(dyp[..., rs, :],
                                          U[..., cs, :].transpose(-1, -2))
    i = torch.arange(QM)
    keep = (i[None, :] <= i[:, None]) & (i[:, None] < Q)
    # the exponent selected to -inf above the diagonal, then the exp
    L = torch.exp(torch.where(keep, cump[..., :, None] - cump[..., None, :],
                              -torch.inf).to(f32))
    cbp = torch.nn.functional.pad(cbt, (0, pad, 0, pad))
    M1 = torch.where(keep, cbp, 0.0) * L
    M2 = dut * L
    T = M1 * dut
    # M2 on and below the diagonal, M1^T above, M1's diagonal beside
    lower = i[None, :] <= i[:, None]
    Mt = torch.where(lower, M2, M1.transpose(-1, -2))
    D1 = torch.diagonal(M1, dim1=-2, dim2=-1)
    # T's terms of d da_k: rows' exclusive prefix sums (j <= i), then each
    # column's sum over i >= k, in index order
    Tp = torch.zeros_like(T)
    s = torch.zeros(T.shape[:-1])
    for j in range(Q):
        Tp[..., j] = s
        s = s + T[..., j]
    sA = torch.zeros((BH, nc, Q))
    acc = torch.zeros((BH, nc, Q))
    for r in reversed(range(Q)):
        acc = acc + torch.where(torch.arange(Q) <= r, Tp[..., r, :Q], 0.0)
        sA = torch.where(torch.arange(Q) == r, acc, sA)

    def cut(v, n):        # rows of a (.., QM, n) output back to Q
        return v[..., :Q, :n]
    ecp = torch.exp(cump.to(f32))
    eq = torch.where(i < Q, torch.exp((cump[..., Q - 1:Q] - cump).to(f32)),
                     0.0)
    bp = torch.nn.functional.pad(
        b.repeat_interleave(R, 0).reshape(BH, nc, Q, N), (0, 0, 0, pad))
    cp = torch.nn.functional.pad(cb, (0, 0, 0, pad))
    A_m2 = causal_operand(0, Mt, D1, Q)                  # (.., QM, Q)
    A_m1t = causal_operand(1, Mt, D1, Q)
    A_m2t = causal_operand(2, Mt, D1, Q)
    NW = plan.slab
    check_items(MT, 8)
    check_items(MT, NW // 8)
    gbt = torch.zeros((BH, nc, QM, P))
    p1 = torch.zeros((BH, nc, QM))
    gh = torch.zeros((BH, nc))
    dc = torch.empty((BH, nc, Q, N))
    db = torch.empty((BH, nc, Q, N))
    for c0 in range(0, N, NW):
        cs = slice(c0, min(c0 + NW, N))
        H = states[..., cs]
        Gs = gst[..., cs]
        dch = mm(dyp, H)                                  # (.., QM, w)
        p1 = p1 + (cp[..., cs] * dch).sum(-1)
        dc[..., cs] = cut(ecp[..., None] * dch + mm(A_m2[..., :Q],
                                                     bp[..., :Q, cs]), N)
        gh = gh + (H * Gs).sum((-1, -2))
        gbt = gbt + mm(bp[..., cs], Gs.transpose(-1, -2))
        db[..., cs] = cut(eq[..., None] * mm(U, Gs)
                          + mm(A_m2t, cp[..., :Q, cs]), N)
    Wj = eq * (U * gbt).sum(-1)
    du = eq[..., None] * gbt + mm(A_m1t, dyp[..., :Q, :])
    du = du[..., :Q, :]
    dx = (dtq[..., None] * du).reshape(BH, S, P)
    xdu = (xq * du).sum(-1)
    P1 = ecp[..., :Q] * p1[..., :Q]
    ghs = gh * ec[..., -1]
    # d da, ddt and the chunk's share, one step at a time from the last
    wpre = torch.zeros((BH, nc, Q))
    w_run = torch.zeros((BH, nc))
    for j in range(Q):
        wpre[..., j] = w_run
        w_run = w_run + Wj[..., j]
    run = torch.zeros((BH, nc))
    dap = torch.zeros((BH, nc))
    ddt = torch.empty((BH, nc, Q))
    for r in reversed(range(Q)):
        run = run + P1[..., r]
        dda = run + sA[..., r] + wpre[..., r] + ghs
        ddt[..., r] = xdu[..., r] + a[:, None] * dda
        dap = dap + dtq[..., r] * dda
    # ---- 4. the heads' partials in head order, 5. da in chunk order
    da = dap[:, 0].clone()
    for k in range(1, nc):
        da = da + dap[:, k]
    # db and dc: the R heads' partials of a row in head order
    dbh = db.reshape(rows, R, S, N)
    dch_ = dc.reshape(rows, R, S, N)
    sb, sc = dbh[:, 0].clone(), dch_[:, 0].clone()
    for h in range(1, R):
        sb = sb + dbh[:, h]
        sc = sc + dch_[:, h]
    return dx, ddt.reshape(BH, S), da, sb, sc


# ------------------------------------------------------------- the checks

def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(rng, BH, R, S, P, N, strong=False):
    """x, dt, a, b, c as tests/test_torch_ssd_bwd.py draws them."""
    rows = BH // R
    dt = (0.02 + 0.2 * rng.random((BH, S))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(BH)).astype(np.float32)
    if strong:
        dt, a = 1 + 4 * np.log1p(np.exp(rng.standard_normal((BH, S)))), 4 * a
    return (rng.standard_normal((BH, S, P)).astype(np.float32),
            dt.astype(np.float32), a.astype(np.float32),
            rng.standard_normal((rows, S, N)).astype(np.float32),
            rng.standard_normal((rows, S, N)).astype(np.float32))


def _jax_vjp(x, dt, a, b, c, dy, dh):
    R = x.shape[0] // b.shape[0]

    def f(x, dt, a, b, c):
        return jref.ssd_scan_ref(x, dt, a, jnp.repeat(b, R, 0),
                                 jnp.repeat(c, R, 0))
    (_, h), vjp = jax.vjp(f, x, dt, a, b, c)
    dh = np.zeros(h.shape, np.float32) if dh is None else dh
    return [np.asarray(g) for g in vjp((dy, dh))]


def _states(x, dt, a, b, c, chunk):
    """The states entering each chunk, as the forward keeps them."""
    R = x.shape[0] // b.shape[0]
    bf = b.repeat_interleave(R, 0)
    BH, S, P = x.shape
    h = x.new_zeros((BH, P, b.shape[-1]))
    states = []
    for t in range(S):
        if t % chunk == 0:
            states.append(h)
        d = dt[:, t, None, None]
        h = torch.exp(d * a[:, None, None]) * h + d * (
            x[:, t, :, None] * bf[:, t, None, :])
    return torch.stack(states, 1)


# (BH, R, S, P, N, chunk, strong decay, SMs): test_torch_ssd_bwd.py's
# MODEL_CASES, and edges of the tiling: N = 100 (a slab of 64 and one of
# 36), P = 40 (a partial row tile), N = 8 (the narrowest tiles); a small
# SM count makes the walk's blocks two or four warps
CASES = [(3, 1, 64, 16, 16, 8, False, 132), (4, 4, 64, 32, 16, 16, False, 132),
         (4, 2, 128, 16, 128, 64, False, 132),
         (2, 1, 96, 64, 128, 16, False, 1), (6, 3, 64, 8, 20, 16, False, 132),
         (3, 3, 64, 16, 20, 8, True, 132), (2, 2, 128, 16, 128, 64, True, 132),
         (4, 2, 96, 40, 100, 32, False, 2), (2, 2, 64, 48, 8, 8, True, 1)]


@pytest.mark.parametrize("case", CASES)
def test_tile_model_matches_jax_vjp(case):
    BH, R, S, P, N, chunk, strong, sms = case
    rng = np.random.default_rng(sum(case[:6]))
    arrs = _inputs(rng, BH, R, S, P, N, strong)
    dy = rng.standard_normal((BH, S, P)).astype(np.float32)
    dh = rng.standard_normal((BH, P, N)).astype(np.float32)
    t = [torch.from_numpy(v) for v in arrs]
    states = _states(*t, chunk)
    for cot in (dh, None):
        want = _jax_vjp(*arrs, dy, cot)
        got = tile_model(*t, states, torch.from_numpy(dy),
                         None if cot is None else torch.from_numpy(cot),
                         chunk, sms=sms)
        assert [g.shape for g in got] == [w.shape for w in want]
        errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
        assert max(errs) <= GRAD_TOL, errs


def test_tile_model_one_tf32_product_misses():
    BH, R, S, P, N, chunk = 4, 2, 128, 32, 64, 32
    rng = np.random.default_rng(11)
    arrs = _inputs(rng, BH, R, S, P, N)
    dy = rng.standard_normal((BH, S, P)).astype(np.float32)
    want = _jax_vjp(*arrs, dy, None)
    t = [torch.from_numpy(v) for v in arrs]
    got = tile_model(*t, _states(*t, chunk), torch.from_numpy(dy), None,
                     chunk, split=False)
    assert max(_rel(g.numpy(), w) for g, w in zip(got, want)) > 10 * GRAD_TOL


@pytest.mark.parametrize("MT,NT8", [(m, n) for m in (1, 2, 4)
                                    for n in (2, 4, 8)])
def test_warp_items_partition_every_output(MT, NT8):
    """Every 16 x 8 tile of each output shape the chunk pass forms is one
    warp's, the causal row tiles paired (r, MT - 1 - r) where a warp has
    two, and no warp beyond the block's eight is asked for."""
    check_items(MT, NT8)
    its = items(MT, NT8)
    assert 1 <= len(its) <= WARPS
    for ms, _ in its:
        assert len(ms) == 1 or ms[0] + ms[1] == MT - 1


@pytest.mark.parametrize("Q", [8, 16, 32, 64])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_causal_k_steps_read_each_kept_pair_once(Q, kind):
    """The causal products' k-steps and selects on a labelled M tile:
    every kept pair's value read once, from where the kernel stores it."""
    QM = max(Q, 16)
    r, k = np.meshgrid(np.arange(QM), np.arange(QM), indexing="ij")
    M1 = torch.from_numpy((1000 * r + k + 1).astype(np.float32))
    M2 = -M1
    lower = torch.from_numpy(k <= r)
    Mt = torch.where(lower, M2, M1.T)
    D1 = torch.diagonal(M1)
    A = causal_operand(kind, Mt, D1, Q).numpy()
    rr, kk = np.arange(QM)[:, None], np.arange(Q)[None, :]
    if kind == 0:
        want = np.where(kk <= rr, M2.numpy()[:, :Q], 0)
    elif kind == 1:
        want = np.where(kk >= rr, M1.numpy().T[:, :Q], 0)
    else:
        want = np.where(kk >= rr, M2.numpy().T[:, :Q], 0)
    np.testing.assert_array_equal(A, want)


@pytest.mark.parametrize("BH,P,N,Q,plan,blocks", [
    # mamba2-2.7b's training shape: four warps a block share C's tile
    (80, 64, 128, 64, (64, 4, 3, 64), 160),
    # hymba-1.5b's: one warp a block, at least 132 blocks
    (50, 64, 16, 64, (16, 1, 8, 16), 200),
    (320, 64, 128, 64, (64, 4, 3, 64), 640),
    (64, 64, 128, 64, (64, 2, 3, 64), 256),
    (3, 37, 20, 8, (32, 1, 8, 32), 9),
    (6, 40, 100, 16, (64, 1, 8, 64), 36),
    (2, 64, 8, 32, (8, 1, 8, 16), 8)])
def test_bwd_plan(BH, P, N, Q, plan, blocks):
    """The walk's column tile fits N (no padded column where N is 8, 16,
    32 or a multiple of 64); its rows split so that every SM has a block
    where it can; its ring of chunk tiles fits two blocks an SM; the slab,
    which alone fixes an order of sums, depends on N alone."""
    got = ssd.bwd_plan(BH, P, N, Q, 132)
    assert tuple(got) == plan
    cols, warps, stages, _ = got
    assert BH * -(-N // cols) * -(-P // (16 * warps)) == blocks
    stage = ssd.walk_stage_bytes(Q, cols, warps)
    assert stage == 4 * (Q * (max(cols + 8, 24) + 16 * warps + 8) + Q + 4)
    assert 2 <= stages <= 8 and stages * stage <= ssd.WALK_SMEM
    assert all(ssd.bwd_plan(m * BH, P, N, Q, 132).slab == got.slab
               for m in (1, 2, 7))
