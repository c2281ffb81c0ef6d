"""The gradient of the SSD scan on the card (``csrc/ssd_scan_bwd.cu``) and
the banded attention's gradient route, modelled and plumbed on the CPU
and held against the JAX package.

* The kernel's arithmetic in plain PyTorch (``bwd_model``), its passes
  and orders: the reverse walk over the chunks that records G_c, the
  gradient of the state leaving chunk c (G_last = dh), and adds e^cum dy
  c^T; then every chunk from the forward's entering state H_c and G_c:
  C B^T and dY U^T with L selected to 0 above the diagonal before the
  exp, dc, du, dx, db, d da in the form where nothing cancels (the
  entering terms summed over i >= k, T over rows i >= k and columns
  j < k, W over j < k, and e^cum_Q <G_c, H_c>), ddt and the chunk's
  share of da; then
  db and dc summed over each row's R heads in head order and da over the
  chunks in chunk order. Held against ``jax.vjp`` of
  ``repro.kernels.ref.ssd_scan_ref`` with both cotangents: R = 1 and
  R > 1, chunks 8, 16 and 64, N 16 and 128, within ``GRAD_TOL`` of each
  gradient's largest entry (f32 on both sides, summed in other orders).
  The same passes with every product one TF32 product miss it: why the
  kernel multiplies in f32.
* ``ref.ssd_scan_bwd_ref`` (the card's plain version) against the same,
  with and without dh.
* ``ssd_scan.SSDScanFn`` with its launch functions replaced by stand-ins
  (the plain forward with its entering states, and ``bwd_model``) that
  refuse wrapped tensors and count their calls: ``loss.backward()`` and
  ``torch.func.grad`` equal the plain version's gradient; under
  ``vmap(grad)`` one forward and one backward call whatever m; an unread
  final state arrives as None; ``ops.ssd_scan`` pads S to a chunk
  multiple and differentiates through the pad; bf16 takes the f32 kernel
  on its inputs upcast, gradients cast back to each input's dtype,
  a second derivative raises.
* ``ops.swa_attention`` under a gradient, with the attention stand-ins:
  it goes through ``AttentionFn`` with the window, counts
  ``"swa_attention"``, and its gradient matches ``jax.vjp`` of the
  reference's banded attention (``_banded_sdpa``) in the GQA and the
  (B, S, d) layouts.
* The mamba2-2.7b and hymba-1.5b smoke configs' ``lm_loss`` gradient
  with every kernel route taken (``ops._on_cpu`` patched) and stand-ins
  behind it, against ``jax.grad`` of the JAX ``lm_loss``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import _banded_sdpa  # noqa: E402
from repro.models.model import init_lm_params as jinit  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.flatten import tree_leaves  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models.model import lm_loss  # noqa: E402

GRAD_TOL = 1e-5
# lm_loss's gradient leaves against the reference's (test_torch_lm_train)
LM_GRAD_TOL = 1e-4


def _bits(v):
    return v.contiguous().view(torch.int32)


def tf32(v):
    """v rounded to TF32, to nearest with ties away from zero."""
    return ((_bits(v) + 0x1000) & ~0x1FFF).view(torch.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(rng, BH, R, S, P, N, strong=False):
    """x, dt, a, b, c; ``strong``: dt |a| about 15 a step, a chunk's cum
    to about -120 (chip_smoke.py's strong case)."""
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
    (y, h), vjp = jax.vjp(f, x, dt, a, b, c)
    dh = np.zeros(h.shape, np.float32) if dh is None else dh
    return [np.asarray(g) for g in vjp((dy, dh))]


def forward_with_states(x, dt, a, b, c, chunk):
    """The plain forward as the kernel's launch returns it: (y, h, the
    states entering each chunk (BH, S / chunk, P, N))."""
    R = x.shape[0] // b.shape[0]
    bf, cf = b.repeat_interleave(R, 0), c.repeat_interleave(R, 0)
    BH, S, P = x.shape
    h = x.new_zeros((BH, P, b.shape[-1]))
    states, ys = [], []
    for t in range(S):
        if t % chunk == 0:
            states.append(h)
        d = dt[:, t, None, None]
        h = torch.exp(d * a[:, None, None]) * h + d * (
            x[:, t, :, None] * bf[:, t, None, :])
        ys.append(torch.bmm(h, cf[:, t, :, None])[..., 0])
    return torch.stack(ys, 1), h, torch.stack(states, 1)


def bwd_model(x, dt, a, b, c, states, dy, dh, chunk, *, one_tf32=False):
    """The kernel's passes in plain PyTorch -> (dx, ddt, da, db, dc); with
    ``one_tf32`` every product takes its operands rounded once to TF32."""
    mm = (lambda u, v: tf32(u) @ tf32(v)) if one_tf32 else torch.matmul
    BH, S, P = x.shape
    rows, N = b.shape[0], b.shape[-1]
    R, Q = BH // rows, chunk
    nc = S // Q
    bb = b.repeat_interleave(R, 0).reshape(BH, nc, Q, N)
    cc = c.repeat_interleave(R, 0).reshape(BH, nc, Q, N)
    xq, dyq = x.reshape(BH, nc, Q, P), dy.reshape(BH, nc, Q, P)
    dtq = dt.reshape(BH, nc, Q)
    # cum in float64: a decay e^(cum_i - cum_j) of nearby steps from the
    # difference of two long f32 sums would lose |cum| eps of its argument
    cum = torch.cumsum((dtq * a[:, None, None]).double(), -1)
    ecum = torch.exp(cum.to(x.dtype))
    # 1. the reverse walk: G_c, then G <- e^cum_Q G + sum_i e^cum_i dy_i c_i^T
    G = dh.clone() if dh is not None else x.new_zeros((BH, P, N))
    gst = x.new_empty((BH, nc, P, N))
    for k in reversed(range(nc)):
        gst[:, k] = G
        G = ecum[:, k, -1, None, None] * G + mm(
            (ecum[:, k, :, None] * dyq[:, k]).transpose(1, 2), cc[:, k])
    # 2. every chunk
    u = xq * dtq[..., None]
    i = torch.arange(Q)
    below = i[None, :] <= i[:, None]
    L = torch.exp(torch.where(below, cum[..., :, None] - cum[..., None, :],
                              -torch.inf).to(x.dtype))
    dut = mm(dyq, u.transpose(-1, -2))
    M1 = mm(cc, bb.transpose(-1, -2)) * L
    M2 = dut * L
    T = M1 * dut
    dcH = mm(dyq, states)                           # H_c^T dy_i
    p1 = ecum * (cc * dcH).sum(-1)
    dc = ecum[..., None] * dcH + mm(M2, bb)
    gh = (gst * states).sum((-1, -2))
    GB = mm(bb, gst.transpose(-1, -2))              # G_c b_j
    eq = torch.exp((cum[..., -1:] - cum).to(x.dtype))
    W = eq * (u * GB).sum(-1)
    du = eq[..., None] * GB + mm(M1.transpose(-1, -2), dyq)
    db = eq[..., None] * mm(u, gst) + mm(M2.transpose(-1, -2), cc)
    # d da_k = sum_{i >= k} p1_i + sum_{i >= k, j < k} T_ij
    #          + sum_{j < k} W_j + e^cum_Q <G_c, H_c>
    rect = (i[:, None, None] <= i[None, :, None]) & \
        (i[None, None, :] < i[:, None, None])       # (k, i, j)
    dda = (torch.flip(torch.cumsum(torch.flip(p1, [-1]), -1), [-1])
           + torch.einsum("...ij,kij->...k", T, rect.to(T.dtype))
           + F.pad(torch.cumsum(W[..., :-1], -1), (1, 0))
           + (ecum[..., -1] * gh)[..., None])
    dx = (dtq[..., None] * du).reshape(BH, S, P)
    ddt = ((xq * du).sum(-1) + a[:, None, None] * dda).reshape(BH, S)
    share = (dtq * dda).sum(-1)
    da = share[:, 0].clone()
    for k in range(1, nc):
        da += share[:, k]
    db, dc = (g.reshape(rows, R, S, N) for g in (db, dc))
    sb, sc = db[:, 0].clone(), dc[:, 0].clone()
    for h in range(1, R):
        sb += db[:, h]
        sc += dc[:, h]
    return dx, ddt, da, sb, sc


# (BH, R, S, P, N, chunk, strong decay)
MODEL_CASES = [(3, 1, 64, 16, 16, 8, False), (4, 4, 64, 32, 16, 16, False),
               (4, 2, 128, 16, 128, 64, False),
               (2, 1, 96, 64, 128, 16, False), (6, 3, 64, 8, 20, 16, False),
               (3, 3, 64, 16, 20, 8, True), (2, 2, 128, 16, 128, 64, True)]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_bwd_model_matches_jax_vjp(case):
    BH, R, S, P, N, chunk, strong = case
    rng = np.random.default_rng(sum(case))
    arrs = _inputs(rng, BH, R, S, P, N, strong)
    dy = rng.standard_normal((BH, S, P)).astype(np.float32)
    dh = rng.standard_normal((BH, P, N)).astype(np.float32)
    t = [torch.from_numpy(v) for v in arrs]
    _, _, states = forward_with_states(*t, chunk)
    for cot in (dh, None):
        want = _jax_vjp(*arrs, dy, cot)
        got = bwd_model(*t, states, torch.from_numpy(dy),
                        None if cot is None else torch.from_numpy(cot), chunk)
        errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
        assert max(errs) <= GRAD_TOL, errs


def test_bwd_model_one_tf32_product_misses():
    BH, R, S, P, N, chunk = 4, 2, 128, 32, 64, 32
    rng = np.random.default_rng(11)
    arrs = _inputs(rng, BH, R, S, P, N)
    dy = rng.standard_normal((BH, S, P)).astype(np.float32)
    want = _jax_vjp(*arrs, dy, None)
    t = [torch.from_numpy(v) for v in arrs]
    _, _, states = forward_with_states(*t, chunk)
    got = bwd_model(*t, states, torch.from_numpy(dy), None, chunk,
                    one_tf32=True)
    assert max(_rel(g.numpy(), w) for g, w in zip(got, want)) > 10 * GRAD_TOL


@pytest.mark.parametrize("R,N", [(1, 16), (3, 128)])
def test_ssd_scan_bwd_ref_matches_jax_vjp(R, N):
    rng = np.random.default_rng(R + N)
    BH, S, P = 3 * R, 48, 16
    arrs = _inputs(rng, BH, R, S, P, N)
    dy = rng.standard_normal((BH, S, P)).astype(np.float32)
    dh = rng.standard_normal((BH, P, N)).astype(np.float32)
    t = [torch.from_numpy(v) for v in arrs]
    for cot in (dh, None):
        want = _jax_vjp(*arrs, dy, cot)
        got = ref.ssd_scan_bwd_ref(
            *t, torch.from_numpy(dy),
            None if cot is None else torch.from_numpy(cot))
        assert [g.shape for g in got] == [w.shape for w in want]
        errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
        assert max(errs) <= GRAD_TOL, errs
    # float64 inputs are differentiated in float64
    got64 = ref.ssd_scan_bwd_ref(*(v.double() for v in t),
                                 torch.from_numpy(dy).double())
    assert all(g.dtype == torch.float64 for g in got64)


# ------------------------------------------------------------- plumbing

class StandIns:
    """Plain-version launch functions that refuse wrapped tensors and
    count their calls: the SSD's (``forward_with_states``, ``bwd_model``)
    and the attention's and norm's."""

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(("ssd", "ssd_bwd", "attn", "attn_bwd",
                                    "norm", "norm_bwd"), 0)
        self.dh = []
        for mod, name, fn in (
                (ssd, "launch_forward", self.ssd),
                (ssd, "launch_backward", self.ssd_bwd),
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
            t.data_ptr()

    def ssd(self, x, dt, a, b, c, chunk):
        self._plain(x, dt, a, b, c)
        self.calls["ssd"] += 1
        return forward_with_states(x, dt, a, b, c, chunk)

    def ssd_bwd(self, x, dt, a, b, c, states, dy, dh, chunk):
        self._plain(x, dt, a, b, c, states, dy,
                    *(() if dh is None else (dh,)))
        self.calls["ssd_bwd"] += 1
        self.dh.append(dh)
        return bwd_model(x, dt, a, b, c, states, dy, dh, chunk)

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


def _kernel_route(monkeypatch):
    """``ops`` takes the card's routes for CPU tensors."""
    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    ops.reset_launches()


def _ssd_params(rng, m=None, BH=4, R=2, S=32, P=8, N=16):
    lead = () if m is None else (m,)
    rows = BH // R
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(lead + s).astype(np.float32))
    return {"x": f(BH, S, P), "dt": 0.05 + 0.1 * f(BH, S).abs(),
            "a": -f(BH).abs() - 0.1, "b": f(rows, S, N), "c": f(rows, S, N)}


def _ssd_loss(p, fn):
    y, h = fn(p["x"], p["dt"], p["a"], p["b"], p["c"])
    return y.square().mean() + 0.1 * h.sum()


def _kernel_ssd(x, dt, a, b, c, chunk=8):
    return ssd.SSDScanFn.apply(x, dt, a, b, c, chunk)[:2]


def _plain_ssd(x, dt, a, b, c):
    R = x.shape[0] // b.shape[0]
    return ref.ssd_scan_ref(x, dt, a, b.repeat_interleave(R, 0),
                            c.repeat_interleave(R, 0))


def test_ssd_fn_backward_equals_func_grad(monkeypatch):
    stand = StandIns(monkeypatch)
    p = _ssd_params(np.random.default_rng(1))
    want = torch.func.grad(lambda p: _ssd_loss(p, _plain_ssd))(p)
    got = torch.func.grad(lambda p: _ssd_loss(p, _kernel_ssd))(p)
    tracked = {k: v.clone().requires_grad_() for k, v in p.items()}
    _ssd_loss(tracked, _kernel_ssd).backward()
    assert stand.calls["ssd"] == stand.calls["ssd_bwd"] == 2
    assert all(dh is not None for dh in stand.dh)
    for k in p:
        assert _rel(got[k], want[k]) <= GRAD_TOL, k
        torch.testing.assert_close(tracked[k].grad, got[k], rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("m", [1, 3])
def test_ssd_vmap_grad_one_call_per_op_whatever_m(m, monkeypatch):
    stand = StandIns(monkeypatch)
    p = _ssd_params(np.random.default_rng(m), m)
    got = torch.func.vmap(torch.func.grad(
        lambda p: _ssd_loss(p, _kernel_ssd)))(p)
    assert (stand.calls["ssd"], stand.calls["ssd_bwd"]) == (1, 1)
    want = torch.func.vmap(torch.func.grad(
        lambda p: _ssd_loss(p, _plain_ssd)))(p)
    for k in p:
        assert _rel(got[k], want[k]) <= GRAD_TOL, k


def test_ssd_unread_final_state_arrives_as_none(monkeypatch):
    stand = StandIns(monkeypatch)
    p = _ssd_params(np.random.default_rng(2))
    got = torch.func.grad(
        lambda p: _kernel_ssd(*p.values())[0].square().sum())(p)
    want = torch.func.grad(
        lambda p: _plain_ssd(*p.values())[0].square().sum())(p)
    assert stand.dh == [None]
    for k in p:
        assert _rel(got[k], want[k]) <= GRAD_TOL, k


def test_ops_ssd_scan_pads_and_differentiates(monkeypatch):
    stand = StandIns(monkeypatch)
    _kernel_route(monkeypatch)
    p = _ssd_params(np.random.default_rng(3), S=27)
    got = torch.func.grad(lambda p: _ssd_loss(
        p, lambda *t: ops.ssd_scan(*t, chunk=8)))(p)
    assert stand.calls["ssd"] == stand.calls["ssd_bwd"] == 1
    want = torch.func.grad(lambda p: _ssd_loss(p, _plain_ssd))(p)
    for k in p:
        assert got[k].shape == p[k].shape
        assert _rel(got[k], want[k]) <= GRAD_TOL, k


def test_ssd_bf16_and_second_derivative_raise(monkeypatch):
    """A bf16 ``ops.ssd_scan`` under a gradient: the bf16 forward, then
    the f32 backward kernel on its inputs upcast (the stand-in receives
    f32 only), each gradient cast to its input's dtype, within one bf16
    step of the largest entry of the plain version's gradient at the same
    (bf16) values in f32, its output rounded to bf16 as the kernel's. A
    second derivative still raises; it alone now raises (the name is
    from when bf16 raised too)."""
    stand = StandIns(monkeypatch)
    _kernel_route(monkeypatch)
    p = _ssd_params(np.random.default_rng(4))
    pb = {k: v.to(torch.bfloat16) if k != "a" else v for k, v in p.items()}
    seen, plain_fwd, plain_bwd = [], stand.ssd, stand.ssd_bwd

    def ssd_fwd(x, dt, a, b, c, chunk):
        # the bf16 forward kernel: bf16 in, f32 inside, y in bf16
        y, h, states = plain_fwd(*(t.float() for t in (x, dt, a, b, c)),
                                 chunk)
        return y.to(x.dtype), h, states

    def ssd_bwd(*args):
        seen.extend(t.dtype for t in args[:-1] if t is not None)
        return plain_bwd(*args)
    monkeypatch.setattr(ssd, "launch_forward", ssd_fwd)
    monkeypatch.setattr(ssd, "launch_backward", ssd_bwd)

    def loss(p):
        return ops.ssd_scan(*p.values(), chunk=8)[0].float().square().sum()
    got = torch.func.grad(loss)(pb)
    assert stand.calls["ssd"] == stand.calls["ssd_bwd"] == 1
    assert seen and all(t == torch.float32 for t in seen)
    # y rounded to bf16, as the kernel writes it (so dy is the route's)
    want = torch.func.grad(lambda p: _plain_ssd(*p.values())[0]
                           .to(torch.bfloat16).float().square().sum())(
        {k: v.float() for k, v in pb.items()})
    for k in p:
        assert got[k].dtype == pb[k].dtype, k
        assert _rel(got[k].float(), want[k]) <= 2.0 ** -8, k
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.func.grad(lambda p: torch.func.grad(lambda q: _ssd_loss(
            q, _kernel_ssd))(p)["x"].sum())(p)


# ---------------------------------------------------- the banded route

@pytest.mark.parametrize("B,S,H,Hkv,d,w", [(1, 64, 4, 2, 32, 16),
                                           (2, 48, 3, 1, 64, 24),
                                           (2, 32, 1, 1, 32, 16)])
def test_ops_swa_attention_gradient_route(B, S, H, Hkv, d, w, monkeypatch):
    stand = StandIns(monkeypatch)
    _kernel_route(monkeypatch)
    rng = np.random.default_rng(S + H)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    do = rng.standard_normal((B, S, H, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    flat = H == 1

    def jf(q, k, v):
        return _banded_sdpa(q.reshape(B, S, Hkv, H // Hkv, d), k, v, w,
                            scale).reshape(B, S, H, d)
    _, vjp = jax.vjp(jf, q, k, v)
    want = vjp(do)
    t = [torch.from_numpy(a[:, :, 0] if flat else a) for a in (q, k, v)]
    tdo = torch.from_numpy(do[:, :, 0] if flat else do)
    got = torch.func.vjp(lambda *t: ops.swa_attention(
        *t, window=w, scale=scale), *t)[1](tdo)
    assert stand.calls["attn"] == stand.calls["attn_bwd"] == 1
    assert ops.LAUNCHES["swa_attention"] == 1
    assert ops.LAUNCHES["flash_attention"] == 0
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)[:, :, 0] if flat else np.asarray(wnt)
        assert _rel(g.numpy(), wnt) <= GRAD_TOL


def test_attention_fn_counts_under_its_kernel(monkeypatch):
    StandIns(monkeypatch)
    ops.reset_launches()
    q, k, v = (torch.randn(1, 32, 2, 16) for _ in range(3))
    fa.AttentionFn.apply(q, k, v, True, 0, None)
    fa.AttentionFn.apply(q, k, v, True, 16, None, "swa_attention")
    assert (_build.LAUNCHES["flash_attention"],
            _build.LAUNCHES["swa_attention"]) == (1, 1)
    ops.reset_launches()


# ------------------------------------------- the smoke configs' lm_loss

def _lm_batch(cfg, key, B=2, S=32):
    toks = jax.random.randint(key, (B, S), 0, cfg.vocab_size)
    labels = jax.random.randint(jax.random.fold_in(key, 1), (B, S), 0,
                                cfg.vocab_size)
    return {"tokens": np.asarray(toks), "labels": np.asarray(labels)}


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_smoke_lm_loss_gradient_through_kernel_routes(arch, monkeypatch):
    jcfg, cfg = jget_arch(arch, smoke=True), get_arch(arch, smoke=True)
    params_np = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    batch = _lm_batch(jcfg, jax.random.PRNGKey(1))
    want = jax.jit(jax.grad(lambda p: jlm_loss(jcfg, p, batch)))(
        jax.tree.map(jnp.asarray, params_np))
    stand = StandIns(monkeypatch)
    _kernel_route(monkeypatch)
    params = params_from_numpy(params_np, device="cpu")
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    got = torch.func.grad(lambda p: lm_loss(cfg, p, tb))(params)
    L = cfg.num_layers
    assert stand.calls["ssd"] == stand.calls["ssd_bwd"] == L
    if arch == "hymba-1.5b":          # S = 32 = 2 windows: the banded path
        assert stand.calls["attn"] == stand.calls["attn_bwd"] == L
        assert ops.LAUNCHES["swa_attention"] == L
        assert ops.LAUNCHES["flash_attention"] == 0
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = tree_leaves(got)
    assert len(want_leaves) == len(got_leaves)
    for (path, w), g in zip(want_leaves, got_leaves):
        assert _rel(g.detach().numpy(), w) <= LM_GRAD_TOL, \
            jax.tree_util.keystr(path)


# ------------------------------------------------------------- the bound

@pytest.mark.parametrize("shape,nbytes,bound,cuda_cores", [
    # mamba2-2.7b's training shape (one layer, B = 1, S = 4,096)
    ((80, 4096, 64, 128, 64, 80), 262_668_928, 0.180, 0.443),
    # hymba-1.5b's SSM branch
    ((50, 4096, 64, 16, 64, 50), 159_973_776, 0.0478, 0.0569)])
def test_ssd_scan_bwd_bound(shape, nbytes, bound, cuda_cores):
    """The function's bytes (x, dt, b, c, dy in; dx, ddt, db, dc, da out;
    a in) and the chunked form's flops in split TF32, with the CUDA
    cores' f32 bound beside (PERF.md §6, row 9)."""
    from repro_torch.analysis import roofline
    got = roofline.kernel_bound("ssd_scan_bwd", shape, torch.float32)
    BH, S, P, N, Q, R = shape
    assert got["bytes"] == nbytes == 4 * (3 * BH * S * P + 2 * BH * S
                                          + 4 * (BH // R) * S * N + 2 * BH)
    assert float(f"{got['bound_ms']:.3g}") == bound
    assert float(f"{got['bound_ms_f32_cuda_cores']:.3g}") == cuda_cores
    assert got["ops"] == 3 * roofline.ssd_bwd_work(
        BH, S, P, N, BH // R, Q, 4)[1]
