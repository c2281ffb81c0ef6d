"""LM training in the port (``repro_torch.models.model.lm_loss``,
``data.synthetic.TokenStream`` and the three step factories with
``lm_loss``) against the JAX package on the CPU.

* ``TokenStream``: the V x V logits bit for bit, before and after
  ``force_drift``, and the tokens and labels of batches drawn with the
  same keys identical (any draw that differed would be reported with its
  rate and first position).
* ``lm_loss``: the value and the gradient of every smoke config of the
  reference's ``test_arch_smoke.py`` (``ASSIGNED_ARCHS``), on the
  reference's own f32 weights (``convert``), against
  ``jax.value_and_grad(lm_loss)``: the loss within rtol 1e-5, every
  gradient leaf within ``GRAD_TOL`` of its own largest entry (the two
  packages sum the matrix products, softmaxes and norm statistics in
  other orders). The text configs run with a ``loss_mask``, the vision
  config with its stub prefix, the audio config on four codebooks.
  ``torch.func.grad`` and ``loss.backward()`` give the same gradient.
* ``lm_loss(remat=True)`` (``RematLayer``): every smoke config against
  the reference's ``lm_loss(remat=True)`` (``jax.checkpoint``) under
  ``torch.func.grad``, ``loss.backward()`` and the learners' vmap at the
  tolerances above, and against the port's ``remat=False`` in each mode
  within ``REMAT_TOL``; on the card's routes (stand-in launches) each
  layer's forward kernels launch twice a step, its backward kernels
  once, for one learner or two.
* The step factories with ``lm_loss`` on llama3-8b-smoke (adam, lr 1e-3)
  for 20 steps on ``TokenStream`` batches against the reference's jitted
  steps: ``make_train_step`` with ``micro_batch`` 1 and 2 (B = 4),
  ``make_dynamic_train_step`` (b = 2, Δ between the checked distances)
  and ``make_periodic_train_step`` (b = 3) at m = 4: ``synced``,
  ``syncs`` and ``checks`` exact, every checked distance at least
  1e-4·Δ away from Δ, ``max_sq_dist`` within rtol 1e-4, and the losses
  and the parameters after 20 steps within the bounds of
  ``STEP_LOSS_TOL`` / ``PLANE_REL_TOL`` (adam's sensitivity, below);
  the dynamic step also with ``remat=True`` on both sides.
  ``check_fleet`` serves ``tests/test_torch_moe_fleet.py`` too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.core import distributed as jdistributed  # noqa: E402
from repro.core.flatten import fleet_adapter as jfleet_adapter  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.models.model import init_lm_params as jinit  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.config import ProtocolConfig, TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import key_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.flatten import (  # noqa: E402
    fleet_adapter, tree_leaves, tree_map,
)
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.model import AUDIO_CODEBOOKS, lm_loss  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

B, S = 2, 32
# a gradient leaf against the reference's, as max |diff| over max |leaf|
GRAD_TOL = 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# loss.backward() against torch.func.grad, as GRAD_TOL
BACKWARD_TOL = 1e-5
STEPS, M = 20, 4
# 20 adam steps: adam moves a weight whose gradient is at f32's noise
# level by up to lr (1e-3) a step whatever the gradient's size, so the
# gradient's last bits (summed in other orders by the two packages) move
# such weights by up to lr and the losses after them. The bounds: the
# losses within rtol 1e-4 (9.0e-6 seen), the parameter planes within
# 1e-3 of their norm (8.7e-5 seen), and no entry further apart than two
# opposite adam moves of lr a step, 2 lr x 20 (7.0e-3 seen), on jax 0.9.0
# and torch 2.13 on the CPU
STEP_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PLANE_REL_TOL, PLANE_ABS_TOL = 1e-3, 2 * 1e-3 * STEPS
DELTA_MARGIN = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
            batch.items()}


# ---------------------------------------------------------------- streams

def _mismatch(want, got) -> str:
    bad = np.argwhere(want != got)
    return (f"{len(bad)} of {want.size} draws differ "
            f"({len(bad) / want.size:.2e}), the first at {bad[:1].tolist()}")


@pytest.mark.parametrize("vocab,batch,seq", [(512, 4, 64), (2048, 2, 96)])
def test_token_stream_matches_reference(vocab, batch, seq):
    want_s = JTokenStream(seed=7, vocab=vocab, temp=0.8)
    got_s = TokenStream(seed=7, vocab=vocab, temp=0.8, device="cpu")
    for drift in range(2):
        if drift:
            want_s.force_drift()
            got_s.force_drift()
        assert np.array_equal(np.asarray(want_s.logits),
                              got_s.logits.numpy())
        for seed in (0, 11):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), drift)
            want = _np(want_s.sample(key, batch, seq))
            got = got_s.sample(key_from_numpy(key, "cpu"), batch, seq)
            for name in ("tokens", "labels"):
                g = got[name].numpy()
                assert g.shape == (batch, seq)
                assert np.array_equal(want[name], g), \
                    f"{name}: " + _mismatch(want[name], g)
            assert np.array_equal(got["tokens"][:, 1:].numpy(),
                                  got["labels"][:, :-1].numpy())


# ---------------------------------------------------------------- lm_loss

def _loss_batch(cfg, key):
    """The reference's smoke batch (tests/test_arch_smoke.py) plus a
    loss mask on the text configs."""
    if cfg.modality == "audio":
        toks = jax.random.randint(key, (B, S, AUDIO_CODEBOOKS), 0,
                                  cfg.vocab_size)
        return {"tokens": toks, "labels": toks}
    toks = jax.random.randint(key, (B, S), 0, cfg.vocab_size)
    labels = jax.random.randint(jax.random.fold_in(key, 1), (B, S), 0,
                                cfg.vocab_size)
    batch = {"tokens": toks, "labels": labels}
    if cfg.modality == "vision":
        batch["prefix_embeds"] = 0.02 * jax.random.normal(
            jax.random.fold_in(key, 7), (B, 8, cfg.d_model))
    else:
        batch["loss_mask"] = (jax.random.uniform(
            jax.random.fold_in(key, 2), (B, S)) < 0.7).astype(jnp.float32)
    return batch


def _leaf_gaps(want_tree, got_tree):
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    got = tree_leaves(got_tree)
    assert len(want) == len(got)
    out = {}
    for (path, w), g in zip(want, got):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert w.shape == g.shape, path
        out[jax.tree_util.keystr(path)] = float(
            np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))
    return out


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_lm_loss_value_and_grad_match_reference(arch):
    jcfg = jget_arch(arch, smoke=True)
    cfg = get_arch(arch, smoke=True)
    params_np = _np(jinit(jcfg, jax.random.PRNGKey(0)))
    batch = _np(_loss_batch(jcfg, jax.random.PRNGKey(1)))
    want_loss, want_grad = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(jcfg, p, batch)))(
            jax.tree.map(jnp.asarray, params_np))

    params = params_from_numpy(params_np, device="cpu")
    tb = _torch_batch(batch)
    grads, loss = torch.func.grad_and_value(
        lambda p: lm_loss(cfg, p, tb))(params)
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
    gaps = _leaf_gaps(want_grad, grads)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])

    # loss.backward() gives torch.func.grad's gradient, up to the order in
    # which the two graphs add a leaf's terms
    leaves = [x.clone().requires_grad_() for x in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    lm_loss(cfg, tracked, tb).backward()
    for x, g in zip(leaves, tree_leaves(grads)):
        assert float((x.grad - g).abs().max()) <= \
            BACKWARD_TOL * float(g.abs().max())


def _port_grads(cfg, params, tb, mode, remat):
    """(loss, gradient tree) of the port's ``lm_loss`` by ``mode``:
    ``torch.func.grad``, ``loss.backward()``, or learner 1 of two under
    the learners' ``torch.func.vmap`` (learner 0 on the weights scaled by
    1.01)."""
    def loss_fn(p, b):
        return lm_loss(cfg, p, b, remat=remat)
    if mode == "grad":
        grads, loss = torch.func.grad_and_value(loss_fn)(params, tb)
        return loss, grads
    if mode == "backward":
        leaves = [x.clone().requires_grad_() for x in tree_leaves(params)]
        it = iter(leaves)
        loss = loss_fn(tree_map(lambda _: next(it), params), tb)
        loss.backward()
        it = iter(leaves)
        return loss.detach(), tree_map(lambda _: next(it).grad, params)
    fleet = tree_map(lambda x: torch.stack([x * 1.01, x]), params)
    fb = {k: torch.stack([v, v]) for k, v in tb.items()}
    grads, loss = torch.func.vmap(torch.func.grad_and_value(loss_fn))(fleet,
                                                                     fb)
    return loss[1], tree_map(lambda g: g[1], grads)


REMAT_MODES = ("grad", "backward", "vmap")
# rematerialized layers against the plain ones in the same mode, as the
# largest leaf's max |diff| over its max |leaf|: the same operations in
# the same order (0 seen on torch 2.13 on the CPU)
REMAT_TOL = 1e-6


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_lm_loss_remat_matches_reference(arch):
    """``lm_loss(remat=True)`` against the reference's
    ``lm_loss(remat=True)`` (``jax.checkpoint`` of each layer) under
    ``torch.func.grad``, ``loss.backward()`` and the learners' vmap, at
    the tolerances of the test above."""
    jcfg = jget_arch(arch, smoke=True)
    cfg = get_arch(arch, smoke=True)
    params_np = _np(jinit(jcfg, jax.random.PRNGKey(0)))
    batch = _np(_loss_batch(jcfg, jax.random.PRNGKey(1)))
    want_loss, want_grad = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(jcfg, p, batch, remat=True)))(
            jax.tree.map(jnp.asarray, params_np))
    params = params_from_numpy(params_np, device="cpu")
    tb = _torch_batch(batch)
    for mode in REMAT_MODES:
        loss, grads = _port_grads(cfg, params, tb, mode, remat=True)
        np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
        gaps = _leaf_gaps(want_grad, grads)
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= GRAD_TOL, (mode, worst, gaps[worst])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_lm_loss_remat_matches_plain_layers(arch):
    """``remat=True`` against the port's ``remat=False`` in each mode:
    the same loss and the gradient within REMAT_TOL."""
    jcfg = jget_arch(arch, smoke=True)
    cfg = get_arch(arch, smoke=True)
    params = params_from_numpy(_np(jinit(jcfg, jax.random.PRNGKey(0))),
                               device="cpu")
    tb = _torch_batch(_np(_loss_batch(jcfg, jax.random.PRNGKey(1))))
    for mode in REMAT_MODES:
        want_loss, want = _port_grads(cfg, params, tb, mode, remat=False)
        loss, got = _port_grads(cfg, params, tb, mode, remat=True)
        assert float(loss) == float(want_loss), mode
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert float((g - w).abs().max()) <= \
                REMAT_TOL * float(w.abs().max()), mode


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x22b",
                                  "deepseek-v2-236b", "mamba2-2.7b",
                                  "hymba-1.5b"])
@pytest.mark.parametrize("mode", ["grad", "vmap"])
def test_lm_loss_remat_launches(arch, mode, monkeypatch):
    """The card's routes (``ops._on_cpu`` patched, the launches replaced
    by their plain versions): under ``remat`` each layer's forward kernels
    launch twice a step, in the forward and in the backward's recompute,
    its backward kernels once, the final norm once each way; under the
    learners' vmap the same counts for two learners. The gradient is
    ``remat=False``'s through the same routes within REMAT_TOL."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_attention as swa
    from test_torch_ssd_bwd import StandIns, _kernel_route

    def plain_ssd(x, dt, a, b, c, chunk):
        R = x.shape[0] // b.shape[0]
        return ref.ssd_scan_ref(x, dt, a, b.repeat_interleave(R, dim=0),
                                c.repeat_interleave(R, dim=0), chunk=chunk)
    # the routes without a gradient (the forward inside RematLayer)
    for mod, name, fn in ((fa, "flash_attention_gqa",
                           ref.flash_attention_gqa_ref),
                          (swa, "swa_attention", ref.swa_attention_ref),
                          (rn, "rmsnorm", ref.rmsnorm_ref),
                          (ssd, "ssd_scan", plain_ssd)):
        monkeypatch.setattr(mod, name, fn)
    jcfg = jget_arch(arch, smoke=True)
    cfg = get_arch(arch, smoke=True)
    params = params_from_numpy(_np(jinit(jcfg, jax.random.PRNGKey(0))),
                               device="cpu")
    tb = _torch_batch(_np(_loss_batch(jcfg, jax.random.PRNGKey(1))))
    if mode == "vmap":
        params = tree_map(lambda x: torch.stack([x, x * 1.01]), params)
        tb = {k: torch.stack([v, v]) for k, v in tb.items()}
    grads = {}
    for remat in (False, True):
        fn = torch.func.grad(lambda p, b: lm_loss(cfg, p, b, remat=remat))
        stand = StandIns(monkeypatch)     # their launches are counted here
        _kernel_route(monkeypatch)
        grads[remat] = (torch.func.vmap(fn) if mode == "vmap" else fn)(
            params, tb)
        launches = {k: n for k, n in ops.LAUNCHES.items() if n}
        for call, kernel in (("attn_bwd", "attention_bwd"),
                             ("norm", "rmsnorm"), ("norm_bwd", "rmsnorm_bwd"),
                             ("ssd", "ssd_scan"), ("ssd_bwd", "ssd_scan_bwd")):
            if stand.calls[call]:
                launches[kernel] = launches.get(kernel, 0) + stand.calls[call]
    L, again = cfg.num_layers, 2
    norms = 5 * L if cfg.family == "hybrid" else 2 * L
    want = {"rmsnorm": again * norms + 1, "rmsnorm_bwd": norms + 1}
    if cfg.family != "ssm":
        banded = cfg.attn_type == "sliding" and S % cfg.sliding_window == 0 \
            and S >= 2 * cfg.sliding_window
        want["swa_attention" if banded else "flash_attention"] = again * L
        want["attention_bwd"] = L
    if cfg.family in ("ssm", "hybrid"):
        want.update(ssd_scan=again * L, ssd_scan_bwd=L)
    assert launches == want
    for g, w in zip(tree_leaves(grads[True]), tree_leaves(grads[False])):
        assert float((g - w).abs().max()) <= \
            REMAT_TOL * float(w.abs().max())


# ------------------------------------------------------------ the steps

def make_setup(arch="llama3-8b"):
    """``arch``'s smoke config (llama3-8b's unless asked), its reference
    weights and STEPS fleet batches (M learners of B from their
    TokenStreams, drawn by the port's stream, which draws the
    reference's tokens: the test above) and single batches (M B)."""
    jcfg = jget_arch(arch, smoke=True)
    params_np = _np(jinit(jcfg, jax.random.PRNGKey(0)))
    streams = [TokenStream(seed=100 + i, vocab=jcfg.vocab_size,
                           device="cpu") for i in range(M)]
    fleet, single = [], []
    for t in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(1), t)
        bs = [{k: v.numpy() for k, v in s.sample(key_from_numpy(
            jax.random.fold_in(key, i), "cpu"), B, S).items()}
              for i, s in enumerate(streams)]
        fleet.append({k: np.stack([b[k] for b in bs]) for k in bs[0]})
        single.append({k: v.reshape((M * B,) + v.shape[2:])
                       for k, v in fleet[-1].items()})
    return jcfg, params_np, fleet, single, arch


@pytest.fixture(scope="module")
def setup():
    return make_setup()


# the fleet tests' optimizer: adam at lr 1e-3
FLEET_TRAIN = dict(optimizer="adam", learning_rate=1e-3)


def ref_fleet(kind, proto, setup, remat=False, train=FLEET_TRAIN):
    """The reference's fleet step of ``kind`` on ``setup`` (M learners,
    ``train`` the TrainConfig's fields): each step's ``synced``,
    ``max_sq_dist`` and loss, then syncs, checks and the parameter
    plane."""
    jcfg, params_np, fleet, _, _ = setup
    train = JTrainConfig(**train)
    mk = (jdistributed.make_dynamic_train_step if kind == "dynamic"
          else jdistributed.make_periodic_train_step)
    step = jax.jit(mk(lambda p, b: jlm_loss(jcfg, p, b, remat=remat), proto,
                      train, M))
    state = jdistributed.init_dynamic_state(
        lambda k: jax.tree.map(jnp.asarray, params_np),
        jax.random.PRNGKey(0), M, train)
    out = {"synced": [], "max_sq_dist": [], "loss": []}
    for b in fleet:
        state, metrics = step(state, b)
        out["synced"].append(int(metrics["synced"]))
        out["max_sq_dist"].append(float(metrics.get("max_sq_dist", 0.0)))
        out["loss"].append(float(metrics["loss"]))
    out.update(syncs=int(state.syncs), checks=int(state.checks),
               plane=np.asarray(jfleet_adapter(state.params)
                                .ravel(state.params)))
    return out


def port_fleet(kind, proto, setup, remat=False, train=FLEET_TRAIN):
    """``ref_fleet`` in the port, from the reference's weights."""
    _, params_np, fleet, _, arch = setup
    cfg = get_arch(arch, smoke=True)
    train = TrainConfig(**train)
    mk = (distributed.make_dynamic_train_step if kind == "dynamic"
          else distributed.make_periodic_train_step)
    step = mk(lambda p, b: lm_loss(cfg, p, b, remat=remat), proto, train, M)
    state = distributed.init_dynamic_state(
        lambda g: params_from_numpy(params_np, device="cpu"),
        torch.Generator().manual_seed(0), M, train, device="cpu")
    out = {"synced": [], "max_sq_dist": [], "loss": []}
    for b in fleet:
        state, metrics = step(state, _torch_batch(b))
        out["synced"].append(int(metrics["synced"]))
        out["max_sq_dist"].append(float(metrics.get("max_sq_dist", 0.0)))
        out["loss"].append(float(metrics["loss"]))
    out.update(syncs=state.syncs, checks=state.checks,
               plane=state.plane.numpy())
    return out


def close_planes(got, want):
    assert np.linalg.norm(got - want) <= PLANE_REL_TOL * np.linalg.norm(want)
    assert np.abs(got - want).max() <= PLANE_ABS_TOL


def check_fleet(kind, b, delta, setup, remat=False, train=FLEET_TRAIN):
    """The port's fleet step of ``kind`` against the reference's on
    ``setup``: ``synced``, syncs and checks exact, the losses and the
    plane within STEP_LOSS_TOL / PLANE_*_TOL; a dynamic run must both
    sync and skip, with no checked distance within DELTA_MARGIN·Δ of Δ."""
    want = ref_fleet(kind, JProtocolConfig(kind="dynamic", b=b, delta=delta),
                     setup, remat, train)
    got = port_fleet(kind, ProtocolConfig(kind="dynamic", b=b, delta=delta),
                     setup, remat, train)
    assert got["synced"] == want["synced"]
    assert (got["syncs"], got["checks"]) == (want["syncs"], want["checks"])
    if kind == "dynamic":
        assert 0 < want["syncs"] < want["checks"], want["synced"]
        checked = [d for t, d in enumerate(want["max_sq_dist"])
                   if (t + 1) % b == 0]
        # each learner's distance is at most the max: the max decides
        # here, since every learner takes the same steps on equal models
        # up to its batch
        assert min(abs(d - delta) for d in checked) >= DELTA_MARGIN * delta
        np.testing.assert_allclose(got["max_sq_dist"], want["max_sq_dist"],
                                   rtol=1e-4, atol=1e-9)
    else:
        assert want["syncs"] == STEPS // b
    np.testing.assert_allclose(got["loss"], want["loss"], **STEP_LOSS_TOL)
    close_planes(got["plane"], want["plane"])


# Δ sits between the checked distances of the reference's run (llama3-8b-
# smoke, adam at lr 1e-3, b = 2), so the run both syncs and skips
DYN_B, DYN_DELTA = 2, 1.5


@pytest.mark.parametrize("kind", ["dynamic", "periodic"])
def test_fleet_steps_with_lm_loss_match_reference(kind, setup):
    if kind == "dynamic":
        check_fleet(kind, DYN_B, DYN_DELTA, setup)
    else:
        check_fleet(kind, 3, 1.0, setup)


def test_fleet_step_with_remat_matches_reference(setup):
    """The dynamic fleet with rematerialized layers on both sides: the
    learners' vmap over ``RematLayer``'s generated rule."""
    check_fleet("dynamic", DYN_B, DYN_DELTA, setup, remat=True)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_with_lm_loss_matches_reference(micro, setup):
    jcfg, params_np, _, single, _ = setup
    cfg = get_arch("llama3-8b", smoke=True)
    jinit_state, jstep = jmake_train_step(
        lambda p, b: jlm_loss(jcfg, p, b),
        JTrainConfig(optimizer="adam", learning_rate=1e-3,
                     micro_batch=micro))
    jstate = jinit_state(jax.tree.map(jnp.asarray, params_np))
    jstep = jax.jit(jstep)
    init_state, step = make_train_step(
        lambda p, b: lm_loss(cfg, p, b),
        TrainConfig(optimizer="adam", learning_rate=1e-3,
                    micro_batch=micro), device="cpu")
    state = init_state(params_from_numpy(params_np, device="cpu"))
    want_loss, got_loss = [], []
    for b in single:
        jstate, jm = jstep(jstate, b)
        state, m = step(state, _torch_batch(b))
        want_loss.append(float(jm["loss"]))
        got_loss.append(float(m["loss"]))
    np.testing.assert_allclose(got_loss, want_loss, **STEP_LOSS_TOL)
    assert int(state.step) == int(jstate.step) == STEPS
    want = np.asarray(jfleet_adapter(jstate.params).ravel_model(
        jstate.params))
    got = fleet_adapter(state.params).ravel_model(state.params).numpy()
    close_planes(got, want)
