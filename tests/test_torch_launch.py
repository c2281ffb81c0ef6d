"""The launcher's mesh, sharding rules and programs (``repro_torch.launch``
``mesh``, ``sharding``, ``specs``; ``repro_torch.pjit_utils``) against
the JAX package's on the CPU:

* ``logical_to_spec``, ``param_spec_tree`` (with and without the learner
  axis), ``cache_spec_tree`` and ``batch_spec_tree`` equal to the
  reference's, leaf by leaf, for every config of ``ASSIGNED_ARCHS`` at its
  published size, on both production meshes (the reference's on
  ``compat.abstract_mesh``, its structs by ``specs.params_struct`` /
  ``input_specs``);
* ``build_program``'s names, ``meta``, argument shapes and dtypes and in /
  out specs equal to the reference's for every config x shape that
  ``dryrun.pairs_for`` yields (the shape's own mode) and both fleet modes
  at ``train_4k``, on both meshes. The sigma_1 optimizer's step count
  is (1,), one a row (``optim/optimizers.py::init_step``), where the
  reference's is (). The fleet state is the port's
  ``DynamicTrainState`` (``launch/specs.py``, "Departures"): its stacked
  params, optimizer steps and batch are compared with the reference's,
  its raveled ``ref`` row with the reference's ``ref`` tree, leaf shapes
  and specs in order;
* at smoke size on the CPU the five programs, ``materialize``d from a
  seed, against the reference's jitted on a (1, 1) mesh of the one CPU
  device from the same values: losses within ``LOSS_TOL``, logits, new
  weights and metrics within ``TOL`` (the port's LM tests' tolerances),
  ``synced`` exact;
* a real ``DeviceMesh`` over one gloo rank: ``to_placements``,
  ``local_shape`` and ``constrain`` redistributing a ``DTensor``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro import compat  # noqa: E402
from repro import pjit_utils as jpjit  # noqa: E402
from repro.config import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.configs import ASSIGNED_ARCHS as JARCHS  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import pjit_utils  # noqa: E402
from repro_torch.config import INPUT_SHAPES, ShapeConfig, get_arch  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)          # tests/test_torch_lm.py
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_torch_lm_train.py
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(kind):
    return compat.abstract_mesh(*MESHES[kind])


def _tmesh(kind):
    return make_production_mesh(multi_pod=kind == "multi")


def _names(path):
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(str(k.key))
        elif hasattr(k, "name"):
            out.append(k.name)
    return tuple(out)


def jflat(tree, leaf=None):
    """{path names: leaf} of a reference tree (``leaf``: a leaf type)."""
    is_leaf = (lambda x: isinstance(x, leaf)) if leaf else None
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {_names(p): v for p, v in flat}


def tflat(tree):
    """{path names: leaf} of a port tree."""
    out = {}
    shd.map_named(lambda n, x: out.setdefault(n, x), tree)
    return out


def jspec(tree):
    """{path names: spec tuple} of a reference spec or sharding tree."""
    def as_tuple(s):
        return tuple((s.spec if isinstance(s, NamedSharding) else s))
    flat = jflat(tree, (NamedSharding, jax.sharding.PartitionSpec))
    return {k: as_tuple(v) for k, v in flat.items()}


def tspec(tree):
    return {k: tuple(v) for k, v in tflat(tree).items()}


def shapes(flat):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat.items()}


# ------------------------------------------------------- sharding rules

@pytest.mark.parametrize("kind", ["single", "multi"])
def test_sharding_trees_are_the_references(kind):
    jmesh, tmesh = _jmesh(kind), _tmesh(kind)
    multi = kind == "multi"
    jaxes, taxes = jshd.default_axes_map(multi), shd.default_axes_map(multi)
    assert taxes == jaxes
    assert shd.activation_rules(taxes) == jshd.activation_rules(jaxes)
    fleet = dict(taxes, batch="data") if multi else dict(taxes, learner=None)
    for arch in ASSIGNED_ARCHS:
        jcfg, cfg = jget_arch(arch), get_arch(arch)
        jp, tp = jspecs.params_struct(jcfg), specs.params_struct(cfg)
        assert shapes(tflat(tp)) == shapes(jflat(jp)), arch
        assert tspec(shd.param_spec_tree(tp, tmesh, taxes)) == jspec(
            jshd.param_spec_tree(jp, jmesh, jaxes)), arch
        m = 2
        jst = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            (m,) + s.shape, s.dtype), jp)
        tst = shd.map_named(lambda n, s: torch.empty(
            (m,) + tuple(s.shape), dtype=s.dtype, device="meta"), tp)
        assert tspec(shd.param_spec_tree(tst, tmesh, fleet, True)) == jspec(
            jshd.param_spec_tree(jst, jmesh, fleet, learner_axis=True)), arch
        for sname in dryrun.pairs_for(arch):
            jin = jspecs.input_specs(jcfg, JSHAPES[sname])
            tin = specs.input_specs(cfg, INPUT_SHAPES[sname])
            if "cache" in jin:
                assert shapes(tflat(tin["cache"])) == shapes(
                    jflat(jin["cache"])), (arch, sname)
                assert tspec(shd.cache_spec_tree(
                    tin["cache"], tmesh, taxes)) == jspec(
                    jshd.cache_spec_tree(jin["cache"], jmesh, jaxes))
                jb, tb = {"token": jin["token"]}, {"token": tin["token"]}
            else:
                jb, tb = jin, tin
            assert shapes(tflat(tb)) == shapes(jflat(jb)), (arch, sname)
            assert tspec(shd.batch_spec_tree(tb, tmesh, taxes)) == jspec(
                jshd.batch_spec_tree(jb, jmesh, jaxes)), (arch, sname)


def test_logical_to_spec_is_the_references():
    jmesh, tmesh = _jmesh("multi"), _tmesh("multi")
    rules = jshd.activation_rules(jshd.default_axes_map(True))
    cases = [(("batch", None, "heads"), (64, 7, 32)),
             (("batch", None, "heads"), (64, 7, 25)),
             (("expert", None, "tp"), (160, 8, 64)),
             (("expert", None, "tp"), (8, 8, 64)),
             (("embed", "tp"), (4096, 1024)), ((None, "vocab"), (3, 50280))]
    for names, dims in cases:
        for m_j, m_t, d in ((jmesh, tmesh, dims), (None, None, None)):
            assert tuple(pjit_utils.logical_to_spec(names, rules, m_t, d)) \
                == tuple(jpjit.logical_to_spec(names, rules, m_j, d))


def test_local_shape_is_the_references_shard_shape():
    jmesh, tmesh = _jmesh("multi"), _tmesh("multi")
    for spec, shape in ((("pod", "model", "data"), (2, 128256, 4096)),
                        ((("pod", "data"), None), (64, 4096)),
                        ((None, "model"), (3, 64)), ((), (5,))):
        want = NamedSharding(jmesh, jax.sharding.PartitionSpec(*spec)) \
            .shard_shape(shape)
        assert shd.local_shape(shape, shd.PartitionSpec(*spec), tmesh) == \
            tuple(want)


# ------------------------------------------------------------- programs

def _cases():
    for arch in JARCHS:
        for sname in dryrun.pairs_for(arch):
            yield arch, sname, "auto"
        for mode in ("train_dynamic", "train_periodic"):
            yield arch, "train_4k", mode


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_programs_are_the_references(kind):
    jmesh, tmesh = _jmesh(kind), _tmesh(kind)
    for arch, sname, mode in _cases():
        jp = jspecs.build_program(jget_arch(arch), JSHAPES[sname], jmesh,
                                  mode)
        tp = specs.build_program(get_arch(arch), INPUT_SHAPES[sname], tmesh,
                                 mode)
        where = (arch, sname, mode, kind)
        assert (tp.name, tp.meta) == (jp.name, jp.meta), where
        mode_ = jp.meta["mode"]
        if mode_ == "train":
            (js, jb), (ts, tb) = jp.args, tp.args
            assert shapes(tflat(ts.params)) == shapes(jflat(js.params))
            # one step count a row (``optim/optimizers.py::init_step``)
            assert tuple(ts.opt_state.step.shape) == (1,)
            assert js.opt_state.step.shape == ()
            assert (tuple(ts.step.shape), ts.step.dtype) == (
                js.step.shape, torch.int32)
            assert shapes(tflat(tb)) == shapes(jflat(jb)), where
            jss, jbs = jp.in_shardings
            tss, tbs = tp.in_shardings
            assert tspec(tss.params) == jspec(jss.params), where
            assert tspec(tbs) == jspec(jbs), where
            assert tspec(tp.out_shardings[1]) == jspec(jp.out_shardings[1])
        elif mode_ in ("train_dynamic", "train_periodic"):
            (js, jb), (ts, tb) = jp.args, tp.args
            assert shapes(tflat(ts.params)) == shapes(jflat(js.params))
            assert tuple(ts.opt_state.step.shape) == js.opt_state.step.shape
            assert ts.plane.shape == (jp.meta["m"], sum(
                v.size for v in jax.tree.leaves(js.ref)))
            assert shapes(tflat(tb)) == shapes(jflat(jb)), where
            jss, jbs = jp.in_shardings
            tss, tbs = tp.in_shardings
            assert tspec(tss.params) == jspec(jss.params), where
            jref = [(tuple(v.shape), tuple(s.spec)) for v, s in zip(
                jax.tree.leaves(js.ref), jax.tree.leaves(
                    jss.ref, is_leaf=lambda x: isinstance(x,
                                                          NamedSharding)))]
            assert list(zip(tss.ref.shapes, map(tuple, tss.ref.specs))) == \
                jref, where
            assert tspec(tbs) == jspec(jbs), where
            assert tspec(tp.out_shardings[1]) == jspec(jp.out_shardings[1])
        else:
            assert len(tp.args) == len(jp.args)
            for ta, ja, ts_, js_ in zip(tp.args, jp.args, tp.in_shardings,
                                        jp.in_shardings):
                assert shapes(tflat(ta)) == shapes(jflat(ja)), where
                assert tspec(ts_) == jspec(js_), where
            if mode_ == "prefill":
                assert tuple(tp.out_shardings) == tuple(
                    jp.out_shardings.spec)
            else:
                assert tp.out_shardings is jp.out_shardings is None


# ------------------------------------------- smoke programs, values

SMOKE = {"train": ShapeConfig("smoke", 32, 4, "train"),
         "prefill": ShapeConfig("smoke", 32, 2, "prefill"),
         "decode": ShapeConfig("smoke", 32, 2, "decode")}


@pytest.fixture(scope="module")
def one_device_mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def _np(t):
    return t.detach().cpu().numpy()


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, params_to_numpy(tree))


def _jshape(s):
    return JShape(s.name, s.seq_len, s.global_batch, s.kind)


def _run_both(arch, mode, mesh):
    shape = SMOKE["train" if mode.startswith("train") else mode]
    cfg, jcfg = get_arch(arch, smoke=True), jget_arch(arch, smoke=True)
    tprog = specs.materialize(specs.build_program(
        cfg, shape, AbstractMesh((1, 1), ("data", "model")), mode),
        seed=3, device="cpu")
    jprog = jspecs.build_program(jcfg, _jshape(shape), mesh, mode)
    return cfg, tprog, jprog


def _jit(jprog, mesh, *args):
    with mesh:
        return jax.jit(jprog.fn, in_shardings=jprog.in_shardings,
                       out_shardings=jprog.out_shardings)(*args)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b"])
def test_train_program_matches_the_reference(arch, one_device_mesh):
    _, tprog, jprog = _run_both(arch, "train", one_device_mesh)
    state, batch = tprog.args
    jparams = _jnp_tree(state.params)
    jstate = jprog.args[0]._replace(
        params=jparams,
        opt_state=jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                               jprog.args[0].opt_state),
        step=jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(_np(v)) for k, v in batch.items()}
    new, metrics = tprog.fn(state, batch)
    jnew, jm = _jit(jprog, one_device_mesh, jstate, jbatch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    got, want = params_to_numpy(new.params), jax.tree.map(np.asarray,
                                                          jnew.params)
    for k, w in jflat(want).items():
        np.testing.assert_allclose(tflat(got)[k], w, **TOL, err_msg=str(k))
    assert int(new.step) == int(jnew.step) == 1


@pytest.mark.parametrize("mode", ["train_dynamic", "train_periodic"])
def test_fleet_programs_match_the_reference(mode, one_device_mesh):
    cfg, tprog, jprog = _run_both("llama3-8b", mode, one_device_mesh)
    state, batch = tprog.args
    m = tprog.meta["m"]
    js = jprog.args[0]
    jparams = _jnp_tree(state.params)
    jref = jax.tree.map(lambda x: x[0], jparams)
    jstate = js._replace(
        params=jparams, opt_state=jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), js.opt_state),
        ref=jref, step=jnp.asarray(state.step, jnp.int32),
        syncs=jnp.zeros((), jnp.int32), checks=jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(_np(v)) for k, v in batch.items()}
    new, metrics = tprog.fn(state, batch)
    jnew, jm = _jit(jprog, one_device_mesh, jstate, jbatch)
    assert int(metrics["synced"]) == int(jm["synced"]) == 1
    assert (new.step, new.syncs) == (int(jnew.step), int(jnew.syncs))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    if mode == "train_dynamic":
        assert new.checks == int(jnew.checks) == 1
        np.testing.assert_allclose(_np(metrics["loss_per_learner"]),
                                   np.asarray(jm["loss_per_learner"]),
                                   **LOSS_TOL)
        d = float(metrics["max_sq_dist"])
        np.testing.assert_allclose(d, float(jm["max_sq_dist"]), **TOL)
        assert abs(d - 1.0) > 1e-4        # no distance at the threshold
    got = tflat(params_to_numpy(new.params))
    for k, w in jflat(jax.tree.map(np.asarray, jnew.params)).items():
        np.testing.assert_allclose(got[k], w, **TOL, err_msg=str(k))
    assert new.plane.shape[0] == m


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b"])
def test_serving_programs_match_the_reference(arch, one_device_mesh):
    for mode in ("prefill", "decode"):
        _, tprog, jprog = _run_both(arch, mode, one_device_mesh)
        jargs = [_jnp_tree(a) if isinstance(a, dict)
                 else jnp.asarray(_np(a)) for a in tprog.args]
        got = tprog.fn(*tprog.args)
        want = _jit(jprog, one_device_mesh, *jargs)
        if mode == "decode":
            got, want = got[0], want[0]
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_vision_prefill_program_matches_the_reference(one_device_mesh):
    shape = ShapeConfig("smoke", specs.VISION_PREFIX_TOKENS + 8, 2,
                        "prefill")
    cfg, jcfg = (get_arch("internvl2-76b", smoke=True),
                 jget_arch("internvl2-76b", smoke=True))
    tprog = specs.materialize(specs.build_program(
        cfg, shape, AbstractMesh((1, 1), ("data", "model")), "prefill"),
        seed=1, device="cpu")
    jprog = jspecs.build_program(jcfg, _jshape(shape), one_device_mesh,
                                 "prefill")
    p, t, pe = tprog.args
    want = _jit(jprog, one_device_mesh, _jnp_tree(p), jnp.asarray(_np(t)),
                jnp.asarray(_np(pe)))
    np.testing.assert_allclose(_np(tprog.fn(*tprog.args)), np.asarray(want),
                               **TOL)


def test_meta_programs_need_the_launcher():
    """``materialize`` on the CPU runs; ``meta`` stays refused outside
    the launcher's block."""
    from repro_torch.device import resolve_device, shapes_only
    with pytest.raises(ValueError):
        resolve_device("meta")
    with shapes_only():
        assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("meta")


# ------------------------------------------------ a real device mesh

def test_device_mesh_placements_and_constrain(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import axis_sizes, device_mesh
    with pytest.raises(RuntimeError):
        device_mesh((1, 1), ("data", "model"), "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = device_mesh((1, 1), ("data", "model"), "cpu")
        assert axis_sizes(mesh) == {"data": 1, "model": 1}
        with pytest.raises(ValueError):
            device_mesh((2, 1), ("data", "model"), "cpu")
        spec = shd.PartitionSpec(("data", "model"), None)
        assert shd.to_placements(spec, mesh) == (Shard(0), Shard(0))
        assert shd.to_placements(shd.PartitionSpec(None, "model"), mesh) \
            == (Replicate(), Shard(1))
        assert shd.local_shape((4, 6), spec, mesh) == (4, 6)
        x = torch.arange(24.0).reshape(4, 6)
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        rules = {"batch": "data", "tp": "model"}
        assert pjit_utils.constrain(dx, ("batch", "tp")) is dx   # no mesh
        with pjit_utils.mesh_context(mesh, rules):
            got = pjit_utils.constrain(dx, ("batch", "tp"))
            assert got.placements == (Shard(0), Shard(1))
            assert pjit_utils.constrain(x, ("batch", "tp")) is x
            assert torch.equal(got.full_tensor(), x)
        with pjit_utils.mesh_context(mesh, dict(rules,
                                                _gather_weights=False)):
            assert pjit_utils.gather_weight(dx, ("batch", "tp")) is dx
    finally:
        dist.destroy_process_group()
