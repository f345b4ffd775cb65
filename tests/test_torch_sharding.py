"""The port's ``launch/mesh.py``, ``launch/sharding.py`` and
``models/sharding_hooks.py`` against the JAX package's, on the CPU.

* The rule functions: ``param_pspec`` / ``cache_pspec`` equal the
  reference's on every leaf of the reference's own trees (its
  ``abstract_params`` and the ``eval_shape`` of its decode caches), for
  every assigned arch at full size, on the 16 x 16, 2 x 16 x 16 and
  2 x 4 meshes.  The reference's functions read only ``mesh.shape``, so
  they get a stand-in; neither side needs a device.
* The tree functions on the port's own trees (``Model.abstract_params``,
  ``input_specs``' ``meta`` caches): each port leaf's spec is the spec
  of the reference leaf it came from, less the leading ``None`` of the
  reference's stacked axis.  The one stated difference is Whisper's
  cross cache: 1504 rows in the port divide a model axis of 16, so its
  sequence shards over ``model``; the reference's 1500 rows do not, so
  its KV heads do.  The ``encoder/layers/<i>/`` paths (trap: they
  contain ``/layers/``, which the reference's rule reads as a stacked
  axis) have a test of their own.
* ``batch_shardings``, ``opt_shardings``, ``placements()``, the meshes.
* The hooks: their state follows the reference's, and ``constrain``
  returns its input object.

Each reference tree is traced once (cached), at full size on
``jax.eval_shape`` (about 2 s for the ten archs), and the file carries a
run-time cap (``CAP_S``): past it the running test fails instead of
holding the suite.
"""
import functools
import signal
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as j_configs  # noqa: E402
import repro.launch.mesh as j_mesh  # noqa: E402
import repro.launch.shapes as j_shapes  # noqa: E402
import repro.launch.sharding as j_sh  # noqa: E402
import repro.models.sharding_hooks as j_hooks  # noqa: E402
import repro_torch.launch.mesh as t_mesh  # noqa: E402
import repro_torch.launch.sharding as t_sh  # noqa: E402
import repro_torch.models.sharding_hooks as t_hooks  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.shapes import input_specs, \
    resolve_arch_for_shape  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training.optim import OptimizerConfig, adamw_init  # noqa: E402

ARCHS = j_configs.ASSIGNED_ARCHS
#: (name, port mesh, fsdp / batch axes)
MESHES = {
    "16x16": (t_mesh.make_production_mesh(), t_mesh.fsdp_axes(False)),
    "2x16x16": (t_mesh.make_production_mesh(multi_pod=True),
                t_mesh.fsdp_axes(True)),
    "2x4": (t_mesh.Mesh((2, 4), ("data", "model")), ("data",)),
}
DECODE_SHAPES = [s for s, v in j_shapes.INPUT_SHAPES.items()
                 if v["kind"] == "decode"]
CAP_S = 240


@pytest.fixture(scope="module", autouse=True)
def run_time_cap():
    """Fail the running test if the file outlasts ``CAP_S`` (only where
    the tests run on the main thread, which ``signal`` needs)."""
    if threading.current_thread() is not threading.main_thread() or \
            not hasattr(signal, "SIGALRM"):
        yield
        return

    def expire(*_):
        raise TimeoutError(f"tests/test_torch_sharding.py exceeded its "
                           f"{CAP_S} s cap")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(CAP_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _ref_mesh(mesh):
    """What the reference's rules read of a mesh: ``shape``."""
    return types.SimpleNamespace(shape=dict(mesh.shape))


def _path(path) -> str:
    return j_sh._path_str(path)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return JModel(j_configs.get_config(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape):
    cfg, skip = j_shapes.resolve_arch_for_shape(j_configs.get_config(arch),
                                                shape)
    if skip:
        return None
    return j_shapes.input_specs(cfg, shape)["cache"]


def _ref_leaves(tree):
    return [(_path(p), tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ---------------------------------------------------------------- meshes

def test_meshes_match_the_reference_names_and_sizes():
    for multi in (False, True):
        m = t_mesh.make_production_mesh(multi_pod=multi)
        assert m.axis_names == (("pod", "data", "model") if multi
                                else ("data", "model"))
        assert list(m.shape.values()) == ([2, 16, 16] if multi
                                          else [16, 16])
        assert int(np.prod(list(m.shape.values()))) == (512 if multi
                                                         else 256)
        assert t_mesh.fsdp_axes(multi) == j_mesh.fsdp_axes(multi)
    smoke = t_mesh.make_smoke_mesh()
    assert smoke.shape == dict(j_mesh.make_smoke_mesh().shape)
    assert smoke.axis_names == ("data", "model")
    with pytest.raises(ValueError):
        t_mesh.Mesh((2, 2), ("data",))


# ------------------------------------------------------ the rule functions

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_equals_reference_on_reference_tree(arch, mesh_name):
    mesh, fsdp = MESHES[mesh_name]
    rm = _ref_mesh(mesh)
    leaves = _ref_leaves(_ref_params(arch))
    assert leaves
    for path, shape in leaves:
        want = tuple(j_sh.param_pspec(path, shape, rm, fsdp))
        assert t_sh.param_pspec(path, shape, mesh, fsdp) == want, path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspec_equals_reference_on_reference_tree(arch, mesh_name):
    mesh, axes = MESHES[mesh_name]
    rm = _ref_mesh(mesh)
    n = 0
    for shape_name in DECODE_SHAPES:
        cache = _ref_cache(arch, shape_name)
        if cache is None:
            continue
        for path, shape in _ref_leaves(cache):
            want = tuple(j_sh.cache_pspec(path, shape, rm, axes))
            assert t_sh.cache_pspec(path, shape, mesh, axes) == want, \
                (shape_name, path)
            n += 1
    assert n


# ------------------------------------------- the port's own trees

def _ref_layer(cfg, i):
    """(reference path prefix of port layer ``i``, whether it is
    stacked)."""
    unit, n_units, _ = cfg.repeating_unit()
    L = len(unit)
    if i < n_units * L:
        return ("units", i % L), True
    return ("rest", i - n_units * L), False


def _leaves_by_path(tree):
    return {_path(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _ref_param_of(path, cfg):
    """The reference path and stacking of the port's parameter ``path``."""
    parts = path.split("/")
    if parts[0] == "layers":
        (top, j), stacked = _ref_layer(cfg, int(parts[1]))
        return "/".join([top, str(j)] + parts[2:]), stacked
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(parts[:2] + parts[3:]), True
    return path, False


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_on_port_tree(arch, mesh_name):
    """Each port leaf's spec is its reference leaf's, less the stacked
    axis; the two trees hold the same leaves."""
    mesh, fsdp = MESHES[mesh_name]
    rm = _ref_mesh(mesh)
    cfg = get_config(arch)
    params = Model(cfg, device="cpu").abstract_params()
    shard = t_sh.param_shardings(params, mesh, fsdp)
    ref = _leaves_by_path(_ref_params(arch))
    seen = set()
    for (path, leaf), (_, s) in zip(_port_leaves(params),
                                    _port_leaves(shard)):
        assert isinstance(s, t_sh.Sharding) and s.mesh is mesh
        rpath, stacked = _ref_param_of(path, cfg)
        rshape = ref[rpath]
        assert tuple(leaf.shape) == (rshape[1:] if stacked else rshape)
        want = tuple(j_sh.param_pspec(rpath, rshape, rm, fsdp))
        if stacked:
            assert want[0] is None
            want = want[1:]
        assert s.spec == want, path
        assert len(s.spec) == leaf.dim()
        seen.add(rpath)
    assert seen == set(ref)


def test_encoder_layer_paths_are_not_stacked():
    """``encoder/layers/<i>/...`` contains ``/layers/``: read with the
    reference's path convention (``n_lead=None``) a port leaf would lose
    its first dim to a stacked axis it does not have.  The tree function
    passes ``n_lead=0`` and gives the reference's spec of the stacked
    leaf less its lead."""
    mesh, fsdp = MESHES["16x16"]
    rm = _ref_mesh(mesh)
    cfg = get_config("whisper_medium")
    params = Model(cfg, device="cpu").abstract_params()
    shard = t_sh.param_shardings(params, mesh, fsdp)
    enc = params["encoder"]["layers"]
    assert len(enc) == cfg.enc_layers == 24
    ref = _leaves_by_path(_ref_params("whisper_medium"))
    for name, sub in (("norm1/scale", ("norm1", "scale")),
                      ("wq/w", ("wq", "w")), ("ffn/wo/w", ("ffn", "wo", "w"))):
        path = f"encoder/layers/3/{name}"
        leaf = enc[3]
        got = shard["encoder"]["layers"][3]
        for k in sub:
            leaf, got = leaf[k], got[k]
        rspec = tuple(j_sh.param_pspec(f"encoder/layers/{name}",
                                       ref[f"encoder/layers/{name}"], rm,
                                       fsdp))
        assert got.spec == rspec[1:], name
        literal = t_sh.param_pspec(path, tuple(leaf.shape), mesh, fsdp)
        assert literal != got.spec, name
    # the norm scale (1024,): sharded over model, not lost
    assert shard["encoder"]["layers"][3]["norm1"]["scale"].spec == ("model",)
    assert t_sh.param_pspec("encoder/layers/3/norm1/scale", (1024,), mesh,
                            fsdp) == (None,)


def _ref_cache_leaf(entry_ref, name):
    if isinstance(entry_ref, tuple):                # (k, v[, xk, xv])
        return ("k", "v", "xk", "xv").index(name)
    return name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_on_port_tree(arch, mesh_name):
    """Each port cache leaf's spec is its reference leaf's, less the
    stacked axis -- but for Whisper's cross caches where the model axis
    divides 1504 and not 1500."""
    mesh, axes = MESHES[mesh_name]
    rm = _ref_mesh(mesh)
    for shape_name in DECODE_SHAPES:
        jcache = _ref_cache(arch, shape_name)
        if jcache is None:
            continue
        cfg, _ = resolve_arch_for_shape(get_config(arch), shape_name)
        cache = input_specs(cfg, shape_name)["cache"]
        shard = t_sh.cache_shardings(cache, mesh, axes)
        differ = []
        for i, (entry, sh) in enumerate(zip(cache, shard)):
            (top, j), stacked = _ref_layer(cfg, i)
            eref = jcache[top][j]
            prefix = f"{top}/{j}"
            for name, t in entry.items():
                key = _ref_cache_leaf(eref, name)
                r = eref[key]
                want = tuple(j_sh.cache_pspec(f"{prefix}/{key}",
                                              tuple(r.shape), rm, axes))
                if stacked:
                    assert want[0] is None
                    want = want[1:]
                got = sh[name].spec
                assert len(got) == t.dim()
                if got != want:
                    differ.append((i, name, got, want))
        if arch == "whisper_medium" and mesh.shape["model"] == 16:
            # the stated difference, and only it: every cross cache leaf
            n_x = cfg.block_pattern.count("xattn")
            assert len(differ) == 2 * n_x
            for i, name, got, want in differ:
                assert name in ("xk", "xv")
                b = "data" if len(axes) == 1 else axes
                assert got == (b, "model", None, None)      # 1504 rows
                assert want == (b, None, "model", None)     # 16 KV heads
        else:
            assert differ == [], (shape_name, differ[:3])


# ------------------------------------------- batches, optimizer, placements

def test_batch_shardings_match_reference():
    from jax.sharding import AbstractMesh
    for name, (mesh, axes) in MESHES.items():
        am = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
        for arch in ("qwen3_4b", "whisper_medium", "paligemma_3b"):
            for shape_name in j_shapes.INPUT_SHAPES:
                tcfg, skip = resolve_arch_for_shape(get_config(arch),
                                                    shape_name)
                if skip:
                    continue
                jcfg, _ = j_shapes.resolve_arch_for_shape(
                    j_configs.get_config(arch), shape_name)
                ts = input_specs(tcfg, shape_name)
                js = j_shapes.input_specs(jcfg, shape_name)
                if ts["kind"] == "decode":
                    tb = {"t": ts["token"], "p": ts["pos"]}
                    jb = {"t": js["token"], "p": js["pos"]}
                else:
                    tb, jb = ts["batch"], js["batch"]
                got = t_sh.batch_shardings(tb, mesh, axes)
                want = j_sh.batch_shardings(jb, am, axes)
                assert set(got) == set(want)
                for k in got:
                    assert got[k].spec == tuple(want[k].spec), \
                        (name, arch, shape_name, k)


def test_opt_shardings_mirror_params_step_replicated():
    mesh, fsdp = MESHES["16x16"]
    params = Model(get_config("qwen3_4b"), device="cpu").abstract_params()
    state = adamw_init(params, OptimizerConfig())
    assert state.m["embed"]["w"].device.type == "meta"
    pshard = t_sh.param_shardings(params, mesh, fsdp)
    osh = t_sh.opt_shardings(state, pshard, mesh)
    assert osh.step == t_sh.Sharding(mesh, ())
    assert osh.m is pshard and osh.v is pshard
    with pytest.raises(ValueError):
        t_sh.opt_shardings(state._replace(m={"embed": state.m["embed"]}),
                           pshard, mesh)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh3, _ = MESHES["2x16x16"]
    s = t_sh.Sharding(mesh3, (("pod", "data"), "model"))
    assert s.placements() == (Shard(0), Shard(0), Shard(1))
    mesh2, fsdp = MESHES["16x16"]
    assert t_sh.Sharding(mesh2, (None, "model")).placements() == \
        (Replicate(), Shard(1))
    assert t_sh.Sharding(mesh2, ()).placements() == (Replicate(),
                                                      Replicate())
    # a real leaf: Qwen3-4B's wq (d, H*hd) is column-sharded
    params = Model(get_config("qwen3_4b"), device="cpu").abstract_params()
    wq = t_sh.param_shardings(params, mesh2, fsdp)["layers"][0]["attn"]["wq"]
    assert wq["w"].spec == ("data", "model")
    assert wq["w"].placements() == (Shard(0), Shard(1))


def test_specs_divide_their_dims_on_port_trees():
    """Every sharded dim of every port parameter divides its axes' size
    (the property the layout exists for), at full size."""
    for name, (mesh, fsdp) in MESHES.items():
        for arch in ARCHS:
            params = Model(get_config(arch), device="cpu").abstract_params()
            shard = t_sh.param_shardings(params, mesh, fsdp)
            for (_, leaf), (_, s) in zip(_port_leaves(params),
                                         _port_leaves(shard)):
                for dim, ax in zip(leaf.shape, s.spec):
                    if ax is None:
                        continue
                    axes = (ax,) if isinstance(ax, str) else ax
                    assert dim % int(np.prod([mesh.shape[a]
                                              for a in axes])) == 0


# ---------------------------------------------------------------- hooks

@pytest.fixture
def clean_hooks():
    yield
    for h in (j_hooks, t_hooks):
        h.clear_activation_sharding()
        h.set_sequence_parallel(False)
        h._ACT_SHARD["model_axis"] = "model"


def test_hooks_state_follows_reference(clean_hooks):
    mesh, axes = MESHES["16x16"]
    for h in (j_hooks, t_hooks):
        assert not h.active()
        assert h.batch_axes() is None and h.model_axis() == "model"
    for h in (j_hooks, t_hooks):
        h.set_activation_sharding(mesh, axes, model_axis="tp")
    assert t_hooks.active() == j_hooks.active() is True
    assert t_hooks.batch_axes() == j_hooks.batch_axes() == axes
    assert t_hooks.model_axis() == j_hooks.model_axis() == "tp"
    for h in (j_hooks, t_hooks):
        h.clear_activation_sharding()
    assert t_hooks.active() == j_hooks.active() is False
    assert t_hooks.batch_axes() == j_hooks.batch_axes() is None
    assert t_hooks.model_axis() == j_hooks.model_axis() == "tp"
    for v in (1, 0):
        for h in (j_hooks, t_hooks):
            h.set_sequence_parallel(v)
        assert t_hooks.SEQUENCE_PARALLEL is j_hooks.SEQUENCE_PARALLEL \
            is bool(v)


def test_constrain_returns_its_input(clean_hooks):
    mesh, axes = MESHES["2x16x16"]
    x3 = torch.randn(4, 6, 8)
    x4 = torch.randn(4, 2, 3, 8)
    for mesh_set in (False, True):
        if mesh_set:
            t_hooks.set_activation_sharding(mesh, axes)
        for sp in (False, True):
            t_hooks.set_sequence_parallel(sp)
            assert t_hooks.constrain(x3, "data", None, "model") is x3
            assert t_hooks.constrain_tokens_dim(x3) is x3
            assert t_hooks.constrain_logits(x3) is x3
            assert t_hooks.constrain_moe_buffer(x4) is x4
    # the reference's constrain is the identity too while no mesh is set
    assert j_hooks.constrain(x3, "data") is x3
