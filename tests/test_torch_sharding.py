"""The port's layout rules and dry-run stand-ins against the JAX package's.

* ``_param_spec`` / ``_batch_spec`` / ``_cache_spec`` (pure Python in both
  packages) give the same spec, leaf for leaf, for every assigned config's
  parameter, batch and cache trees (the reference's ``jax.eval_shape``
  trees) on the 16x16 and 2x16x16 production meshes and the 2x2 debug
  mesh, under every ``set_fsdp_axes``/``set_moe_expert_axis`` setting the
  dry run uses; the ``tree_*_shardings`` over the port's own stand-ins
  give the same specs;
* ``launch.specs``' meta stand-ins equal JAX's ``ShapeDtypeStruct``s in
  shape and dtype for every (arch, shape) cell (and the w8/w4 serving
  trees), and hold no storage;
* ``NamedSharding.placements`` maps specs to DTensor placements.

The meshes here are ``{axis: size}`` mappings (the rules read only sizes);
the layouts on real ranks are in ``tests/test_torch_dist_ranks.py``.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs  # noqa: E402,F401
import repro_torch.configs  # noqa: E402,F401
from repro.dist import sharding as JSH  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models.common import get_config as jget  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402
from repro_torch.tree import tree_flatten, tree_paths  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
# (fsdp axes, expert axis): every setting launch/dryrun.py makes
SETTINGS = [(("data",), "data"), (("data",), "model"), ((), "data"),
            (("pod", "data"), "data"), (("pod", "data"), "model")]


def _jdtype(d) -> torch.dtype:
    return getattr(torch, str(jnp.dtype(d)))


@pytest.fixture(autouse=True)
def _reset_knobs():
    yield
    for m in (JSH, SH):
        m.set_fsdp_axes(("data",))
        m.set_moe_expert_axis("data")


def _ref_spec(fn, shape, mesh):
    return tuple(fn(tuple(shape), types.SimpleNamespace(shape=mesh)))


def _shapes(tree):
    return [tuple(t.shape) for t in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def trees():
    """Per arch: the reference's float param tree, its w4 serving tree and
    its decode cache (eval_shape), and the port's stand-ins."""
    out = {}
    for arch in ASSIGNED:
        jc, pc = jget(arch), get_config(arch)
        out[arch] = {
            "jparams": JSP.param_specs(jc),
            "jw4": JSP.param_specs(jc, 4, jnp.bfloat16),
            "jcache": JSP.cache_specs(jc, "decode_32k"),
            "params": SP.param_specs(pc),
            "cache": SP.cache_specs(pc, "decode_32k"),
        }
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("setting", SETTINGS, ids=lambda s: repr(s))
def test_param_specs_equal_reference(trees, mesh_name, setting):
    mesh = MESHES[mesh_name]
    for m in (JSH, SH):
        m.set_fsdp_axes(setting[0])
        m.set_moe_expert_axis(setting[1])
    for arch, t in trees.items():
        for key in ("jparams", "jw4"):
            for shape in _shapes(t[key]):
                assert SH._param_spec(shape, mesh) == \
                    _ref_spec(JSH._param_spec, shape, mesh), (arch, shape)
        port = [s.spec for s in tree_flatten(
            SH.tree_param_shardings(t["params"], mesh))[0]]
        want = [_ref_spec(JSH._param_spec, s, mesh)
                for s in _shapes(t["jparams"])]
        assert port == want, arch
        assert [s.spec for s in tree_flatten(
            SH.tree_opt_shardings(t["params"], mesh))[0]] == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_and_cache_specs_equal_reference(trees, mesh_name):
    mesh = MESHES[mesh_name]
    for arch, t in trees.items():
        cfg, jcfg = get_config(arch), jget(arch)
        for shape_name in SP.SHAPES:
            jb = JSP.batch_specs(jcfg, shape_name)
            pb = SP.batch_specs(cfg, shape_name)
            assert sorted(pb) == sorted(jb)
            port = {k: s.spec for k, s in
                    SH.tree_batch_shardings(pb, mesh).items()}
            for k in jb:
                assert port[k] == _ref_spec(JSH._batch_spec, jb[k].shape,
                                            mesh), (arch, shape_name, k)
        port = [s.spec for s in tree_flatten(
            SH.tree_cache_shardings(t["cache"], mesh))[0]]
        assert port == [_ref_spec(JSH._cache_spec, s, mesh)
                        for s in _shapes(t["jcache"])], arch
    # the rules' edge branches: scalars, no data axis, odd batch sizes
    for shape in [(), (3,), (5, 7), (2, 6, 16), (4, 3, 16), (0, 4)]:
        for m in (mesh, {"model": 4}):
            assert SH._batch_spec(shape, m) == \
                _ref_spec(JSH._batch_spec, shape, m)
            assert SH._cache_spec(shape, m) == \
                _ref_spec(JSH._cache_spec, shape, m)


def _check_like(port_tree, jax_tree, what):
    pl, jl = tree_flatten(port_tree)[0], jax.tree.leaves(jax_tree)
    assert tree_paths(port_tree) == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jax_tree)[0]], what
    for p, j in zip(pl, jl):
        assert p.is_meta, what
        assert tuple(p.shape) == tuple(j.shape), what
        assert p.dtype == _jdtype(j.dtype), (what, p.dtype, j.dtype)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_stand_ins_equal_jax(trees, arch):
    """Every (arch, shape) cell's batch, cache and params (the dry run's
    dtypes: the train policy, bf16 serving, w8/w4) as JAX's."""
    from repro.launch.steps import train_dtype_policy as jpolicy

    from repro_torch.launch.steps import train_dtype_policy

    cfg, jcfg = get_config(arch), jget(arch)
    t = trees[arch]
    _check_like(t["params"], t["jparams"], "params")
    _check_like(t["cache"], t["jcache"], "cache")
    for shape_name in SP.SHAPES:
        assert SP.cell_supported(cfg, shape_name) == \
            JSP.cell_supported(jcfg, shape_name)
        _check_like(SP.batch_specs(cfg, shape_name),
                    JSP.batch_specs(jcfg, shape_name), shape_name)
    pdtype = train_dtype_policy(cfg)[0]
    assert _jdtype(jpolicy(jcfg)[0]) == pdtype
    if pdtype != torch.float32:        # float32 is the fixture's tree
        _check_like(SP.param_specs(cfg, dtype=pdtype),
                    JSP.param_specs(jcfg, dtype=jpolicy(jcfg)[0]), "train")
    _check_like(SP.param_specs(cfg, 0, torch.bfloat16),
                JSP.param_specs(jcfg, 0, jnp.bfloat16), "serve")
    _check_like(SP.param_specs(cfg, 8, torch.bfloat16),
                JSP.param_specs(jcfg, 8, jnp.bfloat16), 8)
    _check_like(SP.param_specs(cfg, 4, torch.bfloat16), t["jw4"], 4)
    _check_like(SP.cache_specs(cfg, "decode_32k", torch.int8),
                JSP.cache_specs(jcfg, "decode_32k", jnp.int8), "int8 cache")


def test_named_sharding_placements_and_prototype_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES["2x16x16"]
    ns = SH.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert ns.placements == (Shard(0), Shard(0), Shard(2))
    assert SH.NamedSharding(mesh, (None, "data")).placements == \
        (Replicate(), Shard(1), Replicate())
    assert SH.NamedSharding(mesh, ()).placements == (Replicate(),) * 3
    assert SH.mesh_shape(mesh) == mesh
    # prototype_spec over a mesh: the reference's rule on the same sizes
    for n in (0, 6, 8, 32):
        for m in ({"model": 4}, {"x": 4}):
            split = SH.prototype_spec(n, m).split
            ref = JSH.prototype_spec(n, types.SimpleNamespace(shape=m))
            assert split == (ref == jax.sharding.PartitionSpec("model", None))
