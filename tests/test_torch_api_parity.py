"""Public names the JAX package offers, imported from both packages.

Code written against the reference must find each of these in the port
too: the lazy package re-exports of ``repro.fsl`` and ``repro.core`` (the
build-step lists compared by their members' names), the
``resnet9-paper`` config, ``resnet9.l2_features``,
``graph.set_index_enabled`` and the deprecated aliases.  Each is imported
from both packages and, where it computes, compared on the same inputs.
A config whose family is not ported raises the port's ``not_ported``
message, and ``import repro_torch`` stays lazy.
"""

import dataclasses
import importlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

REEXPORTS = [
    ("fsl", name) for name in ("FSLPipeline", "evaluate_episodes",
                               "pretrain_backbone", "class_means",
                               "ncm_classify", "ncm_accuracy")
] + [
    ("core", name) for name in (
        "FixedPointSpec", "QuantConfig", "dequantize", "fake_quant",
        "multithreshold", "pack_int4", "quantize", "thresholds_for",
        "unpack_int4", "Graph", "GraphBuildError", "Node", "execute",
        "GraphPass", "PassManager", "PassOrderError",
        "PassVerificationError", "PassTrace", "register_pass",
        "BuildRecipe", "list_recipes", "recipe", "register_lazy_recipe",
        "register_recipe", "DeployedModel", "lower_graph", "compile_graph",
        "build_dataflow")
]


@pytest.mark.parametrize("pkg,name", REEXPORTS)
def test_package_reexports_resolve(pkg, name):
    ref = getattr(importlib.import_module(f"repro.{pkg}"), name)
    port = getattr(importlib.import_module(f"repro_torch.{pkg}"), name)
    assert callable(port) and port.__name__ == ref.__name__
    assert port.__module__.startswith("repro_torch.")
    exec(f"from repro_torch.{pkg} import {name}", {})


@pytest.mark.parametrize("name", ["DEFAULT_MLP_STEPS", "RESNET9_BUILD_STEPS"])
def test_build_step_lists_reexported(name):
    ref = getattr(importlib.import_module("repro.core"), name)
    port = getattr(importlib.import_module("repro_torch.core"), name)
    assert [f.__name__ for f in port] == [f.__name__ for f in ref]
    assert all(f.__module__ == "repro_torch.core.transforms" for f in port)
    exec(f"from repro_torch.core import {name}", {})


def test_compile_graph_is_the_compile_entry_point():
    from repro_torch.core import compile_graph
    from repro_torch.core.deploy import compile as deploy_compile

    assert compile_graph is deploy_compile
    import repro_torch
    assert repro_torch.compile is compile_graph


def test_reexports_stay_lazy():
    code = ("import sys, repro_torch, repro_torch.fsl, repro_torch.core; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['repro_torch.core', 'repro_torch.fsl']"


def test_resnet9_paper_config_matches_reference():
    from repro.models.common import get_config as jget
    from repro_torch.models.common import get_config

    ref, port = jget("resnet9-paper"), get_config("resnet9-paper")
    for f in ("name", "family", "n_layers", "d_model", "vocab"):
        assert getattr(port, f) == getattr(ref, f)
    assert port.family == "cnn"
    assert port.quant.weight.total_bits == ref.quant.weight.total_bits == 6
    assert port.quant.act.total_bits == ref.quant.act.total_bits == 4
    mod = importlib.import_module("repro_torch.configs.resnet9_paper")
    assert mod.WIDTH == 64
    assert mod.QUANT_16.weight.total_bits == 16
    from repro_torch.models.common import list_configs
    assert "resnet9-paper" in list_configs()


def test_unported_configs_raise_not_ported():
    """Every config of the JAX package resolves in the port with equal
    fields (MoE grok-1 and arctic, MLA minicpm3 and audio whisper among
    them since their slice), and nothing is left unported."""
    from repro.models.common import get_config as jget
    from repro.models.common import list_configs as jlist
    from repro_torch.models.common import UNPORTED, get_config

    assert UNPORTED == ()
    assert {"arctic-480b", "grok-1-314b", "minicpm3-4b",
            "whisper-tiny"} <= set(jlist())
    for name in jlist():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget(name)), name


def test_unknown_config_raises_key_error():
    from repro_torch.models.common import get_config

    with pytest.raises(KeyError, match="no-such-model"):
        get_config("no-such-model")


def test_l2_features_matches_reference():
    from repro.core.quant import QuantConfig as JQ
    from repro.models import resnet9 as jr
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import resnet9

    pj = jax.tree_util.tree_map(np.asarray, jr.init_params(
        jax.random.PRNGKey(0), 4))
    x = np.random.default_rng(3).random((3, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jr.l2_features(pj, x, JQ.paper_w6a4(), 4))
    got = resnet9.l2_features(params_from_numpy(pj, device="cpu"),
                              torch.from_numpy(x), QuantConfig.paper_w6a4(),
                              4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_set_index_enabled_matches_linear_scan():
    from repro.core import graph as JG
    from repro_torch.core import graph as G
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import resnet9

    assert JG.set_index_enabled.__name__ == G.set_index_enabled.__name__
    params = resnet9.init_params(torch.Generator().manual_seed(0), 4, "cpu")
    g = resnet9.export_graph(params, QuantConfig.paper_w6a4(), width=4)
    tensors = sorted({t for n in g.nodes for t in n.inputs + n.outputs})
    try:
        for t in tensors:
            G.set_index_enabled(True)
            g.invalidate()
            fast = (g.producer(t), g.consumers(t), g.fresh_name(t))
            G.set_index_enabled(False)
            assert g._index() is None
            slow = (g.producer(t), g.consumers(t), g.fresh_name(t))
            assert fast[0] is slow[0] and fast[1:] == slow[1:]
    finally:
        G.set_index_enabled(True)
    dup = G.Graph([G.Node("add", ["t", "t"], ["y"])], ["t"], ["y"], {})
    for on in (True, False):
        try:
            G.set_index_enabled(on)
            dup.invalidate()
            assert len(dup.consumers("t")) == 1
        finally:
            G.set_index_enabled(True)


def test_datatype_rule_alias_registers_and_refuses_overwrite():
    from repro.core import datatypes as JD
    from repro_torch.core import datatypes as D

    assert "datatype_rule" in D.__all__ and "datatype_rule" in JD.__all__
    op = "test_api_parity_op"

    @D.datatype_rule(op)
    def rule(node, in_specs, g):
        return in_specs[0]

    assert D.DATATYPE_RULES[op] is rule
    with pytest.raises(ValueError, match="already registered"):
        D.datatype_rule(op)(lambda n, s, g: None)
    del D.DATATYPE_RULES[op]


def test_apply_transforms_alias_matches_reference():
    from repro.core import transforms as JT
    from repro.core.graph import Graph as JGraph, Node as JNode
    from repro_torch.core import transforms as T
    from repro_torch.core.graph import Graph, Node

    def nodes(N):
        return [N("mul", ["x"], ["a"], {"value": 2.0}),
                N("mul", ["a"], ["y"], {"value": 3.0})]

    g = T.apply_transforms(Graph(nodes(Node), ["x"], ["y"], {}),
                           [T.CollapseRepeatedMul])
    jg = JT.apply_transforms(JGraph(nodes(JNode), ["x"], ["y"], {}),
                             [JT.CollapseRepeatedMul])
    assert [(n.op, n.attrs) for n in g.nodes] == \
        [(n.op, n.attrs) for n in jg.nodes]
    assert T.apply_transforms(g, []) is g


def test_require_fsl_hooks_warns_as_reference():
    from repro.core.recipes import recipe as jrecipe
    from repro_torch.core.recipes import BuildRecipe, recipe

    for rec in (recipe("resnet9"), jrecipe("resnet9")):
        with pytest.warns(DeprecationWarning, match="workload_hooks"):
            assert rec.require_fsl_hooks() is rec
    bare = BuildRecipe("bare", ())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="no FSL hooks"):
            bare.require_fsl_hooks()


TRAINING_NAMES = [
    ("models.lm", "loss_fn"),
    ("launch.steps", "make_train_step"),
    ("launch.steps", "train_dtype_policy"),
    ("data.synthetic", "token_lm_batch"),
    ("dist.compression", "compress_int8"),
    ("dist.compression", "decompress_int8"),
    ("dist.compression", "init_residuals"),
    ("dist.compression", "ef_compress_tree"),
    ("dist.straggler", "StragglerMonitor"),
    ("launch.train", "main"),
]


@pytest.mark.parametrize("mod,name", TRAINING_NAMES)
def test_training_names_resolve(mod, name):
    ref = getattr(importlib.import_module(f"repro.{mod}"), name)
    port = getattr(importlib.import_module(f"repro_torch.{mod}"), name)
    assert callable(port) and port.__name__ == ref.__name__
    assert port.__module__ == f"repro_torch.{mod}"


@pytest.mark.parametrize("datapath", ["int", "f32"])
def test_profile_default_counts_the_matmul_flops(datapath):
    """``dm.profile(x)`` at its default works, and its ``xla.flops`` is
    2·ΣM·K·N over the artifact's matmul-family nodes (the FLOPs the CPU
    run of the plain version performs in products)."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.deploy import compile as tcompile
    from repro_torch.models import resnet9

    params = resnet9.init_params(torch.Generator().manual_seed(1), 4, "cpu")
    dm = tcompile(params, QuantConfig.paper_w6a4(), recipe="resnet9",
                  datapath=datapath, device="cpu")
    x = np.zeros((3, 32, 32, 3), np.float32)
    prof = dm.profile(x)
    g = dm.graph.copy().infer_shapes({dm.input_names[0]: x})
    want = 0
    for n in g.nodes:
        if n.op in ("matmul", "matmul_int", "mvau", "mvau_int"):
            *m, k = g.shapes[n.inputs[0]]
            want += 2 * int(np.prod(m)) * k * g.shapes[n.outputs[0]][-1]
    assert want > 0 and prof["xla"] == {"flops": float(want)}
    assert prof["xla"]["flops"] == sum(
        r["flops"] for r in prof["nodes"]
        if r["op"] in ("matmul", "matmul_int", "mvau", "mvau_int"))
    assert dm.profile(x, xla=False)["xla"] is None


_DIST_NAMES = {
    "dist": ["act_sharding", "compress_int8", "decompress_int8",
             "ef_compress_tree", "init_residuals", "prototype_spec",
             "serve_mesh", "set_fsdp_axes", "set_moe_expert_axis",
             "tree_batch_shardings", "tree_cache_shardings",
             "tree_opt_shardings", "tree_param_shardings",
             "StragglerMonitor"],
    "dist.pipeline": ["pipeline_apply"],
    "dist.act_sharding": ["rules", "get_rule", "constrain"],
    "launch.mesh": ["make_production_mesh", "make_debug_mesh"],
    "launch.specs": ["SHAPES", "cell_supported", "batch_specs",
                     "cache_specs", "param_specs"],
    "launch.dryrun": ["apply_variant", "lower_cell", "artifact_path",
                      "run_cell", "main", "ARTIFACT_DIR"],
    "launch.hlo_analysis": ["analyze", "top_collectives", "top_dots"],
    "launch.diagnose": ["lower_and_text", "main"],
    "obs.hlo": ["analyze", "top_collectives", "top_dots"],
    "obs.diagnose": ["lower_and_text", "main"],
    "launch.steps": ["make_train_step", "make_prefill_step",
                     "make_decode_step", "train_dtype_policy"],
    "ckpt": ["restore_resharded"],
    "serve.cluster": ["ShardedNCMHead", "ShardedStore",
                      "sharded_tenant_registry"],
}


@pytest.mark.parametrize("mod", sorted(_DIST_NAMES))
def test_distribution_names_in_both_packages(mod):
    """Every public name of the distribution slice imports from both
    packages.  The reference's dry run sets ``XLA_FLAGS`` at import; the
    variable is restored so later subprocesses see what they saw."""
    import os

    saved = os.environ.get("XLA_FLAGS")
    try:
        ref = importlib.import_module(f"repro.{mod}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    port = importlib.import_module(f"repro_torch.{mod}")
    for name in _DIST_NAMES[mod]:
        assert hasattr(ref, name), (mod, name)
        assert hasattr(port, name), (mod, name)
