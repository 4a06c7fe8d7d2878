"""The port's build-step lists (``core/build.py``) against the JAX
reference, on the same numpy params through both packages'
``resnet9.export_graph`` at width 8:

* the FINN tutorial's MLP steps fail on ResNet-9 in both packages, with the
  same error class and message naming the same mis-ordered pass, and so
  does a bare ``reduce_mean`` graph (the paper's Sec. III-A negative
  result);
* the customized ResNet-9 steps give the reference's HW graph node for
  node (ops, tensor names, attributes) with initializers bit for bit, and
  the op-set and transpose-count claims of the reference's own tests hold;
* the HW graph run by the port's interpreter equals
  ``compile(g, recipe="resnet9")`` and the JAX interpreter bit for bit.
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro.core import build as JB  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.graph import Node as JNode  # noqa: E402
from repro.core.graph import execute as jexecute  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import build as TB  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.graph import Graph as TGraph  # noqa: E402
from repro_torch.core.graph import GraphBuildError  # noqa: E402
from repro_torch.core.graph import Node as TNode  # noqa: E402
from repro_torch.core.graph import execute  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402

WIDTH = 8
JCFG, TCFG = JQ.QuantConfig.paper_w6a4(), TQ.QuantConfig.paper_w6a4()


def dump(g):
    """Everything a build step can change, framework-neutral."""
    return {
        "name": g.name, "inputs": list(g.inputs), "outputs": list(g.outputs),
        "nodes": [(n.op, list(n.inputs), list(n.outputs),
                   repr(sorted(n.attrs.items()))) for n in g.nodes],
        "inits": {k: (np.asarray(v).dtype.str, np.asarray(v).shape,
                      hashlib.sha256(np.ascontiguousarray(v).tobytes())
                      .hexdigest())
                  for k, v in g.initializers.items()},
    }


@pytest.fixture(scope="module")
def graphs():
    # the reference's init drawn with numpy (He-normal conv weights), with
    # a non-trivial BN so the folded thresholds are off the identity
    rng = np.random.default_rng(1)
    pn = {}
    for blk in JR.plan(WIDTH):
        cin, cout = blk["cin"], blk["cout"]
        pn[blk["name"]] = {
            "w": (rng.standard_normal((3, 3, cin, cout))
                  * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
            "gamma": np.exp(0.2 * rng.standard_normal(cout)).astype(np.float32),
            "beta": (0.1 * rng.standard_normal(cout)).astype(np.float32)}
    pj = jax.tree_util.tree_map(jnp.asarray, pn)
    pt = params_from_numpy(pn, "cpu")
    gj = JR.export_graph(pj, JCFG, width=WIDTH)
    gt = TR.export_graph(pt, TCFG, width=WIDTH)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    xq = np.array(JQ.fake_quant(jnp.asarray(x), JCFG.act))
    return gj, gt, xq


def _raised(build, g, steps):
    with pytest.raises(Exception) as info:
        build(g, steps)
    return info.value


def test_mlp_steps_fail_on_resnet9_as_in_the_reference(graphs):
    gj, gt, _ = graphs
    ej = _raised(JB.build_dataflow, gj, JB.DEFAULT_MLP_STEPS)
    et = _raised(TB.build_dataflow, gt, TB.DEFAULT_MLP_STEPS)
    assert type(et).__name__ == type(ej).__name__ == "PassOrderError"
    assert isinstance(et, GraphBuildError)
    assert "'fuse_matmul_threshold_to_mvau'" in str(et)
    assert str(et) == str(ej)


def test_reduce_mean_graph_fails_as_in_the_reference():
    attrs = {"axes": [1, 2], "spatial_size": 4}
    gj = JGraph([JNode("reduce_mean", ["x"], ["y"], dict(attrs))],
                ["x"], ["y"], {}, name="bad")
    gt = TGraph([TNode("reduce_mean", ["x"], ["y"], dict(attrs))],
                ["x"], ["y"], {}, name="bad")
    ej = _raised(JB.build_dataflow, gj, JB.DEFAULT_MLP_STEPS)
    et = _raised(TB.build_dataflow, gt, TB.DEFAULT_MLP_STEPS)
    assert type(et).__name__ == type(ej).__name__ == "GraphBuildError"
    assert "reduce_mean" in str(et) and str(et) == str(ej)


def test_resnet9_steps_give_the_reference_hw_graph(graphs):
    gj, gt, _ = graphs
    hj = JB.build_dataflow(gj, JB.RESNET9_BUILD_STEPS)
    ht = TB.build_dataflow(gt, TB.RESNET9_BUILD_STEPS)
    assert dump(ht) == dump(hj)
    ops = {n.op for n in ht.nodes}
    assert "mvau" in ops and "global_acc_pool" in ops
    assert "reduce_mean" not in ops and "multithreshold" not in ops
    n_before = sum(n.op == "transpose" for n in gt.nodes)
    n_after = sum(n.op == "transpose" for n in ht.nodes)
    assert n_before >= 16 and n_after < n_before / 2


def test_hw_graph_executes_as_the_recipe_artifact_and_jax(graphs):
    gj, gt, xq = graphs
    ht = TB.build_dataflow(gt, TB.RESNET9_BUILD_STEPS)
    (got,) = execute(ht, {"x": torch.from_numpy(xq)})
    dm = repro_torch.compile(gt, recipe="resnet9", device="cpu")
    want = dm(xq)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    hj = JB.build_dataflow(gj, JB.RESNET9_BUILD_STEPS)
    (ref,) = jexecute(hj, {"x": jnp.asarray(xq)})
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(ref).view(np.int32))
