"""The port's compiler front half against the JAX reference: ResNet-9
export, every streamline pass and the datatype/integer-lowering/fusion
passes, compared dump for dump (ops, wiring, attrs, initializer bytes and
datatype annotations) on parameters carried across as numpy arrays."""

import hashlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import passes as JP  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.core.recipes import recipe as jrecipe  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import passes as TP  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.graph import execute  # noqa: E402
from repro_torch.core.recipes import recipe as trecipe  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402

WIDTH = 8
INT_PASSES = ["infer_datatypes", "lower_to_integer_datapath",
              "fuse_integer_datapath"]


def dump(g):
    """Framework-neutral dump of a graph: everything a pass can change."""
    def spec(s):
        return None if s is None else (s.total_bits, s.frac_bits, s.signed)

    return {
        "name": g.name, "inputs": list(g.inputs), "outputs": list(g.outputs),
        "nodes": [(n.op, list(n.inputs), list(n.outputs),
                   repr(sorted((k, v) for k, v in n.attrs.items())))
                  for n in g.nodes],
        "inits": {k: (np.asarray(v).dtype.str, np.asarray(v).shape,
                      hashlib.sha256(np.ascontiguousarray(v).tobytes())
                      .hexdigest())
                  for k, v in g.initializers.items()},
        "dtypes": {k: spec(v) for k, v in g.dtypes.items()},
        "properties": sorted(g.properties),
    }


@pytest.fixture(scope="module")
def params():
    p = JR.init_params(jax.random.PRNGKey(0), WIDTH)
    # non-trivial BN so threshold folding is exercised off the identity
    keys = jax.random.split(jax.random.PRNGKey(1), 16)
    for i, name in enumerate(JR.layer_names(WIDTH)):
        c = p[name]["gamma"].shape[0]
        p[name]["gamma"] = jnp.exp(0.2 * jax.random.normal(keys[2 * i], (c,)))
        p[name]["beta"] = 0.1 * jax.random.normal(keys[2 * i + 1], (c,))
    pn = jax.tree_util.tree_map(np.asarray, p)
    return p, params_from_numpy(pn, "cpu")


@pytest.mark.parametrize("w,a", [(6, 4), (4, 4), (8, 6)])
@pytest.mark.parametrize("insert_transposes", [True, False])
def test_every_pass_matches_reference(params, w, a, insert_transposes):
    pj, pt = params
    gj = JR.export_graph(pj, JQ.QuantConfig.grid_point(w, a), width=WIDTH,
                         img=16, insert_transposes=insert_transposes)
    gt = TR.export_graph(pt, TQ.QuantConfig.grid_point(w, a), width=WIDTH,
                         img=16, insert_transposes=insert_transposes)
    assert dump(gt) == dump(gj)
    names = list(trecipe("resnet9").passes) + INT_PASSES
    assert names == list(jrecipe("resnet9").passes) + INT_PASSES
    for name in names:
        gj = JP.apply_pass(gj, name)
        gt = TP.apply_pass(gt, name)
        assert dump(gt) == dump(gj), f"graphs differ after pass '{name}'"
    ops = {n.op for n in gt.nodes}
    assert "mvau_int" in ops and "mvau" not in ops


def test_qat_forward_matches_reference(params):
    pj, pt = params
    qcfg_j, qcfg_t = JQ.QuantConfig.paper_w6a4(), TQ.QuantConfig.paper_w6a4()
    x = np.random.default_rng(2).random((2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(JR.forward(pj, jnp.asarray(x), qcfg_j, WIDTH))
    got = TR.forward(pt, torch.from_numpy(x), qcfg_t, WIDTH).numpy()
    # BN with gamma != 1 puts the affine off the grid: float32 sums in
    # another order may round differently (same tolerance as the
    # reference's compile-vs-forward test)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_port_golden_io_verification_and_order_checks(params):
    _, pt = params
    qcfg = TQ.QuantConfig.paper_w6a4()
    g = TR.export_graph(pt, qcfg, width=WIDTH, img=16)
    x = TQ.fake_quant(torch.rand((2, 16, 16, 3),
                                 generator=torch.Generator().manual_seed(0)),
                      qcfg.act)
    res = TP.PassManager(device="cpu").run(
        g, list(trecipe("resnet9").passes) + INT_PASSES,
        verify_feeds={"x": x})
    assert all(r.verified for r in res.trace.records)
    before = dump(g)
    assert before == dump(g)                       # value semantics
    with pytest.raises(TP.PassOrderError):
        TP.PassManager(device="cpu").run(
            g, ["fuse_matmul_threshold_to_mvau",
                "absorb_transpose_into_multithreshold"])
    with pytest.raises(TP.PassOrderError):
        TP.apply_pass(g, "lower_to_integer_datapath")
    # interpreter: exported graph == streamlined HW graph on grid input
    (want,) = execute(g, {"x": x})
    (got,) = execute(res.graph, {"x": x})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_infer_shapes(params):
    _, pt = params
    g = TR.export_graph(pt, TQ.QuantConfig.paper_w6a4(), width=WIDTH, img=16)
    g.infer_shapes({"x": np.zeros((1, 16, 16, 3), np.float32)})
    assert g.shapes["features"] == (1, 8 * WIDTH)
    assert g.shapes["c0_col"] == (1, 16, 16, 27)
