"""Integer codes wider than int8, and the float MVAU in conv form, on the CPU
against the JAX package.

* ``paper_w16a16()``, ``grid_point(8, 8)`` and ``table2_row(12, 6, 6)``
  (9- to 16-bit weights stored as int16; 8-bit unsigned activations) give
  the JAX artifact's features bit for bit, with equal weight bytes and
  dispatch tables;
* ``mvau_conv_plain`` (what a CPU tensor takes, and the bar the CUDA-core
  conv-form kernel is held to on the card) equals the reference's
  ``_ex_im2col`` followed by ``mvau_pallas`` in interpret mode, bit for bit
  on the fixed-point grid;
* ``conv_pairs`` folds an ``im2col`` into a float ``mvau`` and into an
  ``mvau_int`` of any code width, and into nothing else; the folded f32
  artifact never puts a patch tensor in its environment.

The kernels themselves run only on the card: see ``tests/test_torch_card.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.kernels import mvau as jmvau  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.deploy import lower_graph  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

WIDTH = 8
KSP = [(1, 1, 0), (3, 1, 1), (3, 2, 1), (3, 2, 0)]
CONFIGS = {
    "paper_w16a16": lambda Q: Q.QuantConfig.paper_w16a16(),
    "grid_point_8_8": lambda Q: Q.QuantConfig.grid_point(8, 8),
    "table2_row_12_6_6": lambda Q: Q.QuantConfig.table2_row(12, 6, 6),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def params():
    pj = JR.init_params(jax.random.PRNGKey(7), WIDTH)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_wide_artifact_equals_reference(params, config):
    """Both packages compile the same numpy params at width 8; the port's
    weights keep the reference's storage (int16 for 9- to 16-bit codes)
    and its features equal JAX's bit for bit."""
    pj, pt = params
    dj = repro.compile(pj, CONFIGS[config](JQ), recipe="resnet9",
                       datapath="int")
    dt = repro_torch.compile(pt, CONFIGS[config](TQ), recipe="resnet9",
                             datapath="int", device="cpu")
    x = np.random.default_rng(11).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(dj(x))
    got = dt(x)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert dt.weight_bytes() == dj.weight_bytes()
    assert dt.dispatch_table() == dj.dispatch_table()
    for n in dt.graph.nodes:
        if n.op == "mvau_int":
            w = dt.graph.initializers[n.inputs[1]]
            assert w.dtype == np.asarray(dj.graph.initializers[n.inputs[1]]
                                         ).dtype
            assert not n.attrs["int8_ok"]
            # on the card codes of up to 24 bits run the tensor cores'
            # plane route (paper_w16a16's c2 too, whose input is a
            # residual sum of 17 bits), wider ones the CUDA-core kernel; a
            # node read without the graph's specs keeps the int8_ok rule
            bits = dt.graph.dtypes[n.inputs[0]].total_bits
            assert bits <= 17
            assert tops.kernel_dispatch(n, False, graph=dt.graph) == (
                "fused-cuda-planes" if bits <= 24 else "fused-cuda-core")
            assert tops.kernel_dispatch(n, False) == "fused-cuda-core"


@pytest.mark.parametrize("kernel,stride,pad", KSP)
def test_float_conv_plain_equals_reference(kernel, stride, pad):
    """Float32 grid inputs (every partial sum exact): the port's plain
    conv form against ``_ex_im2col`` + ``mvau_pallas(interpret=True)``,
    C 3 and 16, N 8 and 72, 15 and 255 levels, bit for bit."""
    rng = np.random.default_rng(10 * kernel + stride + pad)
    for c, n, levels in ((3, 8, 15), (16, 72, 255)):
        x = (rng.integers(0, 16, size=(2, 9, 9, c)) * 0.25
             ).astype(np.float32)
        k = kernel * kernel * c
        w = (rng.integers(-32, 32, size=(k, n)) / 32).astype(np.float32)
        t = np.sort(rng.normal(size=(n, levels)) * 4, axis=1).astype(np.float32)
        node = JG.Node("im2col", ["x"], ["x_col"],
                       {"kernel": kernel, "stride": stride, "pad": pad})
        patches = JG._ex_im2col(node, jnp.asarray(x))
        b, oh, ow, kk = patches.shape
        want = jmvau.mvau_pallas(patches.reshape(-1, kk), jnp.asarray(w),
                                 jnp.asarray(t), out_base=-2.0, out_scale=0.5,
                                 out_bias=0.25, interpret=True)
        want = np.asarray(want).reshape(b, oh, ow, n)
        got = KM.mvau_conv_plain(_t(x), _t(w), _t(t), kernel, stride, pad,
                                 -2.0, 0.5, 0.25)
        np.testing.assert_array_equal(got.numpy(), want)
        # a CPU tensor takes the plain version through both wrappers
        assert torch.equal(KM.mvau_conv(_t(x), _t(w), _t(t), kernel, stride,
                                        pad, -2.0, 0.5, 0.25), got)
        assert torch.equal(tops.mvau_conv(_t(x), _t(w), _t(t), kernel, stride,
                                          pad, -2.0, 0.5, 0.25), got)


@pytest.mark.parametrize("wdt", ["int16", "int32"])
def test_wide_weight_codes_through_the_wrappers(wdt):
    """int16 and int32 weight codes with 16-bit unsigned activation codes
    through the GEMM and conv wrappers (their plain versions on the CPU)
    equal the reference's ``ref.mvau_int`` bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 65536, size=(2, 7, 7, 16)).astype(np.int32)
    w = rng.integers(-4000, 4000, size=(144, 24)).astype(wdt)
    t = np.sort(rng.integers(-2**30, 2**30, size=(24, 255)),
                axis=1).astype(np.int32)
    node = JG.Node("im2col", ["x"], ["x_col"],
                   {"kernel": 3, "stride": 1, "pad": 1})
    patches = np.asarray(JG._ex_im2col(node, jnp.asarray(x))).reshape(-1, 144)
    want = np.asarray(jref.mvau_int(jnp.asarray(patches), jnp.asarray(w),
                                    jnp.asarray(t), out_base=-3))
    got = tops.mvau_int_conv(_t(x), _t(w), _t(t), 3, 1, 1, out_base=-3)
    np.testing.assert_array_equal(got.reshape(-1, 24).numpy(), want)
    got2 = tops.mvau_int(_t(patches), _t(w), _t(t), out_base=-3)
    np.testing.assert_array_equal(got2.numpy(), want)


def _pair_graph(reader="mvau", col_is_output=False, extra_reader=False):
    """x -> im2col -> MVAU (-> y): a float mvau, or an mvau_int with int16
    weights (not int8_ok); optionally the patches as a graph output or
    read by a second node."""
    rng = np.random.default_rng(9)
    if reader == "mvau":
        mv = TG.Node("mvau", ["col", "w", "t"], ["y"],
                     {"out_base": -1.0, "out_scale": 0.5, "out_bias": 0.0})
        init = {"w": (rng.integers(-8, 8, size=(36, 5)) / 8
                      ).astype(np.float32),
                "t": np.sort(rng.normal(size=(5, 15)), axis=1
                             ).astype(np.float32)}
    else:
        mv = TG.Node("mvau_int", ["col", "w", "t"], ["y"],
                     {"out_base": 0, "int8_ok": False, "w_packed": False,
                      "acc_f32_exact": False})
        init = {"w": rng.integers(-3000, 3000, size=(36, 5)).astype(np.int16),
                "t": np.sort(rng.integers(-10**6, 10**6, size=(5, 255)),
                             axis=1).astype(np.int32)}
    nodes = [TG.Node("im2col", ["x"], ["col"],
                     {"kernel": 3, "stride": 1, "pad": 1}), mv]
    outputs = ["y"]
    if extra_reader:
        nodes.append(TG.Node("mul", ["col"], ["z"], {"value": 2}))
        outputs.append("z")
    if col_is_output:
        outputs.append("col")
    return TG.Graph(nodes, ["x"], outputs, init, name="pair")


@pytest.mark.parametrize("case,paired", [
    ({"reader": "mvau"}, True), ({"reader": "mvau_int"}, True),
    ({"reader": "mvau", "col_is_output": True}, False),
    ({"reader": "mvau_int", "extra_reader": True}, False)])
def test_conv_pairs_fold_float_and_wide_mvaus(case, paired):
    """A float mvau and an mvau_int with int16 codes fold their im2col; an
    im2col that is a graph output, or has two readers, is left alone.  The
    lowered function equals the interpreter either way, and on the card a
    folded im2col carries its MVAU's label."""
    g = _pair_graph(**case)
    pairs = tops.conv_pairs(g.nodes, g.outputs)
    assert (pairs == {"col": g.nodes[1]}) is paired
    fn = lower_graph(g, "cpu")
    assert fn.folded == (("col",) if paired else ())
    if case["reader"] == "mvau":
        x = torch.from_numpy((np.random.default_rng(2).integers(
            0, 8, size=(2, 6, 6, 4)) * 0.25).astype(np.float32))
    else:
        x = torch.from_numpy(np.random.default_rng(2).integers(
            0, 65536, size=(2, 6, 6, 4)).astype(np.int32))
    for a, b in zip(fn(x), TG.execute(g, {"x": x})):
        assert torch.equal(a, b)
    label = tops.kernel_dispatch(g.nodes[0], False, pairs.get("col"))
    want = {"mvau": "cuda", "mvau_int": "fused-cuda-core"}[case["reader"]]
    assert label == (want if paired else "xla")
    assert tops.kernel_dispatch(g.nodes[0], True, pairs.get("col")) == "xla"


def test_folded_f32_artifact_has_no_patch_tensor(params, monkeypatch):
    """The f32 artifact's 8 im2col nodes are folded, and so is the residual
    add before its GlobalAccPool: the im2col executor never runs, and its
    features equal the interpreter's (which keeps the explicit im2col) and
    the JAX artifact's, bit for bit."""
    pj, pt = params
    qj, qt = JQ.QuantConfig.paper_w6a4(), TQ.QuantConfig.paper_w6a4()
    dt = repro_torch.compile(pt, qt, recipe="resnet9", device="cpu")
    dj = repro.compile(pj, qj, recipe="resnet9")
    x = np.array(JQ.fake_quant(jnp.asarray(np.random.default_rng(5).random(
        (2, 32, 32, 3)).astype(np.float32)), qj.act))
    calls = []
    real = TG._EXECUTORS["im2col"]
    monkeypatch.setitem(TG._EXECUTORS, "im2col",
                        lambda node, xx: calls.append(node) or real(node, xx))
    fn = lower_graph(dt.graph, "cpu")
    cols = [n.outputs[0] for n in dt.graph.nodes if n.op == "im2col"]
    assert len(cols) == 8 and sorted(fn.folded) == sorted(cols + ["r2b_res"])
    (f,) = fn(torch.from_numpy(x))
    assert calls == []
    (interp,) = TG.execute(dt.graph, {"x": torch.from_numpy(x)})
    assert len(calls) == 8 and torch.equal(f, interp)
    np.testing.assert_array_equal(f.numpy(), np.asarray(dj(x)))


@pytest.mark.parametrize("m,n,k,want", [
    (65536, 64, 27, 1), (65536, 128, 576, 1), (16384, 128, 1152, 2),
    (16384, 256, 1152, 1), (4096, 512, 2304, 2), (1024, 512, 4608, 8)])
def test_core_split_plan(m, n, k, want):
    """The float MVAU's 8 layers at batch 64 on 132 SMs: the CUDA-core
    kernel splits K only where its output tiles (128 x 64 for N <= 64,
    else 128 x 128) are fewer than the SMs, each split keeping at least 16
    K-tiles of 16."""
    assert KM.core_splits(m, n, k, 132) == want
