"""The conv-form integer MVAU and the lowering that folds ``im2col`` into it,
on the CPU against the JAX package.

``mvau_int_conv_plain`` (what a CPU tensor takes, and the bar the CUDA
conv-form kernel is held to on the card) equals the reference's
``_ex_im2col`` followed by ``ref.mvau_int``, bit for bit; the lowered int
artifact, whose ``im2col -> mvau_int`` pairs are folded, still gives the JAX
artifact's features bit for bit, and no patch tensor enters its
environment.  The kernel itself runs only on the card: see
``tests/test_torch_card.py``.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.deploy import lower_graph  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402

WIDTH = 16
KSP = [(1, 1, 0), (3, 1, 1), (3, 2, 1), (3, 2, 0)]
# (activation dtype, packed int4 weights, levels): every combination
COMBOS = [(xd, packed, levels) for xd in (np.int8, np.int32)
          for packed in (False, True) for levels in (15, 255)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_conv_mvau(x, w, t, kernel, stride, pad, out_base):
    node = JG.Node("im2col", ["x"], ["x_col"],
                   {"kernel": kernel, "stride": stride, "pad": pad})
    patches = JG._ex_im2col(node, jnp.asarray(x))
    b, oh, ow, k = patches.shape
    y = jref.mvau_int(patches.reshape(-1, k), jnp.asarray(w), jnp.asarray(t),
                      out_base=out_base)
    return np.asarray(y).reshape(b, oh, ow, -1)


@pytest.mark.parametrize("kernel,stride,pad", KSP)
@pytest.mark.parametrize("c", [3, 16, 24])
def test_conv_plain_equals_reference(kernel, stride, pad, c):
    """Batch 1 and 3, 7x7 and 9x9 frames, N 8 and 72, int8 and int32
    activations, int8 and packed int4 weights, 15 and 255 levels."""
    rng = np.random.default_rng(100 * kernel + 10 * stride + pad + c)
    for n in (8, 72):
        for batch, hw in ((1, 7), (3, 9), (3, 7), (1, 9)):
            for xd, packed, levels in COMBOS:
                x = rng.integers(0, 16, size=(batch, hw, hw, c)).astype(xd)
                k = kernel * kernel * c
                lim = 8 if packed else 32
                w = rng.integers(-lim, lim, size=(k, n)).astype(np.int8)
                t = np.sort(rng.integers(-600, 900, size=(n, levels)),
                            axis=1).astype(np.int32)
                want = _jax_conv_mvau(x, w, t, kernel, stride, pad, -3)
                wt = TQ.pack_int4(_t(w).to(torch.int32)) if packed else _t(w)
                got = KM.mvau_int_conv_plain(_t(x), wt, _t(t), kernel, stride,
                                             pad, -3, w_packed=packed)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want)
                # a CPU tensor takes the plain version through the wrapper
                assert torch.equal(
                    tops.mvau_int_conv(_t(x), wt, _t(t), kernel, stride, pad,
                                       -3, w_packed=packed), got)


@pytest.mark.parametrize("bad", ["x_rank", "x_dtype", "w_rows", "w_dtype",
                                 "t_rows", "t_dtype", "no_fit", "stride",
                                 "packed_dtype"])
def test_conv_wrapper_raises_on_bad_operands(bad):
    x = torch.zeros((2, 5, 5, 4), dtype=torch.int8)
    w = torch.zeros((36, 6), dtype=torch.int8)
    t = torch.zeros((6, 15), dtype=torch.int32)
    args = dict(x=x, w=w, thresholds=t, kernel=3, stride=1, pad=1,
                w_packed=False)
    if bad == "x_rank":
        args["x"] = x.reshape(2, 25, 4)
    elif bad == "x_dtype":
        args["x"] = x.float()
    elif bad == "w_rows":
        args["w"] = w[:-1]
    elif bad == "w_dtype":
        args["w"] = w.float()
    elif bad == "t_rows":
        args["thresholds"] = t[:-1]
    elif bad == "t_dtype":
        args["thresholds"] = t.to(torch.int64)
    elif bad == "no_fit":
        args.update(kernel=9, pad=0)
    elif bad == "stride":
        args["stride"] = 0
    elif bad == "packed_dtype":
        args.update(w=w.to(torch.int32)[:, :3], w_packed=True)
    with pytest.raises(ValueError):
        KM.mvau_int_conv(**args)


@pytest.mark.parametrize("m,n,k,want", [
    (65536, 64, 27, 1), (65536, 128, 576, 1), (16384, 256, 1152, 1),
    (16384, 128, 1152, 1), (4096, 512, 2304, 2), (1024, 512, 4608, 4),
    (100, 8, 64, 1)])
def test_split_plan(m, n, k, want):
    """The w6a4 ResNet-9's 8 layers at batch 64 on 132 SMs: split K only
    where the output tiles are fewer than the SMs, each split keeping at
    least 16 K-tiles."""
    assert KM.tc_splits(m, n, k, 132) == want


# ---------------------------------------------------------------------------
# the paired lowering
# ---------------------------------------------------------------------------
JCFG, TCFG = JQ.QuantConfig.paper_w6a4(), TQ.QuantConfig.paper_w6a4()


@pytest.fixture(scope="module")
def arts():
    pj = JR.init_params(jax.random.PRNGKey(3), WIDTH)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    x = np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)
    dj = repro.compile(pj, JCFG, recipe="resnet9", datapath="int")
    dt = repro_torch.compile(pt, TCFG, recipe="resnet9", datapath="int",
                             device="cpu")
    return dj, dt, x


def test_folded_artifact_equals_reference(arts):
    dj, dt, x = arts
    want = np.asarray(dj(x))
    got = dt(x)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert dt.dispatch_table() == dj.dispatch_table()
    assert dt.op_counts() == dj.op_counts()
    assert dt.weight_bytes() == dj.weight_bytes()


def test_no_patch_tensor_enters_the_environment(arts, monkeypatch):
    """Every im2col of the int artifact is folded: its executor never runs
    and its output is never named in the lowered function's environment;
    the f32 artifact folds its 8 im2col nodes too.  Beside them, the int
    artifact folds its r2b MVAU output and residual sum into the fused GAP
    tail, and the f32 artifact its residual sum into the GAP."""
    _, dt, x = arts
    calls = []
    real = TG._EXECUTORS["im2col"]
    monkeypatch.setitem(TG._EXECUTORS, "im2col",
                        lambda node, xx: calls.append(node) or real(node, xx))
    folded_fn = lower_graph(dt.graph, "cpu")
    cols = [n.outputs[0] for n in dt.graph.nodes if n.op == "im2col"]
    assert len(cols) == 8 and sorted(folded_fn.folded) == sorted(
        cols + ["r2b_mt_nchw_nhwc_0", "r2b_res"])
    (f,) = folded_fn(torch.from_numpy(x))
    assert calls == []
    assert torch.equal(f, dt(x))
    (interp,) = TG.execute(dt.graph, {"x": torch.from_numpy(x)})
    assert torch.equal(f, interp) and len(calls) == 8
    f32 = repro_torch.compile(TR.init_params(torch.Generator().manual_seed(0),
                                             4, device="cpu"),
                              TCFG, recipe="resnet9", device="cpu")
    f32_cols = [n.outputs[0] for n in f32.graph.nodes if n.op == "im2col"]
    assert len(f32_cols) == 8 and sorted(f32.apply.folded) == sorted(
        f32_cols + ["r2b_res"])


def _conv_graph(extra_reader=False, col_is_output=False, int8_ok=True):
    """x -> im2col -> mvau_int (-> y), optionally with a second reader of
    the patches or the patches as a graph output."""
    rng = np.random.default_rng(9)
    nodes = [TG.Node("im2col", ["x"], ["col"],
                     {"kernel": 3, "stride": 1, "pad": 1}),
             TG.Node("mvau_int", ["col", "w", "t"], ["y"],
                     {"out_base": 0, "int8_ok": int8_ok, "w_packed": False,
                      "acc_f32_exact": True})]
    outputs = ["y"]
    if extra_reader:
        nodes.append(TG.Node("mul", ["col"], ["z"], {"value": 2}))
        outputs.append("z")
    if col_is_output:
        outputs.append("col")
    init = {"w": rng.integers(-8, 8, size=(36, 5)).astype(np.int8),
            "t": np.sort(rng.integers(-100, 100, size=(5, 15)),
                         axis=1).astype(np.int32)}
    return TG.Graph(nodes, ["x"], outputs, init, name="conv")


@pytest.mark.parametrize("case,paired", [
    ({}, True), ({"extra_reader": True}, False),
    ({"col_is_output": True}, False), ({"int8_ok": False}, True)])
def test_pairing_rules(case, paired):
    """Only an im2col whose sole reader is an MVAU (an int8_ok mvau_int or
    one with wider codes alike), and whose output is not a graph output, is
    folded; the results equal the interpreter's either way, and on the
    card the folded im2col carries its MVAU's label."""
    g = _conv_graph(**case)
    assert (tops.conv_pairs(g.nodes, g.outputs) == {"col": g.nodes[1]}) \
        is paired
    fn = lower_graph(g, "cpu")
    assert fn.folded == (("col",) if paired else ())
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 16, size=(2, 6, 6, 4)).astype(np.int32))
    got, want = fn(x), TG.execute(g, {"x": x})
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    folded = tops.conv_pairs(g.nodes, g.outputs).get("col")
    assert tops.kernel_dispatch(g.nodes[0], True, folded) == "xla"
    assert tops.kernel_dispatch(g.nodes[0], False, folded) == (
        ("fused-cuda" if case.get("int8_ok", True) else "fused-cuda-core")
        if paired else "xla")
