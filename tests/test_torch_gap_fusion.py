"""The fused GlobalAccPool tail and the residual GAP, on the CPU against the
JAX package.

On the card the int8 route runs ``im2col -> mvau_int -> add ->
global_acc_pool`` as one launch of the conv MVAU with a GAP epilogue
(``kernels.mvau.mvau_int_conv_gap``), and every other ``add ->
global_acc_pool`` pair as one launch of the GAP kernel with the add folded
in (``kernels.gap.gap(x, skip)``).  Here their plain versions (what a CPU
tensor takes, and the bar the kernels are held to on the card) equal the
reference's ``mvau_int_pallas`` -> ``+ skip`` -> ``gap_pallas`` in interpret
mode, bit for bit on integers; the lowering folds the tail of the w6a4 int
artifact and refuses every other shape, and all of them still give the JAX
artifact's features bit for bit.  The kernels themselves run only on the
card: see ``tests/test_torch_card.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import deploy as JD  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.kernels import gap as jgap  # noqa: E402
from repro.kernels import mvau as jmvau  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.deploy import lower_graph  # noqa: E402
from repro_torch.kernels import gap as KG  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402

WIDTH = 8
TAIL = ("r2b_mt_nchw_nhwc_0", "r2b_res")


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_tail(x, w, t, skip, out_base):
    """The reference chain: im2col, ``mvau_int_pallas`` (interpret mode),
    ``+ skip`` in int32, ``gap_pallas`` (interpret mode)."""
    node = JG.Node("im2col", ["x"], ["x_col"],
                   {"kernel": 3, "stride": 1, "pad": 1})
    patches = JG._ex_im2col(node, jnp.asarray(x))
    b, oh, ow, k = patches.shape
    y = jmvau.mvau_int_pallas(patches.reshape(-1, k), jnp.asarray(w),
                              jnp.asarray(t), out_base=out_base,
                              interpret=True)
    y = y.reshape(b, oh, ow, -1) + jnp.asarray(skip)
    return np.asarray(jgap.gap_pallas(y, interpret=True))


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("side", [1, 2, 4])        # OH·OW 1, 4, 16
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("wrap", [False, True])
def test_fused_tail_plain_equals_reference(side, c, wrap):
    """3x3 / stride 1 / pad 1 conv MVAU over side x side frames (OH·OW =
    side²), N 24, batch 1 to 3, 15 levels, then a skip and the spatial sum.
    With ``wrap`` the skip lies near 2³¹, so the int32 add and sum wrap."""
    rng = np.random.default_rng(10 * side + c + wrap)
    n = 24
    for batch in (1, 3):
        x = rng.integers(0, 16, size=(batch, side, side, c)).astype(np.int8)
        w = rng.integers(-32, 32, size=(9 * c, n)).astype(np.int8)
        t = np.sort(rng.integers(-600, 900, size=(n, 15)),
                    axis=1).astype(np.int32)
        lo, hi = ((2**31 - 40, 2**31) if wrap else (-50, 50))
        skip = rng.integers(lo, hi, size=(batch, side, side, n)
                            ).astype(np.int32)
        want = _jax_tail(x, w, t, skip, -3)
        got = KM.mvau_int_conv_gap_plain(_t(x), _t(w), _t(t), _t(skip), 3, 1,
                                         1, -3)
        assert got.dtype == torch.int32 and got.shape == (batch, n)
        np.testing.assert_array_equal(got.numpy(), want)
        # a CPU tensor takes the plain version through both wrappers
        assert torch.equal(KM.mvau_int_conv_gap(_t(x), _t(w), _t(t), _t(skip),
                                                3, 1, 1, -3), got)
        assert torch.equal(tops.mvau_int_conv_gap(_t(x), _t(w), _t(t),
                                                  _t(skip), 3, 1, 1, -3), got)
        if wrap:                                   # the int32 sums did wrap
            codes = KM.mvau_int_conv_plain(_t(x), _t(w), _t(t), 3, 1, 1, -3)
            wide = (codes.to(torch.int64) + _t(skip)).sum(dim=(1, 2))
            assert bool(((wide < -2**31) | (wide >= 2**31)).any())


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 5, 7, 24)])
def test_residual_gap_int_equals_reference(dtype, shape):
    """Integers, bit for bit, the add wrapping in the operands' dtype (int8
    codes near its edge) as the reference's does."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(len(shape) + shape[0])
    a = rng.integers(info.max - 60, info.max, size=shape).astype(dtype)
    b = rng.integers(0, 60, size=shape).astype(dtype)
    want = np.asarray(jgap.gap_pallas(jnp.asarray(a) + jnp.asarray(b),
                                      interpret=True))
    got = KG.gap(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(KG.gap_plain(_t(a), _t(b)), got)


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (1, 8, 8, 64)])
def test_residual_gap_float_equals_reference(shape):
    """float32 on the fixed-point grid: bit for bit.  Off the grid the sums
    run in another order: rtol/atol 1e-5 (the reference test's
    tolerance)."""
    rng = np.random.default_rng(shape[-1])
    spec = JQ.FixedPointSpec(6, 2, signed=False)
    a, b = (np.asarray(JQ.fake_quant(jnp.asarray(
        rng.uniform(0, 16, size=shape).astype(np.float32)), spec))
        for _ in range(2))
    want = np.asarray(jgap.gap_pallas(jnp.asarray(a) + jnp.asarray(b),
                                      interpret=True))
    np.testing.assert_array_equal(KG.gap(_t(a), _t(b)).numpy(), want)
    a, b = (rng.uniform(-2, 2, size=shape).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jgap.gap_pallas(jnp.asarray(a) + jnp.asarray(b),
                                      interpret=True))
    got = KG.gap(_t(a), _t(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def params():
    pj = JR.init_params(jax.random.PRNGKey(11), WIDTH)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt


@pytest.fixture(scope="module")
def w6a4(params):
    pj, pt = params
    dj = repro.compile(pj, JQ.QuantConfig.paper_w6a4(), recipe="resnet9",
                       datapath="int")
    dt = repro_torch.compile(pt, TQ.QuantConfig.paper_w6a4(),
                             recipe="resnet9", datapath="int", device="cpu")
    return dj, dt


def _frames(img=32, batch=2):
    return np.random.default_rng(5).random((batch, img, img, 3)
                                           ).astype(np.float32)


def test_w6a4_tail_is_folded(w6a4, monkeypatch):
    """The w6a4 int artifact's tail is one step: the ``add`` executor runs
    for r1b's residual only, the lowered function names the r2b MVAU output
    and the residual sum as folded, and its features equal JAX's bit for
    bit; the dispatch table off the card is the reference's, and on the
    card the folded add and GAP carry their MVAU's label."""
    dj, dt = w6a4
    g = dt.graph
    tails = tops.gap_tails(g.nodes, g.outputs)
    assert list(tails) == ["features_accsum_0"]
    mv, add = tails["features_accsum_0"]
    assert (mv.outputs[0], add.outputs[0]) == TAIL
    assert tops.residual_gaps(g.nodes, g.outputs) == {}
    ran = []
    real = TG._EXECUTORS["add"]
    monkeypatch.setitem(TG._EXECUTORS, "add",
                        lambda node, *a: ran.append(node.outputs[0])
                        or real(node, *a))
    fn = lower_graph(g, "cpu")
    assert set(TAIL) <= set(fn.folded) and len(fn.folded) == 10
    x = _frames()
    (f,) = fn(torch.from_numpy(x))
    assert ran == ["r1b_res"]
    np.testing.assert_array_equal(f.numpy(), np.asarray(dj(x)))
    assert torch.equal(dt(x), f)
    assert dt.dispatch_table() == dj.dispatch_table()
    into = tops.folded_into(g.nodes, g.outputs)
    card = {r: tops.kernel_dispatch(n, False, into.get(r))
            for n in g.nodes for r in n.outputs}
    assert card["r2b_res"] == card["features_accsum_0"] == "fused-cuda"
    assert card["r1b_res"] == "xla"


def _edited(graph, extra_reader=False, res_is_output=False):
    """A copy of an artifact's graph with a second reader of the r2b MVAU
    output, or with the residual sum as a graph output."""
    g = graph.copy()
    if extra_reader:
        g.nodes.append(type(g.nodes[0])("mul", [TAIL[0]], ["extra"],
                                        {"value": 2}))
        g.outputs.append("extra")
    if res_is_output:
        g.outputs.append(TAIL[1])
    return g


@pytest.mark.parametrize("case", ["extra_reader", "res_is_output"])
def test_tail_refused_when_an_intermediate_escapes(w6a4, case):
    """A second reader of the MVAU output, or the residual sum as a graph
    output: no fused tail; the first still folds its add into the GAP
    kernel.  Every output equals the reference's lowering bit for bit."""
    dj, dt = w6a4
    gt, gj = (_edited(d.graph, **{case: True}) for d in (dt, dj))
    assert tops.gap_tails(gt.nodes, gt.outputs) == {}
    residual = tops.residual_gaps(gt.nodes, gt.outputs)
    assert (list(residual) == ["features_accsum_0"]) == (case == "extra_reader")
    fn = lower_graph(gt, "cpu")
    assert not set(TAIL[:1]) & set(fn.folded)
    x = _frames()
    got = fn(torch.from_numpy(x))
    want = JD.lower_graph(gj)(jnp.asarray(x))
    assert len(got) == len(want) == len(gt.outputs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tail_refused_for_wide_codes(params):
    """``grid_point(8, 8)``: 8-bit unsigned activations are not ``int8_ok``,
    so a bare node's rule (no specs to read) refuses the tail and folds the
    residual add into the GAP kernel; read with the graph's specs, r2b's
    codes take the plane route of the tensor cores, so the lowering fuses
    the tail there as for int8 codes (one launch with the GAP epilogue on
    the card; on the CPU the MVAU, the add and the GAP in turn).  Features
    and dispatch equal JAX's."""
    pj, pt = params
    dj = repro.compile(pj, JQ.QuantConfig.grid_point(8, 8), recipe="resnet9",
                       datapath="int")
    dt = repro_torch.compile(pt, TQ.QuantConfig.grid_point(8, 8),
                             recipe="resnet9", datapath="int", device="cpu")
    g = dt.graph
    assert tops.gap_tails(g.nodes, g.outputs) == {}
    assert [a.outputs[0] for a in tops.residual_gaps(g.nodes, g.outputs)
            .values()] == ["r2b_res"]
    pool = next(n for n in g.nodes if n.op == "global_acc_pool")
    assert [(mv.outputs[0], add.outputs[0]) for mv, add in tops.gap_tails(
        g.nodes, g.outputs, g).values()] == [TAIL]
    assert list(tops.gap_tails(g.nodes, g.outputs, g)) == [pool.outputs[0]]
    assert tops.residual_gaps(g.nodes, g.outputs, graph=g) == {}
    assert "r2b_res" in dt.apply.folded and TAIL[0] in dt.apply.folded
    x = _frames()
    np.testing.assert_array_equal(dt(x).numpy(), np.asarray(dj(x)))
    assert dt.dispatch_table() == dj.dispatch_table()
    into = tops.folded_into(g.nodes, g.outputs, g)
    r2b_add = next(n for n in g.nodes if n.outputs[0] == "r2b_res")
    assert tops.kernel_dispatch(r2b_add, False, into["r2b_res"], g) \
        == "fused-cuda-planes"
    into = tops.folded_into(g.nodes, g.outputs)
    assert tops.kernel_dispatch(r2b_add, False, into["r2b_res"]) == "cuda"


def test_tail_refused_for_64_positions(params):
    """64 x 64 frames leave an 8 x 8 feature map: OH·OW = 64 does not divide
    16, so the tail is not fused and the residual add folds into the GAP
    kernel.  Features and dispatch equal JAX's bit for bit."""
    pj, pt = params
    qj, qt = JQ.QuantConfig.paper_w6a4(), TQ.QuantConfig.paper_w6a4()
    dj = repro.compile(JR.export_graph(pj, qj, width=WIDTH, img=64), qj,
                       recipe="resnet9", datapath="int")
    dt = repro_torch.compile(TR.export_graph(pt, qt, width=WIDTH, img=64), qt,
                             recipe="resnet9", datapath="int", device="cpu")
    g = dt.graph
    pool = next(n for n in g.nodes if n.op == "global_acc_pool")
    assert pool.attrs["spatial_size"] == 64
    assert tops.gap_tails(g.nodes, g.outputs) == {}
    assert list(tops.residual_gaps(g.nodes, g.outputs)) == [pool.outputs[0]]
    x = _frames(img=64)
    np.testing.assert_array_equal(dt(x).numpy(), np.asarray(dj(x)))
    assert dt.dispatch_table() == dj.dispatch_table()


@pytest.mark.parametrize("case", [{}, {"int8_ok": False}, {"size": 64},
                                  {"axes": [2, 3]}, {"scalar_add": True}])
def test_matcher_rules(case):
    """A hand-built tail: fused only for an ``int8_ok`` MVAU, pool axes (1,
    2), OH·OW dividing 16 and an add of two tensors; the residual fold takes
    any other pool over axes (1, 2) of an add of two tensors.  The lowered
    function equals the interpreter either way."""
    rng = np.random.default_rng(4)
    side = 8 if case.get("size") == 64 else 4
    add_in = ["y"] if case.get("scalar_add") else ["y", "s"]
    nodes = [TG.Node("im2col", ["x"], ["col"],
                     {"kernel": 3, "stride": 1, "pad": 1}),
             TG.Node("mvau_int", ["col", "w", "t"], ["y"],
                     {"out_base": 0, "int8_ok": case.get("int8_ok", True),
                      "w_packed": False, "acc_f32_exact": True}),
             TG.Node("add", add_in, ["r"],
                     {"value": 5} if case.get("scalar_add") else {}),
             TG.Node("global_acc_pool", ["r"], ["f"],
                     {"axes": case.get("axes", [1, 2]),
                      "spatial_size": side * side})]
    init = {"w": rng.integers(-8, 8, size=(36, 5)).astype(np.int8),
            "t": np.sort(rng.integers(-100, 100, size=(5, 15)),
                         axis=1).astype(np.int32)}
    g = TG.Graph(nodes, ["x", "s"], ["f"], init, name="tail")
    fused = not set(case) - {"int8_ok"} and case.get("int8_ok", True)
    residual = not fused and not set(case) & {"axes", "scalar_add"}
    assert bool(tops.gap_tails(g.nodes, g.outputs)) is fused
    assert bool(tops.residual_gaps(g.nodes, g.outputs)) is residual
    fn = lower_graph(g, "cpu")
    assert fn.folded == ("col",) + (("y", "r") if fused else
                                    ("r",) if residual else ())
    x = _t(rng.integers(0, 16, size=(2, side, side, 4)).astype(np.int32))
    s = _t(rng.integers(-9, 9, size=(2, side, side, 5)).astype(np.int32))
    (got,), (want,) = fn(x, s), TG.execute(g, {"x": x, "s": s})
    assert torch.equal(got, want)


def _tail_graph(mod, int8_ok):
    """``im2col -> mvau_int -> add(y, s) -> global_acc_pool`` over a 4 x 4
    map, N 5, in the graph module ``mod`` of either package."""
    rng = np.random.default_rng(6)
    nodes = [mod.Node("im2col", ["x"], ["col"],
                      {"kernel": 3, "stride": 1, "pad": 1}),
             mod.Node("mvau_int", ["col", "w", "t"], ["y"],
                      {"out_base": 0, "int8_ok": int8_ok, "w_packed": False,
                       "acc_f32_exact": True}),
             mod.Node("add", ["y", "s"], ["r"]),
             mod.Node("global_acc_pool", ["r"], ["f"],
                      {"axes": [1, 2], "spatial_size": 16})]
    init = {"w": rng.integers(-8, 8, size=(36, 5)).astype(np.int8),
            "t": np.sort(rng.integers(-100, 100, size=(5, 15)),
                         axis=1).astype(np.int32)}
    return mod.Graph(nodes, ["x", "s"], ["f"], init, name="tail")


@pytest.mark.parametrize("int8_ok", [True, False])
@pytest.mark.parametrize("skip", [((2, 4, 4, 5), np.int32),
                                  ((2, 1, 1, 5), np.int32),
                                  ((1, 4, 4, 5), np.int8), ((5,), np.int32),
                                  ((2, 4, 4, 5), np.float32)])
def test_skip_that_broadcasts_or_is_float(monkeypatch, int8_ok, skip):
    """The add's other operand decides at run time: only an integer skip of
    the MVAU output's own shape takes the GAP epilogue (the fused tail) or
    the GAP kernel's residual operand (the residual fold).  A skip that
    broadcasts is added first and the GAP kernel pools the sum; a float
    skip does not fit the epilogue.  Either way the GAP kernel's wrapper
    pools, never a plain ``torch.sum``, and the features equal the JAX
    package's lowering of the same graph."""
    shape, dtype = skip
    same = shape == (2, 4, 4, 5)
    rng = np.random.default_rng(len(shape))
    x = rng.integers(0, 16, size=(2, 4, 4, 4)).astype(np.int32)
    s = rng.integers(-9, 9, size=shape).astype(dtype)
    g = _tail_graph(TG, int8_ok)
    assert bool(tops.gap_tails(g.nodes, g.outputs)) is int8_ok
    assert bool(tops.residual_gaps(g.nodes, g.outputs)) is not int8_ok
    mv = g.nodes[1]
    assert tops.tail_fits(g.nodes[0], mv, _t(x), _t(g.initializers["w"]),
                          _t(s)) is (same and dtype != np.float32)
    pooled = []
    real = tops.gap
    monkeypatch.setattr(tops, "gap", lambda a, b=None: pooled.append(
        None if b is None else tuple(b.shape)) or real(a, b))
    fn = lower_graph(g, "cpu")
    (got,) = fn(_t(x), _t(s))
    assert pooled == [shape if same else None]
    want = JD.lower_graph(_tail_graph(JG, int8_ok))(jnp.asarray(x),
                                                     jnp.asarray(s))[0]
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (interp,) = TG.execute(g, {"x": _t(x), "s": _t(s)})
    assert torch.equal(got, interp)
