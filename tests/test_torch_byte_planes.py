"""The plane route of the integer MVAU (activation codes of up to 24 bits on
the H100's int8 tensor cores) on the CPU.

* the byte planes: :func:`weight_planes` (two planes of 16-bit weights, one
  of int8 weights) and the activation codes' split recombine exactly, and
  the int16 cast of unsigned 16-bit codes is pinned at 32,768..65,535;
* :func:`plane_matmul`, the kernel's decomposition with its uint32
  recombination written as plain tensor code, equals the exact product
  modulo 2^32 at the codes' extremes (two or three activation planes, one
  or two weight planes, K up to the limit), and the plane route's plain
  version equals ``mvau_int_conv_plain`` on the original codes bit for bit
  where the integer lowering admits them, including a product whose ``hh
  << 16`` alone leaves int32;
* the route rule: 8-bit codes one plane, 9- to 24-bit codes byte planes (2,
  3, 4 or 6 products), wider codes or a K past the planes' limit the CUDA
  cores;
* the lowering records each node's route and prepares its weights once,
  and the cost model reads the plane route at the int8 rate over its
  products.

The kernel itself runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_card.py``.
"""

import copy

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402
from repro_torch.obs import costmodel  # noqa: E402

# activation codes [lo, hi) and weight codes [lo, hi)
KINDS = {"u8": (0, 256), "u9": (0, 512), "u16": (0, 65536),
         "u17": (0, 2**17), "s24": (-2**23, 2**23), "u24": (0, 2**24)}
W_KINDS = {"s8": (-128, 128), "s16": (-32768, 32768)}
KSP = [(1, 1, 0), (3, 1, 1), (3, 2, 1)]


def _x_kind(kind, wkind):
    """The plane route's activation kind for codes of ``kind`` against
    weights of ``wkind`` (``u8``, ``s16``, ``u16``, ``s24`` or ``u24``)."""
    (xlo, xhi), (wlo, whi) = KINDS[kind], W_KINDS[wkind]
    return KM.int_route((xlo, xhi - 1), (wlo, whi - 1), 27)[1]


def _extremes(rng, lo, hi, shape):
    """Codes in [lo, hi), half of them at an end of the range."""
    v = rng.integers(lo, hi, size=shape)
    ends = np.where(rng.random(shape) < 0.5, lo, hi - 1)
    return np.where(rng.random(shape) < 0.5, ends, v)


def _wrap32(v):
    """int64 values reduced modulo 2^32 and read as int32."""
    v = np.asarray(v, np.int64) & 0xFFFFFFFF
    return (v - ((v >> 31) << 32)).astype(np.int32)


def _operands(kind, wkind, x, w, xk=None):
    """Codes as the plane route takes them: uint8 codes x int8 weights, or
    int16 codes (the low 16 bits) or int32 codes x the weights' byte planes
    (one plane of int8 weights, two of 16-bit ones); ``xk`` overrides the
    activation kind."""
    xk = xk or _x_kind(kind, wkind)
    xt = torch.from_numpy(x.astype(np.int64)).to(torch.int32)
    wt = torch.from_numpy(w.astype(np.int64)).to(torch.int32)
    if xk == "u8":
        return xt.to(torch.uint8), wt.to(torch.int8)
    return (xt.to(KM.x_dtype(xk)),
            KM.weight_planes(wt, planes=1 if wkind == "s8" else 2))


@pytest.mark.parametrize("w_dtype,lo,hi", [("int8", -128, 128),
                                           ("int16", -32768, 32768),
                                           ("int32", -32768, 32768)])
def test_weight_planes_recombine(w_dtype, lo, hi):
    """``256 * hi + (lo & 255)`` gives each code back, for every code of
    the dtype's range at its extremes; the planes are K-major, K padded to
    a multiple of 16 with zeros."""
    rng = np.random.default_rng(1)
    w = _extremes(rng, lo, hi, (37, 9)).astype(w_dtype)
    w[0, :2] = (lo, hi - 1)
    planes = KM.weight_planes(torch.from_numpy(w))
    assert planes.dtype == torch.int8 and tuple(planes.shape) == (2, 9, 48)
    lo_b = planes[0].to(torch.int32) & 255
    hi_b = planes[1].to(torch.int32)
    back = (256 * hi_b + lo_b).t()
    np.testing.assert_array_equal(back[:37].numpy(), w.astype(np.int32))
    assert not planes[:, :, 37:].any()


@pytest.mark.parametrize("w_dtype,packed", [("int8", False), ("int16", False),
                                            ("int32", False), ("int8", True)])
def test_one_weight_plane_is_the_int8_codes(w_dtype, packed):
    """One byte plane of codes within int8 (int8, int16 or int32 storage,
    or packed int4) is the codes themselves, K-major, zero past K; codes
    past int8 raise."""
    rng = np.random.default_rng(4)
    lo, hi = (-8, 8) if packed else (-128, 128)
    w = _extremes(rng, lo, hi, (37, 10)).astype(np.int32)
    wt = torch.from_numpy(w)
    wt = TQ.pack_int4(wt) if packed else wt.to(getattr(torch, w_dtype))
    planes = KM.weight_planes(wt, w_packed=packed, planes=1)
    assert planes.dtype == torch.int8 and tuple(planes.shape) == (1, 10, 48)
    np.testing.assert_array_equal(planes[0, :, :37].t().numpy(), w)
    assert not planes[:, :, 37:].any()
    with pytest.raises(ValueError, match="int8"):
        KM.weight_planes(torch.tensor([[128]], dtype=torch.int32), planes=1)


def test_weight_planes_of_packed_int4_and_wider_codes():
    """Packed int4 weights are unpacked first; codes past int16 raise."""
    rng = np.random.default_rng(2)
    w = rng.integers(-8, 8, size=(20, 6)).astype(np.int32)
    packed = TQ.pack_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(
        KM.weight_planes(packed, w_packed=True).numpy(),
        KM.weight_planes(torch.from_numpy(w)).numpy())
    with pytest.raises(ValueError, match="int16"):
        KM.weight_planes(torch.tensor([[40000]], dtype=torch.int32))


def test_int16_cast_of_unsigned_codes():
    """Unsigned 16-bit codes 32,768..65,535 narrowed to int16 wrap to
    -32,768..-1 (the low 16 bits); read as the kernel splits them, the low
    byte unsigned and the high byte unsigned, they come back whole."""
    v = torch.arange(32768, 65536, dtype=torch.int32)
    x16 = v.to(torch.int16)
    np.testing.assert_array_equal(x16.numpy(), (v - 65536).numpy())
    xi = x16.to(torch.int32)
    back = 256 * ((xi >> 8) & 255) + (xi & 255)
    assert torch.equal(back, v)
    # plane_matmul reads them the same way: one code against weight 1
    planes = KM.weight_planes(torch.ones((1, 1), dtype=torch.int16))
    got = KM.plane_matmul(x16[:, None], planes, x_unsigned=True)
    assert torch.equal(got[:, 0], v)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("wkind", sorted(W_KINDS))
@pytest.mark.parametrize("k", [27, 576, 4608, KM.PLANE_MAX_K])
def test_plane_matmul_is_exact_modulo_2_32(kind, wkind, k):
    """At the codes' extremes (2^16 - 1, 2^17 - 1, -2^23, 2^24 - 1 against
    -32,768 and 32,767 or -128 and 127), where the sums leave int32, the
    decomposition's uint32 recombination is the exact product modulo 2^32,
    as the kernel's is: two or three activation planes (8-bit codes as
    two) against one or two weight planes, K up to the planes' limit."""
    rng = np.random.default_rng(k)
    xlo, xhi = KINDS[kind]
    x = _extremes(rng, xlo, xhi, (3 if k > 4608 else 6, k))
    w = _extremes(rng, *W_KINDS[wkind], (k, 5))
    xk = _x_kind(kind, "s16")
    xt, planes = _operands(kind, wkind, x, w, xk)
    assert planes.shape[0] == (1 if wkind == "s8" else 2)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    got = KM.plane_matmul(xt, planes, x_unsigned=xk in ("u16", "u24"))
    np.testing.assert_array_equal(got.numpy(), _wrap32(exact))


def _plain_against_int32_codes(kind, wkind, k, c):
    """The plane route's plain version (the operands the kernel takes and
    the decomposition it computes) against ``mvau_int_conv_plain`` on the
    original int32 codes: x at its range's ends, weights at the ends of
    the largest range whose sums stay inside int32 at this K, 15 and 255
    levels, on conv geometries and the GEMM form."""
    rng = np.random.default_rng(k + c)
    xlo, xhi = KINDS[kind]
    whi = W_KINDS[wkind][1]
    xmax = max(abs(xlo), xhi - 1)
    wlim = min(whi, (2**31 - 1) // (k * xmax))
    assert wlim >= 1
    side = 4 if c >= 64 else 6
    x = _extremes(rng, xlo, xhi, (2, side, side, c))
    w = _extremes(rng, -wlim, wlim, (9 * c, 7))
    xu = _x_kind(kind, wkind) in ("u16", "u24")
    for levels in (15, 255):
        tmax = min(2**31 - 1, xmax * wlim * 40)
        t = torch.from_numpy(np.sort(rng.integers(-tmax, tmax,
                                                  size=(7, levels)),
                                     axis=1).astype(np.int32))
        for kernel, stride, pad in KSP:
            kk = kernel * kernel * c
            xt, wt = _operands(kind, wkind, x, w[:kk])
            want = KM.mvau_int_conv_plain(
                torch.from_numpy(x.astype(np.int32)),
                torch.from_numpy(w[:kk].astype(np.int32)), t, kernel, stride,
                pad, -2)
            got = KM.mvau_int_conv_plain(xt, wt, t, kernel, stride, pad, -2,
                                         x_unsigned=xu)
            assert torch.equal(got, want)
            # a CPU tensor takes the plain version through the wrapper too
            assert torch.equal(KM.mvau_int_conv(xt, wt, t, kernel, stride,
                                                pad, -2, x_unsigned=xu), want)
        xg = x.reshape(-1, c)
        xt, wt = _operands(kind, wkind, xg, w[:c])
        want = KM.mvau_int_plain(torch.from_numpy(xg.astype(np.int32)),
                                 torch.from_numpy(w[:c].astype(np.int32)), t,
                                 3)
        assert torch.equal(KM.mvau_int(xt, wt, t, 3, x_unsigned=xu), want)


@pytest.mark.parametrize("kind", ["u16", "u8", "u9"])
@pytest.mark.parametrize("wkind", sorted(W_KINDS))
@pytest.mark.parametrize("k,c", [(27, 3), (576, 64), (4608, 512)])
def test_plane_route_plain_equals_mvau_int_plain(kind, wkind, k, c):
    """Codes of up to 16 bits: the plane route's plain version equals
    ``mvau_int_conv_plain`` on the original int32 codes bit for bit
    (:func:`_plain_against_int32_codes`)."""
    _plain_against_int32_codes(kind, wkind, k, c)


@pytest.mark.parametrize("kind,k,c", [("u17", 27, 3), ("u17", 576, 64),
                                      ("u17", 4608, 512), ("s24", 27, 3),
                                      ("u24", 27, 3)])
@pytest.mark.parametrize("wkind", sorted(W_KINDS))
def test_24_bit_plane_route_plain_equals_mvau_int_plain(kind, k, c, wkind):
    """Codes of 17 to 24 bits (three activation planes; int32 on the card)
    against one or two weight planes: the plane route's plain version
    equals ``mvau_int_conv_plain`` on the original codes bit for bit, at
    each K the integer lowering admits for such codes (K (2^k - 1) within
    int32)."""
    _plain_against_int32_codes(kind, wkind, k, c)


def test_hh_shift_alone_leaves_int32():
    """Three terms whose high bytes give hh = 32,895: ``hh << 16`` alone is
    2,155,806,720, past int32, while the whole product, 2,147,450,880, fits
    it; the uint32 recombination gives it exactly, and so does the route's
    plain version against its thresholds."""
    x = np.array([[65280, 65280, 255]])
    w = np.array([[32512], [512], [-32768]])
    xt = torch.from_numpy(x).to(torch.int32).to(torch.int16)
    planes = KM.weight_planes(torch.from_numpy(w).to(torch.int16))
    xi = xt.to(torch.int32)
    xh, xl = (xi >> 8) & 255, xi & 255
    wh = planes[1, :, :3].to(torch.int32).t()
    wl = (planes[0, :, :3].to(torch.int32) & 255).t()
    hh = int((xh.to(torch.int64) @ wh.to(torch.int64)).item())
    assert hh == 32895 and (hh << 16) > 2**31 - 1
    exact = int((x @ w).item())
    assert exact == 2_147_450_880
    assert int(KM.plane_matmul(xt, planes, x_unsigned=True).item()) == exact
    assert int((xl @ wl).item()) == 0
    t = torch.tensor([[exact - 1, exact, exact + 1]], dtype=torch.int32)
    got = KM.mvau_int_plain(xt, planes, t, 0, x_unsigned=True)
    assert got.tolist() == [[2]]


@pytest.mark.parametrize("x_range,w_range,k,want", [
    ((0, 15), (-32, 31), 576, ("int8", "s8", 1)),
    ((-128, 127), (-128, 127), 4608, ("int8", "s8", 1)),
    ((0, 255), (-128, 127), 4608, ("planes", "u8", 1)),
    ((0, 255), (-128, 127), 10**6, ("planes", "u8", 1)),
    ((0, 511), (-128, 127), 1152, ("planes", "s16", 2)),
    ((0, 65535), (-32768, 32767), 4608, ("planes", "u16", 4)),
    ((-32768, 32767), (-8, 7), 27, ("planes", "s16", 2)),
    ((0, 255), (-32768, 32767), 27, ("planes", "s16", 4)),
    ((0, 255), (0, 255), 27, ("planes", "s16", 4)),
    ((0, 65535), (-32768, 32767), KM.PLANE_MAX_K, ("planes", "u16", 4)),
    ((0, 65535), (-32768, 32767), KM.PLANE_MAX_K + 1, ("core", None, 1)),
    ((0, 131071), (-32768, 32767), 1152, ("planes", "s24", 6)),
    ((0, 255), (-65536, 65535), 27, ("core", None, 1)),
    ((0, 255), (0, 65535), 27, ("core", None, 1)),
    ((0, 65535), (-128, 127), 4608, ("planes", "u16", 2)),
    ((0, 2**24 - 1), (-32768, 32767), 27, ("planes", "u24", 6)),
    ((-2**23, 2**23 - 1), (-32768, 32767), 27, ("planes", "s24", 6)),
    ((0, 2**24 - 1), (-128, 127), 27, ("planes", "u24", 3)),
    ((-2**23, 2**23 - 1), (-8, 7), 27, ("planes", "s24", 3)),
    ((0, 131071), (-32768, 32767), KM.PLANE_MAX_K, ("planes", "s24", 6)),
    ((0, 131071), (-32768, 32767), KM.PLANE_MAX_K + 1, ("core", None, 1)),
    ((0, 2**24), (-128, 127), 27, ("core", None, 1)),
    ((-2**23 - 1, 2**23 - 1), (-128, 127), 27, ("core", None, 1)),
    ((0, 131071), (-65536, 65535), 27, ("core", None, 1))])
def test_route_rule(x_range, w_range, k, want):
    """Codes of up to 8 bits: one product (s8.s8, or u8.s8 for unsigned
    activations); activation codes of 9 to 24 bits, or weights of 9 to 16:
    byte planes, two or three activation planes (16-bit and 24-bit codes,
    their top byte unsigned past 32,767 and 2^23 - 1) times one (int8
    weights) or two (16-bit weights) weight planes, one product each;
    25-bit codes, 17-bit weights, or K past the planes' int32 limit: the
    CUDA cores."""
    assert KM.int_route(x_range, w_range, k) == want
    assert KM.PLANE_MAX_K == 16512
    assert KM.PLANE_MAX_K * 2 * 255 * 255 < 2**31
    assert (KM.PLANE_MAX_K + 1) * 2 * 255 * 255 >= 2**31


@pytest.fixture(scope="module")
def w16a16():
    params = TR.init_params(torch.Generator().manual_seed(0), 8, device="cpu")
    return repro_torch.compile(params, TQ.QuantConfig.paper_w16a16(),
                               recipe="resnet9", datapath="int", device="cpu")


def test_lowering_prepares_routes_and_planes(w16a16):
    """``prepare_tables`` records each ``mvau_int`` node's route from the
    graph's specs on the lowering's copies (the graph's attrs stay the
    reference's) and writes the byte planes once; the executors hand the
    kernel those planes and the codes: int16, unsigned, for the 16-bit
    layers (four products), int32 for c2, whose input is a 17-bit residual
    sum (three activation planes, six products)."""
    g = w16a16.graph
    nodes = [n.copy() for n in g.nodes]
    consts = {k: torch.as_tensor(np.asarray(v)) for k, v in
              g.initializers.items()}
    tops.prepare_tables(nodes, g.initializers, consts, g.dtypes)
    mv = [n for n in nodes if n.op == "mvau_int"]
    routes = [n.attrs["int_route"] for n in mv]
    assert routes == ["planes"] * 8
    for n, orig in zip(mv, (n for n in g.nodes if n.op == "mvau_int")):
        assert "int_route" not in orig.attrs
        assert tops.int_route_of(n) == tops.int_route_of(orig, g)
        c2 = n.outputs[0].startswith("c2_")
        assert (n.attrs["x_kind"], n.attrs["plane_products"]) == (
            ("s24", 6) if c2 else ("u16", 4))
        w = consts[n.inputs[1]]
        assert n.attrs["w_kernel"] == f"{n.inputs[1]}@planes"
        assert torch.equal(consts[n.attrs["w_kernel"]], KM.weight_planes(w))
        x = torch.tensor([[131071 if c2 else 40000, 7]], dtype=torch.int32)
        xk, wk, packed, xu = tops._kernel_codes(n, x, w,
                                                consts[n.attrs["w_kernel"]])
        assert xk.dtype == (torch.int32 if c2 else torch.int16)
        assert xu is not c2 and not packed
        assert wk is consts[n.attrs["w_kernel"]]
        with pytest.raises(ValueError, match="prepare"):
            tops._kernel_codes(n, x, w)


def test_lowering_gives_grid_point_8_8_c2_one_weight_plane():
    """``grid_point(8, 8)``: the 8-bit layers keep one u8.s8 product and
    their int8 weights; c2, a 9-bit residual sum against int8 weights,
    takes two activation planes against one weight plane (the int8 codes,
    ``<w>@planes1``): two products instead of four."""
    params = TR.init_params(torch.Generator().manual_seed(0), 8, device="cpu")
    dm = repro_torch.compile(params, TQ.QuantConfig.grid_point(8, 8),
                             recipe="resnet9", datapath="int", device="cpu")
    g = dm.graph
    nodes = [n.copy() for n in g.nodes]
    consts = {k: torch.as_tensor(np.asarray(v)) for k, v in
              g.initializers.items()}
    tops.prepare_tables(nodes, g.initializers, consts, g.dtypes)
    for n in (n for n in nodes if n.op == "mvau_int"):
        c2 = n.outputs[0].startswith("c2_")
        assert tops.int_route_of(n) == (("planes", "s16", 2) if c2
                                        else ("planes", "u8", 1))
        w = consts[n.inputs[1]]
        if not c2:
            assert "w_kernel" not in n.attrs
            continue
        assert n.attrs["w_kernel"] == f"{n.inputs[1]}@planes1"
        planes = consts[n.attrs["w_kernel"]]
        assert tuple(planes.shape) == (1, w.shape[1],
                                       KM.plane_depth(w.shape[0]))
        assert torch.equal(planes, KM.weight_planes(w, planes=1))
        xk, wk, _, xu = tops._kernel_codes(
            n, torch.tensor([[511, 0]], dtype=torch.int32), w, planes)
        assert xk.dtype == torch.int16 and not xu and wk is planes


def test_cost_model_reads_the_plane_route(w16a16):
    """On the H100 a plane-route node's compute bound is its operations
    over the int8 rate divided by its products (4, and 6 for the 17-bit
    c2); a node whose codes pass 24 bits (c2's input spec widened to 25
    bits on a copy of the graph) takes the CUDA cores' int32 rate."""
    x = np.zeros((2, 32, 32, 3), np.float32)
    wide = copy.copy(w16a16)
    wide.graph = w16a16.graph.copy()
    c2 = next(n for n in wide.graph.nodes
              if n.op == "mvau_int" and n.outputs[0].startswith("c2_"))
    wide.graph.dtypes[c2.inputs[0]] = TQ.FixedPointSpec(25, 0, signed=False)
    peaks = costmodel.KERNEL_PEAK_OPS["h100"]
    _, bw = costmodel.BACKEND_ROOFLINE["h100"]
    seen = set()
    for dm in (w16a16, wide):
        prof = dm.profile(x, xla=False, backend="h100")
        rows = {r["tensor"]: r for r in prof["nodes"]}
        for n in dm.graph.nodes:
            if n.op != "mvau_int":
                continue
            route, _, prods = tops.int_route_of(n, dm.graph)
            label = {"planes": "fused-cuda-planes",
                     "core": "fused-cuda-core"}[route]
            peak = peaks[label] / (prods if route == "planes" else 1)
            r = rows[n.outputs[0]]
            assert r["est_ms"] == pytest.approx(
                max(r["flops"] / peak, r["bytes"] / bw) * 1e3)
            seen.add((route, prods))
    assert seen == {("planes", 4), ("planes", 6), ("core", 1)}


def test_bare_node_keeps_its_label():
    """A node with no specs to read keeps the ``int8_ok`` rule on the card:
    ``fused-cuda`` or ``fused-cuda-core``."""
    for ok, want in ((True, "fused-cuda"), (False, "fused-cuda-core")):
        node = TG.Node("mvau_int", ["x", "w", "t"], ["y"], {"int8_ok": ok})
        assert tops.kernel_dispatch(node, False) == want
        g = TG.Graph([node], ["x"], ["y"], {}, name="bare")
        assert tops.kernel_dispatch(node, False, graph=g) == want
