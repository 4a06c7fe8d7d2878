"""The port's CUDA kernels and main path on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode; on the CPU each wrapper takes its plain version,
which the other ``test_torch_*`` files hold against the JAX reference).
This file imports no JAX, so it also runs on the machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import gap as KG  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.models import resnet9  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,levels", [(7, 36, 8, 15), (130, 200, 96, 512),
                                          (1, 27, 64, 255), (70, 40, 24, 4095),
                                          (9, 64, 136, 65535)])
def test_mvau_kernels_equal_plain(card, m, k, n, levels):
    rng = np.random.default_rng(m * n)
    x = _t(rng.integers(0, 16, size=(m, k)).astype(np.int8), card)
    w = _t(rng.integers(-8, 8, size=(k, n)).astype(np.int8), card)
    t = _t(np.sort(rng.integers(-500, 800, size=(n, levels)), axis=1
                   ).astype(np.int32), card)
    assert torch.equal(KM.mvau_int(x, w, t, 1), KM.mvau_int_plain(x, w, t, 1))
    xi = x.to(torch.int32)
    assert torch.equal(KM.mvau_int(xi, w, t, 1), KM.mvau_int_plain(xi, w, t, 1))
    wp = Q.pack_int4(w.to(torch.int32))
    assert torch.equal(KM.mvau_int(x, wp, t, 1, w_packed=True),
                       KM.mvau_int_plain(x, wp, t, 1, w_packed=True))
    xf, wf, tf = x.float() * 0.25, w.float() / 32, t.float() / 128
    assert torch.equal(KM.mvau(xf, wf, tf, 0.0, 0.25, 0.0),
                       KM.mvau_plain(xf, wf, tf, 0.0, 0.25, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,pad", [(1, 1, 0), (3, 1, 1), (3, 2, 1),
                                               (3, 2, 0)])
@pytest.mark.parametrize("c", [3, 16, 24])
def test_conv_mvau_kernel_equals_plain(card, kernel, stride, pad, c):
    """The conv-form kernel against its plain version (im2col + mvau_int)
    on the CPU tests' cases, int8 activations (the kernel's input): batch
    1 and 3, 7x7 and 9x9, N 8 and 72, int8 and packed int4 weights, 15 and
    255 levels, and forced K-splits; bit for bit."""
    rng = np.random.default_rng(10 * kernel + c)
    for n in (8, 72):
        for batch, hw in ((1, 7), (3, 9)):
            for packed in (False, True):
                for levels in (15, 255):
                    x = _t(rng.integers(0, 16, size=(batch, hw, hw, c)
                                        ).astype(np.int8), card)
                    k = kernel * kernel * c
                    lim = 8 if packed else 32
                    w = rng.integers(-lim, lim, size=(k, n)).astype(np.int32)
                    wt = (Q.pack_int4(torch.from_numpy(w)) if packed
                          else torch.from_numpy(w.astype(np.int8))).to(card)
                    t = _t(np.sort(rng.integers(-600, 900, size=(n, levels)),
                                   axis=1).astype(np.int32), card)
                    want = KM.mvau_int_conv_plain(x, wt, t, kernel, stride,
                                                  pad, -3, packed)
                    before = B.launch_counts["mvau_int"]
                    got = KM.mvau_int_conv(x, wt, t, kernel, stride, pad, -3,
                                           packed)
                    assert B.launch_counts["mvau_int"] == before + 1
                    assert torch.equal(got, want)
                    for splits in (2, 3):
                        assert torch.equal(KM.mvau_int_conv(
                            x, wt, t, kernel, stride, pad, -3, packed,
                            splits=splits), want)


@pytest.mark.cuda
def test_conv_mvau_wrapper_raises_on_the_card(card):
    """A CUDA tensor reaching the conv form launches a kernel or raises:
    float or int64 codes, a weight kind the kernels do not take, tensors on
    two devices, a non-contiguous activation.  int32 codes and int16/int32
    weights launch the CUDA-core kernel."""
    x = torch.zeros((2, 5, 5, 4), dtype=torch.int8, device=card)
    w = torch.zeros((36, 6), dtype=torch.int8, device=card)
    t = torch.zeros((6, 15), dtype=torch.int32, device=card)
    before = B.launch_counts["mvau_int"]
    for bad in ((x.float(), w, t), (x, w.to(torch.int64), t),
                (x, w.cpu(), t), (x, w, t.cpu()),
                (x.to(torch.int32).transpose(1, 2), w, t)):
        with pytest.raises(ValueError):
            KM.mvau_int_conv(*bad, 3, 1, 1)
    assert B.launch_counts["mvau_int"] == before
    for xx, ww in ((x.to(torch.int32), w), (x, w.to(torch.int16)),
                   (x, w.to(torch.int32))):
        assert torch.equal(KM.mvau_int_conv(xx, ww, t, 3, 1, 1),
                           KM.mvau_int_conv_plain(xx, ww, t, 3, 1, 1))
    assert B.launch_counts["mvau_int"] == before + 3


# ---------------------------------------------------------------------------
# The plane route of the tensor-core kernel: codes of up to 24 bits
# ---------------------------------------------------------------------------
def _plane_operands(kind, x, w, dev):
    """uint8 codes x int8 weights, or int16 codes (their low 16 bits) or
    int32 codes x the weights' byte planes (two, or one for the ``w8``
    forms' int8 weights)."""
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if kind == "u8":
        return xt.to(torch.uint8).to(dev), wt.to(torch.int8).to(dev)
    xk = "u" + kind[1:3] if kind[0] == "u" else "s" + kind[1:3]
    return (xt.to(torch.int32).to(KM.x_dtype(xk)).to(dev),
            KM.weight_planes(wt.to(torch.int32),
                             planes=1 if kind.endswith("w8") else 2).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,xr,wr", [("u8", (0, 256), (-128, 128)),
                                        ("s16", (-32768, 32768),
                                         (-32768, 32768)),
                                        ("u16", (0, 65536), (-32768, 32768)),
                                        ("s16w8", (-32768, 32768),
                                         (-128, 128)),
                                        ("u16w8", (0, 65536), (-128, 128)),
                                        ("s24", (-2**23, 2**23),
                                         (-32768, 32768)),
                                        ("u24", (0, 2**24), (-32768, 32768)),
                                        ("u24w8", (0, 2**24), (-128, 128))])
@pytest.mark.parametrize("kernel,stride,pad", [(1, 1, 0), (3, 1, 1), (3, 2, 1),
                                               (3, 2, 0)])
@pytest.mark.parametrize("c", [3, 16, 24])
def test_plane_route_equals_plain(card, kind, xr, wr, kernel, stride, pad, c):
    """The plane route (uint8 codes as one u8.s8 product; int16 codes as
    byte planes against two weight planes, four products, or one, two;
    int32 codes of up to 24 bits against two, six, or one, three) against
    its plain version, codes at their extremes half the time (sums that
    leave int32 wrap alike in both): batch 1 and 3, 7x7 and 9x9, N 8, 72
    and 136, 15 and 255 levels, K split planned, 2 and 3, and the GEMM
    form; each launch counted as ``mvau_int`` and ``mvau_int_planes`` (and
    ``mvau_int_planes2`` / ``mvau_int_planes6`` for two and six products).
    Bit for bit."""
    rng = np.random.default_rng(30 * kernel + c)

    def codes(lo, hi, shape):
        ends = np.where(rng.random(shape) < 0.5, lo, hi - 1)
        return np.where(rng.random(shape) < 0.5, ends,
                        rng.integers(lo, hi, size=shape))

    xu = kind[0] == "u" and kind != "u8"
    k = kernel * kernel * c
    prods = {"u8": 1, "s16": 4, "u16": 4, "s16w8": 2, "u16w8": 2, "s24": 6,
             "u24": 6, "u24w8": 3}[kind]
    for n in (8, 72, 136):
        for batch, hw, levels in ((1, 7, 15), (3, 9, 255)):
            x, w = _plane_operands(kind, codes(*xr, (batch, hw, hw, c)),
                                   codes(*wr, (k, n)), card)
            t = _t(np.sort(rng.integers(-2**31, 2**31 - 1, size=(n, levels)),
                           axis=1).astype(np.int32), card)
            want = KM.mvau_int_conv_plain(x, w, t, kernel, stride, pad, -1,
                                          x_unsigned=xu)
            for splits in (None, 2, 3):
                before = dict(B.launch_counts)
                got = KM.mvau_int_conv(x, w, t, kernel, stride, pad, -1,
                                       x_unsigned=xu, splits=splits)
                assert torch.equal(got, want)
                assert B.launch_counts["mvau_int"] == before["mvau_int"] + 1
                assert B.launch_counts["mvau_int_planes"] == \
                    before["mvau_int_planes"] + 1
                for p in (2, 6):
                    name = f"mvau_int_planes{p}"
                    assert B.launch_counts[name] == \
                        before[name] + int(prods == p)
    x2, w2 = _plane_operands(kind, codes(*xr, (37, c)), codes(*wr, (c, 24)),
                             card)
    t = _t(np.sort(rng.integers(-2**31, 2**31 - 1, size=(24, 15)), axis=1
                   ).astype(np.int32), card)
    assert torch.equal(KM.mvau_int(x2, w2, t, 4, x_unsigned=xu),
                       KM.mvau_int_plain(x2, w2, t, 4, x_unsigned=xu))


@pytest.mark.cuda
def test_plane_route_refuses_what_it_cannot_run(card):
    """A K past the byte planes' int32 limit, planes of the wrong depth and
    packed weights raise; nothing runs another route in their place."""
    x = torch.zeros((1, 1, 1, KM.PLANE_MAX_K + 16), dtype=torch.int16,
                    device=card)
    w = torch.zeros((2, 8, KM.plane_depth(KM.PLANE_MAX_K + 16)),
                    dtype=torch.int8, device=card)
    t = torch.zeros((8, 15), dtype=torch.int32, device=card)
    before = dict(B.launch_counts)
    with pytest.raises(ValueError, match="limit"):
        KM.mvau_int_conv(x, w, t, 1, 1, 0)
    with pytest.raises(ValueError, match="planes"):
        KM.mvau_int_conv(x[..., :32], w[:, :, :16], t, 1, 1, 0)
    with pytest.raises(ValueError, match="int8 weights"):
        KM.mvau_int_conv(x[..., :32].to(torch.uint8),
                         torch.zeros((32, 4), dtype=torch.int8, device=card),
                         t, 1, 1, 0, w_packed=True)
    # int32 codes: K past the limit, and a third weight plane
    with pytest.raises(ValueError, match="limit"):
        KM.mvau_int_conv(x.to(torch.int32), w, t, 1, 1, 0)
    with pytest.raises(ValueError, match="planes"):
        KM.mvau_int_conv(x[..., :32].to(torch.int32),
                         torch.zeros((3, 8, 32), dtype=torch.int8,
                                     device=card), t, 1, 1, 0)
    assert B.launch_counts == before


# ---------------------------------------------------------------------------
# The CUDA-core conv-form kernel: float MVAU and wide integer codes
# ---------------------------------------------------------------------------
def _float_conv_inputs(rng, batch, hw, c, kernel, n, levels, grid, dev):
    k = kernel * kernel * c
    if grid:      # every partial sum exact in float32
        x = rng.integers(0, 16, size=(batch, hw, hw, c)) * 0.25
        w = rng.integers(-32, 32, size=(k, n)) / 32
        t = np.sort(rng.normal(size=(n, levels)) * 4, axis=1)
    else:
        x = rng.uniform(-2, 2, size=(batch, hw, hw, c))
        w = rng.uniform(-2, 2, size=(k, n))
        t = np.sort(rng.normal(size=(n, levels)) * 2, axis=1)
    return tuple(_t(a.astype(np.float32), dev) for a in (x, w, t))


def _off_grid_ok(got, want, x, w, t, kernel, stride, pad):
    """At most one level apart, and only where the exact (float64)
    accumulator lies within 1e-5 of the row's |x|·|w| of a threshold."""
    from repro_torch.kernels import ref

    p = ref.im2col(x, kernel, stride, pad).double()
    p = p.reshape(-1, p.shape[-1])
    acc = p @ w.double()
    scale = p.abs() @ w.double().abs()
    near = ((acc[..., None] - t.double()[None]).abs()
            <= 1e-5 * scale[..., None]).any(-1)
    diff = (got - want).reshape(near.shape).abs()
    return bool((diff[~near] == 0).all()) and bool((diff <= 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,pad", [(1, 1, 0), (3, 1, 1), (3, 2, 1),
                                               (3, 2, 0)])
@pytest.mark.parametrize("c", [3, 16, 24])
def test_float_conv_kernel_equals_plain(card, kernel, stride, pad, c):
    """The float conv form against its plain version (im2col + mvau_plain):
    batch 1 and 3, 7x7 and 9x9, N 8 and 72, 15 and 255 levels, forced
    K-splits 1, 2, 3.  On the grid bit for bit; off it at most one level,
    within 1e-5 of a threshold."""
    rng = np.random.default_rng(20 * kernel + c)
    for n in (8, 72):
        for batch, hw, levels in ((1, 7, 15), (3, 9, 255)):
            for grid in (True, False):
                x, w, t = _float_conv_inputs(rng, batch, hw, c, kernel, n,
                                             levels, grid, card)
                want = KM.mvau_conv_plain(x, w, t, kernel, stride, pad, -2.0,
                                          0.5, 0.25)
                for splits in (1, 2, 3):
                    before = B.launch_counts["mvau"]
                    got = KM.mvau_conv(x, w, t, kernel, stride, pad, -2.0, 0.5,
                                       0.25, splits=splits)
                    assert B.launch_counts["mvau"] == before + 1
                    if grid:
                        assert torch.equal(got, want)
                    else:
                        assert _off_grid_ok((got + 2.0 - 0.25) / 0.5,
                                            (want + 2.0 - 0.25) / 0.5, x, w, t,
                                            kernel, stride, pad)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", ["int8", "int16", "int32", "packed4"])
@pytest.mark.parametrize("levels", [15, 255, 65535])
def test_core_int_kernel_equals_plain(card, wdt, levels):
    """The integer instantiation of the CUDA-core kernel, conv and GEMM
    form, on int32 activation codes (8-bit unsigned and 16-bit ranges) with
    int8, int16, int32 and packed int4 weights, forced splits; bit for
    bit."""
    rng = np.random.default_rng(levels + len(wdt))
    lim = {"int8": 128, "int16": 32768, "int32": 40000, "packed4": 8}[wdt]
    for kernel, stride, pad in ((1, 1, 0), (3, 1, 1), (3, 2, 1), (3, 2, 0)):
        for c, n, xmax in ((3, 8, 65536), (16, 72, 256), (24, 8, 4096)):
            x = _t(rng.integers(0, xmax, size=(2, 7, 7, c)).astype(np.int32),
                   card)
            k = kernel * kernel * c
            # every partial sum inside int32, as the integer lowering ensures
            wlim = min(lim, 2**31 // (k * xmax))
            wi = rng.integers(-wlim, wlim, size=(k, n)).astype(np.int32)
            w = (Q.pack_int4(torch.from_numpy(wi)) if wdt == "packed4"
                 else torch.from_numpy(wi.astype(getattr(np, wdt))))
            w = w.to(card)
            t = _t(np.sort(rng.integers(-2**30, 2**30, size=(n, levels)),
                           axis=1).astype(np.int32), card)
            packed = wdt == "packed4"
            want = KM.mvau_int_conv_plain(x, w, t, kernel, stride, pad, -3,
                                          packed)
            for splits in (None, 2, 3):
                assert torch.equal(KM.mvau_int_conv(
                    x, w, t, kernel, stride, pad, -3, packed, splits=splits),
                    want)
            x2 = x.reshape(-1, c).contiguous()
            w2 = w[:c].contiguous()
            assert torch.equal(KM.mvau_int(x2, w2, t, 5, packed),
                               KM.mvau_int_plain(x2, w2, t, 5, packed))


@pytest.mark.cuda
def test_core_kernel_repeats_bit_for_bit_and_resets_counters(card):
    """Off the grid, at r2a's shape (K 4608 split 8 ways) and a ragged one:
    two launches give identical bits (the last block adds the splits in
    split order), and every tile counter is left at zero."""
    rng = np.random.default_rng(4)
    for b, hw, c, n in ((64, 4, 512, 512), (3, 9, 24, 72)):
        x, w, t = _float_conv_inputs(rng, b, hw, c, 3, n, 15, False, card)
        for splits in (None, 3):
            first = KM.mvau_conv(x, w, t, 3, 1, 1, splits=splits)
            assert torch.equal(first, KM.mvau_conv(x, w, t, 3, 1, 1,
                                                   splits=splits))
        torch.cuda.synchronize()
        assert int(B.tile_counters(card, 0).abs().sum()) == 0
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert KM.core_splits(64 * 16, 512, 9 * 512, sms) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["paper_w16a16", "grid_point_8_8",
                                    "table2_row_12_6_6"])
def test_wide_code_artifacts_card_equal_cpu(card, config):
    """Artifacts whose codes do not fit int8 (16- and 12-bit weights stored
    as int16; 8-bit unsigned activations) run every MVAU on the tensor
    cores' plane route (paper_w16a16's c2, whose input is a 17-bit residual
    sum, as int32 codes in six products; grid_point(8, 8)'s 9-bit c2
    against one weight plane in two) with its im2col folded in, r2b with
    the GAP epilogue, and equal the CPU run bit for bit."""
    from repro_torch.kernels import ops as kops

    qcfg = {"paper_w16a16": lambda: Q.QuantConfig.paper_w16a16(),
            "grid_point_8_8": lambda: Q.QuantConfig.grid_point(8, 8),
            "table2_row_12_6_6": lambda: Q.QuantConfig.table2_row(12, 6, 6),
            }[config]()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    cpu = {k: {kk: v.cpu() for kk, v in b.items()} for k, b in params.items()}
    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    dm = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int")
    dm_cpu = repro_torch.compile(cpu, qcfg, recipe="resnet9", datapath="int",
                                 device="cpu")
    prods = [kops.int_route_of(n, dm.graph)[2]
             for n in dm.graph.nodes if n.op == "mvau_int"]
    assert all(kops.int_route_of(n, dm.graph)[0] == "planes"
               for n in dm.graph.nodes if n.op == "mvau_int")
    assert (prods.count(2), prods.count(6)) == {
        "paper_w16a16": (0, 1), "grid_point_8_8": (1, 0),
        "table2_row_12_6_6": (0, 0)}[config]
    labels = {(r["op"], r["kernel"]) for r in dm.dispatch_table()
              if r["op"] in ("im2col", "mvau_int")}
    assert labels == {("im2col", "fused-cuda-planes"),
                      ("mvau_int", "fused-cuda-planes")}
    assert len(dm.apply.folded) == 10 and "r2b_res" in dm.apply.folded
    before = dict(B.launch_counts)
    f = dm(x)
    delta = {k: B.launch_counts[k] - before[k] for k in before}
    assert delta["mvau_int"] == 8 and delta["gap"] == 0
    assert delta["mvau_int_gap"] == 1 and delta["mvau_int_wide"] == 0
    assert delta["mvau_int_planes"] == 8
    assert (delta["mvau_int_planes2"], delta["mvau_int_planes6"]) == (
        prods.count(2), prods.count(6))
    assert torch.equal(f.cpu(), dm_cpu(x))
    assert dm.weight_bytes() == dm_cpu.weight_bytes()


@pytest.mark.cuda
def test_f32_artifact_folds_every_im2col_on_the_card(card):
    """The f32 artifact's 8 im2col nodes are folded into the float conv
    form and its residual add into the GAP kernel: its features equal the
    interpreter's (explicit im2col) and the int artifact's, bit for bit,
    with 8 mvau launches and 1 gap launch."""
    from repro_torch.core.graph import execute

    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    x = Q.fake_quant(_t(np.random.default_rng(1).random((3, 32, 32, 3))
                        .astype(np.float32), card), qcfg.act)
    dm32 = repro_torch.compile(params, qcfg, recipe="resnet9")
    assert len(dm32.apply.folded) == 9 and "r2b_res" in dm32.apply.folded
    assert {r["kernel"] for r in dm32.dispatch_table()
            if r["op"] in ("im2col", "mvau", "global_acc_pool")
            or r["tensor"] == "r2b_res"} == {"cuda"}
    before = dict(B.launch_counts)
    f = dm32(x)
    assert B.launch_counts["mvau"] - before["mvau"] == 8
    assert B.launch_counts["gap"] - before["gap"] == 1
    (interp,) = execute(dm32.graph, {"x": x})
    assert torch.equal(f, interp)
    dm = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int")
    assert torch.equal(f, dm(x))


@pytest.mark.cuda
def test_gap_kernel_and_wrapper_checks(card):
    rng = np.random.default_rng(3)
    for dt in (np.int8, np.int32):
        xi = _t(rng.integers(-100, 100, size=(3, 5, 7, 24)).astype(dt), card)
        got = KG.gap(xi)
        assert got.dtype == torch.int32 and torch.equal(got, KG.gap_plain(xi))
    before = B.launch_counts["gap"]
    KG.gap(_t(rng.random((2, 4, 4, 8)).astype(np.float32), card))
    assert B.launch_counts["gap"] == before + 1
    with pytest.raises(ValueError):
        KG.gap(_t(np.zeros((2, 4, 4, 8), np.float64), card))
    with pytest.raises(ValueError):
        KM.mvau_int(_t(np.zeros((2, 4), np.int8), card),
                    _t(np.zeros((4, 3), np.int8), card),
                    _t(np.zeros((2, 15), np.int32), card))   # N mismatch


def _tail_inputs(rng, batch, side, c, n, dev, packed=False, wrap=False):
    x = _t(rng.integers(0, 16, size=(batch, side, side, c)).astype(np.int8),
           dev)
    lim = 8 if packed else 32
    w = torch.from_numpy(rng.integers(-lim, lim, size=(9 * c, n)
                                      ).astype(np.int32))
    w = (Q.pack_int4(w) if packed else w.to(torch.int8)).to(dev)
    t = _t(np.sort(rng.integers(-2000, 2000, size=(n, 15)), axis=1
                   ).astype(np.int32), dev)
    lo, hi = (2**31 - 40, 2**31) if wrap else (0, 16)
    skip = _t(rng.integers(lo, hi, size=(batch, side, side, n)
                           ).astype(np.int32), dev)
    return x, w, t, skip


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 64])
def test_fused_gap_kernel_equals_plain_at_r2b(card, batch):
    """The conv MVAU with its GAP epilogue at the main path's r2b shape (4 x
    4 x 512 in, N 512, K 4608), planned and forced K splits 1, 2, 8, a skip
    near 2^31 that makes the int32 sums wrap: bit for bit against the plain
    chain, the same bits on a repeated launch, one mvau_int launch each,
    tile counters left at zero."""
    rng = np.random.default_rng(batch)
    for wrap in (False, True):
        x, w, t, skip = _tail_inputs(rng, batch, 4, 512, 512, card, wrap=wrap)
        want = KM.mvau_int_conv_gap_plain(x, w, t, skip, 3, 1, 1, -3)
        for splits in (None, 1, 2, 8):
            before = dict(B.launch_counts)
            got = KM.mvau_int_conv_gap(x, w, t, skip, 3, 1, 1, -3,
                                       splits=splits)
            assert B.launch_counts["mvau_int"] == before["mvau_int"] + 1
            assert B.launch_counts["mvau_int_gap"] == \
                before["mvau_int_gap"] + 1
            assert B.launch_counts["gap"] == before["gap"]
            assert got.shape == (batch, 512) and torch.equal(got, want)
            assert torch.equal(got, KM.mvau_int_conv_gap(
                x, w, t, skip, 3, 1, 1, -3, splits=splits))
        torch.cuda.synchronize()
        assert int(B.tile_counters(card, 0).abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("side", [1, 2, 4])
def test_fused_gap_kernel_equals_plain_small(card, side):
    """OH·OW 1, 4 and 16; C 8 and 24 (4- and 1-byte loads); N 24 and 72
    (ragged column tiles); batch 3 and 37 (a ragged row tile); int8 and
    packed int4 weights; forced splits: bit for bit."""
    rng = np.random.default_rng(side)
    for c, n, batch in ((8, 24, 3), (24, 72, 37)):
        for packed in (False, True):
            x, w, t, skip = _tail_inputs(rng, batch, side, c, n, card, packed)
            want = KM.mvau_int_conv_gap_plain(x, w, t, skip, 3, 1, 1, 2,
                                              packed)
            for splits in (None, 2, 3):
                assert torch.equal(KM.mvau_int_conv_gap(
                    x, w, t, skip, 3, 1, 1, 2, packed, splits=splits), want)


@pytest.mark.cuda
def test_fused_gap_wrapper_raises_on_the_card(card):
    """OH·OW = 64 (an 8 x 8 map), int32 codes (not the tensor cores), a skip
    of another shape or a float skip: ValueError, no launch."""
    rng = np.random.default_rng(9)
    x, w, t, skip = _tail_inputs(rng, 2, 8, 8, 24, card)
    x4, _, _, skip4 = _tail_inputs(rng, 2, 4, 8, 24, card)
    before = dict(B.launch_counts)
    for bad in ((x, w, t, skip), (x4.to(torch.int32), w, t, skip4),
                (x4, w, t, skip4[:, :2]), (x4, w, t, skip4.float())):
        with pytest.raises(ValueError):
            KM.mvau_int_conv_gap(*bad, 3, 1, 1)
    assert B.launch_counts == before


@pytest.mark.cuda
def test_residual_gap_kernel_equals_plain(card):
    """The GAP kernel with the residual add folded in: int8 (the add wraps
    in int8) and int32 bit for bit; float32 on the grid bit for bit, off it
    within rtol/atol 1e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(5)
    for shape in ((64, 4, 4, 512), (3, 5, 7, 24)):
        for dt in (np.int8, np.int32):
            info = np.iinfo(dt)
            a = _t(rng.integers(info.max - 60, info.max, size=shape
                                ).astype(dt), card)
            b = _t(rng.integers(0, 60, size=shape).astype(dt), card)
            before = B.launch_counts["gap"]
            got = KG.gap(a, b)
            assert B.launch_counts["gap"] == before + 1
            assert got.dtype == torch.int32
            assert torch.equal(got, KG.gap_plain(a, b))
        a, b = (_t(rng.integers(0, 64, size=shape) * 0.25, card).float()
                for _ in range(2))
        assert torch.equal(KG.gap(a, b), KG.gap_plain(a, b))
        a, b = (_t(rng.uniform(-2, 2, size=shape).astype(np.float32), card)
                for _ in range(2))
        assert torch.allclose(KG.gap(a, b), KG.gap_plain(a, b), rtol=1e-5,
                              atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("int8_ok", [True, False])
@pytest.mark.parametrize("skip", [((2, 4, 4, 5), np.int32),
                                  ((2, 1, 1, 5), np.int32),
                                  ((1, 4, 4, 5), np.int8), ((5,), np.int32),
                                  ((2, 4, 4, 5), np.float32)])
def test_skip_that_broadcasts_or_is_float_on_the_card(card, int8_ok, skip):
    """A hand-built ``im2col -> mvau_int -> add -> global_acc_pool`` tail
    lowered on the card: only an integer skip of the MVAU output's shape
    takes the GAP epilogue (``int8_ok``) or the GAP kernel's residual
    operand; a skip that broadcasts or is float is added first and pooled
    by the GAP kernel.  One MVAU launch and one pooling launch each, and
    card == CPU bit for bit."""
    from repro_torch.core import graph as G
    from repro_torch.core.deploy import lower_graph

    shape, dtype = skip
    rng = np.random.default_rng(6)
    nodes = [G.Node("im2col", ["x"], ["col"],
                    {"kernel": 3, "stride": 1, "pad": 1}),
             G.Node("mvau_int", ["col", "w", "t"], ["y"],
                    {"out_base": 0, "int8_ok": int8_ok, "w_packed": False,
                     "acc_f32_exact": True}),
             G.Node("add", ["y", "s"], ["r"]),
             G.Node("global_acc_pool", ["r"], ["f"],
                    {"axes": [1, 2], "spatial_size": 16})]
    init = {"w": rng.integers(-8, 8, size=(36, 5)).astype(np.int8),
            "t": np.sort(rng.integers(-100, 100, size=(5, 15)),
                         axis=1).astype(np.int32)}
    g = G.Graph(nodes, ["x", "s"], ["f"], init, name="tail")
    x = rng.integers(0, 16, size=(2, 4, 4, 4)).astype(np.int32)
    s = rng.integers(-9, 9, size=shape).astype(dtype)
    fused = int8_ok and shape == (2, 4, 4, 5) and dtype != np.float32
    before = dict(B.launch_counts)
    (got,) = lower_graph(g, card)(_t(x, card), _t(s, card))
    delta = {k: B.launch_counts[k] - before[k] for k in before}
    assert delta == {"mvau_int": 1, "mvau_int_gap": int(fused),
                     "mvau_int_wide": int(not int8_ok),
                     "mvau_int_planes": 0, "mvau_int_planes2": 0,
                     "mvau_int_planes6": 0, "mvau_int_small_m": 0, "mvau": 0,
                     "gap": 1 - int(fused), "qmatmul": 0,
                     "qmatmul_rows": 0}
    (want,) = lower_graph(g, "cpu")(_t(x, "cpu"), _t(s, "cpu"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_w6a4_width64_fuses_the_tail_on_the_card(card):
    """The w6a4 int artifact at the paper's width 64: 8 mvau_int launches a
    forward, one of them with the GAP epilogue, and no gap launch; card ==
    CPU bit for bit."""
    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 64,
                                 device=card)
    cpu = {k: {kk: v.cpu() for kk, v in b.items()} for k, b in params.items()}
    x = np.random.default_rng(1).random((8, 32, 32, 3)).astype(np.float32)
    dm = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int")
    dm_cpu = repro_torch.compile(cpu, qcfg, recipe="resnet9", datapath="int",
                                 device="cpu")
    before = dict(B.launch_counts)
    f = dm(x)
    delta = {k: B.launch_counts[k] - before[k] for k in before}
    assert delta == {"mvau_int": 8, "mvau_int_gap": 1, "mvau_int_wide": 0,
                     "mvau_int_planes": 0, "mvau_int_planes2": 0,
                     "mvau_int_planes6": 0, "mvau_int_small_m": 0, "mvau": 0,
                     "gap": 0, "qmatmul": 0,
                     "qmatmul_rows": 0}
    assert torch.equal(f.cpu(), dm_cpu(x))


@pytest.mark.cuda
def test_main_path_card_equals_cpu(card):
    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    cpu = {k: {kk: v.cpu() for kk, v in b.items()} for k, b in params.items()}
    x = np.random.default_rng(1).random((3, 32, 32, 3)).astype(np.float32)
    dm = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int")
    dm32 = repro_torch.compile(params, qcfg, recipe="resnet9")
    dm_cpu = repro_torch.compile(cpu, qcfg, recipe="resnet9", datapath="int",
                                 device="cpu")
    before = dict(B.launch_counts)
    f = dm(x)
    assert B.launch_counts["mvau_int"] - before["mvau_int"] == 8
    assert B.launch_counts["mvau_int_gap"] - before["mvau_int_gap"] == 1
    assert B.launch_counts["gap"] - before["gap"] == 0
    assert torch.equal(f.cpu(), dm_cpu(x))
    assert torch.equal(f, dm32(Q.fake_quant(_t(x, card), qcfg.act)))
    # every im2col is folded into the conv-form kernel on the card, and the
    # last residual add and the GAP into r2b's epilogue
    labels = {(r["op"], r["kernel"]) for r in dm.dispatch_table()
              if r["op"] in ("im2col", "mvau_int", "global_acc_pool")}
    assert labels == {("im2col", "fused-cuda"), ("mvau_int", "fused-cuda"),
                      ("global_acc_pool", "fused-cuda")}
    assert len(dm.apply.folded) == 10


@pytest.mark.cuda
def test_build_dataflow_graph_on_the_card_equals_the_recipe(card):
    """The paper's customized build-step list at width 8: its HW graph
    through the interpreter on the card (8 float ``mvau`` launches) equals
    the recipe artifact and the CPU run of the same graph, bit for bit."""
    from repro_torch.core import RESNET9_BUILD_STEPS, build_dataflow
    from repro_torch.core.graph import execute

    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    hw = build_dataflow(resnet9.export_graph(params, qcfg, width=8),
                        RESNET9_BUILD_STEPS)
    x = np.random.default_rng(1).random((3, 32, 32, 3)).astype(np.float32)
    xq = Q.fake_quant(_t(x, card), qcfg.act)
    before = dict(B.launch_counts)
    (f,) = execute(hw, {"x": xq})
    assert B.launch_counts["mvau"] - before["mvau"] == 8
    dm = repro_torch.compile(params, qcfg, recipe="resnet9")
    assert f.is_cuda and torch.equal(f, dm(xq))
    (f_cpu,) = execute(hw, {"x": xq.cpu()})
    assert torch.equal(f.cpu(), f_cpu)


FUZZ_CARD_CASES = ([("reference", s) for s in (0, 1, 2, 3)]
                   + [("wide", s) for s in (7, 13, 23, 40, 42)]
                   + [("gemm", s) for s in (2, 11, 17, 19)])


@pytest.mark.cuda
@pytest.mark.parametrize("corpus,seed", FUZZ_CARD_CASES)
def test_fuzz_graphs_card_equal_cpu(card, corpus, seed):
    """Random hardware-mapped graphs of ``core.fuzz`` through the four
    engines on the card (``check_differential``: interpreter == f32 ==
    unfused int == fused int), each output equal to its CPU counterpart and
    the CPU interpreter's bit for bit.  The wide seeds hold a fused GAP
    tail (7, 40), a float residual add (13), a CUDA-core MVAU whose K the
    planner splits (23) and one with 255 levels (42); the dense seeds hold
    int8 GEMM-form MVAUs on the small-M kernel (17: K 1,440; 19: 255
    levels) and past its limit on the wgmma kernel (2: M 2,049; 11: K
    1,440)."""
    from repro_torch.core import fuzz

    gen = {"reference": fuzz.random_hw_graph, "wide": fuzz.wide_hw_graph,
           "gemm": fuzz.gemm_hw_graph}[corpus]
    g, x, _ = gen(seed)
    got = fuzz.check_differential(g, x, card)
    want = fuzz.check_differential(g, x, "cpu")
    for key in ("interpreter", "f32", "int_unfused", "int"):
        assert fuzz.same_output(got[key], want[key]), key
        assert fuzz.same_output(got[key], want["interpreter"]), key


@pytest.mark.cuda
def test_store_head_on_the_card(card):
    """The store's default device is the card; its prototypes and
    similarities agree with a CPU store's within rtol 1e-5 / atol 1e-6 and
    its predictions are equal; chunked registrations equal class_means."""
    from repro_torch.fsl import ncm
    from repro_torch.serve.store import PrototypeStore

    rng = np.random.default_rng(2)
    f = rng.normal(size=(11, 64)).astype(np.float32)
    labs = np.array([0] * 7 + [1] * 1 + [2] * 3)
    gpu, cpu = PrototypeStore(), PrototypeStore(device="cpu")
    assert gpu.device.type == "cuda"
    for s in (gpu, cpu):
        s.register(0, f[0:3])
        s.register(2, f[8:9])
        s.register(0, f[3:7])
        s.register(1, _t(f[7:8], card))
        s.register(2, f[9:11])
    means = gpu.prototypes()[0]
    offline = ncm.class_means(_t(f, card), torch.from_numpy(labs), 3)
    assert np.array_equal(means[[0, 2, 1]], offline.cpu().numpy())
    np.testing.assert_allclose(means, cpu.prototypes()[0], rtol=1e-5, atol=1e-6)
    q = rng.normal(size=(6, 64)).astype(np.float32)
    (g_ids, g_sims), (c_ids, c_sims) = gpu.classify(_t(q, card)), cpu.classify(q)
    assert g_ids == c_ids
    np.testing.assert_allclose(g_sims, c_sims, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# qmatmul: the w8/w4 LM decode path's kernel
# ---------------------------------------------------------------------------
def _qmm_inputs(m, k, n, bits, xdt, dev, seed, exact=False):
    rng = np.random.default_rng(seed)
    lim = 8 if bits == 4 else (32 if exact else 128)
    codes = rng.integers(-lim, lim, size=(k, n)).astype(np.int32)
    if exact:
        x = rng.integers(-16, 17, size=(m, k)).astype(np.float32)
    else:
        x = rng.uniform(-1, 1, size=(m, k)).astype(np.float32)
    s = rng.uniform(0.001, 0.02, size=(n,)).astype(np.float32)
    w = (Q.pack_int4(torch.from_numpy(codes)) if bits == 4
         else torch.from_numpy(codes.astype(np.int8)))
    return (_t(x, dev).to(xdt), w.to(dev), _t(s, dev),
            torch.from_numpy(codes).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 32, 16), (5, 130, 66), (3, 37, 12),
                                   (9, 515, 264), (4, 2048, 256),
                                   (4, 2048, 11008), (4, 11008, 2048),
                                   (32, 2048, 2048)])
def test_qmatmul_kernel_equals_plain(card, m, k, n, bits, xdt):
    """Ragged M, N, K (scalar and vector weight loads), the decode shapes
    at batch 4 and a prefill shape.  Only the order of the float32 sum
    differs: the error stays within 2e-5 of sum_k |bf16(x)| |code| scale,
    plus one bf16 rounding of the output for bf16 x."""
    from repro_torch.kernels import qmatmul as KQ

    dt = getattr(torch, xdt)
    x, w, s, codes = _qmm_inputs(m, k, n, bits, dt, card, m * k + n)
    before = B.launch_counts["qmatmul"]
    got = KQ.qmatmul(x, w, s, bits)
    assert B.launch_counts["qmatmul"] == before + 1
    want = KQ.qmatmul_plain(x, w, s, bits)
    assert got.dtype == dt and got.shape == want.shape
    scale = (x.to(torch.bfloat16).float().abs() @ codes.float().abs()) * s
    tol = 2e-5 * scale
    if dt == torch.bfloat16:
        tol = tol + want.float().abs() * 2.0 ** -7
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_qmatmul_wrapper_checks(card):
    from repro_torch.kernels import qmatmul as KQ

    x, w, s, _ = _qmm_inputs(4, 64, 32, 8, torch.bfloat16, card, 1)
    before = B.launch_counts["qmatmul"]
    for bad in ((x.half(), w, s), (x, w, s[:-1]), (x, w.cpu(), s),
                (x, w.to(torch.int32), s), (x.T, w, s)):
        with pytest.raises(ValueError):
            KQ.qmatmul(*bad, 8)
    assert B.launch_counts["qmatmul"] == before
    assert KQ.qmatmul(x[:0], w, s, 8).shape == (0, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_kernel_exact_on_integers(card, bits):
    """Integer-valued x and small codes: every partial sum is an integer
    below 2^24, so the kernel equals the plain version bit for bit."""
    from repro_torch.kernels import qmatmul as KQ

    for m, k, n in ((4, 2048, 256), (4, 11008, 2048), (7, 100, 18)):
        x, w, s, _ = _qmm_inputs(m, k, n, bits, torch.float32, card, k,
                                 exact=True)
        s = torch.full_like(s, 0.5)
        assert torch.equal(KQ.qmatmul(x, w, s, bits),
                           KQ.qmatmul_plain(x, w, s, bits))


def _qmm_tolerance(x, codes, s, want):
    """2e-5 of sum_k |bf16(x)| |code| scale, plus one bf16 rounding of the
    output for bf16 x: the tolerance of test_qmatmul_kernel_equals_plain."""
    tol = 2e-5 * (x.to(torch.bfloat16).float().abs() @ codes.float().abs()) * s
    if x.dtype == torch.bfloat16:
        tol = tol + want.float().abs() * 2.0 ** -7
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("splits", [1, 2, 4, 8, 5])
def test_qmatmul_forced_splits_equal_plain(card, splits, bn, bits):
    """Every forced K split (5 leaves a ragged last split of 416 rows of
    2048) and both column-tile widths, within the unchanged tolerance."""
    from repro_torch.kernels import qmatmul as KQ

    x, w, s, codes = _qmm_inputs(4, 2048, 320, bits, torch.bfloat16, card,
                                 splits + bn)
    got = KQ.qmatmul(x, w, s, bits, splits=splits, bn=bn)
    want = KQ.qmatmul_plain(x, w, s, bits)
    assert bool(((got.float() - want.float()).abs()
                 <= _qmm_tolerance(x, codes, s, want)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_repeats_bit_for_bit_and_resets_counters(card, bits):
    """Split K adds the splits in a fixed order inside the launch: two calls
    give identical bits, and the last block of each tile leaves its counter
    at zero."""
    from repro_torch.kernels import qmatmul as KQ

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for m, k, n in ((4, 2048, 256), (4, 11008, 2048), (3, 1030, 264)):
        x, w, s, _ = _qmm_inputs(m, k, n, bits, torch.bfloat16, card, k)
        assert KQ.split_plan(m, k, n, sms, bits)[2] > 1
        first = KQ.qmatmul(x, w, s, bits)
        assert torch.equal(first, KQ.qmatmul(x, w, s, bits))
        torch.cuda.synchronize()
        assert int(B.tile_counters(x.device, 0).abs().sum()) == 0


@pytest.mark.cuda
def test_qmatmul_is_one_launch_per_call(card):
    """One call adds exactly one to the launch count, and the profiler sees
    one kernel and no separate reduce, at a split and at no split."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import qmatmul as KQ

    x, w, s, _ = _qmm_inputs(4, 2048, 256, 8, torch.bfloat16, card, 3)
    for splits in (None, 1):
        KQ.qmatmul(x, w, s, 8, splits=splits)
        torch.cuda.synchronize()
        before = B.launch_counts["qmatmul"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            KQ.qmatmul(x, w, s, 8, splits=splits)
            torch.cuda.synchronize()
        assert B.launch_counts["qmatmul"] == before + 1
        names = [e.key for e in prof.key_averages() if "qmm" in e.key]
        assert len(names) == 1 and "reduce" not in names[0], names
        assert sum(e.count for e in prof.key_averages()
                   if "qmm" in e.key) == 1


@pytest.mark.cuda
def test_full_width_decode_card_equals_cpu(card):
    """Qwen2.5-3B at full width, 2 layers, w8: teacher-forced decode logits
    on the card against the CPU within atol 0.0625 (bf16 logits up to
    about 4.5 in size, where one ulp is 0.03125; the CPU port and the JAX
    reference differed by one ulp at this size), and equal greedy tokens
    wherever the CPU's top-2 margin exceeds twice that."""
    import dataclasses

    from repro_torch.launch.steps import quantize_tree_for_serving
    from repro_torch.models import lm
    from repro_torch.models.common import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    params = lm.init_params(torch.Generator(device=card).manual_seed(0), cfg)
    cpu = _tree_map(lambda t: t.cpu(), params)
    q_card = lm.with_head_copy(quantize_tree_for_serving(params, 8), cfg)
    q_cpu = lm.with_head_copy(quantize_tree_for_serving(cpu, 8), cfg)
    assert torch.equal(q_card["blocks"]["mlp"]["w_up"]["w_codes"].cpu(),
                       q_cpu["blocks"]["mlp"]["w_up"]["w_codes"])
    B_, T = 2, 6
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B_, T))
    caches = {d: lm.init_cache(cfg, B_, T + 1, device=d)
              for d in ("cuda", "cpu")}
    tol = 0.0625
    for t in range(T):
        tok = torch.from_numpy(toks[:, t:t + 1].astype(np.int32))
        lc, caches["cpu"] = lm.decode_step(q_cpu, tok, caches["cpu"], cfg)
        lg, caches["cuda"] = lm.decode_step(q_card, tok.to(card),
                                            caches["cuda"], cfg)
        lc = lc[:, :cfg.vocab].float()
        lg = lg[:, :cfg.vocab].float().cpu()
        assert bool(torch.isfinite(lg).all())
        assert float((lg - lc).abs().max()) <= tol, f"step {t}"
        top2 = torch.topk(lc, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        assert torch.equal(lg.argmax(-1)[sure], lc.argmax(-1)[sure])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["lm-tiny", "qwen2.5-3b"])
def test_long_prefill_card_equals_cpu(card, arch):
    """A prompt of 4,096 through the chunked attention, card against CPU
    within 0.0625 (the LM rule): lm-tiny's float ``lm.forward`` (chunk 8,
    one group of 512 query blocks) and one Qwen2.5-3B attention layer at
    full width (chunk 1,024, groups of one block)."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.common import get_config

    S = 4096
    rng = np.random.default_rng(0)
    if arch == "lm-tiny":
        cfg = dataclasses.replace(get_config(arch), quant=None)
        assert L._group_blocks(S // 8, 8) == S // 8
        cpu = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))
                                .astype(np.int32))
        want = lm.forward(cpu, {"tokens": toks}, cfg)[0]
        got = lm.forward(_tree_map(lambda t: t.to(card), cpu),
                         {"tokens": toks.to(card)}, cfg)[0]
    else:
        cfg = get_config(arch)
        assert L._group_blocks(S // 1024, 1024) == 1
        cpu = L.attn_init(torch.Generator().manual_seed(0), cfg)
        x = torch.from_numpy(rng.standard_normal((1, S, cfg.d_model))
                             .astype(np.float32)).to(torch.bfloat16)
        pos = torch.arange(S)[None]
        want = L.attention(cpu, x, cfg, pos)[0]
        got = L.attention(_tree_map(lambda t: t.to(card), cpu), x.to(card),
                          cfg, pos.to(card))[0]
    assert got.is_cuda and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert float((got.float().cpu() - want.float()).abs().max()) <= 0.0625


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# CUDA graphs: warmed buckets, the flip ensemble, the decode step, the engine
# ---------------------------------------------------------------------------
def _artifacts(card, width=8):
    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), width,
                                 device=card)
    return qcfg, params, {
        dp: repro_torch.compile(params, qcfg, recipe="resnet9", datapath=dp)
        for dp in ("int", "f32")}


def _frames(card, n, seed=1):
    return _t(np.random.default_rng(seed).random((n, 32, 32, 3))
              .astype(np.float32), card)


@pytest.mark.cuda
def test_replayed_buckets_equal_eager(card):
    """Every warmed bucket of the int and f32 artifacts at width 8: the
    replay equals the eager run of the same lowered function bit for bit,
    adds the graph's captured launches (8 MVAU kernels) to the counts, and
    nothing is captured after warmup."""
    qcfg, _, dms = _artifacts(card)
    for dp, dm in dms.items():
        assert dm.warmup([1, 2, 4, 8], _frames(card, 1)) == (1, 2, 4, 8)
        assert dm.trace_count == 4 and len(dm.compile_log) == 4
        for n in (1, 3, 4, 8):
            x = _frames(card, n, seed=n)
            if dp == "f32":
                x = Q.fake_quant(x, qcfg.act)
            before = dict(B.launch_counts)
            got = dm.batched(x)
            torch.cuda.synchronize()
            kern = "mvau_int" if dp == "int" else "mvau"
            assert B.launch_counts[kern] - before[kern] == 8
            b = 1 << (n - 1).bit_length()
            pad = torch.cat([x, x.new_zeros((b - n,) + x.shape[1:])])
            (want,) = dm.apply(pad)
            assert torch.equal(got, want[:n]), (dp, n)
        assert dm.trace_count == 4


@pytest.mark.cuda
def test_flip_ensemble_replay_equals_eager(card):
    from repro_torch.fsl.pipeline import FSLPipeline

    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    pipe = FSLPipeline(width=8, qcfg=qcfg)
    for dp in ("int", "f32"):
        feats = pipe.deploy(params, datapath=dp)
        feats.warmup([1, 4])
        n = feats.trace_count()
        assert n == 2
        for b in (1, 4):
            x = _frames(card, b, seed=b)
            got = feats(x)
            assert torch.equal(got, feats._exec.fn(x))
            assert torch.equal(got, pipe.features(params, x))
        assert feats.trace_count() == n


@pytest.mark.cuda
def test_replay_results_do_not_alias(card):
    _, _, dms = _artifacts(card)
    dm = dms["int"]
    dm.warmup([2], _frames(card, 1))
    a = dm.batched(_frames(card, 2, seed=5))
    keep = a.clone()
    b = dm.batched(_frames(card, 2, seed=6))
    torch.cuda.synchronize()
    assert torch.equal(a, keep) and not torch.equal(a, b)
    assert a.data_ptr() != b.data_ptr()


@pytest.mark.cuda
def test_two_threads_on_one_artifact_equal_serial(card):
    import threading

    _, _, dms = _artifacts(card)
    dm = dms["int"]
    dm.warmup([1, 2, 4], _frames(card, 1))
    xs = [_frames(card, 1 + i % 4, seed=i) for i in range(16)]
    serial = [dm.batched(x) for x in xs]
    got = [None] * len(xs)

    def work(lo):
        for i in range(lo, len(xs), 2):
            for _ in range(5):
                got[i] = dm.batched(xs[i])

    threads = [threading.Thread(target=work, args=(lo,)) for lo in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert all(torch.equal(g, s) for g, s in zip(got, serial))


@pytest.mark.cuda
def test_two_graphs_on_two_streams_keep_their_split_counters(card):
    """Two graphs of a split-K launch (8 forced K splits) replayed at once
    on two streams give their serial results: each graph owns its tile
    counters, neither is the device's eager buffer, and all are left zero."""
    import threading

    from repro_torch.core.cudagraph import CapturedGraph

    rng = np.random.default_rng(9)
    graphs, want = [], []
    for i in range(2):
        x = _t(rng.integers(-8, 8, size=(16, 4, 4, 512)).astype(np.int8), card)
        w = _t(rng.integers(-8, 8, size=(4608, 512)).astype(np.int8), card)
        t = _t(np.sort(rng.integers(-900, 900, size=(512, 15)), axis=1)
               .astype(np.int32), card)

        def fn(x, w=w, t=t):
            return KM.mvau_int_conv(x, w, t, 3, 1, 1, 0, splits=8)

        want.append(KM.mvau_int_conv_plain(x, w, t, 3, 1, 1, 0))
        graphs.append(CapturedGraph(fn, (x,), pool=None,
                                    stream=torch.cuda.Stream(card)))
    shared = B.tile_counters(card, 0).data_ptr()
    ptrs = {g.counters.data_ptr() for g in graphs}
    assert len(ptrs) == 2 and shared not in ptrs
    assert all(g.launches == {"mvau_int": 1} for g in graphs)
    streams = [torch.cuda.Stream(card) for _ in graphs]
    errors = []

    def work(i):
        with torch.cuda.stream(streams[i]):
            for _ in range(50):
                graphs[i].replay()
                if not torch.equal(graphs[i].outputs[0], want[i]):
                    errors.append(i)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors
    assert all(int(g.counters.abs().sum()) == 0 for g in graphs)


@pytest.mark.cuda
def test_capture_survives_collectable_dropped_graphs(card):
    """Graphs dropped in reference cycles are freed whenever the garbage
    collector runs, and freeing one returns its memory pool to the device.
    With collections due at every allocation while another graph captures
    (thresholds of 1, garbage graphs present), the capture still completes
    and its replay equals the eager result: no collection runs inside a
    capture."""
    import gc

    from repro_torch.core.cudagraph import WARM_RUNS, CapturedGraph

    x = torch.randn(64, 64, device=card)

    def capture(fn):
        g = CapturedGraph(fn, (x,), pool=torch.cuda.graph_pool_handle(),
                          stream=torch.cuda.Stream(card))
        g.cycle = g                     # only the collector frees it
        return g

    dropped = [capture(lambda t: t @ t) for _ in range(3)]
    calls = []
    thresholds = gc.get_threshold()

    def fn(t):
        calls.append(1)
        if len(calls) == WARM_RUNS + 1:          # inside the capture
            dropped.clear()
            gc.set_threshold(1, 1, 1)
            junk = [[] for _ in range(2000)]     # collections fall due
            del junk
        return t @ t + 1

    try:
        g = capture(fn)
    finally:
        gc.set_threshold(*thresholds)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(g.outputs[0], x @ x + 1)


@pytest.mark.cuda
def test_decode_graph_equals_eager_two_layers(card):
    """Qwen2.5-3B at full width, 2 layers, w8 and w4: the captured decode
    step gives the eager step's logits and greedy tokens bit for bit over a
    prompt and generated tokens; ``generate`` gives the same tokens both
    ways; the graph records 14 qmatmul launches a step."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import (GraphedDecodeStep,
                                          make_decode_step,
                                          quantize_tree_for_serving)
    from repro_torch.models import lm
    from repro_torch.models.common import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    params = lm.init_params(torch.Generator(device=card).manual_seed(0), cfg)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 4))
    for bits in (8, 4):
        q = lm.with_head_copy(quantize_tree_for_serving(params, bits), cfg)
        step = GraphedDecodeStep(q, cfg, 2, 12)
        assert step.graph.launches == {"qmatmul": 14}
        eager = make_decode_step(cfg)
        cache = lm.init_cache(cfg, 2, 12)
        tok = torch.as_tensor(prompt[:, :1], dtype=torch.int32, device=card)
        for t in range(9):
            feed = (torch.as_tensor(prompt[:, t:t + 1], dtype=torch.int32,
                                    device=card) if t < 4 else tok)
            logits, _ = lm.decode_step(q, feed, cache, cfg)
            nxt, cache = eager(q, {"tokens": feed}, cache)
            step.step(feed)
            assert torch.equal(step.logits, logits), (bits, t)
            assert torch.equal(step.tokens[:, 0], nxt), (bits, t)
            tok = nxt[:, None]
        assert torch.equal(generate(q, cfg, prompt, 5),
                           generate(q, cfg, prompt, 5, graph=False))


@pytest.mark.cuda
def test_engine_on_the_card_no_capture_after_warmup(card):
    """The engine on the card: warmup captures every bucket of both
    artifacts, mixed traffic from two threads captures nothing more, the
    served prototypes equal an offline recompute through the same feats bit
    for bit, and a third artifact warmed while the engine serves captures
    beside the worker's replays."""
    import threading

    from repro_torch.fsl.pipeline import FSLPipeline
    from repro_torch.serve import ArtifactRegistry, ServeEngine

    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    pipe = FSLPipeline(width=8, qcfg=qcfg)
    reg = ArtifactRegistry()
    reg.register("int", pipe.deploy(params, "int"), default=True)
    reg.register("f32", pipe.deploy(params, "f32"))
    rng = np.random.default_rng(4)
    shots = {c: rng.random((3, 32, 32, 3)).astype(np.float32)
             for c in range(3)}
    queries = [rng.random((1 + i % 3, 32, 32, 3)).astype(np.float32)
               for i in range(60)]
    with ServeEngine(reg, max_batch=8, batch_wait_ms=1.0) as eng:
        base = eng.warmup(img=32)
        assert base == {"int": 4, "f32": 4}
        for c, x in shots.items():
            eng.submit_register(c, x).result(60)
        results = [None] * len(queries)

        def submit(lo):
            for i in range(lo, len(queries), 2):
                results[i] = eng.submit_classify(queries[i]).result(60)

        threads = [threading.Thread(target=submit, args=(lo,))
                   for lo in (0, 1)]
        for t in threads:
            t.start()
        feats3 = FSLPipeline(width=8, qcfg=qcfg).deploy(params, "int")
        reg.register("int-2", feats3)
        reg.get("int-2").warmup(eng.buckets, img=32)
        for t in threads:
            t.join()
        assert eng.trace_counts() == {**base, "int-2": 4}
        snap = eng.metrics.snapshot()
        assert snap["failed"] == 0 and snap["rejected"] == 0
    feats = reg.get("int").feats
    means, ids = reg.get("int").store.prototypes()
    from repro_torch.fsl import ncm
    sup = torch.cat([feats(x) for x in shots.values()])
    labs = torch.as_tensor(np.repeat(np.arange(3), 3))
    offline = ncm.class_means(sup, labs, 3)
    assert ids == (0, 1, 2)
    np.testing.assert_array_equal(means, offline.cpu().numpy())
    for q, r in zip(queries, results):
        want = ncm.ncm_classify(feats(q), offline)
        assert r.class_ids == want.tolist()


def _cluster_registry(params, dev):
    from repro_torch.fsl.pipeline import FSLPipeline
    from repro_torch.serve.cluster import sharded_tenant_registry

    pipe = FSLPipeline(width=8, qcfg=repro_torch.QuantConfig.paper_w6a4(),
                       device=dev)
    reg = sharded_tenant_registry()
    reg.register_backbone("int", pipe.deploy(params, "int"), default=True)
    reg.register_backbone("f32", pipe.deploy(params, "f32"))
    return reg


@pytest.mark.cuda
def test_cluster_cold_then_restart_on_the_card(card, tmp_path):
    """The cluster at width 8 on the card: 4 tenants (one on the f32
    backbone) served by 2 replicas from two threads, nothing captured after
    warmup, prototypes bit for bit with an offline recompute; then a cold
    restart from the same cache directory: every bucket a cache hit, no new
    record, every digest matched, and the same queries answered bit for bit
    (class ids and similarities).  Features equal the CPU's bit for bit."""
    import threading

    from repro_torch.ckpt import CompileCache
    from repro_torch.fsl import ncm
    from repro_torch.serve.cluster import ServeCluster

    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    rng = np.random.default_rng(5)
    tenants = ("a", "b", "c", "d")
    shots = {t: {c: rng.random((3, 32, 32, 3)).astype(np.float32)
                 for c in range(3)} for t in tenants}
    queries = [(tenants[i % 4], rng.random((1 + i % 4, 32, 32, 3)).astype(
        np.float32)) for i in range(48)]
    cache = CompileCache(str(tmp_path))

    def serve(replicas):
        reg = _cluster_registry(params, card)
        with ServeCluster(reg, replicas=replicas, max_batch=8,
                          batch_wait_ms=1.0, tenant_quota=0.5,
                          compile_cache=cache) as cluster:
            for t in tenants:
                cluster.add_tenant(t)
            reg.set_tenant_default("d", "f32")
            base = cluster.warmup(img=32)
            for t in tenants:
                for c, x in shots[t].items():
                    cluster.submit_register(t, c, x).result(60)
            out = [None] * len(queries)

            def client(lo):
                for i in range(lo, len(queries), 2):
                    t, x = queries[i]
                    out[i] = cluster.submit_classify(t, x).result(60)

            threads = [threading.Thread(target=client, args=(lo,))
                       for lo in (0, 1)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            assert cluster.trace_counts() == base
            snap = cluster.metrics_snapshot()
            assert snap["completed"] == len(queries) + 12
            assert snap["rejected"] == 0
        return reg, base, out

    reg, base, first = serve(2)
    assert base["int"] == base["f32"] == 4 and cache.stats()["stores"] == 8
    for t in tenants:
        bb = "f32" if t == "d" else "int"
        feats = reg.get(bb).feats
        sup = torch.cat([feats(x) for x in shots[t].values()])
        want = ncm.class_means(sup, torch.as_tensor(np.repeat(np.arange(3),
                                                              3)), 3)
        np.testing.assert_array_equal(reg.tenant_store(t).prototypes()[0],
                                      want.cpu().numpy())
    stats = cache.stats()
    reg2, base2, second = serve(1)
    assert base2 == base
    assert cache.stats()["stores"] == stats["stores"]
    assert cache.stats()["hits"] == stats["hits"] + 8
    assert cache.stats()["load_errors"] == 0
    for r1, r2 in zip(first, second):
        assert r1.artifact == r2.artifact
        assert r1.class_ids == r2.class_ids
        np.testing.assert_array_equal(r1.sims, r2.sims)
    cpu = _cluster_registry(resnet9.init_params(
        torch.Generator().manual_seed(0), 8, device="cpu"), "cpu")
    x = queries[3][1]
    for bb in ("int", "f32"):
        np.testing.assert_array_equal(reg2.get(bb).feats(x).cpu().numpy(),
                                      cpu.get(bb).feats(x).numpy())


@pytest.mark.cuda
def test_warm_captures_a_shape_already_run_eagerly(card, tmp_path):
    """A shape run eagerly before warmup (the lm-tiny decode's eager steps)
    is still captured by ``warm``, with or without a cache."""
    from repro_torch.ckpt import CompileCache
    from repro_torch.core.cudagraph import GraphTable

    for cache in (None, CompileCache(str(tmp_path))):
        table = GraphTable(lambda x: x * 2 + 1, card)
        x = torch.ones((4, 3), device=card)
        table(x)
        assert table.trace_count == 1 and not table.graphs
        table.warm((x,), name="t", cache=cache,
                   key=None if cache is None else cache.key(kind="t"))
        assert len(table.graphs) == 1
        assert torch.equal(table(x)[0], x * 2 + 1)


@pytest.mark.cuda
def test_cache_digest_check_on_restore_on_the_card(card, tmp_path):
    """A restored bucket's first replay is checked against the record: a
    tampered digest raises, and the graph is not kept."""
    from repro_torch.ckpt import CompileCache
    from repro_torch.ckpt.compile_cache import WarmDigestMismatch

    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    cache = CompileCache(str(tmp_path))
    ex = np.zeros((1, 32, 32, 3), np.float32)
    dm1 = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int")
    dm1.warmup([1, 4], ex, cache=cache)
    assert [e["cached"] for e in dm1.compile_log] == [False, False]
    dm2 = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int")
    dm2.warmup([1, 4], ex, cache=cache)
    assert [e["cached"] for e in dm2.compile_log] == [True, True]
    assert dm2.trace_count == 2                    # captured again, checked
    key = dm2.compile_log[1]["key"]
    rec = cache.load(key)
    rec["sha256"] = (rec["sha256"] ^ np.uint8(1)).astype(np.uint8)
    cache.store(key, rec)
    dm3 = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int")
    dm3.warmup([1], ex, cache=cache)
    with pytest.raises(WarmDigestMismatch):
        dm3.warmup([4], ex, cache=cache)
    assert dm3.trace_count == 1
    x = np.random.default_rng(0).random((4, 32, 32, 3)).astype(np.float32)
    assert torch.equal(dm2(x), dm1(x))


def _train_setup(dev, width: int = 8):
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.fsl.pipeline import FSLPipeline

    data = SyntheticImages(n_base=6, n_novel=5, seed=2)
    return data, FSLPipeline(width=width, qcfg=Q.QuantConfig.paper_w6a4(),
                             device=dev)


@pytest.mark.cuda
def test_training_steps_on_the_card_match_the_cpu(card):
    """A few pretraining steps on the card and on the CPU from the same
    seed: losses within rtol 1e-5, params within rtol 1e-4, atol 1e-6."""
    from repro_torch.fsl.pipeline import pretrain_backbone

    data, pipe_cpu = _train_setup("cpu")
    _, pipe_card = _train_setup(card)
    a = pretrain_backbone(data, pipe_cpu, steps=3, batch=8, seed=4)
    b = pretrain_backbone(data, pipe_card, steps=3, batch=8, seed=4)
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
    for name, blk in a["params"].items():
        for leaf, want in blk.items():
            got = b["params"][name][leaf]
            assert got.device.type == "cuda"
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_training_on_the_card_is_deterministic(card):
    """Two same-seed runs on the card: losses and params bit for bit (the
    backward has no atomics: im2col is shifted slices, not a gather)."""
    from repro_torch.fsl.pipeline import pretrain_backbone

    data, pipe = _train_setup(card)
    a = pretrain_backbone(data, pipe, steps=5, batch=16, seed=1)
    b = pretrain_backbone(data, pipe, steps=5, batch=16, seed=1)
    assert a["losses"] == b["losses"]
    for name, blk in a["params"].items():
        for leaf, v in blk.items():
            assert torch.equal(v, b["params"][name][leaf]), (name, leaf)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.cuda
def test_trained_int_artifact_card_equals_cpu(card):
    from repro_torch.fsl.pipeline import pretrain_backbone

    data, pipe = _train_setup(card)
    out = pretrain_backbone(data, pipe, steps=5, batch=16, seed=3)
    _, pipe_cpu = _train_setup("cpu")
    cpu = {k: {kk: v.cpu() for kk, v in b.items()}
           for k, b in out["params"].items()}
    x = np.random.default_rng(2).random((4, 32, 32, 3)).astype(np.float32)
    for datapath in ("int", "f32"):
        got = pipe.deploy(out["params"], datapath=datapath)(x)
        want = pipe_cpu.deploy(cpu, datapath=datapath)(x)
        assert torch.equal(got.cpu(), want), datapath
    # QAT features on every frame where no pre-activation lies on a grid
    # midpoint (resnet9.midpoint_ties); at most one tied frame of 4, within
    # one code of the last block's grid
    xt = torch.from_numpy(x).to(card)
    ties = sum(resnet9.midpoint_ties(out["params"], v, pipe.qcfg, 8)
               for v in (xt, torch.flip(xt, dims=[2]))) > 0
    got = pipe.deploy(out["params"], "int")(x)
    want = pipe.features(out["params"], x)
    bad = ~torch.isclose(got, want, rtol=1e-5, atol=1e-6).all(dim=1)
    assert not (bad & ~ties).any(), (bad, ties)
    assert int(ties.sum()) <= 1, ties
    code = pipe.qcfg.layer(resnet9.plan(8)[-1]["name"]).act.scale
    assert ((got - want).abs()[ties] <= code).all()


# ---------------------------------------------------------------------------
# compiled LM decode (lm-tiny) on the card
# ---------------------------------------------------------------------------
LM_BUCKETS = (1, 2, 4, 8)
LM_CAPS = (8, 16)


@pytest.fixture(scope="module")
def lm_tiny():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.serve.decode import build_decode_artifact

    cfg = get_config("lm-tiny")
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                            device="cuda")
    arts = {dp: build_decode_artifact(params, cfg, datapath=dp,
                                      capacities=LM_CAPS, device="cuda")
            for dp in ("int", "f32")}
    for art in arts.values():
        art.warmup(LM_BUCKETS)
    return cfg, params, arts


def _lm_feeds(cfg, batch, cap, seed):
    from repro_torch.models import lm

    feeds = lm.example_decode_feeds(cfg, batch=batch, capacity=cap, seed=seed)
    return {k: torch.as_tensor(v, device="cuda") for k, v in feeds.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", LM_BUCKETS)
@pytest.mark.parametrize("cap", LM_CAPS)
def test_lm_tiny_replay_equals_eager_and_ref(lm_tiny, bucket, cap):
    """Every warmed (bucket, capacity) of the int and f32 decode artifacts:
    the replayed CUDA graph == the eager lowered function ==
    ``decode_step_ref`` on the card, bit for bit, and the int step
    launches ``mvau_int`` twice."""
    from repro_torch.models import lm

    cfg, params, arts = lm_tiny
    feeds = _lm_feeds(cfg, bucket, cap, seed=bucket + cap)
    xs = [feeds[k] for k in arts["int"].dm.input_names]
    caches = xs[2:]
    logits, new = lm.decode_step_ref(params, feeds["tokens"], feeds["pos"],
                                     caches, cfg)
    want = [logits] + new
    base = arts["int"].trace_count()
    for dp, art in arts.items():
        B.reset_launch_counts()
        replay = art.dm(*xs)
        if dp == "int":
            assert B.launch_counts["mvau_int"] == 2
        eager = art.dm.apply(*xs)
        for a, b, c in zip(replay, eager, want):
            assert torch.equal(a, b) and torch.equal(a, c)
    assert arts["int"].trace_count() == base


@pytest.mark.cuda
def test_lm_tiny_row_is_bucket_invariant(lm_tiny):
    """One sequence's row is the same stepped alone (bucket 1) and beside
    seven others (bucket 8)."""
    cfg, _, arts = lm_tiny
    feeds = _lm_feeds(cfg, 8, 16, seed=21)
    dm = arts["int"].dm
    full = dm(*[feeds[k] for k in dm.input_names])
    for b in (0, 3, 7):
        one = dm(*[feeds[k][b:b + 1] for k in dm.input_names])
        for a, c in zip(full, one):
            assert torch.equal(a[b:b + 1], c)


def _levels(acc, n, levels, shared, rng):
    """(n, levels) int32 tables sorted ascending over the range of ``acc``
    (an (M, n) int64 product): a third of the levels copied from the
    accumulators themselves (so some land exactly on a level), runs of
    equal levels, and, where there is room, the int32 extremes; one row
    shared by every column, or one per column."""
    lo, hi = int(acc.min()) - 3, int(acc.max()) + 3
    rows = 1 if shared else n
    t = rng.integers(lo, hi + 1, size=(rows, levels))
    flat = acc.reshape(-1)
    for r in range(rows):
        on = rng.integers(0, levels, size=levels // 3)
        t[r, on] = flat[rng.integers(0, flat.size, size=on.size)]
        if levels >= 8:
            t[r, :4] = t[r, 4]                   # a run of equal levels
            t[r, -2] = np.iinfo(np.int32).max
            t[r, 0] = np.iinfo(np.int32).min
    t = np.sort(t, axis=1).astype(np.int32)
    return np.broadcast_to(t, (n, levels)).copy() if shared else t


# (K, N, packed int4 weights) at each M: lm-tiny's w_down, its int4 form,
# a ragged N, and a long K with N past one 128-column tile
LM_SHAPE_CASES = ((96, 64, False), (96, 64, True), (96, 20, False),
                  (1440, 160, False), (1440, 160, True))


@pytest.mark.cuda
@pytest.mark.parametrize("m", sorted({1, 3, 8, KM.SMALL_M_ROWS,
                                      KM.SMALL_M_ROWS + 1, 64}))
@pytest.mark.parametrize("levels", [15, 64, 65, 255])
@pytest.mark.parametrize("shared", [True, False])
def test_mvau_int_at_the_lm_shape_equals_plain(card, m, levels, shared):
    """The int8 GEMM form on both sides of the route limit (the small-M
    kernel up to ``SMALL_M_ROWS`` rows, the wgmma kernel past it) at
    lm-tiny's w_down (K 96, N 64) and its packed-int4 form, a ragged N of
    20 and K 1,440 x N 160: dense (15, 64) and searched (65, 255) tables,
    one shared by every column (as the lowering expands it) or one per
    column, with accumulators on a level, runs of equal levels and the
    int32 extremes; bit for bit against the plain version, one launch of
    the route the shapes pick."""
    rng = np.random.default_rng(1000 * m + levels + int(shared))
    route = KM.int8_gemm_route(m, levels)
    for k, n, packed in LM_SHAPE_CASES:
        lim = 8 if packed else 128
        x = rng.integers(-128, 128, size=(m, k))
        w = rng.integers(-lim, lim, size=(k, n))
        t = _levels(x @ w, n, levels, shared, rng)
        wt = (Q.pack_int4(torch.from_numpy(w.astype(np.int32))) if packed
              else torch.from_numpy(w.astype(np.int8))).to(card)
        xc, tc = _t(x.astype(np.int8), card), _t(t, card)
        before = dict(B.launch_counts)
        got = KM.mvau_int(xc, wt, tc, -128, packed)
        delta = {k: B.launch_counts[k] - before[k] for k in before}
        assert delta["mvau_int"] == 1
        assert delta["mvau_int_small_m"] == int(route == "small_m")
        assert torch.equal(got, KM.mvau_int_plain(xc, wt, tc, -128, packed)), \
            (k, n, packed)


@pytest.mark.cuda
def test_mvau_int_small_m_is_bucket_invariant_and_captures(card):
    """Rows of x give the same bits at M 1, 8, the route limit and one row
    past it (the wgmma route); a launch of the small-M route captured in a
    CUDA graph replays what an eager launch computes, on new inputs."""
    from repro_torch.core.cudagraph import CapturedGraph

    rng = np.random.default_rng(7)
    mx = KM.SMALL_M_ROWS + 1
    x = _t(rng.integers(-128, 128, size=(mx, 96)).astype(np.int8), card)
    w = _t(rng.integers(-128, 128, size=(96, 64)).astype(np.int8), card)
    acc = x.cpu().numpy().astype(np.int64) @ w.cpu().numpy().astype(np.int64)
    t = _t(_levels(acc, 64, 255, True, rng), card)
    full = KM.mvau_int(x, w, t, -128)
    for m in (1, 8, KM.SMALL_M_ROWS):
        assert torch.equal(KM.mvau_int(x[:m].contiguous(), w, t, -128),
                           full[:m])
    xs = x[:8].contiguous()
    g = CapturedGraph(lambda v: KM.mvau_int(v, w, t, -128), (xs,),
                      pool=torch.cuda.graph_pool_handle(),
                      stream=torch.cuda.Stream(card))
    assert g.launches == {"mvau_int": 1, "mvau_int_small_m": 1}
    xs.copy_(x[8:16])
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(g.outputs[0], KM.mvau_int(x[8:16].contiguous(), w, t,
                                                 -128))
    assert torch.equal(g.outputs[0], full[8:16])


# ---------------------------------------------------------------------------
# LM training on the card
# ---------------------------------------------------------------------------
LM_TRAIN_LR = 3e-4


def _lm_train(dev, layers=2):
    """qwen2.5-3b at full width, ``layers`` deep: parameters from a CPU
    generator (the same on every device), its step and a batch maker."""
    import dataclasses

    from repro_torch.data.synthetic import token_lm_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=layers)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device=dev)

    def batch(i, size=2, seq=16):
        b = token_lm_batch(i, size, seq, cfg.vocab)
        return {k: torch.from_numpy(v).reshape(cfg.grad_accum, -1, seq).to(dev)
                for k, v in b.items()}

    return (params, adamw_init(params),
            make_train_step(cfg, lr=LM_TRAIN_LR), batch)


@pytest.mark.cuda
def test_lm_train_step_card_against_cpu(card):
    """One full-width step (2 layers, bf16 compute) on the card and on the
    CPU from the same parameters.  The two devices' bf16 GEMMs sum in other
    orders, so a bf16 rounding (2^-8 relative) now and then falls the
    other way, as between the port and JAX on the CPU: the loss within
    rtol 1e-4 (7.2e-6 measured on an H100), the first moment (0.1 x the
    clipped gradients) within 2^-6 of each leaf's largest value (0.0083
    measured, the CPU tests' gradient tolerance), every parameter within
    2 lr: AdamW's first update is close to lr * sign(g), and where a
    gradient lies within that noise of 0 the two signs may disagree."""
    from repro_torch.tree import tree_flatten, tree_paths

    got = {}
    for dev in (card, torch.device("cpu")):
        params, opt, step, batch = _lm_train(dev)
        p, o, loss = step(params, opt, batch(0))
        got[dev.type] = (float(loss), tree_flatten(p)[0],
                         tree_flatten(o.m)[0], tree_paths(p))
    (lg, pg, mg, paths), (lc, pc, mc, _) = got["cuda"], got["cpu"]
    print(f"card {lg!r} cpu {lc!r} relative {abs(lg - lc) / lc:.3g}")
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for path, a, b, ma, mb in zip(paths, pg, pc, mg, mc):
        dm = float((ma.cpu() - mb).abs().max() / mb.abs().max())
        dp = float((a.cpu() - b).abs().max())
        print(f"{path}: m {dm:.3g} of max, params {dp / LM_TRAIN_LR:.3g} lr")
        assert dm <= 2 ** -6, path
        assert dp <= 2 * LM_TRAIN_LR * (1 + 1e-3), path


@pytest.mark.cuda
def test_lm_train_two_runs_bit_for_bit(card):
    """Two same-seed runs of 2 full-width steps: losses and every
    parameter and moment bit for bit (no atomics on the path: the
    embedding's backward accumulates each row's tokens in one order)."""
    from repro_torch.tree import tree_flatten

    runs = []
    for _ in range(2):
        params, opt, step, batch = _lm_train(card)
        losses = []
        for i in range(2):
            params, opt, loss = step(params, opt, batch(i, 4, 32))
            losses.append(float(loss))
        runs.append((losses, tree_flatten((params, opt.m, opt.v))[0]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.cuda
def test_lm_train_launcher_resume_equals_straight(card, tmp_path, capsys):
    """``launch.train.main`` on the card (its default device): 2 steps, a
    checkpoint, a resume and 1 step give the loss of 3 straight steps, bit
    for bit."""
    from repro_torch.launch import train

    smoke = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "2", "--seq",
             "16"]
    straight = train.main(smoke + ["--steps", "3"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train.main(smoke + ["--steps", "2"] + ck)
    resumed = train.main(smoke + ["--steps", "1", "--resume"] + ck)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed == straight


# ---------------------------------------------------------------------------
# The recurrent-state and vision-language families: decode graphs, qmatmul
# at the ragged in-projection widths
# ---------------------------------------------------------------------------
# (config, layer slots of the full-width copy, qmatmul launches a step):
# mamba2's 2 Mamba2 blocks (tied head); zamba2's first 6 slots, five Mamba2
# blocks and one invocation of the shared block, with the untied head;
# qwen2-vl's 2 M-RoPE blocks and its untied head
FAMILY_GRAPHS = [("mamba2-780m", 2, 4), ("zamba2-7b", 6, 18),
                 ("qwen2-vl-7b", 2, 15)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch,slots,per_step", FAMILY_GRAPHS)
def test_family_decode_graph_equals_eager(card, arch, slots, per_step, bits):
    """A full-width copy of the config's first layer slots at w8 and w4:
    the captured decode step gives the eager step's logits and greedy
    tokens bit for bit over a prompt and generated tokens (the SSM state
    and the shared block's KV written in place, the lengths copied back);
    ``generate`` twice through one graph, ``reset()`` between, gives the
    eager tokens both times; the graph records ``per_step`` qmatmul
    launches."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import (GraphedDecodeStep, greedy,
                                          quantize_tree_for_serving)
    from repro_torch.models import lm
    from repro_torch.models.common import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=slots)
    params = lm.init_params(torch.Generator(device=card).manual_seed(0), cfg)
    q = lm.with_head_copy(quantize_tree_for_serving(params, bits), cfg)
    del params
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 4))
    step = GraphedDecodeStep(q, cfg, 2, 12)
    assert step.graph.launches == {"qmatmul": per_step}
    cache = lm.init_cache(cfg, 2, 12)
    tok = None
    for t in range(9):
        feed = (torch.as_tensor(prompt[:, t:t + 1], dtype=torch.int32,
                                device=card) if t < 4 else tok)
        logits, cache = lm.decode_step(q, feed, cache, cfg)
        nxt = greedy(logits, cfg)
        step.step(feed)
        assert torch.equal(step.logits, logits), (arch, bits, t)
        assert torch.equal(step.tokens[:, 0], nxt), (arch, bits, t)
        tok = nxt[:, None]
    want = generate(q, cfg, prompt, 5, graph=False)
    assert torch.equal(generate(q, cfg, prompt, 5), want)
    assert torch.equal(generate(q, cfg, prompt, 5), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(4, 1536, 6448), (1, 1536, 6448),
                                   (4, 3584, 14576), (3, 3584, 14576)])
def test_qmatmul_at_the_ragged_in_proj_widths(card, m, k, n, bits):
    """mamba2's and zamba2's in-projections (N = 6448 and 14576, not
    multiples of the 64- or 128-column tile) against the plain version at
    the tolerance of ``test_qmatmul_kernel_equals_plain``; two launches
    bit for bit."""
    from repro_torch.kernels import qmatmul as KQ

    x, w, s, codes = _qmm_inputs(m, k, n, bits, torch.bfloat16, card,
                                 m + k + n)
    got = KQ.qmatmul(x, w, s, bits)
    want = KQ.qmatmul_plain(x, w, s, bits)
    scale = (x.float().abs() @ codes.float().abs()) * s
    tol = 2e-5 * scale + want.float().abs() * 2.0 ** -7
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert torch.equal(got, KQ.qmatmul(x, w, s, bits))


# ---------------------------------------------------------------------------
# MoE, MLA and the encoder-decoder: decode graphs, qmatmul at whisper's
# encoder rows and an expert's single row
# ---------------------------------------------------------------------------
# (config, qmatmul launches a decode step at reduce_config size, 2 layers):
# grok 2 x (4 + 4 experts x 3) + the untied head; arctic the same plus its
# dense residual's 3 a layer; minicpm3 2 x 7 + the head; whisper 2 x 8
MMA_GRAPHS = [("grok-1-314b", 33), ("arctic-480b", 39), ("minicpm3-4b", 15),
              ("whisper-tiny", 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch,per_step", MMA_GRAPHS)
def test_moe_mla_whisper_decode_graph_equals_eager(card, arch, per_step,
                                                   bits):
    """Each config at ``reduce_config`` size in bf16, at w8 and w4: the
    captured decode step gives the eager step's logits and greedy tokens
    bit for bit (MoE dispatch, MLA's latent rows, whisper's cross
    attention inside the graph); the graph records ``per_step`` qmatmul
    launches.  whisper decodes two utterances in turn through one graph
    (``reset(cross)`` between): each equals its eager run, and the second
    differs from the first."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import (GraphedDecodeStep, greedy,
                                          init_serving_params, model_module)
    from repro_torch.models.common import get_config
    from repro_torch.models.testing import reduce_config

    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              compute_dtype="bfloat16")
    mod = model_module(cfg)
    q = mod.with_head_copy(init_serving_params(
        torch.Generator(device=card).manual_seed(0), cfg, bits), cfg)
    crosses = [None]
    if cfg.family == "audio":
        crosses = []
        for seed in (1, 2):
            frames = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                 generator=torch.Generator(
                                     device=card).manual_seed(seed),
                                 device=card)
            crosses.append(mod.build_cross_cache(
                q, mod.encode(q, frames, cfg), cfg))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 4))
    step = GraphedDecodeStep(q, cfg, 2, 12)
    assert step.graph.launches == {"qmatmul": per_step}
    outs = []
    for cross in crosses:
        step.reset(cross)
        cache = mod.init_cache(cfg, 2, 12)
        if cross is not None:
            for n in ("k", "v"):
                cache["cross"][n].copy_(cross[n])
        tok = None
        for t in range(9):
            feed = (torch.as_tensor(prompt[:, t:t + 1], dtype=torch.int32,
                                    device=card) if t < 4 else tok)
            logits, cache = mod.decode_step(q, feed, cache, cfg)
            nxt = greedy(logits, cfg)
            step.step(feed)
            assert torch.equal(step.logits, logits), (arch, bits, t)
            assert torch.equal(step.tokens[:, 0], nxt), (arch, bits, t)
            tok = nxt[:, None]
        want = generate(q, cfg, prompt, 5, graph=False, cross=cross)
        assert torch.equal(generate(q, cfg, prompt, 5, cross=cross), want)
        outs.append(step.logits.clone())
    if len(outs) == 2:
        assert not torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(6000, 384, 384), (6000, 384, 1536),
                                   (6000, 1536, 384), (1, 7168, 4864),
                                   (1, 4864, 7168)])
def test_qmatmul_at_whisper_encoder_rows_and_expert_rows(card, m, k, n,
                                                         bits):
    """whisper's encoder and cross-cache products (M = 4 utterances x
    1,500 frames, on the many-row kernel) and an arctic expert's at its
    capacity of one row (on the decode kernel): against the plain version
    at the tolerance of ``test_qmatmul_kernel_equals_plain``, bit for bit
    on integer inputs (every partial sum an integer below 2^24), two
    launches bit for bit."""
    from repro_torch.kernels import qmatmul as KQ

    x, w, s, codes = _qmm_inputs(m, k, n, bits, torch.bfloat16, card,
                                 m + k + n)
    before = B.launch_counts["qmatmul_rows"]
    got = KQ.qmatmul(x, w, s, bits)
    assert B.launch_counts["qmatmul_rows"] == before + int(m > 1)
    want = KQ.qmatmul_plain(x, w, s, bits)
    scale = (x.float().abs() @ codes.float().abs()) * s
    tol = 2e-5 * scale + want.float().abs() * 2.0 ** -7
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert torch.equal(got, KQ.qmatmul(x, w, s, bits))
    xi = torch.randint(-16, 17, (m, k), generator=torch.Generator(
        device=card).manual_seed(m), device=card).to(torch.bfloat16)
    half = torch.full((n,), 0.5, device=card)
    assert torch.equal(KQ.qmatmul(xi, w, half, bits),
                       KQ.qmatmul_plain(xi, w, half, bits))


# ---------------------------------------------------------------------------
# qmatmul's many-row route: qmm_rows_kernel
# ---------------------------------------------------------------------------
_ROWS_SHAPES = [(65, 37, 66), (130, 300, 264), (1000, 1536, 66),
                (6000, 300, 1536), (9, 300, 264), (63, 1536, 264),
                (1000, 37, 1536), (6000, 1536, 264), (200, 384, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", _ROWS_SHAPES)
def test_qmatmul_rows_kernel_equals_plain(card, m, k, n, bits, xdt):
    """The many-row kernel, forced and at every tile height, on ragged M, K
    and N on both sides of the crossover (9 x 264, 63 x 264 and 200 x 384
    below ``ROWS_MN``):
    within ``check_qmatmul``'s tolerance, 2e-5 of sum_k |bf16(x)| |code|
    scale, plus one bf16 rounding of the output for bf16 x.  K 37 and 300
    take the converting x copies, N 66 at w8 the byte copies of codes."""
    from repro_torch.kernels import qmatmul as KQ

    dt = getattr(torch, xdt)
    x, w, s, codes = _qmm_inputs(m, k, n, bits, dt, card, m * k + n + bits)
    want = KQ.qmatmul_plain(x, w, s, bits)
    tol = _qmm_tolerance(x, codes, s, want)
    for bm in (None, *KQ.ROWS_BMS):
        before = dict(B.launch_counts)
        got = KQ.qmatmul(x, w, s, bits, route="rows", bm=bm)
        assert B.launch_counts["qmatmul_rows"] == before["qmatmul_rows"] + 1
        assert B.launch_counts["qmatmul"] == before["qmatmul"] + 1
        assert got.dtype == dt and got.shape == want.shape
        assert bool(((got.float() - want.float()).abs() <= tol).all()), bm


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_qmatmul_rows_kernel_exact_on_integers(card, bits, xdt):
    """Integer-valued x and small codes: every partial sum is an integer
    below 2^24, so the many-row kernel equals the plain version bit for
    bit, at every tile height."""
    from repro_torch.kernels import qmatmul as KQ

    dt = getattr(torch, xdt)
    for m, k, n in ((65, 37, 66), (1000, 1536, 264), (6000, 384, 1536),
                    (257, 2048, 256)):
        x, w, s, _ = _qmm_inputs(m, k, n, bits, dt, card, k + n,
                                 exact=True)
        s = torch.full_like(s, 0.5)
        want = KQ.qmatmul_plain(x, w, s, bits)
        for bm in KQ.ROWS_BMS:
            assert torch.equal(KQ.qmatmul(x, w, s, bits, route="rows",
                                          bm=bm), want), (m, k, n, bm)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_rows_repeats_and_replays_bit_for_bit(card, bits):
    """No atomics and a fixed order of every sum: two launches give
    identical bits, and a captured graph's replay (the output allocated
    inside the capture) equals the eager call."""
    from repro_torch.core.cudagraph import CapturedGraph
    from repro_torch.kernels import qmatmul as KQ

    x, w, s, _ = _qmm_inputs(6000, 384, 1536, bits, torch.bfloat16, card, 7)
    first = KQ.qmatmul(x, w, s, bits)
    assert torch.equal(first, KQ.qmatmul(x, w, s, bits))
    g = CapturedGraph(lambda v: KQ.qmatmul(v, w, s, bits), (x.clone(),),
                      pool=None, stream=torch.cuda.Stream(card))
    assert g.launches == {"qmatmul": 1, "qmatmul_rows": 1}
    before = B.launch_counts["qmatmul_rows"]
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(g.outputs[0], first)
    assert B.launch_counts["qmatmul_rows"] == before + 1


@pytest.mark.cuda
def test_qmatmul_routes_count_their_launches(card):
    """Above the crossover every call launches the many-row kernel once
    (``qmatmul_rows`` and ``qmatmul`` each move by 1), at decode shapes the
    decode kernel (``qmatmul`` alone moves by 1); the profiler sees one
    kernel of the route's name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import qmatmul as KQ

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    m_rows = -(-KQ.ROWS_MN // 2048)           # the first rows shape, N 2048
    for m, k, n, kernel in ((4, 2048, 256, "qmm_kernel"),
                            (8, 2048, 11008, "qmm_kernel"),
                            (m_rows - 1, 2048, 2048, "qmm_kernel"),
                            (m_rows, 2048, 2048, "qmm_rows_kernel"),
                            (6000, 1536, 384, "qmm_rows_kernel")):
        rows = kernel == "qmm_rows_kernel"
        assert KQ.qmm_route(m, k, n, sms, 8) == ("rows" if rows
                                                 else "decode")
        x, w, s, _ = _qmm_inputs(m, k, n, 8, torch.bfloat16, card, m)
        KQ.qmatmul(x, w, s, 8)
        torch.cuda.synchronize()
        before = dict(B.launch_counts)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            KQ.qmatmul(x, w, s, 8)
            torch.cuda.synchronize()
        assert B.launch_counts["qmatmul"] == before["qmatmul"] + 1
        assert (B.launch_counts["qmatmul_rows"]
                == before["qmatmul_rows"] + int(rows))
        names = [e.key for e in prof.key_averages() if "qmm" in e.key]
        assert len(names) == 1 and (kernel + "<") in names[0], names


# ---------------------------------------------------------------------------
# distribution: one rank over NCCL, two ranks on the one card over gloo
# ---------------------------------------------------------------------------
def _dist_smoke(tmp_path, *args):
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = tmp_path / "ds"
    r = subprocess.run([sys.executable, str(root / "tools" / "dist_smoke.py"),
                        *args, "--out", str(out)], capture_output=True,
                       text=True, timeout=600)
    summary = json.loads((out / "summary.json").read_text())
    assert r.returncode == 0 and summary["ok"], (summary["failed"],
                                                 r.stderr[-3000:])
    return summary


@pytest.mark.cuda
def test_dist_one_rank_nccl(card, tmp_path):
    """One rank over NCCL: the 1x1 mesh, the sharded train steps (reduced
    qwen2.5-3b and the MoE grok-1-314b, its dispatches too) and the w8
    and w4 decode bit for bit the plain ones, restore_resharded (the
    checks need no collective of two ranks, so none is deferred).  The
    MoE step's first moments within 1e-4 of each leaf's largest: the
    DTensor lookup's ``embedding`` backward sums a repeated token's rows
    in another order than the plain ``table[tokens]``'s."""
    s = _dist_smoke(tmp_path, "--spawn", "1", "--backend", "nccl")
    assert s["world"] == 1 and not s["deferred"]
    archs = s["checks"]["train"]["archs"]
    assert archs["qwen2.5-3b"]["meshes"]["1x1_acc"]["bitforbit"]
    moe = archs["grok-1-314b"]["meshes"]["1x1_acc"]
    assert moe["bitforbit"] and moe["dispatch_bitforbit"]
    assert max(moe["m_err"].values()) <= 1e-4, moe["m_err"]
    assert all(r["logit_err"] == 0 for r in
               s["checks"]["decode"]["bits"].values())
    assert s["checks"]["restore"]["ok"]
    assert s["launches"]["qmatmul"] > 0


@pytest.mark.cuda
def test_dist_two_ranks_one_card_gloo(card, tmp_path):
    """Two ranks spawned on the one card over gloo: the sharded head over
    the int artifact bit for bit, the checks gloo can run on CUDA tensors,
    and the kernels on the sharded runs."""
    s = _dist_smoke(tmp_path, "--spawn", "2", "--backend", "gloo")
    assert s["world"] == 2 and s["checks"]["head"]["ok"]
    assert s["launches"]["mvau_int"] > 0 and s["launches"]["mvau_int_gap"] > 0
    if "decode" not in s["deferred"]:
        assert s["launches"]["qmatmul"] > 0
