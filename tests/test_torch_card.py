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
    as int16; 8-bit unsigned activations) run every MVAU on the CUDA-core
    kernel with its im2col folded in, and equal the CPU run bit for bit."""
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
    labels = {(r["op"], r["kernel"]) for r in dm.dispatch_table()
              if r["op"] in ("im2col", "mvau_int")}
    assert labels == {("im2col", "fused-cuda-core"),
                      ("mvau_int", "fused-cuda-core")}
    assert len(dm.apply.folded) == 9 and "r2b_res" in dm.apply.folded
    before = dict(B.launch_counts)
    f = dm(x)
    assert B.launch_counts["mvau_int"] - before["mvau_int"] == 8
    assert B.launch_counts["gap"] - before["gap"] == 1
    assert B.launch_counts["mvau_int_gap"] == before["mvau_int_gap"]
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
                     "mvau_int_wide": int(not int8_ok), "mvau": 0,
                     "gap": 1 - int(fused), "qmatmul": 0}
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
                     "mvau": 0, "gap": 0, "qmatmul": 0}
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
