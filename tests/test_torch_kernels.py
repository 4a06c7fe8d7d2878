"""The port's kernel layer on the CPU: each plain version (what a CPU tensor
takes, and the bar each CUDA kernel is held to on the card) against the
JAX package's Pallas kernel run in interpret mode, as the reference's own
kernel tests run it.  Integer paths and on-grid floats are compared bit
for bit; off-grid floats with the reference tests' tolerance (rtol 1e-5),
because float32 sums in another order may round differently.

The CUDA kernels themselves run only on the card: see
``tests/test_torch_card.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import gap as KG  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid(rng, shape, spec):
    q = rng.integers(spec.qmin, spec.qmax + 1, size=shape)
    return (q * spec.scale).astype(np.float32)


# ---------------------------------------------------------------------------
# integer MVAU (mvau_int_pallas)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,levels,xdt", [
    (7, 36, 8, 15, np.int32),      # odd M, K not a tile multiple
    (16, 130, 129, 15, np.int8),   # odd N: ragged last tile in both axes
    (5, 64, 32, 255, np.int32),    # 8-bit grid: chunked threshold loop
    (3, 40, 20, 512, np.int8),     # the dispatch gate's largest table
    (130, 27, 64, 15, np.int8),    # the first conv layer's K
])
def test_mvau_int_plain_equals_pallas(m, k, n, levels, xdt):
    rng = np.random.default_rng(m * k + levels)
    x = rng.integers(0, 16, size=(m, k)).astype(xdt)
    w = rng.integers(-32, 32, size=(k, n)).astype(np.int8)
    t = np.sort(rng.integers(-800, 3000, size=(n, levels)), axis=1
                ).astype(np.int32)
    want = np.asarray(jops.mvau_int(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(t), out_base=-3,
                                    interpret=True))
    got = KM.mvau_int(_t(x), _t(w), _t(t), out_base=-3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.mvau_int(_t(x).reshape(1, m, k), _t(w), _t(t), out_base=-3)
        .numpy()[0], want)


def test_mvau_int_full_int8_range():
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, size=(4, 64)).astype(np.int8)
    w = rng.integers(-128, 128, size=(64, 32)).astype(np.int8)
    t = np.sort(rng.integers(-4000, 4000, size=(32, 15)), axis=1).astype(np.int32)
    want = np.asarray(jops.mvau_int(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(t), out_base=-8,
                                    interpret=True))
    np.testing.assert_array_equal(
        KM.mvau_int(_t(x), _t(w), _t(t), out_base=-8).numpy(), want)


@pytest.mark.parametrize("levels", [15, 255])
def test_mvau_int_packed_int4(levels):
    rng = np.random.default_rng(levels)
    m, k, n = 6, 36, 32
    x = rng.integers(0, 16, size=(m, k)).astype(np.int32)
    w = rng.integers(-8, 8, size=(k, n)).astype(np.int32)
    t = np.sort(rng.integers(-500, 3000, size=(n, levels)), axis=1
                ).astype(np.int32)
    wp = np.asarray(JQ.pack_int4(jnp.asarray(w)))
    want = np.asarray(jops.mvau_int(jnp.asarray(x), jnp.asarray(wp),
                                    jnp.asarray(t), out_base=-3,
                                    interpret=True, w_packed=True))
    got = KM.mvau_int(_t(x), TQ.pack_int4(_t(w)), _t(t), out_base=-3,
                      w_packed=True)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# float MVAU (mvau_pallas)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,levels", [(1, 16, 8, 3), (7, 33, 130, 15),
                                          (130, 257, 129, 15)])
def test_mvau_plain_equals_pallas_on_grid(m, k, n, levels):
    rng = np.random.default_rng(m + k + n)
    x = _grid(rng, (m, k), JQ.FixedPointSpec(6, 5))
    w = _grid(rng, (k, n), JQ.FixedPointSpec(6, 5))
    t = np.sort(_grid(rng, (n, levels), JQ.FixedPointSpec(12, 8)), axis=1)
    want = np.asarray(jops.mvau(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(t), out_base=-4, out_scale=0.5,
                                out_bias=0.25, interpret=True))
    got = KM.mvau(_t(x), _t(w), _t(t), -4.0, 0.5, 0.25)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_mvau_off_grid_many_levels():
    """L = 255 off the grid: tolerance rtol 1e-5, as the reference's test."""
    rng = np.random.default_rng(3)
    spec = JQ.FixedPointSpec(8, 4, signed=True)
    t = JQ.thresholds_for(spec)
    x = rng.uniform(-2, 2, size=(9, 40)).astype(np.float32)
    w = rng.uniform(-2, 2, size=(40, 17)).astype(np.float32)
    want = np.asarray(jops.mvau(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(t), out_base=spec.qmin,
                                interpret=True))
    got = tops.mvau(_t(x), _t(w), _t(t), out_base=spec.qmin)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_mvau_int8_subpath_equals_pallas():
    """mvau_pallas's int8 x int8 -> int32 accumulate sub-path."""
    from repro.kernels.mvau import mvau_pallas

    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, size=(9, 70)).astype(np.int8)
    w = rng.integers(-128, 128, size=(70, 33)).astype(np.int8)
    t = np.sort(rng.integers(-20000, 20000, size=(33, 15)), axis=1
                ).astype(np.int32)
    want = np.asarray(mvau_pallas(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(t), out_base=1.0,
                                  out_scale=0.25, out_bias=-0.5,
                                  interpret=True))
    got = KM.mvau(_t(x), _t(w), _t(t), 1.0, 0.25, -0.5)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# GlobalAccPool (gap_pallas)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 5, 7, 24), (2, 4, 4, 64)])
@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_gap_int_bitforbit(shape, dtype):
    x = np.random.default_rng(5).integers(-100, 100, size=shape).astype(dtype)
    want = np.asarray(jops.gap(jnp.asarray(x), interpret=True))
    got = KG.gap(_t(x))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 32, 32, 64)])
def test_gap_float(shape):
    """Off the grid the f32 sums run in another order: rtol/atol 1e-5 (the
    reference test's tolerance).  On the grid: bit for bit."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 2, size=shape).astype(np.float32)
    want = np.asarray(jops.gap(jnp.asarray(x), interpret=True))
    got = KG.gap(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xg = _grid(rng, shape, JQ.FixedPointSpec(6, 2, signed=False))
    np.testing.assert_array_equal(
        KG.gap(_t(xg)).numpy(),
        np.asarray(jops.gap(jnp.asarray(xg), interpret=True)))


# ---------------------------------------------------------------------------
# the rest of ref.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("levels", [15, 128])
def test_fast_paths_equal_reference(levels):
    rng = np.random.default_rng(levels)
    x = rng.integers(0, 16, size=(3, 7, 40)).astype(np.int32)
    w = rng.integers(-32, 32, size=(40, 12)).astype(np.int32)
    t = np.sort(rng.integers(-500, 1500, size=(12, levels)), axis=1
                ).astype(np.int32)
    for exact in (True, False):
        np.testing.assert_array_equal(
            tref.mvau_int_fast(_t(x), _t(w), _t(t), 2, exact).numpy(),
            np.asarray(jref.mvau_int_fast(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(t), 2, exact)))
        np.testing.assert_array_equal(
            tref.matmul_int_fast(_t(x), _t(w), exact).numpy(),
            np.asarray(jref.matmul_int_fast(jnp.asarray(x), jnp.asarray(w),
                                            exact)))
    acc = rng.integers(-600, 1600, size=(4, 12)).astype(np.int32)
    np.testing.assert_array_equal(
        tref.threshold_counts_fast(_t(acc), _t(t)).numpy(),
        np.asarray(jref.threshold_counts_fast(jnp.asarray(acc), jnp.asarray(t))))
    np.testing.assert_array_equal(
        tref.multithreshold_int(_t(acc), _t(t), -1).numpy(),
        np.asarray(jref.multithreshold_int(jnp.asarray(acc), jnp.asarray(t),
                                           -1)))


@pytest.mark.parametrize("shift,bits,frac,signed", [
    (-3, 4, 2, False), (-1, 6, 3, True), (2, 8, 6, True), (0, 5, 2, False),
    (-8, 8, 0, True)])
def test_requantize_sweep(shift, bits, frac, signed):
    q = np.arange(-5000, 5000, dtype=np.int32)
    np.testing.assert_array_equal(
        tref.requantize(_t(q), shift, bits, frac, signed).numpy(),
        np.asarray(jref.requantize(jnp.asarray(q), shift, bits, frac, signed)))


def test_wrappers_validate_inputs_on_cpu():
    """CPU tensors take the plain versions; the dispatch labels off the card
    equal the reference's off-TPU labels.  On the card every ``mvau_int``
    node takes the fused kernel, however long its table (the reference's
    L <= 512 gate is a TPU choice; the CUDA kernel binary-searches): the
    tensor-core one for ``int8_ok`` codes, the CUDA-core one otherwise."""
    from repro.core.graph import Node as JNode
    from repro_torch.core.graph import Node as TNode

    for op, attrs, levels in (("mvau_int", {"acc_f32_exact": True}, 15),
                              ("mvau_int", {}, 15),
                              ("mvau_int", {"acc_f32_exact": True}, 600),
                              ("matmul_int", {"int8_ok": True}, None),
                              ("mvau", {}, None), ("global_acc_pool", {}, None),
                              ("requantize", {}, None), ("im2col", {}, None)):
        want = jops.kernel_dispatch(JNode(op, [], [], attrs), True, levels)
        assert tops.kernel_dispatch(TNode(op, [], [], attrs), True) == want
        on_card = tops.kernel_dispatch(TNode(op, [], [], attrs), False)
        assert "pallas" not in on_card
    assert tops.kernel_dispatch(TNode("mvau_int", [], [], {}), False) \
        == "fused-cuda-core"
    assert tops.kernel_dispatch(TNode("mvau_int", [], [],
                                      {"acc_f32_exact": True}), False) \
        == "fused-cuda-core"
    assert tops.kernel_dispatch(TNode("mvau_int", [], [],
                                      {"int8_ok": True}), False) \
        == "fused-cuda"
