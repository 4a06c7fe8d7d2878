"""The port's fixed-point grid against the JAX reference, bit for bit:
exhaustive code sweeps of quantize/dequantize/fake_quant, threshold tables
and counts (dense and binary-search forms), int4 packing, storage sizes and
the config digests."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402

SPECS = [(4, 2, False), (6, 5, True), (8, 4, True), (8, 0, False),
         (3, 1, True), (12, 8, True), (16, 8, False)]


def _sweep(spec):
    """Every grid point, every midpoint and its float32 neighbours, and
    values beyond both saturation edges."""
    q = np.arange(spec.qmin - 3, spec.qmax + 4, dtype=np.float64)
    mids = (q + 0.5) * spec.scale
    vals = np.concatenate([q * spec.scale, mids]).astype(np.float32)
    vals = np.concatenate([vals, np.nextafter(vals, np.float32(np.inf)),
                           np.nextafter(vals, np.float32(-np.inf))])
    rng = np.random.default_rng(0)
    rand = rng.uniform(spec.min_value * 1.5 - 1, spec.max_value * 1.5 + 1,
                       size=4096).astype(np.float32)
    return np.concatenate([vals, rand])


@pytest.mark.parametrize("bits,frac,signed", SPECS)
def test_quantize_dequantize_fake_quant_bitforbit(bits, frac, signed):
    js = JQ.FixedPointSpec(bits, frac, signed)
    ts = TQ.FixedPointSpec(bits, frac, signed)
    x = _sweep(js)
    qj = np.asarray(JQ.quantize(jnp.asarray(x), js))
    qt = TQ.quantize(torch.from_numpy(x), ts).numpy()
    assert qt.dtype == qj.dtype == np.int32
    np.testing.assert_array_equal(qt, qj)
    dj = np.asarray(JQ.dequantize(jnp.asarray(qj), js))
    dt = TQ.dequantize(torch.from_numpy(qt), ts).numpy()
    assert dt.dtype == dj.dtype == np.float32
    np.testing.assert_array_equal(dt, dj)
    fj = np.asarray(JQ.fake_quant(jnp.asarray(x), js))
    ft = TQ.fake_quant(torch.from_numpy(x), ts).numpy()
    np.testing.assert_array_equal(ft.view(np.int32), fj.view(np.int32))


@pytest.mark.parametrize("bits,frac,signed", SPECS)
def test_thresholds_and_multithreshold_match_quantize(bits, frac, signed):
    js = JQ.FixedPointSpec(bits, frac, signed)
    ts = TQ.FixedPointSpec(bits, frac, signed)
    tj, tt = JQ.thresholds_for(js), TQ.thresholds_for(ts)
    np.testing.assert_array_equal(tt.view(np.int32), tj.view(np.int32))
    x = _sweep(js)
    mt = TQ.multithreshold(torch.from_numpy(x), torch.from_numpy(tt),
                           out_base=ts.qmin).numpy()
    np.testing.assert_array_equal(
        mt, TQ.quantize(torch.from_numpy(x), ts).numpy().astype(np.float32))
    mj = np.asarray(JQ.multithreshold(jnp.asarray(x), jnp.asarray(tj),
                                      js.qmin, 0.5, -0.25))
    mt = TQ.multithreshold(torch.from_numpy(x), torch.from_numpy(tt),
                           ts.qmin, 0.5, -0.25).numpy()
    np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("levels", [3, 15, 63, 64, 255, 1000])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_threshold_counts_per_channel_and_tensor(levels, sort, dtype):
    """Dense compare below 64 levels or on unsorted tables, binary search on
    sorted tables from 64 levels: both equal the reference."""
    rng = np.random.default_rng(levels)
    t = rng.integers(-300, 300, size=(6, levels)).astype(dtype)
    if sort:
        t = np.sort(t, axis=-1)
    x = rng.integers(-350, 350, size=(2, 5, 6)).astype(dtype)
    for tt in (t, t[0]):
        want = np.asarray(JQ.threshold_counts(jnp.asarray(x), jnp.asarray(tt)))
        got = TQ.threshold_counts(torch.from_numpy(x), torch.from_numpy(tt))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_pack_unpack_int4_exhaustive():
    codes = np.array([[a, b] for a in range(-8, 8) for b in range(-8, 8)],
                     np.int32).reshape(16, 32)
    pj = np.asarray(JQ.pack_int4(jnp.asarray(codes)))
    pt = TQ.pack_int4(torch.from_numpy(codes))
    assert pt.dtype == torch.int8 and tuple(pt.shape) == (16, 16)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(TQ.unpack_int4(pt).numpy(), codes)
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(8, 32)
    np.testing.assert_array_equal(
        TQ.unpack_int4(torch.from_numpy(every_byte)).numpy(),
        np.asarray(JQ.unpack_int4(jnp.asarray(every_byte))))
    with pytest.raises(ValueError):
        TQ.pack_int4(torch.zeros((2, 3), dtype=torch.int32))


@pytest.mark.parametrize("bits", [1, 2, 4, 5, 8, 9, 16, 17, 32])
def test_storage_dtype_and_bytes(bits):
    js = JQ.FixedPointSpec(bits, 0, signed=False)
    ts = TQ.FixedPointSpec(bits, 0, signed=False)
    assert TQ.storage_dtype(ts).itemsize == np.dtype(JQ.storage_dtype(js)).itemsize
    assert TQ.storage_bytes_per_element(ts) == JQ.storage_bytes_per_element(js)
    assert TQ.storage_bytes_per_element(None) == JQ.storage_bytes_per_element(None)


def test_configs_and_plan_digest_match():
    assert TQ.QuantConfig.paper_w6a4() == TQ.QuantConfig.grid_point(6, 4)
    for w, a in ((6, 4), (8, 8), (4, 2)):
        tj, tt = JQ.QuantConfig.grid_point(w, a), TQ.QuantConfig.grid_point(w, a)
        assert (tt.weight.describe(), tt.act.describe()) == \
            (tj.weight.describe(), tj.act.describe())
    layers = (("c1", (4, 4)), ("c0", (8, 6)))
    pj = JQ.LayerQuantPlan(layers, default=(6, 4))
    pt = TQ.LayerQuantPlan(layers, default=(6, 4))
    assert pt.digest() == pj.digest() and pt.to_dict() == pj.to_dict()
    assert pt.quant_config().layer("c0").weight.describe() == \
        pj.quant_config().layer("c0").weight.describe()
