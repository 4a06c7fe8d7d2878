"""The int8 GEMM form at decode shapes, on the CPU against the JAX package.

On the card an int8 GEMM-form ``mvau_int`` of at most ``SMALL_M_ROWS``
rows runs ``mvau_small_m_kernel`` instead of the wgmma kernel
(``kernels.mvau.int8_gemm_route``).  Here:

* the route is a pure function of the shapes, with the limit the H100
  crossover set;
* ``kernels.mvau.mvau_int`` and ``kernels.ops.mvau_int`` (their plain
  versions on CPU tensors, the bar the kernel is held to on the card)
  equal the reference's ``ops.mvau_int`` (its Pallas kernel in interpret
  mode) bit for bit at the route's shapes: M 1-512, K 96 and 1,440, N 64
  and 160, 64 / 65 / 255 levels, shared and per-column tables, int8 and
  packed int4 weights, with accumulators on a level and runs of equal
  levels;
* ``ref.count_sorted_steps``, the small-M kernel's search arithmetic,
  equals the dense count and the reference's count on adversarial tables.

The kernel itself runs only on the card: ``tests/test_torch_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

I32 = np.iinfo(np.int32)


@pytest.mark.parametrize("m,levels,want", [
    (1, 255, "small_m"), (8, 255, "small_m"), (512, 255, "small_m"),
    (513, 255, "wgmma"), (4096, 15, "wgmma"), (1, 15, "small_m"),
    (8, 2048, "small_m"), (8, 2049, "wgmma"), (1, 65535, "wgmma")])
def test_int8_gemm_route(m, levels, want):
    """Up to 512 rows (the least H100 crossover of ``tools/probe_mvau_conv.py
    --only gemm``) with a table of at most 2,048 levels (16 rows of it in
    shared memory), the small-M kernel; else the wgmma kernel."""
    assert KM.SMALL_M_ROWS == 512 and KM.SMALL_M_MAX_LEVELS == 2048
    assert KM.int8_gemm_route(m, levels) == want


def _tables(acc, n, levels, shared, rng):
    """(n, levels) int32 tables sorted ascending over ``acc``'s range: a
    third of the levels copied from the accumulators, a run of equal
    levels; one row for every column, or one per column."""
    rows = 1 if shared else n
    t = rng.integers(int(acc.min()) - 3, int(acc.max()) + 4,
                     size=(rows, levels))
    flat = acc.reshape(-1)
    for r in range(rows):
        on = rng.integers(0, levels, size=levels // 3)
        t[r, on] = flat[rng.integers(0, flat.size, size=on.size)]
        t[r, 1:5] = t[r, 0]
    t = np.sort(t, axis=1).astype(np.int32)
    return np.broadcast_to(t, (n, levels)).copy() if shared else t


# (M, K, N, levels, shared table, packed int4 weights)
CASES = [(1, 96, 64, 255, True, False), (3, 96, 64, 255, False, True),
         (8, 96, 64, 65, True, False), (8, 96, 64, 64, False, False),
         (17, 1440, 160, 255, False, False), (33, 1440, 160, 65, True, True),
         (64, 96, 160, 255, True, False), (64, 1440, 64, 64, False, True),
         (512, 96, 64, 255, False, False), (513, 96, 20, 255, True, True)]


@pytest.mark.parametrize("m,k,n,levels,shared,packed", CASES)
def test_small_m_shapes_equal_reference(m, k, n, levels, shared, packed):
    rng = np.random.default_rng(m * 1000 + levels)
    lim = 8 if packed else 128
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-lim, lim, size=(k, n)).astype(np.int8)
    t = _tables(x.astype(np.int64) @ w.astype(np.int64), n, levels, shared,
                rng)
    wt = torch.from_numpy(w)
    if packed:
        wt = TQ.pack_int4(wt.to(torch.int32))
        wj = JQ.pack_int4(jnp.asarray(w.astype(np.int32)))
        assert np.array_equal(wt.numpy(), np.asarray(wj))
    else:
        wj = jnp.asarray(w)
    want = np.asarray(jops.mvau_int(jnp.asarray(x), wj, jnp.asarray(t),
                                    out_base=-128, interpret=True,
                                    w_packed=packed))
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    got = KM.mvau_int(xt, wt, tt, -128, packed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.mvau_int(xt, wt, tt, -128, w_packed=packed).numpy(), want)
    # a per-tensor (L,) table, as a graph stores it before prepare_tables
    if shared:
        np.testing.assert_array_equal(
            tops.mvau_int(xt, wt, tt[0], -128, w_packed=packed).numpy(),
            want)


def _adversarial(levels, kind, rng):
    if kind == "equal":
        return np.full((3, levels), 7, np.int32)
    if kind == "extremes":
        t = rng.integers(-50, 50, size=(3, levels))
        t[:, : (levels + 1) // 2] = I32.min
        t[:, -(levels // 3):] = I32.max
        return np.sort(t, axis=1).astype(np.int32)
    t = rng.integers(-50, 50, size=(3, levels))
    t[:, levels // 2:] = t[:, levels // 2:levels // 2 + 1]
    return np.sort(t, axis=1).astype(np.int32)


@pytest.mark.parametrize("levels", [0, 1, 2, 65, 100, 255, 256, 511])
@pytest.mark.parametrize("kind", ["runs", "equal", "extremes"])
def test_count_sorted_steps_equals_dense_count(levels, kind):
    """The search's step arithmetic on sorted tables of every awkward
    length, with runs of equal levels, all levels equal and the int32
    extremes, against accumulators on, between and beyond the levels:
    the dense count and the reference's ``quant.threshold_counts``."""
    rng = np.random.default_rng(levels)
    t = _adversarial(levels, kind, rng)
    acc = rng.integers(-60, 60, size=(5, 3))
    if levels:
        acc[0] = t[:, 0]
        acc[1] = t[:, -1]
        acc[2] = t[np.arange(3), rng.integers(0, levels, size=3)]
    acc = np.concatenate([acc, np.full((1, 3), I32.min),
                          np.full((1, 3), I32.max)]).astype(np.int32)
    dense = (acc[:, :, None] >= t[None]).sum(-1)
    got = ref.count_sorted_steps(torch.from_numpy(acc), torch.from_numpy(t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), dense)
    if levels:
        want = np.asarray(JQ.threshold_counts(jnp.asarray(acc),
                                              jnp.asarray(t)))
        np.testing.assert_array_equal(got.numpy(), want)
