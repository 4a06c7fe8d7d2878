"""The port's weight-only quantized matmul and serving quantization on the
CPU, against the JAX package.

* The plain ``qmatmul`` (what a CPU tensor takes, and the bar the CUDA
  kernel is held to on the card) against the Pallas kernel in interpret
  mode and against the reference's ``ref.qmatmul``, at the reference tests'
  shapes and tolerances (``tests/test_kernels.py``: rtol/atol 2e-2 for w8,
  whose bf16 outputs round, 1e-3 for w4, exact for small integer codes).
* ``quantize_dense_for_serving`` / ``quantize_tree_for_serving``: codes and
  scales equal the JAX package's bit for bit, w8 and w4.

The CUDA kernel itself runs only on the card: see ``tests/test_torch_card.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.steps import quantize_tree_for_serving as j_quantize_tree  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import get_config as j_get_config  # noqa: E402
from repro.models.testing import reduce_config as j_reduce  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import qmatmul as KQ  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch.steps import quantize_tree_for_serving  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _rand(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(1, 32, 16), (5, 130, 64), (128, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatmul_w8_plain_equals_pallas_and_ref(m, k, n, dtype):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(m * k + n)
    x = _rand(rng, (m, k))
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    s = _rand(rng, (n,), 0.001, 0.02)
    xj = jnp.asarray(x, jdt)
    pallas = jops.qmatmul(xj, jnp.asarray(w), jnp.asarray(s), bits=8,
                          interpret=True)
    want = jref.qmatmul(xj, jnp.asarray(w), jnp.asarray(s), bits=8)
    xt = _t(x).to(tdt)
    got = KQ.qmatmul(xt, _t(w), _t(s), bits=8)
    assert got.dtype == tdt
    for other in (pallas, want):
        np.testing.assert_allclose(_f32(got), _f32(other), rtol=2e-2,
                                   atol=2e-2)
    np.testing.assert_array_equal(_f32(got), _f32(tref.qmatmul(xt, _t(w),
                                                               _t(s), 8)))


@pytest.mark.parametrize("m,k,n", [(3, 64, 32), (130, 96, 256)])
def test_qmatmul_w4_plain_equals_pallas_and_ref(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = _rand(rng, (m, k))
    codes = rng.integers(-8, 8, size=(k, n)).astype(np.int32)
    packed = np.asarray(JQ.pack_int4(jnp.asarray(codes)))
    s = _rand(rng, (n,), 0.01, 0.1)
    pallas = jops.qmatmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s),
                          bits=4, interpret=True)
    want = jref.qmatmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s),
                        bits=4)
    tp = TQ.pack_int4(_t(codes))
    np.testing.assert_array_equal(tp.numpy(), packed)
    got = KQ.qmatmul(_t(x), tp, _t(s), bits=4)
    assert got.dtype == torch.float32
    for other in (pallas, want):
        np.testing.assert_allclose(got.numpy(), _f32(other), rtol=1e-3,
                                   atol=1e-3)


def test_qmatmul_exactness_small_codes():
    """bf16 holds integers exactly up to 256: an identity x returns the
    codes themselves, bit for bit, as the reference's test asserts."""
    rng = np.random.default_rng(5)
    k, n = 16, 8
    x = np.eye(k, dtype=np.float32)
    codes = rng.integers(-8, 8, size=(k, n)).astype(np.int32)
    s = np.ones((n,), np.float32)
    got = KQ.qmatmul(_t(x), TQ.pack_int4(_t(codes)), _t(s), bits=4)
    np.testing.assert_array_equal(got.numpy(), codes.astype(np.float32))
    packed = JQ.pack_int4(jnp.asarray(codes))
    pallas = jops.qmatmul(jnp.asarray(x), packed, jnp.asarray(s), bits=4,
                          interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_integer_valued_x_is_exact(bits):
    """Integer-valued x with small codes: every partial sum is an integer
    below 2^24, so any summation order gives the same float32 bits; the
    port equals the reference's plain version and its Pallas kernel."""
    rng = np.random.default_rng(bits)
    m, k, n = 4, 200, 48
    x = rng.integers(-16, 17, size=(m, k)).astype(np.float32)
    lim = 8 if bits == 4 else 32
    codes = rng.integers(-lim, lim, size=(k, n)).astype(np.int32)
    wj = (JQ.pack_int4(jnp.asarray(codes)) if bits == 4
          else jnp.asarray(codes.astype(np.int8)))
    s = np.full((n,), 0.5, np.float32)
    want = np.asarray(jref.qmatmul(jnp.asarray(x), wj, jnp.asarray(s), bits))
    pallas = np.asarray(jops.qmatmul(jnp.asarray(x), wj, jnp.asarray(s),
                                     bits=bits, interpret=True))
    got = KQ.qmatmul(_t(x), _t(np.asarray(wj)), _t(s), bits=bits).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_ops_qmatmul_flattens_leading_dims():
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 3, 40))
    w = rng.integers(-128, 128, size=(40, 24)).astype(np.int8)
    s = _rand(rng, (24,), 0.01, 0.02)
    want = np.asarray(jops.qmatmul(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(s), bits=8, interpret=True))
    got = tops.qmatmul(_t(x), _t(w), _t(s), bits=8)
    assert tuple(got.shape) == (2, 3, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_qmatmul_rejects_other_bit_widths():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        KQ.qmatmul(x, torch.zeros((8, 4), dtype=torch.int8), torch.ones(4),
                   bits=2)


@pytest.mark.parametrize("case,match", [
    (dict(bits=2), "bits must be 4 or 8"),
    (dict(x=torch.zeros((2, 3, 8))), "x must be 2-D"),
    (dict(x=torch.zeros((8, 2)).T), "x must be contiguous"),
    (dict(x=torch.zeros((2, 8), dtype=torch.float16)), "float32 or bfloat16"),
    (dict(w=torch.zeros((8, 4), dtype=torch.int32)), "codes must be int8"),
    (dict(s=torch.ones(4, dtype=torch.float64)), "scale must be float32"),
    (dict(w=torch.zeros((7, 4), dtype=torch.int8)), "codes rows 7 != x cols 8"),
    (dict(s=torch.ones(5)), r"scale must be \(4,\)"),
    (dict(bits=4), r"scale must be \(8,\)"),
])
def test_qmatmul_names_what_it_rejects(case, match):
    """What the wrapper refuses on the card, and the message that names it
    (built only once the hot path's single test has failed)."""
    args = dict(x=torch.zeros((2, 8)), w=torch.zeros((8, 4), dtype=torch.int8),
                s=torch.ones(4), bits=8)
    args.update(case)
    with pytest.raises(ValueError, match=match):
        KQ._reject(args["x"], args["w"], args["s"], args["bits"])


# Qwen2.5-3B's seven decode projections (K, N) at batch 4 and one prefill
# shape: how the kernel's grid is cut on a 132-SM card.
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 2048, 256),
                                   (4, 2048, 11008), (4, 11008, 2048),
                                   (1, 2048, 256), (32, 2048, 11008),
                                   (7, 100, 9), (0, 64, 64)])
def test_split_plan_covers_k_and_fills_the_card(m, k, n):
    for bits in (8, 4):
        mt, bn, splits, kps = KQ.split_plan(m, k, n, 132, bits)
        assert mt in (1, 2, 4, 8) and mt >= min(max(m, 1), 8)
        assert bn in (64, 128)
        assert kps % 16 == 0 and splits <= KQ.MAX_SPLITS
        assert splits >= 1 and splits * kps >= k and (splits - 1) * kps < k
        ks = KQ.stage_rows(bits, bn)
        assert splits == 1 or kps >= ks
        tiles = -(-n // bn) * -(-max(m, 1) // mt)
        blocks = tiles * splits
        # a block per SM, or K cannot be cut further: another split would
        # stream less than a ring stage, pass MAX_SPLITS, or leave blocks
        # that no longer fit on the card at once
        resident = KQ.RESIDENT_PER_SM if bn == 128 else 1
        can_cut = (splits < KQ.MAX_SPLITS and kps >= 2 * ks
                   and tiles * (splits + 1) <= resident * 132)
        assert blocks >= 132 or not can_cut
        assert mt * (-(-kps // ks) * ks + 8) * 2 <= KQ.X_SMEM_MAX
        if (m, k, n) == (4, 2048, 256):      # wk / wv: one stage a split
            assert (mt, bn, splits, kps) == ((4, 64, 8, 256) if bits == 8
                                             else (4, 64, 4, 512))
        if (m, k, n) == (4, 11008, 2048):    # w_down: 32 column tiles x 4
            assert (mt, bn, splits, kps) == (4, 64, 4, 2752)


@pytest.mark.parametrize("k,splits", [(2048, 5), (2048, 64), (11008, 9),
                                      (100, 8), (37, 1), (515, 17)])
def test_forced_splits_leave_no_empty_split(k, splits):
    """A forced split count becomes slices of a multiple of 16 rows (the
    kernel's k-step) that cover K with none empty, as the C entry point
    requires; the count may fall where 16-row slices need fewer."""
    sp, kps = KQ._cut_k(k, splits, 16)
    assert kps % 16 == 0 and 1 <= sp <= splits
    assert (sp - 1) * kps < k <= sp * kps


# ---------------------------------------------------------------------------
# Serving quantization: codes and scales bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(64, 32), (3, 48, 96)])
def test_quantize_dense_for_serving_bit_for_bit(bits, shape):
    rng = np.random.default_rng(bits + len(shape))
    w = rng.normal(size=shape).astype(np.float32) * 0.1
    w[..., 5] = 0.0                      # all-zero column: scale = 1e-12
    b = rng.normal(size=shape[:-2] + shape[-1:]).astype(np.float32)
    want = JL.quantize_dense_for_serving({"w": jnp.asarray(w),
                                          "b": jnp.asarray(b)}, bits)
    got = TL.quantize_dense_for_serving({"w": _t(w), "b": _t(b)}, bits)
    assert sorted(got) == sorted(want) == ["b", "w_codes", "w_scale"]
    assert got["w_codes"].dtype == torch.int8
    assert got["w_scale"].dtype == torch.float32
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_for_serving_bit_for_bit(bits):
    cfg = j_reduce(j_get_config("qwen2.5-3b"))
    params = jlm.init_params(jax.random.PRNGKey(3), cfg)
    want = jax.tree_util.tree_map(np.asarray,
                                  j_quantize_tree(params, bits))
    got = quantize_tree_for_serving(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                          device="cpu"), bits)
    want_leaves, want_def = jax.tree_util.tree_flatten_with_path(want)
    got_leaves, got_def = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.numpy().dtype == w.dtype, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
