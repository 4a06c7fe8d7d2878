"""The port's training substrate against the JAX package, on the CPU.

* ``token_lm_batch``: the same arrays from the same seed, bit for bit;
* ``compress_int8``: codes and scales bit for bit against JAX's (a true
  division and round-half-even in both), the ``scale / 2`` round-trip
  bound, and the error-feedback running sum of ``ef_compress_tree`` as the
  reference's ``tests/test_substrate.py`` holds it, leaf for leaf equal to
  JAX's over 50 steps;
* ``StragglerMonitor``: the same verdicts and ``events`` strings on a
  seeded duration stream with slow bursts.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import token_lm_batch as j_token_lm_batch  # noqa: E402
from repro.dist import compression as JC  # noqa: E402
from repro.dist.straggler import StragglerMonitor as JMonitor  # noqa: E402
from repro_torch.data.synthetic import token_lm_batch  # noqa: E402
from repro_torch.dist import compression as TC  # noqa: E402
from repro_torch.dist.straggler import StragglerMonitor  # noqa: E402


@pytest.mark.parametrize("seed,batch,seq,vocab", [
    (0, 2, 16, 97), (3, 8, 128, 151936), (11, 5, 7, 1)])
def test_token_lm_batch_equals_reference(seed, batch, seq, vocab):
    want = j_token_lm_batch(seed, batch, seq, vocab)
    got = token_lm_batch(seed, batch, seq, vocab)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def _grads(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("seed,shape,scale", [
    (0, (1000,), 1.0), (1, (64, 33), 1e-3), (2, (7,), 3e4)])
def test_compress_int8_codes_and_scale_equal_reference(seed, shape, scale):
    g = _grads(seed, shape, scale)
    jcodes, jscale = JC.compress_int8(jnp.asarray(g))
    codes, s = TC.compress_int8(torch.from_numpy(g))
    assert codes.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert s.item() == float(jscale)
    back = TC.decompress_int8(codes, s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JC.decompress_int8(jcodes, jscale)))
    assert float((back - torch.from_numpy(g)).abs().max()) \
        <= s.item() * 0.5 + 1e-7 * scale


def test_compress_int8_of_zeros_uses_the_floor_scale():
    codes, s = TC.compress_int8(torch.zeros(5))
    jcodes, jscale = JC.compress_int8(jnp.zeros(5))
    assert s.item() == float(jscale) == np.float32(1e-12)
    assert not codes.any() and not np.asarray(jcodes).any()


def test_compress_int8_rounds_half_to_even():
    # amax 127 -> scale 1: the quotients are the values themselves
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    codes, _ = TC.compress_int8(torch.from_numpy(g))
    assert codes.tolist() == [127, 0, 2, 2, 0, -2, 4]
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(JC.compress_int8(jnp.asarray(g))[0]))


def test_error_feedback_running_sum_equals_reference():
    """EF compression: the running sum of compressed grads tracks the
    running sum of true grads (the EF-SGD guarantee), and every sent leaf
    and residual equals JAX's bit for bit along the way."""
    rng = np.random.default_rng(1)
    seq = [{"w": rng.normal(size=(64,)).astype(np.float32) * 0.01,
            "b": [rng.normal(size=(3, 5)).astype(np.float32)]}
           for _ in range(50)]
    res = TC.init_residuals({k: (torch.from_numpy(v) if k == "w" else
                                 [torch.from_numpy(v[0])])
                             for k, v in seq[0].items()})
    jres = JC.init_residuals(jax.tree_util.tree_map(jnp.asarray, seq[0]))
    assert res["w"].dtype == torch.float32 and not res["b"][0].any()
    sum_true = np.zeros(64, np.float32)
    sum_comp = np.zeros(64, np.float32)
    for g in seq:
        tg = {"w": torch.from_numpy(g["w"]), "b": [torch.from_numpy(g["b"][0])]}
        sent, res = TC.ef_compress_tree(tg, res)
        jsent, jres = JC.ef_compress_tree(
            jax.tree_util.tree_map(jnp.asarray, g), jres)
        for a, b in ((sent, jsent), (res, jres)):
            np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))
            np.testing.assert_array_equal(a["b"][0].numpy(),
                                          np.asarray(b["b"][0]))
        assert isinstance(sent["b"], list) and sent["w"].dtype == torch.float32
        sum_true += g["w"]
        sum_comp += sent["w"].numpy()
    # the residual bounds the gap: |sum true - sum sent| == |residual|,
    # at most one quantization step
    gap = np.abs(sum_true - sum_comp).max()
    assert gap <= float(res["w"].abs().max()) + 1e-6
    assert gap < 0.01


def test_ef_compress_keeps_bf16_leaves_and_bounds_residuals():
    g = {"w": torch.full((8,), 0.25, dtype=torch.bfloat16),
         "v": torch.linspace(-1, 1, 33)}
    res = TC.init_residuals(g)
    sent, new_res = TC.ef_compress_tree(g, res)
    assert sent["w"].dtype == torch.bfloat16
    assert new_res["w"].dtype == torch.float32
    for k in g:
        _, scale = TC.compress_int8(g[k].float() + res[k])
        assert float(new_res[k].abs().max()) <= scale.item() / 2 + 1e-7


def _durations(seed, n=160):
    """Noisy ~1 s steps with slow bursts of 1, 2, 3 and 5 steps."""
    rng = np.random.default_rng(seed)
    d = 1.0 + 0.05 * rng.random(n)
    for start, length in ((30, 1), (60, 2), (90, 3), (120, 5)):
        d[start:start + length] = 2.0 + rng.random(length)
    return d


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {"sustain": 2}),
                                     (2, {"window": 8, "factor": 1.2,
                                          "min_history": 3})])
def test_straggler_verdicts_equal_reference(seed, kw):
    mon, jmon = StragglerMonitor(**kw), JMonitor(**kw)
    got = [mon.observe(i, float(d)) for i, d in enumerate(_durations(seed))]
    want = [jmon.observe(i, float(d)) for i, d in enumerate(_durations(seed))]
    assert got == want
    assert "evict" in got and "warn" in got
    assert mon.events == jmon.events
    assert mon.baseline() == jmon.baseline()


def test_straggler_tolerates_noise():
    mon = StragglerMonitor()
    rng = np.random.default_rng(0)
    assert all(mon.observe(i, 1.0 + 0.05 * rng.random()) is None
               for i in range(200))
    assert mon.events == []
