"""The port's distribution substrate over 4 ranks on the CPU (``gloo``).

``tools/dist_smoke.py --spawn 4 --backend gloo --cpu`` runs once for the
module (its ranks meet through a ``FileStore`` under the test's tmp dir,
so parallel test workers never share a port), at its CPU sizes; its
summary and GPipe's arrays are held here against the serial paths and,
where JAX can run, against the JAX package:

* the sharded NCM head over the width-8 int artifact's features
  (prototype rows split over a 1-D mesh of the 4 ranks) equals the serial
  head bit for bit at C in {1, 3, 4, 8, 11, 80}, and
  ``ShardedStore.classify`` == ``PrototypeStore.classify``;
* GPipe over 4 stages against the sequential apply, the port's and JAX's:
  forward rtol 2e-5, gradients rtol 1e-4 (the reference's tolerances);
* ``make_train_step`` on reduced ``qwen2.5-3b`` and reduced
  ``grok-1-314b`` (4 experts top-2 at capacity factor 1.25; both at
  grad_accum 2) on a 2x2 mesh, with and without ``acc_shardings``, and on
  1x4 (one query head a rank, its k/v group cut from the replicated k/v,
  whose gradient is then a partial sum): the loss within rtol 2e-4 of the
  one-rank step, the loss after the update within rtol 5e-3 (the
  reference's ``test_sharded_train_step_runs_and_matches_single_device``),
  the moments sharded; for the MoE step (with ``acc_shardings``) the first
  moments leaf by leaf within 1e-4 of each leaf's largest, both steps
  with float32 projections;
* the MoE step's expert-parallel dispatch (each rank's tokens in their
  global slots, an all-to-all over ``"data"`` on 2x2): every dispatch
  buffer and kept mask of the step, made whole, equal the serial dispatch
  of the same tokens bit for bit (its batches overflow the capacity), and
  so do the buffer, kept mask and combined rows of a routing that sends
  half the entries to one expert, with 4 experts (split over ``"data"``)
  and with 3 (``"data"`` does not divide them: their slots split); a
  capacity that the slot axes do not divide raises ``ValueError``;
* reduced ``qwen3-14b`` float32 decode at float weights and served at w8
  and w4 (column-sharded codes: each rank's columns with its slice of the
  scale), 2 steps on 2x2 then 2 re-placed on 1x4 (the k/v cut again):
  every cache leaf finite and ``len`` advanced (the reference's checks),
  logits within 1e-4 of the serial decode's on the same weights, greedy
  tokens equal wherever the serial top-2 margin exceeds 1e-3;
* ``restore_resharded`` onto the 2x2 mesh: ``full_tensor()`` bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "dist_smoke.py"),
                        "--spawn", str(WORLD), "--backend", "gloo", "--cpu",
                        "--timeout", "400", "--out", str(out)], env=env,
                       capture_output=True, text=True, timeout=450)
    assert (out / "summary.json").exists(), r.stderr[-3000:]
    with open(out / "summary.json") as f:
        summary = json.load(f)
    arrays = (dict(np.load(out / "pipeline.npz"))
              if (out / "pipeline.npz").exists() else {})
    return summary, arrays, r


def _check(ranks, name):
    c = ranks[0]["checks"][name]
    assert "error" not in c, c["error"]
    return c


def test_every_check_ran_on_every_rank(ranks):
    summary, _, r = ranks
    assert summary["world"] == WORLD and summary["device"] == "cpu"
    assert not summary["deferred"]
    assert set(summary["checks"]) == {"head", "pipeline", "train", "decode",
                                      "restore"}
    assert summary["ok"] and not summary["failed"], summary["failed"]
    assert r.returncode == 0, r.stderr[-3000:]


def test_sharded_head_bitforbit(ranks):
    c = _check(ranks, "head")
    assert c["n_dev"] == WORLD
    assert c["C"] == {str(n): True for n in (1, 3, 4, 8, 11, 80)}
    assert c["classify_equal"]


def test_pipeline_matches_sequential(ranks):
    """Forward and gradient against the port's sequential apply and JAX's
    (the reference test's function, on the same inputs)."""
    import jax
    import jax.numpy as jnp

    assert _check(ranks, "pipeline")["stages"] == WORLD
    a = ranks[1]
    np.testing.assert_allclose(a["y"], a["seq_y"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(a["g"], a["seq_g"], rtol=1e-4, atol=1e-4)

    def sequential(ws, x):
        y = x
        for i in range(ws.shape[0]):
            y = jnp.tanh(y @ ws[i])
        return y

    ws, x = jnp.asarray(a["ws"]), jnp.asarray(a["x"])
    np.testing.assert_allclose(a["y"], np.asarray(sequential(ws, x)),
                               rtol=2e-5, atol=2e-5)
    g = jax.grad(lambda w: jnp.sum(sequential(w, x) ** 2))(ws)
    np.testing.assert_allclose(a["g"], np.asarray(g), rtol=1e-4,
                               atol=1e-4)


def test_pipeline_rejects_a_mismatched_axis(ranks):
    assert "3 stages need a 3-wide 'pipe' axis, got 4" in \
        _check(ranks, "pipeline")["axis_error"]


TRAIN_MESHES = {"plain": "2x2", "acc": "2x2_acc", "1x4": "1x4_acc"}


def _train(ranks, tag):
    arch, _, mesh = tag.rpartition("-")
    return _check(ranks, "train")["archs"][arch or "qwen2.5-3b"]["meshes"][
        TRAIN_MESHES[mesh]]


@pytest.mark.parametrize("tag", [
    "plain", "acc", "1x4",
    "grok-1-314b-plain", "grok-1-314b-acc", "grok-1-314b-1x4"])
def test_sharded_train_step_matches_single_rank(ranks, tag):
    r = _train(ranks, tag)
    assert np.isfinite(r["loss2"])
    np.testing.assert_allclose(r["loss2"], r["loss1"], rtol=2e-4)
    np.testing.assert_allclose(r["after2"], r["after1"], rtol=5e-3)
    assert r["moments_sharded"]


@pytest.mark.parametrize("mesh", ["acc", "1x4"])
def test_moe_step_first_moments_match_single_rank(ranks, mesh):
    """The backward of the expert-parallel step, leaf by leaf: the first
    moments after one step ((1 - b1) times the gradient), both steps with
    float32 projections, within 1e-4 of each leaf's largest value (the
    sums in another order differ by about 1e-6).  The losses alone would
    pass a gradient scaled by a positive factor: AdamW's first update is
    about sign(g)."""
    err = _train(ranks, f"grok-1-314b-{mesh}")["m_err"]
    for leaf in ("blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down",
                 "blocks/moe/router/w", "blocks/attn/wo/w", "embed"):
        assert leaf in err
    assert max(err.values()) <= 1e-4, err


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_moe_dispatch_bitforbit_in_the_step(ranks, mesh):
    """Each of the step's 4 dispatches (2 layers x 2 microbatches): the
    buffer and kept mask equal the serial dispatch's, with drops."""
    r = _train(ranks, f"grok-1-314b-{mesh}")
    assert r["dispatches"] == 4 and r["dispatch_bitforbit"]
    assert r["dropped"] > 0


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_moe_dispatch_and_combine_bitforbit_on_overflow(ranks, mesh):
    """4 experts (split over ``"data"`` on 2x2) and 3 (their slots split
    there); ``"data"`` is 1 wide on 1x4: nothing is split."""
    cases = _train(ranks, f"grok-1-314b-{mesh}")["overflow"]
    want = {"1x4": [{}, {}]}.get(mesh, [{"data": "experts"},
                                        {"data": "slots"}])
    assert [c["split"] for c in cases] == want
    for r in cases:
        assert r["dropped"] > 0
        assert r["dispatch_bitforbit"] and r["combine_bitforbit"]


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_moe_dispatch_rejects_an_undivided_capacity(ranks, mesh):
    """3 experts over a 2-wide ``"data"`` split their slots, and C = 41
    does not split: every rank raises before any exchange.  ``"data"`` is
    1 wide on 1x4: nothing is split."""
    msg = _train(ranks, f"grok-1-314b-{mesh}")["undivided"]
    if mesh == "1x4":
        assert msg is None
    else:
        assert msg == ("MoE capacity 41 does not split over the 2 ranks "
                       "of mesh axes ['data']")


def _decode_matches_serial(r):
    assert r["dtype"] == "float32"
    assert r["finite"] and r["cache_sharded"]
    assert r["len"] == [4] * len(r["len"])            # four steps
    assert [s["mesh"] for s in r["steps"]] == ["2x2", "2x2", "1x4", "1x4"]
    for s in r["steps"]:
        assert s["logit_err"] <= 1e-4
        for m, a, b in zip(s["margin"], s["tok1"], s["tok2"]):
            if m > 1e-3:
                assert a == b


def test_sharded_decode_matches_serial(ranks):
    _decode_matches_serial(_check(ranks, "decode")["bits"]["0"])


@pytest.mark.parametrize("bits", [8, 4])
def test_sharded_quantized_decode_matches_serial(ranks, bits):
    """Served at w8 and w4: the column-sharded codes run the quantized
    product on each rank's columns with its slice of the scale, against
    the serial decode of the same codes."""
    _decode_matches_serial(_check(ranks, "decode")["bits"][str(bits)])


def test_restore_resharded_onto_2x2(ranks):
    r = _check(ranks, "restore")
    assert r["mesh"] == "2x2"
    assert r["ok"] and r["sharded"] > 0
