"""The port's checkpoints, graph fingerprints and cost model against the
JAX reference, on the CPU.

* ``content_key`` gives the reference's strings;
* a checkpoint written by either package restores in the other (the same
  ``arrays.npz`` keys and ``meta.json``);
* the reference's named-checkpoint contracts: round trip and meta, GC-proof
  named entries, concurrent writers of one key, unsafe names refused;
* ``graph_fingerprint`` and ``DeployedModel.fingerprint`` equal the
  reference's for the same numpy params;
* ``profile_deployed`` counts the reference's FLOPs and bytes per node.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.ckpt import CheckpointManager as JMgr  # noqa: E402
from repro.ckpt import content_key as j_content_key  # noqa: E402
from repro.ckpt import graph_fingerprint as j_fingerprint  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.core.deploy import compile as jcompile  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CompileCache  # noqa: E402
from repro_torch.ckpt import content_key, graph_fingerprint  # noqa: E402
from repro_torch.ckpt import restore_resharded  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.deploy import compile as tcompile  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402
from repro_torch.obs.costmodel import profile_deployed, render_profile  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores,
    and torch's default (one thread per core in every worker) makes these
    small ops wait on each other many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", [
    {"a": 1, "b": 2},
    {"arch": "resnet9", "width": 8, "steps": 120, "cache_v": 2,
     "candidate": [6, 4], "lr": 2e-3},
    {"candidate": {"default": [6, 4], "layers": {"r2a": [4, 4]}},
     "nested": [1, 2.5, None, True, "x"]},
    [3, "w6a4", {"z": 0}],
])
def test_content_key_equals_the_reference(config):
    assert content_key(config) == j_content_key(config)
    assert content_key(config, length=8) == j_content_key(config, length=8)


def test_content_key_is_canonical():
    assert content_key({"a": 1, "b": 2}) == content_key({"b": 2, "a": 1})
    assert content_key({"a": 1}) != content_key({"a": 2})
    assert len(content_key({"a": 1})) == 16
    assert content_key({"a": 1}, length=8) == content_key({"a": 1})[:8]


def _params(width=2):
    return TR.init_params(torch.Generator().manual_seed(3), width, "cpu")


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.detach().numpy()


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    p = _params()
    tree = {"params": p, "probe_feats": np.arange(6, dtype=np.float32)}
    CheckpointManager(str(tmp_path)).save_named("k", tree, meta={"acc": 0.5})
    jmgr = JMgr(str(tmp_path))
    like = {"params": jax.tree_util.tree_map(np.zeros_like, _np(p)),
            "probe_feats": np.zeros(6, np.float32)}
    out = jmgr.restore_named(like, "k")
    for blk in p:
        for leaf in p[blk]:
            np.testing.assert_array_equal(np.asarray(out["params"][blk][leaf]),
                                          p[blk][leaf].numpy())
    np.testing.assert_array_equal(out["probe_feats"], tree["probe_feats"])
    assert jmgr.named_meta("k")["acc"] == 0.5


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jp = jax.tree_util.tree_map(np.asarray,
                                JR.init_params(jax.random.PRNGKey(1), 2))
    jmgr = JMgr(str(tmp_path), keep=2)
    for step in range(3):
        jmgr.save(step, {"backbone": jp, "n": np.int32(step)},
                  meta={"loss": float(step)})
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2
    like = {"backbone": _params(), "n": np.int32(0)}
    out = mgr.restore(like)
    assert isinstance(out["backbone"]["c0"]["w"], torch.Tensor)
    for blk in jp:
        for leaf in jp[blk]:
            np.testing.assert_array_equal(out["backbone"][blk][leaf].numpy(),
                                          jp[blk][leaf])
    assert int(out["n"]) == 2 and mgr.meta()["loss"] == 2.0
    assert int(mgr.restore(like, step=1)["n"]) == 1


def test_restore_missing_leaf_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"a": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        mgr.restore({"a": np.zeros(2, np.float32), "b": np.zeros(1)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"a": 0})


def test_named_checkpoint_roundtrip_and_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones((3,), np.float32)}
    assert not mgr.has_named("k1")
    mgr.save_named("k1", tree, meta={"acc": 0.5})
    assert mgr.has_named("k1") and mgr.all_named() == ["k1"]
    like = {"w": np.zeros((2, 3), np.float32), "b": np.zeros((3,), np.float32)}
    out = mgr.restore_named(like, "k1")
    np.testing.assert_array_equal(out["w"], tree["w"])
    np.testing.assert_array_equal(out["b"], tree["b"])
    assert mgr.named_meta("k1")["acc"] == 0.5
    with pytest.raises(FileNotFoundError):
        mgr.restore_named(like, "nope")


def test_named_checkpoints_survive_step_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save_named("cache-point", {"x": np.ones(2, np.float32)})
    for step in range(5):
        mgr.save(step, {"x": torch.zeros(1)})
    assert mgr.all_steps() == [3, 4]
    assert mgr.has_named("cache-point")
    assert mgr.latest_step() == 4


def test_named_checkpoint_concurrent_same_key_writers(tmp_path):
    """Each writer stages in a private tmp dir: the last replace wins with
    a complete entry, never an interleaved one."""
    mgr = CheckpointManager(str(tmp_path))
    payloads = [torch.full((64, 64), float(i)) for i in range(8)]
    barrier = threading.Barrier(4)

    def writer(i):
        barrier.wait(timeout=60)
        for p in payloads:
            mgr.save_named("contested", {"x": p}, meta={"writer": i})

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    out = mgr.restore_named({"x": torch.zeros((64, 64))}, "contested")
    assert torch.equal(out["x"], payloads[-1])
    assert mgr.named_meta("contested")["writer"] in range(4)


@pytest.mark.parametrize("bad", ["../escape", "a/b", "", "sp ace"])
def test_named_checkpoint_rejects_unsafe_names(tmp_path, bad):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError, match="invalid checkpoint name"):
        mgr.save_named(bad, {"x": np.zeros(1)})


def test_compile_cache_and_resharding_wait_for_their_slices(tmp_path):
    with pytest.raises(NotImplementedError, match="compile cache"):
        CompileCache(str(tmp_path))
    with pytest.raises(NotImplementedError, match="resharding"):
        restore_resharded(CheckpointManager(str(tmp_path)), {}, None)


# ---------------------------------------------------------------------------
# fingerprints and the cost model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[((6, 4), "int"), ((6, 4), "f32"),
                                        ((8, 8), "int"), ((3, 2), "int")],
                ids=["w6a4-int", "w6a4-f32", "w8a8-int", "w3a2-int"])
def artifacts(request):
    point, datapath = request.param
    pn = jax.tree_util.tree_map(np.asarray,
                                JR.init_params(jax.random.PRNGKey(4), 4))
    dj = jcompile(pn, JQ.QuantConfig.grid_point(*point), recipe="resnet9",
                  datapath=datapath)
    dt = tcompile(pn, TQ.QuantConfig.grid_point(*point), recipe="resnet9",
                  datapath=datapath, device="cpu")
    return dj, dt


def test_graph_fingerprint_equals_the_reference(artifacts):
    dj, dt = artifacts
    assert graph_fingerprint(dt.graph) == j_fingerprint(dj.graph)
    assert dt.fingerprint() == dj.fingerprint()
    assert dt.fingerprint() is dt.fingerprint()          # memoized


def test_fingerprint_moves_with_the_weights():
    p = _params(4)
    a = tcompile(p, TQ.QuantConfig.paper_w6a4(), recipe="resnet9",
                 datapath="int", device="cpu")
    p["r2b"]["w"] = p["r2b"]["w"] * 1.5
    b = tcompile(p, TQ.QuantConfig.paper_w6a4(), recipe="resnet9",
                 datapath="int", device="cpu")
    assert graph_fingerprint(a.graph) != graph_fingerprint(b.graph)
    c = tcompile(p, TQ.QuantConfig.paper_w6a4(), recipe="resnet9",
                 datapath="f32", device="cpu")
    assert c.fingerprint() != b.fingerprint()


def test_profile_counts_the_reference_flops_and_bytes(artifacts):
    dj, dt = artifacts
    x = np.zeros((2, 32, 32, 3), np.float32)
    pj = dj.profile(x, xla=False, backend="cpu")
    pt = dt.profile(x, xla=False)
    assert pt["backend"] == "cpu" and pt["batch"] == 2 and pt["xla"] is None
    assert [(r["tensor"], r["op"], r["kernel"], r["flops"], r["bytes"],
             r["bound"]) for r in pt["nodes"]] == \
        [(r["tensor"], r["op"], r["kernel"], r["flops"], r["bytes"],
          r["bound"]) for r in pj["nodes"]]
    for key in ("flops", "bytes", "est_ms"):
        np.testing.assert_allclose(pt["totals"][key], pj["totals"][key],
                                   rtol=1e-12)
    assert abs(sum(r["share"] for r in pt["nodes"]) - 1.0) < 1e-9
    assert render_profile(pt, top=3).count("\n") == 3
    with pytest.raises(NotImplementedError, match="XLA"):
        dt.profile(x)
    h100 = profile_deployed(dt, x, xla=False, backend="h100")
    assert h100["totals"]["est_ms"] < pt["totals"]["est_ms"]


@pytest.mark.parametrize("qcfg,peak", [
    ("paper_w6a4", 1979e12),           # int8 tensor cores
    ("grid_point_8_8", 67e12 / 2),     # int32 on the CUDA cores
])
def test_h100_model_takes_each_mvau_at_its_units_peak(qcfg, peak):
    """The "h100" roofline times an integer MVAU at the peak of the unit
    its card kernel runs on: w6a4's int8 codes on the tensor cores,
    w8a8's wider codes on the CUDA cores (compute-bound there)."""
    cfg = (TQ.QuantConfig.grid_point(8, 8) if qcfg == "grid_point_8_8"
           else TQ.QuantConfig.paper_w6a4())
    dt = tcompile(_params(8), cfg, recipe="resnet9", datapath="int",
                  device="cpu")
    prof = profile_deployed(dt, np.zeros((8, 32, 32, 3), np.float32),
                            xla=False, backend="h100")
    rows = [r for r in prof["nodes"] if r["op"] == "mvau_int"]
    assert len(rows) == 8
    for r in rows:
        assert r["est_ms"] == max(r["flops"] / peak,
                                  r["bytes"] / 3.35e12) * 1e3
    if peak < 1e15:
        assert all(r["bound"] == "compute" for r in rows)
