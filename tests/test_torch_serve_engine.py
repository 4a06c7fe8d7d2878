"""The port's serving layer on the CPU, against the JAX package's.

The same seeded numpy traffic goes through ``repro.serve.ServeEngine``
(JAX, CPU) and ``repro_torch.serve.ServeEngine`` (``device="cpu"``) over
the paper's w6a4 int artifact at ResNet-9 width 4 on 16x16 frames, with the
JAX params moved across as numpy (``repro_torch.convert.params_from_numpy``):
features bit for bit, served prototypes within the tolerance the port holds
``ncm._l2`` to (and bit for bit with the port's own offline recompute),
class ids and request counts equal.  Then the reference's engine contracts
(``tests/test_serve.py``, ``tests/test_workload_api.py``) in the port:
backpressure, tenant quotas, failing futures, A/B and hot swap, FIFO order,
cancellation, bucket overrides, stop, and a 1,000-request soak with no
retrace after warmup.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.fsl.pipeline import FSLPipeline as JFSLPipeline  # noqa: E402
from repro.models import resnet9 as jresnet9  # noqa: E402
from repro.serve import ArtifactRegistry as JRegistry  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.deploy import compile as tcompile  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.fsl import ncm  # noqa: E402
from repro_torch.fsl.pipeline import FSLPipeline  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ArtifactRegistry,
    ClassifyResult,
    FSLAdapter,
    RequestKind,
    ServeEngine,
    ServeOverload,
    TenantOverQuota,
    pad_to_bucket,
)
from repro_torch.serve.workload import default_adapter  # noqa: E402

WIDTH, IMG = 4, 16
# the port's tolerance against JAX for float reductions whose order differs
# (row L2 norms, the NCM cosine matmul), as tests/test_torch_fsl.py
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def served():
    pj = jax.tree_util.tree_map(np.asarray,
                                jresnet9.init_params(jax.random.PRNGKey(0),
                                                     WIDTH))
    pt = params_from_numpy(pj, device="cpu")
    jpipe = JFSLPipeline(width=WIDTH, qcfg=JQuantConfig.paper_w6a4())
    tpipe = FSLPipeline(width=WIDTH, qcfg=QuantConfig.paper_w6a4(),
                        device="cpu")
    return pj, pt, jpipe, tpipe


def _frames(rng, n):
    return rng.random((n, IMG, IMG, 3)).astype(np.float32)


def _engine(tpipe, pt, **kw):
    reg = ArtifactRegistry()
    reg.register("int", tpipe.deploy(pt, datapath="int"), default=True)
    kw.setdefault("max_batch", 8)
    kw.setdefault("batch_wait_ms", 1.0)
    return ServeEngine(reg, **kw)


def _plan(rng, n_req, n_classes, p_register=0.2, max_rows=4):
    plan = []
    for i in range(n_req):
        if i < n_classes or rng.random() < p_register:
            c = i if i < n_classes else int(rng.integers(n_classes))
            plan.append(("register", c,
                         _frames(rng, int(rng.integers(1, max_rows + 1)))))
        else:
            plan.append(("classify", None,
                         _frames(rng, int(rng.integers(1, max_rows)))))
    return plan


def _offline(feats, plan):
    """Per class, every registered chunk's features folded in arrival
    order through the port's NCM (the store's own fold)."""
    by_class = {}
    for kind, c, x in plan:
        if kind == "register":
            by_class.setdefault(c, []).append(feats(x))
    return {c: ncm.class_means(torch.cat(ch), torch.zeros(
        sum(len(f) for f in ch), dtype=torch.int64), 1)[0]
        for c, ch in by_class.items()}


# ---------------------------------------------------------------------------
# the same traffic through both engines
# ---------------------------------------------------------------------------
def test_same_traffic_through_both_engines(served):
    pj, pt, jpipe, tpipe = served
    plan = _plan(np.random.default_rng(31), 40, 4)
    jfeats = jpipe.deploy(pj, datapath="int")
    tfeats = tpipe.deploy(pt, datapath="int")
    for _, _, x in plan:
        np.testing.assert_array_equal(tfeats(x).numpy(), np.asarray(jfeats(x)))
    out = {}
    for name, eng in (
            ("jax", JEngine(_jreg(jfeats), max_batch=8, batch_wait_ms=1.0)),
            ("torch", _engine(tpipe, pt))):
        with eng:
            base = eng.warmup(img=IMG)
            futs = [eng.submit_register(c, x) if kind == "register"
                    else eng.submit_classify(x) for kind, c, x in plan]
            results = [f.result(120) for f in futs]
            assert eng.trace_counts() == base
            snap = eng.metrics.snapshot()
        out[name] = (results, eng.registry.get("int").store.prototypes(),
                     {k: snap[k] for k in ("completed", "failed",
                                           "rejected", "cancelled")})
    (jres, (jmeans, jids), jsnap), (tres, (tmeans, tids), tsnap) = \
        out["jax"], out["torch"]
    assert jsnap == tsnap == {"completed": 40, "failed": 0, "rejected": 0,
                              "cancelled": 0}
    assert tids == jids
    np.testing.assert_allclose(tmeans, jmeans, **TOL)
    offline = _offline(tfeats, plan)
    for c, mean in offline.items():
        np.testing.assert_array_equal(tmeans[tids.index(c)], mean.numpy())
    for (kind, _, _), jr, tr in zip(plan, jres, tres):
        if kind == "register":
            assert jr == tr
        else:
            assert tr.class_ids == jr.class_ids
            np.testing.assert_allclose(tr.sims, jr.sims, **TOL)


def _jreg(jfeats):
    reg = JRegistry()
    reg.register("int", jfeats, default=True)
    return reg


# ---------------------------------------------------------------------------
# the reference's engine contracts in the port
# ---------------------------------------------------------------------------
def test_engine_mixed_traffic_bitforbit(served):
    _, pt, _, tpipe = served
    rng = np.random.default_rng(7)
    shots = {f"cls{c}": _frames(rng, 2 + c) for c in range(3)}
    queries = _frames(rng, 5)
    with _engine(tpipe, pt) as eng:
        base = eng.warmup(img=IMG)
        futs = [eng.submit_register(c, x) for c, x in shots.items()]
        assert [f.result(60) for f in futs] == [2, 3, 4]
        res = eng.submit_classify(queries).result(60)
        assert eng.trace_counts() == base
        snap = eng.metrics.snapshot()
        assert snap["completed"] == 4 and snap["failed"] == 0
    feats = tpipe.deploy(pt, datapath="int")
    sup = torch.cat([feats(x) for x in shots.values()])
    labs = torch.as_tensor(np.repeat(np.arange(3), [2, 3, 4]))
    offline = ncm.class_means(sup, labs, 3)
    means, ids = eng.registry.get("int").store.prototypes()
    assert ids == tuple(shots)
    np.testing.assert_array_equal(means, offline.numpy())
    want = ncm.ncm_classify(feats(queries), offline)
    assert res.class_ids == [f"cls{p}" for p in want.tolist()]
    assert isinstance(res, ClassifyResult) and isinstance(res.sims, np.ndarray)
    assert res.artifact == "int" and res.sims.shape == (5, 3)


def test_engine_classify_before_register_fails_future(served):
    _, pt, _, tpipe = served
    with _engine(tpipe, pt) as eng:
        fut = eng.submit_classify(_frames(np.random.default_rng(0), 1))
        with pytest.raises(RuntimeError, match="no classes"):
            fut.result(60)
        assert eng.metrics.snapshot()["failed"] == 1


def test_engine_backpressure_rejects_when_full(served):
    _, pt, _, tpipe = served
    rng = np.random.default_rng(0)
    eng = _engine(tpipe, pt, max_queue=2, start=False)
    eng.submit_classify(_frames(rng, 1))
    eng.submit_classify(_frames(rng, 1))
    with pytest.raises(ServeOverload):
        eng.submit_classify(_frames(rng, 1))
    assert eng.metrics.snapshot()["rejected"] == 1
    eng.stop(drain=False)
    assert eng.metrics.snapshot()["failed"] == 2
    with pytest.raises(ServeOverload, match="stopped"):
        eng.submit_classify(_frames(rng, 1))


def test_engine_tenant_over_quota_admits_others(served):
    _, pt, _, tpipe = served
    rng = np.random.default_rng(2)
    eng = _engine(tpipe, pt, max_queue=8, tenant_quota=0.25, start=False)
    for _ in range(2):
        eng.submit_classify(_frames(rng, 1), tenant="noisy")
    with pytest.raises(TenantOverQuota):
        eng.submit_classify(_frames(rng, 1), tenant="noisy")
    eng.submit_classify(_frames(rng, 1), tenant="quiet")
    assert eng.tenant_queue_depths() == {"noisy": 2, "quiet": 1}
    snap = eng.metrics.snapshot()
    assert snap["rejected"] == 1 and snap["over_quota"] == 1
    ts = eng.metrics.tenant_snapshot()
    assert ts["noisy"]["over_quota"] == 1 and ts["noisy"]["rejected"] == 1
    with pytest.raises(ValueError):
        ServeEngine(eng.registry, tenant_quota=1.5, start=False)
    eng.stop(drain=False)


def test_engine_request_validation_and_unknown_kind(served):
    _, pt, _, tpipe = served
    eng = _engine(tpipe, pt, start=False)
    with pytest.raises(ValueError):
        eng.submit_classify(np.zeros((IMG, IMG), np.float32))
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit_classify(np.zeros((9, IMG, IMG, 3), np.float32))
    with pytest.raises(ValueError, match="unknown request kind"):
        eng.submit("decode", {"seq": "s"})
    with pytest.raises(ValueError, match="classify"):
        eng.submit("nope", {"x": np.zeros((1, 4, 4, 3), np.float32)})
    eng.stop(drain=False)


def test_engine_unknown_artifact_fails_future(served):
    _, pt, _, tpipe = served
    with _engine(tpipe, pt) as eng:
        fut = eng.submit_classify(_frames(np.random.default_rng(0), 1),
                                  artifact="nope")
        with pytest.raises(KeyError):
            fut.result(60)


def test_engine_ab_artifacts_and_hot_swap(served):
    """int and f32 artifacts side by side, separate stores, equal sims (the
    two datapaths are bit for bit on the grid); the default hot-swaps."""
    _, pt, _, tpipe = served
    reg = ArtifactRegistry()
    reg.register("int", tpipe.deploy(pt, datapath="int"), default=True)
    reg.register("f32", tpipe.deploy(pt, datapath="f32"))
    rng = np.random.default_rng(11)
    shots0, shots1 = _frames(rng, 3), _frames(rng, 2)
    with ServeEngine(reg, max_batch=8, batch_wait_ms=1.0) as eng:
        base = eng.warmup(img=IMG)
        for art in ("int", "f32"):
            eng.submit_register("c0", shots0, artifact=art).result(60)
            eng.submit_register("c1", shots1, artifact=art).result(60)
        q = _frames(rng, 4)
        r_int = eng.submit_classify(q, artifact="int").result(60)
        r_f32 = eng.submit_classify(q, artifact="f32").result(60)
        assert r_int.artifact == "int" and r_f32.artifact == "f32"
        np.testing.assert_array_equal(r_int.sims, r_f32.sims)
        reg.set_default("f32")
        assert eng.submit_classify(q).result(60).artifact == "f32"
        assert eng.trace_counts() == base
    assert reg.get("int").store is not reg.get("f32").store


def test_engine_concurrent_submitters_fifo_per_class(served):
    _, pt, _, tpipe = served
    rng = np.random.default_rng(13)
    chunks = {t: [_frames(rng, 1 + (i % 3)) for i in range(4)]
              for t in range(4)}
    with _engine(tpipe, pt, max_queue=512) as eng:
        eng.warmup(img=IMG)

        def submit(tid):
            for ch in chunks[tid]:
                eng.submit_register(tid, ch).result(60)

        threads = [threading.Thread(target=submit, args=(t,)) for t in chunks]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        means, ids = eng.registry.get("int").store.prototypes()
    offline = _offline(tpipe.deploy(pt, datapath="int"),
                       [("register", t, c) for t, chs in chunks.items()
                        for c in chs])
    for tid in chunks:
        np.testing.assert_array_equal(means[ids.index(tid)],
                                      offline[tid].numpy())


def test_engine_survives_cancelled_future(served):
    _, pt, _, tpipe = served
    rng = np.random.default_rng(19)
    eng = _engine(tpipe, pt, start=False)
    doomed = eng.submit_classify(_frames(rng, 1))
    assert doomed.cancel()
    survivor = eng.submit_register("c0", _frames(rng, 2))
    eng.start()
    assert survivor.result(60) == 2
    assert eng.submit_classify(_frames(rng, 1)).result(60).class_ids == ["c0"]
    assert eng.metrics.snapshot()["cancelled"] == 1
    eng.stop()


def test_engine_warmup_bucket_override_replaces_set(served):
    _, pt, _, tpipe = served
    eng = _engine(tpipe, pt, max_batch=8, start=False)
    with pytest.raises(ValueError):
        eng.warmup(img=IMG, buckets=[1, 2, 4])
    eng.warmup(img=IMG, buckets=[1, 8])
    assert eng.buckets == (1, 8)
    with pytest.raises(ValueError):
        ServeEngine(eng.registry, max_batch=8, buckets=[2.5, 8], start=False)
    eng.stop()


def test_engine_default_alias_keeps_arrival_order(served):
    _, pt, _, tpipe = served
    rng = np.random.default_rng(23)
    eng = _engine(tpipe, pt, start=False)
    eng.submit_register("A", _frames(rng, 1))
    c1 = eng.submit_classify(_frames(rng, 1), artifact="int")
    eng.submit_register("B", _frames(rng, 1), artifact="int")
    c2 = eng.submit_classify(_frames(rng, 1))
    eng.start()
    assert c1.result(60).sims.shape == (1, 1)
    assert c2.result(60).sims.shape == (1, 2)
    eng.stop()


def test_engine_serves_raw_deployed_model(served):
    _, pt, _, _ = served
    dm = tcompile(pt, QuantConfig.paper_w6a4(), recipe="resnet9",
                  datapath="int", device="cpu")
    reg = ArtifactRegistry()
    reg.register("raw", dm)
    assert reg.get("raw").store.device.type == "cpu"
    rng = np.random.default_rng(17)
    with ServeEngine(reg, max_batch=8, batch_wait_ms=1.0) as eng:
        base = eng.warmup(img=IMG)
        assert base["raw"] == dm.trace_count == 4
        assert [e["bucket"] for e in dm.compile_log] == [1, 2, 4, 8]
        assert eng.metrics.compile_snapshot()["compile_events"] == 4
        eng.submit_register("c0", _frames(rng, 2)).result(60)
        eng.submit_register("c1", _frames(rng, 2)).result(60)
        res = eng.submit_classify(_frames(rng, 3)).result(60)
        assert len(res.class_ids) == 3 and res.artifact == "raw"
        assert eng.trace_counts() == base


def test_engine_stop_is_idempotent(served):
    _, pt, _, tpipe = served
    rng = np.random.default_rng(5)
    eng = _engine(tpipe, pt, start=False)
    eng.stop()
    eng.stop()
    eng.start()
    eng.submit_register("c", _frames(rng, 2)).result(timeout=60)
    eng.stop()
    eng.stop()
    with pytest.raises(ServeOverload, match="stopped"):
        eng.submit_classify(_frames(rng, 1))
    eng.start()
    assert eng.submit_classify(_frames(rng, 1)).result(60).class_ids == ["c"]
    eng.stop()
    eng2 = _engine(tpipe, pt)
    eng2.stop(drain=False)
    eng2.stop(drain=False)


def test_registry_metadata_default_adapter_and_bucketing():
    reg = ArtifactRegistry()
    reg.register("a", lambda x: x, meta={"weight_bytes": 123, "knee": True},
                 device="cpu")
    reg.register("b", lambda x: x, device="cpu")
    assert reg.get("a").meta["weight_bytes"] == 123 and reg.get("b").meta == {}
    md = reg.metadata()
    md["a"]["knee"] = False
    assert reg.get("a").meta["knee"] and reg.default_name == "a"
    with pytest.raises(KeyError):
        reg.set_default("zz")
    ad = default_adapter()
    assert isinstance(ad, FSLAdapter) and sorted(ad.kinds) == ["classify",
                                                               "register"]
    assert all(isinstance(k, RequestKind) for k in ad.kinds.values())
    x = np.ones((3, 2, 2, 1), np.float32)
    padded, n, b = pad_to_bucket(x, (1, 2, 4))
    assert (n, b, padded.shape[0]) == (3, 4, 4) and (padded[3:] == 0).all()


def test_deploy_warmup_cache_is_not_ported(served):
    """The compile cache is ported now (its contracts:
    ``tests/test_torch_compile_cache.py``): both warmups consult a given
    cache for every bucket not yet warm, so one without ``CompileCache``'s
    interface is refused, never ignored."""
    _, pt, _, tpipe = served
    feats = tpipe.deploy(pt, datapath="int")
    with pytest.raises(AttributeError, match="key"):
        feats.warmup([32], img=IMG, cache=object())
    with pytest.raises(AttributeError, match="key"):
        feats.deployed_model.warmup([32], np.zeros((1, IMG, IMG, 3),
                                                   np.float32), cache=object())
    assert 32 not in [e["bucket"] for e in feats._exec.compile_log]


# ---------------------------------------------------------------------------
# soak: >= 1000 mixed requests, no retrace after warmup
# ---------------------------------------------------------------------------
def test_soak_1000_mixed_requests_zero_retrace(served):
    _, pt, _, tpipe = served
    plan = _plan(np.random.default_rng(42), 1000, 8, p_register=0.15)
    with _engine(tpipe, pt, max_batch=32, max_queue=256) as eng:
        base = eng.warmup(img=IMG)
        futs = [eng.submit_register(c, x, timeout=30.0) if kind == "register"
                else eng.submit_classify(x, timeout=30.0)
                for kind, c, x in plan]
        results = [f.result(timeout=120) for f in futs]
        assert len(results) == 1000
        assert eng.trace_counts() == base, "ran a new shape under load"
        snap = eng.metrics.snapshot()
        assert snap["completed"] == 1000
        assert snap["rejected"] == 0 and snap["failed"] == 0
        assert 1 < snap["max_queue_depth"] <= 256
        assert snap["mean_batch"] > 2.0
        store = eng.registry.get("int").store
    means, ids = store.prototypes()
    for c, mean in _offline(tpipe.deploy(pt, datapath="int"), plan).items():
        np.testing.assert_array_equal(means[ids.index(c)], mean.numpy())
