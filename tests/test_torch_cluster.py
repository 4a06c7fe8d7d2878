"""The port's multi-tenant serving cluster on the CPU, against the JAX
package's (``repro.serve.cluster``, ``tests/test_cluster.py``).

The same seeded numpy traffic (ResNet-9 width 4, 16x16 frames,
``paper_w6a4()``, the int flip ensemble) goes through both packages'
``ServeCluster`` over a ``sharded_tenant_registry`` with a compile cache,
then through a cold restart from the same cache directory: features bit
for bit with JAX; prototypes within 1e-5 of JAX (the NCM row norms'
tolerance) and bit for bit with the port's offline recompute over each
tenant's own shots; class ids equal; per-tenant metrics equal.  Then the
reference's contracts in the port: tenant namespacing, isolation and
default swap; quotas that never spill to another replica while a full
replica fails over; the one-device sharded head equal to the serial store
bit for bit and more devices refused; the serial halves of ``dist``; and a
multi-tenant run from 4 client threads with a flooding tenant.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.ckpt import CompileCache as JCompileCache  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.fsl.pipeline import FSLPipeline as JFSLPipeline  # noqa: E402
from repro.models import resnet9 as jresnet9  # noqa: E402
from repro.serve.cluster import ServeCluster as JServeCluster  # noqa: E402
from repro.serve.cluster import TenantRegistry as JTenantRegistry  # noqa: E402
from repro.serve.cluster import \
    sharded_tenant_registry as j_sharded_registry  # noqa: E402
from repro_torch.ckpt import CompileCache  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.dist import act_sharding  # noqa: E402
from repro_torch.dist.sharding import prototype_spec, serve_mesh  # noqa: E402
from repro_torch.fsl import ncm  # noqa: E402
from repro_torch.fsl.pipeline import FSLPipeline  # noqa: E402
from repro_torch.obs import RingBufferExporter, Tracer  # noqa: E402
from repro_torch.serve import PrototypeStore, ServeOverload  # noqa: E402
from repro_torch.serve.cluster import (  # noqa: E402
    ServeCluster,
    ShardedNCMHead,
    ShardedStore,
    TenantOverQuota,
    TenantRegistry,
    sharded_tenant_registry,
)

WIDTH, IMG = 4, 16
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def served():
    pj = jax.tree_util.tree_map(np.asarray, jresnet9.init_params(
        jax.random.PRNGKey(0), WIDTH))
    return pj, params_from_numpy(pj, device="cpu")


def _frames(rng, n):
    return rng.random((n, IMG, IMG, 3)).astype(np.float32)


def _flat_feats(x):
    # a backbone stand-in for routing tests: no compile needed
    return np.asarray(x, np.float32).reshape(len(x), -1)


def _treg():
    return TenantRegistry(device="cpu")


def _tpipe():
    return FSLPipeline(width=WIDTH, qcfg=QuantConfig.paper_w6a4(),
                       device="cpu")


# ---------------------------------------------------------------------------
# TenantRegistry: namespaces, isolation, defaults (the reference's cases,
# the same calls on both registries)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make", [_treg, JTenantRegistry],
                         ids=["torch", "jax"])
def test_tenant_registry_namespacing_and_isolation(make):
    reg = make()
    with pytest.raises(ValueError):
        reg.add_tenant("early")                          # no backbone yet
    reg.register_backbone("bb", _flat_feats, default=True)
    reg.add_tenant("acme")
    reg.add_tenant("acme")                               # idempotent
    reg.add_tenant("bob")
    assert reg.resolve("acme") == "acme/bb"
    assert reg.resolve("acme", "bb") == "acme/bb"
    assert reg.get("acme/bb").feats is _flat_feats       # shared backbone
    assert reg.get("bob/bb").feats is _flat_feats
    reg.tenant_store("acme").register("c", np.ones((1, 4), np.float32))
    assert len(reg.tenant_store("acme")) == 1
    assert len(reg.tenant_store("bob")) == 0
    assert len(reg.get("bb").store) == 0
    assert reg.tenants() == ("acme", "bob")
    assert reg.backbone_names() == ("bb",)
    assert reg.names() == ("acme/bb", "bb", "bob/bb")
    assert reg.metadata()["acme/bb"] == {"tenant": "acme", "backbone": "bb"}


@pytest.mark.parametrize("make", [_treg, JTenantRegistry],
                         ids=["torch", "jax"])
def test_tenant_registry_unknown_names_raise(make):
    reg = make()
    reg.register_backbone("bb", _flat_feats, default=True)
    reg.add_tenant("acme")
    with pytest.raises(KeyError):
        reg.resolve("ghost")                             # never auto-created
    with pytest.raises(KeyError):
        reg.resolve("acme", "nope")
    with pytest.raises(KeyError):
        reg.add_tenant("z", default_backbone="nope")
    with pytest.raises(ValueError):
        reg.add_tenant("bad/name")                       # separator reserved
    with pytest.raises(ValueError):
        reg.register_backbone("a/b", _flat_feats)
    with pytest.raises(ValueError):
        reg.add_tenant("")


@pytest.mark.parametrize("make", [_treg, JTenantRegistry],
                         ids=["torch", "jax"])
def test_tenant_registry_backbone_after_tenant_and_default_swap(make):
    reg = make()
    reg.register_backbone("w6", _flat_feats, default=True)
    reg.add_tenant("acme")
    reg.register_backbone("w4", _flat_feats)             # late backbone
    assert reg.resolve("acme", "w4") == "acme/w4"        # view auto-created
    assert reg.resolve("acme") == "acme/w6"
    reg.set_tenant_default("acme", "w4")                 # per-tenant A/B swap
    assert reg.resolve("acme") == "acme/w4"
    with pytest.raises(KeyError):
        reg.set_tenant_default("acme", "nope")


def test_tenant_stores_follow_the_backbone_device(served):
    """Without a registry device, each view's store lies where its
    backbone runs (the pipeline's ``device``); a toy backbone with no
    device and no registry device would default to the card."""
    _, pt = served
    reg = TenantRegistry()
    reg.register_backbone("int", _tpipe().deploy(pt, "int"), default=True)
    reg.add_tenant("acme")
    assert reg.tenant_store("acme").device.type == "cpu"
    assert reg.get("int").store.device.type == "cpu"


# ---------------------------------------------------------------------------
# the sharded head on one device, and the serial halves of dist/
# ---------------------------------------------------------------------------
def test_sharded_head_single_device_serial_path():
    head = ShardedNCMHead()
    assert head.mesh is None and head.n_dev == 1
    rng = np.random.default_rng(4)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    m = rng.normal(size=(3, 8)).astype(np.float32)
    want = PrototypeStore(device="cpu")._sims(torch.from_numpy(q),
                                              torch.from_numpy(m))
    got = head.sims(q, m)
    assert torch.equal(got, want)
    assert torch.equal(head.sims(torch.from_numpy(q), torch.from_numpy(m)),
                       want)
    assert tuple(head.sims(q, np.zeros((0, 8), np.float32)).shape) == (5, 0)
    # the reference's head on the same inputs, within the row norms'
    # tolerance
    from repro.serve.cluster import ShardedNCMHead as JHead
    np.testing.assert_allclose(got.numpy(), JHead().sims(q, m), **TOL)


def test_sharded_store_matches_plain_store_bitforbit():
    rng = np.random.default_rng(6)
    f = rng.normal(size=(10, 8)).astype(np.float32)
    plain = PrototypeStore(device="cpu")
    sharded = ShardedStore(ShardedNCMHead(), device="cpu")
    for cid in range(5):
        plain.register(cid, f[2 * cid:2 * cid + 2])
        sharded.register(cid, f[2 * cid:2 * cid + 2])
    np.testing.assert_array_equal(plain.prototypes()[0],
                                  sharded.prototypes()[0])
    for n in (1, 3, 4, 7):
        q = rng.normal(size=(n, 8)).astype(np.float32)
        ids_p, sims_p = plain.classify(q)
        ids_s, sims_s = sharded.classify(q)
        assert ids_p == ids_s
        np.testing.assert_array_equal(sims_p, sims_s)
    ids1, sims1 = sharded.classify(q[0])                 # 1-D promotion
    assert ids1 == [ids_s[0]] and sims1.shape == (1, 5)
    sharded.prime(8, (1, 2, 4))


def test_head_rows_do_not_depend_on_their_batch():
    """A query's similarities are the same bits alone, among 7 others and
    past one block of HEAD_ROWS rows."""
    from repro_torch.serve.store import HEAD_ROWS, head_sims

    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(HEAD_ROWS + 9, 16)).astype(
        np.float32))
    m = ncm._l2(torch.from_numpy(rng.normal(size=(5, 16)).astype(
        np.float32)))
    full = head_sims(q, m)
    assert full.shape == (HEAD_ROWS + 9, 5)
    for lo, hi in ((0, 1), (3, 11), (HEAD_ROWS - 2, HEAD_ROWS + 9)):
        assert torch.equal(head_sims(q[lo:hi], m), full[lo:hi])
    assert head_sims(q[:0], m).shape == (0, 5)


def test_sharded_tenant_registry_shares_one_head():
    reg = sharded_tenant_registry(device="cpu")
    reg.register_backbone("bb", _flat_feats, default=True)
    reg.add_tenant("t1")
    reg.add_tenant("t2")
    s1, s2 = reg.tenant_store("t1"), reg.tenant_store("t2")
    assert isinstance(s1, ShardedStore) and isinstance(s2, ShardedStore)
    assert s1 is not s2 and s1.head is s2.head           # state private,
    assert reg.get("bb").store.head is s1.head           # compute shared


@pytest.mark.parametrize("devices", [["cuda:0", "cuda:1"], list(range(4))])
def test_more_than_one_device_is_not_ported(devices):
    """More than one device needs the caller's process group of as many
    ranks: without one, the head raises rather than starting a group (the
    head over ranks: tests/test_torch_dist_ranks.py)."""
    with pytest.raises(RuntimeError, match="initialized process group"):
        serve_mesh(devices)
    with pytest.raises(RuntimeError):
        ShardedNCMHead(devices)
    with pytest.raises(RuntimeError):
        sharded_tenant_registry(devices)


def test_serve_mesh_and_prototype_spec_serial_rules():
    assert serve_mesh() is None and serve_mesh(["cpu"]) is None
    assert serve_mesh([]) is None
    # divisibility-or-replicate, the reference's rule
    assert prototype_spec(8, 4).split and prototype_spec(4, 4).split
    assert not prototype_spec(6, 4).split and not prototype_spec(0, 4).split
    assert prototype_spec(3, 1).split and prototype_spec(3, 1).n_dev == 1
    assert prototype_spec(3, 1, axis="data").axis == "data"
    # the reference on a one-device mesh agrees
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.dist.sharding import prototype_spec as jspec
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    for n in (0, 1, 5):
        assert (jspec(n, mesh) == P("model", None)) == \
            prototype_spec(n, 1).split


def test_act_sharding_rules_nest_and_constrain_is_identity():
    x = torch.ones(3)
    assert act_sharding.get_rule("serve/query_rows") is None
    assert act_sharding.constrain(x, "serve/query_rows") is x
    with act_sharding.rules({"a": 1, "b": 2}):
        assert act_sharding.get_rule("a") == 1
        with act_sharding.rules({"a": 3}):
            assert (act_sharding.get_rule("a"),
                    act_sharding.get_rule("b")) == (3, 2)
            assert act_sharding.constrain(x, "a") is x
        assert act_sharding.get_rule("a") == 1
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            act_sharding.get_rule("a")))
        t.start()
        t.join()
        assert seen == [None]                            # thread-local
    assert act_sharding.get_rule("a") is None


# ---------------------------------------------------------------------------
# routing: home replicas, quota without spill, failover on a full replica
# ---------------------------------------------------------------------------
def test_cluster_needs_at_least_one_replica():
    with pytest.raises(ValueError):
        ServeCluster(_treg(), replicas=0)


def test_cluster_home_affinity_quota_no_spill_and_failover():
    reg = _treg()
    reg.register_backbone("bb", _flat_feats, default=True)
    rng = np.random.default_rng(0)
    ring = RingBufferExporter()
    cluster = ServeCluster(reg, replicas=2, max_batch=4, max_queue=3,
                           tenant_quota=2, tracer=Tracer(ring), start=False)
    try:
        for t in ("a", "b", "c"):
            cluster.add_tenant(t)
        assert [cluster.home_replica(t) for t in "abc"] == [0, 1, 0]
        with pytest.raises(KeyError):
            cluster.home_replica("nobody")
        with pytest.raises(KeyError):
            cluster.submit_classify("ghost", _frames(rng, 1))
        # engines are stopped: admitted work sits in the queues
        for _ in range(2):
            cluster.submit_classify("a", _frames(rng, 1))
        with pytest.raises(TenantOverQuota):             # no spill to 1
            cluster.submit_classify("a", _frames(rng, 1))
        cluster.submit_classify("c", _frames(rng, 1))    # replica 0 full
        fut = cluster.submit_classify("c", _frames(rng, 1))   # fails over
        assert cluster.engines[1].tenant_queue_depths() == {"c": 1}
        cluster.submit_classify("b", _frames(rng, 1))
        cluster.submit_classify("b", _frames(rng, 1))
        with pytest.raises(TenantOverQuota):
            cluster.submit_classify("b", _frames(rng, 1))
        with pytest.raises(ServeOverload) as exc:         # both full
            cluster.submit_classify("c", _frames(rng, 1))
        assert not isinstance(exc.value, TenantOverQuota)
    finally:
        for eng in cluster.engines:
            eng.stop(drain=False)
    routes = [e for e in ring.events() if e["name"] == "cluster.route"]
    (over,) = [e for e in routes if e["trace"] == fut.trace_id]
    assert over["attrs"]["failovers"] == 1 and over["attrs"]["replica"] == 1
    assert [e["status"] for e in routes].count("rejected:over_quota") == 2
    assert routes[-1]["status"] == "rejected:overload"
    snap = cluster.metrics_snapshot()
    assert set(snap) == {"replicas", "tenants", "compile_s", "completed",
                         "rejected", "over_quota"}
    # each replica counts its own rejections: 2 over quota, replica 0's
    # refusal before the failover, and both refusals of the last submit
    assert snap["over_quota"] == 2 and snap["rejected"] == 5
    assert snap["tenants"]["a"]["over_quota"] == 1


# ---------------------------------------------------------------------------
# the same traffic through both clusters, and a cold restart
# ---------------------------------------------------------------------------
def _traffic(rng):
    shots = {t: {f"cls{c}": _frames(rng, 2) for c in range(2)}
             for t in ("acme", "bob")}
    queries = [("acme", _frames(rng, 3)), ("bob", _frames(rng, 1)),
               ("acme", _frames(rng, 2)), ("bob", _frames(rng, 4))]
    return shots, queries


def _run_cluster(cls, reg_fn, cache, shots, queries, replicas):
    """Register every tenant's shots, then classify, sequentially (so both
    packages fold the same rows in the same order)."""
    reg = reg_fn()
    with cls(reg, replicas=replicas, max_batch=4, batch_wait_ms=1.0,
             tenant_quota=0.5, compile_cache=cache) as cluster:
        for t in shots:
            cluster.add_tenant(t)
        base = cluster.warmup(img=IMG)
        for t, by_class in shots.items():
            for c, x in by_class.items():
                assert cluster.submit_register(t, c, x).result(60) == 2
        results = [cluster.submit_classify(t, x).result(60)
                   for t, x in queries]
        assert cluster.trace_counts() == base            # nothing new
        snap = cluster.metrics_snapshot()
        stores = {t: reg.tenant_store(t).prototypes() for t in shots}
    return base, results, snap, stores


def test_cluster_end_to_end_and_cold_restart_vs_jax(served, tmp_path):
    pj, pt = served
    shots, queries = _traffic(np.random.default_rng(9))
    jfeats = JFSLPipeline(width=WIDTH, qcfg=JQuantConfig.paper_w6a4()
                          ).deploy(pj, datapath="int")
    tfeats = _tpipe().deploy(pt, datapath="int")
    for by_class in shots.values():              # features: bit for bit
        for x in by_class.values():
            np.testing.assert_array_equal(tfeats(x).numpy(),
                                          np.asarray(jfeats(x)))

    def jreg():
        reg = j_sharded_registry()
        reg.register_backbone("w6a4-int", JFSLPipeline(
            width=WIDTH, qcfg=JQuantConfig.paper_w6a4()).deploy(
                pj, datapath="int"), default=True)
        return reg

    def treg():
        reg = sharded_tenant_registry()
        reg.register_backbone("w6a4-int", _tpipe().deploy(pt, "int"),
                              default=True)
        return reg

    cache = CompileCache(str(tmp_path / "torch"))
    jcache = JCompileCache(str(tmp_path / "jax"))
    jbase, jres, jsnap, jstores = _run_cluster(JServeCluster, jreg, jcache,
                                               shots, queries, 2)
    base, res, snap, stores = _run_cluster(ServeCluster, treg, cache, shots,
                                           queries, 2)
    # the port captures (here: runs eagerly) each bucket once, per backbone
    assert base == {n: 3 for n in ("w6a4-int", "acme/w6a4-int",
                                   "bob/w6a4-int")}
    assert cache.stats() == {"hits": 0, "misses": 3, "stores": 3,
                             "load_errors": 0, "entries": 3}
    assert jcache.stats()["stores"] == cache.stats()["stores"]
    for t in shots:
        (tm, tids), (jm, jids) = stores[t], jstores[t]
        assert tids == jids == tuple(shots[t])
        np.testing.assert_allclose(tm, jm, **TOL)
        sup = torch.cat([tfeats(x) for x in shots[t].values()])
        labs = torch.as_tensor(np.repeat(np.arange(2), 2))
        np.testing.assert_array_equal(tm,
                                      ncm.class_means(sup, labs, 2).numpy())
    for r, jr, (t, _) in zip(res, jres, queries):
        assert r.artifact == jr.artifact == f"{t}/w6a4-int"
        assert r.class_ids == jr.class_ids
        np.testing.assert_allclose(r.sims, jr.sims, **TOL)
    for k in ("completed", "rejected", "over_quota"):
        assert snap[k] == jsnap[k]
    assert snap["tenants"] == jsnap["tenants"]
    assert snap["completed"] == 8 and snap["compile_s"] > 0

    # -- cold restart: fresh pipeline and registry, warm through the cache --
    _, jres2, _, _ = _run_cluster(JServeCluster, jreg, jcache, shots,
                                  queries, 1)
    base2, res2, snap2, stores2 = _run_cluster(ServeCluster, treg, cache,
                                               shots, queries, 1)
    assert cache.stats()["stores"] == 3                  # nothing republished
    assert cache.stats()["hits"] == 3                    # one per bucket
    assert base2 == base                                 # captured again
    for r, r2, jr2 in zip(res, res2, jres2):
        assert r2.class_ids == r.class_ids == jr2.class_ids
        np.testing.assert_array_equal(r2.sims, r.sims)
    for t in shots:
        np.testing.assert_array_equal(stores2[t][0], stores[t][0])
    assert snap2["replicas"][0]["completed"] == 8


def test_cluster_add_replica_warms_from_shared_artifacts(served, tmp_path):
    _, pt = served
    reg = sharded_tenant_registry()
    reg.register_backbone("int", _tpipe().deploy(pt, "int"), default=True)
    cache = CompileCache(str(tmp_path))
    rng = np.random.default_rng(21)
    with ServeCluster(reg, replicas=1, max_batch=2, batch_wait_ms=1.0,
                      compile_cache=cache) as cluster:
        cluster.add_tenant("t")
        base = cluster.warmup(img=IMG)
        stats = cache.stats()
        cluster.add_replica()                            # shares warm graphs
        assert len(cluster.engines) == 2
        assert cache.stats() == stats                    # nothing looked up
        assert cluster.trace_counts() == base
        cluster.submit_register("t", "c", _frames(rng, 1)).result(60)
        for _ in range(4):
            r = cluster.submit_classify("t", _frames(rng, 1)).result(60)
            assert r.class_ids == ["c"]
        assert cluster.trace_counts() == base
        completed = sum(eng.metrics.snapshot()["completed"]
                        for eng in cluster.engines)
        assert completed == 5
        log = cluster.engines[1].metrics.compile_snapshot()
        assert log["compile_events"] == 0


def test_cluster_many_tenants_from_threads_with_a_flooder(served, tmp_path):
    """The chip phase at test size: 8 tenants of 2 classes x 2 shots on the
    int backbone, one tenant switched to the f32 backbone, classify
    requests of 1-4 frames from 4 client threads, and one tenant flooding
    the live cluster past its quota.  No request fails,
    the flooder's rejections are all ``TenantOverQuota``, nothing is
    captured after warmup, every tenant's prototypes equal an offline
    recompute, and each served answer equals the same query through the
    tenant's store directly."""
    _, pt = served
    pipe = _tpipe()
    feats = {"int": pipe.deploy(pt, "int"), "f32": pipe.deploy(pt, "f32")}
    reg = sharded_tenant_registry()
    reg.register_backbone("int", feats["int"], default=True)
    reg.register_backbone("f32", feats["f32"])
    rng = np.random.default_rng(11)
    tenants = [f"t{i}" for i in range(8)]
    shots = {t: {c: _frames(rng, 2) for c in range(2)} for t in tenants}
    plan = [(tenants[i % len(tenants)], _frames(rng, int(rng.integers(1, 5))))
            for i in range(96)]
    with ServeCluster(reg, replicas=2, max_batch=8, max_queue=64,
                      batch_wait_ms=1.0, tenant_quota=0.25,
                      compile_cache=CompileCache(str(tmp_path))) as cluster:
        for t in tenants:
            cluster.add_tenant(t)
        reg.set_tenant_default("t7", "f32")
        base = cluster.warmup(img=IMG)
        for t in tenants:
            for c, x in shots[t].items():
                cluster.submit_register(t, c, x).result(60)
        results, errors = {}, []

        def client(k):
            try:
                for i in range(k, len(plan), 4):
                    t, x = plan[i]
                    results[i] = cluster.submit_classify(t, x).result(60)
            except Exception as e:                        # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        flood_rejected, flood_futs = 0, []
        for _ in range(200):
            try:
                flood_futs.append(cluster.submit_classify(
                    "t0", _frames(rng, 1)))
            except TenantOverQuota:
                flood_rejected += 1
        for th in threads:
            th.join()
        for f in flood_futs:
            f.result(60)
        assert not errors, errors
        assert cluster.trace_counts() == base
        snap = cluster.metrics_snapshot()
    assert flood_rejected > 0
    assert snap["over_quota"] == flood_rejected == snap["rejected"]
    assert snap["completed"] == len(plan) + len(flood_futs) + 16
    assert all(s["failed"] == 0 for s in snap["tenants"].values())
    for t in tenants:
        bb = "f32" if t == "t7" else "int"
        store = reg.tenant_store(t)
        sup = torch.cat([feats[bb](x) for x in shots[t].values()])
        want = ncm.class_means(sup, torch.as_tensor([0, 0, 1, 1]), 2)
        np.testing.assert_array_equal(store.prototypes()[0], want.numpy())
    for i, (t, x) in enumerate(plan):
        bb = "f32" if t == "t7" else "int"
        assert results[i].artifact == f"{t}/{bb}"
        ids, sims = reg.tenant_store(t).classify(feats[bb](x))
        assert results[i].class_ids == ids
        np.testing.assert_array_equal(results[i].sims, sims)
