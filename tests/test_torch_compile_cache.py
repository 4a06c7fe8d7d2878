"""The port's persistent compile cache on the CPU, against the reference's
contract (``tests/test_cluster.py``).

``CompileCache`` keeps the reference's methods and counters: a round trip
through a fresh cache object, ``get_or_compile`` counts, content-sensitive
keys, and a corrupt entry as a counted, evicted miss.  What an entry holds
differs by design: a verified warm record per bucket (the SHA-256 of the
bucket's first outputs), not an executable.  So a restore captures (on the
CPU: runs eagerly) again and counts in ``trace_count``, where the
reference counts 0; it checks the first outputs against the record and
raises on a mismatch.  The warmups of ``DeployedModel`` (single and
multi-input), the flip ensemble and ``DecodeArtifact`` go through it, and
the restored artifacts compute bit for bit what the first ones did and
what the JAX artifacts restored from the reference's cache compute.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro  # noqa: E402
from repro.ckpt import CompileCache as JCompileCache  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import resnet9 as jresnet9  # noqa: E402
from repro_torch.ckpt import CompileCache  # noqa: E402
from repro_torch.ckpt import compile_cache as CC  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.deploy import compile as tcompile  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.fsl.pipeline import FSLPipeline  # noqa: E402
from repro_torch.serve import ServeMetrics  # noqa: E402

WIDTH, IMG = 4, 16
QCFG = QuantConfig.paper_w6a4()


@pytest.fixture(scope="module")
def params():
    pj = jax.tree_util.tree_map(np.asarray, jresnet9.init_params(
        jax.random.PRNGKey(0), WIDTH))
    return pj, params_from_numpy(pj, device="cpu")


def _dm(pt):
    return tcompile(pt, QCFG, recipe="resnet9", datapath="int", device="cpu")


def _record(n=4):
    return {"sha256": np.arange(n, dtype=np.uint8), "bucket": 2,
            "name": "x", "signature": [[[2, 3], "float32"]], "warm_s": 0.5}


# ---------------------------------------------------------------------------
# the store itself
# ---------------------------------------------------------------------------
def test_compile_cache_roundtrip(tmp_path):
    """store -> a fresh cache object (nothing in memory) -> load gives the
    same value back; evict -> a miss; the reference's stats."""
    cache = CompileCache(str(tmp_path))
    key = cache.key(kind="test", shape=[8])
    rec = _record()
    cache.store(key, rec, meta={"artifact": "x"})
    assert cache.has(key) and key in cache.keys()
    got = CompileCache(str(tmp_path)).load(key)
    assert set(got) == set(rec)
    np.testing.assert_array_equal(got["sha256"], rec["sha256"])
    assert got["sha256"].dtype == np.uint8
    assert {k: got[k] for k in rec if k != "sha256"} == \
        {k: rec[k] for k in rec if k != "sha256"}
    assert cache.mgr.named_meta(key)["artifact"] == "x"
    cache.evict(key)
    assert not cache.has(key)
    assert cache.load(key) is None
    st = cache.stats()
    assert st["stores"] == 1 and st["misses"] == 1 and st["entries"] == 0
    assert set(st) == set(JCompileCache(str(tmp_path / "j")).stats())


def test_compile_cache_get_or_compile_counts(tmp_path):
    cache = CompileCache(str(tmp_path))
    calls = []

    def compile_fn():
        calls.append(1)
        return _record()

    key = cache.key(kind="goc")
    v1, hit1, s1 = cache.get_or_compile(key, compile_fn)
    assert not hit1 and len(calls) == 1 and s1 > 0
    v2, hit2, s2 = cache.get_or_compile(key, compile_fn)
    assert hit2 and len(calls) == 1 and s2 > 0          # no second build
    np.testing.assert_array_equal(v1["sha256"], v2["sha256"])
    assert cache.stats() == {"hits": 1, "misses": 1, "stores": 1,
                             "load_errors": 0, "entries": 1}


def test_compile_cache_method_set_matches_reference():
    names = ("key", "store", "load", "has", "keys", "evict",
             "get_or_compile", "stats")
    for n in names:
        assert callable(getattr(CompileCache, n))
        assert callable(getattr(JCompileCache, n))


def test_compile_cache_keys_are_content_sensitive(tmp_path):
    cache = CompileCache(str(tmp_path))
    assert cache.key(a=1) == cache.key(a=1)
    assert cache.key(a=1) != cache.key(a=2)
    assert cache.key(a=1) != cache.key(a=1, b=0)
    assert cache.key(a=1) == cache.key(a=1, device="cpu")  # the CPU here


def test_compile_cache_key_follows_the_environment(tmp_path, monkeypatch):
    """The device name and capability, torch and CUDA versions and the
    kernel sources' digest are all in the key: any change is a miss."""
    from repro_torch.kernels import build

    cache = CompileCache(str(tmp_path))
    base = cache.key(a=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: (9, 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    h100 = cache.key(a=1, device="cuda")
    assert h100 != base
    assert cache.key(a=1, device="cuda:0") == h100
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: (8, 0))
    assert cache.key(a=1, device="cuda") != h100
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA A100-SXM4-80GB")
    a100 = cache.key(a=1, device="cuda")
    assert a100 not in (h100, base)
    monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    assert cache.key(a=1, device="cpu") != base
    monkeypatch.undo()
    assert cache.key(a=1, device="cpu") == base
    monkeypatch.setattr(torch.version, "cuda", "99.9")
    assert cache.key(a=1, device="cpu") != base
    monkeypatch.undo()
    monkeypatch.setattr(build, "_digest", lambda: "0" * 16)
    assert cache.key(a=1, device="cpu") != base


@pytest.mark.parametrize("damage", ["overwrite", "missing_array"])
def test_compile_cache_corrupt_entry_is_clean_miss(tmp_path, damage):
    """A present-but-unloadable entry loads as None, counted in
    ``load_errors`` and ``misses``, and is evicted."""
    cache = CompileCache(str(tmp_path))
    key = cache.key(kind="corrupt")
    cache.store(key, _record())
    entry = cache.mgr._named_dir(key)
    if damage == "overwrite":
        for fname in os.listdir(entry):
            with open(os.path.join(entry, fname), "wb") as f:
                f.write(b"not a warm record")
    else:
        np.savez(os.path.join(entry, "arrays.npz"), other=np.zeros(2))
    assert cache.load(key) is None
    st = cache.stats()
    assert st["load_errors"] == 1 and st["misses"] == 1 and st["hits"] == 0
    assert not cache.has(key)


def test_output_digest_sees_dtype_shape_and_bits():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    d = CC.output_digest([a])
    assert d == CC.output_digest([a.clone()]) and len(d) == 64
    assert d != CC.output_digest([a.reshape(3, 2)])
    assert d != CC.output_digest([a.to(torch.int32)])
    b = a.clone()
    b[1, 2] = torch.nextafter(b[1, 2], torch.tensor(10.0))
    assert d != CC.output_digest([b])
    assert d != CC.output_digest([a, a])
    CC.output_digest([a.to(torch.bfloat16), a.t()])      # any dtype, strides


# ---------------------------------------------------------------------------
# warmup through the cache
# ---------------------------------------------------------------------------
def test_deployed_warmup_cache_restore_bitforbit(params, tmp_path):
    """Cold warmup publishes one record per bucket; a fresh compile of the
    same params warms through the cache (cached, checked) and serves bit
    for bit.  The restore's eager runs count in ``trace_count``: a
    decided difference from the reference's 0."""
    pj, pt = params
    cache = CompileCache(str(tmp_path))
    ex = np.zeros((1, IMG, IMG, 3), np.float32)
    dm1 = _dm(pt)
    dm1.warmup([1, 2], example=ex, cache=cache)
    assert dm1.trace_count == 2
    assert [e["cached"] for e in dm1.compile_log] == [False, False]
    assert cache.stats()["stores"] == 2
    x = np.random.default_rng(3).random((2, IMG, IMG, 3)).astype(np.float32)
    want = dm1(x).numpy()

    dm2 = _dm(pt)
    assert dm2.fingerprint() == dm1.fingerprint()
    metrics = ServeMetrics()
    dm2.warmup([1, 2], example=ex, cache=cache, metrics=metrics, label="dm2")
    assert [e["cached"] for e in dm2.compile_log] == [True, True]
    assert [e["key"] for e in dm2.compile_log] == \
        [e["key"] for e in dm1.compile_log]
    assert dm2.trace_count == 2                 # restored: run again, checked
    np.testing.assert_array_equal(dm2(x).numpy(), want)
    np.testing.assert_array_equal(dm2.batched(x[:1]).numpy(), want[:1])
    assert dm2.trace_count == 2
    cs = metrics.compile_snapshot()
    assert cs["compile_events"] == 2 and cs["compile_cached"] == 2
    assert cs["compile_fresh_s"] == 0.0
    assert cache.stats() == {"hits": 2, "misses": 2, "stores": 2,
                             "load_errors": 0, "entries": 2}
    dm2.warmup([1, 2], example=ex, cache=cache)  # already warm: a no-op
    assert len(dm2.compile_log) == 2 and cache.stats()["hits"] == 2

    # the reference's cache on the same params: the same outputs restored
    jcache = JCompileCache(str(tmp_path / "jax"))
    for _ in range(2):
        jdm = repro.compile(pj, JQuantConfig.paper_w6a4(), recipe="resnet9",
                            datapath="int")
        jdm.warmup([1, 2], example=ex, cache=jcache)
    assert [e["cached"] for e in jdm.compile_log] == \
        [e["cached"] for e in dm2.compile_log]
    np.testing.assert_array_equal(np.asarray(jdm(x)), want)


def test_warmup_digest_mismatch_raises(params, tmp_path):
    """A record whose digest the restored bucket does not reproduce fails
    loudly, and the bucket is not left warm."""
    _, pt = params
    cache = CompileCache(str(tmp_path))
    ex = np.zeros((1, IMG, IMG, 3), np.float32)
    dm1 = _dm(pt)
    dm1.warmup([2], example=ex, cache=cache)
    (key,) = cache.keys()
    rec = cache.load(key)
    rec["sha256"] = (rec["sha256"] ^ np.uint8(1)).astype(np.uint8)
    cache.store(key, rec)
    dm2 = _dm(pt)
    with pytest.raises(CC.WarmDigestMismatch, match="computes differently"):
        dm2.warmup([2], example=ex, cache=cache)
    assert dm2.trace_count == 0 and dm2.compile_log == []
    assert cache.has(key)                       # the record is not replaced


def test_warmup_keys_follow_the_artifact(params, tmp_path):
    """Other weights, another datapath or another bucket shape is another
    key: never a wrong hit."""
    _, pt = params
    cache = CompileCache(str(tmp_path))
    ex = np.zeros((1, IMG, IMG, 3), np.float32)
    _dm(pt).warmup([1], example=ex, cache=cache)
    other = {k: dict(v) for k, v in pt.items()}
    other["r1a"]["w"] = other["r1a"]["w"] * 0.5
    _dm(other).warmup([1], example=ex, cache=cache)
    tcompile(pt, QCFG, recipe="resnet9", datapath="f32",
             device="cpu").warmup([1], example=ex, cache=cache)
    _dm(pt).warmup([1], example=np.zeros((1, 8, 8, 3), np.float32),
                   cache=cache)
    assert cache.stats()["hits"] == 0 and len(cache.keys()) == 4


def test_pipeline_deploy_warmup_cache_restore(params, tmp_path):
    """The flip ensemble the engine serves: the reference's ``fused-feats``
    key, restored and checked, bit for bit."""
    _, pt = params
    cache = CompileCache(str(tmp_path))
    f1 = FSLPipeline(width=WIDTH, qcfg=QCFG, device="cpu").deploy(pt, "int")
    f1.warmup([1, 2], img=IMG, cache=cache)
    x = np.random.default_rng(5).random((2, IMG, IMG, 3)).astype(np.float32)
    want = f1(x).numpy()
    f2 = FSLPipeline(width=WIDTH, qcfg=QCFG, device="cpu").deploy(pt, "int")
    assert f2 is not f1
    f2.warmup([1, 2], img=IMG, cache=cache)
    assert [e["cached"] for e in f2._exec.compile_log] == [True, True]
    np.testing.assert_array_equal(f2(x).numpy(), want)
    assert f2.trace_count() == 2
    assert cache.stats()["hits"] == 2 and cache.stats()["stores"] == 2
    # the bare DeployedModel at the same bucket is a different entry
    f2.deployed_model.warmup([1], np.zeros((1, IMG, IMG, 3), np.float32),
                             cache=cache)
    assert cache.stats()["stores"] == 3


def test_decode_artifact_warmup_cache_restore(tmp_path):
    """Multi-input warmup (lm-tiny's decode graph, one record per batch
    bucket x KV capacity) through the cache."""
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.serve import build_decode_artifact

    cfg = get_config("lm-tiny")
    p = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = CompileCache(str(tmp_path))

    def art():
        return build_decode_artifact(p, cfg, datapath="int",
                                     capacities=(8, 16), verify=False,
                                     device="cpu")

    a1 = art()
    a1.warmup((1, 2), cache=cache)
    assert cache.stats() == {"hits": 0, "misses": 4, "stores": 4,
                             "load_errors": 0, "entries": 4}
    a2 = art()
    metrics = ServeMetrics()
    a2.warmup((1, 2), cache=cache, metrics=metrics)
    assert [e["cached"] for e in a2.dm.compile_log] == [True] * 4
    assert metrics.compile_snapshot()["compile_cached"] == 4
    assert cache.stats()["hits"] == 4 and cache.stats()["stores"] == 4
    feeds = lm.example_decode_feeds(cfg, batch=2, capacity=8)
    args = [feeds[n] for n in a1.dm.input_names]
    for o1, o2 in zip(a1.dm(*args), a2.dm(*args)):
        np.testing.assert_array_equal(o1.numpy(), o2.numpy())
