"""The port's tracing and metrics against the JAX package's.

``repro_torch.obs`` and ``repro_torch.serve.metrics`` are copies of pure
Python modules of the reference; fed the same recorded events they must
give the reference's ``snapshot()`` values and ``prometheus()`` text, and a
traced request through either engine must emit the same span names with
the same parent links.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.serve import ArtifactRegistry as JRegistry  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.metrics import ServeMetrics as JServeMetrics  # noqa: E402
from repro.serve.metrics import percentile as jpercentile  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.serve import ArtifactRegistry, ServeEngine  # noqa: E402
from repro_torch.serve.metrics import ServeMetrics, percentile  # noqa: E402


def _feed_metrics(m):
    """A fixed sequence of serving events, as an engine would record them."""
    for i, v in enumerate((0.1, 0.2, 0.3, 0.4, 0.5, 0.0123, 2.5)):
        m.record_request(v, tenant="a" if i % 2 else None)
    m.record_request(0.0, ok=False, tenant="b")
    m.record_batch(3, 4)
    m.record_batch(8, 8)
    m.record_rejected()
    m.record_rejected(tenant="b", over_quota=True)
    m.record_compile("int", 1, 0.25)
    m.record_compile("int", 2, 0.5, cached=True)
    m.record_cancelled()
    m.observe_queue_depth(7)
    m.observe_queue_depth(3)


def _fixed(snap):
    return {k: v for k, v in snap.items() if k != "throughput_rps"}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("window", [4, 10_000])
def test_serve_metrics_match_reference(window):
    t, j = ServeMetrics(window=window), JServeMetrics(window=window)
    _same(_fixed(t.snapshot()), _fixed(j.snapshot()))        # empty window
    _feed_metrics(t)
    _feed_metrics(j)
    _same(_fixed(t.snapshot()), _fixed(j.snapshot()))
    assert t.tenant_snapshot().keys() == j.tenant_snapshot().keys()
    for tenant in j.tenant_snapshot():
        _same(t.tenant_snapshot()[tenant], j.tenant_snapshot()[tenant])
    assert t.compile_snapshot() == j.compile_snapshot()
    assert t.prometheus() == j.prometheus()
    assert "p95" in t.report()
    t.reset_clock()
    j.reset_clock()
    _same(_fixed(t.snapshot()), _fixed(j.snapshot()))
    assert t.prometheus() == j.prometheus()


@pytest.mark.parametrize("vals", [[], [7.5], [1.0, 9.0], [1.0, 2.0, 3.0, 4.0]])
@pytest.mark.parametrize("p", [-10, 0, 50, 51, 95, 99, 100, 250])
def test_percentile_matches_reference(vals, p):
    got, want = percentile(vals, p), jpercentile(vals, p)
    assert (np.isnan(got) and np.isnan(want)) or got == want


def _feed_registry(reg):
    c = reg.counter("jobs_total", "jobs", labelnames=("kind",))
    c.inc(kind="a")
    c.inc(2.5, kind='quo"te\\n\nl')
    g = reg.gauge("depth", "queue depth")
    g.max(3)
    g.max(1)
    g.set(2, **{})
    h = reg.histogram("lat_ms", "latency", buckets=(1, 10))
    for v in (0.5, 5, 50):
        h.observe(v)
    return c, g, h


def test_metrics_registry_matches_reference():
    t, j = obs.MetricsRegistry(), jobs.MetricsRegistry()
    tc, tg, th = _feed_registry(t)
    jc, jg, jh = _feed_registry(j)
    assert t.render() == j.render()
    assert tc.total() == jc.total() and tg.value() == jg.value()
    assert th.count() == jh.count() == 3
    with pytest.raises(ValueError):
        t.counter("jobs_total", labelnames=("other",))
    with pytest.raises(ValueError):
        tc.inc(wrong="x")
    t.reset()
    j.reset()
    assert t.render() == j.render()
    assert obs.escape_label_value('a"b\\c\nd') == \
        jobs.escape_label_value('a"b\\c\nd')


def test_tracer_span_api_and_exporters(tmp_path):
    ring = obs.RingBufferExporter(capacity=3)
    tr = obs.Tracer(exporter=ring)
    with tr.span("outer", attrs={"k": 1}) as sp:
        sp.set("x", 2)
        tr.record("inner", 0.0, 0.001, trace=sp.trace, parent=sp.span_id)
    evs = ring.events()
    assert [e["name"] for e in evs] == ["inner", "outer"]
    assert evs[0]["parent"] == evs[1]["span"]
    assert evs[1]["attrs"] == {"k": 1, "x": 2}
    assert all(tuple(e) == obs.EVENT_FIELDS for e in evs)
    assert tuple(obs.EVENT_FIELDS) == tuple(jobs.EVENT_FIELDS)
    for i in range(4):
        tr.record(f"e{i}", 0.0, 0.0, trace="t")
    assert len(ring) == 3 and [e["name"] for e in ring.drain()] == \
        ["e1", "e2", "e3"]
    off = obs.Tracer(exporter=None)
    assert not off.enabled and off.span("x") is obs.NULL_SPAN
    path = tmp_path / "trace.jsonl"
    with obs.JsonlExporter(str(path)) as jx:
        obs.Tracer(exporter=jx).record("w", 0.0, 0.5, trace="t1")
    (ev,) = obs.read_jsonl(str(path))
    assert ev["name"] == "w" and ev["dur_ms"] == 500.0
    assert obs.get_tracer() is obs.get_tracer()


def _traced_run(engine_cls, registry_cls, exporter_cls, tracer_cls, **reg_kw):
    ring = exporter_cls()
    reg = registry_cls()
    reg.register("fsl", lambda x: np.asarray(x).reshape(len(x), -1), **reg_kw)
    rng = np.random.default_rng(0)
    with engine_cls(reg, max_batch=4, batch_wait_ms=1.0,
                    tracer=tracer_cls(exporter=ring)) as eng:
        f = eng.submit_register("c", rng.random((2, 4, 4, 3), np.float32))
        f.result(60)
        g = eng.submit_classify(rng.random((1, 4, 4, 3), np.float32))
        g.result(60)
    return ring.events(), (f.trace_id, g.trace_id)


def _shape(events, trace):
    """(name, parent name or None) of every span of one request's trace."""
    evs = [e for e in events if e["trace"] == trace]
    by_id = {e["span"]: e["name"] for e in evs}
    return sorted((e["name"], by_id.get(e["parent"])) for e in evs)


def test_traced_requests_emit_the_reference_spans():
    t_evs, t_ids = _traced_run(ServeEngine, ArtifactRegistry,
                               obs.RingBufferExporter, obs.Tracer,
                               device="cpu")
    j_evs, j_ids = _traced_run(JEngine, JRegistry, jobs.RingBufferExporter,
                               jobs.Tracer)
    for t_id, j_id in zip(t_ids, j_ids):
        got = _shape(t_evs, t_id)
        assert got == _shape(j_evs, j_id)
        assert got == sorted([
            ("serve.admission", "serve.request"),
            ("serve.coalesce", "serve.request"),
            ("serve.exec", "serve.request"),
            ("serve.queue", "serve.request"),
            ("serve.request", None),
            ("serve.respond", "serve.request")])
    batches = [e for e in t_evs if e["name"] == "serve.batch"]
    assert len(batches) == 2 and batches[0]["attrs"]["n_real"] == 2
    assert {e["status"] for e in t_evs if e["name"] == "serve.request"} == \
        {"ok"}
