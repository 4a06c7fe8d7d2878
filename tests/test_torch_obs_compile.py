"""Compile spans and the trace summarizer of the port, against the JAX
package's.

The same numpy params and on-grid 32x32 frames (ResNet-9 width 4,
``grid_point(6, 4)``, the int datapath) compile through
``repro.compile(..., tracer=)`` and ``repro_torch.compile(..., tracer=,
device="cpu")``: both emit one
``compile.build`` span with one ``compile.pass`` child per pass, with the
same pass names in order, the same parents, the same attribute keys and
the same node counts and op deltas.  ``repro_torch.obs.summarize`` renders
the same text as the reference's on the same events, and a cluster route
span carries the request's trace ID in the port as in the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import resnet9 as jresnet9  # noqa: E402
from repro.obs import RingBufferExporter as JRing  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import summarize as jsummarize  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.passes import PassManager  # noqa: E402
from repro_torch.core.quant import QuantConfig, fake_quant  # noqa: E402
from repro_torch.obs import EVENT_FIELDS, RingBufferExporter, Tracer  # noqa: E402
from repro_torch.obs import summarize  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

WIDTH, IMG = 4, 32


@pytest.fixture(scope="module")
def both_compiles():
    pj = jax.tree_util.tree_map(np.asarray, jresnet9.init_params(
        jax.random.PRNGKey(0), WIDTH))
    jring, ring = JRing(), RingBufferExporter()
    qcfg = QuantConfig.grid_point(6, 4)
    x = fake_quant(torch.from_numpy(np.random.default_rng(0).random(
        (2, IMG, IMG, 3)).astype(np.float32)), qcfg.act).numpy()
    repro.compile(pj, JQuantConfig.grid_point(6, 4), recipe="resnet9",
                  datapath="int", tracer=JTracer(jring), sample_input=x)
    dm = repro_torch.compile(params_from_numpy(pj, device="cpu"),
                             qcfg, recipe="resnet9",
                             datapath="int", tracer=Tracer(ring),
                             sample_input=x, device="cpu")
    return jring.events(), ring.events(), dm


def _split(events):
    (root,) = [e for e in events if e["name"] == "compile.build"]
    passes = [e for e in events if e["name"] == "compile.pass"]
    return root, passes


def test_compile_spans_match_reference(both_compiles):
    jev, tev, _ = both_compiles
    jroot, jpasses = _split(jev)
    root, passes = _split(tev)
    assert set(root) == set(jroot) == set(EVENT_FIELDS)
    assert root["parent"] is None and jroot["parent"] is None
    assert set(root["attrs"]) == set(jroot["attrs"])
    for k in ("graph", "n_passes", "verified"):
        assert root["attrs"][k] == jroot["attrs"][k]
    assert root["attrs"]["total_ms"] > 0
    assert len(passes) == root["attrs"]["n_passes"] == len(jpasses) >= 3
    assert all(e["trace"] == root["trace"] and e["parent"] == root["span"]
               for e in passes)
    for e, je in zip(passes, jpasses):
        a, ja = e["attrs"], je["attrs"]
        assert set(a) == set(ja)
        for k in ("pass", "nodes_before", "nodes_after", "op_delta",
                  "establishes", "verified"):
            assert a[k] == ja[k], (a["pass"], k)
        assert e["status"] == je["status"] == "ok"
        assert a["max_abs_err"] == 0.0
    fuse = [e for e in passes if "fuse" in e["attrs"]["pass"]]
    assert fuse and any(v < 0 for e in fuse
                        for v in e["attrs"]["op_delta"].values())


def test_pass_manager_tracer_default_and_failure_span(both_compiles):
    """Without ``tracer=`` the manager takes the process-global (disabled)
    tracer; a pass that breaks IO equality marks the root ``failed_pass``
    and its pass span ``io-mismatch``, as the reference's."""
    from repro_torch.core.graph import Graph, Node
    from repro_torch.core.passes import PassVerificationError, register_pass
    from repro_torch.obs import get_tracer

    assert PassManager().tracer is get_tracer()

    def double(g):
        g = g.copy()
        g.nodes[0].attrs["value"] = 2.0
        return g

    name = "test_obs_compile_breaks_io"
    register_pass(name, double, description="breaks IO equality")
    g = Graph([Node("mul", ["x"], ["y"], {"value": 1.0})], ["x"], ["y"], {},
              name="toy")
    ring = RingBufferExporter()
    with pytest.raises(PassVerificationError):
        PassManager(tracer=Tracer(ring), device="cpu").run(
            g, [name], verify_feeds={"x": np.ones((2,), np.float32)})
    root, (p,) = _split(ring.events())
    assert p["status"] == "io-mismatch" and p["attrs"]["verified"] is False
    assert root["attrs"]["failed_pass"] == name
    assert root["status"].startswith("error")


def test_summarize_renders_as_reference(both_compiles):
    jev, tev, _ = both_compiles
    for ev in (tev, jev):
        assert summarize.stage_stats(ev).keys() == \
            jsummarize.stage_stats(ev).keys()
        assert summarize.render(ev, trees=1) == jsummarize.render(ev, trees=1)
        tr = ev[0]["trace"]
        assert summarize.render_tree(ev, tr) == jsummarize.render_tree(ev, tr)
    out = summarize.render(tev)
    assert "compile.build" in out and "compile.pass" in out
    assert summarize.render([]) == "no events"


def test_summarize_cli_reads_jsonl(both_compiles, tmp_path, capsys):
    from repro_torch.obs import JsonlExporter

    _, tev, _ = both_compiles
    path = tmp_path / "trace.jsonl"
    with JsonlExporter(str(path)) as ex:
        for e in tev:
            ex.export(e)
    summarize.main([str(path)])
    out = capsys.readouterr().out
    assert out == summarize.render(tev) + "\n"
    summarize.main([str(path), "--trace", tev[0]["trace"]])
    assert capsys.readouterr().out.startswith(f"trace {tev[0]['trace']}")


def test_cluster_route_span_carries_the_trace():
    """One trace ID covers routing and the engine lifecycle; the route span
    parents on the engine's root span (the reference's contract)."""
    from repro_torch.serve.cluster import ServeCluster, TenantRegistry

    def toy(x):
        x = np.asarray(x, np.float32)
        return x.reshape(x.shape[0], -1)[:, :8]

    ring = RingBufferExporter()
    tr = Tracer(ring)
    reg = TenantRegistry(device="cpu")
    reg.register_backbone("toy", toy, default=True)
    rng = np.random.default_rng(1)
    with ServeCluster(reg, replicas=2, max_batch=8, batch_wait_ms=1.0,
                      tracer=tr) as cluster:
        cluster.add_tenant("acme")
        cluster.submit_register("acme", "c0", rng.random(
            (2, 8, 8, 3), np.float32)).result(timeout=30)
        fut = cluster.submit_classify("acme", rng.random((1, 8, 8, 3),
                                                         np.float32))
        fut.result(timeout=30)
        trace = fut.trace_id
    ev = [e for e in ring.events() if e["trace"] == trace]
    assert {"cluster.route", "serve.request", "serve.queue",
            "serve.exec"} <= {e["name"] for e in ev}
    (route,) = [e for e in ev if e["name"] == "cluster.route"]
    assert route["parent"] == ServeEngine._root_span(trace)
    assert route["attrs"] == {"tenant": "acme", "artifact": "acme/toy",
                              "replica": cluster.home_replica("acme"),
                              "failovers": 0}
    assert "cluster.route" in summarize.render(ring.events())
