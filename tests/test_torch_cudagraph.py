"""The executable table and the captured decode step off the card.

On the CPU a warmed shape is one eager run (the port's CPU path) and the
table's retrace counter behaves as the reference's: one count per warmed
bucket, flat afterwards, one more per new shape run eagerly.  The split-K
state of a graph (``kernels.build.GraphState``) is plain Python and is
checked here without a card; the captures themselves run in
``tests/test_torch_card.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.cudagraph import GraphTable  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.serve.metrics import ServeMetrics  # noqa: E402


def test_graph_table_on_the_cpu_counts_shapes_and_logs_warmups():
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x * 2, x.sum(dim=1)

    table = GraphTable(fn, torch.device("cpu"))
    metrics = ServeMetrics()
    for b in (1, 2, 4, 2):
        table.warm((torch.zeros((b, 3)),), name="t", metrics=metrics)
    assert table.trace_count == 3 and table.graphs == {}
    assert [e["bucket"] for e in table.compile_log] == [1, 2, 4]
    assert metrics.compile_snapshot()["compile_events"] == 3
    out = table(torch.ones((2, 3)))
    assert isinstance(out, tuple) and torch.equal(out[0], 2 * torch.ones(2, 3))
    assert table.trace_count == 3
    table(torch.ones((5, 3)))
    assert table.trace_count == 4 and calls[-1] == (5, 3)


def test_graph_state_routes_counters_and_launch_counts():
    """Inside ``warming`` a launch counts and the graph's counters grow;
    inside ``capture`` the counters are fixed and launches go to the
    graph's record; outside, the device's counters and the global counts."""
    state = B.GraphState()
    before = dict(B.launch_counts)
    dev = torch.device("cpu")
    with state.warming():
        c = B.tile_counters(dev, 2000)
        assert c is state.counters and c.numel() == 2000
        assert B.tile_counters(dev, 10) is c
        B.count_launch("mvau_int")
    assert B.launch_counts["mvau_int"] == before["mvau_int"] + 1
    with state.capture():
        assert B.tile_counters(dev, 1500) is c
        B.count_launch("mvau_int", "mvau_int_gap")
        B.count_launch("qmatmul")
        with pytest.raises(RuntimeError, match="split-K tile counters"):
            B.tile_counters(dev, 5000)
    assert state.launches == {"mvau_int": 1, "mvau_int_gap": 1, "qmatmul": 1}
    assert not state.capturing
    assert B.tile_counters(dev, 8) is not c
    B.add_launches(state.launches)
    after = dict(B.launch_counts)
    assert after["qmatmul"] == before["qmatmul"] + 1
    assert after["mvau_int_gap"] == before["mvau_int_gap"] + 1


def test_captured_decode_step_needs_the_card():
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import GraphedDecodeStep
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.models.testing import reduce_config

    cfg = reduce_config(get_config("qwen2.5-3b"))
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    with pytest.raises(ValueError, match="on the card"):
        GraphedDecodeStep(params, cfg, 2, 8, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 3))
    with pytest.raises(ValueError, match="on the card"):
        generate(params, cfg, prompt, 2, device="cpu", graph=True)
    out = generate(params, cfg, prompt, 2, device="cpu")
    assert out.shape == (2, 2) and out.dtype == torch.int32


def test_launch_counts_survive_threads_and_stay_per_thread_while_capturing():
    """Eight threads count launches at a short switch interval while one of
    them records into a graph's capture: no count is lost, and the capture
    sees only its own thread's launches."""
    import sys
    import threading

    state = B.GraphState()
    before = B.launch_counts["gap"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count(n, capture):
            if capture:
                with state.capture():
                    for _ in range(n):
                        B.count_launch("gap")
            else:
                for _ in range(n):
                    B.count_launch("gap")

        threads = [threading.Thread(target=count, args=(2000, i == 0))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert state.launches == {"gap": 2000}
    assert B.launch_counts["gap"] == before + 7 * 2000
