"""The harness finds cells, configurations, mixes and metrics by name, and
its comparison catches a broken timed path.

Runs the harness in process on the CPU stub (``harness.main(..., stub=True)``,
which skips the look for a card and nothing else) in a temporary copy of
the benchmark with tiny cells.
"""

import json
import time

import pytest
import torch

from portbench import harness

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def _run(root, capsys, workload, trace=0, seconds=1.0, wrap=None, seed=11):
    t0 = time.perf_counter()
    rc = harness.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      lambda: time.perf_counter() - t0, stub=True, root=root,
                      wrap=wrap)
    assert rc == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_a_new_cell_runs_from_new_files_alone(tiny_root, capsys):
    """A configuration file, a traffic file, a per-layer metric file and a
    cell entry, with no other file edited, make a cell that runs."""
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs" / "tiny-offline-cfg.json").read_text())
    cfg.update(name="resnet9-w5a3-tiny", weight_bits=5, weight_frac=4,
               act_bits=3, act_frac=1)
    (pb / "configs" / "resnet9-w5a3-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "tiny-offline-mix.json").read_text())
    mix.update(batch=2, resident_batches=3)
    (pb / "traffic" / "offline-b2.json").write_text(json.dumps(mix))
    (pb / "layer_metrics" / "calls_in_window.py").write_text(
        "def read(r):\n    return float(r.calls)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "resnet9-w5a3-tiny", "source": "test",
                             "file": "portbench/configs/resnet9-w5a3-tiny.json",
                             "reduced": ["width"], "why": "test"})
    bench["workloads"].append({"name": "w5a3-b2", "config": "resnet9-w5a3-tiny",
                               "traffic": "offline-b2", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("w5a3-b2")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "load generator",
                               "moves": "images_per_s",
                               "workloads": ["w5a3-b2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    res, err = _run(tiny_root, capsys, "w5a3-b2")
    assert list(res) == RESULT_KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}
    assert res["attempted"] > 0
    assert err.strip().splitlines()[-1].startswith("check feature_mismatch")

    res, _ = _run(tiny_root, capsys, "w5a3-b2", trace=1)
    assert list(res) == RESULT_KEYS[:5] + ["breakdown", "checks"]
    assert res["metrics"]["calls_in_window"]["value"] >= 1
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,trace", [("tiny-offline", 0),
                                        ("tiny16-offline", 0),
                                        ("tiny-offline", 1)])
def test_the_model_cells_report_their_metrics(tiny_root, capsys, cell, trace):
    res, _ = _run(tiny_root, capsys, cell, trace=trace, seconds=1.5)
    assert res["correct"] is True, res["checks"]
    # the device's readings need the card; the host's are all there
    want = {"replay_host_ms"} if trace else {"images_per_s", "setup_s"}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())


# -- a broken timed path makes ``correct`` false ------------------------------

def _offline_fault(kind):
    def wrap(driver):
        if kind == "neighbour_table":
            # c3 thresholds by its neighbour channel's table: the same
            # weights deployed with that layer's BN gammas rolled by one
            ctx = driver.ctx
            params = dict(ctx.params)
            params["c3"] = dict(params["c3"],
                                gamma=torch.roll(params["c3"]["gamma"], 1))
            driver.feats = ctx.system.deploy(ctx.cfg, params, ctx.dev.device)
            driver.feats.warmup([driver.batch], img=ctx.cfg["img"])
            return
        feats = driver.feats
        # the answer of the call before (the first: of the warm-up's zeros)
        prev = [feats(torch.zeros_like(driver.xs[0]))]

        def broken(x):
            out = feats(x)
            if kind == "state_unchanged":
                prev.append(out)
                return prev[-2]
            out = out.clone()
            if kind == "half_batch":             # the rest from the mean
                h = out.shape[0] // 2
                out[h:] = out[:h].mean(dim=0)
            else:                                # one answer altered
                out[0, 0] += 0.25
            return out
        driver.feats = broken
    return wrap


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer",
                                  "neighbour_table"])
def test_faults_in_the_offline_path_are_not_correct(tiny_root, capsys, kind):
    res, err = _run(tiny_root, capsys, "tiny-offline", seconds=1.0,
                    wrap=_offline_fault(kind))
    assert res["correct"] is False
    assert "FAILED" in err


def test_no_card_means_no_result(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "tiny-offline", "--seed", "1",
                       "--seconds", "1"], lambda: 0.0, root=tiny_root)
    assert rc != 0
    assert capsys.readouterr().out == ""
