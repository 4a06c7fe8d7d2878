"""The port's design-space exploration against the JAX reference, on the CPU.

* ``pareto_frontier``, the candidate seeds, labels and contents, and the
  search's ``random_plan`` / ``mutate_plan`` / ``crossover_plans`` /
  ranking equal the reference's on the same inputs and seeds;
* the reference's sweep, farm and search contracts hold in the port at
  their tiny sizes: the determinism contract, resume, thread and process
  dispatch equal to serial, failure isolation, and the knee served bit for
  bit through the port's ``ServeEngine``.

The port trains with torch streams and draws its probe with numpy, so its
records' accuracies and digests are compared inside the port; weight bytes
and bit-exactness are the reference's.
"""

import hashlib
import importlib
import json
import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.quant import LayerQuantPlan as JPlan  # noqa: E402
from repro.explore import farm as jfarm  # noqa: E402
from repro_torch.ckpt import content_key  # noqa: E402
from repro_torch.core.quant import LayerQuantPlan, QuantConfig  # noqa: E402
from repro_torch.explore import (DEFAULT_GRID, DETERMINISTIC_KEYS,  # noqa: E402
                                 SweepFarm, as_candidate, candidate_config,
                                 candidate_content, candidate_label,
                                 candidate_seed, config_for, crossover_plans,
                                 mutate_plan, pareto_frontier, point_seed,
                                 probe_batch, publish_frontier, random_plan,
                                 run_point, search, select_knee, sweep)
from repro_torch.models.resnet9 import coupled_act_groups, layer_names  # noqa: E402
from repro_torch.serve import ArtifactRegistry, PrototypeStore, ServeEngine  # noqa: E402

# the packages re-export the functions ``sweep`` and ``search`` under their
# modules' names, so the modules are imported by path
jsweep = importlib.import_module("repro.explore.sweep")
jsearch = importlib.import_module("repro.explore.search")
tsearch = importlib.import_module("repro_torch.explore.search")

WIDTH, IMG, BENCH_BATCH = 4, 16, 2
GRID2 = [(3, 2), (6, 4)]
FARM_KW = dict(width=WIDTH, steps=2, episodes=2, n_base=6, n_novel=5,
               img=IMG, batch=8, bench_batch=BENCH_BATCH, bench_iters=1,
               verbose=False, device="cpu")
TINY = dict(width=2, steps=1, episodes=1, n_base=4, n_novel=5, img=8,
            batch=4, bench_batch=2, bench_iters=1, verbose=False,
            device="cpu")
NAMES = layer_names(WIDTH)
COUPLED = coupled_act_groups(WIDTH)
PLAN = LayerQuantPlan.from_dict(
    {"default": [6, 4], "layers": {"r2a": [4, 4], "r2b": [4, 4]}})
REQUIRED_KEYS = {"w_bits", "a_bits", "acc_mean", "acc_ci95",
                 "weight_bytes_f32", "weight_bytes_int",
                 "int_ms_per_batch", "int_batches_per_s",
                 "bitexact_int_vs_f32", "modeled_ms", "cost_top",
                 "seed", "point_seed", "probe_digest"}


def _farm(cache_dir, **overrides) -> SweepFarm:
    return SweepFarm(str(cache_dir), **{**FARM_KW, **overrides})


def _det(rec):
    return {k: rec[k] for k in DETERMINISTIC_KEYS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores,
    and torch's default (one thread per core in every worker) makes these
    small ops wait on each other many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# pure functions against the reference
# ---------------------------------------------------------------------------
def test_config_for_matches_paper_point():
    cfg, paper = config_for(6, 4), QuantConfig.paper_w6a4()
    assert cfg.weight == paper.weight and cfg.act == paper.act


@pytest.mark.parametrize("seed", range(6))
def test_pareto_frontier_equals_the_reference(seed):
    rng = random.Random(seed)
    pts = [{"acc_mean": rng.choice([0.5, 0.6, 0.7, 0.8]),
            "weight_bytes_int": rng.choice([10, 20, 30, 40])}
           for _ in range(rng.randrange(0, 40))]
    assert pareto_frontier(pts) == jsweep.pareto_frontier(pts)


@pytest.mark.parametrize("pts,want", [
    ([], []),
    ([{"acc_mean": 0.5, "weight_bytes_int": 10}], [0]),
    ([{"acc_mean": 0.9, "weight_bytes_int": 100},
      {"acc_mean": 0.8, "weight_bytes_int": 100}], [0]),
    ([{"acc_mean": 0.9, "weight_bytes_int": 100},
      {"acc_mean": 0.9, "weight_bytes_int": 80}], [1]),
    ([{"acc_mean": 0.9, "weight_bytes_int": 100},
      {"acc_mean": 0.9, "weight_bytes_int": 100},
      {"acc_mean": 0.5, "weight_bytes_int": 200}], [0, 1]),
    ([{"acc_mean": 0.9, "weight_bytes_int": 100},
      {"acc_mean": 0.7, "weight_bytes_int": 100},
      {"acc_mean": 0.7, "weight_bytes_int": 50}], [0, 2]),
])
def test_pareto_frontier_edge_cases(pts, want):
    assert pareto_frontier(pts) == want == jsweep.pareto_frontier(pts)


@pytest.mark.parametrize("cand", [(6, 4), (3, 2), [8, 8], PLAN,
                                  {"default": [6, 4], "layers": {}},
                                  LayerQuantPlan.uniform(4, 4, names=NAMES)])
def test_candidate_identity_equals_the_reference(cand):
    jc = (JPlan.from_dict(cand.to_dict()) if isinstance(cand, LayerQuantPlan)
          else cand)
    tc = as_candidate(cand)
    assert candidate_content(tc) == jsweep.candidate_content(jc)
    assert candidate_label(tc) == jsweep.candidate_label(jc)
    for seed in (0, 7):
        assert candidate_seed(seed, tc) == jsweep.candidate_seed(seed, jc)
    qt, qj = candidate_config(tc), jsweep.candidate_config(jc)
    for n in NAMES:
        assert qt.layer(n).weight.describe() == qj.layer(n).weight.describe()
        assert qt.layer(n).act.describe() == qj.layer(n).act.describe()


def test_point_seeds_equal_the_reference_and_are_distinct():
    seeds = {point_seed(0, w, a) for w, a in DEFAULT_GRID}
    assert len(seeds) == len(DEFAULT_GRID)
    assert all(0 <= s < 2**63 for s in seeds)
    for s in (0, 1, 7):
        for w, a in DEFAULT_GRID + ((4, 6),):
            assert point_seed(s, w, a) == jsweep.point_seed(s, w, a)


def test_probe_batch_is_regenerable():
    a, b = probe_batch(123, 2, 8), probe_batch(123, 2, 8)
    assert a.shape == (2, 8, 8, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all() and (a < 1).all()
    assert not np.array_equal(a, probe_batch(124, 2, 8))


@pytest.mark.parametrize("seed", [0, 5])
def test_plan_generation_equals_the_reference(seed):
    rt, rj = random.Random(seed), random.Random(seed)
    for _ in range(8):
        pt = random_plan(rt, NAMES, COUPLED)
        pj = jsearch.random_plan(rj, NAMES, COUPLED)
        assert pt.to_dict() == pj.to_dict()
        mt = mutate_plan(rt, pt, NAMES, COUPLED, n_mut=3)
        mj = jsearch.mutate_plan(rj, pj, NAMES, COUPLED, n_mut=3)
        assert mt.to_dict() == mj.to_dict()
        ct = crossover_plans(rt, pt, mt, NAMES, COUPLED)
        cj = jsearch.crossover_plans(rj, pj, mj, NAMES, COUPLED)
        assert ct.to_dict() == cj.to_dict()
        assert all(len({ct.bits_for(n)[1] for n in grp}) == 1
                   for grp in COUPLED)
    assert [p.to_dict() for p in tsearch._tail_seed_plans(NAMES)] == \
        [p.to_dict() for p in jsearch._tail_seed_plans(NAMES)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_search_ranking_equals_the_reference(seed):
    rng = random.Random(seed)
    recs = [{"acc_mean": rng.choice([0.5, 0.6, 0.7]),
             "weight_bytes_int": rng.choice([10, 20, 30]),
             "modeled_ms": rng.choice([None, 0.1, 0.2])}
            for _ in range(15)]
    assert tsearch._rank(recs) == jsearch._rank(recs)
    assert tsearch._nondominated(recs) == jsearch._nondominated(recs)


def test_select_knee_prefers_smallest_within_tolerance():
    pts = [{"acc_mean": 0.90, "weight_bytes_int": 100},
           {"acc_mean": 0.89, "weight_bytes_int": 40},
           {"acc_mean": 0.50, "weight_bytes_int": 10}]
    for tol, want in ((0.02, 1), (0.001, 0)):
        assert select_knee(pts, [0, 1, 2], acc_tol=tol) == want == \
            jfarm.select_knee(pts, [0, 1, 2], acc_tol=tol)
    with pytest.raises(ValueError):
        select_knee(pts, [])


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------
def test_run_point_same_seed_identical_records():
    kw = dict(width=4, steps=2, episodes=2, batch=8, bench_batch=2,
              bench_iters=1, n_base=6, n_novel=5, seed=3, device="cpu")
    a = run_point(3, 2, **kw).record
    b = run_point(3, 2, **kw).record
    assert _det(a) == _det(b)
    c = run_point(3, 2, **{**kw, "seed": 4}).record
    assert c["point_seed"] != a["point_seed"]
    assert c["probe_digest"] != a["probe_digest"]


def test_sweep_emits_frontier_over_four_points(tmp_path):
    from repro.core.deploy import compile as jcompile
    from repro.core.quant import QuantConfig as JCfg
    from repro.models.resnet9 import plan as jplan

    out = tmp_path / "frontier.json"
    result = sweep(DEFAULT_GRID, width=4, steps=2, episodes=2, n_base=6,
                   n_novel=5, batch=8, bench_batch=2, bench_iters=1,
                   out_path=str(out), verbose=False, device="cpu")
    assert result["backend"] == "cpu" and len(result["points"]) == 4
    for p, (w, a) in zip(result["points"], DEFAULT_GRID):
        assert REQUIRED_KEYS <= set(p)
        assert p["bitexact_int_vs_f32"]
        assert p["weight_bytes_int"] < p["weight_bytes_f32"]
        assert p["cost_top"]["op"] and p["modeled_ms"] > 0
        # storage bytes are the reference artifact's at the same point
        flat = {b["name"]: {
            "w": np.full((3, 3, b["cin"], b["cout"]), 0.01, np.float32),
            "gamma": np.ones(b["cout"], np.float32),
            "beta": np.zeros(b["cout"], np.float32)} for b in jplan(4)}
        assert p["weight_bytes_int"] == jcompile(
            flat, JCfg.grid_point(w, a), recipe="resnet9",
            datapath="int").weight_bytes()
    assert result["frontier"]
    on_disk = json.loads(out.read_text())
    assert on_disk["points"] == result["points"]


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    kw = dict(width=2, steps=1, episodes=1, n_base=4, n_novel=5, batch=4,
              bench_batch=2, bench_iters=1, verbose=False, device=None)
    for call in (lambda: run_point(6, 4, **kw),
                 lambda: sweep([(6, 4)], **kw),
                 lambda: SweepFarm(str(tmp_path), **{**TINY, "device": None}),
                 lambda: search(str(tmp_path), width=2, device=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# farm
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def farm_run(tmp_path_factory):
    cache = tmp_path_factory.mktemp("farm_cache")
    farm = _farm(cache)
    return farm, farm.run(GRID2)


def test_cold_run_computes_every_point(farm_run):
    _, result = farm_run
    assert result.cached == [False, False]
    assert result.computed == 2 and result.hits == 0
    assert len(set(result.keys)) == 2
    assert all(rec["bitexact_int_vs_f32"] for rec in result.points)
    assert result.to_dict()["backend"] == "cpu"


def test_restarted_run_completes_remaining_points_only(farm_run):
    farm, first = farm_run
    result = _farm(farm.cache_dir).run(GRID2 + [(4, 4)])
    assert result.cached == [True, True, False] and result.computed == 1
    assert result.points[:2] == first.points
    assert result.keys[:2] == first.keys
    again = _farm(farm.cache_dir).run(GRID2 + [(4, 4)])
    assert again.cached == [True, True, True]
    assert again.points == result.points


def test_cache_key_is_content_addressed(tmp_path):
    a, b = _farm(tmp_path / "a"), _farm(tmp_path / "b")
    assert a.key_for(6, 4) == b.key_for(6, 4) == a.key_for((6, 4))
    assert a.key_for(6, 4) != a.key_for(4, 6)
    assert _farm(tmp_path / "c", steps=3).key_for(6, 4) != a.key_for(6, 4)
    assert _farm(tmp_path / "d", seed=1).key_for(6, 4) != a.key_for(6, 4)
    assert _farm(tmp_path / "e", bench_iters=9).key_for(6, 4) == \
        a.key_for(6, 4)
    # the device type is identity: a CPU point is not the card's point
    cfg = {**a.config, "cache_v": "torch-1", "candidate": [6, 4]}
    assert a.key_for(6, 4) == content_key({**cfg, "device": "cpu"})
    assert a.key_for(6, 4) != content_key({**cfg, "device": "cuda"})


def test_thread_pool_dispatch_matches_serial(tmp_path):
    grid = [(3, 2), (4, 4)]
    serial = SweepFarm(str(tmp_path / "s"), workers=1, **TINY).run(grid)
    threaded = SweepFarm(str(tmp_path / "t"), workers=2, **TINY).run(grid)
    assert threaded.cached == [False, False]
    for rs, rt in zip(serial.points, threaded.points):
        assert _det(rs) == _det(rt)


def test_failing_candidate_isolated_and_siblings_survive(tmp_path):
    result = _farm(tmp_path / "c", workers=2).run([(3, 2), (40, 4), (4, 4)])
    assert result.errors[0] is None and result.errors[2] is None
    assert result.errors[1] and "ValueError" in result.errors[1]
    assert result.failed == [1] and result.cached == [False] * 3
    assert result.points[0]["bitexact_int_vs_f32"]
    assert result.points[2]["bitexact_int_vs_f32"]
    assert result.points[1]["error"] == result.errors[1]
    assert result.points[1]["label"] == "w40a4"
    assert 1 not in result.frontier and result.frontier
    assert result.to_dict()["errors"] == result.errors


def test_failed_point_resume_recomputes_only_the_failure(tmp_path,
                                                         monkeypatch):
    sweep_mod = importlib.import_module("repro_torch.explore.sweep")
    real = sweep_mod.run_candidate

    def flaky(cand, **kw):
        if tuple(cand) == (6, 4):
            raise RuntimeError("transient trainer crash")
        return real(cand, **kw)

    monkeypatch.setattr(sweep_mod, "run_candidate", flaky)
    first = _farm(tmp_path / "c").run(GRID2)
    assert first.failed == [1] and "transient" in first.errors[1]
    monkeypatch.setattr(sweep_mod, "run_candidate", real)
    second = _farm(tmp_path / "c").run(GRID2)
    assert second.cached == [True, False]
    assert second.failed == [] and second.errors == [None, None]
    assert second.points[0] == first.points[0]


def test_unknown_arch_fails_loudly_at_construction(tmp_path):
    with pytest.raises(KeyError, match="unknown recipe"):
        _farm(tmp_path / "c", arch="mystery-net")


def test_restore_point_arch_mismatch_raises(farm_run):
    from repro_torch.core.recipes import register_recipe
    from repro_torch.explore.farm import _restore_point

    farm, result = farm_run
    register_recipe("other-net", ["verify_hw_mappable"],
                    description="test stub")
    with pytest.raises(ValueError, match="arch 'resnet9'"):
        _restore_point(farm.cache_dir, result.keys[0], WIDTH, BENCH_BATCH,
                       arch="other-net")


def test_process_pool_dispatch_matches_serial(tmp_path):
    grid = [(3, 2), (40, 4), (4, 4)]
    serial = SweepFarm(str(tmp_path / "s"), workers=1, **TINY).run(grid)
    proc = SweepFarm(str(tmp_path / "p"), workers=2, mode="process",
                     **TINY).run(grid)
    assert proc.failed == [1] and "ValueError" in proc.errors[1]
    for i in (0, 2):
        assert _det(serial.points[i]) == _det(proc.points[i])
    again = SweepFarm(str(tmp_path / "p"), workers=1, **TINY).run(
        [grid[0], grid[2]])
    assert again.cached == [True, True]


def _serve_and_check(farm, result, registry, knee_idx, probe):
    """Served features == cached probe features bit for bit (digest too),
    then through the engine: ids and similarities equal an offline store
    over the sweep-time features."""
    rec = result.points[knee_idx]
    cached = farm.restore_point(result.keys[knee_idx])
    default = registry.get(None)
    served = default.feats(probe).cpu().numpy()
    np.testing.assert_array_equal(served, cached.probe_feats)
    assert hashlib.sha256(served.tobytes()).hexdigest() == rec["probe_digest"]
    offline = PrototypeStore("cpu")
    offline.register("a", cached.probe_feats[:1])
    offline.register("b", cached.probe_feats[1:2])
    want_ids, want_sims = offline.classify(cached.probe_feats)
    with ServeEngine(registry, max_batch=4, batch_wait_ms=1.0) as eng:
        eng.warmup(img=IMG)
        eng.submit_register("a", probe[:1]).result(timeout=60)
        eng.submit_register("b", probe[1:2]).result(timeout=60)
        got = eng.submit_classify(probe).result(timeout=60)
    assert got.artifact == default.name
    assert got.class_ids == want_ids
    np.testing.assert_array_equal(got.sims, want_sims)


def test_publish_frontier_serves_the_knee_bit_for_bit(farm_run):
    farm, result = farm_run
    registry = ArtifactRegistry()
    names = publish_frontier(result, registry, device="cpu")
    assert names and len(registry) == len(result.frontier)
    knee = select_knee(result.points, result.frontier)
    rec = result.points[knee]
    default = registry.get(None)
    assert default.name == f"w{rec['w_bits']}a{rec['a_bits']}-int"
    assert default.meta["knee"] and \
        default.meta["cache_key"] == result.keys[knee]
    assert default.meta["weight_bytes"] == rec["weight_bytes_int"]
    assert default.meta["modeled_ms"] == rec["modeled_ms"]
    probe = probe_batch(rec["point_seed"], BENCH_BATCH, IMG)
    _serve_and_check(farm, result, registry, knee, probe)


def test_publish_empty_farm_result_raises(farm_run):
    import dataclasses

    _, result = farm_run
    empty = dataclasses.replace(result, points=[], frontier=[], keys=[],
                                cached=[], wall_s=[])
    with pytest.raises(ValueError, match="empty"):
        publish_frontier(empty, ArtifactRegistry(), device="cpu")


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------
SEARCH_KW = dict(width=WIDTH, seed=0, pop_size=5, children=2,
                 rungs=({"steps": 2, "episodes": 2, "keep": 3},
                        {"steps": 4, "episodes": 2, "keep": 2}),
                 uniform_grid=((3, 2), (6, 4)),
                 n_base=6, n_novel=5, img=IMG, batch=8,
                 bench_batch=BENCH_BATCH, bench_iters=1, verbose=False,
                 device="cpu")


def test_two_rung_halving_shrinks_population_and_resumes(tmp_path):
    res = search(str(tmp_path / "c"), **SEARCH_KW)
    assert len(res.rungs) == 2
    r0, r1 = res.rungs
    assert len(r0["survivors"]) <= 3 < len(r0["population"])
    assert len(r1["population"]) <= 3 + 2
    assert set(r0["survivors"]) <= set(r1["population"])
    assert res.ranked and res.frontier
    assert res.best["acc_mean"] == max(
        res.points[i]["acc_mean"] for i in res.frontier)
    for rec in res.points:
        assert bool(rec["plan"]) == rec["label"].startswith("mp-")
    res2 = search(str(tmp_path / "c"), **SEARCH_KW)
    assert res2.farm.hits == len(res2.farm.cached)
    assert res2.ranked == res.ranked
    assert [r["survivors"] for r in res2.rungs] == \
        [r["survivors"] for r in res.rungs]


def test_search_population_equals_the_reference(tmp_path, monkeypatch):
    """With the farm stubbed out (records from the candidate alone), the
    port's search breeds the reference's rungs, label for label."""
    def fake_run(self, grid):
        return _fake_result(self, [as_candidate(c) for c in grid])

    def fake_run_j(self, grid):
        return _fake_result(self, [jsweep.as_candidate(c) for c in grid],
                            jfarm.FarmResult, jsweep)

    monkeypatch.setattr(SweepFarm, "run", fake_run)
    monkeypatch.setattr(jfarm.SweepFarm, "run", fake_run_j)
    kw = {k: v for k, v in SEARCH_KW.items() if k != "device"}
    got = search(str(tmp_path / "t"), **SEARCH_KW)
    want = jsearch.search(str(tmp_path / "j"), **kw)
    assert got.rungs == want.rungs
    assert got.ranked == want.ranked and got.frontier == want.frontier


def _fake_result(farm, grid, result_cls=None, mod=None):
    from repro_torch.explore.farm import FarmResult

    mod = mod or importlib.import_module("repro_torch.explore.sweep")
    pts = []
    for c in grid:
        h = int(hashlib.sha256(mod.candidate_label(c).encode()).hexdigest(),
                16)
        pts.append({"label": mod.candidate_label(c),
                    "candidate": mod.candidate_content(c),
                    "plan": (c.to_dict() if not isinstance(c, tuple)
                             else None),
                    "acc_mean": (h % 7) / 7, "weight_bytes_int": h % 5,
                    "modeled_ms": (h % 3) / 3})
    n = len(pts)
    return (result_cls or FarmResult)(
        grid=[p["candidate"] for p in pts], points=pts,
        frontier=mod.pareto_frontier(pts), keys=[""] * n,
        cached=[False] * n, wall_s=[0.0] * n, cache_dir="", config={},
        errors=[None] * n)


def test_search_requires_quant_layers_hook(tmp_path):
    from repro_torch.core.recipes import register_recipe
    from repro_torch.models import resnet9

    register_recipe("hookless-net", ["verify_hw_mappable"],
                    init_params=resnet9.init_params,
                    feature_dim=resnet9.feature_dim,
                    forward=resnet9.forward)
    with pytest.raises(ValueError, match="quant_layers"):
        search(str(tmp_path), arch="hookless-net", **SEARCH_KW)


def test_published_mixed_precision_artifact_serves_bit_for_bit(tmp_path):
    farm = _farm(tmp_path / "c")
    result = farm.run([PLAN])
    assert result.failed == [] and result.frontier == [0]
    rec = result.points[0]
    assert rec["label"] == f"mp-{PLAN.digest()}"
    assert rec["plan"] == PLAN.to_dict() and rec["bitexact_int_vs_f32"]
    registry = ArtifactRegistry()
    names = publish_frontier(result, registry, device="cpu")
    assert names == [f"mp-{PLAN.digest()}-int"]
    served = registry.get(None)
    assert served.meta["plan"] == PLAN.to_dict()
    probe = probe_batch(rec["point_seed"], BENCH_BATCH, IMG)
    _serve_and_check(farm, result, registry, 0, probe)
    qcfg = candidate_config(as_candidate(rec["candidate"]))
    assert qcfg.layer("r2a").weight.total_bits == 4
    assert qcfg.layer("c0").weight.total_bits == 6


def test_farm_cli_runs_as_a_module(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.explore.farm`` runs the module after the
    package has rebound ``sweep`` to the function: the farm must still
    reach the sweep module's ``run_candidate``."""
    import runpy
    import sys

    out = tmp_path / "farm.json"
    argv = ["farm", "--quick", "--device", "cpu", "--cache-dir",
            str(tmp_path / "cache"), "--out", str(out)]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_module("repro_torch.explore.farm", run_name="__main__")
    result = json.loads(out.read_text())
    assert result["errors"] == [None] * len(DEFAULT_GRID)
    assert all(p["bitexact_int_vs_f32"] for p in result["points"])
    assert "farm,done,4 computed" in capsys.readouterr().out
