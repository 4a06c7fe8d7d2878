"""Per-layer mixed-precision search — the bit-width DSE scaled from 4
uniform grid points to layer-wise assignments.

Counterpart of the JAX package's ``explore/search.py``, pure Python over
:class:`~repro_torch.core.quant.LayerQuantPlan` and ``random.Random``: with
the same seed it draws the same plans as the reference.

* **Candidates** are plans (or uniform ``(W, A)`` tuples); both content-key
  identically through ``SweepFarm``.
* **Feasibility** comes from the recipe's ``quant_layers`` hook: residual
  adds force their operands onto a common activation fraction
  (``coupled_act`` groups), so plans assign activation widths per group.
* **Successive halving**: each rung is one ``SweepFarm.run`` with a proxy
  budget; survivors ranked on the acc/bytes/modeled-ms frontier move on.
* **Evolution (optional)**: survivors breed mutation/crossover children
  that enter the next rung.

``search()`` returns a :class:`SearchResult` whose final rung is a plain
``FarmResult``, publishable through ``publish_frontier``.
"""

from __future__ import annotations

import dataclasses
import json
import random
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.quant import LayerQuantPlan
from repro_torch.core.recipes import recipe
from repro_torch.device import DeviceLike
from repro_torch.explore.farm import FarmResult, SweepFarm
from repro_torch.explore.sweep import (DEFAULT_GRID, Candidate, as_candidate,
                                 candidate_content, candidate_label)

__all__ = ["SearchResult", "crossover_plans", "mutate_plan", "random_plan",
           "search"]

# Per-rung proxy budgets: (short-QAT scoring, full QAT for survivors).  The
# ``keep`` of the last rung bounds the reported frontier, not a promotion.
DEFAULT_RUNGS: Tuple[Dict, ...] = (
    {"steps": 30, "episodes": 4, "keep": 8},
    {"steps": 120, "episodes": 10, "keep": 6},
)


# ---------------------------------------------------------------------------
# Coupling-aware plan generation / variation
# ---------------------------------------------------------------------------
def _act_groups(names: Sequence[str],
                coupled: Sequence[Sequence[str]]) -> List[List[str]]:
    """Partition ``names`` into activation-width groups: each coupled group
    is one unit (a residual add needs ONE common fraction), every other
    layer is its own singleton."""
    grouped = set()
    groups: List[List[str]] = []
    for grp in coupled:
        groups.append([str(n) for n in grp])
        grouped.update(groups[-1])
    for n in names:
        if n not in grouped:
            groups.append([n])
    return groups


def random_plan(rng: random.Random, names: Sequence[str],
                coupled: Sequence[Sequence[str]], *,
                w_choices: Sequence[int] = (3, 4, 6, 8),
                a_choices: Sequence[int] = (2, 4, 6, 8),
                default: Tuple[int, int] = (6, 4)) -> LayerQuantPlan:
    """A uniformly random feasible plan: independent weight width per layer,
    ONE activation width per coupled group."""
    bits = {n: [rng.choice(list(w_choices)), None] for n in names}
    for grp in _act_groups(names, coupled):
        a = rng.choice(list(a_choices))
        for n in grp:
            bits[n][1] = a
    return LayerQuantPlan.from_dict({"default": list(default),
                                     "layers": bits})


def mutate_plan(rng: random.Random, plan: LayerQuantPlan,
                names: Sequence[str], coupled: Sequence[Sequence[str]], *,
                w_choices: Sequence[int] = (3, 4, 6, 8),
                a_choices: Sequence[int] = (2, 4, 6, 8),
                n_mut: int = 1) -> LayerQuantPlan:
    """Perturb ``n_mut`` genes: either one layer's weight width or one
    coupled group's activation width (never a single member of a group —
    that would emit an infeasible plan)."""
    for _ in range(max(n_mut, 1)):
        if rng.random() < 0.5:
            n = rng.choice(list(names))
            w, a = plan.bits_for(n)
            alt = [c for c in w_choices if c != w] or list(w_choices)
            plan = plan.replace_layer(n, rng.choice(alt), a)
        else:
            grp = rng.choice(_act_groups(names, coupled))
            a = plan.bits_for(grp[0])[1]
            alt = [c for c in a_choices if c != a] or list(a_choices)
            na = rng.choice(alt)
            for n in grp:
                plan = plan.replace_layer(n, plan.bits_for(n)[0], na)
    return plan


def crossover_plans(rng: random.Random, pa: LayerQuantPlan,
                    pb: LayerQuantPlan, names: Sequence[str],
                    coupled: Sequence[Sequence[str]]) -> LayerQuantPlan:
    """Uniform crossover: each layer's weight width and each coupled
    group's activation width come from a random parent — both parents
    feasible ⇒ the child is feasible."""
    child = pa
    for n in names:
        w = (pa if rng.random() < 0.5 else pb).bits_for(n)[0]
        child = child.replace_layer(n, w, child.bits_for(n)[1])
    for grp in _act_groups(names, coupled):
        a = (pa if rng.random() < 0.5 else pb).bits_for(grp[0])[1]
        for n in grp:
            child = child.replace_layer(n, child.bits_for(n)[0], a)
    return child


def _tail_seed_plans(names: Sequence[str],
                     default: Tuple[int, int] = (6, 4),
                     w_narrow: Sequence[int] = (4, 3),
                     w_wide: int = 8) -> List[LayerQuantPlan]:
    """Knee-biased seed plans exploiting the storage-width cliffs.

    * Narrow the TAIL layers' weights — the deepest layers carry most of
      the weight bytes (channel counts grow with depth), and ≤4-bit codes
      pack two-per-byte, so this is where per-layer assignment buys
      footprint at least accuracy cost.
    * Widen the HEAD layers' weights to ``w_wide`` — every width in
      (4, 8] stores as int8, so extra head precision is byte-FREE: a
      head-widened plan can dominate the uniform default on accuracy at
      identical footprint.
    * Both at once: the paper's per-layer argument in one plan.
    """
    seeds = []
    names = list(names)
    for w in w_narrow:
        for k in (2, 3):
            seeds.append(LayerQuantPlan.from_dict({
                "default": list(default),
                "layers": {n: [w, default[1]] for n in names[-k:]}}))
    head = {n: [w_wide, default[1]] for n in names[:-3]}
    seeds.append(LayerQuantPlan.from_dict({
        "default": list(default), "layers": head}))
    for k in (2, 3):
        seeds.append(LayerQuantPlan.from_dict({
            "default": list(default),
            "layers": {**head,
                       **{n: [w_narrow[0], default[1]]
                          for n in names[-k:]}}}))
    return seeds


# ---------------------------------------------------------------------------
# 3-objective ranking (acc ↑, weight bytes ↓, modeled ms ↓)
# ---------------------------------------------------------------------------
def _objectives(rec: Dict) -> Tuple[float, float, float]:
    return (-float(rec["acc_mean"]), float(rec["weight_bytes_int"]),
            float(rec.get("modeled_ms") or 0.0))


def _nondominated(records: Sequence[Dict]) -> List[int]:
    """Indices not dominated on (acc max, bytes min, modeled-ms min).
    All-pairs over rung populations (tens of candidates) — the O(n log n)
    2-objective form stays in ``sweep.pareto_frontier`` where thousands of
    points flow through."""
    objs = [_objectives(r) for r in records]
    out = []
    for i, p in enumerate(objs):
        dominated = any(
            all(q[k] <= p[k] for k in range(3))
            and any(q[k] < p[k] for k in range(3))
            for j, q in enumerate(objs) if j != i)
        if not dominated:
            out.append(i)
    return out


def _rank(records: Sequence[Dict]) -> List[int]:
    """Non-dominated-front peeling; inside a front, best accuracy first
    (then fewest bytes, then lowest modeled ms)."""
    remaining = list(range(len(records)))
    ranked: List[int] = []
    while remaining:
        front = [remaining[j]
                 for j in _nondominated([records[i] for i in remaining])]
        front.sort(key=lambda i: _objectives(records[i]))
        ranked.extend(front)
        picked = set(front)
        remaining = [i for i in remaining if i not in picked]
    return ranked


# ---------------------------------------------------------------------------
# The search loop
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SearchResult:
    """Outcome of one :func:`search` run.

    ``farm`` is the FINAL rung's :class:`FarmResult` — publishable through
    ``publish_frontier`` unchanged.  ``points``/``frontier``/``ranked``
    describe the final population on the 3-objective frontier; ``rungs``
    logs every rung's budget, population, and survivors by label.
    """

    rungs: List[Dict]
    points: List[Dict]
    frontier: List[int]          # 3-objective non-dominated, into ``points``
    ranked: List[int]            # full ranking, best first
    cache_dir: str
    config: Dict
    farm: FarmResult
    wall_s: float = 0.0

    @property
    def best(self) -> Dict:
        return self.points[self.ranked[0]]

    def best_mixed(self) -> Optional[Dict]:
        """The best-ranked candidate that is a true per-layer plan (not a
        uniform anchor) — the record the search exists to find."""
        for i in self.ranked:
            if self.points[i].get("plan"):
                return self.points[i]
        return None

    def to_dict(self) -> Dict:
        return {
            "rungs": self.rungs, "points": self.points,
            "frontier": self.frontier, "ranked": self.ranked,
            "cache_dir": self.cache_dir, "config": self.config,
            "wall_s": self.wall_s, "farm": self.farm.to_dict(),
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)


def search(cache_dir: str, *, arch: str = "resnet9", width: int = 8,
           seed: int = 0, rungs: Sequence[Dict] = DEFAULT_RUNGS,
           population: Optional[Sequence[Candidate]] = None,
           pop_size: int = 12, evolve: bool = True, children: int = 4,
           w_choices: Sequence[int] = (3, 4, 6, 8),
           a_choices: Sequence[int] = (2, 4, 6, 8),
           default_point: Tuple[int, int] = (6, 4),
           include_uniform: bool = True,
           uniform_grid: Sequence[Tuple[int, int]] = DEFAULT_GRID,
           n_base: int = 12, n_novel: int = 6, img: int = 32,
           batch: int = 32, bench_batch: int = 8, bench_iters: int = 10,
           workers: Optional[int] = None, mode: str = "thread",
           verbose: bool = True, device: DeviceLike = None) -> SearchResult:
    """Successive-halving per-layer search over the farm; module docstring
    has the full story.

    The initial population = explicit ``population`` if given, else
    knee-biased tail-narrowing seeds + (``include_uniform``) the uniform
    anchor grid + random feasible plans up to ``pop_size``.  Uniform
    anchors keep the comparison honest (the searched plan must EARN its
    frontier spot against them) and share cache entries with plain uniform
    farm runs at the same config.  Evolution children enter the next rung
    unscored — the rung itself is their proxy score.
    """
    t0 = time.perf_counter()
    rec = recipe(arch).workload_hooks("fsl")
    if rec.quant_layers is None:
        raise ValueError(
            f"recipe '{arch}' has no quant_layers hook; per-layer search "
            "needs the architecture's layer names and act couplings")
    ql = rec.quant_layers(width)
    names, coupled = list(ql["names"]), list(ql["coupled_act"])
    rng = random.Random(seed)

    if population is None:
        pop: List[Candidate] = _tail_seed_plans(
            names, default_point, w_wide=max(w_choices))
        if include_uniform:
            pop.extend(tuple(p) for p in uniform_grid)
        while len(pop) < pop_size:
            pop.append(random_plan(rng, names, coupled, w_choices=w_choices,
                                   a_choices=a_choices,
                                   default=default_point))
    else:
        pop = [as_candidate(c) for c in population]
    pop = _dedup(pop)

    rung_log: List[Dict] = []
    farm_result: Optional[FarmResult] = None
    for r, rung in enumerate(rungs):
        last = r == len(rungs) - 1
        farm = SweepFarm(
            cache_dir, arch=arch, width=width, steps=int(rung["steps"]),
            episodes=int(rung["episodes"]), n_base=n_base, n_novel=n_novel,
            img=img, batch=batch, bench_batch=bench_batch,
            bench_iters=bench_iters, seed=seed, workers=workers, mode=mode,
            verbose=verbose, device=device)
        farm_result = farm.run(pop)
        ok = [i for i, e in enumerate(farm_result.errors) if e is None]
        ranked_ok = [ok[j]
                     for j in _rank([farm_result.points[i] for i in ok])]
        keep = max(int(rung.get("keep", len(ok))), 1)
        survivors = ranked_ok[:keep]
        rung_log.append({
            "steps": int(rung["steps"]), "episodes": int(rung["episodes"]),
            "keep": keep,
            "population": [candidate_label(c) for c in pop],
            "survivors": [farm_result.points[i]["label"] for i in survivors],
            "failed": [candidate_label(pop[i]) for i in farm_result.failed],
            "cache_hits": farm_result.hits,
        })
        if verbose:
            sys.stdout.write(f"search,rung{r},steps={rung['steps']},"
                             f"pop={len(pop)},survivors={len(survivors)},"
                             f"failed={len(farm_result.failed)}\n")
        if last:
            pop = [pop[i] for i in survivors]
            break
        next_pop = [pop[i] for i in survivors]
        if evolve and children > 0:
            parents = [_as_plan(pop[i], names, default_point)
                       for i in survivors]
            for _ in range(children):
                if len(parents) >= 2 and rng.random() < 0.5:
                    pa, pb = rng.sample(parents, 2)
                    child = crossover_plans(rng, pa, pb, names, coupled)
                else:
                    child = mutate_plan(rng, rng.choice(parents), names,
                                        coupled, w_choices=w_choices,
                                        a_choices=a_choices)
                next_pop.append(child)
        pop = _dedup(next_pop)

    ok = [i for i, e in enumerate(farm_result.errors) if e is None]
    final_rank = [ok[j] for j in _rank([farm_result.points[i] for i in ok])]
    frontier3 = [ok[j]
                 for j in _nondominated([farm_result.points[i] for i in ok])]
    return SearchResult(
        rungs=rung_log, points=farm_result.points,
        frontier=sorted(frontier3), ranked=final_rank,
        cache_dir=cache_dir,
        config={"arch": arch, "width": width, "seed": int(seed),
                "pop_size": int(pop_size), "evolve": bool(evolve),
                "w_choices": list(w_choices), "a_choices": list(a_choices),
                "rungs": [dict(r) for r in rungs]},
        farm=farm_result, wall_s=time.perf_counter() - t0)


def _as_plan(cand: Candidate, names: Sequence[str],
             default: Tuple[int, int]) -> LayerQuantPlan:
    cand = as_candidate(cand)
    if isinstance(cand, LayerQuantPlan):
        return cand
    return LayerQuantPlan.uniform(*cand, names=names)


def _dedup(cands: Sequence[Candidate]) -> List[Candidate]:
    seen = set()
    out: List[Candidate] = []
    for c in cands:
        key = json.dumps(candidate_content(c), sort_keys=True)
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache-dir", default="SEARCH_cache")
    ap.add_argument("--quick", action="store_true",
                    help="tiny budget: 2 tiny rungs (CI smoke)")
    ap.add_argument("--out", default="SEARCH_result.json")
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--mode", choices=["thread", "process"], default="thread")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    kw = dict(width=args.width, seed=args.seed, workers=args.workers,
              mode=args.mode, device=args.device)
    if args.quick:
        kw.update(width=4, pop_size=6, children=2,
                  rungs=({"steps": 4, "episodes": 2, "keep": 4},
                         {"steps": 8, "episodes": 2, "keep": 3}),
                  n_base=6, n_novel=5, img=16, batch=8, bench_batch=2,
                  bench_iters=1)
    res = search(args.cache_dir, **kw)
    res.write(args.out)
    sys.stdout.write(f"search,written,{args.out},best={res.best['label']}\n")


if __name__ == "__main__":
    main()
