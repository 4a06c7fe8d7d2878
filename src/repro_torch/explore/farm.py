"""Parallel, resumable DSE sweep farm — sweep → select → deploy as one
system, on the card.

Counterpart of the JAX package's ``explore/farm.py``:

* **Concurrent** — candidates dispatch over a thread pool, one worker per
  CUDA device with each worker's candidates pinned to its card
  (``torch.cuda.device``), or (``mode="process"``) over a spawn-context
  ``ProcessPoolExecutor`` (CUDA cannot be forked).  With one card,
  ``workers=None`` means serial dispatch; results are the same by
  construction, since every candidate owns its PRNG streams.
* **Fault-isolated** — a raising candidate becomes a structured entry
  (``error=...``); its siblings still return, and a re-run recomputes only
  the failures.
* **Resumable** — each finished candidate (trained params, served-path
  probe features, the record) is checkpointed atomically under a content
  hash of its identity: train config, candidate, cache version and device
  type (a float training run on the CPU and on the card are different
  points).  A killed farm restarts where it left off.
* **Publishing** — :func:`publish_frontier` deploys the Pareto-optimal
  points and registers them in a ``serve.ArtifactRegistry`` with
  provenance metadata, the default hot-swapped to the knee.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager, content_key
from repro_torch.core.recipes import recipe
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.explore.sweep import (DEFAULT_GRID, Candidate, PointResult,
                                       as_candidate, candidate_config,
                                       candidate_content, candidate_label,
                                       device_label, pareto_frontier)
from repro_torch.fsl.pipeline import FSLPipeline

__all__ = ["FarmResult", "SweepFarm", "publish_frontier", "select_knee"]

# The sweep module by its path: the package re-exports the function
# ``sweep`` under the module's name, and ``python -m`` runs this file after
# the package has bound it.
_sweep = importlib.import_module("repro_torch.explore.sweep")

# Cache-layout version, hashed into every candidate's content key.  The
# port's entries differ from the reference's (torch init streams, a numpy
# probe), so they live under a version of their own.
_CACHE_VERSION = "torch-1"


def _say(verbose: bool, line: str) -> None:
    if verbose:
        sys.stdout.write(line + "\n")


@dataclasses.dataclass
class FarmResult:
    """Outcome of one :meth:`SweepFarm.run`: records in grid order plus the
    cache/provenance bookkeeping the publish step needs.  ``errors[i]`` is
    ``None`` for a completed candidate and ``"ExcType: message"`` for a
    failed one (whose ``points[i]`` is a failure stub); ``frontier`` ranks
    completed candidates only, by index into ``points``."""

    grid: List
    points: List[Dict]
    frontier: List[int]
    keys: List[str]
    cached: List[bool]
    wall_s: List[float]
    cache_dir: str
    config: Dict
    errors: List[Optional[str]] = dataclasses.field(default_factory=list)
    backend: str = ""

    @property
    def hits(self) -> int:
        return sum(self.cached)

    @property
    def failed(self) -> List[int]:
        return [i for i, e in enumerate(self.errors) if e is not None]

    @property
    def computed(self) -> int:
        return len(self.cached) - self.hits - len(self.failed)

    def to_dict(self) -> Dict:
        """JSON form — a superset of the serial ``sweep()`` dict."""
        return {
            "model": self.config.get("arch", "resnet9"),
            "backend": self.backend,
            "grid": list(self.grid), "points": self.points,
            "frontier": self.frontier, "keys": self.keys,
            "cached": self.cached, "wall_s": self.wall_s,
            "errors": self.errors,
            "cache_dir": self.cache_dir, "config": self.config,
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)


def _point_task(cache_dir: str, cfg: Dict, bench_iters: int, cand_content,
                key: str, verbose: bool, device: str, data=None
                ) -> Tuple[Dict, str, bool, float, Optional[str]]:
    """ONE candidate: cache check → run → atomic publish.

    Module-level and driven by picklable arguments, so thread, serial and
    spawn-context process dispatch share it.  A raising candidate returns a
    failure entry instead of propagating.  ``run_candidate`` is resolved
    through the module attribute at call time (monkeypatch-friendly)."""
    cand = as_candidate(cand_content)
    label = candidate_label(cand)
    mgr = CheckpointManager(cache_dir)
    t0 = time.perf_counter()
    if mgr.has_named(key):
        record = mgr.named_meta(key)["record"]
        _say(verbose, f"farm,{label},cache_hit,{key}")
        return record, key, True, time.perf_counter() - t0, None
    if data is None:
        data = SyntheticImages(n_base=cfg["n_base"], n_novel=cfg["n_novel"],
                               seed=cfg["seed"], img=cfg["img"])
    try:
        pr = _sweep.run_candidate(
            cand, width=cfg["width"], steps=cfg["steps"],
            episodes=cfg["episodes"], batch=cfg["batch"],
            bench_batch=cfg["bench_batch"], bench_iters=bench_iters,
            seed=cfg["seed"], data=data, arch=cfg["arch"], verbose=verbose,
            device=device)
    except Exception as e:  # noqa: BLE001 — isolate ANY per-point failure
        wall = time.perf_counter() - t0
        err = f"{type(e).__name__}: {e}"
        _say(verbose, f"farm,{label},failed,{err}")
        stub = {"label": label, "candidate": candidate_content(cand),
                "error": err}
        return stub, key, False, wall, err
    wall = time.perf_counter() - t0
    # publish only after the point finished: a kill mid-point leaves no
    # entry, so resume recomputes it
    mgr.save_named(
        key, {"params": pr.params, "probe_feats": pr.probe_feats},
        meta={"record": pr.record, "config": cfg, "wall_s": wall})
    return pr.record, key, False, wall, None


class SweepFarm:
    """Concurrent, resumable orchestrator over ``run_candidate``.

    ``device`` (default: the card; ``"cpu"`` for the plain versions) picks
    where candidates run; ``workers=None`` means one worker per CUDA device
    (serial with one card, or on the CPU).  ``mode="process"`` dispatches
    over a spawn-context process pool (each child imports torch afresh; the
    shared cache directory is the only coordination point)."""

    def __init__(self, cache_dir: str, *, width: int = 8, steps: int = 120,
                 episodes: int = 10, n_base: int = 12, n_novel: int = 6,
                 img: int = 32, batch: int = 32, bench_batch: int = 8,
                 bench_iters: int = 10, seed: int = 0,
                 workers: Optional[int] = None, mode: str = "thread",
                 arch: str = "resnet9", verbose: bool = True,
                 device: DeviceLike = None):
        if mode not in ("thread", "process"):
            raise ValueError(f"mode must be 'thread' or 'process', got {mode!r}")
        recipe(arch).workload_hooks("fsl")  # fail loudly BEFORE any training
        self.device = resolve_device(device)
        self.cache_dir = cache_dir
        self.mgr = CheckpointManager(cache_dir)
        self.config = {
            "arch": str(arch), "width": int(width), "steps": int(steps),
            "episodes": int(episodes), "n_base": int(n_base),
            "n_novel": int(n_novel), "img": int(img), "batch": int(batch),
            "bench_batch": int(bench_batch), "seed": int(seed),
        }
        self.bench_iters = int(bench_iters)   # timing budget: not identity
        self.workers = workers
        self.mode = mode
        self.verbose = verbose

    # -- cache identity -----------------------------------------------------
    def key_for(self, cand, a_bits: Optional[int] = None) -> str:
        """Content hash of (train config, cache version, device type,
        candidate); accepts any candidate descriptor or ``key_for(W, A)``.
        ``bench_iters`` is excluded: it only changes how long the latency
        measurement averages."""
        if a_bits is not None:
            cand = (cand, a_bits)
        return content_key({**self.config, "cache_v": _CACHE_VERSION,
                            "device": self.device.type,
                            "candidate": candidate_content(cand)})

    def _devices(self) -> List[str]:
        if self.device.type != "cuda":
            return [str(self.device)]
        if self.device.index is not None:
            return [str(self.device)]
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]

    # -- run ----------------------------------------------------------------
    def run(self, grid: Sequence[Candidate] = DEFAULT_GRID) -> FarmResult:
        grid = [as_candidate(c) for c in grid]
        cfg = self.config
        contents = [candidate_content(c) for c in grid]
        keys = [self.key_for(c) for c in grid]
        devices = self._devices()
        workers = self.workers if self.workers is not None else len(devices)
        workers = max(min(workers, len(grid)), 1)

        if self.mode == "process" and workers > 1:
            import multiprocessing as mp

            ctx = mp.get_context("spawn")   # CUDA cannot be forked
            with ProcessPoolExecutor(max_workers=workers,
                                     mp_context=ctx) as ex:
                futs = [ex.submit(_point_task, self.cache_dir, cfg,
                                  self.bench_iters, contents[i], keys[i],
                                  self.verbose, devices[i % len(devices)])
                        for i in range(len(grid))]
                outs = [f.result() for f in futs]
        else:
            data = SyntheticImages(n_base=cfg["n_base"],
                                   n_novel=cfg["n_novel"],
                                   seed=cfg["seed"], img=cfg["img"])

            def one(i: int):
                dev = devices[i % len(devices)]
                pin = (torch.cuda.device(dev) if dev.startswith("cuda")
                       else contextlib.nullcontext())
                with pin:
                    return _point_task(self.cache_dir, cfg, self.bench_iters,
                                       contents[i], keys[i], self.verbose,
                                       dev, data=data)

            if workers <= 1:
                outs = [one(i) for i in range(len(grid))]
            else:
                with ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="sweep-farm") as ex:
                    outs = list(ex.map(one, range(len(grid))))

        points = [o[0] for o in outs]
        errors = [o[4] for o in outs]
        ok = [i for i, e in enumerate(errors) if e is None]
        frontier = [ok[j] for j in pareto_frontier([points[i] for i in ok])]
        result = FarmResult(
            grid=contents, points=points, frontier=frontier,
            keys=[o[1] for o in outs], cached=[o[2] for o in outs],
            wall_s=[o[3] for o in outs], cache_dir=self.cache_dir,
            config=dict(cfg), errors=errors,
            backend=device_label(self.device))
        _say(self.verbose, f"farm,done,{result.computed} computed,"
                           f"{result.hits} cache hits,"
                           f"{len(result.failed)} failed,"
                           f"frontier={result.frontier}")
        return result

    # -- cache access -------------------------------------------------------
    def restore_point(self, key: str) -> PointResult:
        return _restore_point(self.cache_dir, key, self.config["width"],
                              self.config["bench_batch"],
                              arch=self.config["arch"])


def _restore_point(cache_dir: str, key: str, width: int, bench_batch: int,
                   arch: str = "resnet9") -> PointResult:
    """Load a cached point (params on the CPU + probe features + record).

    The restore template comes from the recipe's FSL hooks on a CPU
    generator, and the entry's recorded arch is checked first: a mismatch
    raises instead of restoring wrong-shaped params."""
    mgr = CheckpointManager(cache_dir)
    meta = mgr.named_meta(key)
    stored = ((meta.get("record") or {}).get("arch")
              or (meta.get("config") or {}).get("arch"))
    if stored is not None and stored != arch:
        raise ValueError(
            f"cache entry {key} was swept with arch '{stored}' but the "
            f"restore requested '{arch}' — refusing a wrong-shaped restore")
    hooks = recipe(arch).workload_hooks("fsl")
    like = {
        "params": hooks.init_params(torch.Generator().manual_seed(0), width,
                                    "cpu"),
        "probe_feats": np.zeros((bench_batch, hooks.feature_dim(width)),
                                np.float32),
    }
    tree = mgr.restore_named(like, key)
    return PointResult(record=meta["record"], params=tree["params"],
                       probe_feats=np.asarray(tree["probe_feats"]))


def select_knee(points: Sequence[Dict], frontier: Sequence[int],
                acc_tol: float = 0.02) -> int:
    """The frontier point to serve by default: the smallest int weight
    footprint within ``acc_tol`` of the frontier's best accuracy."""
    if not frontier:
        raise ValueError("empty frontier: nothing to select a knee from")
    best = max(points[i]["acc_mean"] for i in frontier)
    good = [i for i in frontier if points[i]["acc_mean"] >= best - acc_tol]
    return min(good, key=lambda i: (points[i]["weight_bytes_int"],
                                    -points[i]["acc_mean"]))


def publish_frontier(result: FarmResult, registry, *, datapath: str = "int",
                     set_default: bool = True, acc_tol: float = 0.02,
                     device: DeviceLike = None) -> List[str]:
    """Deploy the Pareto-optimal points on ``device`` (default: the card)
    and register them for serving as ``"{label}-{datapath}"``, with
    provenance metadata; the registry default hot-swaps to the
    :func:`select_knee` point.  Returns the names in frontier order."""
    if not result.points:
        raise ValueError("cannot publish an empty farm result")
    dev = resolve_device(device)
    knee = select_knee(result.points, result.frontier, acc_tol)
    arch = result.config.get("arch", "resnet9")
    names: List[str] = []
    for i in result.frontier:
        rec = result.points[i]
        cand = as_candidate(rec.get("candidate",
                                    (rec["w_bits"], rec["a_bits"])))
        pr = _restore_point(result.cache_dir, result.keys[i],
                            result.config["width"],
                            result.config["bench_batch"], arch=arch)
        pipe = FSLPipeline(width=result.config["width"],
                           qcfg=candidate_config(cand), arch=arch,
                           device=dev)
        feats = pipe.deploy(pr.params, datapath=datapath)
        name = f"{rec.get('label', candidate_label(cand))}-{datapath}"
        dp = "int" if datapath == "int" else "f32"
        registry.register(
            name, feats,
            default=(set_default and i == knee),
            meta={
                "arch": arch, "label": rec.get("label"),
                "candidate": rec.get("candidate"),
                "plan": rec.get("plan"),
                "w_bits": rec["w_bits"], "a_bits": rec["a_bits"],
                "datapath": datapath,
                "weight_bytes": rec[f"weight_bytes_{dp}"],
                "acc_mean": rec["acc_mean"], "acc_ci95": rec["acc_ci95"],
                "ms_per_batch": rec[f"{dp}_ms_per_batch"],
                "point_seed": rec["point_seed"],
                "probe_digest": rec["probe_digest"],
                "modeled_ms": rec.get("modeled_ms"),
                "cost_top": rec.get("cost_top"),
                "cache_key": result.keys[i], "knee": i == knee,
            })
        names.append(name)
    return names


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache-dir", default="FARM_cache")
    ap.add_argument("--quick", action="store_true",
                    help="tiny budget: fewer steps/episodes (CI smoke)")
    ap.add_argument("--out", default="FARM_frontier.json")
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
        kw.update(width=min(args.width, 8), steps=20, episodes=3,
                  bench_iters=3)
    result = SweepFarm(args.cache_dir, **kw).run()
    result.write(args.out)
    sys.stdout.write(f"farm,written,{args.out}\n")


if __name__ == "__main__":
    main()
