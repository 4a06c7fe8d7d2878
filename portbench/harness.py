"""One run of one cell of the port's benchmark.

``BENCHMARK.json`` at the root of the checkout names the cells. A cell
names a configuration (``portbench/configs/<config>.json``, whose ``arch``
names the system under test in ``portbench/systems/<arch>.py`` and its
plain reference in ``portbench/reference/<arch>_qat.py``) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``driver`` names the general
generator that reads it, ``portbench/drivers/<driver>.py``). Each
per-layer metric is read by ``portbench/layer_metrics/<name>.py``.
Everything is found by name, so a new cell, configuration, mix, driver or
metric is a new file and a new entry.

A run: set-up (weights and frames from the seed, the system built and
warmed), the window, with ``--trace 1`` a traced stretch of the same
traffic after it, then the system freed and the reference run on what the
window produced. The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


class Card:
    """The CUDA device the cell runs on."""

    on_card = True
    platform = "gpu"

    def __init__(self, chips: int):
        self.device = torch.device("cuda", 0)
        self.count = chips

    def record(self):
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def sync(self) -> None:
        torch.cuda.synchronize(self.device)

    def kind(self) -> str:
        return torch.cuda.get_device_name(0)

    def peak_bytes(self) -> int:
        """The allocator's peak since the process started, on the fullest
        card."""
        return max(torch.cuda.max_memory_allocated(d)
                   for d in range(self.count))

    def generator(self) -> torch.Generator:
        return torch.Generator(device=self.device)

    def release(self) -> None:
        torch.cuda.empty_cache()

    def power_limit(self) -> str:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"not read ({type(e).__name__})"
        return out.stdout.strip().replace("\n", "; ") or "not read"


class _Done:
    @staticmethod
    def synchronize() -> None:
        pass


class CpuStub(Card):
    """The CPU in the card's place, for the harness's own tests: every call
    is synchronous and nothing on it is a device measurement."""

    on_card = False
    platform = "cpu"

    def __init__(self, chips: int = 1):
        self.device = torch.device("cpu")
        self.count = chips

    def record(self):
        return _Done

    def sync(self) -> None:
        pass

    def kind(self) -> str:
        return "cpu stub (not a device)"

    def peak_bytes(self) -> int:
        return 0

    def generator(self) -> torch.Generator:
        return torch.Generator()

    def release(self) -> None:
        pass

    def power_limit(self) -> str:
        return "not measured (cpu stub)"


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path) -> ModuleType:
    """A harness file found by name (names may hold dots)."""
    name = "portbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or, with
    no list, wherever the end-to-end metric it moves is (an end-to-end
    metric with no list: everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


class Context(SimpleNamespace):
    """What a driver reads: the cell's files, the seed, the device, the
    system under test and the parameters."""

    def rng(self, stream: str) -> np.random.Generator:
        """A generator of its own for each named use of the seed."""
        return np.random.default_rng([self.seed_u,
                                      zlib.crc32(stream.encode())])


def context(root: Path, workload: str, seed: int, seconds: float,
            dev: Card, trace: bool = False):
    """The cell's :class:`Context` (its files, the seed, the device, the
    system under test, the parameters drawn from the seed) and its plain
    reference module."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / conf["file"])
    pb = root / "portbench"
    ctx = Context(workload=workload, seed=seed, seed_u=seed % (1 << 63),
                  seconds=seconds, trace=trace, cfg=cfg, dev=dev,
                  traffic=load_json(pb / "traffic" / f"{cell['traffic']}.json"),
                  out_dir=pb / "out",
                  system=load_module(pb / "systems" / f"{cfg['arch']}.py"))
    refmod = load_module(pb / "reference" / f"{cfg['arch']}_qat.py")
    ctx.params = refmod.init_params(dev.generator().manual_seed(ctx.seed_u),
                                    cfg["width"], dev.device)
    ctx.driver = load_module(pb / "drivers" / f"{ctx.traffic['driver']}.py")
    return ctx, refmod


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, dev: Card, age_at: Callable[[], float],
             wrap: Optional[Callable] = None):
    """Run the cell; returns (result dict, numbers compared, info lines).
    ``age_at()`` is the process's age in seconds now; ``wrap(driver)``, for
    the harness's tests, may break the timed path after set-up."""
    phases = {"start_to_harness": age_at()}
    bench = load_json(root / "BENCHMARK.json")
    ctx, refmod = context(root, workload, seed, seconds, dev, trace)
    dev.sync()
    phases["weights"] = age_at() - sum(phases.values())
    cfg, traffic = ctx.cfg, ctx.traffic
    pb = root / "portbench"
    ctx.out_dir.mkdir(exist_ok=True)
    driver = ctx.driver.Driver(ctx)
    dev.sync()
    phases["inputs_system_warmup"] = age_at() - sum(phases.values())
    if wrap is not None:
        wrap(driver)
    t_start = driver.window(seconds)
    setup_s = age_at() - (time.perf_counter() - t_start)
    tr = driver.traced_stretch() if trace else None
    peak = dev.peak_bytes()

    driver.free()
    dev.release()
    params = ctx.params

    def reference(x: torch.Tensor) -> torch.Tensor:
        return refmod.features(params, x.to(dev.device), cfg["width"], cfg,
                               cfg["flip_ensemble"])

    numbers = driver.compare(reference)

    e2e = [m for m in bench["end_to_end"] if applies(m, workload, [])]
    reported = [m["name"] for m in e2e]
    metrics: Dict[str, Dict] = {}
    if not trace:
        values = dict(driver.e2e, setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        readings = SimpleNamespace(cfg=cfg, traffic=traffic, trace=tr,
                                   **driver.readings)
        for m in bench["per_layer"]:
            if not applies(m, workload, reported):
                continue
            reader = load_module(pb / "layer_metrics" / f"{m['name']}.py")
            v = reader.read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": dev.platform, "kind": dev.kind(),
              "count": dev.count, "memory_peak_bytes": peak}
    result = {"correct": all(n.ok for n in numbers),
              "attempted": driver.attempted,
              "failed": getattr(driver, "failed", 0),
              "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {n.name: {"value": n.value, "limit": n.limit}
                        for n in numbers}
    info = [f"device: {dev.kind()}, {torch.cuda.device_count()} visible, "
            f"{dev.count} used; nvidia-smi name, power.limit: "
            f"{dev.power_limit()}",
            f"workload {workload} seed {seed} seconds {seconds} trace "
            f"{int(trace)}: setup_s {setup_s:.3f}, attempted "
            f"{result['attempted']}, failed {result['failed']}",
            "setup phases (s): " + ", ".join(
                f"{k} {v:.3f}" for k, v in phases.items())]
    return result, numbers, info


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], age_at: Callable[[], float],
         stub: bool = False, root: Path = ROOT,
         wrap: Optional[Callable] = None) -> int:
    args = parse(argv)
    bench = load_json(root / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    if stub:
        dev: Card = CpuStub(chips)
    else:
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark runs on the card only",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < chips:
            print(f"{torch.cuda.device_count()} CUDA device(s), the cell "
                  f"needs {chips}", file=sys.stderr)
            return 3
        dev = Card(chips)
    result, numbers, info = run_cell(root, args.workload, args.seed,
                                     args.seconds, bool(args.trace), dev,
                                     age_at, wrap)
    gc.collect()
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    for line in info:
        print(line, flush=True)
    for n in numbers:
        print(f"check {n.name} = {n.value!r} limit {n.limit!r} "
              f"{'ok' if n.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
