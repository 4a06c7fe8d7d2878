"""Bit-width design-space exploration — the paper's Tables II/III as a
program, on the card.

Counterpart of the JAX package's ``explore/sweep.py``.  :func:`run_point`
is ONE iteration of the paper's loop:

  1. QAT-pretrain the ResNet-9 backbone at that grid
     (``fsl.pipeline.pretrain_backbone``, on the device);
  2. compile BOTH deployment artifacts — ``datapath="f32"`` (grid-emulated,
     the float MVAU and GAP kernels) and ``datapath="int"`` (integer codes
     and the integer MVAU kernels) — and check that they agree bit for bit
     on a probe batch;
  3. score novel-class episode accuracy through the deployed int artifact
     (the deployed-accuracy contract);
  4. measure weight storage bytes (f32 vs int) and per-batch latency.

:func:`sweep` is the serial loop over a grid; ``repro_torch.explore.farm``
is the parallel, resumable, registry-publishing orchestrator over the same
:func:`run_candidate`.

Seeding: each candidate derives its own stream via :func:`candidate_seed`
(a content hash of ``(seed, candidate)``), so a point's deterministic
record fields (:data:`DETERMINISTIC_KEYS`) are a pure function of
``(config, seed, device type)``.  The probe batch is regenerable from the
record (:func:`probe_batch`); it is drawn with numpy, not the reference's
``jax.random``, so ``probe_digest`` is comparable only inside the port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.quant import LayerQuantPlan, QuantConfig, fake_quant
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fsl.pipeline import (FSLPipeline, evaluate_episodes,
                                      pretrain_backbone)

__all__ = ["DEFAULT_GRID", "DETERMINISTIC_KEYS", "Candidate", "PointResult",
           "as_candidate", "candidate_config", "candidate_content",
           "candidate_label", "candidate_seed", "config_for",
           "device_label", "pareto_frontier", "point_seed", "probe_batch",
           "run_candidate", "run_point", "sweep"]

# A DSE candidate: a uniform (W, A) grid point or a per-layer plan.
Candidate = Union[Tuple[int, int], LayerQuantPlan]

# (weight_bits, act_bits) grid — paper Table II's sweep axis.
DEFAULT_GRID: Tuple[Tuple[int, int], ...] = ((3, 2), (4, 4), (6, 4), (8, 8))

# Serializes the latency-measurement window across concurrent farm workers.
_BENCH_LOCK = threading.Lock()

# Record keys that are a pure function of (config, seed) — no wall-clock.
DETERMINISTIC_KEYS: Tuple[str, ...] = (
    "arch", "label", "candidate", "w_bits", "a_bits", "weight_spec",
    "act_spec", "acc_mean", "acc_ci95", "weight_bytes_f32",
    "weight_bytes_int", "bitexact_int_vs_f32", "final_pretrain_loss", "seed",
    "point_seed", "probe_digest")


def config_for(w_bits: int, a_bits: int) -> QuantConfig:
    """The paper's frac-split convention for a (W, A) point — alias of
    :meth:`QuantConfig.grid_point`."""
    return QuantConfig.grid_point(w_bits, a_bits)


def device_label(device: torch.device) -> str:
    """The device's type and name, the record of where a sweep ran."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


# ---------------------------------------------------------------------------
# Candidate protocol
# ---------------------------------------------------------------------------
def as_candidate(cand: Union[Candidate, Sequence[int], Dict]) -> Candidate:
    """Normalize a candidate descriptor: ``(W, A)`` pairs become int
    tuples, plan dicts/``LayerQuantPlan`` become plans; a plan with no
    overrides collapses to its uniform tuple."""
    if isinstance(cand, LayerQuantPlan):
        return cand.default if not cand.layers else cand
    if isinstance(cand, dict):
        return as_candidate(LayerQuantPlan.from_dict(cand))
    w, a = cand
    return (int(w), int(a))


def candidate_label(cand: Candidate) -> str:
    """``w6a4`` for uniform points, ``mp-<digest>`` for per-layer plans."""
    cand = as_candidate(cand)
    if isinstance(cand, LayerQuantPlan):
        return f"mp-{cand.digest()}"
    return f"w{cand[0]}a{cand[1]}"


def candidate_content(cand: Candidate):
    """Canonical JSON-able identity: ``[W, A]`` or the plan's dict."""
    cand = as_candidate(cand)
    if isinstance(cand, LayerQuantPlan):
        return cand.to_dict()
    return [cand[0], cand[1]]


def candidate_config(cand: Candidate) -> QuantConfig:
    """The QuantConfig a candidate trains AND deploys at."""
    cand = as_candidate(cand)
    if isinstance(cand, LayerQuantPlan):
        return cand.quant_config()
    return QuantConfig.grid_point(*cand)


def _seed63(blob: bytes) -> int:
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big") >> 1


def point_seed(seed: int, w_bits: int, a_bits: int) -> int:
    """Per-point 63-bit seed: a content hash of ``(seed, W, A)``, stable
    under grid reordering and distinct across points."""
    blob = f"{int(seed)}:{int(w_bits)}:{int(a_bits)}".encode()
    return _seed63(blob)


def candidate_seed(seed: int, cand: Candidate) -> int:
    """:func:`point_seed` generalized to plans (content-hashed over the
    canonical plan JSON)."""
    cand = as_candidate(cand)
    if isinstance(cand, tuple):
        return point_seed(seed, *cand)
    blob = f"{int(seed)}:plan:" + json.dumps(
        candidate_content(cand), sort_keys=True, separators=(",", ":"))
    return _seed63(blob.encode())


def probe_batch(pseed: int, n: int, img: int) -> np.ndarray:
    """The bit-exactness probe batch for a point, (n, img, img, 3) float32
    in [0, 1), regenerable from its record's ``point_seed``."""
    return np.random.default_rng(pseed + 1).random((n, img, img, 3),
                                                   dtype=np.float32)


def pareto_frontier(points: Sequence[Dict]) -> List[int]:
    """Indices of points not dominated on (maximize accuracy, minimize int
    weight bytes), ascending.  Sort-then-scan; domination needs ≥ on both
    axes with one strict, so exact duplicates both survive."""
    n = len(points)
    order = sorted(range(n), key=lambda i: (points[i]["weight_bytes_int"],
                                            -points[i]["acc_mean"]))
    frontier: List[int] = []
    best_acc = -float("inf")     # max accuracy among strictly-smaller-bytes
    i = 0
    while i < n:
        j = i
        b = points[order[i]]["weight_bytes_int"]
        while j < n and points[order[j]]["weight_bytes_int"] == b:
            j += 1
        group = order[i:j]
        gmax = max(points[k]["acc_mean"] for k in group)
        if gmax > best_acc:      # else: dominated by a smaller-bytes point
            frontier.extend(k for k in group
                            if points[k]["acc_mean"] == gmax)
        best_acc = max(best_acc, gmax)
        i = j
    return sorted(frontier)


@dataclasses.dataclass
class PointResult:
    """One grid point's outcome: the JSON ``record``, the trained backbone
    ``params`` and the served-path ``probe_feats`` (what the farm
    checkpoints)."""

    record: Dict
    params: Dict
    probe_feats: np.ndarray


def run_point(w_bits: int, a_bits: int, **kw) -> PointResult:
    """Run ONE uniform (W, A) grid point: :func:`run_candidate` on a tuple."""
    return run_candidate((w_bits, a_bits), **kw)


def run_candidate(cand: Candidate, *, width: int = 8, steps: int = 120,
                  episodes: int = 10, batch: int = 32, bench_batch: int = 8,
                  bench_iters: int = 10, seed: int = 0,
                  data: Optional[SyntheticImages] = None,
                  n_base: int = 12, n_novel: int = 6, arch: str = "resnet9",
                  verbose: bool = False,
                  device: DeviceLike = None) -> PointResult:
    """Run ONE candidate end to end on ``device`` (default: the card); see
    the module docstring.  ``seed`` is the SWEEP seed; the candidate
    derives its own stream via :func:`candidate_seed`."""
    dev = resolve_device(device)
    cand = as_candidate(cand)
    if data is None:
        data = SyntheticImages(n_base=n_base, n_novel=n_novel, seed=seed)
    ps = candidate_seed(seed, cand)
    qcfg = candidate_config(cand)
    plan = cand if isinstance(cand, LayerQuantPlan) else None
    w_bits, a_bits = plan.default if plan else cand
    pipe = FSLPipeline(width=width, qcfg=qcfg, arch=arch, device=dev)
    out = pretrain_backbone(data, pipe, steps=steps, batch=batch, seed=ps)
    params = out["params"]

    feats_int = pipe.deploy(params, datapath="int")
    dm_int = feats_int.deployed_model
    dm_f32 = pipe.deploy(params, datapath="f32").deployed_model

    probe = torch.from_numpy(probe_batch(ps, bench_batch, data.img)).to(dev)
    probe_q = fake_quant(probe, qcfg.act)
    bitexact = bool(torch.equal(dm_f32(probe_q), dm_int(probe_q)))
    # Served-path probe features: the same flip-ensemble function the
    # registry serves after publish_frontier — the point's audit anchor.
    probe_feats = feats_int(probe).cpu().numpy()

    acc, ci = evaluate_episodes(params, data, pipe, n_episodes=episodes,
                                seed=ps + 100, feats_fn=feats_int)
    # farm workers serialize their timing windows so two benches never
    # time each other's launches; the bench batch is warmed first, so on
    # the card each artifact is timed as it is served, one replayed CUDA
    # graph per call
    with _BENCH_LOCK:
        dm_f32.warmup((bench_batch,), probe_q)
        dm_int.warmup((bench_batch,), probe_q)
        t_f32 = dm_f32.throughput(probe_q, iters=bench_iters)
        t_int = dm_int.throughput(probe_q, iters=bench_iters)
    # modeled per-node cost at the bench batch (repro_torch.obs.costmodel);
    # not deterministic across devices: the roofline constants differ
    prof = dm_int.profile(probe_q, xla=False)
    top = max(prof["nodes"], key=lambda r: r["est_ms"], default=None)
    record = {
        "arch": arch,
        "label": candidate_label(cand),
        "candidate": candidate_content(cand),
        "plan": plan.to_dict() if plan else None,
        "w_bits": w_bits, "a_bits": a_bits,
        "weight_spec": qcfg.weight.describe(),
        "act_spec": qcfg.act.describe(),
        "acc_mean": acc, "acc_ci95": ci,
        "weight_bytes_f32": dm_f32.weight_bytes(),
        "weight_bytes_int": dm_int.weight_bytes(),
        "f32_ms_per_batch": t_f32["ms_per_call"],
        "int_ms_per_batch": t_int["ms_per_call"],
        "int_batches_per_s": t_int["calls_per_s"],
        "bitexact_int_vs_f32": bitexact,
        "modeled_ms": prof["totals"]["est_ms"],
        "modeled_flops": prof["totals"]["flops"],
        "modeled_bytes": prof["totals"]["bytes"],
        "cost_top": ({"tensor": top["tensor"], "op": top["op"],
                      "kernel": top["kernel"], "share": top["share"]}
                     if top else None),
        "final_pretrain_loss": float(out["losses"][-1]),
        "seed": int(seed), "point_seed": int(ps),
        "probe_digest": hashlib.sha256(probe_feats.tobytes()).hexdigest(),
    }
    if verbose:
        sys.stdout.write(
            f"sweep,{record['label']},acc={acc:.3f}±{ci:.3f},"
            f"bytes={record['weight_bytes_int']},"
            f"ms={record['int_ms_per_batch']:.2f},"
            f"bitexact={int(bitexact)}\n")
    return PointResult(record=record, params=params, probe_feats=probe_feats)


def sweep(grid: Sequence[Candidate] = DEFAULT_GRID, *,
          width: int = 8, steps: int = 120, episodes: int = 10,
          n_base: int = 12, n_novel: int = 6, batch: int = 32,
          bench_batch: int = 8, bench_iters: int = 10, seed: int = 0,
          data: Optional[SyntheticImages] = None,
          out_path: Optional[str] = None, verbose: bool = True,
          device: DeviceLike = None) -> Dict:
    """Run the bit-width DSE loop serially on ``device`` (default: the
    card); returns (and optionally writes) the frontier dict."""
    dev = resolve_device(device)
    if data is None:
        data = SyntheticImages(n_base=n_base, n_novel=n_novel, seed=seed)
    points: List[Dict] = []
    for cand in grid:
        pr = run_candidate(cand, width=width, steps=steps,
                           episodes=episodes, batch=batch,
                           bench_batch=bench_batch, bench_iters=bench_iters,
                           seed=seed, data=data, verbose=verbose, device=dev)
        points.append(pr.record)

    result = {
        "model": "resnet9", "width": width, "backend": device_label(dev),
        "pretrain_steps": steps, "episodes": episodes, "seed": int(seed),
        "points": points, "frontier": pareto_frontier(points),
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
        if verbose:
            sys.stdout.write(f"sweep,written,{out_path}\n")
    return result


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny budget: fewer steps/episodes (CI smoke)")
    ap.add_argument("--out", default="SWEEP_frontier.json")
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.quick:
        sweep(width=min(args.width, 8), steps=20, episodes=3, bench_iters=3,
              seed=args.seed, out_path=args.out, device=args.device)
    else:
        sweep(width=args.width, steps=240, episodes=20, seed=args.seed,
              out_path=args.out, device=args.device)


if __name__ == "__main__":
    main()
