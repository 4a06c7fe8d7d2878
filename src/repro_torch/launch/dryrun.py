"""Multi-pod dry run of the port: every (arch × shape) step run over a
``"fake"`` process group of 256 or 512 ranks on the production mesh, its
per-device dots, collectives and argument bytes recorded.

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell for 512 forced host devices and reads the compiled HLO.
Here :func:`main` (never an import) starts
``init_process_group("fake", store=FakeStore(), rank=0, world_size=...)``,
builds the mesh, places params, moments, batch and cache as DTensors over
META local shards (no storage), and runs the unchanged train / prefill /
decode step under :class:`repro_torch.obs.hlo.DispatchRecord`: the
record of rank 0's local ops stands where the reference's HLO stands.
Collectives of a fake group move nothing, so the run is a schedule, not a
measurement of time.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod both|single|multi]
  python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k \\
      --variant w8

Artifacts: ``dryrun_out/<arch>__<shape>__<mesh>__<variant>.json`` under
the repository root (git-ignored), or ``--out DIR``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.dist import act_sharding
from repro_torch.dist.sharding import (
    NamedSharding,
    set_fsdp_axes,
    set_moe_expert_axis,
    tree_batch_shardings,
    tree_cache_shardings,
    tree_opt_shardings,
    tree_param_shardings,
)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import ArchConfig, get_config
from repro_torch.obs import hlo
from repro_torch.tree import tree_flatten, tree_map

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "dryrun_out")


# ---------------------------------------------------------------------------
# Variants (hillclimb levers — each returns cfg overrides + rules)
# ---------------------------------------------------------------------------
def apply_variant(cfg: ArchConfig, variant: str, mesh):
    """Returns (cfg, serving_bits, act_rules, notes): the reference's
    levers, the same notes; rules are act-sharding rules
    (:class:`NamedSharding`) bound around the step."""
    bspec = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    rules = {
        "residual": NamedSharding(mesh, (bspec, None, None)),
        "logits": NamedSharding(mesh, (bspec, None, "model")),
    }
    serving_bits = 0
    notes = []
    for v in (variant.split("+") if variant else []):
        if v in ("", "base"):
            continue
        elif v == "w8":
            serving_bits = 8
            notes.append("serving weights int8 (paper bit-width lever)")
        elif v == "w4":
            serving_bits = 4
            notes.append("serving weights int4-packed")
        elif v == "sp":
            rules["residual"] = NamedSharding(mesh, (bspec, None, "model"))
            notes.append("sequence/feature-parallel residual stream")
        elif v == "seqsp":
            rules["residual"] = NamedSharding(mesh, (bspec, "model", None))
            notes.append("sequence-parallel residual (seq on model axis)")
        elif v == "nologitsp":
            rules.pop("logits")
            notes.append("no logits sharding constraint")
        elif v == "noremat":
            cfg = dataclasses.replace(cfg, remat=False)
            notes.append("activation checkpointing off")
        elif v.startswith("accum"):
            cfg = dataclasses.replace(cfg, grad_accum=int(v[5:]))
            notes.append(f"grad_accum={v[5:]}")
        elif v.startswith("chunk"):
            cfg = dataclasses.replace(cfg, prefill_chunk=int(v[5:]))
            notes.append(f"prefill_chunk={v[5:]}")
        elif v.startswith("mesh"):
            notes.append(f"mesh re-factorized: {v[4:]}")
        elif v == "epmodel":
            notes.append("MoE experts sharded over the model axis "
                         "(EP on model; d_ff takes data)")
        elif v == "epdispatch":
            rules["moe_dispatch"] = NamedSharding(mesh, ("model", None, None))
            notes.append("MoE dispatch buffer expert-sharded on model")
        elif v == "epdispatchdata":
            rules["moe_dispatch"] = NamedSharding(mesh, ("data", None, None))
            notes.append("MoE dispatch buffer expert-home-sharded on data")
        elif v == "rematsave":
            cfg = dataclasses.replace(cfg, remat_policy="tp_outputs")
            notes.append("remat saves post-AR TP outputs "
                         "(backward re-runs no collectives)")
        elif v == "gradbf16":
            notes.append("bf16 gradient accumulation/reduction "
                         "(halves dW all-reduce payload)")
        elif v == "cachequant":
            notes.append("int8 KV cache")  # handled via cache dtype below
        elif v == "nofsdp":
            notes.append("FSDP off: pure TP + ZeRO-1 moments "
                         "(kills per-microbatch weight gathers)")
        elif v == "attnsp":
            rules["attn_chunk_q"] = NamedSharding(
                mesh, (bspec, "model", None, None, None))
            rules["attn_q_rows"] = NamedSharding(
                mesh, (bspec, "model", None, None))
            notes.append("attention q-rows sharded on model axis "
                         "(seq-TP: no sharded-contraction partial sums)")
        elif v == "headshard":
            rules["attn_heads"] = NamedSharding(
                mesh, (bspec, None, "model", None))
            notes.append("attention head dim sharded on model "
                         "(GSPMD pads uneven head counts)")
        else:
            raise ValueError(f"unknown variant component '{v}'")
    return cfg, serving_bits, rules, notes


# ---------------------------------------------------------------------------
# Placing stand-ins and running a step under the record
# ---------------------------------------------------------------------------
def place(tree: Any, shardings: Any) -> Any:
    """Each (meta or real) leaf as a DTensor of its layout; every rank
    keeps its own chunk (no communication)."""
    return tree_map(lambda t, s: s.place(t), tree, shardings)


def local_bytes(*trees: Any) -> int:
    """Bytes of this rank's shards of every tensor leaf of ``trees``."""
    from repro_torch.dist.dtensor import is_dtensor

    total = 0
    for t in trees:
        for leaf in tree_flatten(t)[0]:
            if isinstance(leaf, torch.Tensor):
                loc = leaf.to_local() if is_dtensor(leaf) else leaf
                total += loc.numel() * loc.element_size()
    return total


def trace_step(fn, *args) -> Tuple[Any, List[hlo.Event]]:
    """Run ``fn(*args)`` under a :class:`~repro_torch.obs.hlo.DispatchRecord`
    (and, for DTensor arguments, implicit replication)."""
    from repro_torch.dist import dtensor as D

    with hlo.DispatchRecord() as rec, D.implicit(*args):
        out = fn(*args)
    return out, rec.events


# ---------------------------------------------------------------------------
# Cell lowering
# ---------------------------------------------------------------------------
def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "") -> Dict[str, Any]:
    """One cell on the production mesh of the running (fake) group."""
    from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                          make_train_step, train_dtype_policy)
    from repro_torch.optim import adamw_init

    cfg = get_config(arch)
    ok, why = S.cell_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "variant": variant, "status": "skipped", "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    # mesh re-factorization lever: the same 256 ranks, another split
    mm = re.search(r"mesh(\d+)x(\d+)", variant or "")
    if mm and not multi_pod:
        from torch.distributed.device_mesh import init_device_mesh

        d_, m_ = int(mm.group(1)), int(mm.group(2))
        assert d_ * m_ == 256, "single-pod mesh must keep 256 ranks"
        mesh = init_device_mesh("cpu", (d_, m_),
                                mesh_dim_names=("data", "model"))
    cfg, serving_bits, rules, notes = apply_variant(cfg, variant, mesh)
    kind = S.SHAPES[shape_name]["kind"]
    set_moe_expert_axis("model" if "epmodel" in (variant or "") else "data")
    if "nofsdp" in (variant or ""):
        set_fsdp_axes(())
    elif multi_pod and cfg.n_params() > 5e10:
        set_fsdp_axes(("pod", "data"))
        notes = notes + ["FSDP over (pod,data) — ZeRO-3 across pods"]
    else:
        set_fsdp_axes(("data",))
    t0 = time.time()

    with act_sharding.rules(rules):
        batch = place(S.batch_specs(cfg, shape_name),
                      tree_batch_shardings(S.batch_specs(cfg, shape_name),
                                           mesh))
        if kind == "train":
            pdtype, moment_dtype, _ = train_dtype_policy(cfg)
            params_sds = S.param_specs(cfg, dtype=pdtype)
            params = place(params_sds, tree_param_shardings(params_sds, mesh))
            opt = adamw_init(params, moment_dtype=moment_dtype)
            step = make_train_step(
                cfg, compress_pod_grads=multi_pod,
                acc_shardings=tree_opt_shardings(params_sds, mesh),
                grad_dtype=torch.bfloat16 if "gradbf16" in (variant or "")
                else None)
            args = (params, opt, batch)
            if multi_pod:
                args = args + (tree_map(torch.zeros_like, params),)
        elif kind == "prefill":
            params_sds = S.param_specs(cfg, serving_bits, dtype=torch.bfloat16)
            params = place(params_sds, tree_param_shardings(params_sds, mesh))
            step = make_prefill_step(cfg)
            args = (params, batch)
        else:  # decode
            params_sds = S.param_specs(cfg, serving_bits, dtype=torch.bfloat16)
            params = place(params_sds, tree_param_shardings(params_sds, mesh))
            cache_dtype = torch.int8 if "cachequant" in (variant or "") \
                else torch.bfloat16
            cache_sds = S.cache_specs(cfg, shape_name, dtype=cache_dtype)
            cache = place(cache_sds, tree_cache_shardings(cache_sds, mesh))
            step = make_decode_step(cfg)
            args = (params, batch, cache)
        arg_bytes = local_bytes(*args)
        t_place = time.time() - t0
        out, log = trace_step(step, *args)
        t_run = time.time() - t0 - t_place

    deep = hlo.analyze(log)
    mem_d = {"argument_size_in_bytes": arg_bytes,
             "output_size_in_bytes": local_bytes(out)}
    n_dev = mesh.size()
    return {
        "arch": arch, "shape": shape_name, "variant": variant or "base",
        "multi_pod": multi_pod,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "status": "ok", "kind": kind,
        "n_devices": n_dev,
        "dot_flops_per_device": float(deep["dot_flops"]),
        "collective_bytes_per_device": deep["collective_bytes"],
        "collective_counts": deep["collective_counts"],
        "memory_analysis": mem_d,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "lower_s": round(t_place, 2), "compile_s": round(t_run, 2),
        "notes": notes,
    }


def artifact_path(arch, shape, multi_pod, variant, out_dir=None):
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    v = variant or "base"
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_tag}__{v}.json")


def run_cell(arch, shape, multi_pod, variant="", force=False,
             out_dir=None) -> Dict:
    path = artifact_path(arch, shape, multi_pod, variant, out_dir)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        res = lower_cell(arch, shape, multi_pod, variant)
    except Exception as e:  # a failing cell is a bug — record it loudly
        res = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "variant": variant or "base", "status": "FAILED",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def fake_group(world_size: int) -> None:
    """Start a ``"fake"`` process group of ``world_size`` ranks, this
    process rank 0 (collectives return at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default="")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default: dryrun_out/)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import ASSIGNED
    pods = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    n_ok = n_skip = n_fail = 0
    for mp in pods:
        cells = ([(arch, shape) for arch in ASSIGNED for shape in S.SHAPES]
                 if args.all else [(args.arch, args.shape)])
        fake_group(512 if mp else 256)
        try:
            for arch, shape in cells:
                res = run_cell(arch, shape, mp, args.variant, args.force,
                               args.out)
                tag = f"{arch:18s} {shape:12s} {'2x16x16' if mp else '16x16':8s}"
                if res["status"] == "ok":
                    n_ok += 1
                    mem = res.get("memory_analysis", {})
                    print(f"OK   {tag} "
                          f"dotflops={res['dot_flops_per_device']:.3e} "
                          f"lower={res['lower_s']}s "
                          f"compile={res['compile_s']}s "
                          f"args={mem.get('argument_size_in_bytes', 0)/2**30:.2f}GiB")
                elif res["status"] == "skipped":
                    n_skip += 1
                    print(f"SKIP {tag} ({res['reason'][:60]})")
                else:
                    n_fail += 1
                    print(f"FAIL {tag} {res['error'][:120]}")
        finally:
            dist.destroy_process_group()
    print(f"\n{n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
