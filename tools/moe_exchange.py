#!/usr/bin/env python3
"""What the expert-parallel MoE exchange costs: one MoE layer at the full
widths of each MoE config, forward and backward, on every rank's own
tokens, and the dispatch and combine alone.

Four cards, one rank each, over NCCL::

    torchrun --nproc-per-node 4 tools/moe_exchange.py --out DIR

On the CPU at reduced widths (gloo; the same code, for a quick run)::

    python3 tools/moe_exchange.py --spawn 4 --cpu --out DIR

For each config (:data:`ARCHS`, bf16 banks and activations, the train
policy above 50B parameters) and each ``("data", "model")`` mesh of
:data:`MESHES`, the layer's input is ``(n_data, SEQ, d)`` (one sequence a
``"data"`` rank, d over ``"model"``, as the train step hands it to
``layers.moe``), the params placed by ``tree_param_shardings``.  Timed
(``--reps`` runs after one warm run, synchronised host clock, ms each):

* ``layer`` — ``layers.moe`` forward and backward (gradients of the
  params and of x);
* ``exchange`` — ``dtensor.ExpertDispatch`` and its combine, forward and
  backward, with the buffer fed straight to the combine (no experts): the
  slots, the scatter, the two all-to-alls and their inverses;
* ``needed`` — ``all_to_all_single`` of each rank's k·T_local rows of d
  in even splits, four times (dispatch and combine, forward and
  backward): about what an exchange that moves only the routed rows
  would take.

Bytes: one ``layer`` and one ``exchange`` run under
``obs.hlo.DispatchRecord`` (per rank, by kind; the layer's all-to-alls
include the banks' moves to the experts' layout), beside the ``needed``
exchanges' (each all-to-all counted at its input's bytes).  Rank 0 writes
``summary.json`` under ``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("grok-1-314b", "arctic-480b")
MESHES = ((2, 2), (4, 1))
SEQ = 4096                   # tokens of one sequence (the train_4k shape)
CPU_SEQ = 32


def _config(arch, cpu):
    from repro_torch.models.common import get_config
    from repro_torch.models.testing import reduce_config

    cfg = get_config(arch)
    if cpu:
        cfg = reduce_config(cfg, moe_capacity_factor=cfg.moe_capacity_factor,
                            compute_dtype="bfloat16")
    return cfg


def _ms(torch, dev, fn, reps):
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t.append((time.perf_counter() - t0) * 1e3)
    t.sort()
    return t[len(t) // 2]


def cell(torch, dist, dev, arch, shape, seq, reps, cpu):
    """One config on one mesh: the times and bytes of the module
    docstring."""
    from repro_torch.dist import dtensor as D
    from repro_torch.dist.sharding import NamedSharding, tree_param_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.obs import hlo
    from repro_torch.tree import tree_flatten, tree_map

    cfg = _config(arch, cpu)
    mesh = make_debug_mesh(*shape, device_type=dev.type)
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k
    bf = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)

    def bank(*dims):
        # drawn in bf16: arctic's three banks in float32 would fill a card
        return torch.randn(dims, generator=gen, device=dev,
                           dtype=bf) * dims[-2] ** -0.5

    params = {"router": L.dense_init(gen, d, E, device=dev),
              "w_gate": bank(E, d, f), "w_up": bank(E, d, f),
              "w_down": bank(E, f, d)}
    if cfg.moe_dense_residual:
        params["dense_mlp"] = L.mlp_init(gen, d, f, cfg.act, device=dev)
    params = tree_map(lambda t: t.to(bf), params)
    params = tree_map(lambda t, s: s.place(t).requires_grad_(True), params,
                      tree_param_shardings(params, mesh))
    x = torch.randn((shape[0], seq, d), generator=gen, device=dev, dtype=bf)
    x = NamedSharding(mesh, ("data", None, "model")).place(x)
    x.requires_grad_(True)
    leaves = [x] + tree_flatten(params)[0]

    def layer():
        with D.implicit(params, x):
            y, aux = L.moe(params, x, cfg)
            torch.autograd.grad((y.float().sum(), aux), leaves)

    T = shape[0] * seq
    C = max(int(cfg.moe_capacity_factor * T * k / E), 1)
    with torch.no_grad(), D.implicit(params, x):
        _, gates, idx = L.moe_route(
            params, D.unshard(D.reshape(x, T, d), (1,)), cfg)
    ids = idx.reshape(T * k)

    def exchange():
        with D.implicit(params, x):
            flat = D.unshard(D.reshape(x, T, d), (1,))
            route = D.ExpertDispatch(flat, ids, E, C, "data", L.moe_slots)
            y = route.combine(route.buf, gates)
            torch.autograd.grad(y.float().sum(), [x])

    # k·T_local rows of a rank, to the ranks of its "data" group
    group, n = mesh.get_group("data"), shape[0]
    rows = k * seq
    send = torch.randn((rows - rows % n, d), device=dev, dtype=bf)
    recv = torch.empty_like(send)

    def needed():
        for _ in range(4):
            dist.all_to_all_single(recv, send, group=group)

    r = {"arch": arch, "mesh": f"{shape[0]}x{shape[1]}", "T_global": T,
         "C": C, "E": E, "d": d, "k": k,
         "ms_layer": _ms(torch, dev, layer, reps),
         "ms_exchange": _ms(torch, dev, exchange, reps),
         "ms_needed": _ms(torch, dev, needed, reps)}
    r["exchange_share"] = r["ms_exchange"] / r["ms_layer"]
    with hlo.DispatchRecord() as rec:
        layer()
    got = hlo.analyze(rec.events)
    r["collective_bytes"] = got["collective_bytes"]
    r["collective_counts"] = got["collective_counts"]
    with hlo.DispatchRecord() as rec:
        exchange()
    r["exchange_bytes"] = hlo.analyze(rec.events)["collective_bytes"]
    # as the recorder counts an all-to-all: its input, own rows included
    r["needed_bytes"] = 4 * send.numel() * send.element_size()
    r["exchange_over_needed"] = (r["exchange_bytes"]["all-to-all"]
                                 / r["needed_bytes"])
    return r


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if args.cpu:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo" if args.cpu else "nccl", rank=rank, world_size=world,
        init_method=f"file://{args.store}" if args.store else "env://",
        device_id=None if args.cpu else dev)
    from repro_torch.device import resolve_device

    resolve_device(dev)
    cells, ok = [], True
    for arch in ARCHS:
        for shape in MESHES:
            if shape[0] * shape[1] != world:
                continue
            try:
                cells.append(cell(torch, dist, dev, arch, shape,
                                  CPU_SEQ if args.cpu else SEQ, args.reps,
                                  args.cpu))
            except Exception as e:        # recorded; the other cells run
                ok = False
                cells.append({"arch": arch, "mesh": f"{shape[0]}x{shape[1]}",
                              "error": f"{type(e).__name__}: {e}"[:2000]})
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
    if rank == 0:
        out = {"world": world, "device": (torch.cuda.get_device_name(dev)
                                          if dev.type == "cuda" else "cpu"),
               "seq": CPU_SEQ if args.cpu else SEQ, "cells": cells,
               "ok": ok}
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))
    dist.destroy_process_group()
    return 0 if ok else 1


def spawn(args) -> int:
    os.makedirs(args.out, exist_ok=True)
    store = os.path.join(os.path.abspath(args.out), "store")
    if os.path.exists(store):
        os.remove(store)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--out", args.out,
           "--store", store, "--reps", str(args.reps)] + (
        ["--cpu"] if args.cpu else [])
    procs = [subprocess.Popen(cmd, env=dict(os.environ, RANK=str(r),
                                            WORLD_SIZE=str(args.spawn),
                                            LOCAL_RANK=str(r)))
             for r in range(args.spawn)]
    try:
        rcs = [p.wait(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return 0 if all(rc == 0 for rc in rcs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks on this machine")
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU (gloo) at reduced widths")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--store", default="",
                    help="a rank's FileStore path (set by --spawn)")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default=str(ROOT / "moe_exchange_out"))
    args = ap.parse_args(argv)
    if args.spawn:
        return spawn(args)
    return rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
