#!/usr/bin/env python3
"""The port's distribution substrate on ranks, each check against its serial
run.

Four cards, one rank each, over NCCL (a 2x2 ``("data", "model")`` mesh)::

    torchrun --nproc-per-node 4 tools/dist_smoke.py [--time] [--out DIR]

Ranks spawned on ONE card, as ``chip_smoke.py``'s ``dist`` phase runs
them: one rank over NCCL, and two over ``gloo`` (NCCL takes no two ranks
on one card; gloo stages each collective's CUDA buffers through the
host)::

    python3 tools/dist_smoke.py --spawn 1 --backend nccl --out DIR
    python3 tools/dist_smoke.py --spawn 2 --backend gloo --out DIR

Ranks on the CPU, at the small sizes of :data:`CPU` (what
``tests/test_torch_dist_ranks.py`` runs, over 4 ranks)::

    python3 tools/dist_smoke.py --spawn 4 --backend gloo --cpu --out DIR

Spawned ranks meet through a ``FileStore`` under ``DIR``; under
``torchrun`` through its environment.  Each rank runs the same checks:

* ``head`` — the int artifact's features (the ``mvau_int`` and
  ``mvau_int_gap`` kernels on the card) behind a ``ShardedStore`` over all
  ranks: similarities bit for bit the serial head's at C in {1, 3, 4, 8,
  11} and at 16 tenants' worth of rows, ``classify`` == the serial store's;
* ``pipeline`` — GPipe over all ranks: forward rtol 2e-5 and gradient rtol
  1e-4 against the sequential apply (rank 0 writes both to
  ``pipeline.npz``), and the ``ValueError`` of a stage count that does not
  match the axis;
* ``train`` — reduced ``qwen2.5-3b`` and reduced ``grok-1-314b`` (MoE,
  capacity factor 1.25; both grad_accum 2, :data:`TRAIN_ARCHS`) on each
  mesh of the world's size (1x1; 2x1 and 1x2; 2x2 without and with
  ``acc_shardings`` and 1x4): loss rtol 2e-4 and loss after the update
  rtol 5e-3 against the one-rank step, the moments DTensors; bit for bit
  on 1x1.  For the MoE step with ``acc_shardings`` also the first moments
  leaf by leaf (both steps with float32 projections; :data:`M_TOL`).  The MoE step's expert-parallel dispatches (an all-to-all over
  ``"data"``): each buffer and kept mask, made whole, bit for bit the
  serial dispatch of the same tokens, a routing that overflows the
  capacity through dispatch and combine against the serial ones, and the
  ``ValueError`` of a capacity the slot axes do not divide; with
  ``--time`` also one step's collective bytes per rank, by kind;
* ``decode`` — ``qwen3-14b`` at each of the sizes' weight bits, from the
  same codes as the serial decode, on a mesh with a model axis (1xN; at
  4 ranks two steps on 2x2 and two re-placed on 1x4): column-sharded
  projections run ``qmatmul`` (on the card the kernel, on the CPU its
  plain version) on each rank's columns; logits within the sizes' limit
  of the serial decode's (0 on 1x1), greedy tokens equal where the serial
  top-2 margin exceeds the sizes' margin (everywhere on 1x1), every cache
  leaf finite and ``len`` advanced once a step;
* ``restore`` — ``restore_resharded`` onto the first train mesh, bit for
  bit.

Launch counts are read over the sharded runs only (the serial runs they
are held against are left out).  ``--time`` times each sharded run beside
its serial one (synchronised host clock).  A check that needs a
collective the backend lacks for CUDA tensors is not run and is named in
the summary with the reason: over gloo in torch 2.11, point-to-point
(GPipe) and DTensor's functional collectives (train, decode, restore)
end the rank, so on one card those run on the NCCL rank and across ranks
only in the 4-card NCCL call.  Rank 0 writes ``summary.json`` (and every rank
``rank<r>.json``) under ``--out``; the exit code is non-zero if any rank
or check failed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

HEAD_C = (1, 3, 4, 8, 11)
TENANTS, CLASSES, SHOTS = 16, 5, 5
DECODE_ARCH, DECODE_BATCH, DECODE_STEPS = "qwen3-14b", 4, 4
TIMED = 5


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What the checks run at."""

    width: int               # the backbone behind the head
    pipe_dim: int            # GPipe's stage width
    pipe_rows: int           # rows of each of 8 microbatches
    decode_layers: int       # 0: ``reduce_config``'s cut of every width
    decode_dtype: str
    decode_bits: tuple
    logit_tol: float         # decode logits against the serial decode's
    margin: float            # tokens compared where the top-2 gap exceeds


# the card: the width-64 artifact, qwen3-14b at full width cut to 2 layers
# in bf16 (a rank's columns run another K split of the kernel, so sums
# differ in order: chip_smoke.py's card-vs-CPU limits)
CARD = Sizes(width=64, pipe_dim=256, pipe_rows=16, decode_layers=2,
             decode_dtype="bfloat16", decode_bits=(8, 4), logit_tol=0.0625,
             margin=0.125)
# the CPU: every width reduced, float32, the reference's decode limits
CPU = Sizes(width=8, pipe_dim=16, pipe_rows=2, decode_layers=0,
            decode_dtype="float32", decode_bits=(0, 8, 4), logit_tol=1e-4,
            margin=1e-3)

# the collectives each check needs on the backend (for its tensors):
# eager all_gather for the head, point-to-point for GPipe's ring, and the
# functional collectives DTensor redistributes with
NEEDS = {"head": ("all_gather",),
         "pipeline": ("p2p", "all_reduce"),
         "train": ("funcol",),
         "decode": ("funcol",),
         "restore": ("funcol",)}
# gloo with CUDA tensors, torch 2.11 (probed on the H100 in separate
# processes): these end the process, so they are not probed in a rank
GLOO_CUDA_CRASHES = {
    "p2p": "batch_isend_irecv of CUDA tensors aborts the rank "
           "(gloo::IoException: writev ... Bad address)",
    "funcol": "DTensor's functional collectives on CUDA tensors crash the "
              "rank (SIGSEGV)"}


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------
def probe_collectives(torch, dist, dev) -> dict:
    """Which collectives the group runs on ``dev``'s tensors (a failure is
    recorded, not raised; the same on every rank)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    t = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank

    def p2p():
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
               dist.P2POp(dist.irecv, out, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def funcol():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)

        mesh = init_device_mesh(dev.type, (world,))
        x = DTensor.from_local(t.clone(), mesh, [Partial()])
        y = x.redistribute(mesh, [Shard(0)]).redistribute(mesh, [Replicate()])
        assert y.shape == t.shape

    tries = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(t.numel() * world, device=dev), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), t.clone()),
        "p2p": p2p if world > 1 else (lambda: None),
        "funcol": funcol,
        "barrier": dist.barrier,
    }
    ok = {}
    if dist.get_backend() == "gloo" and dev.type == "cuda":
        ok.update(GLOO_CUDA_CRASHES)
    for name, fn in tries.items():
        if name in ok:
            continue
        try:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ok[name] = True
        except Exception as e:          # the backend lacks it for CUDA
            ok[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return ok


class Counted:
    """Launch counts of the sharded runs only: ``with counted.on():``
    around each; serial runs outside add nothing."""

    def __init__(self, B):
        self.B = B
        self.total = {k: 0 for k in B.launch_counts}

    @contextlib.contextmanager
    def on(self):
        before = dict(self.B.launch_counts)
        yield
        for k, v in self.B.launch_counts.items():
            self.total[k] += v - before[k]


def _ms(torch, fn, reps=TIMED):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def check_head(torch, dist, dev, sizes, counted, timed, out_dir):
    import numpy as np

    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.fsl import ncm
    from repro_torch.fsl.pipeline import FSLPipeline
    from repro_torch.models import resnet9
    from repro_torch.serve.cluster import ShardedNCMHead, ShardedStore
    from repro_torch.serve.store import PrototypeStore, head_sims

    qcfg = QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0),
                                 sizes.width, device=dev)
    feats = FSLPipeline(width=sizes.width, qcfg=qcfg,
                        device=dev).deploy(params, "int")
    data = SyntheticImages(n_base=32, n_novel=TENANTS * CLASSES, seed=0,
                           img=32)
    rng = np.random.default_rng(0)
    n_sup = TENANTS * CLASSES * SHOTS
    classes = np.repeat(np.arange(TENANTS * CLASSES), SHOTS)
    x_sup, _ = data.batch(classes, rng.integers(0, 10_000, n_sup))
    x_q, _ = data.batch(rng.integers(0, TENANTS * CLASSES, 64),
                        rng.integers(0, 10_000, 64))
    head = ShardedNCMHead(list(range(dist.get_world_size())))
    sharded, serial = ShardedStore(head, dev), PrototypeStore(dev)
    with counted.on():
        sup = torch.cat([feats(torch.from_numpy(x_sup[i:i + 64]).to(dev))
                         for i in range(0, n_sup, 64)])
        q = feats(torch.from_numpy(x_q).to(dev))
        for c in range(TENANTS * CLASSES):
            sharded.register(c, sup[c * SHOTS:(c + 1) * SHOTS])
        ids_s, sims_s = sharded.classify(q)
    for c in range(TENANTS * CLASSES):
        serial.register(c, sup[c * SHOTS:(c + 1) * SHOTS])
    ids_p, sims_p = serial.classify(q)
    out = {"classify_equal": bool(ids_s == ids_p
                                  and np.array_equal(sims_s, sims_p)),
           "n_dev": head.n_dev, "C": {}}
    for c in (*HEAD_C, TENANTS * CLASSES):
        m = ncm._l2(sup[:c * SHOTS:SHOTS].float())
        out["C"][c] = bool(torch.equal(head.sims(q, m), head_sims(q, m)))
    out["ok"] = out["classify_equal"] and all(out["C"].values())
    if timed:
        m = ncm._l2(torch.randn(4096, sup.shape[1], device=dev,
                                generator=torch.Generator(dev).manual_seed(1)))
        out["ms_sharded_4096"] = _ms(torch, lambda: head.sims(q, m))
        out["ms_serial_4096"] = _ms(torch, lambda: head_sims(q, m))
    return out


def check_pipeline(torch, dist, dev, sizes, counted, timed, out_dir):
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.dist.pipeline import pipeline_apply

    n, d = dist.get_world_size(), sizes.pipe_dim
    mesh = init_device_mesh(dev.type, (n,), mesh_dim_names=("pipe",))
    g = torch.Generator(dev).manual_seed(0)
    ws = torch.randn(n, d, d, generator=g, device=dev) * d ** -0.5
    x = torch.randn(8, sizes.pipe_rows, d, generator=g, device=dev)

    def stage(w, a):
        return torch.tanh(a @ w)

    wd = distribute_tensor(ws, mesh, [Shard(0)], src_data_rank=None)
    wd.requires_grad_(True)
    with counted.on():
        y = pipeline_apply(stage, wd, x, mesh)
        (y ** 2).sum().backward()
    gp = wd.grad.full_tensor()
    w2 = ws.clone().requires_grad_(True)
    seq = x
    for i in range(n):
        seq = stage(w2[i], seq)
    (seq ** 2).sum().backward()
    fwd = torch.allclose(y, seq, rtol=2e-5, atol=2e-5)
    grad = torch.allclose(gp, w2.grad, rtol=1e-4, atol=1e-4)
    out = {"stages": n, "fwd_err": float((y - seq).abs().max()),
           "grad_err": float((gp - w2.grad).abs().max()), "axis_error": ""}
    if n > 1:
        try:
            pipeline_apply(stage, ws[:n - 1], x, mesh)
        except ValueError as e:
            out["axis_error"] = str(e)
    out["ok"] = bool(fwd and grad) and (n == 1 or bool(out["axis_error"]))
    if dist.get_rank() == 0:
        arrays = {"ws": ws, "x": x, "y": y.detach(), "g": gp,
                  "seq_y": seq.detach(), "seq_g": w2.grad}
        np.savez(os.path.join(out_dir, "pipeline.npz"),
                 **{k: v.cpu().numpy() for k, v in arrays.items()})
    if timed:
        out["ms_pipelined"] = _ms(torch, lambda: pipeline_apply(
            stage, wd.detach(), x, mesh))

        def sequential():
            a = x
            for i in range(n):
                a = stage(ws[i], a)
            return a

        out["ms_sequential"] = _ms(torch, sequential)
    return out


# the sharded train step's configs, each reduced (``reduce_config``) with
# these overrides: a dense decoder and an MoE one (4 experts top-2 at
# capacity factor 1.25, the dry run's mini cell: some experts overflow)
TRAIN_ARCHS = {"qwen2.5-3b": dict(grad_accum=2),
               "grok-1-314b": dict(grad_accum=2, moe_capacity_factor=1.25)}


# the first moments' largest difference from the one-rank step's, over
# each leaf's largest, with float32 projections (their sums in another
# order differ by about 1e-6; with the bf16 projections by up to 1.3e-2).
# Not 0 on 1x1: on the card the DTensor lookup's ``embedding`` backward
# sums a repeated token's rows in another order than ``table[tokens]``'s
M_TOL = 1e-4


@contextlib.contextmanager
def _f32_projections(torch):
    """``layers.dense`` in float32 unless a caller names a dtype (bf16
    otherwise, as the reference's projections), so that two steps differ
    only in the order of float32 sums."""
    from repro_torch.models import layers as L

    saved = L.dense.__defaults__
    L.dense.__defaults__ = (None, torch.float32)
    try:
        yield
    finally:
        L.dense.__defaults__ = saved


def _train_cases(world):
    """(name, mesh shape, with ``acc_shardings``) of each sharded step."""
    return {1: [("1x1_acc", (1, 1), True)],
            2: [("2x1_acc", (2, 1), True), ("1x2_acc", (1, 2), True)],
            4: [("2x2", (2, 2), False), ("2x2_acc", (2, 2), True),
                ("1x4_acc", (1, 4), True)]}.get(
        world, [(f"{world}x1_acc", (world, 1), True)])


def _place(tree, shardings):
    from repro_torch.tree import tree_map

    return tree_map(lambda t, s: s.place(t), tree, shardings)


@contextlib.contextmanager
def _dispatches(torch, calls):
    """Record each expert-parallel ``layers.moe_dispatch`` of the enclosed
    block in ``calls``: its tokens, ids, buffer and kept mask made whole
    (``full_tensor``), for :func:`_dispatch_equal`."""
    from repro_torch.dist import dtensor as D
    from repro_torch.models import layers as L

    inner = L.moe_dispatch

    def recorded(flat, ids, E, C, expert_parallel=True):
        buf, route = inner(flat, ids, E, C, expert_parallel)
        if D.is_dtensor(flat) and isinstance(route, D.ExpertDispatch):
            with torch.no_grad():
                calls.append([t.full_tensor() for t in (flat, ids, buf,
                                                        route.keep)]
                             + [E, C])
        return buf, route

    L.moe_dispatch = recorded
    try:
        yield
    finally:
        L.moe_dispatch = inner


def _dispatch_equal(torch, calls) -> dict:
    """The recorded sharded dispatches against the serial one of the same
    tokens: buffers and kept masks bit for bit."""
    from repro_torch.models import layers as L

    same, dropped = True, 0
    for flat, ids, buf, keep, E, C in calls:
        with torch.no_grad():
            sbuf, (_, _, skeep) = L.moe_dispatch(flat, ids, E, C)
        same = same and torch.equal(buf, sbuf) and torch.equal(keep, skeep)
        dropped += int((~skeep).sum())
    return {"dispatches": len(calls), "dispatch_bitforbit": bool(same),
            "dropped": dropped}


def check_dispatch(torch, dev, mesh, E, T) -> dict:
    """The MoE dispatch and combine over ``mesh`` of T tokens to E experts
    (top-2) on routing that overflows the capacity (half the entries on
    expert 0), against the serial ones: buffer, kept mask and combined
    rows bit for bit.  Where ``"data"`` does not divide E the buffer
    splits its slots over it."""
    from repro_torch.dist.sharding import NamedSharding
    from repro_torch.models import layers as L

    k, d = 2, 16
    C = int(1.25 * T * k / E)
    g = torch.Generator(dev).manual_seed(4)
    flat = torch.randn(T, d, generator=g, device=dev)
    ids = torch.randint(0, E, (T * k,), generator=g, device=dev)
    ids = torch.where(torch.rand(T * k, generator=g, device=dev) < 0.5, 0,
                      ids)
    gates = torch.rand(T, k, generator=g, device=dev)
    out = torch.randn(E, C, d, generator=g, device=dev)
    rows = NamedSharding(mesh, ("data", None))
    ids_d = NamedSharding(mesh, ("data",)).place(ids)
    buf, route = L.moe_dispatch(rows.place(flat), ids_d, E, C)
    y = L.moe_combine(NamedSharding(mesh, ("data", None, None)).place(out),
                      rows.place(gates), route)
    sbuf, sroute = L.moe_dispatch(flat, ids, E, C)
    keep, skeep = route.keep, sroute[2]
    sy = L.moe_combine(out, gates, sroute)
    names = mesh.mesh_dim_names
    return {"E": E, "T": T,
            "split": {names[i]: ("experts", "slots")[dim]
                      for i, dim in route.block.items()},
            "dropped": int((~skeep).sum()),
            "dispatch_bitforbit": bool(torch.equal(buf.full_tensor(), sbuf)
                                       and torch.equal(keep.full_tensor(),
                                                       skeep)),
            "combine_bitforbit": bool(torch.equal(y.full_tensor(), sy))}


# (E, T) of the direct dispatch checks: experts split over "data" at 2
# or 4 ranks, and slots split (3 experts at 2 ranks; C = 40)
DISPATCH_CASES = ((4, 64), (3, 48))


def check_undivided(torch, dev, mesh):
    """The ``ValueError`` of a capacity that the slot axes do not divide
    (3 experts over a 2-wide ``"data"`` split their slots; C = 41), or
    None where nothing splits the slots."""
    from repro_torch.dist.sharding import NamedSharding
    from repro_torch.models import layers as L

    T, E, d = 50, 3, 16
    C = int(1.25 * T * 2 / E)
    flat = NamedSharding(mesh, ("data", None)).place(
        torch.zeros(T, d, device=dev))
    ids = NamedSharding(mesh, ("data",)).place(
        torch.arange(T * 2, device=dev) % E)
    try:
        L.moe_dispatch(flat, ids, E, C)
    except ValueError as e:
        return str(e)
    return None


def train_arch(torch, dist, dev, arch, counted, timed):
    """``arch``'s sharded train step on each mesh of the world's size
    against the one-rank step."""
    from repro_torch.dist import dtensor as D
    from repro_torch.dist.sharding import (tree_batch_shardings,
                                           tree_opt_shardings,
                                           tree_param_shardings)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.models.testing import reduce_config
    from repro_torch.obs import hlo
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten, tree_map, tree_paths

    cfg = reduce_config(get_config(arch), **TRAIN_ARCHS[arch])
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    toks = torch.randint(0, cfg.vocab, (2, 4, 16), dtype=torch.int32,
                         device=dev, generator=torch.Generator(dev)
                         .manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    step = make_train_step(cfg)
    p1, _, loss1 = step(params, adamw_init(params), batch)
    if cfg.moe_experts:
        with _f32_projections(torch):
            _, o1, _ = step(params, adamw_init(params), batch)
        names, m1 = tree_paths(o1.m), tree_flatten(o1.m)[0]
    mb = tree_map(lambda t: t[0], batch)
    after1 = float(lm.loss_fn(p1, mb, cfg))
    out = {"ok": True, "meshes": {}}
    for name, shape, acc in _train_cases(dist.get_world_size()):
        mesh = make_debug_mesh(*shape, device_type=dev.type)
        dp = _place(params, tree_param_shardings(params, mesh))
        db = _place(batch, tree_batch_shardings(batch, mesh))
        sharded = make_train_step(
            cfg, acc_shardings=tree_opt_shardings(params, mesh)
            if acc else None)
        calls = []
        with counted.on(), _dispatches(torch, calls):
            p2, o2, loss2 = sharded(dp, adamw_init(dp), db)
        after2 = float(lm.loss_fn(tree_map(
            lambda t: t.full_tensor() if D.is_dtensor(t) else t, p2),
            mb, cfg))
        r = {"loss1": float(loss1), "loss2": float(loss2),
             "after1": after1, "after2": after2,
             "bitforbit": float(loss1) == float(loss2) and after1 == after2,
             "moments_sharded": all(D.is_dtensor(m)
                                    for m in tree_flatten(o2.m)[0])}
        # nothing is split on 1x1: the sharded step is the plain one's bits
        r["ok"] = r["moments_sharded"] and (
            r["bitforbit"] if shape == (1, 1) else
            abs(r["loss2"] - r["loss1"]) <= 2e-4 * abs(r["loss1"])
            and abs(after2 - after1) <= 5e-3 * abs(after1))
        if cfg.moe_experts and acc:
            # the first moments ((1 - b1) times the gradient) leaf by
            # leaf, each leaf's largest difference over its largest value,
            # both steps with float32 projections: AdamW's first update is
            # about sign(g), so the losses would not see a gradient scaled
            # by a positive factor
            with _f32_projections(torch):
                _, o2f, _ = sharded(dp, adamw_init(dp), db)
            r["m_err"] = {n: float((a.full_tensor() - b).abs().max()
                                   / b.abs().max().clamp_min(1e-30))
                          for n, a, b in zip(names, tree_flatten(o2f.m)[0],
                                             m1)}
            r["ok"] = r["ok"] and max(r["m_err"].values()) <= M_TOL
        if cfg.moe_experts:
            r.update(_dispatch_equal(torch, calls))
            r["overflow"] = [check_dispatch(torch, dev, mesh, E, T)
                             for E, T in DISPATCH_CASES]
            r["undivided"] = check_undivided(torch, dev, mesh)
            r["ok"] = (r["ok"] and r["dispatches"] == 2 * cfg.n_layers
                       and (r["undivided"] is None) == (shape[0] == 1)
                       and r["dispatch_bitforbit"] and all(
                           o["dropped"] > 0 and o["dispatch_bitforbit"]
                           and o["combine_bitforbit"]
                           for o in r["overflow"]))
        if timed:
            r["ms_sharded"] = _ms(torch, lambda: sharded(
                dp, adamw_init(dp), db), reps=3)
            r["ms_serial"] = _ms(torch, lambda: step(
                params, adamw_init(params), batch), reps=3)
            # what one step sends, per rank, by kind (all-to-all: the MoE
            # buffer's exchanges and DTensor's shard-to-shard moves)
            with hlo.DispatchRecord() as rec:
                sharded(dp, adamw_init(dp), db)
            r["collective_bytes"] = hlo.analyze(rec.events)[
                "collective_bytes"]
        out["meshes"][name] = r
        out["ok"] = out["ok"] and r["ok"]
    return out


def check_train(torch, dist, dev, sizes, counted, timed, out_dir):
    out = {"archs": {a: train_arch(torch, dist, dev, a, counted, timed)
                     for a in TRAIN_ARCHS}}
    out["ok"] = all(r["ok"] for r in out["archs"].values())
    return out


def _decode_meshes(world):
    """The decode's meshes, each for an equal share of the steps."""
    return {4: [(2, 2), (1, 4)]}.get(world, [(1, world)])


def decode_bits(torch, dist, dev, sizes, counted, timed, bits):
    """The sharded decode at weight ``bits`` against the serial decode of
    the same codes."""
    from repro_torch.dist import dtensor as D
    from repro_torch.dist.sharding import (tree_batch_shardings,
                                           tree_cache_shardings,
                                           tree_param_shardings)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import init_serving_params
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.models.testing import reduce_config
    from repro_torch.tree import tree_flatten, tree_map

    cfg = get_config(DECODE_ARCH)
    if sizes.decode_layers:
        cfg = dataclasses.replace(cfg, n_layers=sizes.decode_layers,
                                  compute_dtype=sizes.decode_dtype)
    else:
        cfg = reduce_config(cfg, compute_dtype=sizes.decode_dtype)
    params = lm.with_head_copy(init_serving_params(
        torch.Generator(dev).manual_seed(0), cfg, bits, dev), cfg)
    dt = lm.compute_dtype(cfg)
    cache = lm.init_cache(cfg, DECODE_BATCH, 32, dtype=dt, device=dev)
    dc = lm.init_cache(cfg, DECODE_BATCH, 32, dtype=dt, device=dev)
    toks = torch.randint(0, cfg.vocab, (DECODE_BATCH, 1), dtype=torch.int32,
                         device=dev, generator=torch.Generator(dev)
                         .manual_seed(2))
    meshes = _decode_meshes(dist.get_world_size())
    exact = meshes == [(1, 1)]          # nothing split: the serial bits
    tol, margin = (0.0, -1.0) if exact else (sizes.logit_tol, sizes.margin)
    full = (lambda t: t.full_tensor() if D.is_dtensor(t) else t)
    steps, v = [], cfg.vocab
    mesh = dp = None

    def sharded_step(tokens, cache_):
        db = _place({"tokens": tokens},
                    tree_batch_shardings({"tokens": tokens}, mesh))
        with D.implicit(dp):
            return lm.decode_step(dp, db["tokens"], cache_, cfg)

    for t in range(DECODE_STEPS):
        shape = meshes[t * len(meshes) // DECODE_STEPS]
        if mesh is None or tuple(mesh.shape) != shape:
            # (re-)placed: the params and the cache so far
            mesh = make_debug_mesh(*shape, device_type=dev.type)
            dp = _place(params, tree_param_shardings(params, mesh))
            dc = _place(tree_map(full, dc), tree_cache_shardings(cache, mesh))
        with counted.on():
            lg2, dc = sharded_step(toks, dc)
            lg2 = full(lg2)
        lg1, cache = lm.decode_step(params, toks, cache, cfg)
        top2 = torch.topk(lg1[:, :v].float(), 2, dim=-1).values
        t1, t2 = lg1[:, :v].argmax(-1), lg2[:, :v].argmax(-1)
        steps.append({"mesh": "x".join(map(str, shape)),
                      "logit_err": float((lg1.float() - lg2.float())
                                         .abs().max()),
                      "margin": (top2[:, 0] - top2[:, 1]).tolist(),
                      "tok1": t1.tolist(), "tok2": t2.tolist()})
        toks = t1[:, None].to(torch.int32)
    leaves = [full(t) for t in tree_flatten(dc)[0]]
    out = {"layers": cfg.n_layers, "dtype": sizes.decode_dtype,
           "steps": steps,
           "logit_err": max(s["logit_err"] for s in steps),
           "tokens_agree": all(a == b for s in steps for m, a, b in zip(
               s["margin"], s["tok1"], s["tok2"]) if m > margin),
           "finite": all(bool(torch.isfinite(t.float()).all())
                         for t in leaves),
           "len": full(dc["attn"]["len"]).tolist(),
           "cache_sharded": D.is_dtensor(dc["attn"]["k"])}
    out["ok"] = (out["logit_err"] <= tol and out["tokens_agree"]
                 and out["finite"] and out["cache_sharded"]
                 and set(out["len"]) == {DECODE_STEPS})
    if timed:
        out["ms_sharded"] = _ms(torch, lambda: sharded_step(toks, dc))
        out["ms_serial"] = _ms(torch, lambda: lm.decode_step(
            params, toks, cache, cfg))
    return out


def check_decode(torch, dist, dev, sizes, counted, timed, out_dir):
    out = {"bits": {b: decode_bits(torch, dist, dev, sizes, counted, timed,
                                   b) for b in sizes.decode_bits}}
    out["ok"] = all(r["ok"] for r in out["bits"].values())
    return out


def check_restore(torch, dist, dev, sizes, counted, timed, out_dir):
    from repro_torch.ckpt import CheckpointManager, restore_resharded
    from repro_torch.dist.sharding import tree_param_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.models.testing import reduce_config
    from repro_torch.tree import tree_flatten, tree_paths

    cfg = reduce_config(get_config("qwen2.5-3b"))
    params = lm.init_params(torch.Generator(dev).manual_seed(3), cfg, dev)
    ck = os.path.join(out_dir, "ckpt")
    if dist.get_rank() == 0:
        CheckpointManager(ck).save(1, params)
    dist.barrier()
    shape = _train_cases(dist.get_world_size())[0][1]
    mesh = make_debug_mesh(*shape, device_type=dev.type)
    by_path = dict(zip(tree_paths(params), tree_flatten(
        tree_param_shardings(params, mesh))[0]))
    got = restore_resharded(CheckpointManager(ck), params,
                            lambda path, shape: by_path[path])
    leaves = tree_flatten(got)[0]
    ok = all(bool(torch.equal(g.full_tensor(), p))
             for g, p in zip(leaves, tree_flatten(params)[0]))
    return {"ok": ok, "leaves": len(leaves), "mesh": "x".join(map(str, shape)),
            "sharded": sum(any(not p.is_replicate() for p in g.placements)
                           for g in leaves),
            "on_device": all(g.to_local().device == dev for g in leaves)}


CHECKS = {"head": check_head, "pipeline": check_pipeline,
          "train": check_train, "decode": check_decode,
          "restore": check_restore}


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
        args.backend, rank=rank, world_size=world,
        init_method=f"file://{args.store}" if args.store else "env://",
        device_id=dev if args.backend == "nccl" else None)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as B

    resolve_device(dev)                    # no TF32 on this rank
    if dev.type == "cuda":
        if rank == 0:
            B.build()                      # one build; the others load it
        dist.barrier()
        B.library()
    B.reset_launch_counts()
    counted = Counted(B)
    sizes = CPU if args.cpu else CARD
    res = {"rank": rank, "world": world, "backend": args.backend,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "sizes": dataclasses.asdict(sizes),
           "collectives": probe_collectives(torch, dist, dev),
           "checks": {}, "deferred": {}}
    for name, fn in CHECKS.items():
        missing = [c for c in NEEDS[name] if res["collectives"][c] is not True]
        if missing:
            res["deferred"][name] = {c: res["collectives"][c]
                                     for c in missing}
            continue
        t0 = time.perf_counter()
        try:
            res["checks"][name] = fn(torch, dist, dev, sizes, counted,
                                     args.time, args.out)
        except Exception:
            res["checks"][name] = {"ok": False,
                                   "error": traceback.format_exc()[-3000:]}
        res["checks"][name]["s"] = time.perf_counter() - t0
        dist.barrier()
    res["launches"] = counted.total
    res["ok"] = all(c.get("ok") for c in res["checks"].values())
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, indent=1)
    dist.barrier()
    if rank == 0:
        summarize(args.out, world)
    dist.destroy_process_group()
    return 0 if res["ok"] else 1


# ---------------------------------------------------------------------------
# Launcher side
# ---------------------------------------------------------------------------
def summarize(out_dir, world) -> dict:
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    summary = {"world": world, "backend": ranks[0]["backend"],
               "device": ranks[0]["device"], "sizes": ranks[0]["sizes"],
               "ok": all(r["ok"] for r in ranks),
               "launches": launches,
               "deferred": ranks[0]["deferred"],
               "collectives": ranks[0]["collectives"],
               "checks": ranks[0]["checks"],
               "failed": {r["rank"]: [n for n, c in r["checks"].items()
                                      if not c.get("ok")] for r in ranks
                          if not r["ok"]}}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def spawn(args) -> int:
    """Start ``args.spawn`` ranks of this script on this machine (on its
    first card, or on the CPU with ``--cpu``), meeting through a
    ``FileStore`` under ``args.out``, and wait for them all."""
    os.makedirs(args.out, exist_ok=True)
    store = os.path.join(os.path.abspath(args.out), "store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, WORLD_SIZE=str(args.spawn))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--backend",
           args.backend, "--out", args.out, "--store", store] + (
        ["--time"] if args.time else []) + (["--cpu"] if args.cpu else [])
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK="0"))
             for r in range(args.spawn)]
    try:
        rcs = [p.wait(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(json.dumps({"rank_exit_codes": rcs}))
    return 0 if all(rc == 0 for rc in rcs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks on this machine")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU (gloo) at the CPU sizes")
    ap.add_argument("--store", default="",
                    help="a rank's FileStore path (set by --spawn)")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default=str(ROOT / "dist_smoke_out"))
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.stderr.write("dist_smoke: no CUDA device\n")
        return 2
    if args.spawn:
        return spawn(args)
    os.makedirs(args.out, exist_ok=True)
    return rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
