"""Training launcher on one card: data → train step → checkpoint/restart →
straggler policy.  The port of the JAX package's ``launch/train.py`` with
the same flags plus ``--device``::

    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 30 --ckpt-dir /tmp/ckpt
    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 3 --batch 2 --seq 16 --device cpu

The parameters are drawn from a CPU ``torch.Generator`` seeded with 0 and
moved to the device, so a run on the card and one on the CPU start from the
same weights; the AdamW moments take the dtype of
:func:`~repro_torch.launch.steps.train_dtype_policy`.  Checkpoints use the
reference's layout (``{"params", "m", "v"}`` with meta ``step``, ``mesh``
and ``arch``), so a checkpoint written by the JAX launcher resumes here and
one written here resumes there.  One card, no mesh: the meta's ``mesh`` is
``[1, 1]``.  Each step's duration is taken after the device finishes it,
and feeds the straggler monitor; its ``evict`` verdict saves a checkpoint.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.data.synthetic import token_lm_batch
from repro_torch.device import resolve_device
from repro_torch.dist.straggler import StragglerMonitor
from repro_torch.launch.steps import (
    make_train_step,
    model_module,
    train_dtype_policy,
)
from repro_torch.models.common import get_config
from repro_torch.optim import AdamWState, adamw_init


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        from repro_torch.models.testing import reduce_config
        cfg = reduce_config(cfg, grad_accum=2)
    dev = resolve_device(args.device)
    mod = model_module(cfg)

    _, moment_dtype, _ = train_dtype_policy(cfg)
    params = mod.init_params(torch.Generator().manual_seed(0), cfg,
                             device=dev)
    opt = adamw_init(params, moment_dtype)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume and mgr.latest_step() is not None:
        state = mgr.restore({"params": params, "m": opt.m, "v": opt.v})
        params = state["params"]
        start_step = mgr.meta()["step"]
        opt = AdamWState(step=torch.full((), start_step, dtype=torch.int32,
                                         device=dev),
                         m=state["m"], v=state["v"])
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, lr=3e-4)
    monitor = StragglerMonitor()

    def make_batch(i):
        b = token_lm_batch(i, args.batch, args.seq, cfg.vocab)
        n_micro = cfg.grad_accum
        return {k: torch.from_numpy(v).reshape(
                    n_micro, args.batch // n_micro, -1).to(dev)
                for k, v in b.items()}

    def state_tree():
        return {"params": params, "m": opt.m, "v": opt.v}

    for i in range(start_step, start_step + args.steps):
        t0 = time.time()
        params, opt, loss = step_fn(params, opt, make_batch(i))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        verdict = monitor.observe(i, dt)
        if verdict == "evict":
            # policy: checkpoint, shrink, resume (elastic path). In a single
            # process we checkpoint + log; a cluster agent restarts.
            if mgr:
                mgr.save(i, state_tree(),
                         meta={"step": i, "reason": "straggler-evict"})
            print(f"step {i}: straggler evict policy fired")
        if i % 5 == 0 or i == start_step + args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f} ({dt*1e3:.0f} ms)")
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state_tree(),
                     meta={"step": i + 1, "mesh": [1, 1], "arch": cfg.name})
    return float(loss)


if __name__ == "__main__":
    main()
