#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference computed on the
configuration's ``control`` grid (the nearest grid below the one it
states) put in the program's place, and judged by the same numbers as the
program's answers. Its readings are the upper ends the limits are set
below; the benchmark's own runs never run it.

    python3 portbench/control.py --workload w6a4-offline --seeds 1,2,3 --seconds 10

Prints one JSON line per seed with every number compared and whether it
would pass. Inputs and weights are the cell's own for that seed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def control_numbers(ctx, refmod, params):
    """The cell's numbers with the control's answers in the program's
    place, by the cell's driver."""
    cfg = ctx.cfg

    def feats(x, grid):
        return refmod.features(params, x.to(ctx.dev.device), cfg["width"],
                               grid, cfg["flip_ensemble"])

    return ctx.driver.control_numbers(ctx, feats)


def main(argv, stub: bool = False, root=None) -> int:
    from pathlib import Path

    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path(root or ROOT)
    if stub:
        dev = harness.CpuStub()
    elif not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    else:
        dev = harness.Card(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, refmod = harness.context(root, args.workload, seed,
                                      args.seconds, dev)
        cfg, params = ctx.cfg, ctx.params
        nums = control_numbers(ctx, refmod, params)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cfg["control"],
                          "numbers": {n.name: n.value for n in nums},
                          "fails": [n.name for n in nums if not n.ok]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
