"""Per-cell collective/dot breakdown (the §Perf profiling view) of the
port's dry run.

  python -m repro_torch.obs.diagnose --arch qwen3-14b --shape train_4k \\
      --variant nofsdp [--multi-pod]

Counterpart of the JAX package's ``obs/diagnose.py``: the same two tables,
read from the dry run's recorded dispatch log
(:mod:`repro_torch.obs.hlo`) instead of HLO text.  The fake process group
is started inside :func:`main`; importing this module touches nothing.
"""

import argparse
import json
import sys

from repro_torch.obs import hlo as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dump-log", default="",
                    help="write the recorded dispatch log (JSON lines)")
    args = ap.parse_args(argv)

    res, log = lower_and_text(args.arch, args.shape, args.multi_pod,
                             args.variant)
    del res
    if args.dump_log:
        with open(args.dump_log, "w") as f:
            for e in log:
                f.write(json.dumps(e.__dict__) + "\n")
    out = sys.stdout.write
    out("== collectives (per-device bytes x multiplicity) ==\n")
    for r in H.top_collectives(log, 14):
        out(f"{r['total']/1e9:10.2f} GB {r['op']:18s} "
            f"mult={r['mult']:8.0f} visit={r['per_visit']/1e6:9.2f}MB "
            f"n={r['count']:3d} {r['comp'][:58]}\n")
    out("== dots ==\n")
    for r in H.top_dots(log, 8):
        out(f"{r['total']/1e12:10.2f} TF mult={r['mult']:8.0f} "
            f"visit={r['per_visit']/1e9:9.2f}GF {r['comp'][:58]}\n")


def lower_and_text(arch, shape, multi_pod, variant):
    """``lower_cell`` on a fresh fake group, returning the dispatch log too
    (the reference's name; its second value is HLO text there).

    ``lower_cell`` keeps only the log's totals, so the ``analyze`` entry
    point it calls (resolved as a module attribute at call time) is tapped
    to capture the log on its way through."""
    import torch.distributed as dist

    import repro_torch.launch.dryrun as dr

    captured = {}
    orig = dr.hlo.analyze

    def tap(log):
        captured["log"] = log
        return orig(log)

    dr.fake_group(512 if multi_pod else 256)
    dr.hlo.analyze = tap
    try:
        res = dr.lower_cell(arch, shape, multi_pod, variant)
    finally:
        dr.hlo.analyze = orig
        dist.destroy_process_group()
    if "log" not in captured:
        raise SystemExit(f"cell did not reach analysis: {res}")
    return res, captured["log"]


if __name__ == "__main__":
    main()
