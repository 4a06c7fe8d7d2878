#!/usr/bin/env python3
"""The NCM head's similarity product on the card: its time, and whether its
bits depend on the class count or the split.

Run from the repository root on a machine with the card::

    python3 tools/time_head.py [--out DIR]

Forms of ``ncm._l2(q) @ means.T`` at 64 query rows and the width-64
backbone's 512 features:

* ``one_gemm`` — one GEMM a 64-row query block against all C prototypes
  (the head before it was made to run the same shapes as a sharded one);
* ``tiles`` — one GEMM a (64, 64) tile, the tiles concatenated;
* ``head_sims`` — :func:`repro_torch.serve.store.head_sims` as it stands,
  and with ``HEAD_TILES`` (the tiles of each batched product) set to each
  of :data:`GROUPS`.

Each is timed at C 5, 80 and 4,096 with CUDA events (launches queued
behind a device-side sleep: device time) and with the host clock around
synchronised calls (what a serving thread waits).  Each ``head_sims`` is
then held bit for bit against itself: at C in {1, 3, 4, 8, 11, 80, 200,
1030, 4096}, the serial result against the blocks of 2, 4 and 8 ranks
(``ShardedNCMHead``'s padding and split, run here in one process), and a
query's row against the same query with other batch neighbours.  Last,
``chip_smoke.py``'s ``cluster`` phase runs with ``one_gemm`` and with
``head_sims`` as it stands as the head, in the order one_gemm, head_sims,
head_sims, one_gemm, and its requests/s are read from each run.  The card's name and
power limit, and every number, go to standard output and ``DIR/head.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DIM, ROWS = 512, 64
TIMED_C = (5, 80, 4096)
CHECKED_C = (1, 3, 4, 8, 11, 80, 200, 1030, 4096)
SPLITS = (2, 4, 8)
GROUPS = (8, 16, 64)


def one_gemm(q, means):
    import torch

    from repro_torch.fsl import ncm
    from repro_torch.serve.store import HEAD_ROWS, _pad_rows

    return torch.cat([ncm._l2(b) @ means.T for b in
                      _pad_rows(q, HEAD_ROWS).split(HEAD_ROWS)])[:q.shape[0]]


def tiles(q, means):
    import torch

    from repro_torch.fsl import ncm
    from repro_torch.serve.store import HEAD_COLS, HEAD_ROWS, _pad_rows

    protos = _pad_rows(means, HEAD_COLS).split(HEAD_COLS)
    return torch.cat([torch.cat([b @ m.T for m in protos], dim=1)
                      for b in map(ncm._l2, _pad_rows(q, HEAD_ROWS)
                                   .split(HEAD_ROWS))])[:q.shape[0],
                                                        :means.shape[0]]


def grouped(n_tiles):
    """``head_sims`` with ``HEAD_TILES`` set to ``n_tiles`` while it runs."""
    from repro_torch.serve import store

    def head(q, means):
        keep, store.HEAD_TILES = store.HEAD_TILES, n_tiles
        try:
            return store.head_sims(q, means)
        finally:
            store.HEAD_TILES = keep

    return head


def rank_blocks(head, q, means, n_dev):
    """``ShardedNCMHead.sims``'s padding and split, every rank's block
    computed here."""
    import torch

    from repro_torch.serve.store import HEAD_COLS

    c = means.shape[0]
    pad = (-c) % (HEAD_COLS * n_dev)
    m = torch.cat([means, means.new_zeros((pad, means.shape[1]))])
    rows = m.shape[0] // n_dev
    return torch.cat([head(q, m[r * rows:(r + 1) * rows])
                      for r in range(n_dev)], dim=1)[:, :c]


def cluster_rps(torch, np, B, form):
    """``chip_smoke.cluster_phase`` with ``form`` as every store's head:
    (requests/s, the phase's metrics line)."""
    import chip_smoke
    from repro_torch.serve import store
    from repro_torch.serve.cluster import sharded

    keep = store.head_sims, sharded.head_sims
    store.head_sims = sharded.head_sims = form
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            chip_smoke.cluster_phase(torch, np, B)
    finally:
        store.head_sims, sharded.head_sims = keep
    line = next(l for l in buf.getvalue().splitlines()
                if l.startswith("cluster metrics"))
    return float(re.search(r"([\d.]+) requests/s", line).group(1)), line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "time_head_out"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("time_head: no CUDA device\n")
        return 2
    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.fsl import ncm
    from repro_torch.kernels import build as B
    from repro_torch.serve.store import HEAD_TILES, head_sims

    resolve_device(None)                   # TF32 off, as the port serves
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(ROWS, DIM, device=dev, generator=g)
    forms = {"one_gemm": one_gemm, "tiles": tiles, "head_sims": head_sims,
             **{f"head_sims@{t}": grouped(t) for t in GROUPS}}
    heads = {k: v for k, v in forms.items() if k.startswith("head_sims@")}
    res = {"card": smi, "torch": torch.__version__, "dim": DIM,
           "rows": ROWS, "head_tiles": HEAD_TILES, "ms": {},
           "bitforbit": {}, "cluster": []}
    for c in TIMED_C:
        m = ncm._l2(torch.randn(c, DIM, device=dev, generator=g))
        want = (ncm._l2(q.double()) @ m.double().T)
        for name, fn in forms.items():
            err = float((fn(q, m).double() - want).abs().max())
            dev_ms = chip_smoke.cuda_ms(torch, lambda: fn(q, m), reps=50)
            host_ms = chip_smoke.wall_ms(torch, lambda: fn(q, m), reps=50)
            res["ms"][f"{name}_C{c}"] = {"device_ms": dev_ms,
                                         "host_ms": host_ms,
                                         "max_abs_err_vs_f64": err}
            print(f"C {c} {name}: device {dev_ms:.4f} ms, host "
                  f"{host_ms:.4f} ms, max |err| vs float64 {err:.3g}",
                  flush=True)
    for c in CHECKED_C:
        m = ncm._l2(torch.randn(c, DIM, device=dev, generator=g))
        for name, head in heads.items():
            serial = head(q, m)
            ok = {f"ranks{n}": bool(torch.equal(rank_blocks(head, q, m, n),
                                                serial)) for n in SPLITS}
            ok["rows"] = bool(torch.equal(head(q[:3], m), serial[:3])
                              and torch.equal(head(q[5:6], m), serial[5:6]))
            res["bitforbit"][f"{name}_C{c}"] = ok
            print(f"C {c} {name} bit for bit: {ok}", flush=True)
    B.build()
    B.library()
    for name in ("one_gemm", "head_sims", "head_sims", "one_gemm"):
        rps, line = cluster_rps(torch, np, B, forms[name])
        res["cluster"].append({"head": name, "requests_per_s": rps,
                               "line": line})
        print(f"cluster with {name}: {line}", flush=True)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "head.json").write_text(json.dumps(res, indent=1))
    ok = all(all(v.values()) for k, v in res["bitforbit"].items()
             if k.startswith(f"head_sims@{HEAD_TILES}_"))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
