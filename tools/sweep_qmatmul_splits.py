#!/usr/bin/env python3
"""Time the qmatmul kernel at Qwen2.5-3B's decode shapes for every K split
and column-tile width.

Run from the repository root on a machine with one CUDA card::

    python3 tools/sweep_qmatmul_splits.py [--ablate] [--phases] [--variants w4s4b8,...]

For each projection shape (K, N) at batch 4 in bf16, w8 and w4, it launches
the kernel on 36 distinct weight matrices in turn (as one decode step
streams the layers, so nothing sits in the 50 MB L2) with 64- and
128-column tiles and K split 1, 2, 3, ... ways, and prints microseconds
per launch and GB/s of codes beside the bytes bound, marking with ``*``
the plan that ``repro_torch.kernels.qmatmul.split_plan`` picks and giving
its distance from the best forced plan, then one decode step's qmatmul
time (36 layers x 7 projections) at the planned and at the best plans.
This is the measurement behind that rule.  Every forced plan is first held
against the plain version.

``--ablate`` also builds ``csrc/qmatmul.cu`` with ``-DQMM_NO_MMA`` (the
tensor-core MMAs removed) and with ``-DQMM_NO_COPY`` (the weight copies
removed), and times both at the planned split beside the kernel: which
phase sets the pace.  Those builds compute wrong values.

``--variants`` builds the source with other block geometries, ``wAsBbC``
= ``QMM_WARPS`` A, ``QMM_STAGES`` B, ``QMM_STAGE_BYTES`` C KB, and runs
the whole sweep on each.

``--phases`` builds the source (and each variant) with ``-DQMM_CLOCK`` and
prints, at the planned split of each shape, thread 0's clock64 cycles per
block in each phase: the prologue (first copies issued), waiting for
copies at the ring's barrier, computing, the warps' sums and stores, the
split handshake (fence and counter), and per last block of a tile its sum
of the splits.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LAYERS, BATCH, REPS = 36, 4, 3
# (name, K, N, launches per layer)
SHAPES = (("wq/wo", 2048, 2048, 2), ("wk/wv", 2048, 256, 2),
          ("gate/up", 2048, 11008, 2), ("w_down", 11008, 2048, 1))
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
PHASES = ("prologue", "wait", "compute", "sums+stores", "handshake",
          "last block's sum")
PEAK_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 200_000_000


def build_variant(B, name: str, flags) -> Path:
    """qmatmul.cu alone, built with ``flags``, as its own shared library."""
    out = B.BUILD_DIR / f"qmatmul-{name}.so"
    B.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([B._nvcc(), *B.ARCH_FLAGS, *B.CFLAGS, *flags, "-shared",
                    "-o", str(out), str(B.CSRC_DIR / "qmatmul.cu")],
                   check=True, capture_output=True, text=True)
    return out


def geometry_flags(spec: str):
    m = re.fullmatch(r"w(\d+)s(\d+)b(\d+)", spec)
    if not m:
        raise SystemExit(f"variant {spec!r} is not of the form w8s3b16")
    w, s, b = map(int, m.groups())
    return [f"-DQMM_WARPS={w}", f"-DQMM_STAGES={s}",
            f"-DQMM_STAGE_BYTES={b * 1024}"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ablate", action="store_true",
                    help="also time builds without the MMAs and without the "
                         "weight copies")
    ap.add_argument("--phases", action="store_true",
                    help="also time the phases of each block (clock64)")
    ap.add_argument("--variants", default="",
                    help="comma-separated block geometries to sweep too, "
                         "e.g. w4s4b8,w8s4b16")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("needs a CUDA device\n")
        return 2
    from repro_torch.core import quant as Q
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as B
    from repro_torch.kernels import qmatmul as KQ

    resolve_device(None)
    lib = B.library()
    kernel_fn = lib.qmatmul
    builds = {f"ablate-{f}": [f"-D{f}"] for f in ("QMM_NO_MMA", "QMM_NO_COPY")
              if args.ablate}
    variants = [v for v in args.variants.split(",") if v]
    builds.update({v: geometry_flags(v) for v in variants})
    if args.phases:
        builds.update({f"clock-{v}": geometry_flags(v) + ["-DQMM_CLOCK"]
                       for v in variants})
        builds["clock-kernel"] = ["-DQMM_CLOCK"]
    with ThreadPoolExecutor(len(builds) or 1) as pool:
        paths = dict(zip(builds, pool.map(
            lambda kv: build_variant(B, *kv), builds.items())))
    fns, clocks = {}, {}
    for name, path in paths.items():
        so = ctypes.CDLL(str(path))
        fn = so.repro_qmatmul
        fn.argtypes, fn.restype = kernel_fn.argtypes, ctypes.c_int
        fns[name] = fn
        if name.startswith("clock-"):
            clocks[name] = so.repro_qmatmul_clock
            clocks[name].argtypes = [ctypes.c_void_p]
            clocks[name].restype = ctypes.c_int
    sweeps = ["kernel"] + variants
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)

    def time_us(x, ws, s, bits, **plan) -> float:
        for w in ws:
            KQ.qmatmul(x, w, s, bits, **plan)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)   # the host enqueues ahead
        start.record()
        for _ in range(REPS):
            for w in ws:
                KQ.qmatmul(x, w, s, bits, **plan)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (REPS * len(ws)) * 1e3

    worst = 0.0
    step = {}                      # (build, bits) -> [planned ms, best ms]
    for bits in (8, 4):
        for name, k, n, per_layer in SHAPES:
            nb = n if bits == 8 else n // 2
            ws = [torch.randint(-128, 128, (k, nb), dtype=torch.int8,
                                device="cuda", generator=gen)
                  for _ in range(LAYERS)]
            s = torch.rand(n, device="cuda", generator=gen) * 0.02 + 0.001
            x = (torch.rand(BATCH, k, device="cuda", generator=gen) * 2 - 1
                 ).to(torch.bfloat16)
            want = KQ.qmatmul_plain(x, ws[0], s, bits).float()
            wint = (Q.unpack_int4(ws[0]) if bits == 4 else ws[0]).float()
            tol = (2e-5 * (x.float().abs() @ wint.abs()) * s
                   + want.abs() * 2.0 ** -7)
            code_bytes = k * nb
            bound_us = code_bytes / PEAK_BYTES_PER_S * 1e6
            _, pbn, psplits, _ = KQ.split_plan(BATCH, k, n, sms, bits)
            for build in sweeps:
                lib.qmatmul = fns.get(build, kernel_fn)
                best, planned = None, None
                for bn in (64, 128):
                    row = []
                    for sp in SPLITS:
                        try:
                            got = KQ.qmatmul(x, ws[0], s, bits, splits=sp,
                                             bn=bn)
                        except RuntimeError:    # e.g. beyond shared memory
                            row.append(f"s{sp}:refused")
                            continue
                        if not bool(((got.float() - want).abs() <= tol).all()):
                            raise SystemExit(
                                f"{build} w{bits} {name} bn {bn} splits {sp}"
                                " differs from the plain version")
                        us = time_us(x, ws, s, bits, splits=sp, bn=bn)
                        mark = "*" if (bn, sp) == (pbn, psplits) else ""
                        row.append(f"s{sp}{mark}:{us:.2f}")
                        best = us if best is None else min(best, us)
                        if mark:
                            planned = us
                    print(f"{build} w{bits} {name:7s} K={k:5d} N={n:5d} "
                          f"bn={bn:3d} bound {bound_us:.2f} us; us/launch "
                          + " ".join(row))
                if planned is None:
                    planned = time_us(x, ws, s, bits)
                if build == "kernel":
                    worst = max(worst, planned / best - 1)
                tot = step.setdefault((build, bits), [0.0, 0.0])
                tot[0] += planned * per_layer * LAYERS / 1e3
                tot[1] += best * per_layer * LAYERS / 1e3
                print(f"{build} w{bits} {name:7s} plan bn={pbn} s{psplits}: "
                      f"{planned:.2f} us = {code_bytes / planned / 1e3:.0f} "
                      f"GB/s of codes ({planned / bound_us:.2f}x the bound), "
                      f"best forced {best:.2f} us, plan "
                      f"{planned / best - 1:+.1%}")
            lib.qmatmul = kernel_fn
            for build, read in clocks.items():
                lib.qmatmul = fns[build]
                buf = (ctypes.c_ulonglong * 8)()
                try:
                    for w in ws:
                        KQ.qmatmul(x, w, s, bits)
                    torch.cuda.synchronize()
                    read(buf)                      # discard the warm-up
                    for w in ws:
                        KQ.qmatmul(x, w, s, bits)
                    torch.cuda.synchronize()
                    if read(buf) != 0:
                        raise SystemExit(f"{build}: reading the clocks failed")
                finally:
                    lib.qmatmul = kernel_fn
                blocks, last = max(buf[6], 1), max(buf[7], 1)
                per = [buf[i] / blocks for i in range(5)] + [buf[5] / last]
                print(f"{build[6:]} w{bits} {name:7s} cycles per block "
                      f"({buf[6] // LAYERS} blocks, {buf[7] // LAYERS} last): "
                      + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, per)))
            for build, fn in fns.items():
                if not build.startswith("ablate-"):
                    continue
                lib.qmatmul = fn
                try:
                    us = time_us(x, ws, s, bits)
                finally:
                    lib.qmatmul = kernel_fn
                print(f"w{bits} {name:7s} plan {build[7:]}: {us:.2f} us "
                      f"({us / planned - 1:+.1%} against the kernel)")
            del ws
    for (build, bits), (planned, best) in step.items():
        print(f"{build} w{bits} one decode step ({7 * LAYERS} launches): "
              f"{planned:.4f} ms at the planned splits, {best:.4f} ms at the "
              "best forced plan of each shape")
    print(f"worst plan against the best forced plan: {worst:+.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
