#!/usr/bin/env python3
"""Time the qmatmul kernel at Qwen2.5-3B's decode shapes for every K split
and column-tile width.

Run from the repository root on a machine with one CUDA card::

    python3 tools/sweep_qmatmul_splits.py [--ablate] [--phases] [--variants w4s4b8,...]
    python3 tools/sweep_qmatmul_splits.py --rows

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

``--rows`` times the two routes instead (``repro_torch.kernels.qmatmul.
qmm_route``): at M 8 to 8,192, on whisper-tiny's encoder products and on
Qwen2.5-3B's projections (the (K, N) of a prefill), w8 and w4, bf16 x, the
decode kernel at its planned splits and the many-row kernel at 64-, 96-
and 128-row tiles, each held against the plain version first; it prints
microseconds per launch beside the bound, the route and tile the plans
pick and their distance from the best, and where the rows route starts to
win for each shape: the measurement behind ``qmm_route`` (``ROWS_M``,
``ROWS_MN``) and ``rows_plan``.
Then whisper-tiny's ``encode`` of 4 x 1,500 frames at full size, w8 and
w4, with every product on the decode kernel and on the planned routes, in
turns (planned, decode, decode, planned).

``--rows-variants s3,s5,...`` (with ``--rows``) first builds the source
with other many-row ring depths, ``sB`` = ``QMR_STAGES`` B stages, and
times each beside the built kernel at M 6,000 on the same shapes, each
held against the plain version first; ``s4+QMM_NO_MMA+...`` adds
measurement flags (the ablations in ``csrc/qmatmul.cu``'s header, which
compute wrong values and are not checked).

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
PEAK_BF16_OPS = 989e12
SLEEP_CYCLES = 200_000_000
# --rows: rows of x, and (name, K, N) of whisper-tiny's encoder and of a
# Qwen2.5-3B prefill
ROWS_MS = (8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 1024, 2048, 4096,
           6000, 8192)
ROWS_SHAPES = (("enc q/k/v/o", 384, 384), ("enc w_up", 384, 1536),
               ("enc w_down", 1536, 384), ("wq/wo", 2048, 2048),
               ("wk/wv", 2048, 256), ("gate/up", 2048, 11008),
               ("w_down", 11008, 2048))
ROWS_STREAM_BYTES = 64e6      # codes streamed per timed shape
ROWS_GIVE_UP = 3.0            # stop timing the decode route this far behind


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


def _time_us(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)   # the host enqueues ahead
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def rows_variants(torch, specs) -> None:
    """The many-row kernel built with other ring depths (``sB``), beside
    the built one, at M 6,000 on ROWS_SHAPES, w8 and w4, both tile
    heights."""
    from repro_torch.core import quant as Q
    from repro_torch.kernels import build as B
    from repro_torch.kernels import qmatmul as KQ

    builds = {}
    for spec in specs:
        m = re.fullmatch(r"s(\d+)((?:\+\w+)*)", spec)
        if not m:
            raise SystemExit(f"variant {spec!r} is not of the form s4 or "
                             "s4+QMM_NO_MMA+...")
        builds[spec] = [f"-DQMR_STAGES={m.group(1)}"] + [
            f"-D{f}" for f in m.group(2).split("+") if f]
    def build(kv):
        try:
            return build_variant(B, "rows-" + kv[0], kv[1])
        except subprocess.CalledProcessError as e:
            print(f"rows variant {kv[0]}: nvcc failed ({e.returncode}):\n"
                  + (e.stdout or "")[-1500:] + (e.stderr or "")[-1500:])
            return None

    with ThreadPoolExecutor(max(1, len(builds))) as pool:
        paths = {k: v for k, v in zip(builds, pool.map(build, builds.items()))
                 if v is not None}
    lib = B.library()
    built = lib.qmatmul_rows
    fns = {"built": built}
    for spec, path in paths.items():
        fn = ctypes.CDLL(str(path)).repro_qmatmul_rows
        fn.argtypes, fn.restype = built.argtypes, ctypes.c_int
        fns[spec] = fn
    gen = torch.Generator(device="cuda").manual_seed(1)
    m = 6000
    for bits in (8, 4):
        for name, k, n in ROWS_SHAPES:
            lim = 8 if bits == 4 else 128
            ints = torch.randint(-lim, lim, (k, n), generator=gen,
                                 device="cuda", dtype=torch.int32)
            w = Q.pack_int4(ints) if bits == 4 else ints.to(torch.int8)
            s = torch.rand(n, device="cuda", generator=gen) * 0.02 + 0.001
            x = (torch.rand(m, k, device="cuda", generator=gen) * 2 - 1
                 ).to(torch.bfloat16)
            want = KQ.qmatmul_plain(x, w, s, bits).float()
            tol = (2e-5 * (x.float().abs() @ ints.abs().float()) * s
                   + want.abs() * 2.0 ** -7)
            row = []
            for label, fn in fns.items():
                lib.qmatmul_rows = fn
                try:
                    for bm in KQ.ROWS_BMS:
                        got = KQ.qmatmul(x, w, s, bits, route="rows", bm=bm)
                        # an ablation (s4+QMM_NO_MMA) computes wrong values
                        if "NO_" not in label and not bool(
                                ((got.float() - want).abs() <= tol).all()):
                            raise SystemExit(f"rows variant {label} w{bits} "
                                             f"{name} bm {bm} differs")
                        us = _time_us(torch, lambda: KQ.qmatmul(
                            x, w, s, bits, route="rows", bm=bm), 20)
                        row.append(f"{label}/{bm}={us:.2f}")
                finally:
                    lib.qmatmul_rows = built
            print(f"rows variants w{bits} {name:11s} K={k:5d} N={n:5d} "
                  f"M={m}: " + " ".join(row) + " us")
            del ints, w, x, want, tol


def rows_sweep(torch, variants=()) -> int:
    """The two routes at M 8 to 8,192 (see the module docstring)."""
    from repro_torch.core import quant as Q
    from repro_torch.kernels import qmatmul as KQ

    if variants:
        rows_variants(torch, variants)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for bits in (8, 4):
        for name, k, n in ROWS_SHAPES:
            nb = n if bits == 8 else n // 2
            lim = 8 if bits == 4 else 128
            copies = int(min(32, max(2, -(-ROWS_STREAM_BYTES // (k * nb)))))
            ints = [torch.randint(-lim, lim, (k, n), generator=gen,
                                  device="cuda", dtype=torch.int32)
                    for _ in range(copies)]
            ws = [Q.pack_int4(c) if bits == 4 else c.to(torch.int8)
                  for c in ints]
            wabs = ints[0].abs().float()
            del ints
            s = torch.rand(n, device="cuda", generator=gen) * 0.02 + 0.001
            give_up = 0
            first_rows = None
            for m in ROWS_MS:
                x = (torch.rand(m, k, device="cuda", generator=gen) * 2 - 1
                     ).to(torch.bfloat16)
                want = KQ.qmatmul_plain(x, ws[0], s, bits).float()
                tol = (2e-5 * (x.float().abs() @ wabs) * s
                       + want.abs() * 2.0 ** -7)
                forms = [("decode", None)] if give_up < 2 else []
                forms += [("rows", bm) for bm in KQ.ROWS_BMS]
                times = {}
                for route, bm in forms:
                    got = KQ.qmatmul(x, ws[0], s, bits, route=route, bm=bm)
                    if not bool(((got.float() - want).abs() <= tol).all()):
                        raise SystemExit(f"w{bits} {name} M={m} {route} "
                                         f"bm {bm} differs from the plain "
                                         "version")
                    est = _time_us(torch, lambda: KQ.qmatmul(
                        x, ws[0], s, bits, route=route, bm=bm), 1)
                    reps = int(max(1, min(8, 20_000 / max(est, 1.0)
                                          / copies)))
                    times[(route, bm)] = _time_us(torch, lambda: [
                        KQ.qmatmul(x, w, s, bits, route=route, bm=bm)
                        for w in ws], reps) / copies
                del got, want, tol
                best_rows = min(times[("rows", bm)] for bm in KQ.ROWS_BMS)
                dec = times.get(("decode", None))
                if dec is not None and dec > ROWS_GIVE_UP * best_rows:
                    give_up += 1
                if first_rows is None and (dec is None or best_rows < dec):
                    first_rows = m
                route = KQ.qmm_route(m, k, n, sms, bits)
                pbm = (KQ.rows_plan(m, k, n, sms, bits)[0] if route == "rows"
                       else None)
                planned = times.get((route, pbm))
                best = min(times.values())
                if planned is not None:
                    worst = max(worst, planned / best - 1)
                b_us = (k * nb + 4 * n + 2 * m * (k + n)) / PEAK_BYTES_PER_S * 1e6
                o_us = 2 * m * k * n / PEAK_BF16_OPS * 1e6
                print(f"rows w{bits} {name:11s} K={k:5d} N={n:5d} M={m:5d}: "
                      + " ".join(f"{r}{'' if b is None else b}={t:.2f}"
                                 for (r, b), t in times.items())
                      + ("" if dec is not None else " decode=not timed")
                      + f" us; bound {max(b_us, o_us):.2f} us "
                      f"({'bytes' if b_us >= o_us else 'operations'}); plan "
                      f"{route}{'' if pbm is None else pbm}"
                      + ("" if planned is None else
                         f" {planned:.2f} us, {planned / best - 1:+.1%} "
                         "against the best"))
            print(f"rows w{bits} {name:11s} K={k:5d} N={n:5d}: the rows route "
                  f"is faster from M={first_rows} on (the route takes it from "
                  f"M={max(KQ.ROWS_M, -(-KQ.ROWS_MN // n))})")
            del ws
            torch.cuda.empty_cache()
    print(f"rows: worst planned route and tile against the best measured: "
          f"{worst:+.1%}")
    encode_turns(torch, KQ)
    return 0


def encode_turns(torch, KQ) -> None:
    """whisper-tiny's encode of 4 x 1,500 frames, every product on the
    decode kernel against the planned routes, in turns."""
    import numpy as np

    from repro_torch.kernels import build as B
    from repro_torch.launch.steps import init_serving_params
    from repro_torch.models import whisper
    from repro_torch.models.common import get_config

    cfg = get_config("whisper-tiny")
    frames = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (4, cfg.enc_seq, cfg.d_model)).astype(np.float32), device="cuda")
    rows_m = KQ.ROWS_M      # a "decode" turn sets it past every M
    for bits in (8, 4):
        tree = init_serving_params(torch.Generator(device="cuda").manual_seed(
            0), cfg, bits)
        res = {}
        for label in ("planned", "decode", "decode", "planned"):
            KQ.ROWS_M = rows_m if label == "planned" else 1 << 30
            KQ.qmm_route.cache_clear()
            try:
                B.reset_launch_counts()
                whisper.encode(tree, frames, cfg)
                torch.cuda.synchronize()
                rows = B.launch_counts["qmatmul_rows"]
                launches = B.launch_counts["qmatmul"]
                ms = _time_us(torch, lambda: whisper.encode(tree, frames, cfg),
                              5) / 1e3
            finally:
                KQ.ROWS_M = rows_m
                KQ.qmm_route.cache_clear()
            res.setdefault(label, []).append(ms)
            print(f"rows whisper-tiny encode w{bits} (4 x {cfg.enc_seq} "
                  f"frames) {label}: {ms:.4f} ms ({rows} of {launches} "
                  "qmatmul launches on the rows kernel)")
        print(f"rows whisper-tiny encode w{bits}: planned "
              f"{min(res['planned']):.4f} ms, all on the decode kernel "
              f"{min(res['decode']):.4f} ms (best of 2 each)")
        del tree


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
    ap.add_argument("--rows", action="store_true",
                    help="time the decode and the many-row routes at M 8 "
                         "to 8,192 instead")
    ap.add_argument("--rows-variants", default="",
                    help="with --rows: comma-separated many-row ring depths "
                         "to time too, e.g. s3,s5")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("needs a CUDA device\n")
        return 2
    if args.rows:
        from repro_torch.device import resolve_device

        resolve_device(None)
        return rows_sweep(torch, [v for v in args.rows_variants.split(",")
                                  if v])
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
