#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA H100 and check them.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit (``nvcc``); without a CUDA
device it exits non-zero before printing any result.  Phases, each of which
ends the run with a non-zero exit if it fails:

1. card name and power limit, torch/CUDA versions; build every CUDA kernel
   of the port from ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a``
   (one ``nvcc`` per source, all started together); registers and spills
   per kernel as ``ptxas`` reports them; a kernel that spills fails the
   run.
2. FSL kernels: each held against its plain PyTorch version on the card
   (odd shapes, int8/int16/int32 codes, packed int4, L from 15 to 65535,
   grid and off-grid floats; the conv forms on every kernel / stride / pad
   the im2col node takes, with forced K splits: the int8 tensor-core
   kernel, the float MVAU and the wide-code integer route on the CUDA-core
   kernel; the int8 kernel with its GlobalAccPool epilogue at r2b's shape
   at batch 1 and 64, forced splits 1/2/8, repeated launches and a skip
   that wraps the int32 sums; the GAP kernel with and without a residual
   operand); then each held against it again and timed at the FSL path's
   shapes at batch 64, beside its bound and PyTorch library calls
   computing the same function (``torch._int_mm`` + count, ``torch.matmul``
   + count and ``torch.matmul`` alone on pre-built patches, the unfold
   im2col a PyTorch user would write, ``torch.add`` + ``torch.sum``); the
   MVAUs in conv form and in GEMM form on pre-built patches; the int32-code
   route in conv form; r2b's tail fused, unfused (conv, add, GAP) and the
   conv alone.
2b. CUDA graphs on the FSL path: the width-64 int and f32 artifacts and
   their flip ensembles warmed at every bucket 1-64, each bucket captured
   as one CUDA graph; every replay equals the eager run of the same
   function bit for bit, int == f32 == interpreter through the replays,
   no capture after warmup; latency at batch 1 and 64, replayed and eager
   (profiled after phase 4: device busy beside each, and the replayed
   batch-64 int forward's kernels, 27 with 8 ``mvau_conv_kernel``).
3. FSL path at the paper's width 64 on 32x32 frames: ``compile(...,
   datapath="int")`` and ``"f32"`` on the card, every im2col of both
   artifacts folded into its conv-form MVAU, the int artifact's last
   residual add and GAP into r2b's epilogue, the f32 artifact's add into
   the GAP kernel; int == f32 == interpreter and card == CPU, bit for bit;
   weight bytes; launches per forward; compile time, latency and
   throughput, beside the int artifact lowered with its tail unfused.
4. few-shot requests: support shots registered into a PrototypeStore on
   the card and queries classified through the deployed int artifact;
   prototypes and similarities agree with a CPU store's run within a stated
   tolerance, predictions are equal.  Then, after every latency has been
   taken, ``torch.profiler`` traces the int (unfused tail too) and f32
   forwards: device time by kernel, kernels per forward (27 int, 14 f32,
   one add kernel each), an estimate of the device's busy share, and no
   patch gather.  After the path's launch counts are read, the 8
   conv-form launches are timed again on the activations and weights one
   forward gives them, and r2b's again with its GAP epilogue.
4b. the serving engine on the card: ``ServeEngine`` over an
   ``ArtifactRegistry`` of the width-64 int and f32 artifacts (flip
   ensembles), warmed at max_batch 64; 5-way 5-shot registers, then at
   least 1,000 classify requests of 1-4 frames from 4 closed-loop client
   threads, the default hot-swapped to f32 halfway and a third artifact
   captured while they run: no capture after warmup, nothing rejected or
   failed, prototypes bit for bit and predictions equal to an offline
   recompute, every kernel launch a graph replay; requests/s, p50/p99
   latency and mean batch, closed loop and saturated (open loop), and the
   device's busy share in a traced window of each.
5. wide codes: ``grid_point(8, 8)`` and ``paper_w16a16()`` int artifacts
   (and w6a4 beside them) compiled on the card at the widest width their
   lowering admits, every MVAU on the CUDA-core kernel with its im2col
   folded in; card == CPU bit for bit on the timed batch-64 forward;
   batch-64 latency.
6. LM decode path, Qwen2.5-3B at full width and depth with random weights
   drawn on the card: ``qmatmul`` held against its plain version (ragged
   shapes, the 7 decode projections at batch 4, a prefill shape, forced K
   splits at both column-tile widths; w8 and w4; bit for bit on integer
   inputs; two launches bit for bit), then timed over one decode step's
   252 launches beside its bound and cuBLAS on pre-cast codes, with GB/s
   of codes per projection and the w4/w8 ratio; ``generate`` at w8 and w4
   (batch 4, prompt 8, 16 new tokens, twice each: identical tokens) with
   the eager step, then with the decode step captured as one CUDA graph
   (its pool's bytes; the same tokens; logits of every step bit for bit
   against the eager step), launches per step, per-step latency eager and
   replayed, w8 against bf16 top-1 agreement, a traced step's device time
   by kernel and busy share, eager and replayed (252 qmatmul kernels per
   step, none a separate split-K reduce); then a 2-layer
   full-width copy decodes on the card and on the CPU, and their logits
   and greedy tokens are compared.
7. training (path ``fsl_train``): ``pretrain_backbone`` at width 64 with
   ``paper_w6a4()`` on the card (24 base classes, batch 64, 150 steps),
   twice from one seed: finite losses that fall, both runs bit for bit
   equal in losses and params, TF32 still off; ms per step and steps/s,
   one step's device time by kernel and busy share (profiler), the
   smallest BN scale.  The trained weights deployed: int and f32
   artifacts equal the QAT features (rtol 1e-5, atol 1e-6) on every frame
   where no pre-activation lies on a grid midpoint
   (``resnet9.midpoint_ties``; at most 2 of 64 frames tie, each within a
   code of QAT), int == f32 bit for bit, card == CPU
   at batch 2, deployed accuracy over 20 episodes within 0.01 of QAT
   accuracy.  Then the paper's Table II rows
   (``benchmarks/table2_accuracy.py``'s four configs) at width 64, 120
   steps: QAT and deployed-int accuracy with their CIs and seconds,
   printed, not gated.
8. design-space exploration (path ``dse``): ``SweepFarm`` over
   ``DEFAULT_GRID`` at width 64, 120 steps, 10 episodes, on the card:
   every point's int artifact == its f32 artifact; a restarted farm
   recomputes nothing and returns equal records; a serial ``sweep`` of two
   points equals the farm on ``DETERMINISTIC_KEYS``; ``publish_frontier``
   registers the frontier and a ``ServeEngine`` serves the knee, its
   features bit for bit the record's probe features and its
   classification the offline NCM's.
9. a JSON line of every kernel with its launches on its paths (the integer
   MVAU's also by route: int8 ``wgmma`` and CUDA cores) and its numbers,
   the card's name and power limit, and a last line
   ``{"ok": true, "device": {...}}``.

Launch counters are set to 0 just before each path (phases 3-4, the
engine's traffic, the counted forwards of phase 5, the eager and the
captured ``generate`` runs of phase 6, and phases 7 and 8 as a whole) and
read just after; launches made while comparing or timing kernels do not
count.  A graph's launches are
recorded when it is captured and counted at each replay: the paths
``fsl_serve`` and ``lm_decode_graph`` are counted from replays only (the
script checks that every launch there was one).
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth, int8 tensor-core
# rate, float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_OPS = 67e12
# int32 multiply-add outside the tensor cores: 64 INT32 lanes per SM against
# 128 FP32 lanes (Hopper white paper), so half the float32 rate
PEAK_INT32_OPS = PEAK_F32_OPS / 2

WIDTH = 64
IMG = 32
BATCH = 64
INT_WEIGHT_BYTES = 6_697_920
F32_WEIGHT_BYTES = 26_388_480


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


SLEEP_CYCLES = 20_000_000     # about 10 ms of device clock


def cuda_ms(torch, fn, reps: int = 20,
            sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call.  The launches queue behind a device-side sleep,
    so the host has enqueued them all before the first one starts and the
    card runs them back to back: a slow host adds no idle gaps to the time
    of a short kernel.  A function that waits for the card inside still
    pays its own waits."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn, reps: int = 10) -> float:
    """Mean host wall-clock of ``fn`` with the device synchronized."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def layer_shapes(width: int, batch: int, img: int):
    """(name, frame side, C, N) of the 8 conv MVAU layers of ResNet-9 at
    this size: 3x3, stride 1, pad 1, so M = batch x side^2 and K = 9 C."""
    from repro_torch.models import resnet9

    out, hw = [], img
    for blk in resnet9.plan(width):
        out.append((blk["name"], hw, blk["cin"], blk["cout"]))
        if blk.get("pool"):
            hw //= 2
    return out


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels(torch, Q, KM, KG, ref):
    dev = "cuda"
    gen = torch.Generator().manual_seed(1234)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64
                             ).to(torch.int32)

    err = {"mvau_int": 0.0, "mvau_int_gap": 0.0, "mvau": 0.0, "gap": 0.0}
    # L > 64 takes the kernels' binary-search epilogue (sorted tables)
    cases = [(7, 36, 8, 15), (16, 130, 129, 15), (5, 64, 32, 255),
             (130, 200, 96, 512), (1000, 27, 64, 15), (300, 4608, 512, 15),
             (70, 40, 24, 4095), (9, 64, 136, 65535)]
    for m, k, n, L in cases:
        x = ri(0, 16, (m, k))
        w = ri(-32, 32, (k, n))
        t = torch.sort(ri(-500, 4000, (n, L)), dim=1).values
        want = KM.mvau_int_plain(x, w, t, -3)
        for xd, wd in ((torch.int8, torch.int8), (torch.int32, torch.int32),
                       (torch.int8, torch.int32), (torch.int32, torch.int16),
                       (torch.int32, torch.int8)):
            got = KM.mvau_int(x.to(xd).to(dev), w.to(wd).to(dev), t.to(dev), -3)
            torch.cuda.synchronize()
            d = (got.cpu() - want).abs().max().item() if want.numel() else 0
            err["mvau_int"] = max(err["mvau_int"], float(d))
            check(torch.equal(got.cpu(), want),
                  f"mvau_int {m}x{k}x{n} L={L} {xd}/{wd} differs by {d}")
        if n % 2 == 0:
            w4 = ri(-8, 8, (k, n))
            want4 = KM.mvau_int_plain(x, w4, t, 2)
            got4 = KM.mvau_int(x.to(torch.int8).to(dev),
                               Q.pack_int4(w4).to(dev), t.to(dev), 2,
                               w_packed=True)
            torch.cuda.synchronize()
            check(torch.equal(got4.cpu(), want4),
                  f"mvau_int packed int4 {m}x{k}x{n} L={L} differs")
        # float MVAU on the grid: every partial sum exact -> bit for bit
        xf, wf = x.float() * 0.25, w.float() / 32
        tf = torch.sort(torch.randn((n, L), generator=gen) * 4, dim=1).values
        xf, wf, tf = xf.to(dev), wf.to(dev), tf.to(dev)
        got = KM.mvau(xf, wf, tf, -4.0, 0.5, 0.25)
        want = KM.mvau_plain(xf, wf, tf, -4.0, 0.5, 0.25)
        torch.cuda.synchronize()
        d = (got - want).abs().max().item() if want.numel() else 0
        err["mvau"] = max(err["mvau"], float(d))
        check(torch.equal(got, want), f"mvau grid {m}x{k}x{n} L={L} differs by {d}")
        # int8 x int8 sub-path of the float MVAU
        ti = torch.sort(ri(-500, 4000, (n, L)), dim=1).values.to(dev)
        x8, w8 = x.to(torch.int8).to(dev), w.to(torch.int8).to(dev)
        check(torch.equal(KM.mvau(x8, w8, ti, 1.0, 0.25, -0.5),
                          KM.mvau_plain(x8, w8, ti, 1.0, 0.25, -0.5)),
              f"mvau int8 sub-path {m}x{k}x{n} differs")

    # float MVAU off the grid.  Tolerance: the kernel (FMA, K-tile order)
    # and the plain version (library GEMM) round their float32 sums
    # differently, so a count may differ by one level, and only where the
    # exact (float64) accumulator lies within 1e-5 of the row's |x|·|w| of a
    # threshold; everywhere else the outputs are equal.
    xo = torch.rand((257, 300), generator=gen) * 4 - 2
    wo = torch.rand((300, 130), generator=gen) * 4 - 2
    spec = Q.FixedPointSpec(8, 4, signed=True)
    to = torch.as_tensor(Q.thresholds_for(spec))[None, :].expand(130, 255)
    to = to.contiguous()
    xo, wo, to = xo.to(dev), wo.to(dev), to.to(dev)
    got = KM.mvau(xo, wo, to, float(spec.qmin), 1.0, 0.0)
    want = KM.mvau_plain(xo, wo, to, float(spec.qmin), 1.0, 0.0)
    acc64 = xo.double() @ wo.double()
    scale64 = xo.double().abs() @ wo.double().abs()
    near = ((acc64[..., None] - to.double()[None]).abs()
            <= 1e-5 * scale64[..., None]).any(dim=-1)
    diff = (got - want).abs()
    err["mvau"] = max(err["mvau"], float(diff.max().item()))
    check(bool((diff[~near] == 0).all()), "mvau off-grid differs away from "
          "a threshold")
    check(bool((diff <= 1.0).all()), "mvau off-grid differs by more than one "
          "level")
    log(f"kernel check mvau off-grid: {int((diff > 0).sum())} of "
        f"{diff.numel()} outputs differ by one level, all within 1e-5 of a "
        "threshold")

    n_conv = check_conv_kernel(torch, Q, KM, ri, err)
    log(f"kernel check mvau_int conv form: {n_conv} cases bit for bit "
        "(kernel/stride/pad 1/1/0, 3/1/1, 3/2/1, 3/2/0; C 3, 16, 24; N 8, 72; "
        "int8 and packed int4 weights; 15 and 255 levels; K split 1, 2, 3)")
    n_grid, n_off, moved, outs = check_float_conv_kernel(torch, KM, ref, err)
    log(f"kernel check mvau float conv form (CUDA cores): {n_grid} cases on "
        f"the grid bit for bit, {n_off} off the grid with {moved} of {outs} "
        "outputs one level apart, all within 1e-5 of a threshold "
        "(kernel/stride/pad 1/1/0, 3/1/1, 3/2/1, 3/2/0; C 3, 16, 24; N 8, 72; "
        "15 and 255 levels; K split 1, 2, 3)")
    n_core = check_core_int_kernel(torch, Q, KM, gen, err)
    log(f"kernel check mvau_int CUDA-core route: {n_core} cases bit for bit "
        "(int32 codes up to 16 bits; int8, int16, int32 and packed int4 "
        "weights; 15, 255 and 65535 levels; conv form on every kernel/stride/"
        "pad with K split planned, 2 and 3, and the GEMM form)")

    n_fused = check_fused_gap(torch, Q, KM, ri, err)
    log(f"kernel check mvau_int with the GAP epilogue: {n_fused} cases bit "
        "for bit (r2b's 4x4x512 -> 512 at batch 1 and 64, K 4608, K split "
        "planned, 1, 2 and 8, each launched twice, a skip near 2^31 that "
        "wraps the int32 sums; OH·OW 1, 4 and 16, C 8 and 24, N 24 and 72, "
        "batch 3 and 37, int8 and packed int4 weights)")

    for shape in ((2, 8, 8, 16), (64, 4, 4, 512), (3, 5, 7, 24)):
        for dt in (torch.int8, torch.int32):
            xi = ri(-100, 100, shape).to(dt).to(dev)
            g, p = KG.gap(xi), KG.gap_plain(xi)
            check(g.dtype == torch.int32 and torch.equal(g, p),
                  f"gap {dt} {shape} differs")
            # the residual add folded in: int8 sums wrap in int8
            si = ri(0, 100, shape).to(dt).to(dev)
            g, p = KG.gap(xi, si), KG.gap_plain(xi, si)
            check(g.dtype == torch.int32 and torch.equal(g, p),
                  f"gap with skip {dt} {shape} differs")
        xg = (ri(0, 64, shape).float() * 0.25).to(dev)     # on the grid
        sg = (ri(0, 64, shape).float() * 0.25).to(dev)
        check(torch.equal(KG.gap(xg), KG.gap_plain(xg)), f"gap f32 grid {shape}")
        check(torch.equal(KG.gap(xg, sg), KG.gap_plain(xg, sg)),
              f"gap with skip f32 grid {shape}")
        xr = torch.randn(shape, generator=gen).to(dev)      # off the grid
        sr = torch.randn(shape, generator=gen).to(dev)
        # tolerance: float32 sums in another order, as the reference tests
        for got, want in ((KG.gap(xr), KG.gap_plain(xr)),
                          (KG.gap(xr, sr), KG.gap_plain(xr, sr))):
            d = (got - want).abs().max().item()
            err["gap"] = max(err["gap"], float(d))
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"gap f32 {shape} off by {d}")
    log(f"kernel check: all kernels equal their plain versions "
        f"(max abs err {err})")
    return err


def check_fused_gap(torch, Q, KM, ri, err):
    """The int8 conv MVAU with its GlobalAccPool epilogue against its plain
    version (``mvau_int_conv_plain`` + skip -> ``gap_plain``): at r2b's
    shape at batch 1 and 64 with the planned and forced K splits, each
    launched twice, once with a skip near 2^31 that makes the int32 sums
    wrap; and on small odd shapes.  Bit for bit."""
    dev = "cuda"
    n_cases = 0

    def inputs(batch, side, c, n, packed=False, wrap=False):
        x = ri(0, 16, (batch, side, side, c)).to(torch.int8).to(dev)
        w = ri(-8, 8, (9 * c, n)) if packed else ri(-32, 32, (9 * c, n))
        w = (Q.pack_int4(w) if packed else w.to(torch.int8)).to(dev)
        t = torch.sort(ri(-2000, 2000, (n, 15)), dim=1).values.to(dev)
        lo, hi = (2**31 - 40, 2**31 - 1) if wrap else (0, 16)
        skip = ri(lo, hi, (batch, side, side, n)).to(dev)
        return x, w, t, skip

    def one(args, base, packed, splits, label):
        x, w, t, skip = args
        want = KM.mvau_int_conv_gap_plain(x, w, t, skip, 3, 1, 1, base, packed)
        got = KM.mvau_int_conv_gap(x, w, t, skip, 3, 1, 1, base, packed,
                                   splits=splits)
        again = KM.mvau_int_conv_gap(x, w, t, skip, 3, 1, 1, base, packed,
                                     splits=splits)
        torch.cuda.synchronize()
        d = (got - want).abs().max().item()
        err["mvau_int_gap"] = max(err["mvau_int_gap"], float(d))
        check(torch.equal(got, want), f"mvau_int_conv_gap {label} splits="
              f"{splits} differs by {d}")
        check(torch.equal(got, again), f"mvau_int_conv_gap {label} splits="
              f"{splits}: two launches differ")

    for batch in (1, BATCH):
        for wrap in (False, True):
            args = inputs(batch, 4, 8 * WIDTH, 8 * WIDTH, wrap=wrap)
            for splits in (None, 1, 2, 8):
                one(args, 0, False, splits, f"r2b batch {batch} wrap={wrap}")
                n_cases += 1
    for side in (1, 2, 4):
        for c, n, batch in ((8, 24, 3), (24, 72, 37)):
            for packed in (False, True):
                args = inputs(batch, side, c, n, packed)
                for splits in (None, 2, 3):
                    one(args, -3, packed, splits, f"{batch}x{side}x{side}x{c}"
                        f" N={n} packed={packed}")
                    n_cases += 1
    return n_cases


def check_conv_kernel(torch, Q, KM, ri, err):
    """The conv-form kernel against its plain version (``ref.im2col`` +
    ``mvau_int_plain``) on the card, on the CPU tests' odd cases; the
    split-K path on forced splits.  Bit for bit."""
    dev = "cuda"
    n_cases = 0
    for kernel, stride, pad in ((1, 1, 0), (3, 1, 1), (3, 2, 1), (3, 2, 0)):
        for c in (3, 16, 24):
            for n in (8, 72):
                for batch, hw, packed, levels in ((1, 7, False, 15),
                                                  (3, 9, True, 255),
                                                  (3, 7, True, 15),
                                                  (1, 9, False, 255)):
                    x = ri(0, 16, (batch, hw, hw, c)).to(torch.int8).to(dev)
                    k = kernel * kernel * c
                    w = ri(-8, 8, (k, n)) if packed else ri(-32, 32, (k, n))
                    w = (Q.pack_int4(w) if packed else w.to(torch.int8)).to(dev)
                    t = torch.sort(ri(-600, 900, (n, levels)), dim=1).values
                    t = t.to(dev)
                    want = KM.mvau_int_conv_plain(x, w, t, kernel, stride, pad,
                                                  -3, packed)
                    for splits in (None, 2, 3):
                        got = KM.mvau_int_conv(x, w, t, kernel, stride, pad,
                                               -3, packed, splits=splits)
                        torch.cuda.synchronize()
                        d = (got - want).abs().max().item()
                        err["mvau_int"] = max(err["mvau_int"], float(d))
                        check(torch.equal(got, want),
                              f"mvau_int_conv {batch}x{hw}x{hw}x{c} N={n} "
                              f"k/s/p={kernel}/{stride}/{pad} L={levels} "
                              f"packed={packed} splits={splits} differs by {d}")
                        n_cases += 1
    return n_cases


KSP = ((1, 1, 0), (3, 1, 1), (3, 2, 1), (3, 2, 0))


def near_threshold(torch, ref, x, w, t, kernel, stride, pad):
    """Outputs whose exact (float64) accumulator lies within 1e-5 of the
    row's |x|·|w| of one of its thresholds: the only places where float32
    sums in another order may count one level apart."""
    p = ref.im2col(x, kernel, stride, pad).double()
    p = p.reshape(-1, p.shape[-1])
    acc = p @ w.double()
    scale = p.abs() @ w.double().abs()
    return ((acc[..., None] - t.double()[None]).abs()
            <= 1e-5 * scale[..., None]).any(dim=-1)


def check_float_conv_kernel(torch, KM, ref, err):
    """The float conv form (CUDA-core kernel) against its plain version
    (``ref.im2col`` + ``mvau_plain``) on the int8 conv form's odd cases, at
    forced K splits 1, 2 and 3.  On the grid every partial sum is exact:
    bit for bit.  Off the grid the kernel (FMA, K-tile order, splits) and
    the plain version (library GEMM) round float32 sums differently: a
    count may differ by one level, and only where the exact accumulator
    lies within 1e-5 of the row's |x|·|w| of a threshold."""
    dev = "cuda"
    gen = torch.Generator().manual_seed(77)
    n_grid = n_off = moved = outs = 0
    base, scale, bias = -2.0, 0.5, 0.25
    for kernel, stride, pad in KSP:
        for c in (3, 16, 24):
            for n in (8, 72):
                for batch, hw, levels in ((1, 7, 15), (3, 9, 255),
                                          (3, 7, 15), (1, 9, 255)):
                    k = kernel * kernel * c
                    xg = (torch.randint(0, 16, (batch, hw, hw, c),
                                        generator=gen) * 0.25).to(dev)
                    wg = (torch.randint(-32, 32, (k, n), generator=gen)
                          / 32).to(dev)
                    tg = torch.sort(torch.randn((n, levels), generator=gen)
                                    * 4, dim=1).values.to(dev)
                    xo = (torch.rand((batch, hw, hw, c), generator=gen) * 4
                          - 2).to(dev)
                    wo = (torch.rand((k, n), generator=gen) * 4 - 2).to(dev)
                    to = torch.sort(torch.randn((n, levels), generator=gen)
                                    * 2, dim=1).values.to(dev)
                    want_g = KM.mvau_conv_plain(xg, wg, tg, kernel, stride,
                                                pad, base, scale, bias)
                    want_o = KM.mvau_conv_plain(xo, wo, to, kernel, stride,
                                                pad, base, scale, bias)
                    near = near_threshold(torch, ref, xo, wo, to, kernel,
                                          stride, pad)
                    for splits in (1, 2, 3):
                        got = KM.mvau_conv(xg, wg, tg, kernel, stride, pad,
                                           base, scale, bias, splits=splits)
                        torch.cuda.synchronize()
                        d = (got - want_g).abs().max().item()
                        err["mvau"] = max(err["mvau"], float(d))
                        check(torch.equal(got, want_g),
                              f"mvau_conv grid {batch}x{hw}x{hw}x{c} N={n} "
                              f"k/s/p={kernel}/{stride}/{pad} L={levels} "
                              f"splits={splits} differs by {d}")
                        got = KM.mvau_conv(xo, wo, to, kernel, stride, pad,
                                           base, scale, bias, splits=splits)
                        lv = ((got - want_o) / scale).abs().reshape(near.shape)
                        err["mvau"] = max(err["mvau"], float(
                            (got - want_o).abs().max().item()))
                        check(bool((lv[~near] == 0).all()) and
                              bool((lv <= 1).all()),
                              f"mvau_conv off-grid {batch}x{hw}x{hw}x{c} N={n} "
                              f"k/s/p={kernel}/{stride}/{pad} splits={splits}"
                              ": more than one level, or away from a "
                              "threshold")
                        moved += int((lv > 0).sum())
                        outs += lv.numel()
                        n_grid += 1
                        n_off += 1
    return n_grid, n_off, moved, outs


def check_core_int_kernel(torch, Q, KM, gen, err):
    """The integer instantiation of the CUDA-core kernel against its plain
    version: int32 activation codes (up to 16-bit unsigned), int8, int16,
    int32 and packed int4 weights, 15, 255 and 65535 levels (dense count
    and binary search), conv form on every kernel/stride/pad with the
    planned and forced K splits, and the GEMM form.  The weights are bounded
    so that every partial sum stays inside int32, as the integer lowering
    guarantees.  Bit for bit."""
    dev = "cuda"
    n_cases = 0
    for wname, lim in (("int8", 128), ("int16", 32768), ("int32", 1 << 20),
                       ("packed4", 8)):
        for levels in (15, 255, 65535):
            for kernel, stride, pad in KSP:
                for c, n, xmax in ((3, 8, 65536), (16, 72, 256),
                                   (24, 8, 4096)):
                    k = kernel * kernel * c
                    wlim = min(lim, 2**31 // (k * xmax))
                    x = torch.randint(0, xmax, (2, 7, 7, c), generator=gen
                                      ).to(torch.int32).to(dev)
                    wi = torch.randint(-wlim, wlim, (k, n), generator=gen
                                       ).to(torch.int32)
                    packed = wname == "packed4"
                    w = (Q.pack_int4(wi) if packed
                         else wi.to(getattr(torch, wname))).to(dev)
                    tmax = max(1, k * xmax * wlim // 8)
                    t = torch.sort(torch.randint(-tmax, tmax, (n, levels),
                                                 generator=gen), dim=1
                                   ).values.to(torch.int32).to(dev)
                    want = KM.mvau_int_conv_plain(x, w, t, kernel, stride,
                                                  pad, -3, packed)
                    for splits in (None, 2, 3):
                        got = KM.mvau_int_conv(x, w, t, kernel, stride, pad,
                                               -3, packed, splits=splits)
                        torch.cuda.synchronize()
                        d = (got - want).abs().max().item()
                        err["mvau_int"] = max(err["mvau_int"], float(d))
                        check(torch.equal(got, want),
                              f"mvau_int CUDA-core {wname} L={levels} "
                              f"C={c} N={n} k/s/p={kernel}/{stride}/{pad} "
                              f"splits={splits} differs by {d}")
                        n_cases += 1
                    x2, w2 = x.reshape(-1, c).contiguous(), w[:c].contiguous()
                    check(torch.equal(KM.mvau_int(x2, w2, t, 5, packed),
                                      KM.mvau_int_plain(x2, w2, t, 5, packed)),
                          f"mvau_int CUDA-core GEMM form {wname} L={levels} "
                          f"C={c} differs")
                    n_cases += 1
    return n_cases


def im2col_unfold(torch, x, kernel, stride, pad):
    """The patch rows as a PyTorch user would build them: pad, unfold,
    permute to patch order (kh, kw, c), copy."""
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    p = xp.unfold(1, kernel, stride).unfold(2, kernel, stride)
    b, oh, ow = p.shape[:3]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(b * oh * ow, -1)


def time_kernels(torch, Q, KM, KG, ref, err):
    """Each kernel at the main path's shapes at batch 64: the kernel, its
    plain version, one library call, and the bound."""
    dev = "cuda"
    gen = torch.Generator().manual_seed(7)
    rows = []
    tot = {"mvau_int": [0.0, 0.0, 0.0, 0, 0], "mvau": [0.0, 0.0, 0.0, 0, 0]}
    conv = {"gemm_form_ms": 0.0, "gemm_form_bytes": 0, "library_im2col_ms": 0.0,
            "int32_codes_cuda_core_ms": 0.0, "int32_codes_plain_ms": 0.0,
            "int32_codes_bound_ms": 0.0, "layer_ms": []}
    flt = {"matmul_only_ms": 0.0, "gemm_form_ms": 0.0, "layers": []}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, hw, cin, n in layer_shapes(WIDTH, BATCH, IMG):
        L = 15
        m, k = BATCH * hw * hw, 9 * cin
        x4 = torch.randint(0, 16, (BATCH, hw, hw, cin), generator=gen
                           ).to(torch.int8).to(dev)          # NHWC codes
        w = torch.randint(-32, 32, (k, n), generator=gen).to(torch.int8).to(dev)
        t = torch.sort(torch.randint(-2000, 2000, (n, L), generator=gen),
                       dim=1).values.to(torch.int32).to(dev)
        x = ref.im2col(x4, 3, 1, 1).reshape(m, k).contiguous()   # patch rows
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8         # _int_mm wants /8
        xpad = torch.nn.functional.pad(x, (0, kp - k))
        wpad = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))

        def lib_int():
            acc = torch._int_mm(xpad, wpad)[:, :n]
            return ref.threshold_counts_fast(acc, t)

        def lib_im2col():
            xp = torch.nn.functional.pad(im2col_unfold(torch, x4, 3, 1, 1),
                                         (0, kp - k))
            return ref.threshold_counts_fast(torch._int_mm(xp, wpad)[:, :n], t)

        x32 = x.to(torch.int32)       # int32 codes take the CUDA-core kernel
        x4i = x4.to(torch.int32)
        # int16 weight codes at 16-bit scale (up to 2**13 in magnitude: the
        # sums stay inside int32 at K = 4608) through the same route
        w16 = torch.randint(-8192, 8192, (k, n), generator=gen
                            ).to(torch.int16).to(dev)
        tr = 2 ** 16 * math.isqrt(k)      # about 1.5 sums' spreads
        t16 = torch.sort(torch.randint(-tr, tr, (n, L), generator=gen),
                         dim=1).values.to(torch.int32).to(dev)
        want16 = KM.mvau_int_plain(x, w16, t16, 0)
        for got in (KM.mvau_int(x32, w16, t16, 0),
                    KM.mvau_int_conv(x4i, w16, t16, 3, 1, 1).reshape(m, n)):
            d = (got - want16).abs().max().item()
            err["mvau_int"] = max(err["mvau_int"], float(d))
            check(torch.equal(got, want16), f"mvau_int {name} at the main "
                  f"path's shape (int16 weights) differs by {d}")
        want = KM.mvau_int_plain(x, w, t, 0)
        for xx in (x, x32):
            got = KM.mvau_int(xx, w, t, 0)
            d = (got - want).abs().max().item()
            err["mvau_int"] = max(err["mvau_int"], float(d))
            check(torch.equal(got, want), f"mvau_int {name} at the main "
                  f"path's shape ({xx.dtype}) differs by {d}")
        for xx in (x4, x4i):
            got = KM.mvau_int_conv(xx, w, t, 3, 1, 1).reshape(m, n)
            d = (got - want).abs().max().item()
            err["mvau_int"] = max(err["mvau_int"], float(d))
            check(torch.equal(got, want), f"mvau_int_conv {name} at the main "
                  f"path's shape ({xx.dtype}) differs by {d}")
        check(torch.equal(lib_im2col(), want), f"{name}: the im2col yardstick "
              "computes another function")
        ms = cuda_ms(torch, lambda: KM.mvau_int_conv(x4, w, t, 3, 1, 1))
        gemm_ms = cuda_ms(torch, lambda: KM.mvau_int(x, w, t, 0))
        # the int32-code route: the CUDA-core kernel in conv form
        core_ms = cuda_ms(torch, lambda: KM.mvau_int_conv(x4i, w, t, 3, 1, 1))
        core_plain = cuda_ms(torch, lambda: KM.mvau_int_conv_plain(
            x4i, w, t, 3, 1, 1), reps=3)
        core_bound = max((4 * x4i.numel() + w.numel() + 4 * t.numel()
                          + 4 * m * n) / PEAK_BYTES_PER_S,
                         2 * m * k * n / PEAK_INT32_OPS) * 1e3
        plain = cuda_ms(torch, lambda: KM.mvau_int_conv_plain(x4, w, t, 3, 1, 1),
                        reps=10)
        lib = cuda_ms(torch, lib_int)
        lib2 = cuda_ms(torch, lib_im2col)
        # the conv form reads the int8 activation, the GEMM form its patches
        nbytes = x4.numel() + w.numel() + 4 * t.numel() + 4 * m * n
        gemm_bytes = x.numel() + w.numel() + 4 * t.numel() + 4 * m * n
        ops = 2 * m * k * n
        for i, v in enumerate((ms, plain, lib, nbytes, ops)):
            tot["mvau_int"][i] += v
        conv["layer_ms"].append(ms)
        for key, v in (("gemm_form_ms", gemm_ms), ("gemm_form_bytes", gemm_bytes),
                       ("library_im2col_ms", lib2),
                       ("int32_codes_cuda_core_ms", core_ms),
                       ("int32_codes_plain_ms", core_plain),
                       ("int32_codes_bound_ms", core_bound)):
            conv[key] += v
        rows.append(("mvau_int", name, m, k, n, ms, plain, lib,
                     max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3,
                     f" gemm_form_ms={gemm_ms:.4f} gemm_form_bound_ms="
                     f"{max(gemm_bytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3:.4f}"
                     f" library_im2col_ms={lib2:.4f} splits="
                     f"{KM.tc_splits(m, n, k, sms)}; int32 codes (CUDA cores, "
                     f"conv form): kernel_ms={core_ms:.4f} plain_ms="
                     f"{core_plain:.4f} bound_ms={core_bound:.4f} library_ms="
                     "none"))

        # float MVAU: the CUDA-core kernel in conv form on the float32 NHWC
        # activation; the plain version and the library on patch rows
        x4f = (x4.float() * 0.25).contiguous()
        xf = (x.float() * 0.25).contiguous()
        wf = (w.float() / 32).contiguous()
        tf = (t.float() / 128).contiguous()

        # on the grid: every partial sum exact -> bit for bit
        want = KM.mvau_plain(xf, wf, tf, 0.0, 0.25, 0.0)
        for got in (KM.mvau_conv(x4f, wf, tf, 3, 1, 1, 0.0, 0.25, 0.0
                                 ).reshape(m, n),
                    KM.mvau(xf, wf, tf, 0.0, 0.25, 0.0)):
            d = (got - want).abs().max().item()
            err["mvau"] = max(err["mvau"], float(d))
            check(torch.equal(got, want), f"mvau {name} at the main path's "
                  f"shape differs by {d}")

        def lib_f32():
            return quant_count(torch.matmul(xf, wf), tf)

        def quant_count(acc, tt):
            return 0.25 * ref.threshold_counts_fast(acc, tt).to(torch.float32)

        check(torch.equal(lib_f32(), want), f"{name}: the float yardstick "
              "computes another function")
        ms = cuda_ms(torch, lambda: KM.mvau_conv(x4f, wf, tf, 3, 1, 1, 0.0,
                                                 0.25, 0.0))
        gemm_f = cuda_ms(torch, lambda: KM.mvau(xf, wf, tf, 0.0, 0.25, 0.0))
        plain = cuda_ms(torch, lambda: KM.mvau_conv_plain(x4f, wf, tf, 3, 1, 1,
                                                          0.0, 0.25, 0.0),
                        reps=10)
        lib = cuda_ms(torch, lib_f32)
        mm = cuda_ms(torch, lambda: torch.matmul(xf, wf))
        nbytes = 4 * (x4f.numel() + wf.numel() + tf.numel() + m * n)
        bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS) * 1e3
        for i, v in enumerate((ms, plain, lib, nbytes, ops)):
            tot["mvau"][i] += v
        flt["matmul_only_ms"] += mm
        flt["gemm_form_ms"] += gemm_f
        flt["layers"].append({"layer": name, "ms": ms, "plain_ms": plain,
                              "library_ms": lib, "matmul_only_ms": mm,
                              "bound_ms": bound})
        rows.append(("mvau", name, m, k, n, ms, plain, lib, bound,
                     f" matmul_only_ms={mm:.4f} gemm_form_ms={gemm_f:.4f} "
                     f"splits={KM.core_splits(m, n, k, sms)}"))

    for r in rows:
        log(f"kernel {r[0]:8s} {r[1]:4s} M={r[2]:6d} K={r[3]:5d} N={r[4]:4d}: "
            f"kernel_ms={r[5]:.4f} plain_ms={r[6]:.4f} library_ms={r[7]:.4f} "
            f"bound_ms={r[8]:.4f}{r[9]}")
    i_ops = tot["mvau_int"][4]
    conv["gemm_form_bound_ms"] = max(conv["gemm_form_bytes"] / PEAK_BYTES_PER_S,
                                     i_ops / PEAK_INT8_OPS) * 1e3
    log(f"kernel mvau_int sum over the 8 layers at batch {BATCH}: conv form "
        f"{tot['mvau_int'][0]:.4f} ms (bound "
        f"{max(tot['mvau_int'][3] / PEAK_BYTES_PER_S, i_ops / PEAK_INT8_OPS) * 1e3:.4f}"
        f" ms: {tot['mvau_int'][3]} bytes of int8 NHWC codes, weights, tables "
        f"and int32 codes; {i_ops} operations); GEMM form on pre-built patches "
        f"{conv['gemm_form_ms']:.4f} ms (bound {conv['gemm_form_bound_ms']:.4f} "
        f"ms); int32-code route (CUDA cores, conv form) "
        f"{conv['int32_codes_cuda_core_ms']:.4f} ms (bound "
        f"{conv['int32_codes_bound_ms']:.4f} ms at the int32 rate, plain "
        f"{conv['int32_codes_plain_ms']:.4f} ms, no library call); "
        f"torch._int_mm + count {tot['mvau_int'][2]:.4f} ms on pre-built "
        f"patches, {conv['library_im2col_ms']:.4f} ms with the unfold im2col")
    f_ms, f_lib = tot["mvau"][0], tot["mvau"][2]
    f_bound = max(tot["mvau"][3] / PEAK_BYTES_PER_S,
                  tot["mvau"][4] / PEAK_F32_OPS) * 1e3
    over = [r["layer"] for r in flt["layers"] if r["ms"] > r["library_ms"]]
    log(f"kernel mvau (float, CUDA cores, conv form) sum over the 8 layers at "
        f"batch {BATCH}: {f_ms:.4f} ms, {f_bound / f_ms:.1%} of the FFMA "
        f"bound {f_bound:.4f} ms (goal <= 1.2 ms: "
        f"{'met' if f_ms <= 1.2 else 'missed'}); GEMM form on pre-built "
        f"patches {flt['gemm_form_ms']:.4f} ms; torch.matmul + count "
        f"{f_lib:.4f} ms, torch.matmul alone {flt['matmul_only_ms']:.4f} ms; "
        f"layers above their library_ms: {over or 'none'}")

    # GlobalAccPool with the residual add folded in, as the f32 artifact
    # and the wide-code route run it: two (64, 4, 4, 512) operands
    xg = torch.randint(0, 64, (BATCH, 4, 4, 8 * WIDTH),
                       generator=gen).to(torch.int32).to(dev)
    sg = torch.randint(0, 64, (BATCH, 4, 4, 8 * WIDTH),
                       generator=gen).to(torch.int32).to(dev)
    xgf, sgf = ((v.float() * 0.25).contiguous() for v in (xg, sg))  # grid
    for xx, ss in ((xg, sg), (xgf, sgf)):
        for got, want in ((KG.gap(xx, ss), KG.gap_plain(xx, ss)),
                          (KG.gap(xx), KG.gap_plain(xx))):
            d = (got - want).abs().max().item()
            err["gap"] = max(err["gap"], float(d))
            check(got.dtype == want.dtype and torch.equal(got, want),
                  f"gap {xx.dtype} at the main path's shape differs by {d}")
    g_ms = cuda_ms(torch, lambda: KG.gap(xg, sg), reps=100)
    g_plain = cuda_ms(torch, lambda: KG.gap_plain(xg, sg), reps=100)
    g_lib = cuda_ms(torch, lambda: torch.sum(torch.add(xg, sg), dim=(1, 2),
                                             dtype=torch.int32), reps=100)
    g_bytes = 8 * xg.numel() + 4 * BATCH * 8 * WIDTH
    g_ops = 2 * xg.numel()
    gf_ms = cuda_ms(torch, lambda: KG.gap(xgf, sgf), reps=100)
    g1_ms = cuda_ms(torch, lambda: KG.gap(xg), reps=100)
    g1_lib = cuda_ms(torch, lambda: torch.sum(xg, dim=(1, 2),
                                              dtype=torch.int32), reps=100)
    log(f"kernel gap      (64,4,4,512) int32 + skip: kernel_ms={g_ms:.4f} "
        f"plain_ms={g_plain:.4f} library_ms={g_lib:.4f} (torch.add + "
        f"torch.sum) bound_ms={g_bytes / PEAK_BYTES_PER_S * 1e3:.5f}; float32 "
        f"operands: kernel_ms={gf_ms:.4f}; one int32 operand (no skip): "
        f"kernel_ms={g1_ms:.4f} library_ms={g1_lib:.4f} (torch.sum) bound_ms="
        f"{(4 * xg.numel() + 4 * BATCH * 8 * WIDTH) / PEAK_BYTES_PER_S * 1e3:.5f}")
    fused = time_fused_gap(torch, KM, KG, ref, gen, err)

    def entry(name, source, replaces, t, ops_peak, **extra):
        ms, plain, lib, nbytes, ops = t
        b_ms, o_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / ops_peak * 1e3
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0,
                "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "library_ms": lib, **extra}

    return [
        entry("mvau_int", "src/repro_torch/csrc/mvau.cu",
              "src/repro/kernels/mvau.py:195", tot["mvau_int"], PEAK_INT8_OPS,
              form="conv (implicit GEMM on int8 NHWC codes, wgmma)",
              gemm_form_ms=conv["gemm_form_ms"],
              gemm_form_bound_ms=conv["gemm_form_bound_ms"],
              library_im2col_ms=conv["library_im2col_ms"],
              int32_codes_cuda_core_ms=conv["int32_codes_cuda_core_ms"],
              int32_codes_plain_ms=conv["int32_codes_plain_ms"],
              int32_codes_bound_ms=conv["int32_codes_bound_ms"],
              layer_ms=conv["layer_ms"]),
        entry("mvau", "src/repro_torch/csrc/mvau.cu",
              "src/repro/kernels/mvau.py:140", tot["mvau"], PEAK_F32_OPS,
              form="conv (implicit GEMM on float32 NHWC, register-tiled "
                   "FFMA on the CUDA cores)",
              layer_ms=flt["layers"], matmul_only_ms=flt["matmul_only_ms"],
              gemm_form_ms=flt["gemm_form_ms"]),
        entry("gap", "src/repro_torch/csrc/gap.cu",
              "src/repro/kernels/gap.py:41",
              [g_ms, g_plain, g_lib, g_bytes, g_ops], PEAK_INT32_OPS,
              form="residual add folded in: (64, 4, 4, 512) int32 + skip",
              float32_ms=gf_ms, no_skip_ms=g1_ms, no_skip_library_ms=g1_lib),
        entry("mvau_int_gap", "src/repro_torch/csrc/mvau.cu",
              "src/repro/kernels/gap.py:41", fused.pop("t"), PEAK_INT8_OPS,
              **fused),
    ]


def time_fused_gap(torch, KM, KG, ref, gen, err):
    """r2b's tail at batch 64 (int8 4x4x512 codes, K 4608, N 512, plus an
    int32 skip): the conv MVAU with the GAP epilogue, the same conv alone,
    and the unfused chain (conv, torch add, GAP kernel), in one interleaved
    series.  The entry is the whole fused function: its bound counts the
    conv's operands read once, the skip read once and the (64, 512) sums
    written once, against its int8 operations; its plain version is
    ``mvau_int_conv_gap_plain`` and its library yardstick ``torch._int_mm``
    on unfolded patches, the threshold count, ``torch.add`` and
    ``torch.sum``."""
    dev = "cuda"
    c = n = 8 * WIDTH
    x = torch.randint(0, 16, (BATCH, 4, 4, c), generator=gen
                      ).to(torch.int8).to(dev)
    w = torch.randint(-32, 32, (9 * c, n), generator=gen).to(torch.int8).to(dev)
    t = torch.sort(torch.randint(-2000, 2000, (n, 15), generator=gen),
                   dim=1).values.to(torch.int32).to(dev)
    skip = torch.randint(0, 16, (BATCH, 4, 4, n), generator=gen
                         ).to(torch.int32).to(dev)
    y = KM.mvau_int_conv(x, w, t, 3, 1, 1)
    got = KM.mvau_int_conv_gap(x, w, t, skip, 3, 1, 1)
    want = KG.gap_plain(y, skip)
    d = (got - want).abs().max().item()
    err["mvau_int_gap"] = max(err["mvau_int_gap"], float(d))
    check(torch.equal(got, want), f"fused r2b tail at batch {BATCH} differs "
          f"by {d}")

    def lib():
        acc = torch._int_mm(im2col_unfold(torch, x, 3, 1, 1), w)
        codes = ref.threshold_counts_fast(acc, t).reshape(y.shape)
        return torch.sum(torch.add(codes, skip), dim=(1, 2),
                         dtype=torch.int32)

    check(torch.equal(lib(), want), "the fused tail's yardstick computes "
          "another function")
    runs = {"fused": lambda: KM.mvau_int_conv_gap(x, w, t, skip, 3, 1, 1),
            "conv": lambda: KM.mvau_int_conv(x, w, t, 3, 1, 1),
            "chain": lambda: KG.gap(KM.mvau_int_conv(x, w, t, 3, 1, 1) + skip)}
    # a sleep long enough that a slow host enqueues every launch of the
    # chain (3 a call) and of the library (about 35) before the first runs
    sleep = 8 * SLEEP_CYCLES
    each = {k: [] for k in runs}
    for order in (("conv", "fused", "chain"), ("chain", "fused", "conv")):
        for k in order:
            each[k].append(cuda_ms(torch, runs[k], reps=100,
                                   sleep_cycles=sleep))
    ms = {k: sum(v) / len(v) for k, v in each.items()}
    plain = cuda_ms(torch, lambda: KM.mvau_int_conv_gap_plain(
        x, w, t, skip, 3, 1, 1), reps=3)
    lib_ms = cuda_ms(torch, lib, reps=20, sleep_cycles=sleep)
    nbytes = (x.numel() + w.numel() + 4 * t.numel() + 4 * skip.numel()
              + 4 * BATCH * n)
    ops = 2 * BATCH * 16 * 9 * c * n
    log(f"kernel mvau_int_gap r2b M={BATCH * 16} K={9 * c} N={n} (conv MVAU "
        f"with the residual add and GAP in its epilogue): kernel_ms="
        f"{ms['fused']:.4f} plain_ms={plain:.4f} library_ms={lib_ms:.4f} "
        f"(torch._int_mm + count + torch.add + torch.sum) bound_ms="
        f"{max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3:.5f} "
        f"({nbytes} bytes, {ops} int8 ops); before, the conv alone "
        f"{ms['conv']:.4f} and the unfused chain {ms['chain']:.4f} (conv + "
        f"torch add + gap kernel); the two runs of each: "
        + ", ".join(f"{k} {' / '.join(f'{v:.4f}' for v in vs)}"
                    for k, vs in each.items()))
    return {"t": [ms["fused"], plain, lib_ms, nbytes, ops],
            "form": "GAP epilogue of mvau_conv_kernel (r2b, batch 64): the "
                    "conv MVAU, the residual add and the spatial sum",
            "conv_alone_ms": ms["conv"], "unfused_chain_ms": ms["chain"]}


PROFILE_READS = 3


def traced_steps():
    """``torch.profiler.profile`` arguments for a traced run in two steps:
    a warm-up step whose events are dropped, then the step that is read.
    Started cold, the tracer has lost the first kernels of a run (a f32
    forward once read 9 kernels of its 14)."""
    from torch.profiler import ProfilerActivity, schedule

    return {"activities": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
            "schedule": schedule(wait=0, warmup=1, active=1, repeat=1)}


def profile_forward(torch, label: str, fn, reps: int = 5,
                    batch: int = BATCH, unit: str = "forward", top: int = 0):
    """Device time by kernel over ``reps`` calls of ``fn`` (a forward at
    batch 64, or a training step; torch.profiler, CUDA activity), the
    ``top`` largest kernels printed (all with 0); returns the device-busy
    ms per call (None when the profiler saw no device time) and the
    kernels' profiler events.  The profiler's own host cost stretches the
    traced run's wall time, so the busy share printed here is a floor.

    Every call of ``fn`` launches the same kernels, so each kernel's count
    is a multiple of ``reps``; a read where one is not has lost events in
    the tracer (a replayed int forward once read 22.4 kernels of its 27)
    and is traced again, at most PROFILE_READS times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    for read in range(1, PROFILE_READS + 1):
        with profile(**traced_steps()) as prof:
            fn()                      # warm-up step: its events are dropped
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")]   # the step's span
        torn = [e.key[:60] for e in kern if e.count % reps]
        if not torn:
            break
        log(f"profile {label}: read {read} lost events in the tracer "
            f"({len(torn)} kernels with counts not a multiple of {reps}, "
            f"e.g. {torn[0]})" + (", traced again" if read < PROFILE_READS
                                  else ""))
    busy_us = sum(e.device_time_total for e in kern)
    if busy_us <= 0:
        log(f"profile {label}: device time not measured (no CUDA events)")
        return None, kern
    log(f"profile {label} (batch {batch}, {reps} {unit}s): traced wall "
        f"{wall_us / reps / 1e3:.3f} ms/{unit}, device busy "
        f"{busy_us / reps / 1e3:.3f} ms/{unit} ({busy_us / wall_us:.1%}), "
        f"{sum(e.count for e in kern) / reps:.0f} kernels/{unit}")
    ranked = sorted(kern, key=lambda e: -e.device_time_total)
    for e in ranked[:top] if top else ranked:
        log(f"  {e.device_time_total / reps / 1e3:8.4f} ms/{unit} "
            f"{e.count / reps:5.1f}x  {e.key[:90]}")
    return busy_us / reps / 1e3, kern


# ---------------------------------------------------------------------------
# Phases 3-4: the main path
# ---------------------------------------------------------------------------
def main_path(torch, np, B):
    import repro_torch
    from repro_torch.core.graph import execute
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.fsl.pipeline import FSLPipeline
    from repro_torch.models import resnet9
    from repro_torch.serve.store import PrototypeStore

    qcfg = QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), WIDTH,
                                 device="cuda")
    params_cpu = {k: {kk: v.cpu() for kk, v in blk.items()}
                  for k, blk in params.items()}
    data = SyntheticImages(n_base=32, n_novel=10, seed=0, img=IMG)
    rng = np.random.default_rng(0)
    x_np, _ = data.batch(rng.integers(0, 42, BATCH),
                         rng.integers(0, 10_000, BATCH))
    x = torch.from_numpy(x_np).cuda()
    x_q = fake_quant(x, qcfg.act)

    t0 = time.perf_counter()
    dm_int = repro_torch.compile(params, qcfg, recipe="resnet9",
                                 datapath="int", device="cuda")
    t1 = time.perf_counter()
    dm_f32 = repro_torch.compile(params, qcfg, recipe="resnet9",
                                 datapath="f32", device="cuda")
    t2 = time.perf_counter()
    log(f"compile: int {t1 - t0:.3f} s, f32 {t2 - t1:.3f} s (width {WIDTH})")
    ops = dm_int.op_counts()
    log(f"int artifact: {len(dm_int.graph.nodes)} nodes {ops}; "
        f"dispatch {sorted({r['kernel'] for r in dm_int.dispatch_table()})}")
    check(ops.get("mvau_int") == 8 and ops.get("global_acc_pool") == 1,
          f"int artifact ops {ops}")
    check(all(r["kernel"] == "fused-cuda" for r in dm_int.dispatch_table()
              if r["op"] in ("mvau_int", "im2col", "global_acc_pool")
              or r["tensor"] == "r2b_res"),
          "an mvau_int node is not on the kernel, an im2col not folded, or "
          "the GAP tail not fused")
    check(len(dm_int.apply.folded) == 10
          and {"r2b_mt_nchw_nhwc_0", "r2b_res"} <= set(dm_int.apply.folded),
          f"folded {dm_int.apply.folded}")
    check(dm_int.weight_bytes() == INT_WEIGHT_BYTES,
          f"int weight bytes {dm_int.weight_bytes()}")
    check(dm_f32.weight_bytes() == F32_WEIGHT_BYTES,
          f"f32 weight bytes {dm_f32.weight_bytes()}")
    check(all(r["kernel"] == "cuda" for r in dm_f32.dispatch_table()
              if r["op"] in ("mvau", "im2col", "global_acc_pool")
              or r["tensor"] == "r2b_res")
          and len(dm_f32.apply.folded) == 9 and "r2b_res" in dm_f32.apply.folded,
          "an f32 mvau node is not on the kernel, an im2col not folded, or "
          "the residual add not folded into the GAP")
    log(f"weight bytes: int {dm_int.weight_bytes()} f32 "
        f"{dm_f32.weight_bytes()}")

    def delta(fn):
        before = dict(B.launch_counts)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: B.launch_counts[k] - before[k] for k in before}

    f_int, d = delta(lambda: dm_int(x))
    check(d == {"mvau_int": 8, "mvau_int_gap": 1, "mvau_int_wide": 0,
                "mvau": 0, "gap": 0, "qmatmul": 0},
          f"int forward launches {d}")
    f_f32, d = delta(lambda: dm_f32(x_q))
    check(d == {"mvau_int": 0, "mvau_int_gap": 0, "mvau_int_wide": 0,
                "mvau": 8, "gap": 1, "qmatmul": 0},
          f"f32 forward launches {d}")
    (f_interp,), d = delta(lambda: execute(dm_f32.graph, {"x": x_q}))
    check(d["mvau"] == 8, f"interpreter launches {d}")
    (f_interp_int,) = execute(dm_int.graph, {"x": x})
    check(f_int.dtype == torch.float32 and tuple(f_int.shape) == (BATCH, 512),
          f"features {f_int.dtype} {tuple(f_int.shape)}")
    check(bool(torch.isfinite(f_int).all()), "non-finite features")
    check(torch.equal(f_int, f_f32), "int features != f32 features")
    check(torch.equal(f_int, f_interp), "int features != interpreter (f32 graph)")
    check(torch.equal(f_int, f_interp_int), "int features != interpreter "
          "(int graph, plain versions)")
    dm_cpu = repro_torch.compile(params_cpu, qcfg, recipe="resnet9",
                                 datapath="int", device="cpu")
    f_cpu = dm_cpu(x_np)
    check(torch.equal(f_int.cpu(), f_cpu), "card features != CPU features")
    log("main path: int == f32 == interpreter on the card, card == CPU, "
        "bit for bit")
    # the int artifact lowered without either GAP fold (the add and the GAP
    # as launches of their own, as before the fused tail): the "before" of
    # this run's latency and profile; its launches are not the path's
    saved = dict(B.launch_counts)
    unfused = unfused_lowering(dm_int)
    f_unf, d = delta(lambda: unfused(x))
    check(d == {"mvau_int": 8, "mvau_int_gap": 0, "mvau_int_wide": 0,
                "mvau": 0, "gap": 1, "qmatmul": 0}
          and torch.equal(f_unf, f_int),
          f"unfused int forward: launches {d}, or features differ")
    B.launch_counts.update(saved)

    pipe = FSLPipeline(width=WIDTH, qcfg=qcfg, device="cuda")
    feats = pipe.deploy(params, datapath="int")
    f_flip, d = delta(lambda: feats(x))
    check(d == {"mvau_int": 16, "mvau_int_gap": 2, "mvau_int_wide": 0,
                "mvau": 0, "gap": 0, "qmatmul": 0}, f"flip ensemble {d}")
    feats_f32 = pipe.deploy(params, datapath="f32")
    f_flip32, d = delta(lambda: feats_f32(x))
    check(d == {"mvau_int": 0, "mvau_int_gap": 0, "mvau_int_wide": 0,
                "mvau": 16, "gap": 2, "qmatmul": 0},
          f"f32 flip ensemble {d}")
    check(torch.equal(f_flip, f_flip32), "flip ensemble int != f32")
    check(torch.equal(f_flip, pipe.features(params, x)),
          "deployed flip features != QAT forward")
    log("launches per forward: int 8 mvau_int (1 with the GAP epilogue) + 0 "
        "gap, flip ensemble 16 (2) + 0; f32 8 mvau + 1 gap (residual add "
        "folded in), flip ensemble 16 + 2")

    # every latency is taken before the first traced run: once the profiler
    # has traced the card, later eager launches in the process run slower.
    # The unfused tail and the fused one alternate, twice.
    x1 = x[:1].contiguous()
    walls = {}
    saved = dict(B.launch_counts)
    for label, fn in (("int artifact, unfused tail (before)", unfused),
                      ("int artifact", dm_int), ("int flip ensemble", feats),
                      ("int artifact, unfused tail (before), again", unfused),
                      ("int artifact, again", dm_int)):
        b1 = wall_ms(torch, lambda: fn(x1), reps=50)
        b64 = walls[label] = wall_ms(torch, lambda: fn(x), reps=20)
        log(f"latency {label}: batch 1 {b1:.3f} ms, batch {BATCH} "
            f"{b64:.3f} ms ({BATCH / b64 * 1e3:.1f} images/s)")
        if "flip" not in label:
            # the device's own time: forwards queued behind a sleep, so
            # that no host gap falls inside
            dev = cuda_ms(torch, lambda: fn(x), reps=10,
                          sleep_cycles=QMM_SLEEP_CYCLES)
            log(f"device time {label}, batch {BATCH}, no host gaps (CUDA "
                f"events): {dev:.4f} ms/forward")
        if "unfused" in label:
            B.launch_counts.update(saved)     # not the path's launches
        saved = dict(B.launch_counts)
    b64_f32 = walls["f32 artifact"] = wall_ms(torch, lambda: dm_f32(x_q))
    log(f"latency f32 artifact (every im2col folded into the float conv "
        f"form): batch {BATCH} {b64_f32:.3f} ms "
        f"({BATCH / b64_f32 * 1e3:.1f} images/s)")

    # -- few-shot requests ---------------------------------------------------
    # the card's head against the same head on the CPU: row norms and the
    # similarity are float reductions in another order, so prototypes and
    # similarities agree within rtol 1e-5 / atol 1e-6 (as the CPU tests hold
    # the port against JAX) and predictions are equal
    pipe_cpu = FSLPipeline(width=WIDTH, qcfg=qcfg, device="cpu")
    feats_cpu = pipe_cpu.deploy(params_cpu, datapath="int")
    tol = dict(rtol=1e-5, atol=1e-6)
    ep_rng = np.random.default_rng(100)
    lat = {"register": [], "register_head": [], "classify": [],
           "classify_head": []}
    accs, worst = [], 0.0
    for _ in range(3):
        ep = data.episode(ep_rng, 5, 5, 15)
        stores = {"cuda": PrototypeStore(), "cpu": PrototypeStore(device="cpu")}
        check(stores["cuda"].device.type == "cuda", "store is not on the card")
        preds, sims = {}, {}
        for dev, fn in (("cuda", feats), ("cpu", feats_cpu)):
            store, out, ss = stores[dev], [], []
            for way in range(5):
                shots = ep["support_x"][ep["support_y"] == way]
                t0 = time.perf_counter()
                f = fn(shots)
                t1 = time.perf_counter()
                store.register(way, f)
                t2 = time.perf_counter()
                if dev == "cuda":
                    lat["register"].append((t2 - t0) * 1e3)
                    lat["register_head"].append((t2 - t1) * 1e3)
            for lo in range(0, len(ep["query_x"]), 15):
                t0 = time.perf_counter()
                f = fn(ep["query_x"][lo:lo + 15])
                t1 = time.perf_counter()
                ids, sim = store.classify(f)
                t2 = time.perf_counter()
                if dev == "cuda":
                    lat["classify"].append((t2 - t0) * 1e3)
                    lat["classify_head"].append((t2 - t1) * 1e3)
                out += ids
                ss.append(sim)
            preds[dev], sims[dev] = np.asarray(out), np.concatenate(ss)
        check(np.array_equal(preds["cuda"], preds["cpu"]),
              "few-shot predictions differ between card and CPU")
        p_gpu, p_cpu = (stores[d].prototypes()[0] for d in ("cuda", "cpu"))
        worst = max(worst, float(np.abs(p_gpu - p_cpu).max()),
                    float(np.abs(sims["cuda"] - sims["cpu"]).max()))
        check(np.allclose(p_gpu, p_cpu, **tol),
              "prototypes differ between card and CPU beyond rtol 1e-5")
        check(np.allclose(sims["cuda"], sims["cpu"], **tol),
              "similarities differ between card and CPU beyond rtol 1e-5")
        accs.append(float((preds["cuda"] == ep["query_y"]).mean()))
    med = {k: float(np.median(v)) for k, v in lat.items()}
    log(f"few-shot: 3 episodes 5-way 5-shot 15-query, accuracy {accs} "
        f"(random weights); register request (5 shots) median "
        f"{med['register']:.3f} ms, of which the store {med['register_head']:.3f}"
        f" ms; classify request (15 queries) median {med['classify']:.3f} ms, "
        f"of which the store {med['classify_head']:.3f} ms; head on the card; "
        f"predictions equal the CPU run's, prototypes and similarities within "
        f"{worst:.3g} of it")

    # -- where the device time goes (traced last; see above) ------------------
    # kernels a forward: the int artifact's tail is one launch (27, where
    # the unfused tail takes 29), the f32 artifact's add + GAP one (14)
    per_fwd = {"int artifact": 27, "f32 artifact": 14}
    saved = dict(B.launch_counts)
    for label, fn, xx in (("int artifact, unfused tail (before)", unfused, x),
                          ("int artifact", dm_int, x),
                          ("int flip ensemble", feats, x),
                          ("f32 artifact", dm_f32, x_q)):
        busy, kern = profile_forward(torch, label, lambda: fn(xx))
        if "unfused" in label:
            B.launch_counts.update(saved)     # not the path's launches
        # the folded forwards gather no patches: no indexing kernel runs
        # (the flip ensemble's one flip of the frames aside)
        gathers = [e.key for e in kern if "index" in e.key
                   and "flip" not in e.key]
        check(not gathers, f"{label}: a patch gather ran: {gathers}")
        n_kern = sum(e.count for e in kern) / 5
        adds = sum(e.count for e in kern if "add" in e.key.lower()) / 5
        log(f"profile {label}: {n_kern:.0f} kernels/forward, {adds:.0f} of "
            "them add kernels")
        if label in per_fwd:
            # one add kernel is left: r1b's residual add, before c2
            check(n_kern == per_fwd[label] and adds == 1,
                  f"{label}: {n_kern} kernels/forward, {adds} add kernels; "
                  f"expected {per_fwd[label]} and 1 (r1b's residual add)")
        if busy is not None:
            log(f"device busy share {label}, batch {BATCH}: estimate "
                f"{busy / walls[label]:.1%} = busy {busy:.3f} ms/forward "
                f"(traced run) / wall {walls[label]:.3f} ms/forward (untraced "
                "run above)")
    return dm_int, x


def unfused_lowering(dm):
    """The artifact with its graph lowered with neither GlobalAccPool fold:
    the residual add and the GAP run as launches of their own, as the
    lowering did before the fused tail (the "before" of the latency and
    profile comparison).  Every im2col stays folded."""
    import dataclasses

    from repro_torch.core.deploy import lower_graph

    return dataclasses.replace(
        dm, apply=lower_graph(dm.graph, "cuda", fold_pools=False))


# ---------------------------------------------------------------------------
# Phases 2b and 4b: CUDA graphs on the FSL path, and the serving engine
# ---------------------------------------------------------------------------
GRAPH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
ENGINE_REQUESTS = 1000          # classify requests of 1-4 frames, at least
ENGINE_THREADS = 4


def fsl_setup(torch, np, seed: int = 0):
    """w6a4 params at width 64 (``torch.Generator`` seed ``seed``, on the
    card) and main_path's batch-64 frames, raw and on the activation grid."""
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.models import resnet9

    qcfg = QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(seed), WIDTH,
                                 device="cuda")
    data = SyntheticImages(n_base=32, n_novel=10, seed=0, img=IMG)
    rng = np.random.default_rng(0)
    x_np, _ = data.batch(rng.integers(0, 42, BATCH),
                         rng.integers(0, 10_000, BATCH))
    x = torch.from_numpy(x_np).cuda()
    return qcfg, params, data, x, fake_quant(x, qcfg.act)


def graph_of(table, x):
    """The captured graph a table replays for input ``x``."""
    return table.graphs[table.key((x,))]


def sync_ms(torch, fn, reps: int = 50) -> float:
    """Mean host wall-clock of ``fn`` with the device synchronized after
    EVERY call: what one request waits for its result."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def fsl_graph_path(torch, np, B):
    """Every warmed bucket (1 to 64) of the width-64 int and f32 artifacts
    and of both flip ensembles, each captured as one CUDA graph: the replay
    equals the eager run of the same function bit for bit; int == f32 ==
    interpreter through the replays; then latency at batch 1 and 64,
    replayed and eager.  No profiler runs here (main_path's note: a traced
    card slows later eager launches); returns what ``profile_fsl_graphs``
    traces.  The launches here are no path's: the counts are restored."""
    import repro_torch
    from repro_torch.core.graph import execute
    from repro_torch.fsl.pipeline import FSLPipeline

    saved = dict(B.launch_counts)
    qcfg, params, _, x, x_q = fsl_setup(torch, np)
    dms = {dp: repro_torch.compile(params, qcfg, recipe="resnet9",
                                   datapath=dp, device="cuda")
           for dp in ("int", "f32")}
    pipe = FSLPipeline(width=WIDTH, qcfg=qcfg, device="cuda")
    ens = {dp: pipe.deploy(params, datapath=dp) for dp in ("int", "f32")}
    feeds = {"int": x, "f32": x_q}
    secs = {}
    for dp in ("int", "f32"):
        t0 = time.perf_counter()
        dms[dp].warmup(GRAPH_BUCKETS, x[:1])
        t1 = time.perf_counter()
        ens[dp].warmup(GRAPH_BUCKETS, img=IMG)
        secs[dp] = (t1 - t0, time.perf_counter() - t1)
        check(dms[dp].trace_count == len(GRAPH_BUCKETS)
              and ens[dp].trace_count() == len(GRAPH_BUCKETS),
              f"{dp}: {dms[dp].trace_count} / {ens[dp].trace_count()} "
              "captures after warmup")
    traces = {dp: (dms[dp].trace_count, ens[dp].trace_count())
              for dp in dms}
    for b in GRAPH_BUCKETS:
        got = {}
        for dp in ("int", "f32"):
            xb = feeds[dp][:b]
            got[dp] = dms[dp].batched(xb)
            (want,) = dms[dp].apply(xb)
            check(torch.equal(got[dp], want),
                  f"{dp} artifact, bucket {b}: replay != eager")
            fe = ens[dp](x[:b])
            check(torch.equal(fe, ens[dp]._exec.fn(x[:b])),
                  f"{dp} flip ensemble, bucket {b}: replay != eager")
            got[dp, "flip"] = fe
        check(torch.equal(got["int"], got["f32"])
              and torch.equal(got["int", "flip"], got["f32", "flip"]),
              f"bucket {b}: replayed int != replayed f32")
    (interp,) = execute(dms["f32"].graph, {"x": x_q})
    check(torch.equal(dms["int"].batched(x), interp),
          "replayed int != interpreter")
    check(traces == {dp: (dms[dp].trace_count, ens[dp].trace_count())
                     for dp in dms}, "a capture after warmup")
    want = {"int": {"mvau_int": 8, "mvau_int_gap": 1},
            "f32": {"mvau": 8, "gap": 1}}
    for dp in ("int", "f32"):
        g, ge = graph_of(dms[dp]._exec, x), graph_of(ens[dp]._exec, x)
        check(g.launches == want[dp]
              and ge.launches == {k: 2 * v for k, v in want[dp].items()},
              f"{dp}: graph launches {g.launches}, ensemble {ge.launches}")
        pool = sum(gg.pool_bytes for gg in dms[dp]._exec.graphs.values())
        pool_e = sum(gg.pool_bytes for gg in ens[dp]._exec.graphs.values())
        log(f"graphs {dp}: {len(GRAPH_BUCKETS)} buckets captured in "
            f"{secs[dp][0]:.3f} s (artifact) and {secs[dp][1]:.3f} s (flip "
            f"ensemble), 3 eager warm-up runs each; graph pools reserved "
            f"{pool} and {pool_e} bytes; batch-{BATCH} graph launches "
            f"{g.launches}, ensemble {ge.launches}")
    log(f"graphs: every bucket {GRAPH_BUCKETS} of the int and f32 artifacts "
        "and flip ensembles replays the eager result bit for bit; int == f32 "
        "== interpreter through the replays; no capture after warmup")
    # latency: eager, replay, eager, replay, at batch 1 and 64
    runs = (("int artifact", dms["int"].batched, dms["int"].apply, x,
             dms["int"]._exec),
            ("f32 artifact", dms["f32"].batched, dms["f32"].apply, x_q,
             dms["f32"]._exec),
            ("int flip ensemble", ens["int"], ens["int"]._exec.fn, x,
             ens["int"]._exec))
    lat = {}
    for label, replay, eager, xx, table in runs:
        for b in (1, BATCH):
            xb = xx[:b].contiguous()
            for mode, fn in (("eager", eager), ("replay", replay)) * 2:
                lat.setdefault((label, b, mode), []).append(
                    (wall_ms(torch, lambda: fn(xb), reps=50),
                     sync_ms(torch, lambda: fn(xb), reps=50)))
        dev = cuda_ms(torch, graph_of(table, xx).replay, reps=10,
                      sleep_cycles=QMM_SLEEP_CYCLES)
        lat[label, "graph_device_ms"] = dev
        log(f"device time {label} graph, batch {BATCH}, replays queued "
            f"behind a sleep (CUDA events): {dev:.4f} ms/replay")
    for (label, *rest), v in sorted(lat.items(), key=str):
        if len(rest) == 2:
            b, mode = rest
            log(f"latency {label} batch {b} {mode}: back to back "
                f"{', '.join(f'{w:.3f}' for w, _ in v)} ms/call; synchronized "
                f"per call {', '.join(f'{s:.3f}' for _, s in v)} ms")
    B.launch_counts.update(saved)
    return {"dms": dms, "ens": ens, "x": x, "x_q": x_q, "lat": lat,
            "runs": runs}


def profile_fsl_graphs(torch, B, state):
    """The batch-64 int graph replayed under ``torch.profiler``: the same 27
    kernels as the eager forward, 8 of them ``mvau_conv_kernel``; then
    device busy per call beside the latency of ``fsl_graph_path``, replayed
    and eager, at batch 1 and 64.  The launches are no path's."""
    saved = dict(B.launch_counts)
    g = graph_of(state["dms"]["int"]._exec, state["x"])
    busy, kern = profile_forward(torch, "int artifact graph replay", g.replay)
    if busy is not None:
        n_kern = sum(e.count for e in kern) / 5
        n_conv = sum(e.count for e in kern if "mvau_conv_kernel" in e.key) / 5
        check(n_kern == 27 and n_conv == 8,
              f"replayed int forward: {n_kern} kernels, {n_conv} "
              "mvau_conv_kernel; expected 27 and 8 (the eager forward's)")
        log(f"profile int graph replay: {n_kern:.0f} kernels/replay, "
            f"{n_conv:.0f} mvau_conv_kernel, as the eager forward")
    lat = state["lat"]
    for label, replay, eager, xx, _ in state["runs"]:
        for b in (1, BATCH):
            xb = xx[:b].contiguous()
            for mode, fn in (("eager", eager), ("replay", replay)):
                busy, _ = profile_forward(torch, f"{label} {mode}",
                                          lambda: fn(xb), batch=b)
                walls = [w for w, _ in lat[label, b, mode]]
                syncs = [s for _, s in lat[label, b, mode]]
                log(f"fsl {label} batch {b} {mode}: back to back "
                    f"{min(walls):.3f} ms/call, synchronized "
                    f"{min(syncs):.3f} ms/call (best of 2), device busy "
                    + ("not measured" if busy is None else
                       f"{busy:.4f} ms/call ({busy / min(walls):.1%} of the "
                       "back-to-back call)"))
    B.launch_counts.update(saved)


def engine_phase(torch, np, B):
    """The port's ServeEngine on the card: the w6a4 int and f32 artifacts
    at width 64 in an ArtifactRegistry, warmed with max_batch 64 (7 CUDA
    graphs each); 5-way 5-shot registers on both, then classify requests of
    1-4 frames from 4 submitter threads: half of them, the registry default
    hot-swapped to the f32 artifact, more while a third artifact (other
    weights) is captured beside the worker's replays, then the other half.
    Checks: no capture after warmup, nothing rejected or failed, mean batch
    > 1, prototypes bit for bit and predictions equal to an offline
    recompute through the same feats, and every kernel launch of the
    traffic a graph replay (the third artifact's eager warm-up runs
    aside).  Then a traced window of the same traffic for the device's busy
    share.  Returns the replays' launch counts (path ``fsl_serve``)."""
    import threading

    from repro_torch.core.cudagraph import WARM_RUNS
    from repro_torch.fsl import ncm
    from repro_torch.fsl.pipeline import FSLPipeline
    from repro_torch.serve import (ArtifactRegistry, PrototypeStore,
                                   ServeEngine, pad_to_bucket)

    qcfg, params, data, _, _ = fsl_setup(torch, np)
    pipe = FSLPipeline(width=WIDTH, qcfg=qcfg, device="cuda")
    reg = ArtifactRegistry()
    reg.register("w6a4-int", pipe.deploy(params, datapath="int"),
                 default=True)
    reg.register("f32", pipe.deploy(params, datapath="f32"))
    rng = np.random.default_rng(7)
    ep = data.episode(rng, 5, 5, 120)
    shots = {w: ep["support_x"][ep["support_y"] == w] for w in range(5)}
    pool = ep["query_x"]

    def request():
        n = int(rng.integers(1, 5))
        return pool[rng.integers(0, len(pool), n)]

    plan = [request() for _ in range(ENGINE_REQUESTS)]
    fillers = [request() for _ in range(ENGINE_REQUESTS)]
    eng = ServeEngine(reg, max_batch=64, max_queue=512, batch_wait_ms=2.0)
    try:
        t0 = time.perf_counter()
        base = eng.warmup(img=IMG)
        warm_s = time.perf_counter() - t0
        check(base == {"w6a4-int": 7, "f32": 7},
              f"captures after engine warmup {base}")
        for name in ("w6a4-int", "f32"):
            for w, x in shots.items():
                eng.submit_register(w, x, artifact=name).result(120)
        tables = {n: reg.get(n).feats._exec for n in reg.names()}
        start = {id(g): g.replays for t in tables.values()
                 for g in t.graphs.values()}
        B.reset_launch_counts()
        eng.metrics.reset_clock()
        results = {}              # request index -> (frames, result)
        errors = []
        half = threading.Barrier(ENGINE_THREADS + 1)
        warmed = threading.Event()

        def ask(i, x):
            results[i] = (x, eng.submit_classify(x, timeout=60).result(120))

        def client(tid):
            # closed loop: one request in flight per client
            try:
                for i in range(tid, ENGINE_REQUESTS // 2, ENGINE_THREADS):
                    ask(i, plan[i])
                half.wait()
                j = tid
                while not warmed.is_set() and j < len(fillers):
                    ask(ENGINE_REQUESTS + j, fillers[j])
                    j += ENGINE_THREADS
                for i in range(ENGINE_REQUESTS // 2 + tid, ENGINE_REQUESTS,
                               ENGINE_THREADS):
                    ask(i, plan[i])
            except Exception as e:                    # noqa: BLE001
                errors.append(repr(e))
                half.abort()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(ENGINE_THREADS)]
        for t in threads:
            t.start()
        half.wait()
        reg.set_default("f32")                       # hot swap
        feats3 = FSLPipeline(width=WIDTH, qcfg=qcfg, device="cuda").deploy(
            fsl_setup(torch, np, seed=1)[1], datapath="int")
        reg.register("w6a4-int-v2", feats3)
        t3 = time.perf_counter()
        reg.get("w6a4-int-v2").warmup(eng.buckets, img=IMG,
                                      metrics=eng.metrics)
        warm3_s = time.perf_counter() - t3
        served_while = len(results)
        warmed.set()
        for t in threads:
            t.join()
        check(not errors, f"engine clients failed: {errors[:3]}")
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        for w, x in shots.items():
            eng.submit_register(w, x, artifact="w6a4-int-v2").result(120)
        v2 = [eng.submit_classify(plan[i], artifact="w6a4-int-v2")
              for i in range(32)]
        v2 = [(plan[i], f.result(120)) for i, f in enumerate(v2)]
        counts = dict(B.launch_counts)
        tables["w6a4-int-v2"] = feats3._exec
        traces = eng.trace_counts()
    finally:
        eng.stop()
    check(traces == {**base, "w6a4-int-v2": 7},
          f"captures after warmup: {traces}, expected {base} + 7")
    n_req = len(results)
    check(snap["completed"] == n_req and snap["rejected"] == 0
          and snap["failed"] == 0,
          f"engine: {snap['completed']} of {n_req} served, "
          f"{snap['rejected']} rejected, {snap['failed']} failed")
    check(snap["mean_batch"] > 1, f"mean batch {snap['mean_batch']}")
    by_art = {}
    for _, r in results.values():
        by_art[r.artifact] = by_art.get(r.artifact, 0) + 1
    check(set(by_art) == {"w6a4-int", "f32"},
          f"requests by artifact {by_art}: the hot swap did not land")
    # every launch of the traffic was a replay, but the eager warm-up runs
    # of the third artifact's captures
    replayed = {k: 0 for k in counts}
    for t in tables.values():
        for g in t.graphs.values():
            for k, v in g.launches.items():
                replayed[k] += v * (g.replays - start.get(id(g), 0))
    warm3 = {k: 0 for k in counts}
    for g in feats3._exec.graphs.values():
        for k, v in g.launches.items():
            warm3[k] += WARM_RUNS * v
    check(counts == {k: replayed[k] + warm3[k] for k in counts},
          f"engine launches {counts} != replays {replayed} + the third "
          f"artifact's warm-up runs {warm3}")

    # offline recompute through the same feats, padded to its bucket as
    # the engine pads (a replay: no capture)
    def offline(name, x):
        padded, n, _ = pad_to_bucket(x, eng.buckets)
        return reg.get(name).feats(padded)[:n]

    worst = 0.0
    for name, items in (("w6a4-int", list(results.values())),
                        ("w6a4-int-v2", v2)):
        sup = torch.cat([offline(name, shots[w]) for w in range(5)])
        labs = torch.as_tensor(np.repeat(np.arange(5), 5))
        means = ncm.class_means(sup, labs, 5)
        arts = ("w6a4-int", "f32") if name == "w6a4-int" else (name,)
        for art in arts:
            got, ids = reg.get(art).store.prototypes()
            check(ids == (0, 1, 2, 3, 4) and np.array_equal(
                got, means.cpu().numpy()),
                f"{art}: served prototypes != offline recompute")
        store = PrototypeStore(device="cuda")
        for w in range(5):
            store.register(w, sup[5 * w:5 * w + 5])
        for x, r in items:
            ids, sims = store.classify(offline(name, x))
            check(r.class_ids == ids, f"{name}: served predictions != "
                  "offline recompute")
            worst = max(worst, float(np.abs(r.sims - sims).max()))
            check(np.allclose(r.sims, sims, rtol=1e-5, atol=1e-6),
                  f"{name}: served similarities != offline beyond 1e-5")
    log(f"engine: warmup {warm_s:.3f} s ({sum(base.values())} captures); "
        f"{n_req} classify requests of 1-4 frames from {ENGINE_THREADS} "
        f"closed-loop clients in {wall:.3f} s, default hot-swapped to f32 "
        "halfway "
        f"(served: {by_art}); a third artifact captured in {warm3_s:.3f} s "
        f"while serving ({served_while} requests done by then), then 32 "
        f"requests on it; no capture after warmup {traces}; 0 rejected, 0 "
        f"failed; prototypes bit for bit and predictions equal to the "
        f"offline recompute (similarities within {worst:.3g}); every "
        f"launch a replay: {replayed}")
    log(f"engine metrics, {ENGINE_THREADS} closed-loop clients: "
        f"{snap['throughput_rps']:.1f} requests/s, p50 "
        f"{snap['p50_ms']:.3f} ms, p95 {snap['p95_ms']:.3f} ms, p99 "
        f"{snap['p99_ms']:.3f} ms, mean batch {snap['mean_batch']:.2f} "
        f"(padding {snap['padded_frac']:.1%}), batches {snap['batches']:.0f}, "
        f"queue <= {snap['max_queue_depth']:.0f}")
    reg.set_default("w6a4-int")      # the paper's artifact for the loads
    for closed in (True, False):
        engine_load(torch, reg, plan, closed, traced=False, base=traces)
        engine_load(torch, reg, plan[:400], closed, traced=True, base=traces)
    return replayed


def engine_load(torch, reg, reqs, closed: bool, traced: bool, base):
    """The engine phase's classify traffic again on a fresh engine over the
    same (warmed) registry, from 4 threads: closed loop (one request in
    flight per client) or open loop (each thread submits all its requests,
    then waits: the queue stays full, the engine saturated).  Checks no
    capture and no failure; logs requests/s, latency and mean batch, and,
    ``traced``, the device's busy share of the window
    (``torch.profiler``'s device time of every kernel and copy over the
    window's wall time; the profiler's host cost stretches the window, so
    the share is a floor)."""
    import contextlib
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import profile

    from repro_torch.serve import ServeEngine

    eng = ServeEngine(reg, max_batch=64, max_queue=512, batch_wait_ms=2.0)
    errors = []

    def client(tid):
        try:
            mine = range(tid, len(reqs), ENGINE_THREADS)
            if closed:
                for i in mine:
                    eng.submit_classify(reqs[i], timeout=60).result(120)
            else:
                fs = [eng.submit_classify(reqs[i], timeout=60) for i in mine]
                for f in fs:
                    f.result(120)
        except Exception as e:                        # noqa: BLE001
            errors.append(repr(e))

    try:
        check(eng.warmup(img=IMG) == base, "a capture at a second warmup")
        prof = profile(**traced_steps()) if traced else contextlib.nullcontext()
        with prof:
            eng.submit_classify(reqs[0]).result(120)   # warm-up step
            if traced:
                prof.step()
            eng.metrics.reset_clock()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(ENGINE_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if traced:
                prof.step()
        snap = eng.metrics.snapshot()
        traces = eng.trace_counts()
    finally:
        eng.stop()
    check(not errors and snap["failed"] == 0 and snap["rejected"] == 0
          and traces == base, f"engine load: errors {errors[:3]}, {snap}, "
          f"captures {traces}")
    mode = (f"{ENGINE_THREADS} closed-loop clients" if closed
            else f"{ENGINE_THREADS} open-loop submitters (saturated)")
    msg = (f"engine {'traced window' if traced else 'load'}, {mode}: "
           f"{len(reqs)} requests in {wall * 1e3:.3f} ms, "
           f"{snap['throughput_rps']:.1f} requests/s, p50 "
           f"{snap['p50_ms']:.3f} ms, p99 {snap['p99_ms']:.3f} ms, mean "
           f"batch {snap['mean_batch']:.2f}")
    if traced:
        busy_us = sum(e.device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("ProfilerStep"))
        msg += (", device busy " + ("not measured (no CUDA events)"
                                    if busy_us <= 0 else
                                    f"{busy_us / 1e3:.3f} ms = "
                                    f"{busy_us / (wall * 1e6):.1%} of the "
                                    "window"))
    log(msg)


def wide_code_path(torch, np, B):
    """The int artifacts whose codes do not fit int8 -- ``grid_point(8, 8)``
    (8-bit unsigned activations) and the paper's 16-bit baseline
    ``paper_w16a16()`` (16-bit weights stored as int16) -- compiled on the
    card at the widest of widths 64, 32, 16, 8 that the integer lowering
    admits (it refuses a layer whose reachable sums leave int32), every
    MVAU on the CUDA-core kernel with its im2col folded in: card == CPU bit
    for bit on a small batch, launches per forward, batch-64 latency beside
    w6a4's.  Returns the launch counts of the counted forwards."""
    import repro_torch
    from repro_torch.core.graph import GraphBuildError
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.models import resnet9

    data = SyntheticImages(n_base=32, n_novel=10, seed=0, img=IMG)
    rng = np.random.default_rng(3)
    x_np, _ = data.batch(rng.integers(0, 42, BATCH),
                         rng.integers(0, 10_000, BATCH))
    x = torch.from_numpy(x_np).cuda()
    counts = {k: 0 for k in B.launch_counts}
    lat = {}
    for label, qcfg in (("grid_point(8, 8)", QuantConfig.grid_point(8, 8)),
                        ("paper_w16a16()", QuantConfig.paper_w16a16()),
                        ("paper_w6a4()", QuantConfig.paper_w6a4())):
        for width in (64, 32, 16, 8):
            params = resnet9.init_params(torch.Generator().manual_seed(0),
                                         width, device="cuda")
            t0 = time.perf_counter()
            try:
                dm = repro_torch.compile(params, qcfg, recipe="resnet9",
                                         datapath="int", device="cuda")
            except GraphBuildError as e:
                log(f"{label}: width {width} refused by the integer lowering "
                    f"({str(e)[:160]})")
                continue
            break
        else:
            raise SmokeFailure(f"{label}: no width compiles")
        secs = time.perf_counter() - t0
        layers = [(n.outputs[0].split("_")[0], r["kernel"],
                   str(dm.graph.initializers[n.inputs[1]].dtype))
                  for n, r in zip(dm.graph.nodes, dm.dispatch_table())
                  if n.op == "mvau_int"]
        int8 = label == "paper_w6a4()"
        want = "fused-cuda" if int8 else "fused-cuda-core"
        # the int8 route folds r2b's add and GAP into its MVAU, the
        # CUDA-core route the add into the GAP kernel
        check(all(r["kernel"] == want for r in dm.dispatch_table()
                  if r["op"] in ("mvau_int", "im2col"))
              and len(dm.apply.folded) == (10 if int8 else 9)
              and "r2b_res" in dm.apply.folded,
              f"{label}: {layers}, folded {dm.apply.folded}")
        params_cpu = {k: {kk: v.cpu() for kk, v in blk.items()}
                      for k, blk in params.items()}
        dm_cpu = repro_torch.compile(params_cpu, qcfg, recipe="resnet9",
                                     datapath="int", device="cpu")
        check(dm.weight_bytes() == dm_cpu.weight_bytes(),
              f"{label}: weight bytes differ between card and CPU")
        B.reset_launch_counts()
        f = dm(x[:2])
        torch.cuda.synchronize()
        run = dict(B.launch_counts)
        check(run == {"mvau_int": 8, "mvau_int_gap": int(int8),
                      "mvau_int_wide": 8 * (1 - int(int8)), "mvau": 0,
                      "gap": 1 - int(int8), "qmatmul": 0},
              f"{label} forward launches {run}")
        for k, v in run.items():
            counts[k] += v
        check(f.shape == (2, 8 * width) and bool(torch.isfinite(f).all()),
              f"{label}: features {tuple(f.shape)}")
        check(torch.equal(f.cpu(), dm_cpu(x_np[:2])),
              f"{label}: card features != CPU features")
        f = dm(x)
        check(torch.equal(f.cpu(), dm_cpu(x_np)),
              f"{label}: card features != CPU features at batch {BATCH}")
        lat[label] = wall_ms(torch, lambda: dm(x), reps=5)
        log(f"{label} int artifact at width {width} (compiled on the card in "
            f"{secs:.2f} s, weight bytes {dm.weight_bytes()}): card == CPU "
            f"bit for bit at batch 2 and {BATCH}; 8 mvau_int "
            f"({int(int8)} with the GAP epilogue) + {1 - int(int8)} gap "
            f"launches a forward; batch "
            f"{BATCH} {lat[label]:.3f} ms ({BATCH / lat[label] * 1e3:.1f} "
            f"images/s); layers (name, kernel, weight codes): {layers}")
        del dm, dm_cpu, params, params_cpu
    log(f"latency at batch {BATCH}: paper_w16a16() "
        f"{lat['paper_w16a16()']:.3f} ms, grid_point(8, 8) "
        f"{lat['grid_point(8, 8)']:.3f} ms, paper_w6a4() "
        f"{lat['paper_w6a4()']:.3f} ms (same run, same frames)")
    return counts


def time_real_inputs(torch, KM, dm_int, x, random_ms):
    """The 8 conv-form launches of one int forward at batch 64 timed on the
    activations and weights that forward gives them (captured by lowering
    the artifact's graph once more with a recording executor), beside the
    same shapes on random codes.  r2b is timed as the conv alone, like the
    other seven, and with its GAP epilogue on the skip the forward gives
    it; returns the sum of the 8 convs and the fused r2b's time."""
    from repro_torch.core.deploy import lower_graph
    from repro_torch.kernels import ops as kops

    captured = []
    run_pair, run_tail = kops.conv_mvau_int_node, kops.conv_mvau_int_gap_node

    def record(conv, node, xx, w, t):
        captured.append((node.outputs[0], conv.attrs, node.attrs, xx, w, t,
                         None))
        return run_pair(conv, node, xx, w, t)

    def record_tail(conv, node, pool, xx, w, t, skip):
        captured.append((node.outputs[0], conv.attrs, node.attrs, xx, w, t,
                         skip))
        return run_tail(conv, node, pool, xx, w, t, skip)

    kops.conv_mvau_int_node = record
    kops.conv_mvau_int_gap_node = record_tail
    try:
        fn = lower_graph(dm_int.graph, "cuda")
    finally:
        kops.conv_mvau_int_node = run_pair
        kops.conv_mvau_int_gap_node = run_tail
    (f_rec,) = fn(x)
    check(torch.equal(f_rec, dm_int(x)) and len(captured) == 8
          and captured[-1][-1] is not None,
          f"recorded forward: {len(captured)} conv-form calls")
    total = fused = 0.0
    for (name, conv, attrs, xx, w, t, skip), r_ms in zip(captured, random_ms):
        k, st, pd = conv["kernel"], conv["stride"], conv["pad"]
        x8 = xx.to(torch.int8)
        args = (k, st, pd, attrs.get("out_base", 0),
                bool(attrs.get("w_packed")))
        ms = cuda_ms(torch, lambda: KM.mvau_int_conv(x8, w, t, *args))
        total += ms
        log(f"kernel mvau_int {name.split('_')[0]:4s} on the width-64 "
            f"artifact's own inputs {tuple(x8.shape)}: {ms:.4f} ms (random "
            f"codes {r_ms:.4f} ms)")
        if skip is not None:          # r2b, with the GAP epilogue
            fused = cuda_ms(torch, lambda: KM.mvau_int_conv_gap(
                x8, w, t, skip, *args))
            log(f"kernel mvau_int_gap {name.split('_')[0]} on the artifact's "
                f"own inputs and skip: {fused:.4f} ms")
    log(f"kernel mvau_int sum over the 8 layers on the artifact's own inputs: "
        f"{total:.4f} ms (random codes {sum(random_ms):.4f} ms)")
    return total, fused



# ---------------------------------------------------------------------------
# LM decode path: w8/w4 weight-only Qwen2.5-3B serving, the qmatmul kernel
# ---------------------------------------------------------------------------
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 8, 16
PEAK_BF16_OPS = 989e12
QMM_LAUNCHES_PER_STEP = 252        # 7 projections x 36 layers
QMM_SLEEP_CYCLES = 10 * SLEEP_CYCLES
CPU_CHECK_LAYERS, CPU_CHECK_STEPS = 2, 16
# card vs CPU on bf16 logits up to about 4.5 in size, where one ulp is
# 0.03125: the CPU port and the JAX reference differ by one ulp at this
# width and depth, so two ulps
CPU_CHECK_TOL = 0.0625


def _projections(cfg):
    """(name, K, N) of the 7 quantized projections of one layer."""
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    return [("wq", d, cfg.n_heads * cfg.hd), ("wk", d, kv), ("wv", d, kv),
            ("wo", cfg.n_heads * cfg.hd, d), ("w_gate", d, f),
            ("w_up", d, f), ("w_down", f, d)]


def _leaf(blocks, name):
    return blocks["mlp" if name.startswith("w_") else "attn"][name]


def check_qmatmul(torch, Q, KQ, cfg):
    """qmatmul against its plain version on the card: ragged M, N, K (the
    scalar and the vector weight loads), the decode shapes at batch 4 and
    one prefill shape (batch 4 x prompt 8), f32 and bf16 x, w8 and w4.
    Tolerance: only the order of the float32 sum differs, so the error is
    held within 2e-5 of S = sum_k |bf16(x)| |code| scale (plus one bf16
    rounding of the output for bf16 x).  On integer-valued x with small
    codes every partial sum is an integer below 2^24: bit for bit."""
    dev = "cuda"
    gen = torch.Generator().manual_seed(4321)
    shapes = [(1, 32, 16), (5, 130, 66), (3, 37, 12), (9, 515, 264),
              (70, 300, 130)]
    shapes += [(LM_BATCH, k, n) for _, k, n in _projections(cfg)]
    shapes.append((LM_BATCH * LM_PROMPT, cfg.d_model, cfg.d_ff))
    decode = {(LM_BATCH, k, n) for _, k, n in _projections(cfg)}
    worst = {"abs": 0.0, "of_tol": 0.0, "rel_f32": 0.0, "abs_decode": 0.0}
    n_checked = 0
    for bits in (8, 4):
        lim = 8 if bits == 4 else 128
        for m, k, n in shapes:
            codes = torch.randint(-lim, lim, (k, n), generator=gen)
            w = (Q.pack_int4(codes.to(torch.int32)) if bits == 4
                 else codes.to(torch.int8)).to(dev)
            s = (torch.rand((n,), generator=gen) * 0.02 + 0.001).to(dev)
            for xdt in (torch.float32, torch.bfloat16):
                x = (torch.rand((m, k), generator=gen) * 2 - 1).to(xdt).to(dev)
                got = KQ.qmatmul(x, w, s, bits)
                want = KQ.qmatmul_plain(x, w, s, bits)
                torch.cuda.synchronize()
                check(got.dtype == xdt and got.shape == want.shape,
                      f"qmatmul {m}x{k}x{n} w{bits} {xdt}: {got.dtype} "
                      f"{tuple(got.shape)}")
                S = (x.to(torch.bfloat16).float().abs()
                     @ codes.to(dev).float().abs()) * s
                d = (got.float() - want.float()).abs()
                tol = 2e-5 * S
                if xdt == torch.bfloat16:
                    tol = tol + want.float().abs() * 2.0 ** -7
                check(bool((d <= tol).all()),
                      f"qmatmul {m}x{k}x{n} w{bits} {xdt} differs by "
                      f"{d.max().item():.3g} beyond the tolerance")
                worst["abs"] = max(worst["abs"], d.max().item())
                worst["of_tol"] = max(worst["of_tol"],
                                      (d / tol.clamp_min(1e-30)).max().item())
                if xdt == torch.float32:
                    worst["rel_f32"] = max(worst["rel_f32"], (
                        d / S.clamp_min(1e-30)).max().item())
                if (m, k, n) in decode:
                    worst["abs_decode"] = max(worst["abs_decode"],
                                              d.max().item())
                    check(torch.equal(got, KQ.qmatmul(x, w, s, bits)),
                          f"qmatmul {m}x{k}x{n} w{bits} {xdt}: two launches "
                          "differ")
                n_checked += 1
        lim = 8 if bits == 4 else 32
        for m, k, n in ((LM_BATCH, cfg.d_model, 256), (LM_BATCH, cfg.d_ff,
                                                       cfg.d_model), (7, 100, 18)):
            codes = torch.randint(-lim, lim, (k, n), generator=gen)
            w = (Q.pack_int4(codes.to(torch.int32)) if bits == 4
                 else codes.to(torch.int8)).to(dev)
            x = torch.randint(-16, 17, (m, k), generator=gen).float().to(dev)
            s = torch.full((n,), 0.5, device=dev)
            check(torch.equal(KQ.qmatmul(x, w, s, bits),
                              KQ.qmatmul_plain(x, w, s, bits)),
                  f"qmatmul {m}x{k}x{n} w{bits} on integers is not bit "
                  "for bit")
            n_checked += 1
        # every forced K split, a ragged one (5) included, both tile widths
        m, k, n = LM_BATCH, cfg.d_model, 320
        codes = torch.randint(-lim, lim, (k, n), generator=gen)
        w = (Q.pack_int4(codes.to(torch.int32)) if bits == 4
             else codes.to(torch.int8)).to(dev)
        s = (torch.rand((n,), generator=gen) * 0.02 + 0.001).to(dev)
        x = (torch.rand((m, k), generator=gen) * 2 - 1).to(torch.bfloat16
                                                            ).to(dev)
        want = KQ.qmatmul_plain(x, w, s, bits).float()
        tol = (2e-5 * (x.float().abs() @ codes.to(dev).float().abs()) * s
               + want.abs() * 2.0 ** -7)
        for bn in (64, 128):
            for splits in (1, 2, 4, 8, 5):
                got = KQ.qmatmul(x, w, s, bits, splits=splits, bn=bn)
                check(bool(((got.float() - want).abs() <= tol).all()),
                      f"qmatmul w{bits} bn {bn} splits {splits} differs")
                n_checked += 1
    log(f"kernel check qmatmul: {n_checked} cases, w8 and w4, f32 and bf16 "
        f"x, forced splits 1/2/4/8/5 at both tile widths; max abs err "
        f"{worst['abs']:.3g} (decode shapes {worst['abs_decode']:.3g}); "
        f"max err / applied tolerance {worst['of_tol']:.3g} (passes at <= 1; "
        f"the tolerance is 2e-5 sum|bf16(x)||code|scale, plus one bf16 "
        f"rounding of the output for bf16 x); for f32 x, max err / "
        f"sum|bf16(x)||code|scale {worst['rel_f32']:.3g} (tolerance 2e-5); "
        "integer inputs bit for bit; two launches bit for bit at the decode "
        "shapes")
    return worst["abs_decode"]


def _dense_bytes(tree):
    """(code bytes, scale bytes, fp weight count) of the dense leaves."""
    codes = scales = fp = 0
    if isinstance(tree, dict):
        if "w_codes" in tree:
            return (tree["w_codes"].numel(), 4 * tree["w_scale"].numel(), 0)
        if "w" in tree and getattr(tree["w"], "ndim", 0) >= 2:
            return (0, 0, tree["w"].numel())
        for v in tree.values():
            c, s, f = _dense_bytes(v)
            codes, scales, fp = codes + c, scales + s, fp + f
    return codes, scales, fp


def time_qmatmul(torch, Q, KQ, cfg, trees):
    """qmatmul over one decode step: for each projection, the 36 layers'
    weights in turn (as decode streams them, so nothing sits in the 50 MB
    L2), at batch 4 in bf16 — the kernel, its plain version, and the
    library yardstick: cuBLAS bf16 GEMM on codes cast to bf16 before the
    timing (twice w8's bytes, four times w4's), then x scale."""
    dev = "cuda"
    n = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for bits, tree in trees.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
               "ops": 0}
        rows = []
        for name, k, nn in _projections(cfg):
            leaf = _leaf(tree["blocks"], name)
            codes, scale = leaf["w_codes"], leaf["w_scale"]
            x = torch.rand((LM_BATCH, k), generator=gen, device=dev
                           ).to(torch.bfloat16)
            got = KQ.qmatmul(x, codes[0], scale[0], bits)
            want = KQ.qmatmul_plain(x, codes[0], scale[0], bits)
            wint = Q.unpack_int4(codes[0]) if bits == 4 else codes[0]
            S = (x.float().abs() @ wint.float().abs()) * scale[0]
            check(bool(((got.float() - want.float()).abs()
                        <= 2e-5 * S + want.float().abs() * 2.0 ** -7).all()),
                  f"qmatmul {name} w{bits} on the model's weights differs")
            # 5 x 36 launches queue behind a ~100 ms device-side sleep, so
            # the host's per-call cost does not pace the card
            ms = cuda_ms(torch, lambda: [KQ.qmatmul(x, codes[i], scale[i],
                                                    bits) for i in range(n)],
                         reps=5, sleep_cycles=QMM_SLEEP_CYCLES) / n
            plain = cuda_ms(torch, lambda: [KQ.qmatmul_plain(
                x, codes[i], scale[i], bits) for i in range(n)], reps=1,
                sleep_cycles=QMM_SLEEP_CYCLES) / n
            w16 = [(Q.unpack_int4(codes[i]) if bits == 4
                    else codes[i]).to(torch.bfloat16) for i in range(n)]
            lib = cuda_ms(torch, lambda: [
                (torch.matmul(x, w16[i]) * scale[i]).to(torch.bfloat16)
                for i in range(n)], reps=5,
                sleep_cycles=QMM_SLEEP_CYCLES) / n
            del w16
            nbytes = (codes[0].numel() + 4 * nn + 2 * LM_BATCH * (k + nn))
            rows.append((name, k, nn, ms, plain, lib,
                         nbytes / PEAK_BYTES_PER_S * 1e3))
            tot.setdefault("per_projection", {})[name] = ms
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bytes", nbytes),
                           ("ops", 2 * LM_BATCH * k * nn)):
                tot[key] += v * n
        for name, k, nn, ms, plain, lib, bound in rows:
            log(f"kernel qmatmul w{bits} {name:6s} M={LM_BATCH} K={k:5d} "
                f"N={nn:5d}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                f"library_ms={lib:.4f} bound_ms={bound:.4f} "
                f"({(k * nn // (2 if bits == 4 else 1)) / ms / 1e6:.0f} "
                "GB/s of codes)")
        b_ms = tot["bytes"] / PEAK_BYTES_PER_S * 1e3
        o_ms = tot["ops"] / PEAK_BF16_OPS * 1e3
        tot["bound_ms"] = max(b_ms, o_ms)
        tot["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
        log(f"kernel qmatmul w{bits}, one decode step ({n} layers x 7 = "
            f"{7 * n} launches, batch {LM_BATCH}): kernel_ms={tot['ms']:.4f} "
            f"plain_ms={tot['plain_ms']:.4f} library_ms="
            f"{tot['library_ms']:.4f} bound_ms={tot['bound_ms']:.4f} "
            f"({tot['bytes']} bytes)")
        out[bits] = tot
    if 8 in out and 4 in out:
        for name, k, nn in _projections(cfg):
            w8, w4 = out[8]["per_projection"][name], out[4]["per_projection"][name]
            log(f"kernel qmatmul {name:6s} K={k:5d} N={nn:5d}: w8 "
                f"{k * nn / w8 / 1e6:.0f} GB/s, w4 {k * nn / 2 / w4 / 1e6:.0f} "
                f"GB/s of codes; w4/w8 time {w4 / w8:.3f} (w8 {w8 / w4:.2f}x "
                "the w4 time)")
        log(f"kernel qmatmul one decode step: w4/w8 time "
            f"{out[4]['ms'] / out[8]['ms']:.3f}")
    return out


def profile_decode(torch, label, step_fn, reps):
    """Device time by kernel over ``reps`` decode steps (torch.profiler,
    CUDA activity) and, in the same traced run, the CUDA-event time from
    the first step's start to the last one's end: the busy share of that
    one run.  The profiler's host cost stretches the traced run, so the
    share is a floor for the untraced loop."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    step_fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(**traced_steps()) as prof:
        step_fn()                     # warm-up step: its events are dropped
        torch.cuda.synchronize()
        prof.step()
        start.record()
        for _ in range(reps):
            step_fn()
        end.record()
        end.synchronize()
        prof.step()
    elapsed = start.elapsed_time(end) / reps
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]   # the step's span
    busy_us = sum(e.device_time_total for e in kern)
    if busy_us <= 0:
        log(f"profile {label}: device time not measured (no CUDA events)")
        return None, elapsed, kern
    busy = busy_us / reps / 1e3
    log(f"profile {label} ({reps} decode steps, traced): {elapsed:.3f} "
        f"ms/step between CUDA events, device busy {busy:.3f} ms/step "
        f"({busy / elapsed:.1%} of that same run), "
        f"{sum(e.count for e in kern) / reps:.0f} kernels/step")
    for e in sorted(kern, key=lambda e: -e.device_time_total)[:10]:
        log(f"  {e.device_time_total / reps / 1e3:8.4f} ms/step "
            f"{e.count / reps:6.1f}x  {e.key[:90]}")
    return busy, elapsed, kern


def lm_path(torch, np, B, Q, KQ):
    """The port's LM decode-serving path at Qwen2.5-3B's full width and
    depth on the card, at w8 and w4; returns the qmatmul kernel's numbers
    and the path's launch counts."""
    import dataclasses

    from repro_torch.launch.serve import generate, graphed_step
    from repro_torch.launch.steps import (greedy, make_decode_step,
                                          quantize_tree_for_serving)
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.tree import tree_flatten, tree_map

    cfg = get_config(LM_ARCH)
    err = check_qmatmul(torch, Q, KQ, cfg)

    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    q = {bits: lm.with_head_copy(quantize_tree_for_serving(params, bits), cfg)
         for bits in (8, 4)}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    p0 = lm.with_head_copy(params, cfg)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    log(f"lm: {LM_ARCH} full size ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab} padded {cfg.vocab_padded}), {n_params} float32 "
        f"parameters drawn on the card in {t1 - t0:.2f} s; w8 and w4 "
        f"serving quantization {t2 - t1:.2f} s")
    _, _, fp = _dense_bytes(params)
    for bits in (8, 4):
        c, s, _ = _dense_bytes(q[bits])
        log(f"lm weight bytes w{bits}: codes {c} + scales {s} = {c + s}")
    log(f"lm weight bytes bf16: {2 * fp} (the same {fp} dense weights)")
    check(_dense_bytes(q[8])[0] == fp and 2 * _dense_bytes(q[4])[0] == fp,
          "code bytes are not 1 (w8) and 1/2 (w4) per weight")

    timing = time_qmatmul(torch, Q, KQ, cfg, q)

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    steps = LM_PROMPT + LM_TOKENS

    # -- the path: counted, the eager step ------------------------------------
    B.reset_launch_counts()
    gens, walls = {}, {}
    for bits in (8, 4):
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(generate(q[bits], cfg, prompt, LM_TOKENS, graph=False))
            torch.cuda.synchronize()
            walls.setdefault(bits, []).append(time.perf_counter() - t0)
        check(tuple(runs[0].shape) == (LM_BATCH, LM_TOKENS),
              f"w{bits} generated {tuple(runs[0].shape)}")
        check(torch.equal(runs[0], runs[1]),
              f"w{bits}: two runs gave different tokens")
        check(bool(((runs[0] >= 0) & (runs[0] < cfg.vocab)).all()),
              f"w{bits} token outside the vocabulary")
        gens[bits] = runs[0]
    counts = dict(B.launch_counts)
    per_step = counts["qmatmul"] / (4 * steps)
    check(per_step == QMM_LAUNCHES_PER_STEP,
          f"qmatmul launches per decode step {per_step}, expected "
          f"{QMM_LAUNCHES_PER_STEP}")
    check(counts["mvau_int"] == counts["mvau_int_gap"] == counts["mvau"]
          == counts["gap"] == 0, f"LM path launched FSL kernels: {counts}")
    for bits in (8, 4):
        w = min(walls[bits])
        log(f"lm generate w{bits} eager step: batch {LM_BATCH}, prompt "
            f"{LM_PROMPT}, {LM_TOKENS} new tokens, {steps} decode steps in "
            f"{w * 1e3:.1f} ms ({LM_BATCH * LM_TOKENS / w:.1f} tok/s, best of "
            f"2); two runs gave identical tokens; sample "
            f"{gens[bits][0][:8].tolist()}")
    log(f"lm launches, eager: qmatmul {counts['qmatmul']} over 4 generate "
        f"runs of {steps} steps = {per_step:.0f} per decode step")

    # -- the path: counted, the captured step ----------------------------------
    # captured first (its eager warm-up steps are no replay), then counted
    graphs = {}
    for bits in (8, 4):
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        graphs[bits] = graphed_step(q[bits], cfg, LM_BATCH, steps + 1,
                                    torch.device("cuda"))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = torch.cuda.memory_stats()
        g = graphs[bits].graph
        check(g.launches == {"qmatmul": QMM_LAUNCHES_PER_STEP},
              f"w{bits} decode graph launches {g.launches}")
        log(f"lm decode graph w{bits}: captured in {secs:.3f} s (3 eager "
            f"warm-up steps first), {g.launches['qmatmul']} qmatmul launches "
            f"recorded; graph pool reserved {g.pool_bytes} bytes; "
            "memory_stats across warm-up and capture: reserved "
            f"{after['reserved_bytes.all.current'] - before['reserved_bytes.all.current']}"
            f" bytes, allocated "
            f"{after['allocated_bytes.all.current'] - before['allocated_bytes.all.current']}"
            f" bytes (w{bits} weights {_dense_bytes(q[bits])[0] + _dense_bytes(q[bits])[1]} "
            "bytes)")
    B.reset_launch_counts()
    replays0 = {bits: graphs[bits].graph.replays for bits in graphs}
    gwalls = {}
    for bits in (8, 4):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(q[bits], cfg, prompt, LM_TOKENS)
            torch.cuda.synchronize()
            gwalls.setdefault(bits, []).append(time.perf_counter() - t0)
            check(torch.equal(out, gens[bits]),
                  f"w{bits}: the captured step's tokens != the eager step's")
    graph_counts = dict(B.launch_counts)
    replays = sum(graphs[b].graph.replays - replays0[b] for b in graphs)
    check(replays == 4 * steps and graph_counts == {
        **{k: 0 for k in graph_counts},
        "qmatmul": replays * QMM_LAUNCHES_PER_STEP},
        f"captured-step launches {graph_counts} over {replays} replays")
    for bits in (8, 4):
        w = min(gwalls[bits])
        log(f"lm generate w{bits} captured step: {steps} replays in "
            f"{w * 1e3:.1f} ms ({LM_BATCH * LM_TOKENS / w:.1f} tok/s, best of "
            f"2; eager {min(walls[bits]) * 1e3:.1f} ms); tokens equal the "
            "eager step's")
    log(f"lm launches, captured: qmatmul {graph_counts['qmatmul']} from "
        f"{replays} replays x {QMM_LAUNCHES_PER_STEP}, all replays")

    # -- captured step against eager step: logits bit for bit ---------------
    for bits in (8, 4):
        st = graphs[bits]
        st.reset()
        cache = lm.init_cache(cfg, LM_BATCH, steps + 1)
        tok = None
        for t in range(steps):
            feed = (torch.as_tensor(prompt[:, t:t + 1], dtype=torch.int32,
                                    device="cuda") if t < LM_PROMPT else tok)
            logits, cache = lm.decode_step(q[bits], feed, cache, cfg)
            tok = greedy(logits, cfg)[:, None]
            st.step(feed)
            check(torch.equal(st.logits, logits)
                  and torch.equal(st.tokens, tok),
                  f"w{bits} step {t}: the captured step's logits or tokens "
                  "!= the eager step's")
        log(f"lm decode graph w{bits}: logits and greedy tokens of all "
            f"{steps} steps equal the eager step's bit for bit")

    # -- per-step decode latency, untraced ----------------------------------
    decode = make_decode_step(cfg)
    step_ms = {}
    for bits, tree in ((8, q[8]), (4, q[4]), (0, p0)):
        cache = lm.init_cache(cfg, LM_BATCH, steps + 1)
        tok = torch.as_tensor(prompt[:, :1], dtype=torch.int32, device="cuda")
        for t in range(LM_PROMPT):
            tok, cache = decode(tree, {"tokens": torch.as_tensor(
                prompt[:, t:t + 1], dtype=torch.int32, device="cuda")}, cache)
        state = {"tok": tok[:, None], "cache": cache}

        def one():
            nxt, state["cache"] = decode(tree, {"tokens": state["tok"]},
                                         state["cache"])
            state["tok"] = nxt[:, None]

        torch.cuda.synchronize()
        n_timed = LM_TOKENS // 2
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        for _ in range(n_timed):
            one()
        end.record()
        end.synchronize()
        host = (time.perf_counter() - h0) * 1e3 / n_timed
        step_ms[bits] = start.elapsed_time(end) / n_timed
        logits, _ = lm.decode_step(tree, state["tok"], state["cache"], cfg)
        check(bool(torch.isfinite(logits[:, :cfg.vocab].float()).all()),
              f"w{bits} logits not finite")
        log(f"lm decode step {'bf16' if bits == 0 else f'w{bits}'} "
            f"(untraced, {n_timed} steps): {step_ms[bits]:.3f} ms/step "
            f"between CUDA events, host {host:.3f} ms/step, "
            f"{LM_BATCH / step_ms[bits] * 1e3:.1f} tok/s; logits finite")

    graph_ms = {}
    for bits in (8, 4):
        st = graphs[bits]
        st.reset()
        for t in range(LM_PROMPT):
            st.step(torch.as_tensor(prompt[:, t:t + 1], dtype=torch.int32,
                                    device="cuda"))
        torch.cuda.synchronize()
        n_timed = LM_TOKENS // 2
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start_ev.record()
        for _ in range(n_timed):
            st.step()
        end_ev.record()
        end_ev.synchronize()
        host = (time.perf_counter() - h0) * 1e3 / n_timed
        graph_ms[bits] = start_ev.elapsed_time(end_ev) / n_timed
        log(f"lm decode step w{bits} captured (untraced, {n_timed} replays): "
            f"{graph_ms[bits]:.3f} ms/step between CUDA events, host "
            f"{host:.3f} ms/step, {LM_BATCH / graph_ms[bits] * 1e3:.1f} tok/s "
            f"(eager {step_ms[bits]:.3f} ms/step)")

    # -- w8 against bf16: top-1 agreement (printed, not asserted) ------------
    seq = torch.cat([torch.as_tensor(prompt, dtype=torch.int32,
                                     device="cuda"), gens[8]], dim=1)
    top = {}
    for bits, tree in ((0, p0), (8, q[8])):
        logits, _ = lm.forward(tree, {"tokens": seq}, cfg)
        check(bool(torch.isfinite(logits[..., :cfg.vocab].float()).all()),
              f"forward w{bits} logits not finite")
        top[bits] = logits[..., :cfg.vocab].argmax(-1)
    agree = (top[0] == top[8]).float().mean().item()
    log(f"lm top-1 agreement w8 vs bf16 (forward over prompt + w8 tokens, "
        f"{seq.numel()} positions): {agree:.4f}")

    # -- where the time goes: traced last ------------------------------------
    cache = lm.init_cache(cfg, LM_BATCH, 64)
    state = {"tok": torch.as_tensor(prompt[:, :1], dtype=torch.int32,
                                    device="cuda"), "cache": cache}

    def traced_step():
        nxt, state["cache"] = decode(q[8], {"tokens": state["tok"]},
                                     state["cache"])
        state["tok"] = nxt[:, None]

    reps = 8
    busy, traced, kern = profile_decode(torch, "w8 decode", traced_step, reps)
    qmm = [e for e in kern if "qmm_" in e.key]
    check(not any("qmm_reduce" in e.key for e in kern),
          "a qmm_reduce kernel ran in the w8 decode profile")
    if busy is not None:
        n_qmm = sum(e.count for e in qmm) / reps
        check(n_qmm == QMM_LAUNCHES_PER_STEP,
              f"{n_qmm} qmatmul kernels per profiled decode step, expected "
              f"{QMM_LAUNCHES_PER_STEP}")
        log(f"profile w8 decode: qmatmul {n_qmm:.0f} kernels/step, "
            f"{sum(e.device_time_total for e in qmm) / reps / 1e3:.4f} "
            "ms/step of device time; no qmm_reduce kernel")
        log(f"device busy share w8 decode step: {busy / traced:.1%} in the "
            f"traced run; busy {busy:.3f} ms over the untraced step's "
            f"{step_ms[8]:.3f} ms estimates {busy / step_ms[8]:.1%}")

    for bits in (8, 4):
        st = graphs[bits]
        st.reset()
        gbusy, _, gkern = profile_decode(
            torch, f"w{bits} decode graph replay", st.step, reps)
        if gbusy is None:
            continue
        qmm = [e for e in gkern if "qmm_" in e.key]
        n_qmm = sum(e.count for e in qmm) / reps
        check(n_qmm == QMM_LAUNCHES_PER_STEP,
              f"{n_qmm} qmatmul kernels per replayed w{bits} decode step, "
              f"expected {QMM_LAUNCHES_PER_STEP}")
        log(f"profile w{bits} decode graph: qmatmul {n_qmm:.0f} kernels/step,"
            f" {sum(e.device_time_total for e in qmm) / reps / 1e3:.4f} "
            f"ms/step of device time; device busy {gbusy:.3f} ms over the "
            f"untraced replay's {graph_ms[bits]:.3f} ms estimates "
            f"{gbusy / graph_ms[bits]:.1%}")

    # -- card against CPU: 2 layers at full width, w8 ------------------------
    small = dataclasses.replace(cfg, n_layers=CPU_CHECK_LAYERS)
    two = dict(params, blocks=tree_map(
        lambda t: t[:CPU_CHECK_LAYERS].contiguous(), params["blocks"]))
    del p0
    q_dev = lm.with_head_copy(quantize_tree_for_serving(two, 8), small)
    q_cpu = lm.with_head_copy(quantize_tree_for_serving(
        tree_map(lambda t: t.cpu(), two), 8), small)
    for (a, b) in zip(tree_flatten(q_dev)[0], tree_flatten(q_cpu)[0]):
        check(torch.equal(a.cpu(), b), "w8 codes or scales differ between "
              "card and CPU")
    caches = {"cuda": lm.init_cache(small, LM_BATCH, CPU_CHECK_STEPS + 1),
              "cpu": lm.init_cache(small, LM_BATCH, CPU_CHECK_STEPS + 1,
                                   device="cpu")}
    tok = torch.as_tensor(prompt[:, :1], dtype=torch.int32)
    worst, compared, skipped = 0.0, 0, 0
    t0 = time.perf_counter()
    for t in range(CPU_CHECK_STEPS):
        feed = (torch.as_tensor(prompt[:, t:t + 1], dtype=torch.int32)
                if t < LM_PROMPT else tok)
        lc, caches["cpu"] = lm.decode_step(q_cpu, feed, caches["cpu"], small)
        lg, caches["cuda"] = lm.decode_step(q_dev, feed.cuda(),
                                            caches["cuda"], small)
        lc = lc[:, :small.vocab].float()
        lg = lg[:, :small.vocab].float().cpu()
        check(bool(torch.isfinite(lg).all()), "card logits not finite")
        worst = max(worst, float((lg - lc).abs().max()))
        top2 = torch.topk(lc, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * CPU_CHECK_TOL
        check(torch.equal(lg.argmax(-1)[sure], lc.argmax(-1)[sure]),
              f"step {t}: greedy tokens differ between card and CPU at a "
              "top-2 margin above twice the tolerance")
        compared += int(sure.sum())
        skipped += int((~sure).sum())
        tok = lc.argmax(-1, keepdim=True).to(torch.int32)
    check(worst <= CPU_CHECK_TOL, f"card and CPU logits differ by {worst}")
    log(f"lm card vs CPU ({CPU_CHECK_LAYERS} layers, full width, w8, "
        f"{CPU_CHECK_STEPS} teacher-forced steps, {time.perf_counter() - t0:.1f}"
        f" s): logits within {worst:.4g} (tolerance {CPU_CHECK_TOL}); greedy "
        f"tokens equal at {compared} decisions, {skipped} skipped at a top-2 "
        f"margin <= {2 * CPU_CHECK_TOL}")

    w8, w4 = timing[8], timing[4]
    entry = {"name": "qmatmul", "route": "cuda",
             "source": "src/repro_torch/csrc/qmatmul.cu",
             "replaces": "src/repro/kernels/qmatmul.py:64",
             "launches": counts["qmatmul"], "max_abs_err": err,
             "ms": w8["ms"], "plain_ms": w8["plain_ms"],
             "bound_ms": w8["bound_ms"], "bound_by": w8["bound_by"],
             "library_ms": w8["library_ms"],
             "per": f"one {LM_ARCH} decode step at batch {LM_BATCH}, w8 "
                    f"({QMM_LAUNCHES_PER_STEP} launches)",
             "w4": {k: w4[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}
    return entry, counts, graph_counts


# ---------------------------------------------------------------------------
# Phase 7: training (fsl_train)
# ---------------------------------------------------------------------------
TRAIN_STEPS = 150
TRAIN_BATCH = 64
TRAIN_EPISODES = 20
# benchmarks/table2_accuracy.py's rows: (label, conv bits.frac, act bits.frac)
TABLE2_ROWS = (("w3.2a2.1 (collapse row)", (3, 2), (2, 1)),
               ("w6.5a4.2 (paper choice)", (6, 5), (4, 2)),
               ("w8.4a8.4", (8, 4), (8, 4)),
               ("w16.8a16.8 (conventional)", (16, 8), (16, 8)))
TABLE2_STEPS = 120
# frames of the BATCH-frame probe whose pre-activations may tie a grid
# midpoint (each may differ from QAT by one code)
TIED_FRAMES = 2
TABLE2_BATCH = 32


def ieee_flags(torch) -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def train_path(torch, np, B):
    """QAT pretraining at the paper's width 64 on the card, then the trained
    weights deployed through both datapaths, then the paper's Table II rows.
    Returns the path's launch counts (set to 0 at the start)."""
    import repro_torch
    from repro_torch.core.quant import FixedPointSpec, QuantConfig
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.fsl.pipeline import (FSLPipeline, evaluate_episodes,
                                          pretrain_backbone, pretrain_init,
                                          pretrain_step)
    from repro_torch.models import resnet9
    from repro_torch.optim import adamw_init, cosine_warmup
    from repro_torch.tree import tree_flatten, tree_map

    B.reset_launch_counts()
    t_phase = time.perf_counter()
    qcfg = QuantConfig.paper_w6a4()
    data = SyntheticImages(n_base=24, n_novel=8, seed=0, img=IMG)
    pipe = FSLPipeline(width=WIDTH, qcfg=qcfg, device="cuda")
    runs, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(pretrain_backbone(data, pipe, steps=TRAIN_STEPS,
                                      batch=TRAIN_BATCH, seed=0))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    check(ieee_flags(torch), "TF32 is on after training")
    losses = runs[0]["losses"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0],
          f"pretraining losses {losses[:3]} ... {losses[-3:]}")
    check(runs[0]["losses"] == runs[1]["losses"],
          "two same-seed pretraining runs give different losses")
    check(all(torch.equal(u, v) for u, v in zip(
        tree_flatten(runs[0]["params"])[0],
        tree_flatten(runs[1]["params"])[0])),
          "two same-seed pretraining runs give different params")
    params = runs[0]["params"]
    min_gamma = min(float(blk["gamma"].min()) for blk in params.values())
    check(min_gamma > 0, f"BN scale {min_gamma} <= 0: no threshold folding")
    ms = [s / TRAIN_STEPS * 1e3 for s in secs]
    log(f"fsl_train: pretrain_backbone at width {WIDTH}, paper_w6a4(), "
        f"batch {TRAIN_BATCH}, {TRAIN_STEPS} steps, twice from seed 0: "
        f"{secs[0]:.2f} s and {secs[1]:.2f} s ({ms[0]:.3f} and {ms[1]:.3f} "
        f"ms/step, {1e3 / ms[0]:.1f} and {1e3 / ms[1]:.1f} steps/s, batch "
        f"images included); losses and params bit for bit equal; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; smallest gamma "
        f"{min_gamma:.6f}")

    # one step alone: untraced wall, then the profiler's device busy
    p0 = pretrain_init(data, pipe, seed=1)
    st = {"p": p0, "o": adamw_init(p0)}
    sched = cosine_warmup(2e-3, warmup=max(TRAIN_STEPS // 20, 1),
                          total=TRAIN_STEPS)
    xb, yb = data.base_batch(np.random.default_rng(1), TRAIN_BATCH)
    xb = torch.from_numpy(xb).cuda()
    yb = torch.from_numpy(yb).cuda().long()

    def step():
        st["p"], st["o"], _ = pretrain_step(pipe, st["p"], st["o"], sched,
                                            xb, yb)

    step_ms = wall_ms(torch, step, reps=10)
    busy, kern = profile_forward(torch, "training step", step, reps=5,
                                 batch=TRAIN_BATCH, unit="step", top=12)
    log(f"fsl_train step on resident data: {step_ms:.3f} ms wall "
        f"({1e3 / step_ms:.1f} steps/s), device busy "
        + (f"{busy:.3f} ms ({busy / step_ms:.1%} of the untraced step), "
           if busy is not None else "not measured, ")
        + f"{sum(e.count for e in kern) / 5:.0f} kernels a step")

    # the trained weights deployed: int == f32 == QAT, card == CPU
    feats_int = pipe.deploy(params, datapath="int")
    feats_f32 = pipe.deploy(params, datapath="f32")
    ep = data.episode(np.random.default_rng(5), 5, 5, 15)
    x = torch.from_numpy(ep["query_x"][:BATCH]).cuda()
    want = pipe.features(params, x)
    f_int, f_f32 = feats_int(x), feats_f32(x)
    # a frame where a pre-activation lies within float32 roundings of a grid
    # midpoint (the export's (T - beta)/gamma against QAT's gamma*y + beta)
    # may differ from QAT by a code, in the reference as in the port; the
    # test reads the grid and the BN parameters, not the exported
    # thresholds.  Every other frame must give the QAT features, and at
    # most TIED_FRAMES frames may tie
    ties = (resnet9.midpoint_ties(params, x, qcfg, WIDTH)
            + resnet9.midpoint_ties(params, torch.flip(x, dims=[2]), qcfg,
                                    WIDTH)) > 0
    check(int(ties.sum()) <= TIED_FRAMES,
          f"{int(ties.sum())} of {BATCH} frames tie a grid midpoint")
    code = qcfg.layer(resnet9.plan(WIDTH)[-1]["name"]).act.scale
    n_bad = {}
    for name, f in (("int", f_int), ("f32", f_f32)):
        bad = ~torch.isclose(f, want, rtol=1e-5, atol=1e-6).all(dim=1)
        d = (f - want).abs()
        n_bad[name] = int(bad.sum())
        check(not bool((bad & ~ties).any()),
              f"trained {name} artifact != QAT features on a frame without "
              f"a midpoint tie (max diff {d.max().item()})")
        check(bool((d[ties] <= code).all()),
              f"trained {name} artifact differs from QAT by more than a "
              f"code on a tied frame")
    check(torch.equal(f_int, f_f32), "trained int artifact != f32 artifact")
    dm_cpu = repro_torch.compile(tree_map(lambda t: t.cpu(), params), qcfg,
                                 recipe="resnet9", datapath="int",
                                 device="cpu")
    check(torch.equal(feats_int.deployed_model(x[:2]).cpu(),
                      dm_cpu(x[:2].cpu())),
          "trained int artifact: card != CPU at batch 2")
    t0 = time.perf_counter()
    acc_q, ci_q = evaluate_episodes(params, data, pipe,
                                    n_episodes=TRAIN_EPISODES)
    acc_d, ci_d = evaluate_episodes(params, data, pipe,
                                    n_episodes=TRAIN_EPISODES,
                                    feats_fn=feats_int)
    check(abs(acc_d - acc_q) < 0.01,
          f"deployed accuracy {acc_d} vs QAT accuracy {acc_q}")
    log(f"fsl_train: trained int and f32 artifacts == QAT features (rtol "
        f"1e-5, atol 1e-6) at batch {BATCH} on every frame without a "
        f"midpoint tie ({int(ties.sum())} of {BATCH} frames tie, at most "
        f"{TIED_FRAMES}; differ from QAT: int {n_bad['int']}, f32 "
        f"{n_bad['f32']}), int == f32 bit for bit, card == "
        f"CPU at batch 2; 5-way 5-shot over {TRAIN_EPISODES} episodes: QAT "
        f"{acc_q * 100:.2f} ± {ci_q * 100:.2f}%, deployed int "
        f"{acc_d * 100:.2f} ± {ci_d * 100:.2f}% "
        f"({time.perf_counter() - t0:.2f} s)")
    del feats_int, feats_f32, dm_cpu, runs, params, st

    # the paper's Table II rows at width 64
    t2 = SyntheticImages(n_base=24, n_novel=8, seed=0, img=IMG, signal=0.7,
                         noise=0.2)
    for label, (wb, wf), (ab, af) in TABLE2_ROWS:
        cfg = QuantConfig(weight=FixedPointSpec(wb, wf),
                          act=FixedPointSpec(ab, af, signed=False))
        p = FSLPipeline(width=WIDTH, qcfg=cfg, device="cuda")
        t0 = time.perf_counter()
        pre = pretrain_backbone(t2, p, steps=TABLE2_STEPS,
                                batch=TABLE2_BATCH)
        t_train = time.perf_counter() - t0
        acc, ci = evaluate_episodes(pre["params"], t2, p,
                                    n_episodes=TRAIN_EPISODES)
        feats = p.deploy(pre["params"], datapath="int")
        acc_i, ci_i = evaluate_episodes(pre["params"], t2, p,
                                        n_episodes=TRAIN_EPISODES,
                                        feats_fn=feats)
        kernels = sorted({r["kernel"] for r in
                          feats.deployed_model.dispatch_table()
                          if r["op"] == "mvau_int"})
        gmin = min(float(blk["gamma"].min())
                   for blk in pre["params"].values())
        log(f"table2,{label},qat={acc * 100:.2f}±{ci * 100:.2f},"
            f"deployed_int={acc_i * 100:.2f}±{ci_i * 100:.2f},"
            f"loss={pre['losses'][0]:.4f}->{pre['losses'][-1]:.4f},"
            f"min_gamma={gmin:.6f},"
            f"train_s={t_train:.2f},total_s={time.perf_counter() - t0:.2f},"
            f"mvau_int={'/'.join(kernels)}")
        del feats, pre, p
    counts = dict(B.launch_counts)
    log(f"fsl_train: phase {time.perf_counter() - t_phase:.2f} s; launches "
        f"{counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 8: design-space exploration (dse)
# ---------------------------------------------------------------------------
DSE_STEPS = 120
DSE_EPISODES = 10


def dse_path(torch, np, B):
    """``SweepFarm`` over the default grid at width 64 on the card; a
    restart is all cache hits; a serial ``sweep`` of two points equals the
    farm on the deterministic keys; the knee published into a registry and
    served through ``ServeEngine``, bit for bit against its sweep-time
    probe.  Returns the path's launch counts (set to 0 at the start)."""
    import hashlib
    import tempfile

    from repro_torch.explore import (DEFAULT_GRID, DETERMINISTIC_KEYS,
                                     SweepFarm, probe_batch,
                                     publish_frontier, select_knee, sweep)
    from repro_torch.serve import (ArtifactRegistry, PrototypeStore,
                                   ServeEngine)

    B.reset_launch_counts()
    t_phase = time.perf_counter()
    kw = dict(width=WIDTH, steps=DSE_STEPS, episodes=DSE_EPISODES,
              device="cuda")
    with tempfile.TemporaryDirectory(prefix="dse-cache-") as cache:
        t0 = time.perf_counter()
        farm = SweepFarm(cache, verbose=False, **kw)
        res = farm.run(DEFAULT_GRID)
        farm_s = time.perf_counter() - t0
        check(res.failed == [], f"DSE points failed: {res.errors}")
        check(all(p["bitexact_int_vs_f32"] for p in res.points),
              "a DSE point's int artifact != its f32 artifact")
        for p, wall, key in zip(res.points, res.wall_s, res.keys):
            gmin = min(float(blk["gamma"].min()) for blk in
                       farm.restore_point(key).params.values())
            log(f"dse,{p['label']},acc={p['acc_mean'] * 100:.2f}±"
                f"{p['acc_ci95'] * 100:.2f},bytes_int={p['weight_bytes_int']},"
                f"bytes_f32={p['weight_bytes_f32']},int_ms_b8="
                f"{p['int_ms_per_batch']:.3f},f32_ms_b8="
                f"{p['f32_ms_per_batch']:.3f},modeled_ms="
                f"{p['modeled_ms']:.5f},top={p['cost_top']['op']}:"
                f"{p['cost_top']['kernel']},loss={p['final_pretrain_loss']:.4f},"
                f"min_gamma={gmin:.6f},bitexact="
                f"{int(p['bitexact_int_vs_f32'])},wall_s={wall:.2f}")
        t0 = time.perf_counter()
        again = SweepFarm(cache, verbose=False, **kw).run(DEFAULT_GRID)
        check(again.cached == [True] * len(DEFAULT_GRID)
              and again.points == res.points,
              f"restarted farm: cached {again.cached}, or records differ")
        restart_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serial = sweep(DEFAULT_GRID[:2], verbose=False, **kw)
        serial_s = time.perf_counter() - t0
        for a, b in zip(serial["points"], res.points):
            diff = [k for k in DETERMINISTIC_KEYS if a[k] != b[k]]
            check(not diff, f"serial sweep != farm on {a['label']}: {diff}")

        registry = ArtifactRegistry()
        names = publish_frontier(res, registry, device="cuda")
        knee = select_knee(res.points, res.frontier)
        rec = res.points[knee]
        cached = farm.restore_point(res.keys[knee])
        probe = probe_batch(rec["point_seed"], res.config["bench_batch"], IMG)
        with ServeEngine(registry, max_batch=res.config["bench_batch"],
                         batch_wait_ms=1.0) as eng:
            eng.warmup(img=IMG)
            default = registry.get(None)
            served = default.feats(probe).cpu().numpy()
            check(np.array_equal(served, cached.probe_feats)
                  and hashlib.sha256(served.tobytes()).hexdigest()
                  == rec["probe_digest"],
                  "served knee != its sweep-time probe features")
            offline = PrototypeStore("cuda")
            offline.register("a", cached.probe_feats[:1])
            offline.register("b", cached.probe_feats[1:2])
            want_ids, want_sims = offline.classify(cached.probe_feats)
            eng.submit_register("a", probe[:1]).result(timeout=120)
            eng.submit_register("b", probe[1:2]).result(timeout=120)
            got = eng.submit_classify(probe).result(timeout=120)
        check(got.artifact == default.name and got.class_ids == want_ids
              and np.array_equal(got.sims, want_sims),
              "engine classification of the knee != offline NCM")
    counts = dict(B.launch_counts)
    log(f"dse: SweepFarm over {len(DEFAULT_GRID)} points at width {WIDTH}, "
        f"{DSE_STEPS} steps, {DSE_EPISODES} episodes in {farm_s:.2f} s, every "
        f"point int == f32 bit for bit; restart all cache hits in "
        f"{restart_s:.3f} s; serial sweep of 2 points == farm on "
        f"{len(DETERMINISTIC_KEYS)} keys ({serial_s:.2f} s); frontier "
        f"{[res.points[i]['label'] for i in res.frontier]} published as "
        f"{names}, knee {rec['label']} served through ServeEngine bit for bit "
        f"(probe digest {rec['probe_digest'][:12]}), classification == "
        f"offline NCM; phase {time.perf_counter() - t_phase:.2f} s; "
        f"launches {counts}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script runs only "
                         "on the card\n")
        return 2
    import numpy as np

    from repro_torch.core import quant as Q
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as B
    from repro_torch.kernels import gap as KG
    from repro_torch.kernels import mvau as KM
    from repro_torch.kernels import qmatmul as KQ
    from repro_torch.kernels import ref

    resolve_device(None)               # TF32 off for every f32 product
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"card: {smi_line}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    info = B.build(force=True)
    log(f"build: {len(B.SOURCES)} sources with nvcc for sm_90a in "
        f"{info.seconds:.2f} s -> {info.path.name}")
    for section in info.ptxas.split("== ")[1:]:
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  section)})
        spills = sorted({int(b) for b in re.findall(
            r"(\d+) bytes spill stores", section)})
        log(f"  ptxas {section.split()[0]}: registers per kernel {regs}, "
            f"spill stores {spills} bytes")
        entries = section.split("Compiling entry function '")[1:]
        check(len(entries) > 0, f"ptxas reported no kernel for "
              f"{section.split()[0]}")
        spilled = [e.split("'")[0] for e in entries if any(
            int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                       e))]
        check(not spilled, f"ptxas: {section.split()[0]} spills in {spilled}")
    B.library()

    err = check_kernels(torch, Q, KM, KG, ref)
    kernels = time_kernels(torch, Q, KM, KG, ref, err)

    graph_state = fsl_graph_path(torch, np, B)
    B.reset_launch_counts()
    dm_int, x = main_path(torch, np, B)
    fsl_counts = dict(B.launch_counts)
    profile_fsl_graphs(torch, B, graph_state)
    del graph_state
    serve_counts = engine_phase(torch, np, B)
    mv = next(k for k in kernels if k["name"] == "mvau_int")
    mv["real_inputs_ms"], fused_real_ms = time_real_inputs(
        torch, KM, dm_int, x, mv.pop("layer_ms"))
    next(k for k in kernels
         if k["name"] == "mvau_int_gap")["real_inputs_ms"] = fused_real_ms
    del dm_int, x
    wide_counts = wide_code_path(torch, np, B)
    qmm, lm_counts, lm_graph_counts = lm_path(torch, np, B, Q, KQ)
    kernels.append(qmm)
    train_counts = train_path(torch, np, B)
    dse_counts = dse_path(torch, np, B)
    paths = {"fsl": fsl_counts, "fsl_wide_codes": wide_counts,
             "fsl_serve": serve_counts, "lm_decode": lm_counts,
             "lm_decode_graph": lm_graph_counts, "fsl_train": train_counts,
             "dse": dse_counts}
    for k in kernels:
        by_path = {p: c[k["name"]] for p, c in paths.items()}
        k["launches_by_path"] = by_path
        k["launches"] = by_path["lm_decode" if k["name"] == "qmatmul"
                                else "fsl"]
        check(k["launches"] > 0, f"kernel {k['name']} never ran on its path")
        # the replayed paths: counted from graph replays only
        check(by_path["fsl_serve" if k["name"] != "qmatmul"
                      else "lm_decode_graph"] > 0,
              f"kernel {k['name']} never ran in a replayed graph")
        if k["name"] != "qmatmul":
            check(by_path["fsl_train"] > 0 and by_path["dse"] > 0,
                  f"kernel {k['name']} never ran on the training or the "
                  f"DSE path: {by_path}")
    # the integer MVAU's two routes: int8 wgmma, and the CUDA cores for
    # wider codes (grid_point(8, 8), the 16-bit Table II row)
    mv = next(k for k in kernels if k["name"] == "mvau_int")
    mv["launches_by_route"] = {
        "int8_wgmma": {p: c["mvau_int"] - c["mvau_int_wide"]
                       for p, c in paths.items()},
        "cuda_core": {p: c["mvau_int_wide"] for p, c in paths.items()}}
    for route, by_path in mv["launches_by_route"].items():
        check(by_path["fsl_train"] > 0 and by_path["dse"] > 0,
              f"mvau_int's {route} route never ran on the training or the "
              f"DSE path: {by_path}")
    log("kernels " + " ".join(f"{k['name']}={k['launches_by_path']}"
                              for k in kernels))
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        sys.stderr.write(f"chip_smoke FAILED: {e}\n")
        sys.exit(1)
