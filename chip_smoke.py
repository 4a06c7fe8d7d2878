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
   kernel, its plane route (uint8 codes, and int16 and int32 codes of up to
   24 bits as byte planes against one or two weight planes, at their
   extremes; with the GAP epilogue too, 65,535 levels, K at its limit),
   the float MVAU and the int32-code integer route on the CUDA-core
   kernel; the int8 kernel with
   its GlobalAccPool epilogue at r2b's shape
   at batch 1 and 64, forced splits 1/2/8, repeated launches and a skip
   that wraps the int32 sums; the GAP kernel with and without a residual
   operand); then each held against it again and timed at the FSL path's
   shapes at batch 64, beside its bound and PyTorch library calls
   computing the same function (``torch._int_mm`` + count, ``torch.matmul``
   + count and ``torch.matmul`` alone on pre-built patches, the unfold
   im2col a PyTorch user would write, ``torch.add`` + ``torch.sum``); the
   MVAUs in conv form and in GEMM form on pre-built patches; the int32-code
   route in conv form; r2b's tail fused, unfused (conv, add, GAP) and the
   conv alone; the plane route with 16-bit codes (four products), uint8
   codes (one), 16-bit codes x int8 weights (two) and 17-bit codes as
   int32 (six) beside ``torch.matmul`` in float64 + count and the
   CUDA-core kernel on the same codes.
2a. differential fuzz (path ``fuzz``): the random hardware-mapped graphs
   of ``repro_torch.core.fuzz`` -- the reference's corpus
   (``random_hw_graph``, ``REFERENCE_SEEDS``), the wide one at the
   kernels' tile edges (``wide_hw_graph``, ``WIDE_SEEDS``) and the dense
   one at decode and small-batch GEMM shapes (``gemm_hw_graph``,
   ``GEMM_SEEDS``) -- each through ``check_differential`` on the card
   (interpreter == f32 == unfused int == fused int, bit for bit), then on
   the CPU: every card output equals its CPU counterpart and the CPU
   interpreter's.  The float MVAU, the integer MVAU on its tensor-core
   routes (int8 ``wgmma``, the small-M kernel, the plane route), the int8 GEMM
   form past the small-M limit, the fused GAP tail and the GAP kernel must
   each run; the seeds, failures (none allowed), seconds and, per route,
   the MVAU shapes that reached it are logged.
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
   the HW graph of ``build_dataflow(export_graph(...),
   RESNET9_BUILD_STEPS)`` through the interpreter on the card (8 ``mvau``
   launches, counted in the path) == the f32 artifact == its CPU run, bit
   for bit; weight bytes; launches per forward; compile time, latency and
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
4c. the multi-tenant cluster on the card (path ``cluster``):
   ``ServeCluster(replicas=2, max_batch=64, batch_wait_ms=2,
   tenant_quota=0.25)`` over a ``sharded_tenant_registry`` (the serial
   NCM head on one card) with the width-64 int flip ensemble as the
   default backbone and the f32 one beside it, warmed through a
   ``CompileCache`` in a fresh directory (one warm record per bucket and
   backbone); 16 tenants of 5 classes x 5 shots; 1,024 classify requests
   of 1-4 frames from 4 closed-loop clients over 15 tenants, one switched
   to the f32 backbone halfway, while the 16th floods past its quota:
   no capture after warmup, no failure, every rejection the flooder's
   ``TenantOverQuota``, every launch a replay, prototypes bit for bit an
   offline recompute, every answer (class ids and similarities) bit for
   bit the same query through a single ``ServeEngine``; requests/s,
   p50/p99, mean batch, and the busy share of a traced window.  Then a
   cold restart from the same cache directory (a fresh pipeline, registry
   and one-replica cluster): one hit per bucket, no new record, every
   first replay's digest equal to its record, answers bit for bit the
   first cluster's, ``add_replica`` warm with no lookup and no capture;
   warm seconds per bucket, miss against hit.
5. wide codes (path ``fsl_wide_codes``): ``grid_point(8, 8)`` and
   ``paper_w16a16()`` int artifacts (and w6a4 beside them) compiled on the
   card at the widest width their lowering admits, every MVAU on the
   route its codes name (the plane route, the 17-bit c2 of the 16-bit
   baseline too: six products; the (8, 8) point's 9-bit c2 two; none on
   the CUDA-core kernel) with its im2col folded in and r2b with the GAP
   epilogue; card == CPU bit for bit at batch 1 and on the timed batch-64
   forward; buckets 1 and 64 captured and replayed == eager; batch-64
   latency.
6. LM decode path, Qwen2.5-3B at full width and depth with random weights
   drawn on the card: ``qmatmul`` held against its plain version (ragged
   shapes, the 7 decode projections at batch 4, a prefill shape, forced K
   splits at both column-tile widths, the many-row kernel forced at every
   tile height on both sides of the crossover; w8 and w4; bit for bit on
   integer inputs on both kernels; two launches bit for bit; each call on
   the kernel its route names, both routes reached), then timed over one
   decode step's
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
   and greedy tokens are compared.  Last, a long prompt through the
   chunked attention, card against CPU within the same 0.0625 and timed:
   lm-tiny's float ``lm.forward`` at S 4,096 (chunk 8: one group of 512
   query blocks) and one full-width Qwen2.5-3B attention layer at S 4,096
   (chunk 1,024: groups of one block); no port kernel runs there.
6a. the recurrent-state and vision-language LM families (paths
   ``lm_families`` eager, ``lm_families_graph`` replays): ``qmatmul``
   held against its plain version at each (K, N) of the five configs'
   products (in phase 6's kernel check) and timed there at batch 4, w8
   and w4, beside its bound; mamba2-780m (48 Mamba2 blocks, tied head)
   and zamba2-7b (81 slots: 68 Mamba2 blocks and 13 invocations of one
   shared attention+MLP block, untied head) at full size, w8 and w4;
   qwen2-vl-7b (M-RoPE), qwen3-14b (qk-norm) and phi3-medium-14b at full
   width cut to 4 layers, w8: each through ``generate`` (batch 4, prompt
   8, 16 new tokens) eager and replayed, equal tokens, the logits of
   every step bit for bit, qmatmul launches a step (96, 228, 29), graph
   pool and weight bytes, ms a step eager and replayed, one profiled
   replay (kernels a step, device busy); a full-width copy of mamba2's
   first 2 slots and zamba2's first 6 (5 Mamba2 blocks and the shared
   block) decoded on the card and on the CPU at w8; qwen2-vl's forward
   over its 256-patch prefix (272 rows: every product on the many-row
   kernel) card vs CPU.
6c. MoE, MLA and the audio encoder-decoder (paths ``lm_moe_mla_audio``
   eager, ``lm_moe_mla_audio_graph`` replays): ``qmatmul`` held against
   its plain version at the four configs' 25 (M, K, N) (in phase 6's
   kernel check; whisper's encoder rows at M 6,000 bit for bit on integer
   inputs too) and timed there, w8 and w4, beside its bound and cuBLAS
   (the plain version too at M 6,000, on the many-row kernel);
   grok-1-314b (4 of 64 layers) and arctic-480b (2 of 35) at full width,
   their expert banks drawn on the card one expert at a time into codes,
   minicpm3-4b and whisper-tiny at full size, each at w8 and w4 through
   ``generate`` (batch 4, prompt 8, 16 new tokens) eager and replayed:
   equal tokens, the logits of every step bit for bit, qmatmul launches a
   step (113, 783, 435, 32), weight and graph pool bytes, ms a step eager
   and replayed, one profiled replay; whisper decodes an utterance's
   cross k/v from ``encode`` (24 launches at M 6,000) and
   ``build_cross_cache`` (8), all 32 on ``qmm_rows_kernel``, copied into
   the captured cross leaves; card
   against CPU at w8: 2 layers of grok and minicpm3, 1 of arctic (the
   routed experts equal wherever the router's k-th and (k+1)-th
   probabilities differ by more than 1e-3), whisper in full with its
   encoder output and cross k/v.
6b. compiled LM decode (paths ``lm_tiny_decode``, ``lm_tiny_serve``):
   the int8 MVAU in GEMM form at lm-tiny's ``w_down`` (M 1, 3 and 8, K 96,
   N 64, 255 levels; a table shared by every column and one per column:
   the small-M kernel) against its plain version, timed at M 1 and 8
   beside ``torch._int_mm`` + count, the wgmma kernel on the same inputs,
   an empty launch and its bound; lm-tiny at full size (seed 0, drawn on
   the card) through ``build_decode_artifact`` to int and f32 artifacts
   (golden-IO checked bit for bit); eager steps through ``DecodeArtifact``
   before warmup (2 ``mvau_int`` launches per int step, both on the
   small-M kernel, tokens == eager ``decode_step_ref``); one CUDA graph
   per bucket (1, 2, 4, 8) x capacity
   (32, 64): int replay == int eager == f32 == interpreter ==
   ``decode_step_ref``, bit for bit, at every pair, and each row of a
   bucket-8 step == that row at bucket 1; card against CPU on the same
   params (logits within 0.0625, greedy tokens equal where the CPU's top-2
   margin exceeds 0.125); step latency replayed and eager at batch 1 and
   8, the replayed int step profiled (exactly 2 ``mvau_small_m_kernel``
   and 0 ``mvau_conv_kernel`` a step) beside the f32 step (the kernels the
   int step spends more device time on);
   ``ServeEngine`` serving both artifacts through ``DecodeAdapter``: 16
   sequences from 4 threads through ``greedy_generate`` (20-40 new tokens,
   most crossing capacity 32), tokens == eager ``decode_step_ref`` and int
   == f32, no capture after warmup, every launch a replay; tokens/s,
   latency, and the device's busy share in a traced window.
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
9. LM training (path ``lm_train``): ``qwen2.5-3b`` at full width (d 2048,
   16 / 2 heads of 128, d_ff 11008, vocab 151,936, QKV bias, tied
   embeddings), cut to 4 of its 36 layers, bf16 compute with float32
   parameters and moments, through ``make_train_step(cfg, lr=3e-4)`` at
   grad_accum 2, batch 8, seq 128 on ``token_lm_batch`` data: 21 steps
   (the loss after 20 below step 0's, finite), ms per step (CUDA events on
   resident batches), tokens/s, kernels and device busy share of a traced
   step, peak memory; two same-seed runs of 3 steps bit for bit (losses,
   parameters, moments); 2 steps + a checkpoint in the reference's layout
   + a restore + 1 step == 3 straight, bit for bit; remat on == off (loss
   and gradients bit for bit, peak memory of both); one step with
   ``compress_pod_grads=True`` (residuals within half their leaf's int8
   step); the reference's smoke (``launch.train.main(["--arch",
   "qwen2.5-3b", "--reduced", "--steps", N, "--batch", "2", "--seq",
   "16", "--ckpt-dir", tmp])``, N = 1, 2, 3) on the card against the same
   run on the CPU (rtol 1e-5 at the first loss, 1e-4 after an update).
   No kernel of the port is on this path: its launch counts must all be 0.
10. distribution (path ``dist``), ``tools/dist_smoke.py --time``
   spawned twice from here (the kernel library built above is only
   loaded by the ranks): (a) one rank over NCCL: the int artifact behind a
   ``ShardedStore`` bit for bit the serial store, GPipe at one stage, the
   sharded train steps of reduced ``qwen2.5-3b`` and of reduced
   ``grok-1-314b`` (MoE at capacity factor 1.25: the expert-parallel
   dispatch, its buffers and kept masks == the serial dispatch's, and an
   overflowing routing through dispatch and combine) (DTensor params,
   moments and batch on the 1x1 debug mesh, ``acc_shardings``) against
   the plain step, the w8 and w4 decode of ``qwen3-14b`` at full width cut to 2
   layers (every projection ``qmatmul`` on the rank's columns) against the
   serial decode of the same codes, both bit for bit (nothing is split on
   1x1), ``restore_resharded`` bit for bit; (b) two ranks on this one card over ``gloo`` (NCCL takes no
   two ranks on one card; gloo stages CUDA tensors through the host): the
   sharded head across both (prototype rows split, 16 tenants' worth and
   C in {1, 3, 4, 8, 11}) bit for bit the serial head.  The checks gloo
   cannot run on CUDA tensors in torch 2.11 (point-to-point and DTensor's
   functional collectives end the rank) are named and left to the 4-card
   NCCL call of ``tools/dist_smoke.py``.  Sharded and serial ms of each
   check.  Each rank counts its launches over its sharded runs; the path
   is their sum and must show ``mvau_int``, ``mvau_int_gap`` and
   ``qmatmul``.
11. a JSON line of every kernel with its launches on its paths (the integer
   MVAU's also by route: int8 ``wgmma``, the small-M kernel, the plane
   route and CUDA cores; the small-M kernel and the plane route also as
   entries of their own; ``qmatmul``'s by
   route, decode and rows, the many-row kernel also as an entry of its
   own over whisper's 32 launches) and its numbers,
   the card's name and power limit, and a last line
   ``{"ok": true, "device": {...}}``.

Launch counters are set to 0 just before each path (the card runs of
phase 2a, phases 3-4, the
engine's traffic, the cluster's traffic, the counted forwards of phase 5,
the eager and the captured ``generate`` runs of phases 6, 6a and 6c
(with whisper's ``encode`` and ``build_cross_cache``), the
eager steps and the engine's traffic of phase 6b, phases 7, 8 and 9
as a whole, and each rank's sharded runs in phase 10) and read just after; launches made while comparing or timing
kernels do not count.  A graph's launches are recorded when it is
captured and counted at each replay: the paths ``fsl_serve``,
``cluster``, ``lm_decode_graph``, ``lm_families_graph``,
``lm_moe_mla_audio_graph`` and ``lm_tiny_serve`` are counted from replays
only (the script checks that
every launch there was one).
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
import traceback
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

    err = {"mvau_int": 0.0, "mvau_int_gap": 0.0, "mvau": 0.0, "gap": 0.0,
           "mvau_int_small_m": 0.0, "mvau_int_planes": 0.0}
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

    n_planes = check_plane_kernel(torch, KM, gen, err)
    log(f"kernel check mvau_int plane route (int8 tensor cores): {n_planes} "
        "cases bit for bit (uint8 codes x int8 weights; int16 codes, signed "
        "and unsigned to 65535, and int32 codes, signed and unsigned to "
        "2^24 - 1, x 16-bit weights' two byte planes or int8 weights' one: "
        "1, 4, 2, 6 and 3 products; codes at their extremes half the time; "
        "15 and 255 levels; conv form on every kernel/stride/pad, C 3, 16, "
        "24, N 8, 72, 136, K split planned, 2 and 3; the GEMM form; the GAP "
        "epilogue at OH·OW 16 and 4; 65,535 levels; K at PLANE_MAX_K; K past "
        "it, a third weight plane and unknown kinds refused)")

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


# the plane route's operand forms: (name, activation code range, weight
# code range); the route's kind and products follow from the ranges
# (kernels.mvau.int_route): u8 one u8.s8 product; s16/u16 (int16 codes,
# "u16" read as unsigned) x two weight planes, four products, and x one
# (int8 weights), two; s24/u24 (int32 codes of up to 24 bits) x two weight
# planes, six products, and x one, three
PLANE_KINDS = (("u8", (0, 256), (-128, 128)),
               ("s16", (-32768, 32768), (-32768, 32768)),
               ("u16", (0, 65536), (-32768, 32768)),
               ("s16w8", (-32768, 32768), (-128, 128)),
               ("u16w8", (0, 65536), (-128, 128)),
               ("s24", (-2**23, 2**23), (-32768, 32768)),
               ("u24", (0, 2**24), (-32768, 32768)),
               ("s24w8", (-2**23, 2**23), (-128, 128)),
               ("u24w8", (0, 2**24), (-128, 128)))


def plane_route(KM, kind):
    """(x kind, products, x_unsigned) of a PLANE_KINDS form."""
    _, (xlo, xhi), (wlo, whi) = next(k for k in PLANE_KINDS if k[0] == kind)
    route, xk, prods = KM.int_route((xlo, xhi - 1), (wlo, whi - 1), 27)
    check(route == "planes", f"{kind}: route {route}")
    return xk, prods, xk in ("u16", "u24")


def plane_operands(torch, KM, kind, xi, wi):
    """Codes ``xi`` (NHWC) and weights ``wi`` (K, N) as the plane route
    takes them for form ``kind``: uint8 codes and int8 weights, or int16
    codes (a wrapping cast of the low 16 bits) or int32 codes and the
    weights' byte planes (two, or one of int8 weights)."""
    xk, prods, _ = plane_route(KM, kind)
    if xk == "u8":
        return xi.to(torch.uint8).cuda(), wi.to(torch.int8).cuda()
    return (xi.to(torch.int32).to(KM.x_dtype(xk)).cuda(),
            KM.weight_planes(wi.to(torch.int32),
                             planes=prods // KM.x_planes(xk)).cuda())


def extreme_codes(torch, gen, lo, hi, shape):
    """Codes in [lo, hi): half of them at an end of the range."""
    v = torch.randint(lo, hi, shape, generator=gen)
    ends = torch.where(torch.rand(shape, generator=gen) < 0.5, lo, hi - 1)
    return torch.where(torch.rand(shape, generator=gen) < 0.5, ends, v)


def check_plane_kernel(torch, KM, gen, err):
    """The plane route of ``mvau_conv_kernel`` against its plain version,
    for every form of PLANE_KINDS (one u8.s8 product; 16-bit codes, signed
    and unsigned to 65535, against two weight planes (four products) or one
    (two); 24-bit codes, signed and unsigned to 2^24 - 1, against two (six)
    or one (three)): codes at their extremes half the time, so that the
    sums leave int32 and wrap alike in both; 15 and 255 levels; the conv
    form on every kernel/stride/pad, odd C, ragged M and N, with K split
    planned, 2 and 3; the GEMM form; the GAP epilogue at OH·OW 16 and 4
    with and without a split; 65,535 levels; K at PLANE_MAX_K.  Bit for
    bit.  Then the entry point refuses K past the limit, a third weight
    plane and an unknown kind, and the wrapper a K past the limit: nothing
    falls back to the CUDA cores."""
    n_cases = 0

    def one(got, want, label):
        torch.cuda.synchronize()
        d = (got - want).abs().max().item() if want.numel() else 0
        err["mvau_int_planes"] = max(err["mvau_int_planes"], float(d))
        check(torch.equal(got, want), f"mvau_int plane route {label} "
              f"differs by {d}")

    def tables(n, levels):
        return torch.sort(torch.randint(-2**31, 2**31 - 1, (n, levels),
                                        generator=gen), dim=1
                          ).values.to(torch.int32).cuda()

    for kind, (xlo, xhi), (wlo, whi) in PLANE_KINDS:
        xu = plane_route(KM, kind)[2]
        for levels in (15, 255):
            for kernel, stride, pad in KSP:
                for c, n in ((3, 8), (16, 72), (24, 136)):
                    k = kernel * kernel * c
                    xi = extreme_codes(torch, gen, xlo, xhi, (3, 9, 9, c))
                    wi = extreme_codes(torch, gen, wlo, whi, (k, n))
                    x, w = plane_operands(torch, KM, kind, xi, wi)
                    t = tables(n, levels)
                    want = KM.mvau_int_conv_plain(x, w, t, kernel, stride,
                                                  pad, -3, x_unsigned=xu)
                    label = (f"{kind} L={levels} C={c} N={n} k/s/p="
                             f"{kernel}/{stride}/{pad}")
                    for splits in (None, 2, 3):
                        one(KM.mvau_int_conv(x, w, t, kernel, stride, pad, -3,
                                             x_unsigned=xu, splits=splits),
                            want, f"{label} splits={splits}")
                        n_cases += 1
                    x2, w2 = plane_operands(torch, KM, kind,
                                            xi.reshape(-1, c), wi[:c])
                    one(KM.mvau_int(x2, w2, t, 5, x_unsigned=xu),
                        KM.mvau_int_plain(x2, w2, t, 5, x_unsigned=xu),
                        f"{label} GEMM form")
                    n_cases += 1
        for side, c, n in ((4, 16, 24), (2, 24, 72)):
            xi = extreme_codes(torch, gen, xlo, xhi, (5, side, side, c))
            wi = extreme_codes(torch, gen, wlo, whi, (9 * c, n))
            x, w = plane_operands(torch, KM, kind, xi, wi)
            t = tables(n, 15)
            skip = torch.randint(-2**20, 2**20, (5, side, side, n),
                                 generator=gen).to(torch.int32).cuda()
            want = KM.mvau_int_conv_gap_plain(x, w, t, skip, 3, 1, 1, 2,
                                              x_unsigned=xu)
            for splits in (None, 2):
                one(KM.mvau_int_conv_gap(x, w, t, skip, 3, 1, 1, 2,
                                         x_unsigned=xu, splits=splits),
                    want, f"{kind} GAP epilogue {side}x{side}x{c} N={n}")
                n_cases += 1
        # 65,535 levels (binary search), and K at the planes' limit (the
        # GEMM form, 130 rows, one split and several)
        xi = extreme_codes(torch, gen, xlo, xhi, (2, 9, 9, 16))
        wi = extreme_codes(torch, gen, wlo, whi, (144, 72))
        x, w = plane_operands(torch, KM, kind, xi, wi)
        t = tables(72, 65535)
        want = KM.mvau_int_conv_plain(x, w, t, 3, 1, 1, -3, x_unsigned=xu)
        for splits in (None, 2):
            one(KM.mvau_int_conv(x, w, t, 3, 1, 1, -3, x_unsigned=xu,
                                 splits=splits),
                want, f"{kind} L=65535 splits={splits}")
            n_cases += 1
        kmax = KM.PLANE_MAX_K
        xi = extreme_codes(torch, gen, xlo, xhi, (130, kmax))
        wi = extreme_codes(torch, gen, wlo, whi, (kmax, 24))
        x, w = plane_operands(torch, KM, kind, xi, wi)
        t = tables(24, 15)
        want = KM.mvau_int_plain(x, w, t, 0, x_unsigned=xu)
        one(KM.mvau_int(x, w, t, 0, x_unsigned=xu), want,
            f"{kind} K={kmax} (the limit)")
        for splits in (1, 4):
            one(KM.mvau_int_conv(x.reshape(1, 130, 1, kmax), w, t, 1, 1, 0,
                                 0, x_unsigned=xu, splits=splits
                                 ).reshape(130, 24),
                want, f"{kind} K={kmax} splits={splits}")
            n_cases += 1
        n_cases += 1
        if kind != "u8":
            xi = torch.zeros((4, kmax + 1), dtype=torch.int32)
            x, w = plane_operands(torch, KM, kind, xi,
                                  torch.zeros((kmax + 1, 8),
                                              dtype=torch.int32))
            try:
                KM.mvau_int(x, w, tables(8, 15), 0, x_unsigned=xu)
            except ValueError:
                pass
            else:
                raise SmokeFailure(f"{kind}: K {kmax + 1} past the planes' "
                                   "limit did not raise")
    # the entry point itself refuses what it does not take
    from repro_torch.kernels import build as B

    lib = B.library()
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int32, device="cuda")
    t = torch.zeros((8, 15), dtype=torch.int32, device="cuda")
    out = torch.empty((1, 4, 4, 8), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for x_kind, w_planes, c in ((4, 2, KM.PLANE_MAX_K + 16), (4, 3, 16),
                                (2, 0, 16), (6, 2, 16), (1, 1, 16)):
        w = torch.zeros((max(w_planes, 1), 8, KM.plane_depth(c)),
                        dtype=torch.int8, device="cuda")
        xx = (x if c == 16 else torch.zeros((1, 1, 1, c), dtype=torch.int32,
                                            device="cuda"))
        side = 4 if c == 16 else 1
        rc = lib.mvau_int_planes_conv(
            xx.data_ptr(), x_kind, w.data_ptr(), w_planes, t.data_ptr(),
            None, out.data_ptr(), 1, side, side, c, 1, 1, 0, 8, 15, 0, 1,
            None, None, stream)
        check(rc != 0, f"the plane entry took x_kind {x_kind}, w_planes "
              f"{w_planes}, C {c}")
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
            "int32_codes_bound_ms": 0.0, "int32_codes_library_ms": 0.0,
            "layer_ms": []}
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
        # its yardstick: torch.matmul in float64 on the patch rows (exact:
        # the sums lie far below 2^53), then the count
        xd, wd = x.to(torch.float64), w.to(torch.float64)

        def lib_f64():
            acc = torch.matmul(xd, wd).to(torch.int32)
            return ref.threshold_counts_fast(acc, t)

        check(torch.equal(lib_f64(), want), f"{name}: the float64 yardstick "
              "computes another function")
        core_lib = cuda_ms(torch, lib_f64, reps=5)
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
                       ("int32_codes_bound_ms", core_bound),
                       ("int32_codes_library_ms", core_lib)):
            conv[key] += v
        rows.append(("mvau_int", name, m, k, n, ms, plain, lib,
                     max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3,
                     f" gemm_form_ms={gemm_ms:.4f} gemm_form_bound_ms="
                     f"{max(gemm_bytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3:.4f}"
                     f" library_im2col_ms={lib2:.4f} splits="
                     f"{KM.tc_splits(m, n, k, sms)}; int32 codes (CUDA cores, "
                     f"conv form): kernel_ms={core_ms:.4f} plain_ms="
                     f"{core_plain:.4f} bound_ms={core_bound:.4f} library_ms="
                     f"{core_lib:.4f} (torch.matmul in float64 + count)"))

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
        f"{conv['int32_codes_plain_ms']:.4f} ms, torch.matmul in float64 + "
        f"count {conv['int32_codes_library_ms']:.4f} ms); "
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
    planes = time_plane_kernels(torch, KM, ref, gen, err)

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
              int32_codes_library_ms=conv["int32_codes_library_ms"],
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
        entry("mvau_int_planes", "src/repro_torch/csrc/mvau.cu",
              "src/repro/kernels/mvau.py:195", planes.pop("t"),
              PEAK_INT8_OPS, **planes),
    ]


# the plane route's forms timed at the main path's layer shapes: (key,
# PLANE_KINDS form, the timed codes' range or None for the form's own)
TIMED_PLANES = (("16", "u16", None), ("u8", "u8", None),
                ("x2w1", "u16w8", None), ("x3w2", "s24", (0, 2**17)))


def time_plane_kernels(torch, KM, ref, gen, err):
    """The plane route at the main path's 8 layer shapes at batch 64, 15
    levels: 16-bit codes (unsigned to 65535) x 16-bit weights as byte
    planes (the entry's numbers: four wgmma products a K-step); uint8 codes
    x int8 weights (one u8.s8 product: ``u8_*``); 16-bit codes x int8
    weights (two products: ``x2w1_*``); 17-bit codes as int32, the range of
    w16a16's c2, x 16-bit weights (three activation planes, six products:
    ``x3w2_*``).  Each layer is held against its plain version bit for bit
    twice: on codes at the form's extremes (int32 sums that wrap, alike in
    both), and on the timed codes, whose weights are bounded so that every
    sum fits int32 and the library yardstick (``torch.matmul`` in float64
    on pre-built patches, exact below 2^53, then the threshold count)
    computes the same function.  Beside each: the CUDA-core kernel on the
    same codes as int32 (``core_ms``).  The bound counts each operand read
    once (the codes as the kernel takes them, the weight planes, the
    tables) and the int32 codes written once, against the int8 tensor-core
    rate over the products' operations."""
    dev = "cuda"
    L = 15
    tot = {key: [0.0, 0.0, 0.0, 0, 0] for key, _, _ in TIMED_PLANES}
    core = {key: 0.0 for key, _, _ in TIMED_PLANES}
    forms = {kind: (xr, wr) for kind, xr, wr in PLANE_KINDS}
    layers = []
    for name, hw, cin, n in layer_shapes(WIDTH, BATCH, IMG):
        m, k = BATCH * hw * hw, 9 * cin
        row = {"layer": name}
        for key, kind, timed in TIMED_PLANES:
            (xlo, xhi), (wlo, whi) = forms[kind]
            _, prods, xu = plane_route(KM, kind)
            # extremes: wrapped sums, kernel == plain
            xe = extreme_codes(torch, gen, xlo, xhi, (BATCH, hw, hw, cin))
            we = extreme_codes(torch, gen, wlo, whi, (k, n))
            x, w = plane_operands(torch, KM, kind, xe, we)
            te = torch.sort(torch.randint(-2**31, 2**31 - 1, (n, L),
                                          generator=gen), dim=1
                            ).values.to(torch.int32).to(dev)
            got = KM.mvau_int_conv(x, w, te, 3, 1, 1, x_unsigned=xu)
            want = KM.mvau_int_conv_plain(x, w, te, 3, 1, 1, x_unsigned=xu)
            torch.cuda.synchronize()
            d = (got - want).abs().max().item()
            err["mvau_int_planes"] = max(err["mvau_int_planes"], float(d))
            check(torch.equal(got, want), f"mvau_int plane route {kind} "
                  f"{name} at its extremes differs by {d}")
            # the timed codes: every sum inside int32
            xlo, xhi = timed or (xlo, xhi)
            wlim = min(whi, max(1, (2**31 - 1) // (k * (xhi - 1))))
            xi = torch.randint(xlo, xhi, (BATCH, hw, hw, cin), generator=gen)
            wi = torch.randint(-wlim, wlim, (k, n), generator=gen)
            x, w = plane_operands(torch, KM, kind, xi, wi)
            tr = (xhi - 1) * wlim * math.isqrt(k)
            t = torch.sort(torch.randint(-tr, tr, (n, L), generator=gen),
                           dim=1).values.to(torch.int32).to(dev)
            x32 = xi.to(torch.int32).to(dev)
            w_core = wi.to(torch.int8 if whi <= 128 else torch.int16).to(dev)
            xp = ref.im2col(x32, 3, 1, 1).reshape(m, k).to(torch.float64)
            wd = wi.to(torch.float64).to(dev)

            def lib():
                acc = torch.matmul(xp, wd).to(torch.int32)
                return ref.threshold_counts_fast(acc, t)

            got = KM.mvau_int_conv(x, w, t, 3, 1, 1, x_unsigned=xu)
            want = KM.mvau_int_conv_plain(x, w, t, 3, 1, 1, x_unsigned=xu)
            check(torch.equal(got, want)
                  and torch.equal(got.reshape(m, n), lib())
                  and torch.equal(got, KM.mvau_int_conv(x32, w_core, t, 3, 1,
                                                        1)),
                  f"mvau_int plane route {kind} {name}: kernel, plain, "
                  "library and CUDA-core route disagree")
            ms = cuda_ms(torch, lambda: KM.mvau_int_conv(x, w, t, 3, 1, 1,
                                                         x_unsigned=xu))
            plain = cuda_ms(torch, lambda: KM.mvau_int_conv_plain(
                x, w, t, 3, 1, 1, x_unsigned=xu), reps=3)
            lib_ms = cuda_ms(torch, lib, reps=5)
            core_ms = cuda_ms(torch, lambda: KM.mvau_int_conv(
                x32, w_core, t, 3, 1, 1))
            nbytes = (x.element_size() * x.numel() + w.numel()
                      + 4 * t.numel() + 4 * m * n)
            ops = prods * 2 * m * k * n
            for i, v in enumerate((ms, plain, lib_ms, nbytes, ops)):
                tot[key][i] += v
            core[key] += core_ms
            bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS) * 1e3
            row[key] = {"ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                        "bound_ms": bound, "core_ms": core_ms}
            log(f"kernel mvau_int_planes {kind:5s} {name:4s} M={m:6d} "
                f"K={k:5d} N={n:4d}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
                f"({prods} products) cuda_core_ms={core_ms:.4f}")
        layers.append(row)
    bounds = {key: max(v[3] / PEAK_BYTES_PER_S, v[4] / PEAK_INT8_OPS) * 1e3
              for key, v in tot.items()}
    log(f"kernel mvau_int_planes sum over the 8 layers at batch {BATCH}: " +
        "; ".join(f"{key} {tot[key][0]:.4f} ms (bound {bounds[key]:.4f} ms, "
                  f"library {tot[key][2]:.4f} ms, CUDA-core kernel on the "
                  f"same codes {core[key]:.4f} ms)" for key, _, _ in
                  TIMED_PLANES))
    extra = {}
    for key in ("u8", "x2w1", "x3w2"):
        ms, plain, lib_ms = tot[key][:3]
        extra.update({f"{key}_ms": ms, f"{key}_plain_ms": plain,
                      f"{key}_library_ms": lib_ms,
                      f"{key}_bound_ms": bounds[key],
                      f"{key}_cuda_core_ms": core[key]})
    return {"t": tot["16"],
            "form": "conv, 16-bit codes as byte planes (4 wgmma products "
                    "a K-step), 15 levels; u8_*: uint8 codes x int8 "
                    "weights, one u8.s8 product; x2w1_*: 16-bit codes x "
                    "int8 weights, 2 products; x3w2_*: 17-bit codes as "
                    "int32 x 16-bit weights, 6 products",
            "cuda_core_ms": core["16"], **extra, "layer_ms": layers}


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


PROFILE_READS = 5


def traced_steps():
    """``torch.profiler.profile`` arguments for a traced run in two steps:
    a warm-up step whose events are dropped, then the step that is read.
    Started cold, the tracer has lost the first kernels of a run (a f32
    forward once read 9 kernels of its 14)."""
    from torch.profiler import ProfilerActivity, schedule

    return {"activities": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
            "schedule": schedule(wait=0, warmup=1, active=1, repeat=1)}


def traced_reads(torch, label: str, fn, reps: int):
    """Trace ``reps`` calls of ``fn`` (torch.profiler, CUDA activity) after
    one untraced call and one traced warm-up call whose events are dropped;
    returns the kernels' profiler events, the host wall time of the ``reps``
    calls in microseconds and their CUDA-event time in milliseconds.

    Every call of ``fn`` launches the same kernels, so each kernel's count
    is a multiple of ``reps``; a read where one is not has lost events in
    the tracer (a replayed int forward once read 22.4 kernels of its 27, a
    replayed w8 decode step 244.25 qmatmul kernels of its 252) and is
    traced again, at most PROFILE_READS times in all.  A kernel counted
    more often than its calls launch it still shows in the caller's
    checks, since a read is only ever repeated, never corrected."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for read in range(1, PROFILE_READS + 1):
        with profile(**traced_steps()) as prof:
            fn()                      # warm-up step: its events are dropped
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
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
    return kern, wall_us, start.elapsed_time(end)


def profile_forward(torch, label: str, fn, reps: int = 5,
                    batch: int = BATCH, unit: str = "forward", top: int = 0):
    """Device time by kernel over ``reps`` calls of ``fn`` (a forward at
    batch 64, or a training step; :func:`traced_reads`), the ``top``
    largest kernels printed (all with 0); returns the device-busy ms per
    call (None when the profiler saw no device time) and the kernels'
    profiler events.  The profiler's own host cost stretches the traced
    run's wall time, so the busy share printed here is a floor."""
    kern, wall_us, _ = traced_reads(torch, label, fn, reps)
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
    from repro_torch.core.build import RESNET9_BUILD_STEPS, build_dataflow
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
                "mvau_int_planes": 0, "mvau_int_planes2": 0,
                "mvau_int_planes6": 0, "mvau_int_small_m": 0, "mvau": 0,
                "gap": 0, "qmatmul": 0, "qmatmul_rows": 0},
          f"int forward launches {d}")
    f_f32, d = delta(lambda: dm_f32(x_q))
    check(d == {"mvau_int": 0, "mvau_int_gap": 0, "mvau_int_wide": 0,
                "mvau_int_planes": 0, "mvau_int_planes2": 0,
                "mvau_int_planes6": 0, "mvau_int_small_m": 0, "mvau": 8,
                "gap": 1, "qmatmul": 0, "qmatmul_rows": 0},
          f"f32 forward launches {d}")
    (f_interp,), d = delta(lambda: execute(dm_f32.graph, {"x": x_q}))
    check(d["mvau"] == 8, f"interpreter launches {d}")
    # the paper's customized build-step list (the deprecated shim over the
    # pass manager): its HW graph through the interpreter, every MVAU a
    # launch of the float kernel
    hw = build_dataflow(resnet9.export_graph(params, qcfg, width=WIDTH),
                        RESNET9_BUILD_STEPS)
    (f_hw,), d = delta(lambda: execute(hw, {"x": x_q}))
    check(d == {"mvau_int": 0, "mvau_int_gap": 0, "mvau_int_wide": 0,
                "mvau_int_planes": 0, "mvau_int_planes2": 0,
                "mvau_int_planes6": 0, "mvau_int_small_m": 0, "mvau": 8,
                "gap": 0, "qmatmul": 0, "qmatmul_rows": 0},
          f"build_dataflow graph launches {d}")
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
    (f_hw_cpu,) = execute(hw, {"x": x_q.cpu()})
    check(torch.equal(f_hw, f_f32) and torch.equal(f_hw.cpu(), f_hw_cpu),
          "build_dataflow's HW graph on the card != the recipe artifact or "
          "!= its CPU run")
    log("build_dataflow(RESNET9_BUILD_STEPS): HW graph on the card == the "
        "recipe artifact == its CPU run, bit for bit (8 mvau launches)")
    log("main path: int == f32 == interpreter on the card, card == CPU, "
        "bit for bit")
    # the int artifact lowered without either GAP fold (the add and the GAP
    # as launches of their own, as before the fused tail): the "before" of
    # this run's latency and profile; its launches are not the path's
    saved = dict(B.launch_counts)
    unfused = unfused_lowering(dm_int)
    f_unf, d = delta(lambda: unfused(x))
    check(d == {"mvau_int": 8, "mvau_int_gap": 0, "mvau_int_wide": 0,
                "mvau_int_planes": 0, "mvau_int_planes2": 0,
                "mvau_int_planes6": 0, "mvau_int_small_m": 0, "mvau": 0,
                "gap": 1, "qmatmul": 0, "qmatmul_rows": 0}
          and torch.equal(f_unf, f_int),
          f"unfused int forward: launches {d}, or features differ")
    B.launch_counts.update(saved)

    pipe = FSLPipeline(width=WIDTH, qcfg=qcfg, device="cuda")
    feats = pipe.deploy(params, datapath="int")
    f_flip, d = delta(lambda: feats(x))
    check(d == {"mvau_int": 16, "mvau_int_gap": 2, "mvau_int_wide": 0,
                "mvau_int_planes": 0, "mvau_int_planes2": 0,
                "mvau_int_planes6": 0, "mvau_int_small_m": 0, "mvau": 0,
                "gap": 0, "qmatmul": 0, "qmatmul_rows": 0},
          f"flip ensemble {d}")
    feats_f32 = pipe.deploy(params, datapath="f32")
    f_flip32, d = delta(lambda: feats_f32(x))
    check(d == {"mvau_int": 0, "mvau_int_gap": 0, "mvau_int_wide": 0,
                "mvau_int_planes": 0, "mvau_int_planes2": 0,
                "mvau_int_planes6": 0, "mvau_int_small_m": 0, "mvau": 16,
                "gap": 2, "qmatmul": 0, "qmatmul_rows": 0},
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
# Phase 2a: the differential fuzz on the card
# ---------------------------------------------------------------------------
FUZZ_OUTPUTS = ("interpreter", "f32", "int_unfused", "int")


def fuzz_path(torch, np, B):
    """Phase 2a (path ``fuzz``): every graph of ``core.fuzz``'s three card
    ranges (the reference's corpus, ``REFERENCE_SEEDS``, the wide one,
    ``WIDE_SEEDS``, and the dense one, ``GEMM_SEEDS``) through
    ``check_differential`` on the card, then on the CPU; each card output
    equals its CPU counterpart and the CPU interpreter's output.  The
    launch counts cover the card runs only.  Returns the path's counts and
    the phase's numbers."""
    from repro_torch.core import fuzz

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    graphs = [(name, seed, gen(seed)[:2])
              for name, gen, seeds in (
                  ("reference", fuzz.random_hw_graph, fuzz.REFERENCE_SEEDS),
                  ("wide", fuzz.wide_hw_graph, fuzz.WIDE_SEEDS),
                  ("gemm", fuzz.gemm_hw_graph, fuzz.GEMM_SEEDS))
              for seed in seeds]
    failures, card = [], {}
    B.reset_launch_counts()
    t_card = time.perf_counter()
    for name, seed, (g, x) in graphs:
        try:
            card[name, seed] = fuzz.check_differential(g, x)
        except Exception:                 # noqa: BLE001 -- logged, then fails
            failures.append(f"{name} {seed} card: "
                            f"{traceback.format_exc(limit=-4)}")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t_card
    counts = dict(B.launch_counts)
    routes: dict = {}
    gemm_wgmma: set = set()
    tails = residuals = float_adds = 0
    for name, seed, (g, x) in graphs:
        if (name, seed) not in card:
            continue
        got = card[name, seed]
        try:
            cpu = fuzz.check_differential(g, x, "cpu")
        except Exception:                 # noqa: BLE001 -- logged, then fails
            failures.append(f"{name} {seed} cpu: "
                            f"{traceback.format_exc(limit=-4)}")
            continue
        for key in FUZZ_OUTPUTS:
            for other in (key, "interpreter"):
                if not fuzz.same_output(got[key], cpu[other]):
                    failures.append(f"{name} {seed}: card {key} != cpu "
                                    f"{other}")
        for art in ("f32", "int"):
            summary = fuzz.lowering_summary(got["artifacts"][art], x, sms)
            for n in summary["mvau"]:
                routes.setdefault(n["route"], set()).add(
                    (n["m"], n["k"], n["n"], n["levels"], n["splits"]))
                if n["route"] == "int8" and n["form"] == "gemm":
                    gemm_wgmma.add((n["m"], n["k"], n["n"], n["levels"]))
            if art == "int":
                tails += summary["gap_tails"]
                residuals += summary["residual_gaps"]
                float_adds += summary["float_adds"]
    seconds = time.perf_counter() - t_phase
    by_corpus = {c: [s for n, s, _ in graphs if n == c]
                 for c in ("reference", "wide", "gemm")}
    log(f"fuzz: reference seeds {min(by_corpus['reference'])}-"
        f"{max(by_corpus['reference'])}, wide seeds "
        f"{min(by_corpus['wide'])}-{max(by_corpus['wide'])}, dense seeds "
        f"{min(by_corpus['gemm'])}-{max(by_corpus['gemm'])}: "
        f"{len(graphs)} graphs x 4 engines on the card and on the CPU; "
        f"failures {len(failures)}; card runs {t_card:.2f} s, phase "
        f"{seconds:.2f} s")
    for f in failures:
        log(f"  fuzz FAILED {f}")
    for route, shapes in sorted(routes.items()):
        m, k, n, lv = (max(s[i] for s in shapes) for i in range(4))
        log(f"  fuzz route {route}: {len(shapes)} distinct (M, K, N, L); "
            f"up to M {m}, K {k}, N {n}, L {lv}; M > 128 with a ragged "
            f"tile {sum(s[0] > 128 and s[0] % 128 > 0 for s in shapes)}, "
            f"N > 128 {sum(s[2] > 128 for s in shapes)}, L > 64 "
            f"{sum(s[3] > 64 for s in shapes)}; K split (M, K, N, L, "
            f"splits) {sorted(s for s in shapes if s[4] > 1)}")
    rows = sorted(s[0] for s in gemm_wgmma) or ["-"]
    log(f"  fuzz int8 GEMM form past the small-M limit (wgmma): "
        f"{len(gemm_wgmma)} distinct (M, K, N, L), M {rows[0]}-{rows[-1]}")
    log(f"  fuzz int artifacts: {tails} fused GAP tails, {residuals} "
        f"residual GAPs, {float_adds} float adds; launches {counts}")
    check(not failures, f"fuzz: {len(failures)} failures: {failures[:5]}")
    # the corpora's codes fit 16 bits: the integer MVAUs run the int8
    # wgmma, small-M and plane routes (the CUDA-core integer route is held
    # by the kernel phase's int32 codes)
    check(counts["mvau"] > 0 and counts["mvau_int_gap"] > 0
          and counts["gap"] > 0 and counts["mvau_int_planes"] > 0
          and counts["mvau_int_small_m"] > 0
          and counts["mvau_int"] - counts["mvau_int_wide"]
          - counts["mvau_int_small_m"] - counts["mvau_int_planes"] > 0
          and bool(routes.get("planes")),
          f"fuzz path: a kernel never ran: {counts}")
    check(bool(gemm_wgmma) and bool(routes.get("int8_small_m")),
          "fuzz path: the int8 GEMM form did not reach both its routes")
    return counts, {"seconds": seconds, "card_seconds": t_card,
                    "graphs": len(graphs), "failures": len(failures)}


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


CLUSTER_TENANTS = 16
CLUSTER_REQUESTS = 1024        # classify requests of 1-4 frames, 4 clients
CLUSTER_FLOOD_MAX = 5000       # the flooder's submits at most
CLUSTER_BACKBONES = ("w6a4-int", "f32")


def cluster_registry(qcfg, params):
    """A fresh pipeline (nothing warm in memory) and a
    ``sharded_tenant_registry`` with the int flip ensemble as the default
    backbone and the f32 one beside it."""
    from repro_torch.fsl.pipeline import FSLPipeline
    from repro_torch.serve.cluster import sharded_tenant_registry

    pipe = FSLPipeline(width=WIDTH, qcfg=qcfg, device="cuda")
    reg = sharded_tenant_registry()
    reg.register_backbone("w6a4-int", pipe.deploy(params, datapath="int"),
                          default=True)
    reg.register_backbone("f32", pipe.deploy(params, datapath="f32"))
    return reg


def warm_log(reg):
    """Per backbone, the warm seconds of each bucket and whether the cache
    held its record."""
    return {bb: [(e["bucket"], e["seconds"], e["cached"])
                 for e in reg.get(bb).feats._exec.compile_log]
            for bb in CLUSTER_BACKBONES}


def cluster_phase(torch, np, B):
    """The multi-tenant cluster on the card at width 64: ``ServeCluster``
    with 2 replicas over a ``sharded_tenant_registry`` (the int flip
    ensemble, the f32 one beside it), max_batch 64, a tenant quota of a
    quarter of the queue, warmed through a ``CompileCache`` in a fresh
    directory.  16 tenants each register 5 classes x 5 shots; 4 closed-loop
    clients send 1,024 classify requests of 1-4 frames spread over 15
    tenants, one of which is switched to the f32 backbone halfway, while
    the 16th floods past its quota.  Checks: no capture after warmup,
    nothing failed, every rejection the flooder's ``TenantOverQuota``,
    every launch a graph replay, each tenant's prototypes bit for bit an
    offline recompute, and every answer (class ids and similarities) bit
    for bit the same query through a single ``ServeEngine``.  Then a cold
    restart: a fresh pipeline, registry and one-replica cluster over the
    same cache directory: one hit per bucket and backbone, no new record,
    every digest matched, the restarted cluster's answers bit for bit the
    first's, and ``add_replica`` warm from the shared artifacts.  Logs the
    warm seconds per bucket (miss against hit), requests/s, p50/p99, mean
    batch and the device's busy share in a traced window.  Returns the
    traffic's launch counts (path ``cluster``)."""
    import tempfile

    B.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cluster-cache-",
                                     dir=str(B.BUILD_DIR)) as cache_dir:
        return _cluster_run(torch, np, B, cache_dir)


def _register_all(cluster, reg, tenants, switched, shots):
    """Every tenant's shots, one register request per class and in order
    (so each lies in its own bucket-8 batch); the tenant to be switched
    registers on the f32 backbone too."""
    for t in tenants:
        for w, x in shots[t].items():
            for bb in CLUSTER_BACKBONES if t == switched else ("w6a4-int",):
                cluster.submit_register(t, w, x, artifact=bb).result(120)


def _cluster_run(torch, np, B, cache_dir):
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import profile

    from repro_torch.ckpt import CompileCache
    from repro_torch.fsl import ncm
    from repro_torch.serve import ServeEngine, pad_to_bucket
    from repro_torch.serve.cluster import ServeCluster, TenantOverQuota

    t_phase = time.perf_counter()
    qcfg, params, data, _, _ = fsl_setup(torch, np)
    tenants = [f"t{i:02d}" for i in range(CLUSTER_TENANTS)]
    flooder, switched = tenants[-1], tenants[-2]
    rng = np.random.default_rng(21)
    shots, pools = {}, {}
    for t in tenants:
        ep = data.episode(rng, 5, 5, 40)
        shots[t] = {w: ep["support_x"][ep["support_y"] == w]
                    for w in range(5)}
        pools[t] = ep["query_x"]
    plan = []
    for i in range(CLUSTER_REQUESTS):
        t = tenants[i % (CLUSTER_TENANTS - 1)]
        n = int(rng.integers(1, 5))
        plan.append((t, pools[t][rng.integers(0, len(pools[t]), n)]))
    flood_x = pools[flooder][:4]
    cache = CompileCache(cache_dir)
    reg = cluster_registry(qcfg, params)
    cluster = ServeCluster(reg, replicas=2, max_batch=64, batch_wait_ms=2.0,
                           tenant_quota=0.25, compile_cache=cache)
    n_buckets = len(cluster.engines[0].buckets)
    try:
        for t in tenants:
            cluster.add_tenant(t)
        t0 = time.perf_counter()
        base = cluster.warmup(img=IMG)
        warm_s = time.perf_counter() - t0
        check(all(base[bb] == n_buckets for bb in CLUSTER_BACKBONES)
              and len(set(base.values())) == 1,
              f"captures after the cluster's warmup {base}")
        st = cache.stats()
        check(st == {"hits": 0, "misses": 2 * n_buckets,
                     "stores": 2 * n_buckets, "load_errors": 0,
                     "entries": 2 * n_buckets},
              f"cold warmup's cache stats {st}")
        cold_log = warm_log(reg)
        _register_all(cluster, reg, tenants, switched, shots)
        tables = {bb: reg.get(bb).feats._exec for bb in CLUSTER_BACKBONES}
        start = {id(g): g.replays for t in tables.values()
                 for g in t.graphs.values()}
        B.reset_launch_counts()
        for eng in cluster.engines:
            eng.metrics.reset_clock()
        results, lat, errors = {}, {}, []
        half = threading.Barrier(ENGINE_THREADS + 1)
        flood = {"submitted": 0, "rejected": 0, "futs": []}
        flooding = threading.Event()

        def client(k):
            try:
                mine = list(range(k, len(plan), ENGINE_THREADS))
                for j, i in enumerate(mine):
                    if j == len(mine) // 2:
                        half.wait()
                    t, x = plan[i]
                    t1 = time.perf_counter()
                    results[i] = cluster.submit_classify(t, x).result(120)
                    lat[i] = time.perf_counter() - t1
            except Exception as e:                    # noqa: BLE001
                errors.append(repr(e))
                half.abort()

        def flood_client():
            # open loop: submit without waiting until the quota bites
            try:
                while flood["submitted"] < CLUSTER_FLOOD_MAX and (
                        flood["rejected"] == 0 or flood["submitted"] < 500):
                    try:
                        flood["futs"].append(cluster.submit_classify(
                            flooder, flood_x))
                    except TenantOverQuota:
                        flood["rejected"] += 1
                    flood["submitted"] += 1
            except Exception as e:                    # noqa: BLE001
                errors.append(repr(e))
            flooding.set()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(ENGINE_THREADS)]
        threads.append(threading.Thread(target=flood_client))
        for th in threads:
            th.start()
        half.wait()
        reg.set_tenant_default(switched, "f32")          # per-tenant A/B
        for th in threads:
            th.join()
        for f in flood["futs"]:
            f.result(120)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(B.launch_counts)
        check(not errors, f"cluster clients failed: {errors[:3]}")
        traces = cluster.trace_counts()
        snap = cluster.metrics_snapshot()
        engine_snaps = snap["replicas"]
    finally:
        cluster.stop()
    check(traces == base, f"captures after warmup: {traces} != {base}")
    n_flood = len(flood["futs"])
    n_req = len(plan)
    check(flood["rejected"] > 0, f"the flooder was never over quota "
          f"({flood['submitted']} submits)")
    check(snap["completed"] == n_req + n_flood
          and snap["over_quota"] == flood["rejected"] == snap["rejected"],
          f"cluster: {snap['completed']} completed, {snap['rejected']} "
          f"rejected, {snap['over_quota']} over quota; the flooder "
          f"{flood['rejected']} rejected of {flood['submitted']}")
    check(all(s["failed"] == 0 for s in snap["tenants"].values())
          and all(s["over_quota"] == 0 for t, s in snap["tenants"].items()
                  if t != flooder),
          f"per-tenant failures or rejections {snap['tenants']}")
    by_art = {}
    for t, _ in plan:
        by_art.setdefault(t, set())
    for i, r in results.items():
        by_art[plan[i][0]].add(r.artifact)
    check(by_art[switched] == {f"{switched}/w6a4-int", f"{switched}/f32"},
          f"{switched} served by {by_art[switched]}: the switch did not land")
    # every launch of the traffic a replay of a warmed graph
    replayed = {k: 0 for k in counts}
    for t in tables.values():
        for g in t.graphs.values():
            for k, v in g.launches.items():
                replayed[k] += v * (g.replays - start.get(id(g), 0))
    check(counts == replayed, f"cluster launches {counts} != replays "
          f"{replayed}")

    # prototypes: bit for bit an offline recompute through the same feats,
    # padded to the bucket the engine padded each register to
    def offline(bb, x):
        padded, n, _ = pad_to_bucket(x, cluster.engines[0].buckets)
        return reg.get(bb).feats(padded)[:n]

    labs = torch.as_tensor(np.repeat(np.arange(5), 5))
    for t in tenants:
        for bb in (("w6a4-int", "f32") if t == switched else ("w6a4-int",)):
            sup = torch.cat([offline(bb, shots[t][w]) for w in range(5)])
            want = ncm.class_means(sup, labs, 5).cpu().numpy()
            got, ids = reg.tenant_store(t, bb).prototypes()
            check(ids == (0, 1, 2, 3, 4) and np.array_equal(got, want),
                  f"{t}/{bb}: prototypes != offline recompute")

    # the same queries through a single ServeEngine over the same registry
    single = ServeEngine(reg, max_batch=64, max_queue=512, batch_wait_ms=2.0)
    again, errs = {}, []

    def ask_single(k):
        try:
            for i in range(k, n_req, ENGINE_THREADS):
                t, x = plan[i]
                again[i] = single.submit_classify(
                    x, artifact=results[i].artifact, tenant=t).result(120)
        except Exception as e:                        # noqa: BLE001
            errs.append(repr(e))

    try:
        check(single.warmup(img=IMG) == base, "a capture at the single "
              "engine's warmup")
        ths = [threading.Thread(target=ask_single, args=(k,))
               for k in range(ENGINE_THREADS)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
    finally:
        single.stop()
    check(not errs, f"single engine failed: {errs[:3]}")
    for i in range(n_req):
        a, b = results[i], again[i]
        check(a.class_ids == b.class_ids and np.array_equal(a.sims, b.sims),
              f"request {i} ({plan[i][0]}): cluster answer != single "
              "engine's")
    lats = np.sort(np.asarray([lat[i] for i in range(n_req)])) * 1e3
    p50, p99 = np.percentile(lats, 50), np.percentile(lats, 99)
    batches = sum(s["batches"] for s in engine_snaps)
    mean_batch = (sum(s["mean_batch"] * s["batches"] for s in engine_snaps)
                  / max(batches, 1))
    log(f"cluster: 2 replicas, {len(tenants)} tenants x 5 classes x 5 "
        f"shots; warmup {warm_s:.3f} s ({2 * n_buckets} captures, "
        f"{2 * n_buckets} records published); {n_req} classify requests of "
        f"1-4 frames from {ENGINE_THREADS} closed-loop clients over "
        f"{len(tenants) - 1} tenants ({switched} switched to f32 halfway) in "
        f"{wall:.3f} s while {flooder} flooded: {flood['submitted']} "
        f"submits, {flood['rejected']} TenantOverQuota, {n_flood} served; "
        f"no capture after warmup; 0 failed; prototypes bit for bit the "
        f"offline recompute; every answer bit for bit the single engine's; "
        f"every launch a replay: {replayed}")
    log(f"cluster metrics, {ENGINE_THREADS} closed-loop clients + a "
        f"flooder: {(n_req + n_flood) / wall:.1f} requests/s "
        f"({n_req / wall:.1f} of the clients'), client p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms, mean batch {mean_batch:.2f} over {batches} "
        "batches")
    log("cluster cold warm seconds per bucket (miss): " + "; ".join(
        f"{bb} " + ", ".join(f"b{b} {s:.4f}" for b, s, c in rows)
        for bb, rows in cold_log.items()))

    # -- the traced window: the same clients' traffic again ------------------
    n_traced = min(400, n_req)
    traced = ServeCluster(reg, replicas=2, max_batch=64, batch_wait_ms=2.0,
                          tenant_quota=0.25, compile_cache=cache)
    try:
        for t in tenants:
            traced.add_tenant(t)
        check(traced.warmup(img=IMG) == base, "a capture at a second "
              "cluster's warmup")
        with profile(**traced_steps()) as prof:
            t, x = plan[0]
            traced.submit_classify(t, x).result(120)
            prof.step()
            t0 = time.perf_counter()
            errs = []

            def closed(k):
                try:
                    for i in range(k, n_traced, ENGINE_THREADS):
                        t, x = plan[i]
                        traced.submit_classify(t, x).result(120)
                except Exception as e:                # noqa: BLE001
                    errs.append(repr(e))

            ths = [threading.Thread(target=closed, args=(k,))
                   for k in range(ENGINE_THREADS)]
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            torch.cuda.synchronize()
            twall = time.perf_counter() - t0
            prof.step()
        check(not errs, f"traced window failed: {errs[:3]}")
    finally:
        traced.stop()
    busy_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep"))
    log(f"cluster traced window, {ENGINE_THREADS} closed-loop clients: "
        f"{n_traced} requests in {twall * 1e3:.3f} ms, "
        f"{n_traced / twall:.1f} requests/s, "
        "device busy " + ("not measured (no CUDA events)" if busy_us <= 0
                          else f"{busy_us / 1e3:.3f} ms = "
                          f"{busy_us / (twall * 1e6):.1%} of the window"))

    # -- cold restart: a fresh pipeline, registry and cluster ----------------
    stats_before = cache.stats()
    entries = set(cache.keys())
    cache2 = CompileCache(cache_dir)                   # a new process's view
    reg2 = cluster_registry(qcfg, params)
    restarted = ServeCluster(reg2, replicas=1, max_batch=64,
                             batch_wait_ms=2.0, tenant_quota=0.25,
                             compile_cache=cache2)
    try:
        for t in tenants:
            restarted.add_tenant(t)
        reg2.set_tenant_default(switched, "f32")
        t0 = time.perf_counter()
        base2 = restarted.warmup(img=IMG)
        warm2_s = time.perf_counter() - t0
        st2 = cache2.stats()
        check(st2 == {"hits": 2 * n_buckets, "misses": 0, "stores": 0,
                      "load_errors": 0, "entries": 2 * n_buckets}
              and set(cache2.keys()) == entries,
              f"restart's cache stats {st2} (first {stats_before})")
        check(base2 == base, f"restart's captures {base2} != {base}")
        hot_log = warm_log(reg2)
        check(all(c for rows in hot_log.values() for _, _, c in rows),
              f"a restored bucket not marked cached: {hot_log}")
        _register_all(restarted, reg2, tenants, switched, shots)
        def again2(i):
            t, x = plan[i]
            return restarted.submit_classify(
                t, x, artifact=results[i].artifact.split("/")[1]).result(120)

        t0 = time.perf_counter()
        first = again2(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        for i in range(64):
            r = first if i == 0 else again2(i)
            check(r.artifact == results[i].artifact
                  and r.class_ids == results[i].class_ids
                  and np.array_equal(r.sims, results[i].sims),
                  f"restarted cluster's answer to request {i} != the "
                  "first cluster's")
        st_add = cache2.stats()
        t0 = time.perf_counter()
        restarted.add_replica()
        add_s = time.perf_counter() - t0
        check(cache2.stats() == st_add and restarted.trace_counts() == base2
              and len(restarted.engines) == 2,
              "add_replica looked up the cache or captured")
        check(np.array_equal(again2(0).sims, first.sims), "a request after "
              "add_replica differs")
    finally:
        restarted.stop()
    log(f"cluster cold restart: 1 replica warmed in {warm2_s:.3f} s, "
        f"{st2['hits']} hits = {2 * n_buckets} buckets, 0 stores, every "
        f"digest matched; first request served in {first_ms:.3f} ms, 64 "
        f"answers bit for bit the first cluster's; add_replica "
        f"{add_s * 1e3:.3f} ms, no lookup, no capture")
    log("cluster restart warm seconds per bucket (hit): " + "; ".join(
        f"{bb} " + ", ".join(f"b{b} {s:.4f}" for b, s, c in rows)
        for bb, rows in hot_log.items()))
    log(f"cluster phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


def wide_code_path(torch, np, B):
    """The int artifacts whose codes do not fit int8 -- ``grid_point(8, 8)``
    (8-bit unsigned activations; 9-bit at c2, whose input is a residual
    sum) and the paper's 16-bit baseline ``paper_w16a16()`` (16-bit codes;
    17-bit at c2) -- compiled on the card at the widest of widths 64, 32,
    16, 8 that the integer lowering admits (it refuses a layer whose
    reachable sums leave int32): every MVAU on the tensor cores' plane
    route (uint8 codes as one u8.s8 product, wider ones as byte planes:
    (8, 8)'s c2 two products against one weight plane, w16a16's 16-bit
    layers four, its 17-bit c2 six), none on the CUDA-core kernel, each
    with its im2col folded in and r2b with the GAP epilogue: card == CPU
    bit for bit at batch 1 and 64, launches per forward, the buckets 1 and
    64 captured as CUDA graphs and replayed == eager, batch-64 latency
    beside w6a4's.  Returns the launch counts of the counted forwards."""
    import repro_torch
    from repro_torch.core.graph import GraphBuildError
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels import ops as kops
    from repro_torch.models import resnet9

    data = SyntheticImages(n_base=32, n_novel=10, seed=0, img=IMG)
    rng = np.random.default_rng(3)
    x_np, _ = data.batch(rng.integers(0, 42, BATCH),
                         rng.integers(0, 10_000, BATCH))
    x = torch.from_numpy(x_np).cuda()
    counts = {k: 0 for k in B.launch_counts}
    lat = {}
    labels = {"int8": "fused-cuda", "planes": "fused-cuda-planes",
              "core": "fused-cuda-core"}
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
        g = dm.graph
        routes = {n.outputs[0]: kops.int_route_of(n, g)
                  for n in g.nodes if n.op == "mvau_int"}
        table = {r["tensor"]: r["kernel"] for r in dm.dispatch_table()}
        layers = [(n.outputs[0].split("_")[0], table[n.outputs[0]],
                   f"{g.dtypes[n.inputs[0]].total_bits}-bit codes",
                   f"{routes[n.outputs[0]][2]} products",
                   str(g.initializers[n.inputs[1]].dtype))
                  for n in g.nodes if n.op == "mvau_int"]
        int8 = label == "paper_w6a4()"
        # every MVAU on the tensor cores
        want = {n.outputs[0]: "int8" if int8 else "planes"
                for n in g.nodes if n.op == "mvau_int"}
        prods = [r[2] for r in routes.values()]
        p2, p6 = prods.count(2), prods.count(6)
        check(int8 or (p2, p6) == ((1, 0) if label == "grid_point(8, 8)"
                                   else (0, 1)),
              f"{label}: products a K-step {prods}")
        check({t: r[0] for t, r in routes.items()} == want
              and all(table[t] == labels[r] for t, r in want.items())
              and len(dm.apply.folded) == 10
              and "r2b_res" in dm.apply.folded,
              f"{label}: {layers}, folded {dm.apply.folded}")
        params_cpu = {k: {kk: v.cpu() for kk, v in blk.items()}
                      for k, blk in params.items()}
        dm_cpu = repro_torch.compile(params_cpu, qcfg, recipe="resnet9",
                                     datapath="int", device="cpu")
        check(dm.weight_bytes() == dm_cpu.weight_bytes(),
              f"{label}: weight bytes differ between card and CPU")
        B.reset_launch_counts()
        f = dm(x[:1])
        torch.cuda.synchronize()
        run = dict(B.launch_counts)
        check(run == {"mvau_int": 8, "mvau_int_gap": 1,
                      "mvau_int_planes": 0 if int8 else 8,
                      "mvau_int_planes2": p2, "mvau_int_planes6": p6,
                      "mvau_int_wide": 0, "mvau_int_small_m": 0,
                      "mvau": 0, "gap": 0, "qmatmul": 0, "qmatmul_rows": 0},
              f"{label} forward launches {run}")
        for k, v in run.items():
            counts[k] += v
        check(f.shape == (1, 8 * width) and bool(torch.isfinite(f).all()),
              f"{label}: features {tuple(f.shape)}")
        check(torch.equal(f.cpu(), dm_cpu(x_np[:1])),
              f"{label}: card features != CPU features")
        f = dm(x)
        check(torch.equal(f.cpu(), dm_cpu(x_np)),
              f"{label}: card features != CPU features at batch {BATCH}")
        lat[label] = wall_ms(torch, lambda: dm(x), reps=5)
        # buckets 1 and 64 as CUDA graphs: each replay == the eager run;
        # these launches are no path's
        saved = dict(B.launch_counts)
        dm.warmup((1, BATCH), x[:1])
        for b in (1, BATCH):
            (eager,) = dm.apply(x[:b])
            check(torch.equal(dm.batched(x[:b]), eager)
                  and torch.equal(eager, f[:b]),
                  f"{label}: bucket {b} replay != eager")
        B.launch_counts.update(saved)
        log(f"{label} int artifact at width {width} (compiled on the card in "
            f"{secs:.2f} s, weight bytes {dm.weight_bytes()}): card == CPU "
            f"bit for bit at batch 1 and {BATCH}, buckets 1 and {BATCH} "
            f"replayed == eager; launches a forward {run}; "
            f"batch {BATCH} {lat[label]:.3f} ms ({BATCH / lat[label] * 1e3:.1f}"
            f" images/s); layers (name, kernel, codes, products, weight "
            f"codes): {layers}")
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
# card vs CPU with MoE: the routed experts must agree wherever the CPU
# router's k-th and (k+1)-th probabilities are further apart than this
MOE_ROUTE_MARGIN = 1e-3
# a long prompt through the chunked attention (``layers._chunked_sdpa``):
# lm-tiny's chunk of 8 makes one group of all 512 query blocks, the Qwen
# layer's chunk of 1,024 four groups of one block each
LONG_PREFILL_S = 4096


def _projections(cfg):
    """(name, K, N) of the 7 quantized projections of one layer."""
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    return [("wq", d, cfg.n_heads * cfg.hd), ("wk", d, kv), ("wv", d, kv),
            ("wo", cfg.n_heads * cfg.hd, d), ("w_gate", d, f),
            ("w_up", d, f), ("w_down", f, d)]


def _leaf(blocks, name):
    return blocks["mlp" if name.startswith("w_") else "attn"][name]


def check_qmatmul(torch, Q, KQ, B, cfg, extra=()):
    """qmatmul against its plain version on the card: ragged M, N, K (the
    scalar and the vector weight loads), the decode shapes at batch 4, the
    (M, K, N) of ``extra`` (their codes drawn on the card), one prefill
    shape (batch 4 x prompt 8) and ragged many-row shapes, f32 and bf16 x,
    w8 and w4; each call launches the kernel its route names (``qmm_route``:
    ``qmm_kernel``, or ``qmm_rows_kernel`` counted in ``qmatmul_rows``),
    and both routes are reached.  The many-row kernel is also forced at
    every tile height on ragged shapes on both sides of the crossover.  The
    ``extra`` shapes with M above 1,000 (whisper's encoder) are held bit
    for bit on integer inputs too.
    Tolerance: only the order of the float32 sum differs, so the error is
    held within 2e-5 of S = sum_k |bf16(x)| |code| scale (plus one bf16
    rounding of the output for bf16 x).  On integer-valued x with small
    codes every partial sum is an integer below 2^24: bit for bit.
    Returns the largest errors at the decode shapes and on the rows
    route."""
    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(4321)
    on_card = torch.Generator(device=dev).manual_seed(4321)
    shapes = [(1, 32, 16), (5, 130, 66), (3, 37, 12), (9, 515, 264),
              (70, 300, 130), (130, 37, 66), (1000, 300, 264),
              (257, 1536, 1536)]
    shapes += [(LM_BATCH, k, n) for _, k, n in _projections(cfg)]
    shapes.append((LM_BATCH * LM_PROMPT, cfg.d_model, cfg.d_ff))
    wide = list(dict.fromkeys(extra))
    shapes += wide
    decode = {(LM_BATCH, k, n) for _, k, n in _projections(cfg)} | set(wide)
    worst = {"abs": 0.0, "of_tol": 0.0, "rel_f32": 0.0, "abs_decode": 0.0,
             "abs_extra": 0.0, "abs_rows": 0.0}
    n_checked = 0
    routes = {"decode": 0, "rows": 0}
    for bits in (8, 4):
        lim = 8 if bits == 4 else 128
        for m, k, n in shapes:
            g = on_card if (m, k, n) in wide else gen
            codes = torch.randint(-lim, lim, (k, n), generator=g,
                                  device=g.device)
            w = (Q.pack_int4(codes.to(torch.int32)) if bits == 4
                 else codes.to(torch.int8)).to(dev)
            s = (torch.rand((n,), generator=g, device=g.device) * 0.02
                 + 0.001).to(dev)
            route = KQ.qmm_route(m, k, n, sms, bits)
            for xdt in (torch.float32, torch.bfloat16):
                x = (torch.rand((m, k), generator=g, device=g.device) * 2
                     - 1).to(xdt).to(dev)
                rows0 = B.launch_counts["qmatmul_rows"]
                got = KQ.qmatmul(x, w, s, bits)
                check(B.launch_counts["qmatmul_rows"] - rows0
                      == int(route == "rows"),
                      f"qmatmul {m}x{k}x{n} w{bits}: route {route} but "
                      f"{B.launch_counts['qmatmul_rows'] - rows0} launches "
                      "of the rows kernel")
                routes[route] += 1
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
                if (m, k, n) in wide:
                    worst["abs_extra"] = max(worst["abs_extra"],
                                             d.max().item())
                if route == "rows":
                    worst["abs_rows"] = max(worst["abs_rows"],
                                            d.max().item())
                n_checked += 1
        # the many-row kernel forced at every tile height, on both sides of
        # the crossover (9 x 264 and 63 x 264 below ROWS_MN)
        for m, k, n in ((9, 300, 264), (63, 1536, 264), (65, 37, 66),
                        (130, 300, 1536), (1000, 1536, 66)):
            codes = torch.randint(-lim, lim, (k, n), generator=gen)
            w = (Q.pack_int4(codes.to(torch.int32)) if bits == 4
                 else codes.to(torch.int8)).to(dev)
            s = (torch.rand((n,), generator=gen) * 0.02 + 0.001).to(dev)
            for xdt in (torch.float32, torch.bfloat16):
                x = (torch.rand((m, k), generator=gen) * 2 - 1).to(xdt).to(dev)
                want = KQ.qmatmul_plain(x, w, s, bits).float()
                tol = 2e-5 * (x.to(torch.bfloat16).float().abs()
                              @ codes.to(dev).float().abs()) * s
                if xdt == torch.bfloat16:
                    tol = tol + want.abs() * 2.0 ** -7
                for bm in KQ.ROWS_BMS:
                    got = KQ.qmatmul(x, w, s, bits, route="rows", bm=bm)
                    d = (got.float() - want).abs()
                    check(bool((d <= tol).all()),
                          f"qmatmul rows kernel {m}x{k}x{n} w{bits} {xdt} "
                          f"bm {bm} differs by {d.max().item():.3g}")
                    check(torch.equal(got, KQ.qmatmul(
                        x, w, s, bits, route="rows", bm=bm)),
                          f"qmatmul rows kernel {m}x{k}x{n} w{bits}: two "
                          "launches differ")
                    worst["abs_rows"] = max(worst["abs_rows"],
                                            d.max().item())
                    n_checked += 1
        lim = 8 if bits == 4 else 32
        for m, k, n in ((LM_BATCH, cfg.d_model, 256), (LM_BATCH, cfg.d_ff,
                                                       cfg.d_model), (7, 100, 18),
                        *[s for s in wide if s[0] > 1000]):
            codes = torch.randint(-lim, lim, (k, n), generator=gen)
            w = (Q.pack_int4(codes.to(torch.int32)) if bits == 4
                 else codes.to(torch.int8)).to(dev)
            x = torch.randint(-16, 17, (m, k), generator=gen).float().to(dev)
            s = torch.full((n,), 0.5, device=dev)
            want = KQ.qmatmul_plain(x, w, s, bits)
            check(torch.equal(KQ.qmatmul(x, w, s, bits), want),
                  f"qmatmul {m}x{k}x{n} w{bits} on integers is not bit "
                  "for bit")
            if m > 1:
                check(torch.equal(KQ.qmatmul(x, w, s, bits, route="rows"),
                                  want),
                      f"qmatmul rows kernel {m}x{k}x{n} w{bits} on integers "
                      "is not bit for bit")
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
    check(routes["decode"] > 0 and routes["rows"] > 0,
          f"qmatmul's check reached only {routes}")
    log(f"kernel check qmatmul: {n_checked} cases, w8 and w4, f32 and bf16 "
        f"x, {routes['decode']} calls on the decode route and "
        f"{routes['rows']} on the rows route (ROWS_M {KQ.ROWS_M}, ROWS_MN "
        f"{KQ.ROWS_MN}), each "
        "launching its route's kernel; the rows kernel forced at every tile "
        "height on 5 ragged shapes (M 9 to 1,000); forced splits 1/2/4/8/5 "
        f"at both tile widths; max abs err "
        f"{worst['abs']:.3g} (decode shapes {worst['abs_decode']:.3g}, rows "
        f"route {worst['abs_rows']:.3g}); "
        f"max err / applied tolerance {worst['of_tol']:.3g} (passes at <= 1; "
        f"the tolerance is 2e-5 sum|bf16(x)||code|scale, plus one bf16 "
        f"rounding of the output for bf16 x); for f32 x, max err / "
        f"sum|bf16(x)||code|scale {worst['rel_f32']:.3g} (tolerance 2e-5); "
        "integer inputs bit for bit; two launches bit for bit at the decode "
        "shapes")
    if wide:
        log(f"kernel check qmatmul at the LM families' {len(wide)} (M, K, N) "
            f"({', '.join(f'{m}x{k}x{n}' for m, k, n in wide)}), w8 and w4, "
            f"f32 and bf16 x: max abs err {worst['abs_extra']:.3g}; two "
            "launches bit for bit; integer inputs bit for bit at M > 1000 "
            "on both kernels")
    return worst["abs_decode"], worst["abs_rows"]


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
    """Device time by kernel over ``reps`` decode steps
    (:func:`traced_reads`) and, in the same traced run, the CUDA-event time
    from the first step's start to the last one's end: the busy share of
    that one run.  The profiler's host cost stretches the traced run, so
    the share is a floor for the untraced loop."""
    kern, _, elapsed = traced_reads(torch, label, step_fn, reps)
    elapsed /= reps
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


def _tokens(torch, prompt, t):
    return torch.as_tensor(prompt[:, t:t + 1], dtype=torch.int32,
                           device="cuda")


def _fresh_cache(cfg, steps, cross=None, device="cuda"):
    """A decode cache for one generation of ``steps`` steps; whisper's
    cross k/v copied in from ``cross``."""
    from repro_torch.launch.steps import model_module

    cache = model_module(cfg).init_cache(cfg, LM_BATCH, steps + 1,
                                         device=device)
    if cross is not None:
        for name in ("k", "v"):
            cache["cross"][name].copy_(cross[name])
    return cache


def decode_ms(torch, cfg, tree, prompt, n_timed, cross=None):
    """The eager decode step after the prompt, greedy, in a cache the size
    of one generation: CUDA-event ms a step over ``n_timed`` steps and the
    host's ms a step.  The logits after them are checked finite."""
    from repro_torch.launch.steps import make_decode_step, model_module

    decode = make_decode_step(cfg)
    cache = _fresh_cache(cfg, LM_PROMPT + LM_TOKENS, cross)
    for t in range(LM_PROMPT):
        tok, cache = decode(tree, {"tokens": _tokens(torch, prompt, t)},
                            cache)
    tok = tok[:, None]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    for _ in range(n_timed):
        nxt, cache = decode(tree, {"tokens": tok}, cache)
        tok = nxt[:, None]
    end.record()
    end.synchronize()
    host = (time.perf_counter() - h0) * 1e3 / n_timed
    logits, _ = model_module(cfg).decode_step(tree, tok, cache, cfg)
    check(bool(torch.isfinite(logits[:, :cfg.vocab].float()).all()),
          "logits after the timed decode steps not finite")
    return start.elapsed_time(end) / n_timed, host


def replay_ms(torch, st, prompt, n_timed, cross=None):
    """The captured step ``st`` replayed after the prompt: CUDA-event ms a
    step over ``n_timed`` replays and the host's ms a step."""
    st.reset(cross)
    for t in range(LM_PROMPT):
        st.step(_tokens(torch, prompt, t))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    for _ in range(n_timed):
        st.step()
    end.record()
    end.synchronize()
    host = (time.perf_counter() - h0) * 1e3 / n_timed
    return start.elapsed_time(end) / n_timed, host


def check_replay_logits(torch, label, cfg, tree, st, prompt, cross=None):
    """The captured step ``st`` beside the eager ``decode_step`` over the
    prompt and LM_TOKENS greedy tokens: the logits of every step finite
    and bit for bit, and the greedy tokens equal."""
    from repro_torch.launch.steps import greedy, model_module

    steps = LM_PROMPT + LM_TOKENS
    st.reset(cross)
    cache = _fresh_cache(cfg, steps, cross)
    tok = None
    for t in range(steps):
        feed = _tokens(torch, prompt, t) if t < LM_PROMPT else tok
        logits, cache = model_module(cfg).decode_step(tree, feed, cache, cfg)
        tok = greedy(logits, cfg)[:, None]
        st.step(feed)
        check(bool(torch.isfinite(logits[:, :cfg.vocab].float()).all()),
              f"{label} step {t}: logits not finite")
        check(torch.equal(st.logits, logits) and torch.equal(st.tokens, tok),
              f"{label} step {t}: the captured step's logits or tokens != "
              "the eager step's")


def card_vs_cpu(torch, label, cfg, tree, prompt, steps):
    """``tree``, the float32 parameters of the full-width cut ``cfg`` on
    the card, quantized to w8 on the card and on the CPU (the codes
    checked equal) and decoded on both (:func:`decode_card_vs_cpu`).
    Returns the largest difference."""
    from repro_torch.launch.steps import quantize_tree_for_serving
    from repro_torch.models import lm
    from repro_torch.tree import tree_flatten, tree_map

    q_dev = lm.with_head_copy(quantize_tree_for_serving(tree, 8), cfg)
    q_cpu = lm.with_head_copy(quantize_tree_for_serving(
        tree_map(lambda t: t.cpu(), tree), 8), cfg)
    for a, b in zip(tree_flatten(q_dev)[0], tree_flatten(q_cpu)[0]):
        check(torch.equal(a.cpu(), b), f"{label}: w8 codes or scales differ "
              "between card and CPU")
    return decode_card_vs_cpu(torch, label, cfg, q_dev, q_cpu, prompt,
                              steps)


class RouteRecorder:
    """Records every MoE routing (router probabilities and chosen experts)
    while active, by device: a wrapper around ``layers.moe_route``."""

    def __init__(self):
        from repro_torch.models import layers

        self.layers, self.orig = layers, layers.moe_route
        self.calls = {"cpu": [], "cuda": []}

    def __enter__(self):
        def route(p, flat, cfg):
            probs, gates, idx = self.orig(p, flat, cfg)
            self.calls[probs.device.type].append((probs.float().cpu(),
                                                  idx.cpu()))
            return probs, gates, idx

        self.layers.moe_route = route
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.orig


def decode_card_vs_cpu(torch, label, cfg, q_dev, q_cpu, prompt, steps,
                       crosses=None):
    """The same serving tree on the card (``q_dev``) and on the CPU
    (``q_cpu``) decoded on both: the prompt teacher-forced, then the CPU's
    greedy tokens fed to both.  Logits within CPU_CHECK_TOL; greedy tokens
    equal where the CPU's top-2 margin exceeds twice it.  With MoE the
    routed experts (as sets) must be equal wherever the CPU router's k-th
    and (k+1)-th probabilities differ by more than MOE_ROUTE_MARGIN; a
    sequence routed apart at a closer tie is compared up to that step
    only.  ``crosses`` ({"cuda", "cpu"}) are whisper's cross k/v.  Returns
    the largest difference."""
    import contextlib

    from repro_torch.launch.steps import model_module

    mod = model_module(cfg)
    caches = {dev: _fresh_cache(cfg, steps, None if crosses is None
                                else crosses[dev], dev)
              for dev in ("cuda", "cpu")}
    k = cfg.moe_top_k
    rec = RouteRecorder() if cfg.moe_experts else contextlib.nullcontext()
    apart = {}                        # sequence -> step its routes parted
    tok = None
    worst, compared, skipped, routed, gaps_min = 0.0, 0, 0, 0, math.inf
    t0 = time.perf_counter()
    with rec:
        for t in range(steps):
            feed = (torch.as_tensor(prompt[:, t:t + 1], dtype=torch.int32)
                    if t < prompt.shape[1] else tok)
            lc, caches["cpu"] = mod.decode_step(q_cpu, feed, caches["cpu"],
                                                cfg)
            lg, caches["cuda"] = mod.decode_step(q_dev, feed.cuda(),
                                                 caches["cuda"], cfg)
            if cfg.moe_experts:
                for (pc, ic), (_, ig) in zip(rec.calls["cpu"],
                                             rec.calls["cuda"]):
                    top = torch.sort(pc, dim=-1, descending=True).values
                    gap = top[:, k - 1] - top[:, k]
                    same = (ic.sort(-1).values == ig.sort(-1).values).all(-1)
                    for b in range(ic.shape[0]):
                        if b in apart:
                            continue
                        if not bool(same[b]):
                            check(float(gap[b]) <= MOE_ROUTE_MARGIN,
                                  f"{label} step {t}, sequence {b}: experts "
                                  f"{ic[b].tolist()} on the CPU, "
                                  f"{ig[b].tolist()} on the card, at a gap "
                                  f"{float(gap[b]):.3g}")
                            apart[b] = t
                        else:
                            routed += 1
                            gaps_min = min(gaps_min, float(gap[b]))
                rec.calls = {"cpu": [], "cuda": []}
            rows = [b for b in range(lc.shape[0]) if b not in apart]
            lc = lc[rows, :cfg.vocab].float()
            lg = lg[rows, :cfg.vocab].float().cpu()
            check(bool(torch.isfinite(lg).all()), f"{label}: card logits not "
                  "finite")
            if rows:
                worst = max(worst, float((lg - lc).abs().max()))
                top2 = torch.topk(lc, 2, dim=-1).values
                sure = (top2[:, 0] - top2[:, 1]) > 2 * CPU_CHECK_TOL
                check(torch.equal(lg.argmax(-1)[sure], lc.argmax(-1)[sure]),
                      f"{label} step {t}: greedy tokens differ between card "
                      "and CPU at a top-2 margin above twice the tolerance")
                compared += int(sure.sum())
                skipped += int((~sure).sum())
            full = torch.zeros((LM_BATCH, 1), dtype=torch.int32)
            full[rows] = lc.argmax(-1, keepdim=True).to(torch.int32)
            tok = full
    check(worst <= CPU_CHECK_TOL,
          f"{label}: card and CPU logits differ by {worst}")
    forced = min(steps, prompt.shape[1])
    log(f"{label} card vs CPU ({cfg.n_layers} layer slots, full width, "
        f"{steps} steps: {forced} teacher-forced, then the CPU's greedy "
        f"tokens; {time.perf_counter() - t0:.1f} s): logits within "
        f"{worst:.4g} (tolerance {CPU_CHECK_TOL}); greedy tokens equal at "
        f"{compared} decisions, {skipped} skipped at a top-2 margin <= "
        f"{2 * CPU_CHECK_TOL}"
        + (f"; routed experts equal at {routed} (token, layer) choices, "
           f"smallest k-th/(k+1)-th gap among them {gaps_min:.3g}; "
           f"sequences routed apart at a gap <= {MOE_ROUTE_MARGIN}: "
           f"{apart or 'none'}" if cfg.moe_experts else ""))
    return worst


def lm_path(torch, np, B, Q, KQ):
    """The port's LM decode-serving path at Qwen2.5-3B's full width and
    depth on the card, at w8 and w4; returns the qmatmul kernel's numbers
    and the path's launch counts."""
    import dataclasses

    from repro_torch.launch.serve import generate, graphed_step
    from repro_torch.launch.steps import (make_decode_step,
                                          quantize_tree_for_serving)
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.tree import tree_flatten, tree_map

    cfg = get_config(LM_ARCH)
    err, err_rows = check_qmatmul(torch, Q, KQ, B, cfg,
                                  extra=family_shapes() + mma_shapes()
                                  + vlm_prefix_shapes())

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
    check(counts["qmatmul_rows"] == 0, f"decode steps launched the rows "
          f"kernel: {counts}")
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
        check_replay_logits(torch, f"lm w{bits}", cfg, q[bits], graphs[bits],
                            prompt)
        log(f"lm decode graph w{bits}: logits and greedy tokens of all "
            f"{steps} steps equal the eager step's bit for bit")

    # -- per-step decode latency, untraced ----------------------------------
    n_timed = LM_TOKENS // 2
    step_ms = {}
    for bits, tree in ((8, q[8]), (4, q[4]), (0, p0)):
        step_ms[bits], host = decode_ms(torch, cfg, tree, prompt, n_timed)
        log(f"lm decode step {'bf16' if bits == 0 else f'w{bits}'} "
            f"(untraced, {n_timed} steps): {step_ms[bits]:.3f} ms/step "
            f"between CUDA events, host {host:.3f} ms/step, "
            f"{LM_BATCH / step_ms[bits] * 1e3:.1f} tok/s; logits finite")

    graph_ms = {}
    for bits in (8, 4):
        graph_ms[bits], host = replay_ms(torch, graphs[bits], prompt, n_timed)
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
    decode = make_decode_step(cfg)
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
    del p0
    card_vs_cpu(torch, "lm", dataclasses.replace(
        cfg, n_layers=CPU_CHECK_LAYERS), dict(params, blocks=tree_map(
            lambda t: t[:CPU_CHECK_LAYERS].contiguous(), params["blocks"])),
        prompt, CPU_CHECK_STEPS)
    long_prefill(torch, np)

    w8, w4 = timing[8], timing[4]
    entry = {"name": "qmatmul", "route": "cuda",
             "source": "src/repro_torch/csrc/qmatmul.cu",
             "replaces": "src/repro/kernels/qmatmul.py:64",
             "launches": counts["qmatmul"], "max_abs_err": err,
             "max_abs_err_rows": err_rows,
             "ms": w8["ms"], "plain_ms": w8["plain_ms"],
             "bound_ms": w8["bound_ms"], "bound_by": w8["bound_by"],
             "library_ms": w8["library_ms"],
             "per": f"one {LM_ARCH} decode step at batch {LM_BATCH}, w8 "
                    f"({QMM_LAUNCHES_PER_STEP} launches)",
             "w4": {k: w4[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}
    return entry, counts, graph_counts


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def long_prefill(torch, np):
    """The chunked attention at a long prompt, card against CPU: lm-tiny's
    float ``lm.forward`` (``quant=None``) at S 4,096, its chunk of 8 one
    group of 512 query blocks, and one attention layer of Qwen2.5-3B at
    full width at S 4,096, its chunk of 1,024 groups of one block.  Each
    output within ``CPU_CHECK_TOL`` of the CPU's (the LM rule), finite,
    and timed on the card.  No port kernel runs here."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.tree import tree_map

    S = LONG_PREFILL_S
    card = card_line()
    gen = np.random.default_rng(0)

    def compare(label, fn_cpu, fn_card, groups):
        t0 = time.perf_counter()
        want = fn_cpu()
        cpu_s = time.perf_counter() - t0
        got = fn_card()
        torch.cuda.synchronize()
        check(tuple(got.shape) == tuple(want.shape)
              and bool(torch.isfinite(got).all()),
              f"{label}: shape {tuple(got.shape)} or non-finite values")
        worst = float((got.float().cpu() - want.float()).abs().max())
        check(worst <= CPU_CHECK_TOL, f"{label}: card vs CPU {worst} > "
              f"{CPU_CHECK_TOL}")
        ms = wall_ms(torch, fn_card, reps=3)
        log(f"long prefill {label} at S {S} ({groups}): card vs CPU "
            f"{worst:.4g} (<= {CPU_CHECK_TOL}; output max "
            f"{float(want.float().abs().max()):.3g}), {ms:.3f} ms on the "
            f"card ({card}), CPU {cpu_s:.2f} s")

    cfg = dataclasses.replace(get_config("lm-tiny"), quant=None)
    chunk = cfg.prefill_chunk
    g = L._group_blocks(S // chunk, chunk)
    check(g == S // chunk, f"lm-tiny: a group of {g} blocks at S {S}")
    p_cpu = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    p_dev = tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.from_numpy(gen.integers(0, cfg.vocab, (1, S))
                            .astype(np.int32))
    toks_dev = toks.cuda()
    compare("lm-tiny float lm.forward",
            lambda: lm.forward(p_cpu, {"tokens": toks}, cfg)[0],
            lambda: lm.forward(p_dev, {"tokens": toks_dev}, cfg)[0],
            f"chunk {chunk}, one group of {g} blocks")

    cfg = get_config(LM_ARCH)
    chunk = cfg.prefill_chunk
    g = L._group_blocks(S // chunk, chunk)
    check(g == 1, f"{LM_ARCH}: a group of {g} blocks at chunk {chunk}")
    dt = getattr(torch, cfg.compute_dtype)
    a_cpu = L.attn_init(torch.Generator().manual_seed(0), cfg)
    a_dev = tree_map(lambda t: t.cuda(), a_cpu)
    x = torch.from_numpy(gen.standard_normal((1, S, cfg.d_model))
                         .astype(np.float32)).to(dt)
    x_dev, pos = x.cuda(), torch.arange(S)[None]
    pos_dev = pos.cuda()
    compare(f"{LM_ARCH} attention layer",
            lambda: L.attention(a_cpu, x, cfg, pos)[0],
            lambda: L.attention(a_dev, x_dev, cfg, pos_dev)[0],
            f"chunk {chunk}, {S // chunk} groups of 1 block, {dt}")


# ---------------------------------------------------------------------------
# Phase 6a: the recurrent-state and vision-language LM families
# ---------------------------------------------------------------------------
FAMILY_FULL = ("mamba2-780m", "zamba2-7b")            # at full size
FAMILY_CUT = ("qwen2-vl-7b", "qwen3-14b", "phi3-medium-14b")
FAMILY_CUT_LAYERS = 4           # full width; the cut of depth (PERF.md §4)
# card against CPU: layer slots of a full-width copy (zamba2's first six
# slots hold five Mamba2 blocks and one invocation of the shared block)
FAMILY_CPU_SLOTS = {"mamba2-780m": 2, "zamba2-7b": 6}
FAMILY_CPU_STEPS = 8
FAMILY_TIMED = 8
FAMILY_PROFILE_REPS = 3
FAMILY_QMM_STREAM_BYTES = 256e6  # codes streamed per timed shape (> L2)
FAMILY_VLM_TEXT = 16             # text tokens after the vision prefix


def family_config(name: str):
    import dataclasses

    from repro_torch.models.common import get_config

    cfg = get_config(name)
    if name in FAMILY_CUT:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_CUT_LAYERS)
    return cfg


def family_products(cfg):
    """(name, K, N, launches a decode step) of every quantized product of
    one decode step at serving bits: the Mamba2 in/out projections, the
    attention block's 7 (the hybrid's shared block at each invocation)
    and an untied head."""
    from repro_torch.models.lm import _layer_kinds

    kinds = _layer_kinds(cfg)
    out = []
    n_mamba = kinds.count("mamba")
    if n_mamba:
        di, gn = cfg.d_inner, 2 * cfg.ssm_groups * cfg.ssm_state
        out += [("in_proj", cfg.d_model, 2 * di + gn + cfg.ssm_heads,
                 n_mamba), ("out_proj", di, cfg.d_model, n_mamba)]
    n_attn = kinds.count("attn") + kinds.count("shared")
    if n_attn:
        out += [(name, k, n, n_attn) for name, k, n in _projections(cfg)]
    if not cfg.tie_embeddings:
        out.append(("lm_head", cfg.d_model, cfg.vocab_padded, 1))
    return out


def family_shapes():
    """The distinct (M, K, N) of the five configs' quantized products at
    batch LM_BATCH."""
    shapes = []
    for name in FAMILY_FULL + FAMILY_CUT:
        for _, k, n, _ in family_products(family_config(name)):
            if (LM_BATCH, k, n) not in shapes:
                shapes.append((LM_BATCH, k, n))
    return shapes


def vlm_prefix_shapes():
    """The (M, K, N) of qwen2-vl's forward over its patch prefix and
    FAMILY_VLM_TEXT text tokens (:func:`vlm_card_vs_cpu`): every product
    on the many-row route."""
    cfg = family_config("qwen2-vl-7b")
    m = cfg.vision_patches + FAMILY_VLM_TEXT
    return list(dict.fromkeys((m, k, n) for _, k, n, _ in
                              family_products(cfg)))


def time_family_qmatmul(torch, Q, KQ, shapes):
    """qmatmul at each (M, K, N) of ``shapes``, bf16 x, w8 and w4 (held
    against its plain version at these shapes in :func:`check_qmatmul`):
    CUDA-event ms a launch over enough copies of random codes to stream
    FAMILY_QMM_STREAM_BYTES from memory (nothing sits in the 50 MB L2),
    beside the bound (the larger of codes + scales + x + out bytes at
    3.35 TB/s and 2MKN at the bf16 peak) and the library yardstick, cuBLAS
    bf16 on codes cast to bf16 before the timing, times the scale.
    On the many-row route the plain version is timed too.  Returns
    {(bits, M, K, N): {"ms", "bound_ms", "bound_by", "library_ms",
    "plain_ms" (None on the decode route), "route", "tile", "bytes_ms",
    "ops_ms"}}."""
    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for bits in (8, 4):
        lim = 8 if bits == 4 else 128
        for m, k, n in shapes:
            nbytes = k * n // (2 if bits == 4 else 1)
            copies = int(min(64, max(2, math.ceil(FAMILY_QMM_STREAM_BYTES
                                                  / nbytes))))
            ints = [torch.randint(-lim, lim, (k, n), generator=gen,
                                  device=dev, dtype=torch.int32)
                    for _ in range(copies)]
            codes = [Q.pack_int4(c) if bits == 4 else c.to(torch.int8)
                     for c in ints]
            w16 = [c.to(torch.bfloat16) for c in ints]
            del ints
            s = torch.rand((n,), generator=gen, device=dev) * 0.02 + 0.001
            x = (torch.rand((m, k), generator=gen, device=dev) * 2
                 - 1).to(torch.bfloat16)
            ms = cuda_ms(torch, lambda: [KQ.qmatmul(x, c, s, bits)
                                         for c in codes], reps=3,
                         sleep_cycles=QMM_SLEEP_CYCLES) / copies
            lib = cuda_ms(torch, lambda: [(torch.matmul(x, w) * s).to(
                torch.bfloat16) for w in w16], reps=3,
                sleep_cycles=QMM_SLEEP_CYCLES) / copies
            route = KQ.qmm_route(m, k, n, sms, bits)
            tile = (KQ.rows_plan(m, k, n, sms, bits)[:2] if route == "rows"
                    else KQ.split_plan(m, k, n, sms, bits)[:2])
            plain = None
            if route == "rows":
                plain = cuda_ms(torch, lambda: [KQ.qmatmul_plain(x, c, s, bits)
                                                for c in codes], reps=1,
                                sleep_cycles=QMM_SLEEP_CYCLES) / copies
            b_ms = (nbytes + 4 * n + 2 * m * (k + n)) / PEAK_BYTES_PER_S * 1e3
            o_ms = 2 * m * k * n / PEAK_BF16_OPS * 1e3
            by = "bytes" if b_ms >= o_ms else "operations"
            out[(bits, m, k, n)] = {"ms": ms, "bound_ms": max(b_ms, o_ms),
                                    "bound_by": by, "library_ms": lib,
                                    "plain_ms": plain, "route": route,
                                    "tile": list(tile), "bytes_ms": b_ms,
                                    "ops_ms": o_ms}
            log(f"kernel qmatmul w{bits} M={m:5d} K={k:5d} N={n:6d} "
                f"({'qmm_rows_kernel' if route == 'rows' else 'qmm_kernel'}, "
                f"tiles of {tile[0]} rows x {tile[1]} columns): "
                f"kernel_ms={ms:.4f} "
                + ("" if plain is None else f"plain_ms={plain:.4f} ")
                + f"library_ms={lib:.4f} bound_ms="
                f"{max(b_ms, o_ms):.4f} ({by}; {max(b_ms, o_ms) / ms:.1%} of "
                f"the bound's rate; {lib / ms:.2f}x the library's speed; "
                f"{nbytes / ms / 1e6:.0f} GB/s of codes, "
                f"{copies} copies streamed)")
            del codes, w16
    torch.cuda.empty_cache()
    return out


def family_serve(torch, np, B, name, cfg, tree, bits, per_step, sums,
                 paths=("lm_families", "lm_families_graph"), cross=None):
    """One config at one bit-width through ``generate``: eager (counted
    into ``sums[paths[0]]``), then the captured step (its replays counted
    into ``sums[paths[1]]``), equal tokens, logits of every step bit for
    bit; ms a step eager and replayed, and one profiled replay.  ``cross``
    is whisper's cross k/v of an utterance.  Returns the numbers it
    printed."""
    from repro_torch.launch.serve import generate, graphed_step

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    steps = LM_PROMPT + LM_TOKENS
    label = f"{name} w{bits}"

    B.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = generate(tree, cfg, prompt, LM_TOKENS, graph=False, cross=cross)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    counts = dict(B.launch_counts)
    check(tuple(eager.shape) == (LM_BATCH, LM_TOKENS)
          and bool(((eager >= 0) & (eager < cfg.vocab)).all()),
          f"{label}: generated {tuple(eager.shape)} or a token outside the "
          "vocabulary")
    check(counts == {**{k: 0 for k in counts},
                     "qmatmul": per_step * steps},
          f"{label}: eager launches {counts}, expected {per_step} qmatmul a "
          f"step over {steps} steps")
    for k, v in counts.items():
        sums[paths[0]][k] += v

    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    t0 = time.perf_counter()
    st = graphed_step(tree, cfg, LM_BATCH, steps + 1, torch.device("cuda"))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    grown = torch.cuda.memory_stats()["reserved_bytes.all.current"] - before
    check(st.graph.launches == {"qmatmul": per_step},
          f"{label}: the decode graph records {st.graph.launches}")
    B.reset_launch_counts()
    r0 = st.graph.replays
    replayed = generate(tree, cfg, prompt, LM_TOKENS, cross=cross)
    torch.cuda.synchronize()
    gcounts = dict(B.launch_counts)
    replays = st.graph.replays - r0
    check(replays == steps and gcounts == {
        **{k: 0 for k in gcounts}, "qmatmul": replays * per_step},
        f"{label}: replayed launches {gcounts} over {replays} replays")
    for k, v in gcounts.items():
        sums[paths[1]][k] += v
    check(torch.equal(replayed, eager),
          f"{label}: the captured step's tokens != the eager step's")

    check_replay_logits(torch, label, cfg, tree, st, prompt, cross)
    codes, scales, _ = _dense_bytes(tree)
    res = {"eager_generate_s": eager_s, "capture_s": capture_s,
           "pool_bytes": st.graph.pool_bytes, "reserved_grown": grown,
           "weight_bytes": codes + scales, "sample": eager[0][:8].tolist()}
    log(f"{paths[0]} {label}: generate batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, {LM_TOKENS} new tokens: eager {eager_s * 1e3:.1f} ms "
        f"({per_step} qmatmul launches a step, {counts['qmatmul']} in all),"
        f" captured in {capture_s:.3f} s (graph pool {st.graph.pool_bytes} "
        f"bytes; reserved memory grew {grown} bytes), {replays} replays "
        f"({gcounts['qmatmul']} qmatmul launches, all replays): equal "
        f"tokens, logits of all {steps} steps bit for bit; weight bytes "
        f"{codes} codes + {scales} scales; sample {res['sample']}")
    res["eager_ms"], _ = decode_ms(torch, cfg, tree, prompt, FAMILY_TIMED,
                                   cross)
    res["replay_ms"], _ = replay_ms(torch, st, prompt, FAMILY_TIMED, cross)
    st.reset()
    busy, traced, kern = profile_decode(
        torch, f"{label} decode graph replay", st.step, FAMILY_PROFILE_REPS)
    res["traced_ms"] = traced
    if busy is not None:
        reps = FAMILY_PROFILE_REPS
        qmm = [e for e in kern if "qmm_" in e.key]
        n_qmm = sum(e.count for e in qmm) / reps
        check(n_qmm == per_step, f"{label}: {n_qmm} qmatmul kernels per "
              f"profiled replay, expected {per_step}")
        res.update(busy_ms=busy, kernels=sum(e.count for e in kern) / reps,
                   qmm_ms=sum(e.device_time_total for e in qmm) / reps / 1e3)
    log(f"{paths[0]} {label} step: replayed {res['replay_ms']:.3f} "
        f"ms/step, eager {res['eager_ms']:.3f} ms/step (CUDA events, "
        f"{FAMILY_TIMED} steps after the prompt, batch {LM_BATCH}; "
        f"{LM_BATCH / res['replay_ms'] * 1e3:.1f} tok/s replayed)"
        + (f"; profiled replay: {res['kernels']:.0f} kernels/step, device "
           f"busy {res['busy_ms']:.3f} ms/step ({res['busy_ms'] / res['replay_ms']:.1%}"
           f" of the untraced replay), qmatmul {res['qmm_ms']:.4f} ms/step"
           if "busy_ms" in res else ""))
    return res


def vlm_card_vs_cpu(torch, np, cfg, tree):
    """The vision-language forward, card against CPU on the same w8 codes
    ``tree``: ``cfg.vision_patches`` patch embeddings (rows of
    isqrt(patches)) ahead of FAMILY_VLM_TEXT text tokens, with distinct
    M-RoPE streams (patches t 0, h the row, w the column; text t == h == w
    from one past the grid's largest index on).  Logits within CPU_CHECK_TOL.  On the card the same input with
    t == h == w everywhere (plain RoPE) must give other logits, so the
    streams reach the rotation.  Returns the largest difference."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    P, T = cfg.vision_patches, FAMILY_VLM_TEXT
    side = math.isqrt(P)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (1, T))
    patches = (rng.standard_normal((1, P, cfg.d_model)) * 0.02).astype(
        np.float32)
    grid = np.arange(P)
    text = max(side, (P - 1) // side + 1) + np.arange(T)
    pos3 = np.stack([np.concatenate([np.zeros(P, np.int64), text]),
                     np.concatenate([grid // side, text]),
                     np.concatenate([grid % side, text])])[:, None]
    flat = np.broadcast_to(np.arange(P + T), (3, 1, P + T))

    def logits(params, dev, positions3):
        out, _ = lm.forward(params, {
            "tokens": torch.as_tensor(toks, dtype=torch.int32, device=dev),
            "patch_embeds": torch.as_tensor(patches, device=dev),
            "positions3": torch.as_tensor(np.ascontiguousarray(positions3),
                                          dtype=torch.int32, device=dev)},
            cfg)
        return out[..., :cfg.vocab].float().cpu()

    from repro_torch.kernels import build as B

    t0 = time.perf_counter()
    before = dict(B.launch_counts)
    lg = logits(tree, "cuda", pos3)
    rows = {k: B.launch_counts[k] - before[k] for k in ("qmatmul",
                                                       "qmatmul_rows")}
    check(rows["qmatmul"] > 0 and rows["qmatmul_rows"] == rows["qmatmul"],
          f"{cfg.name}: the {P + T}-row forward's qmatmul launches {rows}, "
          "expected all on the rows kernel")
    plain = logits(tree, "cuda", flat)
    lc = logits(tree_map(lambda t: t.cpu(), tree), "cpu", pos3)
    check(tuple(lg.shape) == (1, P + T, cfg.vocab)
          and bool(torch.isfinite(lg).all()),
          f"{cfg.name}: card logits {tuple(lg.shape)} or not finite")
    worst = float((lg - lc).abs().max())
    moved = float((lg - plain).abs().max())
    check(worst <= CPU_CHECK_TOL,
          f"{cfg.name}: card and CPU forward logits differ by {worst}")
    check(moved > 0, f"{cfg.name}: distinct M-RoPE streams left the logits "
          "as plain RoPE's")
    log(f"lm_families {cfg.name} card vs CPU forward ({cfg.n_layers} layers,"
        f" full width, w8, {P} patch embeddings in rows of {side} + {T}"
        f" text tokens, distinct t/h/w streams, {rows['qmatmul_rows']} "
        f"qmatmul launches at M {P + T}, all on qmm_rows_kernel; "
        f"{time.perf_counter() - t0:.1f} s): logits within {worst:.4g} "
        f"(tolerance {CPU_CHECK_TOL}); plain RoPE's logits differ from them "
        f"by up to {moved:.4g}")
    return worst


def lm_families_path(torch, np, B, Q, KQ):
    """The recurrent-state and vision-language families on the card:
    mamba2-780m and zamba2-7b at full size, w8 and w4; qwen2-vl-7b,
    qwen3-14b and phi3-medium-14b at full width cut to FAMILY_CUT_LAYERS
    layers, w8.  Returns the launch counts of the eager runs
    (``lm_families``) and of the replays (``lm_families_graph``), and the
    numbers for the kernels line."""
    import dataclasses
    import gc

    from repro_torch.launch import serve
    from repro_torch.launch.steps import quantize_tree_for_serving
    from repro_torch.models import lm
    from repro_torch.tree import tree_flatten, tree_map

    t_phase = time.perf_counter()
    serve._GRAPHED.clear()        # earlier phases' graphs hold their weights
    gc.collect()
    torch.cuda.empty_cache()
    timing = time_family_qmatmul(torch, Q, KQ, family_shapes())
    sums = {p: {k: 0 for k in B.launch_counts}
            for p in ("lm_families", "lm_families_graph")}
    report = {}
    for name in FAMILY_FULL + FAMILY_CUT:
        cfg = family_config(name)
        products = family_products(cfg)
        per_step = sum(c for *_, c in products)
        t0 = time.perf_counter()
        params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_flatten(params)[0])
        slots = FAMILY_CPU_SLOTS.get(name)
        small = None
        if slots:
            n_mamba = lm._layer_kinds(cfg)[:slots].count("mamba")
            small = dict(params, mamba_blocks=tree_map(
                lambda t: t[:n_mamba].clone(), params["mamba_blocks"]))
        bits_list = (8, 4) if name in FAMILY_FULL else (8,)
        trees = {bits: lm.with_head_copy(
            quantize_tree_for_serving(params, bits), cfg)
            for bits in bits_list}
        del params
        gc.collect()
        torch.cuda.synchronize()
        size = ("full size" if name in FAMILY_FULL else
                f"full width, cut to {FAMILY_CUT_LAYERS} layers")
        log(f"lm_families {name}: {cfg.n_layers} layer slots ({size}), d "
            f"{cfg.d_model}, vocab "
            f"{cfg.vocab} padded {cfg.vocab_padded}, {n_params} float32 "
            f"parameters drawn on the card and quantized to "
            f"w{'/w'.join(map(str, bits_list))} in "
            f"{time.perf_counter() - t0:.2f} s; qmatmul a step: "
            + ", ".join(f"{p} ({k}, {n}) x{c}" for p, k, n, c in products)
            + f" = {per_step}")
        rep = {"qmatmul_per_step": per_step, "params": n_params}
        for bits in bits_list:
            rep[f"w{bits}"] = family_serve(torch, np, B, name, cfg,
                                           trees[bits], bits, per_step, sums)
            qmm_ms = sum(timing[(bits, LM_BATCH, k, n)]["ms"] * c
                         for _, k, n, c in products)
            qmm_bound = sum(timing[(bits, LM_BATCH, k, n)]["bound_ms"] * c
                            for _, k, n, c in products)
            rep[f"w{bits}"].update(qmm_timed_ms=qmm_ms,
                                   qmm_bound_ms=qmm_bound)
            log(f"lm_families {name} w{bits}: qmatmul over one step from the "
                f"per-shape times {qmm_ms:.4f} ms against its bound "
                f"{qmm_bound:.4f} ms ({per_step} launches)")
        if cfg.family == "vlm":
            rep["vlm_cpu_check_max_abs"] = vlm_card_vs_cpu(torch, np, cfg,
                                                           trees[8])
        serve._GRAPHED.clear()
        del trees
        gc.collect()
        torch.cuda.empty_cache()
        if small is not None:
            rep["cpu_check_max_abs"] = card_vs_cpu(
                torch, f"lm_families {name}", dataclasses.replace(
                    cfg, n_layers=slots), small, np.random.default_rng(
                        1).integers(0, cfg.vocab, (LM_BATCH, FAMILY_CPU_STEPS)),
                FAMILY_CPU_STEPS)
            del small
            gc.collect()
            torch.cuda.empty_cache()
        report[name] = rep
    for p, c in sums.items():
        check(c["qmatmul"] > 0 and all(v == 0 for k, v in c.items()
                                       if k != "qmatmul"),
              f"path {p}: launches {c}")
    log(f"lm_families: launches eager {sums['lm_families']}, replayed "
        f"{sums['lm_families_graph']}; phase {time.perf_counter() - t_phase:.1f}"
        " s")
    report["shapes"] = {f"w{b} {m}x{k}x{n}": v
                        for (b, m, k, n), v in timing.items()}
    return sums["lm_families"], sums["lm_families_graph"], report


# ---------------------------------------------------------------------------
# Phase 6c: MoE, MLA and the audio encoder-decoder
# ---------------------------------------------------------------------------
MMA_CONFIGS = ("grok-1-314b", "arctic-480b", "minicpm3-4b", "whisper-tiny")
# full width, cut in depth: one layer's expert banks are 4.83 GB (grok) and
# 13.39 GB (arctic) at w8, so neither fits at full depth (PERF.md section 4)
MMA_CUT = {"grok-1-314b": 4, "arctic-480b": 2}
MMA_PATHS = ("lm_moe_mla_audio", "lm_moe_mla_audio_graph")
# qmatmul launches a decode step at batch 4: 4 x (4 + 8 x 3) + 1,
# 2 x (4 + 128 x 3 + 3) + 1, 62 x 7 + 1, 4 x 8
MMA_QMM_PER_STEP = {"grok-1-314b": 113, "arctic-480b": 783,
                    "minicpm3-4b": 435, "whisper-tiny": 32}
WHISPER_ENC_QMM, WHISPER_CROSS_QMM = 24, 8
# card against CPU: layers of a full-width copy, and decode steps (the
# CPU's plain qmatmul takes ~20 s (grok) and ~30 s (arctic) a step over
# every expert's codes)
MMA_CPU_LAYERS = {"grok-1-314b": 2, "arctic-480b": 1, "minicpm3-4b": 2}
MMA_CPU_STEPS = {"grok-1-314b": 2, "arctic-480b": 2, "minicpm3-4b": 8,
                 "whisper-tiny": 8}
# whisper's encoder output and cross k/v card vs CPU, in bf16 ulps at the
# CPU tensor's largest magnitude: the CPU tests' end-to-end rule (the
# encoder output read 2.00 on an H100)
WHISPER_ENC_ULPS = 4


def mma_config(name: str, layers: int = 0):
    import dataclasses

    from repro_torch.models.common import get_config

    cfg = get_config(name)
    layers = layers or MMA_CUT.get(name, 0)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def mma_products(cfg):
    """(name, M, K, N, launches a decode step) of every quantized product
    of one decode step at batch LM_BATCH: the attention's (MLA: wq_a, wq_b,
    wkv_a, wo; ``wkv_b`` is dequantized, not a launch), each expert's three
    at M = the capacity C (every expert reads its buffer), arctic's dense
    residual, the MLP, an untied head; whisper's decoder blocks (self q, k,
    v, o; cross q, o; up, down)."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, hd, M = cfg.n_heads, cfg.hd, LM_BATCH
    if cfg.family == "audio":
        kv = cfg.n_kv_heads * hd
        return [(nm, M, k, nn, n) for nm, k, nn in (
            ("self wq", d, H * hd), ("self wk", d, kv), ("self wv", d, kv),
            ("self wo", H * hd, d), ("cross wq", d, H * hd),
            ("cross wo", H * hd, d), ("w_up", d, f), ("w_down", f, d))]
    proj = _projections(cfg)
    if cfg.attention == "mla":
        rd, vhd = cfg.mla_rope_dim, cfg.mla_v_head_dim or hd
        out = [("wq_a", M, d, cfg.mla_q_rank, n),
               ("wq_b", M, cfg.mla_q_rank, H * (hd + rd), n),
               ("wkv_a", M, d, cfg.mla_kv_rank + rd, n),
               ("wo", M, H * vhd, d, n)]
    else:
        out = [(nm, M, k, nn, n) for nm, k, nn in proj[:4]]
    if cfg.moe_experts:
        E = cfg.moe_experts
        C = max(int(cfg.moe_capacity_factor * M * cfg.moe_top_k / E), 1)
        out += [(f"expert {nm}", C, k, nn, n * E) for nm, k, nn in proj[4:]]
    if not cfg.moe_experts or cfg.moe_dense_residual:
        out += [(nm, M, k, nn, n) for nm, k, nn in proj[4:]]
    if not cfg.tie_embeddings:
        out.append(("lm_head", M, d, cfg.vocab_padded, 1))
    return out


def whisper_encoder_products(cfg):
    """(name, M, K, N, launches) of ``encode`` and ``build_cross_cache`` on
    LM_BATCH utterances of ``enc_seq`` frames."""
    d, f, M = cfg.d_model, cfg.d_ff, LM_BATCH * cfg.enc_seq
    hd = cfg.n_heads * cfg.hd
    return [("enc wq/wk/wv", M, d, hd, 3 * cfg.enc_layers),
            ("enc wo", M, hd, d, cfg.enc_layers),
            ("enc w_up", M, d, f, cfg.enc_layers),
            ("enc w_down", M, f, d, cfg.enc_layers),
            ("cross wk/wv", M, d, cfg.n_kv_heads * cfg.hd, 2 * cfg.n_layers)]


def mma_shapes():
    """The distinct (M, K, N) of the four configs' quantized products."""
    shapes = []
    for name in MMA_CONFIGS:
        cfg = mma_config(name)
        prods = mma_products(cfg) + (whisper_encoder_products(cfg)
                                     if cfg.family == "audio" else [])
        for _, m, k, n, _ in prods:
            if (m, k, n) not in shapes:
                shapes.append((m, k, n))
    return shapes


def whisper_encode(torch, np, B, cfg, tree, sums):
    """``encode`` of LM_BATCH utterances of random frame embeddings, then
    ``build_cross_cache``, on the card: 24 + 8 qmatmul launches (counted
    into the eager path), finite outputs of the right shapes, their
    CUDA-event ms.  Returns (frames, cross k/v, numbers)."""
    from repro_torch.models import whisper

    frames = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (LM_BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32),
        device="cuda")
    B.reset_launch_counts()
    enc = whisper.encode(tree, frames, cfg)
    n_enc = dict(B.launch_counts)
    cross = whisper.build_cross_cache(tree, enc, cfg)
    torch.cuda.synchronize()
    counts = dict(B.launch_counts)
    n = WHISPER_ENC_QMM + WHISPER_CROSS_QMM
    check(n_enc["qmatmul"] == n_enc["qmatmul_rows"] == WHISPER_ENC_QMM
          and counts == {**{k: 0 for k in counts}, "qmatmul": n,
                         "qmatmul_rows": n},
          f"whisper encode + cross cache launches {counts} (encode "
          f"{n_enc})")
    for k, v in counts.items():
        sums[MMA_PATHS[0]][k] += v
    shape = (cfg.n_layers, LM_BATCH, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
    check(tuple(enc.shape) == (LM_BATCH, cfg.enc_seq, cfg.d_model)
          and bool(torch.isfinite(enc.float()).all())
          and all(tuple(cross[n].shape) == shape
                  and bool(torch.isfinite(cross[n].float()).all())
                  for n in ("k", "v")),
          "whisper encoder output or cross k/v wrong shape or not finite")
    res = {"encode_ms": cuda_ms(torch, lambda: whisper.encode(tree, frames,
                                                              cfg), reps=5),
           "cross_ms": cuda_ms(torch, lambda: whisper.build_cross_cache(
               tree, enc, cfg), reps=5)}
    log(f"{MMA_PATHS[0]} whisper encode: {LM_BATCH} x {cfg.enc_seq} frames, "
        f"{cfg.enc_layers} layers, {WHISPER_ENC_QMM} qmatmul launches at M "
        f"{LM_BATCH * cfg.enc_seq}, all {n_enc['qmatmul_rows']} on "
        f"qmm_rows_kernel (0 on qmm_kernel): {res['encode_ms']:.4f} ms; "
        f"cross k/v of {cfg.n_layers} layers, {WHISPER_CROSS_QMM} launches, "
        f"{counts['qmatmul_rows'] - n_enc['qmatmul_rows']} on "
        f"qmm_rows_kernel: {res['cross_ms']:.4f} ms")
    return frames, cross, res


def whisper_card_vs_cpu(torch, np, cfg, frames):
    """whisper in full, float32 parameters drawn on the card, quantized
    to w8 on the card and on the CPU (codes equal): the encoder output and
    the cross k/v of the same frames within WHISPER_ENC_ULPS bf16 ulps at
    the CPU tensor's largest magnitude (an absolute 0.0625 is two ulps of
    an encoder output of 4 to 8), then MMA_CPU_STEPS decode steps on each
    device's cross cache (:func:`decode_card_vs_cpu`).  Returns the
    largest logit difference."""
    from repro_torch.launch.steps import quantize_tree_for_serving
    from repro_torch.models import whisper
    from repro_torch.tree import tree_flatten, tree_map

    params = whisper.init_params(torch.Generator(device="cuda").manual_seed(
        1), cfg)
    q = {"cuda": whisper.with_head_copy(quantize_tree_for_serving(params, 8),
                                        cfg),
         "cpu": whisper.with_head_copy(quantize_tree_for_serving(
             tree_map(lambda t: t.cpu(), params), 8), cfg)}
    for a, b in zip(tree_flatten(q["cuda"])[0], tree_flatten(q["cpu"])[0]):
        check(torch.equal(a.cpu(), b), "whisper: w8 codes or scales differ "
              "between card and CPU")
    t0 = time.perf_counter()
    enc = {dev: whisper.encode(q[dev], frames.to(dev), cfg)
           for dev in ("cuda", "cpu")}
    crosses = {dev: whisper.build_cross_cache(q[dev], enc[dev], cfg)
               for dev in ("cuda", "cpu")}
    pairs = {"encoder output": (enc["cuda"], enc["cpu"]),
             **{f"cross {n}": (crosses["cuda"][n], crosses["cpu"][n])
                for n in ("k", "v")}}
    ulps = {}
    for what, (card, cpu) in pairs.items():
        cpu = cpu.float()
        ulp = 2.0 ** (math.floor(math.log2(float(cpu.abs().max()))) - 7)
        diff = float((card.float().cpu() - cpu).abs().max())
        ulps[what] = (diff, diff / ulp)
        check(diff <= WHISPER_ENC_ULPS * ulp, f"whisper {what}: card and CPU "
              f"differ by {diff} ({diff / ulp} ulps)")
    log(f"{MMA_PATHS[0]} whisper card vs CPU encode ({cfg.enc_layers} layers"
        f", {LM_BATCH} x {cfg.enc_seq} frames, w8; "
        f"{time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"{k} within {d:.4g} ({u:.2f} ulps)"
                    for k, (d, u) in ulps.items())
        + f" (tolerance {WHISPER_ENC_ULPS} bf16 ulps at the CPU tensor's "
        "largest magnitude)")
    steps = MMA_CPU_STEPS[cfg.name]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab,
                                               (LM_BATCH, steps))
    return decode_card_vs_cpu(torch, f"{MMA_PATHS[0]} whisper-tiny", cfg,
                              q["cuda"], q["cpu"], prompt, steps, crosses)


def moe_mla_card_vs_cpu(torch, np, name):
    """A full-width copy of MMA_CPU_LAYERS[name] layers at w8 on the card
    and on the CPU.  MLA: float32 parameters drawn on the card and
    quantized on both devices (:func:`card_vs_cpu`).  MoE: the serving
    tree drawn on the card expert by expert and copied to the CPU, after
    one expert bank quantized on both devices gave equal codes and
    scales.  Returns the largest difference."""
    from repro_torch.launch.steps import init_serving_params
    from repro_torch.models import layers, lm
    from repro_torch.tree import tree_map

    cfg = mma_config(name, MMA_CPU_LAYERS[name])
    steps = MMA_CPU_STEPS[name]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab,
                                               (LM_BATCH, steps))
    label = f"{MMA_PATHS[0]} {name}"
    gen = torch.Generator(device="cuda").manual_seed(1)
    if not cfg.moe_experts:
        return card_vs_cpu(torch, label, cfg, lm.init_params(gen, cfg),
                           prompt, steps)
    w = torch.rand((cfg.d_model, cfg.d_ff), generator=gen, device="cuda")
    for bits in (8, 4):
        a = layers.quantize_dense_for_serving({"w": w}, bits)
        b = layers.quantize_dense_for_serving({"w": w.cpu()}, bits)
        check(all(torch.equal(a[k].cpu(), b[k]) for k in a),
              f"{label}: an expert's w{bits} codes differ card vs CPU")
    del w, a, b
    q_dev = lm.with_head_copy(init_serving_params(gen, cfg, 8), cfg)
    q_cpu = tree_map(lambda t: t.cpu(), q_dev)
    return decode_card_vs_cpu(torch, label, cfg, q_dev, q_cpu, prompt,
                              steps)


def moe_mla_audio_path(torch, np, B, Q, KQ):
    """grok-1-314b (4 of 64 layers) and arctic-480b (2 of 35) at full
    width, minicpm3-4b and whisper-tiny at full size, each at w8 and w4
    through ``generate``, eager and replayed; whisper on an utterance's
    cross k/v from ``encode`` and ``build_cross_cache``.  Returns the
    launch counts of the eager runs and of the replays, and the numbers
    for the kernels line."""
    import gc

    from repro_torch.launch import serve
    from repro_torch.launch.steps import init_serving_params, model_module

    t_phase = time.perf_counter()
    serve._GRAPHED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    timing = time_family_qmatmul(torch, Q, KQ, mma_shapes())
    sums = {p: {k: 0 for k in B.launch_counts} for p in MMA_PATHS}
    report = {}
    for name in MMA_CONFIGS:
        cfg = mma_config(name)
        mod = model_module(cfg)
        products = mma_products(cfg)
        per_step = sum(c for *_, c in products)
        check(per_step == MMA_QMM_PER_STEP[name],
              f"{name}: {per_step} quantized products a step")
        size = (f"full width, cut to {cfg.n_layers} layers" if name in MMA_CUT
                else "full size")
        rep = {"qmatmul_per_step": per_step}
        frames = None
        for bits in (8, 4):
            t0 = time.perf_counter()
            tree = mod.with_head_copy(init_serving_params(
                torch.Generator(device="cuda").manual_seed(0), cfg, bits),
                cfg)
            torch.cuda.synchronize()
            log(f"{MMA_PATHS[0]} {name} w{bits}: {cfg.n_layers} layers "
                f"({size}), d {cfg.d_model}, vocab {cfg.vocab} padded "
                f"{cfg.vocab_padded}; serving tree drawn on the card in "
                f"{time.perf_counter() - t0:.2f} s"
                + (" (expert banks quantized one expert at a time)"
                   if cfg.moe_experts else "")
                + "; qmatmul a step: " + ", ".join(
                    f"{p} ({m}x{k}x{n}) x{c}" for p, m, k, n, c in products)
                + f" = {per_step}")
            cross = None
            if cfg.family == "audio":
                frames, cross, enc = whisper_encode(torch, np, B, cfg, tree,
                                                    sums)
            res = family_serve(torch, np, B, name, cfg, tree, bits, per_step,
                               sums, paths=MMA_PATHS, cross=cross)
            if cfg.family == "audio":
                res.update(enc)
            res["qmm_timed_ms"] = sum(timing[(bits, m, k, n)]["ms"] * c
                                      for _, m, k, n, c in products)
            res["qmm_bound_ms"] = sum(timing[(bits, m, k, n)]["bound_ms"] * c
                                      for _, m, k, n, c in products)
            log(f"{MMA_PATHS[0]} {name} w{bits}: qmatmul over one step from "
                f"the per-shape times {res['qmm_timed_ms']:.4f} ms against "
                f"its bound {res['qmm_bound_ms']:.4f} ms ({per_step} "
                "launches)")
            rep[f"w{bits}"] = res
            serve._GRAPHED.clear()
            del tree, cross
            gc.collect()
            torch.cuda.empty_cache()
        if cfg.family == "audio":
            rep["cpu_check_max_abs"] = whisper_card_vs_cpu(torch, np, cfg,
                                                           frames)
        else:
            rep["cpu_check_max_abs"] = moe_mla_card_vs_cpu(torch, np, name)
        gc.collect()
        torch.cuda.empty_cache()
        report[name] = rep
    # the rows kernel only in whisper's encode and cross cache (eager)
    for p, c in sums.items():
        rows = 2 * (WHISPER_ENC_QMM + WHISPER_CROSS_QMM) if p == MMA_PATHS[0] \
            else 0
        check(c["qmatmul"] > 0 and c["qmatmul_rows"] == rows
              and all(v == 0 for k, v in c.items()
                      if k not in ("qmatmul", "qmatmul_rows")),
              f"path {p}: launches {c}")
    log(f"{MMA_PATHS[0]}: launches eager {sums[MMA_PATHS[0]]}, replayed "
        f"{sums[MMA_PATHS[1]]}; phase {time.perf_counter() - t_phase:.1f} s")
    report["shapes"] = {f"w{b} {m}x{k}x{n}": v
                        for (b, m, k, n), v in timing.items()}
    return sums[MMA_PATHS[0]], sums[MMA_PATHS[1]], report


# ---------------------------------------------------------------------------
# Phase 6b: compiled LM decode (lm-tiny) through the lm-decode recipe
# ---------------------------------------------------------------------------
LM_TINY_BUCKETS = (1, 2, 4, 8)
LM_TINY_CAPS = (32, 64)
LM_TINY_THREADS = 4
LM_TINY_SEQS_PER_THREAD = 4
# card against CPU: logits within this absolute bound, greedy tokens equal
# wherever the CPU's top-2 margin exceeds twice it (the Qwen rule, PERF.md
# section 2)
LM_TINY_CPU_TOL = 0.0625
LM_TINY_CPU_STEPS = 40
LM_TINY_LEVELS = 255


def time_mvau_int_lm_shape(torch, KM, B, ref, err):
    """The int8 GEMM form at lm-tiny's ``w_down``: M = the batch bucket (1
    and 8, and 3 for the odd case), K 96, N 64, 255 levels (searched), one
    table shared by every column as the lowering expands it, and a random
    sorted one per column.  ``KM.mvau_int`` takes the small-M route there
    (``mvau_small_m_kernel``); each launch is held against the plain
    version.  Timed at M = 1 and 8 beside the plain version, ``torch._int_mm``
    + count (M padded to 32: ``_int_mm`` refuses M <= 16 on the card), the
    wgmma kernel on the same inputs (the route before the small-M kernel,
    launched through the library directly), an empty launch of the same
    grid (the floor of any launch) and the bound; and, for the epilogue's
    share, the small-M kernel with a 15-level table and with 128 rows."""
    check(KM.int8_gemm_route(8, LM_TINY_LEVELS) == "small_m",
          "lm-tiny's w_down is not on the small-M route")
    gen = torch.Generator().manual_seed(11)
    lib = B.library()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for m in (1, 3, 8):
        x = torch.randint(-128, 128, (m, 96), generator=gen).to(torch.int8)
        w = torch.randint(-128, 128, (96, 64), generator=gen).to(torch.int8)
        row = torch.sort(torch.randint(-60000, 60000, (LM_TINY_LEVELS,),
                                       generator=gen)).values
        tables = {"shared": row[None].expand(64, LM_TINY_LEVELS),
                  "per_column": torch.sort(torch.randint(
                      -60000, 60000, (64, LM_TINY_LEVELS), generator=gen),
                      dim=1).values}
        x, w = x.cuda(), w.cuda()
        for kind, t in tables.items():
            t = t.to(torch.int32).contiguous().cuda()
            before = B.launch_counts["mvau_int_small_m"]
            got, want = KM.mvau_int(x, w, t, -128), KM.mvau_int_plain(
                x, w, t, -128)
            check(B.launch_counts["mvau_int_small_m"] == before + 1,
                  f"mvau_int at lm-tiny's shape (M {m}) did not launch the "
                  "small-M kernel")
            d = (got - want).abs().max().item()
            err["mvau_int_small_m"] = max(err["mvau_int_small_m"], float(d))
            check(torch.equal(got, want), f"mvau_int at lm-tiny's shape "
                  f"(M {m}, {kind} table) differs from plain by {d}")
        if m == 3:
            continue
        t = tables["shared"].to(torch.int32).contiguous().cuda()
        # beside it, what the epilogue costs: a 15-level table (counted
        # densely) and 128 rows at 255 levels
        t15 = torch.sort(t[:, ::17], dim=1).values.contiguous()
        x128 = x.repeat(-(-128 // m), 1)[:128].contiguous()
        xpad = torch.nn.functional.pad(x, (0, 0, 0, 32 - m))
        old = torch.empty((m, 64), dtype=torch.int32, device="cuda")

        def lib_call():
            acc = torch._int_mm(xpad, w)[:m]
            return -128 + ref.threshold_counts_fast(acc, t, True)

        def wgmma():
            B.check(lib.mvau_int(x.data_ptr(), w.data_ptr(), 0, t.data_ptr(),
                                 old.data_ptr(), m, 96, 64, LM_TINY_LEVELS,
                                 -128, 1, None, None, stream), "mvau_int")

        def empty():
            B.check(lib.empty_launch(4, 128, stream), "empty")

        check(torch.equal(lib_call().to(torch.int32), KM.mvau_int_plain(
            x, w, t, -128)), "the _int_mm yardstick computes another function")
        wgmma()
        check(torch.equal(old, KM.mvau_int_plain(x, w, t, -128)),
              "the wgmma route differs from plain at lm-tiny's shape")
        nbytes = x.numel() + w.numel() + 4 * t.numel() + 4 * m * 64
        ops = 2 * m * 96 * 64
        b_ms, o_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_INT8_OPS * 1e3
        out[f"M{m}"] = {
            "ms": cuda_ms(torch, lambda: KM.mvau_int(x, w, t, -128)),
            "plain_ms": cuda_ms(torch, lambda: KM.mvau_int_plain(
                x, w, t, -128)),
            "library_ms": cuda_ms(torch, lib_call),
            "wgmma_ms": cuda_ms(torch, wgmma),
            "empty_launch_ms": cuda_ms(torch, empty),
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "ms_15_levels": cuda_ms(torch, lambda: KM.mvau_int(
                x, w, t15, -128)),
            "ms_m128": cuda_ms(torch, lambda: KM.mvau_int(x128, w, t, -128))}
        r = out[f"M{m}"]
        log(f"kernel mvau_int GEMM form at lm-tiny's w_down M={m} K=96 N=64 "
            f"L={LM_TINY_LEVELS}: small-M kernel_ms={r['ms']:.5f} plain_ms="
            f"{r['plain_ms']:.5f} library_ms={r['library_ms']:.5f} "
            f"(torch._int_mm on M padded to 32 + count) wgmma kernel_ms="
            f"{r['wgmma_ms']:.5f} empty launch_ms={r['empty_launch_ms']:.5f} "
            f"bound_ms={r['bound_ms']:.7f} ({r['bound_by']}: {nbytes} bytes, "
            f"{ops} operations); the small-M kernel with 15 levels "
            f"{r['ms_15_levels']:.5f} ms, with 128 rows {r['ms_m128']:.5f} "
            f"ms ({KM.int8_gemm_route(128, LM_TINY_LEVELS)} route)")
    return out


def lm_tiny_path(torch, np, B, KM, ref, err):
    """lm-tiny at its full size through ``build_decode_artifact`` (the
    ``lm-decode`` recipe) to int and f32 artifacts on the card, served by
    ``ServeEngine`` through ``DecodeAdapter``.  Returns the mvau_int numbers
    at the LM's shape and the launch counts of the eager steps (path
    ``lm_tiny_decode``) and of the engine's replays (``lm_tiny_serve``)."""
    import threading

    from repro_torch.core import graph as G
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.serve import (ArtifactRegistry, DecodeAdapter,
                                   ServeEngine, build_decode_artifact,
                                   greedy_generate)
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    cfg = get_config("lm-tiny")
    mv_lm = time_mvau_int_lm_shape(torch, KM, B, ref, err)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    arts, build_s = {}, {}
    for dp in ("int", "f32"):
        t0 = time.perf_counter()
        arts[dp] = build_decode_artifact(params, cfg, datapath=dp,
                                         capacities=LM_TINY_CAPS)
        torch.cuda.synchronize()
        build_s[dp] = time.perf_counter() - t0
        check(all(r.verified for r in arts[dp].dm.trace.records),
              f"lm-tiny {dp}: a pass failed its golden-IO check")
    gi = arts["int"].dm.graph
    ops = {}
    for n in gi.nodes:
        ops[n.op] = ops.get(n.op, 0) + 1
    check(ops.get("mvau_int") == 2 and len(gi.nodes) == 50,
          f"lm-tiny int graph ops {ops}")
    labels = {r["kernel"] for r in arts["int"].dm.dispatch_table()
              if r["op"] == "mvau_int"}
    check(labels == {"fused-cuda"}, f"lm-tiny mvau_int dispatch {labels}")
    log(f"lm_tiny: lm-tiny full size ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab} padded {cfg.vocab_padded}, w8a8), params drawn on the "
        f"card; compile with golden-IO checks bit for bit: int "
        f"{build_s['int']:.3f} s ({arts['int'].weight_bytes()} weight "
        f"bytes, {len(gi.nodes)} nodes {ops}), f32 {build_s['f32']:.3f} s "
        f"({arts['f32'].weight_bytes()} bytes)")

    def eager_greedy(prompt, n_new, cap):
        caches = [torch.zeros((1, cap, cfg.d_model), device="cuda")
                  for _ in range(2 * cfg.n_layers)]
        toks, out = list(prompt), []
        for i in range(len(prompt) + n_new - 1):
            t = toks[i] if i < len(prompt) else out[-1]
            logits, caches = lm.decode_step_ref(
                params, torch.tensor([t], dtype=torch.int32, device="cuda"),
                torch.tensor([i], dtype=torch.int32, device="cuda"), caches,
                cfg)
            if i >= len(prompt) - 1:
                out.append(int(np.argmax(logits[0, :cfg.vocab].cpu().numpy())))
        return out

    # -- the eager path: steps through DecodeArtifact before warmup ---------
    rng = np.random.default_rng(5)
    eager_prompts = [rng.integers(0, cfg.vocab, int(rng.integers(1, 7))
                                  ).tolist() for _ in range(8)]
    art = arts["int"]
    B.reset_launch_counts()
    t0 = time.perf_counter()
    got, launches = {}, 0
    for i, p in enumerate(eager_prompts):
        got[i] = [art.start_sequence(f"e{i}", p)[0]]
        launches += len(p)
    for _ in range(9):
        res, stats = art.step_sequences([(f"e{i}", None) for i in got])
        launches += len(stats)
        for i, (_, tok, _, _) in zip(got, res):
            got[i].append(tok)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    decode_counts = dict(B.launch_counts)
    for i in got:
        art.release(f"e{i}")
    check(decode_counts["mvau_int"] == 2 * launches
          and decode_counts["mvau_int_small_m"] == decode_counts["mvau_int"]
          and decode_counts["mvau_int_wide"] == 0,
          f"lm_tiny eager: {decode_counts['mvau_int']} mvau_int launches "
          f"({decode_counts['mvau_int_small_m']} small-M) for {launches} int "
          "steps")
    for i, p in enumerate(eager_prompts):
        check(got[i] == eager_greedy(p, 10, LM_TINY_CAPS[0]),
              f"lm_tiny eager sequence {i}: tokens != decode_step_ref")
    log(f"lm_tiny eager steps: {len(eager_prompts)} sequences, {launches} "
        f"launches of the int decode model in {eager_s:.3f} s (no graph), "
        f"mvau_int {decode_counts['mvau_int']} = 2 per step, every one on "
        "the small-M kernel; tokens == eager decode_step_ref greedy")

    # -- one CUDA graph per (bucket x capacity) ------------------------------
    warm_s = {}
    for dp, a in arts.items():
        t0 = time.perf_counter()
        a.warmup(LM_TINY_BUCKETS)
        warm_s[dp] = time.perf_counter() - t0
        check(len(a.dm._exec.graphs) == len(LM_TINY_BUCKETS)
              * len(LM_TINY_CAPS), f"lm_tiny {dp}: "
              f"{len(a.dm._exec.graphs)} graphs captured")
    pool = {dp: sum(g.pool_bytes for g in a.dm._exec.graphs.values())
            for dp, a in arts.items()}
    names = arts["int"].dm.input_names
    for cap in LM_TINY_CAPS:
        for b in LM_TINY_BUCKETS:
            feeds = lm.example_decode_feeds(cfg, batch=b, capacity=cap,
                                            seed=b * 100 + cap)
            xs = [torch.as_tensor(feeds[k], device="cuda") for k in names]
            want = lm.decode_step_ref(params, xs[0], xs[1], xs[2:], cfg)
            want = [want[0]] + want[1]
            outs = {"interpreter": G.execute(arts["int"].dm.graph,
                                             dict(zip(names, xs)))}
            for dp, a in arts.items():
                outs[f"{dp} replay"] = a.dm(*xs)
                outs[f"{dp} eager"] = a.dm.apply(*xs)
            for label, o in outs.items():
                check(len(o) == len(want) and all(
                    torch.equal(u, v) for u, v in zip(o, want)),
                    f"lm_tiny (bucket {b}, capacity {cap}): {label} != "
                    "decode_step_ref")
    feeds = lm.example_decode_feeds(cfg, batch=8, capacity=64, seed=77)
    xs = [torch.as_tensor(feeds[k], device="cuda") for k in names]
    full = arts["int"].dm(*xs)
    for r in range(8):
        one = arts["int"].dm(*[x[r:r + 1] for x in xs])
        check(all(torch.equal(u[r:r + 1], v) for u, v in zip(full, one)),
              f"lm_tiny: row {r} differs between bucket 8 and bucket 1")
    log(f"lm_tiny graphs: {len(LM_TINY_BUCKETS)} buckets x "
        f"{len(LM_TINY_CAPS)} capacities captured per artifact (int "
        f"{warm_s['int']:.3f} s, f32 {warm_s['f32']:.3f} s; pool bytes int "
        f"{pool['int']}, f32 {pool['f32']}); at every (bucket, capacity) "
        "int replay == int eager == f32 replay == f32 eager == interpreter "
        "== decode_step_ref on the card, logits and caches bit for bit; "
        "each of 8 rows of a bucket-8 step == the same row at bucket 1")

    # -- card against CPU -----------------------------------------------------
    cpu_art = build_decode_artifact(tree_map(lambda t: t.cpu(), params), cfg,
                                    datapath="int", capacities=LM_TINY_CAPS,
                                    device="cpu")
    prompts = [rng.integers(0, cfg.vocab, 3).tolist() for _ in range(8)]
    worst, exact, compared, skipped = 0.0, 0, 0, 0
    toks = []
    for i, p in enumerate(prompts):
        toks.append(cpu_art.start_sequence(f"c{i}", p)[0])
        arts["int"].start_sequence(f"c{i}", p)
    seqs = [f"c{i}" for i in range(len(prompts))]
    for _ in range(LM_TINY_CPU_STEPS):
        feed = [(s, t) for s, t in zip(seqs, toks)]
        rc, _ = cpu_art.step_sequences(feed)
        rg, _ = arts["int"].step_sequences(feed)
        lc = np.stack([r[3] for r in rc])
        lg = np.stack([r[3] for r in rg])
        check(bool(np.isfinite(lg).all()), "lm_tiny card logits not finite")
        worst = max(worst, float(np.abs(lg - lc).max()))
        exact += int((lg == lc).all(axis=1).sum())
        top2 = -np.sort(-lc, axis=1)[:, :2]
        sure = (top2[:, 0] - top2[:, 1]) > 2 * LM_TINY_CPU_TOL
        check(np.array_equal(lg.argmax(1)[sure], lc.argmax(1)[sure]),
              "lm_tiny: greedy tokens differ between card and CPU at a "
              "top-2 margin above twice the tolerance")
        compared += int(sure.sum())
        skipped += int((~sure).sum())
        toks = [int(r[1]) for r in rc]          # teacher-forced by the CPU
    for s in seqs:
        arts["int"].release(s)
        cpu_art.release(s)
    n_rows = LM_TINY_CPU_STEPS * len(seqs)
    check(worst <= LM_TINY_CPU_TOL,
          f"lm_tiny card and CPU logits differ by {worst}")
    log(f"lm_tiny card vs CPU (int artifacts, {len(seqs)} sequences x "
        f"{LM_TINY_CPU_STEPS} steps teacher-forced by the CPU, crossing "
        f"capacity {LM_TINY_CAPS[0]}): logits within {worst:.4g} (tolerance "
        f"{LM_TINY_CPU_TOL}), {exact} of {n_rows} rows bit for bit; greedy "
        f"tokens equal at {compared} decisions, {skipped} skipped at a top-2 "
        f"margin <= {2 * LM_TINY_CPU_TOL}")

    # -- step latency, replayed and eager; the replayed step profiled --------
    step = {}
    for b in (1, 8):
        feeds = lm.example_decode_feeds(cfg, batch=b, capacity=32, seed=b)
        xs = [torch.as_tensor(feeds[k], device="cuda") for k in names]
        for dp, a in arts.items():
            step[(dp, b, "replay")] = sync_ms(torch, lambda: a.dm(*xs))
            step[(dp, b, "eager")] = sync_ms(torch, lambda: a.dm.apply(*xs))
        step[("ref", b, "eager")] = sync_ms(torch, lambda: lm.decode_step_ref(
            params, xs[0], xs[1], xs[2:], cfg))
    log("lm_tiny step latency (host wall, synchronized each step, capacity "
        "32): " + ", ".join(f"{dp} batch {b} {how} {ms:.4f} ms"
                            for (dp, b, how), ms in step.items()))
    feeds = lm.example_decode_feeds(cfg, batch=8, capacity=32, seed=3)
    xs = [torch.as_tensor(feeds[k], device="cuda") for k in names]
    reps = 20
    busy, traced, kern = profile_decode(
        torch, "lm_tiny int step replay (batch 8, capacity 32)",
        lambda: arts["int"].dm(*xs), reps)
    if busy is not None:
        mv_k = [e for e in kern if "mvau_small_m_kernel" in e.key]
        n_mv = sum(e.count for e in mv_k) / reps
        n_conv = sum(e.count for e in kern
                     if "mvau_conv_kernel" in e.key) / reps
        per_step = sum(e.count for e in kern) / reps
        check(n_mv == 2 and n_conv == 0, f"lm_tiny: {n_mv} "
              f"mvau_small_m_kernel and {n_conv} mvau_conv_kernel per "
              "replayed int step, expected 2 and 0")
        log(f"profile lm_tiny int step: {per_step:.0f} kernels/step, "
            f"mvau_small_m_kernel {n_mv:.0f}/step taking "
            f"{sum(e.device_time_total for e in mv_k) / reps / 1e3:.5f} "
            f"ms/step of device time, mvau_conv_kernel {n_conv:.0f}; device "
            f"busy {busy:.4f} ms of the untraced replay's "
            f"{step[('int', 8, 'replay')]:.4f} ms")
        # the f32 step on the same feeds: which kernels the int step runs
        # beyond it
        busy32, _, kern32 = profile_decode(
            torch, "lm_tiny f32 step replay (batch 8, capacity 32)",
            lambda: arts["f32"].dm(*xs), reps)
        if busy32 is not None:
            def by_key(ks):
                out = {}
                for e in ks:
                    n, us = out.get(e.key[:70], (0, 0.0))
                    out[e.key[:70]] = (n + e.count / reps,
                                       us + e.device_time_total / reps)
                return out
            ki, kf = by_key(kern), by_key(kern32)
            diff = sorted(((ki.get(k, (0, 0.0))[1] - kf.get(k, (0, 0.0))[1],
                            ki.get(k, (0, 0.0))[0] - kf.get(k, (0, 0.0))[0],
                            k) for k in set(ki) | set(kf)), reverse=True)
            log(f"profile lm_tiny int - f32 step (batch 8): busy {busy:.4f} "
                f"- {busy32:.4f} ms, kernels {per_step:.0f} - "
                f"{sum(e.count for e in kern32) / reps:.0f} a step; the "
                "kernels the int step spends more on:")
            for us, n, k in diff[:8]:
                log(f"  {us / 1e3:+8.4f} ms/step {n:+6.1f}x  {k}")

    # -- the engine ------------------------------------------------------------
    reg = ArtifactRegistry()
    adapter = DecodeAdapter()
    reg.register("lm-int", arts["int"], adapter=adapter, default=True)
    reg.register("lm-f32", arts["f32"], adapter=adapter)
    plan = [[(rng.integers(0, cfg.vocab, int(rng.integers(1, 7))).tolist())
             for _ in range(LM_TINY_SEQS_PER_THREAD)]
            for _ in range(LM_TINY_THREADS)]
    n_new = [int(rng.integers(20, 41)) for _ in range(LM_TINY_THREADS)]
    eng = ServeEngine(reg, max_batch=max(LM_TINY_BUCKETS),
                      buckets=LM_TINY_BUCKETS, batch_wait_ms=1.0)
    results, errors = {}, []

    def client(tid, artifact):
        try:
            results[(artifact, tid)] = greedy_generate(
                eng, plan[tid], n_new[tid], artifact=artifact)
        except Exception as e:                        # noqa: BLE001
            errors.append(repr(e))

    def traffic(artifact):
        threads = [threading.Thread(target=client, args=(t, artifact))
                   for t in range(LM_TINY_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    try:
        base = eng.warmup()
        tables = [a.dm._exec for a in arts.values()]
        start = {id(g): g.replays for t in tables for g in t.graphs.values()}
        B.reset_launch_counts()
        eng.metrics.reset_clock()
        t0 = time.perf_counter()
        traffic("lm-int")
        wall_int = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        traffic("lm-f32")
        serve_counts = dict(B.launch_counts)
        replayed = {k: 0 for k in serve_counts}
        for t in tables:
            for g in t.graphs.values():
                for k, v in g.launches.items():
                    replayed[k] += v * (g.replays - start[id(g)])
        traces = eng.trace_counts()
        # a traced window of the same int traffic: the device's busy share
        from torch.autograd import DeviceType
        from torch.profiler import profile

        with profile(**traced_steps()) as prof:
            greedy_generate(eng, [[1]], 2)             # warm-up step
            prof.step()
            t0 = time.perf_counter()
            traffic("lm-int")
            torch.cuda.synchronize()
            wall_traced = time.perf_counter() - t0
            prof.step()
    finally:
        eng.stop()
    check(not errors, f"lm_tiny engine clients failed: {errors[:3]}")
    check(traces == base, f"lm_tiny: captures after warmup {traces} != {base}")
    check(serve_counts == replayed, f"lm_tiny engine launches {serve_counts} "
          f"!= graph replays {replayed}")
    check(serve_counts["mvau_int"] > 0 and serve_counts["mvau_int_wide"] == 0
          and serve_counts["mvau_int_small_m"] == serve_counts["mvau_int"],
          f"lm_tiny engine: mvau_int launches {serve_counts}")
    n_tok = 0
    for tid in range(LM_TINY_THREADS):
        ti, tf = results[("lm-int", tid)], results[("lm-f32", tid)]
        check(ti == tf, f"lm_tiny thread {tid}: int tokens != f32 tokens")
        for p, toks in zip(plan[tid], ti):
            check(len(toks) == n_new[tid], "lm_tiny: wrong token count")
            check(toks == eager_greedy(p, n_new[tid], LM_TINY_CAPS[-1]),
                  f"lm_tiny: served tokens of {p} != eager decode_step_ref")
            n_tok += len(toks)
    crossed = sum(len(p) + n_new[tid] > LM_TINY_CAPS[0]
                  for tid in range(LM_TINY_THREADS) for p in plan[tid])
    busy_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep"))
    n_seq = LM_TINY_THREADS * LM_TINY_SEQS_PER_THREAD
    log(f"lm_tiny engine: {n_seq} "
        f"sequences from {LM_TINY_THREADS} threads through greedy_generate "
        f"(prompts of 1-6 tokens, {min(n_new)}-{max(n_new)} new tokens, "
        f"{crossed} crossing capacity {LM_TINY_CAPS[0]}), on the int "
        f"artifact then the f32 one: tokens int == f32 == eager "
        f"decode_step_ref; no capture after warmup {traces}; every launch a "
        f"replay {replayed}")
    log(f"lm_tiny engine metrics (int): {n_tok} tokens in {wall_int:.3f} s = "
        f"{n_tok / wall_int:.1f} tokens/s; {snap['completed']:.0f} requests "
        f"completed by then ({n_tok - n_seq} decode, {n_seq} prefill, the "
        f"rest release), latency over all of them: p50 "
        f"{snap['p50_ms']:.3f} ms, p99 {snap['p99_ms']:.3f} ms, mean batch "
        f"{snap['mean_batch']:.2f}; traced window {wall_traced * 1e3:.3f} ms, "
        + ("device busy not measured (no CUDA events)" if busy_us <= 0 else
           f"device busy {busy_us / 1e3:.3f} ms = "
           f"{busy_us / (wall_traced * 1e6):.1%} of the window"))
    log(f"lm_tiny phase: {time.perf_counter() - t_phase:.1f} s")
    return mv_lm, decode_counts, serve_counts


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


# ---------------------------------------------------------------------------
# Phase 9: LM training (lm_train)
# ---------------------------------------------------------------------------
LM_TRAIN_LAYERS = 4              # of qwen2.5-3b's 36: the cut of depth
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128
LM_TRAIN_STEPS = 20
LM_TRAIN_TIMED = 5
LM_TRAIN_LR = 3e-4
# the launcher's smoke (the reference's own command for its training stack)
LM_SMOKE = ["--arch", LM_ARCH, "--reduced", "--batch", "2", "--seq", "16"]
LM_SMOKE_STEPS = 3
# card against CPU on the smoke: the first loss is a forward on the same
# parameters; the later ones start from parameters that may differ by 2 lr
# where a gradient lies within the bf16 noise of 0 (AdamW's first update
# is close to lr * sign(g)), as the port against JAX does on the CPU
LM_SMOKE_RTOL = (1e-5, 1e-4, 1e-4)


def lm_train_path(torch, np, B):
    """The port's LM training path at Qwen2.5-3B's full width, cut to
    LM_TRAIN_LAYERS layers, on the card: ``make_train_step`` for
    LM_TRAIN_STEPS steps (the loss falls), two same-seed runs bit for bit,
    resume == straight through a checkpoint in the reference's layout,
    remat on == off bit for bit (peak memory of both), one step with int8
    error-feedback compression, and ``launch.train.main`` (the reference's
    smoke) on the card against the CPU.  No kernel of the port runs on
    this path: returns its launch counts, which must all be 0."""
    import dataclasses
    import io
    import tempfile
    from contextlib import redirect_stdout

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.synthetic import token_lm_batch
    from repro_torch.dist.compression import compress_int8, init_residuals
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import make_train_step, train_dtype_policy
    from repro_torch.models import lm
    from repro_torch.models.common import get_config
    from repro_torch.optim import AdamWState, adamw_init
    from repro_torch.tree import tree_flatten

    B.reset_launch_counts()
    t_phase = time.perf_counter()
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    _, moment_dtype, gdtype = train_dtype_policy(cfg)
    n_micro = cfg.grad_accum
    step = make_train_step(cfg, lr=LM_TRAIN_LR)

    def init():
        p = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        return p, adamw_init(p, moment_dtype)

    def batch(i):
        b = token_lm_batch(i, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab)
        return {k: torch.from_numpy(v).reshape(
            n_micro, LM_TRAIN_BATCH // n_micro, -1).cuda() for k, v in b.items()}

    def run(params, opt, first, n):
        losses = []
        for i in range(first, first + n):
            params, opt, loss = step(params, opt, batches[i])
            losses.append(loss)
        return params, opt, [float(v) for v in losses]

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(tree_flatten(a)[0],
                                                     tree_flatten(b)[0]))

    batches = [batch(i) for i in range(LM_TRAIN_STEPS + 1 + LM_TRAIN_TIMED)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, opt = init()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    log(f"lm_train: {LM_ARCH} at full width (d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab} padded {cfg.vocab_padded}, QKV bias, tied "
        f"embeddings), cut to {cfg.n_layers} of {full.n_layers} layers; "
        f"{n_params} parameters ({cfg.compute_dtype} compute, params / "
        f"moments / gradient buffers {str(torch.float32)[6:]} / "
        f"{str(moment_dtype)[6:]} / {str(gdtype)[6:]}, remat "
        f"{cfg.remat}); grad_accum {n_micro}, batch {LM_TRAIN_BATCH}, seq "
        f"{LM_TRAIN_SEQ}, token_lm_batch data, make_train_step(lr="
        f"{LM_TRAIN_LR}), random weights (CUDA generator, seed 0)")

    # -- the loss falls over LM_TRAIN_STEPS steps ----------------------------
    t0 = time.perf_counter()
    params, opt, losses = run(params, opt, 0, LM_TRAIN_STEPS + 1)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses),
          f"lm_train losses not finite: {losses}")
    check(losses[LM_TRAIN_STEPS] < losses[0],
          f"lm_train loss after {LM_TRAIN_STEPS} steps {losses[-1]} >= "
          f"{losses[0]} at step 0")
    log(f"lm_train: {LM_TRAIN_STEPS + 1} steps in {t_run:.2f} s (first step "
        f"included); loss {losses[0]:.4f} -> {losses[LM_TRAIN_STEPS]:.4f} "
        f"after {LM_TRAIN_STEPS} steps; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB over the "
        f"{base / 2**30:.3f} GiB held before the phase)")

    # -- time: CUDA events over steps on resident batches, then one traced ---
    state = {"p": params, "o": opt, "i": LM_TRAIN_STEPS + 1}

    def one_step():
        state["p"], state["o"], _ = step(state["p"], state["o"],
                                         batches[state["i"] % len(batches)])
        state["i"] += 1

    one_step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(LM_TRAIN_TIMED):
        one_step()
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) / LM_TRAIN_TIMED * 1e3
    step_ms = start.elapsed_time(end) / LM_TRAIN_TIMED
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    busy, kern = profile_forward(torch, "lm_train step", one_step, reps=2,
                                 batch=LM_TRAIN_BATCH, unit="step", top=15)
    groups = {}
    for e in kern:
        name = e.key.lower()
        group = ("GEMM" if any(t in name for t in ("gemm", "nvjet", "cutlass",
                                                    "sm90_", "xmma"))
                 else "reduction" if "reduce" in name
                 else "copy/cast" if "copy" in name or "cat" in name
                 else "elementwise")
        n, t = groups.get(group, (0, 0.0))
        groups[group] = (n + e.count, t + e.device_time_total)
    log("lm_train step by kind: " + ", ".join(
        f"{g} {t / 2e3:.3f} ms ({n / 2:.0f} kernels)"
        for g, (n, t) in sorted(groups.items(), key=lambda kv: -kv[1][1])))
    log(f"lm_train step: {step_ms:.3f} ms (CUDA events, {LM_TRAIN_TIMED} "
        f"steps on resident batches; host wall {wall_ms:.3f} ms), "
        f"{tokens / step_ms * 1e3:.1f} tokens/s, "
        f"{sum(e.count for e in kern) / 2:.0f} kernels a step, device busy "
        + (f"{busy:.3f} ms ({busy / step_ms:.1%} of the untraced step)"
           if busy is not None else "not measured"))
    del params, opt, state

    # -- two same-seed runs, bit for bit; resume == straight -----------------
    n3 = 3
    pa, oa, la = run(*init(), 0, n3)
    pb, ob, lb = run(*init(), 0, n3)
    check(la == lb and same(pa, pb) and same(oa.m, ob.m)
          and same(oa.v, ob.v),
          f"two same-seed lm_train runs differ: losses {la} / {lb}")
    del pb, ob
    t0 = time.perf_counter()
    p2, o2, l2 = run(*init(), 0, 2)
    with tempfile.TemporaryDirectory(prefix="lm-train-ckpt-") as d:
        mgr = CheckpointManager(d)
        mgr.save(2, {"params": p2, "m": o2.m, "v": o2.v},
                 meta={"step": 2, "mesh": [1, 1], "arch": cfg.name})
        like, _ = init()
        st = mgr.restore({"params": like, "m": like, "v": like})
        meta = mgr.meta()
    del p2, o2, like
    o3 = AdamWState(step=torch.full((), meta["step"], dtype=torch.int32,
                                    device="cuda"), m=st["m"], v=st["v"])
    p3, o3, l3 = run(st["params"], o3, 2, 1)
    ck_s = time.perf_counter() - t0
    check(l2 + l3 == la and same(p3, pa) and same(o3.m, oa.m)
          and same(o3.v, oa.v),
          f"lm_train resume != straight: losses {l2 + l3} / {la}")
    log(f"lm_train: two same-seed runs of {n3} steps equal bit for bit "
        f"(losses {la}, every parameter and moment); 2 steps + checkpoint "
        f"(params, m, v: {3 * n_params * 4 / 2**30:.2f} GiB, meta {meta}) + "
        f"restore + 1 step == {n3} straight, bit for bit ({ck_s:.1f} s)")
    del pa, oa, p3, o3, st

    # -- remat on and off: equal loss and gradients, bit for bit -------------
    mb = {k: v[0] for k, v in batches[0].items()}
    grads, peaks = {}, {}
    params, _ = init()
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        leaves, unflatten = tree_flatten(params)
        live = [t.detach().requires_grad_(True) for t in leaves]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = lm.loss_fn(unflatten(live), mb, c)
        g = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        grads[remat] = (loss.detach(), g)
        del live, loss, g
    check(torch.equal(grads[True][0], grads[False][0])
          and all(torch.equal(a, b) for a, b in zip(grads[True][1],
                                                    grads[False][1])),
          "lm_train: remat on and off give different loss or gradients")
    log(f"lm_train: remat on == off, loss and every gradient bit for bit "
        f"(one microbatch of {LM_TRAIN_BATCH // n_micro} x {LM_TRAIN_SEQ}); "
        f"peak memory {peaks[True] / 2**30:.3f} GiB with remat, "
        f"{peaks[False] / 2**30:.3f} GiB without")
    del grads

    # -- one step with int8 error-feedback compression -----------------------
    opt = adamw_init(params, moment_dtype)
    res0 = init_residuals(params)
    leaves, unflatten = tree_flatten(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    acc = [torch.zeros_like(t) for t in leaves]
    for i in range(n_micro):
        g = torch.autograd.grad(lm.loss_fn(unflatten(live), {
            k: v[i] for k, v in batches[0].items()}, cfg), live)
        for a, gi in zip(acc, g):
            a.add_(gi)
    del live, g
    scales = [compress_int8(torch.div(a, torch.full(
        (), float(n_micro), device="cuda")))[1] for a in acc]
    del acc
    cstep = make_train_step(cfg, lr=LM_TRAIN_LR, compress_pod_grads=True)
    _, _, closs, res = cstep(params, opt, batches[0], res0)
    worst = max(float(r.abs().max() / s) for r, s in
                zip(tree_flatten(res)[0], scales))
    check(float(closs) == losses[0],
          f"EF-compressed step loss {float(closs)} != {losses[0]}, the same "
          "parameters and batch")
    check(worst <= 0.5 + 127 * 2 ** -23,
          f"EF residual {worst} of its leaf's int8 step, above 1/2")
    log(f"lm_train: one step with compress_pod_grads=True: loss "
        f"{float(closs):.6f} (uncompressed {losses[0]:.6f}); largest "
        f"residual {worst:.6f} of its leaf's int8 step (bound 1/2)")
    del params, opt, res0, res, scales

    # -- the reference's smoke through launch.train, card against CPU --------
    got = {}
    for dev in ("cuda", "cpu"):
        got[dev] = []
        for n in range(1, LM_SMOKE_STEPS + 1):
            args = LM_SMOKE + ["--steps", str(n)]
            buf = io.StringIO()
            with tempfile.TemporaryDirectory(prefix="lm-smoke-") as d, \
                    redirect_stdout(buf):
                got[dev].append(launch_train.main(
                    args + ["--ckpt-dir", d] if dev == "cuda"
                    else args + ["--device", "cpu"]))
            if n == LM_SMOKE_STEPS:
                got[dev + "_out"] = buf.getvalue().strip().splitlines()
    rel = [abs(a - b) / abs(b) for a, b in zip(got["cuda"], got["cpu"])]
    check(all(r <= t for r, t in zip(rel, LM_SMOKE_RTOL)),
          f"launch.train smoke: card losses {got['cuda']} against CPU "
          f"{got['cpu']} (relative {rel}, allowed {LM_SMOKE_RTOL})")
    check(ieee_flags(torch), "TF32 is on after LM training")
    log(f"lm_train: `python -m repro_torch.launch.train "
        f"{' '.join(LM_SMOKE)} --steps {LM_SMOKE_STEPS}` on the card: losses "
        f"{got['cuda']}, on the CPU {got['cpu']} (relative "
        f"{['%.3g' % r for r in rel]}, allowed {LM_SMOKE_RTOL}); its lines "
        f"on the card: {got['cuda_out']}")

    counts = dict(B.launch_counts)
    check(all(v == 0 for v in counts.values()),
          f"lm_train launched a kernel of the port: {counts}")
    log(f"lm_train: phase {time.perf_counter() - t_phase:.2f} s; launches "
        f"{counts} (the training path multiplies float weights: no kernel "
        f"of the port is on it)")
    return counts


DIST_RANKS = 2                 # ranks spawned on the one card (gloo)
DIST_TIMEOUT = 240             # s, one tools/dist_smoke.py run


def dist_smoke(backend: str, ranks: int):
    """``tools/dist_smoke.py --spawn ranks --backend backend --time``: its
    summary (each rank's launches over its sharded runs summed)."""
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, str(ROOT / "tools" / "dist_smoke.py"),
               "--spawn", str(ranks), "--backend", backend, "--time",
               "--out", out]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=DIST_TIMEOUT)
        path = Path(out) / "summary.json"
        check(path.exists(), f"dist {backend} x{ranks}: no summary; exit "
              f"{r.returncode}\n{r.stderr[-3000:]}")
        summary = json.loads(path.read_text())
    tag = f"dist {ranks} rank{'s' if ranks > 1 else ''} {backend}"
    for name, c in summary["checks"].items():
        log(f"  {tag} {name}: " + json.dumps(
            {k: v for k, v in c.items() if k not in ("steps", "error")}))
    for name, why in summary["deferred"].items():
        log(f"  {tag} {name}: not run: {why}; across ranks it runs in the "
            f"4-card NCCL call of tools/dist_smoke.py")
    check(r.returncode == 0 and summary["ok"],
          f"{tag} failed: {summary['failed']} "
          + json.dumps({n: c.get("error", "")[-1500:]
                        for n, c in summary["checks"].items()
                        if not c.get("ok")}))
    return summary


def dist_path(torch, np, B):
    """Phase 10: the distribution substrate on the card (see the module
    docstring): (a) one rank over NCCL, (b) two ranks over gloo, each
    ``tools/dist_smoke.py`` spawned from here (the kernel library built
    above is loaded, not built, by the ranks).  Returns the ``dist``
    path's launch counts (the ranks' sharded runs) and a report."""
    t_phase = time.perf_counter()
    B.reset_launch_counts()
    counts = dict(B.launch_counts)
    report = {}
    for backend, ranks in (("nccl", 1), ("gloo", DIST_RANKS)):
        summary = dist_smoke(backend, ranks)
        if backend == "gloo":
            log(f"dist {ranks} ranks on one card over gloo: CUDA tensors "
                f"staged through the host by gloo; collectives "
                f"{summary['collectives']}")
        for k, v in summary["launches"].items():
            counts[k] += v
        report[f"{backend}{ranks}"] = {
            k: summary[k] for k in ("world", "checks", "deferred",
                                    "launches")}
    check(counts["mvau_int"] > 0 and counts["mvau_int_gap"] > 0
          and counts["qmatmul"] > 0, f"dist path: launches {counts}")
    moe = report["nccl1"]["checks"]["train"].get("archs", {}).get(
        "grok-1-314b", {}).get("meshes", {}).get("1x1_acc", {})
    check(moe.get("bitforbit") and moe.get("dispatch_bitforbit"),
          f"dist: the MoE train step on 1x1 is not the plain step's bits: "
          f"{moe}")
    log(f"dist: MoE train step 1x1 sharded {moe.get('ms_sharded')} ms, "
        f"serial {moe.get('ms_serial')} ms, collective bytes a step "
        f"{moe.get('collective_bytes')}")
    check(report["nccl1"]["checks"]["train"]["ok"]
          and report["nccl1"]["checks"]["decode"]["ok"]
          and report["nccl1"]["checks"]["restore"]["ok"]
          and report[f"gloo{DIST_RANKS}"]["checks"]["head"]["ok"],
          "dist: a check of (a) or (b) did not run")
    log(f"dist: launches {counts}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts, report


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
    smi_line = card_line()
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
        # the plane route's instantiations: (VEC, PlaneKind) -> registers
        planes = sorted({(int(m.group(2)), int(m.group(1)), int(r))
                         for e in entries for m in [re.match(
                             r"\S*mvau_conv_kernelILi(\d+)ELi\d+ELi\d+ELi(\d+)"
                             r"EE", e)] if m and int(m.group(2)) > 0
                         for r in re.findall(r"Used (\d+) registers", e)})
        if planes:
            log(f"  ptxas {section.split()[0]}: mvau_conv_kernel plane kinds "
                "(PlaneKind, VEC, registers) " + ", ".join(
                    f"({k}, {v}, {r})" for k, v, r in planes))
    B.library()

    err = check_kernels(torch, Q, KM, KG, ref)
    kernels = time_kernels(torch, Q, KM, KG, ref, err)
    fuzz_counts, _ = fuzz_path(torch, np, B)

    graph_state = fsl_graph_path(torch, np, B)
    B.reset_launch_counts()
    dm_int, x = main_path(torch, np, B)
    fsl_counts = dict(B.launch_counts)
    profile_fsl_graphs(torch, B, graph_state)
    del graph_state
    serve_counts = engine_phase(torch, np, B)
    cluster_counts = cluster_phase(torch, np, B)
    mv = next(k for k in kernels if k["name"] == "mvau_int")
    mv["real_inputs_ms"], fused_real_ms = time_real_inputs(
        torch, KM, dm_int, x, mv.pop("layer_ms"))
    next(k for k in kernels
         if k["name"] == "mvau_int_gap")["real_inputs_ms"] = fused_real_ms
    del dm_int, x
    wide_counts = wide_code_path(torch, np, B)
    qmm, lm_counts, lm_graph_counts = lm_path(torch, np, B, Q, KQ)
    kernels.append(qmm)
    fam_counts, fam_graph_counts, qmm["lm_families"] = lm_families_path(
        torch, np, B, Q, KQ)
    mma_counts, mma_graph_counts, qmm["moe_mla_audio"] = moe_mla_audio_path(
        torch, np, B, Q, KQ)
    mv_lm, tiny_counts, tiny_serve_counts = lm_tiny_path(torch, np, B, KM,
                                                         ref, err)
    mv["max_abs_err"] = max(mv["max_abs_err"], err["mvau_int"])
    train_counts = train_path(torch, np, B)
    dse_counts = dse_path(torch, np, B)
    lm_train_counts = lm_train_path(torch, np, B)
    dist_counts, _ = dist_path(torch, np, B)
    paths = {"fuzz": fuzz_counts, "fsl": fsl_counts,
             "fsl_wide_codes": wide_counts,
             "fsl_serve": serve_counts, "cluster": cluster_counts,
             "lm_decode": lm_counts,
             "lm_decode_graph": lm_graph_counts,
             "lm_families": fam_counts,
             "lm_families_graph": fam_graph_counts,
             MMA_PATHS[0]: mma_counts, MMA_PATHS[1]: mma_graph_counts,
             "lm_tiny_decode": tiny_counts, "lm_tiny_serve": tiny_serve_counts,
             "fsl_train": train_counts, "dse": dse_counts,
             "lm_train": lm_train_counts, "dist": dist_counts}
    planes = next(k for k in kernels if k["name"] == "mvau_int_planes")
    kernels.remove(planes)
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
        else:
            # the recurrent-state and vision-language families, and MoE,
            # MLA and the encoder-decoder, eager and replayed
            check(all(by_path[p] > 0 for p in ("lm_families",
                                               "lm_families_graph",
                                               *MMA_PATHS)),
                  f"qmatmul never ran on the LM families' paths: {by_path}")
    # qmatmul's routes: the decode kernel on every decode step, the
    # many-row kernel on whisper's encode and cross cache (its main path)
    qk = next(k for k in kernels if k["name"] == "qmatmul")
    qk["launches_by_route"] = {
        "decode": {p: c["qmatmul"] - c["qmatmul_rows"]
                   for p, c in paths.items()},
        "rows": {p: c["qmatmul_rows"] for p, c in paths.items()}}
    by_rows = qk["launches_by_route"]["rows"]
    check(all(v == 0 for p, v in by_rows.items() if p != MMA_PATHS[0])
          and by_rows[MMA_PATHS[0]] == 2 * (WHISPER_ENC_QMM
                                            + WHISPER_CROSS_QMM)
          and qk["launches_by_route"]["decode"]["lm_decode"]
          == qk["launches"],
          f"qmatmul's routes by path: {qk['launches_by_route']}")
    wcfg = mma_config("whisper-tiny")
    shapes = qmm["moe_mla_audio"]["shapes"]
    wrep = qmm["moe_mla_audio"]["whisper-tiny"]

    def whisper_rows(bits):
        prods = [(shapes[f"w{bits} {m}x{k}x{n}"], c)
                 for _, m, k, n, c in whisper_encoder_products(wcfg)]
        check(all(v["route"] == "rows" for v, _ in prods),
              "a whisper encoder product is not on the rows route")
        tot = {key: sum(v[key] * c for v, c in prods) for key in
               ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                           else "operations")
        tot["encode_ms"] = wrep[f"w{bits}"]["encode_ms"]
        tot["cross_ms"] = wrep[f"w{bits}"]["cross_ms"]
        return tot

    w8r, w4r = whisper_rows(8), whisper_rows(4)
    kernels.append({
        "name": "qmatmul_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qmatmul.py:64",
        "launches_by_path": by_rows, "launches": by_rows[MMA_PATHS[0]],
        "max_abs_err": qk.pop("max_abs_err_rows"),
        **{k: w8r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
        "per": f"whisper-tiny's {WHISPER_ENC_QMM} encode and "
               f"{WHISPER_CROSS_QMM} cross-cache launches at M "
               f"{LM_BATCH * wcfg.enc_seq}, w8, from the per-shape times",
        "w4": {k: w4r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        "encode_ms": {"w8": w8r["encode_ms"], "w4": w4r["encode_ms"]},
        "cross_ms": {"w8": w8r["cross_ms"], "w4": w4r["cross_ms"]}})
    log(f"kernel qmatmul_rows over whisper's {WHISPER_ENC_QMM} + "
        f"{WHISPER_CROSS_QMM} launches: w8 kernel_ms={w8r['ms']:.4f} "
        f"library_ms={w8r['library_ms']:.4f} bound_ms={w8r['bound_ms']:.4f}"
        f"; w4 kernel_ms={w4r['ms']:.4f} library_ms={w4r['library_ms']:.4f} "
        f"bound_ms={w4r['bound_ms']:.4f}; encode {w8r['encode_ms']:.4f} / "
        f"{w4r['encode_ms']:.4f} ms (w8 / w4)")
    # the distribution path: the sharded head's int artifact and the
    # column-sharded decode projections ran the kernels on the ranks
    for name in ("mvau_int", "mvau_int_gap", "qmatmul"):
        k = next(k for k in kernels if k["name"] == name)
        check(k["launches_by_path"]["dist"] > 0,
              f"kernel {name} never ran on the dist path")
    # the integer MVAU's routes: int8 wgmma, the int8 GEMM form at decode
    # shapes (mvau_small_m_kernel), the plane route of the tensor cores for
    # codes of up to 24 bits (grid_point(8, 8), the 8- and 16-bit Table II
    # rows, paper_w16a16(), the 16-bit artifacts' c2, whose input is a
    # 17-bit residual sum, among them), and the CUDA cores for wider codes
    # (the kernel phase's int32 codes; no artifact's layer)
    mv = next(k for k in kernels if k["name"] == "mvau_int")
    mv["launches_by_route"] = {
        "int8_wgmma": {p: c["mvau_int"] - c["mvau_int_wide"]
                       - c["mvau_int_small_m"] - c["mvau_int_planes"]
                       for p, c in paths.items()},
        "int8_small_m": {p: c["mvau_int_small_m"] for p, c in paths.items()},
        "planes": {p: c["mvau_int_planes"] for p, c in paths.items()},
        "cuda_core": {p: c["mvau_int_wide"] for p, c in paths.items()}}
    for route in ("int8_wgmma", "planes"):
        by_path = mv["launches_by_route"][route]
        check(by_path["fsl_train"] > 0 and by_path["dse"] > 0,
              f"mvau_int's {route} route never ran on the training or the "
              f"DSE path: {by_path}")
    # the plane route: its own entry, its launches those of the wide-code
    # artifacts' counted forwards (its main path), training, the DSE and
    # the fuzz beside them
    planes["launches_by_path"] = mv["launches_by_route"]["planes"]
    planes["launches"] = planes["launches_by_path"]["fsl_wide_codes"]
    check(all(planes["launches_by_path"][p] > 0 for p in
              ("fsl_wide_codes", "fsl_train", "dse", "fuzz")),
          f"the plane route never ran on its paths: "
          f"{planes['launches_by_path']}")
    # its two-product (the (8, 8) point's 9-bit c2 x int8 weights) and
    # six-product (w16a16's 17-bit c2) kinds, by path; the wide artifacts
    # run no MVAU on the CUDA cores
    for key, name in (("x2w1", "mvau_int_planes2"),
                      ("x3w2", "mvau_int_planes6")):
        planes[f"{key}_launches_by_path"] = {p: c[name]
                                             for p, c in paths.items()}
        check(paths["fsl_wide_codes"][name] > 0,
              f"the plane route's {key} kind never ran on fsl_wide_codes")
    check(mv["launches_by_route"]["cuda_core"]["fsl_wide_codes"] == 0,
          "an MVAU of the wide-code artifacts ran on the CUDA cores")
    kernels.append(planes)
    # the small-M kernel: its own entry, its launches those of lm-tiny's
    # eager int steps (its main path), the replays and the fuzz beside them
    r1 = mv_lm["M1"]
    small = {"name": "mvau_int_small_m", "route": "cuda",
             "source": "src/repro_torch/csrc/mvau.cu",
             "replaces": "src/repro/kernels/mvau.py:195",
             "launches_by_path": mv["launches_by_route"]["int8_small_m"],
             "launches": mv["launches_by_route"]["int8_small_m"][
                 "lm_tiny_decode"],
             "max_abs_err": err["mvau_int_small_m"], "ms": r1["ms"],
             "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"],
             "bound_by": r1["bound_by"], "library_ms": r1["library_ms"],
             "form": "GEMM form at lm-tiny's w_down, M 1 (M 8: at_m8), K 96, "
                     f"N 64, {LM_TINY_LEVELS} levels, mma.sync swap-AB",
             "wgmma_ms": r1["wgmma_ms"],
             "empty_launch_ms": r1["empty_launch_ms"],
             "ms_15_levels": r1["ms_15_levels"], "ms_m128": r1["ms_m128"],
             "at_m8": mv_lm["M8"]}
    check(all(small["launches_by_path"][p] > 0 for p in
              ("lm_tiny_decode", "lm_tiny_serve", "fuzz")),
          f"the small-M kernel never ran on its paths: "
          f"{small['launches_by_path']}")
    kernels.append(small)
    # the differential fuzz: every integer route, the float MVAU, the
    # fused GAP tail and the GAP kernel (checked in fuzz_path, read here
    # again)
    check(all(mv["launches_by_route"][r]["fuzz"] > 0 for r in
              ("int8_wgmma", "int8_small_m", "planes"))
          and all(paths["fuzz"][n] > 0 for n in ("mvau", "mvau_int_gap",
                                                   "gap")),
          f"fuzz path: launches {paths['fuzz']}")
    # the cluster's traffic: the int backbone's 8 mvau_int launches a forward
    # on the int8 wgmma route, r2b's with the GAP epilogue (replays only)
    cl = paths["cluster"]
    check(cl["mvau_int"] > 0 and cl["mvau_int_gap"] > 0
          and mv["launches_by_route"]["cuda_core"]["cluster"] == 0
          and cl["mvau_int"] == 8 * cl["mvau_int_gap"],
          f"cluster path: launches {cl}")
    # the compiled LM decode: every mvau_int launch on the small-M kernel
    for p in ("lm_tiny_decode", "lm_tiny_serve"):
        check(paths[p]["mvau_int"] > 0
              and mv["launches_by_route"]["int8_small_m"][p]
              == paths[p]["mvau_int"],
              f"lm-tiny path {p}: mvau_int launches {paths[p]}")
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
