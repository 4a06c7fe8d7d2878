#!/usr/bin/env python3
"""Where the conv-form MVAU kernels spend their time on the card.

Builds ``src/repro_torch/csrc/mvau.cu`` as it stands and variants of it
side by side (one ``nvcc`` each, all started together), then times each on
the 8 conv layers of the paper's w6a4 ResNet-9 at width 64, batch 64,
32x32 frames (CUDA events, random inputs).

The int8 tensor-core kernel (``mvau_conv_kernel``, ``--only int8``):

* ``kernel``      the source as committed;
* ``no_mma``      the wgmma instructions removed;
* ``no_loads``    the A copies and the B global loads removed;
* ``phases``      the source with clock64 stamps: cycles per block in the
                  prologue, the mainloop (and per K-tile), the split-K
                  reduction, the threshold count and the stores;

and the committed kernel with L = 0 levels (no count), and on forced K
splits (1, 2, 4, 6, 8) for the layers whose output tiles are fewer than the
SMs.

The CUDA-core kernel as the float MVAU (``mvau_core_kernel``, ``--only
core``), float32 activations on the fixed-point grid:

* ``kernel``      the source as committed;
* ``no_ffma``     7 of every 8 FMAs removed (each fragment value still
                  feeds one);
* ``no_loads``    the A and B copies into shared memory removed;

and the committed kernel with L = 0 levels, on forced K splits, beside
``torch.matmul`` + count on pre-built patches (the library yardstick) and
``torch.matmul`` alone.

The int8 GEMM form's two routes (``--only gemm``, the committed library
only): ``mvau_small_m_kernel`` and the wgmma kernel on the same inputs for
M from 1 to 8,192 rows at lm-tiny's ``w_down`` (K 96, N 64, 255 levels,
and 15, and with packed int4 weights), at K 1,440 x N 160 with 255 levels
and at K 1,152 x N 512 with 15 (a ResNet-9 layer's widths), each launch
held against the plain version, beside ``torch._int_mm`` + count (M
padded to a multiple of 32) and an empty launch of the small-M kernel's
grid.  It prints, per shape, the largest M up to which the small-M kernel
is never slower; the least of them sets ``kernels/mvau.py``'s
``SMALL_M_ROWS``.

The wide-code artifacts (``--only wide``, the committed library only):
``paper_w16a16()`` and ``grid_point(8, 8)`` compiled at width 64 on the
card, one forward at batch 64 recorded, and each of its 8 conv-form
MVAUs timed on the inputs that forward gives it, on its real threshold
tables (65,535 levels for the 16-bit baseline, binary-searched): the
launch as the artifact runs it, the same launch with no levels (the
product alone; the count is the difference), and the CUDA-core kernel on
the same codes as int32 (held equal to the launch bit for bit), as run
and product alone.  It first prints the registers and spills ``ptxas``
gave every instantiation of the plane route's kernel.

The variants compute wrong values; only the committed kernels are held
against their plain versions.  Run on the machine with the card::

    PYTHONPATH=src python3 tools/probe_mvau_conv.py [--only int8|core|gemm|wide]

The variants are text edits of the source: an edit that no longer applies
stops the run, naming the text it looked for.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import resnet9  # noqa: E402

BATCH, WIDTH, IMG, LEVELS = 64, 64, 32, 15
SRC = (ROOT / "src/repro_torch/csrc/mvau.cu").read_text()
OUT = B.BUILD_DIR / "probe"

DBG = """
extern "C" int probe_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));
}
extern "C" int probe_reset() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
"""


def edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"probe edit no longer applies: {old[:70]!r}")
    return text.replace(old, new)


def variants() -> dict:
    no_mma = edit(SRC, """        wgmma_m64n64k32<PL == PL_U8>(acc[i],
                                     wgmma_desc(a_sm + stage * TC_BM * TC_BK +
                                                i * 64 * TC_BK + 32 * kk),
                                     db);""", "        if (db == 1) acc[i][0][0] += 1;")
    no_loads = edit(edit(
        SRC, "          cp_async16(smem_u32(dst + swz(row, a_seg)), src, ok);", ""),
        """            const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                static_cast<const int8_t*>(w) + static_cast<size_t>(kk) * N +
                n));""", "            const uint2 v = make_uint2(kk, n);")
    ph = edit(SRC, "namespace {\n", "__device__ unsigned long long g_phase[8];\n"
              "namespace {\n")
    ph = edit(ph, "  const int tid = threadIdx.x;\n  const int lane = tid & 31;\n"
              "  const int warp = tid >> 5;\n  // warpgroup",
              "  const long long T0 = clock64();\n  const int tid = threadIdx.x;\n"
              "  const int lane = tid & 31;\n  const int warp = tid >> 5;\n"
              "  // warpgroup")
    ph = edit(ph, "  if constexpr (PB) {\n    // Byte planes: raw A tiles",
              "  const long long T1 = clock64();\n"
              "  if constexpr (PB) {\n    // Byte planes: raw A tiles")
    ph = edit(ph, "  cp_async_wait<0>();\n  __syncthreads();\n",
              "  cp_async_wait<0>();\n  __syncthreads();\n"
              "  const long long T2 = clock64();\n")
    ph = edit(ph, "  // ---- epilogue: threshold counts in registers",
              "  const long long T3 = clock64();\n"
              "  // ---- epilogue: threshold counts in registers")
    ph = edit(ph, "  const bool pairs = (N & 1) == 0;",
              "  const long long T4 = clock64();\n"
              "  const bool pairs = (N & 1) == 0;")
    stamps = ("  if (tid == 0) {\n    const long long T5 = clock64();\n"
              "    const long long d[5] = {T1 - T0, T2 - T1, T3 - T2, T4 - T3, "
              "T5 - T4};\n"
              "    for (int q = 0; q < 5; ++q) atomicAdd(&g_phase[q], "
              "(unsigned long long)d[q]);\n"
              "    atomicAdd(&g_phase[5], 1ull);\n"
              "    atomicAdd(&g_phase[6], (unsigned long long)nkt);\n  }\n")
    ph = edit(ph, "}\n\ntemplate <int VEC, int WK, int EPI, int PL>\n"
              "int launch_conv(",
              stamps + "}\n\ntemplate <int VEC, int WK, int EPI, int PL>\n"
              "int launch_conv(")
    return {"kernel": SRC, "no_mma": no_mma, "no_loads": no_loads,
            "phases": ph + DBG}


def core_variants() -> dict:
    """Ablations of the CUDA-core kernel."""
    no_ffma = edit(SRC, "          for (int j = 0; j < TN; ++j) acc[i][j] = "
                   "mad(a[i][kk], b[j], acc[i][j]);",
                   "          for (int j = 0; j < TN; ++j)\n"
                   "            if (i == j) acc[i][j] = mad(a[i][kk], b[j], "
                   "acc[i][j]);")
    no_loads = edit(edit(
        SRC, """        cp_async16(smem_u32(As + ((tid >> 2) + 64 * p) * CORE_AS + seg), src,
                   ok);""", ""),
        """        cp_async16(smem_u32(dst), ok ? wp + static_cast<size_t>(gk) * N + gn : wp,
                   ok);""", "")
    return {"kernel": SRC, "no_ffma": no_ffma, "no_loads": no_loads}


def build_all(srcs: dict) -> dict:
    """{name: source} -> {name: (library, the conv-form integer entry, the
    CUDA-core entry)}; prints each build's spills."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = B._nvcc()
    procs = {}
    for name, text in srcs.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *B.ARCH_FLAGS, *B.CFLAGS, "-shared", "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{out[-4000:]}")
        spills = sorted({int(v) for v in re.findall(
            r"(\d+) bytes spill stores", out)})
        print(f"  {name}: spill stores {spills} bytes")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = lib.repro_mvau_int_conv
        fn.argtypes = [P, P, I, P, P] + [I] * 11 + [P, P, P]
        fn.restype = I
        core = lib.repro_mvau_core_conv
        core.argtypes = [P, I, P, I, P, P] + [I] * 10 + [F, F, F, I, P, P, P]
        core.restype = I
        libs[name] = (lib, fn, core)
    return libs


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def probe_int8(libs: dict, sms: int) -> None:
    gen = torch.Generator().manual_seed(0)
    counts = torch.zeros(4096, dtype=torch.int32, device="cuda")
    layers, hw = [], IMG
    for blk in resnet9.plan(WIDTH):
        cin, n = blk["cin"], blk["cout"]
        x = torch.randint(0, 16, (BATCH, hw, hw, cin), generator=gen
                          ).to(torch.int8).cuda()
        w = torch.randint(-32, 32, (9 * cin, n), generator=gen
                          ).to(torch.int8).cuda()
        t = torch.sort(torch.randint(-2000, 2000, (n, LEVELS), generator=gen),
                       dim=1).values.to(torch.int32).cuda()
        layers.append((blk["name"], hw, cin, n, x, w, t))
        if blk.get("pool"):
            hw //= 2

    def launcher(fn, hw, cin, n, x, w, t, splits):
        m = BATCH * hw * hw
        tiles = -(-m // 128) * -(-n // 128)
        ws = (torch.empty(tiles * splits * 128 * 128, dtype=torch.int32,
                          device="cuda") if splits > 1 else None)
        out = torch.empty((BATCH, hw, hw, n), dtype=torch.int32, device="cuda")

        def go():
            rc = fn(x.data_ptr(), w.data_ptr(), 0, t.data_ptr(), out.data_ptr(),
                    BATCH, hw, hw, cin, 3, 1, 1, n, t.shape[1], 0, splits,
                    None if ws is None else ws.data_ptr(), counts.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        return go, out

    def plan(hw, cin, n):
        return KM.tc_splits(BATCH * hw * hw, n, 9 * cin, sms)

    names = " ".join(f"{lay[0]:>7s}" for lay in layers)
    print(f"{'variant':14s} {'sum':>7s} {names}   (ms, batch {BATCH})")
    for vname, (_, fn, _) in libs.items():
        per = []
        for name, hw, cin, n, x, w, t in layers:
            go, out = launcher(fn, hw, cin, n, x, w, t, plan(hw, cin, n))
            if vname == "kernel":
                go()
                torch.cuda.synchronize()
                if not torch.equal(out, KM.mvau_int_conv_plain(x, w, t, 3, 1, 1)):
                    raise SystemExit(f"{name}: the kernel differs from its "
                                     "plain version")
            per.append(cuda_ms(go))
        print(f"{vname:14s} {sum(per):7.4f} " + " ".join(f"{v:7.4f}" for v in per))
    per = []
    for name, hw, cin, n, x, w, t in layers:
        go, _ = launcher(libs["kernel"][1], hw, cin, n, x, w, t[:, :0].contiguous(),
                         plan(hw, cin, n))
        per.append(cuda_ms(go))
    print(f"{'kernel, L=0':14s} {sum(per):7.4f} " + " ".join(f"{v:7.4f}" for v in per))

    print("K splits (ms) where the output tiles are fewer than the SMs:")
    for name, hw, cin, n, x, w, t in layers:
        m = BATCH * hw * hw
        if -(-m // 128) * -(-n // 128) >= sms:
            continue
        row = {s: cuda_ms(launcher(libs["kernel"][1], hw, cin, n, x, w, t, s)[0])
               for s in (1, 2, 4, 6, 8)}
        print(f"  {name}: planned {plan(hw, cin, n)}; " +
              ", ".join(f"{s}: {v:.4f}" for s, v in row.items()))

    lib, fn, _ = libs["phases"]
    buf = (ctypes.c_ulonglong * 8)()
    print("cycles per block (thread 0, clock64), phases variant:")
    for name, hw, cin, n, x, w, t in layers:
        go, _ = launcher(fn, hw, cin, n, x, w, t, plan(hw, cin, n))
        go()
        torch.cuda.synchronize()
        lib.probe_reset()
        go()
        torch.cuda.synchronize()
        lib.probe_read(buf)
        nb = max(1, buf[5])
        print(f"  {name}: {buf[5]} blocks reached the end, "
              f"{buf[6] / nb:.1f} K-tiles each; prologue {buf[0] / nb:.0f}, "
              f"mainloop {buf[1] / nb:.0f} ({buf[1] / max(1, buf[6]):.0f} per "
              f"K-tile), split-K {buf[2] / nb:.0f}, count {buf[3] / nb:.0f}, "
              f"stores {buf[4] / nb:.0f}")


def probe_core(libs: dict, sms: int) -> None:
    """The CUDA-core kernel as the float MVAU on the 8 layers."""
    gen = torch.Generator().manual_seed(1)
    counts = torch.zeros(4096, dtype=torch.int32, device="cuda")
    layers, hw = [], IMG
    for blk in resnet9.plan(WIDTH):
        cin, n = blk["cin"], blk["cout"]
        x = (torch.randint(0, 16, (BATCH, hw, hw, cin), generator=gen)
             * 0.25).cuda()
        w = (torch.randint(-32, 32, (9 * cin, n), generator=gen) / 32).cuda()
        t = torch.sort(torch.randn((n, LEVELS), generator=gen) * 4,
                       dim=1).values.cuda()
        layers.append((blk["name"], hw, cin, n, x, w, t))
        if blk.get("pool"):
            hw //= 2

    def launcher(fn, hw, cin, n, x, w, t, splits):
        m = BATCH * hw * hw
        bn = KM.core_tile_n(n)
        tiles = -(-m // KM.CORE_TILE_M) * -(-n // bn)
        ws = (torch.empty(tiles * splits * KM.CORE_TILE_M * bn,
                          dtype=torch.int32, device="cuda")
              if splits > 1 else None)
        out = torch.empty((BATCH, hw, hw, n), device="cuda")

        def go():
            rc = fn(x.data_ptr(), 1, w.data_ptr(), 2, t.data_ptr(),
                    out.data_ptr(), BATCH, hw, hw, cin, 3, 1, 1, n,
                    t.shape[1], 0, 0.0, 0.25, 0.0, splits,
                    None if ws is None else ws.data_ptr(), counts.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        return go, out

    def plan(hw, cin, n):
        return KM.core_splits(BATCH * hw * hw, n, 9 * cin, sms)

    names = " ".join(f"{lay[0]:>7s}" for lay in layers)
    print(f"float MVAU, CUDA-core kernel\n{'variant':14s} {'sum':>7s} {names}"
          f"   (ms, batch {BATCH})")
    for vname, (_, _, fn) in libs.items():
        per = []
        for name, hw, cin, n, x, w, t in layers:
            go, out = launcher(fn, hw, cin, n, x, w, t, plan(hw, cin, n))
            if vname == "kernel":
                go()
                torch.cuda.synchronize()
                if not torch.equal(out, KM.mvau_conv_plain(x, w, t, 3, 1, 1,
                                                           0.0, 0.25, 0.0)):
                    raise SystemExit(f"{name}: the kernel differs from its "
                                     "plain version")
            per.append(cuda_ms(go))
        print(f"{vname:14s} {sum(per):7.4f} " + " ".join(f"{v:7.4f}" for v in per))
    rows = {"kernel, L=0": [], "matmul+count": [], "matmul only": [],
            "bound": []}
    for name, hw, cin, n, x, w, t in layers:
        go, _ = launcher(libs["kernel"][2], hw, cin, n, x, w,
                         t[:, :0].contiguous(), plan(hw, cin, n))
        rows["kernel, L=0"].append(cuda_ms(go))
        patches = ref.im2col(x, 3, 1, 1).reshape(-1, 9 * cin).contiguous()
        rows["matmul+count"].append(cuda_ms(lambda: 0.25 * ref.threshold_counts_fast(
            torch.matmul(patches, w), t).to(torch.float32)))
        rows["matmul only"].append(cuda_ms(lambda: torch.matmul(patches, w)))
        rows["bound"].append(2 * patches.shape[0] * patches.shape[1] * n
                             / 67e12 * 1e3)
    for label, per in rows.items():
        print(f"{label:14s} {sum(per):7.4f} " + " ".join(f"{v:7.4f}" for v in per))
    print("K splits (ms) where the output tiles are fewer than the SMs:")
    for name, hw, cin, n, x, w, t in layers:
        m = BATCH * hw * hw
        if -(-m // 128) * -(-n // KM.core_tile_n(n)) >= sms:
            continue
        row = {s: cuda_ms(launcher(libs["kernel"][2], hw, cin, n, x, w, t, s)[0])
               for s in (1, 2, 4, 6, 8, 12)}
        print(f"  {name}: planned {plan(hw, cin, n)}; " +
              ", ".join(f"{s}: {v:.4f}" for s, v in row.items()))


GEMM_ROWS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
             384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192)
# (label, K, N, levels, packed int4 weights)
GEMM_SHAPES = (("w_down L255", 96, 64, 255, False),
               ("w_down L15", 96, 64, 15, False),
               ("w_down L255 int4", 96, 64, 255, True),
               ("K1440 N160 L255", 1440, 160, 255, False),
               ("K1152 N512 L15", 1152, 512, 15, False))


def probe_gemm(sms: int) -> None:
    """The int8 GEMM form's routes against each other over M."""
    from repro_torch.core import quant as Q

    lib = B.library()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(2)
    print("int8 GEMM form (ms a launch, CUDA events): small-M kernel / "
          "wgmma kernel / torch._int_mm + count (M padded to a multiple of "
          "32) / empty "
          "launch of the small-M grid")
    for label, k, n, levels, packed in GEMM_SHAPES:
        lim = 8 if packed else 128
        wv = torch.randint(-lim, lim, (k, n), generator=gen)
        w = (Q.pack_int4(wv) if packed else wv.to(torch.int8)).cuda()
        w8 = wv.to(torch.int8).cuda()
        row = torch.sort(torch.randint(-3000, 3000, (levels,),
                                       generator=gen)).values
        t = row[None].expand(n, levels).to(torch.int32).contiguous().cuda()
        rows, best, prev = [], None, 0
        for m in GEMM_ROWS:
            x = torch.randint(-128, 128, (m, k), generator=gen
                              ).to(torch.int8).cuda()
            out = torch.empty((m, n), dtype=torch.int32, device="cuda")
            splits, ws, counts = KM._split_scratch(m, n, k, x.device, None)
            kind = KM.W_PACKED4 if packed else 0

            def small():
                rc = lib.mvau_int_small_m(x.data_ptr(), w.data_ptr(), kind,
                                          t.data_ptr(), out.data_ptr(), m, k,
                                          n, levels, 0, stream)
                if rc:
                    raise RuntimeError(f"small-M launch failed: {rc}")

            def wgmma():
                rc = lib.mvau_int(x.data_ptr(), w.data_ptr(), kind,
                                  t.data_ptr(), out.data_ptr(), m, k, n,
                                  levels, 0, splits, ws, counts, stream)
                if rc:
                    raise RuntimeError(f"wgmma launch failed: {rc}")

            def empty():
                lib.empty_launch(-(-n // 16) * -(-m // 32), 128, stream)

            xpad = torch.nn.functional.pad(x, (0, 0, 0,
                                               -(-m // 32) * 32 - m))

            def library():
                acc = torch._int_mm(xpad, w8)[:m]
                return ref.threshold_counts_fast(acc, t, True)

            want = KM.mvau_int_plain(x, w, t, 0, packed)
            for fn, name in ((small, "small-M"), (wgmma, "wgmma")):
                out.zero_()
                fn()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"{label} M {m}: the {name} kernel "
                                     "differs from the plain version")
            r = (cuda_ms(small, 50), cuda_ms(wgmma, 50), cuda_ms(library, 50),
                 cuda_ms(empty, 50))
            rows.append((m, r))
            if best is None and r[0] > r[1]:
                best = prev
            prev = m
        print(f"  {label} (K {k}, N {n}, {levels} levels"
              f"{', packed int4' if packed else ''}):")
        for m, r in rows:
            print(f"    M {m:4d}: small-M {r[0]:.5f}  wgmma {r[1]:.5f}  "
                  f"library {r[2]:.5f}  empty {r[3]:.5f}")
        print(f"  {label}: small-M no slower up to M = "
              f"{best if best is not None else GEMM_ROWS[-1]}"
              f"{'' if best is not None else ' (the whole sweep)'}")


# mvau_conv_kernel's PL template argument (csrc/mvau.cu PlaneKind)
PLANE_KINDS = {1: "u8 (1 product)", 2: "x2w2 s (4)", 3: "x2w2 u (4)",
               4: "x2w1 s (2)", 5: "x2w1 u (2)", 6: "x3w2 s (6)",
               7: "x3w2 u (6)", 8: "x3w1 s (3)", 9: "x3w1 u (3)"}


def plane_resources(report: str) -> list:
    """(kind, VEC, registers, spill store bytes, spill load bytes) of each
    plane-route instantiation of mvau_conv_kernel in a ``-Xptxas -v``
    report."""
    rows = []
    for entry in report.split("Compiling entry function '")[1:]:
        m = re.match(r"\S*mvau_conv_kernelILi(\d+)ELi\d+ELi\d+ELi(\d+)EE",
                     entry)
        if not m or int(m.group(2)) == 0:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        rows.append((PLANE_KINDS[int(m.group(2))], int(m.group(1)),
                     int(regs.group(1)) if regs else -1,
                     int(spill.group(1)) if spill else -1,
                     int(spill.group(2)) if spill else -1))
    return sorted(set(rows))


def probe_wide() -> None:
    """The wide-code artifacts' conv MVAUs on their own inputs and tables:
    as run, product alone (no levels), and the CUDA-core route as run and
    product alone; first the plane route's registers and spills."""
    import numpy as np

    import repro_torch
    from repro_torch.core.deploy import lower_graph
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.kernels import ops as kops

    print("plane route instantiations of mvau_conv_kernel (ptxas): kind, "
          "VEC, registers, spill stores / loads (bytes)")
    for kind, vec, regs, st, ld in plane_resources(B.library().info.ptxas):
        print(f"  {kind:16s} VEC {vec:2d}: {regs} registers, spills {st} / "
              f"{ld}")
    data = SyntheticImages(n_base=32, n_novel=10, seed=0, img=IMG)
    rng = np.random.default_rng(3)
    x_np, _ = data.batch(rng.integers(0, 42, BATCH),
                         rng.integers(0, 10_000, BATCH))
    x = torch.from_numpy(x_np).cuda()
    run_pair, run_tail = kops.conv_mvau_int_node, kops.conv_mvau_int_gap_node
    for label, qcfg in (("paper_w16a16()", QuantConfig.paper_w16a16()),
                        ("grid_point(8, 8)", QuantConfig.grid_point(8, 8))):
        params = resnet9.init_params(torch.Generator().manual_seed(0), WIDTH,
                                     device="cuda")
        dm = repro_torch.compile(params, qcfg, recipe="resnet9",
                                 datapath="int", device="cuda")
        captured = []

        def record(conv, node, xx, w, t, wk=None):
            captured.append((conv, node, xx, w, t, wk))
            return run_pair(conv, node, xx, w, t, wk)

        def record_tail(conv, node, pool, xx, w, t, skip, wk=None):
            captured.append((conv, node, xx, w, t, wk))
            return run_tail(conv, node, pool, xx, w, t, skip, wk)

        kops.conv_mvau_int_node = record
        kops.conv_mvau_int_gap_node = record_tail
        try:
            fn = lower_graph(dm.graph, "cuda")
        finally:
            kops.conv_mvau_int_node = run_pair
            kops.conv_mvau_int_gap_node = run_tail
        fn(x)
        torch.cuda.synchronize()
        print(f"{label} at width {WIDTH}, batch {BATCH}, each conv MVAU on "
              "the forward's own inputs (ms a launch, CUDA events): as run / "
              "product alone (no levels) / count (the difference) / the "
              "CUDA-core kernel on the same codes as int32, as run / its "
              "product alone")
        tot = [0.0, 0.0, 0.0, 0.0]
        for conv, node, xx, w, t, wk in captured:
            k, st, pd = (conv.attrs[a] for a in ("kernel", "stride", "pad"))
            route, kind, prods = kops.int_route_of(node)
            xk, wk2, packed, xu = kops._kernel_codes(node, xx, w, wk)
            t0 = t[:, :0].contiguous()

            def full():
                return KM.mvau_int_conv(xk, wk2, t, k, st, pd, 0, packed,
                                        x_unsigned=xu)

            def product():
                return KM.mvau_int_conv(xk, wk2, t0, k, st, pd, 0, packed,
                                        x_unsigned=xu)

            def core(tt=t):
                return KM.mvau_int_conv(xx.to(torch.int32), w, tt, k, st, pd,
                                        0, bool(node.attrs.get("w_packed")))

            if not torch.equal(full(), core()):
                raise SystemExit(f"{label} {node.outputs[0]}: the {route} "
                                 "route differs from the CUDA-core route")
            r = (cuda_ms(full, 10), cuda_ms(product, 10), cuda_ms(core, 10),
                 cuda_ms(lambda: core(t0), 10))
            for i, v in enumerate(r):
                tot[i] += v
            b, h, wd, c = xx.shape
            print(f"  {node.outputs[0].split('_')[0]:4s} {route:6s} "
                  f"{kind or '-':4s} {prods} products  M {b * h * wd:6d} "
                  f"K {k * k * c:5d} N {t.shape[0]:4d} L {t.shape[1]:5d} "
                  f"(tables {4 * t.numel() / 1e6:.1f} MB): {r[0]:.4f} / "
                  f"{r[1]:.4f} / {r[0] - r[1]:.4f} / {r[2]:.4f} / "
                  f"{r[3]:.4f}")
        print(f"  {label} sum over the 8 layers: {tot[0]:.4f} / "
              f"{tot[1]:.4f} / {tot[0] - tot[1]:.4f} / {tot[2]:.4f} / "
              f"{tot[3]:.4f} ms")
        del dm, fn, captured, params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("int8", "core", "gemm", "wide"),
                    default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("probe_mvau_conv: needs the card\n")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    srcs = {}
    if args.only in (None, "int8"):
        srcs.update({f"int8_{k}": v for k, v in variants().items()})
    if args.only in (None, "core"):
        srcs.update({f"core_{k}": v for k, v in core_variants().items()})
    t0 = time.perf_counter()
    libs = build_all(srcs) if srcs else {}
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    for prefix, probe in (("int8_", probe_int8), ("core_", probe_core)):
        sub = {k[len(prefix):]: v for k, v in libs.items()
               if k.startswith(prefix)}
        if sub:
            probe(sub, sms)
    if args.only in (None, "gemm"):
        probe_gemm(sms)
    if args.only in (None, "wide"):
        probe_wide()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
