// Matrix-Vector-Activation Unit for Hopper (sm_90a): a matrix product whose
// epilogue counts threshold crossings, FINN's MVAU.
//
// Replaces, in the JAX package:
//   src/repro/kernels/mvau.py  mvau_int_pallas (_mvau_int_kernel,
//                              _unpack_int4_block)   integer datapath
//   src/repro/kernels/mvau.py  mvau_pallas (_mvau_kernel)   float datapath,
//                              with its int8 x int8 -> int32 sub-path
//   src/repro/kernels/gap.py   gap_pallas (_gap_kernel), where it follows a
//                              residual add of the int8 route's last conv
// All in conv form: the im2col node before them folded in.
//
// What it computes, per output element (m, n):
//   acc   = sum_k x[m, k] * w[k, n]          (int32, or float32 for floats)
//   count = #{ l : acc >= T[n, l] }
//   int datapath:   out = out_base + count                       (int32)
//   float datapath: out = out_scale * (out_base + count) + out_bias (float32)
// In conv form x[m, :] is the patch row of output pixel m = (b, oh, ow),
// read straight from the NHWC activation: the patch tensor never exists.
// The GEMM form (M, K) is the 1 x 1 conv over an M x 1 image of K channels.
// Only the narrow result is written; the accumulator never leaves registers
// (or, under split K, scratch that stays in the 50 MB L2).  The int8
// kernel's GlobalAccPool epilogue (pool > 0) goes further:
//   out[b, n] = sum_{oh, ow} (out_base + count[b, oh, ow, n]
//                             + skip[b, oh, ow, n])          (int32, wraps)
// so the residual add and the spatial sum after the last conv run in its
// registers, and the (B, OH, OW, N) codes are never written.
//
// Three kernels:
// * mvau_small_m_kernel -- the GEMM form of the int8 route at decode and
//   small-batch shapes (lm-tiny's w_down at M 1-8; up to 512 rows, where
//   it stops beating mvau_conv_kernel on the H100), mma.sync m16n8k32 in
//   swap-AB form, the 16 output columns of a block on the MMA's 16 side,
//   the block's threshold rows searched in shared memory.  The Python
//   wrapper routes a launch here where M is at most its limit.
// * mvau_conv_kernel -- int8 activation codes x int8 (or packed int4)
//   weights on the tensor cores (every layer of the w6a4 int artifact):
//   cp.async A loads with zero-fill halos, a 4-stage ring in the 64-byte
//   swizzle, wgmma m64n64k32 (s8.s8.s32) from shared memory, split K in one
//   launch.  The float MVAU's int8 x int8 sub-path is the same kernel with a
//   float epilogue.  Bound by bytes on this card (about 116 MB at the w6a4
//   ResNet-9's shapes at batch 64, 0.035 ms at 3.35 TB/s); measured on the
//   H100 (PERF.md) it is held by instruction issue: the dense threshold
//   count, the B transposes, each tile's prologue.  Its plane route takes
//   integer activation codes of up to 24 bits against weights of up to 16
//   on the same tensor cores: uint8 codes (0..255, the a8 configs) as one
//   wgmma u8.s8, and wider codes as byte planes, one wgmma product for
//   each pair of an activation and a weight plane (2 to 6), recombined
//   exactly (see the notes above the kernel): the 16-bit codes of w16a16
//   and the like, and the 17-bit residual sums that feed w16a16's c2.
// * mvau_core_kernel -- everything else on the CUDA cores: the float MVAU
//   (float32 FMA, never TF32), and integer activation codes wider than 24
//   bits or weights wider than 16, or K past the byte planes' int32 limit
//   (int32 activation codes x int8, int16, int32 or packed int4 weights,
//   exact int32 multiply-add).  A 128 x
//   128 (or 128 x 64) block tile of 8 x 8 register-tiled accumulators a
//   thread, a 4-stage cp.async ring of 16-k stages, split K in one launch.
//   Bound by operations (the float ResNet-9 at batch 64: 96.6 GFLOP, 0.72
//   ms at 67 TFLOP/s).  Measured on the H100 (tools/probe_mvau_conv.py), it
//   is held by shared memory as much as by the FMA pipes: an 8 x 8 tile
//   loads 16 floats a thread per k for 64 FMA, which is exactly the ratio
//   of the SM's shared-memory rate (128 B a clock) to its FP32 rate (128
//   FMA a clock), and the two overlap poorly: removing 7 of every 8 FMAs
//   leaves 60% of the time.  A 16 x 8 tile (one block an SM) measured
//   slower.
// chip_smoke.py computes each kernel's bound from each run's shapes.
// The epilogues count short tables (L <= 64, every layer of the w6a4
// artifact: L = 15) densely from shared memory.  Longer tables (8- to
// 16-bit activations, L = 255 to 65535) are binary-searched: by the
// small-M kernel in shared memory, where its block's rows are staged at
// the start (L <= 2048), several searches a thread in lockstep; by
// mvau_conv_kernel in global memory, a thread's 8 searches in lockstep,
// the block's rows staying in L1/L2; by mvau_core_kernel per output in
// global memory.  Either way about
// ceil(log2(L + 1)) loads instead of L compares.  That needs each row
// sorted ascending, which the integer lowering guarantees for every
// mvau_int table (``t_sorted``);
// the float MVAU's tables carry no such guarantee, so it always counts
// densely.  Ragged M, N and K edges are masked in the kernels; nothing is
// padded with sentinel thresholds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int DENSE_MAX_L = 64;  // longer sorted tables are binary-searched

// #{ l : a >= row[l] } for a row sorted ascending: the index of its first
// level above a.
template <typename ACC>
__device__ __forceinline__ int count_sorted(const ACC* __restrict__ row,
                                            int L, ACC a) {
  int lo = 0;
  int len = L;
  while (len > 0) {
    const int half = len >> 1;
    if (a >= __ldg(row + lo + half)) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

enum WKind { W_I8 = 0, W_I32 = 1, W_F32 = 2, W_PACKED4 = 3, W_I16 = 4 };

template <typename ACC, int WK>
__device__ __forceinline__ ACC load_w(const void* __restrict__ w, int k, int n,
                                      int N) {
  if constexpr (WK == W_PACKED4) {
    // (K, N/2) int8: byte n/2 of row k holds columns n (low) and n+1 (high)
    const uint8_t* wp = static_cast<const uint8_t*>(w);
    const int byte = wp[static_cast<size_t>(k) * (N >> 1) + (n >> 1)];
    const int nib = (n & 1) ? ((byte >> 4) & 0xF) : (byte & 0xF);
    return static_cast<ACC>(nib >= 8 ? nib - 16 : nib);
  } else if constexpr (WK == W_I8) {
    return static_cast<ACC>(
        static_cast<const int8_t*>(w)[static_cast<size_t>(k) * N + n]);
  } else if constexpr (WK == W_I16) {
    return static_cast<ACC>(
        static_cast<const int16_t*>(w)[static_cast<size_t>(k) * N + n]);
  } else if constexpr (WK == W_I32) {
    return static_cast<ACC>(
        static_cast<const int32_t*>(w)[static_cast<size_t>(k) * N + n]);
  } else {
    return static_cast<ACC>(
        static_cast<const float*>(w)[static_cast<size_t>(k) * N + n]);
  }
}


// ---------------------------------------------------------------------------
// int8 x int8 on the tensor cores: the conv-form (implicit-GEMM) MVAU.
//
// Output row m = (b, oh, ow) of a convolution over an NHWC int8 activation;
// its patch row, in patch order (kh, kw, c), is
//   x[b, oh * stride + kh - pad, ow * stride + kw - pad, c]   (0 off the image)
// and is never stored: the A loader reads it from the activation.  The GEMM
// form (M, K) is the 1 x 1 case of the same loader (H = M, W = 1, C = K).
//
// Block tile 128 x 128 x 64 bytes of K, 256 threads = 2 warpgroups; each
// warpgroup runs wgmma m64n64k32 on all 128 rows and its 64 columns.
// Shared memory holds a ring of 4 stages of A (128 rows x 64 B) and B
// (128 columns x 64 B, K-major), each 64-byte row in the 64-byte swizzle
// (16-byte chunks XOR bits 1-2 of the row) that wgmma's descriptors name,
// and the block's threshold rows.
// * A: 16-byte cp.async with a zero-filling source size for the halo, the
//   ragged K edge and rows past M, when C is a multiple of 16; 4-byte
//   cp.async when C is a multiple of 4; else byte loads (the first layer,
//   C = 3).  Tiles i+1 .. i+3 are in flight while the tensor cores consume
//   tile i.
// * B: the (K, N) weights are N-major, wgmma wants K-major s8: each thread
//   loads 4 rows x 8 columns (8-byte loads, or 4-byte loads of packed int4
//   unpacked in registers) of tile i+3, and transposes them with byte
//   permutes into shared memory one iteration later.
// * Thresholds: the block's rows are copied in by cp.async with A tile 0.
// * Split K: where the output tiles are fewer than the SMs, grid.z splits
//   the K-tiles.  Each split writes its int32 partial sums to scratch; the
//   last block of a tile to arrive (a per-tile counter, reset by that block)
//   adds the others' and runs the epilogue on the full sum.  Integer sums
//   are exact in any order, so the split changes no bit.
// ---------------------------------------------------------------------------
constexpr int TC_BM = 128;
constexpr int TC_BN = 128;
constexpr int TC_BK = 64;
constexpr int TC_STAGES = 4;
constexpr int TC_THREADS = 256;
constexpr int TC_RING = TC_STAGES * (TC_BM + TC_BN) * TC_BK;   // 65,536 B
// + the block's threshold rows, staged at the start (up to 64 levels):
// row stride ts_stride(L) words (Planes::SMEM_MAX: 98,816 B in all)
static_assert(TC_BM * TC_BN * 4 <= TC_RING,
              "the GAP epilogue stages a 128 x 128 int32 tile in the ring");
constexpr int TC_NJ = 8;   // 8-column accumulator tiles of a warpgroup

// What the A and B tiles of one launch hold (see the byte-plane notes above
// mvau_conv_kernel).
enum PlaneKind {
  PL_S8 = 0,      // int8 x int8 (or packed int4): s8.s8
  PL_U8 = 1,      // uint8 codes (0..255) x int8: u8.s8
  // Byte planes, P_x activation planes x P_w weight planes: X2 codes of 9
  // to 16 bits (int16), X3 codes of 17 to 24 bits (int32); W2 16-bit
  // weights, W1 int8 weights; U the codes' top plane unsigned (u8: codes up
  // to 65535 or 2^24 - 1), else signed (s8)
  PL_X2W2 = 2, PL_X2W2U = 3, PL_X2W1 = 4, PL_X2W1U = 5,
  PL_X3W2 = 6, PL_X3W2U = 7, PL_X3W1 = 8, PL_X3W1U = 9,
};

// The shape of one plane kind's launch.  Shared memory of the byte-plane
// kinds: a ring of raw A tiles as the codes come (int16 or int32; rows of
// 144 or 272 bytes, 16 past a multiple of 128, so that a warp's 16-byte
// reads of 8 rows x 4 segments fill the banks once), a ring of B tiles of
// the weight planes, two buffers of A's byte planes (written one tile ahead
// of the wgmma that reads them), then the threshold rows.  Every tile
// starts on a multiple of 1,024 bytes:
//   X2W2 205,312 B, X2W1 172,544, X3W2 193,024, X3W1 160,256.
// Registers: one int32 accumulator set a byte shift (P_x + P_w - 1 sets).
// The X2 kinds keep the 128 x 128 tile (X2W2: 3 sets, 192 registers a
// thread; X2W1: 2 sets, 128); the X3 kinds take a 64 x 128 tile (MI = 1:
// 4 or 3 sets of 32 registers), whose raw int32 stages then hold the ring
// at 4 stages: at 128 rows four sets would be the whole register file.
template <int PL>
struct Planes {
  static constexpr bool PB = PL >= PL_X2W2;
  static constexpr int PX = PL >= PL_X3W2 ? 3 : 2;
  static constexpr int PW = PB && ((PL - PL_X2W2) & 2) ? 1 : 2;
  static constexpr bool XU = PB && ((PL - PL_X2W2) & 1);
  static constexpr int SETS = PB ? PX + PW - 1 : 1;
  static constexpr int MI = PB && PX == 3 ? 1 : 2;   // 64-row wgmma blocks
  static constexpr int BM = 64 * MI;                 // rows of the tile
  static constexpr int XB = PX == 3 ? 4 : 2;         // bytes of a raw code
  static constexpr int RAW_STRIDE = XB * TC_BK + 16;
  static constexpr int RAW_STAGE = BM * RAW_STRIDE;
  static constexpr int B_OFF = TC_STAGES * RAW_STAGE;
  static constexpr int A_OFF = B_OFF + TC_STAGES * PW * TC_BN * TC_BK;
  static constexpr int RING = PB ? A_OFF + 2 * PX * BM * TC_BK : TC_RING;
  static constexpr int SMEM_MAX = RING + TC_BN * 65 * 4;
  static_assert(!PB || BM * TC_BN * 4 <= TC_STAGES * RAW_STAGE,
                "the GAP epilogue stages its skip tile in the raw ring");
  static_assert(SMEM_MAX <= 232448, "more shared memory than a block has");
};
// The longest K whose byte-plane sums stay inside int32: a k adds to one
// accumulator set at most two products of bytes (X2W2's shift 8: xl wh +
// xh wl; X3W2's shifts 8 and 16), each at most 255 * 255 (u8 x u8; u8 x s8
// and s8 x s8 products are smaller in magnitude), so a set's sum lies in
// [-2 * 255 * 128 K, 2 * 255 * 255 K].
constexpr int PLANE_MAX_K = 2147483647 / (2 * 255 * 255);          // 16,512

struct ConvGeom {
  int H, W, C;             // activation image and channels
  int KH, KW, stride, pad;
  int OH, OW;              // output image
};

// Byte offset of (row, byte) in a tile of 64-byte rows whose 16-byte chunks
// are permuted by an XOR with bits 1-2 of the row: the 64-byte swizzle of
// wgmma's shared-memory descriptors (on a 512-byte-aligned tile), in which
// 8 consecutive rows from a multiple of 8 fill a 128-byte bank window's 8
// chunk slots once.
__device__ __forceinline__ int swz(int row, int byte) {
  return row * TC_BK + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// wgmma shared-memory matrix descriptor: K-major rows of 64 bytes in the
// 64-byte swizzle (swz above), 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // leading offset (unused)
         (static_cast<uint64_t>(512 >> 4) << 32) |     // stride offset
         (static_cast<uint64_t>(2) << 62);             // 64-byte swizzle
}

// keep the compiler from moving accumulator registers across wgmma
template <int MI, int NJ>
__device__ __forceinline__ void warpgroup_fence(int (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(acc[i][j][r])::"memory");
}

// D (64 x 64, s32) += A (64 x 32) B (32 x 64), both from shared memory, the
// operands 8-bit codes: signed (.s8) or unsigned (.u8, AU / BU).  No
// .satfinite: the sums are exact int32 (see the byte-plane route below).
#define REPRO_WGMMA_D(d)                                                     \
  "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),               \
      "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),           \
      "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),           \
      "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),           \
      "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),           \
      "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),           \
      "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),           \
      "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
#define REPRO_WGMMA(types)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." types " "                \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"                               \
      : REPRO_WGMMA_D(d)                                                     \
      : "l"(da), "l"(db)                                                     \
      : "memory")

template <bool AU = false, bool BU = false>
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[8][4], uint64_t da,
                                                uint64_t db) {
  if constexpr (!AU && !BU) {
    REPRO_WGMMA("s8.s8");
  } else if constexpr (AU && !BU) {
    REPRO_WGMMA("u8.s8");
  } else if constexpr (!AU && BU) {
    REPRO_WGMMA("s8.u8");
  } else {
    REPRO_WGMMA("u8.u8");
  }
}

// wgmma_m64n64k32 with the operand types as arguments: au and bu are
// constants once the caller's loops are unrolled
__device__ __forceinline__ void wgmma_plane(int (&d)[8][4], uint64_t da,
                                            uint64_t db, bool au, bool bu) {
  if (au) {
    if (bu)
      wgmma_m64n64k32<true, true>(d, da, db);
    else
      wgmma_m64n64k32<true, false>(d, da, db);
  } else {
    if (bu)
      wgmma_m64n64k32<false, true>(d, da, db);
    else
      wgmma_m64n64k32<false, false>(d, da, db);
  }
}

// Row stride, in words, of the staged threshold block: odd, so that the 4
// columns a warp reads at once (2 q, q < 4) hit distinct banks.
__host__ __device__ __forceinline__ int ts_stride(int L) { return L | 1; }

// c + (a >= t), as a compare and a predicated add
__device__ __forceinline__ int count_ge(int c, int a, int t) {
  asm("{\n\t.reg .pred p;\n\tsetp.ge.s32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(c)
      : "r"(a), "r"(t));
  return c;
}

// 4 bytes of packed int4 (byte j: column 2j low nibble, 2j+1 high) -> the 8
// columns as signed bytes, columns 0..3 in lo and 4..7 in hi
__device__ __forceinline__ void unpack_int4x8(uint32_t v, uint32_t& lo,
                                              uint32_t& hi) {
  // (q ^ 8) - 8 bytewise, without borrows: ((q ^ 8) + 0x78) ^ 0x80
  const uint32_t l =
      (((v & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
  const uint32_t h =
      ((((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
  lo = __byte_perm(l, h, 0x5140);
  hi = __byte_perm(l, h, 0x7362);
}

// Word of (row, col) in the staged 128 x 128 int32 skip tile: rows of 512
// bytes, 8-word column groups XOR-permuted by bits 0-1 of the row, so the
// 8 rows a warp reads at once (4 distinct row & 3) fill the banks twice,
// the least for 256 bytes.  Column pairs (2c, 2c + 1) stay adjacent.
__device__ __forceinline__ int skip_word(int row, int col) {
  return row * TC_BN + (col ^ ((row & 3) << 3));
}

// cp.async of the skip operand's rows m0 .. m0 + rows - 1, columns n0 ..
// n0 + 127 into a rows x 128 int32 tile (skip_word order) at smem; zero
// past M and N.  16-byte copies where N and the pointer allow, else 4-byte
// ones.
__device__ __forceinline__ void stage_skip(uint8_t* smem,
                                           const int32_t* __restrict__ skip,
                                           int m0, int n0, int M, int N,
                                           int rows, int tid) {
  int32_t* const Ss = reinterpret_cast<int32_t*>(smem);
  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(skip) & 15) == 0;
  for (int e = tid; e < rows * (TC_BN / 4); e += TC_THREADS) {
    const int row = e / (TC_BN / 4);
    const int col = 4 * (e % (TC_BN / 4));
    const int gm = m0 + row;
    const int gn = n0 + col;
    const int32_t* src = skip + static_cast<size_t>(gm) * N + gn;
    int32_t* const dst = Ss + skip_word(row, col);
    if (vec) {
      const bool ok = gm < M && gn < N;
      cp_async16(smem_u32(dst), ok ? src : skip, ok);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = gm < M && gn + c < N;
        cp_async4(smem_u32(dst + c), ok ? src + c : skip, ok);
      }
    }
  }
  cp_async_commit();
}

// One step of a reduce-scatter across lanes XOR apart: the lane whose XOR
// bit is set keeps w[HALF .. 2 HALF - 1] and sends w[0 .. HALF - 1], its
// partner the other way round; w[0 .. HALF - 1] then holds the pair's sums
// of the half this lane keeps.
template <int XOR, int HALF, int NW>
__device__ __forceinline__ void reduce_scatter(uint32_t (&w)[NW], int lane) {
  static_assert(2 * HALF <= NW, "a step halves the words it is given");
  const bool upper = (lane & XOR) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const uint32_t send = upper ? w[k] : w[k + HALF];
    const uint32_t keep = upper ? w[k + HALF] : w[k];
    w[k] = keep + __shfl_xor_sync(0xffffffffu, send, XOR);
  }
}

// What the tensor-core kernel's epilogue writes from each output's
// threshold count.  The integer build serves both of its epilogues: the
// fused GlobalAccPool is chosen at run time (pool > 0), so r2b's launch
// runs the same code as the layers before it, warm in the instruction
// caches, rather than a build of its own that is cold at every forward.
enum EpiKind {
  EPI_INT = 0,     // pool == 0: int32 codes out_base + count, (M, N);
                   // pool > 0: int32 sums over each image's pool rows of
                   // out_base + count + skip, (M / pool, N)
  EPI_FLOAT = 1,   // float32 out_scale * (out_base + count) + out_bias, (M, N)
};

struct Epilogue {
  int out_base_i;
  float out_base_f, out_scale, out_bias;
  const int32_t* skip;   // pool > 0: the (M, N) int32 residual operand
  int pool;              // output rows per image (OH * OW, dividing 16), or 0
};

// Byte planes (PL_X2W2 .. PL_X3W1U): integer codes of 9 to 24 bits on the
// activation side and of up to 16 bits on the weight side, exact on the
// int8 tensor cores.  A code of P bytes is c = sum_p 256^p c_p, its lower
// bytes c_p in [0, 255] (u8) and its top byte in the code's own sign (s8,
// or u8 for unsigned codes up to 65535 or 2^24 - 1; an int8 weight is one
// plane, its top byte).  So, with P_x planes of x and P_w of w,
//   sum_k x w = sum_s 256^s acc_s,   acc_s = sum_{i + j = s} sum_k x_i w_j,
// each x_i w_j one wgmma with its own operand types.  The products of one
// shift s share an accumulator set: 16-bit x 16-bit codes give four
// products in three sets (ll; xl wh + xh wl; hh), 16-bit codes x int8
// weights two in two, 24-bit codes x 16-bit weights six in four (shifts 0,
// 8, 16, 24), x int8 weights three in three.  Every set is a full
// accumulator of the tile (see Planes for the tile and registers), so the
// route runs one block an SM (__launch_bounds__(256, 1)); the tile keeps
// its 16 (MI = 2) or 8 (MI = 1) wgmma a warpgroup and product per K-tile,
// and the split-K and GlobalAccPool epilogues stay as they are.  While K
// <= PLANE_MAX_K each set's sum stays inside int32 (no .satfinite, nothing
// wraps); the sets are added as uint32 sum_s acc_s << 8 s, which is the
// exact sum modulo 2^32, and that sum lies in int32: the integer lowering
// refuses any layer whose reachable partial sums leave it.
// * A: the (B, H, W, C) codes as the graph holds them, int16 (the low 16
//   bits of each code) or int32, by 16-byte cp.async into a ring of raw
//   tiles; after the wait each thread splits the codes it loaded with byte
//   permutes into the P_x planes of one of two A buffers (64-byte
//   swizzle), then the block syncs and the tensor cores read the planes.
//   Odd C: one load a code.
// * B: the weights' byte planes, prepared once when the graph is lowered
//   as (P_w, N, Kp) int8, K-major and K padded to a multiple of 16 with
//   zeros, so each plane's tile is a 16-byte cp.async copy with no
//   transpose.
// PL_U8 (8-bit unsigned codes, 0..255, against int8 weights: the DSE's
// (8, 8) point) is the int8 kernel with a u8 A operand.
template <int VEC, int WK, int EPI, int PL>
__global__ void __launch_bounds__(TC_THREADS, Planes<PL>::PB ? 1 : 2)
mvau_conv_kernel(const void* __restrict__ xv, ConvGeom g,
                 const void* __restrict__ w, bool w_vec,
                 const int32_t* __restrict__ t, void* __restrict__ out,
                 int32_t* __restrict__ ws, int* __restrict__ tile_counts,
                 int M, int K, int N, int L, bool bsearch, int kt_per_split,
                 Epilogue e) {
  using P = Planes<PL>;
  constexpr bool PB = P::PB;
  constexpr int MI = P::MI;
  constexpr int BM = P::BM;
  const int8_t* __restrict__ x = static_cast<const int8_t*>(xv);
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int s_last;
  uint8_t* const As = smem;
  uint8_t* const Bs = smem + TC_STAGES * TC_BM * TC_BK;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // warpgroup wg computes all BM rows x columns 64 wg .. 64 wg + 63 with
  // wgmma m64n64k32 (MI 64-row blocks); its warp wq owns rows 16 wq .. +15
  // of each block
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * TC_BN;
  const int KT = max(1, (K + TC_BK - 1) / TC_BK);
  const int kt_begin = blockIdx.z * kt_per_split;
  const int nkt = min(KT, kt_begin + kt_per_split) - kt_begin;

  // ---- A: rows a_row (and a_row + 64), codes a_seg .. a_seg + 15 of each
  const int a_row = tid >> 2;
  const int a_seg = (tid & 3) * 16;
  int a_img[2], a_ih[2], a_iw[2];
  {
    const int ohw = g.OH * g.OW;
#pragma unroll
    for (int p = 0; p < MI; ++p) {
      const int m = m0 + a_row + 64 * p;
      if (m < M) {
        const int b = m / ohw;
        const int r = m - b * ohw;
        const int oh = r / g.OW;
        const int ow = r - oh * g.OW;
        a_img[p] = b * g.H;
        a_ih[p] = oh * g.stride - g.pad;
        a_iw[p] = ow * g.stride - g.pad;
      } else {
        a_img[p] = 0;
        a_ih[p] = -(1 << 28);      // never inside the image
        a_iw[p] = 0;
      }
    }
  }

  // (kh, kw, c) of this thread's segment in the next K-tile to load: one
  // division here, then advanced tile by tile (tiles load in order)
  int a_k = kt_begin * TC_BK + a_seg;
  int a_kh, a_kw, a_c;
  {
    const int tap = a_k / g.C;
    a_c = a_k - tap * g.C;
    a_kh = tap / g.KW;
    a_kw = tap - a_kh * g.KW;
  }

  // the next K-tile's (kh, kw, c)
  auto advance_a = [&]() {
    a_k += TC_BK;
    a_c += TC_BK;
    while (a_c >= g.C) {
      a_c -= g.C;
      if (++a_kw == g.KW) {
        a_kw = 0;
        ++a_kh;
      }
    }
  };

  auto load_a = [&](int stage) {
    uint8_t* const dst = As + stage * TC_BM * TC_BK;
    const int k = a_k;
    int c = a_c;
    int kh = a_kh;
    int kw = a_kw;
    uint32_t pack[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
#pragma unroll
    for (int j = 0; j < 16 / VEC; ++j) {
      const bool kin = k + j * VEC < K;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ih = a_ih[p] + kh;
        const int iw = a_iw[p] + kw;
        const bool ok = kin && static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
        const int8_t* src =
            ok ? x + (static_cast<int64_t>(a_img[p] + ih) * g.W + iw) * g.C + c
               : x;
        const int row = a_row + 64 * p;
        if constexpr (VEC == 16) {
          cp_async16(smem_u32(dst + swz(row, a_seg)), src, ok);
        } else if constexpr (VEC == 4) {
          cp_async4(smem_u32(dst + swz(row, a_seg + 4 * j)), src, ok);
        } else {
          const uint32_t v = ok ? static_cast<uint8_t>(__ldg(src)) : 0u;
          pack[p][j >> 2] |= v << (8 * (j & 3));
        }
      }
      c += VEC;
      if (c >= g.C) {
        c = 0;
        if (++kw == g.KW) {
          kw = 0;
          ++kh;
        }
      }
    }
    if constexpr (VEC == 1) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
        *reinterpret_cast<uint4*>(dst + swz(a_row + 64 * p, a_seg)) =
            make_uint4(pack[p][0], pack[p][1], pack[p][2], pack[p][3]);
    }
    advance_a();
  };

  // ---- B: rows k .. k+3 (k = 4 b_kg) x columns n .. n+7 (n = 8 b_nc) -----
  // a warp covers 4 k-groups x 64 columns: each load reads 4 rows x 64
  // contiguous bytes
  const int b_kg = 4 * (warp & 3) + (lane >> 3);
  const int b_nc = 8 * (warp >> 2) + (lane & 7);
  uint32_t bw[4][2];

  auto fetch_b = [&](int kt) {
    const int k = kt * TC_BK + 4 * b_kg;
    const int n = n0 + 8 * b_nc;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = k + r;
      uint32_t lo = 0u, hi = 0u;
      if (kk < K) {
        if (w_vec && n + 8 <= N) {
          if constexpr (WK == W_PACKED4) {
            const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(
                static_cast<const uint8_t*>(w) +
                static_cast<size_t>(kk) * (N >> 1) + (n >> 1)));
            unpack_int4x8(v, lo, hi);
          } else {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                static_cast<const int8_t*>(w) + static_cast<size_t>(kk) * N +
                n));
            lo = v.x;
            hi = v.y;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (n + j < N) {
              const uint32_t byte =
                  static_cast<uint8_t>(load_w<int, WK>(w, kk, n + j, N));
              if (j < 4)
                lo |= byte << (8 * j);
              else
                hi |= byte << (8 * (j - 4));
            }
          }
        }
      }
      bw[r][0] = lo;
      bw[r][1] = hi;
    }
  };

  // store i writes column 8 b_nc + (i ^ odd); odd column groups store in
  // the order 1, 0, 3, 2, ... so a warp's stores split over both halves of
  // the bank window
  const int b_odd = b_nc & 1;
  const int b_row = b_nc * 8 * TC_BK + (b_kg & 3) * 4;
  const int b_par[2] = {b_row + b_odd * TC_BK, b_row - b_odd * TC_BK};
  const int b_kq = (b_kg >> 2) << 4;

  auto store_b = [&](int stage) {
    uint8_t* const dst = Bs + stage * TC_BN * TC_BK;
    uint32_t col[8];       // col[i]: rows k .. k+3 of column n + i
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t t01 = __byte_perm(bw[0][h], bw[1][h], 0x5140);
      const uint32_t t23 = __byte_perm(bw[2][h], bw[3][h], 0x5140);
      const uint32_t u01 = __byte_perm(bw[0][h], bw[1][h], 0x7362);
      const uint32_t u23 = __byte_perm(bw[2][h], bw[3][h], 0x7362);
      col[4 * h + 0] = __byte_perm(t01, t23, 0x5410);
      col[4 * h + 1] = __byte_perm(t01, t23, 0x7632);
      col[4 * h + 2] = __byte_perm(u01, u23, 0x5410);
      col[4 * h + 3] = __byte_perm(u01, u23, 0x7632);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // = swz(8 b_nc + (i ^ odd), 4 b_kg): the row's bits 1-2 are i's
      const uint32_t v = b_odd ? col[i ^ 1] : col[i];
      *reinterpret_cast<uint32_t*>(dst + b_par[i & 1] + i * TC_BK +
                                   (b_kq ^ ((i >> 1) << 4))) = v;
    }
  };

  // ---- byte planes: the raw codes (int16 or int32) of rows a_row (and
  // a_row + 64), codes a_seg .. a_seg + 15 of the tile, into this thread's
  // slots of a raw stage (split by split_a below).  int32 codes take four
  // 16-byte chunks a row, read and written in the order chunk c ^ a_rot: a
  // quarter-warp's 8 threads (2 rows x 4 segments) then meet each bank once
  // (rows 16 bytes past a multiple of 128 apart, segments 64 bytes) ----
  using XT = std::conditional_t<P::XB == 4, int32_t, int16_t>;
  const XT* __restrict__ const xr = static_cast<const XT*>(xv);
  const int a_rot = P::XB == 4 ? (tid & 2) : 0;
  auto load_raw = [&](int stage) {
    if constexpr (PB) {
      uint8_t* const raw = smem + stage * P::RAW_STAGE + P::XB * a_seg;
      // VEC 16: two or four 16-byte copies a row of every 16 codes (XB of
      // them, in the order chunk u ^ a_rot); VEC 1 (C not a multiple of
      // 16): a code at a time, row by row (a 4-byte copy of an int32 code,
      // or an int16 code loaded and stored), four codes an unrolled step:
      // unrolled whole, the loads of the 16-bit kinds' byte planes held
      // more registers than the three accumulator sets left (ptxas spilled
      // at 255; 238 registers so)
#pragma unroll
      for (int p = 0; p < MI; ++p) {
        uint8_t* const dst = raw + (a_row + 64 * p) * P::RAW_STRIDE;
        if constexpr (VEC == 16) {
          const int ih = a_ih[p] + a_kh;
          const int iw = a_iw[p] + a_kw;
          const bool ok =
              a_k < K &&
              static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
              static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
          const XT* src =
              ok ? xr + (static_cast<int64_t>(a_img[p] + ih) * g.W + iw) * g.C +
                       a_c
                 : xr;
#pragma unroll
          for (int u = 0; u < P::XB; ++u) {
            const int cu = u ^ a_rot;
            cp_async16(smem_u32(dst + 16 * cu),
                       ok ? src + cu * (16 / P::XB) : xr, ok);
          }
        } else {
          int c = a_c;
          int kh = a_kh;
          int kw = a_kw;
#pragma unroll 4
          for (int j = 0; j < 16; ++j) {
            const int ih = a_ih[p] + kh;
            const int iw = a_iw[p] + kw;
            const bool ok =
                a_k + j < K &&
                static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
            const XT* src =
                ok ? xr + (static_cast<int64_t>(a_img[p] + ih) * g.W + iw) *
                              g.C + c
                   : xr;
            if constexpr (P::XB == 4) {
              cp_async4(smem_u32(dst + 4 * j), src, ok);
            } else {
              *reinterpret_cast<int16_t*>(dst + 2 * j) =
                  ok ? __ldg(src) : static_cast<int16_t>(0);
            }
            if (++c == g.C) {
              c = 0;
              if (++kw == g.KW) {
                kw = 0;
                ++kh;
              }
            }
          }
        }
      }
    }
    advance_a();
  };

  // the codes this thread loaded into raw stage `stage` -> its 16 bytes of
  // each row in each of the P_x planes of A buffer `buf` (plane p: byte p
  // of every code)
  auto split_a = [&](int stage, int buf) {
    if constexpr (PB) {
      const uint8_t* const raw = smem + stage * P::RAW_STAGE + P::XB * a_seg;
      uint8_t* const pl = smem + P::A_OFF + buf * P::PX * BM * TC_BK;
#pragma unroll
      for (int p = 0; p < MI; ++p) {
        const int row = a_row + 64 * p;
        const uint8_t* const src = raw + row * P::RAW_STRIDE;
        if constexpr (P::PX == 2) {
          const uint4 u = *reinterpret_cast<const uint4*>(src);
          const uint4 v = *reinterpret_cast<const uint4*>(src + 16);
          *reinterpret_cast<uint4*>(pl + swz(row, a_seg)) = make_uint4(
              __byte_perm(u.x, u.y, 0x6420), __byte_perm(u.z, u.w, 0x6420),
              __byte_perm(v.x, v.y, 0x6420), __byte_perm(v.z, v.w, 0x6420));
          *reinterpret_cast<uint4*>(pl + BM * TC_BK + swz(row, a_seg)) =
              make_uint4(
                  __byte_perm(u.x, u.y, 0x7531), __byte_perm(u.z, u.w, 0x7531),
                  __byte_perm(v.x, v.y, 0x7531), __byte_perm(v.z, v.w, 0x7531));
        } else {
          // four codes a chunk, a 4 x 4 byte transpose each: word c of
          // plane b holds byte b of codes 4 c .. 4 c + 3
          uint4 ch[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            ch[c] = *reinterpret_cast<const uint4*>(src + 16 * (c ^ a_rot));
          if (a_rot) {
            const uint4 t0 = ch[0], t1 = ch[1];
            ch[0] = ch[2];
            ch[1] = ch[3];
            ch[2] = t0;
            ch[3] = t1;
          }
          uint32_t b0[4], b1[4], b2[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t lo01 = __byte_perm(ch[c].x, ch[c].y, 0x5140);
            const uint32_t lo23 = __byte_perm(ch[c].z, ch[c].w, 0x5140);
            const uint32_t hi01 = __byte_perm(ch[c].x, ch[c].y, 0x7362);
            const uint32_t hi23 = __byte_perm(ch[c].z, ch[c].w, 0x7362);
            b0[c] = __byte_perm(lo01, lo23, 0x5410);
            b1[c] = __byte_perm(lo01, lo23, 0x7632);
            b2[c] = __byte_perm(hi01, hi23, 0x5410);
          }
          *reinterpret_cast<uint4*>(pl + swz(row, a_seg)) =
              make_uint4(b0[0], b0[1], b0[2], b0[3]);
          *reinterpret_cast<uint4*>(pl + BM * TC_BK + swz(row, a_seg)) =
              make_uint4(b1[0], b1[1], b1[2], b1[3]);
          *reinterpret_cast<uint4*>(pl + 2 * BM * TC_BK + swz(row, a_seg)) =
              make_uint4(b2[0], b2[1], b2[2], b2[3]);
        }
      }
    }
  };

  // the B tiles of the weight planes, (P_w, N, Kp) int8 K-major: plane
  // e / 512, column (e / 4) % 128, 16 bytes (e % 4) of the tile's 64 K
  const int kp = (K + 15) & ~15;
  auto load_bpl = [&](int stage, int kt) {
    uint8_t* const dst = smem + P::B_OFF + stage * P::PW * TC_BN * TC_BK;
    const int8_t* const wp = static_cast<const int8_t*>(w);
#pragma unroll
    for (int q = 0; q < P::PW * TC_BN * TC_BK / 16 / TC_THREADS; ++q) {
      const int e = tid + TC_THREADS * q;
      const int plane = e / (TC_BN * TC_BK / 16);
      const int col = (e >> 2) & (TC_BN - 1);
      const int seg = (e & 3) * 16;
      const int gn = n0 + col;
      const int gk = kt * TC_BK + seg;
      const bool ok = gn < N && gk < kp;
      cp_async16(smem_u32(dst + plane * TC_BN * TC_BK + swz(col, seg)),
                 ok ? wp + (static_cast<size_t>(plane) * N + gn) * kp + gk
                    : wp,
                 ok);
    }
  };

  // acc[i][j][2 h + c]: row 64 i + 16 wq + gq + 8 h, column 64 wg + 8 j +
  // 2 q + c, the wgmma m64nNk32 accumulator layout; byte planes: accs[s]
  // holds the products of shift 8 s, added into acc = accs[0] after the
  // mainloop
  int accs[P::SETS][MI][TC_NJ][4];
  int (&acc)[MI][TC_NJ][4] = accs[0];
#pragma unroll
  for (int s = 0; s < P::SETS; ++s)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) accs[s][i][j][r] = 0;

  // wgmma operands straight from the swizzled stages: A rows 64 i.., B
  // rows (columns of W) 64 wg..; the second 32 bytes of K at +32 bytes
  const uint32_t a_sm = smem_u32(As);
  const uint32_t b_sm = smem_u32(Bs) + wg * 64 * TC_BK;

  auto compute = [&](int stage) {
    warpgroup_fence(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t db = wgmma_desc(b_sm + stage * TC_BN * TC_BK + 32 * kk);
#pragma unroll
      for (int i = 0; i < MI; ++i)
        wgmma_m64n64k32<PL == PL_U8>(acc[i],
                                     wgmma_desc(a_sm + stage * TC_BM * TC_BK +
                                                i * 64 * TC_BK + 32 * kk),
                                     db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    warpgroup_fence(acc);
  };

  // byte planes: the P_x P_w products of A buffer `buf` and B stage
  // `stage`, x plane i times w plane j into set i + j; a plane is u8 but
  // for the top one (s8; the codes' u8 for the U kinds)
  auto compute_planes = [&](int stage, int buf) {
    if constexpr (PB) {
#pragma unroll
      for (int s = 0; s < P::SETS; ++s) warpgroup_fence(accs[s]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t a0 =
          smem_u32(smem + P::A_OFF) + buf * P::PX * BM * TC_BK;
      const uint32_t b0 = smem_u32(smem + P::B_OFF) +
                          stage * P::PW * TC_BN * TC_BK + wg * 64 * TC_BK;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int px = 0; px < P::PX; ++px) {
            const uint64_t da = wgmma_desc(a0 + px * BM * TC_BK +
                                           i * 64 * TC_BK + 32 * kk);
#pragma unroll
            for (int pw = 0; pw < P::PW; ++pw)
              wgmma_plane(accs[px + pw][i], da,
                          wgmma_desc(b0 + pw * TC_BN * TC_BK + 32 * kk),
                          px < P::PX - 1 || P::XU, pw < P::PW - 1);
          }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < P::SETS; ++s) warpgroup_fence(accs[s]);
    }
  };

  // ---- mainloop: A tiles i+1 .. i+3 in flight (cp.async) while the tensor
  // cores consume tile i; B tile i+3 in registers, stored into shared
  // memory one iteration later, so its load latency hides behind a tile.
  // The threshold block goes first, with A tile 0: its latency hides
  // behind the mainloop.
  const bool staged = !bsearch && L <= DENSE_MAX_L;
  const int LS = ts_stride(L);
  int32_t* const Ts =
      reinterpret_cast<int32_t*>(smem + P::RING);
  if (staged) {
    for (int e = tid; e < TC_BN * L; e += TC_THREADS) {
      const int c = e / L;
      const int l = e - c * L;
      const bool ok = n0 + c < N;
      cp_async4(smem_u32(Ts + c * LS + l),
                ok ? t + static_cast<size_t>(n0 + c) * L + l : t, ok);
    }
  }
  if constexpr (PB) {
    // Byte planes: raw A tiles and the B planes i+1 .. i+3 in flight
    // while the tensor cores consume tile i.  Each thread splits its own
    // raw codes of tile i (nothing to wait for but its own copies), then
    // one barrier makes A buffer i % 2 and B stage i visible.  The other
    // warpgroup may still read A buffer (i - 1) % 2; buffer i % 2 was last
    // read before the barrier of iteration i - 1.
#pragma unroll
    for (int s = 0; s < TC_STAGES - 1; ++s) {
      if (s < nkt) {
        load_raw(s);
        load_bpl(s, kt_begin + s);
      }
      cp_async_commit();
    }
    for (int i = 0; i < nkt; ++i) {
      cp_async_wait<TC_STAGES - 2>();
      split_a(i % TC_STAGES, i & 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const int nxt = i + TC_STAGES - 1;
      if (nxt < nkt) {
        load_raw(nxt % TC_STAGES);
        load_bpl(nxt % TC_STAGES, kt_begin + nxt);
      }
      cp_async_commit();
      compute_planes(i % TC_STAGES, i & 1);
    }
  } else {
#pragma unroll
    for (int s = 0; s < TC_STAGES - 1; ++s) {
      if (s < nkt) {
        load_a(s);
        fetch_b(kt_begin + s);
        if (s < TC_STAGES - 2) store_b(s);
      }
      cp_async_commit();
    }
    for (int i = 0; i < nkt; ++i) {
      cp_async_wait<TC_STAGES - 2>();
      // shared-memory writes (cp.async, stores) -> wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const int nxt = i + TC_STAGES - 1;
      if (nxt - 1 < nkt) store_b((nxt - 1) % TC_STAGES);
      if (nxt < nkt) {
        load_a(nxt % TC_STAGES);
        fetch_b(kt_begin + nxt);
      }
      cp_async_commit();
      compute(i % TC_STAGES);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (PB) {
    // sum_s accs[s] << 8 s in uint32: the exact sum modulo 2^32
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t v = static_cast<uint32_t>(acc[i][j][r]);
#pragma unroll
          for (int s = 1; s < P::SETS; ++s)
            v += static_cast<uint32_t>(accs[s][i][j][r]) << (8 * s);
          acc[i][j][r] = static_cast<int>(v);
        }
  }

  const int wm = 16 * wq;     // row of acc[i][..] = wm + 64 i + gq + 8 h
  const int wn = 64 * wg;     // column of acc[..][j] = wn + 8 j + 2 q + c

  // ---- split K: the last block of a tile adds the other splits' sums ----
  // Scratch holds, per tile and split, the block's accumulators in thread
  // order (8 MI int4 a thread, a warp's stores contiguous): no bounds, no
  // index arithmetic, and the last block reads them back the same way.
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  int4* const part = reinterpret_cast<int4*>(ws) +
      (static_cast<size_t>(tile) * gridDim.z) * (BM * TC_BN / 4);
  if (gridDim.z > 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < TC_NJ; ++j)
        __stcg(part + blockIdx.z * (BM * TC_BN / 4) +
                   (TC_NJ * i + j) * TC_THREADS + tid,
               make_int4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                         acc[i][j][3]));
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(tile_counts + tile, 1) == static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!s_last) return;
  }
  // GAP epilogue: the block's BM x 128 tile of the skip operand goes into
  // the ring, idle since the mainloop, by cp.async now, and lands while the
  // other splits' sums are added and the thresholds counted
  const bool gap = EPI == EPI_INT && e.pool > 0;
  if (gap) stage_skip(smem, e.skip, m0, n0, M, N, BM, tid);
  if (gridDim.z > 1) {
    __threadfence();
    for (int z = 0; z < static_cast<int>(gridDim.z); ++z) {
      if (z == static_cast<int>(blockIdx.z)) continue;
      int4 v[MI][TC_NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j)
          v[i][j] = __ldcg(part + z * (BM * TC_BN / 4) +
                           (TC_NJ * i + j) * TC_THREADS + tid);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j) {
          acc[i][j][0] += v[i][j].x;
          acc[i][j][1] += v[i][j].y;
          acc[i][j][2] += v[i][j].z;
          acc[i][j][3] += v[i][j].w;
        }
    }
    if (tid == 0) tile_counts[tile] = 0;
  }

  // ---- epilogue: threshold counts in registers, only codes written ------
  // Tables of up to 64 levels are staged in shared memory; longer ones are
  // binary-searched (sorted) or, for the float MVAU's sub-path, whose
  // tables need not be sorted, counted densely from global memory.
  if (bsearch) {
    // The 2 MI searches of each of a thread's two columns in lockstep
    // (count_sorted_smem's arithmetic on the global rows): every search
    // takes the same ceil(log2(L + 1)) steps, so the 8 loads of a step go
    // out together instead of one dependent chain after another.  Rows
    // past M search too and are not stored; columns past N search row
    // N - 1; a warp's 8-column group wholly past N searches nothing.
#pragma unroll
    for (int j = 0; j < TC_NJ; ++j) {
      if (n0 + wn + 8 * j >= N) continue;
      const int gn = n0 + wn + 8 * j + 2 * q;
      const int32_t* const r0 = t + static_cast<size_t>(min(gn, N - 1)) * L;
      const int32_t* const r1 =
          t + static_cast<size_t>(min(gn + 1, N - 1)) * L;
      int lo[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) lo[i][r] = 0;
      for (int n = L + 1; n > 1;) {
        const int h = n >> 1;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r)       // acc[..][r]: column cc = r & 1
            lo[i][r] += acc[i][j][r] >= __ldg((r & 1 ? r1 : r0) + lo[i][r] +
                                              h - 1)
                            ? h : 0;
        n -= h;
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = lo[i][r];
    }
  } else {
#pragma unroll
    for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = wn + 8 * j + 2 * q + cc;
        const int gn = n0 + col;
        if (gn >= N) continue;
        int cnt[MI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) cnt[i][0] = cnt[i][1] = 0;
        if (staged) {
          const int32_t* row = Ts + col * LS;
#pragma unroll 5
          for (int l = 0; l < L; ++l) {
            const int tv = row[l];
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr)
                cnt[i][rr] = count_ge(cnt[i][rr], acc[i][j][2 * rr + cc], tv);
          }
        } else {
          const int32_t* row = t + static_cast<size_t>(gn) * L;
          for (int l = 0; l < L; ++l) {
            const int tv = __ldg(row + l);
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr)
                cnt[i][rr] = count_ge(cnt[i][rr], acc[i][j][2 * rr + cc], tv);
          }
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) acc[i][j][2 * rr + cc] = cnt[i][rr];
      }
  }

  const bool pairs = (N & 1) == 0;
  if (gap) {
    // ---- GlobalAccPool epilogue: v = out_base + count + skip[gm, gn] in
    // uint32 (wrapping as the reference's int32 sum does), summed over the
    // rows of each image; only the (image, column) sums are written.  A
    // warp's 16 rows of a 64-row block start at a multiple of 16, so with
    // pool | 16 each image lies inside one warp: its rows gq + 8 h differ
    // in the low log2(min(pool, 8)) bits of gq (and, for pool = 16, in h),
    // and are summed by xor shuffles across those lanes (and in the
    // thread).  Rows past M and columns past N add 0.  The skip comes from
    // the staged tile, in 8-byte reads: a warp's 8 rows x 32 bytes take 2
    // wavefronts (see skip_word).
    cp_async_wait<0>();
    __syncthreads();
    const int32_t* const Ss = reinterpret_cast<const int32_t*>(smem);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = wm + 64 * i + gq + 8 * rr;
        const int gm = m0 + row;
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j) {
          const int col = wn + 8 * j + 2 * q;
          const int gn = n0 + col;
          const int2 sv =
              *reinterpret_cast<const int2*>(Ss + skip_word(row, col));
          const uint32_t s0 = static_cast<uint32_t>(sv.x);
          const uint32_t s1 = static_cast<uint32_t>(sv.y);
          const uint32_t base = static_cast<uint32_t>(e.out_base_i);
          int& v0 = acc[i][j][2 * rr];
          int& v1 = acc[i][j][2 * rr + 1];
          v0 = gm < M && gn < N
                   ? static_cast<int>(base + static_cast<uint32_t>(v0) + s0)
                   : 0;
          v1 = gm < M && gn + 1 < N
                   ? static_cast<int>(base + static_cast<uint32_t>(v1) + s1)
                   : 0;
        }
      }
    int32_t* const pooled = static_cast<int32_t*>(out);
    constexpr unsigned FULL = 0xffffffffu;
    if (e.pool == 16) {
      // One image per warp and 64-row block: add the thread's two row
      // halves, then reduce-scatter the 16 MI sums across the 8 lanes of a
      // column quad (xor 16, 8, 4: each step keeps half and sends half, 28
      // shuffles in all at MI = 2).  Lane gq ends with the sums of flat
      // index 2 MI gq .. 2 MI gq + 2 MI - 1 of (i, j, c): i = MI gq / 8
      // and j = (MI gq + k) % 8 for its pairs k < MI (MI = 2: i = gq / 4,
      // j = 2 (gq % 4) + k; MI = 1: i = 0, j = gq).
      uint32_t w[MI * TC_NJ * 2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            w[(i * TC_NJ + j) * 2 + c] = static_cast<uint32_t>(acc[i][j][c]) +
                                         static_cast<uint32_t>(acc[i][j][2 + c]);
      reduce_scatter<16, 8 * MI>(w, lane);
      reduce_scatter<8, 4 * MI>(w, lane);
      reduce_scatter<4, 2 * MI>(w, lane);
      // the image's first row
      const int gm = m0 + wm + 64 * ((MI * gq) >> 3);
      if (gm >= M) return;
      int32_t* const row = pooled + static_cast<size_t>(gm / 16) * N;
#pragma unroll
      for (int kk = 0; kk < MI; ++kk) {
        const int gn = n0 + wn + 8 * ((MI * gq + kk) & (TC_NJ - 1)) + 2 * q;
        const int c0 = static_cast<int>(w[2 * kk]);
        const int c1 = static_cast<int>(w[2 * kk + 1]);
        if (pairs && gn + 1 < N) {
          *reinterpret_cast<int2*>(row + gn) = make_int2(c0, c1);
        } else {
          if (gn < N) row[gn] = c0;
          if (gn + 1 < N) row[gn + 1] = c1;
        }
      }
      return;
    }
    // Smaller images: each lies inside one row half; xor shuffles over the
    // gq bits that differ inside it, then the lanes whose gq is a multiple
    // of span hold its sums.
    const int span = e.pool < 8 ? e.pool : 8;
    for (int off = 4; off < 4 * span; off <<= 1)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[i][j][r] = static_cast<int>(
                static_cast<uint32_t>(acc[i][j][r]) +
                static_cast<uint32_t>(
                    __shfl_xor_sync(FULL, acc[i][j][r], off)));
    if ((gq & (span - 1)) != 0) return;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int gm = m0 + wm + 64 * i + gq + 8 * rr;
        if (gm >= M) continue;
        int32_t* const row = pooled + static_cast<size_t>(gm / e.pool) * N;
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j) {
          const int gn = n0 + wn + 8 * j + 2 * q;
          const int c0 = acc[i][j][2 * rr];
          const int c1 = acc[i][j][2 * rr + 1];
          if (pairs && gn + 1 < N) {
            *reinterpret_cast<int2*>(row + gn) = make_int2(c0, c1);
          } else {
            if (gn < N) row[gn] = c0;
            if (gn + 1 < N) row[gn + 1] = c1;
          }
        }
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int gm = m0 + wm + 64 * i + gq + 8 * rr;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < TC_NJ; ++j) {
        const int gn = n0 + wn + 8 * j + 2 * q;
        const size_t o = static_cast<size_t>(gm) * N + gn;
        const int c0 = acc[i][j][2 * rr];
        const int c1 = acc[i][j][2 * rr + 1];
        if constexpr (EPI == EPI_FLOAT) {
          // three separately rounded float32 operations, as the reference
          // computes them: no contraction into an FMA
          const float y0 = __fadd_rn(
              __fmul_rn(e.out_scale,
                        __fadd_rn(e.out_base_f, static_cast<float>(c0))),
              e.out_bias);
          const float y1 = __fadd_rn(
              __fmul_rn(e.out_scale,
                        __fadd_rn(e.out_base_f, static_cast<float>(c1))),
              e.out_bias);
          float* const dst = static_cast<float*>(out) + o;
          if (pairs && gn + 1 < N) {
            *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
          } else {
            if (gn < N) dst[0] = y0;
            if (gn + 1 < N) dst[1] = y1;
          }
        } else {
          int32_t* const dst = static_cast<int32_t*>(out) + o;
          if (pairs && gn + 1 < N) {
            *reinterpret_cast<int2*>(dst) =
                make_int2(e.out_base_i + c0, e.out_base_i + c1);
          } else {
            if (gn < N) dst[0] = e.out_base_i + c0;
            if (gn + 1 < N) dst[1] = e.out_base_i + c1;
          }
        }
      }
    }
}

template <int VEC, int WK, int EPI, int PL>
int launch_conv(const void* x, const ConvGeom& g, const void* w,
                const int32_t* t, void* out, int32_t* ws, int* tile_counts,
                int M, int K, int N, int L, bool bsearch, int splits,
                const Epilogue& e, cudaStream_t stream) {
  using P = Planes<PL>;
  auto kern = mvau_conv_kernel<VEC, WK, EPI, PL>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int KT = std::max(1, (K + TC_BK - 1) / TC_BK);
  splits = std::max(1, std::min(splits, KT));
  const int per = (KT + splits - 1) / splits;
  splits = (KT + per - 1) / per;          // no split left without a K-tile
  if (splits > 1 && (ws == nullptr || tile_counts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const bool w_vec = N % 8 == 0 && wa % (WK == W_PACKED4 ? 4 : 8) == 0;
  dim3 grid((M + P::BM - 1) / P::BM, (N + TC_BN - 1) / TC_BN, splits);
  const int smem = P::RING +
                   (!bsearch && L <= DENSE_MAX_L ? TC_BN * ts_stride(L) * 4
                                                 : 0);
  kern<<<grid, TC_THREADS, smem, stream>>>(x, g, w, w_vec, t, out, ws,
                                           tile_counts, M, K, N, L, bsearch,
                                           per, e);
  return static_cast<int>(cudaGetLastError());
}

// the widest A copy that C and the activation's alignment allow (16 codes,
// 4 codes or 1 code; the u8 and byte-plane routes take 16 or 1)
template <int WK, int EPI, int PL = PL_S8>
int launch_conv_any(const void* x, const ConvGeom& g, const void* w,
                    const int32_t* t, void* out, int32_t* ws,
                    int* tile_counts, int M, int K, int N, int L,
                    bool bsearch, int splits, const Epilogue& e,
                    cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (g.C % 16 == 0 && xa % 16 == 0)
    return launch_conv<16, WK, EPI, PL>(x, g, w, t, out, ws, tile_counts, M,
                                        K, N, L, bsearch, splits, e, stream);
  if constexpr (PL == PL_S8) {
    if (g.C % 4 == 0 && xa % 4 == 0)
      return launch_conv<4, WK, EPI, PL>(x, g, w, t, out, ws, tile_counts, M,
                                         K, N, L, bsearch, splits, e, stream);
  }
  return launch_conv<1, WK, EPI, PL>(x, g, w, t, out, ws, tile_counts, M, K,
                                     N, L, bsearch, splits, e, stream);
}

// the integer MVAU's epilogues: codes, or codes + skip summed per image
Epilogue int_epilogue(int out_base, const int32_t* skip = nullptr,
                      int pool = 0) {
  return Epilogue{out_base, 0.f, 1.f, 0.f, skip, pool};
}

// the GEMM form (M, K) as a 1 x 1 conv over an M x 1 image of K channels
ConvGeom gemm_geom(int M, int K) {
  return ConvGeom{M, 1, std::max(K, 1), 1, 1, 1, 0, M, 1};
}

// ---------------------------------------------------------------------------
// The GEMM form at decode shapes: int8 x int8 (or packed int4) for M of a
// few rows (up to 512), mvau_small_m_kernel.
//
// At M <= 8 the wgmma kernel's 128-row tile is 1/128 used, and its long-
// table epilogue searched every accumulator of the tile, each search a
// chain of dependent global loads: one launch at lm-tiny's w_down (K 96,
// N 64, 255 levels) took as long at M = 1 as at M = 128.  Here:
// * Swap-AB on mma.sync m16n8k32 (s8.s8.s32): the block's 16 output
//   columns are the MMA's 16-row side (A = W^T), the block's rows of x its
//   8-wide side (B = x^T), up to 4 such tiles for 32 rows; an 8-row tile
//   with no row < M is not multiplied, and no row >= M is counted.
// * K is split over the block's 4 warps (32-byte steps, round robin) and
//   their sums added in warp order in shared memory: no atomics, no
//   scratch, no tile counters, so a CUDA graph captures the launch as it
//   is.  Passes of 512 bytes of K stage W (transposed to K-major columns
//   with byte permutes, packed int4 unpacked on the way) and x in shared
//   memory.
// * The block's threshold rows (16 x L words, contiguous in t) are copied
//   into shared memory by cp.async at the start and land while W and x
//   load and multiply.  Tables of up to 64 levels are counted densely;
//   longer ones are searched (count_sorted_smem), every search of a thread
//   in lockstep so their loads overlap.
// Grid: N / 16 x M / 32 blocks of 128 threads.  Bound by bytes, dominated
// by the thresholds (N L words); at these sizes a launch's latency is
// what the card pays (chip_smoke.py times an empty launch beside it).
// ---------------------------------------------------------------------------
constexpr int SM_BN = 16;       // output columns a block: the MMA's 16 side
constexpr int SM_BM = 32;       // rows of x a block: 4 MMA tiles of 8
constexpr int SM_WARPS = 4;
constexpr int SM_THREADS = 32 * SM_WARPS;
constexpr int SM_KC = 512;      // K bytes staged per pass: 4 rows a thread
// Words per staged column of W and row of x: 4 mod 32, so the fragment
// reads of a warp (8 columns or rows x 4 words) hit 32 distinct banks.
constexpr int SM_KW = SM_KC / 4 + 4;
constexpr int SM_MAX_L = 2048;  // levels that fit shared memory (16 L words)
static_assert(SM_KC == 4 * SM_THREADS, "a W pass is 4 K-rows a thread");

// D (16 x 8, s32) += A (16 x 32, s8, row) B (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// #{ l : a[i] >= row[l] } for the first nv of the R accumulators of a
// thread, in a row sorted ascending, in ceil(log2(L + 1)) steps: the answer
// lies in [lo, lo + n); it is at least lo + h exactly when a >= row[lo + h
// - 1]; both outcomes keep n - h candidates, so every search of the thread
// takes the same steps and their loads go out together.  (kernels/ref.py's
// count_sorted_steps mirrors this arithmetic.)
template <int R>
__device__ __forceinline__ void count_sorted_smem(const int32_t* row, int L,
                                                  const int (&a)[R], int nv,
                                                  int (&lo)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) lo[i] = 0;
  for (int n = L + 1; n > 1;) {
    const int h = n >> 1;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < nv) lo[i] += a[i] >= row[lo[i] + h - 1] ? h : 0;
    n -= h;
  }
}

template <int WK>
__global__ void __launch_bounds__(SM_THREADS)
mvau_small_m_kernel(const int8_t* __restrict__ x,
                    const void* __restrict__ w,
                    const int32_t* __restrict__ t, int32_t* __restrict__ out,
                    int M, int K, int N, int L, int out_base, bool x_vec,
                    bool w_vec, bool t_vec) {
  extern __shared__ __align__(16) int32_t sm_t[];   // 16 rows x L levels
  __shared__ __align__(16) uint32_t Wt[SM_BN * SM_KW];  // column-major W
  __shared__ __align__(16) uint32_t Xs[SM_BM * SM_KW];  // row-major x
  __shared__ int red[SM_WARPS][SM_BM * SM_BN];          // per warp's sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int n0 = blockIdx.x * SM_BN;
  const int m0 = blockIdx.y * SM_BM;
  const int nb = min(SM_BN, N - n0);       // columns of the block
  const int mb = min(SM_BM, M - m0);       // rows of the block
  const int tiles = (mb + 7) >> 3;         // 8-row MMA tiles with a row < M

  // ---- thresholds: rows n0 .. n0 + nb - 1 are nb L contiguous words ----
  {
    const int32_t* src = t + static_cast<size_t>(n0) * L;
    const int words = nb * L;
    const int vecs = t_vec ? words >> 2 : 0;
    for (int e = tid; e < vecs; e += SM_THREADS)
      cp_async16(smem_u32(sm_t + 4 * e), src + 4 * e, true);
    for (int e = 4 * vecs + tid; e < words; e += SM_THREADS)
      cp_async4(smem_u32(sm_t + e), src + e, true);
    cp_async_commit();
  }

  // acc[j][r]: column n0 + g + 8 (r >> 1), row m0 + 8 j + 2 q + (r & 1)
  int acc[SM_BM / 8][4];
#pragma unroll
  for (int j = 0; j < SM_BM / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += SM_KC) {
    const int steps = (min(SM_KC, K - k0) + 31) >> 5;   // 32-byte K steps
    if (k0 > 0) __syncthreads();          // every warp done with the last pass
    // ---- W: rows k0 + 4 tid .. + 3 of the block's 16 columns, transposed
    // to 16 words (4 rows of one column each), 0 past K and N
    {
      uint32_t rw[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kk = k0 + 4 * tid + r;
#pragma unroll
        for (int h = 0; h < 4; ++h) rw[r][h] = 0u;
        if (kk >= K) continue;
        if (w_vec && nb == SM_BN) {
          if constexpr (WK == W_PACKED4) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                static_cast<const uint8_t*>(w) +
                static_cast<size_t>(kk) * (N >> 1) + (n0 >> 1)));
            unpack_int4x8(v.x, rw[r][0], rw[r][1]);
            unpack_int4x8(v.y, rw[r][2], rw[r][3]);
          } else {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                static_cast<const int8_t*>(w) + static_cast<size_t>(kk) * N +
                n0));
            rw[r][0] = v.x;
            rw[r][1] = v.y;
            rw[r][2] = v.z;
            rw[r][3] = v.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < SM_BN; ++c)
            if (c < nb)
              rw[r][c >> 2] |=
                  static_cast<uint32_t>(static_cast<uint8_t>(
                      load_w<int, WK>(w, kk, n0 + c, N)))
                  << (8 * (c & 3));
        }
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint32_t t01 = __byte_perm(rw[0][h], rw[1][h], 0x5140);
        const uint32_t t23 = __byte_perm(rw[2][h], rw[3][h], 0x5140);
        const uint32_t u01 = __byte_perm(rw[0][h], rw[1][h], 0x7362);
        const uint32_t u23 = __byte_perm(rw[2][h], rw[3][h], 0x7362);
        Wt[(4 * h + 0) * SM_KW + tid] = __byte_perm(t01, t23, 0x5410);
        Wt[(4 * h + 1) * SM_KW + tid] = __byte_perm(t01, t23, 0x7632);
        Wt[(4 * h + 2) * SM_KW + tid] = __byte_perm(u01, u23, 0x5410);
        Wt[(4 * h + 3) * SM_KW + tid] = __byte_perm(u01, u23, 0x7632);
      }
    }
    // ---- x: the block's rows < M, the pass's steps, 4 bytes a word -------
    {
      const int kw = 8 * steps;              // words a row in this pass
      for (int e = tid; e < mb * kw; e += SM_THREADS) {
        const int row = e / kw;
        const int c = e - row * kw;
        const int kk = k0 + 4 * c;
        const int8_t* src = x + static_cast<size_t>(m0 + row) * K + kk;
        uint32_t v = 0u;
        if (x_vec) {
          if (kk < K) v = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (kk + b < K)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + b)))
                   << (8 * b);
        }
        Xs[row * SM_KW + c] = v;
      }
    }
    __syncthreads();
    // ---- the products: step s of the pass on warp s % 4 ------------------
    for (int s = warp; s < steps; s += SM_WARPS) {
      const int kq = 8 * s;
      uint32_t a[4];
      a[0] = Wt[g * SM_KW + kq + q];
      a[1] = Wt[(g + 8) * SM_KW + kq + q];
      a[2] = Wt[g * SM_KW + kq + 4 + q];
      a[3] = Wt[(g + 8) * SM_KW + kq + 4 + q];
#pragma unroll
      for (int j = 0; j < SM_BM / 8; ++j)
        if (j < tiles)
          mma_s8(acc[j], a, Xs[(8 * j + g) * SM_KW + kq + q],
                 Xs[(8 * j + g) * SM_KW + kq + 4 + q]);
    }
  }

  // ---- the warps' sums, added in warp order -------------------------------
#pragma unroll
  for (int j = 0; j < SM_BM / 8; ++j)
    if (j < tiles)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[warp][(8 * j + 2 * q + (r & 1)) * SM_BN + g + 8 * (r >> 1)] =
            acc[j][r];
  cp_async_wait<0>();
  __syncthreads();

  // ---- epilogue: column c, rows r0 + 8 i (i < nv: the rows < M) -----------
  constexpr int R = SM_BM * SM_BN / SM_THREADS;        // 4 outputs a thread
  constexpr int RS = SM_THREADS / SM_BN;               // 8 rows apart
  const int c = tid & (SM_BN - 1);
  const int r0 = tid / SM_BN;
  if (c >= nb || r0 >= mb) return;
  const int nv = (mb - r0 + RS - 1) / RS;
  int v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    v[i] = 0;
    if (i < nv)
#pragma unroll
      for (int wp = 0; wp < SM_WARPS; ++wp)
        v[i] += red[wp][(r0 + RS * i) * SM_BN + c];
  }
  const int32_t* row_t = sm_t + c * L;
  int cnt[R];
  if (L <= DENSE_MAX_L) {
#pragma unroll
    for (int i = 0; i < R; ++i) cnt[i] = 0;
    for (int l = 0; l < L; ++l) {
      const int tv = row_t[l];
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < nv) cnt[i] = count_ge(cnt[i], v[i], tv);
    }
  } else {
    count_sorted_smem<R>(row_t, L, v, nv, cnt);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < nv)
      out[static_cast<size_t>(m0 + r0 + RS * i) * N + n0 + c] =
          out_base + cnt[i];
}

template <int WK>
int launch_small_m(const void* x, const void* w, const int32_t* t,
                   int32_t* out, int M, int K, int N, int L, int out_base,
                   cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  auto kern = mvau_small_m_kernel<WK>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SM_BN * SM_MAX_L * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const bool x_vec = K % 4 == 0 && xa % 4 == 0;
  const bool w_vec = N % SM_BN == 0 && wa % (WK == W_PACKED4 ? 8 : 16) == 0;
  const bool t_vec = reinterpret_cast<uintptr_t>(t) % 16 == 0;
  dim3 grid((N + SM_BN - 1) / SM_BN, (M + SM_BM - 1) / SM_BM);
  kern<<<grid, SM_THREADS, SM_BN * L * 4, stream>>>(
      static_cast<const int8_t*>(x), w, t, out, M, K, N, L, out_base, x_vec,
      w_vec, t_vec);
  return static_cast<int>(cudaGetLastError());
}

// the practical floor of a launch: nothing but the launch itself
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// Everything else on the CUDA cores: the conv-form (implicit-GEMM) MVAU in
// float32 FMA (the float MVAU) or exact int32 multiply-add (integer codes
// that do not fit int8: a8 activations, 9- to 16-bit weights).
//
// Block tile 128 rows x BN columns (BN = 128, or 64 where N <= 64), 256
// threads.  Thread (ty, tx) = (4 (warp / 2) + lane / 8, 8 (warp % 2) + lane
// % 8) owns rows ty + 16 i (i < CORE_TM = 8) and columns 4 tx + 64 g + c
// (g < BN / 64, c < 4): 64 (or 32) accumulators in registers.
// Shared memory holds a ring of CORE_STAGES stages, each an A tile (128
// patch rows x 16 k, M-major as the activation stores them) and a B tile
// (16 k x BN columns, as W stores them), then the block's patch-row table
// (where each output pixel's window starts: the loaders keep no per-row
// registers) and its threshold rows, level-major.  A's rows are padded to
// CORE_AS = 20 words.
// * A: 16-byte cp.async of 4 consecutive k of one patch row, with a
//   zero-filling source size for the halo, the ragged K edge and rows past
//   M, when C is a multiple of 4; 4-byte cp.async otherwise (C = 3).
// * B: 16-byte cp.async for 32-bit weights (float32, int32); int8, int16
//   and packed int4 codes are loaded into registers one stage ahead,
//   widened to int32, and stored after the stage's math.
// * Fragments: per 2 k, one 8-byte load from each of the thread's 8 rows; per k, one 16-byte load per 4 columns.  A warp spans
//   4 rows x 8 column groups, so each fragment load reads at most 128
//   distinct bytes: 4 adjacent rows (20 words apart: distinct banks), or 8
//   contiguous 16-byte column groups.
// * One __syncthreads per stage: the copies for stage i + 3 go out after
//   it, into the buffer every thread finished with in stage i - 1.
// * Split K: where the output tiles are fewer than the SMs, grid.z splits
//   the K-tiles.  Each split writes its partial sums to scratch; the last
//   block of a tile to arrive (a per-tile counter, reset by that block)
//   adds all of them in split order, so every launch gives the same bits.
// * Epilogue: tables of up to 64 levels are counted densely from shared
//   memory, one column at a time; longer integer tables (sorted) are
//   binary-searched; longer float tables (not sorted) are counted densely
//   from global memory.  The accumulators are replaced in place by the
//   output values and stored 16 bytes at a time.
// ---------------------------------------------------------------------------
constexpr int CORE_TM = 8;     // rows per thread
constexpr int CORE_BM = 16 * CORE_TM;
constexpr int CORE_BK = 16;
constexpr int CORE_AS = CORE_BK + 4;    // A row stride in words
constexpr int CORE_STAGES = 4;
constexpr int CORE_THREADS = 256;

template <int BN>
struct CoreTile {
  static constexpr int TN = BN / 16;           // columns per thread
  static constexpr int G = BN / 64;            // 4-column groups per thread
  static constexpr int A_WORDS = CORE_BM * CORE_AS;
  static constexpr int B_WORDS = CORE_BK * BN;
  static constexpr int STAGE = A_WORDS + B_WORDS;
  static constexpr int RING = CORE_STAGES * STAGE;          // words
  static constexpr int ROWS = 4 * CORE_BM;   // words of the patch-row table
  static constexpr int B_CHUNKS = B_WORDS / 4 / CORE_THREADS;
  static constexpr int SMEM_MAX = (RING + ROWS + BN * DENSE_MAX_L) * 4;
};

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<int> { using type = int2; };
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  static __device__ __forceinline__ float4 make(float a, float b, float c,
                                                float d) {
    return make_float4(a, b, c, d);
  }
};
template <> struct Vec4<int> {
  using type = int4;
  static __device__ __forceinline__ int4 make(int a, int b, int c, int d) {
    return make_int4(a, b, c, d);
  }
};

__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);         // float32 FMA, never TF32
}
__device__ __forceinline__ int mad(int a, int b, int c) { return a * b + c; }

__host__ __device__ constexpr bool narrow_w(int wk) {
  return wk == W_I8 || wk == W_I16 || wk == W_PACKED4;
}

// columns n .. n+3 of row k of narrow weight codes, widened to int32 (0 past
// N); vec: n + 3 < N and the row is aligned for one vector load
template <int WK>
__device__ __forceinline__ int4 load_w4(const void* __restrict__ w, int k,
                                        int n, int N, bool vec) {
  if (vec) {
    if constexpr (WK == W_I8) {
      const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(
          static_cast<const int8_t*>(w) + static_cast<size_t>(k) * N + n));
      return make_int4(static_cast<int8_t>(v & 0xFF),
                       static_cast<int8_t>((v >> 8) & 0xFF),
                       static_cast<int8_t>((v >> 16) & 0xFF),
                       static_cast<int8_t>(v >> 24));
    } else if constexpr (WK == W_I16) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(
          static_cast<const int16_t*>(w) + static_cast<size_t>(k) * N + n));
      return make_int4(static_cast<int16_t>(v.x & 0xFFFF),
                       static_cast<int16_t>(v.x >> 16),
                       static_cast<int16_t>(v.y & 0xFFFF),
                       static_cast<int16_t>(v.y >> 16));
    } else {
      // packed int4: 2 bytes, columns n, n+1 (byte 0 low, high), n+2, n+3
      const uint32_t v = __ldg(reinterpret_cast<const unsigned short*>(
          static_cast<const uint8_t*>(w) + static_cast<size_t>(k) * (N >> 1) +
          (n >> 1)));
      return make_int4(static_cast<int>((v & 0xF) ^ 8u) - 8,
                       static_cast<int>(((v >> 4) & 0xF) ^ 8u) - 8,
                       static_cast<int>(((v >> 8) & 0xF) ^ 8u) - 8,
                       static_cast<int>(((v >> 12) & 0xF) ^ 8u) - 8);
    }
  }
  int r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    r[c] = n + c < N ? load_w<int, WK>(w, k, n + c, N) : 0;
  return make_int4(r[0], r[1], r[2], r[3]);
}

template <typename ACC, int WK, int BN>
__global__ void __launch_bounds__(CORE_THREADS, 2)
mvau_core_kernel(const ACC* __restrict__ x, ConvGeom g, bool a_vec,
                 const void* __restrict__ w, bool w_vec,
                 const ACC* __restrict__ t, ACC* __restrict__ out,
                 ACC* __restrict__ ws, int* __restrict__ tile_counts, int M,
                 int K, int N, int L, bool bsearch, int kt_per_split,
                 int out_base_i, float out_base_f, float out_scale,
                 float out_bias) {
  using Tile = CoreTile<BN>;
  using V2 = typename Vec2<ACC>::type;
  using V4 = typename Vec4<ACC>::type;
  constexpr int TN = Tile::TN;
  constexpr int G = Tile::G;
  extern __shared__ __align__(16) uint8_t core_smem[];
  __shared__ int s_last;
  ACC* const ring = reinterpret_cast<ACC*>(core_smem);
  int4* const rows = reinterpret_cast<int4*>(ring + Tile::RING);
  ACC* const Ts = ring + Tile::RING + Tile::ROWS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = ((tid >> 5) & 1) * 8 + (lane & 7);
  const int ty = (tid >> 6) * 4 + (lane >> 3);
  const int m0 = blockIdx.x * CORE_BM;
  const int n0 = blockIdx.y * BN;
  const int KT = (K + CORE_BK - 1) / CORE_BK;
  const int kt_begin = blockIdx.z * kt_per_split;
  const int nkt = min(KT, kt_begin + kt_per_split) - kt_begin;
  // ---- patch rows: (b H, oh stride - pad, ow stride - pad) of each of the
  // block's output pixels, in shared memory for the A loaders; a row past M
  // lies outside every image
  for (int r = tid; r < CORE_BM; r += CORE_THREADS) {
    const int m = m0 + r;
    int4 v = make_int4(0, -(1 << 28), 0, 0);
    if (m < M) {
      const int ohw = g.OH * g.OW;
      const int b = m / ohw;
      const int rem = m - b * ohw;
      const int oh = rem / g.OW;
      const int ow = rem - oh * g.OW;
      v = make_int4(b * g.H, oh * g.stride - g.pad, ow * g.stride - g.pad, 0);
    }
    rows[r] = v;
  }
  __syncthreads();

  // ---- A, 16-byte copies: rows tid / 4 + 64 p, k 4 (tid % 4) .. of each
  // tile; the (kh, kw, c) of that k advance tile by tile
  int a_k = kt_begin * CORE_BK;    // first k of the next tile to load
  int a_kh, a_kw, a_c;
  {
    const int k = a_k + 4 * (tid & 3);
    const int tap = k / g.C;
    a_c = k - tap * g.C;
    a_kh = tap / g.KW;
    a_kw = tap - a_kh * g.KW;
  }

  auto load_a = [&](int stage) {
    ACC* const As = ring + stage * Tile::STAGE;
    if (a_vec) {
      const int seg = 4 * (tid & 3);
      const bool kin = a_k + seg < K;
#pragma unroll
      for (int p = 0; p < CORE_BM / 64; ++p) {
        const int4 r = rows[(tid >> 2) + 64 * p];
        const int ih = r.y + a_kh;
        const int iw = r.z + a_kw;
        const bool ok = kin && static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
        const ACC* src =
            ok ? x + (static_cast<int64_t>(r.x + ih) * g.W + iw) * g.C + a_c
               : x;
        cp_async16(smem_u32(As + ((tid >> 2) + 64 * p) * CORE_AS + seg), src,
                   ok);
      }
      a_c += CORE_BK;
      while (a_c >= g.C) {
        a_c -= g.C;
        if (++a_kw == g.KW) {
          a_kw = 0;
          ++a_kh;
        }
      }
    } else {
      // 4-byte copies: rows tid / 16 + 16 j, k tid % 16 of the tile
      const int kc = tid & 15;
      const int k = a_k + kc;
      const bool kin = k < K;
      int kh = 0, kw = 0, c = 0;
      if (kin) {
        const int tap = k / g.C;
        c = k - tap * g.C;
        kh = tap / g.KW;
        kw = tap - kh * g.KW;
      }
#pragma unroll
      for (int j = 0; j < CORE_TM; ++j) {
        const int row = (tid >> 4) + 16 * j;
        const int4 r = rows[row];
        const int ih = r.y + kh;
        const int iw = r.z + kw;
        const bool ok = kin && static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
        const ACC* src =
            ok ? x + (static_cast<int64_t>(r.x + ih) * g.W + iw) * g.C + c : x;
        cp_async4(smem_u32(As + row * CORE_AS + kc), src, ok);
      }
    }
    a_k += CORE_BK;
  };

  // ---- B: chunk q of a thread is row ch / (BN / 4), columns 4 (ch % (BN /
  // 4)) .. + 3 of the tile, ch = tid + 256 q
  auto load_b = [&](int stage, int kt) {       // 32-bit weights: cp.async
    ACC* const Bs = ring + stage * Tile::STAGE + Tile::A_WORDS;
    const ACC* const wp = static_cast<const ACC*>(w);
#pragma unroll
    for (int q = 0; q < Tile::B_CHUNKS; ++q) {
      const int ch = tid + CORE_THREADS * q;
      const int kr = ch / (BN / 4);
      const int nc = 4 * (ch % (BN / 4));
      const int gk = kt * CORE_BK + kr;
      const int gn = n0 + nc;
      ACC* const dst = Bs + kr * BN + nc;
      if (w_vec) {
        const bool ok = gk < K && gn < N;
        cp_async16(smem_u32(dst), ok ? wp + static_cast<size_t>(gk) * N + gn : wp,
                   ok);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = gk < K && gn + c < N;
          cp_async4(smem_u32(dst + c),
                    ok ? wp + static_cast<size_t>(gk) * N + gn + c : wp, ok);
        }
      }
    }
  };
  int4 bw[Tile::B_CHUNKS];                     // narrow codes, widened
  auto fetch_b = [&](int kt) {
#pragma unroll
    for (int q = 0; q < Tile::B_CHUNKS; ++q) {
      const int ch = tid + CORE_THREADS * q;
      const int gk = kt * CORE_BK + ch / (BN / 4);
      const int gn = n0 + 4 * (ch % (BN / 4));
      bw[q] = gk < K && gn < N ? load_w4<WK>(w, gk, gn, N, w_vec)
                               : make_int4(0, 0, 0, 0);
    }
  };
  auto store_b = [&](int stage) {
    ACC* const Bs = ring + stage * Tile::STAGE + Tile::A_WORDS;
#pragma unroll
    for (int q = 0; q < Tile::B_CHUNKS; ++q) {
      const int ch = tid + CORE_THREADS * q;
      *reinterpret_cast<int4*>(Bs + (ch / (BN / 4)) * BN + 4 * (ch % (BN / 4))) =
          bw[q];
    }
  };

  ACC acc[CORE_TM][TN];
#pragma unroll
  for (int i = 0; i < CORE_TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = ACC(0);

  auto compute = [&](int stage) {
    const ACC* const As = ring + stage * Tile::STAGE + ty * CORE_AS;
    const ACC* const Bs = ring + stage * Tile::STAGE + Tile::A_WORDS + 4 * tx;
#pragma unroll
    for (int k2 = 0; k2 < CORE_BK; k2 += 2) {
      ACC a[CORE_TM][2];
#pragma unroll
      for (int i = 0; i < CORE_TM; ++i) {
        const V2 v = *reinterpret_cast<const V2*>(As + 16 * i * CORE_AS + k2);
        a[i][0] = v.x;
        a[i][1] = v.y;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ACC b[TN];
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const V4 v = *reinterpret_cast<const V4*>(Bs + (k2 + kk) * BN + 64 * gg);
          b[4 * gg + 0] = v.x;
          b[4 * gg + 1] = v.y;
          b[4 * gg + 2] = v.z;
          b[4 * gg + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < CORE_TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = mad(a[i][kk], b[j], acc[i][j]);
      }
    }
  };

  // ---- mainloop: stages i+1 .. i+3 in flight while stage i is consumed;
  // the threshold block goes out first, with stage 0
  const bool staged = !bsearch && L <= DENSE_MAX_L;
  if (staged) {
    for (int e = tid; e < BN * L; e += CORE_THREADS) {
      const int c = e / L;
      const int l = e - c * L;
      const bool ok = n0 + c < N;
      cp_async4(smem_u32(Ts + l * BN + c),
                ok ? t + static_cast<size_t>(n0 + c) * L + l : t, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < CORE_STAGES - 1; ++s) {
    if (s < nkt) {
      load_a(s);
      if constexpr (narrow_w(WK)) {
        fetch_b(kt_begin + s);
        store_b(s);
      } else {
        load_b(s, kt_begin + s);
      }
    }
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<CORE_STAGES - 2>();
    __syncthreads();
    const int nxt = i + CORE_STAGES - 1;
    const bool more = nxt < nkt;
    if (more) {
      load_a(nxt % CORE_STAGES);
      if constexpr (narrow_w(WK))
        fetch_b(kt_begin + nxt);
      else
        load_b(nxt % CORE_STAGES, kt_begin + nxt);
    }
    cp_async_commit();
    compute(i % CORE_STAGES);
    if constexpr (narrow_w(WK)) {
      if (more) store_b(nxt % CORE_STAGES);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- split K: the last block of a tile adds every split's sums --------
  // Scratch holds, per tile and split, the block's accumulators in thread
  // order (CORE_TM G 16-byte vectors a thread, a warp's stores contiguous).
  if (gridDim.z > 1) {
    constexpr int PART = CORE_BM * BN / 4;     // vectors per tile and split
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    V4* const part = reinterpret_cast<V4*>(ws) +
                     static_cast<size_t>(tile) * gridDim.z * PART + tid;
#pragma unroll
    for (int i = 0; i < CORE_TM; ++i)
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
        __stcg(part + blockIdx.z * PART + (G * i + gg) * CORE_THREADS,
               Vec4<ACC>::make(acc[i][4 * gg], acc[i][4 * gg + 1],
                               acc[i][4 * gg + 2], acc[i][4 * gg + 3]));
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(tile_counts + tile, 1) == static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // in split order 0, 1, ...: the same bits whichever block is last
#pragma unroll
    for (int i = 0; i < CORE_TM; ++i)
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        V4 s = __ldcg(part + (G * i + gg) * CORE_THREADS);
        for (int z = 1; z < static_cast<int>(gridDim.z); ++z) {
          const V4 v = __ldcg(part + z * PART + (G * i + gg) * CORE_THREADS);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        acc[i][4 * gg] = s.x;
        acc[i][4 * gg + 1] = s.y;
        acc[i][4 * gg + 2] = s.z;
        acc[i][4 * gg + 3] = s.w;
      }
    if (tid == 0) tile_counts[tile] = 0;
  }

  // ---- epilogue: counts, then the output values, in place -------------
  // one column at a time, so the counters add 8 registers
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = 4 * tx + (j & 3) + 64 * (j >> 2);
    int cnt[CORE_TM];
#pragma unroll
    for (int i = 0; i < CORE_TM; ++i) cnt[i] = 0;
    if (staged) {
      for (int l = 0; l < L; ++l) {
        const ACC tv = Ts[l * BN + col];
#pragma unroll
        for (int i = 0; i < CORE_TM; ++i) cnt[i] += acc[i][j] >= tv;
      }
    } else if (n0 + col < N) {
      const ACC* const row = t + static_cast<size_t>(n0 + col) * L;
      if (bsearch) {
#pragma unroll
        for (int i = 0; i < CORE_TM; ++i) cnt[i] = count_sorted(row, L, acc[i][j]);
      } else {
        for (int l = 0; l < L; ++l) {
          const ACC tv = __ldg(row + l);
#pragma unroll
          for (int i = 0; i < CORE_TM; ++i) cnt[i] += acc[i][j] >= tv;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CORE_TM; ++i) {
      if constexpr (std::is_same<ACC, float>::value) {
        // three separately rounded float32 operations, as the reference
        // computes them: no contraction into an FMA
        acc[i][j] = __fadd_rn(
            __fmul_rn(out_scale, __fadd_rn(out_base_f, static_cast<float>(cnt[i]))),
            out_bias);
      } else {
        acc[i][j] = out_base_i + cnt[i];
      }
    }
  }

  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < CORE_TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const int gn = n0 + 4 * tx + 64 * gg;
      ACC* const dst = out + static_cast<size_t>(gm) * N + gn;
      if (vec_out && gn < N) {
        *reinterpret_cast<V4*>(dst) =
            Vec4<ACC>::make(acc[i][4 * gg], acc[i][4 * gg + 1],
                            acc[i][4 * gg + 2], acc[i][4 * gg + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gn + c < N) dst[c] = acc[i][4 * gg + c];
      }
    }
  }
}

template <typename ACC, int WK, int BN>
int launch_core(const ACC* x, const ConvGeom& g, bool a_vec, const void* w,
                bool w_vec, const ACC* t, ACC* out, ACC* ws, int* tile_counts,
                int M, int K, int N, int L, bool bsearch, int splits,
                int out_base_i, float out_base_f, float out_scale,
                float out_bias, cudaStream_t stream) {
  using Tile = CoreTile<BN>;
  auto kern = mvau_core_kernel<ACC, WK, BN>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int KT = std::max(1, (K + CORE_BK - 1) / CORE_BK);
  splits = std::max(1, std::min(splits, KT));
  const int per = (KT + splits - 1) / splits;
  splits = (KT + per - 1) / per;          // no split left without a K-tile
  if (splits > 1 && (ws == nullptr || tile_counts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + CORE_BM - 1) / CORE_BM, (N + BN - 1) / BN, splits);
  const int smem =
      (Tile::RING + Tile::ROWS + (!bsearch && L <= DENSE_MAX_L ? BN * L : 0)) *
      4;
  kern<<<grid, CORE_THREADS, smem, stream>>>(
      x, g, a_vec, w, w_vec, t, out, ws, tile_counts, M, K, N, L, bsearch, per,
      out_base_i, out_base_f, out_scale, out_bias);
  return static_cast<int>(cudaGetLastError());
}

// the tile width N asks for, and the widest copies C, N and the operands'
// alignment allow
template <typename ACC, int WK>
int launch_core_any(const void* x, const ConvGeom& g, const void* w,
                    const void* t, void* out, void* ws, int* tile_counts,
                    int M, int K, int N, int L, bool bsearch, int splits,
                    int out_base_i, float out_base_f, float out_scale,
                    float out_bias, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const bool a_vec = g.C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_align = WK == W_I8 ? 4 : WK == W_I16 ? 8 : WK == W_PACKED4 ? 2 : 16;
  const bool w_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % w_align == 0;
  const ACC* xp = static_cast<const ACC*>(x);
  const ACC* tp = static_cast<const ACC*>(t);
  ACC* op = static_cast<ACC*>(out);
  ACC* wsp = static_cast<ACC*>(ws);
  if (N <= 64)
    return launch_core<ACC, WK, 64>(xp, g, a_vec, w, w_vec, tp, op, wsp,
                                    tile_counts, M, K, N, L, bsearch, splits,
                                    out_base_i, out_base_f, out_scale,
                                    out_bias, stream);
  return launch_core<ACC, WK, 128>(xp, g, a_vec, w, w_vec, tp, op, wsp,
                                   tile_counts, M, K, N, L, bsearch, splits,
                                   out_base_i, out_base_f, out_scale, out_bias,
                                   stream);
}

}  // namespace

// This file builds as three objects, compiled side by side: as it stands,
// every entry point but the plane route's; with REPRO_MVAU_PLANES defined
// (mvau_planes.cu), the plane route's entry point and its uint8 and 16-bit
// kinds; with REPRO_MVAU_PLANES24 too (mvau_planes24.cu), its kinds for
// codes of 17 to 24 bits.  Six instantiations of mvau_conv_kernel's plane
// route took as long to compile as the rest of the file together.
#ifndef REPRO_MVAU_PLANES

// Integer MVAU (mvau_int_pallas), GEMM form, on the int8 tensor cores.
// x: (M, K) int8 codes.  w_kind: 0 = int8 codes (K, N), 3 = packed int4
// (K, N/2).  t: (N, L) int32, each row sorted ascending when L > 64.
// out: (M, N) int32.  splits > 1 splits K and needs ws (output tiles x
// splits x 128 x 128 int32) and tile_counts (one zeroed int per output
// tile, left zeroed).  Wider codes take repro_mvau_core_conv.  Returns
// cudaGetLastError.
extern "C" int repro_mvau_int(const void* x, const void* w, int w_kind,
                              const int32_t* t, int32_t* out, int M, int K,
                              int N, int L, int out_base, int splits,
                              int32_t* ws, int* tile_counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bs = L > DENSE_MAX_L;
  const Epilogue e = int_epilogue(out_base);
  if (w_kind == W_I8)
    return launch_conv_any<W_I8, EPI_INT>(x, gemm_geom(M, K), w, t, out, ws,
                                          tile_counts, M, K, N, L, bs, splits,
                                          e, s);
  if (w_kind == W_PACKED4)
    return launch_conv_any<W_PACKED4, EPI_INT>(x, gemm_geom(M, K), w, t, out,
                                               ws, tile_counts, M, K, N, L, bs,
                                               splits, e, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same integer MVAU in GEMM form at decode shapes (mvau_small_m_kernel):
// operands as for repro_mvau_int; L at most 2048 (the block's threshold
// rows fit shared memory), each row sorted ascending when L > 64.  No K
// split, no scratch.  kernels/mvau.py sends a launch here where M is at
// most its route limit.  Returns cudaGetLastError.
extern "C" int repro_mvau_int_small_m(const void* x, const void* w,
                                      int w_kind, const int32_t* t,
                                      int32_t* out, int M, int K, int N,
                                      int L, int out_base, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 0 || L > SM_MAX_L || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_kind == W_I8)
    return launch_small_m<W_I8>(x, w, t, out, M, K, N, L, out_base, s);
  if (w_kind == W_PACKED4)
    return launch_small_m<W_PACKED4>(x, w, t, out, M, K, N, L, out_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// An empty kernel on blocks x threads: what a launch costs with no work, the
// floor beside which chip_smoke.py reads the small-M kernel's time.
extern "C" int repro_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

#endif  // REPRO_MVAU_PLANES

namespace {

// the conv form's geometry, or false where the window does not fit
bool conv_geom(int B, int H, int W, int C, int kernel, int stride, int pad,
               ConvGeom* g) {
  if (B < 0 || H < 1 || W < 1 || C < 1 || kernel < 1 || stride < 1 ||
      pad < 0 || H + 2 * pad < kernel || W + 2 * pad < kernel)
    return false;
  *g = ConvGeom{H, W, C, kernel, kernel, stride, pad,
                (H + 2 * pad - kernel) / stride + 1,
                (W + 2 * pad - kernel) / stride + 1};
  return true;
}

#ifndef REPRO_MVAU_PLANES
int launch_int_conv(const void* x, const void* w, int w_kind,
                    const int32_t* t, void* out, int B, const ConvGeom& g,
                    int N, int L, int splits, int32_t* ws, int* tile_counts,
                    const Epilogue& e, cudaStream_t s) {
  const int M = B * g.OH * g.OW;
  const int K = g.KH * g.KW * g.C;
  const bool bs = L > DENSE_MAX_L;
  if (w_kind == W_I8)
    return launch_conv_any<W_I8, EPI_INT>(x, g, w, t, out, ws, tile_counts, M,
                                          K, N, L, bs, splits, e, s);
  if (w_kind == W_PACKED4)
    return launch_conv_any<W_PACKED4, EPI_INT>(x, g, w, t, out, ws,
                                               tile_counts, M, K, N, L, bs,
                                               splits, e, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

#else  // REPRO_MVAU_PLANES

// the plane route's operands, as repro_mvau_int_planes_conv takes them
#define REPRO_PLANES_PARAMS                                                  \
  const void *x, const void *w, const int32_t *t, const int32_t *skip,       \
      int32_t *out, int B, int H, int W, int C, int kernel, int stride,      \
      int pad, int N, int L, int out_base, int splits, int32_t *ws,          \
      int *tile_counts, void *stream
#define REPRO_PLANES_ARGS                                                    \
  x, w, t, skip, out, B, H, W, C, kernel, stride, pad, N, L, out_base,       \
      splits, ws, tile_counts, stream

// one launch of plane kind PL
template <int PL>
int launch_planes(REPRO_PLANES_PARAMS) {
  ConvGeom g;
  if (!conv_geom(B, H, W, C, kernel, stride, pad, &g) || L < 0 ||
      (skip != nullptr && 16 % (g.OH * g.OW) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = kernel * kernel * C;
  if (Planes<PL>::PB && K > PLANE_MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue e = skip != nullptr
                         ? int_epilogue(out_base, skip, g.OH * g.OW)
                         : int_epilogue(out_base);
  return launch_conv_any<W_I8, EPI_INT, PL>(
      x, g, w, t, out, ws, tile_counts, B * g.OH * g.OW, K, N, L,
      L > DENSE_MAX_L, splits, e, static_cast<cudaStream_t>(stream));
}

#endif  // REPRO_MVAU_PLANES

}  // namespace

#ifndef REPRO_MVAU_PLANES

// Integer MVAU in conv form: the im2col node folded into the kernel.
// x: (B, H, W, C) int8 NHWC codes.  w_kind: 0 = int8 (K, N), 3 = packed
// int4 (K, N/2), K = kernel * kernel * C in patch order (kh, kw, c).
// t: (N, L) int32, sorted ascending when L > 64.  out: (B, OH, OW, N) int32.
// splits, ws, tile_counts as for repro_mvau_int with M = B * OH * OW.
extern "C" int repro_mvau_int_conv(const void* x, const void* w, int w_kind,
                                   const int32_t* t, int32_t* out, int B,
                                   int H, int W, int C, int kernel,
                                   int stride, int pad, int N, int L,
                                   int out_base, int splits, int32_t* ws,
                                   int* tile_counts, void* stream) {
  ConvGeom g;
  if (!conv_geom(B, H, W, C, kernel, stride, pad, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_int_conv(x, w, w_kind, t, out, B, g, N, L, splits, ws,
                         tile_counts, int_epilogue(out_base),
                         static_cast<cudaStream_t>(stream));
}

// The same conv-form MVAU with the residual add and GlobalAccPool that
// follow it folded into its epilogue:
//   out[b, n] = sum_{oh, ow} (out_base + count[b, oh, ow, n]
//                             + skip[b, oh, ow, n])
// in int32 arithmetic that wraps.  skip: (B, OH, OW, N) int32.  out: (B, N)
// int32; the (B, OH, OW, N) codes are never written.  OH * OW must divide
// 16 (an image's rows then lie inside one warp's 16).  Other operands as
// for repro_mvau_int_conv.
extern "C" int repro_mvau_int_conv_gap(const void* x, const void* w,
                                       int w_kind, const int32_t* t,
                                       const int32_t* skip, int32_t* out,
                                       int B, int H, int W, int C, int kernel,
                                       int stride, int pad, int N, int L,
                                       int out_base, int splits, int32_t* ws,
                                       int* tile_counts, void* stream) {
  ConvGeom g;
  if (!conv_geom(B, H, W, C, kernel, stride, pad, &g) || skip == nullptr ||
      16 % (g.OH * g.OW) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_int_conv(x, w, w_kind, t, out, B, g, N, L, splits, ws,
                         tile_counts, int_epilogue(out_base, skip, g.OH * g.OW),
                         static_cast<cudaStream_t>(stream));
}

#elif defined(REPRO_MVAU_PLANES24)

// The X3 kinds of the plane route (codes of 17 to 24 bits), reached through
// repro_mvau_int_planes_conv and built as an object of their own
// (mvau_planes24.cu) beside the entry point's, so that the two compile side
// by side.  x_unsigned: the codes' top plane is u8, else s8.
extern "C" int repro_mvau_int_planes24(int x_unsigned, int w_planes,
                                       REPRO_PLANES_PARAMS) {
  if (w_planes == 2)
    return x_unsigned ? launch_planes<PL_X3W2U>(REPRO_PLANES_ARGS)
                      : launch_planes<PL_X3W2>(REPRO_PLANES_ARGS);
  if (w_planes == 1)
    return x_unsigned ? launch_planes<PL_X3W1U>(REPRO_PLANES_ARGS)
                      : launch_planes<PL_X3W1>(REPRO_PLANES_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

#else  // REPRO_MVAU_PLANES

extern "C" int repro_mvau_int_planes24(int x_unsigned, int w_planes,
                                       REPRO_PLANES_PARAMS);

// The integer conv-form MVAU for codes that do not fit int8, on the int8
// tensor cores (mvau_conv_kernel's PL_U8 and byte-plane routes), with the
// plain epilogue (skip == nullptr; out (B, OH, OW, N) int32) or the
// GlobalAccPool one (skip (B, OH, OW, N) int32, out (B, N) int32, OH * OW
// dividing 16), as repro_mvau_int_conv and repro_mvau_int_conv_gap.
// x_kind 1: x (B, H, W, C) uint8 codes 0..255 against w (K, N) int8
// (w_planes 0).  x_kind 2 and 3: x (B, H, W, C) int16, the low 16 bits of
// each code, whose high byte is signed (2) or unsigned (3: codes up to
// 65535).  x_kind 4 and 5: x (B, H, W, C) int32 codes of up to 24 bits,
// their third byte signed (4: -2^23 .. 2^23 - 1) or unsigned (5: up to
// 2^24 - 1); the fourth byte is not read.  With x_kind 2 to 5, w is
// (w_planes, N, Kp) int8, the weights' byte planes K-major, Kp = K rounded
// up to a multiple of 16, zero past K: w_planes 2 for 16-bit weights (low
// byte, high byte), 1 for int8 weights (the codes); K at most
// PLANE_MAX_K.  t: (N, L) int32, sorted ascending when L > 64.  splits,
// ws, tile_counts as for repro_mvau_int_conv.  The GEMM form (M, K) is B =
// 1, H = M, W = 1, C = K, kernel 1, stride 1, pad 0.  Returns
// cudaGetLastError, or cudaErrorInvalidValue for any other kind.
extern "C" int repro_mvau_int_planes_conv(
    const void* x, int x_kind, const void* w, int w_planes, const int32_t* t,
    const int32_t* skip, int32_t* out, int B, int H, int W, int C,
    int kernel, int stride, int pad, int N, int L, int out_base, int splits,
    int32_t* ws, int* tile_counts, void* stream) {
  const bool xu = x_kind == 3 || x_kind == 5;
  if (x_kind == 1 && w_planes == 0)
    return launch_planes<PL_U8>(REPRO_PLANES_ARGS);
  if ((x_kind == 2 || x_kind == 3) && w_planes == 2)
    return xu ? launch_planes<PL_X2W2U>(REPRO_PLANES_ARGS)
              : launch_planes<PL_X2W2>(REPRO_PLANES_ARGS);
  if ((x_kind == 2 || x_kind == 3) && w_planes == 1)
    return xu ? launch_planes<PL_X2W1U>(REPRO_PLANES_ARGS)
              : launch_planes<PL_X2W1>(REPRO_PLANES_ARGS);
  if (x_kind == 4 || x_kind == 5)
    return repro_mvau_int_planes24(xu, w_planes, REPRO_PLANES_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // REPRO_MVAU_PLANES

#ifndef REPRO_MVAU_PLANES

// The CUDA-core MVAU in conv form: the float MVAU (mvau_pallas), and the
// integer MVAU (mvau_int_pallas) for codes that do not fit int8.  The GEMM
// form (M, K) is B = 1, H = M, W = 1, C = K, kernel 1, stride 1, pad 0.
// x: (B, H, W, C) NHWC, float32 (x_float = 1) or int32 codes.  w: (K, N)
// in patch order (kh, kw, c): w_kind 2 = float32 (with float x), or 0 =
// int8, 4 = int16, 1 = int32 codes, 3 = packed int4 (K, N/2).  t: (N, L),
// float32 or int32 as x; an int32 table longer than 64 levels must have
// each row sorted ascending (it is binary-searched).  out: (B, OH, OW, N),
// float32 out_scale * (out_base_f + count) + out_bias, or int32 out_base_i
// + count.  splits > 1 splits K and needs ws (output tiles x splits x 128 x
// BN words, BN = 64 where N <= 64, else 128) and tile_counts (one zeroed
// int per output tile, left zeroed).  Returns cudaGetLastError.
extern "C" int repro_mvau_core_conv(const void* x, int x_float, const void* w,
                                    int w_kind, const void* t, void* out,
                                    int B, int H, int W, int C, int kernel,
                                    int stride, int pad, int N, int L,
                                    int out_base_i, float out_base_f,
                                    float out_scale, float out_bias,
                                    int splits, void* ws, int* tile_counts,
                                    void* stream) {
  ConvGeom g;
  if (!conv_geom(B, H, W, C, kernel, stride, pad, &g) || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * g.OH * g.OW;
  const int K = kernel * kernel * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_float) {
    if (w_kind != W_F32) return static_cast<int>(cudaErrorInvalidValue);
    return launch_core_any<float, W_F32>(x, g, w, t, out, ws, tile_counts, M,
                                         K, N, L, false, splits, 0, out_base_f,
                                         out_scale, out_bias, s);
  }
  const bool bs = L > DENSE_MAX_L;
  switch (w_kind) {
    case W_I8:
      return launch_core_any<int, W_I8>(x, g, w, t, out, ws, tile_counts, M,
                                        K, N, L, bs, splits, out_base_i, 0.f,
                                        1.f, 0.f, s);
    case W_I16:
      return launch_core_any<int, W_I16>(x, g, w, t, out, ws, tile_counts, M,
                                         K, N, L, bs, splits, out_base_i, 0.f,
                                         1.f, 0.f, s);
    case W_I32:
      return launch_core_any<int, W_I32>(x, g, w, t, out, ws, tile_counts, M,
                                         K, N, L, bs, splits, out_base_i, 0.f,
                                         1.f, 0.f, s);
    case W_PACKED4:
      return launch_core_any<int, W_PACKED4>(x, g, w, t, out, ws, tile_counts,
                                             M, K, N, L, bs, splits,
                                             out_base_i, 0.f, 1.f, 0.f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// mvau_pallas's int8 x int8 sub-path: int32 accumulation against int32
// thresholds, float32 output; dense count, as the float MVAU; no split.
extern "C" int repro_mvau_i8(const int8_t* x, const int8_t* w,
                             const int32_t* t, float* out, int M, int K, int N,
                             int L, float out_base, float out_scale,
                             float out_bias, void* stream) {
  const Epilogue e{0, out_base, out_scale, out_bias, nullptr, 0};
  return launch_conv_any<W_I8, EPI_FLOAT>(x, gemm_geom(M, K), w, t, out,
                                          nullptr, nullptr, M, K, N, L, false,
                                          1, e,
                                          static_cast<cudaStream_t>(stream));
}

#endif  // REPRO_MVAU_PLANES
