// Matrix-Vector-Activation Unit for Hopper (sm_90a): a matrix product whose
// epilogue counts threshold crossings, FINN's MVAU.
//
// Replaces, in the JAX package:
//   src/repro/kernels/mvau.py  mvau_int_pallas (_mvau_int_kernel,
//                              _unpack_int4_block)   integer datapath, here
//                              in conv form too (the im2col node folded in)
//   src/repro/kernels/mvau.py  mvau_pallas (_mvau_kernel)   float datapath,
//                              with its int8 x int8 -> int32 sub-path
//
// What it computes, per output element (m, n):
//   acc   = sum_k x[m, k] * w[k, n]          (int32, or float32 for floats)
//   count = #{ l : acc >= T[n, l] }
//   int datapath:   out = out_base + count                       (int32)
//   float datapath: out = out_scale * (out_base + count) + out_bias (float32)
// In conv form x[m, :] is the patch row of output pixel m = (b, oh, ow),
// read straight from the NHWC activation: the patch tensor never exists.
// Only the narrow result is written; the accumulator never leaves registers
// (or, under split K, int32 scratch that stays in the 50 MB L2).
//
// What bounds it on this card.  The conv-form integer MVAU must read the
// activation once, the weights and tables once and write the int32 codes:
// at the w6a4 ResNet-9's shapes at batch 64 that is about 154 MB per
// forward (two thirds of it the int32 output), 0.046 ms at 3.35 TB/s,
// against 48.5 G int8 operations, 0.025 ms at 1,979 TOP/s: bound by bytes,
// chiefly the int32 codes written.  The float MVAU on the CUDA cores (67
// TFLOP/s) is bound by operations.  chip_smoke.py computes both bounds from
// each run's shapes.
//
// What this design does about it, and what it leaves for later:
// * int8 activations x int8 (or packed int4) weights -- every layer of the
//   w6a4 int artifact -- run one tensor-core kernel (mvau_conv_kernel
//   below): implicit-GEMM A loads by cp.async with zero-fill halos, a
//   4-stage shared-memory ring in the 64-byte swizzle, wgmma m64n64k32
//   (s8.s8.s32) with both operands read from shared memory, and split K
//   inside one launch where the output tiles are fewer than the SMs.  The
//   GEMM form (M, K) is the 1 x 1 conv of the same loader, and the float
//   MVAU's int8 x int8 sub-path is the same kernel with a float epilogue.
// * everything else (int32 codes, float32, int32 weights) runs a CUDA-core
//   kernel: 64 x 64 tile, 4 x 4 accumulators a thread, int32 multiply-add
//   or float32 FMA (never TF32).
// Measured on the H100 (PERF.md), the tensor-core kernel is bound by
// instruction issue, not by bytes or the tensor cores: the dense threshold
// count (2 instructions per level and output) issues about half of a
// tile's instructions, the B transposes and the loop's barrier most of the
// rest; removing the MMAs or all operand loads saves little.  Left: int8
// codes out of the epilogue (a third of the bytes), the 2 x 2 maxpool and
// the residual add fused into it, a 128 x 64 tile for N <= 64, persistent
// blocks to hide each tile's prologue.
// The epilogue counts short tables (L <= 64, every layer of the w6a4
// artifact: L = 15) densely from shared memory.  Longer tables (8- to
// 16-bit activations, L = 255 to 65535) are binary-searched per output in
// global memory, where the block's rows stay in L1/L2: ceil(log2(L + 1))
// loads instead of L compares.  That needs each row sorted ascending, which
// the integer lowering guarantees for every mvau_int table (``t_sorted``);
// the float MVAU's tables carry no such guarantee, so it always counts
// densely.  Ragged M, N and K edges are masked in the kernels; nothing is
// padded with sentinel thresholds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction depth per shared-memory tile
constexpr int LC = 64;        // threshold levels staged per epilogue chunk
constexpr int TM = 4;         // rows per thread: ty + 16 * i
constexpr int TN = 4;         // columns per thread: tx + 16 * j
constexpr int THREADS = 256;  // 16 x 16
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

enum WKind { W_I8 = 0, W_I32 = 1, W_F32 = 2, W_PACKED4 = 3 };

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
  } else if constexpr (WK == W_I32) {
    return static_cast<ACC>(
        static_cast<const int32_t*>(w)[static_cast<size_t>(k) * N + n]);
  } else {
    return static_cast<ACC>(
        static_cast<const float*>(w)[static_cast<size_t>(k) * N + n]);
  }
}

template <typename XT, int WK, typename ACC, bool FLOAT_OUT>
__global__ void __launch_bounds__(THREADS)
mvau_tile_kernel(const XT* __restrict__ x, const void* __restrict__ w,
                 const ACC* __restrict__ t, void* __restrict__ out, int M,
                 int K, int N, int L, bool bsearch, int out_base_i,
                 float out_base_f, float out_scale, float out_bias) {
  __shared__ ACC As[BK][BM + 1];   // x tile, K-major; +1 avoids bank conflicts
  __shared__ ACC Bs[BK][BN];       // w tile
  __shared__ ACC Ts[BN][LC + 1];   // threshold chunk, one row per column

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  ACC acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = ACC(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      As[c][r] = (gm < M && gk < K)
                     ? static_cast<ACC>(x[static_cast<size_t>(gm) * K + gk])
                     : ACC(0);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? load_w<ACC, WK>(w, gk, gn, N) : ACC(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      ACC a[TM];
      ACC b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  int cnt[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) cnt[i][j] = 0;

  if (bsearch) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) {
        const ACC* row = t + static_cast<size_t>(gn) * L;
#pragma unroll
        for (int i = 0; i < TM; ++i) cnt[i][j] = count_sorted(row, L, acc[i][j]);
      }
    }
  }
  for (int l0 = 0; !bsearch && l0 < L; l0 += LC) {
    const int lc = min(LC, L - l0);
    for (int e = tid; e < BN * LC; e += THREADS) {
      const int r = e / LC;
      const int c = e % LC;
      const int gn = n0 + r;
      if (gn < N && c < lc) Ts[r][c] = t[static_cast<size_t>(gn) * L + l0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tx + 16 * j;
      if (n0 + col < N) {
        for (int l = 0; l < lc; ++l) {
          const ACC tv = Ts[col][l];
#pragma unroll
          for (int i = 0; i < TM; ++i) cnt[i][j] += (acc[i][j] >= tv) ? 1 : 0;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const size_t o = static_cast<size_t>(gm) * N + gn;
      if constexpr (FLOAT_OUT) {
        // three separately rounded float32 operations, as the reference
        // computes them: no contraction into an FMA
        const float y = __fadd_rn(
            __fmul_rn(out_scale,
                      __fadd_rn(out_base_f, static_cast<float>(cnt[i][j]))),
            out_bias);
        static_cast<float*>(out)[o] = y;
      } else {
        static_cast<int32_t*>(out)[o] = out_base_i + cnt[i][j];
      }
    }
  }
}

template <typename XT, int WK, typename ACC, bool FLOAT_OUT>
int launch(const void* x, const void* w, const void* t, void* out, int M,
           int K, int N, int L, bool bsearch, int out_base_i, float out_base_f,
           float out_scale, float out_bias, cudaStream_t stream) {
  if (M > 0 && N > 0) {
    dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    mvau_tile_kernel<XT, WK, ACC, FLOAT_OUT><<<grid, THREADS, 0, stream>>>(
        static_cast<const XT*>(x), w, static_cast<const ACC*>(t), out, M, K, N,
        L, bsearch, out_base_i, out_base_f, out_scale, out_bias);
  }
  return static_cast<int>(cudaGetLastError());
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
// row stride ts_stride(L) words
constexpr int TC_SMEM_MAX = TC_RING + TC_BN * 65 * 4;          // 98,816 B
constexpr int TC_MI = 2;   // 64-row wgmma blocks a thread's accumulators span
constexpr int TC_NJ = 8;   // 8-column accumulator tiles of a warpgroup

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

// D (64 x 64, s32) += A (64 x 32, s8) B (32 x 64, s8), both from shared memory
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[8][4], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(da), "l"(db)
      : "memory");
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

template <int VEC, int WK, bool FLOAT_OUT>
__global__ void __launch_bounds__(TC_THREADS, 2)
mvau_conv_kernel(const int8_t* __restrict__ x, ConvGeom g,
                 const void* __restrict__ w, bool w_vec,
                 const int32_t* __restrict__ t, void* __restrict__ out,
                 int32_t* __restrict__ ws, int* __restrict__ tile_counts,
                 int M, int K, int N, int L, bool bsearch, int kt_per_split,
                 int out_base_i, float out_base_f, float out_scale,
                 float out_bias) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int s_last;
  uint8_t* const As = smem;
  uint8_t* const Bs = smem + TC_STAGES * TC_BM * TC_BK;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // warpgroup wg computes all 128 rows x columns 64 wg .. 64 wg + 63 with
  // wgmma m64n64k32 (two 64-row blocks); its warp wq owns rows 16 wq .. +15
  // of each block
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const int m0 = blockIdx.x * TC_BM;
  const int n0 = blockIdx.y * TC_BN;
  const int KT = max(1, (K + TC_BK - 1) / TC_BK);
  const int kt_begin = blockIdx.z * kt_per_split;
  const int nkt = min(KT, kt_begin + kt_per_split) - kt_begin;

  // ---- A: rows a_row and a_row + 64, 16-byte segment a_seg of each ------
  const int a_row = tid >> 2;
  const int a_seg = (tid & 3) * 16;
  int a_img[2], a_ih[2], a_iw[2];
  {
    const int ohw = g.OH * g.OW;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
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

  // acc[i][j][2 h + c]: row 64 i + 16 wq + gq + 8 h, column 64 wg + 8 j +
  // 2 q + c, the wgmma m64nNk32 accumulator layout
  int acc[TC_MI][TC_NJ][4];
#pragma unroll
  for (int i = 0; i < TC_MI; ++i)
#pragma unroll
    for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

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
      for (int i = 0; i < TC_MI; ++i)
        wgmma_m64n64k32(acc[i], wgmma_desc(a_sm + stage * TC_BM * TC_BK +
                                           i * 64 * TC_BK + 32 * kk),
                        db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    warpgroup_fence(acc);
  };

  // ---- mainloop: A tiles i+1 .. i+3 in flight (cp.async) while the tensor
  // cores consume tile i; B tile i+3 in registers, stored into shared
  // memory one iteration later, so its load latency hides behind a tile.
  // The threshold block goes first, with A tile 0: its latency hides
  // behind the mainloop.
  const bool staged = !bsearch && L <= DENSE_MAX_L;
  const int LS = ts_stride(L);
  int32_t* const Ts = reinterpret_cast<int32_t*>(smem + TC_RING);
  if (staged) {
    for (int e = tid; e < TC_BN * L; e += TC_THREADS) {
      const int c = e / L;
      const int l = e - c * L;
      const bool ok = n0 + c < N;
      cp_async4(smem_u32(Ts + c * LS + l),
                ok ? t + static_cast<size_t>(n0 + c) * L + l : t, ok);
    }
  }
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
  cp_async_wait<0>();
  __syncthreads();

  const int wm = 16 * wq;     // row of acc[i][..] = wm + 64 i + gq + 8 h
  const int wn = 64 * wg;     // column of acc[..][j] = wn + 8 j + 2 q + c

  // ---- split K: the last block of a tile adds the other splits' sums ----
  // Scratch holds, per tile and split, the block's accumulators in thread
  // order (16 int4 a thread, a warp's stores contiguous): no bounds, no
  // index arithmetic, and the last block reads them back the same way.
  if (gridDim.z > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int4* const part = reinterpret_cast<int4*>(ws) +
        (static_cast<size_t>(tile) * gridDim.z) * (TC_BM * TC_BN / 4);
#pragma unroll
    for (int i = 0; i < TC_MI; ++i)
#pragma unroll
      for (int j = 0; j < TC_NJ; ++j)
        __stcg(part + blockIdx.z * (TC_BM * TC_BN / 4) +
                   (TC_NJ * i + j) * TC_THREADS + tid,
               make_int4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                         acc[i][j][3]));
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(tile_counts + tile, 1) == static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int z = 0; z < static_cast<int>(gridDim.z); ++z) {
      if (z == static_cast<int>(blockIdx.z)) continue;
      int4 v[TC_MI][TC_NJ];
#pragma unroll
      for (int i = 0; i < TC_MI; ++i)
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j)
          v[i][j] = __ldcg(part + z * (TC_BM * TC_BN / 4) +
                           (TC_NJ * i + j) * TC_THREADS + tid);
#pragma unroll
      for (int i = 0; i < TC_MI; ++i)
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
#pragma unroll
  for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int col = wn + 8 * j + 2 * q + cc;
      const int gn = n0 + col;
      if (gn >= N) continue;
      int cnt[TC_MI][2];
#pragma unroll
      for (int i = 0; i < TC_MI; ++i) cnt[i][0] = cnt[i][1] = 0;
      if (bsearch) {
        const int32_t* row = t + static_cast<size_t>(gn) * L;
#pragma unroll
        for (int i = 0; i < TC_MI; ++i)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            cnt[i][rr] = count_sorted(row, L, acc[i][j][2 * rr + cc]);
      } else if (staged) {
        const int32_t* row = Ts + col * LS;
#pragma unroll 5
        for (int l = 0; l < L; ++l) {
          const int tv = row[l];
#pragma unroll
          for (int i = 0; i < TC_MI; ++i)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              cnt[i][rr] = count_ge(cnt[i][rr], acc[i][j][2 * rr + cc], tv);
        }
      } else {
        const int32_t* row = t + static_cast<size_t>(gn) * L;
        for (int l = 0; l < L; ++l) {
          const int tv = __ldg(row + l);
#pragma unroll
          for (int i = 0; i < TC_MI; ++i)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              cnt[i][rr] = count_ge(cnt[i][rr], acc[i][j][2 * rr + cc], tv);
        }
      }
#pragma unroll
      for (int i = 0; i < TC_MI; ++i)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) acc[i][j][2 * rr + cc] = cnt[i][rr];
    }

  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < TC_MI; ++i)
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
        if constexpr (FLOAT_OUT) {
          // three separately rounded float32 operations, as the reference
          // computes them: no contraction into an FMA
          const float y0 = __fadd_rn(
              __fmul_rn(out_scale, __fadd_rn(out_base_f, static_cast<float>(c0))),
              out_bias);
          const float y1 = __fadd_rn(
              __fmul_rn(out_scale, __fadd_rn(out_base_f, static_cast<float>(c1))),
              out_bias);
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
                make_int2(out_base_i + c0, out_base_i + c1);
          } else {
            if (gn < N) dst[0] = out_base_i + c0;
            if (gn + 1 < N) dst[1] = out_base_i + c1;
          }
        }
      }
    }
}

template <int VEC, int WK, bool FLOAT_OUT>
int launch_conv(const int8_t* x, const ConvGeom& g, const void* w,
                const int32_t* t, void* out, int32_t* ws, int* tile_counts,
                int M, int K, int N, int L, bool bsearch, int splits,
                int out_base_i, float out_base_f, float out_scale,
                float out_bias, cudaStream_t stream) {
  auto kern = mvau_conv_kernel<VEC, WK, FLOAT_OUT>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
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
  dim3 grid((M + TC_BM - 1) / TC_BM, (N + TC_BN - 1) / TC_BN, splits);
  const int smem = TC_RING + (!bsearch && L <= DENSE_MAX_L
                                  ? TC_BN * ts_stride(L) * 4 : 0);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      x, g, w, w_vec, t, out, ws, tile_counts, M, K, N, L, bsearch, per,
      out_base_i, out_base_f, out_scale, out_bias);
  return static_cast<int>(cudaGetLastError());
}

// the widest A copy that C and the activation's alignment allow
template <int WK, bool FLOAT_OUT>
int launch_conv_any(const void* x, const ConvGeom& g, const void* w,
                    const int32_t* t, void* out, int32_t* ws,
                    int* tile_counts, int M, int K, int N, int L,
                    bool bsearch, int splits, int out_base_i,
                    float out_base_f, float out_scale, float out_bias,
                    cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (g.C % 16 == 0 && xa % 16 == 0)
    return launch_conv<16, WK, FLOAT_OUT>(xp, g, w, t, out, ws, tile_counts,
                                          M, K, N, L, bsearch, splits,
                                          out_base_i, out_base_f, out_scale,
                                          out_bias, stream);
  if (g.C % 4 == 0 && xa % 4 == 0)
    return launch_conv<4, WK, FLOAT_OUT>(xp, g, w, t, out, ws, tile_counts, M,
                                         K, N, L, bsearch, splits, out_base_i,
                                         out_base_f, out_scale, out_bias,
                                         stream);
  return launch_conv<1, WK, FLOAT_OUT>(xp, g, w, t, out, ws, tile_counts, M,
                                       K, N, L, bsearch, splits, out_base_i,
                                       out_base_f, out_scale, out_bias,
                                       stream);
}

// the GEMM form (M, K) as a 1 x 1 conv over an M x 1 image of K channels
ConvGeom gemm_geom(int M, int K) {
  return ConvGeom{M, 1, std::max(K, 1), 1, 1, 1, 0, M, 1};
}

}  // namespace

// Integer MVAU (mvau_int_pallas), GEMM form.  x_kind: 0 = int8, 1 = int32
// codes.  w_kind: 0 = int8 codes (K, N), 1 = int32 codes (K, N), 3 = packed
// int4 (K, N/2).  t: (N, L) int32, each row sorted ascending when L > 64.
// out: (M, N) int32.  splits > 1 splits K on the tensor cores and needs
// ws (output tiles x splits x 128 x 128 int32) and tile_counts (one zeroed
// int per output tile, left zeroed).  Returns cudaGetLastError.
extern "C" int repro_mvau_int(const void* x, int x_kind, const void* w,
                              int w_kind, const int32_t* t, int32_t* out,
                              int M, int K, int N, int L, int out_base,
                              int splits, int32_t* ws, int* tile_counts,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bs = L > DENSE_MAX_L;
  if (x_kind == 0) {
    if (w_kind == W_I8)
      return launch_conv_any<W_I8, false>(x, gemm_geom(M, K), w, t, out, ws,
                                          tile_counts, M, K, N, L, bs, splits,
                                          out_base, 0.f, 1.f, 0.f, s);
    if (w_kind == W_I32)
      return launch<int8_t, W_I32, int32_t, false>(
          x, w, t, out, M, K, N, L, bs, out_base, 0.f, 1.f, 0.f, s);
    if (w_kind == W_PACKED4)
      return launch_conv_any<W_PACKED4, false>(
          x, gemm_geom(M, K), w, t, out, ws, tile_counts, M, K, N, L, bs,
          splits, out_base, 0.f, 1.f, 0.f, s);
  } else if (x_kind == 1) {
    if (w_kind == W_I8)
      return launch<int32_t, W_I8, int32_t, false>(
          x, w, t, out, M, K, N, L, bs, out_base, 0.f, 1.f, 0.f, s);
    if (w_kind == W_I32)
      return launch<int32_t, W_I32, int32_t, false>(
          x, w, t, out, M, K, N, L, bs, out_base, 0.f, 1.f, 0.f, s);
    if (w_kind == W_PACKED4)
      return launch<int32_t, W_PACKED4, int32_t, false>(
          x, w, t, out, M, K, N, L, bs, out_base, 0.f, 1.f, 0.f, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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
  if (B < 0 || H < 1 || W < 1 || C < 1 || kernel < 1 || stride < 1 ||
      pad < 0 || H + 2 * pad < kernel || W + 2 * pad < kernel)
    return static_cast<int>(cudaErrorInvalidValue);
  const int OH = (H + 2 * pad - kernel) / stride + 1;
  const int OW = (W + 2 * pad - kernel) / stride + 1;
  const ConvGeom g{H, W, C, kernel, kernel, stride, pad, OH, OW};
  const int M = B * OH * OW;
  const int K = kernel * kernel * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bs = L > DENSE_MAX_L;
  if (w_kind == W_I8)
    return launch_conv_any<W_I8, false>(x, g, w, t, out, ws, tile_counts, M,
                                        K, N, L, bs, splits, out_base, 0.f,
                                        1.f, 0.f, s);
  if (w_kind == W_PACKED4)
    return launch_conv_any<W_PACKED4, false>(x, g, w, t, out, ws, tile_counts,
                                             M, K, N, L, bs, splits, out_base,
                                             0.f, 1.f, 0.f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Float MVAU (mvau_pallas).  x, w float32; t (N, L) float32; out float32.
// Counts densely: its tables need not be sorted.
extern "C" int repro_mvau_f32(const float* x, const float* w, const float* t,
                              float* out, int M, int K, int N, int L,
                              float out_base, float out_scale, float out_bias,
                              void* stream) {
  return launch<float, W_F32, float, true>(x, w, t, out, M, K, N, L, false, 0,
                                           out_base, out_scale, out_bias,
                                           static_cast<cudaStream_t>(stream));
}

// mvau_pallas's int8 x int8 sub-path: int32 accumulation against int32
// thresholds, float32 output; dense count, as the float MVAU; no split.
extern "C" int repro_mvau_i8(const int8_t* x, const int8_t* w,
                             const int32_t* t, float* out, int M, int K, int N,
                             int L, float out_base, float out_scale,
                             float out_bias, void* stream) {
  return launch_conv_any<W_I8, true>(x, gemm_geom(M, K), w, t, out, nullptr,
                                     nullptr, M, K, N, L, false, 1, 0,
                                     out_base, out_scale, out_bias,
                                     static_cast<cudaStream_t>(stream));
}
