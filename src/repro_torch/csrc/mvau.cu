// Matrix-Vector-Activation Unit for Hopper (sm_90a): a matrix product whose
// epilogue counts threshold crossings, FINN's MVAU.
//
// Replaces, in the JAX package:
//   src/repro/kernels/mvau.py  mvau_int_pallas (_mvau_int_kernel,
//                              _unpack_int4_block)   integer datapath
//   src/repro/kernels/mvau.py  mvau_pallas (_mvau_kernel)   float datapath,
//                              with its int8 x int8 -> int32 sub-path
//
// What it computes, per output element (m, n):
//   acc   = sum_k x[m, k] * w[k, n]          (int32, or float32 for floats)
//   count = #{ l : acc >= T[n, l] }
//   int datapath:   out = out_base + count                       (int32)
//   float datapath: out = out_scale * (out_base + count) + out_bias (float32)
// Only the narrow result is written; the accumulator never leaves registers.
//
// What bounds it on this card: at the main path's shapes (K = 27 .. 4608,
// N = 64 .. 512, M = batch x 16 .. 1024) the integer layers do roughly 10
// to 530 operations per byte of x, w, T and out, below the int8
// tensor-core ridge of about 590 (1,979 TOP/s over 3.35 TB/s): an ideal
// integer MVAU is bound by bytes, chiefly the int8 activations read and the
// int32 codes written.  The float datapath on the CUDA cores (67 TFLOP/s,
// ridge about 20) is bound by operations.  chip_smoke.py computes both
// bounds from each run's shapes.
//
// What this design does about it, and what it leaves for later.  Two
// kernels share one epilogue design:
// * int8 activations x int8 (or packed int4) weights — every layer of the
//   w6a4 int artifact — run on the int8 tensor cores through mma.sync
//   m16n8k32 (s8.s8.s32), block tile 64 x 128, K in 64-deep shared-memory
//   tiles; packed int4 weights are unpacked while the tile loads (low
//   nibble = even output channel), so they cross device memory at half the
//   bytes.
// * everything else (int32 codes, float32, int32 weights) runs a CUDA-core
//   kernel: 64 x 64 tile, 4 x 4 accumulators a thread, int32 multiply-add
//   or float32 FMA (never TF32).
// The epilogue counts short tables (L <= 64, every layer of the w6a4
// artifact: L = 15) densely, staging the threshold block in shared memory
// in chunks of levels.  Longer tables (8- to 16-bit activations, L = 255 to
// 65535) are binary-searched per output in global memory, where the block's
// rows stay in L1/L2: ceil(log2(L + 1)) loads instead of L compares.  That
// needs each row sorted ascending, which the integer lowering guarantees for
// every mvau_int table (``t_sorted``); the float MVAU's tables carry no
// such guarantee, so it always counts densely.  Ragged M, N and K edges are
// masked in the kernels; nothing is padded with sentinel thresholds.
// Operand tiles load byte by byte with no pipelining: TMA, wgmma and a ring
// of tiles in flight are the next steps, measured against these.

#include <cuda_runtime.h>
#include <stdint.h>

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
// int8 x int8 on the tensor cores: mma.sync m16n8k32 (s8, s8 -> s32).
// Taken whenever the activations arrive as int8 and the weights as int8 or
// packed int4 (the main path: every layer of the w6a4 int artifact).  Block
// tile 64 x 128 x 64; 8 warps as 2 (M) x 4 (N), each owning a 32 x 32
// sub-tile = 2 x 4 mma tiles of 16 x 8.  A is kept row-major and B
// column-major (k contiguous) in shared memory, rows padded to 80 bytes so
// the 4-byte fragment loads of a warp hit 32 distinct banks.
// ---------------------------------------------------------------------------
constexpr int MMA_BM = 64;
constexpr int MMA_BN = 128;
constexpr int MMA_BK = 64;
constexpr int MMA_PAD = 16;        // bytes of padding per shared-memory row
constexpr int MMA_LC = 32;         // threshold levels per epilogue chunk

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int WK, bool FLOAT_OUT>
__global__ void __launch_bounds__(THREADS)
mvau_mma_kernel(const int8_t* __restrict__ x, const void* __restrict__ w,
                const int32_t* __restrict__ t, void* __restrict__ out, int M,
                int K, int N, int L, bool bsearch, int out_base_i,
                float out_base_f, float out_scale, float out_bias) {
  __shared__ __align__(16) int8_t As[MMA_BM][MMA_BK + MMA_PAD];
  __shared__ __align__(16) int8_t Bs[MMA_BN][MMA_BK + MMA_PAD];
  __shared__ int32_t Ts[MMA_BN][MMA_LC + 1];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;          // fragment row group
  const int q = lane % 4;          // thread within the group
  const int wm = (warp % 2) * 32;  // warp's row offset in the block tile
  const int wn = (warp / 2) * 32;  // warp's column offset
  const int m0 = blockIdx.x * MMA_BM;
  const int n0 = blockIdx.y * MMA_BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += MMA_BK) {
#pragma unroll
    for (int i = 0; i < (MMA_BM * MMA_BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / MMA_BK;
      const int c = e % MMA_BK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk]
                                    : int8_t(0);
    }
#pragma unroll
    for (int i = 0; i < (MMA_BK * MMA_BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / MMA_BN;
      const int c = e % MMA_BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      Bs[c][r] = (gk < K && gn < N)
                     ? static_cast<int8_t>(load_w<int, WK>(w, gk, gn, N))
                     : int8_t(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 32) {
      int a[2][4];
      int b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const int*>(&As[r][kk + q * 4]);
        a[i][1] = *reinterpret_cast<const int*>(&As[r + 8][kk + q * 4]);
        a[i][2] = *reinterpret_cast<const int*>(&As[r][kk + 16 + q * 4]);
        a[i][3] = *reinterpret_cast<const int*>(&As[r + 8][kk + 16 + q * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        b[j][0] = *reinterpret_cast<const int*>(&Bs[c][kk + q * 4]);
        b[j][1] = *reinterpret_cast<const int*>(&Bs[c][kk + 16 + q * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0],
                 b[j][1]);
    }
    __syncthreads();
  }

  // accumulator element r of tile (i, j): row wm + 16 i + g + 8 (r / 2),
  // column wn + 8 j + 2 q + (r % 2)
  int cnt[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) cnt[i][j][r] = 0;

  if (bsearch) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int gn = n0 + wn + j * 8 + 2 * q + cc;
        if (gn < N) {
          const int32_t* row = t + static_cast<size_t>(gn) * L;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              cnt[i][j][2 * rr + cc] =
                  count_sorted(row, L, acc[i][j][2 * rr + cc]);
        }
      }
  }
  for (int l0 = 0; !bsearch && l0 < L; l0 += MMA_LC) {
    const int lc = min(MMA_LC, L - l0);
    for (int e = tid; e < MMA_BN * MMA_LC; e += THREADS) {
      const int r = e / MMA_LC;
      const int c = e % MMA_LC;
      const int gn = n0 + r;
      if (gn < N && c < lc) Ts[r][c] = t[static_cast<size_t>(gn) * L + l0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = wn + j * 8 + 2 * q + cc;
        if (n0 + col < N) {
          for (int l = 0; l < lc; ++l) {
            const int tv = Ts[col][l];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr)
                cnt[i][j][2 * rr + cc] += (acc[i][j][2 * rr + cc] >= tv) ? 1 : 0;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm + 16 * i + g + 8 * (r / 2);
        const int gn = n0 + wn + 8 * j + 2 * q + (r % 2);
        if (gm >= M || gn >= N) continue;
        const size_t o = static_cast<size_t>(gm) * N + gn;
        if constexpr (FLOAT_OUT) {
          static_cast<float*>(out)[o] = __fadd_rn(
              __fmul_rn(out_scale,
                        __fadd_rn(out_base_f, static_cast<float>(cnt[i][j][r]))),
              out_bias);
        } else {
          static_cast<int32_t*>(out)[o] = out_base_i + cnt[i][j][r];
        }
      }
}

template <int WK, bool FLOAT_OUT>
int launch_mma(const void* x, const void* w, const int32_t* t, void* out,
               int M, int K, int N, int L, bool bsearch, int out_base_i,
               float out_base_f, float out_scale, float out_bias,
               cudaStream_t stream) {
  if (M > 0 && N > 0) {
    dim3 grid((M + MMA_BM - 1) / MMA_BM, (N + MMA_BN - 1) / MMA_BN);
    mvau_mma_kernel<WK, FLOAT_OUT><<<grid, THREADS, 0, stream>>>(
        static_cast<const int8_t*>(x), w, t, out, M, K, N, L, bsearch,
        out_base_i, out_base_f, out_scale, out_bias);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Integer MVAU (mvau_int_pallas).  x_kind: 0 = int8, 1 = int32 codes.
// w_kind: 0 = int8 codes (K, N), 1 = int32 codes (K, N), 3 = packed int4
// (K, N/2).  t: (N, L) int32, each row sorted ascending when L > 64.
// out: (M, N) int32.  Returns cudaGetLastError.
extern "C" int repro_mvau_int(const void* x, int x_kind, const void* w,
                              int w_kind, const int32_t* t, int32_t* out,
                              int M, int K, int N, int L, int out_base,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bs = L > DENSE_MAX_L;
  if (x_kind == 0) {
    if (w_kind == W_I8)
      return launch_mma<W_I8, false>(x, w, t, out, M, K, N, L, bs, out_base,
                                     0.f, 1.f, 0.f, s);
    if (w_kind == W_I32)
      return launch<int8_t, W_I32, int32_t, false>(
          x, w, t, out, M, K, N, L, bs, out_base, 0.f, 1.f, 0.f, s);
    if (w_kind == W_PACKED4)
      return launch_mma<W_PACKED4, false>(x, w, t, out, M, K, N, L, bs,
                                          out_base, 0.f, 1.f, 0.f, s);
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
// thresholds, float32 output; dense count, as the float MVAU.
extern "C" int repro_mvau_i8(const int8_t* x, const int8_t* w,
                             const int32_t* t, float* out, int M, int K, int N,
                             int L, float out_base, float out_scale,
                             float out_bias, void* stream) {
  return launch_mma<W_I8, true>(x, w, t, out, M, K, N, L, false, 0, out_base,
                                out_scale, out_bias,
                                static_cast<cudaStream_t>(stream));
}
