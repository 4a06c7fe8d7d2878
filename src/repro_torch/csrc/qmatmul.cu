// Weight-only quantized matmul for Hopper (sm_90a): w8a16 and w4a16.
//
// Replaces, in the JAX package:
//   src/repro/kernels/qmatmul.py  qmatmul_pallas (_qmm_kernel)
//
// What it computes, per output element (m, n):
//   acc = sum_k bf16(x[m, k]) * code[k, n]        (float32)
//   out = (acc * scale[n]) cast to x's dtype (float32 or bf16)
// code is an int8 (w8), or a 4-bit two's-complement nibble (w4: packed
// byte [k, j] holds column 2j in its low nibble and 2j + 1 in its high
// one).  Every product bf16 x code is exact in float32 (8 + 8 significant
// bits), so the kernel and the plain version differ only in the order in
// which the float32 sum is taken.
//
// What bounds it on this card: in LM decode M is the batch (1 to 8 rows)
// and K, N are in the thousands, so each weight byte serves M rows: about
// 2M operations per byte at w8, far below the ridge of any unit.  An ideal
// kernel is bound by the bytes of the codes: 2.77 GB per Qwen2.5-3B decode
// step at w8, 0.83 ms at 3.35 TB/s.
//
// What this design does about it: it streams the weights once, on the
// CUDA cores, and keeps everything else on chip.
// * A block owns BN = 64 output columns and a K slice.  Its 256 threads
//   are 8 columns wide and 32 rows deep: thread (tk, tc) reads 8 columns
//   (8 bytes at w8, 4 packed bytes at w4) of rows tk, tk + 32, ..., with
//   UNROLL row loads in flight before it computes; neighbouring threads
//   read neighbouring bytes.
// * The block's rows of x (MT <= 8 of them) are staged in shared memory as
//   float32 already rounded to bf16, KC rows of K at a time, laid out
//   [k][m] so that one 16-byte shared load gives four rows' values.
// * Codes become float32 without a conversion instruction: a byte with its
//   sign bit flipped, placed in the low mantissa of 2^23, is 2^23 + 128 + c
//   (a nibble likewise with 8), and one subtraction leaves c exactly.
// * The 32 partial sums of each column are added in a fixed order through
//   shared memory, so the result does not depend on scheduling.
// * When the column tiles alone would leave SMs idle (decode's projections
//   with N = 256 or 2048), the wrapper splits K over grid.y: each split
//   writes its float32 sums into scratch that the wrapper allocated, and a
//   second kernel adds the splits in order, scales and casts.
// Ragged M, N and K are masked in the kernel; nothing is padded.
// Left for later: tensor cores (mma/wgmma), TMA and a pipelined ring of
// weight tiles, and fusing the bias add and the next cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;          // output columns per block
constexpr int CPT = 8;          // columns per thread
constexpr int TC = BN / CPT;    // threads across the columns: 8
constexpr int THREADS = 256;
constexpr int TK = THREADS / TC;  // threads down K: 32
constexpr int KC = 256;         // rows of K staged per shared-memory chunk
constexpr int UNROLL = 8;       // weight-row loads in flight per thread
static_assert(TK * UNROLL <= KC, "one unrolled sweep must fit a chunk");

__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Raw code bytes of row k, columns c0 .. c0 + 7 (zero where masked).
template <int BITS, bool VEC>
__device__ __forceinline__ void load_row(const int8_t* __restrict__ w, int N,
                                         int k, int c0, bool valid,
                                         uint32_t (&raw)[2]) {
  raw[0] = 0u;
  raw[1] = 0u;
  if (!valid) return;
  if (BITS == 8) {
    const int8_t* row = w + static_cast<size_t>(k) * N;
    if (VEC) {
      if (c0 < N) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + c0));
        raw[0] = v.x;
        raw[1] = v.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (c0 + j < N) {
          const uint32_t b = static_cast<uint8_t>(__ldg(row + c0 + j));
          raw[j >> 2] |= b << (8 * (j & 3));
        }
      }
    }
  } else {
    const int np = N >> 1;  // packed bytes per row
    const int p0 = c0 >> 1;
    const int8_t* row = w + static_cast<size_t>(k) * np;
    if (VEC) {
      if (p0 < np) raw[0] = __ldg(reinterpret_cast<const uint32_t*>(row + p0));
    } else {
#pragma unroll
      for (int j = 0; j < CPT / 2; ++j) {
        if (p0 + j < np) {
          const uint32_t b = static_cast<uint8_t>(__ldg(row + p0 + j));
          raw[0] |= b << (8 * j);
        }
      }
    }
  }
}

// The 8 codes of a row as exact float32 values.
template <int BITS>
__device__ __forceinline__ void codes_to_f32(const uint32_t (&raw)[2],
                                             float (&f)[CPT]) {
  if (BITS == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t u = raw[h] ^ 0x80808080u;  // c + 128 in each byte
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[4 * h + i] =
            __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + i)) -
            8388736.0f;  // 2^23 + 128
    }
  } else {
    const uint32_t u = raw[0] ^ 0x88888888u;  // c + 8 in each nibble
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      f[q] = __int_as_float(0x4B000000u | ((u >> (4 * q)) & 0xFu)) -
             8388616.0f;  // 2^23 + 8
  }
}

template <int BITS, typename XT, int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
    qmm_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, XT* __restrict__ out,
               float* __restrict__ partial, int M, int K, int N,
               int k_per_split) {
  constexpr int RM = MT < 4 ? MT : 4;  // rows reduced per round
  __shared__ __align__(16) float xs[KC * MT];
  __shared__ float red[TK * RM * BN];

  const int tid = threadIdx.x;
  const int tc = tid % TC;
  const int tk = tid / TC;
  const int n0 = blockIdx.x * BN;
  const int c0 = n0 + tc * CPT;
  const int m0 = blockIdx.z * MT;
  const int kb = blockIdx.y * k_per_split;
  const int ke = min(K, kb + k_per_split);

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

  for (int kc = kb; kc < ke; kc += KC) {
    const int kn = min(KC, ke - kc);
    for (int i = tid; i < KC * MT; i += THREADS) {
      const int m = i / KC;
      const int kk = i % KC;
      float v = 0.f;
      if (kk < kn && m0 + m < M)
        v = bf16_value(x[static_cast<size_t>(m0 + m) * K + kc + kk]);
      xs[kk * MT + m] = v;
    }
    __syncthreads();
    for (int kk0 = 0; kk0 < kn; kk0 += TK * UNROLL) {
      uint32_t raw[UNROLL][2];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kk = kk0 + u * TK + tk;
        load_row<BITS, VEC>(w, N, kc + kk, c0, kk < kn, raw[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kk = kk0 + u * TK + tk;
        if (kk < kn) {
          float f[CPT];
          codes_to_f32<BITS>(raw[u], f);
          const float* xr = xs + kk * MT;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xr[m];
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[m][j] = fmaf(xv, f[j], acc[m][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Column sums over the 32 K-groups, in order tk = 0, 1, ..., 31.
  const int col = tid % BN;
  const int rm = tid / BN;
  const int n = n0 + col;
#pragma unroll
  for (int r = 0; r < MT / RM; ++r) {
#pragma unroll
    for (int mm = 0; mm < RM; ++mm)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        red[(tk * RM + mm) * BN + tc * CPT + j] = acc[r * RM + mm][j];
    __syncthreads();
    if (rm < RM) {
      float s = 0.f;
      for (int t = 0; t < TK; ++t) s += red[(t * RM + rm) * BN + col];
      const int m = m0 + r * RM + rm;
      if (m < M && n < N) {
        if (gridDim.y == 1)
          out[static_cast<size_t>(m) * N + n] =
              from_f32<XT>(__fmul_rn(s, scale[n]));
        else
          partial[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

// Split-K epilogue: add the splits' sums in order, scale, cast.
template <typename XT>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  XT* __restrict__ out, int M, int N,
                                  int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(M) * N;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * total + i];
  out[i] = from_f32<XT>(__fmul_rn(s, scale[i % N]));
}

template <int BITS, typename XT, int MT>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           float* partial, int M, int K, int N, int splits, int k_per_split,
           cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, splits, (M + MT - 1) / MT);
  const bool vec = N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % (BITS == 8 ? 8 : 4) == 0;
  const XT* xx = static_cast<const XT*>(x);
  XT* oo = static_cast<XT*>(out);
  if (vec)
    qmm_kernel<BITS, XT, MT, true><<<grid, THREADS, 0, s>>>(
        xx, w, scale, oo, partial, M, K, N, k_per_split);
  else
    qmm_kernel<BITS, XT, MT, false><<<grid, THREADS, 0, s>>>(
        xx, w, scale, oo, partial, M, K, N, k_per_split);
  if (splits > 1) {
    const size_t total = static_cast<size_t>(M) * N;
    const int blocks = static_cast<int>((total + THREADS - 1) / THREADS);
    qmm_reduce_kernel<XT><<<blocks, THREADS, 0, s>>>(partial, scale, oo, M, N,
                                                     splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename XT>
int launch_mt(const void* x, const int8_t* w, const float* scale, void* out,
              float* partial, int M, int K, int N, int mt, int splits,
              int k_per_split, cudaStream_t s) {
  switch (mt) {
    case 1:
      return launch<BITS, XT, 1>(x, w, scale, out, partial, M, K, N, splits,
                                 k_per_split, s);
    case 2:
      return launch<BITS, XT, 2>(x, w, scale, out, partial, M, K, N, splits,
                                 k_per_split, s);
    case 4:
      return launch<BITS, XT, 4>(x, w, scale, out, partial, M, K, N, splits,
                                 k_per_split, s);
    case 8:
      return launch<BITS, XT, 8>(x, w, scale, out, partial, M, K, N, splits,
                                 k_per_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K) float32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w (K, N) int8 codes
// (bits = 8) or (K, N / 2) packed int4 (bits = 4); scale (N,) float32;
// out (M, N) of x's type.  mt in {1, 2, 4, 8} rows per block; K is split
// into `splits` slices of k_per_split rows, and when splits > 1, partial
// is (splits, M, N) float32 scratch.  Returns cudaGetLastError().
extern "C" int repro_qmatmul(const void* x, int x_bf16, const int8_t* w,
                             int bits, const float* scale, void* out,
                             float* partial, int M, int K, int N, int mt,
                             int splits, int k_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || splits < 1 || k_per_split < 1 ||
      (splits > 1 && partial == nullptr) || (bits == 4 && N % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8 && x_bf16 == 0)
    return launch_mt<8, float>(x, w, scale, out, partial, M, K, N, mt, splits,
                               k_per_split, s);
  if (bits == 8 && x_bf16 == 1)
    return launch_mt<8, __nv_bfloat16>(x, w, scale, out, partial, M, K, N, mt,
                                       splits, k_per_split, s);
  if (bits == 4 && x_bf16 == 0)
    return launch_mt<4, float>(x, w, scale, out, partial, M, K, N, mt, splits,
                               k_per_split, s);
  if (bits == 4 && x_bf16 == 1)
    return launch_mt<4, __nv_bfloat16>(x, w, scale, out, partial, M, K, N, mt,
                                       splits, k_per_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
