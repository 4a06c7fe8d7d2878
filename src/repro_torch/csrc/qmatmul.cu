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
// Two kernels compute it, one per regime; the wrapper
// (kernels/qmatmul.py, qmm_route) picks one per shape.
//
// Decode (qmm_kernel).  What bounds it on this card: in LM decode M is the
// batch (1 to 8 rows) and K, N are in the thousands, so each weight byte
// serves M rows: about 2M operations per byte at w8, far below the ridge
// of any unit.  An ideal kernel is bound by the bytes of the codes: 2.77 GB
// per Qwen2.5-3B decode step at w8 (0.83 ms at 3.35 TB/s), half that at w4.
//
// Many rows (qmm_rows_kernel, below qmm_kernel).  What bounds it: at
// whisper's encoder (M 6,000, K and N 384 or 1,536) each code serves
// thousands of rows and each x row hundreds of columns, so the work is
// 2MKN operations on the bf16 tensor cores (7.1 GFLOP, 7.2 us at 989
// TFLOP/s, for K 384 x N 1,536) and the bytes of x and out (4.6 MB each
// at N 384, 2.8 us); the decode kernel, re-streaming and re-decoding every
// code for each 8 rows, ran at 4-7% of that.  What the design does about
// it: tiles of 128 output columns by 128 (or 64) rows of x on bf16 wgmma,
// each code read from shared memory and decoded once per tile, straight
// into the A operand's registers (swap-AB, x the B operand from shared
// memory), the decode of one K step overlapping the tensor cores' work on
// the previous one; see its section.
//
// What the decode design does about its bound: it keeps enough weight
// bytes in flight to cover the DRAM latency, and spends few instructions
// per code.
// * A block (256 threads, 8 warps) owns BN = 64 or 128 output columns, up
//   to 8 rows of x and a K slice.  Its column tile streams through a ring
//   of STAGES = 3 shared-memory stages of 16 KB of codes each (KS rows of
//   K: 128 at w8 and BN = 128, up to 512 at w4 and BN = 64), filled by
//   16-byte cp.async.cg; two stages (32 KB) are in flight while the block
//   computes the third, at w4 as at w8 (a w4 stage spans twice the rows),
//   and an SM holds two blocks.
//   Each row is padded by 16 bytes, so the fragment reads below hit
//   distinct banks.  One __syncthreads per stage, before the next copies
//   are issued: none stands between issuing a stage and computing an
//   earlier one.
// * x is staged once per block in bf16 ([row][k], padded rows), its chunks
//   copied in the same cp.async group as the stage of weights that first
//   reads them (bf16 x, K a multiple of 8), or converted by plain loads
//   (float32 x, ragged K) before the first stage is computed.
// * The products run on the bf16 tensor cores, mma.sync m16n8k16 with
//   float32 accumulators, in swap-AB form: the weight tile (16 output
//   columns x 16 of K) is A, x^T (16 of K x 8 rows of x, zero past M) is B.
//   A thread reads its CPT = BN / 8 columns of rows 2t, 2t+1, 2t+8, 2t+9
//   of a 16-row step (16, 8 or 4 bytes a row) and pairs consecutive rows
//   of one column with byte permutes; MMA row g of tile i is column
//   CPT g + 2i, row g + 8 column CPT g + 2i + 1, so a thread's accumulators
//   hold 2 rows of x x CPT contiguous columns.
// * Codes become bf16 exactly with bit operations into the mantissa of a
//   biased bf16 and one bf16x2 FMA: a nibble n gives 0x4300 | (n ^ 8) =
//   136 + c, minus 136.  A byte cannot (bf16 has 8 significant bits, the
//   biased byte needs 9), so it is split: (128 + (c & 127)) - (128 +
//   (c & 128)) = c, both operands exact bf16, their difference exact.
// * The 8 warps split each stage's 16-row steps; at the end their sums are
//   added in warp order through shared memory (the ring's space), then
//   scaled and cast.  Where the column tiles alone would leave SMs idle,
//   K is split over grid.y within this one launch: each split writes its
//   float32 sums to scratch, and the last block of a column tile to arrive
//   (a per-tile counter that block resets; one thread fences for the
//   block) adds the splits in split order, scales and casts.  The order of
//   every sum is fixed, so repeated calls give identical bits.
// Ragged M, N and K are masked in the kernel (zero-filled copies past K
// and past N); N not a multiple of 16 bytes takes byte loads into the same
// ring.  Left for later: overlapping a call's first copies with the
// previous kernel (programmatic dependent launch), and one launch for the
// projections that share x (q/k/v, gate/up).
//
// Measurement builds: -DQMM_NO_MMA drops the tensor-core MMAs and
// -DQMM_NO_COPY the weight copies of both kernels, -DQMR_NO_XCOPY the x
// copies and -DQMR_NO_DECODE the code decode of the many-row kernel (all
// compute wrong values), and -DQMM_CLOCK sums each decode block's clock64
// cycles per phase (thread 0); only tools/sweep_qmatmul_splits.py builds
// them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The block's geometry; the -D overrides exist for
// tools/sweep_qmatmul_splits.py --variants.
#ifndef QMM_WARPS
#define QMM_WARPS 8
#endif
#ifndef QMM_STAGES
#define QMM_STAGES 3
#endif
#ifndef QMM_STAGE_BYTES
#define QMM_STAGE_BYTES 16384
#endif
constexpr int WARPS = QMM_WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = QMM_STAGES;
constexpr int STAGE_BYTES = QMM_STAGE_BYTES;  // codes per ring stage
constexpr int PAD = 16;            // bytes after each staged row
constexpr int MT8 = 8;             // rows of x an MMA covers

#ifdef QMM_CLOCK
// cycles of thread 0 summed over blocks: prologue, waits, compute, warp
// sums and stores, split handshake, last block's sum; blocks, last blocks
__device__ unsigned long long g_qmm_cycles[8];
#define QMM_CLOCK_START long long qmm_t = clock64()
#define QMM_STAMP(i)                                                     \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long now = clock64();                                   \
      atomicAdd(&g_qmm_cycles[i], static_cast<unsigned long long>(now - qmm_t)); \
      qmm_t = now;                                                       \
    }                                                                    \
  } while (0)
#define QMM_COUNT(i)                                                     \
  do {                                                                   \
    if (threadIdx.x == 0) atomicAdd(&g_qmm_cycles[i], 1ull);             \
  } while (0)
#else
#define QMM_CLOCK_START
#define QMM_STAMP(i)
#define QMM_COUNT(i)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// d = a * b + c on bf16 pairs (exact whenever the result is)
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Two int8 codes (bytes 0 and 2 of w) as a bf16 pair, exactly.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const uint32_t lo = (w & 0x007F007Fu) | 0x43004300u;  // 128 + (c & 127)
  const uint32_t hi = (w & 0x00800080u) | 0x43004300u;  // 128 + (c & 128)
  return fma_bf16x2(hi, 0xBF80BF80u, lo);                // lo - hi
}

// Two int4 codes (bits 0-3 and 16-19 of w) as a bf16 pair, exactly.
__device__ __forceinline__ uint32_t i4x2_to_bf16x2(uint32_t w) {
  const uint32_t v = (w & 0x000F000Fu) ^ 0x43084308u;   // 136 + c
  return fma_bf16x2(v, 0x3F803F80u, 0xC308C308u);        // v * 1 - 136
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#ifndef QMM_NO_MMA
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#else
  d[0] += __int_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);
#endif
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
  return v;
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

template <int BITS, int BN>
struct Tile {
  static constexpr int ROW = BN * BITS / 8;         // code bytes of a row
  static constexpr int RS = ROW + PAD;              // staged row stride
  static constexpr int KS = STAGE_BYTES / ROW;      // rows of K per stage
  static constexpr int CHUNKS = ROW / 16;           // 16-byte copies a row
  static constexpr int CPT = BN / 8;                // columns per thread
  static constexpr int WPR = CPT * BITS / 32;       // 32-bit words a row
  static constexpr int NT = CPT / 2;                // m16 tiles per warp
  static constexpr int STEPS = KS / 16;             // MMA k-steps a stage
  static constexpr int CPJ = KS * CHUNKS / THREADS; // copies a thread issues
  static_assert(STEPS % WARPS == 0, "each warp takes whole k-steps");
  static_assert(THREADS % CHUNKS == 0 && CPJ * THREADS == KS * CHUNKS,
                "a thread copies whole chunks of one column range");
  static_assert(STAGES * KS * RS >= WARPS * MT8 * BN * 4,
                "the warp sums fit in the ring");
};

// The four k-rows (2t, 2t+1, 2t+8, 2t+9) of a thread's columns as A
// fragments of the NT m16 tiles.
template <int BITS, int BN>
__device__ __forceinline__ void a_fragments(const uint8_t* rows, int g, int t,
                                            uint32_t (&a)[Tile<BITS, BN>::NT][4]) {
  using T = Tile<BITS, BN>;
  uint32_t r[4][T::WPR];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int k = 2 * t + (h & 1) + 8 * (h >> 1);
    const uint8_t* p = rows + k * T::RS + g * (T::WPR * 4);
    if constexpr (T::WPR == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      r[h][0] = v.x;
      r[h][1] = v.y;
      r[h][2] = v.z;
      r[h][3] = v.w;
    } else if constexpr (T::WPR == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      r[h][0] = v.x;
      r[h][1] = v.y;
    } else {
      r[h][0] = *reinterpret_cast<const uint32_t*>(p);
    }
  }
#pragma unroll
  for (int i = 0; i < T::NT; ++i) {
    // columns j = 2i (MMA row g) and j + 1 (row g + 8) of the thread's CPT
#pragma unroll
    for (int h = 0; h < 2; ++h) {       // k-rows 2t, 2t+1 (h=0); +8, +9 (h=1)
      const uint32_t* r0 = r[2 * h];
      const uint32_t* r1 = r[2 * h + 1];
      uint32_t p0, p1;
      if constexpr (BITS == 8) {
        const int q = i / 2;              // word of columns 2i, 2i + 1
        const int b = 2 * (i % 2);        // their bytes b, b + 1
        // bytes 0, 2 <- column 2i of rows r0, r1; then column 2i + 1
        p0 = i8x2_to_bf16x2(__byte_perm(r0[q], r1[q], b | ((4 + b) << 8)));
        p1 = i8x2_to_bf16x2(
            __byte_perm(r0[q], r1[q], (b + 1) | ((5 + b) << 8)));
      } else {
        const int q = i / 4;              // word of 8 columns
        const int p = 2 * (i % 4);        // nibble of column 2i
        // nibbles 0-3 <- 4 columns of r0, 4-7 <- the same of r1
        const uint32_t w = __byte_perm(r0[q], r1[q], p < 4 ? 0x5410 : 0x7632);
        p0 = i4x2_to_bf16x2(w >> (4 * (p % 4)));
        p1 = i4x2_to_bf16x2(w >> (4 * (p % 4 + 1)));
      }
      a[i][2 * h] = p0;       // MMA row g:     k 2t, 2t+1 (+8)
      a[i][2 * h + 1] = p1;   // MMA row g + 8: the same k
    }
  }
}

template <int BITS, typename XT, int BN, bool VEC, bool VECX>
__global__ void __launch_bounds__(THREADS)
    qmm_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, XT* __restrict__ out,
               float* __restrict__ ws, int* __restrict__ tile_counts, int M,
               int K, int N, int mt, int k_per_split) {
  using T = Tile<BITS, BN>;
  QMM_CLOCK_START;
  QMM_COUNT(6);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  uint8_t* const ring = smem;
  __nv_bfloat16* const xs =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * T::KS * T::RS);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.z * mt;
  const int rows = min(mt, M - m0);
  const int kb = blockIdx.y * k_per_split;
  const int kn = min(K, kb + k_per_split) - kb;
  const int ntiles = (kn + T::KS - 1) / T::KS;
  const int XS = ntiles * T::KS + 8;        // staged x row stride (bf16)
  const int NB = N * BITS / 8;              // code bytes of a row of w
  const uint8_t* const wb = reinterpret_cast<const uint8_t*>(w);

  // A thread copies the same 16 bytes of columns (cb) of rows r0, r0 +
  // RSTEP, ... of every stage: its source advances by a stage's rows.
  constexpr int RSTEP = THREADS / T::CHUNKS;
  const int cb = (tid % T::CHUNKS) * 16;
  const int r0 = tid / T::CHUNKS;
  const int nb = n0 * BITS / 8 + cb;
  const bool col_ok = nb < NB;
  const uint8_t* const wsrc =
      wb + (col_ok ? static_cast<size_t>(kb + r0) * NB + nb : 0);
  const int kn16 = (kn + 15) & ~15;       // rows a k-step may read

  // copies of tile s of the K slice into ring stage st (plus x's chunks);
  // rows past the slice are zero-filled up to the end of their k-step and
  // not copied beyond it (no k-step reads them)
  auto load_tile = [&](int s, int st) {
    uint8_t* dst = ring + st * T::KS * T::RS + r0 * T::RS + cb;
#ifndef QMM_NO_COPY
#pragma unroll
    for (int j = 0; j < T::CPJ; ++j) {
      const int r = s * T::KS + r0 + j * RSTEP;   // row in the K slice
      if (r >= kn16) break;
      const bool ok = col_ok && r < kn;
      const uint8_t* src =
          ok ? wsrc + static_cast<size_t>(s * T::KS + j * RSTEP) * NB : wb;
      if constexpr (VEC) {
        cp_async16(smem_u32(dst + j * RSTEP * T::RS), src, ok);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (ok && nb + i < NB)
            v[i >> 2] |= static_cast<uint32_t>(__ldg(src + i)) << (8 * (i & 3));
        *reinterpret_cast<uint4*>(dst + j * RSTEP * T::RS) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
#endif
    if constexpr (VECX) {
      constexpr int XC = T::KS / 8;   // 16-byte chunks of a row's K tile
      for (int c = tid; c < rows * XC; c += THREADS) {
        const int m = c / XC;
        const int kk = s * T::KS + (c % XC) * 8;
        if (kk >= kn16) continue;
        const bool ok = kk < kn;
        cp_async16(smem_u32(xs + m * XS + kk),
                   x + (ok ? static_cast<size_t>(m0 + m) * K + kb + kk : 0),
                   ok);
      }
    }
  };

  // ---- prologue: STAGES - 1 tiles in flight ----
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  if constexpr (!VECX) {
    for (int i = tid; i < rows * ntiles * T::KS; i += THREADS) {
      const int m = i / (ntiles * T::KS);
      const int kk = i % (ntiles * T::KS);
      xs[m * XS + kk] = kk < kn ? to_bf16(x[static_cast<size_t>(m0 + m) * K +
                                            kb + kk])
                                : __float2bfloat16_rn(0.f);
    }
  }

  float acc[T::NT][4];
#pragma unroll
  for (int i = 0; i < T::NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // this thread's first output task (task = tid) has its scales loaded
  // while the block streams, off the epilogue's path
  constexpr int C4 = BN / 4;            // float4 chunks of a row
  // the scales of a task's 4 columns, loaded before its sums are ready
  auto scales = [&](int c4, float (&sc)[4]) {
    const int n = n0 + 4 * c4;
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = n + j < N ? __ldg(scale + n + j) : 0.f;
  };
  float sc_first[4];
  scales(tid % C4, sc_first);
  QMM_STAMP(0);

  // ---- mainloop ----
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    QMM_STAMP(1);
    if (it + STAGES - 1 < ntiles)
      load_tile(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint8_t* st = ring + (it % STAGES) * T::KS * T::RS;
#pragma unroll
    for (int j = 0; j < T::STEPS / WARPS; ++j) {
      const int step = warp + WARPS * j;
      const int kk = it * T::KS + 16 * step;   // row in the K slice
      if (kk >= kn) break;
      uint32_t b0 = 0u, b1 = 0u;
      if (g < rows) {
        const __nv_bfloat16* xr = xs + g * XS + kk + 2 * t;
        b0 = *reinterpret_cast<const uint32_t*>(xr);
        b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
      uint32_t a[T::NT][4];
      a_fragments<BITS, BN>(st + 16 * step * T::RS, g, t, a);
#pragma unroll
      for (int i = 0; i < T::NT; ++i) mma_bf16(acc[i], a[i], b0, b1);
    }
    QMM_STAMP(2);
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- the warps' sums, added in warp order (the ring's space) ----
  float* const red = reinterpret_cast<float*>(smem);   // [warp][row][BN]
  // thread (g, t): rows 2t, 2t + 1; columns CPT g + 2i (c0, c1), + 1 (c2, c3)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 2 * t + h;
    if (m < rows) {
      float* dst = red + (warp * MT8 + m) * BN + T::CPT * g;
#pragma unroll
      for (int i = 0; i < T::NT; ++i)
        *reinterpret_cast<float2*>(dst + 2 * i) =
            make_float2(acc[i][h], acc[i][2 + h]);
    }
  }
  __syncthreads();

  const int tasks = rows * C4;
  const bool split = gridDim.y > 1;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  float4* const part = reinterpret_cast<float4*>(ws) +
      static_cast<size_t>(tile) * gridDim.y * (MT8 * C4);
  auto store = [&](int m, int c4, float4 v, const float (&sc)[4]) {
    const float e[4] = {v.x, v.y, v.z, v.w};
    const int n = n0 + 4 * c4;
    XT* o = out + static_cast<size_t>(m0 + m) * N + n;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) o[j] = from_f32<XT>(__fmul_rn(e[j], sc[j]));
  };
  for (int task = tid; task < tasks; task += THREADS) {
    const int m = task / C4;
    const int c4 = task % C4;
    float sc[4] = {sc_first[0], sc_first[1], sc_first[2], sc_first[3]};
    if (!split && task != tid) scales(c4, sc);
    float4 v = reinterpret_cast<const float4*>(red)[m * C4 + c4];
#pragma unroll
    for (int wp = 1; wp < WARPS; ++wp) {
      const float4 u = reinterpret_cast<const float4*>(red)[(wp * MT8 + m) * C4 + c4];
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    if (split)
      __stcg(part + blockIdx.y * (MT8 * C4) + m * C4 + c4, v);
    else
      store(m, c4, v, sc);
  }
  QMM_STAMP(3);
  if (!split) return;

  // ---- split K: the last block of the tile adds the splits in order ----
  // One thread fences on the block's behalf after the barrier (release),
  // takes the count, and fences again before the barrier that lets the
  // block read the other splits' sums (acquire), as CUTLASS's semaphores do.
  __syncthreads();
  if (tid == 0) {
    fence_acq_rel_gpu();
    s_last = atomicAdd(tile_counts + tile, 1) == static_cast<int>(gridDim.y) - 1;
    fence_acq_rel_gpu();
  }
  __syncthreads();
  QMM_STAMP(4);
  if (!s_last) return;
  QMM_COUNT(7);
  for (int task = tid; task < tasks; task += THREADS) {
    const int m = task / C4;
    const int c4 = task % C4;
    float sc[4] = {sc_first[0], sc_first[1], sc_first[2], sc_first[3]};
    if (task != tid) scales(c4, sc);
    const float4* p = part + m * C4 + c4;
    const int S = static_cast<int>(gridDim.y);
    float4 v = __ldcg(p);
    int z = 1;
    for (; z + 4 <= S; z += 4) {        // 4 loads in flight, added in order
      float4 u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = __ldcg(p + static_cast<size_t>(z + i) * (MT8 * C4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v.x += u[i].x; v.y += u[i].y; v.z += u[i].z; v.w += u[i].w;
      }
    }
    for (; z < S; ++z) {
      const float4 u = __ldcg(p + static_cast<size_t>(z) * (MT8 * C4));
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    store(m, c4, v, sc);
  }
  if (tid == 0) tile_counts[tile] = 0;
  QMM_STAMP(5);
}

template <int BITS, typename XT, int BN, bool VEC, bool VECX>
int launch_one(const void* x, const int8_t* w, const float* scale, void* out,
               float* ws, int* counts, int M, int K, int N, int mt,
               int splits, int k_per_split, cudaStream_t s) {
  using T = Tile<BITS, BN>;
  const int ntiles = (k_per_split + T::KS - 1) / T::KS;
  const size_t smem = static_cast<size_t>(STAGES) * T::KS * T::RS +
                      static_cast<size_t>(mt) * (ntiles * T::KS + 8) * 2;
  auto kern = qmm_kernel<BITS, XT, BN, VEC, VECX>;
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const dim3 grid((N + BN - 1) / BN, splits, (M + mt - 1) / mt);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const XT*>(x), w, scale, static_cast<XT*>(out), ws, counts,
      M, K, N, mt, k_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename XT, int BN>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           float* ws, int* counts, int M, int K, int N, int mt, int splits,
           int k_per_split, cudaStream_t s) {
  const bool vec = (N * BITS / 8) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vecx = sizeof(XT) == 2 && K % 8 == 0 && k_per_split % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define QMM_LAUNCH(V, VX)                                                   \
  return launch_one<BITS, XT, BN, V, VX>(x, w, scale, out, ws, counts, M, K, \
                                         N, mt, splits, k_per_split, s)
  if (vec && vecx) QMM_LAUNCH(true, true);
  if (vec) QMM_LAUNCH(true, false);
  if (vecx) QMM_LAUNCH(false, true);
  QMM_LAUNCH(false, false);
#undef QMM_LAUNCH
}

template <int BITS, typename XT>
int launch_bn(const void* x, const int8_t* w, const float* scale, void* out,
              float* ws, int* counts, int M, int K, int N, int mt, int bn,
              int splits, int k_per_split, cudaStream_t s) {
  if (bn == 128)
    return launch<BITS, XT, 128>(x, w, scale, out, ws, counts, M, K, N, mt,
                                 splits, k_per_split, s);
  if (bn == 64)
    return launch<BITS, XT, 64>(x, w, scale, out, ws, counts, M, K, N, mt,
                                splits, k_per_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The many-row route: qmm_rows_kernel
// ---------------------------------------------------------------------------
// Swap-AB on wgmma, as the decode kernel is on mma.sync: the codes are the
// A operand, decoded into registers, and x is the B operand, read by the
// tensor cores from shared memory.  A block owns RBN = 128 output columns
// (two consumer warpgroups of 64, the wgmma's M) and BMX = 64, 80, 96 or
// 128 rows of x (the wgmma's N), and walks K in RBK = 64-row steps through
// a ring of RSTAGES = 4 stages: the x tile (bf16, 128-byte rows, the
// 128-byte swizzle of a K-major wgmma operand: 16-byte chunk c of row r at
// slot c ^ (r & 7)) and the raw code tile (RBN bytes a row at w8, RBN / 2
// at w4, padded by 16 bytes so the fragment reads below hit distinct
// banks).
// Each code is read from shared memory once and decoded once per block,
// into the registers of the one thread whose A fragment holds it; nothing
// decoded is written back.  Per step that is the x tile copied in and read
// twice by the tensor cores (once per warpgroup) and the raw codes copied
// in and read once: 64 KB of shared-memory traffic for 128 x 128 x 64
// products at w8, where a decoded bf16 B tile (written, then read by both
// warpgroups) took 96 KB and held the kernel to the shared memory's rate.
// A warpgroup's M row 16 w + g (warp w, lane group g) is output column
// 16 w + 2 g of its 64, and row 16 w + g + 8 column 16 w + 2 g + 1, so a
// thread's two columns are adjacent: one 16-bit read (w8) or one byte (w4)
// gives both columns of a K row.  Step it + 1's fragments are decoded while
// step it's wgmma runs (but on the byte-copy path, for want of registers);
// one barrier a step.  Two blocks fit on an SM.

constexpr int RBN = 128;                 // output columns a block owns
constexpr int RBK = 64;                  // rows of K a ring stage holds
constexpr int RTHREADS = 256;            // two warpgroups
#ifndef QMR_STAGES
#define QMR_STAGES 4
#endif
constexpr int RSTAGES = QMR_STAGES;      // 3 at least: two steps ahead
constexpr int RALIGN = 1024;             // a swizzle atom

template <int BITS, int BMX>
struct RTile {
  static constexpr int A_BYTES = BMX * RBK * 2;          // x tile in bf16
  static constexpr int RAW_ROW = RBN * BITS / 8;         // code bytes a row
  static constexpr int RS = RAW_ROW + 16;                // staged row stride
  static constexpr int RAW_BYTES = RBK * RS;
  static constexpr int STAGE = A_BYTES + RAW_BYTES;
  static constexpr int CH = RAW_ROW / 16;                // 16-byte copies a row
  static constexpr int NJ = BMX / 8;                     // 8-row groups of x
  static constexpr int SMEM = RALIGN + RSTAGES * STAGE;
  static_assert(STAGE % RALIGN == 0, "every stage's x tile on a swizzle atom");
  static_assert(RSTAGES >= 3, "steps it and it + 1 landed, one in flight");
};

// 16-byte chunk `c` of row `r` of a tile of 128-byte rows (128-byte swizzle)
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + (((c ^ r) & 7) << 4);
}

// wgmma shared-memory descriptor of the K-major x tile: 128-byte rows in
// the 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_x(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// keep the compiler from moving accumulator registers across wgmma
template <int NJ>
__device__ __forceinline__ void acc_fence(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(acc[j][r])::"memory");
}

// D (64 x 64, f32) += A (64 x 16, bf16, in registers) B (16 x 64, bf16,
// K-major in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[8][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db)
      : "memory");
}

// D (64 x 80, f32) += A (64 x 16, bf16, in registers) B (16 x 80, bf16,
// K-major in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_m64n80k16(float (&d)[10][4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db)
      : "memory");
}

// D (64 x 96, f32) += A (64 x 16, bf16, in registers) B (16 x 96, bf16,
// K-major in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_m64n96k16(float (&d)[12][4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db)
      : "memory");
}

// D (64 x 128, f32) += A (64 x 16, bf16, in registers) B (16 x 128, bf16,
// K-major in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[16][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db)
      : "memory");
}

template <int BMX>
__device__ __forceinline__ void wgmma_rs(float (&d)[BMX / 8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
#ifndef QMM_NO_MMA
  if constexpr (BMX == 128)
    wgmma_rs_m64n128k16(d, a, db);
  else if constexpr (BMX == 96)
    wgmma_rs_m64n96k16(d, a, db);
  else if constexpr (BMX == 80)
    wgmma_rs_m64n80k16(d, a, db);
  else
    wgmma_rs_m64n64k16(d, a, db);
#endif
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The A fragments of one K step (4 slices of 16) of a thread's two adjacent
// columns, from the raw codes at `raw` (the thread's first column's byte,
// w8, or the byte of both, w4): slice s, register 0 holds column c0 at K
// rows 2t, 2t + 1, register 1 column c0 + 1 there, registers 2 and 3 the
// same at rows 2t + 8, 2t + 9 (mma's m16n8k16 A layout, M row g = column
// c0, row g + 8 = column c0 + 1).
template <int BITS, int RS>
__device__ __forceinline__ void a_fragments_rows(const uint8_t* raw, int t,
                                                 uint32_t (&a)[4][4]) {
#ifdef QMR_NO_DECODE
  return;
#endif
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {        // rows 2t, 2t + 1 (h = 0); + 8
      const uint8_t* p = raw + (16 * s + 2 * t + 8 * h) * RS;
      if constexpr (BITS == 8) {
        // bytes: row k col c0, row k col c0 + 1, row k + 1 col c0, ...
        const uint32_t w = *reinterpret_cast<const uint16_t*>(p) |
                           static_cast<uint32_t>(
                               *reinterpret_cast<const uint16_t*>(p + RS))
                               << 16;
        a[s][2 * h] = i8x2_to_bf16x2(w);            // bytes 0, 2
        a[s][2 * h + 1] = i8x2_to_bf16x2(w >> 8);   // bytes 1, 3
      } else {
        // nibbles: low = column c0, high = c0 + 1, of rows k and k + 1
        const uint32_t w = static_cast<uint32_t>(p[0]) |
                           (static_cast<uint32_t>(p[RS]) << 16);
        a[s][2 * h] = i4x2_to_bf16x2(w);
        a[s][2 * h + 1] = i4x2_to_bf16x2(w >> 4);
      }
    }
  }
}

template <int BITS, typename XT, int BMX, bool VEC, bool VECX>
__global__ void __launch_bounds__(RTHREADS, 2)
    qmm_rows_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, XT* __restrict__ out,
                    int M, int K, int N) {
  using T = RTile<BITS, BMX>;
  // the next step's fragments decoded while this step's wgmma runs; the
  // byte-copy path for codes (N not a multiple of 16 bytes) has not the
  // registers for both sets, and decodes after the wait
  constexpr bool AHEAD = VEC;
  extern __shared__ __align__(16) uint8_t rsmem[];
  uint8_t* const base =
      rsmem + ((RALIGN - (smem_u32(rsmem) & (RALIGN - 1))) & (RALIGN - 1));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int warp = (tid & 127) >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * RBN;
  const int m0 = blockIdx.y * BMX;
  const int nk = (K + RBK - 1) / RBK;
  const int NB = N * BITS / 8;              // code bytes of a row of w
  const uint8_t* const wb = reinterpret_cast<const uint8_t*>(w);
  const int nb0 = n0 * BITS / 8;
  // this thread's two adjacent output columns, from the block's first
  const int c0 = 64 * wg + 16 * warp + 2 * g;

  // A thread copies the same chunk column of rows r0, r0 + RS, ... of
  // every step: fixed sources advanced by a step's K, fixed shared-memory
  // slots (the swizzle sees r0 & 7 only, the row step being a multiple of
  // 8), a handful of instructions a copy.
  // x, 16-byte copies: chunk xc of rows xr0 + 32 j
  constexpr int XRS = RTHREADS / 8;
  const int xr0 = tid / 8;
  const int xc = tid % 8;
  const XT* const xsrc = x + static_cast<size_t>(m0 + xr0) * K + xc * 8;
  const size_t xstride = static_cast<size_t>(XRS) * K;
  const uint32_t xdst = smem_u32(base) + swz128(xr0, xc);
  // x converted on the way in: pair kp of rows pr0 + 8 j
  constexpr int PRS = RTHREADS / (RBK / 2);
  const int pr0 = tid / (RBK / 2);
  const int kp = tid % (RBK / 2);
  const XT* const psrc = x + static_cast<size_t>(m0 + pr0) * K + 2 * kp;
  const size_t pstride = static_cast<size_t>(PRS) * K;
  uint8_t* const pdst = base + swz128(pr0, kp >> 2) + (kp & 3) * 4;
  // codes, 16-byte pieces: piece cb of rows cr0 + CRS i
  constexpr int CRS = RTHREADS / T::CH;
  constexpr int CJ = (RBK + CRS - 1) / CRS;
  const int cr0 = tid / T::CH;
  const int cb = (tid % T::CH) * 16;
  const bool ccol = nb0 + cb < NB;
  const uint8_t* const csrc =
      wb + (ccol ? static_cast<size_t>(cr0) * NB + nb0 + cb : 0);
  uint8_t* const cdst = base + T::A_BYTES + cr0 * T::RS + cb;

  // K step s into ring stage st: the x tile (rows past M and columns past
  // K zero) and the raw codes (rows past K and columns past N zero)
  auto load_step = [&](int s, int st) {
    const int k0 = s * RBK;
#ifndef QMR_NO_XCOPY
    if constexpr (VECX) {
      const bool kok = k0 + xc * 8 < K;
      const XT* src = xsrc + k0;
#pragma unroll
      for (int j = 0; j < (BMX + XRS - 1) / XRS; ++j) {
        if (BMX % XRS != 0 && xr0 + XRS * j >= BMX) break;
        const bool ok = kok && m0 + xr0 + XRS * j < M;
        cp_async16(xdst + st * T::STAGE + XRS * j * 128,
                   ok ? src + xstride * j : x, ok);
      }
    } else {
      const int kk = k0 + 2 * kp;
      const XT* src = psrc + k0;
#pragma unroll 4
      for (int j = 0; j < BMX / PRS; ++j) {
        const bool row = m0 + pr0 + PRS * j < M;
        const XT* e = src + pstride * j;
        __nv_bfloat162 v;
        v.x = row && kk < K ? to_bf16(e[0]) : __float2bfloat16_rn(0.f);
        v.y = row && kk + 1 < K ? to_bf16(e[1]) : __float2bfloat16_rn(0.f);
        *reinterpret_cast<__nv_bfloat162*>(pdst + st * T::STAGE +
                                           PRS * j * 128) = v;
      }
    }
#endif
#ifndef QMM_NO_COPY
    const uint8_t* src = csrc + static_cast<size_t>(k0) * NB;
    uint8_t* const raw = cdst + st * T::STAGE;
#pragma unroll
    for (int i = 0; i < CJ; ++i) {
      if (CRS * CJ > RBK && cr0 + CRS * i >= RBK) break;
      const bool ok = ccol && k0 + cr0 + CRS * i < K;
      const uint8_t* e = ok ? src + static_cast<size_t>(CRS * i) * NB : wb;
      if constexpr (VEC) {
        cp_async16(smem_u32(raw + CRS * i * T::RS), e, ok);
      } else {
        // byte by byte: N not a multiple of 16 bytes (few registers live)
        for (int b = 0; b < 16; ++b)
          raw[CRS * i * T::RS + b] =
              ok && nb0 + cb + b < NB ? __ldg(e + b) : uint8_t{0};
      }
    }
#endif
  };

  float acc[T::NJ][4];
#pragma unroll
  for (int j = 0; j < T::NJ; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  const uint8_t* const fsrc =
      base + T::A_BYTES + (BITS == 8 ? c0 : c0 / 2);   // + stage, + row
  const uint32_t xs = smem_u32(base);

  // ---- prologue: RSTAGES - 1 steps in flight; step 0's fragments ----
#pragma unroll
  for (int s = 0; s < RSTAGES - 1; ++s) {
    if (s < nk) load_step(s, s);
    cp_async_commit();
  }
  uint32_t a[4][4];
  cp_async_wait<RSTAGES - 2>();
  __syncthreads();
  a_fragments_rows<BITS, T::RS>(fsrc, t, a);

  // ---- mainloop: step it's wgmma runs while step it + 1's fragments are
  // read and decoded ----
  for (int it = 0; it < nk; ++it) {
    const int st = it % RSTAGES;
    // steps it and it + 1 landed (every thread's copies; x seen by the
    // tensor cores); every warpgroup's wgmma of step it - 1 done
    cp_async_wait<RSTAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    acc_fence<T::NJ>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_rs<BMX>(acc, a[s], desc_x(xs + st * T::STAGE + 32 * s));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // into the stage of step it - 1
    if (it + RSTAGES - 1 < nk)
      load_step(it + RSTAGES - 1, (it + RSTAGES - 1) % RSTAGES);
    cp_async_commit();
    const uint8_t* const next = fsrc + ((it + 1) % RSTAGES) * T::STAGE;
    if constexpr (AHEAD) {
      uint32_t an[4][4];
      if (it + 1 < nk) a_fragments_rows<BITS, T::RS>(next, t, an);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      acc_fence<T::NJ>(acc);
      // the tensor cores read `a` until the wait: keep it live to here, so
      // the next step's fragments never take its registers
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          asm volatile("" : "+r"(a[s][r])::"memory");
          a[s][r] = an[s][r];
        }
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      acc_fence<T::NJ>(acc);
      if (it + 1 < nk) a_fragments_rows<BITS, T::RS>(next, t, a);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: scaled and cast into shared memory (the ring's space),
  // then stored as 16-byte pieces of whole rows.  acc[j][2 h + c] is M row
  // g + 8 h of the warp's 16 (output column c0 + h), N column 8 j + 2 t + c
  // (row 8 j + 2 t + c of x's tile); rows past M are not stored ----
  constexpr int OS = RBN * static_cast<int>(sizeof(XT)) + 16;  // row stride
  constexpr int EPC = 16 / static_cast<int>(sizeof(XT));       // a piece
  static_assert(BMX * OS <= RSTAGES * T::STAGE, "the tile fits the ring");
  __syncthreads();       // every warpgroup is done with the ring
  const float s0 = n0 + c0 < N ? __ldg(scale + n0 + c0) : 0.f;
  const float s1 = n0 + c0 + 1 < N ? __ldg(scale + n0 + c0 + 1) : 0.f;
#pragma unroll
  for (int j = 0; j < T::NJ; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      XT* o = reinterpret_cast<XT*>(base + (8 * j + 2 * t + c) * OS) + c0;
      o[0] = from_f32<XT>(__fmul_rn(acc[j][c], s0));
      o[1] = from_f32<XT>(__fmul_rn(acc[j][2 + c], s1));
    }
  }
  __syncthreads();
  const bool vec_out = (N * sizeof(XT)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int c = tid; c < BMX * (RBN / EPC); c += RTHREADS) {
    const int r = c / (RBN / EPC);
    const int n = n0 + (c % (RBN / EPC)) * EPC;
    if (m0 + r >= M || n >= N) continue;
    const uint8_t* src = base + r * OS + (c % (RBN / EPC)) * 16;
    XT* o = out + static_cast<size_t>(m0 + r) * N + n;
    if (vec_out && n + EPC <= N) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
    } else {
      const XT* e = reinterpret_cast<const XT*>(src);
      for (int i = 0; i < EPC && n + i < N; ++i) o[i] = e[i];
    }
  }
}

template <int BITS, typename XT, int BMX, bool VEC, bool VECX>
int launch_rows_one(const void* x, const int8_t* w, const float* scale,
                    void* out, int M, int K, int N, cudaStream_t s) {
  using T = RTile<BITS, BMX>;
  auto kern = qmm_rows_kernel<BITS, XT, BMX, VEC, VECX>;
  static bool granted = false;
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = true;
  }
  const dim3 grid((N + RBN - 1) / RBN, (M + BMX - 1) / BMX);
  kern<<<grid, RTHREADS, T::SMEM, s>>>(static_cast<const XT*>(x), w, scale,
                                       static_cast<XT*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename XT, int BMX>
int launch_rows(const void* x, const int8_t* w, const float* scale, void* out,
                int M, int K, int N, cudaStream_t s) {
  const bool vec = (N * BITS / 8) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vecx = sizeof(XT) == 2 && K % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define QMR_LAUNCH(V, VX) \
  return launch_rows_one<BITS, XT, BMX, V, VX>(x, w, scale, out, M, K, N, s)
  if constexpr (sizeof(XT) == 2) {
    if (vec && vecx) QMR_LAUNCH(true, true);
    if (vecx) QMR_LAUNCH(false, true);
  }
  if (vec) QMR_LAUNCH(true, false);
  QMR_LAUNCH(false, false);
#undef QMR_LAUNCH
}

template <int BITS, typename XT>
int launch_rows_bm(const void* x, const int8_t* w, const float* scale,
                   void* out, int M, int K, int N, int bm, cudaStream_t s) {
  if (bm == 128)
    return launch_rows<BITS, XT, 128>(x, w, scale, out, M, K, N, s);
  if (bm == 96)
    return launch_rows<BITS, XT, 96>(x, w, scale, out, M, K, N, s);
  if (bm == 80)
    return launch_rows<BITS, XT, 80>(x, w, scale, out, M, K, N, s);
  if (bm == 64)
    return launch_rows<BITS, XT, 64>(x, w, scale, out, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


}  // namespace

// x (M, K) float32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w (K, N) int8 codes
// (bits = 8) or (K, N / 2) packed int4 (bits = 4); scale (N,) float32;
// out (M, N) of x's type.  A block takes mt (1 to 8) rows of x and bn (64
// or 128) columns; K is cut into `splits` slices of k_per_split rows (a
// multiple of 16, no slice empty).  When splits > 1, ws is float32 scratch
// of ceil(M / mt) * ceil(N / bn) * splits * 8 * bn values and counts holds
// ceil(M / mt) * ceil(N / bn) ints, zero before the launch and zero after
// it.  Returns cudaGetLastError() (or the error of raising the kernel's
// shared-memory limit).
extern "C" int repro_qmatmul(const void* x, int x_bf16, const int8_t* w,
                             int bits, const float* scale, void* out,
                             float* ws, int* counts, int M, int K, int N,
                             int mt, int bn, int splits, int k_per_split,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || mt < 1 || mt > MT8 || splits < 1 ||
      k_per_split < 1 || k_per_split % 16 != 0 ||
      static_cast<long long>(splits - 1) * k_per_split >= K ||
      static_cast<long long>(splits) * k_per_split < K ||
      (splits > 1 && (ws == nullptr || counts == nullptr)) ||
      (bits == 4 && N % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8 && x_bf16 == 0)
    return launch_bn<8, float>(x, w, scale, out, ws, counts, M, K, N, mt, bn,
                               splits, k_per_split, s);
  if (bits == 8 && x_bf16 == 1)
    return launch_bn<8, __nv_bfloat16>(x, w, scale, out, ws, counts, M, K, N,
                                       mt, bn, splits, k_per_split, s);
  if (bits == 4 && x_bf16 == 0)
    return launch_bn<4, float>(x, w, scale, out, ws, counts, M, K, N, mt, bn,
                               splits, k_per_split, s);
  if (bits == 4 && x_bf16 == 1)
    return launch_bn<4, __nv_bfloat16>(x, w, scale, out, ws, counts, M, K, N,
                                       mt, bn, splits, k_per_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The many-row route: x (M, K) float32 (x_bf16 = 0) or bf16 (x_bf16 = 1);
// w, scale and out as for repro_qmatmul.  A block takes bm (64, 80, 96
// or 128) rows of x and 128 columns and walks all of K; no scratch, no
// counters.
// Returns cudaGetLastError() (or the error of raising the kernel's
// shared-memory limit).
extern "C" int repro_qmatmul_rows(const void* x, int x_bf16, const int8_t* w,
                                  int bits, const float* scale, void* out,
                                  int M, int K, int N, int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 ||
      (bm != 64 && bm != 80 && bm != 96 && bm != 128) ||
      (M + bm - 1) / bm > 65535 || (bits == 4 && N % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 8 && x_bf16 == 0)
    return launch_rows_bm<8, float>(x, w, scale, out, M, K, N, bm, s);
  if (bits == 8 && x_bf16 == 1)
    return launch_rows_bm<8, __nv_bfloat16>(x, w, scale, out, M, K, N, bm, s);
  if (bits == 4 && x_bf16 == 0)
    return launch_rows_bm<4, float>(x, w, scale, out, M, K, N, bm, s);
  if (bits == 4 && x_bf16 == 1)
    return launch_rows_bm<4, __nv_bfloat16>(x, w, scale, out, M, K, N, bm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef QMM_CLOCK
// Copies the phase sums to host[8] and zeroes them.
extern "C" int repro_qmatmul_clock(unsigned long long* host) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(host, g_qmm_cycles, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_qmm_cycles, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif
