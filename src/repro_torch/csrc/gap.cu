// GlobalAccPool for Hopper (sm_90a): the spatial SUM of an NHWC feature
// map, with no division (paper Sec. III-D), optionally of the residual add
// that produces it.
//
// Replaces, in the JAX package: src/repro/kernels/gap.py  gap_pallas
// (_gap_kernel), with the ``add`` node before it folded in.
//
// What it computes: out[n, c] = sum_{h,w} x[n, h, w, c], or, with a skip
// operand of x's shape and dtype, sum_{h,w} (x + skip)[n, h, w, c], the
// elementwise sum taken in x's dtype as the add node takes it (wrapping
// for integers, one float32 rounding per element).  The spatial sum
// accumulates in int32 for integer input (wrapping like the reference's
// int32 sum) and in float32 for float input, written as int32 or float32,
// never int64.
//
// What bounds it on this card: one read of x (and skip) and one write of
// out with one or two adds per element, so it is bound by bytes (3.35
// TB/s).  At the main path's (64, 4, 4, 512) int32 input that is 2 MB an
// operand: the launch itself costs more than the traffic.  That is why the
// int8 route does not launch it at all: the conv MVAU before the residual
// add sums its own output tile (csrc/mvau.cu, EPI_GAP).  This kernel serves
// the routes that do not fuse (the float MVAU, wide integer codes, other
// spatial sizes), where folding the add in saves the add's launch and its
// 2 MB round trip.
//
// What this design does about it: a thread owns one (image, channel) pair
// and walks the H*W positions in order, so neighbouring threads read
// neighbouring channels (coalesced 128-byte lines) and no block needs
// shared memory, atomics or a second pass.  The TPU kernel carried the sum
// in VMEM scratch across a sequential grid axis; here the loop inside the
// thread takes that axis's place.  Float sums run in position order, which
// is exact on the fixed-point grid and differs from PyTorch's tree order by
// rounding off it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;

template <typename XT, typename ACC, bool RES>
__global__ void __launch_bounds__(THREADS)
gap_kernel(const XT* __restrict__ x, const XT* __restrict__ skip,
           ACC* __restrict__ out, int HW, int C) {
  const int n = blockIdx.x;
  const int c = blockIdx.y * THREADS + threadIdx.x;
  if (c >= C) return;
  const size_t at = static_cast<size_t>(n) * HW * C + c;
  const XT* p = x + at;
  const XT* r = RES ? skip + at : nullptr;
  if constexpr (std::is_integral<ACC>::value) {
    // integer: the add wraps in x's dtype, the sum in uint32 so overflow is
    // defined, as the reference's int32 sum wraps
    uint32_t acc = 0;
    for (int i = 0; i < HW; ++i) {
      const size_t o = static_cast<size_t>(i) * C;
      XT v = p[o];
      if constexpr (RES)
        v = static_cast<XT>(static_cast<uint32_t>(v) +
                            static_cast<uint32_t>(r[o]));
      acc += static_cast<uint32_t>(static_cast<int32_t>(v));
    }
    out[static_cast<size_t>(n) * C + c] = static_cast<ACC>(static_cast<int32_t>(acc));
  } else {
    float acc = 0.f;
    for (int i = 0; i < HW; ++i) {
      const size_t o = static_cast<size_t>(i) * C;
      float v = static_cast<float>(p[o]);
      if constexpr (RES) v = __fadd_rn(v, static_cast<float>(r[o]));
      acc = __fadd_rn(acc, v);
    }
    out[static_cast<size_t>(n) * C + c] = acc;
  }
}

template <typename XT, typename ACC>
int launch(const void* x, const void* skip, void* out, int N, int HW, int C,
           cudaStream_t s) {
  if (N > 0 && C > 0) {
    dim3 grid(N, (C + THREADS - 1) / THREADS);
    const XT* xp = static_cast<const XT*>(x);
    const XT* sp = static_cast<const XT*>(skip);
    ACC* op = static_cast<ACC*>(out);
    if (sp != nullptr)
      gap_kernel<XT, ACC, true><<<grid, THREADS, 0, s>>>(xp, sp, op, HW, C);
    else
      gap_kernel<XT, ACC, false><<<grid, THREADS, 0, s>>>(xp, sp, op, HW, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, H*W, C) contiguous; skip: nullptr, or a second operand of x's
// shape and dtype added to x before the sum.  x_kind: 0 = int8, 1 = uint8,
// 2 = int16, 3 = int32 (out int32); 4 = float32 (out float32).  Returns
// cudaGetLastError.
extern "C" int repro_gap(const void* x, const void* skip, int x_kind,
                         void* out, int N, int HW, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_kind) {
    case 0: return launch<int8_t, int32_t>(x, skip, out, N, HW, C, s);
    case 1: return launch<uint8_t, int32_t>(x, skip, out, N, HW, C, s);
    case 2: return launch<int16_t, int32_t>(x, skip, out, N, HW, C, s);
    case 3: return launch<int32_t, int32_t>(x, skip, out, N, HW, C, s);
    case 4: return launch<float, float>(x, skip, out, N, HW, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
