// GlobalAccPool for Hopper (sm_90a): the spatial SUM of an NHWC feature
// map, with no division (paper Sec. III-D).
//
// Replaces, in the JAX package: src/repro/kernels/gap.py  gap_pallas
// (_gap_kernel).
//
// What it computes: out[n, c] = sum_{h,w} x[n, h, w, c], accumulated in
// int32 for integer input (wrapping like the reference's int32 sum) and in
// float32 for float input, written as int32 or float32, never int64.
//
// What bounds it on this card: one read of x and one write of out with one
// add per element read, so it is bound by bytes (3.35 TB/s).  At the main
// path's (64, 4, 4, 512) int32 input that is 2 MB: the launch itself costs
// more than the traffic.
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

template <typename XT, typename ACC>
__global__ void __launch_bounds__(THREADS)
gap_kernel(const XT* __restrict__ x, ACC* __restrict__ out, int HW, int C) {
  const int n = blockIdx.x;
  const int c = blockIdx.y * THREADS + threadIdx.x;
  if (c >= C) return;
  const XT* p = x + static_cast<size_t>(n) * HW * C + c;
  if constexpr (std::is_integral<ACC>::value) {
    // integer: wrap in uint32 so overflow is defined, as the reference's
    // int32 sum wraps
    uint32_t acc = 0;
    for (int i = 0; i < HW; ++i)
      acc += static_cast<uint32_t>(static_cast<int32_t>(p[static_cast<size_t>(i) * C]));
    out[static_cast<size_t>(n) * C + c] = static_cast<ACC>(static_cast<int32_t>(acc));
  } else {
    float acc = 0.f;
    for (int i = 0; i < HW; ++i)
      acc = __fadd_rn(acc, static_cast<float>(p[static_cast<size_t>(i) * C]));
    out[static_cast<size_t>(n) * C + c] = acc;
  }
}

template <typename XT, typename ACC>
int launch(const void* x, void* out, int N, int HW, int C, cudaStream_t s) {
  if (N > 0 && C > 0) {
    dim3 grid(N, (C + THREADS - 1) / THREADS);
    gap_kernel<XT, ACC><<<grid, THREADS, 0, s>>>(
        static_cast<const XT*>(x), static_cast<ACC*>(out), HW, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, H*W, C) contiguous.  x_kind: 0 = int8, 1 = uint8, 2 = int16,
// 3 = int32 (out int32); 4 = float32 (out float32).  Returns
// cudaGetLastError.
extern "C" int repro_gap(const void* x, int x_kind, void* out, int N, int HW,
                         int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_kind) {
    case 0: return launch<int8_t, int32_t>(x, out, N, HW, C, s);
    case 1: return launch<uint8_t, int32_t>(x, out, N, HW, C, s);
    case 2: return launch<int16_t, int32_t>(x, out, N, HW, C, s);
    case 3: return launch<int32_t, int32_t>(x, out, N, HW, C, s);
    case 4: return launch<float, float>(x, out, N, HW, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
