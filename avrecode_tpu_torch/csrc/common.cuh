// Shared pieces of the port's CUDA kernels: the C export macro, launch
// helpers and a block-wide exclusive scan (warp shuffles + one shared-memory
// pass over the warp totals). No CUB or Thrust.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ARTC_API extern "C" __attribute__((visibility("default")))

namespace artc {

constexpr int kProbBits = 15;
constexpr int kProbScale = 1 << kProbBits;

inline unsigned grid_for(long long n, int threads) {
  return unsigned((n + threads - 1) / threads);
}

// Exclusive prefix of `v` over the calling block (blockDim.x a multiple of
// 32, at most 1024); `*total` receives the block's sum. Every thread of the
// block must call it (it synchronises).
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const T before = warp > 0 ? warp_sums[warp - 1] : T(0);
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

}  // namespace artc
