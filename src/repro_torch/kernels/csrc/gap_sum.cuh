// Fixed-order sums across a CTA and across a grid's partials, shared by the
// kernels that compute a step's L1 gap in their own launch (power_step.cu,
// bsr_spmv.cu), for sm_90a.
//
// Each CTA sums its |s_new - s_old| with block_sum and writes one partial;
// the last CTA to draw a ticket sums the partials with gap_sum. Neither sum
// depends on which CTA finished last, so a step's gap is bitwise repeatable.
#pragma once

#include <cuda_runtime.h>

namespace repro {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Fixed-order sum over the CTA (blockDim.x a multiple of 32, at most 1024):
// a shuffle tree inside each warp, then warp 0 folds the warp sums in warp
// order. The result is valid in thread 0. `scratch` holds >= 32 values.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : T(0);
    v = warp_sum(v);
  }
  return v;
}

// The sum of partial[0, count) in the order of a CTA of kGapWidth threads:
// virtual thread k adds partial[k], partial[k + kGapWidth], ... in turn,
// each virtual warp folds its lanes with warp_sum, then lane 0 of warp 0
// folds the virtual warps' sums with warp_sum. Any blockDim (a multiple of
// 32) gives the same bits; the result is valid in thread 0. The partials
// are read through L2 (__ldcg): other CTAs wrote them.
template <typename T>
__device__ T gap_sum(const T* partial, int count, T* scratch) {
  constexpr int kGapWidth = 256;
  constexpr int kGapWarps = kGapWidth / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int vw = warp; vw < kGapWarps; vw += nwarps) {
    T v = T(0);
    for (int i = vw * 32 + lane; i < count; i += kGapWidth) v += __ldcg(partial + i);
    v = warp_sum(v);
    if (lane == 0) scratch[vw] = v;
  }
  __syncthreads();
  T v = T(0);
  if (warp == 0) {
    v = lane < kGapWarps ? scratch[lane] : T(0);
    v = warp_sum(v);
  }
  return v;
}

}  // namespace repro
