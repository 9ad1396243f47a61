// The gather/accumulate core shared by the edge-tile kernels
// (power_step.cu and edge_spmv.cu), for sm_90a.
//
// Layout (src/repro_torch/kernels/formats.py): edges sorted by destination,
// cut into blocks of eblk slots; every block scatters into one node tile of
// `tile` nodes, and the blocks of a tile form one contiguous range
// (tile_first_block / tile_num_blocks). Unused slots hold the sentinel
// source n.
//
// One CTA of `tile` threads owns one node tile; thread r owns node r of it.
// For each block of the tile's range the CTA stages the gathered values
// (times the per-edge weight when kWeighted) and the dst_local rows in shared
// memory; thread r then sums, in slot order, the values whose row is r. All
// threads of a warp read the same word, so those reads are broadcasts. The
// sum has a fixed order and uses no atomics, so a kernel built on it is a
// deterministic map. Sentinel slots (src == n, or any id outside [0, n)) are
// skipped wherever they lie, so slots filled later by edge patches need not
// come before them.
//
// Its cost is the scan: every thread reads every slot of its tile's blocks
// (tile x eblk compares a block). A faster fixed-order scatter is later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Thread r's sum over node r of the tile whose blocks are [b0, b0 + nb).
// `vals` / `rows` are shared scratch of eblk entries each; `weights` is read
// only when kWeighted. Every thread of the CTA must call it (it
// synchronises).
template <typename T, bool kWeighted>
__device__ __forceinline__ T tile_scan(const T* __restrict__ s_pre, int n,
                                       const int32_t* __restrict__ src_idx,
                                       const int32_t* __restrict__ dst_local,
                                       const T* __restrict__ weights, int64_t b0,
                                       int nb, int eblk, T* vals, int32_t* rows) {
  const int tile = blockDim.x;
  const int r = threadIdx.x;
  T acc = T(0);
  for (int k = 0; k < nb; ++k) {
    const int64_t base = (b0 + k) * (int64_t)eblk;
    for (int e = r; e < eblk; e += tile) {
      const int32_t j = src_idx[base + e];
      const bool real = j >= 0 && j < n;                       // sentinel is n
      T v = real ? s_pre[j] : T(0);
      if (kWeighted && real) v *= weights[base + e];
      vals[e] = v;
      rows[e] = real ? dst_local[base + e] : -1;
    }
    __syncthreads();
    for (int e = 0; e < eblk; ++e) {
      if (rows[e] == r) acc += vals[e];
    }
    __syncthreads();
  }
  return acc;
}

}  // namespace repro
