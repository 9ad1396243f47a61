// Fused Power-psi step over the edge-tile format, for sm_90a.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/power_step.py
//   (power_step_call, body _make_kernel): gather s_pre[src], scatter into the
//   block's node tile, on the tile's last block s' = mu * t + c, and the L1
//   gap ||s' - s_old||_1 accumulated in the kernel.
//
// What bounds it on this card: bytes. Each step reads the int32 src_idx of
//   every slot and dst_local of every real slot, gathers s_pre at random, and
//   streams mu, c, s_old in and s_new out; about two flops per edge. On the
//   twitter stand-in that is about 20 MB a step, which stays in the 50 MB L2
//   across the solver loop.
//
// What the design does about it, and about the TPU's sequential grid:
//   * One CTA per node tile, one thread per output node. The CTA walks its
//     tile's block range (tile_first_block / tile_num_blocks, taken from
//     block_tile, not from the block_last flags that pad blocks move).
//   * The TPU's one-hot matmul (its workaround for having no scatter) is
//     dropped. The gather and the fixed-order, atomic-free sum into the
//     tile are the shared core in edge_tile_scan.cuh (also used by
//     edge_spmv.cu), so the f32 iteration is a deterministic map and can
//     reach an exact fixed point (gap 0); sentinel slots are skipped
//     wherever they lie.
//   * Each CTA writes its partial gap; a second one-CTA kernel sums the
//     partials in a fixed order.
//   This is the simple, right version: every thread scans every slot of its
//   tile's blocks (tile x eblk compares a block). A faster scatter is later
//   work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile_scan.cuh"

namespace {

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

template <typename T>
__global__ void power_step_kernel(const T* __restrict__ s_pre, int n,
                                  const int32_t* __restrict__ src_idx,
                                  const int32_t* __restrict__ dst_local,
                                  const int32_t* __restrict__ tile_first_block,
                                  const int32_t* __restrict__ tile_num_blocks,
                                  const T* __restrict__ mu, const T* __restrict__ c,
                                  const T* __restrict__ s_old, T* __restrict__ s_new,
                                  T* __restrict__ gap_partial, int eblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vals = reinterpret_cast<T*>(smem_raw);                   // [eblk]
  int32_t* rows = reinterpret_cast<int32_t*>(vals + eblk);     // [eblk]
  const int tile = blockDim.x;
  const int r = threadIdx.x;
  const T acc = repro::tile_scan<T, false>(
      s_pre, n, src_idx, dst_local, nullptr, tile_first_block[blockIdx.x],
      tile_num_blocks[blockIdx.x], eblk, vals, rows);

  const int64_t node = (int64_t)blockIdx.x * tile + r;
  const T sn = mu[node] * acc + c[node];
  s_new[node] = sn;
  const T d = sn - s_old[node];
  const T total = block_sum(d < T(0) ? -d : d, vals);
  if (r == 0) gap_partial[blockIdx.x] = total;
}

template <typename T>
__global__ void gap_reduce_kernel(const T* __restrict__ partial, int count,
                                  T* __restrict__ gap) {
  __shared__ T scratch[32];
  T v = T(0);
  for (int i = threadIdx.x; i < count; i += blockDim.x) v += partial[i];
  v = block_sum(v, scratch);
  if (threadIdx.x == 0) *gap = v;
}

template <typename T>
int launch(const void* s_pre, int n, const void* src_idx, const void* dst_local,
           const void* tile_first_block, const void* tile_num_blocks,
           const void* mu, const void* c, const void* s_old, void* s_new,
           void* gap_partial, void* gap, int num_tiles, int tile, int eblk,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)eblk * (sizeof(T) + sizeof(int32_t));
  power_step_kernel<T><<<num_tiles, tile, smem, st>>>(
      static_cast<const T*>(s_pre), n, static_cast<const int32_t*>(src_idx),
      static_cast<const int32_t*>(dst_local),
      static_cast<const int32_t*>(tile_first_block),
      static_cast<const int32_t*>(tile_num_blocks), static_cast<const T*>(mu),
      static_cast<const T*>(c), static_cast<const T*>(s_old), static_cast<T*>(s_new),
      static_cast<T*>(gap_partial), eblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gap_reduce_kernel<T><<<1, 256, 0, st>>>(static_cast<const T*>(gap_partial),
                                          num_tiles, static_cast<T*>(gap));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_power_step_f32(const void* s_pre, int n, const void* src_idx,
                         const void* dst_local, const void* tile_first_block,
                         const void* tile_num_blocks, const void* mu, const void* c,
                         const void* s_old, void* s_new, void* gap_partial, void* gap,
                         int num_tiles, int tile, int eblk, void* stream) {
  return launch<float>(s_pre, n, src_idx, dst_local, tile_first_block,
                       tile_num_blocks, mu, c, s_old, s_new, gap_partial, gap,
                       num_tiles, tile, eblk, stream);
}

int repro_power_step_f64(const void* s_pre, int n, const void* src_idx,
                         const void* dst_local, const void* tile_first_block,
                         const void* tile_num_blocks, const void* mu, const void* c,
                         const void* s_old, void* s_new, void* gap_partial, void* gap,
                         int num_tiles, int tile, int eblk, void* stream) {
  return launch<double>(s_pre, n, src_idx, dst_local, tile_first_block,
                        tile_num_blocks, mu, c, s_old, s_new, gap_partial, gap,
                        num_tiles, tile, eblk, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
