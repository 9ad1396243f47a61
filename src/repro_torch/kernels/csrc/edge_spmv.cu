// Bare edge-tile push t_i = sum_{(j->i)} w_e * s_pre[j], for sm_90a.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/edge_spmv.py
//   (edge_spmv_call, body _make_kernel): gather s_pre[src], multiply by the
//   optional per-edge weight, scatter into the block's node tile; the output
//   tile is written once.
//
// What bounds it on this card: bytes. A launch reads the int32 src_idx of
//   every slot, dst_local (and the weight) of every real slot, gathers s_pre
//   at random and writes t once; about two flops per edge.
//
// What the design does about it, and about the TPU's sequential grid: the
//   TPU kernel carries each output tile in VMEM across consecutive grid steps
//   and scatters with a one-hot MXU matmul (its workaround for having no
//   scatter). Here one CTA per node tile walks its tile's block range
//   (tile_first_block / tile_num_blocks) and thread r sums, in slot order,
//   the slots whose row is r: the core shared with power_step.cu
//   (edge_tile_scan.cuh). No atomics, so the result is the same from run to
//   run and equals the plain version's slot-order sum on the CPU. The
//   power_step epilogue (mu, c, the gap) is dropped. A tile without real
//   slots writes zeros. Simple and right first: every thread scans every slot
//   of its tile's blocks; a faster scatter is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile_scan.cuh"

namespace {

template <typename T, bool kWeighted>
__global__ void edge_spmv_kernel(const T* __restrict__ s_pre, int n,
                                 const int32_t* __restrict__ src_idx,
                                 const int32_t* __restrict__ dst_local,
                                 const T* __restrict__ weights,
                                 const int32_t* __restrict__ tile_first_block,
                                 const int32_t* __restrict__ tile_num_blocks,
                                 T* __restrict__ out, int eblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vals = reinterpret_cast<T*>(smem_raw);                   // [eblk]
  int32_t* rows = reinterpret_cast<int32_t*>(vals + eblk);     // [eblk]
  const T acc = repro::tile_scan<T, kWeighted>(
      s_pre, n, src_idx, dst_local, weights, tile_first_block[blockIdx.x],
      tile_num_blocks[blockIdx.x], eblk, vals, rows);
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <typename T>
int launch(const void* s_pre, int n, const void* src_idx, const void* dst_local,
           const void* weights, const void* tile_first_block,
           const void* tile_num_blocks, void* out, int num_tiles, int tile,
           int eblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)eblk * (sizeof(T) + sizeof(int32_t));
  const T* s = static_cast<const T*>(s_pre);
  const int32_t* si = static_cast<const int32_t*>(src_idx);
  const int32_t* dl = static_cast<const int32_t*>(dst_local);
  const T* w = static_cast<const T*>(weights);
  const int32_t* tf = static_cast<const int32_t*>(tile_first_block);
  const int32_t* tn = static_cast<const int32_t*>(tile_num_blocks);
  T* o = static_cast<T*>(out);
  if (w != nullptr) {
    edge_spmv_kernel<T, true><<<num_tiles, tile, smem, st>>>(s, n, si, dl, w, tf,
                                                             tn, o, eblk);
  } else {
    edge_spmv_kernel<T, false><<<num_tiles, tile, smem, st>>>(s, n, si, dl, w, tf,
                                                              tn, o, eblk);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `weights` may be null (unweighted push).
int repro_edge_spmv_f32(const void* s_pre, int n, const void* src_idx,
                        const void* dst_local, const void* weights,
                        const void* tile_first_block, const void* tile_num_blocks,
                        void* out, int num_tiles, int tile, int eblk, void* stream) {
  return launch<float>(s_pre, n, src_idx, dst_local, weights, tile_first_block,
                       tile_num_blocks, out, num_tiles, tile, eblk, stream);
}

int repro_edge_spmv_f64(const void* s_pre, int n, const void* src_idx,
                        const void* dst_local, const void* weights,
                        const void* tile_first_block, const void* tile_num_blocks,
                        void* out, int num_tiles, int tile, int eblk, void* stream) {
  return launch<double>(s_pre, n, src_idx, dst_local, weights, tile_first_block,
                        tile_num_blocks, out, num_tiles, tile, eblk, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
