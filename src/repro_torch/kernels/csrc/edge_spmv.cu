// Bare edge-tile push t_i = sum_{(j->i)} w_e * s_pre[j], for sm_90a.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/edge_spmv.py
//   (edge_spmv_call, body _make_kernel): gather s_pre[src], multiply by the
//   optional per-edge weight, scatter into the block's node tile; the output
//   tile is written once. Also the same call under jax.vmap, the fleet's ψ
//   epilogue (src/repro/serving/fleet.py), one launch for every lane of a
//   bucket: block b of the grid is lane b % L, rank b / L of that lane's
//   tile_order, and a CTA forms its lane's base pointers once, before any
//   loop (as in power_step.cu), so each lane gets exactly what a
//   single-lane launch on its own tensors gives. A single-lane launch is
//   the L = 1 case.
//
// What bounds it on this card: the order of the sums, then latency. A
//   launch reads the int32 src_idx of every slot, dst_local (and the
//   weight) of every real slot, gathers s_pre at random and writes t once;
//   about two flops per edge. Each node's sum must be the plain version's
//   left fold in slot order (no atomics, no tree within a row), so the
//   bound is the longest chain, a node of thousands of in-edges (~4 cycles
//   an add), and the latency of bringing its tile's blocks in behind it
//   (edge_tile_scan.cuh).
//
// What the design does about it, and about the TPU's sequential grid: the
//   TPU kernel carries each output tile in VMEM across consecutive grid
//   steps and scatters with a one-hot MXU matmul (its workaround for having
//   no scatter). Here one CTA per node tile walks its tile's block range
//   (tile_first_block / tile_num_blocks), the tiles with the most blocks
//   launched first, through the core shared with power_step.cu
//   (edge_tile_scan.cuh): a ring of `depth` stages of sblk blocks, the
//   index blocks (and weights) brought in by TMA bulk copies on mbarriers,
//   the gathers issued by whichever warps are not folding, and each thread
//   folding only its own row's slots, in slot order, into a register that
//   carries across the tile's blocks: in place when a stage is sorted and
//   through a stable counting sort when it is not. The weight product is
//   rounded before the add (__fmul_rn / __dmul_rn), as in the plain
//   version. So the result is the same from run to run and equals the
//   plain version's index_add_ on the CPU, with the slots sorted or not and
//   sentinels anywhere. The power_step epilogue (mu, c, the gap) is
//   dropped. A tile without real slots, or without blocks, writes zeros.
// Shared memory: edge_tile_smem_bytes(tile, eblk, sblk, depth, sizeof(T),
//   weighted) of edge_tile_scan.cuh, dynamic; above 48 KB the kernel opts in to
//   the card's 227 KB, once a device (SmemOptIn).
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile_scan.cuh"

namespace {

// At most 64 registers a thread, so a CTA of 1,024 threads can launch.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(1024)
    edge_spmv_kernel(const T* __restrict__ s_pre, int n,
                     const int32_t* __restrict__ src_idx,
                     const int32_t* __restrict__ dst_local,
                     const T* __restrict__ weights,
                     const int32_t* __restrict__ tile_first_block,
                     const int32_t* __restrict__ tile_num_blocks,
                     const int32_t* __restrict__ tile_order,
                     T* __restrict__ out, int num_tiles, int lanes,
                     int eblk, int sblk, int depth,
                     int64_t s_stride, int64_t lane_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // this CTA's lane and its arrays, formed once (as in power_step.cu)
  const int lane = lanes > 1 ? (int)(blockIdx.x % lanes) : 0;
  const int rank = lanes > 1 ? (int)(blockIdx.x / lanes) : (int)blockIdx.x;
  const int64_t lt = (int64_t)lane * num_tiles;
  const int t = tile_order[lt + rank];
  const int64_t first = lane * lane_blocks + tile_first_block[lt + t];
  const repro::EdgeTileRing<T> ring{s_pre + lane * s_stride,
                                    src_idx + first * eblk,
                                    dst_local + first * eblk,
                                    kWeighted ? weights + first * eblk : nullptr,
                                    n,
                                    tile_num_blocks[lt + t],
                                    eblk,
                                    sblk,
                                    depth};
  const T acc = repro::tile_fold<T, kWeighted>(
      ring, repro::carve<T>(smem_raw, blockDim.x, sblk * eblk, depth,
                            kWeighted));
  out[(lt + t) * blockDim.x + threadIdx.x] = acc;
}

template <typename T, bool kWeighted>
int launch_kernel(const T* s, int n, const int32_t* si, const int32_t* dl,
                  const T* w, const int32_t* tf, const int32_t* tn,
                  const int32_t* to, T* o, int num_tiles, int tile, int eblk,
                  int sblk, int depth, int lanes, int64_t s_stride,
                  int64_t lane_blocks, cudaStream_t st) {
  const size_t smem = repro::edge_tile_smem_bytes(tile, eblk, sblk, depth,
                                                  sizeof(T), kWeighted);
  static repro::SmemOptIn opt_in;
  const int err = opt_in.allow(edge_spmv_kernel<T, kWeighted>, smem);
  if (err != 0) return err;
  edge_spmv_kernel<T, kWeighted><<<num_tiles * lanes, tile, smem, st>>>(
      s, n, si, dl, w, tf, tn, to, o, num_tiles, lanes, eblk, sblk, depth,
      s_stride, lane_blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* s_pre, int n, const void* src_idx, const void* dst_local,
           const void* weights, const void* tile_first_block,
           const void* tile_num_blocks, const void* tile_order, void* out,
           int num_tiles, int tile, int eblk, int sblk, int depth, int lanes,
           long long s_stride, long long lane_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* s = static_cast<const T*>(s_pre);
  const int32_t* si = static_cast<const int32_t*>(src_idx);
  const int32_t* dl = static_cast<const int32_t*>(dst_local);
  const T* w = static_cast<const T*>(weights);
  const int32_t* tf = static_cast<const int32_t*>(tile_first_block);
  const int32_t* tn = static_cast<const int32_t*>(tile_num_blocks);
  const int32_t* to = static_cast<const int32_t*>(tile_order);
  T* o = static_cast<T*>(out);
  if (w != nullptr) {
    return launch_kernel<T, true>(s, n, si, dl, w, tf, tn, to, o, num_tiles,
                                  tile, eblk, sblk, depth, lanes, s_stride,
                                  lane_blocks, st);
  }
  return launch_kernel<T, false>(s, n, si, dl, w, tf, tn, to, o, num_tiles,
                                 tile, eblk, sblk, depth, lanes, s_stride,
                                 lane_blocks, st);
}

}  // namespace

extern "C" {

// `weights` may be null (unweighted push). `lanes` formats of one shape,
// lane l's arrays at l times their strides (s_pre: s_stride elements;
// src_idx / dst_local / weights: lane_blocks blocks; the tile tables:
// num_tiles; out: num_tiles * tile). lanes = 1 is the single-lane push.
// The ring: depth stages of sblk blocks (edge_tile_scan.cuh).
int repro_edge_spmv_f32(const void* s_pre, int n, const void* src_idx,
                        const void* dst_local, const void* weights,
                        const void* tile_first_block, const void* tile_num_blocks,
                        const void* tile_order, void* out, int num_tiles, int tile,
                        int eblk, int sblk, int depth, int lanes,
                        long long s_stride, long long lane_blocks,
                        void* stream) {
  return launch<float>(s_pre, n, src_idx, dst_local, weights, tile_first_block,
                       tile_num_blocks, tile_order, out, num_tiles, tile, eblk,
                       sblk, depth, lanes, s_stride, lane_blocks, stream);
}

int repro_edge_spmv_f64(const void* s_pre, int n, const void* src_idx,
                        const void* dst_local, const void* weights,
                        const void* tile_first_block, const void* tile_num_blocks,
                        const void* tile_order, void* out, int num_tiles, int tile,
                        int eblk, int sblk, int depth, int lanes,
                        long long s_stride, long long lane_blocks,
                        void* stream) {
  return launch<double>(s_pre, n, src_idx, dst_local, weights, tile_first_block,
                        tile_num_blocks, tile_order, out, num_tiles, tile, eblk,
                        sblk, depth, lanes, s_stride, lane_blocks, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
