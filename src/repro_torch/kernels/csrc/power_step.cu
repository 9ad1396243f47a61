// Fused Power-psi step over the edge-tile format, for sm_90a.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/power_step.py
//   (power_step_call, body _make_kernel): gather s_pre[src], scatter into the
//   block's node tile, on the tile's last block s' = mu * t + c, and the L1
//   gap ||s' - s_old||_1 accumulated in the kernel; and the same call under
//   jax.vmap (src/repro/core/engine.py make_edge_tile_step, run by the
//   fleet's kernel regime, src/repro/serving/fleet.py), one launch a step
//   for every lane of a bucket.
//
// What bounds it on this card: the order of the sums, then latency. Each
//   step reads the int32 src_idx of every slot and dst_local of every real
//   slot, gathers s_pre at random and streams mu, c, s_old in and s_new out:
//   about 20 MB on the twitter stand-in, which stays in the 50 MB L2 across
//   the solver loop, and two flops per edge. The f32 map must stay
//   deterministic (the solve ends at gap exactly 0), so each node's sum is
//   one left fold in slot order: no atomics, no tree within a row. So the
//   bound is the longest chain, a node of thousands of in-edges (~4 cycles
//   an add), and the latency of bringing a tile's blocks in behind it
//   (edge_tile_scan.cuh).
//
// What the design does about it, and about the TPU's sequential grid:
//   * One CTA per node tile, one thread per output node. The CTA walks its
//     tile's block range (tile_first_block / tile_num_blocks, taken from
//     block_tile, not from the block_last flags that pad blocks move).
//     Blocks are launched in the order of tile_order (the tiles with the
//     most blocks first), every lane's k-th tile before any lane's
//     (k+1)-th, so the longest chains of all lanes start in the first wave.
//   * The TPU's one-hot matmul (its workaround for having no scatter) is
//     dropped. The gather and the fixed-order sum into the tile are the
//     shared core in edge_tile_scan.cuh (also used by edge_spmv.cu): a ring
//     of `depth` stages of sblk blocks, the index blocks brought in by TMA
//     bulk copies on mbarriers, the gathers issued by whichever warps are
//     not folding (cp.async), and each thread folding only its own row's
//     slots, in slot order, as soon as a stage has landed: in place when
//     the stage is sorted, through a stable counting sort when it is not.
//     Sentinel slots are skipped wherever they lie.
//   * Lanes: the multi-tenant fleet stacks L same-shape formats (src_idx /
//     dst_local [L, blocks, e1, e2], the tile tables and partials [L,
//     num_tiles], the node vectors [L, 1, n_pad], s_pre [L, 1, s_stride])
//     and steps every lane in one launch, the TPU kernel under jax.vmap,
//     whose batch axis became a grid dimension there too. Block b of the
//     grid is lane b % L, rank b / L of that lane's tile_order (no
//     division when L = 1). Each CTA forms its lane's base pointers once,
//     before any loop, and computes exactly what a single-lane launch on
//     the lane's own tensors computes. A single-lane launch is the L = 1
//     case; against a build with the lane fixed at 0 it costs ~1% of
//     device time at tile 256 on the twitter stand-in (the compiler forms
//     the lane's gather base again at the gathers; PERF.md).
//   * The gap in the same launch: each CTA writes its tile's partial gap,
//     fences, and draws an integer ticket from a device counter; the CTA
//     that draws the last ticket sums all partials in tile order in the
//     fixed order of a 256-thread CTA (that of the two-kernel version),
//     writes the gap and resets the counter to 0. The sum does not depend
//     on which CTA finished last, so a step is bitwise repeatable. Each
//     lane draws from its own counter (ticket[lane]) and sums its own
//     partials into gap[lane]. The wrapper owns the counters (one int32
//     array per device and stream, zeroed once): launches that share a
//     counter must not overlap, and launches on one stream never do.
// Shared memory: edge_tile_smem_bytes(tile, eblk, sblk, depth, sizeof(T),
//   false) of edge_tile_scan.cuh, dynamic; above 48 KB the kernel opts in to
//   the card's 227 KB, once a device (SmemOptIn).
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile_scan.cuh"
#include "gap_sum.cuh"

namespace {

// At most 64 registers a thread, so a CTA of 1,024 threads can launch.
template <typename T>
__global__ void __launch_bounds__(1024)
    power_step_kernel(const T* __restrict__ s_pre, int n,
                      const int32_t* __restrict__ src_idx,
                      const int32_t* __restrict__ dst_local,
                      const int32_t* __restrict__ tile_first_block,
                      const int32_t* __restrict__ tile_num_blocks,
                      const int32_t* __restrict__ tile_order,
                      const T* __restrict__ mu, const T* __restrict__ c,
                      const T* __restrict__ s_old, T* __restrict__ s_new,
                      T* __restrict__ gap_partial, T* __restrict__ gap,
                      unsigned int* __restrict__ ticket, int num_tiles,
                      int lanes, int eblk, int sblk, int depth,
                      int64_t s_stride, int64_t lane_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockDim.x;
  const int r = threadIdx.x;
  // this CTA's lane and its arrays, formed once: the tile tables and
  // partials num_tiles in, the node vectors num_tiles * tile, the blocks
  // lane_blocks, the gather source s_stride
  const int lane = lanes > 1 ? (int)(blockIdx.x % lanes) : 0;
  const int rank = lanes > 1 ? (int)(blockIdx.x / lanes) : (int)blockIdx.x;
  const int64_t lt = (int64_t)lane * num_tiles;
  const int t = tile_order[lt + rank];
  const int64_t first = lane * lane_blocks + tile_first_block[lt + t];
  const repro::EdgeTileRing<T> ring{s_pre + lane * s_stride,
                                    src_idx + first * eblk,
                                    dst_local + first * eblk,
                                    nullptr,
                                    n,
                                    tile_num_blocks[lt + t],
                                    eblk,
                                    sblk,
                                    depth};
  const repro::EdgeTileSmem<T> sm =
      repro::carve<T>(smem_raw, tile, sblk * eblk, depth, false);
  const T acc = repro::tile_fold<T, false>(ring, sm);

  const int64_t node = (lt + t) * tile + r;
  const T sn = mu[node] * acc + c[node];
  s_new[node] = sn;
  const T d = sn - s_old[node];
  const T total = repro::block_sum(d < T(0) ? -d : d, sm.scratch);
  T* partial = gap_partial + lt;
  bool last = false;
  if (r == 0) {
    partial[t] = total;
    __threadfence();                       // the partial before the ticket
    last = atomicAdd(ticket + lane, 1u) == (unsigned)num_tiles - 1;
  }
  if (!__syncthreads_or(last)) return;
  __threadfence();                         // every partial is visible now
  const T g = repro::gap_sum(partial, num_tiles, sm.scratch);
  if (r == 0) {
    gap[lane] = g;
    ticket[lane] = 0u;                     // ready for the next launch
  }
}

template <typename T>
int launch(const void* s_pre, int n, const void* src_idx, const void* dst_local,
           const void* tile_first_block, const void* tile_num_blocks,
           const void* tile_order, const void* mu, const void* c,
           const void* s_old, void* s_new,
           void* gap_partial, void* gap, void* ticket, int num_tiles, int tile,
           int eblk, int sblk, int depth, int lanes, long long s_stride,
           long long lane_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      repro::edge_tile_smem_bytes(tile, eblk, sblk, depth, sizeof(T), false);
  static repro::SmemOptIn opt_in;
  const int err = opt_in.allow(power_step_kernel<T>, smem);
  if (err != 0) return err;
  power_step_kernel<T><<<num_tiles * lanes, tile, smem, st>>>(
      static_cast<const T*>(s_pre), n, static_cast<const int32_t*>(src_idx),
      static_cast<const int32_t*>(dst_local),
      static_cast<const int32_t*>(tile_first_block),
      static_cast<const int32_t*>(tile_num_blocks),
      static_cast<const int32_t*>(tile_order), static_cast<const T*>(mu),
      static_cast<const T*>(c), static_cast<const T*>(s_old), static_cast<T*>(s_new),
      static_cast<T*>(gap_partial), static_cast<T*>(gap),
      static_cast<unsigned int*>(ticket), num_tiles, lanes, eblk, sblk, depth,
      (int64_t)s_stride, (int64_t)lane_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `lanes` formats of one shape, lane l's arrays at l times their strides
// (s_pre: s_stride elements; src_idx / dst_local: lane_blocks blocks; the
// tile tables, partials: num_tiles; mu, c, s_old, s_new: num_tiles * tile;
// gap, ticket: 1). lanes = 1 is the single-lane step. The ring: depth
// stages of sblk blocks (edge_tile_scan.cuh).
int repro_power_step_f32(const void* s_pre, int n, const void* src_idx,
                         const void* dst_local, const void* tile_first_block,
                         const void* tile_num_blocks, const void* tile_order,
                         const void* mu, const void* c, const void* s_old,
                         void* s_new, void* gap_partial, void* gap, void* ticket,
                         int num_tiles, int tile, int eblk, int sblk, int depth,
                         int lanes, long long s_stride, long long lane_blocks,
                         void* stream) {
  return launch<float>(s_pre, n, src_idx, dst_local, tile_first_block,
                       tile_num_blocks, tile_order, mu, c, s_old, s_new,
                       gap_partial, gap, ticket, num_tiles, tile, eblk, sblk,
                       depth, lanes, s_stride, lane_blocks, stream);
}

int repro_power_step_f64(const void* s_pre, int n, const void* src_idx,
                         const void* dst_local, const void* tile_first_block,
                         const void* tile_num_blocks, const void* tile_order,
                         const void* mu, const void* c, const void* s_old,
                         void* s_new, void* gap_partial, void* gap, void* ticket,
                         int num_tiles, int tile, int eblk, int sblk, int depth,
                         int lanes, long long s_stride, long long lane_blocks,
                         void* stream) {
  return launch<double>(s_pre, n, src_idx, dst_local, tile_first_block,
                        tile_num_blocks, tile_order, mu, c, s_old, s_new,
                        gap_partial, gap, ticket, num_tiles, tile, eblk, sblk,
                        depth, lanes, s_stride, lane_blocks, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
