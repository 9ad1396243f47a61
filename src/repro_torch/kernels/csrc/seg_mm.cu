// Blocked segment-sum of feature rows Y[i] = sum_{e: dst_e = i} M[e, :]
// (GNN aggregation), for sm_90a.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/seg_mm.py:43
//   (seg_mm_call, body _kernel): per edge block, a one-hot
//   [tile, eblk] @ [eblk, d] MXU matmul scatters the block's message rows
//   into its node tile, and the output tile is carried in VMEM across the
//   consecutive grid steps of that tile.
//
// Layout (src/repro_torch/kernels/formats.py): the message rows come in the
//   blocked edge-tile order, messages[num_blocks, eblk, d] with zero rows in
//   padding slots; every block scatters into one node tile of `tile` rows
//   through dst_local (row within the tile), and the blocks of a tile form
//   one contiguous range (tile_first_block / tile_num_blocks). tile_span
//   (optional, derived on the host from the sentinel sources) counts the
//   slots of a tile's range up to its last real slot; the rest are padding.
//
// What bounds it on this card: bytes. Each real message element is read
//   once and added once, and each output element is written once; at the
//   trainer's shape (d = 602) that is ~0.41 GB of real messages and ~0.41 GB
//   of output a launch, far past the 50 MB L2.
//
// What the design does about it:
//   * No shared accumulator, so residency is bounded by registers: a CTA of
//     8 warps owns 64 rows of one tile, and each warp takes whole rows. A
//     row's sum is a left fold, from +0.0, of its slots' rows in slot order,
//     one lane per column group, held in registers; the output row is
//     written once (zeros for a row without slots), with 16-, 8- or 4-byte
//     vectors as d and the pointer's alignment allow (the wrapper picks).
//     A lane sums up to 4 column vectors at once and issues 8 loads before
//     it adds them, so a row of 10-15 slots costs a few round trips.
//   * Sorted tiles (every slot of the span's rows in [0, tile), non-
//     decreasing: the trainer's dst-sorted build): a row's slots are one
//     run. The CTA checks that, then finds the first slot of each of its
//     rows from the run boundaries in one pass over dst_local (row_start in
//     shared memory), and a warp streams its row's run.
//   * Any other tile (slots in any order): a warp finds its row's slots 32 at
//     a time with a ballot over dst_local and adds them in ascending slot
//     order; a dst_local outside [0, tile) is skipped.
//   * Padding past tile_span is not read. Skipping a padding row can change
//     no bit: it is zero, and a sum that starts from +0.0 is never -0.0, so
//     adding +-0.0 to it is exact. So every path equals the plain version's
//     index_add_ on the CPU (every slot, slot order) to the last bit, and
//     the kernel is a deterministic map: no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps a CTA
constexpr int kRowsPerCta = 64;            // rows of one tile a CTA owns

// Streaming loads (read once), exact adds, zero, by vector type.
__device__ __forceinline__ float ld(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float2 ld(const float2* p) { return __ldcs(p); }
__device__ __forceinline__ float4 ld(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ double ld(const double* p) { return __ldcs(p); }
__device__ __forceinline__ double2 ld(const double2* p) { return __ldcs(p); }

__device__ __forceinline__ void add(float& a, float b) { a = __fadd_rn(a, b); }
__device__ __forceinline__ void add(float2& a, float2 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
}
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}
__device__ __forceinline__ void add(double& a, double b) { a = __dadd_rn(a, b); }
__device__ __forceinline__ void add(double2& a, double2 b) {
  a.x = __dadd_rn(a.x, b.x);
  a.y = __dadd_rn(a.y, b.y);
}

template <typename W>
__device__ __forceinline__ W zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.0f, 0.0f); }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
template <>
__device__ __forceinline__ double zero<double>() { return 0.0; }
template <>
__device__ __forceinline__ double2 zero<double2>() { return make_double2(0.0, 0.0); }

// W: the vector of V elements a lane loads (float, float2, float4, double
// or double2); nvec = d / V; K: column vectors a lane sums at once on the
// sorted path (1, 2 or 4).
template <typename W, int K>
__global__ void __launch_bounds__(kWarps * 32)
seg_mm_kernel(const W* __restrict__ messages, const int32_t* __restrict__ dst_local,
              const int32_t* __restrict__ tile_first_block,
              const int32_t* __restrict__ tile_num_blocks,
              const int32_t* __restrict__ tile_span, W* __restrict__ out,
              int nvec, int tile, int eblk) {
  __shared__ int row_start[kRowsPerCta + 1];
  const int t = blockIdx.x;
  const int r0 = blockIdx.y * kRowsPerCta;
  const int r1 = min(r0 + kRowsPerCta, tile);              // rows [r0, r1)
  const int64_t s0 = (int64_t)tile_first_block[t] * eblk;
  const int cap = tile_num_blocks[t] * eblk;
  const int span = tile_span ? min(tile_span[t], cap) : cap;
  const int32_t* __restrict__ dl = dst_local + s0;
  const W* __restrict__ msg = messages + s0 * nvec;

  bool ok = true;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int v = dl[i];
    ok = ok && (unsigned)v < (unsigned)tile && (i == 0 || dl[i - 1] <= v);
  }
  const bool sorted = __syncthreads_and(ok);
  if (sorted) {
    // slot i opens rows dl[i-1]+1 .. dl[i]; the span's end opens the rest
    for (int i = threadIdx.x; i <= span; i += blockDim.x) {
      const int lo = max(i == 0 ? 0 : dl[i - 1] + 1, r0);
      const int hi = min(i == span ? tile : dl[i], r1);
      for (int r = lo; r <= hi; ++r) row_start[r - r0] = i;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    W* __restrict__ o = out + ((int64_t)t * tile + r) * nvec;
    if (sorted) {
      // lane holds K column vectors (v0 + 32k) and loads kSlots slots of
      // each before adding them in slot order: 8 loads in flight a lane
      constexpr int kSlots = 8 / K;
      const int cnt = row_start[r - r0 + 1] - row_start[r - r0];
      const W* __restrict__ m = msg + (int64_t)row_start[r - r0] * nvec;
      for (int v0 = lane; v0 < nvec; v0 += 32 * K) {
        W acc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = zero<W>();
        for (int s = 0; s < cnt; s += kSlots) {
          W x[kSlots][K];
#pragma unroll
          for (int u = 0; u < kSlots; ++u)
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (s + u < cnt && v0 + 32 * k < nvec)
                x[u][k] = ld(m + (int64_t)(s + u) * nvec + v0 + 32 * k);
#pragma unroll
          for (int u = 0; u < kSlots; ++u)
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (s + u < cnt && v0 + 32 * k < nvec) add(acc[k], x[u][k]);
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (v0 + 32 * k < nvec) o[v0 + 32 * k] = acc[k];
      }
    } else {
      for (int v0 = 0; v0 < nvec; v0 += 32) {
        const int v = v0 + lane;
        W acc = zero<W>();
        for (int c0 = 0; c0 < span; c0 += 32) {
          const int i = c0 + lane;
          unsigned hit = __ballot_sync(0xffffffffu, i < span && dl[i] == r);
          while (hit) {
            const int j = c0 + __ffs(hit) - 1;
            hit &= hit - 1;
            if (v < nvec) add(acc, ld(msg + (int64_t)j * nvec + v));
          }
        }
        if (v < nvec) o[v] = acc;
      }
    }
  }
}

template <typename W, int K>
void launch_k(const void* messages, const void* dst_local,
              const void* tile_first_block, const void* tile_num_blocks,
              const void* tile_span, void* out, int num_tiles, int tile,
              int eblk, int nvec, cudaStream_t stream) {
  const dim3 grid(num_tiles, (tile + kRowsPerCta - 1) / kRowsPerCta);
  seg_mm_kernel<W, K><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const W*>(messages), static_cast<const int32_t*>(dst_local),
      static_cast<const int32_t*>(tile_first_block),
      static_cast<const int32_t*>(tile_num_blocks),
      static_cast<const int32_t*>(tile_span), static_cast<W*>(out), nvec, tile,
      eblk);
}

// K from the row's width: 4 column vectors a lane past 64 vectors a row,
// 2 past 32, else 1.
template <typename T, typename W>
int launch(const void* messages, const void* dst_local,
           const void* tile_first_block, const void* tile_num_blocks,
           const void* tile_span, void* out, int num_tiles, int tile, int eblk,
           int d, void* stream) {
  const int nvec = d / (int)(sizeof(W) / sizeof(T));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nvec > 64)
    launch_k<W, 4>(messages, dst_local, tile_first_block, tile_num_blocks,
                   tile_span, out, num_tiles, tile, eblk, nvec, st);
  else if (nvec > 32)
    launch_k<W, 2>(messages, dst_local, tile_first_block, tile_num_blocks,
                   tile_span, out, num_tiles, tile, eblk, nvec, st);
  else
    launch_k<W, 1>(messages, dst_local, tile_first_block, tile_num_blocks,
                   tile_span, out, num_tiles, tile, eblk, nvec, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vec: elements a lane loads at once (1, 2 or 4; the wrapper checks that d
// and the pointers allow it). tile_span may be null: every slot is read.
int repro_seg_mm_f32(const void* messages, const void* dst_local,
                     const void* tile_first_block, const void* tile_num_blocks,
                     const void* tile_span, void* out, int num_tiles, int tile,
                     int eblk, int d, int vec, void* stream) {
  if (vec == 4)
    return launch<float, float4>(messages, dst_local, tile_first_block,
                                 tile_num_blocks, tile_span, out, num_tiles,
                                 tile, eblk, d, stream);
  if (vec == 2)
    return launch<float, float2>(messages, dst_local, tile_first_block,
                                 tile_num_blocks, tile_span, out, num_tiles,
                                 tile, eblk, d, stream);
  return launch<float, float>(messages, dst_local, tile_first_block,
                              tile_num_blocks, tile_span, out, num_tiles, tile,
                              eblk, d, stream);
}

int repro_seg_mm_f64(const void* messages, const void* dst_local,
                     const void* tile_first_block, const void* tile_num_blocks,
                     const void* tile_span, void* out, int num_tiles, int tile,
                     int eblk, int d, int vec, void* stream) {
  if (vec == 2)
    return launch<double, double2>(messages, dst_local, tile_first_block,
                                   tile_num_blocks, tile_span, out, num_tiles,
                                   tile, eblk, d, stream);
  return launch<double, double>(messages, dst_local, tile_first_block,
                                tile_num_blocks, tile_span, out, num_tiles,
                                tile, eblk, d, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
