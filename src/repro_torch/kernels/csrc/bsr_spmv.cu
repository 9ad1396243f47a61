// Block-sparse-row push t = s_pre^T A over packed dense tiles, for sm_90a.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/bsr_spmv.py
//   (bsr_spmv_call, body _kernel): for each stored ts x td tile b,
//   out[dst_tile[b]] += s_pre[src_tile[b]] @ tiles[b], in dst-major order so
//   each output tile accumulates in place.
//
// What bounds it on this card: bytes. One vector against the stored tiles is
//   two flops per tile element read (ts * td * sizeof(T) bytes a tile), far
//   below the card's ratio of operations to bytes, so the tile stream from
//   device memory sets the time. Tensor cores would only pay across many
//   vectors at once.
//
// What the design does about it, and about the TPU's sequential grid:
//   * One CTA per dst tile, one thread per output column. The CTA walks the
//     dst tile's block range (dst_first_block / dst_num_blocks) in table
//     order, so the output tile accumulates in registers and is written once:
//     no atomics, and the sum has a fixed order (bitwise run to run).
//   * The s_pre[src_tile] slice is staged in shared memory; tiles[b, r, c] is
//     read row by row, so a warp reads 32 neighbouring words of one row.
//   * A dst tile with no stored block still writes its zero columns.
//   The tile product is computed here; no library GEMM stands in for it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void bsr_spmv_kernel(const T* __restrict__ s_pre,
                                const T* __restrict__ tiles,
                                const int32_t* __restrict__ src_tile,
                                const int32_t* __restrict__ dst_first_block,
                                const int32_t* __restrict__ dst_num_blocks,
                                T* __restrict__ out, int ts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* seg = reinterpret_cast<T*>(smem_raw);                     // [ts]
  const int td = blockDim.x;
  const int col = threadIdx.x;
  const int64_t b0 = dst_first_block[blockIdx.x];
  const int nb = dst_num_blocks[blockIdx.x];

  T acc = T(0);
  for (int k = 0; k < nb; ++k) {
    const int64_t b = b0 + k;
    const int64_t src_base = (int64_t)src_tile[b] * ts;
    for (int r = col; r < ts; r += td) seg[r] = s_pre[src_base + r];
    __syncthreads();
    const T* tb = tiles + b * (int64_t)ts * td + col;
#pragma unroll 8
    for (int r = 0; r < ts; ++r) acc += seg[r] * tb[(int64_t)r * td];
    __syncthreads();
  }
  out[(int64_t)blockIdx.x * td + col] = acc;
}

template <typename T>
int launch(const void* s_pre, const void* tiles, const void* src_tile,
           const void* dst_first_block, const void* dst_num_blocks, void* out,
           int num_dst_tiles, int ts, int td, void* stream) {
  const size_t smem = (size_t)ts * sizeof(T);
  bsr_spmv_kernel<T><<<num_dst_tiles, td, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s_pre), static_cast<const T*>(tiles),
      static_cast<const int32_t*>(src_tile),
      static_cast<const int32_t*>(dst_first_block),
      static_cast<const int32_t*>(dst_num_blocks), static_cast<T*>(out), ts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_bsr_spmv_f32(const void* s_pre, const void* tiles, const void* src_tile,
                       const void* dst_first_block, const void* dst_num_blocks,
                       void* out, int num_dst_tiles, int ts, int td, void* stream) {
  return launch<float>(s_pre, tiles, src_tile, dst_first_block, dst_num_blocks,
                       out, num_dst_tiles, ts, td, stream);
}

int repro_bsr_spmv_f64(const void* s_pre, const void* tiles, const void* src_tile,
                       const void* dst_first_block, const void* dst_num_blocks,
                       void* out, int num_dst_tiles, int ts, int td, void* stream) {
  return launch<double>(s_pre, tiles, src_tile, dst_first_block, dst_num_blocks,
                        out, num_dst_tiles, ts, td, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
