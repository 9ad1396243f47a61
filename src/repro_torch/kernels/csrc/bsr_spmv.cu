// Block-sparse-row push t = s_pre^T A over packed dense tiles, and the fused
// Power-psi step over the same tiles, for sm_90a.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/bsr_spmv.py
//   (bsr_spmv_call, body _kernel): for each stored ts x td tile b,
//   out[dst_tile[b]] += s_pre[src_tile[b]] @ tiles[b], in dst-major order so
//   each output tile accumulates in place. The JAX package's bsr regime then
//   applies s' = mu * t + c and the L1 gap in XLA; here one launch does the
//   step (kStep): s_pre = s * 1/w as the source slice is staged, the push,
//   s' = mu * t + c and the step's gap ||s' - s||_1.
//
// What bounds it on this card: bytes. One vector against the stored tiles is
//   two flops per tile cell read, far below the card's ratio of operations to
//   bytes, so the tile stream sets the time. The psi regime's tiles hold edge
//   counts, small integers, so the wrapper stores them in one byte a cell
//   (uint8) where that is exact and in the working type T otherwise: 4x (f32)
//   or 8x (f64) fewer bytes, and a clustered graph's tiles then fit the 50 MB
//   L2 across the solver loop. Tensor cores would only pay across many
//   vectors at once.
//
// What the design does about it, and about the TPU's sequential grid:
//   * One CTA per dst tile, td / C threads; thread k owns output columns
//     Ck .. Ck+C-1 and reads their C neighbouring cells of a row in one load
//     (C = 4 where td is a multiple of 128: 4 bytes at uint8, 16 at f32,
//     two 16-byte loads at f64, so a warp reads 128 neighbouring columns of
//     a row at once; C = 2 or 1 for the narrower td = 64 or 32 tiles, which
//     keeps a CTA whole warps). Loads of 8 rows are issued before their
//     products.
//   * Each column's sum is the left fold, from 0, of s_pre[r] * cell over the
//     rows r = 0 .. ts-1 of each block, blocks in table order, one FMA a
//     term: the order of the earlier one-thread-a-column kernel, so t does
//     not change by one bit. No atomics; bitwise repeatable. A uint8 cell is
//     converted to T exactly (its byte as the low mantissa bits of 2^23,
//     2^52 at f64, less that power), so both storages give the same t.
//   * The s_pre[src_tile] slice is staged in shared memory once per block.
//     In the step, a source index past n reads 0 (no padded copy of s).
//   * The step's epilogue rounds mu * t and + c separately (__fmul_rn /
//     __fadd_rn), so s' is bitwise PyTorch's mu * t + c. Its gap: each CTA
//     writes its tile's partial, and the last CTA to draw a ticket sums the
//     partials in tile order (gap_sum.cuh, as power_step.cu does). The
//     wrapper owns the counter, one per device and stream.
//   * A dst tile with no stored block still writes its zero columns.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gap_sum.cuh"

namespace {

constexpr int kRows = 8;     // rows whose loads are issued together

// The output columns a thread owns: 4 where td is a multiple of 128, else
// 2 where it is a multiple of 64, else 1, so a CTA is whole warps.
__host__ __device__ constexpr int cols_for(int td) {
  return td % 128 == 0 ? 4 : td % 64 == 0 ? 2 : 1;
}

// A thread's C neighbouring cells of one row, as loaded: one 4-, 2- or
// 1-byte word at uint8, one vector of C values at f32 (two 16-byte vectors
// for four f64 values).
template <typename S, int C>
struct Raw {
  S v[C];
};
template <int C>
struct Raw<uint8_t, C> {
  uint32_t w;
};

template <int C>
__device__ __forceinline__ Raw<uint8_t, C> load_raw(const uint8_t* p) {
  if constexpr (C == 4)
    return {__ldg(reinterpret_cast<const unsigned int*>(p))};
  else if constexpr (C == 2)
    return {(uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p))};
  else
    return {(uint32_t)__ldg(p)};
}
template <int C>
__device__ __forceinline__ Raw<float, C> load_raw(const float* p) {
  if constexpr (C == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    return {{q.x, q.y, q.z, q.w}};
  } else if constexpr (C == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    return {{q.x, q.y}};
  } else {
    return {{__ldg(p)}};
  }
}
template <int C>
__device__ __forceinline__ Raw<double, C> load_raw(const double* p) {
  if constexpr (C == 1) {
    return {{__ldg(p)}};
  } else {
    const double2* q = reinterpret_cast<const double2*>(p);
    const double2 lo = __ldg(q);
    if constexpr (C == 2) {
      return {{lo.x, lo.y}};
    } else {
      const double2 hi = __ldg(q + 1);
      return {{lo.x, lo.y, hi.x, hi.y}};
    }
  }
}

// Exact byte -> T: byte j of w placed under the exponent of 2^23 (2^52),
// minus that power.
template <int C>
__device__ __forceinline__ void unpack(const Raw<uint8_t, C>& r, float (&v)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j)
    v[j] = __fsub_rn(__uint_as_float(__byte_perm(r.w, 0x4B000000u, 0x7440u | j)),
                     8388608.0f);
}
template <int C>
__device__ __forceinline__ void unpack(const Raw<uint8_t, C>& r, double (&v)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j)
    v[j] = __dsub_rn(__hiloint2double(0x43300000, (int)__byte_perm(r.w, 0u, 0x4440u | j)),
                     4503599627370496.0);
}
template <typename T, int C>
__device__ __forceinline__ void unpack(const Raw<T, C>& r, T (&v)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = r.v[j];
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T, typename S, int C, bool kStep>
__global__ void bsr_kernel(const T* __restrict__ x, const T* __restrict__ inv_w,
                           int n, const S* __restrict__ tiles,
                           const int32_t* __restrict__ src_tile,
                           const int32_t* __restrict__ dst_first_block,
                           const int32_t* __restrict__ dst_num_blocks,
                           const T* __restrict__ mu, const T* __restrict__ c,
                           T* __restrict__ out, T* __restrict__ gap_partial,
                           T* __restrict__ gap, unsigned int* __restrict__ ticket,
                           int ts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* seg = reinterpret_cast<T*>(smem_raw);                   // [ts]
  T* scratch = seg + ts;                                     // [32]
  const int td = blockDim.x * C;
  const int col0 = threadIdx.x * C;
  const int64_t b0 = dst_first_block[blockIdx.x];
  const int nb = dst_num_blocks[blockIdx.x];

  T acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = T(0);
  for (int k = 0; k < nb; ++k) {
    const int64_t b = b0 + k;
    const int64_t src_base = (int64_t)src_tile[b] * ts;
    for (int r = threadIdx.x; r < ts; r += blockDim.x) {
      const int64_t i = src_base + r;
      if constexpr (kStep)
        seg[r] = i < n ? mul_rn(x[i], inv_w[i]) : T(0);
      else
        seg[r] = x[i];
    }
    __syncthreads();
    const S* tb = tiles + b * (int64_t)ts * td + col0;
    int r0 = 0;
    for (; r0 + kRows <= ts; r0 += kRows) {
      Raw<S, C> raw[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) raw[i] = load_raw<C>(tb + (int64_t)(r0 + i) * td);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        T v[C];
        unpack(raw[i], v);
        const T w = seg[r0 + i];
#pragma unroll
        for (int j = 0; j < C; ++j) acc[j] = fma_rn(w, v[j], acc[j]);
      }
    }
    for (; r0 < ts; ++r0) {
      T v[C];
      unpack(load_raw<C>(tb + (int64_t)r0 * td), v);
      const T w = seg[r0];
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = fma_rn(w, v[j], acc[j]);
    }
    __syncthreads();
  }

  const int64_t node0 = (int64_t)blockIdx.x * td + col0;
  if constexpr (!kStep) {
#pragma unroll
    for (int j = 0; j < C; ++j) out[node0 + j] = acc[j];
    return;
  }
  T local = T(0);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int64_t node = node0 + j;
    if (node < n) {
      const T sn = add_rn(mul_rn(mu[node], acc[j]), c[node]);
      out[node] = sn;
      const T d = sub_rn(sn, x[node]);
      local = add_rn(local, d < T(0) ? -d : d);
    }
  }
  const T total = repro::block_sum(local, scratch);
  bool last = false;
  if (threadIdx.x == 0) {
    gap_partial[blockIdx.x] = total;
    __threadfence();                       // the partial before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  if (!__syncthreads_or(last)) return;
  __threadfence();                         // every partial is visible now
  const T g = repro::gap_sum(gap_partial, gridDim.x, scratch);
  if (threadIdx.x == 0) {
    *gap = g;
    *ticket = 0u;                          // ready for the next launch
  }
}

template <typename T, typename S, int C, bool kStep>
int launch(const void* x, const void* inv_w, int n, const void* tiles,
           const void* src_tile, const void* dst_first_block,
           const void* dst_num_blocks, const void* mu, const void* c, void* out,
           void* gap_partial, void* gap, void* ticket, int num_dst_tiles,
           int ts, int td, void* stream) {
  const size_t smem = (size_t)(ts + 32) * sizeof(T);
  bsr_kernel<T, S, C, kStep><<<num_dst_tiles, td / C, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(inv_w), n,
      static_cast<const S*>(tiles), static_cast<const int32_t*>(src_tile),
      static_cast<const int32_t*>(dst_first_block),
      static_cast<const int32_t*>(dst_num_blocks), static_cast<const T*>(mu),
      static_cast<const T*>(c), static_cast<T*>(out),
      static_cast<T*>(gap_partial), static_cast<T*>(gap),
      static_cast<unsigned int*>(ticket), ts);
  return (int)cudaGetLastError();
}

template <typename T, typename S, bool kStep>
int launch_cols(const void* x, const void* inv_w, int n, const void* tiles,
                const void* src_tile, const void* dst_first_block,
                const void* dst_num_blocks, const void* mu, const void* c,
                void* out, void* gap_partial, void* gap, void* ticket,
                int num_dst_tiles, int ts, int td, void* stream) {
  switch (cols_for(td)) {
    case 4:
      return launch<T, S, 4, kStep>(x, inv_w, n, tiles, src_tile,
                                    dst_first_block, dst_num_blocks, mu, c,
                                    out, gap_partial, gap, ticket,
                                    num_dst_tiles, ts, td, stream);
    case 2:
      return launch<T, S, 2, kStep>(x, inv_w, n, tiles, src_tile,
                                    dst_first_block, dst_num_blocks, mu, c,
                                    out, gap_partial, gap, ticket,
                                    num_dst_tiles, ts, td, stream);
    default:
      return launch<T, S, 1, kStep>(x, inv_w, n, tiles, src_tile,
                                    dst_first_block, dst_num_blocks, mu, c,
                                    out, gap_partial, gap, ticket,
                                    num_dst_tiles, ts, td, stream);
  }
}

template <typename T, bool kStep>
int launch_storage(int narrow, const void* x, const void* inv_w, int n,
                   const void* tiles, const void* src_tile,
                   const void* dst_first_block, const void* dst_num_blocks,
                   const void* mu, const void* c, void* out, void* gap_partial,
                   void* gap, void* ticket, int num_dst_tiles, int ts, int td,
                   void* stream) {
  if (narrow)
    return launch_cols<T, uint8_t, kStep>(x, inv_w, n, tiles, src_tile,
                                          dst_first_block, dst_num_blocks, mu,
                                          c, out, gap_partial, gap, ticket,
                                          num_dst_tiles, ts, td, stream);
  return launch_cols<T, T, kStep>(x, inv_w, n, tiles, src_tile,
                                  dst_first_block, dst_num_blocks, mu, c, out,
                                  gap_partial, gap, ticket, num_dst_tiles, ts,
                                  td, stream);
}

}  // namespace

extern "C" {

// The bare push: out = s_pre^T A, f[num_dst_tiles * td]. `narrow` != 0 when
// the tiles are uint8.
int repro_bsr_spmv_f32(const void* s_pre, const void* tiles, int narrow,
                       const void* src_tile, const void* dst_first_block,
                       const void* dst_num_blocks, void* out, int num_dst_tiles,
                       int ts, int td, void* stream) {
  return launch_storage<float, false>(narrow, s_pre, nullptr, 0, tiles, src_tile,
                                      dst_first_block, dst_num_blocks, nullptr,
                                      nullptr, out, nullptr, nullptr, nullptr,
                                      num_dst_tiles, ts, td, stream);
}

int repro_bsr_spmv_f64(const void* s_pre, const void* tiles, int narrow,
                       const void* src_tile, const void* dst_first_block,
                       const void* dst_num_blocks, void* out, int num_dst_tiles,
                       int ts, int td, void* stream) {
  return launch_storage<double, false>(narrow, s_pre, nullptr, 0, tiles,
                                       src_tile, dst_first_block,
                                       dst_num_blocks, nullptr, nullptr, out,
                                       nullptr, nullptr, nullptr, num_dst_tiles,
                                       ts, td, stream);
}

// The fused step: s_new = mu * (s * inv_w)^T A + c over f[n] node vectors,
// gap = ||s_new - s||_1; gap_partial holds num_dst_tiles values, ticket is
// the caller's zeroed counter.
int repro_bsr_step_f32(const void* s, const void* inv_w, int n, const void* tiles,
                       int narrow, const void* src_tile,
                       const void* dst_first_block, const void* dst_num_blocks,
                       const void* mu, const void* c, void* s_new,
                       void* gap_partial, void* gap, void* ticket,
                       int num_dst_tiles, int ts, int td, void* stream) {
  return launch_storage<float, true>(narrow, s, inv_w, n, tiles, src_tile,
                                     dst_first_block, dst_num_blocks, mu, c,
                                     s_new, gap_partial, gap, ticket,
                                     num_dst_tiles, ts, td, stream);
}

int repro_bsr_step_f64(const void* s, const void* inv_w, int n, const void* tiles,
                       int narrow, const void* src_tile,
                       const void* dst_first_block, const void* dst_num_blocks,
                       const void* mu, const void* c, void* s_new,
                       void* gap_partial, void* gap, void* ticket,
                       int num_dst_tiles, int ts, int td, void* stream) {
  return launch_storage<double, true>(narrow, s, inv_w, n, tiles, src_tile,
                                      dst_first_block, dst_num_blocks, mu, c,
                                      s_new, gap_partial, gap, ticket,
                                      num_dst_tiles, ts, td, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
