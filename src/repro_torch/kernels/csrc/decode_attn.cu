// Decode attention over a head-major cache whose slot i holds position i
// (a full-attention layer's cache): one query a row, each row read up to its
// own position, for sm_90a.
//
// Replaces: no TPU kernel. The JAX package leaves attention to XLA (float32
//   einsums, src/repro/models/transformer/attention.py); the port's plain
//   PyTorch path (models/transformer/attention.py cached_attention) widens
//   every padded slot's keys to float32, multiplies them on CUDA cores and
//   takes the softmax and the P.V product over every padded slot. This
//   kernel reads each row's live bf16 keys and values once.
//
// Layout: q bf16[B, 1, Hq, DK]; kc bf16[B, Hkv, C, DK] and vc bf16[B, Hkv,
//   C, DV], one layer's contiguous view of the cache; q_pos i64[B]. Row r
//   reads slots 0 .. q_pos[r] (clamped to C) and no slot past them; its
//   length is read on the device. The Hq / Hkv query heads of a KV head
//   (at most 16) are the M dimension of the tensor-core product.
//
// What bounds it on this card: bytes. Each live key and value is read once
//   (Hkv x (DK + DV) x 2 bytes a slot); the products (2 x 16 x (DK + DV)
//   FLOPs a slot and KV head) are far below the tensor cores' rate.
//
// What the design does about it:
//   * Split-K: a CTA a (chunk of `chunk` slots, KV head, row). CTAs whose
//     chunk starts past the row's end exit at once, so the grid is sized
//     for C and the live work is spread over ~all SMs whatever the spread
//     of lengths. Inside a CTA each warp takes every kWarps-th tile of 16
//     slots and streams it through a ring of its own (kStages stages,
//     cp.async, zero-filled past the row's end; rows padded by 16 bytes so
//     ldmatrix reads are free of bank conflicts). No CTA-wide barrier in
//     the loop.
//   * mma.sync m16n8k16 on the bf16 tiles as stored: S = Q K^T with f32
//     accumulation, scaled by 1/sqrt(DK); an online softmax in f32 (running
//     max, exp, sum) a warp; P rounded to bf16 for P.V, f32 accumulation.
//   * Sizes (chosen on the card at the mimo.decode cell's shape, 128 rows,
//     C 32,784, lengths 1k-32k): 4 warps, 2 stages (86 KB of shared memory,
//     two CTAs an SM), chunks of 2,048 slots from the wrapper: 1.215 ms a
//     launch against a 1.042 ms bound; 3 or 4 stages, 8 warps a CTA or 2
//     moved it by < 1%, chunks of 1,024 / 512 took 3% / 10% more.
//   * The warps' states merge in warp order in shared memory; each CTA
//     writes its chunk's (m, l, acc) to f32 scratch. decode_attn_merge_kernel
//     folds a row's chunks in chunk order, starting from the sink (m = sink,
//     l = 1) where there is one, divides by l, multiplies by v_scale and
//     rounds to bf16. No atomics: the result is the same bits launch after
//     launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                     // warps a CTA
constexpr int kStages = 2;                    // ring stages a warp
constexpr int kSlots = 16;                    // slots a warp tile
constexpr int kRows = 16;                     // query heads a KV head, padded
constexpr int kPad = 8;                       // bf16 padding a smem row
constexpr int kMergeThreads = 256;

template <int DK, int DV>
struct Shape {
  static constexpr int kRow = DK + kPad;                 // smem row, K
  static constexpr int vRow = DV + kPad;                 // smem row, V
  static constexpr int stage = kSlots * (kRow + vRow);   // bf16 a stage
  static constexpr int ring_bytes = kWarps * kStages * stage * 2;
  static constexpr int merge_bytes = kWarps * kRows * (DV + 2) * 4;
  static constexpr int smem_bytes =
      ring_bytes > merge_bytes ? ring_bytes : merge_bytes;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;                          // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a b: a bf16 16x16 (row-major fragment), b bf16 16x8 (col), c f32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int row_len(const int64_t* q_pos, int b, int C) {
  const int64_t n = q_pos[b] + 1;
  return n <= 0 ? 0 : (n >= C ? C : static_cast<int>(n));
}

template <int DK, int DV>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc,
                   const int64_t* __restrict__ q_pos,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int C, int chunk, int group,
                   float scale) {
  using S = Shape<DK, DV>;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hkv = gridDim.y, nchunks = gridDim.x;
  const int len = row_len(q_pos, b, C);
  const int c0 = c * chunk;
  if (c0 >= len) return;                       // past the row's end
  const int c1 = min(c0 + chunk, len);         // slots [c0, c1)

  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = 2 * (lane % 4);   // fragment row, column

  // The group's queries as A fragments, rows past the group zero.
  uint32_t qa[DK / 16][4];
  {
    const __nv_bfloat16* qg = q + (static_cast<int64_t>(b) * hkv * group +
                                   static_cast<int64_t>(h) * group) * DK;
    const bool lo = gr < group, hi = gr + 8 < group;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      const int col = ks * 16 + tq;
      const uint32_t* p0 =
          reinterpret_cast<const uint32_t*>(qg + gr * DK + col);
      const uint32_t* p1 =
          reinterpret_cast<const uint32_t*>(qg + (gr + 8) * DK + col);
      qa[ks][0] = lo ? p0[0] : 0u;
      qa[ks][1] = hi ? p1[0] : 0u;
      qa[ks][2] = lo ? p0[4] : 0u;
      qa[ks][3] = hi ? p1[4] : 0u;
    }
  }

  const int64_t head = static_cast<int64_t>(b) * hkv + h;
  const __nv_bfloat16* kh = kc + head * C * DK;
  const __nv_bfloat16* vh = vc + head * C * DV;
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem) + warp * kStages * S::stage;

  const int ntiles = (c1 - c0 + kSlots - 1) / kSlots;
  const int mine = warp < ntiles ? (ntiles - warp + kWarps - 1) / kWarps : 0;

  // this warp's i-th tile into stage s (slots past c1 zero-filled, unread)
  auto load = [&](int i, int s) {
    const int start = c0 + (warp + i * kWarps) * kSlots;
    __nv_bfloat16* ks = ring + s * S::stage;
    __nv_bfloat16* vs = ks + kSlots * S::kRow;
    constexpr int kc16 = DK / 8, vc16 = DV / 8;   // 16-byte pieces a row
#pragma unroll
    for (int e = lane; e < kSlots * kc16; e += 32) {
      const int r = e / kc16, col = (e % kc16) * 8;
      const bool ok = start + r < c1;
      cp_async16(ks + r * S::kRow + col,
                 kh + static_cast<int64_t>(ok ? start + r : c0) * DK + col,
                 ok);
    }
#pragma unroll
    for (int e = lane; e < kSlots * vc16; e += 32) {
      const int r = e / vc16, col = (e % vc16) * 8;
      const bool ok = start + r < c1;
      cp_async16(vs + r * S::vRow + col,
                 vh + static_cast<int64_t>(ok ? start + r : c0) * DV + col,
                 ok);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int d = 0; d < DV / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    const int ahead = i + kStages - 1;
    if (ahead < mine) load(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const __nv_bfloat16* ks = ring + (i % kStages) * S::stage;
    const __nv_bfloat16* vs = ks + kSlots * S::kRow;
    const int start = c0 + (warp + i * kWarps) * kSlots;

    // S = Q K^T over the tile's 16 slots: two 8-slot column tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int krow = (lane / 16) * 8 + lane % 8, kcol = ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t bf[4];
      ldmatrix_x4(bf, ks + krow * S::kRow + kk * 16 + kcol);
      mma(s[0], qa[kk], bf[0], bf[1]);
      mma(s[1], qa[kk], bf[2], bf[3]);
    }

    // online softmax, rows gr (e = 0, 1) and gr + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = start + nt * 8 + tq + (e & 1) < c1;
        s[nt][e] = live ? s[nt][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e / 2]);
        sum[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int d = 0; d < DV / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // acc += P V, P rounded to bf16 (the C fragments of S are P's A fragment)
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
    const int vrow = ((lane / 8) % 2) * 8 + lane % 8, vcol = (lane / 16) * 8;
#pragma unroll
    for (int dp = 0; dp < DV / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vs + vrow * S::vRow + dp * 16 + vcol);
      mma(acc[2 * dp], pa, bf[0], bf[1]);
      mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
    }
    __syncwarp();                  // the stage is free for the next load
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' states, merged in warp order; a warp with no tile has m = -inf
  float* sm_m = reinterpret_cast<float*>(smem);
  float* sm_l = sm_m + kWarps * kRows;
  float* sm_acc = sm_l + kWarps * kRows;
  if (lane % 4 == 0) {
    sm_m[warp * kRows + gr] = m[0];
    sm_m[warp * kRows + gr + 8] = m[1];
    sm_l[warp * kRows + gr] = l[0];
    sm_l[warp * kRows + gr + 8] = l[1];
  }
#pragma unroll
  for (int d = 0; d < DV / 8; ++d) {
    float* a0 = sm_acc + (warp * kRows + gr) * DV + d * 8 + tq;
    float* a1 = a0 + 8 * DV;
    a0[0] = acc[d][0];
    a0[1] = acc[d][1];
    a1[0] = acc[d][2];
    a1[1] = acc[d][3];
  }
  __syncthreads();
  const int64_t part = head * nchunks + c;
  for (int idx = threadIdx.x; idx < kRows * DV; idx += kWarps * 32) {
    const int r = idx / DV;
    float mm = sm_m[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * kRows + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w * kRows + r] - mm);
      ll += sm_l[w * kRows + r] * e;
      aa += sm_acc[w * kRows * DV + idx] * e;
    }
    part_acc[part * kRows * DV + idx] = aa;
    if (idx % DV == 0) {
      part_m[part * kRows + r] = mm;
      part_l[part * kRows + r] = ll;
    }
  }
}

// A row's chunks folded in chunk order, from the sink where there is one.
template <int DV>
__global__ void __launch_bounds__(kMergeThreads)
decode_attn_merge_kernel(const float* __restrict__ part_m,
                         const float* __restrict__ part_l,
                         const float* __restrict__ part_acc,
                         const int64_t* __restrict__ q_pos,
                         const float* __restrict__ sink,
                         __nv_bfloat16* __restrict__ out, int C, int chunk,
                         int nchunks, int group, float v_scale) {
  const int h = blockIdx.x, b = blockIdx.y, hkv = gridDim.x;
  const int len = row_len(q_pos, b, C);
  const int n = (len + chunk - 1) / chunk;
  const int64_t head = static_cast<int64_t>(b) * hkv + h;
  for (int idx = threadIdx.x; idx < group * DV; idx += kMergeThreads) {
    const int r = idx / DV;
    float m = -INFINITY, l = 0.f, a = 0.f;
    if (sink != nullptr) {
      m = sink[h * group + r];
      l = 1.f;
    }
    for (int c = 0; c < n; ++c) {
      const int64_t part = head * nchunks + c;
      const float mc = part_m[part * kRows + r];
      const float mn = fmaxf(m, mc);
      const float ea = expf(m - mn), eb = expf(mc - mn);
      l = l * ea + part_l[part * kRows + r] * eb;
      a = a * ea + part_acc[part * kRows * DV + idx] * eb;
      m = mn;
    }
    const float o = l > 0.f ? a / l : 0.f;
    out[(head * group + r) * DV + idx % DV] = __float2bfloat16_rn(o * v_scale);
  }
}

template <int DK, int DV>
int launch(const void* q, const void* kc, const void* vc, const void* q_pos,
           const void* sink, void* part_m, void* part_l, void* part_acc,
           void* out, int B, int hkv, int C, int group, int chunk,
           float v_scale, cudaStream_t st) {
  using S = Shape<DK, DV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nchunks = (C + chunk - 1) / chunk;
  decode_attn_kernel<DK, DV><<<dim3(nchunks, hkv, B), kWarps * 32,
                               S::smem_bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc),
      static_cast<const int64_t*>(q_pos), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), C, chunk,
      group, 1.0f / sqrtf(static_cast<float>(DK)));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_merge_kernel<DV><<<dim3(hkv, B), kMergeThreads, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc),
      static_cast<const int64_t*>(q_pos), static_cast<const float*>(sink),
      static_cast<__nv_bfloat16*>(out), C, chunk, nchunks, group, v_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch: part_m / part_l f32[B, hkv, ceil(C / chunk), 16], part_acc
// f32[..., 16, dv]; out bf16[B, 1, hkv * group, dv]. sink: f32[hkv * group]
// or null. The wrapper checks shapes, types and contiguity; head sizes
// other than dk 192 / dv 128 are cudaErrorInvalidValue (one instantiation
// more a pair).
int repro_decode_attn(const void* q, const void* kc, const void* vc,
                      const void* q_pos, const void* sink, void* part_m,
                      void* part_l, void* part_acc, void* out, int B, int hkv,
                      int C, int group, int dk, int dv, int chunk,
                      float v_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > kRows || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dk == 192 && dv == 128)      // MiMo-V2-Flash's full layers
    return launch<192, 128>(q, kc, vc, q_pos, sink, part_m, part_l, part_acc,
                            out, B, hkv, C, group, chunk, v_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
