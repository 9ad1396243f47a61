// The gather/accumulate core shared by the edge-tile kernels
// (power_step.cu and edge_spmv.cu), for sm_90a.
//
// Layout (src/repro_torch/kernels/formats.py): edges sorted by destination,
// cut into blocks of eblk slots; every block scatters into one node tile of
// `tile` nodes, and the blocks of a tile form one contiguous range
// (tile_first_block / tile_num_blocks). Unused slots hold the sentinel
// source n. Edge patches fill sentinel slots after a tile's sorted edges, so
// the core must also take blocks whose rows are in no order.
//
// One CTA of `tile` threads owns one node tile; thread r owns node r of it
// and returns the left fold, from 0, of node r's terms in ascending slot
// order across all of the tile's blocks. That is the order of the plain
// version's index_add_ on the CPU, so the two agree to the last bit, and
// the f32 map is deterministic (it can reach gap 0). There are no float
// atomics and no tree within a row; a weighted term is rounded (__fmul_rn /
// __dmul_rn) before it is added.
//
// The tile's blocks go through a ring of `depth` stages of `sblk` blocks
// (span = sblk * eblk slots), so a stage's loads are in flight while the
// threads fold the stages before it, and no CTA-wide barrier separates two
// sorted stages:
//
//   1. indices: the thread that finishes the last fold of a ring slot's
//      stage copies the src_idx and dst_local blocks (and the weights) of
//      the stage `depth` ahead into that slot with TMA bulk copies
//      (cp.async.bulk, contiguous blocks), which complete on the slot's
//      idx_full mbarrier. The first `depth` stages are issued at the start.
//   2. gathers: any warp that is not folding claims 128-slot chunks of a
//      landed stage (a shared counter a slot) and, four consecutive slots a
//      lane, gathers s_pre[src] into vals[] with 4- or 8-byte cp.async
//      copies, all in flight together, skipping a sentinel (src outside
//      [0, n)) or a dst_local outside [0, tile), wherever it lies. For
//      each real slot it compares the rows of its neighbours: a slot that
//      starts a run of one row writes first[row], one that ends it writes
//      end[row], and a real slot after a sentinel or after a larger row
//      marks the stage unsorted. The chunk's lanes then arrive on the
//      slot's `full` mbarrier, their gathers with cp.async.mbarrier.arrive,
//      so the stage completes when every chunk's copies have landed. Before
//      a warp waits on a stage it claims every chunk left of it and of the
//      stages before it, so no chunk is left unclaimed while anyone waits
//      (the first stage's first chunks go to the warps in order, with no
//      claim), and while the stage is not in, it gathers chunks of the
//      landed stages ahead, one at a time, so its fold starts as soon as
//      the stage lands: a warp folding a hub's long chain neither holds up
//      the gathers of the stages behind it nor waits on them.
//   3. fold: a sorted stage (every stage of a fresh build) holds each row's
//      slots as one run, and thread r adds vals[first[r], end[r]) in place,
//      then resets its row's marks. An unsorted stage takes a stable
//      counting sort by row, the CTA together (it is rare: only patched
//      tiles have one): the first min(4, tile / 32) warps count each row's
//      slots in their segment of 32-slot chunks (__match_any_sync groups a
//      chunk's lanes by row, the lowest lane of a group adds __popc), a
//      CTA-wide scan gives each row's start, the same warps place every
//      real slot at its row's next position in slot order (a rank that
//      never comes from an atomic), and thread r folds grouped[start,
//      start + total). The fold loads 16-byte vectors a batch ahead, so the
//      chain of dependent adds does not wait on shared memory; the
//      accumulator carries across the stages in block order.
//   4. release: each warp counts itself done with the slot; the last one
//      issues the TMA copies of the stage `depth` ahead (step 1).
//
// What bounds it now (a probe of per-warp clock64 stamps; PERF.md):
// the longest chain, and the latency of a tile's first stage. A row's terms
// are one dependent chain of adds on one thread (splitting it would
// reassociate the sum): 4.1 cycles an add alone, ~6 while the other warps
// of the SM gather, so a node with k in-edges costs ~6k cycles. The other
// warps of its tile run up to depth - 1 stages ahead of it and then wait
// for its ring slot. A tile of one block costs the latency of its index
// copy, then of its gathers; such tiles run in waves of as many CTAs as
// the registers allow (57-61 a thread: four CTAs of 256 threads an SM).
// The kernels launch the tiles with the most blocks first (heavy_first in
// edge_spmv.py, every lane's first tiles before any lane's second), so the
// longest chains start at once.
//
// Shared memory, dynamic, carved from one buffer in this order (span =
// sblk * eblk, ring slots s = 0 .. depth - 1, sort warps = min(4, tile/32)):
//   idx_full uint64[4]           mbarriers, TMA completion (depth <= 4)
//   full     uint64[4]           mbarriers, gathers and marks
//   claim    int32[4]            next chunk to claim, a slot
//   done     int32[4]            warps done with a slot
//   flag     int32[4]            stage + 1 when that stage is unsorted
//   (pad)    int32[4]            (the header is 128 bytes)
//   scratch  T[32]               CTA scan / sum scratch
//   src      int32[depth][span]  staged src_idx (TMA)
//   dst      int32[depth][span]  staged dst_local (TMA)
//   wts      T[depth][span]      staged weights (TMA; weighted push only)
//   vals     T[depth][span]      gathered values, slot order
//   first    int16[depth][tile]  a sorted stage's run of each row
//   end      int16[depth][tile]
//   grouped  T[span]             an unsorted stage's values by row
//   counts   uint16[sort warps][tile]  per-warp row counts, then positions
// = 128 + 32 * sizeof(T) + depth * (span * (8 + sizeof(T) * (1 + weighted))
//   + 4 * tile) + span * sizeof(T) + 2 * min(4, tile / 32) * tile bytes;
// edge_tile_smem_bytes() below, and the wrappers' checks in Python, compute
// exactly this. tile is a multiple of 32 in [32, 1024]; eblk a multiple of
// 128 (every chunk is a whole warp's four slots a lane, every block 16-byte
// aligned for TMA); positions are 16-bit (span <= 32,767, far above what
// fits).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDepth = 4;     // ring slots the header has room for
constexpr int kSortWarps = 4;    // warps of an unsorted stage's counting sort
// A gather chunk: kSlots consecutive slots a lane, so a chunk's loads and
// gathers are in flight together.
constexpr int kSlots = 4;
constexpr int kChunk = 32 * kSlots;

__host__ __device__ constexpr int sort_warps(int tile) {
  return tile / 32 < kSortWarps ? tile / 32 : kSortWarps;
}

// The core's dynamic shared memory in bytes (the layout above).
__host__ __device__ constexpr size_t edge_tile_smem_bytes(int tile, int eblk,
                                                          int sblk, int depth,
                                                          int elt,
                                                          bool weighted) {
  return 128 + 32 * (size_t)elt +
         (size_t)depth * ((size_t)sblk * eblk * (8 + elt * (weighted ? 2 : 1)) +
                          4 * (size_t)tile) +
         (size_t)sblk * eblk * elt + 2 * (size_t)sort_warps(tile) * tile;
}

// A kernel's opt-in to the card's whole dynamic shared memory (227 KB),
// made once a device: cudaFuncSetAttribute costs a launch's time, so it is
// not made on every launch. One static instance a kernel.
struct SmemOptIn {
  std::atomic<unsigned long long> devices{0};    // a bit a device done
  template <typename K>
  int allow(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (bit & devices.load(std::memory_order_acquire)) return 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err != cudaSuccess) return (int)err;
    devices.fetch_or(bit, std::memory_order_release);
    return 0;
  }
};

template <typename T>
struct EdgeTileSmem {
  uint64_t* idx_full;
  uint64_t* full;
  int* claim;
  int* done;
  int* flag;
  T* scratch;
  int32_t* src;
  int32_t* dst;
  T* wts;
  T* vals;
  int16_t* first;
  int16_t* end;
  T* grouped;
  uint16_t* counts;
};

template <typename T>
__device__ __forceinline__ EdgeTileSmem<T> carve(unsigned char* raw, int tile,
                                                 int span, int depth,
                                                 bool weighted) {
  EdgeTileSmem<T> s;
  s.idx_full = reinterpret_cast<uint64_t*>(raw);
  s.full = s.idx_full + kMaxDepth;
  s.claim = reinterpret_cast<int*>(s.full + kMaxDepth);
  s.done = s.claim + kMaxDepth;
  s.flag = s.done + kMaxDepth;
  s.scratch = reinterpret_cast<T*>(raw + 128);
  s.src = reinterpret_cast<int32_t*>(s.scratch + 32);
  s.dst = s.src + depth * span;
  s.wts = reinterpret_cast<T*>(s.dst + depth * span);
  s.vals = s.wts + (weighted ? depth * span : 0);
  s.first = reinterpret_cast<int16_t*>(s.vals + depth * span);
  s.end = s.first + depth * tile;
  s.grouped = reinterpret_cast<T*>(s.end + depth * tile);
  s.counts = reinterpret_cast<uint16_t*>(s.grouped + span);
  return s;
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// --- mbarriers, TMA bulk copies and cp.async (PTX) ----------------------- //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned count = 1) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0], %1;\n\t}" ::"r"(
          smem_u32(bar)),
      "r"(count)
      : "memory");
}
// This thread's cp.async copies so far count as one pending arrival of the
// current phase, made when they have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Whether the phase of parity `parity` has completed (acquire: what was
// released before the arrivals is visible after a true).
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}" : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
// A wait that outlasts kWaitLimitNs (no stage takes a fraction of that)
// traps, so a fault in the ring ends the launch with an error instead of
// hanging the card.
constexpr unsigned long long kWaitLimitNs = 4000000000ull;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  unsigned long long since = 0;
  for (;;) {
    unsigned ok;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}" : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
    if (ok) return;
    const unsigned long long now = global_ns();
    if (since == 0) {
      since = now;
    } else if (now - since > kWaitLimitNs) {
      __trap();
    }
  }
}
// `bytes` (a multiple of 16) from global to shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void gather(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void gather(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// --- the fold ------------------------------------------------------------ //
// 16-byte vectors for the fold's shared-memory loads, added in order.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
__device__ __forceinline__ float add_in_order(float acc, float4 v) {
  acc += v.x;
  acc += v.y;
  acc += v.z;
  acc += v.w;
  return acc;
}
__device__ __forceinline__ double add_in_order(double acc, double2 v) {
  acc += v.x;
  acc += v.y;
  return acc;
}
__device__ __forceinline__ float add_in_order(float acc, float4 v, float4 w) {
  acc += mul_rn(v.x, w.x);
  acc += mul_rn(v.y, w.y);
  acc += mul_rn(v.z, w.z);
  acc += mul_rn(v.w, w.w);
  return acc;
}
__device__ __forceinline__ double add_in_order(double acc, double2 v,
                                               double2 w) {
  acc += mul_rn(v.x, w.x);
  acc += mul_rn(v.y, w.y);
  return acc;
}

// Exclusive prefix sum of v over the CTA (integers: any order is exact).
// `scratch` holds >= 32 ints. Synchronises twice.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? scratch[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, t, off);
      if (lane >= off) t += y;
    }
    if (lane < nwarps) scratch[lane] = t;     // inclusive warp totals
  }
  __syncthreads();
  return (warp ? scratch[warp - 1] : 0) + x - v;
}

// acc + p[0] + p[1] + ... + p[count - 1], added left to right; with
// kWeighted the terms are mul_rn(p[i], q[i]). After the scalars up to a
// 16-byte boundary, 16-byte vectors, four a batch (16 f32 or 8 f64 values:
// more than the shared-memory latency of a busy SM in dependent adds; two
// with weights, which need twice the registers), the next batch loaded
// before the current one is added.
template <typename T, bool kWeighted>
__device__ __forceinline__ T fold_run(T acc, const T* p, const T* q,
                                      int count) {
  using V = typename Vec16<T>::type;
  constexpr int kW = sizeof(V) / sizeof(T);         // values a vector
  constexpr int kAhead = kWeighted ? 2 : 4;         // vectors a batch
  int i = 0;
  for (; i < count && (reinterpret_cast<uintptr_t>(p + i) % sizeof(V)); ++i) {
    acc += kWeighted ? mul_rn(p[i], q[i]) : p[i];
  }
  const V* pv = reinterpret_cast<const V*>(p + i);
  const V* qv = reinterpret_cast<const V*>(q + i);
  const int nv = (count - i) / kW;
  int j = 0;
  if (nv >= kAhead) {
    V cur[kAhead], wc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cur[u] = pv[u];
      if constexpr (kWeighted) wc[u] = qv[u];
    }
    for (j = kAhead; j + kAhead <= nv; j += kAhead) {
      V nxt[kAhead], wn[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        nxt[u] = pv[j + u];
        if constexpr (kWeighted) wn[u] = qv[j + u];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if constexpr (kWeighted) {
          acc = add_in_order(acc, cur[u], wc[u]);
        } else {
          acc = add_in_order(acc, cur[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        cur[u] = nxt[u];
        if constexpr (kWeighted) wc[u] = wn[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if constexpr (kWeighted) {
        acc = add_in_order(acc, cur[u], wc[u]);
      } else {
        acc = add_in_order(acc, cur[u]);
      }
    }
  }
  for (; j < nv; ++j) {
    if constexpr (kWeighted) {
      acc = add_in_order(acc, pv[j], qv[j]);
    } else {
      acc = add_in_order(acc, pv[j]);
    }
  }
  for (i += nv * kW; i < count; ++i) {
    acc += kWeighted ? mul_rn(p[i], q[i]) : p[i];
  }
  return acc;
}

// --- the ring ------------------------------------------------------------ //
// One tile's blocks as the ring sees them: the tile's first block of
// src_idx / dst_local / weights (every lane offset already applied) and the
// ring's shape.
template <typename T>
struct EdgeTileRing {
  const T* s_pre;
  const int32_t* src;
  const int32_t* dst;
  const T* wts;
  int n;
  int nb;        // blocks of the tile
  int eblk;
  int sblk;      // blocks a stage
  int depth;     // ring slots
};

// The slots of stage j (the last stage may hold fewer blocks).
template <typename T>
__device__ __forceinline__ int stage_span(const EdgeTileRing<T>& g, int j) {
  const int left = g.nb - j * g.sblk;
  return (left < g.sblk ? left : g.sblk) * g.eblk;
}

// TMA copies of stage j's blocks into ring slot j % depth.
template <typename T, bool kWeighted>
__device__ __forceinline__ void issue_stage(const EdgeTileRing<T>& g,
                                            const EdgeTileSmem<T>& sm, int j) {
  const int slot = j % g.depth;
  const int span_max = g.sblk * g.eblk;
  const int span = stage_span(g, j);
  const int64_t off = (int64_t)j * span_max;
  const unsigned ibytes = (unsigned)span * 4u;
  const unsigned wbytes = kWeighted ? (unsigned)span * sizeof(T) : 0u;
  uint64_t* bar = sm.idx_full + slot;
  if (span < span_max) {
    // a short last stage: the arrivals of the chunks it lacks
    mbar_arrive(sm.full + slot, (span_max - span) / kChunk);
  }
  mbar_expect_tx(bar, 2 * ibytes + wbytes);
  tma_load(sm.src + slot * span_max, g.src + off, ibytes, bar);
  tma_load(sm.dst + slot * span_max, g.dst + off, ibytes, bar);
  if constexpr (kWeighted) {
    tma_load(sm.wts + slot * span_max, g.wts + off, wbytes, bar);
  }
}

// The row of slot e of a staged stage, -1 when it adds nothing.
__device__ __forceinline__ int slot_row(const int32_t* src, const int32_t* dst,
                                        int e, int n, int tile) {
  const int s = src[e];
  const int d = dst[e];
  return ((unsigned)s < (unsigned)n && (unsigned)d < (unsigned)tile) ? d : -1;
}

// Gather chunk c of stage j (its indices have landed) and mark its runs
// (step 2 above). Called by a whole warp.

template <typename T, bool kWeighted>
__device__ __forceinline__ void produce_at(const EdgeTileRing<T>& g,
                                           const EdgeTileSmem<T>& sm, int j,
                                           int c) {
  const int tile = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int slot = j % g.depth;
  const int span_max = g.sblk * g.eblk;
  const int span = stage_span(g, j);
  const int32_t* src = sm.src + slot * span_max;
  const int32_t* dst = sm.dst + slot * span_max;
  T* vals = sm.vals + slot * span_max;
  const int e0 = c * kChunk + lane * kSlots;          // this lane's slots
  const int4 s4 = *reinterpret_cast<const int4*>(src + e0);
  const int4 d4 = *reinterpret_cast<const int4*>(dst + e0);
  // lane 0 needs the slot before the chunk, lane 31 the one after it
  const int ne = lane == 0 ? max(e0 - 1, 0) : min(e0 + kSlots, span - 1);
  const int nrow = slot_row(src, dst, ne, g.n, tile);
  const int sv[kSlots] = {s4.x, s4.y, s4.z, s4.w};
  const int dv[kSlots] = {d4.x, d4.y, d4.z, d4.w};
  int row[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const bool real = (unsigned)sv[u] < (unsigned)g.n &&
                      (unsigned)dv[u] < (unsigned)tile;
    row[u] = real ? dv[u] : -1;
    if (real) gather(vals + e0 + u, g.s_pre + sv[u]);
  }
  int prev = __shfl_up_sync(kFullMask, row[kSlots - 1], 1);
  int next = __shfl_down_sync(kFullMask, row[0], 1);
  if (lane == 0) prev = e0 > 0 ? nrow : row[0];
  if (lane == 31) next = e0 + kSlots < span ? nrow : -2;
  bool unsorted = false;
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int e = e0 + u;
    const int before = u == 0 ? prev : row[u - 1];
    const int after = u == kSlots - 1 ? next : row[u + 1];
    if (row[u] >= 0) {
      if (e == 0 || before != row[u]) {
        sm.first[slot * tile + row[u]] = (int16_t)e;
      }
      if (after != row[u]) sm.end[slot * tile + row[u]] = (int16_t)(e + 1);
      if (e > 0 && (before < 0 || before > row[u])) unsorted = true;
    }
  }
  if (unsorted) sm.flag[slot] = j + 1;
  mbar_arrive_copies(sm.full + slot);
  __syncwarp();
  if (lane == 0) mbar_arrive(sm.full + slot);
}

// Claim the next chunk of stage j and produce it; false when none was left.
template <typename T, bool kWeighted>
__device__ __forceinline__ bool produce_chunk(const EdgeTileRing<T>& g,
                                              const EdgeTileSmem<T>& sm,
                                              int j) {
  int c = 0;
  if ((threadIdx.x & 31) == 0) c = atomicAdd(sm.claim + j % g.depth, 1);
  c = __shfl_sync(kFullMask, c, 0);
  if (c >= stage_span(g, j) / kChunk) return false;
  produce_at<T, kWeighted>(g, sm, j, c);
  return true;
}

// Whether the phase of parity `parity` of bar has completed, the same answer
// for the whole warp (lane 0 asks).
__device__ __forceinline__ bool warp_test(uint64_t* bar, unsigned parity) {
  const int ready = (threadIdx.x & 31) == 0 ? (int)mbar_test(bar, parity) : 0;
  return __shfl_sync(kFullMask, ready, 0) != 0;
}

// An unsorted stage (step 3 above): row r's fold over its slots in slot
// order, through a stable counting sort. Every thread of the CTA calls it.
template <typename T, bool kWeighted>
__device__ __forceinline__ T fold_unsorted(const EdgeTileRing<T>& g,
                                        const EdgeTileSmem<T>& sm, int slot,
                                        int span, T acc) {
  const int tile = blockDim.x;
  const int r = threadIdx.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int swarps = sort_warps(tile);
  const unsigned lower = (1u << lane) - 1u;            // lanes below this one
  const int span_max = g.sblk * g.eblk;
  const int32_t* src = sm.src + slot * span_max;
  const int32_t* dst = sm.dst + slot * span_max;
  const T* vals = sm.vals + slot * span_max;
  const T* wts = sm.wts + slot * span_max;
  uint16_t* my_counts = sm.counts + warp * tile;
  const int nchunks = span >> 5;
  const int per_warp = (nchunks + swarps - 1) / swarps;
  const int c0 = warp * per_warp;
  const int c1 = min(c0 + per_warp, nchunks);
  __syncthreads();          // grouped and counts are free (an earlier sort)
  // count this warp's segment, row by row
  if (warp < swarps) {
    for (int i = lane; i < tile; i += 32) my_counts[i] = 0;
    __syncwarp();
    for (int c = c0; c < c1; ++c) {
      const int row = slot_row(src, dst, (c << 5) + lane, g.n, tile);
      if (__all_sync(kFullMask, row < 0)) continue;
      const unsigned peers = __match_any_sync(kFullMask, row);
      if (row >= 0 && (peers & lower) == 0) my_counts[row] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  // row r's total and start; each sort warp's first position for row r
  int total = 0;
  for (int w = 0; w < swarps; ++w) total += sm.counts[w * tile + r];
  const int start =
      block_exclusive_scan(total, reinterpret_cast<int*>(sm.scratch));
  for (int w = 0, run = start; w < swarps; ++w) {
    const int cnt = sm.counts[w * tile + r];
    sm.counts[w * tile + r] = (uint16_t)run;
    run += cnt;
  }
  __syncthreads();
  // place every real slot (its weighted term) at its row's next position
  if (warp < swarps) {
    for (int c = c0; c < c1; ++c) {
      const int e = (c << 5) + lane;
      const int row = slot_row(src, dst, e, g.n, tile);
      if (__all_sync(kFullMask, row < 0)) continue;
      const unsigned peers = __match_any_sync(kFullMask, row);
      if (row >= 0) {
        sm.grouped[my_counts[row] + __popc(peers & lower)] =
            kWeighted ? mul_rn(vals[e], wts[e]) : vals[e];
      }
      __syncwarp();
      if (row >= 0 && (peers & lower) == 0) my_counts[row] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  return fold_run<T, false>(acc, sm.grouped + start, nullptr, total);
}

// Thread r's sum over node r of the tile (see the top of this file). Every
// thread of the CTA must call it; the shared buffers must not be touched by
// anything else until it returns.
template <typename T, bool kWeighted>
__device__ __forceinline__ T tile_fold(const EdgeTileRing<T>& g,
                                       const EdgeTileSmem<T>& sm) {
  const int tile = blockDim.x;
  const int r = threadIdx.x;
  const int lane = r & 31;
  const int nwarps = tile >> 5;
  const int depth = g.depth;
  const int stages = (g.nb + g.sblk - 1) / g.sblk;
  const int span_max = g.sblk * g.eblk;
  if (r == 0) {
    // the ring's barriers, then the first stages' copies at once
    for (int s = 0; s < depth; ++s) {
      mbar_init(sm.idx_full + s, 1);
      mbar_init(sm.full + s, span_max / kChunk);
      sm.claim[s] = s == 0 ? nwarps : 0;
      sm.done[s] = 0;
      sm.flag[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < depth && j < stages; ++j) {
      issue_stage<T, kWeighted>(g, sm, j);
    }
  }
  for (int s = 0; s < depth; ++s) {
    sm.first[s * tile + r] = 0;
    sm.end[s * tile + r] = 0;
  }
  __syncthreads();
  // every warp starts idle: warp w gathers chunk w of the first stage
  // without a claim (the claims of stage 0 start past them)
  const int warp = r >> 5;
  if (stages > 0 && warp < stage_span(g, 0) / kChunk) {
    mbar_wait(sm.idx_full, 0);
    produce_at<T, kWeighted>(g, sm, 0, warp);
  }
  const auto slot_of = [depth](int j) { return j % depth; };
  const auto phase_of = [depth](int j) { return (unsigned)(j / depth) & 1u; };
  T acc = T(0);
  int p = 0;                    // the next stage this warp may gather
  for (int k = 0; k < stages; ++k) {
    const int slot = slot_of(k);
    const unsigned parity = phase_of(k);
    // every chunk of the stages up to k is claimed before anyone waits on
    // stage k; then, while it is not in, this warp gathers chunks of the
    // landed stages ahead that the ring holds
    for (; p <= k; ++p) {
      mbar_wait(sm.idx_full + slot_of(p), phase_of(p));
      while (produce_chunk<T, kWeighted>(g, sm, p)) {
      }
    }
    const int lim = min(stages, k + depth);
    while (!warp_test(sm.full + slot, parity) && p < lim &&
           warp_test(sm.idx_full + slot_of(p), phase_of(p))) {
      mbar_wait(sm.idx_full + slot_of(p), phase_of(p));
      if (!produce_chunk<T, kWeighted>(g, sm, p)) ++p;
    }
    mbar_wait(sm.full + slot, parity);
    const int span = stage_span(g, k);
    if (sm.flag[slot] == k + 1) {
      acc = fold_unsorted<T, kWeighted>(g, sm, slot, span, acc);
    } else {
      const int f = sm.first[slot * tile + r];
      acc = fold_run<T, kWeighted>(acc, sm.vals + slot * span_max + f,
                                   sm.wts + slot * span_max + f,
                                   sm.end[slot * tile + r] - f);
    }
    sm.first[slot * tile + r] = 0;
    sm.end[slot * tile + r] = 0;
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(sm.done + slot, 1) == nwarps - 1) {
        // the slot is free: every warp has folded stage k
        __threadfence_block();
        sm.done[slot] = 0;
        sm.claim[slot] = 0;
        if (k + depth < stages) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue_stage<T, kWeighted>(g, sm, k + depth);
        }
      }
    }
  }
  __syncthreads();              // every stage is consumed: smem is free
  return acc;
}

}  // namespace repro
