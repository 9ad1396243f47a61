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
// atomics and no tree within a row. The CTA stages `sblk` blocks at a time
// (the wrapper picks the most of 4, 2, 1 that fit 48 KB) and, for each
// stage, each thread adds only its own row's slots:
//
//   1. stage: gather s_pre[src] (times the weight, rounded by __fmul_rn /
//      __dmul_rn, when kWeighted) into vals[] and the row into rows[]; -1
//      for a sentinel (src outside [0, n)) or a dst_local outside
//      [0, tile), wherever it lies;
//   2. sorted stage: when the real rows are non-decreasing and no real slot
//      follows a sentinel (every stage of a fresh build), each row's slots
//      are one run; the slots at a run's two ends mark first[row] and
//      end[row], and thread r folds vals[first[r], end[r]) in place.
//   Otherwise a stable counting sort by row, deterministic throughout:
//   3. count: warp w owns a contiguous segment of 32-slot chunks and counts
//      each row's slots there in its own row counts[w][*]:
//      __match_any_sync groups a chunk's lanes by row and the lowest lane
//      of each group adds __popc of the group. No two warps touch one
//      counter, so no atomics at all;
//   4. scan: thread r sums column r over the warps, a CTA-wide exclusive
//      scan of those totals gives row r's start, and thread r rewrites
//      column r into each warp's first position for row r (start + the
//      counts of earlier warps);
//   5. place: each warp walks its chunks again and puts slot e at
//      counts[w][row] + the number of lower lanes of its group, then the
//      group's lowest lane advances counts[w][row]: a row's slots land in
//      ascending slot order, a rank that never comes from an atomic;
//   6. fold: thread r adds grouped[start, start + total) in order.
//   The fold loads 16-byte vectors a batch ahead, so the chain of dependent
//   adds does not wait on shared memory; the accumulator carries across
//   the stages in block order.
//
// A stage costs O(slots + tile * tile / 32) shared-memory operations (each
// slot is touched a constant number of times; the row-count table has
// tile / 32 entries a thread) instead of the tile x eblk compares of
// scanning every slot on every thread: 3 barriers on the sorted path, 8 on
// the counting sort.
//
// What bounds it now: the tiles with many blocks. A row's terms are one
// dependent chain of adds on one thread (splitting it would reassociate
// the sum), so a node with k in-edges costs at least k adds of latency,
// about 4 cycles each, and its tile's CTA also stages every block of the
// tile in turn. The twitter stand-in has 8 nodes of ~4,600 in-edges in
// tiles of 5-6 blocks; on an H100 their CTAs run ~20 us while a one-block
// tile takes ~3.5 us. The kernels launch the tiles with the most blocks first
// (heavy_first in edge_spmv.py), so those chains start at once.
//
// Shared memory, dynamic, carved from one buffer in this order (slots =
// sblk * eblk):
//   vals    T[slots]              staged values, slot order
//   grouped T[slots]              values grouped by row, slot order in a row
//   scratch T[32]                 CTA scan / sum scratch
//   counts  uint16[tile/32][tile] per-warp row counts, then positions
//   rows    int16[slots]          staged rows (-1: skipped)
//   first   int16[tile]           a sorted stage's run of each row
//   end     int16[tile]
// = slots * (2 * sizeof(T) + 2) + 32 * sizeof(T) + tile * tile / 16
// + 4 * tile bytes; edge_tile_smem_bytes() below, and the wrappers' checks
// in Python, compute exactly this. tile is a multiple of 32 in [32, 1024];
// eblk >= 32 (positions are 16-bit; what fits the shared memory is far
// below 32,768 slots).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// The core's dynamic shared memory in bytes (the layout above).
__host__ __device__ constexpr size_t edge_tile_smem_bytes(int tile, int eblk,
                                                          int sblk, int elt) {
  return (size_t)sblk * eblk * (2 * elt + 2) + 32 * (size_t)elt +
         (size_t)tile * (tile / 32) * 2 + (size_t)tile * 4;
}

template <typename T>
struct EdgeTileSmem {
  T* vals;
  T* grouped;
  T* scratch;
  uint16_t* counts;
  int16_t* rows;
  int16_t* first;
  int16_t* end;
};

template <typename T>
__device__ __forceinline__ EdgeTileSmem<T> carve(unsigned char* raw, int tile,
                                                 int slots) {
  EdgeTileSmem<T> s;
  s.vals = reinterpret_cast<T*>(raw);
  s.grouped = s.vals + slots;
  s.scratch = s.grouped + slots;
  s.counts = reinterpret_cast<uint16_t*>(s.scratch + 32);
  s.rows = reinterpret_cast<int16_t*>(s.counts + (tile / 32) * tile);
  s.first = s.rows + slots;
  s.end = s.first + tile;
  return s;
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

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

// acc + p[0] + p[1] + ... + p[count - 1], added left to right. After the
// scalars up to a 16-byte boundary, 16-byte vectors, 8 values a batch, the
// next batch loaded before the current one is added.
template <typename T>
__device__ __forceinline__ T fold_run(T acc, const T* p, int count) {
  using V = typename Vec16<T>::type;
  constexpr int kW = sizeof(V) / sizeof(T);         // values a vector
  constexpr int kAhead = 8 / kW;                    // vectors a batch
  int i = 0;
  for (; i < count && (reinterpret_cast<uintptr_t>(p + i) % sizeof(V)); ++i) {
    acc += p[i];
  }
  const V* q = reinterpret_cast<const V*>(p + i);
  const int nv = (count - i) / kW;
  int j = 0;
  if (nv >= kAhead) {
    V cur[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = q[u];
    for (j = kAhead; j + kAhead <= nv; j += kAhead) {
      V nxt[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) nxt[u] = q[j + u];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) acc = add_in_order(acc, cur[u]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = add_in_order(acc, cur[u]);
  }
  for (; j < nv; ++j) acc = add_in_order(acc, q[j]);
  for (i += nv * kW; i < count; ++i) acc += p[i];
  return acc;
}

// Thread r's sum over node r of the tile whose blocks are [b0, b0 + nb), in
// ascending slot order (see the top of this file). The CTA stages `sblk`
// blocks at a time (the shared buffers hold sblk * eblk slots). `weights`
// is read only when kWeighted. Every thread of the CTA must call it (it
// synchronises); on return the shared buffers are free for the caller.
template <typename T, bool kWeighted>
__device__ __forceinline__ T tile_fold(const T* __restrict__ s_pre, int n,
                                       const int32_t* __restrict__ src_idx,
                                       const int32_t* __restrict__ dst_local,
                                       const T* __restrict__ weights, int64_t b0,
                                       int nb, int eblk, int sblk,
                                       EdgeTileSmem<T> sm) {
  constexpr int kStage = 4;            // slots a thread stages per round
  const int tile = blockDim.x;
  const int r = threadIdx.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int nwarps = tile >> 5;
  const unsigned lower = (1u << lane) - 1u;            // lanes below this one
  uint16_t* my_counts = sm.counts + warp * tile;
  int* iscratch = reinterpret_cast<int*>(sm.scratch);
  T acc = T(0);
  for (int k = 0; k < nb; k += sblk) {
    const int span = min(sblk, nb - k) * eblk;          // slots staged now
    const int64_t base = (b0 + k) * (int64_t)eblk;
    // 1. stage: kStage slots a round, their loads in flight together
    for (int e0 = r; e0 < span; e0 += kStage * tile) {
      int32_t j[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = e0 + u * tile;
        j[u] = e < span ? src_idx[base + e] : -1;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int e = e0 + u * tile;
        if (e >= span) continue;
        int row = -1;
        T v = T(0);
        if ((unsigned)j[u] < (unsigned)n) {                 // sentinel is n
          row = dst_local[base + e];
          v = s_pre[j[u]];
          if constexpr (kWeighted) v = mul_rn(v, weights[base + e]);
          if ((unsigned)row >= (unsigned)tile) row = -1;
        }
        sm.vals[e] = v;
        sm.rows[e] = (int16_t)row;
      }
    }
    sm.first[r] = 0;
    sm.end[r] = 0;
    __syncthreads();
    // 2. sorted slots (real rows non-decreasing, no real slot after a
    // sentinel: every block of a fresh build) hold each row's slots as one
    // run; mark where each run starts and ends
    bool sorted = true;
    for (int e = r; e < span; e += tile) {
      const int row = sm.rows[e];
      if (row < 0) continue;
      const int prev = e > 0 ? sm.rows[e - 1] : row;
      if (prev < 0 || prev > row) sorted = false;
      if (e == 0 || prev != row) sm.first[row] = (int16_t)e;
      if (e + 1 == span || sm.rows[e + 1] != row) {
        sm.end[row] = (int16_t)(e + 1);
      }
    }
    if (__syncthreads_and(sorted)) {
      const int f = sm.first[r];
      acc = fold_run(acc, sm.vals + f, sm.end[r] - f);
      __syncthreads();
      continue;
    }
    // 3. otherwise count this warp's segment, row by row
    const int nchunks = (span + 31) >> 5;
    const int per_warp = (nchunks + nwarps - 1) / nwarps;
    const int c0 = warp * per_warp;
    const int c1 = min(c0 + per_warp, nchunks);
    for (int i = lane; i < tile; i += 32) my_counts[i] = 0;
    __syncwarp();
    for (int c = c0; c < c1; ++c) {
      const int e = (c << 5) + lane;
      const int row = e < span ? sm.rows[e] : -1;
      if (__all_sync(kFullMask, row < 0)) continue;
      const unsigned peers = __match_any_sync(kFullMask, row);
      if (row >= 0 && (peers & lower) == 0) my_counts[row] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // 4. row r's total and start; each warp's first position for row r
    int total = 0;
    for (int w = 0; w < nwarps; ++w) total += sm.counts[w * tile + r];
    const int start = block_exclusive_scan(total, iscratch);
    for (int w = 0, run = start; w < nwarps; ++w) {
      const int cnt = sm.counts[w * tile + r];
      sm.counts[w * tile + r] = (uint16_t)run;
      run += cnt;
    }
    __syncthreads();
    // 5. place every real slot at its row's next position, in slot order
    for (int c = c0; c < c1; ++c) {
      const int e = (c << 5) + lane;
      const int row = e < span ? sm.rows[e] : -1;
      if (__all_sync(kFullMask, row < 0)) continue;
      const unsigned peers = __match_any_sync(kFullMask, row);
      if (row >= 0) {
        sm.grouped[my_counts[row] + __popc(peers & lower)] = sm.vals[e];
      }
      __syncwarp();
      if (row >= 0 && (peers & lower) == 0) my_counts[row] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // 6. fold row r's run
    acc = fold_run(acc, sm.grouped + start, total);
    __syncthreads();
  }
  return acc;
}

}  // namespace repro
