// The row path of the fused step (power_step.cu), for sm_90a: a node tile
// whose rows are sorted and one of which is longer than the ring's stage.
//
// In the ring (edge_tile_scan.cuh) thread r folds row r's run in the stage
// that holds it, and the ring issues a stage only after every warp has
// folded the stage `depth` before it. So a row whose run fills a stage holds
// up its whole tile, and a tile's long rows fold one after another: at 8
// cycles a dependent f64 add, a 2,048-slot stage costs 16k cycles of one
// thread while the others wait.
//
// Here the rows of such a tile fold side by side, each still the left fold,
// from 0, of its terms in ascending slot order (the ring's and the plain
// version's bits):
//
//   1. items: the tile's rows are cut into work items, each a range of
//      consecutive rows whose slots are one contiguous range: a long row (a
//      run longer than `stage` slots) on its own, and between long rows the
//      short rows of each 32-row window. Items are ranked longest first (a
//      rank counted against every other item, with ties in row order).
//   2. teams: the CTA's warps pair up, a gathering warp and a folding warp
//      (at most kMaxTeams teams, one named barrier each). The gathering warp
//      claims the team's next item from an integer counter in shared memory
//      (no float atomics, no shared sum) and hands it over in a mailbox; a
//      team streams its items on its own, with no barrier shared with the
//      other teams.
//   3. stream: the gathering warp walks the item's slots in chunks of
//      kRowChunk: it loads a chunk's src_idx with 16-byte streaming loads
//      (four slots a lane a round; read once, so marked to leave L2 first,
//      ahead of the gather source), gathers s_pre[src] with 4- or 8-byte
//      cp.async copies into one of the team's two chunk buffers, loads the
//      next chunk's indices, waits for its copies and meets the folding warp
//      at the team's barrier; meanwhile the folding warp folds the chunk
//      before, in the other buffer. Lane i of the folding warp folds row
//      r0 + i of the item: a long row on one lane, a window's short rows on
//      one lane each, side by side. So a long row's chain of dependent adds
//      never waits on its own gathers' issue, which adds about a third to a
//      warp that both gathers and folds (the cp.async of 32 random
//      addresses an instruction).
//   4. result: each folding lane writes its row's sum to res[row]; after the
//      CTA's barrier thread r takes res[r] into the step's epilogue.
//
// The tile's time thus falls from the sum of its stages' longest runs to
// about its longest row's chain, and what bounds a launch with many such
// tiles is the random gathers themselves (PERF.md). The row path reads no
// dst_local: a row's
// slots are [row_start[r], row_start[r + 1]) of the tile's slot range, from
// the plan (kernels/power_step.py row_path_plan), built once a format; its
// last row ends at the tile's real slots (tile_row_slots). It gathers each
// real slot once, as the ring does. It takes tiles of 64 threads or more
// (the plan sends no smaller tile).
//
// Shared memory, dynamic, from the same buffer as the ring's (a CTA takes
// one path), in this order:
//   claim    int32                 next item to claim
//   box      int32[kMaxTeams][2]   each team's mailbox, by item parity
//                                  (the 128-byte header)
//   scratch  T[32]                 CTA scan / sum scratch, where the ring has it
//   start    int32[tile + 1]       each row's first slot, then the tile's end
//                                  (padded to 16 bytes)
//   res      T[tile]               each row's sum
//   items    int32[tile]           an item's first row | its end row << 16
//   ilen     int32[tile]           an item's slots
//   order    int32[tile]           the items, longest first
//   bufs     T[teams][2][kRowChunk]  each team's chunk buffers
// = edge_tile_rows_smem_bytes() below.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tile_scan.cuh"

namespace repro {

// A chunk: kRowChunk slots, kRowRounds rounds of kChunk (four slots a lane
// a round). Teams: a named barrier each, ids 1 to 15.
constexpr int kRowChunk = 512;
constexpr int kRowRounds = kRowChunk / kChunk;
constexpr int kMaxTeams = 15;

__host__ __device__ constexpr int row_teams(int tile) {
  return tile / 64 < kMaxTeams ? tile / 64 : kMaxTeams;
}

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

// The row path's dynamic shared memory in bytes (the layout above).
__host__ __device__ constexpr size_t edge_tile_rows_smem_bytes(int tile,
                                                               int elt) {
  return 128 + 32 * (size_t)elt + align16(4 * ((size_t)tile + 1)) +
         (size_t)tile * (elt + 12) +
         (size_t)row_teams(tile) * 2 * kRowChunk * elt;
}

// One row-path tile as the warps see it (every lane offset applied).
template <typename T>
struct EdgeTileRows {
  const T* s_pre;
  const int32_t* src;         // the tile's first slot
  const int32_t* row_start;   // the tile's first row
  int row_slots;              // the tile's real slots: its last row's end
  int stage;                  // a row longer than this is an item alone
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// The two warps of team `team` meet (named barrier team + 1, 64 threads);
// what each wrote before is visible to the other after.
__device__ __forceinline__ void team_sync(int team) {
  __syncwarp();
  asm volatile("barrier.sync %0, 64;" ::"r"(team + 1) : "memory");
}

// A lane's four slots of each round of a chunk.
struct ChunkIdx {
  int4 v[kRowRounds];
};

// The indices of a lane's slots of chunk k of an item that starts at slot
// a0 (a multiple of kSlots) and ends before slot b; -1 past b. A load never
// passes b, so never the tile's slot range.
__device__ __forceinline__ ChunkIdx chunk_indices(const int32_t* src, int a0,
                                                  int b, int k, int lane) {
  ChunkIdx out;
#pragma unroll
  for (int u = 0; u < kRowRounds; ++u) {
    const int p = a0 + k * kRowChunk + u * kChunk + lane * kSlots;
    out.v[u] = p < b ? __ldcs(reinterpret_cast<const int4*>(src + p))
                     : make_int4(-1, -1, -1, -1);
  }
  return out;
}

// cp.async copies of s_pre[src] for the slots of chunk k in [a, b).
template <typename T>
__device__ __forceinline__ void gather_chunk(const T* s_pre, T* buf,
                                             const ChunkIdx& idx, int a0,
                                             int a, int b, int k, int lane) {
#pragma unroll
  for (int r = 0; r < kRowRounds; ++r) {
    const int p = a0 + k * kRowChunk + r * kChunk + lane * kSlots;
    const int4 v = idx.v[r];
    const int sv[kSlots] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (p + u >= a && p + u < b) {
        gather(buf + r * kChunk + lane * kSlots + u, s_pre + sv[u]);
      }
    }
  }
}

// The gathering warp of team `team` (step 3 above): claims the team's items
// and brings in their chunks, until no item is left. `buf` is the team's
// two chunk buffers, `box` its mailbox.
template <typename T>
__device__ __forceinline__ void gather_items(const EdgeTileRows<T>& g,
                                             const int* start,
                                             const int* order, int nitems,
                                             int* claim, int* box, T* buf,
                                             int team) {
  const int lane = threadIdx.x & 31;
  for (int q = 0;; q ^= 1) {
    int it = 0;
    if (lane == 0) it = atomicAdd(claim, 1);
    it = __shfl_sync(kFullMask, it, 0);
    const int item = it < nitems ? order[it] : -1;
    if (lane == 0) box[q] = item;
    if (item < 0) {
      team_sync(team);                       // the folding warp's last
      return;
    }
    const int a = start[item & 0xffff];
    const int b = start[item >> 16];
    const int a0 = a & ~(kSlots - 1);        // 16-byte aligned
    const int chunks = b > a ? (b - a0 + kRowChunk - 1) / kRowChunk : 0;
    ChunkIdx idx = chunk_indices(g.src, a0, b, 0, lane);
    if (chunks > 0) {
      gather_chunk(g.s_pre, buf, idx, a0, a, b, 0, lane);
      idx = chunk_indices(g.src, a0, b, 1, lane);
    }
    cp_async_wait_all();
    team_sync(team);                         // chunk 0 is in, the item told
    for (int k = 0; k < chunks; ++k) {
      // chunk k + 1 into the buffer that chunk k - 1 left
      if (k + 1 < chunks) {
        gather_chunk(g.s_pre, buf + ((k + 1) & 1) * kRowChunk, idx, a0, a, b,
                     k + 1, lane);
        idx = chunk_indices(g.src, a0, b, k + 2, lane);
      }
      cp_async_wait_all();
      team_sync(team);                       // chunk k is folded, k + 1 in
    }
  }
}

// The folding warp of team `team` (step 3 above): folds each item the
// gathering warp hands over, chunk by chunk, into res.
template <typename T>
__device__ __forceinline__ void fold_items(const int* start, T* res,
                                           const int* box, const T* buf,
                                           int team) {
  const int lane = threadIdx.x & 31;
  for (int q = 0;; q ^= 1) {
    team_sync(team);                         // the item, its chunk 0
    const int item = box[q];
    if (item < 0) return;
    const int r0 = item & 0xffff;
    const int r1 = item >> 16;
    const int row = r0 + lane;
    const bool mine = row < r1;
    const int lo = mine ? start[row] : 0;    // this lane's row: [lo, hi)
    const int hi = mine ? start[row + 1] : 0;
    const int a = start[r0];
    const int b = start[r1];
    const int a0 = a & ~(kSlots - 1);
    const int chunks = b > a ? (b - a0 + kRowChunk - 1) / kRowChunk : 0;
    T acc = T(0);
    for (int k = 0; k < chunks; ++k) {
      const int c0 = a0 + k * kRowChunk;
      const int f = max(lo, c0);
      const int e = min(hi, c0 + kRowChunk);
      if (e > f) {
        acc = fold_run<T, false>(acc, buf + (k & 1) * kRowChunk + (f - c0),
                                 nullptr, e - f);
      }
      team_sync(team);                       // buffer k & 1 is free
    }
    if (mine) res[row] = acc;
  }
}

// Thread r's sum over node r of a row-path tile (see the top of this
// file): bitwise what tile_fold gives on the same tile. Every thread of the
// CTA must call it; the shared buffer must not be touched by anything else
// until it returns.
template <typename T>
__device__ __forceinline__ T tile_rows_fold(const EdgeTileRows<T>& g,
                                            unsigned char* raw) {
  const int tile = blockDim.x;
  const int r = threadIdx.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int nwarps = tile >> 5;
  int* claim = reinterpret_cast<int*>(raw);
  int* box = claim + 1;
  int* scan = reinterpret_cast<int*>(raw + 128);
  int* start = reinterpret_cast<int*>(raw + 128 + 32 * sizeof(T));
  T* res = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(start) +
                                align16(4 * ((size_t)tile + 1)));
  int* items = reinterpret_cast<int*>(res + tile);
  int* ilen = items + tile;
  int* order = ilen + tile;
  const int team = warp >> 1;
  T* buf = reinterpret_cast<T*>(order + tile) + (size_t)team * 2 * kRowChunk;
  start[r] = g.row_start[r];
  if (r == 0) {
    start[tile] = g.row_slots;
    *claim = 0;
  }
  __syncthreads();
  // the items: a long row alone; the short rows of a window between long
  // rows together
  const bool is_long = start[r + 1] - start[r] > g.stage;
  const unsigned longs = __ballot_sync(kFullMask, is_long);
  const bool head = is_long || lane == 0 || ((longs >> (lane - 1)) & 1u);
  const unsigned after = longs & ~((2u << lane) - 1u);
  const int r1 = is_long ? r + 1 : (warp << 5) + (after ? __ffs(after) - 1 : 32);
  const int idx = block_exclusive_scan(head ? 1 : 0, scan);
  const int nitems = scan[nwarps - 1];
  if (head) {
    items[idx] = r | (r1 << 16);
    ilen[idx] = start[r1] - start[r];
  }
  __syncthreads();
  if (r < nitems) {            // longest first, ties in row order
    const int mine = ilen[r];
    int rank = 0;
    for (int j = 0; j < nitems; ++j) {
      const int other = ilen[j];
      rank += other > mine || (other == mine && j < r);
    }
    order[rank] = items[r];
  }
  __syncthreads();
  if (team < row_teams(tile)) {
    if (warp & 1) {
      gather_items<T>(g, start, order, nitems, claim, box + 2 * team, buf,
                      team);
    } else {
      fold_items<T>(start, res, box + 2 * team, buf, team);
    }
  }
  __syncthreads();             // every item is folded
  return res[r];
}

}  // namespace repro
