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
//   one contiguous range (tile_first_block / tile_num_blocks).
//
// What bounds it on this card: bytes. Each message element is read once and
//   added once (one flop a 4- or 8-byte load), and each output element is
//   written once; at the trainer's shape (d = 602) that is ~0.55 GB of
//   messages and ~0.4 GB of output a launch, far past the 50 MB L2.
//
// What the design does about it: one CTA per (node tile, chunk of dc
//   columns), one thread per column. A warp reads one message row's chunk
//   per slot as one coalesced 128-byte line (f32), so the messages stream
//   from device memory once in all; dst_local is a broadcast read. Thread c
//   owns column c of a [tile, dc] accumulator in shared memory, so no two
//   threads ever touch one word: no atomics and no barrier. The thread walks
//   its tile's block range in slot order, loading kUnroll slots ahead into
//   registers to keep loads in flight, and carries the running sum of the
//   current row in a register, spilling it to shared memory only when the
//   row changes; every addition happens in slot order, as the plain
//   version's index_add_ on the CPU does, so the two agree to the last bit
//   and the kernel is a deterministic map. Slots need not be sorted by row
//   within a tile. Padding slots (zero rows) are added like any other, as
//   the plain version adds them; a dst_local outside [0, tile) is skipped. A
//   tile with no blocks writes zeros. The ragged column edge (d = 602 is no
//   multiple of 32) is masked by returning early: no thread waits on
//   another. Simple and right first; the shared accumulator caps residency
//   at a few warps an SM (tensor cores, TMA and a layout without padding
//   are later work).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 16;

template <typename T>
__global__ void seg_mm_kernel(const T* __restrict__ messages,
                              const int32_t* __restrict__ dst_local,
                              const int32_t* __restrict__ tile_first_block,
                              const int32_t* __restrict__ tile_num_blocks,
                              T* __restrict__ out, int d, int tile, int eblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);                  // [tile, dc]
  const int dc = blockDim.x;
  const int c = threadIdx.x;
  const int col = blockIdx.y * dc + c;
  if (col >= d) return;                                     // ragged edge
  for (int r = 0; r < tile; ++r) acc[r * dc + c] = T(0);
  const int64_t s0 = (int64_t)tile_first_block[blockIdx.x] * eblk;
  const int64_t s1 = s0 + (int64_t)tile_num_blocks[blockIdx.x] * eblk;
  int cur = 0;        // the row whose running sum `run` holds
  T run = T(0);       // acc[cur] is stale while the row is current
  for (int64_t s = s0; s < s1; s += kUnroll) {
    int rows[kUnroll];
    T vals[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = s + u < s1;
      rows[u] = in ? dst_local[s + u] : -1;
      vals[u] = in ? messages[(s + u) * d + col] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rows[u];
      if ((unsigned)r >= (unsigned)tile) continue;
      if (r != cur) {
        acc[cur * dc + c] = run;
        cur = r;
        run = acc[r * dc + c];
      }
      run += vals[u];
    }
  }
  acc[cur * dc + c] = run;
  T* o = out + (int64_t)blockIdx.x * tile * d + col;
  for (int r = 0; r < tile; ++r) o[(int64_t)r * d] = acc[r * dc + c];
}

template <typename T>
int launch(const void* messages, const void* dst_local,
           const void* tile_first_block, const void* tile_num_blocks,
           void* out, int num_tiles, int tile, int eblk, int d, int dc,
           void* stream) {
  const size_t smem = (size_t)tile * dc * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      seg_mm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_tiles, (d + dc - 1) / dc);
  seg_mm_kernel<T><<<grid, dc, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(messages), static_cast<const int32_t*>(dst_local),
      static_cast<const int32_t*>(tile_first_block),
      static_cast<const int32_t*>(tile_num_blocks), static_cast<T*>(out), d,
      tile, eblk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_seg_mm_f32(const void* messages, const void* dst_local,
                     const void* tile_first_block, const void* tile_num_blocks,
                     void* out, int num_tiles, int tile, int eblk, int d, int dc,
                     void* stream) {
  return launch<float>(messages, dst_local, tile_first_block, tile_num_blocks,
                       out, num_tiles, tile, eblk, d, dc, stream);
}

int repro_seg_mm_f64(const void* messages, const void* dst_local,
                     const void* tile_first_block, const void* tile_num_blocks,
                     void* out, int num_tiles, int tile, int eblk, int d, int dc,
                     void* stream) {
  return launch<double>(messages, dst_local, tile_first_block, tile_num_blocks,
                        out, num_tiles, tile, eblk, d, dc, stream);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
