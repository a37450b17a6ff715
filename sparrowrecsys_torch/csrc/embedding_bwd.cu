// Backward of the masked embedding lookup, for a table whose gradient fits
// in shared memory.
//
//   grad[v, :] = sum of g[r, :] over the rows r with ids[r] == v, v in [lo, V)
//
// g: [N, D] float32, the lookup's output gradient; ids: [N] int32 or int64,
// the ids the lookup was given, unclamped; grad: [V, D] float32. A row whose
// id lies outside [lo, V) adds nothing (lo is 1 under mask_zero, else 0;
// -1 and ids >= V are outside): the lookup's mask is applied here, so its
// `where` has no backward pass of its own.
//
// Replaces no Pallas kernel: the JAX package sums a table of V <= 2048 by an
// XLA one-hot product (sparrowrecsys_tpu/ops/embedding.py::_gather_oh_bwd).
// PyTorch's own backward (embedding_dense_backward) sorts the ids, cuts
// each id's run into segments and gives each (id, column) to one thread,
// which adds all the id's segments in a chain. Under Zipf(1.0) ids the head
// id holds about 13% of the rows: at DIN's [131072, 65] movie lookup that
// chain is 1.1 M rows long and took 10.4 ms of the 13.1 ms call (H100).
//
// Bound on the H100: bytes. The call reads g (N*D*4) and the ids (N*4 or
// N*8) once and writes V*D*4: 375 MB at that lookup, 0.112 ms at 3.35 TB/s.
// There this kernel takes 0.45 ms of device time (H100 at 700 W), against
// 13.4 ms for the mask's `where` and embedding_dense_backward: what remains
// above the bound is the shared-memory traffic of the grouped sums (with
// the adds left out, the staging alone runs in 0.13 ms).
//
// This design, no sort and no float atomics:
// - embedding_bwd_partials: a grid of at most one block per SM; block b
//   takes the rows [b*P, (b+1)*P), P a whole number of tiles, the same split
//   on every call of a shape. The block stages tiles of R rows (their g rows
//   and ids, contiguous in memory) into shared memory by cp.async, 16 bytes
//   a thread where the pointers allow it, in a ring of three stages: two
//   tiles in flight while a third is summed.
// - The block holds C copies of the [V, D] gradient in shared memory.
//   Chunk k (32 rows) of a tile goes to copy k mod C, and the copy's W
//   warps split the row's words (word j to warp j mod W; a word is two
//   floats where D is even, else one), so exactly one warp adds into each
//   cell of a copy, chunk after chunk.
// - In a chunk each lane takes a row; __match_any_sync groups the lanes of
//   one id, and the group's lowest lane adds its peers' rows (in lane
//   order) from the staged tile to its own and the sum, once, to the cell.
//   The Zipf head's rows of a chunk become one add, and its rows are summed
//   by C copies in every block at once: no chain longer than a block's
//   share over C.
// - The block's partial, its copies summed in copy order, goes to a
//   [grid, V, D] scratch; embedding_bwd_reduce gives each cell a thread that
//   adds the blocks' partials in block order and writes every cell (no
//   memset; N = 0 writes zeros).
// Every float addition has a fixed order for given inputs and plan, so two
// calls agree bit for bit. The plan (C, W, R, P, grid) is the caller's
// (ops/embedding.py::bwd_plan, checked by CPU tests); the entry point
// refuses one that does not fit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kCols = 8;                 // columns a lane sums at once
constexpr int kMaxSmem = 232448;         // dynamic shared memory a block can opt into
constexpr int kThreads = 256;            // ops/embedding.py::BWD_WARPS warps
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// A word of a row: one float, or two where D is even (8-byte shared-memory
// accesses: a half-warp reading 32 rows of 40 bytes hits no bank twice).
template <int VEC>
struct Word;
template <>
struct Word<1> {
  using T = float;
  __device__ static float zero() { return 0.f; }
  __device__ static void add(float& a, float b) { a += b; }
};
template <>
struct Word<2> {
  using T = float2;
  __device__ static float2 zero() { return make_float2(0.f, 0.f); }
  __device__ static void add(float2& a, float2 b) {
    a.x += b.x;
    a.y += b.y;
  }
};

// All the block's threads copy `bytes` (a multiple of 4) from global `src`
// to shared `dst` (16-byte aligned): 16 bytes a thread where `src` and
// `bytes` allow it, else 4. The test is the same for every thread.
__device__ __forceinline__ void stage(unsigned char* dst, const unsigned char* src, int bytes) {
  if (((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(bytes)) & 15) == 0) {
    for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16) cp16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x * 4; i < bytes; i += kThreads * 4) cp4(dst + i, src + i);
  }
}

struct Params {
  int64_t n;               // rows
  int64_t rows_per_block;  // P, a multiple of tile
  int v, d, lo;
  int copies, warps_per_copy, tile;
  int tab_bytes;           // C * V * D * 4, rounded up to 16
  int ids_offset;          // within a stage: the g tile's bytes, rounded up to 16
  int stage_bytes;
};

template <typename Id, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
embedding_bwd_partials(const float* __restrict__ g, const Id* __restrict__ ids,
                       float* __restrict__ partials, const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tabs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + p.tab_bytes;
  const int vd = p.v * p.d;
  for (int i = threadIdx.x; i < p.copies * vd; i += kThreads) tabs[i] = 0.f;

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * p.rows_per_block;
  const int64_t r1 = min64(p.n, r0 + p.rows_per_block);
  const int tiles = static_cast<int>((r1 - r0 + p.tile - 1) / p.tile);

  // Tile t into stage t mod kStages; one commit group a tile, empty past
  // the last, so that cp_wait<kStages - 1> always leaves tile t complete.
  auto issue = [&](int t) {
    if (t < tiles) {
      const int64_t start = r0 + static_cast<int64_t>(t) * p.tile;
      const int rows = static_cast<int>(min64(p.tile, r1 - start));
      unsigned char* dst = ring + (t % kStages) * p.stage_bytes;
      stage(dst, reinterpret_cast<const unsigned char*>(g + start * p.d), rows * p.d * 4);
      stage(dst + p.ids_offset, reinterpret_cast<const unsigned char*>(ids + start),
            rows * static_cast<int>(sizeof(Id)));
    }
    cp_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int copy = warp / p.warps_per_copy, slot = warp % p.warps_per_copy;
  const int w = p.warps_per_copy;
  float* tab = tabs + copy * vd;
  for (int t = 0; t < tiles; ++t) {
    issue(t + kStages - 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* st = ring + (t % kStages) * p.stage_bytes;
    const float* gs = reinterpret_cast<const float*>(st);
    const Id* is = reinterpret_cast<const Id*>(st + p.ids_offset);
    const int rows = static_cast<int>(min64(p.tile, r1 - r0 - static_cast<int64_t>(t) * p.tile));
    // Every lane of the warp runs the same chunks: the match is warp-wide.
    for (int k = copy; k * 32 < rows; k += p.copies) {
      const int row = k * 32 + lane;
      int key = -1;
      if (row < rows) {
        const Id id = is[row];
        if (id >= p.lo && id < p.v) key = static_cast<int>(id);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      // The lowest lane of a valid id's group sums it.
      if (key >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
        using W = typename Word<VEC>::T;
        constexpr int kWords = kCols / VEC;
        const int dw = p.d / VEC;
        const unsigned rest = peers & (peers - 1u);
        const W* chunk = reinterpret_cast<const W*>(gs) + static_cast<int64_t>(k) * 32 * dw;
        const W* mine = chunk + lane * dw;
        W* cell = reinterpret_cast<W*>(tab) + key * dw;
        // This warp's words of the row: slot, slot + w, ...
        for (int j0 = slot; j0 < dw; j0 += kWords * w) {
          W acc[kWords];
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            const int q = j0 + j * w;
            acc[j] = q < dw ? mine[q] : Word<VEC>::zero();
          }
          for (unsigned m = rest; m != 0u; m &= m - 1u) {
            const W* peer = chunk + (__ffs(m) - 1) * dw;
#pragma unroll
            for (int j = 0; j < kWords; ++j) {
              const int q = j0 + j * w;
              if (q < dw) Word<VEC>::add(acc[j], peer[q]);
            }
          }
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            const int q = j0 + j * w;
            if (q < dw) {
              W c = cell[q];
              Word<VEC>::add(c, acc[j]);
              cell[q] = c;
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's issue
  }
  __syncthreads();
  float* out = partials + static_cast<int64_t>(blockIdx.x) * vd;
  for (int i = threadIdx.x; i < vd; i += kThreads) {
    float s = tabs[i];
    for (int q = 1; q < p.copies; ++q) s += tabs[q * vd + i];
    out[i] = s;
  }
}

// grad[i] = the blocks' partials at i added in block order, from 0.
__global__ void __launch_bounds__(kReduceThreads)
embedding_bwd_reduce(const float* __restrict__ partials, float* __restrict__ grad, int vd,
                     int blocks) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= vd) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += __ldg(partials + static_cast<int64_t>(b) * vd + i);
  grad[i] = s;
}

int align16(int64_t x) { return static_cast<int>((x + 15) / 16 * 16); }

template <typename Id, int VEC>
cudaError_t launch_partials(const float* g, const Id* ids, float* partials, const Params& p,
                            int grid, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(embedding_bwd_partials<Id, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  embedding_bwd_partials<Id, VEC><<<grid, kThreads, smem, s>>>(g, ids, partials, p);
  return cudaGetLastError();
}

template <typename Id>
cudaError_t launch(const float* g, const Id* ids, float* partials, float* grad, const Params& p,
                   int grid, int smem, cudaStream_t s) {
  if (p.n > 0) {
    // Rows, tiles and table copies are 8-byte aligned where D is even.
    const cudaError_t err = p.d % 2 == 0
                                ? launch_partials<Id, 2>(g, ids, partials, p, grid, smem, s)
                                : launch_partials<Id, 1>(g, ids, partials, p, grid, smem, s);
    if (err != cudaSuccess) return err;
  }
  const int vd = p.v * p.d;
  embedding_bwd_reduce<<<(vd + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      partials, grad, vd, p.n > 0 ? grid : 0);
  return cudaGetLastError();
}

}  // namespace

// `a`: the launch's int64 scalars, {N, V, D, lo, id bytes (4 or 8), then the
// plan of ops/embedding.py::bwd_plan (copies, warps a copy, tile rows, rows
// a block, grid), device}, cached there per shape. `partials` holds grid *
// V * D floats; `grad` V * D. g, ids 4-byte aligned (ids of 8 bytes,
// 8-byte aligned).
extern "C" int embedding_bwd_f32(const void* g, const void* ids, void* partials, void* grad,
                                 const int64_t* a, void* stream) {
  if (a == nullptr) return cudaErrorInvalidValue;
  const int64_t n = a[0], v = a[1], d = a[2], lo = a[3], id_bytes = a[4];
  const int64_t copies = a[5], wpc = a[6], tile = a[7], per_block = a[8], grid = a[9];
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(ids);
  if (n < 0 || v < 1 || d < 1 || v * d > kMaxSmem / 4 || (lo != 0 && lo != 1) ||
      (id_bytes != 4 && id_bytes != 8) || (reinterpret_cast<uintptr_t>(ids) % id_bytes) != 0 ||
      ptrs % 4 != 0 || (copies != 1 && copies != 2 && copies != 4 && copies != 8) ||
      copies * wpc * 32 != kThreads || tile < 32 * copies || tile % (32 * copies) != 0 ||
      tile > (1 << 20) || per_block < tile || per_block % tile != 0 || grid < 0 ||
      grid > INT32_MAX || grid * per_block < n || (n > 0 && (grid - 1) * per_block >= n) ||
      (n == 0) != (grid == 0)) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  p.n = n;
  p.rows_per_block = per_block;
  p.v = static_cast<int>(v);
  p.d = static_cast<int>(d);
  p.lo = static_cast<int>(lo);
  p.copies = static_cast<int>(copies);
  p.warps_per_copy = static_cast<int>(wpc);
  p.tile = static_cast<int>(tile);
  p.tab_bytes = align16(copies * v * d * 4);
  p.ids_offset = align16(tile * d * 4);
  p.stage_bytes = p.ids_offset + align16(tile * id_bytes);
  const int64_t smem = static_cast<int64_t>(p.tab_bytes) + kStages * static_cast<int64_t>(p.stage_bytes);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  DeviceGuard guard(static_cast<int>(a[10]));
  if (guard.status() != cudaSuccess) return guard.status();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  float* out = static_cast<float*>(grad);
  const float* gf = static_cast<const float*>(g);
  if (id_bytes == 4) {
    return launch(gf, static_cast<const int32_t*>(ids), part, out, p, static_cast<int>(grid),
                  static_cast<int>(smem), s);
  }
  return launch(gf, static_cast<const int64_t*>(ids), part, out, p, static_cast<int>(grid),
                static_cast<int>(smem), s);
}
