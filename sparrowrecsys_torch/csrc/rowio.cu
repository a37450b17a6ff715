// Row gather and row write on a [V, row_bytes] table, dtype-agnostic.
//   rows_gather: out[i, :] = table[ids[i], :]           ids in [0, V)
//   rows_write:  table[ids[i], :] = rows[i, :] in place  ids outside [0, V) skipped
//
// Replaces: sparrowrecsys_tpu/ops/rowio.py::rows_gather_pallas (:103, body
// _gather_kernel :77) and rows_write_pallas (:172, body _write_kernel
// :142). On the TPU each row is one DMA with a rolling pipeline of 8 in
// flight, and Mosaic restricted the rows to exactly one f32 lane tile
// ([*, 128] f32). Here any row width and dtype is taken: a row is bytes.
// The lazy row-Adam (training/row_optim.py) gathers its [U, 3D] buffer
// rows and [U, D] gradient rows through rows_gather and writes the
// [U, 3D] rows back through rows_write.
//
// Bound on the H100: bytes. A gather reads U rows and U ids and writes U
// rows; a write reads U rows and ids and writes U rows. At U=65536 rows
// of 512 bytes that is 67 MB, 20 us at 3.35 TB/s; at the trainer's
// [30001, 30] f32 buffer with ~60k touched ids, 29 MB.
//
// Design: one warp per row, grid-stride over rows. Lane l copies the
// row's words l, l + 32, ... so a warp reads and writes its row in
// consecutive, coalesced words. A word is 16 bytes where the row width
// and both row pointers allow it, else 4 bytes, else 2 (an odd-width
// bf16 row). The warp reads its id once (lane 0 loads, a shuffle
// broadcasts it). rows_write requires distinct ids: two warps writing
// one row would race, as two DMAs would on the TPU; the caller
// (row_optim's sorted unique ids) guarantees it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename W>
__global__ void __launch_bounds__(kThreads)
rows_gather_kernel(const W* __restrict__ table, const int32_t* __restrict__ ids,
                   W* __restrict__ out, int64_t v, int64_t u, int64_t row_words) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = warp; i < u; i += n_warps) {
    int32_t id = lane == 0 ? __ldg(ids + i) : 0;
    id = __shfl_sync(0xffffffffu, id, 0);
    W* dst = out + i * row_words;
    if (id < 0 || id >= v) {
      // Outside the contract (ids in [0, V)): a zero row, never a stray read.
      for (int64_t k = lane; k < row_words; k += 32) dst[k] = W{};
      continue;
    }
    const W* src = table + static_cast<int64_t>(id) * row_words;
    for (int64_t k = lane; k < row_words; k += 32) dst[k] = __ldg(src + k);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
rows_write_kernel(W* __restrict__ table, const int32_t* __restrict__ ids,
                  const W* __restrict__ rows, int64_t v, int64_t u, int64_t row_words) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = warp; i < u; i += n_warps) {
    int32_t id = lane == 0 ? __ldg(ids + i) : 0;
    id = __shfl_sync(0xffffffffu, id, 0);
    if (id < 0 || id >= v) continue;  // a drop slot: skipped, as mode="drop"
    W* dst = table + static_cast<int64_t>(id) * row_words;
    const W* src = rows + i * row_words;
    for (int64_t k = lane; k < row_words; k += 32) dst[k] = __ldg(src + k);
  }
}

// The widest word (16, 4 or 2 bytes) that divides the row and aligns every pointer.
int word_bytes(int64_t row_bytes, const void* a, const void* b) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  for (int w : {16, 4, 2}) {
    if (row_bytes % w == 0 && p % w == 0) return w;
  }
  return 0;
}

int grid_for(int64_t u) {
  const int64_t blocks = (u + kWarps - 1) / kWarps;
  return static_cast<int>(blocks < (1 << 16) ? blocks : (1 << 16));
}

template <bool WRITE, typename W>
void run(void* table, const int32_t* ids, void* rows, int64_t v, int64_t u,
         int64_t row_words, cudaStream_t s) {
  if (WRITE) {
    rows_write_kernel<W><<<grid_for(u), kThreads, 0, s>>>(
        static_cast<W*>(table), ids, static_cast<const W*>(rows), v, u, row_words);
  } else {
    rows_gather_kernel<W><<<grid_for(u), kThreads, 0, s>>>(
        static_cast<const W*>(table), ids, static_cast<W*>(rows), v, u, row_words);
  }
}

template <bool WRITE>
int launch(void* table, const void* ids, void* rows, int64_t v, int64_t u,
           int64_t row_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (u == 0 || row_bytes == 0) return cudaSuccess;
  const int w = word_bytes(row_bytes, table, rows);
  const auto* id = static_cast<const int32_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 16: run<WRITE, int4>(table, id, rows, v, u, row_bytes / 16, s); break;
    case 4: run<WRITE, int32_t>(table, id, rows, v, u, row_bytes / 4, s); break;
    case 2: run<WRITE, unsigned short>(table, id, rows, v, u, row_bytes / 2, s); break;
    default: return cudaErrorMisalignedAddress;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int rows_gather(const void* table, const void* ids, void* out, int64_t v,
                           int64_t u, int64_t row_bytes, int device, void* stream) {
  return launch<false>(const_cast<void*>(table), ids, out, v, u, row_bytes, device, stream);
}

extern "C" int rows_write(void* table, const void* ids, const void* rows, int64_t v,
                          int64_t u, int64_t row_bytes, int device, void* stream) {
  return launch<true>(table, ids, const_cast<void*>(rows), v, u, row_bytes, device, stream);
}
