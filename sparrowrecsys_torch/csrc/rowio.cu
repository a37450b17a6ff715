// Row gather and row write on a [V, row_bytes] table, dtype-agnostic.
//   rows_gather: out[i, :] = table[ids[i], :]           ids in [0, V); any other id: a zero row
//   rows_write:  table[ids[i], :] = rows[i, :] in place  ids outside [0, V) skipped
//
// Replaces: sparrowrecsys_tpu/ops/rowio.py::rows_gather_pallas (:103, body
// _gather_kernel :77) and rows_write_pallas (:172, body _write_kernel
// :142). On the TPU each row is one DMA with a rolling pipeline of 8 in
// flight, and Mosaic restricted the rows to exactly one f32 lane tile
// ([*, 128] f32). Here any row width and dtype is taken: a row is bytes.
//
// Bound on the H100: bytes. A gather reads each distinct row and the U
// ids once and writes U rows; a write reads the U ids and the in-range
// rows and writes those rows. The lazy row-Adam (training/row_optim.py)
// runs, per sparse table and step, a [U, 3D] buffer gather, a [U, D]
// gradient gather and a [U, 3D] write at U = 65536. At DeepFMv2's user
// buffer [30001, 30] f32 (26,629 distinct ids in a synthetic batch) the
// gather's bound is 3.4 us and the write's 2.0 us.
//
// What held the first design back (one warp a row, grid-stride): 10.2 us
// of device time for that gather and 7.8 us for that write on an H100 at
// 700 W, 3.0x and 3.9x their bounds. Each warp paid two dependent round
// trips to memory per row (lane 0 loaded the id, a shuffle broadcast it,
// then the row load) with one row in flight; words were 16, 4 or 2 bytes,
// so a 120-byte row moved as 30 words of 4 bytes and a 40-byte row used
// 10 of 32 lanes; 65,536 rows made 7.8 waves of resident blocks.
//
// This design:
// - A word is the widest of 16, 8, 4 and 2 bytes that divides the row and
//   aligns both row pointers: a 120-byte row is 15 words of 8 bytes, a
//   40-byte row 5.
// - A row group is L lanes, L the smallest power of two >= the row's
//   words, at most 32, so a warp moves 32 / L rows at once and narrow rows
//   leave few lanes idle; a row wider than 32 words loops within its group.
// - Each group keeps R = 2 rows in flight. Its lanes first load the R ids
//   (the groups of a block read one contiguous run of ids per slot, so a
//   warp's id loads coalesce), then start all R row loads before any
//   store: the two round trips are paid once per R rows.
// - A block of 256 threads takes (256 / L) * R consecutive rows, slot r of
//   group g being row r * (256 / L) + g, so each slot's stores of a gather
//   (and loads of a write) are one contiguous run. The grid is sized to the
//   rows, capped at one resident wave (132 SMs x 8 blocks), beyond which
//   blocks loop over the rows (grid-stride).
// The plan (word bytes, L, grid) is the caller's (ops/rowio.py::
// launch_plan, checked by CPU tests); the entry points refuse one that
// does not fit the row and the pointers. With R = 2 every instantiation
// fits in 32 registers, so 8 blocks stay resident on an SM; R = 4 and 8
// took more and were no faster (PERF.md). At the trainer's
// [30001, 30] f32 the gather takes 5.0-5.1 us and the write 3.6-3.9 us
// of device time (H100 at 700 W), against 10.2 and 7.8 before.
//
// rows_write requires distinct ids: two groups writing one row would race,
// as two DMAs would on the TPU; the caller (row_optim's sorted unique ids)
// guarantees it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int R = 2;  // rows in flight per lane group (ops/rowio.py::ROWS_IN_FLIGHT)

template <typename W>
__global__ void __launch_bounds__(kThreads)
rows_gather_kernel(const W* __restrict__ table, const int32_t* __restrict__ ids,
                   W* __restrict__ out, int64_t v, int64_t u, int row_words, int lane_bits) {
  const int lane = threadIdx.x & ((1 << lane_bits) - 1);
  const int groups = kThreads >> lane_bits;
  const int64_t block_rows = static_cast<int64_t>(groups) * R;
  for (int64_t first = blockIdx.x * block_rows + (threadIdx.x >> lane_bits); first < u;
       first += gridDim.x * block_rows) {
    int64_t src[R];  // word offset of each slot's table row; -1: a zero row
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = first + r * groups;
      const int32_t id = i < u ? __ldg(ids + i) : -1;
      // Outside the contract (ids in [0, V)): a zero row, never a stray read.
      src[r] = id >= 0 && id < v ? static_cast<int64_t>(id) * row_words : -1;
    }
    for (int k = lane; k < row_words; k += 1 << lane_bits) {
      W w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = src[r] >= 0 ? __ldg(table + src[r] + k) : W{};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t i = first + r * groups;
        if (i < u) out[i * row_words + k] = w[r];
      }
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
rows_write_kernel(W* __restrict__ table, const int32_t* __restrict__ ids,
                  const W* __restrict__ rows, int64_t v, int64_t u, int row_words, int lane_bits) {
  const int lane = threadIdx.x & ((1 << lane_bits) - 1);
  const int groups = kThreads >> lane_bits;
  const int64_t block_rows = static_cast<int64_t>(groups) * R;
  for (int64_t first = blockIdx.x * block_rows + (threadIdx.x >> lane_bits); first < u;
       first += gridDim.x * block_rows) {
    int64_t dst[R];  // word offset of each slot's table row; -1: a drop slot
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = first + r * groups;
      const int32_t id = i < u ? __ldg(ids + i) : -1;
      dst[r] = id >= 0 && id < v ? static_cast<int64_t>(id) * row_words : -1;
    }
    for (int k = lane; k < row_words; k += 1 << lane_bits) {
      W w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        w[r] = dst[r] >= 0 ? __ldg(rows + (first + r * groups) * row_words + k) : W{};
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (dst[r] >= 0) table[dst[r] + k] = w[r];
      }
    }
  }
}

template <bool WRITE, typename W>
void run(void* table, const int32_t* ids, void* rows, int64_t v, int64_t u, int row_words,
         int lane_bits, int grid, cudaStream_t s) {
  if (WRITE) {
    rows_write_kernel<W><<<grid, kThreads, 0, s>>>(
        static_cast<W*>(table), ids, static_cast<const W*>(rows), v, u, row_words, lane_bits);
  } else {
    rows_gather_kernel<W><<<grid, kThreads, 0, s>>>(
        static_cast<const W*>(table), ids, static_cast<W*>(rows), v, u, row_words, lane_bits);
  }
}

template <bool WRITE>
int launch(void* table, const void* ids, void* rows, int64_t v, int64_t u, int64_t row_bytes,
           int64_t word_bytes, int64_t lanes, int64_t grid, int64_t device, void* stream) {
  if (u == 0) return cudaSuccess;
  const uintptr_t p = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(rows);
  int lane_bits = 0;
  while ((1 << lane_bits) < lanes && lane_bits < 5) ++lane_bits;
  const int64_t row_words = word_bytes > 0 ? row_bytes / word_bytes : 0;
  if (word_bytes <= 0 || row_bytes % word_bytes != 0 || p % word_bytes != 0 ||
      reinterpret_cast<uintptr_t>(ids) % 4 != 0 || lanes != 1 << lane_bits ||
      row_words < 1 || row_words > INT32_MAX || v < 0 || u < 0 || grid < 1 ||
      grid > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  DeviceGuard guard(static_cast<int>(device));
  if (guard.status() != cudaSuccess) return guard.status();
  const auto* id = static_cast<const int32_t*>(ids);
  const int words = static_cast<int>(row_words);
  const int g = static_cast<int>(grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16: run<WRITE, int4>(table, id, rows, v, u, words, lane_bits, g, s); break;
    case 8: run<WRITE, uint2>(table, id, rows, v, u, words, lane_bits, g, s); break;
    case 4: run<WRITE, uint32_t>(table, id, rows, v, u, words, lane_bits, g, s); break;
    case 2: run<WRITE, unsigned short>(table, id, rows, v, u, words, lane_bits, g, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// `a`: the launch's seven int64 scalars, {V, U, row bytes, then the plan
// (word bytes: 16, 8, 4 or 2; lanes per row group: a power of two <= 32;
// grid: blocks of 256), device}. The caller keeps one such array per
// launch shape (ops/rowio.py), so a call converts five arguments, not
// eleven.
extern "C" int rows_gather(const void* table, const void* ids, void* out, const int64_t* a,
                           void* stream) {
  if (a == nullptr) return cudaErrorInvalidValue;
  return launch<false>(const_cast<void*>(table), ids, out, a[0], a[1], a[2], a[3], a[4], a[5],
                       a[6], stream);
}

extern "C" int rows_write(void* table, const void* ids, const void* rows, const int64_t* a,
                          void* stream) {
  if (a == nullptr) return cudaErrorInvalidValue;
  return launch<true>(table, ids, const_cast<void*>(rows), a[0], a[1], a[2], a[3], a[4], a[5],
                      a[6], stream);
}
