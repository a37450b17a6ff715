// DIN activation unit (target attention) at narrow widths, D <= 16 and
// H <= 32, forward and backward, float32 on the CUDA cores.
//
// Replaces, at these widths, sparrowrecsys_tpu/ops/attention.py::
// din_attention_pallas (:73), whose body _din_kernel runs _unit (:27-50),
// and the per-step part of its VJP _din_fused_bwd (:119) together with
// the weight-gradient products that XLA computes for jax.vjp(_unit):
//   a     = [h, c, h*c] @ [wa+wb; wc-wa; wd] + b1     w1 = [wa; wb; wc; wd], [4D, H]
//   a     = PReLU(a, alpha)
//   w     = sigmoid(a @ w2 + b2), and 0 where the row h is all zero
//   out   = sum_t w_t * h_t                          [B, D]
// ops/attention.py::narrow picks these kernels by D and H; wider units
// take csrc/din_attention.cu (the tensor cores). The two share no code.
//
// Bound on the H100. At the training cell's [131072, 64, 10], H = 32, the
// forward reads the history once (335 MB) and writes [B, D]: 0.103 ms of
// bytes at 3.35 TB/s. With the candidate folded into the weight once per
// row, a step is D*H + 2*H multiply-adds (about 0.77 kFLOP), 6.5 GFLOP in
// all: 0.10 ms of FFMA at 67 TFLOP/s. The backward reads the history and
// writes dh (687 MB in all, 0.205 ms) and does about three such products
// a step (recompute, dh, and R = sum_t h_t^T dapre_t), 17 GFLOP: 0.26 ms.
// Both sit near the line between bytes and operations, so they must
// neither move extra bytes nor waste instructions. On an H100 SXM at
// 700 W the forward takes 0.27 ms and the backward 0.91 ms there
// (tools/kernel_bench.py).
//
// Why the CUDA cores and not the tensor cores: at D = 10 a step's product
// has K = 10 (or 20 unfolded). An mma tile pads K to 8s and needs three
// TF32 products per float32 product to keep float32 accuracy, plus its
// operand shuffling and an epilogue through shared memory; the wide
// design in csrc/din_attention.cu ran at 4.7% (forward) and 3.5%
// (backward) of the bounds above, the backward writing dapre [B*T, H] and
// [h, h*c] [B*T, 2D] (1.74 GB) for cuBLAS to read back. Plain FFMA in
// float32 does the same arithmetic in one pass, with no TF32, no bf16 and
// no term left out; the fold changes only where float32 rounds.
//
// Design. H is padded to 32 with zero weights (a zero column's
// pre-activation, PReLU and w2 are 0, so the padding is exact), D to an
// even DP (a template parameter) with zero history elements.
// - Per row, lane j folds its column of the weight: W_c[:, j] =
//   (wa+wb)[:, j] + c * wd[:, j] and u_c[j] = b1[j] + c . (wc-wa)[:, j],
//   into the warp's shared memory.
// - A lane takes a step. It reads its history row into registers (8- or
//   16-byte loads where the width and pointers allow) and forms the 32
//   pre-activations as h_t . W_c + u_c, reading W_c as 16-byte broadcasts
//   (the lanes of a row read the same words; `lds4` keeps the compiler
//   from hoisting them into registers), then PReLU, the dot with w2, b2,
//   the sigmoid and the all-zero-row mask. Nothing per step goes to
//   device memory.
// - The forward's warp takes a group of group_rows(T) rows: for T < 32 as
//   many whole histories as fill its lanes (6 at T = 5), their folded
//   weights in banks apart; for longer ones one row in passes, two steps a
//   lane (t and t + 32) while more than 32 remain, so that each weight
//   read serves two. Each lane pools w_t h_t in registers; the row's sum
//   over its lanes, a tree of shuffles, is written once.
// - The backward's warp takes a row at a time, in passes of 32 steps. It
//   recomputes the same, forms dlogit, and writes the pass's
//   pre-activations, dlogit and history to a tile of shared memory. Lane j
//   then walks the tile's steps in order and sums its column: R_b[:, j] =
//   sum_t h_t dapre_t[j], dsum_j, dalpha_j, dw2_j. Lane t keeps its
//   pre-activations in registers and forms dh_t = w_t g + dapre_t . W_c^T
//   from them, and sums its own steps' dlogit (db2). At the row's end,
//   dc[k] = sum_j (wc-wa)[k, j] dsum_j + wd[k, j] R_b[k, j] (a butterfly
//   sum over j), and the warp adds R_b, diag(c) R_b and c^T dsum into its
//   dk0, dk2 and dk1 in shared memory.
// - Deterministic. The rows are cut into units of ops/attention.py::
//   unit_rows (at most 4,096 steps, about 2,048 units), fixed by B and
//   T alone; the warp that takes a unit sums each row's steps in order,
//   then the rows' sums in order (no running sum outlasts a row), and
//   writes one partial: [dk0 | db1], [dk1 | dalpha], [dk2 | dw2], db2.
//   din_narrow_reduce sums the partials in a fixed order (32 interleaved
//   runs, then the runs in order) and unfolds dw1 = [dk0 - dk1; dk0; dk1;
//   dk2], as _din_weight_grads does for the wide design. No float atomics:
//   two calls agree bit for bit, whatever the grid.
// - As in the reference, the PReLU sends the gradient at exactly 0 to the
//   identity branch, the all-zero mask passes no gradient, and a masked
//   step contributes nothing (its dlogit and step weight are 0).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"

namespace {

constexpr int kFwdWarps = 4;
constexpr int kBwdWarps = 4;
constexpr int kReduceWarps = 32;
constexpr int kGroups = 8;          // the 32 hidden columns in float4 groups
constexpr int kPitch = 36;          // the tile's pre-activation rows (odd quarter)
constexpr int kMaxRows = 8;         // batch rows a warp takes at once (short histories)
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

// The launch's int64 scalars (ops/attention.py::_narrow_scalars), by index.
enum Scalar { kBatch, kSteps, kD, kH, kUnitRows, kDevice, kScalars };

// Batch rows a forward warp takes at once: as many whole histories as
// fill its 32 lanes (at most kMaxRows), or one that takes passes of 32.
__host__ __device__ inline int group_rows(int t) {
  return t >= 32 ? 1 : (32 / t < kMaxRows ? 32 / t : kMaxRows);
}

struct Shape {
  int64_t b;
  int t, d, h;
  int rows;  // group_rows(t)
  int64_t unit_rows;
  int vec;  // history and dh rows moved by 4 floats, 2 floats, or (0) one at a time
};

// A row pitch for DP floats: a multiple of 4 whose quarter is odd, so that
// 16-byte stores of 8 consecutive lanes fall in distinct banks.
constexpr int odd_pitch(int dp) {
  return ((dp + 3) / 4) % 2 ? (dp + 3) / 4 * 4 : (dp + 3) / 4 * 4 + 4;
}

// Shared memory in floats. The block's constants: wa+wb, wd, wc-wa as
// [DP][32], then b1, alpha, w2, alpha * w2 [32]. A row's folded weight:
// W_c [DP][32] and u_c [32], padded by 4 so that the rows of a forward
// warp's group fall in different banks. A forward warp holds `rows` of
// them; a backward warp one, the tile
// (pre-activations [32][kPitch], dlogit [32], history [32][kSH]) and
// dk0, dk1, dk2 [DP][32].
template <int DP>
struct Layout {
  static constexpr int kWab = 0, kWd = DP * 32, kWcma = 2 * DP * 32, kB1 = 3 * DP * 32,
                       kAlpha = kB1 + 32, kW2 = kAlpha + 32, kAW2 = kW2 + 32,
                       kConsts = kAW2 + 32;
  static constexpr int kSH = odd_pitch(DP);
  static constexpr int kWc = 0, kU = DP * 32, kRow = kU + 36;
  static constexpr int kP = kRow, kDL = kP + 32 * kPitch, kHs = kDL + 32,
                       kDk = kHs + 32 * kSH, kBwdSlot = kDk + 3 * DP * 32;
  static constexpr size_t fwd_bytes(int rows) {
    return 4u * (kConsts + kFwdWarps * rows * kRow);
  }
  static constexpr size_t bwd_bytes() { return 4u * (kConsts + kBwdWarps * kBwdSlot); }
};

// A unit's partial row: three planes of [D + 1][32] ([dk | small]) and db2,
// padded to a multiple of 32 floats (ops/attention.py::narrow_partial_width).
__host__ __device__ inline int partial_width(int d) { return 3 * (d + 1) * 32 + 32; }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// A 16-byte load from shared memory that stays where it is written. The
// step loops read the folded weight, alpha and w2 as broadcasts on
// purpose; left to itself the compiler hoists those loop-invariant reads
// into registers (hundreds of them, spilled to local memory).
__device__ __forceinline__ float4 lds4(const float4* p) {
  float4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
// PReLU's slope at a times w2: prelu(a) * w2 = a * slope(a, w2, alpha * w2).
// At exactly 0 the identity branch, as the reference takes.
__device__ __forceinline__ float slope(float a, float w2, float aw2) { return a < 0.f ? aw2 : w2; }
__device__ __forceinline__ float prelu(float a, float al) { return a < 0.f ? al * a : a; }

template <int DP>
__device__ void load_consts(float* sm, const float* w1, const float* b1, const float* alpha,
                            const float* w2, int d, int h) {
  using L = Layout<DP>;
  for (int i = threadIdx.x; i < DP * 32; i += blockDim.x) {
    const int k = i >> 5, j = i & 31;
    float wa = 0.f, wb = 0.f, wc = 0.f, wd = 0.f;
    if (k < d && j < h) {
      wa = w1[k * h + j];
      wb = w1[(d + k) * h + j];
      wc = w1[(2 * d + k) * h + j];
      wd = w1[(3 * d + k) * h + j];
    }
    sm[L::kWab + i] = wa + wb;
    sm[L::kWd + i] = wd;
    sm[L::kWcma + i] = wc - wa;
  }
  for (int j = threadIdx.x; j < 32; j += blockDim.x) {
    const bool in = j < h;
    sm[L::kB1 + j] = in ? b1[j] : 0.f;
    sm[L::kAlpha + j] = in ? alpha[j] : 0.f;
    sm[L::kW2 + j] = in ? w2[j] : 0.f;
    sm[L::kAW2 + j] = in ? alpha[j] * w2[j] : 0.f;
  }
}

// Row b's candidate (or output gradient), DP floats: every lane reads the
// same words.
template <int DP>
__device__ __forceinline__ void load_bcast(const float* p, int d, float (&x)[DP]) {
#pragma unroll
  for (int k = 0; k < DP; ++k) x[k] = k < d ? p[k] : 0.f;
}

template <int DP>
__device__ __forceinline__ void load_row(const float* p, int d, int vec, bool valid,
                                         float (&x)[DP]) {
#pragma unroll
  for (int k = 0; k < DP; ++k) x[k] = 0.f;
  if (!valid) return;
  if constexpr (DP % 4 == 0) {
    if (vec == 4) {
#pragma unroll
      for (int k = 0; k < DP; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + k);
        x[k] = v.x, x[k + 1] = v.y, x[k + 2] = v.z, x[k + 3] = v.w;
      }
      return;
    }
  }
  if (vec >= 2) {
#pragma unroll
    for (int k = 0; k < DP; k += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + k);
      x[k] = v.x, x[k + 1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < DP; ++k)
    if (k < d) x[k] = p[k];
}

template <int DP>
__device__ __forceinline__ void store_row(float* p, int d, int vec, const float (&x)[DP]) {
  if constexpr (DP % 4 == 0) {
    if (vec == 4) {
#pragma unroll
      for (int k = 0; k < DP; k += 4)
        *reinterpret_cast<float4*>(p + k) = make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
      return;
    }
  }
  if (vec >= 2) {
#pragma unroll
    for (int k = 0; k < DP; k += 2) *reinterpret_cast<float2*>(p + k) = make_float2(x[k], x[k + 1]);
    return;
  }
#pragma unroll
  for (int k = 0; k < DP; ++k)
    if (k < d) p[k] = x[k];
}

// Lane j folds column j of row b's weight into the warp's slot:
// W_c[k][j] = (wa+wb)[k][j] + c_k wd[k][j], u_c[j] = b1[j] + sum_k c_k (wc-wa)[k][j].
template <int DP>
__device__ __forceinline__ void fold(const float* sm, float* slot, const float (&c)[DP],
                                     int lane) {
  using L = Layout<DP>;
  float u = sm[L::kB1 + lane];
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    const int i = k * 32 + lane;
    u = fmaf(c[k], sm[L::kWcma + i], u);
    slot[L::kWc + i] = fmaf(c[k], sm[L::kWd + i], sm[L::kWab + i]);
  }
  slot[L::kU + lane] = u;
}

// Hidden columns 4g..4g+3 of a step's pre-activation: u_c + sum_k h_k W_c[k].
template <int DP>
__device__ __forceinline__ float4 pre4(const float (&x)[DP], const float4* wc4, const float4* u4,
                                       int g) {
  float4 a = lds4(u4 + g);
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    const float4 w = lds4(wc4 + k * kGroups + g);
    a.x = fmaf(x[k], w.x, a.x);
    a.y = fmaf(x[k], w.y, a.y);
    a.z = fmaf(x[k], w.z, a.z);
    a.w = fmaf(x[k], w.w, a.w);
  }
  return a;
}

// logit + the four columns' prelu(a) * w2, as a * slope(a, w2, alpha * w2).
__device__ __forceinline__ float logit4(float4 a, float4 w, float4 aw, float logit) {
  logit = fmaf(a.x, slope(a.x, w.x, aw.x), logit);
  logit = fmaf(a.y, slope(a.y, w.y, aw.y), logit);
  logit = fmaf(a.z, slope(a.z, w.z, aw.z), logit);
  return fmaf(a.w, slope(a.w, w.w, aw.w), logit);
}

template <int DP>
__device__ __forceinline__ bool nonzero(const float (&x)[DP]) {
  bool live = false;
#pragma unroll
  for (int k = 0; k < DP; ++k) live |= x[k] != 0.f;
  return live;
}

// Sum x over the warp's lanes (a butterfly: every lane gets the sum), and
// lane k < d writes element k to out.
template <int DP>
__device__ __forceinline__ void lane_sum_store(float (&x)[DP], int lane, int d, float* out) {
#pragma unroll
  for (int k = 0; k < DP; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x[k] += __shfl_xor_sync(kAll, x[k], off);
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < DP; ++k)
    if (lane == k) v = x[k];
  if (lane < d) out[lane] = v;
}

struct FwdArgs {
  const float *hist, *cand, *w1, *b1, *alpha, *w2, *b2;
  float* out;
};

template <int DP>
__global__ void __launch_bounds__(kFwdWarps * 32) din_narrow_fwd_kernel(FwdArgs p, Shape s) {
  using L = Layout<DP>;
  extern __shared__ float4 shm4[];
  float* sm = reinterpret_cast<float*>(shm4);
  load_consts<DP>(sm, p.w1, p.b1, p.alpha, p.w2, s.d, s.h);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* slot = sm + L::kConsts + warp * s.rows * L::kRow;
  // Lane = (row r of the group, step tr of its pass): a row's lanes are
  // tl = min(T, 32) consecutive ones.
  const int tl = s.t < 32 ? s.t : 32, r = lane / tl, tr = lane - r * tl;
  const float* row_w = slot + (r < s.rows ? r : 0) * L::kRow;
  const float4* wc4 = reinterpret_cast<const float4*>(row_w + L::kWc);
  const float4* u4 = reinterpret_cast<const float4*>(row_w + L::kU);
  const float4* w24 = reinterpret_cast<const float4*>(sm + L::kW2);
  const float4* aw24 = reinterpret_cast<const float4*>(sm + L::kAW2);
  const float b2 = p.b2[0];
  for (int64_t b0 = (static_cast<int64_t>(blockIdx.x) * kFwdWarps + warp) * s.rows; b0 < s.b;
       b0 += static_cast<int64_t>(gridDim.x) * kFwdWarps * s.rows) {
    const int nr = s.b - b0 < s.rows ? static_cast<int>(s.b - b0) : s.rows;
    for (int q = 0; q < nr; ++q) {
      float c[DP];
      load_bcast<DP>(p.cand + (b0 + q) * s.d, s.d, c);
      fold<DP>(sm, slot + q * L::kRow, c, lane);
    }
    __syncwarp();
    const bool mine = r < nr;
    const float* hist = p.hist + (b0 + (mine ? r : 0)) * s.t * s.d;
    float pool[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) pool[k] = 0.f;
    for (int t0 = 0; t0 < s.t;) {
      if (s.t - t0 > 32) {
        // One row (T > 32). Steps t0 + lane and t0 + 32 + lane: each
        // weight read serves two.
        const int ta = t0 + lane, tb = ta + 32;
        float xa[DP], xb[DP];
        load_row<DP>(hist + static_cast<int64_t>(ta) * s.d, s.d, s.vec, true, xa);
        load_row<DP>(hist + static_cast<int64_t>(tb) * s.d, s.d, s.vec, tb < s.t, xb);
        float la = 0.f, lb = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          float4 pa = lds4(u4 + g);
          float4 pb = pa;
#pragma unroll
          for (int k = 0; k < DP; ++k) {
            const float4 w = lds4(wc4 + k * kGroups + g);
            pa.x = fmaf(xa[k], w.x, pa.x);
            pa.y = fmaf(xa[k], w.y, pa.y);
            pa.z = fmaf(xa[k], w.z, pa.z);
            pa.w = fmaf(xa[k], w.w, pa.w);
            pb.x = fmaf(xb[k], w.x, pb.x);
            pb.y = fmaf(xb[k], w.y, pb.y);
            pb.z = fmaf(xb[k], w.z, pb.z);
            pb.w = fmaf(xb[k], w.w, pb.w);
          }
          const float4 w2v = lds4(w24 + g), aw2v = lds4(aw24 + g);
          la = logit4(pa, w2v, aw2v, la);
          lb = logit4(pb, w2v, aw2v, lb);
        }
        const float wa = nonzero<DP>(xa) ? sigmoid(la + b2) : 0.f;
        const float wb = nonzero<DP>(xb) ? sigmoid(lb + b2) : 0.f;
#pragma unroll
        for (int k = 0; k < DP; ++k) pool[k] = fmaf(wb, xb[k], fmaf(wa, xa[k], pool[k]));
        t0 += 64;
      } else {
        const int t = t0 + tr;
        float x[DP];
        load_row<DP>(hist + static_cast<int64_t>(t) * s.d, s.d, s.vec, mine && t < s.t, x);
        float logit = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          logit = logit4(pre4<DP>(x, wc4, u4, g), lds4(w24 + g), lds4(aw24 + g), logit);
        // A lane past T or past the group's rows holds zeros: it is
        // masked, and adds nothing.
        const float wt = nonzero<DP>(x) ? sigmoid(logit + b2) : 0.f;
#pragma unroll
        for (int k = 0; k < DP; ++k) pool[k] = fmaf(wt, x[k], pool[k]);
        t0 += 32;
      }
    }
    // Each row's sum over its lanes, a tree of shuffles within the row's
    // segment; the row's first lane writes it.
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        const float up = __shfl_down_sync(kAll, pool[k], o);
        if (tr + o < tl) pool[k] += up;
      }
    if (mine && tr == 0) {
#pragma unroll
      for (int k = 0; k < DP; ++k)
        if (k < s.d) p.out[(b0 + r) * s.d + k] = pool[k];
    }
    __syncwarp();  // the next group's fold rewrites the slot
  }
}

struct BwdArgs {
  const float *hist, *cand, *w1, *b1, *alpha, *w2, *b2, *gout;
  float *dh, *dc, *partial;
};

template <int DP>
__global__ void __launch_bounds__(kBwdWarps * 32) din_narrow_bwd_kernel(BwdArgs p, Shape s) {
  using L = Layout<DP>;
  extern __shared__ float4 shm4[];
  float* sm = reinterpret_cast<float*>(shm4);
  load_consts<DP>(sm, p.w1, p.b1, p.alpha, p.w2, s.d, s.h);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* slot = sm + L::kConsts + warp * L::kBwdSlot;
  const float4* wc4 = reinterpret_cast<const float4*>(slot + L::kWc);
  const float4* u4 = reinterpret_cast<const float4*>(slot + L::kU);
  const float4* al4 = reinterpret_cast<const float4*>(sm + L::kAlpha);
  const float4* w24 = reinterpret_cast<const float4*>(sm + L::kW2);
  float* tile_p = slot + L::kP;
  float* tile_dl = slot + L::kDL;
  float* tile_h = slot + L::kHs;
  float* dk = slot + L::kDk;  // dk0, dk1, dk2: [DP][32] each, lane j owns column j
  const float alj = sm[L::kAlpha + lane], w2j = sm[L::kW2 + lane];
  const float b2 = p.b2[0];
  const int64_t units = (s.b + s.unit_rows - 1) / s.unit_rows;
  const int width = partial_width(s.d);
  for (int64_t unit = static_cast<int64_t>(blockIdx.x) * kBwdWarps + warp; unit < units;
       unit += static_cast<int64_t>(gridDim.x) * kBwdWarps) {
#pragma unroll
    for (int k = 0; k < 3 * DP; ++k) dk[k * 32 + lane] = 0.f;
    // Lane j's column sums over the unit, db2 each lane's over its own
    // steps: each a sum of the rows' sums, so that no running sum outlasts
    // a row.
    float db1 = 0.f, dalpha = 0.f, dw2 = 0.f, db2 = 0.f;
    const int64_t r0 = unit * s.unit_rows;
    const int64_t r1 = r0 + s.unit_rows < s.b ? r0 + s.unit_rows : s.b;
    for (int64_t b = r0; b < r1; ++b) {
      float g[DP];
      {
        float c[DP];
        load_bcast<DP>(p.cand + b * s.d, s.d, c);
        fold<DP>(sm, slot, c, lane);
      }
      load_bcast<DP>(p.gout + b * s.d, s.d, g);
      float rk[DP];
#pragma unroll
      for (int k = 0; k < DP; ++k) rk[k] = 0.f;
      float dsum = 0.f, row_dalpha = 0.f, row_dw2 = 0.f, row_db2 = 0.f;
      __syncwarp();
      for (int t0 = 0; t0 < s.t; t0 += 32) {
        // Lane t: recompute step t; the tile takes its pre-activations,
        // dlogit and history.
        const int t = t0 + lane;
        float x[DP];
        load_row<DP>(p.hist + (b * s.t + t) * s.d, s.d, s.vec, t < s.t, x);
        float4* prow = reinterpret_cast<float4*>(tile_p + lane * kPitch);
        float4 pk[kGroups];
        float logit = 0.f;
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          const float4 a = pre4<DP>(x, wc4, u4, gi), al = lds4(al4 + gi), w = lds4(w24 + gi);
          prow[gi] = a;
          pk[gi] = a;
          logit = fmaf(prelu(a.x, al.x), w.x, logit);
          logit = fmaf(prelu(a.y, al.y), w.y, logit);
          logit = fmaf(prelu(a.z, al.z), w.z, logit);
          logit = fmaf(prelu(a.w, al.w), w.w, logit);
        }
        const bool live = nonzero<DP>(x);
        const float sg = sigmoid(logit + b2);
        float gh = 0.f;
#pragma unroll
        for (int k = 0; k < DP; ++k) gh = fmaf(g[k], x[k], gh);
        const float dl = live ? gh * sg * (1.f - sg) : 0.f;
        const float wt = live ? sg : 0.f;
        row_db2 += dl;
        tile_dl[lane] = dl;
        float hx[L::kSH];
#pragma unroll
        for (int k = 0; k < L::kSH; ++k) hx[k] = 0.f;
#pragma unroll
        for (int k = 0; k < DP; ++k) hx[k] = x[k];
        float4* hrow = reinterpret_cast<float4*>(tile_h + lane * L::kSH);
#pragma unroll
        for (int q = 0; q < L::kSH / 4; ++q)
          hrow[q] = make_float4(hx[4 * q], hx[4 * q + 1], hx[4 * q + 2], hx[4 * q + 3]);
        __syncwarp();
        // Lane j: column j's sums over the pass's steps, in step order.
        const int n = s.t - t0 < 32 ? s.t - t0 : 32;
        for (int i = 0; i < n; ++i) {
          const float pj = tile_p[i * kPitch + lane];
          const float d = tile_dl[i];
          const float da = d * w2j;
          const bool neg = pj < 0.f;
          const float dap = neg ? alj * da : da;
          dsum += dap;
          row_dalpha = fmaf(neg ? pj : 0.f, da, row_dalpha);
          row_dw2 = fmaf(neg ? alj * pj : pj, d, row_dw2);
          const float4* hr = reinterpret_cast<const float4*>(tile_h + i * L::kSH);
          float hi[4 * ((DP + 3) / 4)];
#pragma unroll
          for (int q = 0; q < (DP + 3) / 4; ++q) {
            const float4 v = hr[q];
            hi[4 * q] = v.x, hi[4 * q + 1] = v.y, hi[4 * q + 2] = v.z, hi[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int k = 0; k < DP; ++k) rk[k] = fmaf(hi[k], dap, rk[k]);
        }
        // Lane t: dh_t = w_t g + dapre_t . W_c^T, its pre-activations read
        // back from the tile.
        float dhv[DP];
#pragma unroll
        for (int k = 0; k < DP; ++k) dhv[k] = wt * g[k];
        const float4* prow4 = reinterpret_cast<const float4*>(tile_p + lane * kPitch);
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          const float4 a = pk[gi], al = lds4(al4 + gi), w = lds4(w24 + gi);
          const float pa[4] = {a.x, a.y, a.z, a.w}, ws[4] = {w.x, w.y, w.z, w.w},
                      as[4] = {al.x, al.y, al.z, al.w};
          float dap[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float da = dl * ws[e];
            dap[e] = pa[e] < 0.f ? as[e] * da : da;
          }
#pragma unroll
          for (int k = 0; k < DP; ++k) {
            const float4 wv = lds4(wc4 + k * kGroups + gi);
            dhv[k] = fmaf(dap[0], wv.x, dhv[k]);
            dhv[k] = fmaf(dap[1], wv.y, dhv[k]);
            dhv[k] = fmaf(dap[2], wv.z, dhv[k]);
            dhv[k] = fmaf(dap[3], wv.w, dhv[k]);
          }
        }
        if (t < s.t) store_row<DP>(p.dh + (b * s.t + t) * s.d, s.d, s.vec, dhv);
        __syncwarp();  // the next pass rewrites the tile
      }
      // Lane j at the row's end: dc's column-j terms, summed over the lanes;
      // the row's share of dk0, dk1, dk2 and db1.
      float q[DP];
#pragma unroll
      for (int k = 0; k < DP; ++k)
        q[k] = fmaf(sm[L::kWd + k * 32 + lane], rk[k], sm[L::kWcma + k * 32 + lane] * dsum);
      lane_sum_store<DP>(q, lane, s.d, p.dc + b * s.d);
      float c[DP];
      load_bcast<DP>(p.cand + b * s.d, s.d, c);
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        dk[k * 32 + lane] += rk[k];
        dk[(DP + k) * 32 + lane] = fmaf(c[k], dsum, dk[(DP + k) * 32 + lane]);
        dk[(2 * DP + k) * 32 + lane] = fmaf(c[k], rk[k], dk[(2 * DP + k) * 32 + lane]);
      }
      db1 += dsum;
      dalpha += row_dalpha;
      dw2 += row_dw2;
      db2 += row_db2;
      __syncwarp();  // the next row's fold rewrites the slot
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) db2 += __shfl_xor_sync(kAll, db2, off);
    float* out = p.partial + unit * width;
    const int plane = (s.d + 1) * 32;
    for (int k = 0; k < s.d; ++k) {
      out[k * 32 + lane] = dk[k * 32 + lane];
      out[plane + k * 32 + lane] = dk[(DP + k) * 32 + lane];
      out[2 * plane + k * 32 + lane] = dk[(2 * DP + k) * 32 + lane];
    }
    out[s.d * 32 + lane] = db1;
    out[plane + s.d * 32 + lane] = dalpha;
    out[2 * plane + s.d * 32 + lane] = dw2;
    if (lane == 0) out[3 * plane] = db2;
  }
}

// Sums the units' partials in a fixed order and writes grads = [dw1 [4D,
// H] | db1 | dalpha | dw2 | db2]. A block takes 32 columns of the planes
// (the last one db2 too); warp w sums units w, w + 32, ... in order, then
// warp 0 sums the 32 warps' sums in warp order and unfolds dw1.
__global__ void __launch_bounds__(kReduceWarps * 32)
    din_narrow_reduce(const float* partial, int64_t units, int d, int h, float* grads) {
  __shared__ float acc[kReduceWarps][3][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int plane = (d + 1) * 32, width = partial_width(d);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (col < plane) {
#pragma unroll 4
    for (int64_t u = warp; u < units; u += kReduceWarps) {
      const float* row = partial + u * width;
      s0 += row[col];
      s1 += row[plane + col];
      s2 += row[2 * plane + col];
    }
  } else if (col == plane) {
    for (int64_t u = warp; u < units; u += kReduceWarps) s0 += partial[u * width + 3 * plane];
  }
  acc[warp][0][lane] = s0;
  acc[warp][1][lane] = s1;
  acc[warp][2][lane] = s2;
  __syncthreads();
  if (warp != 0 || col > plane) return;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int w = 0; w < kReduceWarps; ++w) {
    a0 += acc[w][0][lane];
    a1 += acc[w][1][lane];
    a2 += acc[w][2][lane];
  }
  const int64_t n_w1 = 4 * static_cast<int64_t>(d) * h;
  if (col == plane) {
    grads[n_w1 + 3 * h] = a0;
    return;
  }
  const int k = col >> 5, j = col & 31;
  if (j >= h) return;
  if (k < d) {
    grads[k * h + j] = a0 - a1;
    grads[(d + k) * h + j] = a0;
    grads[(2 * d + k) * h + j] = a1;
    grads[(3 * d + k) * h + j] = a2;
  } else {
    grads[n_w1 + j] = a0;
    grads[n_w1 + h + j] = a1;
    grads[n_w1 + 2 * h + j] = a2;
  }
}

// The kernel's resident grid on the current device (SMs x blocks an SM
// holds) for `smem` bytes a block, kept in `cache` (one per device and
// shape class): the first launch raises the kernel's dynamic
// shared-memory limit to the most any of its launches takes and asks for
// its occupancy.
template <typename K>
cudaError_t resident_grid(K kernel, int threads, size_t smem, size_t most_smem, int device,
                          std::atomic<int>* cache, int* grid) {
  int got = cache->load(std::memory_order_relaxed);
  if (got == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(most_smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    got = per_sm * sms;
    cache->store(got, std::memory_order_relaxed);
  }
  *grid = got;
  return cudaSuccess;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

bool shape_of(const int64_t* a, const void* x, const void* y, Shape* s) {
  if (a[kBatch] < 1 || a[kSteps] < 1 || a[kSteps] > (1 << 30) || a[kD] < 1 || a[kD] > 16 ||
      a[kH] < 0 || a[kH] > 32 || a[kUnitRows] < 1 || a[kDevice] < 0 ||
      a[kDevice] >= kMaxDevices)
    return false;
  s->b = a[kBatch];
  s->t = static_cast<int>(a[kSteps]);
  s->d = static_cast<int>(a[kD]);
  s->h = static_cast<int>(a[kH]);
  s->rows = group_rows(s->t);
  s->unit_rows = a[kUnitRows];
  s->vec = s->d % 4 == 0 && aligned(x, 16) && aligned(y, 16) ? 4
           : s->d % 2 == 0 && aligned(x, 8) && aligned(y, 8) ? 2
                                                             : 0;
  return true;
}

template <int DP>
int launch_fwd(const FwdArgs& p, const Shape& s, int device, cudaStream_t stream) {
  static std::atomic<int> cache[kMaxDevices][kMaxRows + 1];
  auto kernel = din_narrow_fwd_kernel<DP>;
  const size_t smem = Layout<DP>::fwd_bytes(s.rows);
  int grid = 0;
  cudaError_t err = resident_grid(kernel, kFwdWarps * 32, smem, Layout<DP>::fwd_bytes(kMaxRows),
                                  device, &cache[device][s.rows], &grid);
  if (err != cudaSuccess) return err;
  const int64_t groups = (s.b + s.rows - 1) / s.rows;
  const int64_t need = (groups + kFwdWarps - 1) / kFwdWarps;
  if (grid > need) grid = static_cast<int>(need);
  kernel<<<grid, kFwdWarps * 32, smem, stream>>>(p, s);
  return cudaGetLastError();
}

template <int DP>
int launch_bwd(const BwdArgs& p, const Shape& s, float* grads, int device, cudaStream_t stream) {
  static std::atomic<int> cache[kMaxDevices];
  auto kernel = din_narrow_bwd_kernel<DP>;
  const size_t smem = Layout<DP>::bwd_bytes();
  int grid = 0;
  cudaError_t err = resident_grid(kernel, kBwdWarps * 32, smem, smem, device, &cache[device],
                                  &grid);
  if (err != cudaSuccess) return err;
  const int64_t units = (s.b + s.unit_rows - 1) / s.unit_rows;
  const int64_t need = (units + kBwdWarps - 1) / kBwdWarps;
  if (grid > need) grid = static_cast<int>(need);
  kernel<<<grid, kBwdWarps * 32, smem, stream>>>(p, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  din_narrow_reduce<<<s.d + 2, kReduceWarps * 32, 0, stream>>>(p.partial, units, s.d, s.h, grads);
  return cudaGetLastError();
}

}  // namespace

// `a`: the launch's int64 scalars (enum Scalar: B, T, D, H, rows a unit,
// device), from ops/attention.py::_narrow_scalars. Writes out [B, D].
extern "C" int din_narrow_fwd_f32(const void* hist, const void* cand, const void* w1,
                                  const void* b1, const void* alpha, const void* w2,
                                  const void* b2, void* out, const int64_t* a, void* stream) {
  Shape s;
  if (!shape_of(a, hist, nullptr, &s)) return cudaErrorInvalidValue;
  const int device = static_cast<int>(a[kDevice]);
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  const FwdArgs p{static_cast<const float*>(hist), static_cast<const float*>(cand),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(alpha), static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((s.d + 1) / 2) {
    case 1: return launch_fwd<2>(p, s, device, st);
    case 2: return launch_fwd<4>(p, s, device, st);
    case 3: return launch_fwd<6>(p, s, device, st);
    case 4: return launch_fwd<8>(p, s, device, st);
    case 5: return launch_fwd<10>(p, s, device, st);
    case 6: return launch_fwd<12>(p, s, device, st);
    case 7: return launch_fwd<14>(p, s, device, st);
    case 8: return launch_fwd<16>(p, s, device, st);
    default: return cudaErrorInvalidValue;
  }
}

// Writes dh [B, T, D], dc [B, D] and grads = [dw1 [4D, H] | db1 [H] |
// dalpha [H] | dw2 [H] | db2 [1]], through `partial` [units,
// partial_width(D)], units = ceil(B / rows a unit).
extern "C" int din_narrow_bwd_f32(const void* hist, const void* cand, const void* w1,
                                  const void* b1, const void* alpha, const void* w2,
                                  const void* b2, const void* gout, void* dh, void* dc,
                                  void* partial, void* grads, const int64_t* a, void* stream) {
  Shape s;
  if (!shape_of(a, hist, dh, &s)) return cudaErrorInvalidValue;
  const int device = static_cast<int>(a[kDevice]);
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  const BwdArgs p{static_cast<const float*>(hist), static_cast<const float*>(cand),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(alpha), static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<const float*>(gout),
                  static_cast<float*>(dh), static_cast<float*>(dc),
                  static_cast<float*>(partial)};
  float* gr = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((s.d + 1) / 2) {
    case 1: return launch_bwd<2>(p, s, gr, device, st);
    case 2: return launch_bwd<4>(p, s, gr, device, st);
    case 3: return launch_bwd<6>(p, s, gr, device, st);
    case 4: return launch_bwd<8>(p, s, gr, device, st);
    case 5: return launch_bwd<10>(p, s, gr, device, st);
    case 6: return launch_bwd<12>(p, s, gr, device, st);
    case 7: return launch_bwd<14>(p, s, gr, device, st);
    case 8: return launch_bwd<16>(p, s, gr, device, st);
    default: return cudaErrorInvalidValue;
  }
}
