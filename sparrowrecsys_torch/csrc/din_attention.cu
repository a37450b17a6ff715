// DIN activation unit (target attention), forward and backward, float32.
//
// Replaces: sparrowrecsys_tpu/ops/attention.py::din_attention_pallas (:73),
// whose body _din_kernel (:65-69) runs _unit (:27-50) on a VMEM tile:
//   feats = [h, c, h*c]                          per step, [3D]
//   a     = feats @ [wa+wb; wc-wa; wd] + b1      w1 = [wa; wb; wc; wd], [4D, H]
//   a     = PReLU(a, alpha)
//   w     = sigmoid(a @ w2 + b2), and 0 where the row h is all zero
//   out   = sum_t w_t * h_t                      [B, D]
// and the per-step part of its VJP _din_fused_bwd (:119, attached by
// _din_attention_fused.defvjp at :124), jax.vjp(_unit): XLA computes the
// weight gradients there as dot products, and so does the port, with
// torch.mm on what this kernel writes (ops/attention.py::_din_weight_grads).
//
// Every (B, T, D, H) is taken. The launch plan (ops/attention.py::plan)
// picks a chunk width HC of H (8, 16, 32 or 64, the instantiations) and
// the kernels walk H in ceil(H / HC) chunks, the columns past H read as
// zero weights: a zero column's pre-activation is 0, its PReLU 0 and its
// w2 0, so the padding is exact. The folded chunk [3D, HC] sits in shared
// memory where it fits the plan's budget, else the wrapper folds and pads
// the weight once per call and the kernels read it through L1 (WG). A
// block covers `rows` batch rows; its threads walk the tile's steps.
//
// Bound on the H100: operations. The candidate's share c @ (wc-wa) + b1
// is the same for every step of a row, so the unit costs D*H multiply-
// adds per row plus 2*D*H + H per step, in float32 outside the tensor
// cores. At the serving shape (B=8192, T=5, D=10, H=32) that is 26 MFLOP
// (0.4 us at 67 TFLOP/s) against 1.7 MB read once (0.5 us at 3.35 TB/s):
// the kernel is latency-bound, a chain of dependent loads.
//
// Forward design: a block first stages its row group's history and
// candidates, one contiguous run of memory, into shared memory in one
// coalesced pass, 16-byte loads from the first 16-byte boundary of the
// tile whatever D is, all of them in flight at once (STAGE; rows of D|1
// words, so the step threads, D words apart, hit distinct banks). The
// candidate term c @ (wc-wa) + b1 [rows, HC], each step's pre-activations
// and the pooling pass then read the tile from there. Where a tile does
// not fit the plan's budget (long histories, wide D) the step threads
// read their rows from global memory, 16 bytes at a time where D and the
// pointers allow (VEC). Every thread of a warp reads the same weight
// word, so the weight reads are broadcasts, four weights per 16-byte
// load. An all-zero step's logit is -inf, whose sigmoid is exactly 0.
//
// Backward design: the block stages its tile's history, candidates and
// output gradients as the forward does (STAGE) where they fit; one thread
// per (row, step) of a round of the tile recomputes the pre-activations
// and the logit, turns g . h into dlogit and the pre-activation gradient
// dapre [H], and writes dh = w g + (wa+wb) dapre + c (wd dapre) to its
// row. Each warp then adds its steps' shares of db1, dalpha, dw2 and db2
// into registers, one lane per column, in step order; the registers
// reach the warp's own row of a [blocks * warps, 3H+1] scratch once per
// call (once per round and chunk where H takes several chunks), and
// din_attention_bwd_reduce adds the rows in a fixed order. No float
// atomics: two calls agree bit for bit. From the round's dapre, kept in
// shared memory (where the tile is staged, made again from the round's
// pre-activations and dlogits, kept there instead), the block writes
// dapre [B*T, H], the operand
// hx = [h, h*c] [B*T, 2D] and dsum = sum_t dapre_t [B, H] coalesced (the
// wrapper's weight-gradient products are hx^T dapre and c^T dsum), and
//   dc[k] = sum_j (wc-wa)[k, j] dsum_j + sum_t h_tk (wd dapre_t)_k
// with one thread per (row, k): the step threads leave h_t * (wd dapre_t)
// in shared memory where the tile is staged, else the (row, k) thread
// forms it from the history. With several chunks, pass 1 stashes each
// chunk's pre-activations in the dapre buffer and pass 2 reads them
// back. As in the reference, the PReLU sends the gradient at exactly 0
// to the identity branch, the all-zero mask passes no gradient, and a
// masked step contributes nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kMaxThreads = 256;

// The launch's int64 scalars (ops/attention.py::_scalars), by index.
enum Scalar {
  kBatch, kSteps, kD, kH, kHC, kChunks, kRows, kThreads, kStaged, kWeightsGlobal,
  kStepWeightsGlobal, kDevice, kScalars
};

struct Dims {
  int64_t batch;
  int steps, d, h, chunks, rows;
  int hp;  // chunks * HC: the row stride of the folded weight on the WG path
};

template <int HC>
constexpr int kRowStride = HC + 1;  // [.., HC] rows in shared memory: distinct banks

// Row stride of the folded weight in shared memory: 16-byte rows whose
// starts fall in distinct bank groups for 8 consecutive rows.
template <int HC>
constexpr int kWeightStride = HC + 4;

// Loads chunk c of the weights: b1, alpha and w2 into shared memory, and
// (unless WG) w1 folded into wf [3D, HC] = [wa+wb; wc-wa; wd], rows
// kWeightStride apart; columns past H read as zero. The caller
// synchronises.
template <int HC, bool WG>
__device__ void load_chunk(const float* __restrict__ w1, const float* __restrict__ b1,
                           const float* __restrict__ alpha, const float* __restrict__ w2,
                           float* wf, float* s_b1, float* s_alpha, float* s_w2, int c, int d,
                           int h) {
  const int j0 = c * HC;
  if (!WG) {
    constexpr int W = kWeightStride<HC>;
#pragma unroll 4
    for (int i = threadIdx.x; i < d * HC; i += blockDim.x) {
      const int k = i / HC;
      const int j = i - k * HC;
      const int jj = j0 + j;
      float fa = 0.f, fc = 0.f, fd = 0.f;
      if (jj < h) {
        const float wa = __ldg(w1 + k * h + jj), wb = __ldg(w1 + (d + k) * h + jj);
        const float wc = __ldg(w1 + (2 * d + k) * h + jj), wd = __ldg(w1 + (3 * d + k) * h + jj);
        fa = wa + wb;
        fc = wc - wa;
        fd = wd;
      }
      wf[k * W + j] = fa;
      wf[(d + k) * W + j] = fc;
      wf[(2 * d + k) * W + j] = fd;
    }
  }
  for (int j = threadIdx.x; j < HC; j += blockDim.x) {
    const bool in = j0 + j < h;
    s_b1[j] = in ? __ldg(b1 + j0 + j) : 0.f;
    s_alpha[j] = in ? __ldg(alpha + j0 + j) : 0.f;
    s_w2[j] = in ? __ldg(w2 + j0 + j) : 0.f;
  }
}

// s_cand[rr, j] = c_rr @ (wc-wa)[:, j] + b1[j] for the tile's valid rows,
// four columns a thread (one 16-byte weight load a k); the candidate rows
// start at `cand_rows`, `cs` floats apart.
template <int HC>
__device__ void candidate_term(const float* cand_rows, int cs, const float* wf, int ws,
                               const float* s_b1, float* s_cand, int valid_rows, int d) {
  constexpr int Q = HC / 4;
  for (int i = threadIdx.x; i < valid_rows * Q; i += blockDim.x) {
    const int rr = i / Q;
    const int q = i - rr * Q;
    const float* c = cand_rows + rr * cs;
    const float4* w = reinterpret_cast<const float4*>(wf + d * ws) + q;
    const int w4 = ws / 4;
    float4 s = reinterpret_cast<const float4*>(s_b1)[q];
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      const float ck = c[k];
      const float4 x = w[k * w4];
      s.x = fmaf(ck, x.x, s.x);
      s.y = fmaf(ck, x.y, s.y);
      s.z = fmaf(ck, x.z, s.z);
      s.w = fmaf(ck, x.w, s.w);
    }
    float* out = s_cand + rr * kRowStride<HC> + 4 * q;
    out[0] = s.x;
    out[1] = s.y;
    out[2] = s.z;
    out[3] = s.w;
  }
}

template <int HC>
__device__ __forceinline__ void unit_step(float (&acc)[HC], float hv, float cv, const float* wf,
                                          int ws, int k, int d) {
  const float hc = hv * cv;
  const float4* wh = reinterpret_cast<const float4*>(wf + k * ws);
  const float4* wd = reinterpret_cast<const float4*>(wf + (2 * d + k) * ws);
#pragma unroll
  for (int q = 0; q < HC / 4; ++q) {
    const float4 a = wh[q], e = wd[q];
    acc[4 * q + 0] = fmaf(hc, e.x, fmaf(hv, a.x, acc[4 * q + 0]));
    acc[4 * q + 1] = fmaf(hc, e.y, fmaf(hv, a.y, acc[4 * q + 1]));
    acc[4 * q + 2] = fmaf(hc, e.z, fmaf(hv, a.z, acc[4 * q + 2]));
    acc[4 * q + 3] = fmaf(hc, e.w, fmaf(hv, a.w, acc[4 * q + 3]));
  }
}

// The step's HC pre-activations of one chunk (from the candidate term)
// and whether its history row has a non-zero element; with DOT, also
// g . h into *gh. VEC: h, c and g are 16-byte aligned global rows.
template <int HC, bool VEC, bool DOT>
__device__ __forceinline__ bool preactivations(float (&acc)[HC], const float* h, const float* c,
                                               const float* s_cand_row, const float* wf, int ws,
                                               int d, const float* g, float* gh) {
#pragma unroll
  for (int j = 0; j < HC; ++j) acc[j] = s_cand_row[j];
  bool nz = false;
  float dot = 0.f;
  if (VEC) {
    for (int k = 0; k < d; k += 4) {
      const float4 h4 = __ldg(reinterpret_cast<const float4*>(h + k));
      const float4 c4 = __ldg(reinterpret_cast<const float4*>(c + k));
      nz |= (h4.x != 0.f) | (h4.y != 0.f) | (h4.z != 0.f) | (h4.w != 0.f);
      if (DOT) {
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + k));
        dot = fmaf(g4.x, h4.x, dot);
        dot = fmaf(g4.y, h4.y, dot);
        dot = fmaf(g4.z, h4.z, dot);
        dot = fmaf(g4.w, h4.w, dot);
      }
      unit_step<HC>(acc, h4.x, c4.x, wf, ws, k + 0, d);
      unit_step<HC>(acc, h4.y, c4.y, wf, ws, k + 1, d);
      unit_step<HC>(acc, h4.z, c4.z, wf, ws, k + 2, d);
      unit_step<HC>(acc, h4.w, c4.w, wf, ws, k + 3, d);
    }
  } else {
#pragma unroll 2
    for (int k = 0; k < d; ++k) {
      const float hv = h[k];
      nz |= hv != 0.f;
      if (DOT) dot = fmaf(g[k], hv, dot);
      unit_step<HC>(acc, hv, c[k], wf, ws, k, d);
    }
  }
  if (DOT) *gh = dot;
  return nz;
}

// sum_j PReLU(acc_j) * w2_j over the chunk.
template <int HC>
__device__ __forceinline__ float logit_part(const float (&acc)[HC], const float* s_alpha,
                                            const float* s_w2) {
  float logit = 0.f;
#pragma unroll
  for (int j = 0; j < HC; ++j) {
    const float a = acc[j] >= 0.f ? acc[j] : s_alpha[j] * acc[j];
    logit = fmaf(a, s_w2[j], logit);
  }
  return logit;
}

// Copies `count` contiguous floats from `src` into shared memory, element
// e to dst[(e / d) * stride + e % d]: 16-byte loads from src's first
// 16-byte boundary on, every thread's loads issued before its stores.
__device__ void stage(const float* __restrict__ src, int count, int d, int stride, float* dst) {
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(count, ((16 - misalign) & 15) / 4);
  const int body = (count - head) / 4;
  for (int e = threadIdx.x; e < head; e += blockDim.x) {
    const int r = e / d;
    dst[r * stride + e - r * d] = __ldg(src + e);
  }
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
#pragma unroll 4
  for (int q = threadIdx.x; q < body; q += blockDim.x) {
    const float4 v = __ldg(s4 + q);
    const float vals[4] = {v.x, v.y, v.z, v.w};
    const int e = head + 4 * q;
    int r = e / d, off = e - r * d;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      dst[r * stride + off] = vals[u];
      if (++off == d) {
        off = 0;
        ++r;
      }
    }
  }
  for (int e = head + 4 * body + threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / d;
    dst[r * stride + e - r * d] = __ldg(src + e);
  }
}

// out[rr, k] = sum_t wt[rr*T + t] * h[rr, t, k] over the tile's valid
// rows; the history rows start at `hrows`, `hs` floats apart.
__device__ __forceinline__ void pool(const float* hrows, int hs, const float* wt, float* out,
                                     int valid_rows, int steps, int d) {
  for (int i = threadIdx.x; i < valid_rows * d; i += blockDim.x) {
    const int rr = i / d;
    const int k = i - rr * d;
    const float* hb = hrows + static_cast<int64_t>(rr) * steps * hs + k;
    const float* w = wt + rr * steps;
    float s = 0.f;
    for (int t = 0; t < steps; ++t) s = fmaf(w[t], hb[static_cast<int64_t>(t) * hs], s);
    out[static_cast<int64_t>(rr) * d + k] = s;
  }
}

template <int HC, bool STAGE, bool VEC, bool WG>
__global__ void __launch_bounds__(kMaxThreads)
din_attention_kernel(const float* __restrict__ hist, const float* __restrict__ cand,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ alpha, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ wfold,
                     float* __restrict__ out, float* __restrict__ wt_global, Dims z) {
  extern __shared__ float4 smem4[];
  const int d = z.d, steps = z.steps, rows = z.rows;
  const int S = d | 1;  // staged row stride: odd, so D-apart rows hit distinct banks
  float* s_wf = reinterpret_cast<float*>(smem4);       // [3D, HC + 4] unless WG
  float* s_b1 = s_wf + (WG ? 0 : 3 * d * kWeightStride<HC>);
  float* s_alpha = s_b1 + HC;
  float* s_w2 = s_alpha + HC;
  float* s_cand = s_w2 + HC;                           // [rows, HC + 1]
  float* s_wt = s_cand + rows * kRowStride<HC>;        // [rows * T] unless wt_global
  float* s_h = s_wt + (wt_global ? 0 : rows * steps);  // STAGE: [rows * T, S]
  float* s_c = s_h + rows * steps * S;                 // STAGE: [rows, S]
  const float bias2 = __ldg(b2);
  const int ws = WG ? z.hp : kWeightStride<HC>;
  if (z.chunks == 1) load_chunk<HC, WG>(w1, b1, alpha, w2, s_wf, s_b1, s_alpha, s_w2, 0, d, z.h);
  const int64_t groups = (z.batch + rows - 1) / rows;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t b0 = g * rows;
    const int vrows = static_cast<int>(z.batch - b0 < rows ? z.batch - b0 : rows);
    const int n = vrows * steps;
    const float* hg = hist + b0 * steps * d;
    const float* cg = cand + b0 * d;
    float* wt = wt_global ? wt_global + b0 * steps : s_wt;
    if (g != blockIdx.x) __syncthreads();  // the last tile's readers are done
    if (STAGE) {
      stage(hg, n * d, d, S, s_h);
      stage(cg, vrows * d, d, S, s_c);
    }
    for (int c = 0; c < z.chunks; ++c) {
      if (z.chunks > 1) {
        if (c > 0) __syncthreads();
        load_chunk<HC, WG>(w1, b1, alpha, w2, s_wf, s_b1, s_alpha, s_w2, c, d, z.h);
      }
      const float* wf = WG ? wfold + c * HC : s_wf;
      __syncthreads();
      candidate_term<HC>(STAGE ? s_c : cg, STAGE ? S : d, wf, ws, s_b1, s_cand, vrows, d);
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int rr = i / steps;
        float acc[HC];
        const bool nz = preactivations<HC, VEC, false>(
            acc, STAGE ? s_h + i * S : hg + static_cast<int64_t>(i) * d,
            STAGE ? s_c + rr * S : cg + rr * d, s_cand + rr * kRowStride<HC>, wf, ws, d,
            nullptr, nullptr);
        const float part = logit_part<HC>(acc, s_alpha, s_w2);
        // An all-zero step: -inf, which later chunks keep and whose sigmoid is 0.
        float logit = c == 0 ? (nz ? bias2 + part : -INFINITY) : wt[i] + part;
        if (c == z.chunks - 1) logit = 1.f / (1.f + expf(-logit));
        wt[i] = logit;
      }
    }
    __syncthreads();
    if (STAGE) {
      pool(s_h, S, wt, out + b0 * d, vrows, steps, d);
    } else {
      pool(hg, d, wt, out + b0 * d, vrows, steps, d);
    }
  }
}

// dapre of the round's step i at column j: kept in shared memory unless
// STAGE, else made again from the pre-activation and dlogit as the step
// thread made it (the same rounding).
template <int HC, bool STAGE>
__device__ __forceinline__ float dapre_at(const float* s_apre, const float* s_dap,
                                          const float* s_dl, const float* s_w2,
                                          const float* s_alpha, int i, int j) {
  if (!STAGE) return s_dap[i * kRowStride<HC> + j];
  const float da = s_w2[j] * s_dl[i];
  return s_apre[i * kRowStride<HC> + j] >= 0.f ? da : s_alpha[j] * da;
}

// Adds a warp's small sums of chunk c, held by its lanes (column
// lane + 32u of the chunk: sb = db1, se = sum over negative
// pre-activations of a dl, sw = dw2; lane 0's sd = db2, counted in chunk
// 0), to the warp's row of the scratch; dalpha = w2 * se.
template <int HC, int U>
__device__ void flush_small(float* wrow, const float (&sb)[U], const float (&se)[U],
                            const float (&sw)[U], float sd, const float* s_w2, int c, int h) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lane + 32 * u;
    if (j < HC && c * HC + j < h) {
      wrow[c * HC + j] += sb[u];
      wrow[h + c * HC + j] += s_w2[j] * se[u];
      wrow[2 * h + c * HC + j] += sw[u];
    }
  }
  if (lane == 0 && c == 0) wrow[3 * h] += sd;
}

template <int HC, bool STAGE, bool VEC, bool WG>
__global__ void __launch_bounds__(kMaxThreads)
din_attention_bwd_kernel(const float* __restrict__ hist, const float* __restrict__ cand,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ alpha, const float* __restrict__ w2,
                         const float* __restrict__ b2, const float* __restrict__ wfold,
                         const float* __restrict__ gout, float* __restrict__ dh,
                         float* __restrict__ dc, float* __restrict__ dap,
                         float* __restrict__ hx, float* __restrict__ dsum,
                         float* __restrict__ partial, Dims z) {
  extern __shared__ float4 smem4[];
  constexpr int S = kRowStride<HC>;
  constexpr int U = (HC + 31) / 32;  // columns of the chunk a lane sums
  const int d = z.d, steps = z.steps, rows = z.rows, h = z.h;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int SD = d | 1;  // staged row stride: odd, so D-apart rows hit distinct banks
  float* s_wf = reinterpret_cast<float*>(smem4);          // [3D, HC + 4] unless WG
  float* s_b1 = s_wf + (WG ? 0 : 3 * d * kWeightStride<HC>);
  float* s_alpha = s_b1 + HC;
  float* s_w2 = s_alpha + HC;
  float* s_cand = s_w2 + HC;                              // [rows, HC + 1]
  float* s_dsum = s_cand + rows * S;                      // [rows, HC + 1] the round's dsum
  float* s_apre = s_dsum + rows * S;                      // [nt, HC + 1] pre-activations
  float* s_dap = s_apre + nt * S;                         // unless STAGE: [nt, HC + 1] dapre
  float* s_dl = s_dap + (STAGE ? 0 : nt * S);             // [nt] dlogit, 0 for a dead step
  float* s_h = s_dl + nt;                                 // STAGE: [rows * T, SD]
  float* s_c = s_h + rows * steps * SD;                   // STAGE: [rows, SD]
  float* s_g = s_c + rows * SD;                           // STAGE: [rows, SD] output gradient
  float* s_e = s_g + rows * SD;                           // STAGE: [nt, SD] h_t * (wd dapre_t)
  const int p_all = 3 * h + 1;
  float* wrow = partial + (static_cast<int64_t>(blockIdx.x) * (nt >> 5) + warp) * p_all;
  for (int p = lane; p < p_all; p += 32) wrow[p] = 0.f;
  float sb[U], se[U], sw[U], sd = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) sb[u] = se[u] = sw[u] = 0.f;
  const float bias2 = __ldg(b2);
  const int ws = WG ? z.hp : kWeightStride<HC>;
  const int d2 = 2 * d;
  if (z.chunks == 1) load_chunk<HC, WG>(w1, b1, alpha, w2, s_wf, s_b1, s_alpha, s_w2, 0, d, h);
  const int64_t groups = (z.batch + rows - 1) / rows;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t b0 = g * rows;
    const int vrows = static_cast<int>(z.batch - b0 < rows ? z.batch - b0 : rows);
    const int n = vrows * steps;
    const float* cg = cand + b0 * d;
    if (STAGE) {
      // The last tile's readers of these are done: they come before the
      // barrier that ends its last dsum phase.
      stage(hist + b0 * steps * d, n * d, d, SD, s_h);
      stage(cg, vrows * d, d, SD, s_c);
      stage(gout + b0 * d, vrows * d, d, SD, s_g);
    }
    // Rounds of one step per thread (several where T exceeds the block).
    for (int r0 = 0; r0 < n; r0 += nt) {
      const int nr = min(nt, n - r0);
      const int64_t s0 = b0 * steps + r0;  // the round's first row of [B*T, .]
      const bool live = tid < nr;
      const int rr = live ? (r0 + tid) / steps : 0;
      const int64_t step = s0 + (live ? tid : 0);
      const float* hrow = STAGE ? s_h + (r0 + (live ? tid : 0)) * SD : hist + step * d;
      const float* crow = STAGE ? s_c + rr * SD : cg + rr * d;
      const float* grow = STAGE ? s_g + rr * SD : gout + (b0 + rr) * d;
      const int r_first = r0 / steps, r_last = (r0 + nr - 1) / steps;
      float acc[HC];
      float logit = bias2, gh = 0.f;
      bool nz = false;
      // Pass 1: the logit over the chunks (each chunk's pre-activations
      // stashed in dapre's row where there are several).
      for (int c = 0; c < z.chunks; ++c) {
        __syncthreads();
        if (z.chunks > 1) {
          load_chunk<HC, WG>(w1, b1, alpha, w2, s_wf, s_b1, s_alpha, s_w2, c, d, h);
          __syncthreads();
        }
        const float* wf = WG ? wfold + c * HC : s_wf;
        candidate_term<HC>(STAGE ? s_c : cg, STAGE ? SD : d, wf, ws, s_b1, s_cand, vrows, d);
        __syncthreads();
        if (live) {
          float dot = 0.f;
          const bool nzc = preactivations<HC, VEC, true>(
              acc, hrow, crow, s_cand + rr * S, wf, ws, d, grow, &dot);
          if (c == 0) {
            nz = nzc;
            gh = dot;
          }
          logit += logit_part<HC>(acc, s_alpha, s_w2);
          if (z.chunks > 1) {
#pragma unroll
            for (int j = 0; j < HC; ++j) {
              if (c * HC + j < h) dap[step * h + c * HC + j] = acc[j];
            }
          }
        }
      }
      const float sg = 1.f / (1.f + expf(-logit));
      const float w = nz ? sg : 0.f;
      const float dl = nz ? gh * sg * (1.f - sg) : 0.f;
      s_dl[tid] = dl;
      // Pass 2, chunk by chunk: dapre and dh per step thread, the warp's
      // small sums; then the block writes dapre, hx and dsum, and dc.
      for (int c = 0; c < z.chunks; ++c) {
        const int j0 = c * HC;
        const int jn = min(HC, h - j0);
        if (z.chunks > 1) {
          __syncthreads();
          load_chunk<HC, WG>(w1, b1, alpha, w2, s_wf, s_b1, s_alpha, s_w2, c, d, h);
          __syncthreads();
          if (live) {
#pragma unroll
            for (int j = 0; j < HC; ++j) acc[j] = j0 + j < h ? dap[step * h + j0 + j] : 0.f;
          }
        }
        const float* wf = WG ? wfold + c * HC : s_wf;
        float* ap = s_apre + tid * S;
        float* dp = s_dap + tid * S;
        float* er = s_e + tid * SD;
        if (live && nz) {
          float* dhr = dh + step * d;
#pragma unroll
          for (int j = 0; j < HC; ++j) {
            ap[j] = acc[j];
            const float da = s_w2[j] * dl;
            acc[j] = acc[j] >= 0.f ? da : s_alpha[j] * da;  // acc now holds dapre
            if (!STAGE) dp[j] = acc[j];
          }
#pragma unroll 2
          for (int k = 0; k < d; ++k) {
            const float4* w0 = reinterpret_cast<const float4*>(wf + k * ws);
            const float4* w2f = reinterpret_cast<const float4*>(wf + (2 * d + k) * ws);
            float f0 = 0.f, f2 = 0.f;
#pragma unroll
            for (int q = 0; q < HC / 4; ++q) {
              const float4 a0 = w0[q], a2 = w2f[q];
              f0 = fmaf(a0.x, acc[4 * q], fmaf(a0.y, acc[4 * q + 1],
                   fmaf(a0.z, acc[4 * q + 2], fmaf(a0.w, acc[4 * q + 3], f0))));
              f2 = fmaf(a2.x, acc[4 * q], fmaf(a2.y, acc[4 * q + 1],
                   fmaf(a2.z, acc[4 * q + 2], fmaf(a2.w, acc[4 * q + 3], f2))));
            }
            if (STAGE) er[k] = hrow[k] * f2;
            float v = fmaf(crow[k], f2, f0);
            v = c == 0 ? fmaf(w, grow[k], v) : v + dhr[k];
            dhr[k] = v;
          }
        } else {
#pragma unroll
          for (int j = 0; j < HC; ++j) {
            ap[j] = 0.f;
            if (!STAGE) dp[j] = 0.f;
          }
          if (live) {
            if (STAGE) {
              for (int k = 0; k < d; ++k) er[k] = 0.f;
            }
            // A masked step: no gradient.
            if (c == 0) {
              for (int k = 0; k < d; ++k) dh[step * d + k] = 0.f;
            }
          }
        }
        __syncwarp();
        // The warp's steps, in order, into its lanes' small sums.
        {
          const int base = warp * 32;
          const int cnt = min(32, nr - base);
          float aj[U], w2j[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const bool in = lane + 32 * u < HC;
            aj[u] = in ? s_alpha[lane + 32 * u] : 0.f;
            w2j[u] = in ? s_w2[lane + 32 * u] : 0.f;
          }
          for (int ii = 0; ii < cnt; ++ii) {
            const int i = base + ii;
            const float dli = s_dl[i];
            if (c == 0) sd += dli;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int j = lane + 32 * u;
              if (j < HC) {
                const float x = s_apre[i * S + j];
                const float da = w2j[u] * dli, xd = x * dli;
                sb[u] += x >= 0.f ? da : aj[u] * da;  // dapre, as the step thread made it
                sw[u] = fmaf(x >= 0.f ? 1.f : aj[u], xd, sw[u]);
                se[u] += x < 0.f ? xd : 0.f;
              }
            }
          }
        }
        __syncthreads();
        // dapre and (chunk 0) hx, a warp a step row; dsum per (row, j).
        const int warps = nt >> 5;
        for (int i = warp; i < nr; i += warps) {
          float* drow = dap + (s0 + i) * h + j0;
          for (int j = lane; j < jn; j += 32) {
            drow[j] = dapre_at<HC, STAGE>(s_apre, s_dap, s_dl, s_w2, s_alpha, i, j);
          }
        }
        if (c == 0) {
          for (int i = warp; i < nr; i += warps) {
            const int r = (r0 + i) / steps;
            float* xrow = hx + (s0 + i) * d2;
            for (int k = lane; k < d; k += 32) {
              const float hv = STAGE ? s_h[(r0 + i) * SD + k] : __ldg(hist + (s0 + i) * d + k);
              const float cv = STAGE ? s_c[r * SD + k] : __ldg(cg + r * d + k);
              xrow[k] = hv;
              xrow[d + k] = hv * cv;
            }
          }
        }
        for (int it = tid; it < (r_last - r_first + 1) * HC; it += nt) {
          const int rl = it / HC;
          const int j = it - rl * HC;
          const int r = r_first + rl;
          const int t_lo = max(0, r0 - r * steps), t_hi = min(steps, r0 + nr - r * steps);
          const int i0 = r * steps - r0;
          float s = 0.f;
          for (int t = t_lo; t < t_hi; ++t) {
            s += dapre_at<HC, STAGE>(s_apre, s_dap, s_dl, s_w2, s_alpha, i0 + t, j);
          }
          s_dsum[rl * S + j] = s;
          if (j < jn) {
            float* p = dsum + (b0 + r) * h + j0 + j;
            *p = t_lo == 0 ? s : *p + s;
          }
        }
        __syncthreads();
        // dc[k] += (wc-wa)[k, :] . dsum + sum_t h_tk (wd dapre_t)_k over
        // the round's steps of the row.
        for (int it = tid; it < (r_last - r_first + 1) * d; it += nt) {
          const int rl = it / d;
          const int k = it - rl * d;
          const int r = r_first + rl;
          const int t_lo = max(0, r0 - r * steps), t_hi = min(steps, r0 + nr - r * steps);
          const float4* wc4 = reinterpret_cast<const float4*>(wf + (d + k) * ws);
          const float* ds = s_dsum + rl * S;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < HC / 4; ++q) {
            const float4 x = wc4[q];
            part[0] = fmaf(x.x, ds[4 * q], part[0]);
            part[1] = fmaf(x.y, ds[4 * q + 1], part[1]);
            part[2] = fmaf(x.z, ds[4 * q + 2], part[2]);
            part[3] = fmaf(x.w, ds[4 * q + 3], part[3]);
          }
          float es = 0.f;
          if (STAGE) {
            for (int t = t_lo; t < t_hi; ++t) es += s_e[(r * steps + t - r0) * SD + k];
          } else {
            float wdd[HC];
            const float4* wd4 = reinterpret_cast<const float4*>(wf + (2 * d + k) * ws);
#pragma unroll
            for (int q = 0; q < HC / 4; ++q) {
              const float4 y = wd4[q];
              wdd[4 * q] = y.x, wdd[4 * q + 1] = y.y, wdd[4 * q + 2] = y.z, wdd[4 * q + 3] = y.w;
            }
            const int64_t hs = (b0 + r) * steps;
            for (int t = t_lo; t < t_hi; ++t) {
              const float hv = __ldg(hist + (hs + t) * d + k);
              const float* row = s_dap + (r * steps + t - r0) * S;
              float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int j = 0; j < HC; ++j) f[j & 3] = fmaf(wdd[j], row[j], f[j & 3]);
              es = fmaf(hv, (f[0] + f[1]) + (f[2] + f[3]), es);
            }
          }
          const float s = ((part[0] + part[1]) + (part[2] + part[3])) + es;
          float* dcp = dc + (b0 + r) * d + k;
          *dcp = c == 0 && t_lo == 0 ? s : *dcp + s;
        }
        if (z.chunks > 1) {
          flush_small<HC, U>(wrow, sb, se, sw, sd, s_w2, c, h);
#pragma unroll
          for (int u = 0; u < U; ++u) sb[u] = se[u] = sw[u] = 0.f;
          sd = 0.f;
        }
      }
    }
  }
  if (z.chunks == 1) flush_small<HC, U>(wrow, sb, se, sw, sd, s_w2, 0, h);
}

// out[p] = the sum of the warps' rows of small sums at p < 3H+1: one
// block per p, each thread adding rows t, t + 256, ... in order, then a
// fixed tree. No atomics, so the sum is the same every call.
__global__ void __launch_bounds__(256)
din_attention_bwd_reduce(const float* __restrict__ partial, int prows, int p_all,
                         float* __restrict__ out) {
  __shared__ float s[256];
  const int p = blockIdx.x;
  float v = 0.f;
  for (int b = threadIdx.x; b < prows; b += blockDim.x) {
    v += partial[static_cast<int64_t>(b) * p_all + p];
  }
  s[threadIdx.x] = v;
  __syncthreads();
  for (int width = blockDim.x / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) s[threadIdx.x] += s[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[p] = s[0];
}

// Largest grid that is resident at once (the grid-stride loops cover the
// rest); raises the kernel's dynamic shared-memory limit first.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, int64_t groups,
                            int64_t* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<int64_t>(sms) * per_sm;
  if (*blocks > groups) *blocks = groups;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

Dims dims_of(const int64_t* a) {
  return Dims{a[kBatch], static_cast<int>(a[kSteps]), static_cast<int>(a[kD]),
              static_cast<int>(a[kH]), static_cast<int>(a[kChunks]),
              static_cast<int>(a[kRows]), static_cast<int>(a[kChunks] * a[kHC])};
}

// The plan's scalars must describe a launch the kernels can run.
bool plan_ok(const int64_t* a) {
  if (a == nullptr) return false;
  const int64_t hc = a[kHC];
  return a[kBatch] >= 0 && a[kSteps] >= 1 && a[kD] >= 1 && a[kH] >= 1 &&
         (hc == 8 || hc == 16 || hc == 32 || hc == 64) && a[kChunks] * hc >= a[kH] &&
         (a[kChunks] - 1) * hc < a[kH] && a[kRows] >= 1 && a[kThreads] >= 32 &&
         a[kThreads] <= kMaxThreads && a[kThreads] % 32 == 0 && a[kSteps] * a[kD] < INT32_MAX &&
         (!a[kWeightsGlobal] || (hc == 8 && !a[kStaged]));
}

struct FwdArgs {
  const float *hist, *cand, *w1, *b1, *alpha, *w2, *b2, *wfold;
  float *out, *wt;
};

size_t fwd_shared_bytes(const int64_t* a) {
  const size_t d = a[kD], hc = a[kHC], rows = a[kRows], steps = a[kSteps];
  size_t f = (a[kWeightsGlobal] ? 0 : 3 * d * (hc + 4)) + 3 * hc + rows * (hc + 1);
  if (!a[kStepWeightsGlobal]) f += rows * steps;
  if (a[kStaged]) f += rows * (steps + 1) * (d | 1);
  return f * sizeof(float);
}

template <int HC, bool STAGE, bool VEC, bool WG>
int launch_fwd(const FwdArgs& p, const int64_t* a, cudaStream_t stream) {
  const Dims z = dims_of(a);
  const int threads = static_cast<int>(a[kThreads]);
  const size_t smem = fwd_shared_bytes(a);
  const int64_t groups = (z.batch + z.rows - 1) / z.rows;
  if (groups == 0) return cudaSuccess;
  auto kernel = din_attention_kernel<HC, STAGE, VEC, WG>;
  int64_t blocks = 0;
  cudaError_t err = resident_blocks(kernel, threads, smem, groups, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(
      p.hist, p.cand, p.w1, p.b1, p.alpha, p.w2, p.b2, p.wfold, p.out, p.wt, z);
  return cudaGetLastError();
}

template <int HC>
int fwd_hc(const FwdArgs& p, const int64_t* a, cudaStream_t s) {
  const bool vec = a[kD] % 4 == 0 && aligned16(p.hist) && aligned16(p.cand);
  if (a[kStaged]) return launch_fwd<HC, true, false, false>(p, a, s);
  if (a[kWeightsGlobal]) {
    if constexpr (HC == 8) {
      return vec ? launch_fwd<8, false, true, true>(p, a, s)
                 : launch_fwd<8, false, false, true>(p, a, s);
    }
    return cudaErrorInvalidValue;
  }
  return vec ? launch_fwd<HC, false, true, false>(p, a, s)
             : launch_fwd<HC, false, false, false>(p, a, s);
}

struct BwdArgs {
  const float *hist, *cand, *w1, *b1, *alpha, *w2, *b2, *wfold, *gout;
  float *dh, *dc, *dap, *hx, *dsum, *partial, *small;
};

size_t bwd_shared_bytes(const int64_t* a) {
  const size_t d = a[kD], hc = a[kHC], rows = a[kRows], nt = a[kThreads], steps = a[kSteps];
  return ((a[kWeightsGlobal] ? 0 : 3 * d * (hc + 4)) + 3 * hc + 2 * rows * (hc + 1) +
          (a[kStaged] ? 1 : 2) * nt * (hc + 1) + nt +
          (a[kStaged] ? (rows * (steps + 2) + nt) * (d | 1) : 0)) * sizeof(float);
}

// blocks < 0: report the grid (into *grid) and launch nothing.
template <int HC, bool STAGE, bool VEC, bool WG>
int launch_bwd(const BwdArgs& p, const int64_t* a, int64_t blocks, int64_t* grid,
               cudaStream_t stream) {
  const Dims z = dims_of(a);
  const int threads = static_cast<int>(a[kThreads]);
  const size_t smem = bwd_shared_bytes(a);
  const int64_t groups = (z.batch + z.rows - 1) / z.rows;
  auto kernel = din_attention_bwd_kernel<HC, STAGE, VEC, WG>;
  int64_t most = 0;
  cudaError_t err = resident_blocks(kernel, threads, smem, groups, &most);
  if (err != cudaSuccess) return err;
  if (blocks < 0) {
    *grid = most;
    return cudaSuccess;
  }
  if (blocks < 1 || blocks > most) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(
      p.hist, p.cand, p.w1, p.b1, p.alpha, p.w2, p.b2, p.wfold, p.gout, p.dh, p.dc, p.dap,
      p.hx, p.dsum, p.partial, z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int p_all = 3 * z.h + 1;
  din_attention_bwd_reduce<<<p_all, 256, 0, stream>>>(
      p.partial, static_cast<int>(blocks * (threads / 32)), p_all, p.small);
  return cudaGetLastError();
}

template <int HC>
int bwd_hc(const BwdArgs& p, const int64_t* a, int64_t blocks, int64_t* grid, cudaStream_t s) {
  const bool vec = a[kD] % 4 == 0 && aligned16(p.hist) && aligned16(p.cand) &&
                   aligned16(p.gout);
  if (a[kStaged]) return launch_bwd<HC, true, false, false>(p, a, blocks, grid, s);
  if (a[kWeightsGlobal]) {
    if constexpr (HC == 8) {
      return vec ? launch_bwd<8, false, true, true>(p, a, blocks, grid, s)
                 : launch_bwd<8, false, false, true>(p, a, blocks, grid, s);
    }
    return cudaErrorInvalidValue;
  }
  return vec ? launch_bwd<HC, false, true, false>(p, a, blocks, grid, s)
             : launch_bwd<HC, false, false, false>(p, a, blocks, grid, s);
}

int bwd_dispatch(const BwdArgs& p, const int64_t* a, int64_t blocks, int64_t* grid,
                 cudaStream_t s) {
  if (!plan_ok(a) || a[kBatch] < 1 || (a[kWeightsGlobal] != 0) != (p.wfold != nullptr)) {
    return cudaErrorInvalidValue;
  }
  DeviceGuard guard(static_cast<int>(a[kDevice]));
  if (guard.status() != cudaSuccess) return guard.status();
  switch (a[kHC]) {
    case 8: return bwd_hc<8>(p, a, blocks, grid, s);
    case 16: return bwd_hc<16>(p, a, blocks, grid, s);
    case 32: return bwd_hc<32>(p, a, blocks, grid, s);
    case 64: return bwd_hc<64>(p, a, blocks, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `a`: the launch's int64 scalars (enum Scalar), from the plan of
// ops/attention.py, cached there per shape. `wfold` is the folded,
// padded [3D, chunks*HC] weight where the plan reads it through L1 (else
// null); `wt` a [B*T] scratch for the step weights where the plan keeps
// them out of shared memory (else null).
extern "C" int din_attention_f32(const void* hist, const void* cand, const void* w1,
                                 const void* b1, const void* alpha, const void* w2,
                                 const void* b2, const void* wfold, void* out, void* wt,
                                 const int64_t* a, void* stream) {
  if (!plan_ok(a) || (a[kWeightsGlobal] != 0) != (wfold != nullptr) ||
      (a[kStepWeightsGlobal] != 0) != (wt != nullptr)) {
    return cudaErrorInvalidValue;
  }
  DeviceGuard guard(static_cast<int>(a[kDevice]));
  if (guard.status() != cudaSuccess) return guard.status();
  const FwdArgs p{static_cast<const float*>(hist), static_cast<const float*>(cand),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(alpha), static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<const float*>(wfold),
                  static_cast<float*>(out), static_cast<float*>(wt)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a[kHC]) {
    case 8: return fwd_hc<8>(p, a, s);
    case 16: return fwd_hc<16>(p, a, s);
    case 32: return fwd_hc<32>(p, a, s);
    case 64: return fwd_hc<64>(p, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's grid for these pointers and this plan: the caller
// allocates the [grid * threads / 32, 3H + 1] scratch (a row per warp)
// and passes the same grid to din_attention_bwd_f32. Pointers matter: they select the 16-byte path.
extern "C" int din_attention_bwd_grid(const void* hist, const void* cand, const void* gout,
                                      const void* wfold, const int64_t* a, int64_t* grid) {
  BwdArgs p{};
  p.hist = static_cast<const float*>(hist);
  p.cand = static_cast<const float*>(cand);
  p.gout = static_cast<const float*>(gout);
  p.wfold = static_cast<const float*>(wfold);
  return bwd_dispatch(p, a, -1, grid, nullptr);
}

// Writes dh [B,T,D], dc [B,D], dapre [B*T,H], hx = [h, h*c] [B*T,2D],
// dsum = sum_t dapre_t [B,H] and small = [db1 | dalpha | dw2 | db2]
// (3H+1), through `partial`; the wrapper makes dw1 from hx^T dapre and
// c^T dsum, unfolded.
extern "C" int din_attention_bwd_f32(const void* hist, const void* cand, const void* w1,
                                     const void* b1, const void* alpha, const void* w2,
                                     const void* b2, const void* wfold, const void* gout,
                                     void* dh, void* dc, void* dap, void* hx, void* dsum,
                                     void* partial, void* small, const int64_t* a,
                                     int64_t grid, void* stream) {
  const BwdArgs p{static_cast<const float*>(hist), static_cast<const float*>(cand),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(alpha), static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<const float*>(wfold),
                  static_cast<const float*>(gout), static_cast<float*>(dh),
                  static_cast<float*>(dc), static_cast<float*>(dap), static_cast<float*>(hx),
                  static_cast<float*>(dsum), static_cast<float*>(partial),
                  static_cast<float*>(small)};
  return bwd_dispatch(p, a, grid, nullptr, static_cast<cudaStream_t>(stream));
}
