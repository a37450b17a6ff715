// DIN activation unit (target attention), forward and backward, float32.
//
// Replaces: sparrowrecsys_tpu/ops/attention.py::din_attention_pallas (:73),
// whose body _din_kernel (:65-69) runs _unit (:27-50) on a VMEM tile:
//   feats = [h, c, h*c]                          per step, [3D]
//   a     = feats @ [wa+wb; wc-wa; wd] + b1      w1 = [wa; wb; wc; wd], [4D, H]
//   a     = PReLU(a, alpha)
//   w     = sigmoid(a @ w2 + b2), and 0 where the row h is all zero
//   out   = sum_t w_t * h_t                      [B, D]
// and its VJP _din_fused_bwd (:119, attached by _din_attention_fused.defvjp
// at :124), which recomputes _unit from the raw inputs and returns the
// gradients of all seven inputs.
//
// Bound on the H100: operations. The candidate's share c @ (wc-wa) + b1
// is the same for every step of a row, so the unit costs D*H multiply-
// adds per row plus 2*D*H + H per step, in float32 outside the tensor
// cores. At B=65536, T=64, D=128, H=32 with every step live that is
// 70 GFLOP (1.04 ms at 67 TFLOP/s) against 2.2 GB of history read once
// (0.64 ms at 3.35 TB/s); an all-zero step needs no unit at all. The
// backward recomputes that and adds, per live step, 2*D*H multiply-adds
// for dh through the folded weight (wa+wb and wd) and 2*D*H + 3*H for the
// weight gradients dk0, dk2, db1, dalpha and dw2; the candidate's terms,
// dc's (wc-wa) dapre and dk1 = c^T dapre, depend on the step only through
// dapre, so they cost D*H each per row on sum_t dapre_t: 6*D*H + 4*H per
// live step plus 3*D*H per row in all, about 3x the forward.
//
// Forward design: a block covers `rows` batch rows with one thread per
// (row, step), rows*T <= 256 threads. The block folds w1 into the [3D, H]
// weight once and keeps it, b1, alpha and w2 in shared memory for the
// whole grid-stride loop. For each tile of rows the block first computes
// the candidate term c @ (wc-wa) + b1 [rows, H] into shared memory (one
// thread per (row, j)); each step thread then starts its H pre-activations
// from it and adds h @ (wa+wb) + (h*c) @ wd. Every thread of a warp reads
// the same weight word, so the weight reads are broadcasts, four weights
// per 16-byte load. Each thread keeps its H pre-activations in registers
// and reads its history row once (16-byte loads where D allows). The step
// weights go through shared memory to the pooling pass, where
// neighbouring threads read neighbouring elements of h (mostly from
// L1/L2: the block has just read them). At D=128, H=32 the folded weight
// alone is 48 KB, so the launch raises the dynamic shared-memory limit
// first.
//
// Backward design: the same tiles and the same recompute. Each live step
// thread turns g . h into dlogit and the pre-activation gradient dapre [H]
// (registers), then walks D once: dh = w g + (wa+wb) dapre + c (wd dapre),
// written straight to its row, and its step share of dc, h (wd dapre),
// into shared memory. The block then sums dapre over each row's steps
// ([rows, H] in shared memory), and a pass per (row, d) adds the steps'
// shares and (wc-wa) sum_t dapre_t into dc. The weight gradients are sums
// over B*T; to keep them deterministic (no float atomics) each step leaves
// its pre-activations, dapre and dlogit in shared memory, and the block
// adds the tile's steps in a fixed order into a per-block accumulator in
// shared memory: for dk0 = h^T dapre and dk2 = (h*c)^T dapre, and
// dk1 = c^T sum_t dapre_t over the tile's rows, each thread holds 8 sums
// of one row in registers (8 FMAs per scalar load and two broadcast
// 16-byte loads); for db1, dalpha, dw2 and db2 one thread per element. Each block writes its accumulator to a
// [blocks, P] scratch, and a second kernel adds the blocks in order and
// unfolds [dk0; dk1; dk2] back to w1's four blocks: dwa = dk0 - dk1,
// dwb = dk0, dwc = dk1, dwd = dk2. As in the reference, the PReLU sends the
// gradient at exactly 0 to the identity branch, the all-zero mask passes
// no gradient, and a masked step contributes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowThreads = 128;

// Shared-memory row stride of per-(row or step) [H] vectors: H + 1 words,
// so the threads of a warp, which hold several rows, hit distinct banks.
template <int H>
constexpr int kCandStride = H + 1;

// Rows per block: whole rows of `steps` threads, up to kRowThreads.
int rows_per_block(int steps) { return steps >= kRowThreads ? 1 : kRowThreads / steps; }

template <int H>
__device__ __forceinline__ void unit_step(float (&acc)[H], float hv, float cv,
                                          const float* wf, int k, int d) {
  const float hc = hv * cv;
  const float4* wh = reinterpret_cast<const float4*>(wf + k * H);
  const float4* wd = reinterpret_cast<const float4*>(wf + (2 * d + k) * H);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 a = wh[q], e = wd[q];
    acc[4 * q + 0] = fmaf(hc, e.x, fmaf(hv, a.x, acc[4 * q + 0]));
    acc[4 * q + 1] = fmaf(hc, e.y, fmaf(hv, a.y, acc[4 * q + 1]));
    acc[4 * q + 2] = fmaf(hc, e.z, fmaf(hv, a.z, acc[4 * q + 2]));
    acc[4 * q + 3] = fmaf(hc, e.w, fmaf(hv, a.w, acc[4 * q + 3]));
  }
}

// Folds w1 [4D, H] into wf [3D, H] = [wa+wb; wc-wa; wd] and copies b1,
// alpha and w2 into shared memory. The caller synchronises.
template <int H>
__device__ void load_weights(const float* __restrict__ w1, const float* __restrict__ b1,
                             const float* __restrict__ alpha, const float* __restrict__ w2,
                             float* wf, float* s_b1, float* s_alpha, float* s_w2, int d) {
  const int dh = d * H;
  for (int i = threadIdx.x; i < dh; i += blockDim.x) {
    const float wa = w1[i], wb = w1[dh + i], wc = w1[2 * dh + i], wd = w1[3 * dh + i];
    wf[i] = wa + wb;
    wf[dh + i] = wc - wa;
    wf[2 * dh + i] = wd;
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    s_b1[j] = b1[j];
    s_alpha[j] = alpha[j];
    s_w2[j] = w2[j];
  }
}

// s_cand[rr, j] = c[g*rows + rr] @ (wc-wa)[:, j] + b1[j] for the tile's rows.
template <int H>
__device__ void candidate_term(const float* __restrict__ cand, const float* wf,
                               const float* s_b1, float* s_cand, int64_t g, int rows,
                               int64_t batch, int d) {
  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const int rr = i / H;
    const int j = i - rr * H;
    const int64_t bb = g * rows + rr;
    float s = s_b1[j];
    if (bb < batch) {
      const float* c = cand + bb * d;
      for (int k = 0; k < d; ++k) s = fmaf(__ldg(c + k), wf[(d + k) * H + j], s);
    }
    s_cand[rr * kCandStride<H> + j] = s;
  }
}

// The step's H pre-activations (from the candidate term) and whether its
// history row has a non-zero element; with DOT, also g . h into *gh.
template <int H, bool VEC, bool DOT>
__device__ __forceinline__ bool preactivations(float (&acc)[H], const float* h,
                                               const float* c, const float* s_cand_row,
                                               const float* wf, int d,
                                               const float* gout, float* gh) {
#pragma unroll
  for (int j = 0; j < H; ++j) acc[j] = s_cand_row[j];
  bool nz = false;
  float dot = 0.f;
  if (VEC) {
    for (int k = 0; k < d; k += 4) {
      const float4 h4 = __ldg(reinterpret_cast<const float4*>(h + k));
      const float4 c4 = __ldg(reinterpret_cast<const float4*>(c + k));
      nz |= (h4.x != 0.f) | (h4.y != 0.f) | (h4.z != 0.f) | (h4.w != 0.f);
      if (DOT) {
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(gout + k));
        dot = fmaf(g4.x, h4.x, dot);
        dot = fmaf(g4.y, h4.y, dot);
        dot = fmaf(g4.z, h4.z, dot);
        dot = fmaf(g4.w, h4.w, dot);
      }
      unit_step<H>(acc, h4.x, c4.x, wf, k + 0, d);
      unit_step<H>(acc, h4.y, c4.y, wf, k + 1, d);
      unit_step<H>(acc, h4.z, c4.z, wf, k + 2, d);
      unit_step<H>(acc, h4.w, c4.w, wf, k + 3, d);
    }
  } else {
    for (int k = 0; k < d; ++k) {
      const float hv = __ldg(h + k);
      nz |= hv != 0.f;
      if (DOT) dot = fmaf(__ldg(gout + k), hv, dot);
      unit_step<H>(acc, hv, __ldg(c + k), wf, k, d);
    }
  }
  if (DOT) *gh = dot;
  return nz;
}

template <int H>
__device__ __forceinline__ float logit_of(const float (&acc)[H], const float* s_alpha,
                                          const float* s_w2, float bias2) {
  float logit = bias2;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float a = acc[j] >= 0.f ? acc[j] : s_alpha[j] * acc[j];
    logit = fmaf(a, s_w2[j], logit);
  }
  return logit;
}

template <int H, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
din_attention_kernel(const float* __restrict__ hist, const float* __restrict__ cand,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ alpha, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int64_t batch, int steps, int d, int rows) {
  extern __shared__ float4 smem4[];
  float* wf = reinterpret_cast<float*>(smem4);  // [3D, H]
  float* s_b1 = wf + 3 * d * H;
  float* s_alpha = s_b1 + H;
  float* s_w2 = s_alpha + H;
  float* s_wt = s_w2 + H;  // [rows * steps] step weights
  float* s_cand = s_wt + rows * steps;  // [rows, H + 1] c @ (wc-wa) + b1

  load_weights<H>(w1, b1, alpha, w2, wf, s_b1, s_alpha, s_w2, d);
  const float bias2 = b2[0];
  __syncthreads();

  const int tid = threadIdx.x;
  const int r = tid / steps;
  const int t = tid - r * steps;
  const int64_t groups = (batch + rows - 1) / rows;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    candidate_term<H>(cand, wf, s_b1, s_cand, g, rows, batch, d);
    __syncthreads();
    const int64_t b = g * rows + r;
    float w = 0.f;
    if (b < batch) {
      float acc[H];
      const bool nz = preactivations<H, VEC, false>(
          acc, hist + (b * steps + t) * d, cand + b * d, s_cand + r * kCandStride<H>, wf, d,
          nullptr, nullptr);
      const float logit = logit_of<H>(acc, s_alpha, s_w2, bias2);
      w = nz ? 1.f / (1.f + expf(-logit)) : 0.f;
    }
    s_wt[tid] = w;
    __syncthreads();
    for (int i = tid; i < rows * d; i += blockDim.x) {
      const int rr = i / d;
      const int dd = i - rr * d;
      const int64_t bb = g * rows + rr;
      if (bb < batch) {
        const float* hb = hist + bb * steps * d + dd;
        float s = 0.f;
        for (int t2 = 0; t2 < steps; ++t2) {
          s = fmaf(s_wt[rr * steps + t2], __ldg(hb + static_cast<int64_t>(t2) * d), s);
        }
        out[bb * d + dd] = s;
      }
    }
    __syncthreads();
  }
}

// Weight-gradient elements per block: [dk0 | dk1 | dk2] (3 D H, each
// [D, H] row-major), db1, dalpha, dw2 (H each), db2 (1).
__host__ __device__ inline int grad_elems(int d, int h) { return 3 * d * h + 3 * h + 1; }

// Shared floats of one backward block: wf [3D, H], dapre [n, H], its sums
// over each row's steps [rows, H], b1, alpha, w2, the accumulator [P], the
// candidate term [rows, H+1], the pre-activations [n, H+1], dlogit [n] and
// the dc shares [n, D|1].
size_t bwd_shared_floats(int steps, int d, int h) {
  const int rows = rows_per_block(steps);
  const size_t n = static_cast<size_t>(rows) * steps;
  return 3 * static_cast<size_t>(d) * h + n * h + rows * h + 3 * h + grad_elems(d, h) +
         rows * (h + 1) + n * (h + 1) + n + n * (d | 1);
}

template <int H, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
din_attention_bwd_kernel(const float* __restrict__ hist, const float* __restrict__ cand,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ alpha, const float* __restrict__ w2,
                         const float* __restrict__ b2, const float* __restrict__ gout,
                         float* __restrict__ dh, float* __restrict__ dc,
                         float* __restrict__ partial, int64_t batch, int steps, int d,
                         int rows) {
  extern __shared__ float4 smem4[];
  const int n = rows * steps;
  const int p_all = grad_elems(d, H);
  const int dp = d | 1;  // odd stride: the step threads' rows hit distinct banks
  float* wf = reinterpret_cast<float*>(smem4);    // [3D, H]
  float* s_dap = wf + 3 * d * H;                  // [n, H] dapre, 0 for a dead step
  float* s_dsum = s_dap + n * H;                  // [rows, H] sum_t dapre over a row's steps
  float* s_b1 = s_dsum + rows * H;                // (all three 16-byte aligned: H % 8 == 0)
  float* s_alpha = s_b1 + H;
  float* s_w2 = s_alpha + H;
  float* s_acc = s_w2 + H;                        // [P] this block's weight gradients
  float* s_cand = s_acc + p_all;                  // [rows, H + 1]
  float* s_apre = s_cand + rows * kCandStride<H>; // [n, H + 1] pre-activations
  float* s_dl = s_apre + n * kCandStride<H>;      // [n] dlogit, 0 for a dead step
  float* s_dcp = s_dl + n;                        // [n, dp] each step's share of dc

  load_weights<H>(w1, b1, alpha, w2, wf, s_b1, s_alpha, s_w2, d);
  for (int p = threadIdx.x; p < p_all; p += blockDim.x) s_acc[p] = 0.f;
  const float bias2 = b2[0];
  __syncthreads();

  const int dh_sz = d * H;
  const int tid = threadIdx.x;
  const int r = tid / steps;
  const int t = tid - r * steps;
  const int64_t groups = (batch + rows - 1) / rows;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    candidate_term<H>(cand, wf, s_b1, s_cand, g, rows, batch, d);
    __syncthreads();

    // 1. One thread per (row, step): recompute, dh, and the shares of dc.
    const int64_t b = g * rows + r;
    float* ap = s_apre + tid * kCandStride<H>;
    float* dp_row = s_dap + tid * H;
    float* dcp = s_dcp + tid * dp;
    float dl = 0.f;
    bool live = false;
    if (b < batch) {
      const float* h = hist + (b * steps + t) * d;
      const float* c = cand + b * d;
      const float* gr = gout + b * d;
      float* dhr = dh + (b * steps + t) * d;
      float acc[H];
      float gh = 0.f;
      live = preactivations<H, VEC, true>(acc, h, c, s_cand + r * kCandStride<H>, wf, d, gr, &gh);
      if (live) {
        const float s = 1.f / (1.f + expf(-logit_of<H>(acc, s_alpha, s_w2, bias2)));
        dl = gh * s * (1.f - s);
#pragma unroll
        for (int j = 0; j < H; ++j) {
          ap[j] = acc[j];
          const float da = s_w2[j] * dl;
          acc[j] = acc[j] >= 0.f ? da : s_alpha[j] * da;  // acc now holds dapre
          dp_row[j] = acc[j];
        }
        for (int k = 0; k < d; ++k) {
          const float4* w0 = reinterpret_cast<const float4*>(wf + k * H);
          const float4* w2f = reinterpret_cast<const float4*>(wf + (2 * d + k) * H);
          float f0 = 0.f, f2 = 0.f;
#pragma unroll
          for (int q = 0; q < H / 4; ++q) {
            const float4 a0 = w0[q], a2 = w2f[q];
            f0 = fmaf(a0.x, acc[4 * q], fmaf(a0.y, acc[4 * q + 1],
                 fmaf(a0.z, acc[4 * q + 2], fmaf(a0.w, acc[4 * q + 3], f0))));
            f2 = fmaf(a2.x, acc[4 * q], fmaf(a2.y, acc[4 * q + 1],
                 fmaf(a2.z, acc[4 * q + 2], fmaf(a2.w, acc[4 * q + 3], f2))));
          }
          const float hv = __ldg(h + k), cv = __ldg(c + k);
          dhr[k] = fmaf(s, __ldg(gr + k), fmaf(cv, f2, f0));
          dcp[k] = hv * f2;
        }
      } else {
        for (int k = 0; k < d; ++k) dhr[k] = 0.f;
      }
    }
    if (!live) {
#pragma unroll
      for (int j = 0; j < H; ++j) ap[j] = dp_row[j] = 0.f;
      for (int k = 0; k < d; ++k) dcp[k] = 0.f;
    }
    s_dl[tid] = dl;
    __syncthreads();

    // 2. sum_t dapre_t per row, in step order.
    for (int i = tid; i < rows * H; i += blockDim.x) {
      const int rr = i / H;
      const int j = i - rr * H;
      float s = 0.f;
      for (int t2 = 0; t2 < steps; ++t2) s += s_dap[(rr * steps + t2) * H + j];
      s_dsum[i] = s;
    }
    __syncthreads();

    // 3. dc = (wc-wa) sum_t dapre_t + the steps' shares: one thread per
    // (row, d). Each thread starts the H-sum at its own j, so the threads
    // of a warp, on rows of wf H words apart, read distinct banks.
    for (int i = tid; i < rows * d; i += blockDim.x) {
      const int rr = i / d;
      const int k = i - rr * d;
      const int64_t bb = g * rows + rr;
      if (bb < batch) {
        const float* wrow = wf + (d + k) * H;
        const float* ds = s_dsum + rr * H;
        float s = 0.f;
        for (int j = 0; j < H; ++j) {
          const int jj = (j + k) & (H - 1);
          s = fmaf(wrow[jj], ds[jj], s);
        }
        for (int t2 = 0; t2 < steps; ++t2) s += s_dcp[(rr * steps + t2) * dp + k];
        dc[bb * d + k] = s;
      }
    }

    // 4. Weight gradients, each a sum over the tile in order: one thread
    // per (row kk of the [3D, H] gradient, 8 columns), 8 sums in
    // registers, two broadcast float4 of dapre per term. dk0 and dk2 are
    // X^T dapre over the tile's live steps, X = h or h*c; dk1 is
    // c^T sum_t dapre_t over its rows.
    const int64_t valid_rows = batch - g * rows < rows ? batch - g * rows : rows;
    const float* htile = hist + g * rows * steps * d;
    const float* ctile = cand + g * rows * d;
    constexpr int kGroups = H / 8;
    for (int it = tid; it < 3 * d * kGroups; it += blockDim.x) {
      const int kk = it / kGroups;
      const int j0 = (it - kk * kGroups) * 8;
      const int blk = kk / d;
      const int k = kk - blk * d;
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int rr = 0; rr < valid_rows; ++rr) {
        const float cv = blk == 0 ? 1.f : __ldg(ctile + static_cast<int64_t>(rr) * d + k);
        if (blk == 1) {
          const float4 p = *reinterpret_cast<const float4*>(s_dsum + rr * H + j0);
          const float4 q = *reinterpret_cast<const float4*>(s_dsum + rr * H + j0 + 4);
          a[0] = fmaf(cv, p.x, a[0]);
          a[1] = fmaf(cv, p.y, a[1]);
          a[2] = fmaf(cv, p.z, a[2]);
          a[3] = fmaf(cv, p.w, a[3]);
          a[4] = fmaf(cv, q.x, a[4]);
          a[5] = fmaf(cv, q.y, a[5]);
          a[6] = fmaf(cv, q.z, a[6]);
          a[7] = fmaf(cv, q.w, a[7]);
          continue;
        }
        for (int t2 = 0; t2 < steps; ++t2) {
          const int i = rr * steps + t2;
          if (s_dl[i] == 0.f) continue;
          const float x = __ldg(htile + static_cast<int64_t>(i) * d + k) * cv;
          const float4 p = *reinterpret_cast<const float4*>(s_dap + i * H + j0);
          const float4 q = *reinterpret_cast<const float4*>(s_dap + i * H + j0 + 4);
          a[0] = fmaf(x, p.x, a[0]);
          a[1] = fmaf(x, p.y, a[1]);
          a[2] = fmaf(x, p.z, a[2]);
          a[3] = fmaf(x, p.w, a[3]);
          a[4] = fmaf(x, q.x, a[4]);
          a[5] = fmaf(x, q.y, a[5]);
          a[6] = fmaf(x, q.z, a[6]);
          a[7] = fmaf(x, q.w, a[7]);
        }
      }
      float* dst = s_acc + kk * H + j0;
#pragma unroll
      for (int q = 0; q < 8; ++q) dst[q] += a[q];
    }
    // db1, dalpha, dw2 (H each) and db2: one thread per element.
    const int n_valid = static_cast<int>(valid_rows) * steps;
    for (int q = tid; q < 3 * H + 1; q += blockDim.x) {
      const int which = q / H;  // 0 db1, 1 dalpha, 2 dw2, 3 db2
      const int j = q - which * H;
      float sum = 0.f;
      for (int i = 0; i < n_valid; ++i) {
        const float dli = s_dl[i];
        if (dli == 0.f) continue;
        if (which == 3) {
          sum += dli;
          continue;
        }
        const float a = s_apre[i * kCandStride<H> + j];
        const float da = s_w2[j] * dli;
        if (which == 0) {
          sum += a >= 0.f ? da : s_alpha[j] * da;
        } else if (which == 1) {
          sum += a >= 0.f ? 0.f : a * da;
        } else {
          sum = fmaf(a >= 0.f ? a : s_alpha[j] * a, dli, sum);
        }
      }
      s_acc[3 * dh_sz + q] += sum;
    }
    __syncthreads();
  }
  for (int p = tid; p < p_all; p += blockDim.x) {
    partial[static_cast<int64_t>(blockIdx.x) * p_all + p] = s_acc[p];
  }
}

// Adds the blocks' partial sums in block order and unfolds them to w1's blocks.
__global__ void din_attention_bwd_reduce(const float* __restrict__ partial, int blocks, int d,
                                         int h, float* __restrict__ dw1,
                                         float* __restrict__ db1, float* __restrict__ dalpha,
                                         float* __restrict__ dw2, float* __restrict__ db2) {
  const int p_all = grad_elems(d, h);
  const int dh_sz = d * h;
  const int items = dh_sz + 3 * h + 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    if (i < dh_sz) {
      float k0 = 0.f, k1 = 0.f, k2 = 0.f;
      for (int b = 0; b < blocks; ++b) {
        const float* row = partial + static_cast<int64_t>(b) * p_all;
        k0 += row[i];
        k1 += row[dh_sz + i];
        k2 += row[2 * dh_sz + i];
      }
      dw1[i] = k0 - k1;           // wa: through wa+wb and wc-wa
      dw1[dh_sz + i] = k0;        // wb
      dw1[2 * dh_sz + i] = k1;    // wc
      dw1[3 * dh_sz + i] = k2;    // wd
    } else {
      const int q = i - dh_sz;
      float s = 0.f;
      for (int b = 0; b < blocks; ++b) s += partial[static_cast<int64_t>(b) * p_all + 3 * dh_sz + q];
      const int which = q / h;
      const int j = q - which * h;
      if (which == 0) db1[j] = s;
      else if (which == 1) dalpha[j] = s;
      else if (which == 2) dw2[j] = s;
      else db2[0] = s;
    }
  }
}

// Largest grid that is resident at once (the grid-stride loops cover the rest).
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
  return cudaSuccess;
}

template <int H, bool VEC>
int launch(const float* hist, const float* cand, const float* w1, const float* b1,
           const float* alpha, const float* w2, const float* b2, float* out,
           int64_t batch, int steps, int d, cudaStream_t stream) {
  const int rows = rows_per_block(steps);
  const int threads = rows * steps;
  const size_t smem = (3 * static_cast<size_t>(d) * H + 3 * H + rows * steps +
                       rows * kCandStride<H>) * sizeof(float);
  const int64_t groups = (batch + rows - 1) / rows;
  if (groups == 0) return cudaSuccess;
  auto kernel = din_attention_kernel<H, VEC>;
  int64_t blocks = 0;
  cudaError_t err = resident_blocks(kernel, threads, smem, groups, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(
      hist, cand, w1, b1, alpha, w2, b2, out, batch, steps, d, rows);
  return cudaGetLastError();
}

template <int H>
int launch_h(const float* hist, const float* cand, const float* w1, const float* b1,
             const float* alpha, const float* w2, const float* b2, float* out,
             int64_t batch, int steps, int d, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(hist) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cand) % 16 == 0;
  if (vec) {
    return launch<H, true>(hist, cand, w1, b1, alpha, w2, b2, out, batch, steps, d, stream);
  }
  return launch<H, false>(hist, cand, w1, b1, alpha, w2, b2, out, batch, steps, d, stream);
}

struct BwdArgs {
  const float *hist, *cand, *w1, *b1, *alpha, *w2, *b2, *gout;
  float *dh, *dc, *partial, *dw1, *db1, *dalpha, *dw2, *db2;
  int64_t batch;
  int steps, d;
};

template <int H, bool VEC>
cudaError_t bwd_grid(const BwdArgs& a, int64_t* blocks) {
  const int rows = rows_per_block(a.steps);
  const int64_t groups = (a.batch + rows - 1) / rows;
  return resident_blocks(din_attention_bwd_kernel<H, VEC>, rows * a.steps,
                         bwd_shared_floats(a.steps, a.d, H) * sizeof(float),
                         groups < 1 ? 1 : groups, blocks);
}

template <int H, bool VEC>
int launch_bwd(const BwdArgs& a, int64_t blocks, cudaStream_t stream) {
  const int rows = rows_per_block(a.steps);
  const size_t smem = bwd_shared_floats(a.steps, a.d, H) * sizeof(float);
  int64_t most = 0;
  cudaError_t err = bwd_grid<H, VEC>(a, &most);  // also raises the shared-memory limit
  if (err != cudaSuccess) return err;
  if (blocks < 1 || blocks > most) return cudaErrorInvalidValue;
  din_attention_bwd_kernel<H, VEC><<<static_cast<int>(blocks), rows * a.steps, smem, stream>>>(
      a.hist, a.cand, a.w1, a.b1, a.alpha, a.w2, a.b2, a.gout, a.dh, a.dc, a.partial,
      a.batch, a.steps, a.d, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items = a.d * H + 3 * H + 1;
  din_attention_bwd_reduce<<<(items + 255) / 256, 256, 0, stream>>>(
      a.partial, static_cast<int>(blocks), a.d, H, a.dw1, a.db1, a.dalpha, a.dw2, a.db2);
  return cudaGetLastError();
}

bool vec_ok(const BwdArgs& a) {
  return a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.hist) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.cand) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.gout) % 16 == 0;
}

// blocks < 0: report the grid (into *grid) and launch nothing.
template <int H>
int bwd_h(const BwdArgs& a, int64_t blocks, int64_t* grid, cudaStream_t stream) {
  const bool vec = vec_ok(a);
  if (blocks < 0) return vec ? bwd_grid<H, true>(a, grid) : bwd_grid<H, false>(a, grid);
  return vec ? launch_bwd<H, true>(a, blocks, stream) : launch_bwd<H, false>(a, blocks, stream);
}

int bwd_dispatch(const BwdArgs& a, int h, int64_t blocks, int64_t* grid, cudaStream_t s) {
  if (a.steps < 1 || a.steps > kMaxThreads) return cudaErrorInvalidValue;
  switch (h) {
    case 8: return bwd_h<8>(a, blocks, grid, s);
    case 16: return bwd_h<16>(a, blocks, grid, s);
    case 32: return bwd_h<32>(a, blocks, grid, s);
    case 64: return bwd_h<64>(a, blocks, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int din_attention_f32(const void* hist, const void* cand, const void* w1,
                                 const void* b1, const void* alpha, const void* w2,
                                 const void* b2, void* out, int64_t batch, int64_t steps,
                                 int64_t d, int64_t h, int64_t device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (steps < 1 || steps > kMaxThreads) return cudaErrorInvalidValue;
  const auto* H_ = static_cast<const float*>(hist);
  const auto* C_ = static_cast<const float*>(cand);
  const auto* W1 = static_cast<const float*>(w1);
  const auto* B1 = static_cast<const float*>(b1);
  const auto* A_ = static_cast<const float*>(alpha);
  const auto* W2 = static_cast<const float*>(w2);
  const auto* B2 = static_cast<const float*>(b2);
  auto* O_ = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 8: return launch_h<8>(H_, C_, W1, B1, A_, W2, B2, O_, batch, steps, d, s);
    case 16: return launch_h<16>(H_, C_, W1, B1, A_, W2, B2, O_, batch, steps, d, s);
    case 32: return launch_h<32>(H_, C_, W1, B1, A_, W2, B2, O_, batch, steps, d, s);
    case 64: return launch_h<64>(H_, C_, W1, B1, A_, W2, B2, O_, batch, steps, d, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's grid for these pointers and shapes: the caller allocates
// the [grid, 3DH + 3H + 1] scratch and passes the same grid to
// din_attention_bwd_f32. Pointers matter: they select the 16-byte path.
extern "C" int din_attention_bwd_grid(const void* hist, const void* cand, const void* gout,
                                      int64_t batch, int64_t steps, int64_t d, int64_t h,
                                      int64_t device, int64_t* grid) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  BwdArgs a{};
  a.hist = static_cast<const float*>(hist);
  a.cand = static_cast<const float*>(cand);
  a.gout = static_cast<const float*>(gout);
  a.batch = batch;
  a.steps = static_cast<int>(steps);
  a.d = static_cast<int>(d);
  return bwd_dispatch(a, static_cast<int>(h), -1, grid, nullptr);
}

extern "C" int din_attention_bwd_f32(const void* hist, const void* cand, const void* w1,
                                     const void* b1, const void* alpha, const void* w2,
                                     const void* b2, const void* gout, void* dh, void* dc,
                                     void* partial, int64_t blocks, void* dw1, void* db1,
                                     void* dalpha, void* dw2, void* db2, int64_t batch,
                                     int64_t steps, int64_t d, int64_t h, int64_t device,
                                     void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  BwdArgs a{static_cast<const float*>(hist), static_cast<const float*>(cand),
            static_cast<const float*>(w1), static_cast<const float*>(b1),
            static_cast<const float*>(alpha), static_cast<const float*>(w2),
            static_cast<const float*>(b2), static_cast<const float*>(gout),
            static_cast<float*>(dh), static_cast<float*>(dc), static_cast<float*>(partial),
            static_cast<float*>(dw1), static_cast<float*>(db1), static_cast<float*>(dalpha),
            static_cast<float*>(dw2), static_cast<float*>(db2), batch,
            static_cast<int>(steps), static_cast<int>(d)};
  return bwd_dispatch(a, static_cast<int>(h), blocks, nullptr, static_cast<cudaStream_t>(stream));
}
