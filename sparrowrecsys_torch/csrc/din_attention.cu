// DIN activation unit (target attention), forward, float32.
//
// Replaces: sparrowrecsys_tpu/ops/attention.py::din_attention_pallas (:73),
// whose body _din_kernel (:65-69) runs _unit (:27-50) on a VMEM tile:
//   feats = [h, c, h*c]                          per step, [3D]
//   a     = feats @ [wa+wb; wc-wa; wd] + b1      w1 = [wa; wb; wc; wd], [4D, H]
//   a     = PReLU(a, alpha)
//   w     = sigmoid(a @ w2 + b2), and 0 where the row h is all zero
//   out   = sum_t w_t * h_t                      [B, D]
//
// Bound on the H100: operations. The candidate's share c @ (wc-wa) + b1
// is the same for every step of a row, so the unit costs D*H multiply-
// adds per row plus 2*D*H + H per step, in float32 outside the tensor
// cores. At B=65536, T=64, D=128, H=32 with every step live that is
// 70 GFLOP (1.04 ms at 67 TFLOP/s) against 2.2 GB of history read once
// (0.64 ms at 3.35 TB/s); an all-zero step needs no unit at all.
//
// Design: a block covers `rows` batch rows with one thread per (row, step),
// rows*T <= 256 threads. The block folds w1 into the [3D, H] weight once
// and keeps it, b1, alpha and w2 in shared memory for the whole grid-
// stride loop. For each tile of rows the block first computes the
// candidate term c @ (wc-wa) + b1 [rows, H] into shared memory (one thread
// per (row, j)); each step thread then starts its H pre-activations from
// it and adds h @ (wa+wb) + (h*c) @ wd. Every thread of a warp reads the
// same weight word, so the weight reads are broadcasts, four weights per
// 16-byte load. Each thread keeps its H pre-activations in registers and
// reads its history row once (16-byte loads where D allows). The step
// weights go through shared memory to the pooling pass, where
// neighbouring threads read neighbouring elements of h (mostly from
// L1/L2: the block has just read them). At D=128, H=32 the folded weight
// alone is 48 KB, so the launch raises the dynamic shared-memory limit
// first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowThreads = 128;

// Shared-memory row stride of the candidate term: H + 1 words, so the
// threads of a warp, which hold several rows, read it on distinct banks.
template <int H>
constexpr int kCandStride = H + 1;

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
  const float bias2 = b2[0];
  __syncthreads();

  const int tid = threadIdx.x;
  const int r = tid / steps;
  const int t = tid - r * steps;
  const int64_t groups = (batch + rows - 1) / rows;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    for (int i = tid; i < rows * H; i += blockDim.x) {
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
    __syncthreads();
    const int64_t b = g * rows + r;
    float w = 0.f;
    if (b < batch) {
      const float* h = hist + (b * steps + t) * d;
      const float* c = cand + b * d;
      float acc[H];
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] = s_cand[r * kCandStride<H> + j];
      bool nz = false;
      if (VEC) {
        for (int k = 0; k < d; k += 4) {
          const float4 h4 = __ldg(reinterpret_cast<const float4*>(h + k));
          const float4 c4 = __ldg(reinterpret_cast<const float4*>(c + k));
          nz |= (h4.x != 0.f) | (h4.y != 0.f) | (h4.z != 0.f) | (h4.w != 0.f);
          unit_step<H>(acc, h4.x, c4.x, wf, k + 0, d);
          unit_step<H>(acc, h4.y, c4.y, wf, k + 1, d);
          unit_step<H>(acc, h4.z, c4.z, wf, k + 2, d);
          unit_step<H>(acc, h4.w, c4.w, wf, k + 3, d);
        }
      } else {
        for (int k = 0; k < d; ++k) {
          const float hv = __ldg(h + k);
          nz |= hv != 0.f;
          unit_step<H>(acc, hv, __ldg(c + k), wf, k, d);
        }
      }
      float logit = bias2;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float a = acc[j] >= 0.f ? acc[j] : s_alpha[j] * acc[j];
        logit = fmaf(a, s_w2[j], logit);
      }
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

template <int H, bool VEC>
int launch(const float* hist, const float* cand, const float* w1, const float* b1,
           const float* alpha, const float* w2, const float* b2, float* out,
           int64_t batch, int steps, int d, cudaStream_t stream) {
  const int rows = steps >= kRowThreads ? 1 : kRowThreads / steps;
  const int threads = rows * steps;
  const size_t smem = (3 * static_cast<size_t>(d) * H + 3 * H + rows * steps +
                       rows * kCandStride<H>) * sizeof(float);
  auto kernel = din_attention_kernel<H, VEC>;
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
  const int64_t groups = (batch + rows - 1) / rows;
  if (groups == 0) return cudaSuccess;
  int64_t blocks = static_cast<int64_t>(sms) * per_sm;
  if (blocks > groups) blocks = groups;
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

}  // namespace

extern "C" int din_attention_f32(const void* hist, const void* cand, const void* w1,
                                 const void* b1, const void* alpha, const void* w2,
                                 const void* b2, void* out, int64_t batch, int steps,
                                 int d, int h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
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
