// FM second-order cross, forward and backward.
//   forward:  out[b, d] = (sum_f x[b, f, d])^2 - sum_f x[b, f, d]^2
//   backward: dx[b, f, d] = 2 g[b, d] (s[b, d] - x[b, f, d]),  s = sum_f x[b, f, d]
//
// Replaces: sparrowrecsys_tpu/ops/fm.py::fm_cross_pallas (:41), whose body
// _fm_kernel (:33-37) tiles the batch through VMEM, and its VJP
// fm_cross_bwd (:62, attached by fm_cross_pallas.defvjp at :76), whose
// residual is the raw input x (_fm_pallas_fwd, :58). There is no 0.5
// factor, as in the reference.
//
// Bound on the H100: bytes, both ways. The forward reads each input
// element once and does three flops with it; at B=262144, F=5, D=128 in
// float32 the call moves 0.81 GB (0.24 ms at 3.35 TB/s) and does 0.5
// GFLOP (7 us at 67 TFLOP/s). The backward reads x and g and writes dx:
// at B=65536, F=5, D=64 in float32, 0.19 GB (0.06 ms).
//
// Design: one thread per (row, group of 16 bytes along D). A loop over F
// keeps s (and, forward, sq) in float32 registers; neighbouring threads
// read neighbouring 16-byte words, so every load is coalesced, and each
// result is written once in the input dtype. The backward's second loop
// over F re-reads the same x words (still in L1) to write dx, so x
// crosses HBM once. Where D or the pointers do not allow 16-byte words,
// the same loops run one element per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V elements of T per 16-byte word (V == 1: plain scalar loads).
template <typename T, int V>
struct alignas(sizeof(T) * V) Word {
  T v[V];
};

template <typename T, int V>
__global__ void fm_cross_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int64_t n_words, int f, int d_words) {
  using W = Word<T, V>;
  static_assert(V == 1 || sizeof(W) == 16, "a word is one element or 16 bytes");
  const W* xw = reinterpret_cast<const W*>(x);
  W* ow = reinterpret_cast<W*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_words; i += stride) {
    const int64_t b = i / d_words;
    const int64_t col = i - b * d_words;
    const W* row = xw + b * f * d_words + col;
    float s[V], sq[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = sq[j] = 0.f;
    for (int k = 0; k < f; ++k) {
      const W w = row[static_cast<int64_t>(k) * d_words];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = to_f(w.v[j]);
        s[j] += v;
        sq[j] = fmaf(v, v, sq[j]);
      }
    }
    W o;
#pragma unroll
    for (int j = 0; j < V; ++j) o.v[j] = from_f<T>(s[j] * s[j] - sq[j]);
    ow[i] = o;
  }
}

template <typename T, int V>
__global__ void fm_cross_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                    T* __restrict__ dx, int64_t n_words, int f,
                                    int d_words) {
  using W = Word<T, V>;
  static_assert(V == 1 || sizeof(W) == 16, "a word is one element or 16 bytes");
  const W* xw = reinterpret_cast<const W*>(x);
  const W* gw = reinterpret_cast<const W*>(g);
  W* dw = reinterpret_cast<W*>(dx);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_words; i += stride) {
    const int64_t b = i / d_words;
    const int64_t col = i - b * d_words;
    const int64_t base = b * f * d_words + col;
    float s[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0.f;
    for (int k = 0; k < f; ++k) {
      const W w = xw[base + static_cast<int64_t>(k) * d_words];
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += to_f(w.v[j]);
    }
    const W gv = gw[i];
    float g2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) g2[j] = 2.f * to_f(gv.v[j]);
    for (int k = 0; k < f; ++k) {
      const int64_t at = base + static_cast<int64_t>(k) * d_words;
      const W w = xw[at];
      W o;
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = from_f<T>(g2[j] * (s[j] - to_f(w.v[j])));
      dw[at] = o;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Grid for n_words threads' worth of work (grid-stride beyond 2^20 blocks).
int grid_for(int64_t n_words, int threads) {
  const int64_t blocks64 = (n_words + threads - 1) / threads;
  return static_cast<int>(blocks64 < (1 << 20) ? blocks64 : (1 << 20));
}

template <typename T>
int launch(const void* x, void* out, int64_t b, int f, int d, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  constexpr int V = 16 / sizeof(T);
  const bool words = d % V == 0 && aligned16(x) && aligned16(out);
  const int threads = 256;
  const int d_words = words ? d / V : d;
  const int64_t n_words = b * d_words;
  if (n_words == 0) return cudaSuccess;
  const int blocks = grid_for(n_words, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words) {
    fm_cross_kernel<T, V><<<blocks, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n_words, f, d_words);
  } else {
    fm_cross_kernel<T, 1><<<blocks, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n_words, f, d_words);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, int64_t b, int f, int d, int device,
               void* stream) {
  DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return guard.status();
  constexpr int V = 16 / sizeof(T);
  const bool words = d % V == 0 && aligned16(x) && aligned16(g) && aligned16(dx);
  const int threads = 256;
  const int d_words = words ? d / V : d;
  const int64_t n_words = b * d_words;
  if (n_words == 0) return cudaSuccess;
  const int blocks = grid_for(n_words, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (words) {
    fm_cross_bwd_kernel<T, V><<<blocks, threads, 0, s>>>(xt, gt, dt, n_words, f, d_words);
  } else {
    fm_cross_bwd_kernel<T, 1><<<blocks, threads, 0, s>>>(xt, gt, dt, n_words, f, d_words);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fm_cross_f32(const void* x, void* out, int64_t b, int64_t f, int64_t d,
                            int64_t device, void* stream) {
  return launch<float>(x, out, b, f, d, device, stream);
}

extern "C" int fm_cross_bf16(const void* x, void* out, int64_t b, int64_t f, int64_t d,
                             int64_t device, void* stream) {
  return launch<__nv_bfloat16>(x, out, b, f, d, device, stream);
}

extern "C" int fm_cross_bwd_f32(const void* x, const void* g, void* dx, int64_t b, int64_t f,
                                int64_t d, int64_t device, void* stream) {
  return launch_bwd<float>(x, g, dx, b, f, d, device, stream);
}

extern "C" int fm_cross_bwd_bf16(const void* x, const void* g, void* dx, int64_t b, int64_t f,
                                 int64_t d, int64_t device, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, dx, b, f, d, device, stream);
}
