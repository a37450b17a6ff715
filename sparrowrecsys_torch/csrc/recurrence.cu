// DIEN's two recurrences, each direction one launch over all T steps.
//
//   gru_scan_fwd:   hs[b, t] = GRU step of hs[b, t-1] (h0 = 0) and gx[b, t]
//   gru_scan_bwd:   the reverse dh chain: dgx [B, T, 3H], ops [B, T, 2H], dh0
//   augru_scan_fwd: hs[b, t] = AUGRU step of hs[b, t-1] (h0 = 0), x[b, t], att[b, t]
//   augru_scan_bwd: the reverse dh chain: dx [B, T, 3H], ops [B, T, 2H],
//                   datt [B, T], dh0
//
// The GRU is the reset-before-product form of ops/augru.py::_gru_step,
// gates z|r|h in gx's and U's columns:
//   z = sigmoid(xz + h U_z), r = sigmoid(xr + h U_r), hh = tanh(xh + (r h) U_h),
//   h' = z h + (1 - z) hh on a live step (mask[b, t] != 0), h' = h on a masked one.
// The AUGRU is ops/augru.py::_augru_step, gates r|z|h, with one attention
// scalar a_t per step (DIEN's att_dense1 output, [B, T]):
//   r = sigmoid(xr + h U_r), z = sigmoid(xz + h U_z), ht = tanh(xh + (h z) U_h),
//   h' = (1 - a_t r) h + a_t r ht.
// The input projections (gx, x) are one product over [B*T, D] outside,
// as are the weight gradients: the backward writes each step's
// pre-activation gradients and the operands of the two products
// (ops = [h_prev | r h_prev] for the GRU, [h_prev | h_prev z] for the AUGRU),
// and ops/augru.py multiplies them over the stacked steps.
//
// Replaces no Pallas kernel: the JAX package runs both recurrences as
// `lax.scan` over plain products (sparrowrecsys_tpu/ops/augru.py). The
// port's per-step loop launched 10-25 kernels a step in each direction
// (about 4,000 a DIEN training step at T = 64), and its slices' backward
// wrote a zero-filled gradient the size of the whole sequence every step.
//
// Bound on the H100: bytes. At DIEN's [131072, 64, 10] the GRU forward
// reads gx (1.0 GB) and writes hs (0.34 GB): 0.40 ms at 3.35 TB/s; its
// backward moves twice that. Each step is 3H^2 multiply-adds a row
// forward and about twice that backward, far under the card's rate, but
// each step waits on the one before.
//
// This design:
// - H lanes of a warp own a batch row, lane j its state's element j, for
//   all T steps: 32 / H rows a warp (3 at H = 10). A product h U takes H
//   shuffles of h_k and H multiply-adds a lane; a product with U's
//   transpose the same, each lane summing its own row of U. State and
//   carried gradient stay in registers, a few a lane, so many warps fit on
//   an SM to hide each step's chain of dependent operations.
// - A row's H lanes read and write a step's H contiguous floats of each
//   [B, T, .] tensor (batch-major, as the caller holds them), so a warp's
//   access touches 32 / H short runs, not 32 scattered lines. The next
//   step's inputs are loaded before the current step's arithmetic.
// - The recurrent weights (3H^2 floats, U_a | U_b | U_h) are staged into
//   shared memory once per block, rows of an odd pitch: the lanes of a row
//   read consecutive words of one row of U, or (the transposed products)
//   one word from each of H rows, in different banks either way.
// - Deterministic: no atomics; every sum has a fixed order (k ascending),
//   so two calls agree bit for bit. ops/augru.py's `*_plain` twins repeat
//   the arithmetic in that order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 128;     // four warps
constexpr int kMaxHidden = 32;    // ops/augru.py::MAX_HIDDEN
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

struct Shape {
  int b, t, h;
  int pitch;  // of U's rows in shared memory: 3H, made odd
};

// Where a lane works: its row (valid when `live`), its element j, the
// first lane of its row.
struct Lane {
  int64_t row;
  int j, base;
  bool live;
};

__device__ __forceinline__ Lane lane_of(const Shape& s) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / s.h;
  const int q = lane / s.h;
  Lane l;
  l.j = lane - q * s.h;
  l.base = q * s.h;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  l.row = warp * per_warp + q;
  l.live = q < per_warp && l.row < s.b;
  return l;
}

// us[k * pitch + g * h + j] = block g's weight (k, j): blocks 0 and 1 from
// `a` (row stride a_cols, block g's columns [g*h, (g+1)*h)), block 2 from
// `c` (row stride c_cols, columns [0, h)).
__device__ void stage_weights(float* us, const float* __restrict__ a, int a_cols,
                              const float* __restrict__ c, int c_cols, const Shape& s) {
  const int h = s.h;
  for (int i = threadIdx.x; i < h * 3 * h; i += blockDim.x) {
    const int k = i / (3 * h), col = i % (3 * h), g = col / h, j = col % h;
    us[k * s.pitch + col] = g < 2 ? __ldg(a + k * a_cols + g * h + j) : __ldg(c + k * c_cols + j);
  }
}

// sum over k ascending of v_k * us[k][col], v_k the value of lane base + k.
__device__ __forceinline__ float dot_col(const float* us, int pitch, int col, float v, int base,
                                         int h) {
  float acc = 0.f;
#pragma unroll 5
  for (int k = 0; k < h; ++k) acc = fmaf(__shfl_sync(kAll, v, base + k), us[k * pitch + col], acc);
  return acc;
}

// sum over m ascending of v_m * row[m], v_m the value of lane base + m: the
// product with U's transpose, each lane its own row of U.
__device__ __forceinline__ float dot_row(const float* row, float v, int base, int h) {
  float acc = 0.f;
#pragma unroll 5
  for (int m = 0; m < h; ++m) acc = fmaf(__shfl_sync(kAll, v, base + m), row[m], acc);
  return acc;
}

// A step's inputs for one lane: its three gate projections, and the step's
// mask or attention (the same on every lane of the row).
struct StepIn {
  float xa, xb, xc;
  float hp, g;
  float w;
};

__device__ __forceinline__ void load_x(StepIn& in, const float* __restrict__ x, const Lane& l,
                                       const Shape& s, int t) {
  if (l.live) {
    const float* p = x + (l.row * s.t + t) * 3 * s.h + l.j;
    in.xa = __ldg(p);
    in.xb = __ldg(p + s.h);
    in.xc = __ldg(p + 2 * s.h);
  } else {
    in.xa = in.xb = in.xc = 0.f;
  }
}

// The lane's element of h_prev (hs at t - 1, 0 at t = 0) and of the step's
// output gradient (dhs at t, where given).
__device__ __forceinline__ void load_back(StepIn& in, const float* __restrict__ hs,
                                          const float* __restrict__ dhs, const Lane& l,
                                          const Shape& s, int t) {
  const int64_t at = (l.row * s.t + t) * s.h + l.j;
  in.hp = l.live && t > 0 ? __ldg(hs + at - s.h) : 0.f;
  in.g = l.live && dhs != nullptr ? __ldg(dhs + at) : 0.f;
}

__device__ __forceinline__ float load_mask(const uint8_t* __restrict__ mask, const Lane& l,
                                           const Shape& s, int t) {
  return l.live && mask[l.row * s.t + t] != 0 ? 1.f : 0.f;
}

__device__ __forceinline__ float load_att(const float* __restrict__ att, const Lane& l,
                                          const Shape& s, int t) {
  return l.live ? __ldg(att + l.row * s.t + t) : 0.f;
}

// The GRU's gates of the lane's element from the previous state hp.
__device__ __forceinline__ void gru_gates(const float* us, const Shape& s, const Lane& l,
                                          const StepIn& in, float hp, float& z, float& r,
                                          float& hh) {
  const int h = s.h;
  const float az = dot_col(us, s.pitch, l.j, hp, l.base, h);
  const float ar = dot_col(us, s.pitch, h + l.j, hp, l.base, h);
  z = sigmoidf(in.xa + az);
  r = sigmoidf(in.xb + ar);
  hh = tanhf(in.xc + dot_col(us, s.pitch, 2 * h + l.j, r * hp, l.base, h));
}

// The AUGRU's gates of the lane's element from the previous state hp.
__device__ __forceinline__ void augru_gates(const float* us, const Shape& s, const Lane& l,
                                            const StepIn& in, float hp, float& r, float& z,
                                            float& ht) {
  const int h = s.h;
  const float ar = dot_col(us, s.pitch, l.j, hp, l.base, h);
  const float az = dot_col(us, s.pitch, h + l.j, hp, l.base, h);
  r = sigmoidf(in.xa + ar);
  z = sigmoidf(in.xb + az);
  ht = tanhf(in.xc + dot_col(us, s.pitch, 2 * h + l.j, hp * z, l.base, h));
}

__global__ void __launch_bounds__(kThreads) gru_scan_fwd_kernel(
    const float* __restrict__ gx, const float* __restrict__ u, const uint8_t* __restrict__ mask,
    float* __restrict__ hs, Shape s) {
  extern __shared__ float us[];
  stage_weights(us, u, 3 * s.h, u + 2 * s.h, 3 * s.h, s);
  __syncthreads();
  const Lane l = lane_of(s);
  const int64_t row_t = l.row * s.t;
  StepIn in, next;
  load_x(next, gx, l, s, 0);
  float m_next = load_mask(mask, l, s, 0);
  float hc = 0.f;
  for (int t = 0; t < s.t; ++t) {
    in = next;
    const float m = m_next;
    if (t + 1 < s.t) {
      load_x(next, gx, l, s, t + 1);
      m_next = load_mask(mask, l, s, t + 1);
    }
    float z, r, hh;
    gru_gates(us, s, l, in, hc, z, r, hh);
    hc = m != 0.f ? z * hc + (1.f - z) * hh : hc;
    if (l.live) hs[(row_t + t) * s.h + l.j] = hc;
  }
}

__global__ void __launch_bounds__(kThreads) gru_scan_bwd_kernel(
    const float* __restrict__ gx, const float* __restrict__ u, const uint8_t* __restrict__ mask,
    const float* __restrict__ hs, const float* __restrict__ dhs, float* __restrict__ dgx,
    float* __restrict__ ops, float* __restrict__ dh0, Shape s) {
  extern __shared__ float us[];
  stage_weights(us, u, 3 * s.h, u + 2 * s.h, 3 * s.h, s);
  __syncthreads();
  const Lane l = lane_of(s);
  const int h = s.h;
  const int64_t row_t = l.row * s.t;
  const float* own = us + l.j * s.pitch;  // row j of U: the transposed products
  StepIn in, next;
  load_x(next, gx, l, s, s.t - 1);
  load_back(next, hs, dhs, l, s, s.t - 1);
  float m_next = load_mask(mask, l, s, s.t - 1);
  float dh = 0.f;
  for (int t = s.t - 1; t >= 0; --t) {
    in = next;
    const bool m = m_next != 0.f;
    if (t > 0) {
      load_x(next, gx, l, s, t - 1);
      load_back(next, hs, dhs, l, s, t - 1);
      m_next = load_mask(mask, l, s, t - 1);
    }
    const float hp = in.hp;
    float z, r, hh;
    gru_gates(us, s, l, in, hp, z, r, hh);
    const float d = dh + in.g;
    const float dz = m ? d * (hp - hh) : 0.f;
    const float dhh = m ? d * (1.f - z) : 0.f;
    float dprev = m ? d * z : d;
    const float dph = dhh * (1.f - hh * hh);
    const float drh = dot_row(own + 2 * h, dph, l.base, h);
    const float dr = drh * hp;
    dprev = dprev + drh * r;
    const float dpz = dz * z * (1.f - z);
    const float dpr = dr * r * (1.f - r);
    // [dpz | dpr] times the first two blocks' transpose, one sum.
    float back = dot_row(own, dpz, l.base, h);
#pragma unroll 5
    for (int m2 = 0; m2 < h; ++m2)
      back = fmaf(__shfl_sync(kAll, dpr, l.base + m2), own[h + m2], back);
    dh = dprev + back;
    if (l.live) {
      float* pre = dgx + (row_t + t) * 3 * h + l.j;
      pre[0] = dpz;
      pre[h] = dpr;
      pre[2 * h] = dph;
      float* o = ops + (row_t + t) * 2 * h + l.j;
      o[0] = hp;
      o[h] = r * hp;
    }
  }
  if (l.live) dh0[l.row * h + l.j] = dh;
}

__global__ void __launch_bounds__(kThreads) augru_scan_fwd_kernel(
    const float* __restrict__ x_all, const float* __restrict__ u_rz, const float* __restrict__ u_h,
    const float* __restrict__ att, float* __restrict__ hs, float* __restrict__ hfin, Shape s) {
  extern __shared__ float us[];
  stage_weights(us, u_rz, 2 * s.h, u_h, s.h, s);
  __syncthreads();
  const Lane l = lane_of(s);
  const int64_t row_t = l.row * s.t;
  StepIn in, next;
  load_x(next, x_all, l, s, 0);
  float a_next = load_att(att, l, s, 0);
  float hc = 0.f;
  for (int t = 0; t < s.t; ++t) {
    in = next;
    const float at = a_next;
    if (t + 1 < s.t) {
      load_x(next, x_all, l, s, t + 1);
      a_next = load_att(att, l, s, t + 1);
    }
    float r, z, ht;
    augru_gates(us, s, l, in, hc, r, z, ht);
    const float a = at * r;
    hc = (1.f - a) * hc + a * ht;
    if (l.live) hs[(row_t + t) * s.h + l.j] = hc;
  }
  if (l.live) hfin[l.row * s.h + l.j] = hc;
}

__global__ void __launch_bounds__(kThreads) augru_scan_bwd_kernel(
    const float* __restrict__ x_all, const float* __restrict__ u_rz, const float* __restrict__ u_h,
    const float* __restrict__ att, const float* __restrict__ hs, const float* __restrict__ dhfin,
    float* __restrict__ dx, float* __restrict__ ops, float* __restrict__ datt,
    float* __restrict__ dh0, Shape s) {
  extern __shared__ float us[];
  stage_weights(us, u_rz, 2 * s.h, u_h, s.h, s);
  __syncthreads();
  const Lane l = lane_of(s);
  const int h = s.h;
  const int64_t row_t = l.row * s.t;
  const float* own = us + l.j * s.pitch;
  StepIn in, next;
  load_x(next, x_all, l, s, s.t - 1);
  load_back(next, hs, nullptr, l, s, s.t - 1);
  float a_next = load_att(att, l, s, s.t - 1);
  float dh = l.live ? __ldg(dhfin + l.row * h + l.j) : 0.f;
  for (int t = s.t - 1; t >= 0; --t) {
    in = next;
    const float at = a_next;
    if (t > 0) {
      load_x(next, x_all, l, s, t - 1);
      load_back(next, hs, nullptr, l, s, t - 1);
      a_next = load_att(att, l, s, t - 1);
    }
    const float hp = in.hp;
    float r, z, ht;
    augru_gates(us, s, l, in, hp, r, z, ht);
    const float a = at * r;
    const float da = dh * (ht - hp);
    const float dht = dh * a;
    float dprev = dh * (1.f - a);
    // The attention's gradient: the row's da_m r_m summed in m order.
    const float dar = da * r;
    float da_sum = 0.f;
#pragma unroll 5
    for (int m2 = 0; m2 < h; ++m2) da_sum = da_sum + __shfl_sync(kAll, dar, l.base + m2);
    const float dr = da * at;
    const float dph = dht * (1.f - ht * ht);
    const float dhz = dot_row(own + 2 * h, dph, l.base, h);
    const float dz = dhz * hp;
    dprev = dprev + dhz * z;
    const float dpr = dr * r * (1.f - r);
    const float dpz = dz * z * (1.f - z);
    float back = dot_row(own, dpr, l.base, h);
#pragma unroll 5
    for (int m2 = 0; m2 < h; ++m2)
      back = fmaf(__shfl_sync(kAll, dpz, l.base + m2), own[h + m2], back);
    dh = dprev + back;
    if (l.live) {
      float* pre = dx + (row_t + t) * 3 * h + l.j;
      pre[0] = dpr;
      pre[h] = dpz;
      pre[2 * h] = dph;
      float* o = ops + (row_t + t) * 2 * h + l.j;
      o[0] = hp;
      o[h] = hp * z;
      if (l.j == 0) datt[row_t + t] = da_sum;
    }
  }
  if (l.live) dh0[l.row * h + l.j] = dh;
}

// U's rows in shared memory: 3H floats at an odd pitch.
int pitch_of(int h) { return (3 * h) | 1; }

int smem_of(int h) { return h * pitch_of(h) * static_cast<int>(sizeof(float)); }

// The checked scalars {B, T, H, device}; false where they are out of range.
bool shape_of(const int64_t* a, Shape& s) {
  if (a == nullptr) return false;
  const int64_t b = a[0], t = a[1], h = a[2];
  if (b < 1 || b > (int64_t{1} << 31) - kThreads || t < 1 || t > (1 << 20) || h < 1 ||
      h > kMaxHidden || b * t > (int64_t{1} << 40)) {
    return false;
  }
  s.b = static_cast<int>(b);
  s.t = static_cast<int>(t);
  s.h = static_cast<int>(h);
  s.pitch = pitch_of(s.h);
  return true;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Shape& s, cudaStream_t stream, void** args) {
  const int64_t rows_per_block = (kThreads / 32) * (32 / s.h);
  const dim3 grid(static_cast<unsigned>((s.b + rows_per_block - 1) / rows_per_block));
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                                           dim3(kThreads), args, smem_of(s.h), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// `a`: the launch's int64 scalars {B, T, H, device}, cached per shape by
// ops/augru.py. Every tensor is contiguous float32 (mask: bool, one byte a
// step) on that device: gx [B, T, 3H], u [H, 3H] (z|r|h), mask [B, T],
// hs [B, T, H] written.
extern "C" int gru_scan_fwd_f32(const void* gx, const void* u, const void* mask, void* hs,
                                const int64_t* a, void* stream) {
  Shape s;
  if (!shape_of(a, s)) return cudaErrorInvalidValue;
  DeviceGuard guard(static_cast<int>(a[3]));
  if (guard.status() != cudaSuccess) return guard.status();
  const float* gxp = static_cast<const float*>(gx);
  const float* up = static_cast<const float*>(u);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  float* hp = static_cast<float*>(hs);
  void* args[] = {&gxp, &up, &mp, &hp, &s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(gru_scan_fwd_kernel, s, st, args);
}

// gx, u, mask, hs as the forward had them; dhs [B, T, H] the output's
// gradient; written: dgx [B, T, 3H], ops [B, T, 2H], dh0 [B, H].
extern "C" int gru_scan_bwd_f32(const void* gx, const void* u, const void* mask, const void* hs,
                                const void* dhs, void* dgx, void* ops, void* dh0,
                                const int64_t* a, void* stream) {
  Shape s;
  if (!shape_of(a, s)) return cudaErrorInvalidValue;
  DeviceGuard guard(static_cast<int>(a[3]));
  if (guard.status() != cudaSuccess) return guard.status();
  const float* gxp = static_cast<const float*>(gx);
  const float* up = static_cast<const float*>(u);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  const float* hsp = static_cast<const float*>(hs);
  const float* dhsp = static_cast<const float*>(dhs);
  float* dgxp = static_cast<float*>(dgx);
  float* opsp = static_cast<float*>(ops);
  float* dh0p = static_cast<float*>(dh0);
  void* args[] = {&gxp, &up, &mp, &hsp, &dhsp, &dgxp, &opsp, &dh0p, &s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(gru_scan_bwd_kernel, s, st, args);
}

// x [B, T, 3H] (r|z|h), u_rz [H, 2H], u_h [H, H], att [B, T]; written:
// hs [B, T, H], hfin [B, H].
extern "C" int augru_scan_fwd_f32(const void* x, const void* u_rz, const void* u_h,
                                  const void* att, void* hs, void* hfin, const int64_t* a,
                                  void* stream) {
  Shape s;
  if (!shape_of(a, s)) return cudaErrorInvalidValue;
  DeviceGuard guard(static_cast<int>(a[3]));
  if (guard.status() != cudaSuccess) return guard.status();
  const float* xp = static_cast<const float*>(x);
  const float* urz = static_cast<const float*>(u_rz);
  const float* uh = static_cast<const float*>(u_h);
  const float* ap = static_cast<const float*>(att);
  float* hsp = static_cast<float*>(hs);
  float* hfp = static_cast<float*>(hfin);
  void* args[] = {&xp, &urz, &uh, &ap, &hsp, &hfp, &s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(augru_scan_fwd_kernel, s, st, args);
}

// x, u_rz, u_h, att, hs as the forward had them; dhfin [B, H] the final
// state's gradient; written: dx [B, T, 3H], ops [B, T, 2H], datt [B, T],
// dh0 [B, H].
extern "C" int augru_scan_bwd_f32(const void* x, const void* u_rz, const void* u_h,
                                  const void* att, const void* hs, const void* dhfin, void* dx,
                                  void* ops, void* datt, void* dh0, const int64_t* a,
                                  void* stream) {
  Shape s;
  if (!shape_of(a, s)) return cudaErrorInvalidValue;
  DeviceGuard guard(static_cast<int>(a[3]));
  if (guard.status() != cudaSuccess) return guard.status();
  const float* xp = static_cast<const float*>(x);
  const float* urz = static_cast<const float*>(u_rz);
  const float* uh = static_cast<const float*>(u_h);
  const float* ap = static_cast<const float*>(att);
  const float* hsp = static_cast<const float*>(hs);
  const float* dfp = static_cast<const float*>(dhfin);
  float* dxp = static_cast<float*>(dx);
  float* opsp = static_cast<float*>(ops);
  float* dap = static_cast<float*>(datt);
  float* dh0p = static_cast<float*>(dh0);
  void* args[] = {&xp, &urz, &uh, &ap, &hsp, &dfp, &dxp, &opsp, &dap, &dh0p, &s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(augru_scan_bwd_kernel, s, st, args);
}
