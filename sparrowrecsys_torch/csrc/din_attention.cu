// DIN activation unit (target attention), forward and backward, float32,
// on Hopper's tensor cores.
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
// Bound on the H100. The candidate's share c @ (wc-wa) + b1 is the same
// for every step of a row, so a step costs the product [h, h*c] @
// [wa+wb; wd], 2D x H multiply-adds. On the tensor cores, with float32
// accuracy kept by three TF32 products a float32 product (165 TFLOP/s of
// the 495), the operations at [65536,64,128], H=32 take at most 0.42 ms
// (every step live) against 0.66 ms of bytes: both kernels are bound by
// bytes, the history read once and the outputs written once
// (tools/kernel_bench.py's bound). In practice the tile is bound by the
// latency of its mma chains and of the loads that feed them: a warp
// carries NT independent accumulators, each taking six dependent mma a
// k-step (three products of each segment of K), so the design issues the
// products tile after tile and keeps the per-row work off the chain (the
// small sums in registers for the whole launch; for short histories,
// where a row has few steps to share it, the candidate's term as a third
// segment of the product, per step).

// Design (ops/attention.py::plan picks the numbers):
// - The product tile. A chunk is M = 16 * warps (row, step) items of whole
//   batch rows (one row's steps where T > M); each warp takes 16 of them.
//   The pre-activations [M, H] come from mma.sync.m16n8k8 TF32: every
//   operand x is split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
//   hi), and the tile adds lo*hi + hi*lo + hi*hi in float32 accumulators
//   (tf32_split_product_plain is the plain version). The A operand's h*c
//   half is formed in registers from the staged history and the row's
//   candidate. K = 2D runs in k-steps of 8 (D padded with zero weights),
//   H in chunks of NT tiles of 8 columns (zero weights past H): a zero
//   column's pre-activation is 0, its PReLU 0 and its w2 0, so the padding
//   is exact. The folded weight [wa+wb; wd] sits in shared memory once per
//   block, split, in the order the fragments are read (one 16-byte load a
//   lane a tile, the lanes of a row rotated so that the backward's
//   transposed reads are free of bank conflicts too), where it fits; else
//   it is loaded per slice of D. Histories of up to 8 steps (CT) add a
//   third segment, c @ (wc - wa), to the product; longer ones compute the
//   candidate term once per row, from wc - wa in shared memory where it
//   fits, split across lanes where the rows are few.
// - Staging. The history (and the rows' candidates and output gradients)
//   is copied by cp.async, 16 bytes a thread, into a ring of two slots:
//   the next chunk's copies are in flight while the current one's products
//   run, on a persistent grid of one wave. Rows whose width is a multiple
//   of 4 are staged a row at a time with an odd-quarter stride (no bank
//   conflicts on the fragment loads); other widths as one contiguous run.
//   Where D is too wide for shared memory, the chunk is staged in slices
//   of D, and staged once more for the pooling (and the backward's dh).
//   The all-zero-row mask is read from the staged tile, as the fragments
//   load it.
// - Forward epilogue, in registers: PReLU, the dot with w2 across the N
//   fragments (two shuffles within a quad), b2, sigmoid and the mask; the
//   step weights go to shared memory and the pooling sum_t w_t h_t reads
//   the staged tile and writes out coalesced.
// - Backward: the same tile recomputes the pre-activations (and g . h
//   from the same fragment loads), then dlogit and dapre [M, H] are formed
//   in shared memory, and dh = w g + dapre @ (wa+wb)^T + c * (dapre @ wd^T)
//   is one split-TF32 product [M, H] x [H, 2D]; its h*c half's share of dc,
//   h_t * (dapre_t wd^T), is left in the staged tile and summed per row
//   (with CT, plus the c segment's dapre_t (wc-wa)^T: the whole of dc;
//   else dc's candidate share dsum (wc-wa)^T is added once per row).
//   dsum, dc and out of a row are written by the block that owns the row,
//   in chunk order; the small sums (db1, dalpha, dw2, db2) go to a row per
//   warp of a scratch, in a fixed order (shuffles, then the warp's row),
//   and din_attention_bwd_reduce adds the rows in a fixed order. No float
//   atomics: two calls agree bit for bit. Where D > H the kernel writes
//   h*c alone (the weight products take h from the history), else
//   hx = [h, h*c], each element by the lane that writes its dh (no pass
//   of its own). As in the reference, the PReLU sends the gradient at
//   exactly 0 to the identity branch, the all-zero mask passes no
//   gradient, and a masked step contributes nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSharedBytes = 232448;  // the H100's 227 KB a block
constexpr unsigned kFull = 0xffffffffu;

// The launch's int64 scalars (ops/attention.py::_scalars), by index.
enum Scalar {
  kBatch, kSteps, kD, kH, kWarps, kRows, kNT, kChunks, kSliceSteps, kWcShared, kCt, kBytes,
  kDevice, kScalars
};

// How a chunk is staged: a row at a time in 16-byte copies (widths and
// pointers 16-byte aligned), one contiguous run in 16-byte copies (one
// slice), or element by element.
enum Mode { kRow16, kSpan16, kElem4 };

struct Dims {
  int64_t batch, units;
  int steps, d, h;
  int warps, m, rows;
  int chunks, np;    // N chunks of 8 * NT columns; np = padded H
  int kst, sks;      // k-steps of 8 columns of D in all and a slice
  int nslices, passes;
  int wc_shared;     // wc - wa [D, np] in shared memory (else read from w1)
  int ct;            // the candidate's term in the product (a third segment of K)
  int hs, ps;        // staged row stride; pre-activation row stride
  int mode, hx_alone;
  // Float offsets into shared memory.
  int o_par, o_wc, o_ct, o_dsum, o_pre, o_w, o_small, o_ring, slot, o_c, o_g, total;
};

// ---------------------------------------------------------------------------
// Tensor-core and copy primitives.

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b[u] for N B fragments b[u] = {b0 hi, b1 hi, b0 lo, b1 lo}: lo*hi and
// hi*lo added to sm[u], hi*hi to acc[u], each over the N tiles in turn, so
// that back-to-back mma write different accumulators. sm and acc may be
// one array; apart (the kernels without the candidate's term in the
// product, the long histories' and the wide ones', where registers do not
// limit the blocks an SM), the chains of dependent mma are shorter.
template <int N>
__device__ __forceinline__ void mma3(float (&sm)[N][4], float (&acc)[N][4],
                                     const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint4 (&b)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) mma(sm[u], al, b[u].x, b[u].y);
#pragma unroll
  for (int u = 0; u < N; ++u) mma(sm[u], ah, b[u].z, b[u].w);
#pragma unroll
  for (int u = 0; u < N; ++u) mma(acc[u], ah, b[u].x, b[u].y);
}

// acc += sm, element by element.
template <int N>
__device__ __forceinline__ void add_acc(float (&acc)[N][4], const float (&sm)[N][4]) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] += sm[u][e];
  }
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ uint4 split2(float x0, float x1) {
  uint32_t h0, l0, h1, l1;
  split(x0, h0, l0);
  split(x1, h1, l1);
  return make_uint4(h0, h1, l0, l1);
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Staging.

// Walks the elements (i, k) of an n x w tile from element threadIdx.x in
// steps of blockDim.x, with r = (base + i) / steps and t its remainder,
// without a division in the loop.
struct Walk {
  int i, k, r, t;
  int di, dk, dr, dt, w, steps;
  __device__ __forceinline__ Walk(int w_, int base = 0, int steps_ = 1) : w(w_), steps(steps_) {
    i = threadIdx.x / w;
    k = threadIdx.x - i * w;
    di = blockDim.x / w;
    dk = blockDim.x - di * w;
    dr = di / steps;
    dt = di - dr * steps;
    r = (base + i) / steps;
    t = base + i - r * steps;
  }
  __device__ __forceinline__ void next() {
    i += di, k += dk, r += dr, t += dt;
    if (k >= w) k -= w, ++i, ++t;
    if (t >= steps) t -= steps, ++r;
  }
};

// The offset of element (0, 0) of a staged array whose rows start at src.
__device__ __forceinline__ int span_off(const float* src, int mode) {
  return mode == kSpan16 ? static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3) : 0;
}

// Issues the copies of n rows, columns [k0, k0 + w) of a row-major source
// of row length ld starting at src, into dst: element (r, k) lands at
// dst[span_off + r * stride + k], stride hs (ld for kSpan16, which takes
// whole rows, k0 = 0 and w = ld).
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n, int ld, int k0,
                                           int w, int mode, int hs) {
  if (mode == kSpan16) {
    const int count = n * ld;
    const int m4 = span_off(src, mode);
    const int head = min(count, (4 - m4) & 3);
    const int body = (count - head) >> 2;
    float* d = dst + m4;
    for (int e = threadIdx.x; e < head; e += blockDim.x) cp4(d + e, src + e);
    for (int q = threadIdx.x; q < body; q += blockDim.x) cp16(d + head + 4 * q, src + head + 4 * q);
    for (int e = head + 4 * body + threadIdx.x; e < count; e += blockDim.x) cp4(d + e, src + e);
  } else if (mode == kRow16) {
    for (Walk q(w >> 2); q.i < n; q.next()) {
      cp16(dst + q.i * hs + 4 * q.k, src + static_cast<int64_t>(q.i) * ld + k0 + 4 * q.k);
    }
  } else {
    for (Walk q(w); q.i < n; q.next()) {
      cp4(dst + q.i * hs + q.k, src + static_cast<int64_t>(q.i) * ld + k0 + q.k);
    }
  }
}

// A stage: one slice of D of one chunk of a unit (`rows` batch rows), in
// pass 0 (the products) or pass 1 (where D takes several slices: the
// pooling, or the backward's dh).
struct Stage {
  int64_t unit;
  int chunk, pass, slice;
};

struct Tile {
  int64_t b0;     // the unit's first batch row
  int64_t item0;  // the chunk's first (row, step) item, row-major over [B, T]
  int vrows;      // batch rows of the unit
  int n;          // items of the chunk
  int base;       // the chunk's first item within the unit
  int k0, w;      // the slice's columns
};

__device__ __forceinline__ int chunks_of(int64_t unit, const Dims& z) {
  const int vrows = static_cast<int>(min(static_cast<int64_t>(z.rows), z.batch - unit * z.rows));
  return (vrows * z.steps + z.m - 1) / z.m;
}

__device__ __forceinline__ Tile tile_of(const Stage& s, const Dims& z) {
  Tile t;
  t.b0 = s.unit * z.rows;
  t.vrows = static_cast<int>(min(static_cast<int64_t>(z.rows), z.batch - t.b0));
  t.base = s.chunk * z.m;
  t.n = min(z.m, t.vrows * z.steps - t.base);
  t.item0 = t.b0 * z.steps + t.base;
  t.k0 = s.slice * 8 * z.sks;
  t.w = min(8 * z.sks, z.d - t.k0);
  return t;
}

__device__ __forceinline__ bool advance(Stage& s, const Dims& z) {
  if (++s.slice < z.nslices) return true;
  s.slice = 0;
  if (++s.pass < z.passes) return true;
  s.pass = 0;
  if (++s.chunk < chunks_of(s.unit, z)) return true;
  s.chunk = 0;
  s.unit += gridDim.x;
  return s.unit < z.units;
}

// Issues the stage's copies into a ring slot and commits them as a group.
__device__ __forceinline__ void issue(const Stage& s, const Dims& z, float* slot, const float* hist,
                                      const float* cand, const float* gout) {
  const Tile t = tile_of(s, z);
  stage_rows(slot, hist + t.item0 * z.d, t.n, z.d, t.k0, t.w, z.mode, z.hs);
  stage_rows(slot + z.o_c, cand + t.b0 * z.d, t.vrows, z.d, t.k0, t.w, z.mode, z.hs);
  if (gout != nullptr) {
    stage_rows(slot + z.o_g, gout + t.b0 * z.d, t.vrows, z.d, t.k0, t.w, z.mode, z.hs);
  }
  cp_commit();
}

// A staged array: element (r, k) at p[r * stride + k].
struct View {
  float* p;
  int stride;
};

__device__ __forceinline__ View view_of(float* region, const float* src, const Dims& z) {
  return View{region + span_off(src, z.mode), z.mode == kSpan16 ? z.d : z.hs};
}

// ---------------------------------------------------------------------------
// Weights.

// Where lane L's entry of a slab row sits: rows of 8 entries rotated by 2
// per row of 8, so that both the forward's reads (lane L, entry L) and the
// backward's transposed reads (entries 8t + (g & 3) and 8t + 4 + (g & 3))
// fall in distinct bank groups within each quarter warp.
__device__ __forceinline__ int slab_slot(int lane) {
  return (lane & ~7) | ((lane + 2 * (lane >> 3)) & 7);
}

// The forward operand [wa+wb; wd] [2D, H] (with ct, [wa+wb; wd; wc-wa]
// [3D, H]) as B fragments: k-steps [ks0, ks0 + nks) of the h segment, then
// as many of the h*c segment (and of the c segment), each with tiles
// [nt0, nt0 + ntc) of 8 columns; slab[(kk * ntc + nt) * 32 + lane] = {b0,
// b1} split, b0 = W[8 kk + t][8 nt + g], b1 = W[8 kk + t + 4][8 nt + g]
// (g = lane / 4, t = lane % 4), zero past D and H; each row of 32 entries
// stored in `slab_slot` order.
__device__ __forceinline__ void load_b1(uint4* slab, const float* __restrict__ w1, int d, int h,
                                        int ks0, int nks, int nt0, int ntc, int ct) {
  const int total = (2 + ct) * nks * ntc * 32;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int lane = i & 31, f = i >> 5;
    const int kk = f / ntc, nt = f - kk * ntc;
    const int seg = kk / nks;  // 0: h, 1: h*c, 2: c
    const int k = (ks0 + kk - seg * nks) * 8 + (lane & 3);
    const int j = (nt0 + nt) * 8 + (lane >> 2);
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ku = k + 4 * u;
      float x = 0.f;
      if (ku < d && j < h) {
        const float wa = __ldg(w1 + ku * h + j);
        x = seg == 1 ? __ldg(w1 + (3 * d + ku) * h + j)
                     : (seg == 0 ? wa + __ldg(w1 + (d + ku) * h + j)
                                 : __ldg(w1 + (2 * d + ku) * h + j) - wa);
      }
      v[u] = x;
    }
    slab[(i & ~31) | slab_slot(lane)] = split2(v[0], v[1]);
  }
}

// wc - wa [D, np] in float32, zero past H, rows np + 8 floats apart (the
// four lanes of a task read four rows at once: distinct banks).
__device__ __forceinline__ void load_wc(float* s_wc, const float* __restrict__ w1, int d, int h,
                                        int np) {
#pragma unroll 4
  for (int i = threadIdx.x; i < d * np; i += blockDim.x) {
    const int k = i / np, j = i - k * np;
    s_wc[k * (np + 8) + j] = j < h ? __ldg(w1 + (2 * d + k) * h + j) - __ldg(w1 + k * h + j) : 0.f;
  }
}

// (wc - wa)[k, j] from shared memory where it sits there, else from w1.
__device__ __forceinline__ float wc_at(const float* s_wc, const float* __restrict__ w1, int k,
                                       int j, const Dims& z) {
  if (z.wc_shared) return s_wc[k * (z.np + 8) + j];
  return __ldg(w1 + (2 * z.d + k) * z.h + j) - __ldg(w1 + k * z.h + j);
}

// s_ct[r * np + j] = c_r . (wc - wa)[:, j] + b1[j] for the unit's rows, 0
// past H, the candidates from rows `cs` floats apart at `c0`: a (row,
// column) task's sum over D in four partial sums, added in a fixed order;
// where the tasks are fewer than half the threads, split over `parts`
// neighbouring lanes (a power of 2; lane p of a task takes k = p mod parts,
// so the lanes read distinct banks) and added across them by shuffles.
__device__ __forceinline__ void candidate_term(float* s_ct, const float* c0, int cs,
                                               const float* s_wc, const float* __restrict__ w1,
                                               const float* s_b1, int vrows, const Dims& z) {
  const int d = z.d, ws = z.np + 8;
  int lg = 0;
  while (lg < 5 && (2 << lg) * vrows * z.np <= static_cast<int>(blockDim.x)) ++lg;
  const int parts = 1 << lg, lane = threadIdx.x & 31;
  const unsigned group = parts == 32 ? kFull : ((1u << parts) - 1) << (lane & ~(parts - 1));
  for (Walk q(z.np << lg); q.i < vrows; q.next()) {
    const int r = q.i, j = q.k >> lg, part = q.k & (parts - 1);
    const float* c = c0 + r * cs;
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
    int k = part;
    if (z.wc_shared) {
      const float* wc = s_wc + j;
      for (; k + 3 * parts < d; k += 4 * parts) {
        p0 = fmaf(c[k], wc[k * ws], p0);
        p1 = fmaf(c[k + parts], wc[(k + parts) * ws], p1);
        p2 = fmaf(c[k + 2 * parts], wc[(k + 2 * parts) * ws], p2);
        p3 = fmaf(c[k + 3 * parts], wc[(k + 3 * parts) * ws], p3);
      }
    }
    if (j < z.h) {
      for (; k < d; k += parts) p0 = fmaf(c[k], wc_at(s_wc, w1, k, j, z), p0);
    }
    float sum = (p0 + p1) + (p2 + p3);
    for (int o = 1; o < parts; o <<= 1) sum += __shfl_xor_sync(group, sum, o);
    if (part == 0) s_ct[r * z.np + j] = sum + s_b1[j];
  }
}

// ---------------------------------------------------------------------------
// The product tile.

// The warp's 16 items: rows g and g + 8 of its fragments.
struct Items {
  int i0, i1;         // within the chunk
  bool v0, v1;        // within the chunk's n items
  int r0, r1;         // their batch rows within the unit
};

__device__ __forceinline__ Items items_of(const Tile& tl, const Dims& z) {
  const int lane = threadIdx.x & 31;
  Items it;
  it.i0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  it.i1 = it.i0 + 8;
  it.v0 = it.i0 < tl.n;
  it.v1 = it.i1 < tl.n;
  it.r0 = min((tl.base + it.i0) / z.steps, tl.vrows - 1);
  it.r1 = min((tl.base + it.i1) / z.steps, tl.vrows - 1);
  return it;
}

// Adds the slice's share of [h, h*c] @ [wa+wb; wd] (with ct, [h, h*c, c] @
// [wa+wb; wd; wc-wa]) for the warp's items to acc (NT tiles of the slab
// from tile nt0; the slab holds `half` k-steps of the h segment, then the
// h*c segment's and the c segment's, `ntc` tiles a k-step); nks k-steps of
// w valid columns. h0, h1: the items' staged rows; c0, c1, g0, g1: their
// rows' candidates and (with G) output gradients. Marks a non-zero
// element of an item's row in nz0, nz1; with G adds g . h to gh0, gh1.
template <int NT, bool G, bool CT>
__device__ __forceinline__ void product(float (&acc)[NT][4], const uint4* slab, int half, int ntc,
                                        int nt0, int nks, int w, bool v0, bool v1,
                                        const float* h0, const float* h1, const float* c0,
                                        const float* c1, const float* g0, const float* g1,
                                        bool& nz0, bool& nz1, float& gh0, float& gh1) {
  const int lane = threadIdx.x & 31, t = lane & 3, slot = slab_slot(lane);
  float sm[CT ? 1 : NT][4] = {};  // the small products apart where !CT
#pragma unroll 2
  for (int kk = 0; kk < nks; ++kk) {
    const int ka = 8 * kk + t, kb = ka + 4;
    const bool ina = ka < w, inb = kb < w;
    float x[4], y[4];
    x[0] = v0 && ina ? h0[ka] : 0.f;  // (g, t)
    x[1] = v1 && ina ? h1[ka] : 0.f;  // (g + 8, t)
    x[2] = v0 && inb ? h0[kb] : 0.f;  // (g, t + 4)
    x[3] = v1 && inb ? h1[kb] : 0.f;  // (g + 8, t + 4)
    nz0 |= (x[0] != 0.f) | (x[2] != 0.f);
    nz1 |= (x[1] != 0.f) | (x[3] != 0.f);
    float cv[4];
    cv[0] = ina ? c0[ka] : 0.f;
    cv[1] = ina ? c1[ka] : 0.f;
    cv[2] = inb ? c0[kb] : 0.f;
    cv[3] = inb ? c1[kb] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = x[e] * cv[e];
    if (G) {
      if (ina) {
        gh0 = fmaf(x[0], g0[ka], gh0);
        gh1 = fmaf(x[1], g1[ka], gh1);
      }
      if (inb) {
        gh0 = fmaf(x[2], g0[kb], gh0);
        gh1 = fmaf(x[3], g1[kb], gh1);
      }
    }
    uint32_t xh[4], xl[4], yh[4], yl[4];
    split4(x, xh, xl);
    split4(y, yh, yl);
    const uint4* bh = slab + (static_cast<int64_t>(kk) * ntc + nt0) * 32 + slot;
    const uint4* bc = slab + (static_cast<int64_t>(half + kk) * ntc + nt0) * 32 + slot;
    uint4 fh[NT], fc[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      fh[nt] = bh[nt * 32];
      fc[nt] = bc[nt * 32];
    }
    if constexpr (!CT) {
      mma3<NT>(sm, acc, xh, xl, fh);
      mma3<NT>(sm, acc, yh, yl, fc);
    } else {
      mma3<NT>(acc, acc, xh, xl, fh);
      mma3<NT>(acc, acc, yh, yl, fc);
      // The candidate's term c @ (wc - wa), per item.
      split4(cv, yh, yl);
      const uint4* bc2 = slab + (static_cast<int64_t>(2 * half + kk) * ntc + nt0) * 32 + slot;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) fc[nt] = bc2[nt * 32];
      mma3<NT>(acc, acc, yh, yl, fc);
    }
  }
  if constexpr (!CT) add_acc<NT>(acc, sm);
}

// The thread's accumulator elements e of tile nt: (row g or g + 8, column).
__device__ __forceinline__ int acc_col(int nc, int nt, int e, int NT) {
  return (nc * NT + nt) * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

template <int NT>
__device__ __forceinline__ void load_acc(float (&acc)[NT][4], const float* s_pre, int ps,
                                         const Items& it, int nc) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = acc_col(nc, nt, 0, NT);
    const float2 a = *reinterpret_cast<const float2*>(s_pre + it.i0 * ps + col);
    const float2 b = *reinterpret_cast<const float2*>(s_pre + it.i1 * ps + col);
    acc[nt][0] = a.x, acc[nt][1] = a.y, acc[nt][2] = b.x, acc[nt][3] = b.y;
  }
}

template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], float* s_pre, int ps,
                                          const Items& it, int nc) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = acc_col(nc, nt, 0, NT);
    *reinterpret_cast<float2*>(s_pre + it.i0 * ps + col) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(s_pre + it.i1 * ps + col) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// The slice's weights, all chunks of H, where D takes several slices (with
// one, they are loaded once per block).
__device__ __forceinline__ void slice_weights(uint4* slab, const float* __restrict__ w1,
                                              const Stage& s, const Dims& z, int nt_all) {
  if (z.nslices == 1) return;
  __syncthreads();
  load_b1(slab, w1, z.d, z.h, s.slice * z.sks, min(z.sks, z.kst - s.slice * z.sks), 0, nt_all, 0);
  __syncthreads();
}

// Pass 0 of a stage: the products over chunk nc of H for this slice, and on
// the slice that ends D the epilogue: pre-activations (+ candidate term),
// stored to s_pre where STORE, and the PReLU . w2 share of the logits.
template <int NT, bool G, bool STORE, bool CT>
__device__ __forceinline__ void pre_chunk(const Dims& z, const Stage& s, const Tile& tl,
                                          const Items& it, const uint4* slab, const View& vh,
                                          const View& vc, const View& vg, float* s_pre,
                                          const float* s_ct, const float* s_alpha,
                                          const float* s_w2, int nc, bool& nz0, bool& nz1,
                                          float& gh0, float& gh1, float& lg0, float& lg1) {
  const int nks = min(z.sks, z.kst - s.slice * z.sks);
  const bool last = s.slice == z.nslices - 1;
  float acc[NT][4];
  if (s.slice == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  } else {
    load_acc<NT>(acc, s_pre, z.ps, it, nc);
  }
  if (tl.n > static_cast<int>(threadIdx.x >> 5) * 16) {
    product<NT, G, CT>(acc, slab, nks, z.chunks * NT, nc * NT, nks, tl.w, it.v0, it.v1,
                   vh.p + (it.v0 ? it.i0 : 0) * vh.stride, vh.p + (it.v1 ? it.i1 : 0) * vh.stride,
                   vc.p + it.r0 * vc.stride, vc.p + it.r1 * vc.stride,
                   G ? vg.p + it.r0 * vg.stride : nullptr, G ? vg.p + it.r1 * vg.stride : nullptr,
                   nz0, nz1, gh0, gh1);
  }
  if (!last) {
    store_acc<NT>(acc, s_pre, z.ps, it, nc);
    return;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = acc_col(nc, nt, e, NT);
      // b1 sits after alpha and w2; the candidate term holds it where not ct.
      const float x = acc[nt][e] + (CT ? s_alpha[2 * z.np + col]
                                         : s_ct[(e < 2 ? it.r0 : it.r1) * z.np + col]);
      acc[nt][e] = x;
      const float a = x >= 0.f ? x : s_alpha[col] * x;
      if (e < 2) {
        lg0 = fmaf(a, s_w2[col], lg0);
      } else {
        lg1 = fmaf(a, s_w2[col], lg1);
      }
    }
  }
  if (STORE) store_acc<NT>(acc, s_pre, z.ps, it, nc);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ bool quad_any(bool x) {
  int v = x;
  v |= __shfl_xor_sync(kFull, v, 1);
  v |= __shfl_xor_sync(kFull, v, 2);
  return v != 0;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The items of unit row r within the chunk: [lo, hi).
__device__ __forceinline__ void row_items(const Tile& tl, int steps, int r, int& lo, int& hi) {
  lo = max(0, r * steps - tl.base);
  hi = min(tl.n, (r + 1) * steps - tl.base);
}

// sum over j in [lo, hi) of (W ? wt[j] : 1) * x[j * stride], in four
// partial sums over j mod 4, added in a fixed order.
template <bool W>
__device__ __forceinline__ float items_sum(const float* x, int stride, const float* wt, int lo,
                                           int hi) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = lo;
  for (; j + 3 < hi; j += 4) {
    a0 = W ? fmaf(wt[j], x[j * stride], a0) : a0 + x[j * stride];
    a1 = W ? fmaf(wt[j + 1], x[(j + 1) * stride], a1) : a1 + x[(j + 1) * stride];
    a2 = W ? fmaf(wt[j + 2], x[(j + 2) * stride], a2) : a2 + x[(j + 2) * stride];
    a3 = W ? fmaf(wt[j + 3], x[(j + 3) * stride], a3) : a3 + x[(j + 3) * stride];
  }
  for (; j < hi; ++j) a0 = W ? fmaf(wt[j], x[j * stride], a0) : a0 + x[j * stride];
  return (a0 + a1) + (a2 + a3);
}

// out[b0 + r, k0 + k] (+)= sum over the chunk's items i of row r of
// s_w[i] * h_i[k], over the slice's columns; the first chunk writes.
__device__ __forceinline__ void pool(float* out, const float* s_w, const View& vh, const Tile& tl,
                                     const Dims& z, bool first) {
  for (Walk q(tl.w); q.i < tl.vrows; q.next()) {
    const int r = q.i, k = q.k;
    int lo, hi;
    row_items(tl, z.steps, r, lo, hi);
    const float s = items_sum<true>(vh.p + k, vh.stride, s_w, lo, hi);
    float* o = out + (tl.b0 + r) * z.d + tl.k0 + k;
    *o = first ? s : *o + s;
  }
}

struct FwdArgs {
  const float *hist, *cand, *w1, *b1, *alpha, *w2, *b2;
  float* out;
};

// With the candidate's term in the product (short histories, the serving
// and training paths), at most 80 registers: three blocks an SM, so that a
// wave of small batches needs one round of the persistent loop.
template <int NT, bool CT>
__global__ void __launch_bounds__(kMaxThreads, CT ? 3 : 1)
din_attention_kernel(const FwdArgs p, const Dims z) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint4* slab = reinterpret_cast<uint4*>(sm);
  float* s_alpha = sm + z.o_par;
  float* s_w2 = s_alpha + z.np;
  float* s_b1 = s_w2 + z.np;
  float* s_wc = sm + z.o_wc;
  float* s_ct = sm + z.o_ct;
  float* s_pre = sm + z.o_pre;
  float* s_w = sm + z.o_w;
  float* ring = sm + z.o_ring;
  const int t = threadIdx.x & 3;
  Stage s{blockIdx.x, 0, 0, 0};
  issue(s, z, ring, p.hist, p.cand, nullptr);
  for (int j = threadIdx.x; j < z.np; j += blockDim.x) {
    s_alpha[j] = j < z.h ? __ldg(p.alpha + j) : 0.f;
    s_w2[j] = j < z.h ? __ldg(p.w2 + j) : 0.f;
    s_b1[j] = j < z.h ? __ldg(p.b1 + j) : 0.f;
  }
  if (z.wc_shared) load_wc(s_wc, p.w1, z.d, z.h, z.np);
  if (z.nslices == 1) load_b1(slab, p.w1, z.d, z.h, 0, z.kst, 0, z.chunks * NT, CT);
  const float bias2 = __ldg(p.b2);
  float lg0 = 0.f, lg1 = 0.f, gh0 = 0.f, gh1 = 0.f;
  bool nz0 = false, nz1 = false;
  for (int step = 0;; ++step) {
    float* cur = ring + (step & 1) * z.slot;
    Stage nx = s;
    const bool more = advance(nx, z);
    if (more) {
      issue(nx, z, ring + ((step + 1) & 1) * z.slot, p.hist, p.cand, nullptr);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const Tile tl = tile_of(s, z);
    const View vh = view_of(cur, p.hist + tl.item0 * z.d, z);
    if (s.pass == 0) {
      const View vc = view_of(cur + z.o_c, p.cand + tl.b0 * z.d, z);
      const Items it = items_of(tl, z);
      if (s.chunk == 0 && s.slice == 0 && !CT) {
        candidate_term(s_ct, z.nslices == 1 ? vc.p : p.cand + tl.b0 * z.d,
                       z.nslices == 1 ? vc.stride : z.d, s_wc, p.w1, s_b1, tl.vrows, z);
        __syncthreads();
      }
      if (s.slice == 0) {
        lg0 = lg1 = 0.f;
        nz0 = nz1 = false;
      }
      slice_weights(slab, p.w1, s, z, z.chunks * NT);
      for (int nc = 0; nc < z.chunks; ++nc) {
        pre_chunk<NT, false, false, CT>(z, s, tl, it, slab, vh, vc, vc, s_pre, s_ct, s_alpha, s_w2,
                                    nc, nz0, nz1, gh0, gh1, lg0, lg1);
      }
      if (s.slice == z.nslices - 1) {
        const float l0 = quad_sum(lg0), l1 = quad_sum(lg1);
        const bool n0 = quad_any(nz0), n1 = quad_any(nz1);
        if (t == 0) {
          // An all-zero step gets weight 0.
          if (it.v0) s_w[it.i0] = n0 ? sigmoid(l0 + bias2) : 0.f;
          if (it.v1) s_w[it.i1] = n1 ? sigmoid(l1 + bias2) : 0.f;
        }
        if (z.passes == 1) {
          __syncthreads();
          pool(p.out, s_w, vh, tl, z, s.chunk == 0);
        }
      }
    } else {
      pool(p.out, s_w, vh, tl, z, s.chunk == 0);
    }
    __syncthreads();
    if (!more) break;
    s = nx;
  }
}

// ---------------------------------------------------------------------------
// The per-step backward.

struct BwdArgs {
  const float *hist, *cand, *w1, *b1, *alpha, *w2, *b2, *gout;
  float *dh, *dc, *dap, *hx, *dsum, *partial, *small;
};

__device__ __forceinline__ float warp_groups_sum(float x) {
  // The sum over the 8 lanes of a column (lanes t, t + 4, ..., t + 28).
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}

// The warp's small sums of the columns its lanes hold: db1, sum(pre < 0 ?
// pre dl : 0) (dalpha / w2) and dw2 at columns 2t, 2t + 1 of each tile,
// over the lane's steps of the whole launch (H in one chunk; with several,
// each stage's go to the warp's row of s_small), and db2.
template <int NT>
struct SmallSums {
  float v[3][NT][2];
  float db2;
};

// Adds the lanes' sums (xor 4, 8, 16) into the warp's row of s_small.
template <int NT>
__device__ __forceinline__ void flush_sums(const SmallSums<NT>& sums, float* srow, int nc, int np) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float b = warp_groups_sum(sums.v[0][nt][u]), e = warp_groups_sum(sums.v[1][nt][u]);
      const float w = warp_groups_sum(sums.v[2][nt][u]);
      if (lane < 4) {
        const int col = acc_col(nc, nt, u, NT);
        srow[col] += b;
        srow[np + col] += e;
        srow[2 * np + col] += w;
      }
    }
  }
}

// From the chunk's pre-activations in s_pre (the thread's own elements)
// and the items' dlogits: dapre in place, and the lane's shares of the
// small sums.
template <int NT>
__device__ __forceinline__ void to_dapre(const Dims& z, const Items& it, float* s_pre, float* srow,
                                         const float* s_alpha, const float* s_w2, float dl0,
                                         float dl1, SmallSums<NT>& sums) {
  for (int nc = 0; nc < z.chunks; ++nc) {
    if (z.chunks > 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        for (int q = 0; q < 3; ++q) sums.v[q][nt][0] = sums.v[q][nt][1] = 0.f;
      }
    }
    float acc[NT][4];
    load_acc<NT>(acc, s_pre, z.ps, it, nc);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = acc_col(nc, nt, e, NT);
        const float dl = e < 2 ? dl0 : dl1;
        const float x = acc[nt][e];
        const bool neg = x < 0.f;  // the gradient at exactly 0 takes the identity
        const float da = s_w2[col] * dl;
        const float dp = neg ? s_alpha[col] * da : da;
        const float act = neg ? s_alpha[col] * x : x;
        sums.v[0][nt][e & 1] += dp;
        sums.v[1][nt][e & 1] += neg ? x * dl : 0.f;
        sums.v[2][nt][e & 1] = fmaf(act, dl, sums.v[2][nt][e & 1]);
        acc[nt][e] = dp;
      }
    }
    if (z.chunks > 1) flush_sums<NT>(sums, srow, nc, z.np);
    store_acc<NT>(acc, s_pre, z.ps, it, nc);
  }
}

// The B fragment of the backward's operand [wa+wb; wd]^T [H, 2D] at k-step
// ks of H and the slab's k-step kk of D, read from the forward's slab
// (entry (kk, ks) holds W[8 kk + t', 8 ks + g'] for lane 4 g' + t'): K = H
// with the k-step's 8 columns in the order 0, 2, 4, 6, 1, 3, 5, 7 (slot t
// holds column 2t, slot t + 4 column 2t + 1, the accumulator's layout).
__device__ __forceinline__ uint4 b_transposed(const uint4* slab, int ntc, int kk, int ks) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4* row = slab + (static_cast<int64_t>(kk) * ntc + ks) * 32;
  const uint4 e0 = row[slab_slot(8 * t + (g & 3))], e1 = row[slab_slot(8 * t + 4 + (g & 3))];
  return (g & 4) ? make_uint4(e0.y, e1.y, e0.w, e1.w) : make_uint4(e0.x, e1.x, e0.z, e1.z);
}

// dh over the slice's columns from dapre (s_pre) as one split-TF32
// product, [M, np] x [np, 2 w]: dh = w g + dapre (wa+wb)^T + c (dapre wd^T),
// and the product operand hx (h*c, or [h, h*c]) of the same elements;
// h * (dapre wd^T) replaces h in the staged tile for dc (with ct, plus the
// step's candidate share dapre (wc-wa)^T, from the product's third
// segment). Two column groups at a time: f[0], f[1] the first's (wa+wb)
// and wd shares, f[2], f[3] the second's (a copy of the first where nks is
// odd), f[4], f[5] their (wc-wa) shares with ct.
template <bool CT>
__device__ __forceinline__ void dh_product(const Dims& z, const Stage& s, const Tile& tl,
                                           const Items& it, const uint4* slab, const float* s_pre,
                                           const float* s_w, const View& vh, const View& vc,
                                           const View& vg, float* dh, float* hx) {
  if (tl.n <= static_cast<int>(threadIdx.x >> 5) * 16) return;
  const int t = threadIdx.x & 3;
  const int nks = min(z.sks, z.kst - s.slice * z.sks);
  const int np8 = z.np / 8;
  for (int cg = 0; cg < nks; cg += 2) {
    const int cg2 = cg + 1 < nks ? cg + 1 : cg;
    float f[CT ? 6 : 4][4] = {};
    float fs[CT ? 1 : 4][4] = {};  // the small products apart where !CT
    // Four k-steps of H at a time where !CT: their loads ahead of the mma.
#pragma unroll (CT ? 1 : 4)
    for (int ks = 0; ks < np8; ++ks) {
      // dapre's A fragment, the k-step's columns in b_transposed's order.
      const float2 a = *reinterpret_cast<const float2*>(s_pre + it.i0 * z.ps + 8 * ks + 2 * t);
      const float2 b = *reinterpret_cast<const float2*>(s_pre + it.i1 * z.ps + 8 * ks + 2 * t);
      const float x[4] = {a.x, b.x, a.y, b.y};
      uint32_t xh[4], xl[4];
      split4(x, xh, xl);
      if constexpr (CT) {
        const uint4 w[6] = {b_transposed(slab, np8, cg, ks), b_transposed(slab, np8, nks + cg, ks),
                            b_transposed(slab, np8, cg2, ks), b_transposed(slab, np8, nks + cg2, ks),
                            b_transposed(slab, np8, 2 * nks + cg, ks),
                            b_transposed(slab, np8, 2 * nks + cg2, ks)};
        mma3<6>(f, f, xh, xl, w);
      } else {
        const uint4 w[4] = {b_transposed(slab, np8, cg, ks), b_transposed(slab, np8, nks + cg, ks),
                            b_transposed(slab, np8, cg2, ks), b_transposed(slab, np8, nks + cg2, ks)};
        mma3<4>(fs, f, xh, xl, w);
      }
    }
    if constexpr (!CT) add_acc<4>(f, fs);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && cg2 == cg) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = e < 2 ? it.v0 : it.v1;
        const int i = e < 2 ? it.i0 : it.i1, r = e < 2 ? it.r0 : it.r1;
        const int c = 8 * (cg + q) + 2 * t + (e & 1);
        if (v && c < tl.w) {
          const float f0 = f[2 * q][e], f2 = f[2 * q + 1][e];
          const float gv = vg.p[r * vg.stride + c], cv = vc.p[r * vc.stride + c];
          float* hp = vh.p + i * vh.stride + c;
          const float hv = *hp;
          const int64_t at = (tl.item0 + i) * z.d + tl.k0 + c;
          dh[at] = fmaf(s_w[i], gv, f0) + cv * f2;
          if (z.hx_alone) {
            hx[at] = hv * cv;
          } else {
            hx[at + (tl.item0 + i) * z.d] = hv;
            hx[at + (tl.item0 + i + 1) * z.d] = hv * cv;
          }
          *hp = CT ? fmaf(hv, f2, f[CT ? 4 + q : 0][e]) : hv * f2;
        }
      }
    }
  }
}

// Pass 1 of the backward (or the rest of pass 0 where D is one slice):
// dh and hx, then the slice's share of dc, sum_t h_t * (dapre_t wd^T).
template <bool CT>
__device__ __forceinline__ void dh_pass(const Dims& z, const Stage& s, const Tile& tl,
                                        const BwdArgs& p, const uint4* slab, const float* s_pre,
                                        const float* s_w, const View& vh, const View& vc,
                                        const View& vg) {
  const int w = tl.w, d = z.d;
  // Each warp reads and rewrites only its own items' staged rows.
  dh_product<CT>(z, s, tl, items_of(tl, z), slab, s_pre, s_w, vh, vc, vg, p.dh, p.hx);
  __syncthreads();
  for (Walk q(w); q.i < tl.vrows; q.next()) {
    const int r = q.i, k = q.k;
    int lo, hi;
    row_items(tl, z.steps, r, lo, hi);
    const float e = items_sum<false>(vh.p + k, vh.stride, nullptr, lo, hi);
    float* o = p.dc + (tl.b0 + r) * d + tl.k0 + k;
    *o = s.chunk == 0 ? e : *o + e;
  }
}

// dc[b0 + r, k] += (wc - wa)[k, :] . dsum_r for the unit's rows, dsum in
// s_dsum [rows, np]: a thread a (row, k), four partial sums over H, added
// in a fixed order. dc was written by this block.
__device__ __forceinline__ void dc_candidate(float* dc, const float* s_dsum, const float* s_wc,
                                             const float* __restrict__ w1, int64_t b0, int vrows,
                                             const Dims& z) {
  const int d = z.d, h = z.h;
  for (Walk q(d); q.i < vrows; q.next()) {
    const int r = q.i, k = q.k;
    const float* ds = s_dsum + r * z.np;
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
    int j = 0;
    if (z.wc_shared) {
      const float* wc = s_wc + k * (z.np + 8);
      for (; j + 3 < h; j += 4) {
        p0 = fmaf(wc[j], ds[j], p0);
        p1 = fmaf(wc[j + 1], ds[j + 1], p1);
        p2 = fmaf(wc[j + 2], ds[j + 2], p2);
        p3 = fmaf(wc[j + 3], ds[j + 3], p3);
      }
    }
    for (; j < h; ++j) p0 = fmaf(wc_at(s_wc, w1, k, j, z), ds[j], p0);
    dc[(b0 + r) * d + k] += (p0 + p1) + (p2 + p3);
  }
}

// With the candidate's term in the product, two blocks an SM where the
// shared memory allows: at most 128 registers.
template <int NT, bool CT>
__global__ void __launch_bounds__(kMaxThreads, CT ? 2 : 1)
din_attention_bwd_kernel(const BwdArgs p, const Dims z) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint4* slab = reinterpret_cast<uint4*>(sm);
  float* s_alpha = sm + z.o_par;
  float* s_w2 = s_alpha + z.np;
  float* s_b1 = s_w2 + z.np;
  float* s_wc = sm + z.o_wc;
  float* s_ct = sm + z.o_ct;
  float* s_dsum = sm + z.o_dsum;
  float* s_pre = sm + z.o_pre;
  float* s_w = sm + z.o_w;
  float* s_small = sm + z.o_small;
  float* ring = sm + z.o_ring;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int h = z.h, srow_len = 3 * z.np + 1;
  float* srow = s_small + warp * srow_len;
  Stage s{blockIdx.x, 0, 0, 0};
  issue(s, z, ring, p.hist, p.cand, p.gout);
  for (int j = threadIdx.x; j < z.np; j += blockDim.x) {
    s_alpha[j] = j < h ? __ldg(p.alpha + j) : 0.f;
    s_w2[j] = j < h ? __ldg(p.w2 + j) : 0.f;
    s_b1[j] = j < h ? __ldg(p.b1 + j) : 0.f;
  }
  for (int j = threadIdx.x; j < z.warps * srow_len; j += blockDim.x) s_small[j] = 0.f;
  if (z.wc_shared) load_wc(s_wc, p.w1, z.d, h, z.np);
  if (z.nslices == 1) load_b1(slab, p.w1, z.d, h, 0, z.kst, 0, z.chunks * NT, CT);
  const float bias2 = __ldg(p.b2);
  float lg0 = 0.f, lg1 = 0.f, gh0 = 0.f, gh1 = 0.f;
  bool nz0 = false, nz1 = false;
  SmallSums<NT> sums = {};
  for (int step = 0;; ++step) {
    float* cur = ring + (step & 1) * z.slot;
    Stage nx = s;
    const bool more = advance(nx, z);
    if (more) {
      issue(nx, z, ring + ((step + 1) & 1) * z.slot, p.hist, p.cand, p.gout);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const Tile tl = tile_of(s, z);
    const View vh = view_of(cur, p.hist + tl.item0 * z.d, z);
    const View vc = view_of(cur + z.o_c, p.cand + tl.b0 * z.d, z);
    const View vg = view_of(cur + z.o_g, p.gout + tl.b0 * z.d, z);
    const Items it = items_of(tl, z);
    if (s.pass == 0) {
      if (s.chunk == 0 && s.slice == 0 && !CT) {
        candidate_term(s_ct, z.nslices == 1 ? vc.p : p.cand + tl.b0 * z.d,
                       z.nslices == 1 ? vc.stride : z.d, s_wc, p.w1, s_b1, tl.vrows, z);
        __syncthreads();
      }
      if (s.slice == 0) {
        lg0 = lg1 = gh0 = gh1 = 0.f;
        nz0 = nz1 = false;
      }
      slice_weights(slab, p.w1, s, z, z.chunks * NT);
      pre_chunk<NT, true, true, CT>(z, s, tl, it, slab, vh, vc, vg, s_pre, s_ct, s_alpha, s_w2, 0,
                                nz0, nz1, gh0, gh1, lg0, lg1);
      for (int nc = 1; nc < z.chunks; ++nc) {
        pre_chunk<NT, false, true, CT>(z, s, tl, it, slab, vh, vc, vg, s_pre, s_ct, s_alpha, s_w2,
                                   nc, nz0, nz1, gh0, gh1, lg0, lg1);
      }
      if (s.slice == z.nslices - 1) {
        const float l0 = quad_sum(lg0), l1 = quad_sum(lg1);
        const float g0 = quad_sum(gh0), g1 = quad_sum(gh1);
        const bool n0 = quad_any(nz0) && it.v0, n1 = quad_any(nz1) && it.v1;
        const float s0 = sigmoid(l0 + bias2), s1 = sigmoid(l1 + bias2);
        // A masked step passes no gradient and contributes nothing.
        const float dl0 = n0 ? g0 * s0 * (1.f - s0) : 0.f;
        const float dl1 = n1 ? g1 * s1 * (1.f - s1) : 0.f;
        if (t == 0) {
          if (it.v0) s_w[it.i0] = n0 ? s0 : 0.f;
          if (it.v1) s_w[it.i1] = n1 ? s1 : 0.f;
        }
        to_dapre<NT>(z, it, s_pre, srow, s_alpha, s_w2, dl0, dl1, sums);
        if (t == 0) sums.db2 += dl0 + dl1;
        __syncthreads();
        // dapre [B*T, H] and dsum = sum_t dapre_t, coalesced.
        for (Walk q(max(h, 1)); h > 0 && q.i < tl.n; q.next()) {
          p.dap[(tl.item0 + q.i) * h + q.k] = s_pre[q.i * z.ps + q.k];
        }
        for (Walk q(max(h, 1)); h > 0 && q.i < tl.vrows; q.next()) {
          const int r = q.i, j = q.k;
          int lo, hi;
          row_items(tl, z.steps, r, lo, hi);
          const float sum = items_sum<false>(s_pre + j, z.ps, nullptr, lo, hi);
          float* o = s_dsum + r * z.np + j;
          *o = s.chunk == 0 ? sum : *o + sum;
          p.dsum[(tl.b0 + r) * h + j] = *o;
        }
        if (z.passes == 1) dh_pass<CT>(z, s, tl, p, slab, s_pre, s_w, vh, vc, vg);
      }
    } else {
      slice_weights(slab, p.w1, s, z, z.chunks * NT);
      dh_pass<CT>(z, s, tl, p, slab, s_pre, s_w, vh, vc, vg);
    }
    if ((!more || nx.unit != s.unit) && !CT) {
      __syncthreads();
      dc_candidate(p.dc, s_dsum, s_wc, p.w1, tl.b0, tl.vrows, z);
    }
    __syncthreads();
    if (!more) break;
    s = nx;
  }
  // The warp's small sums to its row of the scratch: db1, dalpha, dw2, db2.
  if (z.chunks == 1) flush_sums<NT>(sums, srow, 0, z.np);
  sums.db2 += __shfl_xor_sync(kFull, sums.db2, 4);
  sums.db2 += __shfl_xor_sync(kFull, sums.db2, 8);
  sums.db2 += __shfl_xor_sync(kFull, sums.db2, 16);
  if (lane == 0) srow[3 * z.np] += sums.db2;
  __syncwarp();
  float* prow = p.partial + (static_cast<int64_t>(blockIdx.x) * z.warps + warp) * (3 * h + 1);
  for (int j = lane; j < h; j += 32) {
    prow[j] = srow[j];
    prow[h + j] = s_w2[j] * srow[z.np + j];
    prow[2 * h + j] = srow[2 * z.np + j];
  }
  if (lane == 0) prow[3 * h] = srow[3 * z.np];
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

// ---------------------------------------------------------------------------
// Host side.

// Largest grid that is resident at once (the persistent loops cover the
// rest); raises the kernel's dynamic shared-memory limit first.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, int64_t units, int64_t* blocks) {
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
  if (*blocks > units) *blocks = units;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int odd4(int w) {
  int s = (w + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

int64_t r4(int64_t x) { return (x + 3) / 4 * 4; }

// The launch's dimensions and shared-memory layout, region by region as
// ops/attention.py::shared_floats counts it; false where the scalars do
// not describe a launch the kernels can run.
bool make_dims(const int64_t* a, bool bwd, Dims* z) {
  if (a == nullptr) return false;
  const int64_t b = a[kBatch], t = a[kSteps], d = a[kD], h = a[kH], warps = a[kWarps];
  const int64_t nt = a[kNT], chunks = a[kChunks], sks = a[kSliceSteps], rows = a[kRows];
  if (b < 1 || t < 1 || d < 1 || h < 0 || t >= INT32_MAX / 16 || d >= INT32_MAX / 16) return false;
  if (4 * d * (h > 0 ? h : 1) >= INT32_MAX || 2 * d * 256 >= INT32_MAX) return false;
  if (!(warps == 1 || warps == 2 || warps == 4 || warps == 8)) return false;
  if (!(nt == 1 || nt == 2 || nt == 4 || nt == 8)) return false;
  const int64_t m = 16 * warps, kst = (d + 7) / 8;
  if (chunks < 1 || chunks * nt * 8 < h || (chunks - 1) * nt * 8 >= (h > 0 ? h : 1)) return false;
  if (rows != (m / t > 1 ? m / t : 1) || sks < 1 || sks > kst) return false;
  const int64_t np = chunks * nt * 8, nslices = (kst + sks - 1) / sks;
  const bool wc_shared = a[kWcShared] != 0, ct = a[kCt] != 0;
  if ((wc_shared || ct) && nslices != 1) return false;
  if (wc_shared && ct) return false;
  const int64_t width = d < 8 * sks ? d : 8 * sks;
  z->batch = b;
  z->units = (b + rows - 1) / rows;
  z->steps = static_cast<int>(t);
  z->d = static_cast<int>(d);
  z->h = static_cast<int>(h);
  z->warps = static_cast<int>(warps);
  z->m = static_cast<int>(m);
  z->rows = static_cast<int>(rows);
  z->chunks = static_cast<int>(chunks);
  z->np = static_cast<int>(np);
  z->kst = static_cast<int>(kst);
  z->sks = static_cast<int>(sks);
  z->nslices = static_cast<int>(nslices);
  z->passes = nslices > 1 ? 2 : 1;
  z->wc_shared = wc_shared;
  z->ct = ct;
  z->hs = odd4(static_cast<int>(width));
  z->ps = (np / 8) % 2 ? static_cast<int>(np) : static_cast<int>(np + 8);
  z->mode = kElem4;
  z->hx_alone = d > h;
  // The slab: the slice's k-steps of each segment, every tile of H.
  int64_t off = (ct ? 3 : 2) * sks * chunks * nt * 128;
  z->o_par = static_cast<int>(off);
  off += r4(3 * np);
  z->o_wc = static_cast<int>(off);
  if (wc_shared) off += r4(d * (np + 8));
  z->o_ct = static_cast<int>(off);
  if (!ct) off += r4(rows * np);
  z->o_dsum = static_cast<int>(off);
  if (bwd) off += r4(rows * np);
  z->o_w = static_cast<int>(off);
  off += r4(m);
  z->o_pre = static_cast<int>(off);
  if (bwd || nslices > 1) off += r4(m * z->ps);
  z->o_small = static_cast<int>(off);
  if (bwd) off += r4(warps * (3 * np + 1));
  const int64_t hsz = r4(m * z->hs + 4), csz = r4(rows * z->hs + 4);
  z->o_c = static_cast<int>(hsz);
  z->o_g = static_cast<int>(hsz + csz);
  z->slot = static_cast<int>(hsz + csz * (bwd ? 2 : 1));
  z->o_ring = static_cast<int>(off);
  off += 2 * static_cast<int64_t>(z->slot);
  if (off * 4 > kSharedBytes || off * 4 != a[kBytes]) return false;
  z->total = static_cast<int>(off);
  return true;
}

// The staging mode for these pointers.
int stage_mode(const Dims& z, const void* x, const void* y, const void* g) {
  if (z.d % 4 == 0 && aligned16(x) && aligned16(y) && (g == nullptr || aligned16(g))) return kRow16;
  return z.nslices == 1 ? kSpan16 : kElem4;
}

template <int NT, bool CT>
int launch_fwd(const FwdArgs& p, const Dims& z, cudaStream_t stream) {
  auto kernel = din_attention_kernel<NT, CT>;
  const int threads = 32 * z.warps;
  const size_t smem = static_cast<size_t>(z.total) * 4;
  int64_t blocks = 0;
  cudaError_t err = resident_blocks(kernel, threads, smem, z.units, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(p, z);
  return cudaGetLastError();
}

// blocks < 0: report the grid (into *grid) and launch nothing.
template <int NT, bool CT>
int launch_bwd(const BwdArgs& p, const Dims& z, int64_t blocks, int64_t* grid,
               cudaStream_t stream) {
  auto kernel = din_attention_bwd_kernel<NT, CT>;
  const int threads = 32 * z.warps;
  const size_t smem = static_cast<size_t>(z.total) * 4;
  int64_t most = 0;
  cudaError_t err = resident_blocks(kernel, threads, smem, z.units, &most);
  if (err != cudaSuccess) return err;
  if (blocks < 0) {
    *grid = most;
    return cudaSuccess;
  }
  if (blocks < 1 || blocks > most) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(p, z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int p_all = 3 * z.h + 1;
  din_attention_bwd_reduce<<<p_all, 256, 0, stream>>>(
      p.partial, static_cast<int>(blocks * z.warps), p_all, p.small);
  return cudaGetLastError();
}

int bwd_dispatch(const BwdArgs& p, const int64_t* a, int64_t blocks, int64_t* grid,
                 cudaStream_t s) {
  Dims z;
  if (!make_dims(a, true, &z)) return cudaErrorInvalidValue;
  z.mode = stage_mode(z, p.hist, p.cand, p.gout);
  DeviceGuard guard(static_cast<int>(a[kDevice]));
  if (guard.status() != cudaSuccess) return guard.status();
  switch (a[kNT] * 2 + z.ct) {
    case 2: return launch_bwd<1, false>(p, z, blocks, grid, s);
    case 3: return launch_bwd<1, true>(p, z, blocks, grid, s);
    case 4: return launch_bwd<2, false>(p, z, blocks, grid, s);
    case 5: return launch_bwd<2, true>(p, z, blocks, grid, s);
    case 8: return launch_bwd<4, false>(p, z, blocks, grid, s);
    case 9: return launch_bwd<4, true>(p, z, blocks, grid, s);
    case 16: return launch_bwd<8, false>(p, z, blocks, grid, s);
    case 17: return launch_bwd<8, true>(p, z, blocks, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `a`: the launch's int64 scalars (enum Scalar), from the forward's plan
// of ops/attention.py, cached there per shape.
extern "C" int din_attention_f32(const void* hist, const void* cand, const void* w1,
                                 const void* b1, const void* alpha, const void* w2,
                                 const void* b2, void* out, const int64_t* a, void* stream) {
  Dims z;
  if (!make_dims(a, false, &z)) return cudaErrorInvalidValue;
  z.mode = stage_mode(z, hist, cand, nullptr);
  DeviceGuard guard(static_cast<int>(a[kDevice]));
  if (guard.status() != cudaSuccess) return guard.status();
  const FwdArgs p{static_cast<const float*>(hist), static_cast<const float*>(cand),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(alpha), static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a[kNT] * 2 + z.ct) {
    case 2: return launch_fwd<1, false>(p, z, s);
    case 3: return launch_fwd<1, true>(p, z, s);
    case 4: return launch_fwd<2, false>(p, z, s);
    case 5: return launch_fwd<2, true>(p, z, s);
    case 8: return launch_fwd<4, false>(p, z, s);
    case 9: return launch_fwd<4, true>(p, z, s);
    case 16: return launch_fwd<8, false>(p, z, s);
    case 17: return launch_fwd<8, true>(p, z, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's grid for the backward's plan: the caller allocates the
// [grid * warps, 3H + 1] scratch (a row per warp) and passes the same grid
// to din_attention_bwd_f32.
extern "C" int din_attention_bwd_grid(const int64_t* a, int64_t* grid) {
  BwdArgs p{};
  return bwd_dispatch(p, a, -1, grid, nullptr);
}

// Writes dh [B,T,D], dc [B,D], dapre [B*T,H], hx = [h, h*c] [B*T,2D] (h*c
// alone [B*T,D] where D > H), dsum = sum_t dapre_t [B,H] and small =
// [db1 | dalpha | dw2 | db2] (3H+1), through `partial`; the wrapper makes
// dw1 from hx^T dapre (or h^T dapre and (h*c)^T dapre) and c^T dsum,
// unfolded.
extern "C" int din_attention_bwd_f32(const void* hist, const void* cand, const void* w1,
                                     const void* b1, const void* alpha, const void* w2,
                                     const void* b2, const void* gout, void* dh, void* dc,
                                     void* dap, void* hx, void* dsum, void* partial, void* small,
                                     const int64_t* a, int64_t grid, void* stream) {
  const BwdArgs p{static_cast<const float*>(hist), static_cast<const float*>(cand),
                  static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(alpha), static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<const float*>(gout),
                  static_cast<float*>(dh), static_cast<float*>(dc), static_cast<float*>(dap),
                  static_cast<float*>(hx), static_cast<float*>(dsum),
                  static_cast<float*>(partial), static_cast<float*>(small)};
  return bwd_dispatch(p, a, grid, nullptr, static_cast<cudaStream_t>(stream));
}
