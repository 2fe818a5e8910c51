// Fused gather + multi-aggregator segment reduction, forward and backward,
// for NVIDIA Hopper (sm_90a).
//
// gather_reduce_fwd replaces egc_tpu/ops/pallas/gather_reduce.py
// `windowed_gather_reduce` (bodies `_windowed_kernel`,
// `_windowed_kernel_wide`): for every receiver r, over its in-edges s -> r,
//     sum   = sum_s x_s          wsum = sum_s w_e x_s     sumsq = sum_s x_s^2
//     max   = max_s x_s          min  = min_s x_s
// with 0 for an empty receiver, max and min included.
//
// gather_reduce_bwd replaces `windowed_gather_reduce_bwd` (bodies
// `_windowed_bwd_kernel`, `_windowed_bwd_kernel_wide`): for every sender s,
// over its out-edges s -> r,
//     d[s] = sum_r c_sum[r] + w_e c_wsum[r] + x_s c_sumsq2[r]
//            + [x_s >= mx[r]] c_max[r] + [x_s <= mn[r]] c_min[r]
// where the coefficient row of r packs the present segments side by side in
// the order c_sum | c_wsum | c_sumsq2 | mx | c_max | mn | c_min. The tie
// rule gives every edge that attains the extremum the full cotangent.
//
// What bounds them on an H100: device-memory bytes. Each edge moves a whole
// F-float row (the sender's values forward, the receiver's packed
// coefficients backward) against a handful of flops per float, far below
// the ~20 flop/byte where f32 arithmetic would be the limit. The gathers
// are random rows, so what matters is that each row is read in full
// 16-byte sectors and that enough rows are in flight.
//
// Design. The TPU kernel streamed sender windows through VMEM over a
// (receiver block x sender window) grid because its grid runs in order on
// one core. Here the layout is a plain CSR: the forward walks a
// receiver-sorted edge list (rowptr, senders), the backward a sender-sorted
// one of the transposed graph (colptr, receivers), both built on the host
// (egc_tpu_torch/ops/dispatch.py). One warp owns one output row: each lane
// holds 4 consecutive floats (one 16-byte load per row gathered; a 128-wide
// row is one warp-wide 512-byte read), the warp loads 32 edge indices and
// weights at a time with one coalesced read and broadcasts them by shuffle,
// and every requested primitive accumulates in registers. Each output row
// is written once, with no atomics, so results are deterministic and the
// summation order is the CSR order. Rows wider than 128 floats loop over
// 128-column chunks; widths that are not a multiple of 4 (or unaligned
// pointers) take a one-float-per-lane variant.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSum = 1, kWsum = 2, kSumsq = 4, kMax = 8, kMin = 16;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

struct FwdOut {
  float* sum;
  float* wsum;
  float* sumsq;
  float* max;
  float* min;
};

// Column-segment index of each coefficient in the packed row, or -1.
struct Segs {
  int c_sum, c_wsum, c_sumsq2, mx, c_max, mn, c_min;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_reduce_fwd_kernel(const float* __restrict__ vals,
                         const int* __restrict__ rowptr,
                         const int* __restrict__ senders,
                         const float* __restrict__ edge_w,
                         int n_rows, int f, int prims, FwdOut out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps exit together
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  const bool has_w = (prims & kWsum) != 0;

  for (int c0 = 0; c0 < f; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < f;
    float s[VEC], ws[VEC], sq[VEC], mx[VEC], mn[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] = 0.f; ws[i] = 0.f; sq[i] = 0.f;
      mx[i] = -INFINITY; mn[i] = INFINITY;
    }
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      int my_src = 0;
      float my_w = 0.f;
      if (e < end) {
        my_src = __ldg(senders + e);
        if (has_w) my_w = __ldg(edge_w + e);
      }
      const int cnt = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int src = __shfl_sync(kFull, my_src, j);
        const float w = __shfl_sync(kFull, my_w, j);
        if (!active) continue;
        float v[VEC];
        load_vec<VEC>(vals + (size_t)src * f + col, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s[i] += v[i];
          ws[i] = fmaf(v[i], w, ws[i]);
          sq[i] = fmaf(v[i], v[i], sq[i]);
          mx[i] = fmaxf(mx[i], v[i]);
          mn[i] = fminf(mn[i], v[i]);
        }
      }
    }
    if (!active) continue;
    const size_t o = (size_t)row * f + col;
    if (end == start) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) { mx[i] = 0.f; mn[i] = 0.f; }
    }
    if (prims & kSum) store_vec<VEC>(out.sum + o, s);
    if (prims & kWsum) store_vec<VEC>(out.wsum + o, ws);
    if (prims & kSumsq) store_vec<VEC>(out.sumsq + o, sq);
    if (prims & kMax) store_vec<VEC>(out.max + o, mx);
    if (prims & kMin) store_vec<VEC>(out.min + o, mn);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_reduce_bwd_kernel(const float* __restrict__ coeff,
                         const float* __restrict__ vals,
                         const int* __restrict__ colptr,
                         const int* __restrict__ receivers,
                         const float* __restrict__ edge_w,
                         int n_rows, int f, int k, Segs sg,
                         float* __restrict__ d_vals) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int start = colptr[row];
  const int end = colptr[row + 1];
  const bool has_w = sg.c_wsum >= 0;
  const bool needs_v = sg.c_sumsq2 >= 0 || sg.c_max >= 0 || sg.c_min >= 0;
  const size_t kf = (size_t)k * f;

  for (int c0 = 0; c0 < f; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < f;
    float v[VEC], acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) { v[i] = 0.f; acc[i] = 0.f; }
    if (active && needs_v) load_vec<VEC>(vals + (size_t)row * f + col, v);
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      int my_r = 0;
      float my_w = 0.f;
      if (e < end) {
        my_r = __ldg(receivers + e);
        if (has_w) my_w = __ldg(edge_w + e);
      }
      const int cnt = min(32, end - base);
#pragma unroll 2
      for (int j = 0; j < cnt; ++j) {
        const int r = __shfl_sync(kFull, my_r, j);
        const float w = __shfl_sync(kFull, my_w, j);
        if (!active) continue;
        const float* crow = coeff + (size_t)r * kf + col;
        float contrib[VEC], t[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) contrib[i] = 0.f;
        if (sg.c_sum >= 0) {
          load_vec<VEC>(crow + (size_t)sg.c_sum * f, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i) contrib[i] += t[i];
        }
        if (sg.c_wsum >= 0) {
          load_vec<VEC>(crow + (size_t)sg.c_wsum * f, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i) contrib[i] += t[i] * w;
        }
        if (sg.c_sumsq2 >= 0) {
          load_vec<VEC>(crow + (size_t)sg.c_sumsq2 * f, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i) contrib[i] += t[i] * v[i];
        }
        if (sg.c_max >= 0) {
          float m[VEC];
          load_vec<VEC>(crow + (size_t)sg.mx * f, m);
          load_vec<VEC>(crow + (size_t)sg.c_max * f, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i) contrib[i] += v[i] >= m[i] ? t[i] : 0.f;
        }
        if (sg.c_min >= 0) {
          float m[VEC];
          load_vec<VEC>(crow + (size_t)sg.mn * f, m);
          load_vec<VEC>(crow + (size_t)sg.c_min * f, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i) contrib[i] += v[i] <= m[i] ? t[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += contrib[i];
      }
    }
    if (active) store_vec<VEC>(d_vals + (size_t)row * f + col, acc);
  }
}

inline unsigned blocks_for(int n_rows) {
  return (unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// vec4: caller guarantees f % 4 == 0 and 16-byte-aligned vals and outputs.
int gather_reduce_fwd(const float* vals, const int* rowptr,
                      const int* senders, const float* edge_w, int n_rows,
                      int f, int prims, float* out_sum, float* out_wsum,
                      float* out_sumsq, float* out_max, float* out_min,
                      int vec4, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  FwdOut out{out_sum, out_wsum, out_sumsq, out_max, out_min};
  const dim3 grid(blocks_for(n_rows)), block(kWarpsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    gather_reduce_fwd_kernel<4><<<grid, block, 0, s>>>(
        vals, rowptr, senders, edge_w, n_rows, f, prims, out);
  else
    gather_reduce_fwd_kernel<1><<<grid, block, 0, s>>>(
        vals, rowptr, senders, edge_w, n_rows, f, prims, out);
  return (int)cudaGetLastError();
}

// seg_pos: 7 ints, the column-segment index of c_sum, c_wsum, c_sumsq2, mx,
// c_max, mn, c_min in the packed coefficient rows (-1 when absent).
int gather_reduce_bwd(const float* coeff, const float* vals,
                      const int* colptr, const int* receivers,
                      const float* edge_w, int n_rows, int f, int k,
                      const int* seg_pos, float* d_vals, int vec4,
                      void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  Segs sg{seg_pos[0], seg_pos[1], seg_pos[2], seg_pos[3],
          seg_pos[4], seg_pos[5], seg_pos[6]};
  const dim3 grid(blocks_for(n_rows)), block(kWarpsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    gather_reduce_bwd_kernel<4><<<grid, block, 0, s>>>(
        coeff, vals, colptr, receivers, edge_w, n_rows, f, k, sg, d_vals);
  else
    gather_reduce_bwd_kernel<1><<<grid, block, 0, s>>>(
        coeff, vals, colptr, receivers, edge_w, n_rows, f, k, sg, d_vals);
  return (int)cudaGetLastError();
}

}  // extern "C"
