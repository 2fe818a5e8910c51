// EGC head mix, forward and backward, for NVIDIA Hopper (sm_90a).
//
// headmix_fwd replaces egc_tpu/ops/pallas/headmix.py `_make_headmix.run_fwd`
// (body `fwd_kernel`, entry `head_mix_fused`):
//     z[n, h*L + l] = sum_{b,a} w2d[n, h*B*A + b*A + a] * ys[a][n, b*L + l]
//                     + bias[h*L + l]
// headmix_bwd replaces `_make_headmix.run_bwd` (body `bwd_kernel`):
//     dy[a][n, b*L + l] = sum_h w2d[n, h*B*A + b*A + a] * dz[n, h*L + l]
//                         (columns B*L .. y_width-1 written as 0)
//     dw[n, h*B*A + b*A + a] = sum_l dz[n, h*L + l] * ys[a][n, b*L + l]
// dbias = sum_n dz stays outside the kernel, as in the JAX package.
//
// What bounds them on an H100: device-memory bytes, if the loads are few
// enough. Per node the forward reads H*B*A + A*B*L floats and writes H*L;
// each output costs 2*B*A flops, about 6 flops per byte moved at the arxiv
// shape (H4 B4 A3 L32), well under the f32 ridge. The backward moves about
// twice the bytes.
//
// Forward design. A thread per output element (the first design) issued
// two loads per FMA and had the H threads of each l reload the same ys
// values: ~3,000 load instructions per node for 2,240 bytes, so load issue
// and L1, not HBM, set its time. Now a thread owns V consecutive l of one
// node (V = 4: one float4, L/4 threads per node, 4 nodes per warp at L =
// 32; V = 1, the scalar variant, when L or y_width is not a multiple of 4
// or a ys / bias pointer is not 16-byte aligned) and computes all H outputs
// of its l in registers, kHeadsPerPass heads per pass: every ys value is
// loaded exactly once (for H <= kHeadsPerPass) as one V-wide load, each
// w2d word by a broadcast load that all threads of the node share, so the
// node's w2d row leaves device memory once. The bias is added in the
// epilogue; the H V-wide stores of a node's threads are coalesced.
// headmix_fwd picks the variant (fwd_vector_ok); headmix_fwd_variant
// reports the pick, so a caller can hold it against its own rule.
//
// Backward design. One warp per node: lanes stride over l, so dy rows are
// written coalesced, and each dw entry is a sum over l finished by a warp
// shuffle reduction. The A aggregator arrays come as separate pointers (at
// most kMaxAggrs), never stacked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxAggrs = 8;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

struct InPtrs {
  const float* p[kMaxAggrs];
};
struct OutPtrs {
  float* p[kMaxAggrs];
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float ld(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float fma(float w, float y, float acc) {
    return fmaf(w, y, acc);
  }
  static __device__ __forceinline__ float add(float x, float y) {
    return x + y;
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float4 ld(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void st(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float4 fma(float w, float4 y,
                                               float4 acc) {
    return make_float4(fmaf(w, y.x, acc.x), fmaf(w, y.y, acc.y),
                       fmaf(w, y.z, acc.z), fmaf(w, y.w, acc.w));
  }
  static __device__ __forceinline__ float4 add(float4 x, float4 y) {
    return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
};

constexpr int kHeadsPerPass = 4;

// Thread t: node t / (L/V), columns l = V * (t % (L/V)) .. + V-1.
template <int V>
__global__ void __launch_bounds__(256)
headmix_fwd_kernel(const float* __restrict__ w2d, InPtrs ys,
                   const float* __restrict__ bias, int n, int H, int B,
                   int A, int L, int yw, float* __restrict__ z) {
  using Op = Vec<V>;
  const int per_node = L / V;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * per_node) return;
  const size_t node = idx / per_node;
  const int l = V * (int)(idx - node * per_node);
  const int BA = B * A;
  const float* wrow = w2d + node * (size_t)(H * BA);
  const size_t ybase = node * (size_t)yw + l;
  float* zrow = z + node * (size_t)(H * L) + l;
  for (int h0 = 0; h0 < H; h0 += kHeadsPerPass) {
    typename Op::T acc[kHeadsPerPass];
#pragma unroll
    for (int j = 0; j < kHeadsPerPass; ++j) acc[j] = Op::zero();
    for (int b = 0; b < B; ++b) {
      // the A loads of this b go out back to back; a is a constant in
      // each unrolled slot, so ys.p[a] is read from the parameter bank
      typename Op::T y[kMaxAggrs];
#pragma unroll
      for (int a = 0; a < kMaxAggrs; ++a)
        if (a < A) y[a] = Op::ld(ys.p[a] + ybase + b * L);
#pragma unroll
      for (int a = 0; a < kMaxAggrs; ++a) {
        if (a < A) {
          const float* w = wrow + h0 * BA + b * A + a;
#pragma unroll
          for (int j = 0; j < kHeadsPerPass; ++j)
            if (h0 + j < H) acc[j] = Op::fma(__ldg(w + j * BA), y[a], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kHeadsPerPass; ++j) {
      const int h = h0 + j;
      if (h < H) {
        typename Op::T out = acc[j];
        if (bias != nullptr) out = Op::add(out, Op::ld(bias + h * L + l));
        Op::st(zrow + h * L, out);
      }
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
headmix_bwd_kernel(const float* __restrict__ w2d, InPtrs ys,
                   const float* __restrict__ dz, int n, int H, int B, int A,
                   int L, int yw, float* __restrict__ dw, OutPtrs dys) {
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (node >= n) return;  // whole warps exit together
  const int BA = B * A;
  const float* wrow = w2d + (size_t)node * H * BA;
  const float* dzrow = dz + (size_t)node * H * L;
  const size_t ybase = (size_t)node * yw;

  for (int a = 0; a < A; ++a) {
    float* dy = dys.p[a] + ybase;
    for (int b = 0; b < B; ++b) {
      for (int l = lane; l < L; l += 32) {
        float acc = 0.f;
        for (int h = 0; h < H; ++h)
          acc = fmaf(__ldg(wrow + h * BA + b * A + a),
                     __ldg(dzrow + h * L + l), acc);
        dy[b * L + l] = acc;
      }
    }
    for (int c = B * L + lane; c < yw; c += 32) dy[c] = 0.f;
  }

  float* dwrow = dw + (size_t)node * H * BA;
  for (int h = 0; h < H; ++h) {
    for (int b = 0; b < B; ++b) {
      for (int a = 0; a < A; ++a) {
        const float* y = ys.p[a] + ybase + b * L;
        float part = 0.f;
        for (int l = lane; l < L; l += 32)
          part = fmaf(__ldg(dzrow + h * L + l), __ldg(y + l), part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(kFull, part, off);
        if (lane == 0) dwrow[h * BA + b * A + a] = part;
      }
    }
  }
}

// The float4 variant: L and y_width multiples of 4 (so every thread's four
// columns stay in one row and 16-byte aligned) and 16-byte aligned ys and
// bias pointers; z is allocated by the caller, and its rows of H*L floats
// keep that alignment.
inline bool fwd_vector_ok(const void* const* ys, int A, const float* bias,
                          int L, int yw) {
  bool ok = L % 4 == 0 && yw % 4 == 0 &&
            reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  for (int a = 0; a < A; ++a)
    ok = ok && reinterpret_cast<uintptr_t>(ys[a]) % 16 == 0;
  return ok;
}

}  // namespace

extern "C" {

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ys: host array of A device pointers; bias may be null.
int headmix_fwd(const float* w2d, const void* const* ys, int A,
                const float* bias, int n, int H, int B, int L, int yw,
                float* z, void* stream) {
  if (A < 1 || A > kMaxAggrs) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  InPtrs in{};
  for (int a = 0; a < A; ++a) in.p[a] = static_cast<const float*>(ys[a]);
  const bool vec = fwd_vector_ok(ys, A, bias, L, yw);
  const size_t total = (size_t)n * (vec ? L / 4 : L);
  const unsigned threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (vec)
    headmix_fwd_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        w2d, in, bias, n, H, B, A, L, yw, z);
  else
    headmix_fwd_kernel<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        w2d, in, bias, n, H, B, A, L, yw, z);
  return (int)cudaGetLastError();
}

// 1 if headmix_fwd takes the float4 variant for these arguments, else 0.
int headmix_fwd_variant(const void* const* ys, int A, const float* bias,
                        int L, int yw) {
  return fwd_vector_ok(ys, A, bias, L, yw) ? 1 : 0;
}

// ys, dys: host arrays of A device pointers.
int headmix_bwd(const float* w2d, const void* const* ys, const float* dz,
                int A, int n, int H, int B, int L, int yw, float* dw,
                void* const* dys, void* stream) {
  if (A < 1 || A > kMaxAggrs) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  InPtrs in{};
  OutPtrs out{};
  for (int a = 0; a < A; ++a) {
    in.p[a] = static_cast<const float*>(ys[a]);
    out.p[a] = static_cast<float*>(dys[a]);
  }
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  headmix_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(w2d, in, dz, n, H, B, A, L, yw,
                                               dw, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
