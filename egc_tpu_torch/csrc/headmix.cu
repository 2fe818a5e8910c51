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
// Backward design. The first design gave a warp to each node, its lanes
// striding over l: it re-read the node's dz row A*B times and each ys row
// H times, loaded one w word and one dz word per FMA, and finished each of
// the H*B*A dw entries with its own 5-shuffle reduction and a lone 4-byte
// store (~500 warp instructions to move 3,968 bytes per node at the arxiv
// shape; 4.7x its byte bound). Now it takes the forward's geometry: a
// thread owns V consecutive l of one node (V = 4, one float4; V = 1, the
// scalar variant, when L or y_width is not a multiple of 4 or a ys, dy or
// dz pointer is not 16-byte aligned), and a node's base b gets T threads
// of its own (L/V rounded up to a power of two, at most 32: 8 at L = 32,
// so the 4 bases of a node fill a warp); past 32 V columns a thread takes
// nc chunks of V columns, T V apart. A thread loads its dz values of HP
// heads (HP = 4, or 8 for H > 4; the node's other bases load the same
// addresses in the same warp instruction) and its A V-wide ys values, all
// at once, and w2d words by broadcast loads that the group shares. It then
// forms
//     dy[a] = sum_h w[h, b, a] dz[h]     (A V-wide stores, coalesced)
//     part[a][h] = sum over its columns of dz[h] ys[a]
// (A capped by AP = 4 or 8; HP and AP size the register arrays), and the
// group's T threads sum each part by xor-shuffles at offsets 1, 2, ...,
// T/2, in that order, so every thread ends with the same sums and the
// result is deterministic; thread (h*A + a) % T writes entry (h, b, a).
// A thread has no loop over b, so all its loads go out at once. The
// shuffles name the whole warp: threads past the last (node, b) (in the
// last block only) redo its loads and store nothing, so no lane exits
// early. With a mask of the group's T lanes instead, the kernel took 122
// registers against 80 and 0.50 against 0.30 ms at the arxiv shape
// on an H100. Heads past HP take further passes, which add into the dy
// the thread itself wrote. dy's columns B*L .. y_width-1 are written as 0
// by the last base's threads.
// headmix_bwd picks the variant (bwd_vector_ok); headmix_bwd_variant
// reports the pick. The A aggregator arrays come as separate pointers (at
// most kMaxAggrs), never stacked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxAggrs = 8;
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
  static __device__ __forceinline__ float ld_rw(const float* p) { return *p; }
  static __device__ __forceinline__ float dot(float x, float y, float acc) {
    return fmaf(x, y, acc);
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
  static __device__ __forceinline__ float4 ld_rw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float dot(float4 x, float4 y,
                                              float acc) {
    return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
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

// Thread t: (node, b) = divmod(t / T, B), the nc chunks of columns
// l = V * (t % T + T i) of base b. HP and AP cap the heads of a pass and
// the aggregators: they size the register arrays. Every lane of a warp
// reaches the shuffles; a thread past the last group takes the last
// group's loads and stores nothing.
template <int V, int HP, int AP>
__global__ void __launch_bounds__(256)
headmix_bwd_kernel(const float* __restrict__ w2d, InPtrs ys,
                   const float* __restrict__ dz, int n, int H, int B, int A,
                   int L, int yw, int lg_t, int nc, float* __restrict__ dw,
                   OutPtrs dys) {
  using Op = Vec<V>;
  using VT = typename Op::T;
  const int T = 1 << lg_t;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = (idx >> lg_t) < (size_t)n * B;
  const size_t group = live ? idx >> lg_t : (size_t)n * B - 1;
  const size_t node = group / B;
  const int b = (int)(group - node * B);
  const int j = (int)(idx & (T - 1));
  const int BA = B * A;
  const float* wrow = w2d + node * (size_t)(H * BA) + b * A;
  const float* dzrow = dz + node * (size_t)(H * L);
  const size_t ycol = node * (size_t)yw + b * L;
  float* dwrow = dw + node * (size_t)(H * BA) + b * A;

  for (int h0 = 0; h0 < H; h0 += HP) {
    const int hp = min(HP, H - h0);
    float part[AP][HP];
#pragma unroll
    for (int a = 0; a < AP; ++a)
#pragma unroll
      for (int h = 0; h < HP; ++h) part[a][h] = 0.f;
    for (int i = 0; i < nc; ++i) {
      const int l = V * (j + (i << lg_t));
      if (l >= L) break;
      // the loads of this chunk go out back to back: dz of the pass's
      // heads (shared with the node's other b) and the A ys values
      VT d[HP], y[AP];
#pragma unroll
      for (int h = 0; h < HP; ++h)
        d[h] = h < hp ? Op::ld(dzrow + (h0 + h) * L + l) : Op::zero();
#pragma unroll
      for (int a = 0; a < AP; ++a)
        if (a < A) y[a] = Op::ld(ys.p[a] + ycol + l);
#pragma unroll
      for (int a = 0; a < AP; ++a) {
        if (a < A) {
          VT acc = h0 > 0 ? Op::ld_rw(dys.p[a] + ycol + l) : Op::zero();
#pragma unroll
          for (int h = 0; h < HP; ++h) {
            if (h < hp) {
              acc = Op::fma(__ldg(wrow + (h0 + h) * BA + a), d[h], acc);
              part[a][h] = Op::dot(d[h], y[a], part[a][h]);
            }
          }
          if (live) Op::st(dys.p[a] + ycol + l, acc);
        }
      }
    }
    for (int off = 1; off < T; off <<= 1) {
#pragma unroll
      for (int a = 0; a < AP; ++a)
#pragma unroll
        for (int h = 0; h < HP; ++h)
          if (a < A && h < hp)
            part[a][h] += __shfl_xor_sync(kFull, part[a][h], off);
    }
#pragma unroll
    for (int h = 0; h < HP; ++h)
#pragma unroll
      for (int a = 0; a < AP; ++a)
        if (live && h < hp && a < A && ((h * A + a) & (T - 1)) == j)
          dwrow[(h0 + h) * BA + a] = part[a][h];
  }
  if (live && b == B - 1) {  // dy's tail columns, after the last base's
    for (int c = B * L + V * j; c < yw; c += V * T) {
#pragma unroll
      for (int a = 0; a < AP; ++a)
        if (a < A) Op::st(dys.p[a] + node * (size_t)yw + c, Op::zero());
    }
  }
}

// The float4 variant: L and y_width multiples of 4 (so every thread's four
// columns stay in one row and 16-byte aligned) and 16-byte aligned ys and
// bias pointers; z is allocated by the caller, and its rows of H*L floats
// keep that alignment.
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline bool fwd_vector_ok(const void* const* ys, int A, const float* bias,
                          int L, int yw) {
  bool ok = L % 4 == 0 && yw % 4 == 0 && aligned16(bias);
  for (int a = 0; a < A; ++a) ok = ok && aligned16(ys[a]);
  return ok;
}

// The backward's float4 variant: L and y_width multiples of 4 and 16-byte
// aligned ys, dy and dz pointers (dz's rows of H*L floats keep it). dw is
// written a float at a time and w2d read so: they may lie anywhere.
inline bool bwd_vector_ok(const void* const* ys, const void* const* dys,
                          int A, const float* dz, int L, int yw) {
  bool ok = L % 4 == 0 && yw % 4 == 0 && aligned16(dz);
  for (int a = 0; a < A; ++a) ok = ok && aligned16(ys[a]) && aligned16(dys[a]);
  return ok;
}

// T = 1 << lg_t threads per (node, b): the chunks of V columns of a base
// rounded up to a power of two, at most 32; each thread takes nc chunks.
template <int V>
void launch_bwd(const float* w2d, const InPtrs& in, const float* dz, int n,
                int H, int B, int A, int L, int yw, float* dw,
                const OutPtrs& out, cudaStream_t s) {
  const int chunks = (L + V - 1) / V;
  int lg_t = 0;
  while ((1 << lg_t) < chunks && lg_t < 5) ++lg_t;
  const int nc = (chunks + (1 << lg_t) - 1) >> lg_t;
  const size_t total = ((size_t)n * B) << lg_t;
  const unsigned threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (H <= 4 && A <= 4)
    headmix_bwd_kernel<V, 4, 4><<<blocks, threads, 0, s>>>(
        w2d, in, dz, n, H, B, A, L, yw, lg_t, nc, dw, out);
  else if (H <= 4)
    headmix_bwd_kernel<V, 4, 8><<<blocks, threads, 0, s>>>(
        w2d, in, dz, n, H, B, A, L, yw, lg_t, nc, dw, out);
  else if (A <= 4)
    headmix_bwd_kernel<V, 8, 4><<<blocks, threads, 0, s>>>(
        w2d, in, dz, n, H, B, A, L, yw, lg_t, nc, dw, out);
  else
    headmix_bwd_kernel<V, 8, 8><<<blocks, threads, 0, s>>>(
        w2d, in, dz, n, H, B, A, L, yw, lg_t, nc, dw, out);
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
  if (A < 1 || A > kMaxAggrs || B < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  InPtrs in{};
  OutPtrs out{};
  for (int a = 0; a < A; ++a) {
    in.p[a] = static_cast<const float*>(ys[a]);
    out.p[a] = static_cast<float*>(dys[a]);
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bwd_vector_ok(ys, dys, A, dz, L, yw))
    launch_bwd<4>(w2d, in, dz, n, H, B, A, L, yw, dw, out, s);
  else
    launch_bwd<1>(w2d, in, dz, n, H, B, A, L, yw, dw, out, s);
  return (int)cudaGetLastError();
}

// 1 if headmix_bwd takes the float4 variant for these arguments, else 0.
int headmix_bwd_variant(const void* const* ys, const void* const* dys,
                        const float* dz, int A, int L, int yw) {
  return bwd_vector_ok(ys, dys, A, dz, L, yw) ? 1 : 0;
}

}  // extern "C"
