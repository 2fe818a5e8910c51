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
// What bounds them on an H100: device-memory bytes. Per node the forward
// reads H*B*A + A*y_width floats and writes H*L; each output costs 2*B*A
// flops, about 6 flops per byte moved at the arxiv shape (H4 B4 A3 L32),
// well under the f32 ridge. The backward moves about twice the bytes.
//
// Design. The TPU kernel transposed each row block in VMEM so that every
// (h, b, a) slice became a sublane range; nothing of that is needed here.
// The forward runs one thread per output element: consecutive threads take
// consecutive l, so the ys reads are coalesced across the warp and the
// w2d row, read by every thread of a node, is served from L1. The bias is
// added in the epilogue. The backward runs one warp per node: lanes stride
// over l, so dy rows are written coalesced, and each dw entry is a sum over
// l finished by a warp shuffle reduction. The A aggregator arrays come as
// separate pointers (at most kMaxAggrs), never stacked.

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

__global__ void __launch_bounds__(256)
headmix_fwd_kernel(const float* __restrict__ w2d, InPtrs ys,
                   const float* __restrict__ bias, int n, int H, int B,
                   int A, int L, int yw, float* __restrict__ z) {
  const int O = H * L;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * O) return;
  const size_t node = idx / O;
  const int o = (int)(idx - node * O);
  const int h = o / L;
  const int l = o - h * L;
  const float* wrow = w2d + node * (size_t)(H * B * A) + h * B * A;
  const size_t ybase = node * (size_t)yw + l;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    for (int a = 0; a < A; ++a) {
      acc = fmaf(__ldg(wrow + b * A + a), __ldg(ys.p[a] + ybase + b * L),
                 acc);
    }
  }
  if (bias != nullptr) acc += __ldg(bias + o);
  z[idx] = acc;
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
  const size_t total = (size_t)n * H * L;
  const unsigned threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  headmix_fwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      w2d, in, bias, n, H, B, A, L, yw, z);
  return (int)cudaGetLastError();
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
