// GATv2 edge softmax for heads wider than one edge group (more than 512
// floats a head), forward and the two backward passes, for NVIDIA Hopper
// (sm_90a).
//
// The functions are gatv2_attention.cu's. Per edge s -> r and head h, with
// z = hl[s] + hr[r] (H x C floats) and the logit
// e_h = sum_c att[h,c] leaky_relu(z_hc):
//
// gatv2w_fwd, like gatv2_fwd (egc_tpu/ops/pallas/attention.py
// `_gatv2_attention_cached.impl`): for every receiver r,
//     m_r = max_s e,  o_r = sum_s exp(e - m_r) hl_s,
//     d_r = sum_s exp(e - m_r),
// with o = 0, d = 0 and m = -1e30 for a receiver without in-edges.
//
// With a = exp(e - m_r) (m a constant: the flash convention, no max-tie
// term), q_h = sum_c g_o[r,h,c] hl[s,h,c], de = a (q + g_d[r]) and
// dz = de att leaky_relu'(z):
//     gatv2w_bwd_t, like gatv2_bwd_t (`_v2_edge_pass(_v2_bwd_t_kernel)`,
//     `_v2_edge_pass_tp`), per sender s over its out-edges (CSC of the
//     transpose):  d_hl[s] = sum_r (a g_o[r] + dz)
//     gatv2w_bwd_f, like gatv2_bwd_f (`_v2_edge_pass(_v2_bwd_f_kernel)`,
//     `_v2_edge_pass_tp_f`), per receiver r over its in-edges (CSR):
//         d_hr[r] = sum_s dz,   d_att = sum over every edge of de leaky(z)
// d_att leaves gatv2w_bwd_f as one row of partial sums per block column;
// the caller sums the rows.
//
// Layout: rows of F = H*C floats, heads x channels (column h*C + c), att
// as F floats, per-head scalars [N, H]: the narrow kernels' arguments.
//
// Why a kernel of its own. A GATv2 logit needs the head's whole row before
// the softmax, so a head wider than the edge group of the narrow kernels
// (32 lanes of at most 16 channels) cannot be split into column launches,
// as a GAT head can. The JAX kernels take such a head in their column
// passes; here a warp walks the head's row in 32-channel slots instead.
//
// What bounds them on an H100: device-memory bytes, as for the narrow
// kernels: each edge gathers the head's C floats of the other endpoint (two
// rows in gatv2w_bwd_t) and does ~5 flops a float.
//
// Design (simple first). One warp owns one (row, head): a receiver for
// gatv2w_fwd and gatv2w_bwd_f, a sender of the transpose for
// gatv2w_bwd_t. It walks the row one edge a step. Lane l holds channels
// l, l + 32, l + 64, ... of the head (slot t is channel l + 32 t), so every
// load of a slot is one coalesced 128-byte line. A head's logit and q are
// the lanes' partial sums finished by a xor-butterfly over the warp, which
// leaves the same bits in every lane. Each edge reads its gathered row
// twice, once for the sums and once for the accumulation (the second read
// mostly from L1); the own row and att are re-read from L1 per edge.
// - Accumulators (o, d_hl, d_hr and d_att) live in kRegSlots registers a
//   lane (768 channels a head) and past them in shared memory, laid out
//   [warp][slot][lane] (dynamic, sized by C). C <= kMaxWideChannels bounds
//   that memory (wide_shape_ok).
// - gatv2w_fwd keeps the online softmax state (m, d, o) of the narrow
//   kernels' online_add: per edge m' = max(m, e), c = exp(m - m'),
//   p = exp(e - m'), d = d c + p, o = o c + p hl, from m = -1e30, d = 0,
//   o = 0, so an empty receiver writes zeros and m = -1e30.
// - gatv2w_bwd_f walks rows with a grid stride over at most
//   kMaxWideAttBlocks blocks for each head (blockIdx.y); each warp sums its
//   d_att terms in its own slots, and the block's warps add theirs in warp
//   order into one row of partial sums: no atomics, deterministic.
// Lanes past C are masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_rows.cuh"

namespace {

constexpr int kWideWarps = 4;           // warps a block
constexpr int kRegSlots = 24;           // a lane's register slots (768 ch)
constexpr int kMaxWideChannels = 4096;  // C the kernels take
constexpr int kMaxWideAttBlocks = 1024; // gatv2w_bwd_f: blocks a head
constexpr int kStaticSmem = 48 * 1024;  // beyond it: an opt-in attribute

// The one shape rule of the wide kernels (and of wide_shape_ok in
// egc_tpu_torch/ops/cuda/attention.py).
inline bool wide_shape_ok(int heads, int channels) {
  return heads >= 1 && heads <= kMaxHeads && channels >= 1 &&
         channels <= kMaxWideChannels;
}

__host__ __device__ inline int slots_of(int channels) {
  return (channels + 31) / 32;
}

__host__ __device__ inline int spill_slots(int channels) {
  const int t = slots_of(channels);
  return t > kRegSlots ? t - kRegSlots : 0;
}

// The warp's total of v, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// fn(channel, acc) for each of the lane's T slots: the first kRegSlots in
// registers, the rest at spill[(t - kRegSlots) * 32].
template <typename Fn>
__device__ __forceinline__ void each_slot(float (&reg)[kRegSlots],
                                          float* spill, int T, int lane,
                                          Fn&& fn) {
#pragma unroll
  for (int t = 0; t < kRegSlots; ++t)
    if (t < T) fn(lane + 32 * t, reg[t]);
  for (int t = kRegSlots; t < T; ++t)
    fn(lane + 32 * t, spill[(t - kRegSlots) * 32]);
}

// The same over two accumulators.
template <typename Fn>
__device__ __forceinline__ void each_slot2(float (&ra)[kRegSlots],
                                           float* sa, float (&rb)[kRegSlots],
                                           float* sb, int T, int lane,
                                           Fn&& fn) {
#pragma unroll
  for (int t = 0; t < kRegSlots; ++t)
    if (t < T) fn(lane + 32 * t, ra[t], rb[t]);
  for (int t = kRegSlots; t < T; ++t)
    fn(lane + 32 * t, sa[(t - kRegSlots) * 32], sb[(t - kRegSlots) * 32]);
}

// The lane's part of the head's logit: sum over its channels of
// att leaky(x + y), x and y the two endpoints' head rows.
__device__ __forceinline__ float part_logit(const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            const float* __restrict__ att,
                                            int C, int lane, float slope) {
  float e = 0.f;
  for (int c = lane; c < C; c += 32)
    e = fmaf(__ldg(att + c), leaky(__ldg(x + c) + __ldg(y + c), slope), e);
  return e;
}

// The lane's parts of the logit and of q = sum_c go hl_s.
__device__ __forceinline__ void part_logit_q(
    const float* __restrict__ hls, const float* __restrict__ hrr,
    const float* __restrict__ go, const float* __restrict__ att, int C,
    int lane, float slope, float& e, float& q) {
  e = 0.f;
  q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float x = __ldg(hls + c);
    e = fmaf(__ldg(att + c), leaky(x + __ldg(hrr + c), slope), e);
    q = fmaf(__ldg(go + c), x, q);
  }
}

// gatv2w_fwd: warp (row, head) = divmod(global warp, heads).
__global__ void __launch_bounds__(kWideWarps * 32)
gatv2w_fwd_kernel(const float* __restrict__ hl, const float* __restrict__ hr,
                  const float* __restrict__ att,
                  const int* __restrict__ rowptr,
                  const int* __restrict__ senders, int n_rows, int heads,
                  int channels, float slope, float* __restrict__ o,
                  float* __restrict__ d, float* __restrict__ m_out) {
  extern __shared__ float s_spill[];  // [warp][slot - kRegSlots][lane]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * kWideWarps + warp;
  if (item >= (long long)n_rows * heads) return;  // whole warps exit
  const int row = (int)(item / heads), h = (int)(item % heads);
  const int C = channels, F = heads * channels, T = slots_of(C);
  float* spill = s_spill + (size_t)warp * spill_slots(C) * 32 + lane;
  const float* hr_own = hr + (size_t)row * F + (size_t)h * C;
  const float* att_h = att + (size_t)h * C;

  float acc[kRegSlots];
  each_slot(acc, spill, T, lane, [&](int, float& a) { a = 0.f; });
  float m = kEmptyMax, dsum = 0.f;
  const int end = rowptr[row + 1];
  for (int i = rowptr[row]; i < end; ++i) {
    const float* src = hl + (size_t)__ldg(senders + i) * F + (size_t)h * C;
    const float e = warp_sum(part_logit(src, hr_own, att_h, C, lane, slope));
    const float m_new = fmaxf(m, e);
    const float corr = expf(m - m_new);
    const float p = expf(e - m_new);
    dsum = fmaf(dsum, corr, p);
    m = m_new;
    each_slot(acc, spill, T, lane, [&](int c, float& a) {
      const float v = c < C ? __ldg(src + c) : 0.f;
      a = fmaf(p, v, a * corr);
    });
  }
  float* o_row = o + (size_t)row * F + (size_t)h * C;
  each_slot(acc, spill, T, lane, [&](int c, float& a) {
    if (c < C) o_row[c] = a;
  });
  if (lane == 0) {
    d[(size_t)row * heads + h] = dsum;
    m_out[(size_t)row * heads + h] = m;
  }
}

// gatv2w_bwd_t: warp (sender s, head) over s's out-edges (CSC).
__global__ void __launch_bounds__(kWideWarps * 32)
gatv2w_bwd_t_kernel(const float* __restrict__ hl,
                    const float* __restrict__ hr,
                    const float* __restrict__ att,
                    const float* __restrict__ m,
                    const float* __restrict__ g_o,
                    const float* __restrict__ g_d,
                    const int* __restrict__ colptr,
                    const int* __restrict__ receivers, int n_rows, int heads,
                    int channels, float slope, float* __restrict__ d_hl) {
  extern __shared__ float s_spill[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * kWideWarps + warp;
  if (item >= (long long)n_rows * heads) return;  // whole warps exit
  const int row = (int)(item / heads), h = (int)(item % heads);
  const int C = channels, F = heads * channels, T = slots_of(C);
  float* spill = s_spill + (size_t)warp * spill_slots(C) * 32 + lane;
  const float* hl_own = hl + (size_t)row * F + (size_t)h * C;
  const float* att_h = att + (size_t)h * C;

  float acc[kRegSlots];
  each_slot(acc, spill, T, lane, [&](int, float& a) { a = 0.f; });
  const int end = colptr[row + 1];
  for (int i = colptr[row]; i < end; ++i) {
    const int r = __ldg(receivers + i);
    const size_t off = (size_t)r * F + (size_t)h * C;
    const float* hr_r = hr + off;
    const float* go_r = g_o + off;
    float pe, pq;
    part_logit_q(hl_own, hr_r, go_r, att_h, C, lane, slope, pe, pq);
    pe = warp_sum(pe);
    pq = warp_sum(pq);
    const float a = expf(pe - __ldg(m + (size_t)r * heads + h));
    const float de = a * (pq + __ldg(g_d + (size_t)r * heads + h));
    each_slot(acc, spill, T, lane, [&](int c, float& s) {
      if (c < C) {
        const float lrp =
            __ldg(hl_own + c) + __ldg(hr_r + c) >= 0.f ? 1.f : slope;
        s = fmaf(a, __ldg(go_r + c), s);
        s = fmaf(de * __ldg(att_h + c), lrp, s);
      }
    });
  }
  float* out = d_hl + (size_t)row * F + (size_t)h * C;
  each_slot(acc, spill, T, lane, [&](int c, float& s) {
    if (c < C) out[c] = s;
  });
}

// gatv2w_bwd_f: head h = blockIdx.y; the block's warps take receivers
// r = blockIdx.x * kWideWarps + warp, + gridDim.x * kWideWarps, ... over
// their in-edges (CSR). Shared memory: each warp's spilled d_hr and d_att
// slots, then one row of C floats where the warps add their d_att.
__global__ void __launch_bounds__(kWideWarps * 32)
gatv2w_bwd_f_kernel(const float* __restrict__ hl,
                    const float* __restrict__ hr,
                    const float* __restrict__ att,
                    const float* __restrict__ m,
                    const float* __restrict__ g_o,
                    const float* __restrict__ g_d,
                    const int* __restrict__ rowptr,
                    const int* __restrict__ senders, int n_rows, int heads,
                    int channels, float slope, float* __restrict__ d_hr,
                    float* __restrict__ d_att_part) {
  extern __shared__ float s_spill[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  const int C = channels, F = heads * channels, T = slots_of(C);
  const int S = spill_slots(C);
  float* spill_acc = s_spill + (size_t)warp * 2 * S * 32 + lane;
  float* spill_att = spill_acc + (size_t)S * 32;
  float* s_row = s_spill + (size_t)kWideWarps * 2 * S * 32;  // [C]
  const float* att_h = att + (size_t)h * C;

  float datt[kRegSlots], acc[kRegSlots];
  each_slot(datt, spill_att, T, lane, [&](int, float& a) { a = 0.f; });
  for (int row = blockIdx.x * kWideWarps + warp; row < n_rows;
       row += gridDim.x * kWideWarps) {
    const size_t own = (size_t)row * F + (size_t)h * C;
    const float* hr_own = hr + own;
    const float* go_own = g_o + own;
    const float mm = __ldg(m + (size_t)row * heads + h);
    const float gd = __ldg(g_d + (size_t)row * heads + h);
    each_slot(acc, spill_acc, T, lane, [&](int, float& a) { a = 0.f; });
    const int end = rowptr[row + 1];
    for (int i = rowptr[row]; i < end; ++i) {
      const float* src =
          hl + (size_t)__ldg(senders + i) * F + (size_t)h * C;
      float pe, pq;
      part_logit_q(src, hr_own, go_own, att_h, C, lane, slope, pe, pq);
      pe = warp_sum(pe);
      pq = warp_sum(pq);
      const float a = expf(pe - mm);
      const float de = a * (pq + gd);
      each_slot2(acc, spill_acc, datt, spill_att, T, lane,
                 [&](int c, float& s, float& t) {
                   if (c < C) {
                     const float z = __ldg(src + c) + __ldg(hr_own + c);
                     s = fmaf(de * __ldg(att_h + c), z >= 0.f ? 1.f : slope,
                              s);
                     t = fmaf(de, leaky(z, slope), t);
                   }
                 });
    }
    float* out = d_hr + own;
    each_slot(acc, spill_acc, T, lane, [&](int c, float& s) {
      if (c < C) out[c] = s;
    });
  }

  // the block's d_att row: the warps' sums added in warp order
  for (int w = 0; w < kWideWarps; ++w) {
    __syncthreads();
    if (warp == w)
      each_slot(datt, spill_att, T, lane, [&](int c, float& t) {
        if (c < C) s_row[c] = w == 0 ? t : s_row[c] + t;
      });
  }
  __syncthreads();
  float* part = d_att_part + (size_t)blockIdx.x * F + (size_t)h * C;
  for (int c = threadIdx.x; c < C; c += kWideWarps * 32) part[c] = s_row[c];
}

inline unsigned att_blocks(int n_rows) {
  const unsigned b = (unsigned)((n_rows + kWideWarps - 1) / kWideWarps);
  return b < (unsigned)kMaxWideAttBlocks ? b : (unsigned)kMaxWideAttBlocks;
}

struct Args {
  const float *hl, *hr, *att, *m, *g_o, *g_d;
  const int *ptr, *idx;
  int n_rows, heads, channels;
  float slope;
  float *out0, *out1, *out2;
};

// Dynamic shared memory of a launch; above kStaticSmem the kernel must opt
// in first.
template <typename K>
cudaError_t shared_bytes(K kernel, size_t bytes) {
  if (bytes <= (size_t)kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// which: 0 gatv2w_fwd, 1 gatv2w_bwd_t, 2 gatv2w_bwd_f
int run(int which, const Args& a, void* stream) {
  if (!wide_shape_ok(a.heads, a.channels)) return (int)cudaErrorInvalidValue;
  if (a.n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = kWideWarps * 32;
  const size_t warp_bytes = (size_t)spill_slots(a.channels) * 32 *
                            sizeof(float);
  const long long items = (long long)a.n_rows * a.heads;
  const unsigned blocks =
      (unsigned)((items + kWideWarps - 1) / kWideWarps);
  cudaError_t err;
  if (which == 0) {
    const size_t bytes = kWideWarps * warp_bytes;
    if ((err = shared_bytes(gatv2w_fwd_kernel, bytes)) != cudaSuccess)
      return (int)err;
    gatv2w_fwd_kernel<<<blocks, threads, bytes, s>>>(
        a.hl, a.hr, a.att, a.ptr, a.idx, a.n_rows, a.heads, a.channels,
        a.slope, a.out0, a.out1, a.out2);
  } else if (which == 1) {
    const size_t bytes = kWideWarps * warp_bytes;
    if ((err = shared_bytes(gatv2w_bwd_t_kernel, bytes)) != cudaSuccess)
      return (int)err;
    gatv2w_bwd_t_kernel<<<blocks, threads, bytes, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, a.out0);
  } else {
    const size_t bytes =
        kWideWarps * 2 * warp_bytes + (size_t)a.channels * sizeof(float);
    if ((err = shared_bytes(gatv2w_bwd_f_kernel, bytes)) != cudaSuccess)
      return (int)err;
    const dim3 grid(att_blocks(a.n_rows), (unsigned)a.heads);
    gatv2w_bwd_f_kernel<<<grid, threads, bytes, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, a.out0, a.out1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// 1 if the wide kernels take (heads, channels), else 0.
int gatv2w_shape_ok(int heads, int channels) {
  return wide_shape_ok(heads, channels) ? 1 : 0;
}

// Rows of d_att partial sums that gatv2w_bwd_f writes for n_rows receivers.
int gatv2w_att_blocks(int n_rows) { return (int)att_blocks(n_rows); }

// hl, hr, o: [n_rows, heads*channels]; att: [heads*channels]; d, m:
// [n_rows, heads]; (heads, channels) as wide_shape_ok takes them (checked
// by the caller): heads <= 32 and channels <= 4096.
int gatv2w_fwd(const float* hl, const float* hr, const float* att,
               const int* rowptr, const int* senders, int n_rows, int heads,
               int channels, float slope, float* o, float* d, float* m,
               void* stream) {
  const Args a{hl, hr, att, nullptr, nullptr, nullptr, rowptr, senders,
               n_rows, heads, channels, slope, o, d, m};
  return run(0, a, stream);
}

// (colptr, receivers): the transposed graph, sender-sorted.
int gatv2w_bwd_t(const float* hl, const float* hr, const float* att,
                 const float* m, const float* g_o, const float* g_d,
                 const int* colptr, const int* receivers, int n_rows,
                 int heads, int channels, float slope, float* d_hl,
                 void* stream) {
  const Args a{hl, hr, att, m, g_o, g_d, colptr, receivers, n_rows, heads,
               channels, slope, d_hl, nullptr, nullptr};
  return run(1, a, stream);
}

// (rowptr, senders): the forward graph, receiver-sorted. d_att_part:
// [gatv2w_att_blocks(n_rows), heads*channels].
int gatv2w_bwd_f(const float* hl, const float* hr, const float* att,
                 const float* m, const float* g_o, const float* g_d,
                 const int* rowptr, const int* senders, int n_rows,
                 int heads, int channels, float slope, float* d_hr,
                 float* d_att_part, void* stream) {
  const Args a{hl, hr, att, m, g_o, g_d, rowptr, senders, n_rows, heads,
               channels, slope, d_hr, d_att_part, nullptr};
  return run(2, a, stream);
}

}  // extern "C"
