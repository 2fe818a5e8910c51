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
// d_att leaves gatv2w_bwd_f as gatv2w_att_rows(n, H, C) rows of partial
// sums; the caller sums the rows.
//
// Layout: rows of F = H*C floats, heads x channels (column h*C + c), att
// as F floats, per-head scalars [N, H]: the narrow kernels' arguments.
//
// Why a kernel of its own. A GATv2 logit needs the head's whole row before
// the softmax, so a head wider than the edge group of the narrow kernels
// (32 lanes of at most 16 channels) cannot be split into column launches,
// as a GAT head can. The JAX kernels take such a head in their column
// passes.
//
// What bounds them on an H100: device-memory bytes, as for the narrow
// kernels. Each edge gathers the head's C floats of the other endpoint:
// hl[s] in gatv2w_fwd and gatv2w_bwd_f, hr[r] and g_o[r] in gatv2w_bwd_t
// (3,000 and 6,000 B an edge at (1, 750)), and does ~5 flops a float.
// The endpoints are random and the gathered arrays (508 MB each at the
// arxiv shape) dwarf the 50 MB L2, so the floor is the gathered bytes
// from HBM. To run at it, an SM needs ~20 KB of gathered rows in flight
// (3.35 TB/s x ~1 us over 132 SMs), and each gathered float must come
// from memory once.
//
// The design, the same in all three. A warp per (row, head) that walks
// the row one edge a step leaves each edge a dependent chain (the
// neighbour index, loads, a butterfly, expf, a second read of the row for
// the accumulation), needs 24-48 register slots of accumulators a lane
// past 768 channels and keeps about one gathered row in flight a warp,
// far below the floor's ~20 KB an SM. So:
// - One block owns a (row, head) and splits the head's channels over its
//   threads: kWideChans = 6 a thread, in 2-float vectors where C is even
//   (rows and heads then start 8 bytes aligned: F = 750 rows are only
//   8-byte aligned, so no wider load is valid on every row), else single
//   floats; vector j of thread t is j T + t (T threads), so each load
//   instruction of a warp is one coalesced run. W = ceil(C / 192) warps:
//   4 at C = 750, 22 at C = 4,096 (wide_warps; the launch picks the
//   vector width by C and the alignment of the pointers, wide_vector).
// - The block walks its row G edges a step (kFwdEdges, kBwdTEdges,
//   kBwdFEdges), with the next step's G neighbour indices loaded one step
//   ahead. All G edges' gathered rows are requested before any is used,
//   into registers, and read there once: for the step's sums and for the
//   accumulation. What the accumulation needs of an edge stays in
//   registers across the sums (hl[s] in fwd, g_o[r] and the signs of z in
//   bwd_t, z in bwd_f). The own row is loaded once for the row, into
//   registers; att_h once for the block, into shared memory (C floats),
//   where it frees the registers that kept the backward kernels from
//   spilling at 3 (bwd_t) and 4 (bwd_f) edges a step.
// - Registers: the launch bound of kMaxWideWarps warps caps a thread at
//   80, so at C = 750 six blocks of 4 warps (24 warps) fit on an SM, each
//   with 12-18 KB of gathered rows requested at a step.
// - The step's G logits (in the backward passes with the G q's) meet
//   once (block_sums): a xor-butterfly in each warp, then the warps'
//   totals added in warp order from shared memory after one barrier (two
//   buffers, so one barrier a step), the same bits in every thread.
// - gatv2w_fwd: one block a (receiver, head), grid (N, H). Every thread
//   holds the same bits of the step's logits, so it keeps the same online
//   softmax state (m, d) beside its channels of o, and the step's G edges
//   fold into it in one rescale, with no state merged into another:
//   m' = max(m, e_g over the step's edges), c = exp(m - m'),
//   p_g = exp(e_g - m') (0 past the row's end), d = d c + sum_g p_g,
//   o = o c + sum_g p_g hl_g, g in order, from m = -1e30, d = 0, o = 0.
// - In the backward passes m is given, so the edges of a row are
//   independent apart from the final sum. gatv2w_bwd_t: one block a
//   (sender, head), grid (N, H). gatv2w_bwd_f: grid (B, H) of B =
//   gatv2w_att_rows blocks a head, one wave of the card; block b walks
//   receivers b, b + B, ... Each thread sums its channels' d_att terms
//   over every edge the block walks, in registers, and writes them to row
//   b of the partial sums at the end: no atomics, deterministic, one
//   partial row a block.
// Every output row is written once, zeros for a row without edges (m =
// -1e30 in the forward); channels past C and edges past the row's end are
// masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "edge_groups.cuh"  // edge_at
#include "warp_rows.cuh"

namespace {

constexpr int kMaxWideChannels = 4096;  // C the kernels take
constexpr int kWideChans = 6;           // channels a thread
constexpr int kMaxWideWarps = 24;       // warps a block at most
constexpr int kFwdEdges = 4;            // gatv2w_fwd: edges a block step
constexpr int kBwdTEdges = 3;           // gatv2w_bwd_t: edges a block step
constexpr int kBwdFEdges = 4;           // gatv2w_bwd_f: edges a block step
static_assert(kMaxWideWarps * 32 * kWideChans >= kMaxWideChannels,
              "a block holds the widest head");

// The one shape rule of the wide kernels (and of wide_shape_ok in
// egc_tpu_torch/ops/cuda/attention.py).
inline bool wide_shape_ok(int heads, int channels) {
  return heads >= 1 && heads <= kMaxHeads && channels >= 1 &&
         channels <= kMaxWideChannels;
}

// The warp's total of v, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Warps of a block for a head of C channels.
__host__ __device__ inline int wide_warps(int channels) {
  return (channels + 32 * kWideChans - 1) / (32 * kWideChans);
}

// The thread's channels of a head row p: vector j (V floats) is
// j * T + t, of nvec = C / V; zeros past C.
template <int V>
__device__ __forceinline__ void load_chans(const float* __restrict__ p,
                                           int t, int T, int nvec,
                                           float (&x)[kWideChans]) {
#pragma unroll
  for (int j = 0; j < kWideChans / V; ++j) {
    const int v = j * T + t;
    if constexpr (V == 2) {
      const float2 f = v < nvec
                           ? __ldg(reinterpret_cast<const float2*>(p) + v)
                           : make_float2(0.f, 0.f);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    } else {
      x[j] = v < nvec ? __ldg(p + v) : 0.f;
    }
  }
}

// The same from the head's C floats in shared memory.
template <int V>
__device__ __forceinline__ void shared_chans(const float* s, int t, int T,
                                             int nvec,
                                             float (&x)[kWideChans]) {
#pragma unroll
  for (int j = 0; j < kWideChans / V; ++j) {
    const int v = j * T + t;
    if constexpr (V == 2) {
      const float2 f = v < nvec ? reinterpret_cast<const float2*>(s)[v]
                                : make_float2(0.f, 0.f);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    } else {
      x[j] = v < nvec ? s[v] : 0.f;
    }
  }
}

// att_h (C floats) into the block's shared memory, for its whole walk.
__device__ __forceinline__ void share_att(float* s,
                                          const float* __restrict__ att_h,
                                          int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) s[c] = __ldg(att_h + c);
  __syncthreads();
}

template <int V>
__device__ __forceinline__ void store_chans(float* __restrict__ p, int t,
                                            int T, int nvec,
                                            const float (&x)[kWideChans]) {
#pragma unroll
  for (int j = 0; j < kWideChans / V; ++j) {
    const int v = j * T + t;
    if (v >= nvec) continue;
    if constexpr (V == 2)
      reinterpret_cast<float2*>(p)[v] = make_float2(x[2 * j], x[2 * j + 1]);
    else
      p[v] = x[j];
  }
}

// The block's totals of the NV x G values v of a step (the G logits; in
// the backward passes also the G q's), the same bits in every thread: a
// butterfly in each warp, then the W warps' totals added in warp order
// from red ([W][NV G] floats, one of two buffers that the steps take in
// turn, so one barrier a step suffices).
template <int NV, int G>
__device__ __forceinline__ void block_sums(float (&v)[NV][G], float* red,
                                           int lane, int warp, int W) {
  constexpr int S = NV * G;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int g = 0; g < G; ++g) v[i][g] = warp_sum(v[i][g]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) red[warp * S + i * G + g] = v[i][g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int g = 0; g < G; ++g) v[i][g] = red[i * G + g];
  }
  for (int w = 1; w < W; ++w) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) v[i][g] += red[w * S + i * G + g];
    }
  }
}

// gatv2w_fwd: block (receiver r = blockIdx.x, head h = blockIdx.y) over
// r's in-edges (CSR). Per edge it keeps hl[s] across the sum, for the
// accumulation.
template <int V>
__global__ void __launch_bounds__(kMaxWideWarps * 32)
gatv2w_fwd_kernel(const float* __restrict__ hl, const float* __restrict__ hr,
                  const float* __restrict__ att,
                  const int* __restrict__ rowptr,
                  const int* __restrict__ senders, int heads, int channels,
                  float slope, float* __restrict__ o, float* __restrict__ d,
                  float* __restrict__ m_out) {
  constexpr int G = kFwdEdges, K = kWideChans;
  __shared__ float s_red[2][kMaxWideWarps * G];
  extern __shared__ float s_att[];  // att_h: C floats
  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5, W = T >> 5;
  const int row = blockIdx.x, h = blockIdx.y;
  const int C = channels, F = heads * channels, nvec = channels / V;
  const size_t hc = (size_t)h * C, own = (size_t)row * F + hc;

  float hr_own[K], acc[K];
  load_chans<V>(hr + own, t, T, nvec, hr_own);
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  share_att(s_att, att + hc, C);

  float m = kEmptyMax, dsum = 0.f;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  int s_next[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s_next[g] = edge_at(senders, start + g, end);
  for (int base = start, step = 0; base < end; base += G, ++step) {
    int s[G];
    float x[G][K];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] = s_next[g];
      s_next[g] = edge_at(senders, base + G + g, end);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {  // every edge's row before any sum
      if (s[g] >= 0) {
        load_chans<V>(hl + (size_t)s[g] * F + hc, t, T, nvec, x[g]);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) x[g][k] = 0.f;
      }
    }
    float e[1][G], attv[K];
    shared_chans<V>(s_att, t, T, nvec, attv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      e[0][g] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        e[0][g] = fmaf(attv[k], leaky(x[g][k] + hr_own[k], slope), e[0][g]);
    }
    block_sums<1, G>(e, s_red[step & 1], lane, warp, W);
    // one rescale for the step's edges; an edge past the row's end adds 0
    float m_new = m;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (s[g] >= 0) m_new = fmaxf(m_new, e[0][g]);
    const float corr = expf(m - m_new);
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      p[g] = s[g] >= 0 ? expf(e[0][g] - m_new) : 0.f;
    dsum *= corr;
#pragma unroll
    for (int g = 0; g < G; ++g) dsum += p[g];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] *= corr;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[k] = fmaf(p[g], x[g][k], acc[k]);
    }
    m = m_new;
  }
  store_chans<V>(o + own, t, T, nvec, acc);
  if (t == 0) {
    d[(size_t)row * heads + h] = dsum;
    m_out[(size_t)row * heads + h] = m;
  }
}

// gatv2w_bwd_t: block (sender s = blockIdx.x, head h = blockIdx.y) over
// s's out-edges (CSC). Per edge it keeps g_o[r] and the signs of z across
// the sums.
template <int V>
__global__ void __launch_bounds__(kMaxWideWarps * 32)
gatv2w_bwd_t_kernel(const float* __restrict__ hl,
                    const float* __restrict__ hr,
                    const float* __restrict__ att,
                    const float* __restrict__ m,
                    const float* __restrict__ g_o,
                    const float* __restrict__ g_d,
                    const int* __restrict__ colptr,
                    const int* __restrict__ receivers, int heads,
                    int channels, float slope, float* __restrict__ d_hl) {
  constexpr int G = kBwdTEdges, K = kWideChans;
  __shared__ float s_red[2][kMaxWideWarps * 2 * G];
  extern __shared__ float s_att[];  // att_h: C floats
  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5, W = T >> 5;
  const int row = blockIdx.x, h = blockIdx.y;
  const int C = channels, F = heads * channels, nvec = channels / V;
  const size_t hc = (size_t)h * C;

  float own[K], acc[K];
  load_chans<V>(hl + (size_t)row * F + hc, t, T, nvec, own);
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  share_att(s_att, att + hc, C);

  const int start = colptr[row];
  const int end = colptr[row + 1];
  int r_next[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    r_next[g] = edge_at(receivers, start + g, end);
  for (int base = start, step = 0; base < end; base += G, ++step) {
    int r[G];
    float hrv[G][K], go[G][K], mm[G], gd[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      r[g] = r_next[g];
      r_next[g] = edge_at(receivers, base + G + g, end);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {  // every edge's rows before any sum
      const size_t off = (size_t)(r[g] < 0 ? 0 : r[g]) * F + hc;
      if (r[g] >= 0) {
        load_chans<V>(hr + off, t, T, nvec, hrv[g]);
        load_chans<V>(g_o + off, t, T, nvec, go[g]);
        mm[g] = __ldg(m + (size_t)r[g] * heads + h);
        gd[g] = __ldg(g_d + (size_t)r[g] * heads + h);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) hrv[g][k] = go[g][k] = 0.f;
        mm[g] = gd[g] = 0.f;
      }
    }
    float eq[2][G], attv[K];
    float(&e)[G] = eq[0];
    float(&q)[G] = eq[1];
    unsigned neg[G];  // bit k: z of channel k below 0
    shared_chans<V>(s_att, t, T, nvec, attv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      e[g] = q[g] = 0.f;
      neg[g] = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float z = own[k] + hrv[g][k];
        e[g] = fmaf(attv[k], leaky(z, slope), e[g]);
        q[g] = fmaf(go[g][k], own[k], q[g]);
        neg[g] |= (z >= 0.f ? 0u : 1u) << k;
      }
    }
    block_sums<2, G>(eq, s_red[step & 1], lane, warp, W);
    shared_chans<V>(s_att, t, T, nvec, attv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (r[g] < 0) continue;  // the same for the whole block
      const float a = expf(e[g] - mm[g]);
      const float de = a * (q[g] + gd[g]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] = fmaf(a, go[g][k], acc[k]);
        acc[k] = fmaf(de * attv[k], (neg[g] >> k) & 1u ? slope : 1.f,
                      acc[k]);
      }
    }
  }
  store_chans<V>(d_hl + (size_t)row * F + hc, t, T, nvec, acc);
}

// gatv2w_bwd_f: block (b = blockIdx.x, head h = blockIdx.y) over the
// receivers r = b, b + gridDim.x, ... and their in-edges (CSR). Per edge it
// keeps z across the sums; each thread sums its channels' d_att terms over
// all the block's edges and writes them to row b of d_att_part.
template <int V>
__global__ void __launch_bounds__(kMaxWideWarps * 32)
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
  constexpr int G = kBwdFEdges, K = kWideChans;
  __shared__ float s_red[2][kMaxWideWarps * 2 * G];
  extern __shared__ float s_att[];  // att_h: C floats
  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5, W = T >> 5;
  const int h = blockIdx.y;
  const int C = channels, F = heads * channels, nvec = channels / V;
  const size_t hc = (size_t)h * C;

  float datt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) datt[k] = 0.f;
  share_att(s_att, att + hc, C);
  int step = 0;
  for (int row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const size_t own = (size_t)row * F + hc;
    float hr_own[K], go_own[K], acc[K];
    load_chans<V>(hr + own, t, T, nvec, hr_own);
    load_chans<V>(g_o + own, t, T, nvec, go_own);
    const float mm = __ldg(m + (size_t)row * heads + h);
    const float gd = __ldg(g_d + (size_t)row * heads + h);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    const int start = rowptr[row];
    const int end = rowptr[row + 1];
    int s_next[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      s_next[g] = edge_at(senders, start + g, end);
    for (int base = start; base < end; base += G, ++step) {
      int s[G];
      float z[G][K];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] = s_next[g];
        s_next[g] = edge_at(senders, base + G + g, end);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {  // every edge's row before any sum
        if (s[g] >= 0) {
          load_chans<V>(hl + (size_t)s[g] * F + hc, t, T, nvec, z[g]);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) z[g][k] = 0.f;
        }
      }
      float eq[2][G], attv[K];
      float(&e)[G] = eq[0];
      float(&q)[G] = eq[1];
      shared_chans<V>(s_att, t, T, nvec, attv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        e[g] = q[g] = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          q[g] = fmaf(go_own[k], z[g][k], q[g]);
          z[g][k] += hr_own[k];
          e[g] = fmaf(attv[k], leaky(z[g][k], slope), e[g]);
        }
      }
      block_sums<2, G>(eq, s_red[step & 1], lane, warp, W);
      shared_chans<V>(s_att, t, T, nvec, attv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (s[g] < 0) continue;  // the same for the whole block
        const float a = expf(e[g] - mm);
        const float de = a * (q[g] + gd);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float zk = z[g][k];
          acc[k] = fmaf(de * attv[k], zk >= 0.f ? 1.f : slope, acc[k]);
          datt[k] = fmaf(de, leaky(zk, slope), datt[k]);
        }
      }
    }
    store_chans<V>(d_hr + own, t, T, nvec, acc);
  }
  store_chans<V>(d_att_part + (size_t)blockIdx.x * F + hc, t, T, nvec,
                 datt);
}

// Dynamic shared memory of a block: att_h.
inline size_t att_bytes(int channels) {
  return (size_t)channels * sizeof(float);
}

// Rows of d_att partial sums, one a gatv2w_bwd_f block: the blocks a head
// of one wave of the card at the occupancy of the launch's kernel, at most
// n_rows; 0 if the device cannot be asked.
int att_rows(int n_rows, int heads, int channels) {
  if (n_rows <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  const int threads = wide_warps(channels) * 32;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm,
          channels % 2 ? gatv2w_bwd_f_kernel<1> : gatv2w_bwd_f_kernel<2>,
          threads, att_bytes(channels)) != cudaSuccess)
    return 0;
  const int want = sms * per_sm / heads;
  return want < 1 ? 1 : (want < n_rows ? want : n_rows);
}

struct Args {
  const float *hl, *hr, *att, *m, *g_o, *g_d;
  const int *ptr, *idx;
  int n_rows, heads, channels;
  float slope;
  float *out0, *out1, *out2;
};

inline bool aligned8(const void* p) {
  return ((uintptr_t)p & 7u) == 0;
}

// The kernels load 2-float vectors where C is even and every row pointer
// is 8-byte aligned (every PyTorch allocation is), else floats.
inline int wide_vector(const Args& a) {
  const void* ptrs[] = {a.hl, a.hr, a.att, a.g_o, a.out0};
  if (a.channels % 2) return 1;
  for (const void* p : ptrs)
    if (!aligned8(p)) return 1;
  return 2;
}

// which: 0 gatv2w_fwd, 1 gatv2w_bwd_t, 2 gatv2w_bwd_f
template <int V>
void launch(int which, const Args& a, cudaStream_t s) {
  const dim3 threads(wide_warps(a.channels) * 32);
  const size_t bytes = att_bytes(a.channels);
  if (which == 0) {
    const dim3 grid((unsigned)a.n_rows, (unsigned)a.heads);
    gatv2w_fwd_kernel<V><<<grid, threads, bytes, s>>>(
        a.hl, a.hr, a.att, a.ptr, a.idx, a.heads, a.channels, a.slope,
        a.out0, a.out1, a.out2);
  } else if (which == 1) {
    const dim3 grid((unsigned)a.n_rows, (unsigned)a.heads);
    gatv2w_bwd_t_kernel<V><<<grid, threads, bytes, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.heads,
        a.channels, a.slope, a.out0);
  } else {
    const dim3 grid((unsigned)att_rows(a.n_rows, a.heads, a.channels),
                    (unsigned)a.heads);
    gatv2w_bwd_f_kernel<V><<<grid, threads, bytes, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, a.out0, a.out1);
  }
}

int run(int which, const Args& a, void* stream) {
  if (!wide_shape_ok(a.heads, a.channels)) return (int)cudaErrorInvalidValue;
  if (a.n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (wide_vector(a) == 2)
    launch<2>(which, a, s);
  else
    launch<1>(which, a, s);
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

// The three kernels' block geometry for (heads, channels) that
// wide_shape_ok takes, on 8-byte aligned tensors: out = {warps a block,
// floats a vector}. 0, or cudaErrorInvalidValue for a shape the rule
// refuses.
int gatv2w_geometry(int heads, int channels, int* out) {
  if (!wide_shape_ok(heads, channels)) return (int)cudaErrorInvalidValue;
  out[0] = wide_warps(channels);
  out[1] = channels % 2 ? 1 : 2;
  return 0;
}

// Rows of d_att partial sums that gatv2w_bwd_f writes for n_rows
// receivers at (heads, channels) on the current device.
int gatv2w_att_rows(int n_rows, int heads, int channels) {
  return att_rows(n_rows, heads, channels);
}

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
// [gatv2w_att_rows(n_rows, heads, channels), heads*channels].
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
