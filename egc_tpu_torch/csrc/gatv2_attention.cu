// GATv2 edge softmax, forward and the two backward passes, for NVIDIA
// Hopper (sm_90a).
//
// Per edge s -> r and head h, with z = hl[s] + hr[r] (H x C floats) and the
// logit e_h = sum_c att[h,c] leaky_relu(z_hc):
//
// gatv2_fwd replaces egc_tpu/ops/pallas/attention.py
// `_gatv2_attention_cached.impl` (bodies `_v2_fwd_kernel`,
// `_v2_fwd_kernel_tp`): for every receiver r,
//     m_r = max_s e,  o_r = sum_s exp(e - m_r) hl_s,  d_r = sum_s exp(e - m_r),
// with o = 0, d = 0 and m = -1e30 for a receiver without in-edges.
//
// gatv2_bwd_t replaces `_v2_edge_pass(_v2_bwd_t_kernel)` and
// `_v2_edge_pass_tp`; gatv2_bwd_f replaces `_v2_edge_pass(_v2_bwd_f_kernel)`
// and `_v2_edge_pass_tp_f`. With a = exp(e - m_r) (m a constant: the flash
// convention, no max-tie term), q_h = sum_c g_o[r,h,c] hl[s,h,c],
// de = a (q + g_d[r]) and dz = de att leaky_relu'(z) (`_v2_edge_grad`):
//     gatv2_bwd_t, per sender s over its out-edges (CSC of the transpose):
//         d_hl[s] = sum_r (a g_o[r] + dz)
//     gatv2_bwd_f, per receiver r over its in-edges (CSR):
//         d_hr[r] = sum_s dz,   d_att = sum over every edge of de leaky(z)
// d_att leaves gatv2_bwd_f as one row of partial sums per block; the caller
// sums the rows (as the JAX wrapper sums its per-block rows).
//
// Layout: rows of F = H*C floats, heads x channels (column h*C + c), att
// as F floats, per-head scalars [N, H]; the JAX package's boundary layout.
// The head interleave, the ones channel that carried d and g_d, and the
// MXU fold matrix were TPU devices and have no counterpart here.
//
// What bounds them on an H100: device-memory bytes. Each edge gathers one
// (forward, gatv2_bwd_f) or two (gatv2_bwd_t) F-float rows and does ~5
// flops per gathered float, below the ~20 flop/byte where f32 arithmetic
// would be the limit. The graph's endpoints are random and the gathered
// rows exceed the 50 MB L2, so nearly every gathered row comes from
// device memory: gatv2_bwd_t's floor is its gathered bytes (2 rows and
// two 32 B sectors of m and g_d per edge, ~0.68 ms at the arxiv shape),
// not the compulsory bytes. What keeps a kernel from that floor is how
// many rows each warp has in flight.
//
// Design. The TPU kernels streamed sender windows through VMEM over a
// sequential (receiver block x sender window) grid. Here one warp owns one
// row of a CSR (receivers forward and for gatv2_bwd_f, senders for the
// transpose), accumulates in registers and writes the row once: no
// atomics, deterministic.
// - gatv2_fwd and gatv2_bwd_f walk the row's edges one at a time. Lane l
//   holds columns l + 32 k (k < NPL), so each gathered row is NPL coalesced
//   warp-wide loads. The logit needs the gathered row: e depends on hl[s]
//   and hr[r] through a per-head dot over C channels that straddles lanes
//   and 32-column chunks (C = 14 with H = 8). A segmented warp scan
//   (head_scan, 5 shuffles, masks precomputed per lane) sums each head's
//   run of columns inside a chunk; the lane that ends a run adds it into a
//   per-head slot in shared memory. (gat_attention.cu inlines the same
//   scan: computing its lane geometry through Columns cost gat_bwd_f 9 more
//   registers and 1.8x its time on an H100.) That per-edge chain (gather,
//   scans, barriers, exp) is serial inside the warp, so latency hides only
//   behind the other warps of the SM.
// - Forward: an online max, so each in-edge's row is gathered once (two
//   sweeps would gather every row twice, and the gather is the cost).
//   Lanes h < H keep head h's running max and denominator; per edge they
//   form the rescale exp(m_old - m_new) and the weight exp(e - m_new) and
//   pass both through shared memory to the lanes of head h's columns. m
//   starts at -1e30, not -inf, so the first rescale is exp(-huge) = 0 and
//   never NaN; an empty receiver keeps m = -1e30 and writes exact zeros.
// - gatv2_bwd_f: recompute e per edge (flash scheme) and the dot q in the
//   same scan; lanes h < H form a and de; every lane then adds its
//   columns' terms. It keeps d_att per lane in registers across the rows a
//   warp walks (a grid-stride loop over a fixed number of blocks), then the
//   block's warps meet in shared memory in a fixed order: deterministic.
// - gatv2_bwd_t: 32 / P out-edges at once. A group of P lanes owns one
//   edge, and each lane holds K consecutive channels of one head (float2
//   loads when C is even), heads padded to a power of two and given LH
//   lanes each (edge_groups): P = 8, K = 14 at both arxiv shapes, one lane
//   per head at (H8, C14), eight at (H1, C112). A head's e and q are the
//   lane's own K-term sums, finished by log2(LH) xor-shuffles inside the
//   head's aligned run: no scan, no shared memory, no barrier in the edge
//   loop, and every lane forms a and de for its own head from m and g_d it
//   loads itself. The receiver index two steps ahead and the rows one step
//   ahead are issued before the current step's arithmetic, so each warp
//   keeps up to 2 x 32 / P edges' rows in flight where the scan design
//   kept one. The G groups' sums meet by xor-shuffles in a fixed order and
//   group 0 writes the row: no atomics, deterministic. Lanes past the last
//   head or past C, and groups past the row's last edge, are masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_rows.cuh"

namespace {

constexpr int kMaxAttBlocks = 1024;  // gatv2_bwd_f: rows of d_att partials

// Where a lane's columns lie in a row of F = H*C floats. A head's C columns
// straddle lanes and 32-column chunks when C does not divide 32 (C = 14).
template <int NPL>
struct Columns {
  int hk[NPL];              // head of column lane + 32 k, -1 past the row
  unsigned scan_mask[NPL];  // bit i: the lane 2^i below is in my head
  bool run_end[NPL];        // my column ends its head's run in the chunk

  __device__ __forceinline__ Columns(int lane, int F, int C) {
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int col = lane + 32 * k;
      const bool valid = col < F;
      hk[k] = valid ? col / C : -1;
      scan_mask[k] = 0u;
#pragma unroll
      for (int i = 0; i < 5; ++i)
        if (valid && lane >= (1 << i) && (col - (1 << i)) / C == hk[k])
          scan_mask[k] |= 1u << i;
      run_end[k] = valid && (lane == 31 || col + 1 >= F ||
                             (col + 1) / C != hk[k]);
    }
  }
};

// Segmented inclusive scan of v up the lanes of one head's run in a chunk
// (5 shuffles): the lane that ends the run gets the run's sum.
__device__ __forceinline__ float head_scan(float v, unsigned mask) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float t = __shfl_up_sync(kFull, v, 1 << i);
    if (mask & (1u << i)) v += t;
  }
  return v;
}

// Dynamic shared memory: per warp, e, rescale and weight of H heads.
template <int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gatv2_fwd_kernel(const float* __restrict__ hl, const float* __restrict__ hr,
                 const float* __restrict__ att,
                 const int* __restrict__ rowptr,
                 const int* __restrict__ senders, int n_rows, int heads,
                 int channels, float slope, float* __restrict__ o,
                 float* __restrict__ d, float* __restrict__ m_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n_rows) return;  // whole warps exit together
  const int H = heads, F = heads * channels;
  float* s_e = smem + warp * 3 * H;  // [H] logits, summed by the scan
  float* s_c = s_e + H;              // [H] rescale exp(m_old - m_new)
  float* s_p = s_c + H;              // [H] weight exp(e - m_new)
  const int start = rowptr[row];
  const int end = rowptr[row + 1];

  const Columns<NPL> cols(lane, F, channels);
  float hr_own[NPL], attv[NPL], acc[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int col = lane + 32 * k;
    const bool valid = cols.hk[k] >= 0;
    hr_own[k] = valid ? __ldg(hr + (size_t)row * F + col) : 0.f;
    attv[k] = valid ? __ldg(att + col) : 0.f;
    acc[k] = 0.f;
  }
  float m_h = kEmptyMax, d_h = 0.f;  // lanes < H: state of head `lane`
  if (lane < H) s_e[lane] = 0.f;
  __syncwarp();

  for (int base = start; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int my_s = lane < cnt ? __ldg(senders + base + lane) : 0;
    for (int j = 0; j < cnt; ++j) {
      const int s = __shfl_sync(kFull, my_s, j);
      const float* src = hl + (size_t)s * F + lane;
      float gv[NPL];
#pragma unroll
      for (int k = 0; k < NPL; ++k)
        gv[k] = cols.hk[k] >= 0 ? __ldg(src + 32 * k) : 0.f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const float v = head_scan(attv[k] * leaky(gv[k] + hr_own[k], slope),
                                  cols.scan_mask[k]);
        if (cols.run_end[k]) s_e[cols.hk[k]] += v;
        __syncwarp();
      }
      if (lane < H) {
        const float e = s_e[lane];
        s_e[lane] = 0.f;
        const float m_new = fmaxf(m_h, e);
        const float c = expf(m_h - m_new);
        const float p = expf(e - m_new);
        d_h = fmaf(d_h, c, p);
        m_h = m_new;
        s_c[lane] = c;
        s_p[lane] = p;
      }
      __syncwarp();
      // s_c and s_p are rewritten only after the next edge's scan barriers
#pragma unroll
      for (int k = 0; k < NPL; ++k)
        if (cols.hk[k] >= 0)
          acc[k] = fmaf(s_p[cols.hk[k]], gv[k], acc[k] * s_c[cols.hk[k]]);
    }
  }
#pragma unroll
  for (int k = 0; k < NPL; ++k)
    if (cols.hk[k] >= 0) o[(size_t)row * F + lane + 32 * k] = acc[k];
  if (lane < H) {
    d[(size_t)row * H + lane] = d_h;
    m_out[(size_t)row * H + lane] = m_h;
  }
}

// One edge of the backward, seen from the warp that owns `row`, with the
// neighbour's row gathered. Lanes h < H get a and de of head h through
// shared memory (s_e, s_q: [H] scan slots, zero on entry and exit; s_a,
// s_de: [H], rewritten only after the next edge's scan barriers). hl_v,
// hr_v, go_v: the edge's hl[s], hr[r] and g_o[r] columns; mm, gd: m[r] and
// g_d[r] of head `lane`. Returns leaky'(z) per column in lrp and leaky(z)
// in lz.
template <int NPL>
__device__ __forceinline__ void edge_terms(
    const Columns<NPL>& cols, int lane, int H, float slope,
    const float (&attv)[NPL], const float (&hl_v)[NPL],
    const float (&hr_v)[NPL], const float (&go_v)[NPL], float mm, float gd,
    float* s_e, float* s_q, float* s_a, float* s_de, float (&lz)[NPL],
    float (&lrp)[NPL]) {
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const float z = hl_v[k] + hr_v[k];
    lz[k] = leaky(z, slope);
    lrp[k] = z >= 0.f ? 1.f : slope;
    const float ve = head_scan(attv[k] * lz[k], cols.scan_mask[k]);
    const float vq = head_scan(go_v[k] * hl_v[k], cols.scan_mask[k]);
    if (cols.run_end[k]) {
      s_e[cols.hk[k]] += ve;
      s_q[cols.hk[k]] += vq;
    }
    __syncwarp();
  }
  if (lane < H) {
    const float a = expf(s_e[lane] - mm);
    s_a[lane] = a;
    s_de[lane] = a * (s_q[lane] + gd);
    s_e[lane] = 0.f;
    s_q[lane] = 0.f;
  }
  __syncwarp();
}

// gatv2_bwd_t: the row is a sender s, the walk over its out-edges (CSC
// of the transpose), G = 32 / P edges at a time (EdgeGroups). Group g of
// the warp takes edges start + g, start + g + G, ...; lane j of a group
// holds columns col .. col + nk - 1 of head h = j / LH. Step t issues the
// receiver index of step t + 2 and the rows of step t + 1 before its own
// arithmetic, so each group keeps two edges' rows in flight.
template <int KT, int V>
__device__ __forceinline__ void load_cols(const float* __restrict__ p,
                                          int nk, float (&v)[KT]) {
#pragma unroll
  for (int k = 0; k < KT; k += V) {
    if constexpr (V == 2) {
      const float2 t = k < nk ? __ldg(reinterpret_cast<const float2*>(p + k))
                              : make_float2(0.f, 0.f);
      v[k] = t.x;
      v[k + 1] = t.y;
    } else {
      v[k] = k < nk ? __ldg(p + k) : 0.f;
    }
  }
}

template <int KT>
struct EdgeRows {
  float hr[KT], go[KT];
  float mm, gd;  // m[r, h] and g_d[r, h]
};

template <int KT, int V>
__device__ __forceinline__ void load_edge(
    EdgeRows<KT>& e, int r, const float* __restrict__ hr,
    const float* __restrict__ g_o, const float* __restrict__ m,
    const float* __restrict__ g_d, int F, int H, int h, int col, int nk) {
  const bool ok = r >= 0;
  const size_t off = (size_t)(ok ? r : 0) * F + col;
  load_cols<KT, V>(hr + off, ok ? nk : 0, e.hr);
  load_cols<KT, V>(g_o + off, ok ? nk : 0, e.go);
  const bool head = ok && h < H;
  e.mm = head ? __ldg(m + (size_t)r * H + h) : 0.f;
  e.gd = head ? __ldg(g_d + (size_t)r * H + h) : 0.f;
}

template <int KT, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gatv2_bwd_t_kernel(const float* __restrict__ hl, const float* __restrict__ hr,
                   const float* __restrict__ att, const float* __restrict__ m,
                   const float* __restrict__ g_o,
                   const float* __restrict__ g_d,
                   const int* __restrict__ colptr,
                   const int* __restrict__ receivers, int n_rows, int heads,
                   int channels, float slope, int P, int LH, int K,
                   float* __restrict__ d_hl) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps exit together
  const int H = heads, C = channels, F = heads * channels;
  const int G = 32 / P;
  const int grp = lane / P, j = lane % P;
  const int h = j / LH;
  const int c0 = (j % LH) * K;
  const int nk = h < H ? max(0, min(K, C - c0)) : 0;
  const int col = nk > 0 ? h * C + c0 : 0;

  float hl_own[KT], attv[KT], acc[KT];
  load_cols<KT, V>(hl + (size_t)row * F + col, nk, hl_own);
  load_cols<KT, V>(att + col, nk, attv);
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;

  const int start = colptr[row];
  const int end = colptr[row + 1];
  int r_cur = start + grp < end ? __ldg(receivers + start + grp) : -1;
  int r_next = start + G + grp < end ? __ldg(receivers + start + G + grp)
                                     : -1;
  EdgeRows<KT> cur;
  load_edge<KT, V>(cur, r_cur, hr, g_o, m, g_d, F, H, h, col, nk);
  for (int base = start; base < end; base += G) {
    const int i2 = base + 2 * G + grp;
    const int r_after = i2 < end ? __ldg(receivers + i2) : -1;
    EdgeRows<KT> nxt;
    load_edge<KT, V>(nxt, r_next, hr, g_o, m, g_d, F, H, h, col, nk);

    // e and q of my head: my columns' part, then the head's LH lanes
    float pe = 0.f, pq = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      pe = fmaf(attv[k], leaky(hl_own[k] + cur.hr[k], slope), pe);
      pq = fmaf(cur.go[k], hl_own[k], pq);
    }
    for (int off = 1; off < LH; off <<= 1) {
      pe += __shfl_xor_sync(kFull, pe, off);
      pq += __shfl_xor_sync(kFull, pq, off);
    }
    if (r_cur >= 0 && nk > 0) {
      const float a = expf(pe - cur.mm);
      const float de = a * (pq + cur.gd);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const float lrp = hl_own[k] + cur.hr[k] >= 0.f ? 1.f : slope;
        acc[k] = fmaf(a, cur.go[k], acc[k]);
        acc[k] = fmaf(de * attv[k], lrp, acc[k]);
      }
    }
    cur = nxt;
    r_cur = r_next;
    r_next = r_after;
  }

  // the G groups' sums, in a fixed order; group 0 writes the row
  for (int off = P; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
  }
  if (grp == 0 && nk > 0) {
    float* out = d_hl + (size_t)row * F + col;
#pragma unroll
    for (int k = 0; k < KT; k += V) {
      if (k < nk) {
        if constexpr (V == 2)
          *reinterpret_cast<float2*>(out + k) =
              make_float2(acc[k], acc[k + 1]);
        else
          out[k] = acc[k];
      }
    }
  }
}

// gatv2_bwd_f: each warp walks receivers r = warp id, + total warps, ...
// over their in-edges (CSR); gridDim.x = att_blocks(n_rows). Dynamic
// shared memory: per warp, 4 x [H], then the block's [8][F] d_att rows.
template <int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gatv2_bwd_f_kernel(const float* __restrict__ hl, const float* __restrict__ hr,
                   const float* __restrict__ att, const float* __restrict__ m,
                   const float* __restrict__ g_o,
                   const float* __restrict__ g_d,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ senders, int n_rows, int heads,
                   int channels, float slope, float* __restrict__ d_hr,
                   float* __restrict__ d_att_part) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H = heads, F = heads * channels;
  float* s_e = smem + warp * 4 * H;
  float* s_q = s_e + H;
  float* s_a = s_q + H;
  float* s_de = s_a + H;
  float* s_att = smem + kWarpsPerBlock * 4 * H;  // [kWarpsPerBlock][F]

  const Columns<NPL> cols(lane, F, channels);
  float attv[NPL], datt[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    attv[k] = cols.hk[k] >= 0 ? __ldg(att + lane + 32 * k) : 0.f;
    datt[k] = 0.f;
  }
  if (lane < H) {
    s_e[lane] = 0.f;
    s_q[lane] = 0.f;
  }
  __syncwarp();

  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n_rows;
       row += gridDim.x * kWarpsPerBlock) {
    const int start = rowptr[row];
    const int end = rowptr[row + 1];
    const size_t off = (size_t)row * F + lane;
    float hr_own[NPL], go_own[NPL], acc[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const bool valid = cols.hk[k] >= 0;
      hr_own[k] = valid ? __ldg(hr + off + 32 * k) : 0.f;
      go_own[k] = valid ? __ldg(g_o + off + 32 * k) : 0.f;
      acc[k] = 0.f;
    }
    float mm = 0.f, gd = 0.f;
    if (lane < H) {
      mm = __ldg(m + (size_t)row * H + lane);
      gd = __ldg(g_d + (size_t)row * H + lane);
    }
    for (int base = start; base < end; base += 32) {
      const int cnt = min(32, end - base);
      const int my_s = lane < cnt ? __ldg(senders + base + lane) : 0;
      for (int j = 0; j < cnt; ++j) {
        const int s = __shfl_sync(kFull, my_s, j);
        const float* src = hl + (size_t)s * F + lane;
        float hl_v[NPL], lz[NPL], lrp[NPL];
#pragma unroll
        for (int k = 0; k < NPL; ++k)
          hl_v[k] = cols.hk[k] >= 0 ? __ldg(src + 32 * k) : 0.f;
        edge_terms<NPL>(cols, lane, H, slope, attv, hl_v, hr_own, go_own, mm,
                        gd, s_e, s_q, s_a, s_de, lz, lrp);
#pragma unroll
        for (int k = 0; k < NPL; ++k)
          if (cols.hk[k] >= 0) {
            const float de = s_de[cols.hk[k]];
            acc[k] = fmaf(de * attv[k], lrp[k], acc[k]);
            datt[k] = fmaf(de, lz[k], datt[k]);
          }
      }
    }
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      if (cols.hk[k] >= 0) d_hr[off + 32 * k] = acc[k];
  }

  // the block's d_att row: its warps' registers summed in warp order
#pragma unroll
  for (int k = 0; k < NPL; ++k)
    if (cols.hk[k] >= 0) s_att[warp * F + lane + 32 * k] = datt[k];
  __syncthreads();
  for (int col = threadIdx.x; col < F; col += kWarpsPerBlock * 32) {
    float sum = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) sum += s_att[w * F + col];
    d_att_part[(size_t)blockIdx.x * F + col] = sum;
  }
}

inline unsigned att_blocks(int n_rows) {
  const unsigned b = blocks_for(n_rows);
  return b < (unsigned)kMaxAttBlocks ? b : (unsigned)kMaxAttBlocks;
}

// Columns per lane for a row of f floats: 2, 4 or 8 (f <= 256).
inline int per_lane(int f) { return f <= 64 ? 2 : f <= 128 ? 4 : 8; }

struct Args {
  const float *hl, *hr, *att, *m, *g_o, *g_d;
  const int *ptr, *idx;
  int n_rows, heads, channels;
  float slope;
  float *out0, *out1, *out2;
};

template <int NPL>
void launch(int which, const Args& a, cudaStream_t s) {
  const int threads = kWarpsPerBlock * 32;
  const int F = a.heads * a.channels;
  if (which == 0) {
    const size_t shm = sizeof(float) * kWarpsPerBlock * 3 * a.heads;
    gatv2_fwd_kernel<NPL><<<blocks_for(a.n_rows), threads, shm, s>>>(
        a.hl, a.hr, a.att, a.ptr, a.idx, a.n_rows, a.heads, a.channels,
        a.slope, a.out0, a.out1, a.out2);
  } else {
    const size_t shm = sizeof(float) * kWarpsPerBlock * (4 * a.heads + F);
    gatv2_bwd_f_kernel<NPL><<<att_blocks(a.n_rows), threads, shm, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, a.out0, a.out1);
  }
}

// gatv2_bwd_t's lane geometry: P lanes per edge (a power of two), LH lanes
// per head (an aligned power-of-two run inside the group, heads padded to
// a power of two), K channels per lane (K <= kMaxChans, even when C is, so
// float2 loads never split a lane's run). LH is the least that keeps K <=
// kMaxChans; with H <= 32 and H*C <= 256 that always gives P <= 32.
constexpr int kMaxChans = 16;

struct EdgeGroups {
  int P, LH, K;
};

inline EdgeGroups edge_groups(int H, int C) {
  int hp = 1;
  while (hp < H) hp *= 2;
  int lh = 1;
  while ((C + lh - 1) / lh > kMaxChans) lh *= 2;
  int k = (C + lh - 1) / lh;
  if (C % 2 == 0 && k % 2 == 1) ++k;
  return EdgeGroups{hp * lh, lh, k};
}

template <int KT>
void launch_bwd_t(const Args& a, const EdgeGroups& g, bool pairs,
                  cudaStream_t s) {
  const int threads = kWarpsPerBlock * 32;
  if (pairs)
    gatv2_bwd_t_kernel<KT, 2><<<blocks_for(a.n_rows), threads, 0, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, g.P, g.LH, g.K, a.out0);
  else
    gatv2_bwd_t_kernel<KT, 1><<<blocks_for(a.n_rows), threads, 0, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, g.P, g.LH, g.K, a.out0);
}

inline bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

int run_bwd_t(const Args& a, cudaStream_t s) {
  const EdgeGroups g = edge_groups(a.heads, a.channels);
  // float2 loads: C even (so every lane's run starts on an even column)
  // and 8-byte aligned rows
  const bool pairs = a.channels % 2 == 0 && aligned8(a.hl) &&
                     aligned8(a.hr) && aligned8(a.att) && aligned8(a.g_o) &&
                     aligned8(a.out0);
  if (g.K <= 4)
    launch_bwd_t<4>(a, g, pairs, s);
  else if (g.K <= 8)
    launch_bwd_t<8>(a, g, pairs, s);
  else if (g.K <= 14)
    launch_bwd_t<14>(a, g, pairs, s);
  else
    launch_bwd_t<16>(a, g, pairs, s);
  return (int)cudaGetLastError();
}

int run(int which, const Args& a, void* stream) {
  if (!shape_ok(a.heads, a.channels)) return (int)cudaErrorInvalidValue;
  if (a.n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 1) return run_bwd_t(a, s);
  switch (per_lane(a.heads * a.channels)) {
    case 2:
      launch<2>(which, a, s);
      break;
    case 4:
      launch<4>(which, a, s);
      break;
    default:
      launch<8>(which, a, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Rows of d_att partial sums that gatv2_bwd_f writes for n_rows receivers.
int gatv2_att_blocks(int n_rows) { return (int)att_blocks(n_rows); }

// hl, hr, o: [n_rows, heads*channels]; att: [heads*channels]; d, m:
// [n_rows, heads]; heads <= 32 and heads*channels <= 256 (checked by the
// caller).
int gatv2_fwd(const float* hl, const float* hr, const float* att,
              const int* rowptr, const int* senders, int n_rows, int heads,
              int channels, float slope, float* o, float* d, float* m,
              void* stream) {
  const Args a{hl, hr, att, nullptr, nullptr, nullptr, rowptr, senders,
               n_rows, heads, channels, slope, o, d, m};
  return run(0, a, stream);
}

// gatv2_bwd_t's lanes per edge, lanes per head and channels per lane for
// (heads, channels), in out[0..2]; cudaErrorInvalidValue if shape_ok
// refuses the shape.
int gatv2_bwd_t_geometry(int heads, int channels, int* out) {
  if (!shape_ok(heads, channels)) return (int)cudaErrorInvalidValue;
  const EdgeGroups g = edge_groups(heads, channels);
  out[0] = g.P;
  out[1] = g.LH;
  out[2] = g.K;
  return 0;
}

// (colptr, receivers): the transposed graph, sender-sorted.
int gatv2_bwd_t(const float* hl, const float* hr, const float* att,
                const float* m, const float* g_o, const float* g_d,
                const int* colptr, const int* receivers, int n_rows,
                int heads, int channels, float slope, float* d_hl,
                void* stream) {
  const Args a{hl, hr, att, m, g_o, g_d, colptr, receivers, n_rows, heads,
               channels, slope, d_hl, nullptr, nullptr};
  return run(1, a, stream);
}

// (rowptr, senders): the forward graph, receiver-sorted. d_att_part:
// [gatv2_att_blocks(n_rows), heads*channels].
int gatv2_bwd_f(const float* hl, const float* hr, const float* att,
                const float* m, const float* g_o, const float* g_d,
                const int* rowptr, const int* senders, int n_rows, int heads,
                int channels, float slope, float* d_hr, float* d_att_part,
                void* stream) {
  const Args a{hl, hr, att, m, g_o, g_d, rowptr, senders, n_rows, heads,
               channels, slope, d_hr, d_att_part, nullptr};
  return run(2, a, stream);
}

}  // extern "C"
