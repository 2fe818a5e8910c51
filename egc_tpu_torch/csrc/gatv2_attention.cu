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
// (gatv2_fwd, gatv2_bwd_f) or two (gatv2_bwd_t) F-float rows of the other
// endpoint and does ~5 flops per gathered float, below the ~20 flop/byte
// where f32 arithmetic would be the limit. The graph's endpoints are
// random and the gathered arrays (76 MB each at the arxiv shape) exceed
// the 50 MB L2, so nearly every gathered row comes from device memory: a
// kernel's floor is its gathered bytes (448 B a row and a 4 B index per
// edge at the arxiv shape, plus the arrays streamed once), not the
// compulsory bytes. What keeps a kernel from that floor is how many rows
// each warp has in flight.
//
// Design. The TPU kernels streamed sender windows through VMEM over a
// sequential (receiver block x sender window) grid. Here one warp owns one
// row of a CSR (receivers for gatv2_fwd and gatv2_bwd_f, senders of the
// transpose for gatv2_bwd_t), accumulates in registers and writes the row
// once: no atomics, deterministic. The three kernels share one lane
// geometry (edge_groups.cuh, at most kMaxChans channels per lane): a group
// of P lanes owns one edge, so a warp walks its row G = 32 / P edges at a
// time, and each lane holds K consecutive channels of one head (float2
// loads when C is even), heads padded to a power of two and given LH lanes
// each. P = 8, K = 14 at both arxiv shapes: one lane per head at (H8, C14),
// eight at (H1, C112). P = 32 (one edge per warp step), K = 10 at the
// ogbg-code2 widths: four lanes per head at (H8, C37) (scalar loads, C
// odd), all 32 at (H1, C296), where lanes 30 and 31 hold no channel but
// join every shuffle. Any shape whose group fits a warp is taken
// (shape_ok): up to 32 heads and H*C = 512.
// - A head's per-edge sums (e, and q in the backward) are the lane's own
//   K-term sums, finished by log2(LH) xor-shuffles inside the head's
//   aligned run: no scan, no shared memory and no barrier in the edge
//   loop, and every lane forms its own head's exponentials.
// - The neighbour index two steps ahead and the gathered rows one step
//   ahead are issued before the current step's arithmetic, so each warp
//   keeps up to 2 G edges' rows in flight.
// - At the end of a row the G groups meet by xor-shuffles at lane offsets
//   P, 2P, ..., 16, in that order, and group 0 writes the row.
// - gatv2_fwd: each group keeps its own online-softmax state per head (m,
//   d and its K columns of o, from m = -1e30, d = 0, o = 0), so each
//   in-edge's row is gathered once: per edge m' = max(m, e),
//   c = exp(m - m'), p = exp(e - m'), d = d c + p, o = o c + p hl
//   (online_add). The groups' states merge as flash attention's blocks do
//   (merge_groups): m* = max(ma, mb), then d and o rescaled by
//   exp(mi - m*) and summed. -1e30 rather than
//   -inf keeps every exponent finite: two empty states merge to
//   exp(0) x 0, exact zeros, so a receiver with fewer in-edges than G, or
//   none, stays exact, and an empty receiver writes m = -1e30.
// - gatv2_bwd_f recomputes e per edge (the flash scheme) and sums each
//   lane's d_att terms in shared-memory slots of its own across the rows
//   a warp walks (a grid-stride loop over at most kMaxAttBlocks blocks);
//   the groups' d_att meet in the same xor order, then the block's warps
//   in shared memory in warp order.
// Lanes past the last head or past C, and groups past the row's last edge,
// are masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "edge_groups.cuh"
#include "warp_rows.cuh"

namespace {

constexpr int kMaxAttBlocks = 1024;  // gatv2_bwd_f: rows of d_att partials

// gatv2_fwd: the row is a receiver r, the walk over its in-edges (CSR).
// Group g takes edges start + g, start + g + G, ... and keeps its own
// state (m_g, d_g, acc) of head h.
template <int KT, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gatv2_fwd_kernel(const float* __restrict__ hl, const float* __restrict__ hr,
                 const float* __restrict__ att,
                 const int* __restrict__ rowptr,
                 const int* __restrict__ senders, int n_rows, int heads,
                 int channels, float slope, int P, int LH, int K,
                 float* __restrict__ o, float* __restrict__ d,
                 float* __restrict__ m_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps exit together
  const int H = heads, F = heads * channels, G = 32 / P;
  const LaneCols lc(lane, P, LH, K, H, channels);

  float hr_own[KT], attv[KT], acc[KT];
  load_cols<KT, V>(hr + (size_t)row * F + lc.col, lc.nk, hr_own);
  load_cols<KT, V>(att + lc.col, lc.nk, attv);
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;
  float m_g = kEmptyMax, d_g = 0.f;

  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  int s_cur = edge_at(senders, start + lc.grp, end);
  int s_next = edge_at(senders, start + G + lc.grp, end);
  float cur[KT];
  load_row<KT, V>(hl, s_cur, F, lc, cur);
  for (int base = start; base < end; base += G) {
    const int s_after = edge_at(senders, base + 2 * G + lc.grp, end);
    float nxt[KT];
    load_row<KT, V>(hl, s_next, F, lc, nxt);

    float e = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      e = fmaf(attv[k], leaky(cur[k] + hr_own[k], slope), e);
    e = sum_head(e, LH);
    if (s_cur >= 0) online_add<KT>(m_g, d_g, acc, e, cur);
#pragma unroll
    for (int k = 0; k < KT; ++k) cur[k] = nxt[k];
    s_cur = s_next;
    s_next = s_after;
  }

  // the G groups' states merge in a fixed order; group 0 writes the row
  merge_groups<KT>(m_g, d_g, acc, P);
  if (lc.grp == 0 && lc.nk > 0) {
    store_cols<KT, V>(o + (size_t)row * F + lc.col, lc.nk, acc);
    if (lc.c0 == 0) {  // the first lane of head h
      d[(size_t)row * H + lc.h] = d_g;
      m_out[(size_t)row * H + lc.h] = m_g;
    }
  }
}

// gatv2_bwd_t: the row is a sender s, the walk over its out-edges (CSC of
// the transpose), group g taking edges start + g, start + g + G, ... The
// receiver's hr and g_o rows, m and g_d are gathered per edge.
template <int KT>
struct EdgeRows {
  float hr[KT], go[KT];
  float mm, gd;  // m[r, h] and g_d[r, h]
};

template <int KT, int V>
__device__ __forceinline__ void load_edge(
    EdgeRows<KT>& e, int r, const float* __restrict__ hr,
    const float* __restrict__ g_o, const float* __restrict__ m,
    const float* __restrict__ g_d, int F, int H, const LaneCols& lc) {
  load_row<KT, V>(hr, r, F, lc, e.hr);
  load_row<KT, V>(g_o, r, F, lc, e.go);
  const bool head = r >= 0 && lc.h < H;
  e.mm = head ? __ldg(m + (size_t)r * H + lc.h) : 0.f;
  e.gd = head ? __ldg(g_d + (size_t)r * H + lc.h) : 0.f;
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
  const int H = heads, F = heads * channels, G = 32 / P;
  const LaneCols lc(lane, P, LH, K, H, channels);

  float hl_own[KT], attv[KT], acc[KT];
  load_cols<KT, V>(hl + (size_t)row * F + lc.col, lc.nk, hl_own);
  load_cols<KT, V>(att + lc.col, lc.nk, attv);
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;

  const int start = colptr[row];
  const int end = colptr[row + 1];
  int r_cur = edge_at(receivers, start + lc.grp, end);
  int r_next = edge_at(receivers, start + G + lc.grp, end);
  EdgeRows<KT> cur;
  load_edge<KT, V>(cur, r_cur, hr, g_o, m, g_d, F, H, lc);
  for (int base = start; base < end; base += G) {
    const int r_after = edge_at(receivers, base + 2 * G + lc.grp, end);
    EdgeRows<KT> nxt;
    load_edge<KT, V>(nxt, r_next, hr, g_o, m, g_d, F, H, lc);

    float pe = 0.f, pq = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      pe = fmaf(attv[k], leaky(hl_own[k] + cur.hr[k], slope), pe);
      pq = fmaf(cur.go[k], hl_own[k], pq);
    }
    sum_head(pe, pq, LH);
    if (r_cur >= 0 && lc.nk > 0) {
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

  sum_groups<KT>(acc, P);
  if (lc.grp == 0)
    store_cols<KT, V>(d_hl + (size_t)row * F + lc.col, lc.nk, acc);
}

// gatv2_bwd_f: each warp walks receivers r = warp id, + total warps, ...
// over their in-edges (CSR), group g taking edges start + g,
// start + g + G, ...; gridDim.x = att_blocks(n_rows). Each lane sums its
// d_att terms in K slots of shared memory of its own (s_datt, laid out
// [k][warp][lane] so a warp's accesses take 32 banks) until every row is
// done. Kept in registers, d_att took the kernel to 150 registers and one
// block per SM; this way it fits 128 registers, two blocks per SM, without
// a spill. At the end each warp's d_att row goes to s_att: a row of F
// floats, and F <= 32 * KT since a group's at most 32 lanes hold at most
// KT channels each, so s_att is sized by the instantiation (8 KiB at KT = 8,
// 14 KiB at KT = 14, 16 KiB at KT = 16) rather than by the widest shape.
template <int KT, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 2)
gatv2_bwd_f_kernel(const float* __restrict__ hl, const float* __restrict__ hr,
                   const float* __restrict__ att, const float* __restrict__ m,
                   const float* __restrict__ g_o,
                   const float* __restrict__ g_d,
                   const int* __restrict__ rowptr,
                   const int* __restrict__ senders, int n_rows, int heads,
                   int channels, float slope, int P, int LH, int K,
                   float* __restrict__ d_hr, float* __restrict__ d_att_part) {
  __shared__ float s_att[kWarpsPerBlock * 32 * KT];    // [warp][F]
  __shared__ float s_datt[KT * kWarpsPerBlock * 32];   // [k][warp][lane]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H = heads, F = heads * channels, G = 32 / P;
  const LaneCols lc(lane, P, LH, K, H, channels);

  float attv[KT];
  load_cols<KT, V>(att + lc.col, lc.nk, attv);
  constexpr int kSlot = kWarpsPerBlock * 32;   // slot k: my_datt[k * kSlot]
  float* my_datt = s_datt + warp * 32 + lane;
#pragma unroll
  for (int k = 0; k < KT; ++k) my_datt[k * kSlot] = 0.f;

  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n_rows;
       row += gridDim.x * kWarpsPerBlock) {
    const size_t own = (size_t)row * F + lc.col;
    float hr_own[KT], go_own[KT], acc[KT];
    load_cols<KT, V>(hr + own, lc.nk, hr_own);
    load_cols<KT, V>(g_o + own, lc.nk, go_own);
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[k] = 0.f;
    const bool head = lc.h < H;
    const float mm = head ? __ldg(m + (size_t)row * H + lc.h) : 0.f;
    const float gd = head ? __ldg(g_d + (size_t)row * H + lc.h) : 0.f;

    const int start = rowptr[row];
    const int end = rowptr[row + 1];
    int s_cur = edge_at(senders, start + lc.grp, end);
    int s_next = edge_at(senders, start + G + lc.grp, end);
    float cur[KT];
    load_row<KT, V>(hl, s_cur, F, lc, cur);
    for (int base = start; base < end; base += G) {
      const int s_after = edge_at(senders, base + 2 * G + lc.grp, end);
      float nxt[KT];
      load_row<KT, V>(hl, s_next, F, lc, nxt);

      float pe = 0.f, pq = 0.f;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        pe = fmaf(attv[k], leaky(cur[k] + hr_own[k], slope), pe);
        pq = fmaf(go_own[k], cur[k], pq);
      }
      sum_head(pe, pq, LH);
      if (s_cur >= 0 && lc.nk > 0) {
        const float a = expf(pe - mm);
        const float de = a * (pq + gd);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const float z = cur[k] + hr_own[k];
          acc[k] = fmaf(de * attv[k], z >= 0.f ? 1.f : slope, acc[k]);
          my_datt[k * kSlot] = fmaf(de, leaky(z, slope), my_datt[k * kSlot]);
        }
      }
#pragma unroll
      for (int k = 0; k < KT; ++k) cur[k] = nxt[k];
      s_cur = s_next;
      s_next = s_after;
    }
    sum_groups<KT>(acc, P);
    if (lc.grp == 0) store_cols<KT, V>(d_hr + own, lc.nk, acc);
  }

  // the block's d_att row: the groups' sums, then the warps' in warp order
  float datt[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) datt[k] = my_datt[k * kSlot];
  sum_groups<KT>(datt, P);
  if (lc.grp == 0) store_cols<KT, 1>(s_att + warp * F + lc.col, lc.nk, datt);
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

struct Args {
  const float *hl, *hr, *att, *m, *g_o, *g_d;
  const int *ptr, *idx;
  int n_rows, heads, channels;
  float slope;
  float *out0, *out1, *out2;
};

// which: 0 gatv2_fwd, 1 gatv2_bwd_t, 2 gatv2_bwd_f
template <int KT, int V>
void launch(int which, const Args& a, const EdgeGroups& g, cudaStream_t s) {
  const int threads = kWarpsPerBlock * 32;
  if (which == 0)
    gatv2_fwd_kernel<KT, V><<<blocks_for(a.n_rows), threads, 0, s>>>(
        a.hl, a.hr, a.att, a.ptr, a.idx, a.n_rows, a.heads, a.channels,
        a.slope, g.P, g.LH, g.K, a.out0, a.out1, a.out2);
  else if (which == 1)
    gatv2_bwd_t_kernel<KT, V><<<blocks_for(a.n_rows), threads, 0, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, g.P, g.LH, g.K, a.out0);
  else
    gatv2_bwd_f_kernel<KT, V><<<att_blocks(a.n_rows), threads, 0, s>>>(
        a.hl, a.hr, a.att, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, g.P, g.LH, g.K, a.out0, a.out1);
}

template <int KT>
void launch(int which, const Args& a, const EdgeGroups& g, bool pairs,
            cudaStream_t s) {
  if (pairs)
    launch<KT, 2>(which, a, g, s);
  else
    launch<KT, 1>(which, a, g, s);
}

inline bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

int run(int which, const Args& a, void* stream) {
  if (!shape_ok(a.heads, a.channels)) return (int)cudaErrorInvalidValue;
  if (a.n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const EdgeGroups g = edge_groups(a.heads, a.channels);
  // float2 loads: C even (so every lane's run starts on an even column)
  // and 8-byte aligned rows (a null pointer, an array the kernel does not
  // take, passes)
  const bool pairs = a.channels % 2 == 0 && aligned8(a.hl) &&
                     aligned8(a.hr) && aligned8(a.att) && aligned8(a.g_o) &&
                     aligned8(a.out0);
  if (g.K <= 4)
    launch<4>(which, a, g, pairs, s);
  else if (g.K <= 8)
    launch<8>(which, a, g, pairs, s);
  else if (g.K <= 14)
    launch<14>(which, a, g, pairs, s);
  else
    launch<16>(which, a, g, pairs, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Rows of d_att partial sums that gatv2_bwd_f writes for n_rows receivers.
int gatv2_att_blocks(int n_rows) { return (int)att_blocks(n_rows); }

// The kernels' lanes per edge, lanes per head and channels per lane for
// (heads, channels), in out[0..2]; cudaErrorInvalidValue if shape_ok
// refuses the shape.
int gatv2_edge_geometry(int heads, int channels, int* out) {
  if (!shape_ok(heads, channels)) return (int)cudaErrorInvalidValue;
  const EdgeGroups g = edge_groups(heads, channels);
  out[0] = g.P;
  out[1] = g.LH;
  out[2] = g.K;
  return 0;
}

// hl, hr, o: [n_rows, heads*channels]; att: [heads*channels]; d, m:
// [n_rows, heads]; (heads, channels) as shape_ok takes them (checked by the
// caller): heads <= 32 and an edge group of at most 32 lanes, which reaches
// heads*channels = 512.
int gatv2_fwd(const float* hl, const float* hr, const float* att,
              const int* rowptr, const int* senders, int n_rows, int heads,
              int channels, float slope, float* o, float* d, float* m,
              void* stream) {
  const Args a{hl, hr, att, nullptr, nullptr, nullptr, rowptr, senders,
               n_rows, heads, channels, slope, o, d, m};
  return run(0, a, stream);
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
