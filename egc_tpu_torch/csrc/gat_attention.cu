// GAT(v1) edge softmax, forward and the two backward passes, for NVIDIA
// Hopper (sm_90a).
//
// Per head h, with z_sr = a_src[s] + a_dst[r], e_sr = leaky_relu(z_sr):
//
// gat_fwd replaces egc_tpu/ops/pallas/attention.py `gat_fwd` (bodies
// `_fwd_kernel`, `_fwd_dacc_kernel`) and the `windowed_gather_reduce(max)`
// pass that fed it its stationary max: for every receiver r,
//     m_r = max_s e_sr,  o_r = sum_s exp(e_sr - m_r) wh_s,
//     d_r = sum_s exp(e_sr - m_r),
// with o = 0, d = 0 and m = -1e30 for a receiver without in-edges.
//
// gat_bwd_t replaces `_edge_pass(_bwd_t_kernel)` and gat_bwd_f
// `_edge_pass(_bwd_f_kernel)`. With a = exp(e - m_r) (m a constant: the
// flash convention, no max-tie term), q = sum_c g_o[r,h,c] wh[s,h,c],
// de = a (q + g_d[r]) and dz = de leaky_relu'(z):
//     gat_bwd_t, per sender s over its out-edges (CSC of the transpose):
//         d_wh[s] = sum_r a g_o[r],   d_asrc[s] = sum_r dz
//     gat_bwd_f, per receiver r over its in-edges (CSR):
//         d_adst[r] = sum_s dz
//
// Layout: rows of F = H*C floats, heads x channels (column h*C + c), per-
// head scalars [N, H]; the JAX package's boundary layout. No interleave:
// the TPU packed heads into lanes because sub-128-lane ops were slow there.
//
// What bounds them on an H100: device-memory bytes. Each edge gathers one
// F-float row (wh forward and in gat_bwd_f, g_o in gat_bwd_t) and does ~2
// flops per float against it, far below the ~20 flop/byte where f32
// arithmetic would be the limit. The endpoints are random and the
// gathered arrays (103 MB at the arxiv shape) exceed the 50 MB L2, so a
// kernel's floor is its gathered bytes; what keeps it from that floor is
// how many rows each warp has in flight.
//
// Design. The TPU kernels streamed sender windows through VMEM over a
// sequential (receiver block x sender window) grid. Here one warp owns one
// row of a CSR (receivers for gat_fwd and gat_bwd_f, senders of the
// transpose for gat_bwd_t), accumulates in registers, and writes the row
// once: no atomics, deterministic. The three kernels share the GATv2
// kernels' lane geometry (edge_groups.cuh): a group of P lanes owns one
// edge, so a warp walks its row G = 32 / P edges per step, and each lane
// holds K consecutive channels of one head (float2 loads when C is even),
// heads padded to a power of two and given LH lanes each. P = 16, G = 2,
// K = 10 at both arxiv shapes: two lanes per head (scalar loads) at (H8,
// C19), sixteen (float2) at (H1, C152). P = 32, G = 1, K = 10 at the
// ogbg-code2 widths: four lanes per head (float2) at (H8, C38), all 32 at
// (H1, C304). Any shape whose group fits a warp is taken (shape_ok): up to
// 32 heads and H*C = 512.
// - Every lane forms its own head's softmax weight from the per-head
//   scalars it gathers with the row, and q (gat_bwd_t, gat_bwd_f) is the
//   lane's K-term dot finished by log2(LH) xor-shuffles inside the head's
//   aligned run: no scan, no shared memory and no barrier in an edge loop.
// - The neighbour index two steps ahead and the gathered row (with its
//   per-head scalars) one step ahead are issued before the current step's
//   arithmetic.
// - At the end of a row the G groups' sums meet by xor-shuffles at lane
//   offsets P, 2P, ..., 16, in that order; group 0 writes the row and a
//   head's first lane its per-head scalars.
// - gat_fwd keeps, in each group, an online softmax state per head (m, d
//   and its K columns of o, from m = -1e30, d = 0, o = 0), as gatv2_fwd
//   does: per edge m' = max(m, e), c = exp(m - m'), p = exp(e - m'),
//   d = d c + p, o = o c + p wh (online_add), and the groups merge by the
//   flash rescale (merge_groups). Each group's e is the plain version's e,
//   and max is order-free, so m is bitwise the plain version's. The TPU's
//   stationary max (one sweep over a_src first, exact since leaky_relu and
//   the addition of a_dst[r] are monotone) was 3-9% slower on an H100
//   (PERF.md).
// - gat_bwd_t gathers the receiver's g_o row and its a_dst, m and g_d of
//   the lane's head per edge, and sums d_wh and d_asrc; gat_bwd_f holds its
//   receiver's g_o row in registers, gathers the sender's wh row and a_src
//   per edge, and sums d_adst only.
// - Empty rows write exact zeros (and m = -1e30): nothing is divided, so
//   no inf - inf or 0 / 0 can arise.
// - A cap of 20 channels per lane (P = 8, G = 4, K = 19 and 20) was slower
//   for each of the three kernels on an H100 (PERF.md), so they keep the
//   GATv2 kernels' kMaxChans = 16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "edge_groups.cuh"
#include "warp_rows.cuh"

namespace {

// gat_fwd and gat_bwd_f gather a sender's row: its wh columns of the lane
// and its a_src of the lane's head (zeros for s < 0, a group past the row).
template <int KT>
struct SrcEdge {
  float wh[KT];
  float asrc;
};

template <int KT, int V>
__device__ __forceinline__ void load_src_edge(
    SrcEdge<KT>& e, int s, const float* __restrict__ wh,
    const float* __restrict__ a_src, int F, int H, const LaneCols& lc) {
  load_row<KT, V>(wh, s, F, lc, e.wh);
  const bool head = s >= 0 && lc.h < H;
  e.asrc = head ? __ldg(a_src + (size_t)s * H + lc.h) : 0.f;
}

// gat_fwd: the row is a receiver r, the walk over its in-edges (CSR),
// group g taking edges start + g, start + g + G, ... and keeping its own
// online state (m_g, dsum, acc) of head h.
template <int KT, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_fwd_kernel(const float* __restrict__ wh, const float* __restrict__ a_src,
               const float* __restrict__ a_dst,
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
  const bool head = lc.h < H;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  const float adst = head ? __ldg(a_dst + (size_t)row * H + lc.h) : 0.f;

  float acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;
  float m_g = kEmptyMax, dsum = 0.f;
  int s_cur = edge_at(senders, start + lc.grp, end);
  int s_next = edge_at(senders, start + G + lc.grp, end);
  SrcEdge<KT> cur;
  load_src_edge<KT, V>(cur, s_cur, wh, a_src, F, H, lc);
  for (int base = start; base < end; base += G) {
    const int s_after = edge_at(senders, base + 2 * G + lc.grp, end);
    SrcEdge<KT> nxt;
    load_src_edge<KT, V>(nxt, s_next, wh, a_src, F, H, lc);
    if (s_cur >= 0 && head)
      online_add<KT>(m_g, dsum, acc, leaky(cur.asrc + adst, slope), cur.wh);
    cur = nxt;
    s_cur = s_next;
    s_next = s_after;
  }

  // the G groups' states merge in a fixed order; group 0 writes the row
  merge_groups<KT>(m_g, dsum, acc, P);
  if (lc.grp == 0) {
    store_cols<KT, V>(o + (size_t)row * F + lc.col, lc.nk, acc);
    if (head && lc.c0 == 0) {  // the first lane of head h
      d[(size_t)row * H + lc.h] = dsum;
      m_out[(size_t)row * H + lc.h] = m_g;
    }
  }
}

// gat_bwd_f: the row is a receiver r, the walk over its in-edges (CSR),
// group g taking edges start + g, start + g + G, ... The receiver's own
// g_o columns and its a_dst, m and g_d of the lane's head stay in
// registers; the sender's wh row and a_src are gathered per edge.
template <int KT, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_f_kernel(const float* __restrict__ wh,
                 const float* __restrict__ a_src,
                 const float* __restrict__ a_dst, const float* __restrict__ m,
                 const float* __restrict__ g_o, const float* __restrict__ g_d,
                 const int* __restrict__ rowptr,
                 const int* __restrict__ senders, int n_rows, int heads,
                 int channels, float slope, int P, int LH, int K,
                 float* __restrict__ d_adst) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps exit together
  const int H = heads, F = heads * channels, G = 32 / P;
  const LaneCols lc(lane, P, LH, K, H, channels);
  const bool head = lc.h < H;

  float go_own[KT];
  load_cols<KT, V>(g_o + (size_t)row * F + lc.col, lc.nk, go_own);
  const size_t own = (size_t)row * H + lc.h;
  const float adst = head ? __ldg(a_dst + own) : 0.f;
  const float mm = head ? __ldg(m + own) : 0.f;
  const float gd = head ? __ldg(g_d + own) : 0.f;
  float hsum = 0.f;  // the sum of dz of head h over the group's edges

  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  int s_cur = edge_at(senders, start + lc.grp, end);
  int s_next = edge_at(senders, start + G + lc.grp, end);
  SrcEdge<KT> cur;
  load_src_edge<KT, V>(cur, s_cur, wh, a_src, F, H, lc);
  for (int base = start; base < end; base += G) {
    const int s_after = edge_at(senders, base + 2 * G + lc.grp, end);
    SrcEdge<KT> nxt;
    load_src_edge<KT, V>(nxt, s_next, wh, a_src, F, H, lc);

    float q = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) q = fmaf(cur.wh[k], go_own[k], q);
    q = sum_head(q, LH);
    if (s_cur >= 0 && head) {
      const float z = cur.asrc + adst;
      const float de = expf(leaky(z, slope) - mm) * (q + gd);
      hsum += z >= 0.f ? de : slope * de;
    }
    cur = nxt;
    s_cur = s_next;
    s_next = s_after;
  }

  // the G groups' sums meet in a fixed order; group 0 writes the row
  for (int off = P; off < 32; off <<= 1)
    hsum += __shfl_xor_sync(kFull, hsum, off);
  if (lc.grp == 0 && head && lc.c0 == 0) d_adst[own] = hsum;
}

// gat_bwd_t: the row is a sender s, the walk over its out-edges (CSC of
// the transpose), group g taking edges start + g, start + g + G, ... The
// receiver's g_o row, and its a_dst, m and g_d of the lane's head, are
// gathered per edge.
template <int KT>
struct GatEdge {
  float go[KT];
  float adst, mm, gd;
};

template <int KT, int V>
__device__ __forceinline__ void load_gat_edge(
    GatEdge<KT>& e, int r, const float* __restrict__ g_o,
    const float* __restrict__ a_dst, const float* __restrict__ m,
    const float* __restrict__ g_d, int F, int H, const LaneCols& lc) {
  load_row<KT, V>(g_o, r, F, lc, e.go);
  const bool head = r >= 0 && lc.h < H;
  const size_t o = (size_t)(head ? r : 0) * H + lc.h;
  e.adst = head ? __ldg(a_dst + o) : 0.f;
  e.mm = head ? __ldg(m + o) : 0.f;
  e.gd = head ? __ldg(g_d + o) : 0.f;
}

template <int KT, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_t_kernel(const float* __restrict__ wh,
                 const float* __restrict__ a_src,
                 const float* __restrict__ a_dst, const float* __restrict__ m,
                 const float* __restrict__ g_o, const float* __restrict__ g_d,
                 const int* __restrict__ colptr,
                 const int* __restrict__ receivers, int n_rows, int heads,
                 int channels, float slope, int P, int LH, int K,
                 float* __restrict__ d_wh, float* __restrict__ d_asrc) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps exit together
  const int H = heads, F = heads * channels, G = 32 / P;
  const LaneCols lc(lane, P, LH, K, H, channels);
  const bool head = lc.h < H;

  float wh_own[KT], acc[KT];
  load_cols<KT, V>(wh + (size_t)row * F + lc.col, lc.nk, wh_own);
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;
  const float asrc = head ? __ldg(a_src + (size_t)row * H + lc.h) : 0.f;
  float hsum = 0.f;  // the sum of dz of head h over the group's edges

  const int start = colptr[row];
  const int end = colptr[row + 1];
  int r_cur = edge_at(receivers, start + lc.grp, end);
  int r_next = edge_at(receivers, start + G + lc.grp, end);
  GatEdge<KT> cur;
  load_gat_edge<KT, V>(cur, r_cur, g_o, a_dst, m, g_d, F, H, lc);
  for (int base = start; base < end; base += G) {
    const int r_after = edge_at(receivers, base + 2 * G + lc.grp, end);
    GatEdge<KT> nxt;
    load_gat_edge<KT, V>(nxt, r_next, g_o, a_dst, m, g_d, F, H, lc);

    float q = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) q = fmaf(cur.go[k], wh_own[k], q);
    q = sum_head(q, LH);
    if (r_cur >= 0 && head) {
      const float z = asrc + cur.adst;
      const float a = expf(leaky(z, slope) - cur.mm);
      const float de = a * (q + cur.gd);
      hsum += z >= 0.f ? de : slope * de;
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[k] = fmaf(a, cur.go[k], acc[k]);
    }
    cur = nxt;
    r_cur = r_next;
    r_next = r_after;
  }

  // the G groups' sums meet in a fixed order; group 0 writes the row
  sum_groups<KT>(acc, P);
  for (int off = P; off < 32; off <<= 1)
    hsum += __shfl_xor_sync(kFull, hsum, off);
  if (lc.grp == 0) {
    store_cols<KT, V>(d_wh + (size_t)row * F + lc.col, lc.nk, acc);
    if (head && lc.c0 == 0) d_asrc[(size_t)row * H + lc.h] = hsum;
  }
}

struct Args {
  const float *wh, *a_src, *a_dst, *m, *g_o, *g_d;
  const int *ptr, *idx;
  int n_rows, heads, channels;
  float slope;
  float *out0, *out1, *out2;
};

// which: 0 gat_fwd, 1 gat_bwd_t, 2 gat_bwd_f
template <int KT, int V>
void launch(int which, const Args& a, const EdgeGroups& g, cudaStream_t s) {
  const unsigned blocks = blocks_for(a.n_rows), threads = kWarpsPerBlock * 32;
  if (which == 0)
    gat_fwd_kernel<KT, V><<<blocks, threads, 0, s>>>(
        a.wh, a.a_src, a.a_dst, a.ptr, a.idx, a.n_rows, a.heads, a.channels,
        a.slope, g.P, g.LH, g.K, a.out0, a.out1, a.out2);
  else if (which == 1)
    gat_bwd_t_kernel<KT, V><<<blocks, threads, 0, s>>>(
        a.wh, a.a_src, a.a_dst, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, g.P, g.LH, g.K, a.out0, a.out1);
  else
    gat_bwd_f_kernel<KT, V><<<blocks, threads, 0, s>>>(
        a.wh, a.a_src, a.a_dst, a.m, a.g_o, a.g_d, a.ptr, a.idx, a.n_rows,
        a.heads, a.channels, a.slope, g.P, g.LH, g.K, a.out0);
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
  const bool pairs = a.channels % 2 == 0 && aligned8(a.wh) &&
                     aligned8(a.g_o) && aligned8(a.out0);
  if (g.K <= 4)
    launch<4>(which, a, g, pairs, s);
  else if (g.K <= 8)
    launch<8>(which, a, g, pairs, s);
  else if (g.K <= 10)
    launch<10>(which, a, g, pairs, s);
  else
    launch<16>(which, a, g, pairs, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The three kernels' lanes per edge, lanes per head and channels per lane
// for (heads, channels), in out[0..2]; cudaErrorInvalidValue if shape_ok
// refuses the shape.
int gat_edge_geometry(int heads, int channels, int* out) {
  if (!shape_ok(heads, channels)) return (int)cudaErrorInvalidValue;
  const EdgeGroups g = edge_groups(heads, channels);
  out[0] = g.P;
  out[1] = g.LH;
  out[2] = g.K;
  return 0;
}

// wh, o: [n_rows, heads*channels]; a_src, a_dst, d, m: [n_rows, heads];
// (heads, channels) as shape_ok takes them (checked by the caller): heads
// <= 32 and an edge group of at most 32 lanes, which reaches
// heads*channels = 512.
int gat_fwd(const float* wh, const float* a_src, const float* a_dst,
            const int* rowptr, const int* senders, int n_rows, int heads,
            int channels, float slope, float* o, float* d, float* m,
            void* stream) {
  const Args a{wh, a_src, a_dst, nullptr, nullptr, nullptr, rowptr, senders,
               n_rows, heads, channels, slope, o, d, m};
  return run(0, a, stream);
}

// (colptr, receivers): the transposed graph, sender-sorted.
int gat_bwd_t(const float* wh, const float* a_src, const float* a_dst,
              const float* m, const float* g_o, const float* g_d,
              const int* colptr, const int* receivers, int n_rows, int heads,
              int channels, float slope, float* d_wh, float* d_asrc,
              void* stream) {
  const Args a{wh, a_src, a_dst, m, g_o, g_d, colptr, receivers, n_rows,
               heads, channels, slope, d_wh, d_asrc, nullptr};
  return run(1, a, stream);
}

// (rowptr, senders): the forward graph, receiver-sorted.
int gat_bwd_f(const float* wh, const float* a_src, const float* a_dst,
              const float* m, const float* g_o, const float* g_d,
              const int* rowptr, const int* senders, int n_rows, int heads,
              int channels, float slope, float* d_adst, void* stream) {
  const Args a{wh, a_src, a_dst, m, g_o, g_d, rowptr, senders, n_rows, heads,
               channels, slope, d_adst, nullptr, nullptr};
  return run(2, a, stream);
}

}  // extern "C"
