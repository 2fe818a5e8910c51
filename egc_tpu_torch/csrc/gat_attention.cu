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
// leaky_relu and the addition of a_dst[r] are monotone (rounding included),
// so m_r = leaky_relu(max_s a_src[s] + a_dst[r]) bit for bit: the first
// sweep over a row reads only a_src.
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
// F-float row (wh forward, g_o or wh backward) and does ~2 flops per float
// against it, far below the ~20 flop/byte where f32 arithmetic would be
// the limit. What matters is that each gathered row is read with full
// coalesced sectors and that enough rows are in flight.
//
// Design. The TPU kernels streamed sender windows through VMEM over a
// sequential (receiver block x sender window) grid. Here one warp owns one
// output row of a CSR (receivers forward and for d_adst, senders of the
// transpose for gat_bwd_t), accumulates in registers, and writes the row
// once: no atomics, deterministic. In gat_fwd and gat_bwd_f lane l holds
// columns l + 32 k (k < NPL), so each gathered row is NPL coalesced
// warp-wide loads.
// - Forward: sweep 1 gives the per-head max; lane l takes head l % H and
//   every (32 / H)-th edge, and the lanes of one head meet in shared
//   memory. Sweep 2 walks the edges 32 at a time: lane j computes the H
//   softmax weights of edge j into shared memory (one exp per edge and
//   head), then the warp gathers the 32 rows and every lane reads the
//   weight of its columns' heads from there.
// - gat_bwd_f: the per-head dot q over C channels does not align with the
//   32-lane groups (C = 19: heads straddle lanes and chunks). A segmented
//   warp scan (5 shuffles, masks precomputed per lane) sums each head's
//   run of columns inside a chunk; the lane that ends a run adds it into a
//   per-head slot in shared memory. Lanes h < H then form de and dz for
//   head h.
// - gat_bwd_t takes the GATv2 kernels' edge groups (edge_groups.cuh). A
//   group of P lanes owns one out-edge, so a warp walks G = 32 / P edges
//   per step, and each lane holds K consecutive channels of one head: P =
//   16, G = 2, K = 10 at both arxiv shapes, two lanes per head (scalar
//   loads) at (H8, C19) and sixteen (float2) at (H1, C152). A cap of 20
//   channels per lane (P = 8, G = 4, K = 19 and 20, 118-122 registers) was
//   slower on an H100: 0.827 / 0.666 ms against 0.730 / 0.631. q is each
//   lane's K-term sum finished by log2(LH) xor-shuffles in the head's
//   aligned run, and every lane forms its own head's weight and dz: no
//   scan, no shared memory and no barrier in the edge loop. The receiver
//   index two steps ahead and the g_o row (with the receiver's a_dst, m
//   and g_d) one step ahead are issued before the current step's
//   arithmetic. At the end of the row the groups' d_wh and d_asrc meet by
//   xor-shuffles at lane offsets P, 2P, ..., 16, in that order, and group
//   0 writes them.
// - Empty rows write exact zeros (and m = -1e30): nothing is divided, so
//   no inf - inf or 0 / 0 can arise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "edge_groups.cuh"
#include "warp_rows.cuh"

namespace {

// Dynamic shared memory: per warp, [32][H] softmax weights and the row's
// a_dst[H] and m[H].
template <int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_fwd_kernel(const float* __restrict__ wh, const float* __restrict__ a_src,
               const float* __restrict__ a_dst,
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
  float* s_w = smem + warp * (34 * H);  // [32][H]
  float* s_adst = s_w + 32 * H;         // [H]
  float* s_m = s_adst + H;              // [H]
  const int start = rowptr[row];
  const int end = rowptr[row + 1];

  // sweep 1: per-head max of a_src over the row's senders
  const int slots = 32 / H;
  const int my_h = lane % H, my_slot = lane / H;
  float amax = -INFINITY;
  if (my_slot < slots)
    for (int e = start + my_slot; e < end; e += slots)
      amax = fmaxf(amax, __ldg(a_src + (size_t)__ldg(senders + e) * H + my_h));
  s_w[lane] = amax;
  __syncwarp();
  if (lane < H) {
    float mx = -INFINITY;
    for (int q = 0; q < slots; ++q) mx = fmaxf(mx, s_w[q * H + lane]);
    const float ad = __ldg(a_dst + (size_t)row * H + lane);
    s_adst[lane] = ad;
    s_m[lane] = end > start ? leaky(mx + ad, slope) : kEmptyMax;
  }
  __syncwarp();

  // sweep 2: weights of 32 edges at a time, then their rows
  int hk[NPL];
  float acc[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int col = lane + 32 * k;
    hk[k] = col < F ? col / channels : -1;
    acc[k] = 0.f;
  }
  float dsum = 0.f;  // lanes < H: denominator of head `lane`
  for (int base = start; base < end; base += 32) {
    const int cnt = min(32, end - base);
    int my_s = 0;
    if (lane < cnt) {
      my_s = __ldg(senders + base + lane);
      const float* as = a_src + (size_t)my_s * H;
      for (int h = 0; h < H; ++h)
        s_w[lane * H + h] =
            expf(leaky(__ldg(as + h) + s_adst[h], slope) - s_m[h]);
    }
    __syncwarp();
    if (lane < H)
      for (int j = 0; j < cnt; ++j) dsum += s_w[j * H + lane];
    for (int j = 0; j < cnt; ++j) {
      const int s = __shfl_sync(kFull, my_s, j);
      const float* src = wh + (size_t)s * F + lane;
      const float* wj = s_w + j * H;
#pragma unroll
      for (int k = 0; k < NPL; ++k)
        if (hk[k] >= 0) acc[k] = fmaf(wj[hk[k]], __ldg(src + 32 * k), acc[k]);
    }
    __syncwarp();  // s_w is rewritten by the next batch
  }
#pragma unroll
  for (int k = 0; k < NPL; ++k)
    if (hk[k] >= 0) o[(size_t)row * F + lane + 32 * k] = acc[k];
  if (lane < H) {
    d[(size_t)row * H + lane] = dsum;
    m_out[(size_t)row * H + lane] = s_m[lane];
  }
}

// gat_bwd_f: the row is a receiver r, the walk over its in-edges (CSR).
// Dynamic shared memory: per warp, the H per-head dots q.
template <int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_f_kernel(const float* __restrict__ wh,
                 const float* __restrict__ a_src,
                 const float* __restrict__ a_dst, const float* __restrict__ m,
                 const float* __restrict__ g_o, const float* __restrict__ g_d,
                 const int* __restrict__ rowptr,
                 const int* __restrict__ senders, int n_rows, int heads,
                 int channels, float slope, float* __restrict__ d_adst) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n_rows) return;
  const int H = heads, F = heads * channels;
  float* s_q = smem + warp * H;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];

  // the row's own g_o[r]; the gathered neighbour rows are wh[s]
  const float* own = g_o + (size_t)row * F;
  int hk[NPL];
  unsigned scan_mask[NPL];  // bit i: the lane 2^i below is in my head
  bool run_end[NPL];        // my column ends its head's run in the chunk
  float ov[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int col = lane + 32 * k;
    const bool valid = col < F;
    hk[k] = valid ? col / channels : -1;
    ov[k] = valid ? own[col] : 0.f;
    scan_mask[k] = 0u;
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if (valid && lane >= (1 << i) && (col - (1 << i)) / channels == hk[k])
        scan_mask[k] |= 1u << i;
    run_end[k] = valid && (lane == 31 || col + 1 >= F ||
                           (col + 1) / channels != hk[k]);
  }
  // lanes < H: the row's own per-head scalars of head `lane`
  float own_adst = 0.f, own_m = 0.f, own_gd = 0.f;
  if (lane < H) {
    const size_t o = (size_t)row * H + lane;
    own_adst = __ldg(a_dst + o);
    own_m = __ldg(m + o);
    own_gd = __ldg(g_d + o);
    s_q[lane] = 0.f;
  }
  __syncwarp();
  float hsum = 0.f;  // lanes < H: sum of dz of head `lane`
  for (int base = start; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int my_nb = lane < cnt ? __ldg(senders + base + lane) : 0;
    for (int j = 0; j < cnt; ++j) {
      const int nb = __shfl_sync(kFull, my_nb, j);
      // lanes < H: this edge's logit and softmax weight for head `lane`
      float z = 0.f, w = 0.f;
      if (lane < H) {
        z = __ldg(a_src + (size_t)nb * H + lane) + own_adst;
        w = expf(leaky(z, slope) - own_m);
      }
      const float* nrow = wh + (size_t)nb * F + lane;
      float gv[NPL];
#pragma unroll
      for (int k = 0; k < NPL; ++k)
        gv[k] = hk[k] >= 0 ? __ldg(nrow + 32 * k) : 0.f;
      // q: segmented scan of the products over each head's columns
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        float v = ov[k] * gv[k];
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float t = __shfl_up_sync(kFull, v, 1 << i);
          if (scan_mask[k] & (1u << i)) v += t;
        }
        if (run_end[k]) s_q[hk[k]] += v;
        __syncwarp();
      }
      if (lane < H) {
        const float de = w * (s_q[lane] + own_gd);
        hsum += z >= 0.f ? de : slope * de;
        s_q[lane] = 0.f;
      }
      __syncwarp();
    }
  }
  if (lane < H) d_adst[(size_t)row * H + lane] = hsum;
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

// Columns per lane for a row of f floats: 2, 5 or 8 (f <= 256).
inline int per_lane(int f) { return f <= 64 ? 2 : f <= 160 ? 5 : 8; }

template <int NPL>
void launch_fwd(const float* wh, const float* a_src, const float* a_dst,
                const int* rowptr, const int* senders, int n_rows, int heads,
                int channels, float slope, float* o, float* d, float* m,
                cudaStream_t s) {
  const size_t shm = sizeof(float) * kWarpsPerBlock * 34 * heads;
  gat_fwd_kernel<NPL><<<blocks_for(n_rows), kWarpsPerBlock * 32, shm, s>>>(
      wh, a_src, a_dst, rowptr, senders, n_rows, heads, channels, slope, o,
      d, m);
}

template <int NPL>
void launch_bwd_f(const float* wh, const float* a_src, const float* a_dst,
                  const float* m, const float* g_o, const float* g_d,
                  const int* rowptr, const int* senders, int n_rows,
                  int heads, int channels, float slope, float* d_adst,
                  cudaStream_t s) {
  const size_t shm = sizeof(float) * kWarpsPerBlock * heads;
  gat_bwd_f_kernel<NPL><<<blocks_for(n_rows), kWarpsPerBlock * 32, shm, s>>>(
      wh, a_src, a_dst, m, g_o, g_d, rowptr, senders, n_rows, heads,
      channels, slope, d_adst);
}

template <int KT>
void launch_bwd_t(bool pairs, const float* wh, const float* a_src,
                  const float* a_dst, const float* m, const float* g_o,
                  const float* g_d, const int* colptr, const int* receivers,
                  int n_rows, int heads, int channels, float slope,
                  const EdgeGroups& g, float* d_wh, float* d_asrc,
                  cudaStream_t s) {
  auto kernel = pairs ? gat_bwd_t_kernel<KT, 2> : gat_bwd_t_kernel<KT, 1>;
  kernel<<<blocks_for(n_rows), kWarpsPerBlock * 32, 0, s>>>(
      wh, a_src, a_dst, m, g_o, g_d, colptr, receivers, n_rows, heads,
      channels, slope, g.P, g.LH, g.K, d_wh, d_asrc);
}

inline bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

}  // namespace

extern "C" {

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// wh, o: [n_rows, heads*channels]; a_src, a_dst, d, m: [n_rows, heads];
// heads <= 32 and heads*channels <= 256 (checked by the caller).
int gat_fwd(const float* wh, const float* a_src, const float* a_dst,
            const int* rowptr, const int* senders, int n_rows, int heads,
            int channels, float slope, float* o, float* d, float* m,
            void* stream) {
  if (!shape_ok(heads, channels)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (per_lane(heads * channels)) {
    case 2:
      launch_fwd<2>(wh, a_src, a_dst, rowptr, senders, n_rows, heads,
                    channels, slope, o, d, m, s);
      break;
    case 5:
      launch_fwd<5>(wh, a_src, a_dst, rowptr, senders, n_rows, heads,
                    channels, slope, o, d, m, s);
      break;
    default:
      launch_fwd<8>(wh, a_src, a_dst, rowptr, senders, n_rows, heads,
                    channels, slope, o, d, m, s);
  }
  return (int)cudaGetLastError();
}

// gat_bwd_t's lanes per edge, lanes per head and channels per lane for
// (heads, channels), in out[0..2]; cudaErrorInvalidValue if shape_ok
// refuses the shape.
int gat_edge_geometry(int heads, int channels, int* out) {
  if (!shape_ok(heads, channels)) return (int)cudaErrorInvalidValue;
  const EdgeGroups g = edge_groups(heads, channels);
  out[0] = g.P;
  out[1] = g.LH;
  out[2] = g.K;
  return 0;
}

// (colptr, receivers): the transposed graph, sender-sorted.
int gat_bwd_t(const float* wh, const float* a_src, const float* a_dst,
              const float* m, const float* g_o, const float* g_d,
              const int* colptr, const int* receivers, int n_rows, int heads,
              int channels, float slope, float* d_wh, float* d_asrc,
              void* stream) {
  if (!shape_ok(heads, channels)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const EdgeGroups g = edge_groups(heads, channels);
  // float2 loads: C even (so every lane's run starts on an even column)
  // and 8-byte aligned rows
  const bool pairs = channels % 2 == 0 && aligned8(wh) && aligned8(g_o) &&
                     aligned8(d_wh);
  if (g.K <= 4)
    launch_bwd_t<4>(pairs, wh, a_src, a_dst, m, g_o, g_d, colptr, receivers,
                    n_rows, heads, channels, slope, g, d_wh, d_asrc, s);
  else if (g.K <= 8)
    launch_bwd_t<8>(pairs, wh, a_src, a_dst, m, g_o, g_d, colptr, receivers,
                    n_rows, heads, channels, slope, g, d_wh, d_asrc, s);
  else if (g.K <= 10)
    launch_bwd_t<10>(pairs, wh, a_src, a_dst, m, g_o, g_d, colptr,
                     receivers, n_rows, heads, channels, slope, g, d_wh,
                     d_asrc, s);
  else
    launch_bwd_t<16>(pairs, wh, a_src, a_dst, m, g_o, g_d, colptr,
                     receivers, n_rows, heads, channels, slope, g, d_wh,
                     d_asrc, s);
  return (int)cudaGetLastError();
}

// (rowptr, senders): the forward graph, receiver-sorted.
int gat_bwd_f(const float* wh, const float* a_src, const float* a_dst,
              const float* m, const float* g_o, const float* g_d,
              const int* rowptr, const int* senders, int n_rows, int heads,
              int channels, float slope, float* d_adst, void* stream) {
  if (!shape_ok(heads, channels)) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (per_lane(heads * channels)) {
    case 2:
      launch_bwd_f<2>(wh, a_src, a_dst, m, g_o, g_d, rowptr, senders, n_rows,
                      heads, channels, slope, d_adst, s);
      break;
    case 5:
      launch_bwd_f<5>(wh, a_src, a_dst, m, g_o, g_d, rowptr, senders, n_rows,
                      heads, channels, slope, d_adst, s);
      break;
    default:
      launch_bwd_f<8>(wh, a_src, a_dst, m, g_o, g_d, rowptr, senders, n_rows,
                      heads, channels, slope, d_adst, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
