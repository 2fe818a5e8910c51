// Fused gather + multi-aggregator segment reduction, forward and backward,
// for NVIDIA Hopper (sm_90a).
//
// gather_reduce_fwd replaces egc_tpu/ops/pallas/gather_reduce.py
// `windowed_gather_reduce` (bodies `_windowed_kernel`,
// `_windowed_kernel_wide`): for every receiver r, over its in-edges s -> r,
//     sum   = sum_s x_s          wsum = sum_s w_e x_s     sumsq = sum_s x_s^2
//     max   = max_s x_s          min  = min_s x_s
// with 0 for an empty receiver, max and min included. Asked for them, it
// also writes the extremum masks: for every edge s -> r and feature f one
// bit, x_s[f] == max_r[f] (and x_s[f] == min_r[f]) under float comparison.
//
// gather_reduce_bwd replaces `windowed_gather_reduce_bwd` (bodies
// `_windowed_bwd_kernel`, `_windowed_bwd_kernel_wide`): for every sender s,
// over its out-edges s -> r,
//     d[s] = sum_r c_sum[r] + w_e c_wsum[r] + x_s c_sumsq2[r]
//            + [x_s == max_r] c_max[r] + [x_s == min_r] c_min[r]
// with the brackets read from the masks. The TPU kernel gathered mx and mn
// packed beside the coefficients and tested x_s >= mx; since x_s <= mx that
// is the same predicate, so every edge that attains the extremum gets the
// full cotangent, as there.
//
// What bounds them on an H100: device-memory bytes. Each edge moves whole
// F-float rows (the sender's values forward, the receiver's coefficients
// backward) against a handful of flops per float, far below the ~20
// flop/byte where f32 arithmetic would be the limit. The gathers are random
// rows, so what matters is that each row is read in full 16-byte sectors,
// that enough rows are in flight, and that an edge gathers as few bytes as
// it can: the backward reads c_max[r] only where a bit says this edge holds
// the maximum, about 1 feature in the mean in-degree, and the mask beside
// it is 1 bit a feature, streamed.
//
// Design. The TPU kernel streamed sender windows through VMEM over a
// (receiver block x sender window) grid because its grid runs in order on
// one core. Here the layout is a plain CSR: the forward walks a
// receiver-sorted edge list (rowptr, senders), the backward a sender-sorted
// one of the transposed graph (colptr, receivers), both built on the host
// (egc_tpu_torch/ops/dispatch.py), with fwd_to_bwd giving each CSR edge's
// position in the CSC order. A group of lanes owns one output row: each
// lane holds VEC consecutive floats (VEC = 4 when F % 4 == 0: one 16-byte
// load per row gathered, a 128-wide row one warp-wide 512-byte read; else
// 1), the group loads one edge index and weight a lane at a time with one
// coalesced read and broadcasts them by shuffle, and every requested
// primitive accumulates in registers. Each output row is written once, with
// no atomics, so results are deterministic and each column adds its edges
// one by one in CSR order (CSC order backward), whatever the geometry.
//
// The lane geometry follows F (`split_col`, mirrored by
// ops/cuda/gather_reduce.py `lane_geometry`). At VEC 4, a row's columns
// up to split_col walk in chunks of 128, one warp a row and one walk of the
// row's edges a chunk; the rest, a tail of at most 16 float4 slots, walks
// in split groups: a warp holds 32 / P rows of P lanes each, P the power
// of two >= the tail's slots, so F 64 keeps no half warp idle and the 8
// columns past 128 at F 136 take 2 lanes of 16 rows, not 2 lanes of a
// whole warp's walk. Each group walks its own row's edges; the warp walks
// as long as its longest row, and a group past its row's end (or without
// a row) takes part in the shuffles only. A tail of 17 to 31 slots, and
// every row at VEC 1, walks as one more chunk. Each pass keeps one
// chunk's state a lane, so registers, and the warps an SM holds, stay
// those of one chunk.
//
// The mask (mask_words): for each chunk of 32 * VEC columns, VEC 32-bit
// words per edge; bit l of word i is column chunk * 32 * VEC + l * VEC + i,
// so lane l owns bit l of every word of its chunk (in a split group, l is
// the lane's place in its group). Words are stored in CSC order (at
// fwd_to_bwd[e]), so the backward streams them and takes its lane's bits
// of edge j from lane j of its group by shuffle. The forward records them
// in its one pass over a chunk's edges: each lane keeps, per column, the
// CSR offset of the first edge that reached the running extremum and a
// tie flag (set when a later edge equals it, cleared when a better one
// arrives). Where no tie is left that edge alone holds the extremum, and
// its lane ORs its bit into the edge's word in shared memory; a lane with
// a tied column reloads its columns of the row's in-edges once more and
// compares them with the final extremum. Any degree is exact. What the
// mask costs the forward (PERF.md §6): the record's compares and the
// scattered 16-byte stores, about a third on top of its time without the
// mask.
//
// Each forward instantiation computes only the primitives its template
// names (sumsq, max, min: registers are what limit the warps in flight);
// the backward's likewise (sumsq and each mask).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSum = 1, kWsum = 2, kSumsq = 4, kMax = 8, kMin = 16;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// The one rule of the lane width and the mask layout (mirrored by
// ops/cuda/gather_reduce.py `lane_vec` and `mask_words`).
inline int lane_vec(int f) { return f % 4 == 0 ? 4 : 1; }

__host__ __device__ inline int mask_words_at(int vec, int f) {
  return (f + 32 * vec - 1) / (32 * vec) * vec;
}

inline int mask_words(int f) { return mask_words_at(lane_vec(f), f); }

// The lane geometry (see the head of this file; mirrored by
// ops/cuda/gather_reduce.py `lane_geometry`): the first column of the
// split tail (f where there is none), and the tail's lanes a row.
inline int split_col(int f) {
  if (lane_vec(f) != 4) return f;
  const int tail = f / 4 % 32;   // float4 slots past the last full chunk
  return tail == 0 || tail > 16 ? f : f - 4 * tail;
}

inline int split_lanes(int f) {
  int p = 1;
  while (4 * p < f - split_col(f)) p *= 2;
  return p;
}

enum Geometry { kChunks = 0, kSplit = 1 };

// The columns [col0, col_end) of one pass, walked in one geometry.
struct FwdIn {
  const float* vals;
  const int* rowptr;
  const int* senders;
  const float* edge_w;
  const int* fwd_to_bwd;   // [E]: CSC position of each CSR edge
  int n_rows, f, prims, lanes, col0, col_end;
};

struct FwdOut {
  float* sum;
  float* wsum;
  float* sumsq;
  float* max;
  float* min;
  uint32_t* max_mask;   // [E, mask_words(f)] in CSC order, or null
  uint32_t* min_mask;
};

// The backward's arguments: each coefficient [rows, F] (null when absent),
// the masks of the forward, the CSC, the output and the pass's columns.
struct BwdIn {
  const float* c_sum;
  const float* c_wsum;
  const float* c_sumsq2;
  const float* c_max;
  const float* c_min;
  const uint32_t* max_mask;
  const uint32_t* min_mask;
  const float* vals;   // [n_rows, F], read with c_sumsq2 only
  const int* colptr;
  const int* receivers;
  const float* edge_w;
  int n_rows, f, lanes, col0, col_end;
  float* d_vals;
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
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) w[i] = __ldg(p + i);
  }
}

template <int VEC>
__device__ __forceinline__ void store_words(uint32_t* p,
                                            const uint32_t (&w)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = w[i];
  }
}

// The bits of lane l of a group of `lanes` in the VEC words of edge j
// (held by lane j of the group), bit i for the lane's column i.
template <int VEC>
__device__ __forceinline__ unsigned lane_bits(const uint32_t (&w)[VEC],
                                              int j, int l, int lanes) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    bits |= ((__shfl_sync(kFull, w[i], j, lanes) >> l) & 1u) << i;
  return bits;
}

// Where a lane sits: its row (has_row false for a split group past the
// last row), its place l in the row's group of `lanes`, the row's edges
// [start, end), and `span`, the edge walk's length, the same in every lane
// of the warp (in the split geometry, the longest row of the warp's).
struct Place {
  int row, l, lanes, start, end, span;
  bool has_row;
};

// False for a warp past the last row, which then exits whole.
template <int GEOM>
__device__ __forceinline__ bool place(const int* ptr, int n_rows,
                                      int lanes, Place& p) {
  const int lane = threadIdx.x & 31;
  p.lanes = GEOM == kSplit ? lanes : 32;
  const int first = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
                    (32 / p.lanes);
  if (first >= n_rows) return false;
  p.l = lane & (p.lanes - 1);
  p.row = first + lane / p.lanes;
  p.has_row = GEOM != kSplit || p.row < n_rows;
  p.start = p.has_row ? ptr[p.row] : 0;
  p.end = p.has_row ? ptr[p.row + 1] : 0;
  p.span = GEOM == kSplit ? __reduce_max_sync(kFull, p.end - p.start)
                          : p.end - p.start;
  return true;
}

// Running extremum of one lane's columns with its mask record: per column,
// the first CSR edge at the running extremum and whether a later edge tied
// it (set by an equal value, cleared by a better one). Where no tie is
// left, that edge alone holds the extremum.
template <int VEC>
struct Extremum {
  float ext[VEC];
  int first[VEC];
  bool tied[VEC];
};

template <int VEC, bool IS_MAX, bool RECORD>
__device__ __forceinline__ void extremum_init(Extremum<VEC>& x) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    x.ext[i] = IS_MAX ? -INFINITY : INFINITY;
    if constexpr (RECORD) { x.first[i] = -1; x.tied[i] = false; }
  }
}

template <int VEC, bool IS_MAX, bool RECORD>
__device__ __forceinline__ void extremum_add(Extremum<VEC>& x,
                                             const float (&v)[VEC], int e) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float old = x.ext[i];
    x.ext[i] = IS_MAX ? fmaxf(old, v[i]) : fminf(old, v[i]);
    if constexpr (RECORD) {
      const bool better = IS_MAX ? v[i] > old : v[i] < old;
      x.first[i] = better ? e : x.first[i];
      x.tied[i] = !better && (x.tied[i] || v[i] == old);
    }
  }
}

// The mask words of a row's in-edges [p.start, p.end) for one chunk,
// written at fwd_to_bwd[e] (pos0: lane l's of edge start + l, loaded with
// the first batch of senders). Per batch of p.lanes edges, the group's
// words sit in shared memory (`words_s`, p.lanes * VEC words): each lane
// ORs its bit into the word of the edge its record names, for every column
// not tied; a lane with tied columns reloads its columns of the batch's
// edges and ORs a bit wherever a tied column equals the final extremum.
// Lane j then stores edge base + j's words.
template <int VEC>
__device__ __forceinline__ void write_mask(
    uint32_t* mask, uint32_t* words_s, const int* __restrict__ fwd_to_bwd,
    const int* __restrict__ senders, const float* __restrict__ vals,
    const Place& p, int f, int col, int words, int chunk, bool active,
    const Extremum<VEC>& x, int pos0) {
  unsigned tie = 0u;   // bit i: column i's extremum is tied
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    tie |= (active && x.tied[i] ? 1u : 0u) << i;
  const bool resweep = __any_sync(kFull, tie != 0u);
  for (int k = 0; k < p.span; k += p.lanes) {
    const int base = p.start + k;
    const int e = base + p.l;
    const int cnt = min(p.lanes, p.end - base);   // <= 0 past the row
    int my_pos = pos0, my_src = 0;
    if (e < p.end) {
      if (k != 0) my_pos = __ldg(fwd_to_bwd + e);
      if (resweep) my_src = __ldg(senders + e);
    }
    uint32_t mine[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) mine[i] = 0u;
    store_words<VEC>(words_s + p.l * VEC, mine);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int a = x.first[i] - base;
      if (active && !((tie >> i) & 1u) && a >= 0 && a < cnt)
        atomicOr(words_s + a * VEC + i, 1u << p.l);
    }
    if (resweep) {
      const int batch = min(p.lanes, p.span - k);
      for (int j = 0; j < batch; ++j) {
        const int src = __shfl_sync(kFull, my_src, j, p.lanes);
        if (tie == 0u || j >= cnt) continue;
        float v[VEC];
        load_vec<VEC>(vals + (size_t)src * f + col, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          if (((tie >> i) & 1u) && v[i] == x.ext[i])
            atomicOr(words_s + j * VEC + i, 1u << p.l);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < VEC; ++i) mine[i] = words_s[p.l * VEC + i];
    __syncwarp();   // read before the next batch clears them
    if (p.l < cnt)
      store_words<VEC>(mask + (size_t)my_pos * words + chunk * VEC, mine);
  }
}

// Blocks of the forward an SM must hold, which bounds its registers. ptxas
// left to itself caps some of the masked instantiations at 48 registers
// and spills; a recorded extremum alone fits 48 (5 blocks), and with
// sumsq or both extrema the lane's state takes up to 64 (4 blocks), in
// either geometry.
constexpr int fwd_min_blocks(bool sq, int maxs, int mins) {
  return maxs != 2 && mins != 2 ? 1 : (sq || (maxs && mins) ? 4 : 5);
}

// Compile-time primitives: SQ computes sumsq; MAXS and MINS are 0 (not
// computed), 1 (computed) or 2 (computed, and its mask written). sum and
// wsum are always accumulated and stored as `prims` says. GEOM is the
// pass's lane geometry.
template <int VEC, int GEOM, bool SQ, int MAXS, int MINS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  fwd_min_blocks(SQ, MAXS, MINS))
gather_reduce_fwd_kernel(FwdIn in, FwdOut out) {
  constexpr bool kMaxRec = MAXS == 2, kMinRec = MINS == 2;
  constexpr bool kMasks = kMaxRec || kMinRec;
  const float* __restrict__ vals = in.vals;
  const int* __restrict__ senders = in.senders;
  const int f = in.f, prims = in.prims;
  Place p;
  if (!place<GEOM>(in.rowptr, in.n_rows, in.lanes, p)) return;
  const bool has_w = (prims & kWsum) != 0;
  const int words = mask_words_at(VEC, f);

  for (int c0 = in.col0; c0 < in.col_end; c0 += 32 * VEC) {
    const int chunk = c0 / (32 * VEC);
    const int col = c0 + p.l * VEC;
    const bool active = p.has_row && col < in.col_end;
    float s[VEC], ws[VEC], sq[VEC];
    Extremum<VEC> mx, mn;
#pragma unroll
    for (int i = 0; i < VEC; ++i) { s[i] = 0.f; ws[i] = 0.f; sq[i] = 0.f; }
    extremum_init<VEC, true, kMaxRec>(mx);
    extremum_init<VEC, false, kMinRec>(mn);
    int pos0 = 0;   // fwd_to_bwd of edge start + l, for write_mask
    for (int k = 0; k < p.span; k += p.lanes) {
      const int e = p.start + k + p.l;
      int my_src = 0;
      float my_w = 0.f;
      if (e < p.end) {
        my_src = __ldg(senders + e);
        if (has_w) my_w = __ldg(in.edge_w + e);
        if (kMasks && k == 0) pos0 = __ldg(in.fwd_to_bwd + e);
      }
      const int cnt = min(p.lanes, p.span - k);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int src = __shfl_sync(kFull, my_src, j, p.lanes);
        const float w = __shfl_sync(kFull, my_w, j, p.lanes);
        if (!active || (GEOM == kSplit && p.start + k + j >= p.end))
          continue;
        float v[VEC];
        load_vec<VEC>(vals + (size_t)src * f + col, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s[i] += v[i];
          ws[i] = fmaf(v[i], w, ws[i]);
          if constexpr (SQ) sq[i] = fmaf(v[i], v[i], sq[i]);
        }
        if constexpr (MAXS != 0)
          extremum_add<VEC, true, kMaxRec>(mx, v, p.start + k + j);
        if constexpr (MINS != 0)
          extremum_add<VEC, false, kMinRec>(mn, v, p.start + k + j);
      }
    }
    if constexpr (kMasks) {   // every lane of the warp takes part
      __shared__ __align__(16) uint32_t words_s[kWarpsPerBlock][32 * VEC];
      // the group's words: lane (lane - l) * VEC on
      uint32_t* group_s = words_s[threadIdx.x >> 5] +
                          ((threadIdx.x & 31) - p.l) * VEC;
      if constexpr (kMaxRec)
        write_mask<VEC>(out.max_mask, group_s, in.fwd_to_bwd, senders, vals,
                        p, f, col, words, chunk, active, mx, pos0);
      if constexpr (kMinRec)
        write_mask<VEC>(out.min_mask, group_s, in.fwd_to_bwd, senders, vals,
                        p, f, col, words, chunk, active, mn, pos0);
    }
    if (!active) continue;
    const size_t o = (size_t)p.row * f + col;
    if (p.end == p.start) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) { mx.ext[i] = 0.f; mn.ext[i] = 0.f; }
    }
    if (prims & kSum) store_vec<VEC>(out.sum + o, s);
    if (prims & kWsum) store_vec<VEC>(out.wsum + o, ws);
    if constexpr (SQ) store_vec<VEC>(out.sumsq + o, sq);
    if constexpr (MAXS != 0) store_vec<VEC>(out.max + o, mx.ext);
    if constexpr (MINS != 0) store_vec<VEC>(out.min + o, mn.ext);
  }
}

// Blocks of the backward an SM must hold: none asked for in the chunks
// geometry. Left to itself, ptxas gives a split group's walk 54 to 72
// registers (4 blocks or fewer); 5 blocks (48 registers) run faster at
// F 64 (exp/kernel_ab.py), 4 with sumsq, which spills at 48.
constexpr int bwd_min_blocks(int geom, bool sumsq) {
  return geom != kSplit ? 1 : sumsq ? 4 : 5;
}

// SUMSQ: c_sumsq2 is present (and vals read); MASKS: bit 0 c_max with
// max_mask, bit 1 c_min with min_mask. c_sum and c_wsum are runtime.
template <int VEC, int GEOM, bool SUMSQ, int MASKS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  bwd_min_blocks(GEOM, SUMSQ))
gather_reduce_bwd_kernel(BwdIn in) {
  constexpr bool kMaxM = (MASKS & 1) != 0, kMinM = (MASKS & 2) != 0;
  const int f = in.f;
  Place p;
  if (!place<GEOM>(in.colptr, in.n_rows, in.lanes, p)) return;
  const bool has_w = in.c_wsum != nullptr;
  const int words = mask_words_at(VEC, f);

  for (int c0 = in.col0; c0 < in.col_end; c0 += 32 * VEC) {
    const int chunk = c0 / (32 * VEC);
    const int col = c0 + p.l * VEC;
    const bool active = p.has_row && col < in.col_end;
    float v[VEC], acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) { v[i] = 0.f; acc[i] = 0.f; }
    if constexpr (SUMSQ)
      if (active) load_vec<VEC>(in.vals + (size_t)p.row * f + col, v);
    for (int k = 0; k < p.span; k += p.lanes) {
      const int e = p.start + k + p.l;
      int my_r = 0;
      float my_w = 0.f;
      uint32_t my_mx[VEC], my_mn[VEC];   // edge e's words of this chunk
#pragma unroll
      for (int i = 0; i < VEC; ++i) { my_mx[i] = 0u; my_mn[i] = 0u; }
      if (e < p.end) {
        my_r = __ldg(in.receivers + e);
        if (has_w) my_w = __ldg(in.edge_w + e);
        const size_t wo = (size_t)e * words + chunk * VEC;
        if constexpr (kMaxM) load_words<VEC>(in.max_mask + wo, my_mx);
        if constexpr (kMinM) load_words<VEC>(in.min_mask + wo, my_mn);
      }
      const int cnt = min(p.lanes, p.span - k);
#pragma unroll 2
      for (int j = 0; j < cnt; ++j) {
        const int r = __shfl_sync(kFull, my_r, j, p.lanes);
        const float w = __shfl_sync(kFull, my_w, j, p.lanes);
        unsigned bmx = 0u, bmn = 0u;
        if constexpr (kMaxM) bmx = lane_bits<VEC>(my_mx, j, p.l, p.lanes);
        if constexpr (kMinM) bmn = lane_bits<VEC>(my_mn, j, p.l, p.lanes);
        if (!active || (GEOM == kSplit && p.start + k + j >= p.end))
          continue;
        const size_t o = (size_t)r * f + col;
        float contrib[VEC], t[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) contrib[i] = 0.f;
        if (in.c_sum) {
          load_vec<VEC>(in.c_sum + o, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i) contrib[i] += t[i];
        }
        if (has_w) {
          load_vec<VEC>(in.c_wsum + o, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i) contrib[i] += t[i] * w;
        }
        if constexpr (SUMSQ) {
          load_vec<VEC>(in.c_sumsq2 + o, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i) contrib[i] += t[i] * v[i];
        }
        if constexpr (kMaxM) {   // c_max[r] only where this edge holds it
#pragma unroll
          for (int i = 0; i < VEC; ++i) t[i] = 0.f;
          if (bmx) load_vec<VEC>(in.c_max + o, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            contrib[i] += ((bmx >> i) & 1u) ? t[i] : 0.f;
        }
        if constexpr (kMinM) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) t[i] = 0.f;
          if (bmn) load_vec<VEC>(in.c_min + o, t);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            contrib[i] += ((bmn >> i) & 1u) ? t[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += contrib[i];
      }
    }
    if (active) store_vec<VEC>(in.d_vals + (size_t)p.row * f + col, acc);
  }
}

// Blocks of kWarpsPerBlock warps, each warp 32 / lanes rows.
inline unsigned blocks_for(int n_rows, int lanes) {
  const int rows = kWarpsPerBlock * (32 / lanes);
  return (unsigned)((n_rows + rows - 1) / rows);
}

using FwdLaunch = void (*)(const FwdIn&, const FwdOut&, cudaStream_t);

template <int VEC, int GEOM, bool SQ, int MAXS, int MINS>
void launch_fwd(const FwdIn& in, const FwdOut& out, cudaStream_t s) {
  const dim3 grid(blocks_for(in.n_rows, in.lanes));
  const dim3 block(kWarpsPerBlock * 32);
  gather_reduce_fwd_kernel<VEC, GEOM, SQ, MAXS, MINS>
      <<<grid, block, 0, s>>>(in, out);
}

// The instantiation for (sq, maxs, mins), maxs and mins each 0, 1 or 2 as
// in the kernel.
template <int VEC, int GEOM, bool SQ, int MAXS>
FwdLaunch fwd_launcher(int mins) {
  return mins == 0   ? launch_fwd<VEC, GEOM, SQ, MAXS, 0>
         : mins == 1 ? launch_fwd<VEC, GEOM, SQ, MAXS, 1>
                     : launch_fwd<VEC, GEOM, SQ, MAXS, 2>;
}

template <int VEC, int GEOM, bool SQ>
FwdLaunch fwd_launcher(int maxs, int mins) {
  return maxs == 0   ? fwd_launcher<VEC, GEOM, SQ, 0>(mins)
         : maxs == 1 ? fwd_launcher<VEC, GEOM, SQ, 1>(mins)
                     : fwd_launcher<VEC, GEOM, SQ, 2>(mins);
}

template <int VEC, int GEOM>
FwdLaunch fwd_launcher(bool sq, int maxs, int mins) {
  return sq ? fwd_launcher<VEC, GEOM, true>(maxs, mins)
            : fwd_launcher<VEC, GEOM, false>(maxs, mins);
}

template <int VEC, int GEOM, bool SUMSQ, int MASKS>
void launch_bwd(const BwdIn& in, cudaStream_t s) {
  const dim3 grid(blocks_for(in.n_rows, in.lanes));
  const dim3 block(kWarpsPerBlock * 32);
  gather_reduce_bwd_kernel<VEC, GEOM, SUMSQ, MASKS>
      <<<grid, block, 0, s>>>(in);
}

using BwdLaunch = void (*)(const BwdIn&, cudaStream_t);

template <int VEC, int GEOM>
BwdLaunch bwd_launcher(bool sumsq, int masks) {
  static const BwdLaunch launch[2][4] = {
      {launch_bwd<VEC, GEOM, false, 0>, launch_bwd<VEC, GEOM, false, 1>,
       launch_bwd<VEC, GEOM, false, 2>, launch_bwd<VEC, GEOM, false, 3>},
      {launch_bwd<VEC, GEOM, true, 0>, launch_bwd<VEC, GEOM, true, 1>,
       launch_bwd<VEC, GEOM, true, 2>, launch_bwd<VEC, GEOM, true, 3>}};
  return launch[sumsq][masks];
}

}  // namespace

extern "C" {

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// 32-bit mask words per edge at width f (ops/cuda/gather_reduce.py
// `mask_words` holds its own copy of the rule against this one).
int gather_reduce_mask_words(int f) { return mask_words(f); }

// The lane geometry at width f: 0 chunks alone, 1 a split pass alone,
// 2 chunks then a split tail (ops/cuda/gather_reduce.py `lane_geometry`
// holds its own copy of the rule against this one).
int gather_reduce_geometry(int f) {
  const int split = split_col(f);
  return split == f ? 0 : split == 0 ? 1 : 2;
}

// vals and the outputs: 16-byte aligned when f % 4 == 0. max_mask and
// min_mask ([E, mask_words(f)], CSC order through fwd_to_bwd) are written
// when not null, and need kMax / kMin in prims. The chunks and the split
// tail are one launch each.
int gather_reduce_fwd(const float* vals, const int* rowptr,
                      const int* senders, const float* edge_w,
                      const int* fwd_to_bwd, int n_rows, int f, int prims,
                      float* out_sum, float* out_wsum, float* out_sumsq,
                      float* out_max, float* out_min, uint32_t* max_mask,
                      uint32_t* min_mask, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if ((max_mask && !(prims & kMax)) || (min_mask && !(prims & kMin)) ||
      ((max_mask || min_mask) && !fwd_to_bwd))
    return (int)cudaErrorInvalidValue;
  const FwdOut out{out_sum, out_wsum, out_sumsq, out_max, out_min, max_mask,
                   min_mask};
  const int maxs = (prims & kMax) ? (max_mask ? 2 : 1) : 0;
  const int mins = (prims & kMin) ? (min_mask ? 2 : 1) : 0;
  const bool sq = (prims & kSumsq) != 0;
  const int split = split_col(f);
  cudaStream_t s = (cudaStream_t)stream;
  if (split > 0) {
    const FwdIn in{vals, rowptr, senders, edge_w, fwd_to_bwd, n_rows, f,
                   prims, 32, 0, split};
    (lane_vec(f) == 4 ? fwd_launcher<4, kChunks>(sq, maxs, mins)
                      : fwd_launcher<1, kChunks>(sq, maxs, mins))(in, out, s);
  }
  if (split < f) {
    const FwdIn in{vals, rowptr, senders, edge_w, fwd_to_bwd, n_rows, f,
                   prims, split_lanes(f), split, f};
    fwd_launcher<4, kSplit>(sq, maxs, mins)(in, out, s);
  }
  return (int)cudaGetLastError();
}

// Coefficients [coefficient rows, f] each, null when absent; c_max needs
// max_mask and c_min min_mask; vals [n_rows, f] is read only with
// c_sumsq2, edge_w only with c_wsum. The same alignment and passes as the
// forward.
int gather_reduce_bwd(const float* c_sum, const float* c_wsum,
                      const float* c_sumsq2, const float* c_max,
                      const float* c_min, const uint32_t* max_mask,
                      const uint32_t* min_mask, const float* vals,
                      const int* colptr, const int* receivers,
                      const float* edge_w, int n_rows, int f, float* d_vals,
                      void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if ((c_max != nullptr) != (max_mask != nullptr) ||
      (c_min != nullptr) != (min_mask != nullptr) ||
      (c_sumsq2 && !vals) || (c_wsum && !edge_w))
    return (int)cudaErrorInvalidValue;
  const int masks = (max_mask ? 1 : 0) | (min_mask ? 2 : 0);
  const bool sumsq = c_sumsq2 != nullptr;
  const int split = split_col(f);
  cudaStream_t s = (cudaStream_t)stream;
  if (split > 0) {
    const BwdIn in{c_sum,    c_wsum,   c_sumsq2, c_max,  c_min,
                   max_mask, min_mask, vals,     colptr, receivers,
                   edge_w,   n_rows,   f,        32,     0,
                   split,    d_vals};
    (lane_vec(f) == 4 ? bwd_launcher<4, kChunks>(sumsq, masks)
                      : bwd_launcher<1, kChunks>(sumsq, masks))(in, s);
  }
  if (split < f) {
    const BwdIn in{c_sum,    c_wsum,   c_sumsq2,       c_max,  c_min,
                   max_mask, min_mask, vals,           colptr, receivers,
                   edge_w,   n_rows,   f,              split_lanes(f),
                   split,    f,        d_vals};
    bwd_launcher<4, kSplit>(sumsq, masks)(in, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
