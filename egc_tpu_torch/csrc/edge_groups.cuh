// The edge-group lane geometry of the attention kernels that walk a CSR or
// CSC row several edges at a time (gatv2_attention.cu, gat_attention.cu),
// and the device helpers that go with it.
//
// A group of P lanes owns one edge, so a warp walks G = 32 / P edges per
// step. Heads are padded to a power of two and get LH lanes each (an
// aligned power-of-two run inside the group); each lane holds K
// consecutive channels of its head (K <= kMaxChans, even when C is, so
// float2 loads never split a lane's run). LH is the least that keeps K <=
// kMaxChans. The kernels take (H, C) if and only if 1 <= H <= kMaxHeads and
// P <= 32 (shape_ok): a group fits in a warp. That reaches H*C = 512 (32
// lanes of 16 channels); at P = 32 a warp walks one edge per step (G = 1),
// and the group merges below run no step.
#pragma once

#include "warp_rows.cuh"

namespace {

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

// The one shape rule of the attention kernels (and of shape_ok in
// egc_tpu_torch/ops/cuda/attention.py).
inline bool shape_ok(int heads, int channels) {
  return heads >= 1 && heads <= kMaxHeads && channels >= 1 &&
         edge_groups(heads, channels).P <= 32;
}

// What a lane holds: lane j = lane % P of group grp = lane / P holds the nk
// channels c0 .. c0 + nk - 1 of head h = j / LH, from column col of a row;
// nk = 0 past the last head or past C.
struct LaneCols {
  int grp, h, c0, nk, col;

  __device__ __forceinline__ LaneCols(int lane, int P, int LH, int K, int H,
                                      int C) {
    const int j = lane % P;
    grp = lane / P;
    h = j / LH;
    c0 = (j % LH) * K;
    nk = h < H ? max(0, min(K, C - c0)) : 0;
    col = nk > 0 ? h * C + c0 : 0;
  }
};

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

template <int KT, int V>
__device__ __forceinline__ void store_cols(float* __restrict__ p, int nk,
                                           const float (&v)[KT]) {
#pragma unroll
  for (int k = 0; k < KT; k += V) {
    if (k < nk) {
      if constexpr (V == 2)
        *reinterpret_cast<float2*>(p + k) = make_float2(v[k], v[k + 1]);
      else
        p[k] = v[k];
    }
  }
}

// Row i's columns of the lane (zeros for i < 0, a group past the row).
template <int KT, int V>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int i,
                                         int F, const LaneCols& lc,
                                         float (&v)[KT]) {
  const bool ok = i >= 0;
  load_cols<KT, V>(x + (size_t)(ok ? i : 0) * F + lc.col, ok ? lc.nk : 0, v);
}

// The neighbour index at position i of the edge list, or -1 at or past the
// row's end.
__device__ __forceinline__ int edge_at(const int* __restrict__ idx, int i,
                                       int end) {
  return i < end ? __ldg(idx + i) : -1;
}

// A head's per-edge sum over its LH lanes, of one value or of two.
__device__ __forceinline__ float sum_head(float a, int LH) {
  for (int off = 1; off < LH; off <<= 1) a += __shfl_xor_sync(kFull, a, off);
  return a;
}

__device__ __forceinline__ void sum_head(float& a, float& b, int LH) {
  for (int off = 1; off < LH; off <<= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
}

// The G groups' sums, in a fixed order; every group ends with the total.
template <int KT>
__device__ __forceinline__ void sum_groups(float (&v)[KT], int P) {
  for (int off = P; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < KT; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
}

// An online softmax state (max m, denominator d, the lane's K columns of
// o), from m = kEmptyMax, d = 0, o = 0: add an edge of logit e and value
// row v.
template <int KT>
__device__ __forceinline__ void online_add(float& m, float& d,
                                           float (&o)[KT], float e,
                                           const float (&v)[KT]) {
  const float m_new = fmaxf(m, e);
  const float c = expf(m - m_new);
  const float p = expf(e - m_new);
  d = fmaf(d, c, p);
  m = m_new;
#pragma unroll
  for (int k = 0; k < KT; ++k) o[k] = fmaf(p, v[k], o[k] * c);
}

// The G groups' online states merge as flash attention's blocks do, in a
// fixed order: m* = max(ma, mb), then d and o rescaled by exp(mi - m*) and
// summed; every group ends with the total. kEmptyMax rather than -inf
// keeps every exponent finite, so two empty states merge to exact zeros.
template <int KT>
__device__ __forceinline__ void merge_groups(float& m, float& d,
                                             float (&o)[KT], int P) {
  for (int off = P; off < 32; off <<= 1) {
    const float m_b = __shfl_xor_sync(kFull, m, off);
    const float d_b = __shfl_xor_sync(kFull, d, off);
    const float m_new = fmaxf(m, m_b);
    const float ca = expf(m - m_new);
    const float cb = expf(m_b - m_new);
    d = d * ca + d_b * cb;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      o[k] = o[k] * ca + __shfl_xor_sync(kFull, o[k], off) * cb;
    m = m_new;
  }
}

}  // namespace
