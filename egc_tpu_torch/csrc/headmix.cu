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
// twice the bytes. Each kernel has two variants: the float4 variant where
// L and y_width are multiples of 4 and the pointers it loads and stores by
// float4 are 16-byte aligned (fwd_vector_ok, bwd_vector_ok), the tile
// variant everywhere else. headmix_fwd_variant and headmix_bwd_variant
// report the pick, so a caller can hold it against its own rule.
//
// Forward, float4 variant. A thread per output element (the first design)
// issued two loads per FMA and had the H threads of each l reload the same
// ys values: ~3,000 load instructions per node for 2,240 bytes, so load
// issue and L1, not HBM, set its time. Now a thread owns 4 consecutive l
// of one node (one float4, L/4 threads per node, 4 nodes per warp at L =
// 32) and computes all H outputs of its l in registers, kHeadsPerPass
// heads per pass: every ys value is loaded exactly once (for H <=
// kHeadsPerPass) as one float4, each w2d word by a broadcast load that all
// threads of the node share, so the node's w2d row leaves device memory
// once. The bias is added in the epilogue; the H float4 stores of a node's
// threads are coalesced.
//
// Backward, float4 variant. The first design gave a warp to each node, its
// lanes striding over l: it re-read the node's dz row A*B times and each ys
// row H times, loaded one w word and one dz word per FMA, and finished each
// of the H*B*A dw entries with its own 5-shuffle reduction and a lone
// 4-byte store (~500 warp instructions to move 3,968 bytes per node at the
// arxiv shape; 4.7x its byte bound). Now it takes the forward's geometry: a
// thread owns V = 4 consecutive l of one node, and a node's base b gets T
// threads of its own (L/4 rounded up to a power of two, at most 32: 8 at L
// = 32, so the 4 bases of a node fill a warp); past 32 float4 columns a
// thread takes nc chunks, T float4 apart. A thread loads its dz values of
// HP heads (HP = 4, or 8 for H > 4; the node's other bases load the same
// addresses in the same warp instruction) and its A float4 ys values, all
// at once, and w2d words by broadcast loads that the group shares. It then
// forms
//     dy[a] = sum_h w[h, b, a] dz[h]     (A float4 stores, coalesced)
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
//
// Why L = 34 (EGC-M h136 H4, the benchmark's arxiv model) left that
// geometry. In it L sets both the access width and the lanes: a base's L/V
// columns round up to a power of two. At L = 34 V fell to 1 (the scalar
// variant), so every value was a lone 4-byte load, a (node, base) took a
// whole warp whose second chunk had 2 of 32 lanes live, and each of the 12
// (h, a) partial sums took 5 shuffle rounds for one (node, base): 4.8x its
// byte bound in the backward, 2.0x in the forward, on an H100.
//
// Tile variant (both kernels). A tile of consecutive nodes is one
// contiguous slab of every array, whatever L is: ys[a] rows [n, y_width],
// dz and z rows [n, H*L], w2d and dw rows [n, H*B*A]. A block of
// kTileThreads threads takes a tile of `tile` nodes (tile_plan: as many as
// fit kTileBytes of shared memory, at most kMaxTileNodes) and
//   1. copies the tile's input slabs (forward: w2d and the A ys; backward:
//      w2d, dz and the A ys) into shared memory by cp.async, 16 bytes a
//      copy between the slab's first and last 16-byte boundary and 4 bytes
//      at either end; each slab sits in its region at the offset that
//      keeps device and shared addresses congruent mod 16;
//   2. computes from shared memory into shared memory, its threads
//      striding over the tile's work items instead of over one head's
//      columns. The forward's item is a column l of a node: it loads the
//      node's A*B ys values of l once and forms its H outputs, summing b
//      then a, kHeadsPerPass heads a pass, the bias added last. The
//      backward has two kinds of item: a column l of a node, which forms
//      dy[a][r, b*L + l] for every b and a, summing h in order (a later
//      pass of heads adds into the dy the thread wrote), and zeroes the
//      tail columns B*L + l, + L, ...; and a (node, h, b), which forms the
//      A entries of dw, summing l = 0 .. L-1 in order. No shuffles, no
//      atomics: every output has one writer and a fixed order of
//      addition, so two launches give the same bits; z and dy add in the
//      float4 variant's order and so give its bits on the same values;
//   3. copies the output slabs (z; dw and the A dy) back with 16-byte
//      stores between the boundaries and 4-byte stores at the ends.
// An item per output element (the first tile design) spent ~115
// instructions an output of the forward (against the float4 variant's
// ~19), the loads of w2d and ys repeated for each head, and ran at 2.2x
// the forward's byte bound; so the items carry the float4 variant's
// register blocking. kTileMinBlocks caps the registers so that four 46-KB
// blocks share an SM. Prefetching the next tile into a second buffer (a
// block looping over tiles) took more registers and was slower on an
// H100, at every tile size tried.
// Where a tile of one node would not fit a block's shared memory
// (kMaxTileSmem), the same items run on device memory directly (kStaged
// false). The A aggregator arrays come as separate pointers (at most
// kMaxAggrs), never stacked.

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

// ---------------------------------------------------------------------------
// Tile variant
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kTileBytes = 48 * 1024;   // shared memory a block aims at
constexpr int kTileMinBlocks = 4;       // blocks an SM holds at once
constexpr int kMaxTileNodes = 32;
constexpr int kMaxTileSmem = 232448;    // a block's opt-in maximum on sm_90

// Floats of the shared-memory region of a slab of `count` floats: room
// for the 0-3 floats of offset that keep it congruent to its device
// address mod 16, rounded up to whole 16-byte words.
__host__ __device__ inline long long slab_region(long long count) {
  return (count + 6) & ~3LL;
}

// The float offset of p within its 16-byte word.
__device__ __forceinline__ int word_offset(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(g));
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Starts the copy of `count` floats at g into the region at s (16-byte
// aligned); returns where the slab starts in it.
__device__ __forceinline__ const float* stage_in(float* s, const float* g,
                                                 int count) {
  float* d = s + word_offset(g);
  const int head = min((4 - word_offset(g)) & 3, count);
  const int quads = (count - head) >> 2;
  const int tail = head + 4 * quads;
  const int t = threadIdx.x;
  if (t < head) cp_async4(d + t, g + t);
  for (int q = t; q < quads; q += kTileThreads)
    cp_async16(d + head + 4 * q, g + head + 4 * q);
  if (tail + t < count) cp_async4(d + tail + t, g + tail + t);
  return d;
}

// Copies `count` floats from d (a slab placed for g, as stage_in places
// one) to g.
__device__ __forceinline__ void stage_out(float* g, const float* d,
                                          int count) {
  const int head = min((4 - word_offset(g)) & 3, count);
  const int quads = (count - head) >> 2;
  const int tail = head + 4 * quads;
  const int t = threadIdx.x;
  if (t < head) g[t] = d[t];
  for (int q = t; q < quads; q += kTileThreads)
    reinterpret_cast<float4*>(g + head)[q] =
        reinterpret_cast<const float4*>(d + head)[q];
  if (tail + t < count) g[tail + t] = d[tail + t];
}

// A tile's nodes and its block's shared-memory bytes (0: the tile does
// not fit, and the kernel runs on device memory).
struct TilePlan {
  int nodes;
  int smem;
};

inline TilePlan tile_plan(bool bwd, int H, int B, int A, int L, int yw) {
  const long long HBA = (long long)H * B * A, HL = (long long)H * L;
  const long long per_node = bwd ? 2 * HBA + HL + 2LL * A * yw
                                 : HBA + HL + (long long)A * yw;
  const long long fit = kTileBytes / (4 * per_node);
  const int nodes = (int)(fit < 1 ? 1 : fit > kMaxTileNodes ? kMaxTileNodes
                                                            : fit);
  const long long floats =
      bwd ? 2 * slab_region(nodes * HBA) + slab_region(nodes * HL) +
                2LL * A * slab_region((long long)nodes * yw)
          : slab_region(nodes * HBA) + slab_region(nodes * HL) +
                (long long)A * slab_region((long long)nodes * yw);
  return {nodes, 4 * floats <= kMaxTileSmem ? (int)(4 * floats) : 0};
}

// Block: nodes node0 .. node0 + m - 1; item i: column l of node r, (r, l)
// = divmod(i, L), whose H outputs it forms kHeadsPerPass heads a pass.
template <int AP, bool kStaged>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
headmix_fwd_tile_kernel(const float* __restrict__ w2d, InPtrs ys,
                        const float* __restrict__ bias, int n, int H, int B,
                        int A, int L, int yw, int tile,
                        float* __restrict__ z) {
  extern __shared__ float4 smem4[];
  const int BA = B * A, HBA = H * BA, HL = H * L;
  const size_t node0 = (size_t)blockIdx.x * tile;
  const int m = (int)min((size_t)tile, (size_t)n - node0);
  // each pointer is set once, to device or to shared memory, so that the
  // staged kernel reads and writes shared memory by LDS and STS
  float* s = reinterpret_cast<float*>(smem4);
  const float* w = w2d + node0 * HBA;
  if constexpr (kStaged) {
    w = stage_in(s, w, m * HBA);
    s += slab_region((long long)tile * HBA);
  }
  const float* y[AP];
#pragma unroll
  for (int a = 0; a < AP; ++a) {
    if (a < A) {
      if constexpr (kStaged) {
        y[a] = stage_in(s, ys.p[a] + node0 * yw, m * yw);
        s += slab_region((long long)tile * yw);
      } else {
        y[a] = ys.p[a] + node0 * yw;
      }
    }
  }
  float* const gz = z + node0 * HL;
  float* const out = kStaged ? s + word_offset(gz) : gz;
  if constexpr (kStaged) {
    cp_async_wait_all();
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m * L; i += kTileThreads) {
    const int r = i / L, l = i - r * L;
    const float* wr = w + r * HBA;
    const int yo = r * yw + l;
    for (int h0 = 0; h0 < H; h0 += kHeadsPerPass) {
      float acc[kHeadsPerPass];
#pragma unroll
      for (int j = 0; j < kHeadsPerPass; ++j) acc[j] = 0.f;
      for (int b = 0; b < B; ++b) {
        float yv[AP];
#pragma unroll
        for (int a = 0; a < AP; ++a)
          if (a < A) yv[a] = y[a][yo + b * L];
#pragma unroll
        for (int a = 0; a < AP; ++a) {
          if (a < A) {
            const float* wa = wr + h0 * BA + b * A + a;
#pragma unroll
            for (int j = 0; j < kHeadsPerPass; ++j)
              if (h0 + j < H) acc[j] = fmaf(wa[j * BA], yv[a], acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kHeadsPerPass; ++j) {
        const int hl = (h0 + j) * L + l;
        if (h0 + j < H)
          out[r * HL + hl] = bias != nullptr ? acc[j] + __ldg(bias + hl)
                                             : acc[j];
      }
    }
  }
  if constexpr (kStaged) {
    __syncthreads();
    stage_out(gz, out, m * HL);
  }
}

// Block: nodes node0 .. node0 + m - 1; items 0 .. m*H*B - 1: the A dw
// entries of (node, h, b); then m*L items, column l of node r, which forms
// dy[a][r, b*L + l] for every b and a, kHeadsPerPass heads a pass, and
// zeroes the tail columns B*L + l, + L, ... of y_width.
template <int AP, bool kStaged>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
headmix_bwd_tile_kernel(const float* __restrict__ w2d, InPtrs ys,
                        const float* __restrict__ dz, int n, int H, int B,
                        int A, int L, int yw, int tile,
                        float* __restrict__ dw, OutPtrs dys) {
  extern __shared__ float4 smem4[];
  const int BA = B * A, HBA = H * BA, HL = H * L, HB = H * B, BL = B * L;
  const size_t node0 = (size_t)blockIdx.x * tile;
  const int m = (int)min((size_t)tile, (size_t)n - node0);
  // each pointer is set once, to device or to shared memory, so that the
  // staged kernel reads and writes shared memory by LDS and STS
  float* s = reinterpret_cast<float*>(smem4);
  const float* w = w2d + node0 * HBA;
  const float* d = dz + node0 * HL;
  if constexpr (kStaged) {
    w = stage_in(s, w, m * HBA);
    s += slab_region((long long)tile * HBA);
    d = stage_in(s, d, m * HL);
    s += slab_region((long long)tile * HL);
  }
  const float* y[AP];
#pragma unroll
  for (int a = 0; a < AP; ++a) {
    if (a < A) {
      if constexpr (kStaged) {
        y[a] = stage_in(s, ys.p[a] + node0 * yw, m * yw);
        s += slab_region((long long)tile * yw);
      } else {
        y[a] = ys.p[a] + node0 * yw;
      }
    }
  }
  float* const gw = dw + node0 * HBA;
  float* const ow = kStaged ? s + word_offset(gw) : gw;
  if constexpr (kStaged) s += slab_region((long long)tile * HBA);
  float* oy[AP];
#pragma unroll
  for (int a = 0; a < AP; ++a) {
    if (a < A) {
      float* const g = dys.p[a] + node0 * yw;
      if constexpr (kStaged) {
        oy[a] = s + word_offset(g);
        s += slab_region((long long)tile * yw);
      } else {
        oy[a] = g;
      }
    }
  }
  if constexpr (kStaged) {
    cp_async_wait_all();
    __syncthreads();
  }
  const int n_dw = m * HB;
  for (int i = threadIdx.x; i < n_dw + m * L; i += kTileThreads) {
    if (i < n_dw) {
      const int r = i / HB, hb = i - r * HB, h = hb / B, b = hb - h * B;
      const float* dr = d + r * HL + h * L;
      const int yo = r * yw + b * L;
      float part[AP];
#pragma unroll
      for (int a = 0; a < AP; ++a) part[a] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float dv = dr[l];
#pragma unroll
        for (int a = 0; a < AP; ++a)
          if (a < A) part[a] = fmaf(dv, y[a][yo + l], part[a]);
      }
      float* o = ow + r * HBA + h * BA + b * A;
#pragma unroll
      for (int a = 0; a < AP; ++a)
        if (a < A) o[a] = part[a];
    } else {
      const int j = i - n_dw, r = j / L, l = j - r * L;
      const float* dr = d + r * HL + l;
      const float* wr = w + r * HBA;
      const int yo = r * yw + l;
      for (int h0 = 0; h0 < H; h0 += kHeadsPerPass) {
        float dv[kHeadsPerPass];
#pragma unroll
        for (int k = 0; k < kHeadsPerPass; ++k)
          dv[k] = h0 + k < H ? dr[(h0 + k) * L] : 0.f;
        for (int b = 0; b < B; ++b) {
#pragma unroll
          for (int a = 0; a < AP; ++a) {
            if (a < A) {
              // a later pass adds into the dy this thread wrote
              float* const o = oy[a] + yo + b * L;
              float acc = h0 > 0 ? *o : 0.f;
              const float* wa = wr + h0 * BA + b * A + a;
#pragma unroll
              for (int k = 0; k < kHeadsPerPass; ++k)
                if (h0 + k < H) acc = fmaf(wa[k * BA], dv[k], acc);
              *o = acc;
            }
          }
        }
      }
      for (int c = BL + l; c < yw; c += L) {
#pragma unroll
        for (int a = 0; a < AP; ++a)
          if (a < A) oy[a][r * yw + c] = 0.f;
      }
    }
  }
  if constexpr (kStaged) {
    __syncthreads();
    stage_out(gw, ow, m * HBA);
#pragma unroll
    for (int a = 0; a < AP; ++a)
      if (a < A) stage_out(dys.p[a] + node0 * yw, oy[a], m * yw);
  }
}

// The blocks of a tile kernel, a tile each, after raising its dynamic
// shared-memory limit past the default 48 KB where the plan needs it.
template <class K>
cudaError_t tile_grid(K kernel, const TilePlan& p, int n, unsigned* blocks) {
  *blocks = (unsigned)((n + p.nodes - 1) / p.nodes);
  return p.smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   p.smem)
             : cudaSuccess;
}

template <int AP>
cudaError_t launch_fwd_tile(const float* w2d, const InPtrs& in,
                            const float* bias, int n, int H, int B, int A,
                            int L, int yw, float* z, cudaStream_t s) {
  const TilePlan p = tile_plan(false, H, B, A, L, yw);
  unsigned blocks = 0;
  if (p.smem == 0) {
    tile_grid(headmix_fwd_tile_kernel<AP, false>, p, n, &blocks);
    headmix_fwd_tile_kernel<AP, false><<<blocks, kTileThreads, 0, s>>>(
        w2d, in, bias, n, H, B, A, L, yw, p.nodes, z);
    return cudaSuccess;
  }
  const cudaError_t err =
      tile_grid(headmix_fwd_tile_kernel<AP, true>, p, n, &blocks);
  if (err != cudaSuccess) return err;
  headmix_fwd_tile_kernel<AP, true><<<blocks, kTileThreads, p.smem, s>>>(
      w2d, in, bias, n, H, B, A, L, yw, p.nodes, z);
  return cudaSuccess;
}

template <int AP>
cudaError_t launch_bwd_tile(const float* w2d, const InPtrs& in,
                            const float* dz, int n, int H, int B, int A,
                            int L, int yw, float* dw, const OutPtrs& out,
                            cudaStream_t s) {
  const TilePlan p = tile_plan(true, H, B, A, L, yw);
  unsigned blocks = 0;
  if (p.smem == 0) {
    tile_grid(headmix_bwd_tile_kernel<AP, false>, p, n, &blocks);
    headmix_bwd_tile_kernel<AP, false><<<blocks, kTileThreads, 0, s>>>(
        w2d, in, dz, n, H, B, A, L, yw, p.nodes, dw, out);
    return cudaSuccess;
  }
  const cudaError_t err =
      tile_grid(headmix_bwd_tile_kernel<AP, true>, p, n, &blocks);
  if (err != cudaSuccess) return err;
  headmix_bwd_tile_kernel<AP, true><<<blocks, kTileThreads, p.smem, s>>>(
      w2d, in, dz, n, H, B, A, L, yw, p.nodes, dw, out);
  return cudaSuccess;
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
  cudaStream_t s = (cudaStream_t)stream;
  if (!fwd_vector_ok(ys, A, bias, L, yw)) {
    const cudaError_t err =
        A <= 4 ? launch_fwd_tile<4>(w2d, in, bias, n, H, B, A, L, yw, z, s)
               : launch_fwd_tile<8>(w2d, in, bias, n, H, B, A, L, yw, z, s);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  const size_t total = (size_t)n * (L / 4);
  const unsigned threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  headmix_fwd_kernel<4><<<blocks, threads, 0, s>>>(w2d, in, bias, n, H, B, A,
                                                   L, yw, z);
  return (int)cudaGetLastError();
}

// 1 if headmix_fwd takes the float4 variant for these arguments, 0 if the
// tile variant.
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
  if (!bwd_vector_ok(ys, dys, A, dz, L, yw)) {
    const cudaError_t err =
        A <= 4
            ? launch_bwd_tile<4>(w2d, in, dz, n, H, B, A, L, yw, dw, out, s)
            : launch_bwd_tile<8>(w2d, in, dz, n, H, B, A, L, yw, dw, out, s);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  launch_bwd<4>(w2d, in, dz, n, H, B, A, L, yw, dw, out, s);
  return (int)cudaGetLastError();
}

// 1 if headmix_bwd takes the float4 variant for these arguments, 0 if the
// tile variant.
int headmix_bwd_variant(const void* const* ys, const void* const* dys,
                        const float* dz, int A, int L, int yw) {
  return bwd_vector_ok(ys, dys, A, dz, L, yw) ? 1 : 0;
}

// The tile variant's nodes a block (into *nodes) and shared-memory bytes a
// block (0: on device memory directly) for the backward (bwd 1) or the
// forward (bwd 0) at this shape.
int headmix_tile_plan(int bwd, int H, int B, int A, int L, int yw,
                      int* nodes) {
  const TilePlan p = tile_plan(bwd != 0, H, B, A, L, yw);
  *nodes = p.nodes;
  return p.smem;
}

}  // extern "C"
