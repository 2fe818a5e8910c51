// Masked BatchNorm, training and evaluation, for NVIDIA Hopper (sm_90a).
//
// These four kernels replace no Pallas kernel: the JAX package leaves its
// MaskedBatchNorm (egc_tpu/nn/norm.py) to XLA, which fuses it into few
// passes. Run as plain PyTorch it took ~20 passes over x and ~50 launches a
// layer. The function is the JAX package's, uncentred variance included:
//     s = sum_n m x,   ssq = sum_n m x^2,   n = max(sum_n m, 1)
//     mean = s / n,    u = ssq / n - mean^2,    var = max(u, 0)
//     r = 1 / sqrt(var + 1e-5)
//     y = ((x - mean) r) w + b                  on every row, masked too
//     running = 0.9 running + 0.1 (mean, var n / max(n - 1, 1))
// Evaluation takes mean and var from the running statistics.
//
// bn_stats      reads x and the mask; writes stats = (s, ssq, n) [2F + 1].
// bn_apply      reads x; writes y. In training block 0 also updates the
//               running statistics and num_batches_tracked in place.
// bn_grad_sums  reads g and x; over all rows sg = sum g and
//               sgx = sum g (x - mean), centred by mean as autograd's
//               x - mean was; writes dweight = r sgx, dbias = sg and
//               d = (ds, dssq) [2F], the cotangents of s and ssq:
//                   dvar = -r^3 w sgx / 2  where u >= 0, else 0
//                   ds = -r w sg / n - 2 mean dvar / n,   dssq = dvar / n
//               (both 0 in evaluation).
// bn_apply_bwd  reads g, x and the mask; writes
//                   dx = g (w r) + m (ds + x (2 dssq)).
// Sync-BN: the caller all-reduces stats between bn_stats and bn_apply and d
// between bn_grad_sums and bn_apply_bwd.
//
// What bounds them on an H100: device-memory bytes. Each does a few flops
// per float it moves. At arxiv's 169,344 x 136 (92.1 MB an array) bn_stats
// moves one array (0.028 ms at 3.35 TB/s), bn_apply and bn_grad_sums two
// (0.055), bn_apply_bwd three (0.082).
//
// Design. A block of kThreads threads walks one range of rows. A thread owns
// V consecutive columns (V = 4, one float4, when F is a multiple of 4 and
// every [N, F] pointer is 16-byte aligned; else V = 1, the scalar variant;
// the wrapper decides, ops/cuda/batch_norm.py: variant, and passes vector)
// and keeps them over the whole range: of C = F / V column groups, thread t
// takes group t % C on rows t / C, t / C + R, ... (R = kThreads / C rows a
// pass), so a pass reads R whole rows, contiguous, and each thread works out
// its columns' constants once, into registers. Past kThreads groups
// (F > 2,048, or F > 512 scalar) a thread takes further groups kThreads
// apart, one pass each. A thread has kUnroll rows' loads in flight. The sums
// add a thread's rows in row order, then a column's R threads in a fixed
// order in shared memory, into per-block partials in a scratch buffer; the
// last block to finish (an integer ticket, zeroed before the launch) adds
// the partials in block order, each thread a column with 16 loads in
// flight. No float atomics: two runs give the same bits. The grid is a
// fixed function of (N, F) that the wrapper computes (ops/cuda/batch_norm.py:
// grid): at most two blocks an SM for the sums, so that the last block has
// few partials to read, four for bn_apply and bn_apply_bwd, fewer on short
// inputs (the fastest of 66 to 1,056 blocks at the arxiv shape on an H100,
// to within 4%). Per-column arithmetic takes round-to-nearest
// intrinsics in the plain version's order, so bn_apply and bn_apply_bwd
// equal their plain versions to the bit given the same stats and sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr float kEps = 1e-5f;
constexpr float kMomentum = 0.1f;
constexpr float kKeep = (float)(1.0 - 0.1);

// The column geometry of a thread (head note).
struct Cols {
  int C, Cw, R, j, r0;
  __device__ explicit Cols(int F, int V) {
    C = F / V;
    Cw = C < kThreads ? C : kThreads;
    R = kThreads / Cw;
    j = threadIdx.x % Cw;
    r0 = threadIdx.x / Cw;
  }
  // whether this thread has a column group in the pass starting at c0
  __device__ bool active(int c0) const { return r0 < R && c0 + j < C; }
};

template <int V>
struct Vals {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vals<V> load(const float* p) {
  Vals<V> o;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o.v[0] = t.x;
    o.v[1] = t.y;
    o.v[2] = t.z;
    o.v[3] = t.w;
  } else {
    o.v[0] = *p;
  }
  return o;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vals<V>& o) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o.v[0], o.v[1], o.v[2],
                                                o.v[3]);
  } else {
    *p = o.v[0];
  }
}

__device__ __forceinline__ float mask_at(const uint8_t* mask, int64_t r) {
  return mask == nullptr ? 1.f : (mask[r] != 0 ? 1.f : 0.f);
}

// One column's constants: from the batch's stats (training) or, with stats
// null, from the running statistics (evaluation; n and pos unused).
struct Col {
  float mean, var, r, n;
  bool pos;  // u >= 0: the clamp passes its gradient
};

__device__ __forceinline__ Col column(const float* stats, const float* rmean,
                                      const float* rvar, int F, int c) {
  Col o;
  if (stats != nullptr) {
    o.n = fmaxf(stats[2 * F], 1.f);
    o.mean = __fdiv_rn(stats[c], o.n);
    const float u =
        __fsub_rn(__fdiv_rn(stats[F + c], o.n), __fmul_rn(o.mean, o.mean));
    o.pos = u >= 0.f;
    o.var = u < 0.f ? 0.f : u;  // a NaN stays NaN, as torch.clamp keeps it
  } else {
    o.n = 1.f;
    o.pos = false;
    o.mean = rmean[c];
    o.var = rvar[c];
  }
  o.r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(o.var, kEps)));
  return o;
}

// The rows [begin, end) of a block.
__device__ __forceinline__ void row_range(int64_t N, int64_t rpb,
                                          int64_t* begin, int64_t* end) {
  *begin = (int64_t)blockIdx.x * rpb;
  *end = *begin + rpb < N ? *begin + rpb : N;
}

// Adds the R rows of red[2][R * Cw * V] column by column, in row order, and
// writes the two sums of the pass's columns at out[c0 V + i] and
// out[F + c0 V + i].
template <int V>
__device__ __forceinline__ void reduce_rows(const Cols& k, int c0, int F,
                                            float (*red)[kThreads * V],
                                            float* out) {
  const int width = (k.C - c0 < k.Cw ? k.C - c0 : k.Cw) * V;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    float a = 0.f, b = 0.f;
    for (int rr = 0; rr < k.R; ++rr) {
      a += red[0][rr * k.Cw * V + i];
      b += red[1][rr * k.Cw * V + i];
    }
    out[c0 * V + i] = a;
    out[F + c0 * V + i] = b;
  }
}

// Whether this block is the last to finish; its partials are visible to it.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// bn_stats: (s, ssq, n)
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ mask, int64_t N, int F,
                    int64_t rpb, float* __restrict__ part,
                    unsigned* __restrict__ ticket,
                    float* __restrict__ stats) {
  __shared__ float red[2][kThreads * V];
  const Cols k(F, V);
  int64_t begin, end;
  row_range(N, rpb, &begin, &end);
  const int64_t W = 2 * (int64_t)F + 1;  // a block's partials
  float* mine = part + blockIdx.x * W;

  int count = 0;  // valid rows of the range
  for (int64_t base = begin; base < end; base += kThreads) {
    const int64_t r = base + threadIdx.x;
    count += __syncthreads_count(r < end && mask_at(mask, r) != 0.f);
  }

  for (int c0 = 0; c0 < k.C; c0 += k.Cw) {
    float s[V], q[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = q[v] = 0.f;
    if (k.active(c0)) {
      const int64_t col = (int64_t)(c0 + k.j) * V;
      const int64_t step = k.R;
      int64_t r = begin + k.r0;
      for (; r + (kUnroll - 1) * step < end; r += kUnroll * step) {
        Vals<V> a[kUnroll];
        float m[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          a[u] = load<V>(x + (r + u * step) * F + col);
          m[u] = mask_at(mask, r + u * step);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            s[v] += a[u].v[v] * m[u];
            q[v] += __fmul_rn(a[u].v[v], a[u].v[v]) * m[u];
          }
      }
      for (; r < end; r += step) {
        const Vals<V> a = load<V>(x + r * F + col);
        const float m = mask_at(mask, r);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          s[v] += a.v[v] * m;
          q[v] += __fmul_rn(a.v[v], a.v[v]) * m;
        }
      }
    }
    __syncthreads();  // the previous pass has read red
    if (k.active(c0)) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red[0][k.r0 * k.Cw * V + k.j * V + v] = s[v];
        red[1][k.r0 * k.Cw * V + k.j * V + v] = q[v];
      }
    }
    __syncthreads();
    reduce_rows<V>(k, c0, F, red, mine);
  }
  if (threadIdx.x == 0) mine[2 * F] = (float)count;

  // the counts are whole numbers, exact in f32 below 2^24 as in the
  // plain version's sum of the float mask
  if (!last_block(ticket)) return;
  for (int i = threadIdx.x; i < W; i += kThreads) {
    float a = 0.f;
#pragma unroll 16
    for (unsigned b = 0; b < gridDim.x; ++b) a += __ldcg(part + b * W + i);
    stats[i] = a;
  }
}

// ---------------------------------------------------------------------------
// bn_apply: y, and in training the running statistics
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const float* __restrict__ x,
                    const float* __restrict__ stats, float* rmean,
                    float* rvar, long long* __restrict__ nbt,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, int64_t N, int F,
                    int64_t rpb, float* __restrict__ y) {
  const Cols k(F, V);
  int64_t begin, end;
  row_range(N, rpb, &begin, &end);
  for (int c0 = 0; c0 < k.C; c0 += k.Cw) {
    if (!k.active(c0)) continue;
    const int c = (c0 + k.j) * V;
    float mean[V], r[V], w[V], b[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const Col col = column(stats, rmean, rvar, F, c + v);
      mean[v] = col.mean;
      r[v] = col.r;
      w[v] = weight[c + v];
      b[v] = bias[c + v];
    }
    const int64_t step = k.R;
    int64_t r0 = begin + k.r0;
    for (; r0 + (kUnroll - 1) * step < end; r0 += kUnroll * step) {
      Vals<V> a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        a[u] = load<V>(x + (r0 + u * step) * F + c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          a[u].v[v] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(a[u].v[v], mean[v]), r[v]), w[v]),
              b[v]);
        store<V>(y + (r0 + u * step) * F + c, a[u]);
      }
    }
    for (; r0 < end; r0 += step) {
      Vals<V> a = load<V>(x + r0 * F + c);
#pragma unroll
      for (int v = 0; v < V; ++v)
        a.v[v] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(a.v[v], mean[v]), r[v]), w[v]),
            b[v]);
      store<V>(y + r0 * F + c, a);
    }
  }
  // Training reads only stats above, so block 0 may update the running
  // statistics in place; evaluation (stats null) leaves them.
  if (stats == nullptr || blockIdx.x != 0) return;
  for (int c = threadIdx.x; c < F; c += kThreads) {
    const Col col = column(stats, nullptr, nullptr, F, c);
    const float unbiased = __fdiv_rn(__fmul_rn(col.var, col.n),
                                     fmaxf(__fsub_rn(col.n, 1.f), 1.f));
    rmean[c] = __fadd_rn(__fmul_rn(rmean[c], kKeep),
                         __fmul_rn(kMomentum, col.mean));
    rvar[c] = __fadd_rn(__fmul_rn(rvar[c], kKeep),
                        __fmul_rn(kMomentum, unbiased));
  }
  if (threadIdx.x == 0) *nbt += 1;
}

// ---------------------------------------------------------------------------
// bn_grad_sums: dweight, dbias and d = (ds, dssq)
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_grad_sums_kernel(const float* __restrict__ g,
                        const float* __restrict__ x,
                        const float* __restrict__ stats,
                        const float* __restrict__ rmean,
                        const float* __restrict__ rvar,
                        const float* __restrict__ weight, int64_t N, int F,
                        int64_t rpb, float* __restrict__ part,
                        unsigned* __restrict__ ticket,
                        float* __restrict__ dweight,
                        float* __restrict__ dbias, float* __restrict__ d) {
  __shared__ float red[2][kThreads * V];
  const Cols k(F, V);
  int64_t begin, end;
  row_range(N, rpb, &begin, &end);
  const int64_t W = 2 * (int64_t)F;
  float* mine = part + blockIdx.x * W;

  for (int c0 = 0; c0 < k.C; c0 += k.Cw) {
    float sg[V], sgx[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sg[v] = sgx[v] = 0.f;
    if (k.active(c0)) {
      const int c = (c0 + k.j) * V;
      float mean[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        mean[v] = column(stats, rmean, rvar, F, c + v).mean;
      const int64_t step = k.R;
      int64_t r = begin + k.r0;
      for (; r + (kUnroll - 1) * step < end; r += kUnroll * step) {
        Vals<V> a[kUnroll], b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          a[u] = load<V>(g + (r + u * step) * F + c);
          b[u] = load<V>(x + (r + u * step) * F + c);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            sg[v] += a[u].v[v];
            sgx[v] += a[u].v[v] * __fsub_rn(b[u].v[v], mean[v]);
          }
      }
      for (; r < end; r += step) {
        const Vals<V> a = load<V>(g + r * F + c);
        const Vals<V> b = load<V>(x + r * F + c);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sg[v] += a.v[v];
          sgx[v] += a.v[v] * __fsub_rn(b.v[v], mean[v]);
        }
      }
    }
    __syncthreads();
    if (k.active(c0)) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red[0][k.r0 * k.Cw * V + k.j * V + v] = sg[v];
        red[1][k.r0 * k.Cw * V + k.j * V + v] = sgx[v];
      }
    }
    __syncthreads();
    reduce_rows<V>(k, c0, F, red, mine);
  }

  if (!last_block(ticket)) return;
  for (int c = threadIdx.x; c < F; c += kThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll 16
    for (unsigned blk = 0; blk < gridDim.x; ++blk) {
      a += __ldcg(part + blk * W + c);
      b += __ldcg(part + blk * W + F + c);
    }
    const Col col = column(stats, rmean, rvar, F, c);
    const float w = weight[c];
    dweight[c] = col.r * b;
    dbias[c] = a;
    float ds = 0.f, dssq = 0.f;
    if (stats != nullptr) {
      const float dvar = col.pos ? -0.5f * col.r * col.r * col.r * w * b : 0.f;
      ds = -(col.r * w * a) / col.n - 2.f * col.mean * dvar / col.n;
      dssq = dvar / col.n;
    }
    d[c] = ds;
    d[F + c] = dssq;
  }
}

// ---------------------------------------------------------------------------
// bn_apply_bwd: dx
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_apply_bwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ x,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ stats,
                        const float* __restrict__ rmean,
                        const float* __restrict__ rvar,
                        const float* __restrict__ weight,
                        const float* __restrict__ d, int64_t N, int F,
                        int64_t rpb, float* __restrict__ dx) {
  const Cols k(F, V);
  int64_t begin, end;
  row_range(N, rpb, &begin, &end);
  for (int c0 = 0; c0 < k.C; c0 += k.Cw) {
    if (!k.active(c0)) continue;
    const int c = (c0 + k.j) * V;
    float a[V], ds[V], d2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      a[v] = __fmul_rn(weight[c + v], column(stats, rmean, rvar, F, c + v).r);
      ds[v] = d[c + v];
      d2[v] = __fmul_rn(2.f, d[F + c + v]);
    }
    const int64_t step = k.R;
    int64_t r = begin + k.r0;
    for (; r + (kUnroll - 1) * step < end; r += kUnroll * step) {
      Vals<V> gg[kUnroll], xx[kUnroll];
      float m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        gg[u] = load<V>(g + (r + u * step) * F + c);
        xx[u] = load<V>(x + (r + u * step) * F + c);
        m[u] = mask_at(mask, r + u * step);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          gg[u].v[v] = __fadd_rn(
              __fmul_rn(gg[u].v[v], a[v]),
              __fmul_rn(m[u], __fadd_rn(ds[v], __fmul_rn(xx[u].v[v], d2[v]))));
        store<V>(dx + (r + u * step) * F + c, gg[u]);
      }
    }
    for (; r < end; r += step) {
      Vals<V> gg = load<V>(g + r * F + c);
      const Vals<V> xx = load<V>(x + r * F + c);
      const float m = mask_at(mask, r);
#pragma unroll
      for (int v = 0; v < V; ++v)
        gg.v[v] = __fadd_rn(
            __fmul_rn(gg.v[v], a[v]),
            __fmul_rn(m, __fadd_rn(ds[v], __fmul_rn(xx.v[v], d2[v]))));
      store<V>(dx + r * F + c, gg);
    }
  }
}

bool bad_grid(long long n, int F, int vector, int blocks, long long rpb) {
  return F < 1 || (vector && F % 4 != 0) || blocks < 1 || rpb < 1 ||
         (long long)blocks * rpb < n;
}

}  // namespace

extern "C" {

// vector: 1 for the float4 variant (F a multiple of 4 and the [N, F]
// pointers 16-byte aligned, as the wrapper's variant decides), 0 for the
// scalar one.

const char* egc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// part: blocks * (2F + 1) floats of scratch; ticket: one unsigned of
// scratch, zeroed here. mask may be null.
int bn_stats(const float* x, const uint8_t* mask, long long n, int F,
             int vector, int blocks, long long rpb, float* part,
             unsigned* ticket, float* stats, void* stream) {
  if (bad_grid(n, F, vector, blocks, rpb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  if (vector)
    bn_stats_kernel<4><<<blocks, kThreads, 0, s>>>(x, mask, n, F, rpb, part,
                                                   ticket, stats);
  else
    bn_stats_kernel<1><<<blocks, kThreads, 0, s>>>(x, mask, n, F, rpb, part,
                                                   ticket, stats);
  return (int)cudaGetLastError();
}

// stats null: evaluation, from rmean and rvar (then left as they are, and
// nbt may be null).
int bn_apply(const float* x, const float* stats, float* rmean, float* rvar,
             long long* nbt, const float* weight, const float* bias,
             long long n, int F, int vector, int blocks, long long rpb,
             float* y, void* stream) {
  if (bad_grid(n, F, vector, blocks, rpb) ||
      (stats != nullptr && nbt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vector)
    bn_apply_kernel<4><<<blocks, kThreads, 0, s>>>(
        x, stats, rmean, rvar, nbt, weight, bias, n, F, rpb, y);
  else
    bn_apply_kernel<1><<<blocks, kThreads, 0, s>>>(
        x, stats, rmean, rvar, nbt, weight, bias, n, F, rpb, y);
  return (int)cudaGetLastError();
}

// part: blocks * 2F floats of scratch; ticket as for bn_stats; d: [2F].
int bn_grad_sums(const float* g, const float* x, const float* stats,
                 const float* rmean, const float* rvar, const float* weight,
                 long long n, int F, int vector, int blocks, long long rpb,
                 float* part, unsigned* ticket, float* dweight, float* dbias,
                 float* d, void* stream) {
  if (bad_grid(n, F, vector, blocks, rpb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  if (vector)
    bn_grad_sums_kernel<4><<<blocks, kThreads, 0, s>>>(
        g, x, stats, rmean, rvar, weight, n, F, rpb, part, ticket, dweight,
        dbias, d);
  else
    bn_grad_sums_kernel<1><<<blocks, kThreads, 0, s>>>(
        g, x, stats, rmean, rvar, weight, n, F, rpb, part, ticket, dweight,
        dbias, d);
  return (int)cudaGetLastError();
}

int bn_apply_bwd(const float* g, const float* x, const uint8_t* mask,
                 const float* stats, const float* rmean, const float* rvar,
                 const float* weight, const float* d, long long n, int F,
                 int vector, int blocks, long long rpb, float* dx,
                 void* stream) {
  if (bad_grid(n, F, vector, blocks, rpb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vector)
    bn_apply_bwd_kernel<4><<<blocks, kThreads, 0, s>>>(
        g, x, mask, stats, rmean, rvar, weight, d, n, F, rpb, dx);
  else
    bn_apply_bwd_kernel<1><<<blocks, kThreads, 0, s>>>(
        g, x, mask, stats, rmean, rvar, weight, d, n, F, rpb, dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
