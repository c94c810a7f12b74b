// K5 globalpack: projected Adam ascent on the relaxed global repack.
//
// Replaces: karpenter_tpu/models/globalpack.py `_globalpack_impl` (:97), the
// vmapped fori_loop of Adam steps on `_gp_objective` (:52-84) with the
// gradient from `jax.grad`, the projection `_gp_project` (:87-93) and the
// final objective; called by `global_repack` (:147) and, at zero pending
// mass, by models/consolidation_model.py `lp_repack` (:154).
//
// Per init c (d [N], y [Q, N], yr [Q, T]; yc = y * compat_qn):
//   disp[q, r]   = pend_mass[q, r] + sum_n onehot[n, q] d[n] used[n, r]
//   routed[n, r] = sum_q yc[q, n] disp[q, r]
//   a[n, r]      = routed[n, r] - (1 - d[n]) slack[n, r], over = max(a, 0) norm_r
//   rep[t, r]    = sum_q yr[q, t] disp[q, r], z[t] = max_r rep inv_alloc
//   route[q]     = sum_n yc[q, n] + sum_t yr[q, t]
//   mass[q]      = sum_r disp[q, r] norm_r[r]
//   objective    = sum d price - cw sum d cost - sum price_safe z
//                  - 10 sum over^2 - 10 sum_q max(1 - route, 0) mass pend_weight
// and the gradient of its negation written out (the tie rules of JAX:
// d max(x, 0)/dx = 0.5 at x == 0; a max over r splits among tied maxima):
//   g_a[n, r]    = 20 over norm_r bal(a)                     (dL/d routed)
//   g_rep[t, r]  = price_safe[t] [w == z] / #ties * inv_alloc (dL/d rep)
//   g_route[q]   = -10 pend_weight mass bal(1 - route), g_mass[q] = 10 pend_weight h
//   g_disp[q, r] = sum_n yc g_a + sum_t yr g_rep + g_mass norm_r
//   g_y[q, n]    = compat (sum_r g_a[n, r] disp[q, r] + g_route[q])
//   g_yr[q, t]   = sum_r g_rep[t, r] disp[q, r] + g_route[q]
//   g_d[n]       = sum_r g_a slack + sum_q onehot sum_r used g_disp - price + cw cost
// then Adam (bias corrections from the table `corr`, as XLA:CPU forms them),
// the clip of d to [0, 1] and the projection of (y, yr) onto the simplex.
//
// What bounds it on an H100: latency. One step is ~30 (N + T) Q R flops
// (~4 MFLOP at Np = 8192, Tp = 2048, Q = R = 4), read from state that sits
// in L2 (~0.6 MB per init), but each step is a chain of phases that each
// wait for the last: three reductions over the node and row axes (the class
// tables, dL/d disp, the projection's row sums) with elementwise work
// between them. 8 inits x 300 steps.
//
// Design: a cluster of K5_CLUSTER 1024-thread blocks per init runs all
// steps (inits are independent: no grid-wide sync). Block `rank` of the
// cluster owns a slice of the nodes and a slice of the replacement rows and
// does all elementwise work there; each reduction is summed per block (all
// threads, K5_CHUNK outputs at a time), then across the cluster through
// distributed shared memory, in rank order, so every block holds the same
// totals. The state, the Adam moments and the two gradient planes
// g_a [N, R] and g_rep [T, R] live in global memory (the wrapper allocates
// them); the class-by-resource tables in shared memory. Every sum is taken
// in double and rounded to float once: the plain version does the same, so
// kernel and plain version differ only where two double sums in different
// orders round to different floats. Elementwise work is float32 in the
// plain version's order, built with -fmad=false and IEEE division and
// square root.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define K5_THREADS 1024
#define K5_WARPS (K5_THREADS / 32)
#define K5_CLUSTER 8  // blocks per init (the portable cluster size)
#define K5_CHUNK 8    // outputs one block-wide reduction pass carries
#define K5_MAX_R 16
#define K5_MAX_Q 64
#define K5_MAX_V (K5_MAX_Q * K5_MAX_R + 2 * K5_MAX_Q)
#define PRICE_CAP 1e6f

struct GP {
  const float *price, *cost, *slack, *used, *row_price, *row_alloc, *onehot, *compat, *pend_mass, *pend_weight;
  const float* corr;
  int N, R, Q, T;
  float cw, b1, b2, c1, c2, lr, eps;
  // this init's state
  float *d, *y, *yr, *md, *vd, *my, *vy, *myr, *vyr, *g_a, *g_rep;
  // this block's slices: nodes [n0, n0 + nn), rows [t0, t0 + nt)
  int n0, nn, t0, nt;
  int buf;  // the partial-sum buffer the next reduction writes (the same in every thread)
};

struct Shared {
  double part[2][K5_MAX_V];  // this block's partial sums, read by the whole cluster
  double tot[K5_MAX_V];      // the cluster's sums
  double wpart[K5_WARPS][K5_CHUNK];
  float disp[K5_MAX_Q * K5_MAX_R];
  float gdisp[K5_MAX_Q * K5_MAX_R];
  float norm[K5_MAX_R];
  float cm[K5_MAX_Q], h[K5_MAX_Q], groute[K5_MAX_Q], gcm[K5_MAX_Q], scale[K5_MAX_Q];
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bal(float x) { return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f); }

__device__ __forceinline__ float inv_alloc(const GP& p, int t, int r) {
  const float a = p.row_alloc[(size_t)t * p.R + r];
  return a > 0.0f ? 1.0f / fmaxf(a, 1e-9f) : PRICE_CAP;
}

__device__ __forceinline__ float yc_of(const GP& p, int q, int n) {
  const size_t i = (size_t)q * p.N + n;
  return p.y[i] * p.compat[i];
}

// s.tot[v] = sum over the block's slices of term(i, v), i < nn + nt (i < nn:
// node n0 + i; else row t0 + i - nn), then over the cluster's blocks in rank
// order, for v < V. Every thread of every block of the cluster calls it.
template <class Term>
__device__ void cluster_sums(GP& p, Shared& s, int V, const Term& term) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* out = s.part[p.buf];
  const int len = p.nn + p.nt;
  for (int v0 = 0; v0 < V; v0 += K5_CHUNK) {
    double acc[K5_CHUNK];
#pragma unroll
    for (int c = 0; c < K5_CHUNK; ++c) acc[c] = 0.0;
    for (int i = threadIdx.x; i < len; i += K5_THREADS) {
#pragma unroll
      for (int c = 0; c < K5_CHUNK; ++c)
        if (v0 + c < V) acc[c] += term(i, v0 + c);
    }
#pragma unroll
    for (int c = 0; c < K5_CHUNK; ++c) {
      const double w = warp_sum(acc[c]);
      if (lane == 0) s.wpart[warp][c] = w;
    }
    __syncthreads();
    if (threadIdx.x < K5_CHUNK && v0 + (int)threadIdx.x < V) {
      double t = 0.0;
      for (int w = 0; w < K5_WARPS; ++w) t += s.wpart[w][threadIdx.x];
      out[v0 + threadIdx.x] = t;
    }
    __syncthreads();
  }
  // every block's partials are written; a block writes this buffer again only
  // two reductions later, after the next cluster barrier, which every block
  // reaches only when it has read this one
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  for (int v = threadIdx.x; v < V; v += K5_THREADS) {
    double t = 0.0;
    for (int r = 0; r < K5_CLUSTER; ++r) t += cl.map_shared_rank(out, r)[v];
    s.tot[v] = t;
  }
  p.buf ^= 1;
  __syncthreads();
}

// disp, the route totals, the class masses and the hinge's pieces.
__device__ void class_tables(GP& p, Shared& s) {
  const int QR = p.Q * p.R, Q = p.Q, R = p.R, nn = p.nn;
  cluster_sums(p, s, QR + 2 * Q, [&](int i, int k) -> double {
    if (i < nn) {
      const int n = p.n0 + i;
      if (k < QR)
        return (double)(p.onehot[(size_t)n * Q + k / R] * p.d[n]) * (double)p.used[(size_t)n * R + k % R];
      return k < QR + Q ? (double)yc_of(p, k - QR, n) : 0.0;
    }
    return k >= QR + Q ? (double)p.yr[(size_t)(k - QR - Q) * p.T + p.t0 + (i - nn)] : 0.0;
  });
  for (int k = threadIdx.x; k < QR; k += K5_THREADS) s.disp[k] = p.pend_mass[k] + (float)s.tot[k];
  __syncthreads();
  const int q = threadIdx.x;
  if (q < Q) {
    const float route = (float)s.tot[QR + q] + (float)s.tot[QR + Q + q];
    double m = 0.0;
    for (int r = 0; r < R; ++r) m += (double)(s.disp[q * R + r] * s.norm[r]);
    const float cm = (float)m;
    const float u = 1.0f - route;
    const float h = fmaxf(u, 0.0f);
    const float ghcm = 10.0f * p.pend_weight[q];
    s.cm[q] = cm;
    s.h[q] = h;
    s.gcm[q] = ghcm * h;
    s.groute[q] = -((ghcm * cm) * bal(u));
  }
  __syncthreads();
}

// Project (y, yr) rows onto the simplex: y and yr already hold max(., 0)
// (y masked by compat); divide each class row by its sum.
__device__ void project_finish(GP& p, Shared& s) {
  const int Q = p.Q, nn = p.nn;
  cluster_sums(p, s, 2 * Q, [&](int i, int k) -> double {
    if (i < nn) return k < Q ? (double)p.y[(size_t)k * p.N + p.n0 + i] : 0.0;
    return k >= Q ? (double)p.yr[(size_t)(k - Q) * p.T + p.t0 + (i - nn)] : 0.0;
  });
  if (threadIdx.x < Q) {
    const float tot = (float)s.tot[threadIdx.x] + (float)s.tot[Q + threadIdx.x];
    s.scale[threadIdx.x] = 1.0f / fmaxf(tot, 1e-9f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q * nn; i += K5_THREADS) {
    const size_t k = (size_t)(i / nn) * p.N + p.n0 + i % nn;
    p.y[k] = p.y[k] * s.scale[i / nn];
  }
  for (int i = threadIdx.x; i < Q * p.nt; i += K5_THREADS) {
    const size_t k = (size_t)(i / p.nt) * p.T + p.t0 + i % p.nt;
    p.yr[k] = p.yr[k] * s.scale[i / p.nt];
  }
  __syncthreads();
}

// routed - keep * slack for node n, resource r
__device__ __forceinline__ float hinge_arg(const GP& p, const Shared& s, int n, int r) {
  double acc = 0.0;
  for (int q = 0; q < p.Q; ++q) acc += (double)yc_of(p, q, n) * (double)s.disp[q * p.R + r];
  return (float)acc - (1.0f - p.d[n]) * p.slack[(size_t)n * p.R + r];
}

// Adam on one coordinate; returns the stepped (unprojected) value.
__device__ __forceinline__ float adam(const GP& p, float x, float g, float* m, float* v, size_t i, float corr1,
                                      float corr2) {
  const float mi = p.b1 * m[i] + p.c1 * g;
  const float vi = p.b2 * v[i] + (p.c2 * g) * g;
  m[i] = mi;
  v[i] = vi;
  const float upd = (mi / corr1) / (sqrtf(vi / corr2) + p.eps);
  return x - p.lr * upd;
}

__device__ void step(GP& p, Shared& s, int it) {
  const int R = p.R, Q = p.Q, T = p.T, N = p.N, nn = p.nn, nt = p.nt;
  class_tables(p, s);
  // dL/d routed and dL/d rep on this block's slices
  for (int i = threadIdx.x; i < nn * R; i += K5_THREADS) {
    const int n = p.n0 + i / R, r = i % R;
    const float a = hinge_arg(p, s, n, r);
    const float over = fmaxf(a, 0.0f) * s.norm[r];
    p.g_a[(size_t)n * R + r] = ((20.0f * over) * s.norm[r]) * bal(a);
  }
  for (int t = p.t0 + threadIdx.x; t < p.t0 + nt; t += K5_THREADS) {
    float w[K5_MAX_R];
    float z = -INFINITY;
#pragma unroll
    for (int r = 0; r < K5_MAX_R; ++r) {
      if (r >= R) break;
      double acc = 0.0;
      for (int q = 0; q < Q; ++q) acc += (double)p.yr[(size_t)q * T + t] * (double)s.disp[q * R + r];
      w[r] = (float)acc * inv_alloc(p, t, r);
      z = fmaxf(z, w[r]);
    }
    float ties = 0.0f;
#pragma unroll
    for (int r = 0; r < K5_MAX_R; ++r)
      if (r < R && w[r] == z) ties += 1.0f;
    const float ps = fminf(p.row_price[t], PRICE_CAP);
#pragma unroll
    for (int r = 0; r < K5_MAX_R; ++r) {
      if (r >= R) break;
      const float ind = w[r] == z ? 1.0f : 0.0f;
      p.g_rep[(size_t)t * R + r] = ((ps * ind) / ties) * inv_alloc(p, t, r);
    }
  }
  __syncthreads();
  // dL/d disp
  cluster_sums(p, s, Q * R, [&](int i, int k) -> double {
    const int q = k / R, r = k % R;
    if (i < nn) {
      const int n = p.n0 + i;
      return (double)yc_of(p, q, n) * (double)p.g_a[(size_t)n * R + r];
    }
    const int t = p.t0 + (i - nn);
    return (double)p.yr[(size_t)q * T + t] * (double)p.g_rep[(size_t)t * R + r];
  });
  for (int k = threadIdx.x; k < Q * R; k += K5_THREADS)
    s.gdisp[k] = (float)(s.tot[k] + (double)(s.gcm[k / R] * s.norm[k % R]));
  __syncthreads();
  const float corr1 = p.corr[2 * it], corr2 = p.corr[2 * it + 1];
  // d: gradient, Adam, clip
  for (int n = p.n0 + threadIdx.x; n < p.n0 + nn; n += K5_THREADS) {
    double acc = 0.0;
    for (int r = 0; r < R; ++r) acc += (double)p.g_a[(size_t)n * R + r] * (double)p.slack[(size_t)n * R + r];
    double cls = 0.0;
    for (int q = 0; q < Q; ++q) {
      double pc = 0.0;
      for (int r = 0; r < R; ++r) pc += (double)p.used[(size_t)n * R + r] * (double)s.gdisp[q * R + r];
      cls += (double)p.onehot[(size_t)n * Q + q] * pc;
    }
    const float gd = (float)(acc + cls - (double)p.price[n] + (double)(p.cw * p.cost[n]));
    const float dn = adam(p, p.d[n], gd, p.md, p.vd, n, corr1, corr2);
    p.d[n] = fminf(fmaxf(dn, 0.0f), 1.0f);
  }
  // y: gradient, Adam, first half of the projection
  for (int j = threadIdx.x; j < Q * nn; j += K5_THREADS) {
    const int q = j / nn, n = p.n0 + j % nn;
    const size_t i = (size_t)q * N + n;
    double acc = 0.0;
    for (int r = 0; r < R; ++r) acc += (double)p.g_a[(size_t)n * R + r] * (double)s.disp[q * R + r];
    const float gy = (float)(acc + (double)s.groute[q]) * p.compat[i];
    const float yn = adam(p, p.y[i], gy, p.my, p.vy, i, corr1, corr2);
    p.y[i] = fmaxf(yn, 0.0f) * p.compat[i];
  }
  for (int j = threadIdx.x; j < Q * nt; j += K5_THREADS) {
    const int q = j / nt, t = p.t0 + j % nt;
    const size_t i = (size_t)q * T + t;
    double acc = 0.0;
    for (int r = 0; r < R; ++r) acc += (double)p.g_rep[(size_t)t * R + r] * (double)s.disp[q * R + r];
    const float gyr = (float)(acc + (double)s.groute[q]);
    const float yn = adam(p, p.yr[i], gyr, p.myr, p.vyr, i, corr1, corr2);
    p.yr[i] = fmaxf(yn, 0.0f);
  }
  __syncthreads();
  project_finish(p, s);
}

// The objective at the current (d, y, yr); valid in thread 0.
__device__ float objective(GP& p, Shared& s) {
  const int R = p.R, Q = p.Q, T = p.T, nn = p.nn;
  class_tables(p, s);
  // 0: sum over^2, 1: sum price_safe z, 2: sum d price, 3: sum d cost
  cluster_sums(p, s, 4, [&](int i, int k) -> double {
    if (i < nn) {
      const int n = p.n0 + i;
      if (k == 0) {
        double cap = 0.0;
        for (int r = 0; r < R; ++r) {
          const float over = fmaxf(hinge_arg(p, s, n, r), 0.0f) * s.norm[r];
          cap += (double)(over * over);
        }
        return cap;
      }
      if (k == 2) return (double)(p.d[n] * p.price[n]);
      if (k == 3) return (double)(p.d[n] * p.cost[n]);
      return 0.0;
    }
    if (k != 1) return 0.0;
    const int t = p.t0 + (i - nn);
    float z = -INFINITY;
    for (int r = 0; r < R; ++r) {
      double acc = 0.0;
      for (int q = 0; q < Q; ++q) acc += (double)p.yr[(size_t)q * T + t] * (double)s.disp[q * R + r];
      z = fmaxf(z, (float)acc * inv_alloc(p, t, r));
    }
    return (double)(fminf(p.row_price[t], PRICE_CAP) * z);
  });
  float out = 0.0f;
  if (threadIdx.x == 0) {
    double un = 0.0;
    for (int q = 0; q < Q; ++q) un += (double)((s.h[q] * s.cm[q]) * p.pend_weight[q]);
    const float savings = (float)s.tot[2] - p.cw * (float)s.tot[3];
    out = ((savings - (float)s.tot[1]) - 10.0f * (float)s.tot[0]) - 10.0f * (float)un;
  }
  return out;
}

__global__ void __cluster_dims__(K5_CLUSTER, 1, 1) __launch_bounds__(K5_THREADS)
globalpack_kernel(GP base, const float* __restrict__ d0, const float* __restrict__ y0, int n_iters,
                  float* __restrict__ score) {
  __shared__ Shared s;
  cg::cluster_group cl = cg::this_cluster();
  const int c = blockIdx.x / K5_CLUSTER, rank = (int)cl.block_rank();
  const int N = base.N, R = base.R, Q = base.Q, T = base.T;
  GP p = base;
  p.d += (size_t)c * N;
  p.md += (size_t)c * N;
  p.vd += (size_t)c * N;
  p.y += (size_t)c * Q * N;
  p.my += (size_t)c * Q * N;
  p.vy += (size_t)c * Q * N;
  p.yr += (size_t)c * Q * T;
  p.myr += (size_t)c * Q * T;
  p.vyr += (size_t)c * Q * T;
  p.g_a += (size_t)c * N * R;
  p.g_rep += (size_t)c * T * R;
  p.n0 = (int)((long long)N * rank / K5_CLUSTER);
  p.nn = (int)((long long)N * (rank + 1) / K5_CLUSTER) - p.n0;
  p.t0 = (int)((long long)T * rank / K5_CLUSTER);
  p.nt = (int)((long long)T * (rank + 1) / K5_CLUSTER) - p.t0;
  p.buf = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // per-resource normalisation: 1 / max(max used, max slack, max pend_mass, 0)
  for (int r = warp; r < R; r += K5_WARPS) {
    float mx = 0.0f;
    for (int n = lane; n < N; n += 32)
      mx = fmaxf(mx, fmaxf(p.used[(size_t)n * R + r], p.slack[(size_t)n * R + r]));
    for (int q = lane; q < Q; q += 32) mx = fmaxf(mx, p.pend_mass[q * R + r]);
    mx = warp_max(mx);
    if (lane == 0) s.norm[r] = 1.0f / fmaxf(mx, 1e-9f);
  }
  // inits on this block's slices: d0, y0 and yr = 0.5, projected; Adam moments zero
  for (int n = p.n0 + threadIdx.x; n < p.n0 + p.nn; n += K5_THREADS) {
    p.d[n] = d0[(size_t)c * N + n];
    p.md[n] = 0.0f;
    p.vd[n] = 0.0f;
  }
  for (int j = threadIdx.x; j < Q * p.nn; j += K5_THREADS) {
    const size_t i = (size_t)(j / p.nn) * N + p.n0 + j % p.nn;
    p.y[i] = fmaxf(y0[(size_t)c * Q * N + i], 0.0f) * p.compat[i];
    p.my[i] = 0.0f;
    p.vy[i] = 0.0f;
  }
  for (int j = threadIdx.x; j < Q * p.nt; j += K5_THREADS) {
    const size_t i = (size_t)(j / p.nt) * T + p.t0 + j % p.nt;
    p.yr[i] = 0.5f;
    p.myr[i] = 0.0f;
    p.vyr[i] = 0.0f;
  }
  __syncthreads();
  project_finish(p, s);
  for (int it = 0; it < n_iters; ++it) step(p, s, it);
  const float obj = objective(p, s);
  if (rank == 0 && threadIdx.x == 0) score[c] = obj;
  cl.sync();  // no block leaves while another may still read its shared memory
}

extern "C" int kt_globalpack(const void* price, const void* cost, const void* slack, const void* used,
                             const void* row_price, const void* row_alloc, const void* onehot, const void* compat_qn,
                             const void* pend_mass, const void* pend_weight, const void* d0, const void* y0,
                             const void* corr, int C, int N, int R, int Q, int T, int n_iters, float cw, float b1,
                             float b2, float c1, float c2, float lr, float eps, void* d, void* y, void* yr, void* md,
                             void* vd, void* my, void* vy, void* myr, void* vyr, void* g_a, void* g_rep, void* score,
                             void* stream) {
  if (R > K5_MAX_R || Q > K5_MAX_Q) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  GP p;
  p.price = (const float*)price;
  p.cost = (const float*)cost;
  p.slack = (const float*)slack;
  p.used = (const float*)used;
  p.row_price = (const float*)row_price;
  p.row_alloc = (const float*)row_alloc;
  p.onehot = (const float*)onehot;
  p.compat = (const float*)compat_qn;
  p.pend_mass = (const float*)pend_mass;
  p.pend_weight = (const float*)pend_weight;
  p.corr = (const float*)corr;
  p.N = N;
  p.R = R;
  p.Q = Q;
  p.T = T;
  p.cw = cw;
  p.b1 = b1;
  p.b2 = b2;
  p.c1 = c1;
  p.c2 = c2;
  p.lr = lr;
  p.eps = eps;
  p.d = (float*)d;
  p.y = (float*)y;
  p.yr = (float*)yr;
  p.md = (float*)md;
  p.vd = (float*)vd;
  p.my = (float*)my;
  p.vy = (float*)vy;
  p.myr = (float*)myr;
  p.vyr = (float*)vyr;
  p.g_a = (float*)g_a;
  p.g_rep = (float*)g_rep;
  globalpack_kernel<<<C * K5_CLUSTER, K5_THREADS, 0, (cudaStream_t)stream>>>(p, (const float*)d0, (const float*)y0,
                                                                              n_iters, (float*)score);
  return (int)cudaGetLastError();
}
