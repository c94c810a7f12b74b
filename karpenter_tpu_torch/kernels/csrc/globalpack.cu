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
// (~4 MFLOP at Np = 8192, Tp = 2048, Q = R = 4), but each step is a chain of
// phases that each wait for the last: three reductions over the node and
// row axes (the class tables, dL/d disp, the projection's row sums) with
// elementwise work between them; 8 inits x 300 steps. Measured on the first
// design (a cluster of eight 1024-thread blocks per init, state in global
// memory, reductions 8 outputs a pass): 47% of a step in the reductions'
// block passes (one warp shuffle tree per output: shuffle-throughput bound),
// 37% in elementwise loops waiting on L2 loads, 8% in cluster barriers and
// distributed-shared-memory reads.
//
// Design: a cluster of `cl` blocks per init runs all steps: 16 blocks of
// 256 threads for the common shape (Qp = R = 4 with the state in shared
// memory: with C = 8 inits, 128 of the H100's 132 SMs), else 8 of 512.
// Block `rank` owns a slice of the nodes and of the replacement rows. Its
// slice of every per-node and per-row array (the inputs, d, y, yr, their
// Adam moments, g_a and g_rep) lives, SoA, in shared memory for all steps.
// Past the shared-memory budget (large Q, R or N) the Adam moments, which
// only the updates touch, move to a slice of a global scratch, behind the
// same pointers, and past it again everything does. Each reduction is one
// block pass per K5_VC outputs (all of them at Q = R = 4 but the class
// tables' 24): every thread sums its items' terms in registers, a warp's 32
// lanes combine them by a reduce-scatter butterfly (16 double shuffles for
// 16 outputs, not 80), then the warps' sums in order; each block pushes its
// sums into every rank's inbox (distributed shared memory) before the
// cluster barrier, and after it sums its own inbox in rank order, so every
// block holds the same totals without a remote read. The elementwise loops
// read each node's and row's data once per phase: the updates of d and y
// share one node loop. The common shape (Qp = R = 4) has its own build with
// Q and R fixed at compile time (its loops unroll, its reductions' (q, r)
// are constants); other shapes read them. Every sum is taken in double and
// rounded to float once: the plain version does the same, so kernel and
// plain version differ only where two double sums in different orders
// round to different floats. Elementwise work is float32 in the plain
// version's order, built with -fmad=false and IEEE division and square
// root.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

#define K5_THREADS 512  // threads of a block of an 8-block cluster (the 16-block clusters: 256)
#define K5_WARPS (K5_THREADS / 32)  // the most warps a block has
#define K5_VC 16         // outputs one reduction pass carries in registers
#define K5_SMEM_BUDGET (232448 - 2048)  // dynamic shared memory a block may take, less the static part
#define PRICE_CAP 1e6f

// the three reductions and the objective's sums; their outputs' (q, r)
enum { RD_TABLES = 0, RD_GDISP = 1, RD_PROJ = 2, RD_OBJ = 3, N_RD };

// Per block: the small tables (the reductions' inboxes [2][cl][V1], totals
// [V1], warp partials [2][warps][VC] and the double copies of disp and
// g_disp, all doubles; then disp, g_disp [Q R], norm [R] and five [Q] class
// tables), the arena (the node fields of `node_fields` x NS floats, the row
// fields of `row_fields` x TS) and the Adam moments (`node_moments` x NS,
// `row_moments` x TS). All three are in shared memory where they fit; else
// the moments go to the global scratch; else everything does. The accessors
// below (`part_of` ..., `nf`, `rf`, `mf`, `mrf`) address them in this order.
struct Layout {
  int NS, TS, V1;  // node and row slice strides; outputs of the largest reduction
  size_t small_w, arena_w, mom_w, bytes;  // 4-byte words of each; shared-memory bytes
  bool arena_s, mom_s;  // the small tables and the arena in shared memory; the moments too
};

__host__ __device__ inline int node_fields(int R, int Q) { return 3 + 3 * R + 3 * Q; }
__host__ __device__ inline int row_fields(int R, int Q) { return 1 + 3 * R + Q; }
__host__ __device__ inline int node_moments(int Q) { return 2 + 2 * Q; }
__host__ __device__ inline int row_moments(int Q) { return 2 * Q; }

__host__ __device__ inline Layout layout_of(int N, int R, int Q, int T, int cl) {
  Layout L;
  L.NS = (N + cl - 1) / cl;
  L.TS = (T + cl - 1) / cl;
  L.V1 = max(Q * R + 2 * Q, 4);  // the objective's 4 sums too
  const size_t doubles = 2 * (size_t)cl * L.V1 + L.V1 + 2 * (size_t)K5_WARPS * K5_VC + 2 * (size_t)Q * R;
  L.small_w = (2 * doubles + 2 * (size_t)Q * R + R + 5 * (size_t)Q + 3) & ~(size_t)3;
  L.arena_w = ((size_t)node_fields(R, Q) * L.NS + (size_t)row_fields(R, Q) * L.TS + 3) & ~(size_t)3;
  L.mom_w = ((size_t)node_moments(Q) * L.NS + (size_t)row_moments(Q) * L.TS + 3) & ~(size_t)3;
  L.mom_s = 4 * (L.small_w + L.arena_w + L.mom_w) <= K5_SMEM_BUDGET;
  L.arena_s = L.mom_s || 4 * (L.small_w + L.arena_w) <= K5_SMEM_BUDGET;
  L.bytes = L.mom_s ? 4 * (L.small_w + L.arena_w + L.mom_w) : (L.arena_s ? 4 * (L.small_w + L.arena_w) : 0);
  return L;
}

// global scratch words one block needs (the regions shared memory does not
// hold: the small tables and the arena, then the moments)
__host__ __device__ inline size_t spill_words(const Layout& L) {
  return (L.arena_s ? 0 : L.small_w + L.arena_w) + (L.mom_s ? 0 : L.mom_w);
}

// QT, RT > 0 fix Q and R at compile time (the common shape, Qp = R = 4,
// has its own build of the same code); 0 reads them from Qr, Rr
template <int QT, int RT, int NTH>
struct GP {
  static constexpr int kThreads = NTH;
  static constexpr int kWarps = NTH / 32;
  const float *price, *cost, *slack, *used, *row_price, *row_alloc, *onehot, *compat, *pend_mass, *pend_weight;
  const float* corr;
  int N, Rr, Qr, T, cl, V1;
  __device__ __forceinline__ int Q() const { return QT > 0 ? QT : Qr; }
  __device__ __forceinline__ int R() const { return RT > 0 ? RT : Rr; }
  float cw, b1, b2, c1, c2, lr, eps;
  // this block's slices: nodes [n0, n0 + nn), rows [t0, t0 + nt)
  int n0, nn, t0, nt, rank, NS, TS;
  int buf;  // the partial-sum buffer the next reduction writes (the same in every thread)
  float* small;  // the small tables (Layout offsets)
  float* arena;  // the slices' fields: node field k at arena + k NS, row field k at rows + k TS
  float* rows;
  float* mom;  // the slices' Adam moments: node field k at mom + k NS, row field k at rows_mom + k TS
  float* rows_mom;
  // the first block of this cluster's slice of the global scratch (peers' small tables)
  float* gsmall0;
  size_t gstride;
};

// the small tables (offsets as in `layout_of`)
template <class P>
__device__ __forceinline__ double* part_of(const P& p, int b) {
  return reinterpret_cast<double*>(p.small) + (size_t)b * p.cl * p.V1;
}
template <class P>
__device__ __forceinline__ double* tot_of(const P& p) {
  return reinterpret_cast<double*>(p.small) + 2 * (size_t)p.cl * p.V1;
}
template <class P>
__device__ __forceinline__ double* wpart_of(const P& p) { return tot_of(p) + p.V1; }
template <class P>
__device__ __forceinline__ double* dispd_of(const P& p) { return wpart_of(p) + 2 * K5_WARPS * K5_VC; }
template <class P>
__device__ __forceinline__ double* gdispd_of(const P& p) { return dispd_of(p) + p.Q() * p.R(); }
template <class P>
__device__ __forceinline__ float* disp_of(const P& p) {
  return reinterpret_cast<float*>(gdispd_of(p) + p.Q() * p.R());
}
template <class P>
__device__ __forceinline__ float* gdisp_of(const P& p) { return disp_of(p) + p.Q() * p.R(); }
template <class P>
__device__ __forceinline__ float* norm_of(const P& p) { return disp_of(p) + 2 * p.Q() * p.R(); }
template <class P>
__device__ __forceinline__ float* cls_of(const P& p, int k) { return norm_of(p) + p.R() + k * p.Q(); }  // cm h groute gcm scale
enum { C_CM = 0, C_H, C_GROUTE, C_GCM, C_SCALE };

// the slices' fields: node fields d, y[Q], g_a[R], price, cost, slack[R],
// used[R], onehot[Q], compat[Q]; row fields yr[Q], g_rep[R], row_price,
// alloc[R], inv_alloc[R]; moments: node md, vd, my[Q], vy[Q]; row myr[Q],
// vyr[Q]
template <class P>
__device__ __forceinline__ float* nf(const P& p, int k) { return p.arena + (size_t)k * p.NS; }
template <class P>
__device__ __forceinline__ float* rf(const P& p, int k) { return p.rows + (size_t)k * p.TS; }
template <class P>
__device__ __forceinline__ float* mf(const P& p, int k) { return p.mom + (size_t)k * p.NS; }
template <class P>
__device__ __forceinline__ float* mrf(const P& p, int k) { return p.rows_mom + (size_t)k * p.TS; }
template <class P>
__device__ __forceinline__ float* f_d(const P& p) { return nf(p, 0); }
template <class P>
__device__ __forceinline__ float* f_y(const P& p, int q) { return nf(p, 1 + q); }
template <class P>
__device__ __forceinline__ float* f_ga(const P& p, int r) { return nf(p, 1 + p.Q() + r); }
template <class P>
__device__ __forceinline__ float* f_price(const P& p) { return nf(p, 1 + p.Q() + p.R()); }
template <class P>
__device__ __forceinline__ float* f_cost(const P& p) { return nf(p, 2 + p.Q() + p.R()); }
template <class P>
__device__ __forceinline__ float* f_slack(const P& p, int r) { return nf(p, 3 + p.Q() + p.R() + r); }
template <class P>
__device__ __forceinline__ float* f_used(const P& p, int r) { return nf(p, 3 + p.Q() + 2 * p.R() + r); }
template <class P>
__device__ __forceinline__ float* f_onehot(const P& p, int q) { return nf(p, 3 + p.Q() + 3 * p.R() + q); }
template <class P>
__device__ __forceinline__ float* f_compat(const P& p, int q) { return nf(p, 3 + 2 * p.Q() + 3 * p.R() + q); }
template <class P>
__device__ __forceinline__ float* f_md(const P& p) { return mf(p, 0); }
template <class P>
__device__ __forceinline__ float* f_vd(const P& p) { return mf(p, 1); }
template <class P>
__device__ __forceinline__ float* f_my(const P& p, int q) { return mf(p, 2 + q); }
template <class P>
__device__ __forceinline__ float* f_vy(const P& p, int q) { return mf(p, 2 + p.Q() + q); }
template <class P>
__device__ __forceinline__ float* f_yr(const P& p, int q) { return rf(p, q); }
template <class P>
__device__ __forceinline__ float* f_grep(const P& p, int r) { return rf(p, p.Q() + r); }
template <class P>
__device__ __forceinline__ float* f_rprice(const P& p) { return rf(p, p.Q() + p.R()); }
template <class P>
__device__ __forceinline__ float* f_alloc(const P& p, int r) { return rf(p, 1 + p.Q() + p.R() + r); }
template <class P>
__device__ __forceinline__ float* f_inva(const P& p, int r) { return rf(p, 1 + p.Q() + 2 * p.R() + r); }
template <class P>
__device__ __forceinline__ float* f_myr(const P& p, int q) { return mrf(p, q); }
template <class P>
__device__ __forceinline__ float* f_vyr(const P& p, int q) { return mrf(p, p.Q() + q); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bal(float x) { return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f); }

template <class P>
__device__ __forceinline__ float yc_of(const P& p, int q, int i) { return f_y(p, q)[i] * f_compat(p, q)[i]; }

// One level of the warp's reduce-scatter, then the next: lanes with bit
// (2 H) set keep the upper H of the 2 H values they hold, the others the
// lower H, each adding its partner's copy.
template <int H>
__device__ __forceinline__ void butterfly(double* acc, int lane) {
  if constexpr (H >= 1) {
    const bool hi = (lane & (2 * H)) != 0;
#pragma unroll
    for (int c = 0; c < H; ++c) {
      const double send = hi ? acc[c] : acc[c + H];
      const double keep = hi ? acc[c + H] : acc[c];
      acc[c] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
    }
    butterfly<H / 2>(acc, lane);
  }
}

// output k of reduction rd -> its (q, r): the class tables' QR
// class-by-resource sums then the two route sums per class; dL/d disp's QR;
// the projection's two row sums per class; the objective's four scalars
template <class P>
__device__ __forceinline__ void decode(const P& p, int rd, int k, int& q, int& r) {
  const int Q = p.Q(), R = p.R(), QR = Q * R;
  q = r = 0;
  if (rd == RD_TABLES || rd == RD_GDISP) {
    if (k < QR) {
      q = k / R;
      r = k % R;
    } else {
      q = (k - QR) % Q;
    }
  } else if (rd == RD_PROJ) {
    q = k % Q;
  }
}

// p.tot[v] = sum over the block's slices of term(i, k, q, r), i < nn + nt
// (i < nn: node i of the slice; else row i - nn), then over the cluster's
// blocks in rank order, for v < V, where (q, r) is output k's (q, r) by
// `decode`. Every thread of every block of the cluster calls it. SMEM: the
// inboxes are in shared memory (peers write them through distributed
// shared memory), else in the global scratch.
template <bool SMEM, class P, class Term>
__device__ __forceinline__ void cluster_sums(P& p, int rd, int V, const Term& term) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cg::cluster_group cl = cg::this_cluster();
  // this reduction's inbox: [cl][V1], rank r's partials at row r, in every block
  double* inbox = part_of(p, p.buf);
  const int len = p.nn + p.nt;
  double* wpart = wpart_of(p);
#pragma unroll
  for (int v0 = 0; v0 < V; v0 += K5_VC) {
    const int pass = v0 / K5_VC;
    double acc[K5_VC];
    // the pass's outputs' (q, r), decoded once per pass; per term where the
    // state is in the global scratch (its 64-bit addresses leave no
    // registers to hold them)
    int qv[K5_VC], rv[K5_VC];
#pragma unroll
    for (int c = 0; c < K5_VC; ++c) {
      acc[c] = 0.0;
      if (SMEM) decode(p, rd, v0 + c, qv[c], rv[c]);
    }
    for (int i = threadIdx.x; i < len; i += P::kThreads) {
#pragma unroll
      for (int c = 0; c < K5_VC; ++c)
        if (v0 + c < V) {
          if (!SMEM) decode(p, rd, v0 + c, qv[c], rv[c]);
          acc[c] += term(i, v0 + c, qv[c], rv[c]);
        }
    }
    // reduce-scatter over the warp: after each level, lane l holds the
    // partials of the outputs whose index bits match its lane bits 4, 3, ...
    butterfly<K5_VC / 2>(acc, lane);
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
    const int idx = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
    double* wp = wpart + (size_t)(pass & 1) * K5_WARPS * K5_VC;
    if ((lane & 1) == 0) wp[warp * K5_VC + idx] = acc[0];
    __syncthreads();
    // the block's sums, pushed into every rank's inbox (distributed shared
    // memory, or the peers' slices of the global scratch)
    if (threadIdx.x < K5_VC && v0 + (int)threadIdx.x < V) {
      double t = 0.0;
      for (int w = 0; w < P::kWarps; ++w) t += wp[w * K5_VC + threadIdx.x];
      const size_t at = (size_t)p.rank * p.V1 + v0 + threadIdx.x;
      for (int r = 0; r < p.cl; ++r) {
        if (SMEM) {
          cl.map_shared_rank(inbox, r)[at] = t;
        } else {
          const size_t off = (size_t)(reinterpret_cast<float*>(inbox) - p.small);
          reinterpret_cast<double*>(p.gsmall0 + (size_t)r * p.gstride + off)[at] = t;
        }
      }
    }
  }
  // every rank's partials are in every inbox; a rank writes into this inbox
  // again only two reductions later, after the next cluster barrier, which
  // every block reaches only when it has read this one
  if (!SMEM) __threadfence();
  cl.sync();
  double* tot = tot_of(p);
  for (int v = threadIdx.x; v < V; v += P::kThreads) {
    double t = 0.0;
    for (int r = 0; r < p.cl; ++r) t += inbox[(size_t)r * p.V1 + v];
    tot[v] = t;
  }
  p.buf ^= 1;
  __syncthreads();
}

// disp, the route totals, the class masses and the hinge's pieces.
template <bool SMEM, class P>
__device__ __forceinline__ void class_tables(P& p) {
  const int QR = p.Q() * p.R(), Q = p.Q(), R = p.R(), nn = p.nn;
  cluster_sums<SMEM>(p, RD_TABLES, QR + 2 * Q, [&](int i, int k, int q, int r) -> double {
    if (i < nn) {
      if (k < QR) return (double)(f_onehot(p, q)[i] * f_d(p)[i]) * (double)f_used(p, r)[i];
      return k < QR + Q ? (double)yc_of(p, q, i) : 0.0;
    }
    return k >= QR + Q ? (double)f_yr(p, q)[i - nn] : 0.0;
  });
  const double* tot = tot_of(p);
  float* disp = disp_of(p);
  const float* norm = norm_of(p);
  double* dispd = dispd_of(p);
  for (int k = threadIdx.x; k < QR; k += P::kThreads) {
    disp[k] = p.pend_mass[k] + (float)tot[k];
    dispd[k] = (double)disp[k];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += P::kThreads) {
    const float route = (float)tot[QR + q] + (float)tot[QR + Q + q];
    double m = 0.0;
    for (int r = 0; r < R; ++r) m += (double)(disp[q * R + r] * norm[r]);
    const float cm = (float)m;
    const float u = 1.0f - route;
    const float h = fmaxf(u, 0.0f);
    const float ghcm = 10.0f * p.pend_weight[q];
    cls_of(p, C_CM)[q] = cm;
    cls_of(p, C_H)[q] = h;
    cls_of(p, C_GCM)[q] = ghcm * h;
    cls_of(p, C_GROUTE)[q] = -((ghcm * cm) * bal(u));
  }
  __syncthreads();
}

// Project (y, yr) rows onto the simplex: y and yr already hold max(., 0)
// (y masked by compat); divide each class row by its sum.
template <bool SMEM, class P>
__device__ __forceinline__ void project_finish(P& p) {
  const int Q = p.Q(), nn = p.nn;
  cluster_sums<SMEM>(p, RD_PROJ, 2 * Q, [&](int i, int k, int q, int) -> double {
    if (i < nn) return k < Q ? (double)f_y(p, q)[i] : 0.0;
    return k >= Q ? (double)f_yr(p, q)[i - nn] : 0.0;
  });
  const double* tot = tot_of(p);
  float* scale = cls_of(p, C_SCALE);
  for (int q = threadIdx.x; q < Q; q += P::kThreads) {
    const float sum = (float)tot[q] + (float)tot[Q + q];
    scale[q] = 1.0f / fmaxf(sum, 1e-9f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nn; i += P::kThreads)
    for (int q = 0; q < Q; ++q) f_y(p, q)[i] = f_y(p, q)[i] * scale[q];
  for (int i = threadIdx.x; i < p.nt; i += P::kThreads)
    for (int q = 0; q < Q; ++q) f_yr(p, q)[i] = f_yr(p, q)[i] * scale[q];
  __syncthreads();
}

// routed - keep * slack for node i of the slice, resource r
template <class P>
__device__ __forceinline__ float hinge_arg(const P& p, int i, int r) {
  const double* dispd = dispd_of(p);
  double acc = 0.0;
  for (int q = 0; q < p.Q(); ++q) acc += (double)yc_of(p, q, i) * dispd[q * p.R() + r];
  return (float)acc - (1.0f - f_d(p)[i]) * f_slack(p, r)[i];
}

// rep[t, r] * inv_alloc for row i of the slice
template <class P>
__device__ __forceinline__ float rep_w(const P& p, int i, int r) {
  const double* dispd = dispd_of(p);
  double acc = 0.0;
  for (int q = 0; q < p.Q(); ++q) acc += (double)f_yr(p, q)[i] * dispd[q * p.R() + r];
  return (float)acc * f_inva(p, r)[i];
}

// Adam on one coordinate; returns the stepped (unprojected) value.
template <class P>
__device__ __forceinline__ float adam(const P& p, float x, float g, float* m, float* v, float corr1, float corr2) {
  const float mi = p.b1 * *m + p.c1 * g;
  const float vi = p.b2 * *v + (p.c2 * g) * g;
  *m = mi;
  *v = vi;
  const float upd = (mi / corr1) / (sqrtf(vi / corr2) + p.eps);
  return x - p.lr * upd;
}

template <bool SMEM, class P>
__device__ __forceinline__ void step(P& p, int it) {
  const int R = p.R(), Q = p.Q(), nn = p.nn, nt = p.nt;
  class_tables<SMEM>(p);
  const float* norm = norm_of(p);
  const double* dispd = dispd_of(p);
  const double* gdispd = gdispd_of(p);
  // dL/d routed on the block's nodes, dL/d rep on its rows
  for (int i = threadIdx.x; i < nn; i += P::kThreads)
    for (int r = 0; r < R; ++r) {
      const float a = hinge_arg(p, i, r);
      const float over = fmaxf(a, 0.0f) * norm[r];
      f_ga(p, r)[i] = ((20.0f * over) * norm[r]) * bal(a);
    }
  for (int i = threadIdx.x; i < nt; i += P::kThreads) {
    float z = -INFINITY;
    for (int r = 0; r < R; ++r) {
      const float w = rep_w(p, i, r);
      f_grep(p, r)[i] = w;  // w, until the ties are counted
      z = fmaxf(z, w);
    }
    float ties = 0.0f;
    for (int r = 0; r < R; ++r)
      if (f_grep(p, r)[i] == z) ties += 1.0f;
    const float ps = fminf(f_rprice(p)[i], PRICE_CAP);
    for (int r = 0; r < R; ++r) {
      const float ind = f_grep(p, r)[i] == z ? 1.0f : 0.0f;
      f_grep(p, r)[i] = ((ps * ind) / ties) * f_inva(p, r)[i];
    }
  }
  __syncthreads();
  // dL/d disp
  cluster_sums<SMEM>(p, RD_GDISP, Q * R, [&](int i, int, int q, int r) -> double {
    if (i < nn) return (double)yc_of(p, q, i) * (double)f_ga(p, r)[i];
    const int t = i - nn;
    return (double)f_yr(p, q)[t] * (double)f_grep(p, r)[t];
  });
  const double* tot = tot_of(p);
  float* gdisp = gdisp_of(p);
  const float* gcm = cls_of(p, C_GCM);
  const float* groute = cls_of(p, C_GROUTE);
  for (int k = threadIdx.x; k < Q * R; k += P::kThreads) {
    gdisp[k] = (float)(tot[k] + (double)(gcm[k / R] * norm[k % R]));
    gdispd_of(p)[k] = (double)gdisp[k];
  }
  __syncthreads();
  const float corr1 = p.corr[2 * it], corr2 = p.corr[2 * it + 1];
  // each node: d (gradient, Adam, clip), then y (gradient, Adam, first half
  // of the projection)
  for (int i = threadIdx.x; i < nn; i += P::kThreads) {
    double acc = 0.0;
    for (int r = 0; r < R; ++r) acc += (double)f_ga(p, r)[i] * (double)f_slack(p, r)[i];
    double cls = 0.0;
    for (int q = 0; q < Q; ++q) {
      double pc = 0.0;
      for (int r = 0; r < R; ++r) pc += (double)f_used(p, r)[i] * gdispd[q * R + r];
      cls += (double)f_onehot(p, q)[i] * pc;
    }
    const float gd = (float)(acc + cls - (double)f_price(p)[i] + (double)(p.cw * f_cost(p)[i]));
    const float dn = adam(p, f_d(p)[i], gd, f_md(p) + i, f_vd(p) + i, corr1, corr2);
    f_d(p)[i] = fminf(fmaxf(dn, 0.0f), 1.0f);
    for (int q = 0; q < Q; ++q) {
      double a2 = 0.0;
      for (int r = 0; r < R; ++r) a2 += (double)f_ga(p, r)[i] * dispd[q * R + r];
      const float cmp = f_compat(p, q)[i];
      const float gy = (float)(a2 + (double)groute[q]) * cmp;
      const float yn = adam(p, f_y(p, q)[i], gy, f_my(p, q) + i, f_vy(p, q) + i, corr1, corr2);
      f_y(p, q)[i] = fmaxf(yn, 0.0f) * cmp;
    }
  }
  // yr: gradient, Adam, first half of the projection; one (row, class) a
  // thread (the block has fewer rows than threads)
  for (int e = threadIdx.x; e < nt * Q; e += P::kThreads) {
    const int q = e / nt, i = e - q * nt;
    double acc = 0.0;
    for (int r = 0; r < R; ++r) acc += (double)f_grep(p, r)[i] * dispd[q * R + r];
    const float gyr = (float)(acc + (double)groute[q]);
    const float yn = adam(p, f_yr(p, q)[i], gyr, f_myr(p, q) + i, f_vyr(p, q) + i, corr1, corr2);
    f_yr(p, q)[i] = fmaxf(yn, 0.0f);
  }
  __syncthreads();
  project_finish<SMEM>(p);
}

// The objective at the current (d, y, yr); valid in thread 0.
template <bool SMEM, class P>
__device__ __forceinline__ float objective(P& p) {
  const int R = p.R(), Q = p.Q(), nn = p.nn;
  class_tables<SMEM>(p);
  const float* norm = norm_of(p);
  // 0: sum over^2, 1: sum price_safe z, 2: sum d price, 3: sum d cost
  cluster_sums<SMEM>(p, RD_OBJ, 4, [&](int i, int k, int, int) -> double {
    if (i < nn) {
      if (k == 0) {
        double cap = 0.0;
        for (int r = 0; r < R; ++r) {
          const float over = fmaxf(hinge_arg(p, i, r), 0.0f) * norm[r];
          cap += (double)(over * over);
        }
        return cap;
      }
      if (k == 2) return (double)(f_d(p)[i] * f_price(p)[i]);
      if (k == 3) return (double)(f_d(p)[i] * f_cost(p)[i]);
      return 0.0;
    }
    if (k != 1) return 0.0;
    const int t = i - nn;
    float z = -INFINITY;
    for (int r = 0; r < R; ++r) z = fmaxf(z, rep_w(p, t, r));
    return (double)(fminf(f_rprice(p)[t], PRICE_CAP) * z);
  });
  float out = 0.0f;
  if (threadIdx.x == 0) {
    const double* tot = tot_of(p);
    double un = 0.0;
    for (int q = 0; q < Q; ++q) un += (double)((cls_of(p, C_H)[q] * cls_of(p, C_CM)[q]) * p.pend_weight[q]);
    const float savings = (float)tot[2] - p.cw * (float)tot[3];
    out = ((savings - (float)tot[1]) - 10.0f * (float)tot[0]) - 10.0f * (float)un;
  }
  return out;
}

// SMEM: the small tables and the arena are in shared memory, else in the
// global scratch; MOM_SMEM: the Adam moments too
template <bool SMEM, bool MOM_SMEM, int QT, int RT, int NTH>
__global__ void __launch_bounds__(NTH, K5_THREADS / NTH)
globalpack_kernel(GP<QT, RT, NTH> base, const float* __restrict__ d0, const float* __restrict__ y0, int n_iters,
                  float* __restrict__ d_out, float* __restrict__ score, float* __restrict__ gscratch) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  GP<QT, RT, NTH> p = base;
  const int rank = (int)cl.block_rank(), c = blockIdx.x / p.cl;
  const int N = p.N, R = p.R(), Q = p.Q(), T = p.T;
  const Layout L = layout_of(N, R, Q, T, p.cl);
  const size_t stride = spill_words(L);
  float* spill = MOM_SMEM ? nullptr : gscratch + (size_t)blockIdx.x * stride;
  p.small = SMEM ? smem : spill;
  p.arena = p.small + L.small_w;
  p.rows = p.arena + (size_t)node_fields(R, Q) * L.NS;
  p.mom = MOM_SMEM ? p.arena + L.arena_w : (SMEM ? spill : spill + L.small_w + L.arena_w);
  p.rows_mom = p.mom + (size_t)node_moments(Q) * L.NS;
  p.gsmall0 = SMEM ? nullptr : gscratch + (size_t)(blockIdx.x - rank) * stride;
  p.gstride = stride;
  p.rank = rank;
  p.V1 = L.V1;
  p.NS = L.NS;
  p.TS = L.TS;
  p.n0 = (int)((long long)N * rank / p.cl);
  p.nn = (int)((long long)N * (rank + 1) / p.cl) - p.n0;
  p.t0 = (int)((long long)T * rank / p.cl);
  p.nt = (int)((long long)T * (rank + 1) / p.cl) - p.t0;
  p.buf = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // per-resource normalisation: 1 / max(max used, max slack, max pend_mass, 0)
  float* norm = norm_of(p);
  for (int r = warp; r < R; r += NTH / 32) {
    float mx = 0.0f;
    for (int n = lane; n < N; n += 32)
      mx = fmaxf(mx, fmaxf(p.used[(size_t)n * R + r], p.slack[(size_t)n * R + r]));
    for (int q = lane; q < Q; q += 32) mx = fmaxf(mx, p.pend_mass[q * R + r]);
    mx = warp_max(mx);
    if (lane == 0) norm[r] = 1.0f / fmaxf(mx, 1e-9f);
  }
  // the slices' inputs into their fields; inits: d0, y0 and yr = 0.5,
  // projected; Adam moments zero
  for (int i = threadIdx.x; i < p.nn; i += NTH) {
    const int n = p.n0 + i;
    f_d(p)[i] = d0[(size_t)c * N + n];
    f_md(p)[i] = 0.0f;
    f_vd(p)[i] = 0.0f;
    f_price(p)[i] = p.price[n];
    f_cost(p)[i] = p.cost[n];
    for (int r = 0; r < R; ++r) {
      f_slack(p, r)[i] = p.slack[(size_t)n * R + r];
      f_used(p, r)[i] = p.used[(size_t)n * R + r];
    }
    for (int q = 0; q < Q; ++q) {
      const float cmp = p.compat[(size_t)q * N + n];
      f_onehot(p, q)[i] = p.onehot[(size_t)n * Q + q];
      f_compat(p, q)[i] = cmp;
      f_y(p, q)[i] = fmaxf(y0[((size_t)c * Q + q) * N + n], 0.0f) * cmp;
      f_my(p, q)[i] = 0.0f;
      f_vy(p, q)[i] = 0.0f;
    }
  }
  for (int i = threadIdx.x; i < p.nt; i += NTH) {
    const int t = p.t0 + i;
    f_rprice(p)[i] = p.row_price[t];
    for (int r = 0; r < R; ++r) {
      const float a = p.row_alloc[(size_t)t * R + r];
      f_alloc(p, r)[i] = a;
      f_inva(p, r)[i] = a > 0.0f ? 1.0f / fmaxf(a, 1e-9f) : PRICE_CAP;
    }
    for (int q = 0; q < Q; ++q) {
      f_yr(p, q)[i] = 0.5f;
      f_myr(p, q)[i] = 0.0f;
      f_vyr(p, q)[i] = 0.0f;
    }
  }
  __syncthreads();
  project_finish<SMEM>(p);
  for (int it = 0; it < n_iters; ++it) step<SMEM>(p, it);
  const float obj = objective<SMEM>(p);
  if (rank == 0 && threadIdx.x == 0) score[c] = obj;
  for (int i = threadIdx.x; i < p.nn; i += NTH) d_out[(size_t)c * N + p.n0 + i] = f_d(p)[i];
  cl.sync();  // no block leaves while another may still read its shared memory
}

// the build and the blocks per init for a shape: Qp = R = 4 with everything
// in shared memory (the common shape) in 16-block clusters of 256 threads,
// any other shape in 8-block clusters of 512, with everything in shared
// memory, the Adam moments in the global scratch, or everything there. 16
// blocks a cluster is past the portable limit of 8: where the card cannot
// run such a cluster, the launch fails.
enum { K_44 = 0, K_ANY = 1, K_MOM = 2, K_SPILL = 3 };
struct Shape {
  int kind, cl;
  Layout L;
};
static Shape shape_of(int N, int R, int Q, int T) {
  Shape s;
  if (Q == 4 && R == 4) {
    s.L = layout_of(N, R, Q, T, 16);
    if (s.L.mom_s) {
      s.kind = K_44;
      s.cl = 16;
      return s;
    }
  }
  s.cl = 8;
  s.L = layout_of(N, R, Q, T, s.cl);
  s.kind = s.L.mom_s ? K_ANY : (s.L.arena_s ? K_MOM : K_SPILL);
  return s;
}

// floats of global scratch the launch needs: 0 where every block's tables,
// arena and moments fit in shared memory
extern "C" long long kt_globalpack_scratch(int C, int N, int R, int Q, int T) {
  const Shape sh = shape_of(N, R, Q, T);
  return (long long)C * sh.cl * (long long)spill_words(sh.L);
}

static cudaLaunchConfig_t config_for(const Shape& sh, int C, cudaLaunchAttribute* attr, void* stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * sh.cl);
  cfg.blockDim = dim3(sh.kind == K_44 ? K5_THREADS / 2 : K5_THREADS);
  cfg.dynamicSmemBytes = sh.L.bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the same arguments as another build's (the members do not depend on QT, RT, NTH)
template <int QT, int RT, int NTH>
static GP<QT, RT, NTH> as(const GP<0, 0, K5_THREADS>& p) {
  GP<QT, RT, NTH> out;
  static_assert(sizeof(out) == sizeof(p), "GP layouts differ");
  memcpy(&out, &p, sizeof(p));
  return out;
}

extern "C" int kt_globalpack(const void* price, const void* cost, const void* slack, const void* used,
                             const void* row_price, const void* row_alloc, const void* onehot, const void* compat_qn,
                             const void* pend_mass, const void* pend_weight, const void* d0, const void* y0,
                             const void* corr, int C, int N, int R, int Q, int T, int n_iters, float cw,
                             float b1, float b2, float c1, float c2, float lr, float eps, void* d, void* score,
                             void* gscratch, void* stream) {
  if (C == 0) return 0;
  const Shape sh = shape_of(N, R, Q, T);
  if (spill_words(sh.L) > 0 && !gscratch) return (int)cudaErrorInvalidValue;
  GP<0, 0, K5_THREADS> p = {};
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
  p.Rr = R;
  p.Qr = Q;
  p.T = T;
  p.cl = sh.cl;
  p.cw = cw;
  p.b1 = b1;
  p.b2 = b2;
  p.c1 = c1;
  p.c2 = c2;
  p.lr = lr;
  p.eps = eps;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config_for(sh, C, attr, stream);
  const float* d0f = (const float*)d0;
  const float* y0f = (const float*)y0;
  float* df = (float*)d;
  float* sf = (float*)score;
  float* gf = (float*)gscratch;
  constexpr int NT = K5_THREADS, NT2 = K5_THREADS / 2;
  const int smem = (int)sh.L.bytes;
  cudaError_t e;
  if (sh.kind == K_44) {
    const auto kern = globalpack_kernel<true, true, 4, 4, NT2>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern, as<4, 4, NT2>(p), d0f, y0f, n_iters, df, sf, gf);
  } else if (sh.kind == K_ANY) {
    const auto kern = globalpack_kernel<true, true, 0, 0, NT>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern, p, d0f, y0f, n_iters, df, sf, gf);
  } else if (sh.kind == K_MOM) {
    const auto kern = globalpack_kernel<true, false, 0, 0, NT>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern, p, d0f, y0f, n_iters, df, sf, gf);
  } else {
    const auto kern = globalpack_kernel<false, false, 0, 0, NT>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern, p, d0f, y0f, n_iters, df, sf, gf);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
