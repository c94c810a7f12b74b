// K6 score_subsets: the discrete factored objective of each delete-set row.
//
// Replaces: karpenter_tpu/models/globalpack.py `_score_subsets_impl` (:212),
// the vmap of `_objective_factored` (:166-208) over the rounded rows, called
// by `score_subsets_global` (:220) in batches of 32 from both LP proposers.
//
// Per row m (x = X[m], xf = 0/1):
//   displaced[r]  = pend_req[r] + sum_n used[n, r] xf[n]
//   avg_pod[r]    = displaced[r] / max(pend_npods + sum_n npods[n] xf[n], 1)
//   deleted[q]    = max(max_n onehot[n, q] xf[n], pend_active[q])
//   usable[r]     = sum_n slack[n, r] (keep[n] cta[n] can_host[n]), with
//                   cta[n] = max_q compat_nq[n, q] deleted[q] and
//                   can_host[n] = all_r slack[n, r] >= avg_pod[r]
//   shortfall     = max(displaced - usable, 0); the cheapest replacement is
//                   the single row covering it (no pending pods) or the ceil
//                   count of identical rows (pending pods), BIG when none;
//   score         = feasible ? sum price xf - replacement - cw sum cost xf : -BIG.
//
// What bounds it on an H100: bytes. Every row reads the node arrays once
// (price, cost, npods, R-wide slack and used, Q-wide onehot and compat:
// ~0.5 MB at Np = 8192, R = Q = 4) and the T replacement rows; ~100 rows
// read ~50 MB in all, ~15 us at 3.35 TB/s, mostly L2 hits since every row
// reads the same arrays. One block per row walking all nodes is instead
// bound by its chains of dependent adds and a few blocks' worth of loads.
//
// Design: a thread-block cluster per row splits the node axis on XLA's
// window boundaries. Nodes are cut into tiles of S = min(Np, 1024): a
// tile's sum of a series is 32 windows of 32 consecutive terms, each added
// in order from 0, then the 32 window sums added in order (at Np <= 1024
// the whole sum), which is XLA:CPU's second level (`xla_order.cuh`). The
// cluster has C = min(8, Np / S) blocks, each owning Np / (S C) consecutive
// tiles (at Np = 8192 one tile each; at 32768 four). Per row, three passes,
// each ending in a cluster barrier:
//   1. each block stages its tiles' terms (used, npods, price, cost times
//      xf) into shared memory, padded one word per 32 so a warp's 32
//      windows hit 32 banks, sums them as above, and takes its nodes'
//      deleted-class maxima; after the barrier every block reads every
//      block's tile sums through distributed shared memory and finishes
//      the levels above in rank order (the same adds in every block), so
//      each has tot1, deleted, displaced and avg_pod;
//   2. the same for the usable slack of its nodes;
//   3. its share of the T replacement rows, whose minimum it writes into
//      block 0's shared memory; after the barrier block 0 scores the row.
// Minima and maxima are exact in any order; the score rounds
// savings - cw * cost once, as XLA's fused multiply-add does, so scores are
// bit-identical to the reference's and to the plain version's. Built with
// -fmad=false and IEEE division. Where a block's tables pass its
// shared-memory budget they live in a slice of a global scratch per block,
// read by the cluster's other blocks after the same barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_order.cuh"

namespace cg = cooperative_groups;

#define K6_THREADS 256
#define K6_WARPS (K6_THREADS / 32)
#define K6_TILE 1024    // nodes of a tile: one second-level window sum per series
#define K6_CLUSTER 8    // blocks of a cluster at most (the portable limit)
#define BIG 3.4e38f
#define K6_SMEM_BUDGET (232448 - 1024)  // dynamic shared memory a block may take, less the static part

// How a row's node axis splits: tiles of S nodes, C blocks of tpc tiles.
struct K6Shape {
  int S, tiles, C, tpc;
};

__host__ __device__ inline K6Shape k6_shape(int N) {
  K6Shape s;
  s.S = N < K6_TILE ? N : K6_TILE;
  s.tiles = N / s.S;
  s.C = K6_CLUSTER;
  while (s.tiles % s.C) s.C /= 2;
  s.tpc = s.tiles / s.C;
  return s;
}

// a tile's windows: S / 32 of 32 terms, or one of S terms (S < 32)
__host__ __device__ inline int k6_windows(int S) { return S >= 32 ? S / 32 : 1; }
// staged words per series: one pad word per 32 terms
__host__ __device__ inline int k6_stride(int S) { return S >= 32 ? S + S / 32 : S; }

// The arena of a block, in floats (offsets in that order): the staged terms
// [R + 3][stride], the window sums [R + 3][windows + 1], the tile sums of pass 1
// [R + 3][tpc] and of pass 2 [R][tpc], the block's deleted-class maxima
// [Q], every block's tile sums gathered [R + 3][tiles], deleted [Q], tot1
// [R + 3], tot2, displaced, avg_pod and shortfall [R], the warps' minima
// [K6_WARPS] and the blocks' minima [K6_CLUSTER].
struct K6Arena {
  size_t terms, lvl1, part1, part2, dmax, gath, deleted, tot1, tot2, displaced, avg_pod, shortfall, wmin, inbox,
      floats;
};

__host__ __device__ inline K6Arena k6_arena(int N, int R, int Q) {
  const K6Shape s = k6_shape(N);
  const size_t V = (size_t)R + 3;
  K6Arena a;
  size_t o = 0;
  a.terms = o; o += V * k6_stride(s.S);
  a.lvl1 = o; o += V * (k6_windows(s.S) + 1);
  a.part1 = o; o += V * s.tpc;
  a.part2 = o; o += (size_t)R * s.tpc;
  a.dmax = o; o += Q;
  a.gath = o; o += V * s.tiles;
  a.deleted = o; o += Q;
  a.tot1 = o; o += V;
  a.tot2 = o; o += R;
  a.displaced = o; o += R;
  a.avg_pod = o; o += R;
  a.shortfall = o; o += R;
  a.wmin = o; o += K6_WARPS;
  a.inbox = o; o += K6_CLUSTER;
  a.floats = o;
  return a;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// the arena of the block of rank r in this cluster: its shared memory
// through the cluster's window, or its slice of the global scratch
template <bool SMEM>
__device__ __forceinline__ float* peer(float* p, int r, int rank, size_t arena_floats) {
  if (SMEM) return cg::this_cluster().map_shared_rank(p, r);
  return p + ((ptrdiff_t)r - rank) * (ptrdiff_t)arena_floats;
}

// The sums of V series over one tile: terms[v][pad(i)] staged, into
// out[v * tpc]; every thread of the block calls it.
__device__ __forceinline__ void tile_sums(const float* terms, float* lvl1, int V, int S, float* out, int tpc) {
  const int W = k6_windows(S), stride = k6_stride(S);
  for (int k = threadIdx.x; k < V * W; k += K6_THREADS) {
    const int v = k / W, w = k - v * W;
    const float* t = terms + (size_t)v * stride + 33 * w;
    float acc = 0.0f;
    if (S >= 32) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc = acc + t[i];
    } else {
      for (int i = 0; i < S; ++i) acc = acc + t[i];
    }
    lvl1[v * (W + 1) + w] = acc;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < V; v += K6_THREADS) {
    const float* l = lvl1 + v * (W + 1);
    float acc = 0.0f;
    for (int w = 0; w < W; ++w) acc = acc + l[w];
    out[(size_t)v * tpc] = acc;
  }
}

// XLA's order over n terms that are whole window sums of the level below:
// windows of 32 added in order while more than 32 remain, then the rest in
// order; folds x in place (one thread)
__device__ __forceinline__ float xla_fold(float* x, int n) {
  while (n > 32) {
    for (int w = 0; w < n / 32; ++w) {
      float acc = 0.0f;
      for (int i = 0; i < 32; ++i) acc = acc + x[32 * w + i];
      x[w] = acc;
    }
    n /= 32;
  }
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) acc = acc + x[i];
  return acc;
}

// every block's tile sums of V series (at `part`, [V][tpc] in each block),
// gathered in rank order into gath [V][tiles] and folded into out[V]
template <bool SMEM>
__device__ __forceinline__ void cluster_fold(float* part, float* gath, float* out, int V, const K6Shape& s, int rank,
                                             size_t arena_floats) {
  for (int k = threadIdx.x; k < V * s.tiles; k += K6_THREADS) {
    const int v = k / s.tiles, g = k - v * s.tiles, r = g / s.tpc;
    gath[k] = peer<SMEM>(part, r, rank, arena_floats)[(size_t)v * s.tpc + (g - r * s.tpc)];
  }
  __syncthreads();
  for (int v = threadIdx.x; v < V; v += K6_THREADS) out[v] = xla_fold(gath + (size_t)v * s.tiles, s.tiles);
  __syncthreads();
}

template <bool SMEM>
__global__ void __launch_bounds__(K6_THREADS)
score_subsets_kernel(const float* __restrict__ price, const float* __restrict__ cost, const float* __restrict__ slack,
                     const float* __restrict__ used, const float* __restrict__ npods,
                     const float* __restrict__ onehot, const float* __restrict__ compat_nq,
                     const float* __restrict__ row_alloc, const float* __restrict__ row_price,
                     const float* __restrict__ pend_req, const float* __restrict__ pend_active,
                     const uint8_t* __restrict__ X, int N, int R, int Q, int T, float pend_npods,
                     float churn_weight, float* __restrict__ score, uint8_t* __restrict__ feasible,
                     float* __restrict__ gscratch) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const K6Shape s = k6_shape(N);
  const K6Arena A = k6_arena(N, R, Q);
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / s.C, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = R + 3, stride = k6_stride(s.S);
  float* ar = SMEM ? smem : gscratch + (size_t)blockIdx.x * A.floats;
  float *terms = ar + A.terms, *lvl1 = ar + A.lvl1, *part1 = ar + A.part1, *part2 = ar + A.part2;
  float *dmax = ar + A.dmax, *gath = ar + A.gath, *deleted = ar + A.deleted, *tot1 = ar + A.tot1;
  float *tot2 = ar + A.tot2, *displaced = ar + A.displaced, *avg_pod = ar + A.avg_pod;
  float *shortfall = ar + A.shortfall, *wmin = ar + A.wmin, *inbox = ar + A.inbox;
  const uint8_t* x = X + (size_t)m * N;
  const int n0 = rank * s.tpc * s.S, n1 = n0 + s.tpc * s.S;  // this block's nodes
  auto pad = [&](int i) { return s.S >= 32 ? i + (i >> 5) : i; };

  // pass 1: displaced mass, pod count, price and cost of the deleted nodes;
  // the deleted classes (one warp per class, exact maxima)
  for (int q = warp; q < Q; q += K6_WARPS) {
    float mx = -INFINITY;
    for (int n = n0 + lane; n < n1; n += 32) mx = fmaxf(mx, onehot[(size_t)n * Q + q] * (x[n] ? 1.0f : 0.0f));
    mx = warp_max(mx);
    if (lane == 0) dmax[q] = mx;
  }
  for (int tl = 0; tl < s.tpc; ++tl) {
    const int base = n0 + tl * s.S;
    for (int i = tid; i < s.S; i += K6_THREADS) {
      const int n = base + i, at = pad(i);
      const float xf = x[n] ? 1.0f : 0.0f;
      for (int v = 0; v < R; ++v) terms[(size_t)v * stride + at] = used[(size_t)n * R + v] * xf;
      terms[(size_t)R * stride + at] = npods[n] * xf;
      terms[(size_t)(R + 1) * stride + at] = price[n] * xf;
      terms[(size_t)(R + 2) * stride + at] = cost[n] * xf;
    }
    __syncthreads();
    tile_sums(terms, lvl1, V, s.S, part1 + tl, s.tpc);
  }
  cluster.sync();  // 1: every block's pass-1 tile sums and maxima
  for (int q = tid; q < Q; q += K6_THREADS) {
    float mx = peer<SMEM>(dmax, 0, rank, A.floats)[q];
    for (int r = 1; r < s.C; ++r) mx = fmaxf(mx, peer<SMEM>(dmax, r, rank, A.floats)[q]);
    deleted[q] = fmaxf(mx, pend_active[q]);
  }
  cluster_fold<SMEM>(part1, gath, tot1, V, s, rank, A.floats);
  for (int r = tid; r < R; r += K6_THREADS) {
    displaced[r] = pend_req[r] + tot1[r];
    avg_pod[r] = displaced[r] / fmaxf(pend_npods + tot1[R], 1.0f);
  }
  __syncthreads();

  // pass 2: slack of kept nodes compatible with a deleted class that can host an average pod
  for (int tl = 0; tl < s.tpc; ++tl) {
    const int base = n0 + tl * s.S;
    for (int i = tid; i < s.S; i += K6_THREADS) {
      const int n = base + i, at = pad(i);
      const float keep = x[n] ? 0.0f : 1.0f;
      float cta = -INFINITY;
      for (int q = 0; q < Q; ++q) cta = fmaxf(cta, compat_nq[(size_t)n * Q + q] * deleted[q]);
      bool can = true;
      for (int r = 0; r < R; ++r) can = can && (slack[(size_t)n * R + r] >= avg_pod[r]);
      const float w = (keep * cta) * (can ? 1.0f : 0.0f);
      for (int r = 0; r < R; ++r) terms[(size_t)r * stride + at] = slack[(size_t)n * R + r] * w;
    }
    __syncthreads();
    tile_sums(terms, lvl1, R, s.S, part2 + tl, s.tpc);
  }
  cluster.sync();  // 2: every block's pass-2 tile sums
  cluster_fold<SMEM>(part2, gath, tot2, R, s, rank, A.floats);
  for (int r = tid; r < R; r += K6_THREADS) shortfall[r] = fmaxf(displaced[r] - tot2[r], 0.0f);
  __syncthreads();

  // pass 3: this block's share of the replacement rows; its minimum to block 0
  const bool multi = pend_npods > 0.0f;
  float best = INFINITY;
  for (int t = rank * K6_THREADS + tid; t < T; t += s.C * K6_THREADS) {
    float c;
    if (!multi) {
      bool fits = true;
      for (int r = 0; r < R; ++r) fits = fits && (row_alloc[(size_t)t * R + r] >= shortfall[r]);
      c = fits ? row_price[t] : BIG;
    } else {
      bool ok = true;
      float mx = -INFINITY;
      for (int r = 0; r < R; ++r) {
        const float a = row_alloc[(size_t)t * R + r], sf = shortfall[r];
        ok = ok && (a > 0.0f || sf <= 0.0f);
        mx = fmaxf(mx, sf > 0.0f ? sf / fmaxf(a, 1e-9f) : 0.0f);
      }
      c = ok ? row_price[t] * fmaxf(ceilf(mx), 1.0f) : BIG;
    }
    best = fminf(best, c);
  }
  best = warp_min(best);
  if (lane == 0) wmin[warp] = best;
  __syncthreads();
  if (tid == 0) {
    float b = wmin[0];
    for (int w = 1; w < K6_WARPS; ++w) b = fminf(b, wmin[w]);
    peer<SMEM>(inbox, 0, rank, A.floats)[rank] = b;
  }
  cluster.sync();  // 3: every block's minimum is in block 0's inbox
  if (rank == 0 && tid == 0) {
    float b = inbox[0];
    for (int r = 1; r < s.C; ++r) b = fminf(b, inbox[r]);
    bool needs = false;
    for (int r = 0; r < R; ++r) needs = needs || (shortfall[r] > 0.0f);
    const float replacement = needs ? b : 0.0f;
    const bool feas = !needs || (b < BIG);
    const float savings = tot1[R + 1] - replacement;
    score[m] = feas ? __fmaf_rn(-churn_weight, tot1[R + 2], savings) : -BIG;
    feasible[m] = feas ? 1 : 0;
  }
}

// One cluster per row, all rows in one launch. score [M] f32 and feasible
// [M] bytes may be parts of one buffer (one download).
extern "C" int kt_score_subsets(const void* price, const void* cost, const void* slack, const void* used,
                                const void* npods, const void* onehot, const void* compat_nq, const void* row_alloc,
                                const void* row_price, const void* pend_req, const void* pend_active, const void* X,
                                int M, int N, int R, int Q, int T, float pend_npods, float churn_weight, void* score,
                                void* feasible, void* gscratch, void* stream) {
  if (!xla_sums_shape_ok(N) || N % k6_shape(N).S) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const K6Shape s = k6_shape(N);
  // the arena in shared memory where it fits, else in the caller's scratch
  const size_t smem = gscratch ? 0 : sizeof(float) * k6_arena(N, R, Q).floats;
  if (smem > K6_SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  const void* kern = gscratch ? (const void*)score_subsets_kernel<false> : (const void*)score_subsets_kernel<true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M * s.C);
  cfg.blockDim = dim3(K6_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float *pr = (const float*)price, *co = (const float*)cost, *sl = (const float*)slack, *us = (const float*)used,
              *np = (const float*)npods, *oh = (const float*)onehot, *cq = (const float*)compat_nq,
              *ra = (const float*)row_alloc, *rp = (const float*)row_price, *preq = (const float*)pend_req,
              *pact = (const float*)pend_active;
  const uint8_t* xx = (const uint8_t*)X;
  float* sc = (float*)score;
  uint8_t* fe = (uint8_t*)feasible;
  float* gs = (float*)gscratch;
  const cudaError_t e = gscratch ? cudaLaunchKernelEx(&cfg, score_subsets_kernel<false>, pr, co, sl, us, np, oh, cq, ra,
                                                      rp, preq, pact, xx, N, R, Q, T, pend_npods, churn_weight, sc,
                                                      fe, gs)
                                 : cudaLaunchKernelEx(&cfg, score_subsets_kernel<true>, pr, co, sl, us, np, oh, cq, ra,
                                                      rp, preq, pact, xx, N, R, Q, T, pend_npods, churn_weight, sc,
                                                      fe, gs);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// floats of global scratch the launch needs for M rows: 0 where a block's
// arena fits in shared memory
extern "C" long long kt_score_subsets_scratch(int M, int N, int R, int Q) {
  if (N <= 0) return 0;
  const size_t floats = k6_arena(N, R, Q).floats;
  return sizeof(float) * floats > K6_SMEM_BUDGET ? (long long)M * k6_shape(N).C * (long long)floats : 0;
}
