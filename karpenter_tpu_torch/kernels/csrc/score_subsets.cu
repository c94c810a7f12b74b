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
// reads the same arrays.
//
// Design: one block per row, all rows in one launch. Three passes: over the
// nodes (the displaced sums, the deleted classes), over the nodes again
// (each node's usable weight keep * cta * can_host into shared memory, then
// the usable slack), over the rows (the cheapest replacement). Every table
// (the weights, the sums' scratch, the R- and Q-wide class and resource
// tables) is sized from the problem and lives in one arena: shared memory
// where it fits the block's budget, else a slice of a global scratch per
// block, behind the same pointers. Sums add in
// XLA:CPU's order (`xla_order.cuh`) and the score rounds
// savings - cw * cost once, as XLA's fused multiply-add does, so scores are
// bit-identical to the reference's and to the plain version's; maxima and
// minima are exact in any order. Built with -fmad=false and IEEE division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_order.cuh"

#define K6_THREADS 256
#define K6_WARPS (K6_THREADS / 32)
#define BIG 3.4e38f
#define K6_SMEM_BUDGET (232448 - 1024)  // dynamic shared memory a block may take, less the static part

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline size_t arena_floats(int N, int R, int Q) {
  return (size_t)N + (size_t)xla_sums_scratch(N, R + 3) + 2 * ((size_t)R + 3) + (size_t)Q + 3 * (size_t)R;
}

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
  __shared__ float wmin[K6_WARPS];
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the arena: weight [N], the xla_sums scratch, tot1 and tot2 [R + 3]
  // (R resources, then pod count, price, cost), deleted [Q], displaced,
  // avg_pod and shortfall [R]
  float* weight = gscratch ? gscratch + (size_t)m * arena_floats(N, R, Q) : smem;
  float* buf = weight + N;
  float* tot1 = buf + xla_sums_scratch(N, R + 3);
  float* tot2 = tot1 + R + 3;
  float* deleted = tot2 + R + 3;
  float* displaced = deleted + Q;
  float* avg_pod = displaced + R;
  float* shortfall = avg_pod + R;
  const uint8_t* x = X + (size_t)m * N;

  // pass 1: displaced mass, pod count, price and cost of the deleted nodes
  auto deleted_terms = [&](int n, int v) -> float {
    const float xf = x[n] ? 1.0f : 0.0f;
    if (v < R) return used[(size_t)n * R + v] * xf;
    if (v == R) return npods[n] * xf;
    return (v == R + 1 ? price[n] : cost[n]) * xf;
  };
  xla_sums(N, R + 3, deleted_terms, buf, tot1);
  // deleted classes: one warp per class, exact maxima
  for (int q = warp; q < Q; q += K6_WARPS) {
    float mx = -INFINITY;
    for (int n = lane; n < N; n += 32) mx = fmaxf(mx, onehot[(size_t)n * Q + q] * (x[n] ? 1.0f : 0.0f));
    mx = warp_max(mx);
    if (lane == 0) deleted[q] = fmaxf(mx, pend_active[q]);
  }
  for (int r = tid; r < R; r += K6_THREADS) displaced[r] = pend_req[r] + tot1[r];
  __syncthreads();
  for (int r = tid; r < R; r += K6_THREADS) avg_pod[r] = displaced[r] / fmaxf(pend_npods + tot1[R], 1.0f);
  __syncthreads();

  // pass 2: slack of kept nodes compatible with a deleted class that can host an average pod
  for (int n = tid; n < N; n += K6_THREADS) {
    const float keep = x[n] ? 0.0f : 1.0f;
    float cta = -INFINITY;
    for (int q = 0; q < Q; ++q) cta = fmaxf(cta, compat_nq[(size_t)n * Q + q] * deleted[q]);
    bool can = true;
    for (int r = 0; r < R; ++r) can = can && (slack[(size_t)n * R + r] >= avg_pod[r]);
    weight[n] = (keep * cta) * (can ? 1.0f : 0.0f);
  }
  __syncthreads();
  xla_sums(N, R, [&](int n, int v) -> float { return slack[(size_t)n * R + v] * weight[n]; }, buf, tot2);
  for (int r = tid; r < R; r += K6_THREADS) shortfall[r] = fmaxf(displaced[r] - tot2[r], 0.0f);
  __syncthreads();

  // pass 3: the cheapest replacement
  const bool multi = pend_npods > 0.0f;
  float best = INFINITY;
  for (int t = tid; t < T; t += K6_THREADS) {
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
    bool needs = false;
    for (int r = 0; r < R; ++r) needs = needs || (shortfall[r] > 0.0f);
    const float replacement = needs ? b : 0.0f;
    const bool feas = !needs || (b < BIG);
    const float savings = tot1[R + 1] - replacement;
    score[m] = feas ? __fmaf_rn(-churn_weight, tot1[R + 2], savings) : -BIG;
    feasible[m] = feas ? 1 : 0;
  }
}

extern "C" int kt_score_subsets(const void* price, const void* cost, const void* slack, const void* used,
                                const void* npods, const void* onehot, const void* compat_nq, const void* row_alloc,
                                const void* row_price, const void* pend_req, const void* pend_active, const void* X,
                                int M, int N, int R, int Q, int T, float pend_npods, float churn_weight, void* score,
                                void* feasible, void* gscratch, void* stream) {
  if (!xla_sums_shape_ok(N)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  // the arena in shared memory where it fits, else in the caller's scratch
  const size_t smem = gscratch ? 0 : sizeof(float) * arena_floats(N, R, Q);
  if (smem > K6_SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(score_subsets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  score_subsets_kernel<<<M, K6_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)price, (const float*)cost, (const float*)slack, (const float*)used, (const float*)npods,
      (const float*)onehot, (const float*)compat_nq, (const float*)row_alloc, (const float*)row_price,
      (const float*)pend_req, (const float*)pend_active, (const uint8_t*)X, N, R, Q, T, pend_npods, churn_weight,
      (float*)score, (uint8_t*)feasible, (float*)gscratch);
  return (int)cudaGetLastError();
}

// floats of global scratch the launch needs for M rows: 0 where the arena
// fits in shared memory
extern "C" long long kt_score_subsets_scratch(int M, int N, int R, int Q) {
  const size_t words = arena_floats(N, R, Q);
  return sizeof(float) * words > K6_SMEM_BUDGET ? (long long)M * (long long)words : 0;
}
