// K7 anneal: simulated-annealing chains over single-bit flips of a delete-set.
//
// Replaces: karpenter_tpu/models/consolidation_model.py `anneal_chains`
// (:103), whose chain body evaluates `_objective` (:69-99) once per step
// (also sharded by parallel/sharded.anneal_sharded, :312).
//
// Per chain c, from x = x0[c] with s = objective(x), for i = 0..S-1:
//   x2 = x with bit flips[c, i] flipped, s2 = objective(x2),
//   temp = max(0.02, 1 - i/S) * (|s| * 0.1 + 1e-3),
//   accept when s2 >= s or u[c, i] < exp(clip((s2 - s) / temp, -50, 0)),
//   and keep the best (x, s) seen (strictly better only).
// objective(x): the displaced mass must fit the slack of kept nodes that are
// compatible with some deleted node (pod_compat[j, i] = 1) and can host one
// average displaced pod, plus at most one replacement row (the cheapest
// whose allocatable covers the shortfall); score = price saved - replacement
// - churn_weight * cost, or -BIG when no row covers it.
//
// What bounds it on an H100: latency of the sequential chain. Each step
// reads the node arrays (price, cost, npods, R-wide slack and used: ~0.2 MB
// at Np = 8192, R = 4; L2-resident), one row of the transposed compatibility
// matrix and the T replacement rows, and does ~10 N operations, then three
// block-wide reductions before the accept test can be decided. The
// reference's dense max over pod_compat[j, :] * x is O(N^2) per step; here
// each node j keeps cnt[j] = #{deleted i : pod_compat[j, i] = 1} in shared
// memory (pod_compat holds 0/1, the wrapper checks), so a flip of i changes
// cnt by row i of pod_compat^T: O(N) per step, and max_i = (cnt > 0).
//
// Design: one block per chain walks its S steps; x, cnt, each node's
// usable weight (kept, compatible with a deleted node, can host an average
// pod: 0 or 1, recomputed per step) and the sums' scratch live in shared
// memory (N + 8N + 4(R + 3)(N/32 + N/1024 + ...) bytes; opted into above
// 48 KB). Sums add in XLA:CPU's order (`xla_order.cuh`), and
// savings - cw * cost and |s| * 0.1 + 1e-3 round once as XLA's fused
// multiply-adds do, so scores match the reference's bit for bit; the accept
// test uses expf on float32, as the plain version does on the card, so the
// two take the same branches. Built with -fmad=false and IEEE division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xla_order.cuh"

#define K7_THREADS 512
#define K7_WARPS (K7_THREADS / 32)
#define K7_MAX_R 16
#define K7_V (K7_MAX_R + 3)  // reduced values: R sums, then pod count, price, cost
#define BIG 3.4e38f

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

struct Red {
  float tot1[K7_V], tot2[K7_V];
  float wmin[K7_WARPS];
  float avg_pod[K7_MAX_R];
  float shortfall[K7_MAX_R];
};

// objective of x with bit `flip` flipped (flip < 0: x itself). cnt[j] counts
// the deleted i with pod_compat[j, i] = 1 in x; pct_row is row `flip` of
// pod_compat^T (the hosts j of node flip). Every thread returns the score.
__device__ float objective(const float* __restrict__ price, const float* __restrict__ cost,
                           const float* __restrict__ slack, const float* __restrict__ used,
                           const float* __restrict__ npods, const float* __restrict__ pct_row,
                           const float* __restrict__ row_alloc, const float* __restrict__ row_price,
                           const uint8_t* x, const int* cnt, int flip, int N, int R, int T, float churn_weight,
                           float* weight, float* buf, Red& red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fdir = flip < 0 ? 0 : (x[flip] ? -1 : 1);  // change of cnt where pod_compat[j, flip] = 1
  auto deleted_terms = [&](int n, int v) -> float {
    const float xf = ((x[n] != 0) != (n == flip)) ? 1.0f : 0.0f;
    if (v < R) return used[(size_t)n * R + v] * xf;
    if (v == R) return npods[n] * xf;
    return (v == R + 1 ? price[n] : cost[n]) * xf;
  };
  xla_sums(N, R + 3, deleted_terms, buf, red.tot1);
  if (tid < R) red.avg_pod[tid] = red.tot1[tid] / fmaxf(red.tot1[R], 1.0f);
  __syncthreads();
  for (int n = tid; n < N; n += K7_THREADS) {
    bool can = false;  // keep = 0
    if ((x[n] != 0) == (n == flip)) {
      int c = cnt[n];
      if (fdir != 0 && pct_row[n] != 0.0f) c += fdir;
      can = c > 0;  // compatible with some deleted node
      for (int r = 0; r < R; ++r) can = can && (slack[(size_t)n * R + r] >= red.avg_pod[r]);
    }
    weight[n] = can ? 1.0f : 0.0f;
  }
  __syncthreads();
  xla_sums(N, R, [&](int n, int v) -> float { return slack[(size_t)n * R + v] * weight[n]; }, buf, red.tot2);
  if (tid < R) red.shortfall[tid] = fmaxf(red.tot1[tid] - red.tot2[tid], 0.0f);
  __syncthreads();
  float best = INFINITY;
  for (int t = tid; t < T; t += K7_THREADS) {
    bool fits = true;
    for (int r = 0; r < R; ++r) fits = fits && (row_alloc[(size_t)t * R + r] >= red.shortfall[r]);
    best = fminf(best, fits ? row_price[t] : BIG);
  }
  best = warp_min(best);
  if (lane == 0) red.wmin[warp] = best;
  __syncthreads();
  float b = red.wmin[0];
  for (int w = 1; w < K7_WARPS; ++w) b = fminf(b, red.wmin[w]);
  bool needs = false;
  for (int r = 0; r < R; ++r) needs = needs || (red.shortfall[r] > 0.0f);
  const float savings = red.tot1[R + 1] - (needs ? b : 0.0f);
  const float score = (!needs || b < BIG) ? __fmaf_rn(-churn_weight, red.tot1[R + 2], savings) : -BIG;
  __syncthreads();  // every thread has read the shared results before they are reused
  return score;
}

__global__ void __launch_bounds__(K7_THREADS)
anneal_kernel(const float* __restrict__ price, const float* __restrict__ cost, const float* __restrict__ slack,
              const float* __restrict__ used, const float* __restrict__ npods, const float* __restrict__ pct,
              const float* __restrict__ row_alloc, const float* __restrict__ row_price, const uint8_t* __restrict__ x0,
              const int* __restrict__ flips, const float* __restrict__ u, int N, int R, int T, int S,
              float churn_weight, uint8_t* __restrict__ best_x, float* __restrict__ best_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* x = smem;
  int* cnt = (int*)(smem + ((N + 15) / 16) * 16);
  float* weight = (float*)(cnt + N);
  float* buf = weight + N;  // xla_sums scratch
  __shared__ Red red;
  const int c = blockIdx.x, tid = threadIdx.x;
  const uint8_t* xc0 = x0 + (size_t)c * N;
  uint8_t* bx = best_x + (size_t)c * N;
  for (int n = tid; n < N; n += K7_THREADS) {
    x[n] = xc0[n] ? 1 : 0;
    bx[n] = x[n];
    cnt[n] = 0;
  }
  __syncthreads();
  // cnt[j] = #{i deleted : pod_compat[j, i] = 1}: rows i of pod_compat^T
  for (int i = 0; i < N; ++i) {
    if (!x[i]) continue;
    const float* row = pct + (size_t)i * N;
    for (int j = tid; j < N; j += K7_THREADS) cnt[j] += row[j] != 0.0f ? 1 : 0;
  }
  __syncthreads();
  float s = objective(price, cost, slack, used, npods, pct, row_alloc, row_price, x, cnt, -1, N, R, T,
                      churn_weight, weight, buf, red);
  float bs = s;
  for (int i = 0; i < S; ++i) {
    const int f = flips[(size_t)c * S + i];
    const float* row = pct + (size_t)f * N;
    const float s2 = objective(price, cost, slack, used, npods, row, row_alloc, row_price, x, cnt, f, N, R, T,
                               churn_weight, weight, buf, red);
    const float frac = fmaxf(0.02f, 1.0f - (float)i / (float)S);
    const float temp = frac * __fmaf_rn(fabsf(s), 0.1f, 1e-3f);
    const float z = fminf(fmaxf((s2 - s) / temp, -50.0f), 0.0f);
    const bool accept = (s2 >= s) || (u[(size_t)c * S + i] < expf(z));
    if (accept) {  // block-uniform: every thread computed the same s2
      const int dir = x[f] ? -1 : 1;
      for (int j = tid; j < N; j += K7_THREADS)
        if (row[j] != 0.0f) cnt[j] += dir;
      __syncthreads();  // all reads of x[f] above are done
      if (tid == 0) x[f] ^= 1;
      s = s2;
      __syncthreads();
      if (s > bs) {
        bs = s;
        for (int n = tid; n < N; n += K7_THREADS) bx[n] = x[n];
      }
    }
  }
  if (tid == 0) best_s[c] = bs;
}

extern "C" int kt_anneal(const void* price, const void* cost, const void* slack, const void* used, const void* npods,
                         const void* pct, const void* row_alloc, const void* row_price, const void* x0,
                         const void* flips, const void* u, int C, int N, int R, int T, int S, float churn_weight,
                         void* best_x, void* best_s, void* stream) {
  if (R > K7_MAX_R || !xla_sums_shape_ok(N)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const size_t smem = (size_t)((N + 15) / 16) * 16 + (size_t)N * (sizeof(int) + sizeof(float)) +
                      sizeof(float) * (size_t)xla_sums_scratch(N, R + 3);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(anneal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  anneal_kernel<<<C, K7_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)price, (const float*)cost, (const float*)slack, (const float*)used, (const float*)npods,
      (const float*)pct, (const float*)row_alloc, (const float*)row_price, (const uint8_t*)x0, (const int*)flips,
      (const float*)u, N, R, T, S, churn_weight, (uint8_t*)best_x, (float*)best_s);
  return (int)cudaGetLastError();
}
