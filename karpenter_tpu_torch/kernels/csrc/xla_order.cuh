// Float32 sums in the reference's order, for kernels that must give
// bit-identical results to the JAX package's XLA:CPU code.
//
// XLA:CPU rewrites a sum over an axis of n > 32 terms into windows of 32
// consecutive terms, each added in order starting from 0, then sums the
// window sums the same way, until at most 32 remain, which are added in
// order from 0 (the padded node and row axes are powers of two, so every
// level is a whole number of windows). `xla_sums` computes V such series at
// once: each thread owns whole (series, window) pairs at each level, so the
// order is fixed and no atomics are involved. The caller builds with
// -fmad=false: each add is rounded on its own.
#pragma once

#include <cuda_runtime.h>

// Whether every level of an n-term sum is a whole number of windows.
__host__ __device__ inline bool xla_sums_shape_ok(int n) {
  for (; n > 32; n /= 32)
    if (n % 32) return false;
  return true;
}

// Shared floats xla_sums needs for n terms and V series (one slot per
// window sum at every level).
__host__ __device__ inline int xla_sums_scratch(int n, int V) {
  int slots = 0;
  for (; n > 32; n /= 32) slots += n / 32;
  return V * slots;
}

// out[v] = sum_i term(i, v) for v < V, in XLA:CPU's order. Every thread of
// the block must call it; `buf` holds xla_sums_scratch(n, V) floats of
// shared memory; `out` (shared) is valid for every thread on return.
template <class Term>
__device__ void xla_sums(int n, int V, const Term& term, float* buf, float* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (n > 32) {
    int m = n / 32;
    float* cur = buf;
    for (int k = tid; k < V * m; k += nt) {
      const int v = k / m, w = k - v * m;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc = acc + term(32 * w + i, v);
      cur[k] = acc;
    }
    __syncthreads();
    while (m > 32) {
      const int m2 = m / 32;
      float* nxt = cur + V * m;
      for (int k = tid; k < V * m2; k += nt) {
        const int v = k / m2, w = k - v * m2;
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc = acc + cur[v * m + 32 * w + i];
        nxt[k] = acc;
      }
      __syncthreads();
      cur = nxt;
      m = m2;
    }
    for (int v = tid; v < V; v += nt) {
      float acc = 0.0f;
      for (int i = 0; i < m; ++i) acc = acc + cur[v * m + i];
      out[v] = acc;
    }
  } else {
    for (int v = tid; v < V; v += nt) {
      float acc = 0.0f;
      for (int i = 0; i < n; ++i) acc = acc + term(i, v);
      out[v] = acc;
    }
  }
  __syncthreads();
}
