// K4 recredit: reverse removed pods' takes in a pack carry.
//
// Replaces: karpenter_tpu/models/scheduler_model_grouped.py `_recredit_impl`
// (:1111), called by `recredit_removals` (:1144) on the delta solve.
//
// Per removal k (slot_idx[k] = -1 pads; j = clip(slot_idx, 0, N-1)):
//   slot_rem[j, :]    += valid ? req[k, :] : 0
//   counts_host[g, j] -= hmem[k, g] & valid
//   counts_zone[g, d] -= zm[k, g] & slot_zoneset[j, d] & (dom_key_of[d] == kstar_k)
// with zm = zmem & valid and kstar_k the largest group_dom_key over k's zm
// groups (-1 when k has none, which selects no domain).
//
// What bounds it on an H100: bytes, and far below them launch latency: the
// carry leaves it rewrites are ~0.35 MB at the headline shape (N = 4096,
// R = 4, G = 16), ~0.1 us at 3.35 TB/s; the K removals add a few KB.
//
// Design: one thread owns each output element (no atomics), in three
// segments of one flat grid: (slot, resource), (group, slot), (group,
// domain). Each walks the K removals in order. For slot_rem that order is
// the point: several removals on one slot must add in the order XLA:CPU
// applies the reference's scatter-add, k = 0..K-1, one rounding per add
// (a tree or pairwise sum differs in the last bit), and padding entries add
// +0.0 to slot 0 as the reference's clipped scatter does (turning a -0.0
// there into +0.0). The integer counts are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void recredit_kernel(const int* __restrict__ slot_idx, const float* __restrict__ req,
                                const uint8_t* __restrict__ zmem, const uint8_t* __restrict__ hmem,
                                const uint8_t* __restrict__ slot_zoneset, const int* __restrict__ group_dom_key,
                                const int* __restrict__ dom_key_of, const float* __restrict__ rem_in,
                                const int* __restrict__ host_in, const int* __restrict__ zone_in, int K, int N, int R,
                                int G, int D, float* __restrict__ rem_out, int* __restrict__ host_out,
                                int* __restrict__ zone_out) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_rem = (long long)N * R, n_host = (long long)G * N, n_zone = (long long)G * D;
  if (tid < n_rem) {
    const int n = (int)(tid / R), r = (int)(tid % R);
    float acc = rem_in[tid];
    for (int k = 0; k < K; ++k) {
      const int s = slot_idx[k];
      if (min(max(s, 0), N - 1) != n) continue;
      acc = __fadd_rn(acc, s >= 0 ? req[(size_t)k * R + r] : 0.0f);
    }
    rem_out[tid] = acc;
    return;
  }
  tid -= n_rem;
  if (tid < n_host) {
    const int g = (int)(tid / N), n = (int)(tid % N);
    int acc = host_in[tid];
    for (int k = 0; k < K; ++k) {
      const int s = slot_idx[k];
      if (s >= 0 && min(s, N - 1) == n && hmem[(size_t)k * G + g]) acc -= 1;
    }
    host_out[tid] = acc;
    return;
  }
  tid -= n_host;
  if (tid < n_zone) {
    const int g = (int)(tid / D), d = (int)(tid % D);
    int acc = zone_in[tid];
    for (int k = 0; k < K; ++k) {
      const int s = slot_idx[k];
      if (s < 0 || !zmem[(size_t)k * G + g]) continue;
      int kstar = -1;
      for (int gg = 0; gg < G; ++gg)
        if (zmem[(size_t)k * G + gg]) kstar = max(kstar, group_dom_key[gg]);
      const int j = min(s, N - 1);
      if (slot_zoneset[(size_t)j * D + d] && dom_key_of[d] == kstar) acc -= 1;
    }
    zone_out[tid] = acc;
  }
}

extern "C" int kt_recredit(const void* slot_idx, const void* req, const void* zmem, const void* hmem,
                           const void* slot_zoneset, const void* group_dom_key, const void* dom_key_of,
                           const void* rem_in, const void* host_in, const void* zone_in, int K, int N, int R, int G,
                           int D, void* rem_out, void* host_out, void* zone_out, void* stream) {
  const long long total = (long long)N * R + (long long)G * N + (long long)G * D;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  recredit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)slot_idx, (const float*)req, (const uint8_t*)zmem, (const uint8_t*)hmem,
      (const uint8_t*)slot_zoneset, (const int*)group_dom_key, (const int*)dom_key_of, (const float*)rem_in,
      (const int*)host_in, (const int*)zone_in, K, N, R, G, D, (float*)rem_out, (int*)host_out, (int*)zone_out);
  return (int)cudaGetLastError();
}
