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
// What bounds it on an H100: launch latency, far below it bytes: the carry
// leaves it rewrites are ~0.35 MB at the headline shape (N = 4096, R = 4,
// G = 16), ~0.2 us at 3.35 TB/s; at most K * (R + G) outputs change.
//
// Design: one launch with no shared state sized by K, N or G. A slot block
// owns SPB consecutive slots (their slot_rem rows and counts_host columns):
// it copies them through, then walks the removals in tiles of RT, in k
// order. Per tile it gathers the removals that fall on its slots into a
// k-ordered list (warp ballots) and stages their requests in shared memory,
// so a fold does not wait on one global load per removal. The owner of each
// (slot, resource) then adds its slot's removals in the order XLA:CPU
// applies the reference's scatter-add, k = 0..K-1, one rounding per add (a
// tree or pairwise sum differs in the last bit); padding entries add +0.0
// to slot 0 at their place in that order, as the reference's clipped
// scatter does (turning a -0.0 there into +0.0). counts_host takes one
// atomic decrement per (removal, hostname member). A tile with no removal on
// the block's slots costs one load and one ballot per thread. The last
// block does counts_zone: per tile each removal's kstar is computed once
// into shared memory, then each (removal, spread group) decrements the
// domains of kstar in its slot's set. The counts are integers, exact in any
// order. Any K: a tile is a fixed RT removals.
// Index arithmetic is 32-bit (the launcher refuses larger shapes).

#include <cuda_runtime.h>
#include <stdint.h>

#define RT 256
#define SPB 32  // slots per slot block
#define RC 16   // resources staged per pass

__global__ void __launch_bounds__(RT) recredit_kernel(
    const int* __restrict__ slot_idx, const float* __restrict__ req, const uint8_t* __restrict__ zmem,
    const uint8_t* __restrict__ hmem, const uint8_t* __restrict__ slot_zoneset, const int* __restrict__ group_dom_key,
    const int* __restrict__ dom_key_of, const float* __restrict__ rem_in, const int* __restrict__ host_in,
    const int* __restrict__ zone_in, int K, int N, int R, int G, int D, int n_slot_blocks,
    float* __restrict__ rem_out, int* __restrict__ host_out, int* __restrict__ zone_out) {
  __shared__ int list_k[RT];  // slot blocks: the tile's removals on this block's slots (~k for padding);
                              // zone block: the tile's kstars
  __shared__ int list_j[RT];  // their slot, relative to the block's first; zone block: the tile's slots
  __shared__ int warp_n[RT / 32];
  __shared__ float s_req[RT * RC];  // slot blocks: the listed removals' requests, RC resources at a time
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the global loads of each step are issued unconditionally and before
  // their first use, so one step waits about one memory latency
  int s_next = tid < K ? slot_idx[tid] : -1;  // this thread's removal of the first tile

  if (blockIdx.x == n_slot_blocks) {
    // counts_zone: copied through, then per tile each removal's kstar (one
    // pass over its (removal, group) pairs, a shared max), then one atomic
    // decrement per (removal, spread group, domain of kstar in its slot's set)
    for (int e = tid; e < G * D; e += RT) zone_out[e] = zone_in[e];
    for (int base = 0; base < K; base += RT) {
      const int n = min(RT, K - base);
      list_j[tid] = s_next;
      list_k[tid] = -1;
      s_next = base + RT + tid < K ? slot_idx[base + RT + tid] : -1;
      __syncthreads();
#pragma unroll 4
      for (int e = tid; e < n * G; e += RT) {
        const int q = e / G, g = e - q * G;
        const bool z = zmem[(base + q) * G + g] != 0;
        const int key = group_dom_key[g];
        if (z && list_j[q] >= 0) atomicMax(&list_k[q], key);
      }
      __syncthreads();
#pragma unroll 4
      for (int e = tid; e < n * G; e += RT) {
        const int q = e / G, g = e - q * G;
        const bool z = zmem[(base + q) * G + g] != 0;
        const int s = list_j[q];
        if (!z || s < 0) continue;
        const int ks = list_k[q], j = min(s, N - 1);
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const bool in = slot_zoneset[j * D + d] != 0;
          if (in && dom_key_of[d] == ks) atomicSub(&zone_out[g * D + d], 1);
        }
      }
      __syncthreads();
    }
    return;
  }

  // slot block: slots [lo, lo + ns); its outputs are slot_rem[lo:lo+ns, :]
  // and counts_host[:, lo:lo+ns]
  const int lo = blockIdx.x * SPB, ns = min(SPB, N - lo), n_rem = ns * R, n_host = G * ns;
#pragma unroll 4
  for (int e = tid; e < n_rem; e += RT) rem_out[lo * R + e] = rem_in[lo * R + e];
#pragma unroll 4
  for (int e = tid; e < n_host; e += RT) {
    const int g = e / ns, o = g * N + lo + e - g * ns;
    host_out[o] = host_in[o];
  }
  for (int base = 0; base < K; base += RT) {
    const int k = base + tid;
    const int s = s_next;
    s_next = k + RT < K ? slot_idx[k + RT] : -1;
    const int j = min(max(s, 0), N - 1);
    const bool mine = k < K && j >= lo && j < lo + ns;
    const unsigned m = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int pos = __popc(m & ((1u << lane) - 1u)), n = 0;
    for (int w = 0; w < RT / 32; ++w) {
      if (w < warp) pos += warp_n[w];
      n += warp_n[w];
    }
    if (mine) {
      list_k[pos] = s >= 0 ? k : ~k;
      list_j[pos] = j - lo;
    }
    __syncthreads();
    if (n > 0) {
      // slot_rem: the listed removals' requests staged RC resources at a
      // time, then one owner per (slot, resource) folds its matches in k order
      for (int r0 = 0; r0 < R; r0 += RC) {
        const int rc = min(RC, R - r0);
#pragma unroll 4
        for (int e = tid; e < n * rc; e += RT) {
          const int q = e / rc, kk = list_k[q];
          const float v = kk >= 0 ? req[kk * R + r0 + e - q * rc] : 0.0f;
          s_req[e] = v;
        }
        __syncthreads();
        for (int e = tid; e < ns * rc; e += RT) {
          const int jl = e / rc, o = lo * R + jl * R + r0 + e - jl * rc;
          float acc = (base == 0 ? rem_in : rem_out)[o];  // the same value; rem_in is read-only
          bool hit = false;
          for (int q = 0; q < n; ++q)
            if (list_j[q] == jl) {
              acc = __fadd_rn(acc, s_req[q * rc + e - jl * rc]);
              hit = true;
            }
          if (hit) rem_out[o] = acc;
        }
        __syncthreads();
      }
      // counts_host: one decrement per (listed removal, hostname member)
#pragma unroll 4
      for (int e = tid; e < n * G; e += RT) {
        const int q = e / G, g = e - q * G, kk = list_k[q];
        const bool h = kk >= 0 && hmem[kk * G + g];
        if (h) atomicSub(&host_out[g * N + lo + list_j[q]], 1);
      }
    }
    __syncthreads();
  }
}

extern "C" int kt_recredit(const void* slot_idx, const void* req, const void* zmem, const void* hmem,
                           const void* slot_zoneset, const void* group_dom_key, const void* dom_key_of,
                           const void* rem_in, const void* host_in, const void* zone_in, int K, int N, int R, int G,
                           int D, void* rem_out, void* host_out, void* zone_out, void* stream) {
  const long long lim = 1LL << 31;
  if (K < 0 || N < 1 || (long long)N * R >= lim || (long long)G * N >= lim || (long long)N * D >= lim ||
      (long long)(K + RT) * (R + G) >= lim)
    return (int)cudaErrorInvalidValue;
  const int n_slot_blocks = (N + SPB - 1) / SPB;
  recredit_kernel<<<n_slot_blocks + 1, RT, 0, (cudaStream_t)stream>>>(
      (const int*)slot_idx, (const float*)req, (const uint8_t*)zmem, (const uint8_t*)hmem,
      (const uint8_t*)slot_zoneset, (const int*)group_dom_key, (const int*)dom_key_of, (const float*)rem_in,
      (const int*)host_in, (const int*)zone_in, K, N, R, G, D, n_slot_blocks, (float*)rem_out, (int*)host_out,
      (int*)zone_out);
  return (int)cudaGetLastError();
}
